"""A run with its timed path broken underneath comes out not correct: each
fault a cell can have, planted in the port on the CPU as the window opens,
with the harness's look for a card skipped.  (No cell spans chips, so none can leave out an
exchange between them.)"""
import time

import numpy as np
import pytest
import torch

from chipbench import run
from chipbench.rehearsal import small

BENCH = run.load_json(run.ROOT / "BENCHMARK.json")


def cpu_run(cell: str) -> dict:
    return run.execute(BENCH, cell, 2**31 + 33, 1.5, False,
                       torch.device("cpu"), small, t0=time.perf_counter())


def _wrap(monkeypatch, cls, name, change):
    inner = getattr(cls, name)

    def broken(self, *args, **kwargs):
        return change(inner(self, *args, **kwargs), *args)

    monkeypatch.setattr(cls, name, broken)


def half_wave_left_out(monkeypatch):
    """Every wave goes to the device path, which answers only the queries
    at even positions; the rest come back empty."""
    from repro_torch.core.query_engine import QueryEngine
    from repro_torch.core.serving import CostModel
    monkeypatch.setattr(CostModel, "prefer_host", lambda self, n, b: False)
    _wrap(monkeypatch, QueryEngine, "query_fps_batch",
          lambda out, *a: [r if i % 2 == 0 else r[:0]
                           for i, r in enumerate(out)])


def answer_altered(monkeypatch):
    """The engine drops the last candidate batch of every answer it
    produces, on the host path and the device path alike."""
    from repro_torch.core.query_engine import QueryEngine
    _wrap(monkeypatch, QueryEngine, "query_fps_batch",
          lambda out, *a: [r[:-1] for r in out])
    _wrap(monkeypatch, QueryEngine, "host_query", lambda out, *a: out[:-1])


def ingest_unchanged(monkeypatch):
    """Every second ``ingest()`` returns leaving the store as it was."""
    from repro_torch.logstore.store import DynaWarpStore
    inner, calls = DynaWarpStore.ingest, [0]

    def ingest(self, lines):
        calls[0] += 1
        if calls[0] % 2:
            inner(self, lines)

    monkeypatch.setattr(DynaWarpStore, "ingest", ingest)


def ingest_half_chunk(monkeypatch):
    """``ingest()`` keeps the first half of each chunk."""
    from repro_torch.logstore.store import DynaWarpStore
    inner = DynaWarpStore.ingest
    monkeypatch.setattr(DynaWarpStore, "ingest",
                        lambda self, lines: inner(self, lines[:len(lines) // 2]))


def ingest_token_altered(monkeypatch):
    """The fingerprints of the first 64 lines of every flushed batch are
    altered where the write path makes them."""
    from repro_torch.core.batch_builder import LineFingerprinter

    def alter(out, lines):
        flat, counts = out
        flat = flat.copy()
        flat[:int(counts[:64].sum())] ^= np.uint32(0x9E3779B9)
        return flat, counts

    _wrap(monkeypatch, LineFingerprinter, "fingerprint_lines", alter)


@pytest.mark.parametrize("cell,fault,count", [
    ("needle-serve", half_wave_left_out, "missing_lines"),
    ("needle-serve", answer_altered, "missing_lines"),
    ("durable-ingest", ingest_unchanged, "line_gap"),
    ("durable-ingest", ingest_half_chunk, "line_gap"),
    ("durable-ingest", ingest_token_altered, "missing_lines"),
])
def test_a_planted_fault_makes_the_run_incorrect(monkeypatch, cell, fault,
                                                 count):
    # planted when the window opens: set-up (the ingest's warm-up, the
    # server's warm-up) runs sound
    from chipbench.traffic import closed_loop, ingest_stream
    for driver in (closed_loop, ingest_stream):
        def window(ctx, seconds, spans, inner=driver.window):
            fault(monkeypatch)
            return inner(ctx, seconds, spans)
        monkeypatch.setattr(driver, "window", window)
    r = cpu_run(cell)
    assert not r["correct"]
    assert r["check"][count][0] > 0, r["check"]
