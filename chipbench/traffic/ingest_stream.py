"""One writer ingesting into a durable store, then a reopen.

Set-up makes ``supply_lines`` corpus lines, warms the write path, the
publish and the reopen on a small store that it then removes, and creates
the configuration's store, empty, in a directory under ``TMPDIR``.  In the
window one writer calls ``ingest()`` on ``chunk_lines`` lines at a time,
and a line counts once its call has returned inside the window.  The
window opens on an empty sketch buffer, so every run's window sees the
same spill cycle: the write path up to the first spill of the 32 MB sketch
buffer, the spill itself (seal, segment file, manifest swap) inside the
``ingest()`` call that fills the buffer, then the write path again.  After
the window the store is finished (the tail sealed, published) and closed,
a fresh ``DynaWarpStore.open()`` of the directory has to hold every line
whose call returned, and term queries drawn from the seed, ids of the
newest lines among them, are answered by the reopened store and compared
with the reference over those lines.
"""
from __future__ import annotations

import os
import shutil
import tempfile
import time

import numpy as np

from ..corpus import make_corpus
from ..reference.check import compare, lose_tail
from ..reference.terms import TermIndex
from . import terms as term_kinds


def make_inputs(config: dict, traffic: dict, seed: int) -> dict:
    return {"corpus": make_corpus(seed, n_lines=traffic["supply_lines"],
                                  **config["corpus"])}


def prepare(config, traffic, cell, seed, device) -> dict:
    from repro_torch.logstore.store import DynaWarpStore

    t0 = time.perf_counter()
    ctx = make_inputs(config, traffic, seed)
    ctx.update(config=config, traffic=traffic, cell=cell, seed=seed,
               device=device, root=tempfile.mkdtemp(prefix="chipbench-"),
               setup_parts={"inputs_s": time.perf_counter() - t0})
    t0 = time.perf_counter()
    warm = cell["warmup"]
    path = os.path.join(ctx["root"], "warm")
    store = DynaWarpStore(**{**config["store"], "memory_limit_bytes":
                             warm["memory_limit_bytes"]},
                          path=path, device=device)
    store.ingest(ctx["corpus"].lines[:warm["lines"]])
    store.finish()
    store.close()
    store = DynaWarpStore.open(path, device=device)
    store.query_term_batch(_sample(ctx, warm["lines"], np.random.default_rng(
        [seed, 2])))
    store.close()
    shutil.rmtree(path)
    ctx["path"] = os.path.join(ctx["root"], "store")
    ctx["store"] = DynaWarpStore(**config["store"], path=ctx["path"],
                                 device=device)
    ctx["acked"] = 0
    ctx["setup_parts"]["warmup_s"] = time.perf_counter() - t0
    return ctx


def _sample(ctx, n_lines: int, rng) -> list[str]:
    """The check's terms over the first ``n_lines`` lines: absent, once
    and present ids, and ids of the last chunk's lines (of the newest
    id-bearing lines where it holds none)."""
    corpus, size = ctx["corpus"], ctx["cell"]["check"]
    chunk = ctx["traffic"]["chunk_lines"]
    j = np.searchsorted(corpus.id_line, n_lines)
    i = np.searchsorted(corpus.id_line, n_lines - chunk)
    newest = corpus.id_value[i if i < j else max(j - 256, 0):j]
    parts = [term_kinds.KINDS[kind](corpus, rng, size[kind], n_lines)
             for kind in ("absent_id", "once_id", "present_id")]
    if newest.size:
        parts.append(newest[rng.integers(0, newest.size,
                                         size=size["newest_id"])])
    return np.concatenate(parts).astype(str).tolist()


def window(ctx, seconds: float, spans) -> dict:
    from repro_torch.logstore.store import DynaWarpStore

    store, lines = ctx["store"], ctx["corpus"].lines
    chunk = ctx["traffic"]["chunk_lines"]
    if spans is not None:
        spans.wrap(DynaWarpStore, "_index_batch", "ingest.index")
        spans.wrap(DynaWarpStore, "_write_batch", "ingest.compress_append")
    stats = store.stats
    tokens0, spills0 = stats.n_tokens_indexed, store._writer.n_spills
    publish0 = stats.publish_s
    acked = ctx["acked"]
    counted = calls = 0
    spill_calls = []    # (start, end) of each ingest() call that spilled
    start = time.perf_counter()
    end = start + seconds
    while time.perf_counter() < end:
        if acked + chunk > len(lines):
            raise RuntimeError(f"the writer ran out of its {len(lines)} "
                               f"lines: raise supply_lines")
        calls += 1
        spills, sent = store._writer.n_spills, time.perf_counter()
        store.ingest(lines[acked:acked + chunk])
        acked += chunk
        now = time.perf_counter()
        if now <= end:
            counted += chunk
        if store._writer.n_spills != spills:
            spill_calls.append((sent - start, now - start))
    ctx["acked"] = acked
    return {
        "e2e": {"ingest_lines_per_s": counted / seconds},
        "attempted": calls,
        "failed": 0,
        "lines": acked,
        "tokens": stats.n_tokens_indexed - tokens0,
        "spills": store._writer.n_spills - spills0,
        "publish_s": stats.publish_s - publish0,
        "spill_call_s": sum(min(t1, seconds) - min(t0, seconds)
                            for t0, t1 in spill_calls),
        "notes": {"spill_calls": [[round(t0, 3), round(t1, 3)]
                                  for t0, t1 in spill_calls]},
    }


def finish(ctx) -> None:
    """Finish and close the store, reopen it, and answer the check's terms
    through the reopened store's engine and post-filter."""
    from repro_torch.logstore.store import DynaWarpStore

    t = [time.perf_counter()]
    store = ctx.pop("store")
    store.finish()
    store.close()
    t.append(time.perf_counter())
    store = DynaWarpStore.open(ctx["path"], device=ctx["device"])
    t.append(time.perf_counter())
    terms = _sample(ctx, ctx["acked"],
                    np.random.default_rng([ctx["seed"], 3]))
    got = [r.matches for r in store.query_term_batch(terms)]
    t.append(time.perf_counter())
    ctx["outputs"] = (terms, got, int(store.batch_start[-1]))
    store.close()
    shutil.rmtree(ctx["root"])
    ctx["after_parts"] = dict(zip(("finish_close_s", "open_s", "queries_s"),
                                  np.diff(t).tolist()))


def _reference(ctx, terms):
    index = TermIndex(ctx["corpus"].lines[:ctx["acked"]],
                      {len(t) for t in terms})
    return [index.lines_with(t) for t in terms]


def check(ctx, outputs=None) -> dict:
    terms, got, n_lines = outputs if outputs is not None else ctx["outputs"]
    out = compare(got, _reference(ctx, terms))
    out["line_gap"] = abs(n_lines - ctx["acked"])
    return out


def control(ctx) -> tuple[list, list, int]:
    """The reference in the program's place, losing the last acknowledged
    chunk, over the check's terms."""
    terms = _sample(ctx, ctx["acked"], np.random.default_rng([ctx["seed"], 3]))
    kept = ctx["acked"] - ctx["traffic"]["chunk_lines"]
    return terms, lose_tail(_reference(ctx, terms), kept), kept
