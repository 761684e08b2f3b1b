"""What the port's kernels must hold when waves run on several threads at
once (the serving front end's workers):

  * concurrent first calls of ``build.library`` build each library once;
  * every wrapper's ``launch_count`` stays exact under threads;
  * on the card, concurrent scheduler waves over two engine replicas give
    the direct wave's answers and launch each kernel exactly as often as
    the waves need.

The JAX package is not imported, so the ``requires_cuda`` cases also run
where JAX is not installed; they skip where there is no card.
"""
import shutil
import subprocess
import sys
import threading
from collections import Counter
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels.bitmap_extract.ops import bitmap_extract_ragged
from repro_torch.kernels.bitset_ops.ops import bitset_reduce_ragged
from repro_torch.kernels.sketch_probe.ops import match_planes
from repro_torch.kernels.token_hash.ops import token_fingerprints

TIMEOUT = 120
N_THREADS = 8


def _race(fn, n=N_THREADS):
    """Run ``fn(i)`` on ``n`` threads released together; returns their
    results in thread order, re-raising the first error."""
    barrier = threading.Barrier(n)
    out, errors = [None] * n, []

    def run(i):
        barrier.wait(TIMEOUT)
        try:
            out[i] = fn(i)
        except BaseException as e:          # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,), daemon=True)
               for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(TIMEOUT)
        assert not t.is_alive(), "thread hung"
    if errors:
        raise errors[0]
    return out


@pytest.fixture
def fresh_build_dir(tmp_path, monkeypatch):
    """``build`` with an empty build directory and nothing loaded."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(build, "_LIBS", {})
    return tmp_path / "kernels"


class _FakeCompile:
    """Stands in for an nvcc process: writes its output file a little
    later, as a compile would, and counts the sources it was given."""

    calls: Counter

    def __init__(self, cmd, **_kw):
        self.calls[Path(cmd[-1]).stem] += 1
        self._out = Path(cmd[cmd.index("-o") + 1])
        self.returncode = 0

    def communicate(self):
        threading.Event().wait(0.02)
        self._out.write_bytes(b"")
        return "", None


def test_concurrent_first_library_calls_build_each_library_once(
        fresh_build_dir, monkeypatch):
    """8 threads ask for every library at once on an empty build
    directory: each source is compiled once, and every thread gets the
    same loaded library."""
    calls = Counter()
    fake = type("Compile", (_FakeCompile,), {"calls": calls})
    monkeypatch.setattr(build, "subprocess", SimpleNamespace(
        Popen=fake, PIPE=subprocess.PIPE, STDOUT=subprocess.STDOUT))
    monkeypatch.setattr(build, "ctypes", SimpleNamespace(
        CDLL=lambda path: SimpleNamespace(
            path=path, kernel_error_string=SimpleNamespace()),
        c_int=None, c_char_p=None))
    names = list(build.SOURCES)
    got = _race(lambda i: {n: build.library(n)
                           for n in names[i % 3:] + names[:i % 3]})
    assert calls == Counter({n: 1 for n in names})
    for n in names:
        assert len({id(libs[n]) for libs in got}) == 1, n
    assert sorted(p.name for p in fresh_build_dir.iterdir()) == sorted(
        build._target(n)[1].name for n in names)


@pytest.mark.parametrize("wrapper", [match_planes, bitset_reduce_ragged,
                                     bitmap_extract_ragged,
                                     token_fingerprints],
                         ids=lambda f: f.__name__)
def test_launch_count_is_exact_under_threads(wrapper):
    """8 threads each count 10,000 launches of one wrapper (with the
    interpreter switching threads as often as it can): none is lost."""
    before = wrapper.launch_count
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        _race(lambda i: [build.count_launch(wrapper) for _ in range(10_000)])
    finally:
        sys.setswitchinterval(interval)
    assert wrapper.launch_count == before + N_THREADS * 10_000
    wrapper.launch_count = before           # reset by assignment
    assert wrapper.launch_count == before


# ------------------------------------------------------ CUDA, on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.requires_cuda
def test_cuda_concurrent_first_builds_compile_once(cuda, fresh_build_dir,
                                                   monkeypatch):
    """The same race with the real nvcc, on an empty build directory."""
    if shutil.which(build._nvcc()) is None:
        pytest.skip("needs nvcc")
    calls = Counter()
    real = subprocess.Popen

    def counting(cmd, **kw):
        calls[Path(cmd[-1]).stem] += 1
        return real(cmd, **kw)

    monkeypatch.setattr(build, "subprocess", SimpleNamespace(
        Popen=counting, PIPE=subprocess.PIPE, STDOUT=subprocess.STDOUT))
    libs = _race(lambda i: build.library("bitset_ops"))
    assert calls == Counter({n: 1 for n in build.SOURCES})
    assert len({id(lib) for lib in libs}) == 1


@pytest.mark.requires_cuda
def test_cuda_scheduler_waves_on_two_replicas(cuda):
    """Concurrent clients through a WaveScheduler over two replicas on the
    card, every wave forced to the device: answers equal the direct wave,
    and the kernels launch once a segment (probe), once a wave (fold) and
    once a wave with an answer (extraction), none lost across threads."""
    from repro_torch.core.serving import CostModel, WaveScheduler, _as_fp
    from repro_torch.core.tokenizer import term_query_tokens
    from repro_torch.logstore.datasets import (generate_dataset, id_queries,
                                               present_id_queries)
    from repro_torch.logstore.store import DynaWarpStore

    ds = generate_dataset("threads", n_lines=3000, n_sources=12, seed=7)
    store = DynaWarpStore(batch_lines=64, mode="segmented",
                          memory_limit_bytes=1 << 15, device=cuda)
    store.ingest(ds.lines)
    store.finish()
    eng = store.engine
    terms = present_id_queries(ds, 3, 16) + id_queries(5, 16)
    fps = [[_as_fp(t) for t in term_query_tokens(x)] for x in terms]
    truth = eng.query_fps_batch(fps)
    n_planes = len(eng._plane_segs)
    sched = WaveScheduler([eng, eng.clone()], flush_deadline_s=0.002,
                          max_live_waves=2, cost_model=CostModel(
                              host_us_per_query=1e9,
                              device_us_per_wave={8: 1.0}))
    entries = (match_planes, bitset_reduce_ragged, bitmap_extract_ragged)
    before = [e.launch_count for e in entries]
    tickets = []
    try:
        def client(i):
            rng = np.random.default_rng(i)
            mine = []
            for _ in range(64):
                qi = int(rng.integers(len(fps)))
                mine.append((qi, sched.submit(fps[qi])))
            return mine
        for mine in _race(client):
            tickets += mine
        answers = [(qi, t.wait(TIMEOUT), t) for qi, t in tickets]
    finally:
        sched.close()
    for qi, got, _ in answers:
        assert np.array_equal(got, truth[qi])
    st = sched.stats()
    assert st.device_waves == st.waves > 0 and st.host_waves == 0
    assert set(st.replica_waves) == {0, 1}
    waves = {}
    for _, got, t in answers:
        waves[t.wave_id] = waves.get(t.wave_id, False) or got.size > 0
    fused, fold, extract = (e.launch_count - b
                            for e, b in zip(entries, before))
    assert fused == n_planes * st.device_waves
    assert fold == st.device_waves
    assert extract == sum(waves.values())
    assert eng.upload_count == len(eng.segments)
