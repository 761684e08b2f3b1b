"""The port's sharded retrieval (``core/distributed.py``) against the JAX
package, as ``tests/test_distributed.py`` holds the reference to it:
``ShardedQueryEngine`` vs the single-device ``QueryEngine`` vs the host
path (bit-identical on any shard count), per-shard uploads kept across
engine rebuilds and compaction, stable shard slots by the reference's
placement rule, heterogeneous MPHF level layouts, and the store-level
sharded wave vs the plain store and the scan store; plus the sharded cases
of ``tests/test_persistence.py`` (reopen, durable slots) and
``tests/test_faults.py`` (a concurrent snapshot reader).

The reference runs on however many devices JAX sees (one on the CPU, eight
on a forced host mesh); the port is held at 1, 3 and 8 logical CPU shards:
engines take ``devices=[cpu] * n`` and store-level cases swap in
``default_shard_devices`` with the ``logical_shards`` fixture, the
counterpart of the forced mesh.  The ``requires_cuda`` case holds 4 logical
shards on the card against the unsharded engine, with exact launch counts.
The reference is imported in fixtures and tests, so that the CUDA case also
runs where JAX is not installed.  Integer data throughout: exact equality.
"""
import threading
import time
import types
from collections import Counter

import numpy as np
import pytest
import torch

from repro_torch.core import batch_builder as port_bb
from repro_torch.core import distributed
from repro_torch.core import immutable_sketch as port_sk
from repro_torch.core.distributed import (ShardedQueryEngine,
                                          default_shard_devices)
from repro_torch.core.query_engine import QueryEngine
from repro_torch.logstore.datasets import id_queries, present_id_queries
from repro_torch.logstore.store import DynaWarpStore

CPU = torch.device("cpu")
SHARDS = (1, 3, 8)
N_POST = 90
# five segments, two MPHF level layouts (the reference compiles one probe
# per segment: ~4 s each on the CPU)
PARITY_SIZES = (700, 2600, 700, 1500, 300)
# twelve segments of six level layouts
FLEET_SIZES = (200, 3000, 800, 200, 5000, 50, 1200, 400, 2600, 90, 700, 1600)
KW = dict(batch_lines=64, mode="segmented", memory_limit_bytes=1 << 14,
          auto_compact=False)
# the writer merges no temporaries: 17 segments, 3 after compact(fanout=2)
MANY_KW = dict(KW, memory_limit_bytes=1 << 13, compact_fanout=16)
TIMEOUT = 300


# ------------------------------------------------------------- the fleets
def _fleet_data(seed, sizes):
    """(fps, postings) of each segment: ``n * 4`` pairs over ``n`` tokens."""
    rng = np.random.default_rng(seed)
    out = []
    for n in sizes:
        fps = (rng.integers(0, n, 4 * n).astype(np.uint64)
               * 2654435761 % (1 << 32)).astype(np.uint32)
        out.append((fps, rng.integers(0, N_POST, fps.size).astype(np.int64)))
    return out


def _build(data, bb=port_bb, sk=port_sk, **kw):
    return [sk.build_immutable(bb.build_sealed(f, p), **kw) for f, p in data]


def _queries(data, seed, n=40):
    """Empty queries, 1..5 tokens that share a posting (so that most AND
    answers are not empty), absent fingerprints."""
    rng = np.random.default_rng(seed)
    fps = np.concatenate([f for f, _ in data])
    posts = np.concatenate([p for _, p in data])
    queries = [[]]
    for i in range(n):
        near = np.unique(fps[posts == rng.integers(0, N_POST)])
        q = [int(x) for x in rng.choice(near, min(1 + i % 5, near.size),
                                        replace=False)]
        if i % 3 == 1:
            q[int(rng.integers(0, len(q)))] = int(rng.integers(0, 2**32))
        queries.append(q)
    return queries


def _logical(n):
    return [CPU] * n


class _Slot:
    """A stand-in segment for the reference's placement rule."""

    def __init__(self, slot):
        self.slot = slot

    def get_shard_slot(self):
        return self.slot

    def set_shard_slot(self, slot):
        self.slot = slot


def _reference_slots(prior, n_shards):
    """The slots the reference's ``ShardedQueryEngine._assign_shards`` gives
    a fleet whose slots were ``prior`` (None: fresh), over ``n_shards``."""
    from repro.core.distributed import ShardedQueryEngine as RefSharded
    stand = [_Slot(p) for p in prior]
    RefSharded._assign_shards(types.SimpleNamespace(
        _plane_segs=list(enumerate(stand)), n_shards=n_shards))
    return [s.slot for s in stand]


@pytest.fixture(scope="module")
def parity():
    """The parity fleet's data, its queries and the reference engine's
    device-wave answers over byte-identical segments (one JAX wave an op)."""
    from repro.core import batch_builder as ref_bb
    from repro.core import immutable_sketch as ref_sk
    from repro.core.query_engine import QueryEngine as RefEngine
    data = _fleet_data(7, PARITY_SIZES)
    ref = RefEngine(_build(data, ref_bb, ref_sk), n_postings=N_POST)
    queries = _queries(data, 8)
    return data, queries, {op: ref.query_fps_batch(queries, op=op)
                           for op in ("and", "or")}


@pytest.fixture
def logical_shards(monkeypatch):
    """``logical_shards(n)`` makes every store's sharded engine spread over
    n logical shards of its device (the forced host mesh's counterpart)."""
    def force(n):
        monkeypatch.setattr(
            distributed, "default_shard_devices",
            lambda shard_axes=("data",), device=None:
            [torch.device(device)] * n)
    return force


@pytest.fixture(scope="module")
def scan(small_dataset):
    from repro.logstore.store import ScanStore
    s = ScanStore(batch_lines=64)
    s.ingest(small_dataset.lines)
    s.finish()
    return s


def _terms(ds):
    return present_id_queries(ds, 3, 6) + id_queries(13, 3) + ["info", "gc"]


# ------------------------------------------------------------- equivalence
@pytest.mark.parametrize("shard_axes", [("data",), ("pod", "data")])
@pytest.mark.parametrize("n_shards", SHARDS)
def test_sharded_matches_reference_engine_and_host(parity, n_shards,
                                                   shard_axes):
    data, queries, want = parity
    segs = _build(data)
    eng = ShardedQueryEngine(segs, devices=_logical(n_shards),
                             shard_axes=shard_axes, n_postings=N_POST)
    assert eng.n_shards == n_shards and eng.device == CPU
    assert eng.slots == _reference_slots([None] * len(segs), n_shards)
    for op in ("and", "or"):
        got = eng.query_fps_batch(queries, op=op)
        assert len(got) == len(queries)
        for q, g, w in zip(queries, got, want[op]):
            assert g.dtype == np.int64
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(g, eng.host_query(q, op=op))
    assert sum(len(g) > 0 for g in got) > len(queries) // 2
    assert eng.upload_count == len(segs)


@pytest.mark.parametrize("n_shards", (3, 8))
def test_heterogeneous_layouts_answer_alike(n_shards):
    """Segments of different MPHF level layouts, and a plane-less one that
    takes the host path, answer as the single-device engine and the
    reference's host path on the same data."""
    from repro.core import batch_builder as ref_bb
    from repro.core import immutable_sketch as ref_sk
    from repro.core.query_engine import QueryEngine as RefEngine
    data = _fleet_data(3, FLEET_SIZES)
    kws = [{"plane_budget_bytes": 0} if i == 4 else {}
           for i in range(len(data))]
    segs = [port_sk.build_immutable(port_bb.build_sealed(f, p), **kw)
            for (f, p), kw in zip(data, kws)]
    assert len({tuple(int(x) for x in s.mphf.level_bits)
                for s in segs}) > 1
    assert segs[4].planes is None
    ref = RefEngine([ref_sk.build_immutable(ref_bb.build_sealed(f, p), **kw)
                     for (f, p), kw in zip(data, kws)], n_postings=N_POST)
    shard = ShardedQueryEngine(segs, devices=_logical(n_shards),
                               n_postings=N_POST)
    single = QueryEngine(segs, n_postings=N_POST, device=CPU)
    assert len(shard._plane_segs) == len(segs) - 1
    assert sum(map(len, shard._by_shard)) == len(segs) - 1
    queries = _queries(data, 4, n=24)
    for op in ("and", "or"):
        for q, x, y in zip(queries, single.query_fps_batch(queries, op=op),
                           shard.query_fps_batch(queries, op=op)):
            np.testing.assert_array_equal(x, y)
            np.testing.assert_array_equal(y, ref.host_query(q, op=op))


# ------------------------------------------------------------ upload cache
@pytest.mark.parametrize("n_shards", (3, 8))
def test_per_shard_buffers_upload_exactly_once(n_shards):
    data = _fleet_data(11, FLEET_SIZES[:9])
    segs = _build(data)
    queries = _queries(data, 12, n=8)
    eng = ShardedQueryEngine(segs, devices=_logical(n_shards),
                             n_postings=N_POST)
    for _ in range(3):                  # several waves, several buckets
        eng.query_fps_batch(queries)
        eng.query_fps_batch(queries[:2], op="or")
    assert eng.upload_count == len(segs), \
        "each segment must upload exactly once"
    # a rebuild (and a serving replica) reuse every upload and every slot
    for again in (ShardedQueryEngine(segs, devices=_logical(n_shards),
                                     n_postings=N_POST), eng.clone()):
        assert again.slots == eng.slots and again.devices == eng.devices
        again.query_fps_batch(queries[:3])
        assert again.upload_count == 0
    # ... and a changed fleet uploads ONLY the new segment, which goes to
    # the least-loaded shard
    merged = port_sk.build_immutable(port_bb.build_sealed(
        np.zeros(1, np.uint32), np.zeros(1, np.int64)))
    eng3 = ShardedQueryEngine(segs[:-1] + [merged],
                              devices=_logical(n_shards), n_postings=N_POST)
    eng3.query_fps_batch(queries[:3])
    assert eng3.upload_count == 1
    assert eng3.slots == _reference_slots(eng.slots[:-1] + [None], n_shards)


@pytest.mark.parametrize("n_shards", (3, 8))
def test_slots_follow_the_reference_rule(n_shards):
    """Kept slots stay while in range; fresh and out-of-range segments fill
    the least-loaded shard in segment order, the lowest on a tie — slot for
    slot the reference's rule, on a fleet with pre-set slots.  Segments
    whose slot is set to None are placed anew."""
    segs = _build(_fleet_data(5, FLEET_SIZES))
    prior = [None, 1, n_shards + 2, 0, None, n_shards - 1, 0, None, 9, 1,
             None, 2]
    for seg, slot in zip(segs, prior):
        seg.set_shard_slot(slot)
    eng = ShardedQueryEngine(segs, devices=_logical(n_shards))
    assert eng.slots == _reference_slots(prior, n_shards)
    assert [s.get_shard_slot() for s in segs] == eng.slots
    assert [len(g) for g in eng._by_shard] == [
        Counter(eng.slots)[k] for k in range(n_shards)]
    for seg in segs:
        seg.set_shard_slot(None)
    assert all(s.get_shard_slot() is None for s in segs)
    again = ShardedQueryEngine(segs, devices=_logical(n_shards))
    assert again.slots == [i % n_shards for i in range(len(segs))]


def test_default_shard_devices_put_the_engine_device_first(monkeypatch):
    for axes in (("data",), ("pod", "data")):
        assert default_shard_devices(axes, "cpu") == [CPU]
    with pytest.raises(ValueError):
        default_shard_devices((), "cpu")
    segs = _build(_fleet_data(2, (300, 400)))
    eng = ShardedQueryEngine(segs, device="cpu")
    assert eng.devices == [CPU] and eng.n_shards == 1 and eng.device == CPU
    with pytest.raises(ValueError):
        ShardedQueryEngine(segs, devices=[])
    # no card: nothing falls back to the CPU unless asked for
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ShardedQueryEngine(segs)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    cuda = [torch.device("cuda", i) for i in range(3)]
    assert default_shard_devices(("data",), "cuda:1") == [cuda[1], cuda[0],
                                                          cuda[2]]
    assert default_shard_devices(("pod", "data"), "cuda:0") == cuda
    with pytest.raises(ValueError, match="several types"):
        ShardedQueryEngine(segs, devices=["cpu", "cuda:0"])
    with pytest.raises(ValueError, match="first shard"):
        ShardedQueryEngine(segs, devices=["cuda:1", "cuda:0"],
                           device="cuda:0")


# ------------------------------------------------------------- store level
@pytest.mark.parametrize("n_shards", SHARDS)
def test_sharded_store_matches_plain_and_scan(small_dataset, scan,
                                              logical_shards, n_shards):
    logical_shards(n_shards)
    plain = DynaWarpStore(**KW, device="cpu")
    shard = DynaWarpStore(**KW, device="cpu", shard_axes=("data",))
    for s in (plain, shard):
        s.ingest(small_dataset.lines)
        s.finish()
    assert type(plain.engine) is QueryEngine
    assert isinstance(shard.engine, ShardedQueryEngine)
    assert shard.engine.n_shards == n_shards
    assert len(shard.segments) > 1
    terms = _terms(small_dataset)
    for t, x, y in zip(terms, plain.query_term_batch(terms),
                       shard.query_term_batch(terms)):
        assert x.matches == y.matches == scan.query_term(t).matches, t
        np.testing.assert_array_equal(x.candidate_batches,
                                      y.candidate_batches)
    sub = terms[0][2:12]
    assert shard.query_contains(sub).matches \
        == scan.query_contains(sub).matches


@pytest.mark.parametrize("n_shards", (3, 8))
def test_store_compaction_keeps_shard_slots_and_caches(small_dataset, scan,
                                                       logical_shards,
                                                       n_shards):
    logical_shards(n_shards)
    s = DynaWarpStore(**MANY_KW, device="cpu", shard_axes=("data",))
    s.ingest(small_dataset.lines)
    s.finish()
    eng = s.engine
    terms = _terms(small_dataset)
    before = s.query_term_batch(terms)
    assert eng.upload_count == len(eng._plane_segs) > n_shards
    placed = [(seg, slot) for (_, seg), slot in zip(eng._plane_segs,
                                                    eng.slots)]
    merges = s.compact(fanout=2)
    assert merges > 0
    new = s.engine
    assert isinstance(new, ShardedQueryEngine) and new.n_shards == n_shards
    after = s.query_term_batch(terms)
    for t, x, y in zip(terms, before, after):
        assert x.matches == y.matches == scan.query_term(t).matches, t
    prior = [next((was for old, was in placed if old is seg), None)
             for _, seg in new._plane_segs]
    survivors = sum(p is not None for p in prior)
    assert survivors and survivors < len(prior)
    # survivors kept their slots, merged segments took the rule's, and
    # only the merged segments uploaded
    assert new.slots == _reference_slots(prior, n_shards)
    assert new.upload_count == len(prior) - survivors


# ----------------------------------------------------------------- durable
def _durable(ds, path):
    s = DynaWarpStore(**KW, device="cpu", path=path, shard_axes=("data",))
    s.ingest(ds.lines)
    s.finish()
    s.close()


@pytest.mark.parametrize("n_shards", (1, 8))
def test_sharded_reopen_is_bit_identical(small_dataset, tmp_path,
                                         logical_shards, n_shards):
    """A sharded engine over a reopened store == the in-RAM single-device
    store's candidates."""
    logical_shards(n_shards)
    ram = DynaWarpStore(**KW, device="cpu")
    ram.ingest(small_dataset.lines)
    ram.finish()
    d = str(tmp_path / "store")
    _durable(small_dataset, d)
    re = DynaWarpStore.open(d, shard_axes=("data",), device="cpu")
    assert isinstance(re.engine, ShardedQueryEngine)
    assert re.engine.n_shards == n_shards
    qs = _terms(small_dataset)
    for a, b in zip(ram.candidates_term_batch(qs),
                    re.candidates_term_batch(qs)):
        np.testing.assert_array_equal(a, b)
    re.close()


def test_durable_shard_slots_keyed_by_durable_id(small_dataset, tmp_path,
                                                 logical_shards):
    """A second open() re-uploads nothing and finds every segment's slot by
    its durable id; discarding a durable id drops its slot with its
    buffers, and close() drops them all."""
    logical_shards(3)
    d = str(tmp_path / "store")
    _durable(small_dataset, d)
    qs = _terms(small_dataset)
    first = DynaWarpStore.open(d, shard_axes=("data",), device="cpu")
    want = first.candidates_term_batch(qs)
    assert first.engine.upload_count == len(first.engine._plane_segs) > 3
    assert first.engine.slots == _reference_slots(
        [None] * len(first.engine.slots), 3)
    again = DynaWarpStore.open(d, shard_axes=("data",), device="cpu")
    assert all(a is not b for a, b in zip(first.segments, again.segments))
    assert [s.get_shard_slot() for s in again.segments] == first.engine.slots
    for a, b in zip(want, again.candidates_term_batch(qs)):
        np.testing.assert_array_equal(a, b)
    assert again.engine.upload_count == 0
    assert again.engine.slots == first.engine.slots
    seg = again.segments[0]
    port_sk.discard_durable_caches(seg.durable_id)
    assert seg.get_shard_slot() is None
    assert first.segments[0].get_shard_slot() is None
    assert not seg.has_device_cache(CPU)
    assert all(s.get_shard_slot() is not None for s in again.segments[1:])
    again.close()
    assert all(s.get_shard_slot() is None for s in first.segments)


def test_concurrent_reader_sees_consistent_sharded_snapshots(
        small_dataset, scan, tmp_path, logical_shards):
    """A reader thread runs query_term_batch on snapshots of a sharded
    store while the writer ingests and publishes per spill: every result
    equals the scan oracle over that snapshot's manifested prefix."""
    logical_shards(3)
    s = DynaWarpStore(**KW, device="cpu", path=str(tmp_path / "live"),
                      shard_axes=("data",))
    terms = present_id_queries(small_dataset, 3, 3) + ["info", "connection"]
    truth = {t: scan.query_term(t).matches for t in terms}
    errors: list = []
    checks, sharded = [0], [0]
    done = threading.Event()
    deadline = time.monotonic() + TIMEOUT

    def reader():
        while (not done.is_set() or checks[0] == 0) \
                and time.monotonic() < deadline:
            snap = s.snapshot()
            try:
                results = snap.query_term_batch(terms)
            except Exception as e:          # pragma: no cover - failure path
                errors.append(repr(e))
                return
            for t, r in zip(terms, results):
                if r.matches != [m for m in truth[t] if m < snap.n_lines]:
                    errors.append((t, snap.n_lines))
                    return
            sharded[0] += isinstance(snap.engine, ShardedQueryEngine)
            checks[0] += 1

    rt = threading.Thread(target=reader, daemon=True)
    rt.start()
    try:
        for i in range(0, len(small_dataset.lines), 100):
            s.ingest(small_dataset.lines[i:i + 100])
        s.finish()
    finally:
        done.set()
        rt.join(timeout=TIMEOUT)
    assert not rt.is_alive(), "reader thread wedged"
    assert not errors, errors[:3]
    assert checks[0] > 0 and sharded[0] > 0
    assert isinstance(s.snapshot().engine, ShardedQueryEngine)
    s.close()


# ------------------------------------------------------- CUDA, on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.requires_cuda
def test_cuda_four_logical_shards_match_the_unsharded_engine(cuda):
    """4 logical shards on the card answer as the unsharded engine and the
    host path, with one token_hash launch a wave, one fused probe a
    segment, one fold and one extraction — the unsharded engine's counts —
    and one upload a segment shared by both engines."""
    from repro_torch.kernels.bitmap_extract.ops import bitmap_extract_ragged
    from repro_torch.kernels.bitset_ops.ops import bitset_reduce_ragged
    from repro_torch.kernels.sketch_probe.ops import match_planes
    from repro_torch.kernels.token_hash.ops import token_fingerprints
    data = _fleet_data(9, FLEET_SIZES)
    segs = _build(data)
    queries = [[int(fp).to_bytes(4, "little") if i % 2 else int(fp)
                for i, fp in enumerate(q)] for q in _queries(data, 10)]
    plain = QueryEngine(segs, n_postings=N_POST, device=cuda)
    shard = ShardedQueryEngine(segs, devices=[cuda] * 4, n_postings=N_POST)
    assert shard.device == cuda
    assert sorted(Counter(shard.slots).values()) == [3, 3, 3, 3]
    entries = (token_fingerprints, match_planes, bitset_reduce_ragged,
               bitmap_extract_ragged)
    counts = {}
    for name, eng in (("plain", plain), ("sharded", shard)):
        for op in ("and", "or"):
            at = [e.launch_count for e in entries]
            got = eng.query_batch(queries, op=op)
            torch.cuda.synchronize()
            counts[name, op] = [e.launch_count - a
                                for e, a in zip(entries, at)]
            for q, g in zip(queries, got):
                np.testing.assert_array_equal(g, eng.host_query(q, op=op))
            if name == "sharded":
                for g, w in zip(got, plain.query_batch(queries, op=op)):
                    np.testing.assert_array_equal(g, w)
    for op in ("and", "or"):
        assert counts["sharded", op] == counts["plain", op] \
            == [1, len(segs), 1, 1]
    assert plain.upload_count == len(segs) and shard.upload_count == 0
