"""The port's wave-coalescing serving front end (``core/serving.py``)
against the contract ``tests/test_serving.py`` holds the JAX package to,
plus what only two packages can show.

  * answers served through coalesced waves are BIT-IDENTICAL to direct
    engine waves, under N concurrent client threads;
  * a lone straggler is flushed by the deadline trigger, a full group
    by the size trigger, and everything pending by ``close()`` (drain);
  * padding to the supported bucket sizes round-trips;
  * admission control BLOCKS ``submit()`` at ``max_pending`` — it never
    drops a query — and ``max_live_waves`` bounds concurrent waves;
  * waves route round-robin over engine replicas with identical results;
    an engine error fails its wave's tickets (never retried on the host
    path) but the scheduler keeps serving;
  * the measured cost model keeps its machine-readable shape, and the
    JSON either package writes loads in the other;
  * a :class:`StoreServer` over a live durable store answers every query
    exactly over SOME published prefix, through writer progress,
    ``refresh()`` races and a writer crash, and recovery converges;
  * the port's and the reference's ``StoreServer`` give equal candidates
    and matches on the same data, through device waves and the host path;
  * ``launch/serve.py --arch dynawarp`` serves a built store and a durable
    directory written by the port.

Every port store runs on ``device="cpu"`` (the kernels' plain versions).
Every blocking call has an explicit timeout.
"""
import json
import threading
import time

import numpy as np
import pytest

from repro.core import serving as ref_serving
from repro.logstore import store as ref_store
from repro_torch.core import faults
from repro_torch.core.serving import (COST_MODEL_FORMAT, CostModel,
                                      StoreServer, WaveScheduler,
                                      measure_dispatch_costs)
from repro_torch.core.tokenizer import term_query_tokens
from repro_torch.launch import serve as port_serve
from repro_torch.logstore.datasets import id_queries, present_id_queries
from repro_torch.logstore.store import DynaWarpStore, ScanStore

TIMEOUT = 120           # ceiling for any single blocking wait
KW = dict(batch_lines=64, mode="segmented", memory_limit_bytes=1 << 14,
          auto_compact=False)

#: Force the scalar host path.
HOST_MODEL = CostModel(host_us_per_query=1.0,
                       device_us_per_wave={8: 1e9})
#: Force the device wave path (tests that must exercise padding).
DEVICE_MODEL = CostModel(host_us_per_query=1e9,
                         device_us_per_wave={8: 1.0})


@pytest.fixture(scope="module")
def store(small_dataset):
    s = DynaWarpStore(device="cpu", **KW)
    s.ingest(small_dataset.lines)
    s.finish()
    return s


@pytest.fixture(scope="module")
def scan_oracle(small_dataset):
    s = ScanStore(batch_lines=64)
    s.ingest(small_dataset.lines)
    s.finish()
    return s


@pytest.fixture(scope="module")
def queries(small_dataset):
    """(terms, token_lists) — a mix of present IDs and common words."""
    terms = present_id_queries(small_dataset, 3, 8) \
        + id_queries(5, 2) + ["info", "connection"]
    return terms, [term_query_tokens(t) for t in terms]


@pytest.fixture(scope="module")
def truth(store, queries):
    _, token_lists = queries
    return [np.asarray(r, np.int64)
            for r in store.engine.query_batch(token_lists, op="and")]


def _same(results, expect):
    return all(np.array_equal(np.asarray(r, np.int64), e)
               for r, e in zip(results, expect))


# ------------------------------------------------------------- cost model
def test_cost_model_decision_and_roundtrip(tmp_path):
    m = CostModel(host_us_per_query=100.0,
                  device_us_per_wave={8: 1000.0, 32: 2000.0})
    # bucket lookup: smallest covering bucket; extrapolation past top
    assert m.device_wave_us(4) == 1000.0
    assert m.device_wave_us(8) == 1000.0
    assert m.device_wave_us(9) == 2000.0
    assert m.device_wave_us(64) == pytest.approx(4000.0)
    # n * host <= wave(bucket) -> host
    assert m.prefer_host(8, 8)          # 800 <= 1000
    assert not m.prefer_host(11, 8)     # 1100 > 1000
    assert m.prefer_host(20, 32)        # 2000 <= 2000 (tie -> host)
    # dict + file round-trip
    m2 = CostModel.from_dict(m.to_dict())
    assert m2.host_us_per_query == m.host_us_per_query
    assert m2.device_us_per_wave == m.device_us_per_wave
    p = tmp_path / "cm.json"
    p.write_text(json.dumps(m.to_dict()))
    assert CostModel.load(str(p)).device_us_per_wave == m.device_us_per_wave
    with pytest.raises(ValueError):
        CostModel.from_dict({"format": COST_MODEL_FORMAT + 1,
                             "host_us_per_query": 1,
                             "device_us_per_wave": {"8": 1}})
    with pytest.raises(ValueError):
        CostModel(device_us_per_wave={})


def test_cost_model_measurement_shape(store, queries):
    """``measure_dispatch_costs`` emits the machine-readable shape
    ``CostModel.from_dict`` consumes, naming the engine's device type."""
    _, token_lists = queries
    model = measure_dispatch_costs(store.engine, token_lists[:4],
                                   buckets=(8,), reps=1, host_samples=4)
    assert model["format"] == COST_MODEL_FORMAT
    assert model["host_us_per_query"] > 0
    assert set(model["device_us_per_wave"]) == {"8"}
    assert all(v > 0 for v in model["device_us_per_wave"].values())
    assert model["n_segments"] == len(store.engine.segments)
    assert model["backend"] == "cpu" and model["reps"] == 1
    cm = CostModel.from_dict(model)
    assert isinstance(cm.prefer_host(1, 8), (bool, np.bool_))


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_cost_model_json_loads_in_the_other_package(store, queries,
                                                    tmp_path, writer):
    """The format is the JAX package's: a ``bench_costmodel.json`` written
    by either package loads in the other with the same decisions."""
    _, token_lists = queries
    measured = measure_dispatch_costs(store.engine, token_lists[:4],
                                      buckets=(8, 16), reps=1,
                                      host_samples=4)
    src, dst = ((CostModel, ref_serving.CostModel) if writer == "port"
                else (ref_serving.CostModel, CostModel))
    written = src.from_dict(measured)
    p = tmp_path / "bench_costmodel.json"
    p.write_text(json.dumps(written.to_dict()))
    read = dst.load(str(p))
    assert read.to_dict() == written.to_dict()
    for n, b in ((1, 8), (8, 8), (16, 16), (64, 64)):
        assert bool(read.prefer_host(n, b)) == bool(written.prefer_host(n, b))
    # the raw measurement, with its provenance keys, loads as well
    assert dst.from_dict(measured).to_dict() == written.to_dict()


# ------------------------------------------------------------ equivalence
def test_concurrent_clients_bit_identical(store, queries, truth):
    """8 client threads hammer one scheduler; every answer must equal
    the direct engine wave, and queries must actually coalesce."""
    _, token_lists = queries
    n_clients, per_client = 8, 20
    sched = WaveScheduler([store.engine], flush_deadline_s=0.02,
                          max_live_waves=2, cost_model=HOST_MODEL)
    errors: list = []

    def client(ci):
        rng = np.random.default_rng(ci)
        for _ in range(per_client):
            qi = int(rng.integers(len(token_lists)))
            r = sched.query(token_lists[qi], timeout=TIMEOUT)
            if not np.array_equal(np.asarray(r, np.int64), truth[qi]):
                errors.append(qi)
    try:
        threads = [threading.Thread(target=client, args=(ci,), daemon=True)
                   for ci in range(n_clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT)
            assert not t.is_alive(), "client thread hung"
    finally:
        sched.close()
    assert not errors
    st = sched.stats()
    assert st.submitted == st.completed == n_clients * per_client
    assert st.failed == 0
    # coalescing happened: far fewer waves than queries
    assert st.waves < st.completed / 2, (st.waves, st.completed)
    assert st.max_wave > 1


def test_device_wave_bit_identical_with_padding(store, queries, truth):
    """The device path: one scheduler, buckets (4, 8), forced device
    model.  Waves of 1/3/4/5/7/8 queries pad to the smallest covering
    bucket, unpad on completion, and stay bit-identical."""
    _, token_lists = queries
    t_len = len(token_lists[0])
    same_t = [tl for tl in token_lists if len(tl) == t_len]
    idx = [i for i, tl in enumerate(token_lists) if len(tl) == t_len]
    assert len(same_t) >= 4
    sched = WaveScheduler([store.engine], bucket_sizes=(4, 8),
                          flush_deadline_s=0.05, max_live_waves=1,
                          cost_model=DEVICE_MODEL)
    try:
        padded = 0
        for n in (1, 3, 4, 5, 7, 8):
            wave = [same_t[i % len(same_t)] for i in range(n)]
            expect = [truth[idx[i % len(same_t)]] for i in range(n)]
            tickets = [sched.submit(tl) for tl in wave]
            results = [t.wait(TIMEOUT) for t in tickets]
            assert _same(results, expect), f"wave n={n} diverged"
            assert all(t.via == "device" for t in tickets)
            bucket = 4 if n <= 4 else 8
            padded += bucket - n
        st = sched.stats()
        assert st.device_waves >= 6 and st.host_waves == 0
        assert st.padded_slots == padded, (st.padded_slots, padded)
    finally:
        sched.close()


def test_replica_routing_identical(store, queries, truth):
    """Waves round-robin over clone replicas; results don't depend on
    which replica served them."""
    _, token_lists = queries
    sched = WaveScheduler([store.engine, store.engine.clone()],
                          flush_deadline_s=0.001, max_live_waves=2,
                          cost_model=HOST_MODEL)
    try:
        for _ in range(4):          # several wave generations
            results = sched.query_batch(token_lists, timeout=TIMEOUT)
            assert _same(results, truth)
            time.sleep(0.005)       # let the deadline cut new waves
        st = sched.stats()
        assert set(st.replica_waves) == {0, 1}, st.replica_waves
        assert all(v > 0 for v in st.replica_waves.values())
    finally:
        sched.close()


# ---------------------------------------------------------- flush triggers
def test_deadline_flush_serves_lone_straggler(store, queries, truth):
    _, token_lists = queries
    sched = WaveScheduler([store.engine], flush_deadline_s=0.2,
                          cost_model=HOST_MODEL)
    try:
        t0 = time.monotonic()
        r = sched.query(token_lists[0], timeout=TIMEOUT)
        dt = time.monotonic() - t0
    finally:
        sched.close()
    assert np.array_equal(np.asarray(r, np.int64), truth[0])
    # not before the deadline, not unboundedly after it
    assert 0.15 <= dt <= 5.0, dt
    st = sched.stats()
    assert st.deadline_flushes == 1 and st.size_flushes == 0


def test_size_flush_fires_without_deadline(store, queries, truth):
    """A group reaching the largest bucket flushes immediately even
    with an (effectively) infinite deadline."""
    _, token_lists = queries
    t_len = len(token_lists[0])
    same = [(i, tl) for i, tl in enumerate(token_lists)
            if len(tl) == t_len][:2]
    sched = WaveScheduler([store.engine], bucket_sizes=(2,),
                          flush_deadline_s=60.0, cost_model=HOST_MODEL)
    try:
        tickets = [sched.submit(tl) for _i, tl in same]
        results = [t.wait(TIMEOUT) for t in tickets]
        assert _same(results, [truth[i] for i, _ in same])
        assert sched.stats().size_flushes >= 1
    finally:
        sched.close()


def test_close_drains_pending_and_rejects_new(store, queries, truth):
    """close() flushes everything still queued as drain waves; nothing
    is lost, and later submits raise instead of hanging."""
    _, token_lists = queries
    sched = WaveScheduler([store.engine], flush_deadline_s=60.0,
                          max_live_waves=1, cost_model=HOST_MODEL)
    tickets = [sched.submit(tl) for tl in token_lists]
    sched.close(timeout=TIMEOUT)
    results = [t.wait(TIMEOUT) for t in tickets]
    assert _same(results, truth)
    st = sched.stats()
    assert st.completed == len(token_lists)
    assert st.drain_flushes >= 1
    with pytest.raises(RuntimeError):
        sched.submit(token_lists[0])


# -------------------------------------------------------------- admission
class _GateEngine:
    """Stub engine whose host path blocks on a gate — lets tests hold a
    wave in flight deterministically."""

    def __init__(self):
        self.gate = threading.Event()
        self.calls = 0

    def host_query(self, fps, op="and"):
        self.gate.wait(TIMEOUT)
        self.calls += 1
        return np.asarray(sorted(fps), np.int64)

    def query_fps_batch(self, fps_lists, op="and"):
        return [self.host_query(fps, op=op) for fps in fps_lists]


def test_admission_blocks_submit_never_drops():
    eng = _GateEngine()
    sched = WaveScheduler([eng], flush_deadline_s=0.001,
                          max_live_waves=1, max_pending=2,
                          cost_model=HOST_MODEL)
    try:
        first = sched.submit([1])          # flushes, blocks on the gate
        time.sleep(0.05)                   # let it become in-flight
        backlog = [sched.submit([2]), sched.submit([3])]  # fills pending
        extra = []
        blocked = threading.Thread(
            target=lambda: extra.append(sched.submit([4])), daemon=True)
        blocked.start()
        blocked.join(timeout=0.3)
        assert blocked.is_alive(), "submit should BLOCK at max_pending"
        assert not extra                   # ...and must not have dropped
        eng.gate.set()                     # free the in-flight wave
        blocked.join(timeout=TIMEOUT)
        assert not blocked.is_alive()
        for t in [first] + backlog + extra:
            t.wait(TIMEOUT)                # every query answered
        st = sched.stats()
        assert st.submitted == st.completed == 4
        assert st.failed == 0
    finally:
        eng.gate.set()
        sched.close()


def test_max_live_waves_bounds_concurrency():
    """With max_live_waves=1 a second wave never starts while the first
    is in flight — arrivals keep coalescing instead."""
    eng = _GateEngine()
    sched = WaveScheduler([eng], flush_deadline_s=0.001,
                          max_live_waves=1, cost_model=HOST_MODEL)
    try:
        t1 = sched.submit([1])
        time.sleep(0.05)                   # wave 1 in flight, gated
        later = [sched.submit([i]) for i in range(2, 8)]
        time.sleep(0.1)                    # deadlines long expired...
        assert eng.calls == 0              # ...but nothing else ran
        eng.gate.set()
        t1.wait(TIMEOUT)
        rs = [t.wait(TIMEOUT) for t in later]
        assert all(r is not None for r in rs)
        st = sched.stats()
        # the held-back queries coalesced into few big waves
        assert st.waves <= 3, st.waves
        assert st.max_wave >= len(later)
    finally:
        eng.gate.set()
        sched.close()


class _FlakyEngine(_GateEngine):
    def __init__(self):
        super().__init__()
        self.gate.set()
        self.fail_next = True

    def host_query(self, fps, op="and"):
        if self.fail_next:
            self.fail_next = False
            raise RuntimeError("injected engine failure")
        return super().host_query(fps, op=op)


def test_engine_error_fails_wave_but_scheduler_survives():
    eng = _FlakyEngine()
    sched = WaveScheduler([eng], flush_deadline_s=0.001,
                          cost_model=HOST_MODEL)
    try:
        bad = sched.submit([1])
        with pytest.raises(RuntimeError, match="injected"):
            bad.wait(TIMEOUT)
        good = sched.query([2], timeout=TIMEOUT)   # still serving
        assert np.array_equal(good, np.asarray([2], np.int64))
        st = sched.stats()
        assert st.failed >= 1 and st.completed >= 1
    finally:
        sched.close()


class _DeviceFaultEngine(_GateEngine):
    """A device wave raises (as a CUDA error would); the host path works."""

    def __init__(self):
        super().__init__()
        self.gate.set()

    def query_fps_batch(self, fps_lists, op="and"):
        raise RuntimeError("injected device fault")


def test_device_wave_error_fails_tickets_never_retried_on_host():
    eng = _DeviceFaultEngine()
    sched = WaveScheduler([eng], flush_deadline_s=0.001,
                          cost_model=DEVICE_MODEL)
    try:
        tickets = [sched.submit([i]) for i in range(3)]
        for t in tickets:
            with pytest.raises(RuntimeError, match="injected device"):
                t.wait(TIMEOUT)
        assert eng.calls == 0              # the host path never ran
        st = sched.stats()
        assert st.failed == 3 and st.completed == 0
        assert st.host_waves == 0 and st.device_waves >= 1
    finally:
        sched.close()


# ------------------------------------------------- serving during live ingest
def _consistent_with_some_prefix(batch, truth_lines, total):
    """Every term's matches must be a prefix of its full-truth matches,
    and one common cut line L must explain the whole batch (the batch
    was answered against ONE captured view)."""
    lo, hi = 0, total
    for matches, full in zip(batch, truth_lines):
        if matches != full[:len(matches)]:
            return False
        lo = max(lo, matches[-1] + 1 if matches else 0)
        hi = min(hi, full[len(matches)] if len(matches) < len(full)
                 else total)
    return lo <= hi


def test_store_server_refresh_consistent_under_live_ingest(
        small_dataset, scan_oracle, tmp_path, queries):
    """A writer ingests a durable store (publish-per-spill) while reader
    threads query a StoreServer and race refresh(); every batched answer
    must be exact over some published prefix, and the final refreshed
    answers must be the full truth.  The port's batch codec is safe
    across threads, so this holds on every run."""
    terms, _ = queries
    terms = terms[:6]
    truth_lines = [scan_oracle.query_term(t).matches for t in terms]
    total = len(small_dataset.lines)
    d = str(tmp_path / "live")
    s = DynaWarpStore(device="cpu", path=d, **KW)
    s.ingest(small_dataset.lines[:200])    # a first published prefix
    server = s.serving(n_replicas=2, flush_deadline_s=0.005,
                       cost_model=HOST_MODEL)
    errors: list = []
    checks = [0]
    moved = [0, 0]                 # each reader counts in its own slot
    done = threading.Event()

    def reader(ci):
        while not done.is_set() or checks[0] == 0:
            moved[ci] += server.refresh()
            try:
                batch = [r.matches
                         for r in server.query_term_batch(
                             terms, timeout=TIMEOUT)]
            except Exception as e:   # pragma: no cover - failure path
                errors.append(repr(e))
                return
            if not _consistent_with_some_prefix(batch, truth_lines,
                                                total):
                errors.append(("inconsistent", ci))
                return
            checks[0] += 1

    readers = [threading.Thread(target=reader, args=(ci,), daemon=True)
               for ci in range(2)]
    for rt in readers:
        rt.start()
    try:
        for i in range(200, total, 100):
            s.ingest(small_dataset.lines[i:i + 100])
        s.finish()
    finally:
        done.set()
        for rt in readers:
            rt.join(timeout=TIMEOUT)
            assert not rt.is_alive(), "reader thread hung"
    assert not errors, errors[:3]
    assert checks[0] > 0
    # no-op if a reader already saw the final view; some refresh moved it
    assert sum(moved) + server.refresh() > 0
    assert server.view.n_lines == total    # final view: the whole store
    final = [r.matches for r in server.query_term_batch(terms,
                                                        timeout=TIMEOUT)]
    assert final == truth_lines
    server.close()
    s.close()


def test_server_survives_writer_crash_then_recovery_converges(
        small_dataset, scan_oracle, tmp_path, queries):
    """Kill the writer at a manifest publish mid-ingest (core.faults).
    The server must keep answering over the last good published prefix;
    DynaWarpStore.open() recovery + reopen-for-append then converges to
    the full truth through a fresh server."""
    terms, _ = queries
    terms = terms[:5]
    truth_lines = [scan_oracle.query_term(t).matches for t in terms]
    total = len(small_dataset.lines)
    d = str(tmp_path / "crashy")
    s = DynaWarpStore(device="cpu", path=d, **KW)

    crashed = threading.Event()

    def writer():
        try:
            with faults.inject(crash_at="manifest.replace", after=2):
                s.ingest(small_dataset.lines)
                s.finish()
        except faults.CrashError:
            crashed.set()

    wt = threading.Thread(target=writer, daemon=True)
    wt.start()
    assert crashed.wait(TIMEOUT), "writer never hit the crashpoint"
    wt.join(timeout=TIMEOUT)

    server = s.serving(flush_deadline_s=0.005, cost_model=HOST_MODEL)
    server.refresh()                        # view_fn may fail: last good
    batch = [r.matches for r in server.query_term_batch(terms,
                                                        timeout=TIMEOUT)]
    assert _consistent_with_some_prefix(batch, truth_lines, total)
    served_lines = server.view.n_lines
    assert 0 < served_lines < total        # a real, partial prefix
    server.close()
    s.blobs.close()                        # the dead writer's fd

    re = DynaWarpStore.open(d, device="cpu")   # crash recovery
    assert re._n_lines >= served_lines     # published prefix survived
    re.ingest(small_dataset.lines[re._n_lines:])
    re.finish()
    server2 = re.serving(flush_deadline_s=0.005, cost_model=HOST_MODEL)
    final = [r.matches for r in server2.query_term_batch(
        terms, timeout=TIMEOUT)]
    assert final == truth_lines
    server2.close()
    re.close()


def test_store_server_matches_store_answers(small_dataset, queries):
    """StoreServer answers == the store's own query_term/contains/batch
    on a finished store, for the single-device engine and the sharded one
    (the reference's ``engine`` and ``sharded`` cases; the replicas of a
    sharded store are sharded clones)."""
    from repro_torch.core.distributed import ShardedQueryEngine
    terms, _ = queries
    terms = terms[:4] + ["info"]
    for shard_axes in (None, ("data",)):
        s = DynaWarpStore(device="cpu", shard_axes=shard_axes, **KW)
        s.ingest(small_dataset.lines[:600])
        s.finish()
        assert isinstance(s.engine, ShardedQueryEngine) == bool(shard_axes)
        server = s.serving(n_replicas=2, flush_deadline_s=0.005,
                           cost_model=HOST_MODEL)
        try:
            assert all(type(e) is type(s.engine)
                       for e in server.scheduler._engines)
            for t in terms:
                assert server.query_term(t, timeout=TIMEOUT).matches \
                    == s.query_term(t).matches, (shard_axes, t)
            sub = terms[0][2:10]
            assert server.query_contains(sub, timeout=TIMEOUT).matches \
                == s.query_contains(sub).matches
            got = server.query_term_batch(terms, timeout=TIMEOUT)
            want = s.query_term_batch(terms)
            assert [r.matches for r in got] == [r.matches for r in want]
        finally:
            server.close()


def test_serving_needs_an_engine_or_a_segmented_writer(small_dataset):
    """As the reference: a finished store without a wave engine, and an
    unfinished store that is not segmented, refuse to serve."""
    s = DynaWarpStore(device="cpu", device_query=False, batch_lines=64)
    s.ingest(small_dataset.lines[:200])
    s.finish()
    with pytest.raises(ValueError, match="device_query"):
        s.serving()
    w = DynaWarpStore(device="cpu", batch_lines=64)
    w.ingest(small_dataset.lines[:200])
    with pytest.raises(ValueError, match="segmented"):
        w.serving()


# ------------------------------------------------- parity with the reference
PARITY_LINES = 600      # fewer segments: the reference compiles per shape


@pytest.fixture(scope="module")
def parity_stores(small_dataset):
    lines = small_dataset.lines[:PARITY_LINES]
    port = DynaWarpStore(device="cpu", **KW)
    ref = ref_store.DynaWarpStore(**KW)
    for s in (port, ref):
        s.ingest(lines)
        s.finish()
    return port, ref


@pytest.mark.parametrize("path", ["host", "device"])
def test_store_server_matches_reference_server(parity_stores, queries, path):
    """The port's and the JAX package's StoreServers over the same data
    give equal candidates and matches for the same terms.  One bucket of
    8 keeps the reference to one wave shape."""
    store, ref_finished = parity_stores
    terms, token_lists = queries
    # six ids (some present in the prefix) and two common words
    terms, token_lists = terms[:6] + terms[-2:], token_lists[:6] + \
        token_lists[-2:]
    kw = dict(bucket_sizes=(8,), flush_deadline_s=0.05)
    port = store.serving(cost_model=HOST_MODEL if path == "host"
                         else DEVICE_MODEL, **kw)
    ref_model = (ref_serving.CostModel.from_dict(HOST_MODEL.to_dict())
                 if path == "host" else
                 ref_serving.CostModel.from_dict(DEVICE_MODEL.to_dict()))
    ref = ref_finished.serving(cost_model=ref_model, **kw)
    try:
        got_c = port.scheduler.query_batch(token_lists, timeout=TIMEOUT)
        want_c = ref.scheduler.query_batch(token_lists, timeout=TIMEOUT)
        assert _same(got_c, [np.asarray(c, np.int64) for c in want_c])
        got = port.query_term_batch(terms, timeout=TIMEOUT)
        want = ref.query_term_batch(terms, timeout=TIMEOUT)
        assert [r.matches for r in got] == [r.matches for r in want]
        assert sum(bool(r.matches) for r in got) >= 3     # not vacuous
        assert all(np.array_equal(np.asarray(a.candidate_batches, np.int64),
                                  np.asarray(b.candidate_batches, np.int64))
                   for a, b in zip(got, want))
        assert port.query_term(terms[0], timeout=TIMEOUT).matches \
            == ref.query_term(terms[0], timeout=TIMEOUT).matches
        via = {"host": "host_waves", "device": "device_waves"}[path]
        assert getattr(port.scheduler.stats(), via) > 0
        assert getattr(ref.scheduler.stats(), via) > 0
    finally:
        port.close()
        ref.close()


# --------------------------------------------------------- the entry point
def test_serve_dynawarp_builds_and_serves_on_cpu(capsys):
    assert port_serve.main(["--arch", "dynawarp", "--device", "cpu",
                            "--lines", "1500", "--clients", "8",
                            "--requests", "3"]) == 0
    out = capsys.readouterr().out
    assert "[serve] built store:" in out and "on cpu" in out
    assert "[serve] 24 queries from 8 clients" in out
    assert "p50" in out and "p99" in out and "waves (" in out


def test_serve_dynawarp_opens_a_durable_store(small_dataset, tmp_path,
                                              capsys):
    """``--store`` opens a durable directory the port wrote, with the
    measured cost model of ``--cost-model``; ``copr`` is the alias."""
    d = str(tmp_path / "store")
    s = DynaWarpStore(device="cpu", path=d, **KW)
    s.ingest(small_dataset.lines[:800])
    s.finish()
    model = measure_dispatch_costs(s.engine, [term_query_tokens("info")],
                                   buckets=(8,), reps=1, host_samples=2)
    s.close()
    cm = tmp_path / "bench_costmodel.json"
    cm.write_text(json.dumps(model))
    assert port_serve.main(["--arch", "copr", "--device", "cpu", "--store",
                            d, "--cost-model", str(cm), "--clients", "8",
                            "--requests", "2"]) == 0
    out = capsys.readouterr().out
    assert f"[serve] opened store {d}" in out
    assert f"[serve] cost model {cm}" in out
    assert "[serve] 16 queries from 8 clients" in out


# ------------------------------------------------------------- the config
def test_dynawarp_config_matches_reference():
    """``configs.dynawarp`` carries the reference's fields and defaults;
    its serving knobs are the scheduler's, and its ``shard_axes`` values
    build a store whose sharded engine answers as the plain one."""
    import dataclasses
    import inspect

    from repro.configs import DYNAWARP_CONFIG as REF_CONFIG
    from repro.configs import DYNAWARP_SMOKE as REF_SMOKE
    from repro_torch.configs import (DYNAWARP_CONFIG, DYNAWARP_SMOKE,
                                     DynaWarpConfig, get_arch)
    assert dataclasses.asdict(DYNAWARP_CONFIG) == dataclasses.asdict(
        REF_CONFIG)
    assert dataclasses.asdict(DYNAWARP_SMOKE) == dataclasses.asdict(
        REF_SMOKE)
    assert DynaWarpConfig() == DYNAWARP_CONFIG
    sched = inspect.signature(WaveScheduler).parameters
    assert DYNAWARP_CONFIG.max_live_waves == sched["max_live_waves"].default
    assert DYNAWARP_CONFIG.flush_deadline_s == \
        sched["flush_deadline_s"].default
    assert DYNAWARP_CONFIG.wave_bucket_sizes == sched["bucket_sizes"].default
    assert DYNAWARP_CONFIG.serve_max_pending == sched["max_pending"].default
    store_kw = inspect.signature(DynaWarpStore).parameters
    for f in dataclasses.fields(DynaWarpConfig):
        if f.name in store_kw:
            assert store_kw[f.name].default == f.default, f.name
    with pytest.raises(ValueError):
        get_arch("copr")
    from repro_torch.core.distributed import ShardedQueryEngine
    assert DYNAWARP_CONFIG.shard_axes is None
    lines = [f"svc{i % 7} req-{i:05d} took {i % 13} ms" for i in range(400)]
    stores = [DynaWarpStore(device="cpu", shard_axes=axes, **KW)
              for axes in (None, ("data",), ("pod", "data"))]
    for st in stores:
        st.ingest(lines)
        st.finish()
    assert [type(st.engine).__name__ for st in stores] == [
        "QueryEngine", "ShardedQueryEngine", "ShardedQueryEngine"]
    assert isinstance(stores[2].engine, ShardedQueryEngine)
    terms = ["req-00017", "svc3", "took", "absent-term"]
    want = stores[0].candidates_term_batch(terms)
    for st in stores[1:]:
        for x, y in zip(st.candidates_term_batch(terms), want):
            np.testing.assert_array_equal(x, y)
