"""The port's span and counter recorder (``repro_torch.trace``).

  * with recording off, a store and a server record nothing: no span or
    count site is reached past its check of ``trace.ON``;
  * with it on, answers equal the unrecorded ones, query by query, for a
    served needle mix and for a durable ingest through a spill;
  * spans nest by parent id, and each request's spans share its id;
  * each ticket's ``serve.queue`` starts at its ``t_submit``, and the
    scheduler's stamps are on the recorder's clock;
  * ``batch_cache.loads`` equals the post-filter LRU's misses;
  * the readers: self time, and an interval named by the innermost span on
    the threads asked about.

Every store runs on ``device="cpu"``; every blocking call has a timeout.
"""
import sys
import threading

import numpy as np
import pytest

from repro_torch import trace
from repro_torch.core.serving import CostModel, WaveScheduler
from repro_torch.core.tokenizer import term_query_tokens
from repro_torch.logstore.datasets import (generate_dataset, id_queries,
                                           present_id_queries)
from repro_torch.logstore.store import DynaWarpStore

TIMEOUT = 120
KW = dict(batch_lines=64, mode="segmented", memory_limit_bytes=1 << 14,
          auto_compact=False)
HOST_MODEL = CostModel(host_us_per_query=1.0, device_us_per_wave={8: 1e9})
DEVICE_MODEL = CostModel(host_us_per_query=1e9, device_us_per_wave={8: 1.0})


@pytest.fixture(scope="module")
def data():
    return generate_dataset("trace", n_lines=1500, n_sources=12, seed=5)


@pytest.fixture(scope="module")
def store(data):
    s = DynaWarpStore(device="cpu", **KW)
    s.ingest(data.lines)
    s.finish()
    return s


@pytest.fixture(scope="module")
def terms(data):
    """Needles: ids absent from the logs, and ids found in them."""
    return id_queries(3, 24) + present_id_queries(data, 4, 8)


def _clients(server, terms, n_threads=4):
    """``n_threads`` client threads, one ``query_term`` each at a time;
    answers in the order of ``terms``."""
    out = [None] * len(terms)

    def client(k):
        for i in range(k, len(terms), n_threads):
            out[i] = server.query_term(terms[i], timeout=TIMEOUT).matches

    threads = [threading.Thread(target=client, args=(k,))
               for k in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(TIMEOUT)
    assert not any(t.is_alive() for t in threads)
    return out


def _serve(store, terms, model):
    server = store.serving(n_replicas=2, flush_deadline_s=0.002,
                           cost_model=model)
    try:
        return _clients(server, terms)
    finally:
        server.close()


def _ingest(path, lines):
    """A durable segmented store through at least one spill; its reopened
    answers."""
    s = DynaWarpStore(device="cpu", path=str(path), **KW)
    for i in range(0, len(lines), 256):
        s.ingest(lines[i:i + 256])
    spills = s._writer.n_spills
    s.finish()
    s.close()
    s = DynaWarpStore.open(str(path), device="cpu")
    try:
        return spills, s
    finally:
        s.close()


def test_recording_off_records_nothing(store, terms, data, tmp_path,
                                       monkeypatch):
    def reached(*a, **k):
        raise AssertionError("a span site ran with recording off")

    for name in ("begin", "end", "record", "count", "context"):
        monkeypatch.setattr(trace, name, reached)
    assert not trace.ON
    for model in (HOST_MODEL, DEVICE_MODEL):
        _serve(store, terms, model)
    _ingest(tmp_path / "s", data.lines[:1200])


@pytest.mark.parametrize("model", [HOST_MODEL, DEVICE_MODEL],
                         ids=["host", "device"])
def test_served_answers_equal_with_recording_on(store, terms, model):
    want = _serve(store, terms, model)
    with trace.recording() as rec:
        got = _serve(store, terms, model)
    assert got == want
    assert not trace.ON
    names = {s.name for s in rec.spans}
    assert {"serve.request", "serve.submit", "serve.queue", "serve.wave",
            "serve.wake", "store.post_filter"} <= names
    if model is HOST_MODEL:
        assert "engine.host_query" in names
    else:
        assert {"engine.pack", "engine.planes", "engine.fold",
                "engine.extract"} <= names
    assert sum(s.name == "serve.request" for s in rec.spans) == len(terms)


def test_durable_ingest_answers_equal_with_recording_on(data, tmp_path):
    lines = data.lines[:1200]
    probe = present_id_queries(data, 6, 6) + id_queries(7, 4)
    spills, _ = _ingest(tmp_path / "off", lines)
    with trace.recording() as rec:
        spills_on, _ = _ingest(tmp_path / "on", lines)
    assert spills == spills_on >= 1
    answers = []
    for d in ("off", "on"):
        s = DynaWarpStore.open(str(tmp_path / d), device="cpu")
        answers.append([r.matches for r in s.query_term_batch(probe)])
        s.close()
    assert answers[0] == answers[1]
    names = {s.name for s in rec.spans}
    assert {"store.ingest", "ingest.tokenize", "ingest.token_hash",
            "ingest.ngram", "ingest.dedup", "ingest.sketch_add",
            "ingest.compress", "spill", "spill.seal", "spill.sketch_build",
            "spill.segment_write", "spill.manifest_swap",
            "spill.engine_rebuild", "store.finish"} <= names
    by_id = {s.id: s for s in rec.spans}
    # every spill stage runs inside a spill (or the finish), and each
    # spill is a request of its own inside the ingest() call that spilled
    for s in rec.spans:
        if s.name == "spill":
            assert s.request == s.id
            assert by_id[s.parent].name == "store.ingest"
        if s.name in ("spill.seal", "spill.segment_write",
                      "spill.manifest_swap", "spill.engine_rebuild"):
            root = s
            while root.parent in by_id:
                root = by_id[root.parent]
            assert root.name in ("store.ingest", "store.finish")


def test_spans_nest_and_share_their_request(store, terms):
    with trace.recording() as rec:
        _serve(store, terms, DEVICE_MODEL)
        _serve(store, terms, HOST_MODEL)
    by_id = {s.id: s for s in rec.spans}
    assert len(by_id) == len(rec.spans)           # ids are unique
    for s in rec.spans:
        assert s.end >= s.start
        p = by_id.get(s.parent)
        if p is not None and p.thread == s.thread:
            assert p.start <= s.start and s.end <= p.end, (p, s)
    requests = {s.id: s for s in rec.spans if s.name == "serve.request"}
    assert len(requests) == 2 * len(terms)
    per_request = {}
    for s in rec.spans:
        if s.name in ("serve.submit", "serve.queue", "serve.wake",
                      "store.post_filter"):
            assert s.request in requests and s.parent == s.request, s
            r = requests[s.request]
            assert s.thread == r.thread
            assert r.start <= s.start and s.end <= r.end, (r, s)
            per_request.setdefault(s.request, set()).add(s.name)
    assert all(v == {"serve.submit", "serve.queue", "serve.wake",
                     "store.post_filter"} for v in per_request.values())
    assert len(per_request) == len(requests)
    # the wave a ticket sat in starts where its queue span ends (each
    # server numbers its waves from 0)
    waves = {}
    for s in rec.spans:
        if s.name == "serve.wave":
            waves.setdefault(s.attrs["wave"], set()).add(s.start)
    for s in rec.spans:
        if s.name == "serve.queue":
            assert s.end in waves[s.attrs["wave"]]
    # engine stages nest in their wave, on the wave worker's thread
    for s in rec.spans:
        if s.name.startswith("engine."):
            assert by_id[s.parent].name == "serve.wave"


def test_queue_span_starts_at_the_tickets_submit(store, terms):
    sched = WaveScheduler([store.engine], flush_deadline_s=0.002,
                          cost_model=DEVICE_MODEL)
    try:
        with trace.recording() as rec:
            tickets = [sched.submit(term_query_tokens(t)) for t in terms]
            for t in tickets:
                t.wait(TIMEOUT)
        now = trace.clock()
    finally:
        sched.close()
    queue = sorted((s.start, s.attrs["wave"]) for s in rec.spans
                   if s.name == "serve.queue")
    assert queue == sorted((t.t_submit, t.wave_id) for t in tickets)
    # the stamps are on the recorder's clock
    assert all(t.t_submit <= t.t_done <= now for t in tickets)
    assert now - min(t.t_submit for t in tickets) < TIMEOUT


def test_batch_cache_loads_count_the_lru_misses(store):
    store._batch_cache.clear()
    cap = store._batch_cache_cap = 3
    rng = np.random.default_rng(11)
    script = [rng.integers(0, min(store.n_batches, 7), size=4)
              for _ in range(20)]
    lru, misses = [], 0
    for cand in script:
        for b in cand.tolist():
            if b in lru:
                lru.remove(b)
            else:
                misses += 1
                if len(lru) == cap:
                    lru.pop(0)
            lru.append(b)
    try:
        with trace.recording() as rec:
            for cand in script:
                store._post_filter(cand, "info", "term")
    finally:
        store._batch_cache_cap = 128
        store._batch_cache.clear()
    assert rec.total("batch_cache.loads") == misses
    calls = {s.id for s in rec.spans if s.name == "store.post_filter"}
    assert len(calls) == len(script)
    assert all(c.parent in calls for c in rec.counts)


def test_recording_is_one_at_a_time_and_ends_off():
    with pytest.raises(ValueError):
        with trace.recording():
            assert trace.ON
            with pytest.raises(RuntimeError):
                with trace.recording():
                    pass
            raise ValueError("leave the block")
    assert not trace.ON


def test_recording_from_many_threads_loses_nothing():
    n_threads, n_spans = 16, 400
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with trace.recording() as rec:
            def work():
                for _ in range(n_spans):
                    outer = trace.begin("outer", request=True)
                    inner = trace.begin("inner")
                    trace.count("n")
                    trace.end(inner)
                    trace.end(outer)

            threads = [threading.Thread(target=work)
                       for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(TIMEOUT)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    assert len(rec.spans) == 2 * n_threads * n_spans
    assert len({s.id for s in rec.spans}) == len(rec.spans)
    assert rec.total("n") == n_threads * n_spans
    by_id = {s.id: s for s in rec.spans}
    for s in rec.spans:
        if s.name == "inner":
            p = by_id[s.parent]
            assert p.name == "outer" and p.thread == s.thread
            assert s.request == p.id == p.request


def _span(name, start, end, sid, parent=0, thread=1):
    return trace.Span(name, start, end, sid, parent, 0, thread, None)


def test_summary_gives_self_time_less_same_thread_children():
    spans = [_span("wave", 0.0, 10.0, 1),
             _span("fold", 2.0, 5.0, 2, parent=1),
             _span("extract", 6.0, 7.0, 3, parent=1),
             _span("queue", 1.0, 9.0, 4, parent=1, thread=2)]
    got = trace.summary(spans)
    assert got["wave"]["total_s"] == 10.0
    assert got["wave"]["self_s"] == 6.0        # the other thread's child
    assert got["fold"]["mean_ms"] == 3000.0    # counts nothing off
    clipped = trace.summary(spans, 4.0, 8.0)
    assert clipped["wave"]["total_s"] == 4.0
    assert clipped["wave"]["self_s"] == 2.0
    assert clipped["wave"]["n"] == 0 and clipped["extract"]["n"] == 1


def test_a_gap_is_named_by_the_innermost_span_on_the_asked_threads():
    spans = [_span("serve.wave", 0.0, 10.0, 1, thread=1),
             _span("engine.host_query", 1.0, 4.0, 2, parent=1, thread=1),
             _span("engine.host_query", 4.5, 8.0, 3, parent=1, thread=1),
             _span("store.post_filter", 0.0, 10.0, 4, thread=2),
             _span("serve.worker_wait", 10.0, 20.0, 5, thread=1),
             _span("engine.fold", 11.0, 11.5, 6, thread=3)]
    cover = trace.innermost_cover(spans, 0.0, 10.0, {1})
    assert cover == pytest.approx({"serve.wave": 3.5,
                                   "engine.host_query": 6.5})
    assert trace.name_interval(spans, 0.0, 10.0, {1}) == "engine.host_query"
    # on every thread, the other thread's span is as innermost as ours
    assert trace.innermost_cover(spans, 0.0, 10.0)["store.post_filter"] \
        == 10.0
    assert trace.name_interval(spans, 12.0, 18.0, {1}) == \
        "serve.worker_wait"
    # nothing covers half of it: no name, and without records none either
    assert trace.name_interval(spans, 20.0, 30.0, {1}) is None
    assert trace.name_interval(spans, 18.0, 30.0, {1}) is None
    assert trace.name_interval([], 0.0, 1.0) is None
    assert trace.device_threads(spans) == {3}


def test_a_gap_split_between_stages_is_named_by_the_longest():
    """A spill's stages each cover under half of its gap: the stage that
    covers most names it, since the spans together cover all of it."""
    spans = [_span("spill", 0.0, 9.0, 1),
             _span("spill.seal", 0.0, 4.0, 2, parent=1),
             _span("spill.sketch_build", 4.0, 6.5, 3, parent=1),
             _span("spill.segment_write", 6.5, 9.0, 4, parent=1)]
    assert trace.name_interval(spans, 0.0, 9.0) == "spill.seal"
    assert trace.innermost_cover(spans, 0.0, 9.0) == pytest.approx(
        {"spill.seal": 4.0, "spill.sketch_build": 2.5,
         "spill.segment_write": 2.5})
    # the stages cover 3 s of [6, 12]: half, and no more
    assert trace.name_interval(spans, 6.0, 12.0) == "spill.segment_write"
    assert trace.name_interval(spans, 6.0, 12.1) is None
