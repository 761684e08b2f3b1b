"""Wave-coalescing query serving front end with admission control.

The engine's fast path is the padded power-of-two ``(Q, T)`` wave
through the CUDA ``sketch_probe``/``bitset_ops``/``bitmap_extract``
kernels — but the store alone only answers one-shot
``query_term_batch`` calls, so nothing *forms* waves from independent
clients.  This module is the
saxml-``ServableMethod``-shaped serving layer that does:

  * **Shape-bucketed coalescing** — concurrent term/boolean queries
    from many clients queue per ``(op, T-bucket)`` group; the
    dispatcher flushes a group as one engine wave when it reaches the
    largest supported Q bucket (size trigger) or when its oldest
    request ages past ``flush_deadline_s`` (deadline trigger — a lone
    straggler never waits longer than the deadline).
  * **Sorted supported bucket sizes, pad-to-bucket** — a flushed wave
    pads up to the smallest supported Q bucket that fits (replicating
    a real query, unpadded on completion), so repeated waves take one
    padded wave shape per bucket.
  * **Admission control with backpressure** — at most
    ``max_live_waves`` waves execute concurrently; the dispatcher
    holds further flushes (arrivals keep coalescing into bigger
    waves), and ``submit()`` BLOCKS — never drops — once
    ``max_pending`` requests queue.
  * **Latency-aware host-vs-device dispatch** — a measured per-bucket
    :class:`CostModel` (emitted by :func:`measure_dispatch_costs`)
    decides per wave whether the scalar host path (cheap for lone
    stragglers) or one device wave (amortized across users) answers
    faster.  A device wave that raises fails its tickets; it is never
    retried on the host path.
  * **Engine replicas** — waves round-robin over engine replicas
    (cheap: :meth:`QueryEngine.clone` shares every per-segment device
    cache), each guarded by its own lock so concurrent waves overlap
    across replicas without racing an engine's LRU state.
  * **Snapshot-backed serving during live ingest** —
    :class:`StoreServer` serves from a store view (the finished store,
    or a :meth:`~repro_torch.logstore.store.DynaWarpStore.snapshot` of
    a live one) and ``refresh()`` atomically advances engines-then-view,
    so every answer is exact over some published prefix even while a
    writer keeps ingesting (or crashes mid-spill).

Results are bit-identical to direct ``query_fps_batch`` calls: the
scheduler only *groups and pads* — evaluation is the engine's own wave
path either way.  Byte tokens are hashed on the host at ``submit()``,
so a device wave enters the engine through ``query_fps_batch`` and
launches no ``token_hash``.  Waves on several threads share the
device's one stream, so their kernels run one after another on the
card.
"""
from __future__ import annotations

import bisect
import json
import statistics
import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import trace
from .query_engine import _as_fp
from .tokenizer import contains_query_tokens, term_query_tokens

#: Sorted supported Q buckets (powers of two — the engine's own padding
#: geometry, so scheduler buckets and the engine's wave shapes coincide).
DEFAULT_BUCKET_SIZES = (8, 16, 32, 64, 128, 256)

#: Where the measured model (:func:`measure_dispatch_costs`) is kept.
DEFAULT_COST_MODEL_PATH = "bench_costmodel.json"

COST_MODEL_FORMAT = 1


def _t_bucket(n_tokens: int) -> int:
    """Power-of-two T grouping key (>= 1)."""
    return 1 << max(n_tokens - 1, 0).bit_length()


class CostModel:
    """Measured per-bucket dispatch costs driving host-vs-device.

    ``host_us_per_query`` is the scalar host probe's per-query cost;
    ``device_us_per_wave`` maps a Q bucket to one device wave's
    dispatch cost at that bucket.  A wave of ``n`` queries goes to the
    host path iff ``n * host_us_per_query <= device_us_per_wave[b]``
    for its bucket ``b`` — lone stragglers keep taking the scalar path,
    big waves amortize the dispatch.  The defaults are placeholders
    shaped on a CPU; :func:`measure_dispatch_costs` measures the model
    on the engine's device (:func:`CostModel.load` reads it back).  The
    file format is the JAX package's, so either package reads the
    other's ``bench_costmodel.json``.
    """

    def __init__(self, *, host_us_per_query: float = 150.0,
                 device_us_per_wave: dict | None = None):
        if device_us_per_wave is None:
            device_us_per_wave = {8: 4_000.0, 16: 4_500.0, 32: 5_000.0,
                                  64: 6_000.0, 128: 8_000.0, 256: 12_000.0}
        if not device_us_per_wave:
            raise ValueError("device_us_per_wave must not be empty")
        self.host_us_per_query = float(host_us_per_query)
        self.device_us_per_wave = {int(k): float(v)
                                   for k, v in device_us_per_wave.items()}
        self._buckets = sorted(self.device_us_per_wave)

    def device_wave_us(self, q_bucket: int) -> float:
        """Dispatch cost of one wave at ``q_bucket``: the measured cost
        of the smallest covering bucket, linearly extrapolated past the
        largest measured one."""
        i = bisect.bisect_left(self._buckets, q_bucket)
        if i < len(self._buckets):
            return self.device_us_per_wave[self._buckets[i]]
        top = self._buckets[-1]
        return self.device_us_per_wave[top] * (q_bucket / top)

    def prefer_host(self, n_queries: int, q_bucket: int) -> bool:
        return (n_queries * self.host_us_per_query
                <= self.device_wave_us(q_bucket))

    def to_dict(self) -> dict:
        return {"format": COST_MODEL_FORMAT,
                "host_us_per_query": self.host_us_per_query,
                "device_us_per_wave": {str(k): v for k, v in
                                       sorted(self.device_us_per_wave
                                              .items())}}

    @classmethod
    def from_dict(cls, d: dict) -> "CostModel":
        if int(d.get("format", COST_MODEL_FORMAT)) > COST_MODEL_FORMAT:
            raise ValueError(f"cost model format {d['format']} is newer "
                             f"than this reader ({COST_MODEL_FORMAT})")
        return cls(host_us_per_query=d["host_us_per_query"],
                   device_us_per_wave=d["device_us_per_wave"])

    @classmethod
    def load(cls, path: str = DEFAULT_COST_MODEL_PATH) -> "CostModel":
        with open(path) as f:
            return cls.from_dict(json.load(f))


class WaveTicket:
    """One submitted query's completion handle.

    ``wait()`` blocks for the wave that serves it; ``t_done`` is
    stamped inside the wave (not at ``wait()`` return), so latency
    percentiles measured from tickets are dispatch-accurate.  Both stamps
    are on :data:`repro_torch.trace.clock`, so they are the ends of the
    ticket's spans.  ``trace_ctx`` is the submitting thread's
    :func:`repro_torch.trace.context` while a recording runs.
    """

    __slots__ = ("fps", "op", "t_submit", "t_done", "wave_id", "via",
                 "trace_ctx", "_event", "_result", "_error")

    def __init__(self, fps: list, op: str):
        self.fps = fps
        self.op = op
        self.t_submit = 0.0
        self.t_done = 0.0
        self.wave_id = -1
        self.via = ""            # "host" | "device" once served
        self.trace_ctx = None
        self._event = threading.Event()
        self._result = None
        self._error = None

    def done(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout: float | None = None) -> np.ndarray:
        if not self._event.wait(timeout):
            raise TimeoutError(f"query not served within {timeout}s")
        if trace.ON:
            trace.record("serve.wake", self.t_done, trace.clock())
        if self._error is not None:
            raise self._error
        return self._result

    def _complete(self, result, wave_id: int, via: str) -> None:
        self.t_done = trace.clock()
        self.wave_id = wave_id
        self.via = via
        self._result = result
        self._event.set()

    def _fail(self, err: BaseException, wave_id: int) -> None:
        self.t_done = trace.clock()
        self.wave_id = wave_id
        self._error = err
        self._event.set()


@dataclass
class ServeStats:
    """Scheduler counters (mutated under the scheduler lock; read a
    consistent copy via :meth:`WaveScheduler.stats`)."""
    submitted: int = 0
    completed: int = 0
    failed: int = 0
    waves: int = 0
    host_waves: int = 0
    device_waves: int = 0
    size_flushes: int = 0
    deadline_flushes: int = 0
    drain_flushes: int = 0
    padded_slots: int = 0
    max_wave: int = 0
    replica_waves: dict = field(default_factory=dict)


class WaveScheduler:
    """Coalesces concurrent queries into shape-bucketed engine waves.

    ``engines`` is one or more wave-capable engines (anything with
    ``query_fps_batch(fps_lists, op=...)`` and ``host_query(tokens,
    op=...)`` — :class:`~repro_torch.core.query_engine.QueryEngine` or
    a test stub).  Thread-safe: any number of
    client threads may ``submit()``/``query()`` concurrently.
    """

    def __init__(self, engines, *, bucket_sizes=DEFAULT_BUCKET_SIZES,
                 flush_deadline_s: float = 0.002, max_live_waves: int = 2,
                 max_pending: int = 8192, cost_model: CostModel | None = None,
                 start: bool = True):
        engines = list(engines)
        if not engines:
            raise ValueError("at least one engine replica is required")
        self.bucket_sizes = tuple(sorted({int(b) for b in bucket_sizes}))
        if not self.bucket_sizes or self.bucket_sizes[0] < 1:
            raise ValueError(f"bucket_sizes={bucket_sizes!r}")
        self.flush_deadline_s = float(flush_deadline_s)
        self.max_live_waves = max(int(max_live_waves), 1)
        self.max_pending = max(int(max_pending), 1)
        self.cost_model = cost_model if cost_model is not None else CostModel()
        self._cv = threading.Condition()
        # every engine replica gets its own lock: waves overlap across
        # replicas but never race one engine's LRUs
        self._engines: list = []
        self._engine_locks: list[threading.Lock] = []
        self.set_engines(engines)
        # (op, t_bucket) -> FIFO of pending tickets; insertion-ordered so
        # the drain path visits groups deterministically
        self._groups: "OrderedDict[tuple, deque]" = OrderedDict()
        self._n_pending = 0
        self._inflight = 0          # formed waves not yet completed
        self._ready: deque = deque()  # formed waves awaiting a worker
        self._wave_seq = 0
        self._stop = False
        self._dispatch_done = False
        self._stats = ServeStats()
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, name="wave-dispatcher", daemon=True)
        self._workers = [threading.Thread(
            target=self._worker_loop, name=f"wave-worker-{i}", daemon=True)
            for i in range(self.max_live_waves)]
        self._started = False
        if start:
            self.start()

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "WaveScheduler":
        if not self._started:
            self._started = True
            self._dispatcher.start()
            for w in self._workers:
                w.start()
        return self

    def close(self, timeout: float = 60.0) -> None:
        """Drain: pending queries flush as final waves, then threads
        exit.  Idempotent."""
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        if not self._started:
            return
        self._dispatcher.join(timeout)
        for w in self._workers:
            w.join(timeout)

    def __enter__(self) -> "WaveScheduler":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    # -------------------------------------------------------------- replicas
    def set_engines(self, engines) -> None:
        """Atomic replica swap (snapshot refresh during live ingest).
        In-flight waves keep the engine they were routed to."""
        engines = list(engines)
        if not engines:
            raise ValueError("at least one engine replica is required")
        with self._cv:
            self._engines = engines
            self._engine_locks = [threading.Lock() for _ in engines]

    @property
    def n_replicas(self) -> int:
        return len(self._engines)

    # --------------------------------------------------------------- clients
    def submit(self, tokens, *, op: str = "and") -> WaveTicket:
        """Enqueue one query; returns immediately with a ticket unless
        ``max_pending`` is saturated, in which case it BLOCKS until the
        dispatcher frees queue space (backpressure, never a drop)."""
        if op not in ("and", "or"):
            raise ValueError(f"op={op!r}")
        fps = [_as_fp(t) for t in tokens]
        ticket = WaveTicket(fps, op)
        key = (op, _t_bucket(len(fps)))
        with self._cv:
            while self._n_pending >= self.max_pending and not self._stop:
                self._cv.wait(timeout=0.05)
            if self._stop:
                raise RuntimeError("scheduler is closed")
            ticket.t_submit = trace.clock()
            if trace.ON:
                ticket.trace_ctx = trace.context()
            self._groups.setdefault(key, deque()).append(ticket)
            self._n_pending += 1
            self._stats.submitted += 1
            self._cv.notify_all()
        return ticket

    def query(self, tokens, *, op: str = "and",
              timeout: float | None = None) -> np.ndarray:
        return self.submit(tokens, op=op).wait(timeout)

    def query_batch(self, token_lists, *, op: str = "and",
                    timeout: float | None = None) -> list[np.ndarray]:
        tickets = [self.submit(toks, op=op) for toks in token_lists]
        return [t.wait(timeout) for t in tickets]

    def stats(self) -> ServeStats:
        with self._cv:
            s = ServeStats(**{k: getattr(self._stats, k)
                              for k in self._stats.__dataclass_fields__})
            s.replica_waves = dict(self._stats.replica_waves)
            return s

    # ------------------------------------------------------------ dispatcher
    def _dispatch_loop(self) -> None:
        with self._cv:
            while True:
                if self._stop and self._n_pending == 0:
                    self._dispatch_done = True
                    self._cv.notify_all()
                    return
                wave = None
                if self._inflight < self.max_live_waves:
                    wave = self._pop_wave(trace.clock())
                if wave is not None:
                    self._inflight += 1
                    self._ready.append(wave)
                    self._cv.notify_all()
                    continue
                self._cv.wait(timeout=self._wait_timeout())

    def _wait_timeout(self) -> float | None:
        """Sleep until the earliest pending deadline (None = until a
        submit/completion/close notification)."""
        if self._stop:
            return 0.05
        if self._inflight >= self.max_live_waves or not self._n_pending:
            return None
        oldest = min(dq[0].t_submit for dq in self._groups.values() if dq)
        return max(oldest + self.flush_deadline_s - trace.clock(), 1e-4)

    def _pop_wave(self, now: float):
        """Pick the flush-ready group: any group at/above the largest
        bucket flushes on size; otherwise the group with the oldest
        head past the deadline flushes (drain mode flushes everything).
        Returns (tickets, key, reason) or None."""
        max_b = self.bucket_sizes[-1]
        chosen, reason, oldest = None, None, None
        for key, dq in self._groups.items():
            if not dq:
                continue
            if len(dq) >= max_b:
                chosen, reason = key, "size"
                break
            head_t = dq[0].t_submit
            if self._stop:
                if chosen is None or head_t < oldest:
                    chosen, reason, oldest = key, "drain", head_t
            elif now - head_t >= self.flush_deadline_s:
                if chosen is None or head_t < oldest:
                    chosen, reason, oldest = key, "deadline", head_t
        if chosen is None:
            return None
        dq = self._groups[chosen]
        take = min(len(dq), max_b)
        tickets = [dq.popleft() for _ in range(take)]
        if not dq:
            del self._groups[chosen]
        self._n_pending -= take
        setattr(self._stats, f"{reason}_flushes",
                getattr(self._stats, f"{reason}_flushes") + 1)
        self._cv.notify_all()       # submit() backpressure waiters
        return tickets, chosen, reason

    # --------------------------------------------------------------- workers
    def _worker_loop(self) -> None:
        while True:
            sp = trace.ON and trace.begin("serve.worker_wait")
            with self._cv:
                while not self._ready and not self._dispatch_done:
                    self._cv.wait()
                wave = self._ready.popleft() if self._ready else None
                if wave is not None:
                    seq = self._wave_seq
                    self._wave_seq += 1
                    idx = seq % len(self._engines)
                    engine = self._engines[idx]
                    lock = self._engine_locks[idx]
            if sp:
                trace.end(sp)
            if wave is None:            # drained and the dispatcher done
                return
            try:
                self._run_wave(wave, seq, idx, engine, lock)
            finally:
                with self._cv:
                    self._inflight -= 1
                    self._cv.notify_all()

    def _run_wave(self, wave, seq: int, replica: int, engine, lock) -> None:
        tickets, (op, _tb), _reason = wave
        n = len(tickets)
        q_bucket = self._q_bucket(n)
        use_host = self.cost_model.prefer_host(n, q_bucket)
        via = "host" if use_host else "device"
        sp = None
        try:
            wait = trace.ON and trace.begin("serve.replica_wait")
            with lock:
                if wait:
                    trace.end(wait)
                    sp = trace.begin("serve.wave", {"wave": seq, "via": via,
                                                    "n": n,
                                                    "bucket": q_bucket})
                    # each ticket's wait, on its client's thread, ends as
                    # its wave's engine call starts
                    for t in tickets:
                        if t.trace_ctx is not None:
                            trace.record("serve.queue", t.t_submit, sp.start,
                                         t.trace_ctx, {"wave": seq})
                if use_host:
                    results = [engine.host_query(t.fps, op=op)
                               for t in tickets]
                else:
                    fps_lists = [t.fps for t in tickets]
                    # pad by replicating a real query (saxml-style), not
                    # with empties: the engine drops empty queries from
                    # its live set and would re-bucket the wave to
                    # pow2(n) — a fresh wave shape per wave size instead
                    # of one per supported bucket
                    fps_lists += [fps_lists[-1]] * (q_bucket - n)
                    results = engine.query_fps_batch(fps_lists, op=op)[:n]
        except BaseException as e:
            for t in tickets:
                t._fail(e, seq)
            if sp:
                trace.end(sp)
            with self._cv:
                self._stats.failed += n
                self._bump_wave_stats(seq, replica, n, q_bucket, use_host)
            return
        for t, r in zip(tickets, results):
            t._complete(r, seq, via)
        if sp:
            trace.end(sp)
        with self._cv:
            self._stats.completed += n
            self._bump_wave_stats(seq, replica, n, q_bucket, use_host)

    def _bump_wave_stats(self, seq, replica, n, q_bucket, use_host) -> None:
        st = self._stats
        st.waves += 1
        st.host_waves += use_host
        st.device_waves += not use_host
        if not use_host:
            st.padded_slots += q_bucket - n
        st.max_wave = max(st.max_wave, n)
        st.replica_waves[replica] = st.replica_waves.get(replica, 0) + 1

    def _q_bucket(self, n: int) -> int:
        """Smallest supported bucket covering ``n`` (the pop cap keeps
        ``n`` <= the largest bucket)."""
        i = bisect.bisect_left(self.bucket_sizes, n)
        return self.bucket_sizes[min(i, len(self.bucket_sizes) - 1)]


class StoreServer:
    """Serving front end over a store view: scheduler waves for the
    candidate probe, the view's exact post-filter for matches.

    ``view_fn`` returns the current store view — the finished store
    itself, or :meth:`DynaWarpStore.snapshot` while a writer ingests.
    A view must expose ``engine``, ``n_batches``, and ``_post_filter``
    (both :class:`~repro_torch.logstore.store.DynaWarpStore` and
    :class:`~repro_torch.logstore.store.StoreSnapshot` do).

    :meth:`refresh` advances to a newer view, swapping the scheduler's
    engine replicas FIRST and the view second — so a request that
    captured view ``V`` is always served by an engine covering at least
    ``V``'s published prefix, and truncating candidates to
    ``V.n_batches`` plus the exact post-filter makes every answer
    consistent with ``V``'s prefix.  A failing ``view_fn`` (e.g. the
    writer just crashed) keeps the last good view serving.
    """

    def __init__(self, view_fn, *, n_replicas: int = 1, **scheduler_kw):
        self._view_fn = view_fn
        self.n_replicas = max(int(n_replicas), 1)
        self._refresh_lock = threading.Lock()
        view = view_fn()
        if view.engine is None:
            raise ValueError("serving requires a wave engine "
                             "(device_query=True)")
        self.scheduler = WaveScheduler(
            self._replicas(view.engine), **scheduler_kw)
        self._view = view

    def _replicas(self, engine) -> list:
        return [engine] + [engine.clone()
                           for _ in range(self.n_replicas - 1)]

    # ------------------------------------------------------------- lifecycle
    def refresh(self) -> bool:
        """Advance to the current store view; returns True if the
        serving view moved.  Safe to call from a background cadence
        thread while clients query."""
        try:
            view = self._view_fn()
        except Exception:
            return False            # writer gone mid-snapshot: keep serving
        if view.engine is None:
            return False
        with self._refresh_lock:
            old = self._view
            if (view.engine is old.engine
                    and view.n_batches == old.n_batches):
                return False
            self.scheduler.set_engines(self._replicas(view.engine))
            self._view = view       # engines first, view second
        return True

    def close(self, timeout: float = 60.0) -> None:
        self.scheduler.close(timeout)

    def __enter__(self) -> "StoreServer":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    # --------------------------------------------------------------- queries
    def _served_candidates(self, view, tickets,
                           timeout: float | None) -> list[np.ndarray]:
        out = []
        for t in tickets:
            cand = np.asarray(t.wait(timeout), np.int64)
            out.append(cand[cand < view.n_batches])
        return out

    def _submit(self, token_lists, req) -> list[WaveTicket]:
        """Submit each query's tokens; with a request span ``req`` open,
        record its ``serve.submit``: from the call's start to the last
        ticket's queueing."""
        tickets = [self.scheduler.submit(toks) for toks in token_lists]
        if req and tickets:
            trace.record("serve.submit", req.start, tickets[-1].t_submit)
        return tickets

    def query_term(self, term: str, *, timeout: float | None = None):
        req = trace.ON and trace.begin("serve.request", request=True)
        try:
            view = self._view
            tickets = self._submit([term_query_tokens(term)], req)
            cand, = self._served_candidates(view, tickets, timeout)
            return view._post_filter(cand, term, "term")
        finally:
            if req:
                trace.end(req)

    def query_contains(self, term: str, *, timeout: float | None = None):
        req = trace.ON and trace.begin("serve.request", request=True)
        try:
            view = self._view
            tokens = contains_query_tokens(term)
            if not tokens:           # no indexable n-gram: scan the prefix
                cand = np.arange(view.n_batches, dtype=np.int64)
                return view._post_filter(cand, term, "contains")
            tickets = self._submit([tokens], req)
            cand, = self._served_candidates(view, tickets, timeout)
            return view._post_filter(cand, term, "contains")
        finally:
            if req:
                trace.end(req)

    def query_term_batch(self, terms: list[str], *,
                         timeout: float | None = None) -> list:
        req = trace.ON and trace.begin("serve.request", request=True)
        try:
            view = self._view
            tickets = self._submit(
                [term_query_tokens(t) for t in terms], req)
            cands = self._served_candidates(view, tickets, timeout)
            return [view._post_filter(c, t, "term")
                    for c, t in zip(cands, terms)]
        finally:
            if req:
                trace.end(req)

    @property
    def view(self):
        return self._view


def measure_dispatch_costs(engine, token_lists, *,
                           buckets=DEFAULT_BUCKET_SIZES,
                           reps: int = 3, host_samples: int = 64) -> dict:
    """Measure the serving cost model on ``engine``: scalar host cost
    per query and one device wave's dispatch cost per Q bucket.

    Machine-readable (the scheduler's input, not a print table): the
    returned dict matches :meth:`CostModel.from_dict` — ``format``,
    ``host_us_per_query`` (float), ``device_us_per_wave`` (bucket ->
    microseconds per wave) — plus measurement provenance (``backend``:
    the engine's device type, ``n_segments``, ``reps``).  Tokens are
    hashed first, as :meth:`WaveScheduler.submit` hashes them, and each
    wave goes through ``query_fps_batch``, the entry the scheduler
    calls.  Each bucket runs one warm-up wave and is timed over
    ``reps`` waves, each between two device synchronizations (a wave
    ends with its answer's copy to the host); the median rep is
    recorded so one GC pause cannot skew the model.
    """
    def sync():
        if engine.device.type == "cuda":
            torch.cuda.synchronize(engine.device)

    buckets = sorted({int(b) for b in buckets})
    fps_lists = [[_as_fp(t) for t in toks] for toks in token_lists]
    hs = (fps_lists * (host_samples // len(fps_lists) + 1))[:host_samples]
    t0 = time.perf_counter()
    for fps in hs:
        engine.host_query(fps, op="and")
    host_us = (time.perf_counter() - t0) / max(len(hs), 1) * 1e6

    device_us = {}
    for b in buckets:
        wave = (fps_lists * (b // len(fps_lists) + 1))[:b]
        engine.query_fps_batch(wave, op="and")          # warm this bucket
        times = []
        for _ in range(max(reps, 1)):
            sync()
            t0 = time.perf_counter()
            engine.query_fps_batch(wave, op="and")
            sync()
            times.append(time.perf_counter() - t0)
        device_us[b] = statistics.median(times) * 1e6
    return {
        "format": COST_MODEL_FORMAT,
        "host_us_per_query": round(host_us, 2),
        "device_us_per_wave": {str(b): round(us, 2)
                               for b, us in device_us.items()},
        "backend": engine.device.type,
        "n_segments": len(engine.segments),
        "reps": int(reps),
    }
