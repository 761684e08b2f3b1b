"""In-memory spans and counters of the store's write path and serving path.

Recording is off by default.  ``recording()`` turns it on for the
process and leaves every span and count of its block readable on the
:class:`Recording` it yields; nothing is written anywhere::

    from repro_torch import trace

    with trace.recording() as rec:
        server.query_term("blk_-1608999687919862906")
    trace.summary(rec.spans)      # {name: n, total_s, self_s, mean_ms}

A span is a name, a start and an end on :data:`clock`
(``time.perf_counter``, the clock a device trace's marker ties the card's
timeline to), its own id, the id of the span that caused it (0 for
none), the id of the request it serves (0 for none; a request's id is its
root span's), the thread it timed and, for a few, a dict of attributes.
A count is a name, an amount, its time and the span open on its thread.

A span site in the program reads ``sp = trace.ON and trace.begin(name)``
and closes with ``if sp: trace.end(sp)``: when recording is off it costs
one read of :data:`ON` and allocates nothing.  Spans opened on one thread nest; :func:`record`
stores a span whose ends were stamped elsewhere (a queued ticket's wait,
recorded by the worker that takes it, on the client's thread).

The spans and where they sit, by path:

* serving (``core/serving.py``, ``logstore/store.py``,
  ``core/query_engine.py``): ``serve.request`` (a client's call, the
  root), ``serve.submit`` (tokenize and hash until the ticket queues),
  ``serve.queue`` (from the ticket's submit to its wave's engine call),
  ``serve.wave`` (the engine call with the replica lock held, and the
  tickets' completion), ``serve.replica_wait`` and ``serve.worker_wait``
  (a wave worker waiting for its replica's lock, and for a ready wave),
  ``serve.wake`` (from the ticket's completion to the client's return
  from ``wait()``), ``store.post_filter``, ``engine.pack``,
  ``engine.planes``, ``engine.fold``, ``engine.extract`` (a device wave's
  stages), ``engine.host_query``; the count ``batch_cache.loads`` (a
  post-filter batch decompressed and lowered on an LRU miss);
* write path: ``store.ingest`` (an ``ingest()`` call, the root),
  ``ingest.tokenize``, ``ingest.token_hash``, ``ingest.ngram``,
  ``ingest.dedup``, ``ingest.sketch_add``, ``ingest.compress``, and at a
  spill ``spill`` (a request of its own), ``spill.seal``,
  ``spill.sketch_build``, ``spill.segment_write``, ``spill.manifest_swap``
  and ``spill.engine_rebuild``; ``store.finish`` runs the same stages.
"""
from __future__ import annotations

import itertools
import threading
import time
from contextlib import contextmanager
from typing import NamedTuple

#: The clock of every span, and of the serving scheduler's stamps.
clock = time.perf_counter

#: True while a :func:`recording` runs; every span site reads it first.
ON = False

#: Spans that launch device work (their threads are the launching ones).
DEVICE_SPANS = ("engine.planes", "engine.fold", "engine.extract",
                "ingest.token_hash")


class Span(NamedTuple):
    name: str
    start: float
    end: float
    id: int
    parent: int
    request: int
    thread: int
    attrs: dict | None


class Count(NamedTuple):
    name: str
    n: int
    t: float
    parent: int
    request: int
    thread: int


class Recording:
    """What one :func:`recording` block recorded: ``spans``, ``counts``,
    and the block's ``start`` and ``end`` on :data:`clock`.

    Records are kept as plain tuples while recording (the collector
    untracks a tuple of atomic fields, and would trace a million
    NamedTuples at every full pass) and made Spans and Counts on
    reading."""

    def __init__(self):
        self._spans: list[tuple] = []
        self._counts: list[tuple] = []
        self._made: list[Span] = []
        self.start = clock()
        self.end: float | None = None

    @property
    def spans(self) -> list[Span]:
        """Every span recorded so far, in the order they ended."""
        made = self._made
        made.extend(_new(Span, r) for r in self._spans[len(made):])
        return made

    @property
    def counts(self) -> list[Count]:
        return [_new(Count, c) for c in self._counts]

    def total(self, name: str) -> int:
        """The amounts counted under ``name``, summed."""
        return sum(c[1] for c in self._counts if c[0] == name)


class _Open(NamedTuple):
    """An open span's handle."""
    name: str
    start: float
    id: int
    parent: int
    request: int
    attrs: dict | None
    rec: Recording | None


_rec: Recording | None = None
_ids = itertools.count(1)
_local = threading.local()
_get_ident = threading.get_ident
_new = tuple.__new__    # a NamedTuple made without its Python __new__


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


@contextmanager
def recording():
    """Record every span and count of the process inside the block; the
    :class:`Recording` stays readable after it."""
    global ON, _rec
    if ON:
        raise RuntimeError("a recording is already running")
    rec = Recording()
    _rec = rec
    ON = True
    try:
        yield rec
    finally:
        ON = False
        _rec = None
        rec.end = clock()


def begin(name: str, attrs: dict | None = None, *,
          request: bool = False) -> _Open:
    """Open a span on this thread, a child of its innermost open one.
    ``request=True`` starts a request whose id is the span's own."""
    st = _stack()
    sid = next(_ids)
    if st:
        top = st[-1]
        h = _new(_Open, (name, clock(), sid, top.id,
                         sid if request else top.request, attrs, _rec))
    else:
        h = _new(_Open, (name, clock(), sid, 0, sid if request else 0,
                         attrs, _rec))
    st.append(h)
    return h


def end(h: _Open, t: float | None = None) -> None:
    """Close ``h`` (at ``t``, or now), and any span an exception left
    open inside it."""
    t = clock() if t is None else t
    st = _stack()
    while st and st.pop() is not h:
        pass
    name, start, sid, parent, request, attrs, rec = h
    if rec is not None:
        rec._spans.append((name, start, t, sid, parent, request,
                           _get_ident(), attrs))


def context() -> tuple[int, int, int]:
    """(request, innermost open span, thread) of this thread, for work
    that another thread will record on its behalf."""
    st = _stack()
    if st:
        return st[-1].request, st[-1].id, _get_ident()
    return 0, 0, _get_ident()


def record(name: str, start: float, end: float,
           ctx: tuple[int, int, int] | None = None,
           attrs: dict | None = None) -> None:
    """Store a finished span whose ends were stamped elsewhere, in
    ``ctx`` (a :func:`context`; this thread's own by default)."""
    rec = _rec
    if rec is None:
        return
    request, parent, tid = context() if ctx is None else ctx
    rec._spans.append((name, start, end, next(_ids), parent, request, tid,
                       attrs))


def count(name: str, n: int = 1) -> None:
    """Count ``n`` under ``name``, in the span open on this thread."""
    rec = _rec
    if rec is None:
        return
    request, parent, tid = context()
    rec._counts.append((name, n, clock(), parent, request, tid))


# ---------------------------------------------------------------- reading
def _clip(s: Span, lo: float, hi: float) -> float:
    return max(min(s.end, hi) - max(s.start, lo), 0.0)


def summary(spans, lo: float = float("-inf"),
            hi: float = float("inf")) -> dict[str, dict]:
    """Per span name: ``n`` spans that end inside [lo, hi] and their mean
    length ``mean_ms``; ``total_s``, their seconds inside [lo, hi], and
    ``self_s``, the same less what their child spans on the same thread
    cover."""
    spans = list(spans)
    by_id = {s.id: s for s in spans}
    out: dict[str, dict] = {}
    for s in spans:
        d = out.setdefault(s.name, {"n": 0, "total_s": 0.0, "self_s": 0.0,
                                    "mean_ms": 0.0})
        c = _clip(s, lo, hi)
        d["total_s"] += c
        d["self_s"] += c
        if lo <= s.end <= hi:
            d["n"] += 1
            d["mean_ms"] += 1e3 * (s.end - s.start)
        p = by_id.get(s.parent)
        if p is not None and p.thread == s.thread:
            out.setdefault(p.name, {"n": 0, "total_s": 0.0, "self_s": 0.0,
                                    "mean_ms": 0.0})["self_s"] -= c
    for d in out.values():
        d["mean_ms"] = d["mean_ms"] / d["n"] if d["n"] else 0.0
    return out


def _innermost(spans) -> list[tuple[str, float, float]]:
    """One thread's spans -> (name, start, end) pieces in which each was
    the innermost open span."""
    out = []
    stack: list[list] = []          # [span, where its own time resumes]

    def close_top():
        top, cur = stack.pop()
        out.append((top.name, cur, top.end))
        if stack:
            stack[-1][1] = max(stack[-1][1], top.end)

    for s in sorted(spans, key=lambda s: (s.start, -s.end)):
        while stack and stack[-1][0].end <= s.start:
            close_top()
        if stack:
            out.append((stack[-1][0].name, stack[-1][1], s.start))
        stack.append([s, s.start])
    while stack:
        close_top()
    return [p for p in out if p[2] > p[1]]


def _union(iv: list) -> float:
    """Seconds covered by the union of (start, end) intervals."""
    iv = sorted(iv)
    total, cur_a, cur_b = 0.0, iv[0][0], iv[0][1]
    for a, b in iv[1:]:
        if a > cur_b:
            total += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    return total + cur_b - cur_a


def _pieces(spans, lo: float, hi: float, threads) -> dict[str, list]:
    per_thread: dict[int, list] = {}
    for s in spans:
        if s.end > lo and s.start < hi and (threads is None
                                            or s.thread in threads):
            per_thread.setdefault(s.thread, []).append(s)
    pieces: dict[str, list] = {}
    for group in per_thread.values():
        for name, a, b in _innermost(group):
            a, b = max(a, lo), min(b, hi)
            if b > a:
                pieces.setdefault(name, []).append((a, b))
    return pieces


def innermost_cover(spans, lo: float, hi: float,
                    threads=None) -> dict[str, float]:
    """Seconds of [lo, hi] in which each span name was the innermost open
    span of some thread of ``threads`` (every thread by default), the
    threads' pieces of one name united."""
    return {name: _union(iv)
            for name, iv in _pieces(spans, lo, hi, threads).items()}


def name_interval(spans, lo: float, hi: float, threads=None) -> str | None:
    """The span name that was innermost on ``threads`` for most of
    [lo, hi], if spans on those threads cover at least half of it; else
    None."""
    pieces = _pieces(spans, lo, hi, threads)
    if not pieces or _union([p for iv in pieces.values() for p in iv]) \
            < 0.5 * (hi - lo):
        return None
    return max(pieces, key=lambda name: _union(pieces[name]))


def device_threads(spans) -> set[int]:
    """The threads that recorded a span launching device work."""
    return {s.thread for s in spans if s.name in DEVICE_SPANS}
