"""Common log-store interface and the in-memory stores of the port.

Every store ingests lines one batch at a time, becomes immutable via
``finish()``, and answers term/contains queries by (1) asking its index
for candidate batches and (2) decompressing + post-filtering those batches
(the paper's protocol: false positives cost real decompression work).

Stores:
  * DynaWarpStore — the paper's sketch (rules 1-8 tokens), segmented,
                    queried through the device wave engine.
  * ScanStore     — no index; decompress-everything baseline (the oracle).
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict
from dataclasses import dataclass

import numpy as np

from ..core.batch_builder import LineFingerprinter
from ..core.hashing import token_fingerprint
from ..core.immutable_sketch import build_immutable
from ..core.query_engine import QueryEngine
from ..core.segment import (SegmentWriter, merge_sealed, sealed_postings,
                            tiered_merge)
from ..core.tokenizer import (contains_query_tokens, term_query_tokens,
                              tokenize_line)
from ..device import resolve_device
from .compress import compress_batch, decompress_batch

_NOT_PORTED = "not yet ported"


@dataclass
class QueryResult:
    matches: list[int]              # global line indices
    candidate_batches: np.ndarray   # batches the index said to read
    true_batches: int               # candidates that actually matched
    batches_total: int

    @property
    def false_positive_batches(self) -> int:
        return len(self.candidate_batches) - self.true_batches

    @property
    def error_rate(self) -> float:
        """Paper §5.2: found-but-irrelevant batches / total batches."""
        if self.batches_total == 0:
            return 0.0
        return self.false_positive_batches / self.batches_total


@dataclass
class IngestStats:
    ingest_s: float = 0.0        # tokenize + index + buffer
    sketch_finish_s: float = 0.0
    data_finish_s: float = 0.0
    data_bytes: int = 0
    index_bytes: int = 0
    raw_bytes: int = 0
    n_tokens_indexed: int = 0


class LogStoreBase:
    """Batched storage common to all stores."""
    name = "base"
    uses_ngrams = True

    def __init__(self, *, batch_lines: int = 512,
                 batch_cache_size: int = 128,
                 ingest_cache_size: int = 2048):
        self.batch_lines = batch_lines
        self.blobs: list[bytes] = []
        self.batch_start: list[int] = [0]
        self._buf: list[str] = []
        self._n_lines = 0
        self.stats = IngestStats()
        self._finished = False
        # LRU of decompressed + lowercased batches (query post-filter);
        # the lock keeps concurrent serving readers off each other's
        # OrderedDict mutations (decompression itself runs unlocked)
        self._batch_cache: OrderedDict[int, tuple] = OrderedDict()
        self._batch_cache_cap = batch_cache_size
        self._batch_cache_lock = threading.Lock()
        # bound of the per-line fingerprint LRU of indexing stores
        self._fp_cache_cap = ingest_cache_size

    # ------------------------------------------------------------------ ingest
    def ingest(self, lines) -> None:
        t0 = time.perf_counter()
        for line in lines:
            self._buf.append(line)
            self.stats.raw_bytes += len(line) + 1
            self._n_lines += 1
            if len(self._buf) >= self.batch_lines:
                self._flush_batch()
        self.stats.ingest_s += time.perf_counter() - t0

    def _flush_batch(self) -> None:
        """Index + compress the buffered batch.  Indexing happens at flush
        granularity so columnar stores see the whole batch at once; every
        buffered line shares the flushed batch's posting id."""
        self._index_batch(self._buf, len(self.blobs))
        self._write_batch()

    def _write_batch(self) -> None:
        blob = compress_batch(self._buf)
        self.blobs.append(blob)
        self.stats.data_bytes += len(blob)
        self.batch_start.append(self._n_lines)
        self._buf = []

    def finish(self) -> None:
        if self._finished:   # idempotent: a second finish() must not
            return           # rebuild (or empty) the sealed index
        # deterministic flush of the partial tail batch: it is indexed and
        # compressed exactly like a full batch, regardless of any pending
        # compaction (the compactor only runs in _seal_index); its index
        # cost stays in ingest_s, its compression in data_finish_s
        if self._buf:
            t0 = time.perf_counter()
            self._index_batch(self._buf, len(self.blobs))
            self.stats.ingest_s += time.perf_counter() - t0
        t0 = time.perf_counter()
        if self._buf:
            self._write_batch()
        self.stats.data_finish_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        self._seal_index()
        self.stats.sketch_finish_s = time.perf_counter() - t0
        self.stats.index_bytes = self.index_bytes()
        self._finished = True

    # hooks ---------------------------------------------------------------
    def _index_batch(self, lines: list[str], batch_id: int) -> None:
        """Index one flush batch; the default is the per-line seed loop,
        columnar stores override with a vectorized whole-batch stage."""
        for line in lines:
            self._index_line(line, batch_id)

    def _index_line(self, line: str, batch_id: int) -> None:
        pass

    def _seal_index(self) -> None:
        pass

    def index_bytes(self) -> int:
        return 0

    def candidates_term(self, term: str) -> np.ndarray:
        return np.arange(len(self.blobs), dtype=np.int64)

    def candidates_contains(self, term: str) -> np.ndarray:
        return np.arange(len(self.blobs), dtype=np.int64)

    # ---------------------------------------------------------------- caches
    def _batch_lower(self, b: int) -> tuple[list[str], list[str]]:
        """(lines, lowercased lines) of batch ``b`` via a bounded LRU —
        repeated queries stop re-decompressing + re-lowercasing every
        candidate batch.  Thread-safe for concurrent serving readers."""
        with self._batch_cache_lock:
            hit = self._batch_cache.get(b)
            if hit is not None:
                self._batch_cache.move_to_end(b)
                return hit
        lines = decompress_batch(self.blobs[b])
        entry = (lines, [ln.lower() for ln in lines])
        with self._batch_cache_lock:
            self._batch_cache[b] = entry
            if len(self._batch_cache) > self._batch_cache_cap:
                self._batch_cache.popitem(last=False)
        return entry

    # ------------------------------------------------------------------ query
    def _post_filter(self, candidates: np.ndarray, term: str,
                     mode: str) -> QueryResult:
        term_l = term.lower()
        matches: list[int] = []
        true_batches = 0
        for b in candidates:
            _, lowered = self._batch_lower(int(b))
            base = self.batch_start[int(b)]
            hit = False
            for i, low in enumerate(lowered):
                if term_l not in low:
                    continue
                if mode == "contains" or self._term_in_line(term_l, low):
                    matches.append(base + i)
                    hit = True
            true_batches += hit
        return QueryResult(matches=matches,
                           candidate_batches=np.asarray(candidates),
                           true_batches=true_batches,
                           batches_total=len(self.blobs))

    @staticmethod
    def _term_in_line(term_l: str, line_lower: str) -> bool:
        """Exact term membership under tokenization rules 1-5."""
        return term_l.encode() in tokenize_line(line_lower, ngrams=False)

    def query_term(self, term: str) -> QueryResult:
        return self._post_filter(self.candidates_term(term), term, "term")

    def query_contains(self, term: str) -> QueryResult:
        return self._post_filter(self.candidates_contains(term), term,
                                 "contains")

    # batch APIs: stores with a wave-capable index override
    # candidates_term_batch; the default is the sequential host loop.
    def candidates_term_batch(self, terms: list[str]) -> list[np.ndarray]:
        return [self.candidates_term(t) for t in terms]

    def query_term_batch(self, terms: list[str]) -> list[QueryResult]:
        return [self._post_filter(c, t, "term")
                for c, t in zip(self.candidates_term_batch(terms), terms)]

    @property
    def n_batches(self) -> int:
        return len(self.blobs)


class ScanStore(LogStoreBase):
    """Brute-force decompress-and-scan baseline."""
    name = "scan"
    uses_ngrams = False


class DynaWarpStore(LogStoreBase):
    """The paper's sketch in ``mode='segmented'``: every spill stays its
    own queryable immutable segment (no monolithic merge) and queries fan
    out across them through the device :class:`QueryEngine`.  Whole flush
    batches are indexed through the vectorized tokenize -> fingerprint ->
    group pipeline (:class:`~repro_torch.core.batch_builder.LineFingerprinter`
    + sort-based ``build_sealed``), with rules 1-8 tokens.

    Fan-out stays bounded by size-tiered compaction: during ingest the
    writer merges same-tier temporaries whenever ``compact_fanout`` of them
    accumulate, and after ``finish()`` :meth:`compact` merges cold
    immutable segments the same way (rebuilding the engine; unchanged
    segments keep their device caches, each merged segment uploads once).

    Batched term queries (``query_term_batch``) run as one device wave;
    lone queries take the engine's scalar host path.  ``device=None``
    means the GPU and raises where there is none; pass ``device="cpu"``
    to run on the CPU."""
    name = "dynawarp"

    def __init__(self, *, batch_lines: int = 512, mode: str = "segmented",
                 sig_bits: int = 8, memory_limit_bytes: int = 32 << 20,
                 plane_budget_bytes: int = 64 << 20, compact_fanout: int = 4,
                 auto_compact: bool = True, device=None,
                 path: str | None = None, shard_axes: tuple | None = None):
        if mode != "segmented":
            if mode in ("batch", "online"):
                raise NotImplementedError(f"mode={mode!r}: {_NOT_PORTED}")
            raise ValueError(f"mode={mode!r}")
        if path is not None:
            raise NotImplementedError(f"path=: {_NOT_PORTED}")
        if shard_axes is not None:
            raise NotImplementedError(f"shard_axes=: {_NOT_PORTED}")
        super().__init__(batch_lines=batch_lines)
        self.device = resolve_device(device)
        self.mode = mode
        self.sig_bits = sig_bits
        self.plane_budget = plane_budget_bytes
        self.compact_fanout = compact_fanout
        self.auto_compact = auto_compact
        self.segments: list = []
        self.engine: QueryEngine | None = None
        self._fingerprinter = LineFingerprinter(cache_size=self._fp_cache_cap)
        # the store drives spills itself at flush-batch boundaries (see
        # _flush_batch), so every sealed temporary covers whole batches
        self._writer = SegmentWriter(memory_limit_bytes=memory_limit_bytes,
                                     sig_bits=sig_bits,
                                     plane_budget_bytes=plane_budget_bytes,
                                     compact_fanout=compact_fanout,
                                     auto_spill=False)

    # ---------------------------------------------------------------- ingest
    def _index_batch(self, lines: list[str], batch_id: int) -> None:
        flat, counts = self._fingerprinter.fingerprint_lines(lines)
        self.stats.n_tokens_indexed += int(counts.sum())
        # one posting per flush batch: the batch's fingerprint set suffices
        fps = np.unique(flat)
        self._writer.add_fingerprint_batch(
            fps, np.full(fps.shape, batch_id, np.int64))

    def _flush_batch(self) -> None:
        """Spill at flush-batch boundaries: the memory check runs after
        indexing, the spill after the batch is written."""
        self._index_batch(self._buf, len(self.blobs))
        spill_due = self._writer._memory_bytes() > self._writer.memory_limit
        self._write_batch()
        if spill_due:
            self._writer.spill()

    def _seal_index(self) -> None:
        segs = []
        for part in self._writer._all_parts():  # seals the live tail too
            sk = build_immutable(part, sig_bits=self.sig_bits,
                                 plane_budget_bytes=self.plane_budget)
            sk.sealed_source = part
            segs.append(sk)
        self.segments = segs
        self.engine = self._build_engine()
        if self.auto_compact and len(self.segments) > self.compact_fanout:
            self.compact()

    # ------------------------------------------------------------ compaction
    def compact(self, *, fanout: int | None = None) -> int:
        """Size-tiered merge of cold segments: whenever ``fanout`` segments
        share a power-of-two size tier they merge into one via
        ``merge_sealed`` on their retained sealed sources, bounding query
        fan-out at O(log n) segments.  Returns the number of merge ops.
        Unchanged segments keep their uploaded device caches, merged-away
        segments drop theirs, and each merged segment uploads exactly once
        on its first wave."""
        if len(self.segments) <= 1:
            return 0
        replaced: list = []

        def merge(group):
            replaced.extend(group)
            part = merge_sealed([s.sealed_source for s in group])
            sk = build_immutable(part, sig_bits=self.sig_bits,
                                 plane_budget_bytes=self.plane_budget)
            sk.sealed_source = part
            return sk

        segments, merges = tiered_merge(
            self.segments, size_of=lambda s: s.size_bytes(), merge=merge,
            fanout=fanout or self.compact_fanout)
        if not merges:
            return 0
        self.segments = segments
        # the writer's temporaries stay the segments' sources
        self._writer.temporaries = [s.sealed_source for s in segments]
        for s in replaced:
            s.drop_device_cache()
        self.engine = self._build_engine()
        if self._finished:
            self.stats.index_bytes = self.index_bytes()
        return merges

    def _build_engine(self) -> QueryEngine:
        return QueryEngine(self.segments, n_postings=len(self.blobs),
                           device=self.device)

    def index_bytes(self) -> int:
        return sum(s.size_bytes() for s in self.segments)

    # ---------------------------------------------------------------- queries
    def _candidates(self, tokens) -> np.ndarray:
        if not self._finished:
            return self._live_candidates(tokens)
        return self.engine.query(tokens, op="and")

    def _live_candidates(self, tokens) -> np.ndarray:
        """Queries served DURING ingest: each token's posting set is the
        union of exact binary-search lookups in every sealed temporary and
        the writer's live columnar tail — every flushed batch, with no
        sketch false positives.  The partial line buffer is not a batch
        yet and is not visible."""
        fps = [token_fingerprint(t) for t in tokens]
        if not fps:
            return np.empty(0, np.int64)
        per_token = []
        for fp in fps:
            sets = [got for part in self._writer.temporaries
                    if (got := sealed_postings(part, fp)) is not None]
            live = self._writer.live_postings(fp)
            if len(live):
                sets.append(live)
            per_token.append(np.unique(np.concatenate(sets)) if sets
                             else np.empty(0, np.int64))
        acc = per_token[0]
        for posts in per_token[1:]:
            acc = np.intersect1d(acc, posts)
        return acc.astype(np.int64)

    def candidates_term(self, term: str) -> np.ndarray:
        return self._candidates(term_query_tokens(term))

    def candidates_contains(self, term: str) -> np.ndarray:
        tokens = contains_query_tokens(term)
        if not tokens:
            return np.arange(len(self.blobs), dtype=np.int64)  # full scan
        return self._candidates(tokens)

    def candidates_term_batch(self, terms: list[str]) -> list[np.ndarray]:
        """One engine wave answers the whole batch of term queries."""
        if not self._finished:
            return [self._live_candidates(term_query_tokens(t))
                    for t in terms]
        return self.engine.query_batch(
            [term_query_tokens(t) for t in terms], op="and")

    # ------------------------------------------------------------ not ported
    def snapshot(self):
        raise NotImplementedError(f"snapshot(): {_NOT_PORTED}")

    def serving(self, **kw):
        raise NotImplementedError(f"serving(): {_NOT_PORTED}")

    @classmethod
    def open(cls, path: str, **kw):
        raise NotImplementedError(f"open(): {_NOT_PORTED}")
