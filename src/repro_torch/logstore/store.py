"""Common log-store interface and the in-memory stores of the port.

Every store ingests lines one batch at a time, becomes immutable via
``finish()``, and answers term/contains queries by (1) asking its index
for candidate batches and (2) decompressing + post-filtering those batches
(the paper's protocol: false positives cost real decompression work).

Stores:
  * DynaWarpStore — the paper's sketch (rules 1-8 tokens), queried through
                    the device wave engine.
  * CscStore      — CSC sketch baseline (rules 1-8 tokens), probed on the
                    device.
  * LuceneStore   — inverted index baseline (rules 1-5 tokens, lexicon scan
                    for contains).
  * BloomStore    — per-batch Bloom filters.
  * ScanStore     — no index; decompress-everything baseline (the oracle).
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict
from dataclasses import dataclass

import numpy as np
import torch

from ..baselines.bloom import BloomPerBatch
from ..baselines.csc import CSCSketch
from ..baselines.inverted import InvertedIndex
from ..core.batch_builder import LineFingerprinter, build_sealed
from ..core.hashing import token_fingerprint
from ..core.immutable_sketch import build_immutable
from ..core.query import query_and
from ..core.query_engine import QueryEngine
from ..core.segment import (SegmentWriter, merge_sealed, sealed_postings,
                            tiered_merge)
from ..core.tokenizer import (contains_query_tokens, term_query_tokens,
                              tokenize_line)
from ..device import resolve_device
from ..kernels.csc_probe.ops import csc_partition_mask
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
        # LRU of per-line fingerprints (repeated log lines re-tokenize
        # once; _index_line and the token stats share the same result)
        self._fp_cache: OrderedDict[tuple, np.ndarray] = OrderedDict()
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
    def _line_fingerprints(self, line: str, *, ngrams: bool) -> np.ndarray:
        """Tokenize + fingerprint with a bounded LRU so duplicate log
        lines (very common in real traffic) tokenize once; the token
        count for the ingest stats rides along as ``len(fps)``."""
        key = (line, ngrams)
        fps = self._fp_cache.get(key)
        if fps is not None:
            self._fp_cache.move_to_end(key)
            return fps
        tokens = tokenize_line(line, ngrams=ngrams)
        fps = np.fromiter((token_fingerprint(t) for t in tokens),
                          dtype=np.uint32, count=len(tokens))
        self._fp_cache[key] = fps
        if len(self._fp_cache) > self._fp_cache_cap:
            self._fp_cache.popitem(last=False)
        return fps

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
    """The paper's sketch.  ``mode='batch'`` (the default) indexes every
    batch into one sort-built sketch at ``finish()``; ``mode='online'``
    uses the faithful mutable sketch with memory-bounded segmentation
    (§4.3), merged into one sketch at ``finish()``; ``mode='segmented'``
    keeps every spill as its own queryable immutable segment (no
    monolithic merge) and fans queries out across them.

    ``columnar=True`` (default) indexes whole flush batches through the
    vectorized tokenize -> fingerprint -> group pipeline
    (:class:`~repro_torch.core.batch_builder.LineFingerprinter`, whose term
    matrix goes through the ``token_hash`` kernel on a CUDA device, +
    sort-based ``build_sealed``); ``columnar=False`` keeps the per-line
    loop (scalar fingerprints).  ``ngrams=False`` indexes rules 1-5 only.

    Segmented mode bounds probe fan-out with size-tiered compaction:
    during ingest the writer merges same-tier temporaries whenever
    ``compact_fanout`` of them accumulate, and after ``finish()``
    :meth:`compact` merges cold immutable segments the same way
    (rebuilding the engine; unchanged segments keep their device caches,
    each merged segment uploads once).

    ``device_query=True`` (default) answers candidate queries through the
    :class:`QueryEngine`: batched term queries (``query_term_batch``) run
    as one device wave, lone queries take the engine's scalar host path.
    ``device_query=False`` keeps the paper's sequential host loop
    (Alg. 3, ``query_and``) on the monolithic sketch; segmented mode
    always uses the engine.  ``device=None`` means the GPU and raises
    where there is none; pass ``device="cpu"`` to run on the CPU.

    The reference's durability, sharding and background-compaction
    keywords are accepted at their defaults; any other value raises
    ``NotImplementedError`` until its slice is ported.
    ``extract_on_device`` may be None or True: extraction always runs on
    the store's device."""
    name = "dynawarp"

    def __init__(self, *, batch_lines: int = 512, mode: str = "batch",
                 sig_bits: int = 8, memory_limit_bytes: int = 32 << 20,
                 ngrams: bool = True, device_query: bool = True,
                 plane_budget_bytes: int = 64 << 20,
                 columnar: bool = True, compact_fanout: int = 4,
                 auto_compact: bool = True, ingest_cache_size: int = 2048,
                 device=None, shard_axes: tuple | None = None,
                 extract_on_device: bool | None = None,
                 path: str | None = None, mmap: bool = True,
                 fsync: bool = False, background_compact: bool = False,
                 publish_per_spill: bool = True, compact_retry: int = 3,
                 compact_backoff_s: float = 0.05):
        if mode not in ("batch", "online", "segmented"):
            raise ValueError(f"mode={mode!r}")
        if extract_on_device not in (None, True):
            raise NotImplementedError(
                f"extract_on_device={extract_on_device!r}: {_NOT_PORTED}")
        for kw, value, default in (
                ("path", path, None), ("shard_axes", shard_axes, None),
                ("mmap", mmap, True), ("fsync", fsync, False),
                ("background_compact", background_compact, False),
                ("publish_per_spill", publish_per_spill, True),
                ("compact_retry", compact_retry, 3),
                ("compact_backoff_s", compact_backoff_s, 0.05)):
            if value != default:
                raise NotImplementedError(
                    f"{kw}={value!r}: {_NOT_PORTED}")
        super().__init__(batch_lines=batch_lines,
                         ingest_cache_size=ingest_cache_size)
        self.device = resolve_device(device)
        self.mode = mode
        self.sig_bits = sig_bits
        self.uses_ngrams = ngrams
        self.device_query = device_query or mode == "segmented"
        self.plane_budget = plane_budget_bytes
        self.columnar = columnar
        self.compact_fanout = compact_fanout
        self.auto_compact = auto_compact
        self.sketch = None
        self.segments: list = []
        self.engine: QueryEngine | None = None
        if columnar:
            self._fingerprinter = LineFingerprinter(
                device=self.device, ngrams=ngrams,
                cache_size=self._fp_cache_cap)
        if mode in ("online", "segmented"):
            # segmented mode drives spills itself at flush-batch
            # boundaries (see _flush_batch), so every sealed temporary
            # covers whole batches
            self._writer = SegmentWriter(memory_limit_bytes=memory_limit_bytes,
                                         sig_bits=sig_bits,
                                         plane_budget_bytes=plane_budget_bytes,
                                         compact_fanout=compact_fanout,
                                         auto_spill=(mode == "online"))
        else:
            self._fp_chunks: list[np.ndarray] = []
            self._post_chunks: list[np.ndarray] = []

    # ---------------------------------------------------------------- ingest
    def _index_batch(self, lines: list[str], batch_id: int) -> None:
        if not self.columnar:
            super()._index_batch(lines, batch_id)
            return
        flat, counts = self._fingerprinter.fingerprint_lines(lines)
        self.stats.n_tokens_indexed += int(counts.sum())
        # one posting per flush batch: the batch's fingerprint set suffices
        fps = np.unique(flat)
        posts = np.full(fps.shape, batch_id, np.int64)
        if self.mode in ("online", "segmented"):
            self._writer.add_fingerprint_batch(fps, posts)
        else:
            self._fp_chunks.append(fps)
            self._post_chunks.append(posts)

    def _index_line(self, line: str, batch_id: int) -> None:
        fps = self._line_fingerprints(line, ngrams=self.uses_ngrams)
        self.stats.n_tokens_indexed += len(fps)
        if self.mode in ("online", "segmented"):
            self._writer.add_fingerprints(fps, batch_id)
        else:
            self._fp_chunks.append(fps)
            self._post_chunks.append(np.full(fps.shape, batch_id, np.int64))

    def _flush_batch(self) -> None:
        """Segmented mode spills at flush-batch boundaries: the memory
        check runs after indexing, the spill after the batch is written."""
        self._index_batch(self._buf, len(self.blobs))
        spill_due = (self.mode == "segmented" and
                     self._writer._memory_bytes() > self._writer.memory_limit)
        self._write_batch()
        if spill_due:
            self._writer.spill()

    def _seal_index(self) -> None:
        if self.mode == "segmented":
            segs = []
            for part in self._writer._all_parts():  # seals the live tail too
                sk = build_immutable(part, sig_bits=self.sig_bits,
                                     plane_budget_bytes=self.plane_budget)
                sk.sealed_source = part
                segs.append(sk)
            self.segments = segs
        elif self.mode == "online":
            self.sketch = self._writer.finish()
            self.segments = [self.sketch]
        else:
            sealed = build_sealed(
                np.concatenate(self._fp_chunks) if self._fp_chunks
                else np.empty(0, np.uint32),
                np.concatenate(self._post_chunks) if self._post_chunks
                else np.empty(0, np.int64))
            self.sketch = build_immutable(sealed, sig_bits=self.sig_bits,
                                          plane_budget_bytes=self.plane_budget)
            self._fp_chunks = self._post_chunks = None
            self.segments = [self.sketch]
        if self.device_query:
            self.engine = self._build_engine()
        if (self.mode == "segmented" and self.auto_compact
                and len(self.segments) > self.compact_fanout):
            self.compact()

    # ------------------------------------------------------------ compaction
    def compact(self, *, fanout: int | None = None) -> int:
        """Size-tiered merge of cold segments (mode='segmented'): whenever
        ``fanout`` segments share a power-of-two size tier they merge into
        one via ``merge_sealed`` on their retained sealed sources, bounding
        query fan-out at O(log n) segments.  Returns the number of merge
        ops.  Unchanged segments keep their uploaded device caches,
        merged-away segments drop theirs, and each merged segment uploads
        exactly once on its first wave."""
        if len(self.segments) <= 1:
            return 0
        if any(s.sealed_source is None for s in self.segments):
            raise ValueError("compaction requires segments built with "
                             "retained sealed sources (mode='segmented')")
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
        if not self._finished and self.mode == "segmented":
            return self._live_candidates(tokens)
        if self.engine is not None:
            return self.engine.query(tokens, op="and")
        return query_and(self.sketch, tokens)

    def _live_candidates(self, tokens) -> np.ndarray:
        """Queries served DURING ingest (mode='segmented'): each token's
        posting set is the union of exact binary-search lookups in every
        sealed temporary and the writer's live columnar tail — every
        flushed batch, with no sketch false positives.  The partial line
        buffer is not a batch yet and is not visible."""
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
        if not self._finished and self.mode == "segmented":
            return [self._live_candidates(term_query_tokens(t))
                    for t in terms]
        if self.engine is None:
            return super().candidates_term_batch(terms)
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


class CscStore(LogStoreBase):
    """CSC sketch baseline; sized at finish() to ``m_bits`` (the benchmark
    passes the next power of two above the DynaWarp sketch size, §5.1.3).

    Whole flush batches are fingerprinted through the same
    :class:`LineFingerprinter` as :class:`DynaWarpStore` (rules 1-8); the
    sketch is built on the host, its bits are uploaded to ``device`` once
    at ``finish()``, and every query probes them there through the
    ``csc_probe`` kernel.  ``device=None`` means the GPU."""
    name = "csc"

    def __init__(self, *, batch_lines: int = 512, m_bits: int | None = None,
                 k: int = 4, p: int = 64, j: int = 1, device=None):
        super().__init__(batch_lines=batch_lines)
        self.device = resolve_device(device)
        self.m_bits = m_bits
        self.k, self.p, self.j = k, p, j
        self._fingerprinter = LineFingerprinter(
            device=self.device, cache_size=self._fp_cache_cap)
        self._fp_chunks: list[np.ndarray] = []
        self._post_chunks: list[np.ndarray] = []
        self.sketch: CSCSketch | None = None

    def _index_batch(self, lines: list[str], batch_id: int) -> None:
        flat, counts = self._fingerprinter.fingerprint_lines(lines)
        self.stats.n_tokens_indexed += int(counts.sum())
        fps = np.unique(flat)
        self._fp_chunks.append(fps)
        self._post_chunks.append(np.full(fps.shape, batch_id, np.int64))

    def _seal_index(self) -> None:
        m_bits = self.m_bits or max(64, 16 * self._n_lines)
        self.sketch = CSCSketch.build(m_bits=m_bits, k=self.k, p=self.p,
                                      j=self.j, n_sets=len(self.blobs))
        if self._fp_chunks:
            self.sketch.insert_batch(np.concatenate(self._fp_chunks),
                                     np.concatenate(self._post_chunks))
        self._fp_chunks = self._post_chunks = None
        self.sketch.device_arrays(self.device)

    def index_bytes(self) -> int:
        return self.sketch.size_bits() // 8 if self.sketch else 0

    def _candidates(self, tokens) -> np.ndarray:
        """Sets that survive the AND of every token's partition mask."""
        fps = np.fromiter((token_fingerprint(t) for t in tokens),
                          dtype=np.uint32, count=len(tokens))
        if fps.size == 0:
            return np.empty(0, np.int64)
        mask = csc_partition_mask(
            self.sketch, torch.from_numpy(fps.view(np.int32)).to(self.device))
        return self.sketch.sets_of(mask.all(dim=0).cpu().numpy())

    def candidates_term(self, term: str) -> np.ndarray:
        # §5.2: CSC additionally intersects the n-grams of the query term
        # to reduce its error rate.
        return self._candidates(term_query_tokens(term)
                                + contains_query_tokens(term))

    def candidates_contains(self, term: str) -> np.ndarray:
        tokens = contains_query_tokens(term)
        if not tokens:
            return np.arange(len(self.blobs), dtype=np.int64)
        return self._candidates(tokens)


class LuceneStore(LogStoreBase):
    """Inverted-index baseline: full tokens (rules 1-5 only), exact
    postings, contains via lexicon scan."""
    name = "lucene"
    uses_ngrams = False

    def __init__(self, *, batch_lines: int = 512):
        super().__init__(batch_lines=batch_lines)
        self.index = InvertedIndex()

    def _index_line(self, line: str, batch_id: int) -> None:
        tokens = tokenize_line(line, ngrams=False)
        self.stats.n_tokens_indexed += len(tokens)
        self.index.add_line(tokens, batch_id)

    def _seal_index(self) -> None:
        self.index.seal()

    def index_bytes(self) -> int:
        return self.index.size_bits() // 8

    def candidates_term(self, term: str) -> np.ndarray:
        return self.index.lookup_term(term.lower().encode())

    def candidates_contains(self, term: str) -> np.ndarray:
        """Lexicon-scan contains (§2.1).  Patterns that SPAN token
        boundaries (e.g. the Log4Shell "${jndi") cannot match inside any
        single lexicon entry; like a real query planner we AND the
        postings of the pattern's full-token fragments, falling back to a
        full scan when no fragment is indexed."""
        needle = term.lower().encode()
        direct = self.index.lookup_contains(needle)
        if len(direct):
            return direct
        frags = [t for t in tokenize_line(term.lower(), ngrams=False)
                 if t != needle]
        out = None
        for f in frags:
            hit = self.index.lookup_contains(f)
            if len(hit) == 0:
                continue
            out = hit if out is None else np.intersect1d(out, hit)
        if out is None:  # nothing indexed covers the pattern: scan all
            return np.arange(len(self.blobs), dtype=np.int64)
        return out


class BloomStore(LogStoreBase):
    """One Bloom filter per batch (§2.2's trivial MS-MMQ extension).  The
    filters are host numpy, so whole flush batches are fingerprinted on
    the host too (rules 1-8)."""
    name = "bloom"

    def __init__(self, *, batch_lines: int = 512, bits_per_batch: int = 1 << 16,
                 k: int = 4):
        super().__init__(batch_lines=batch_lines)
        self.bits_per_batch = bits_per_batch
        self.k = k
        self._fingerprinter = LineFingerprinter(
            device="cpu", cache_size=self._fp_cache_cap)
        self._pending: dict[int, np.ndarray] = {}
        self.sketch: BloomPerBatch | None = None

    def _index_batch(self, lines: list[str], batch_id: int) -> None:
        flat, counts = self._fingerprinter.fingerprint_lines(lines)
        self.stats.n_tokens_indexed += int(counts.sum())
        self._pending[batch_id] = np.unique(flat)

    def _seal_index(self) -> None:
        self.sketch = BloomPerBatch.build(len(self.blobs),
                                          self.bits_per_batch, self.k)
        for b, fps in self._pending.items():
            self.sketch.insert_batch(fps, b)
        self._pending = {}

    def index_bytes(self) -> int:
        return self.sketch.size_bits() // 8 if self.sketch else 0

    def candidates_term(self, term: str) -> np.ndarray:
        fps = [token_fingerprint(t) for t in term_query_tokens(term)]
        return self.sketch.query_all_tokens(fps)

    def candidates_contains(self, term: str) -> np.ndarray:
        tokens = contains_query_tokens(term)
        if not tokens:
            return np.arange(len(self.blobs), dtype=np.int64)
        fps = [token_fingerprint(t) for t in tokens]
        return self.sketch.query_all_tokens(fps)


ALL_STORES = {
    "dynawarp": DynaWarpStore,
    "csc": CscStore,
    "lucene": LuceneStore,
    "bloom": BloomStore,
    "scan": ScanStore,
}
