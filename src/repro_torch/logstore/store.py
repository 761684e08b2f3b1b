"""Common log-store interface and the stores of the port.

Every store ingests lines one batch at a time, becomes immutable via
``finish()``, and answers term/contains queries by (1) asking its index
for candidate batches and (2) decompressing + post-filtering those batches
(the paper's protocol: false positives cost real decompression work).

Stores:
  * DynaWarpStore — the paper's sketch (rules 1-8 tokens), queried through
                    the device wave engine; durable on disk with ``path=``
                    (the JAX package's file formats).
  * CscStore      — CSC sketch baseline (rules 1-8 tokens), probed on the
                    device.
  * LuceneStore   — inverted index baseline (rules 1-5 tokens, lexicon scan
                    for contains).
  * BloomStore    — per-batch Bloom filters.
  * ScanStore     — no index; decompress-everything baseline (the oracle).
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import OrderedDict
from dataclasses import asdict, dataclass

import numpy as np
import torch

from .. import trace
from ..baselines.bloom import BloomPerBatch
from ..baselines.csc import CSCSketch
from ..baselines.inverted import InvertedIndex
from ..core import serial
from ..core.batch_builder import LineFingerprinter, build_sealed
from ..core.faults import fault_point
from ..core.hashing import token_fingerprint
from ..core.immutable_sketch import build_immutable, discard_durable_caches
from ..core.query import query_and
from ..core.query_engine import QueryEngine
from ..core.segment import (SegmentWriter, merge_sealed, sealed_postings,
                            tiered_merge)
from ..core.tokenizer import (contains_query_tokens, term_query_tokens,
                              tokenize_line)
from ..device import canonical_device, resolve_device
from ..kernels.csc_probe.ops import csc_partition_mask
from .blobfile import BlobFile
from .compress import compress_batch, decompress_batch

MANIFEST_NAME = "MANIFEST.json"
# format 2: adds ``finished`` (live-ingest manifests published at every
# spill carry finished=false until the final finish() publish), writer
# counters for reopen-for-append, and the write-path config knobs the
# resumed writer needs.  Format-1 manifests read as finished=true.
MANIFEST_FORMAT = 2


def _gc_orphan_files(path: str, live_files: set) -> list[str]:
    """Delete segment files the manifest does not reference, plus stray
    ``*.tmp`` publish leftovers — the recovery sweep for a crash between a
    segment-file write and the manifest swap.  Blob files are never GC'd
    (append-only; un-manifested tail bytes are simply never read)."""
    removed = []
    for fname in sorted(os.listdir(path)):
        is_seg = fname.startswith("seg-") and fname.endswith(".dwp")
        if not (fname.endswith(".tmp") or (is_seg and fname not in live_files)):
            continue
        fpath = os.path.join(path, fname)
        discard_durable_caches(os.path.abspath(fpath))
        try:
            os.unlink(fpath)
            removed.append(fname)
        except OSError:  # pragma: no cover - concurrent external delete
            pass
    return removed


_BACKOFF_CAP_S = 30.0


class _CompactionWorker:
    """Opt-in background compactor (``background_compact=True``): merges
    run on this worker thread and publish through the store's atomic
    manifest/engine swap, so ingest and ``finish()`` never block on
    merging.  ``schedule()`` wakes the worker, ``wait()`` drains pending
    work (re-raising any worker-side error), ``close()`` drains and
    joins.

    The worker must not die silently: a failed job is retried with capped
    exponential backoff (``store.compact_retry`` retries starting at
    ``store.compact_backoff_s``), and only after the retries are
    exhausted does the LAST error surface at ``wait()``/``close()`` —
    transient I/O errors (a disk that briefly fills, an injected EIO)
    self-heal, persistent ones are reported instead of swallowed."""

    def __init__(self, store):
        self._store = store
        self._cv = threading.Condition()
        self._pending = False
        self._active = False
        self._stop = False
        self._error: BaseException | None = None
        self.merges = 0
        self.retries = 0
        self.last_error: BaseException | None = None
        self._thread = threading.Thread(
            target=self._run, name="dynawarp-compactor", daemon=True)
        self._thread.start()

    def schedule(self) -> None:
        with self._cv:
            self._pending = True
            self._cv.notify_all()

    def wait(self, timeout: float | None = None) -> int:
        """Block until no compaction is pending or running; returns total
        merge ops performed by the worker so far."""
        with self._cv:
            self._cv.wait_for(
                lambda: ((not self._pending and not self._active)
                         or self._error is not None), timeout=timeout)
            if self._error is not None:
                err, self._error = self._error, None
                raise err
            return self.merges

    def close(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self._thread.join(timeout=300)
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _run(self) -> None:
        while True:
            with self._cv:
                self._cv.wait_for(lambda: self._pending or self._stop)
                if not self._pending and self._stop:
                    return
                self._pending = False
                self._active = True
            try:
                self._run_one_job()
            except BaseException as e:      # non-Exception (e.g. a
                with self._cv:              # simulated kill): never
                    self._error = e         # retried, surfaced directly
            finally:
                with self._cv:
                    self._active = False
                    self._cv.notify_all()

    def _run_one_job(self) -> None:
        """One scheduled compaction with capped exponential backoff.
        Backoff sleeps on the condition variable so ``close()`` can
        interrupt a retrying worker immediately.  The requested fanout is
        consumed ONCE here and passed to every attempt — a failed first
        try must not downgrade its retries to the default fanout."""
        with self._store._compact_lock:
            fanout = self._store._pending_fanout
            self._store._pending_fanout = None
        delay = max(float(self._store.compact_backoff_s), 1e-3)
        for attempt in range(max(int(self._store.compact_retry), 0) + 1):
            if attempt:
                self.retries += 1
                with self._cv:
                    if self._cv.wait_for(lambda: self._stop,
                                         timeout=min(delay, _BACKOFF_CAP_S)):
                        break               # shutting down mid-backoff
                delay *= 2
            try:
                self.merges += self._store.compact(fanout=fanout)
                return
            except Exception as e:
                self.last_error = e
        with self._cv:
            self._error = self.last_error


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
    # a durable spill's segment sync (_sync_segments(publish=True)):
    # sketch build, segment file, manifest swap and engine rebuild
    publish_s: float = 0.0
    data_bytes: int = 0
    index_bytes: int = 0
    raw_bytes: int = 0
    n_tokens_indexed: int = 0


class _BatchReader:
    """The read half that a store and a :class:`StoreSnapshot` share: the
    candidate batches of a query (``candidates_*``, the reader's own) are
    decompressed through a bounded LRU and post-filtered.  A reader holds
    ``blobs``, ``batch_start``, ``n_batches`` and the LRU's state."""

    def _batch_lower(self, b: int) -> tuple[list[str], list[str]]:
        """(lines, lowercased lines) of batch ``b`` via a bounded LRU —
        repeated queries stop re-decompressing + re-lowercasing every
        candidate batch.  Thread-safe for concurrent serving readers."""
        with self._batch_cache_lock:
            hit = self._batch_cache.get(b)
            if hit is not None:
                self._batch_cache.move_to_end(b)
                return hit
        if trace.ON:
            trace.count("batch_cache.loads")
        lines = decompress_batch(self.blobs[b])
        entry = (lines, [ln.lower() for ln in lines])
        with self._batch_cache_lock:
            self._batch_cache[b] = entry
            if len(self._batch_cache) > self._batch_cache_cap:
                self._batch_cache.popitem(last=False)
        return entry

    def _post_filter(self, candidates: np.ndarray, term: str,
                     mode: str) -> QueryResult:
        sp = trace.ON and trace.begin("store.post_filter")
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
        if sp:
            trace.end(sp)
        return QueryResult(matches=matches,
                           candidate_batches=np.asarray(candidates),
                           true_batches=true_batches,
                           batches_total=self.n_batches)

    @staticmethod
    def _term_in_line(term_l: str, line_lower: str) -> bool:
        """Exact term membership under tokenization rules 1-5."""
        return term_l.encode() in tokenize_line(line_lower, ngrams=False)

    def query_term(self, term: str) -> QueryResult:
        return self._post_filter(self.candidates_term(term), term, "term")

    def query_contains(self, term: str) -> QueryResult:
        return self._post_filter(self.candidates_contains(term), term,
                                 "contains")

    def query_term_batch(self, terms: list[str]) -> list[QueryResult]:
        return [self._post_filter(c, t, "term")
                for c, t in zip(self.candidates_term_batch(terms), terms)]


class LogStoreBase(_BatchReader):
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
        sp = trace.ON and trace.begin("store.ingest", request=True)
        t0 = time.perf_counter()
        for line in lines:
            self._buf.append(line)
            self.stats.raw_bytes += len(line) + 1
            self._n_lines += 1
            if len(self._buf) >= self.batch_lines:
                self._flush_batch()
        self.stats.ingest_s += time.perf_counter() - t0
        if sp:
            trace.end(sp)

    def _flush_batch(self) -> None:
        """Index + compress the buffered batch.  Indexing happens at flush
        granularity so columnar stores see the whole batch at once; every
        buffered line shares the flushed batch's posting id."""
        self._index_batch(self._buf, len(self.blobs))
        self._write_batch()

    def _write_batch(self) -> None:
        sp = trace.ON and trace.begin("ingest.compress")
        blob = compress_batch(self._buf)
        self.blobs.append(blob)
        self.stats.data_bytes += len(blob)
        self.batch_start.append(self._n_lines)
        self._buf = []
        if sp:
            trace.end(sp)

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

    # batch APIs: stores with a wave-capable index override
    # candidates_term_batch; the default is the sequential host loop.
    def candidates_term_batch(self, terms: list[str]) -> list[np.ndarray]:
        return [self.candidates_term(t) for t in terms]

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

    ``path`` makes the store DURABLE: compressed data batches append to
    an on-disk blob file as they flush, sealed segments publish as single
    flat files (``core.serial``, planes + sealed posting columns
    included), and a ``MANIFEST.json`` — swapped atomically via
    tmp + ``os.replace``, the §4.2 fault-tolerance primitive — names the
    live segment files and blob extents.  :meth:`open` recovers the full
    store from the manifest with segments served from ``np.memmap``
    (``mmap`` knob); device caches key on durable segment ids (file path
    + generation) and the device, so a store reopened in-process
    re-uploads nothing it already staged.  ``fsync=True`` makes every
    publish survive power loss, not just process death.
    ``background_compact=True`` moves :meth:`compact` onto a worker
    thread — merges publish through the same manifest swap while ingest
    and queries proceed; drain with :meth:`wait_compaction`, release with
    :meth:`close`.  The files are the JAX package's format: either
    package opens a store the other wrote.

    :meth:`serving` puts the wave-coalescing front end of
    ``core/serving.py`` before the store or its snapshots.
    ``shard_axes`` (e.g. ``('data',)`` or ``('pod', 'data')``) swaps the
    engine for a :class:`~repro_torch.core.distributed.ShardedQueryEngine`
    over every visible device of the store's type, the store's device
    first: segments are assigned to shards and each wave's probes fan out
    over them — same kernels, bit-identical results.  Rebuilds (spill
    publishes, compaction, ``open()``, snapshots) stay sharded, and
    unchanged segments keep their shards and uploaded buffers.
    ``extract_on_device=False`` keeps the probes and the fold on the
    device but decodes the folded bitmaps on the host
    (``QueryEngine``); None or True compacts them on the device."""
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
        super().__init__(batch_lines=batch_lines,
                         ingest_cache_size=ingest_cache_size)
        # the index is filled in here, once: a compactor thread's own
        # current device must not rename the card in the cache keys
        self.device = canonical_device(resolve_device(device))
        self.mode = mode
        self.sig_bits = sig_bits
        self.uses_ngrams = ngrams
        self.device_query = device_query or mode == "segmented"
        self.plane_budget = plane_budget_bytes
        self.memory_limit_bytes = memory_limit_bytes
        self.columnar = columnar
        self.compact_fanout = compact_fanout
        self.auto_compact = auto_compact
        self.extract_on_device = extract_on_device
        self.shard_axes = tuple(shard_axes) if shard_axes else None
        self._compact_pending = False
        self._pending_fanout: int | None = None
        self.sketch = None
        self.segments: list = []
        self.engine: QueryEngine | None = None
        # durable-store state (path=None keeps everything in host RAM)
        self.path = path
        self.mmap = mmap
        self.fsync = fsync
        self.background_compact = background_compact
        self.publish_per_spill = publish_per_spill
        self.compact_retry = compact_retry
        self.compact_backoff_s = compact_backoff_s
        self._manifest_gen = 0
        self._seg_seq = 0
        self._blob_name = "blobs-000001.dat"
        self._seg_lock = threading.RLock()      # publish/swap critical section
        self._compact_lock = threading.Lock()   # serializes compactors
        self._worker: _CompactionWorker | None = None
        # live-ingest segment state: which flush batches the current
        # self.segments cover (the published/queryable prefix), the
        # sealed-part -> sketch identity map that lets a re-sync reuse
        # already-built (and already-saved) sketches, and the staleness
        # flag a non-publishing spill leaves for the next snapshot()
        self._covered_batches = 0
        self._spill_covered = 0
        self._seg_by_part: dict = {}
        self._segments_stale = False
        if path is not None:
            if os.path.exists(os.path.join(path, MANIFEST_NAME)):
                raise ValueError(
                    f"{path}: a published store already lives here — "
                    f"use DynaWarpStore.open() to read it")
            os.makedirs(path, exist_ok=True)
            # a writer that crashed before its FIRST manifest publish may
            # have left segment/tmp files behind; nothing was ever
            # published, so sweep them and truncate any stale blob file
            _gc_orphan_files(path, set())
            blob_path = os.path.join(path, self._blob_name)
            if os.path.exists(blob_path):
                os.unlink(blob_path)
            self.blobs = BlobFile(blob_path, fsync=fsync)
        if columnar:
            self._fingerprinter = LineFingerprinter(
                device=self.device, ngrams=ngrams,
                cache_size=self._fp_cache_cap)
        if mode in ("online", "segmented"):
            # segmented mode drives spills itself at flush-batch
            # boundaries (see _flush_batch) so every sealed temporary
            # covers exactly the batches already in the blob file
            self._writer = SegmentWriter(memory_limit_bytes=memory_limit_bytes,
                                         sig_bits=sig_bits,
                                         plane_budget_bytes=plane_budget_bytes,
                                         compact_fanout=compact_fanout,
                                         auto_spill=(mode == "online"))
        else:
            self._fp_chunks: list[np.ndarray] = []
            self._post_chunks: list[np.ndarray] = []
        if background_compact:
            self._worker = _CompactionWorker(self)

    # ---------------------------------------------------------------- ingest
    def _index_batch(self, lines: list[str], batch_id: int) -> None:
        if not self.columnar:
            super()._index_batch(lines, batch_id)
            return
        flat, counts = self._fingerprinter.fingerprint_lines(lines)
        self.stats.n_tokens_indexed += int(counts.sum())
        # one posting per flush batch: the batch's fingerprint set suffices
        sp = trace.ON and trace.begin("ingest.dedup")
        fps = np.unique(flat)
        if sp:
            trace.end(sp)
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
        check runs after indexing but the spill runs after the batch is
        written, so a sealed temporary never references a batch whose
        blob is not on disk yet — the invariant that makes publishing the
        manifest at every spill safe."""
        self._index_batch(self._buf, len(self.blobs))
        spill_due = (self.mode == "segmented" and
                     self._writer._memory_bytes() > self._writer.memory_limit)
        self._write_batch()
        if spill_due:
            self._spill_publish()

    def _spill_publish(self) -> None:
        """Store-driven spill: seal the live buffers into a tier-merged
        temporary and — for a durable store with ``publish_per_spill`` —
        publish the manifest right here, shrinking the crash-loss window
        from "since finish()" to "since the last spill".  A RAM store (or
        ``publish_per_spill=False``) just marks the segment view stale;
        the next :meth:`snapshot` or ``finish()`` re-syncs lazily."""
        sp = trace.ON and trace.begin("spill", request=True)
        with self._seg_lock:
            self._writer.spill()
            self._spill_covered = len(self.blobs)
            if self.path is not None and self.publish_per_spill:
                t0 = time.perf_counter()
                self._sync_segments(publish=True)
                self.stats.publish_s += time.perf_counter() - t0
            else:
                self._segments_stale = True
        if sp:
            trace.end(sp)

    def _sync_segments(self, *, publish: bool) -> None:
        """Rebind ``self.segments`` (and the engine) to the writer's
        current temporaries.  Sketches are reused by sealed-part identity:
        a temporary that survived since the last sync keeps its built
        sketch, its saved segment file, and its device caches; only new
        (freshly spilled or tier-merged) parts build — and, when
        ``publish``, save + manifest-swap — anew.  The disk state always
        publishes BEFORE the in-RAM swap, so readers and crash recovery
        both see complete states only."""
        with self._seg_lock:
            prev = self._seg_by_part
            segs, new_map = [], {}
            for part in self._writer.temporaries:
                sk = prev.get(id(part))
                if sk is None:
                    sp = trace.ON and trace.begin("spill.sketch_build")
                    sk = build_immutable(
                        part, sig_bits=self.sig_bits,
                        plane_budget_bytes=self.plane_budget)
                    sk.sealed_source = part
                    if sp:
                        trace.end(sp)
                segs.append(sk)
                new_map[id(part)] = sk
            replaced = [sk for pid, sk in prev.items() if pid not in new_map]
            if publish:
                self._persist(segs)
            self.segments = segs
            self._seg_by_part = new_map
            self._covered_batches = self._spill_covered
            self._segments_stale = False
            sp = trace.ON and trace.begin("spill.engine_rebuild")
            for sk in replaced:
                sk.drop_device_cache()
            if self.device_query:
                self.engine = self._build_engine()
            if sp:
                trace.end(sp)

    def _seal_index(self) -> None:
        if self.mode == "segmented":
            with self._seg_lock:
                self._writer._all_parts()   # seal the live tail in place
                self._spill_covered = len(self.blobs)
                self._sync_segments(publish=False)
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
        if self.mode != "segmented":
            self._covered_batches = self._spill_covered = len(self.blobs)
            if self.device_query:
                self.engine = self._build_engine()
        if self.mode == "segmented" and (
                self._compact_pending or
                (self.auto_compact and len(self.segments) > self.compact_fanout)):
            if self._worker is not None:
                self._compact_pending = False
                self._worker.schedule()
            else:
                self.compact()

    def finish(self) -> None:
        already = self._finished
        sp = trace.ON and not already and trace.begin("store.finish",
                                                      request=True)
        super().finish()
        if self.path is not None and not already:
            self._persist()
        if sp:
            trace.end(sp)

    def wait_compaction(self, timeout: float | None = None) -> int:
        """Drain the background compactor (no-op without one); returns its
        total merge ops and re-raises any worker-side error."""
        if self._worker is None:
            return 0
        return self._worker.wait(timeout)

    def close(self) -> None:
        """Drain background work, release file handles, and free this
        store's staged device buffers from the process-global durable
        registry (closing means done — without this, a process cycling
        through many stores would accumulate every store's uploads
        forever).  Idempotent; a finished durable store can be reopened
        with :meth:`open` (its first wave re-stages)."""
        if self._worker is not None:
            self._worker.close()
            self._worker = None
        if isinstance(self.blobs, BlobFile):
            self.blobs.sync()
            self.blobs.close()
        for seg in self.segments:
            if seg.durable_id is not None:
                discard_durable_caches(seg.durable_id)

    # ------------------------------------------------------------ compaction
    def request_compact(self, *, fanout: int | None = None) -> None:
        """Mark a compaction as pending; it runs at the next ``finish()``
        (or immediately via :meth:`compact` once segments exist).  On a
        finished store with a background worker it schedules right away —
        the worker merges and publishes off-thread.  ``fanout`` overrides
        the store's ``compact_fanout`` for that one run.  Pending
        compactions never affect how the partial tail batch is flushed."""
        self._compact_pending = True
        self._pending_fanout = fanout
        if self._worker is not None and self._finished and self.segments:
            self._worker.schedule()

    def compact(self, *, fanout: int | None = None) -> int:
        """Size-tiered merge of cold segments (mode='segmented'): whenever
        ``fanout`` segments share a power-of-two size tier they merge into
        one via ``merge_sealed`` on their retained sealed sources —
        ``np.memmap``-backed for a reopened durable store, so the merge
        streams from disk — bounding query fan-out at O(log n) segments.
        Returns the number of merge ops.

        Durable stores publish before they switch: merged segment files
        are written, the manifest swaps atomically, orphaned inputs are
        deleted, and only then does the in-RAM segment list (and the
        rebuilt engine) swap in — a crash anywhere mid-compaction leaves
        either the old or the new manifest, never a broken store.
        Unchanged segments keep their uploaded device caches, merged-away
        segments drop theirs, and each newly merged segment uploads
        exactly once on its first wave."""
        with self._compact_lock:
            self._compact_pending = False
            if fanout is None:
                fanout, self._pending_fanout = self._pending_fanout, None
            segments = self.segments       # atomic snapshot (post-finish,
            if len(segments) <= 1:         # only compactors rebind it)
                return 0
            if any(s.sealed_source is None for s in segments):
                raise ValueError("compaction requires segments built with "
                                 "retained sealed sources (mode='segmented')")
            fanout = fanout or self.compact_fanout
            replaced: list = []

            def merge(group):
                replaced.extend(group)
                part = merge_sealed([s.sealed_source for s in group])
                sk = build_immutable(part, sig_bits=self.sig_bits,
                                     plane_budget_bytes=self.plane_budget)
                sk.sealed_source = part
                return sk

            segments, merges = tiered_merge(
                segments, size_of=lambda s: s.size_bytes(),
                merge=merge, fanout=fanout)
            if not merges:
                return 0
            fault_point("compact.mid_merge")
            with self._seg_lock:
                if self.path is not None:
                    self._persist(segments)
                self.segments = segments
                if self.mode == "segmented" and hasattr(self, "_writer"):
                    # pre-finish compaction must not fork the writer's
                    # view: its temporaries stay the segments' sources so
                    # the next spill/sync sees the merged parts
                    self._writer.temporaries = \
                        [s.sealed_source for s in segments]
                self._seg_by_part = {id(s.sealed_source): s
                                     for s in segments
                                     if s.sealed_source is not None}
                for s in replaced:
                    s.drop_device_cache()
                if self.engine is not None:
                    self.engine = self._build_engine()
                if self._finished:
                    self.stats.index_bytes = self.index_bytes()
            return merges

    # ------------------------------------------------------- durability
    def _persist(self, segments: list | None = None) -> None:
        """Publish the store state under ``path``: write any unpublished
        segment file, swap MANIFEST.json atomically, GC orphans.  The
        manifest swap is the §4.2 publish point — a crash before it leaves
        the previous manifest fully live (new files are orphans the next
        open()/persist sweeps up); a crash after it leaves the new state
        fully live."""
        with self._seg_lock:
            segments = self.segments if segments is None else segments
            self.blobs.sync()
            next_gen = self._manifest_gen + 1
            for seg in segments:
                if seg.durable_id is None:
                    self._save_segment(seg, next_gen)
            sp = trace.ON and trace.begin("spill.manifest_swap")
            writer = None
            if self.mode in ("online", "segmented"):
                writer = dict(n_spills=self._writer.n_spills,
                              n_compactions=self._writer.n_compactions)
            n_batches = len(self.blobs)
            manifest = dict(
                format=MANIFEST_FORMAT, generation=next_gen,
                seg_seq=self._seg_seq, blob_file=self._blob_name,
                blob_extents=[list(e) for e in self.blobs.extents],
                batch_start=[int(x)
                             for x in self.batch_start[:n_batches + 1]],
                n_lines=int(self.batch_start[n_batches]),
                finished=self._finished,
                writer=writer,
                segments=[dict(file=seg._durable_file, gen=seg._durable_gen,
                               bytes=seg._durable_bytes)
                          for seg in segments],
                stats=asdict(self.stats),
                config=dict(mode=self.mode, sig_bits=self.sig_bits,
                            ngrams=self.uses_ngrams,
                            batch_lines=self.batch_lines,
                            columnar=self.columnar,
                            compact_fanout=self.compact_fanout,
                            auto_compact=self.auto_compact,
                            plane_budget_bytes=self.plane_budget,
                            memory_limit_bytes=self.memory_limit_bytes,
                            publish_per_spill=self.publish_per_spill,
                            compact_retry=self.compact_retry,
                            compact_backoff_s=self.compact_backoff_s))
            self._swap_manifest(manifest)
            self._manifest_gen = next_gen
            _gc_orphan_files(self.path,
                             {seg._durable_file for seg in segments})
            if sp:
                trace.end(sp)

    def _save_segment(self, seg, gen: int) -> None:
        """Write one segment as a flat file (planes + sealed source
        included) and stamp its durable id — file path + generation, the
        process-global device-cache key."""
        sp = trace.ON and trace.begin("spill.segment_write")
        self._seg_seq += 1
        fname = f"seg-{self._seg_seq:06d}.dwp"
        fpath = os.path.join(self.path, fname)
        nbytes = serial.save(seg, fpath, fsync=self.fsync)
        seg._durable_file = fname
        seg._durable_gen = gen
        seg._durable_bytes = nbytes
        seg.durable_id = f"{os.path.abspath(fpath)}@g{gen}"
        if sp:
            trace.end(sp)

    def _swap_manifest(self, manifest: dict) -> None:
        """Atomic manifest publish (tmp + ``os.replace``).  Everything
        before this call is invisible to readers; everything after is
        recoverable.  Crash-recovery tests override this to simulate a
        kill at the exact publish boundary."""
        mpath = os.path.join(self.path, MANIFEST_NAME)
        tmp = mpath + ".tmp"
        fault_point("manifest.tmp_write")
        with open(tmp, "w") as f:
            json.dump(manifest, f)
            if self.fsync:
                f.flush()
                os.fsync(f.fileno())
        fault_point("manifest.replace")
        os.replace(tmp, mpath)
        fault_point("manifest.dir_fsync")
        if self.fsync:
            serial.fsync_dir(self.path)

    @classmethod
    def open(cls, path: str, *, mmap: bool = True, device_query: bool = True,
             shard_axes: tuple | None = None,
             extract_on_device: bool | None = None,
             background_compact: bool = False,
             fsync: bool = False, device=None) -> "DynaWarpStore":
        """Recover a durable store from its MANIFEST.json: orphan files
        from any interrupted publish are swept, live segments open
        ``np.memmap``-backed (only each file's header page is read up
        front), and the query engine rebuilds over durable segment ids —
        so a store reopened in the same process re-uploads no device
        buffers it already staged, and a sharded one (``shard_axes``, as
        the constructor's) finds each segment's shard slot by its durable
        id.  ``device`` is the constructor's (``None`` means the GPU).

        A FINISHED manifest comes back read-only (queryable and
        compactable).  An UNFINISHED one — published by a per-spill swap
        before the writer crashed — comes back writable: the blob file
        reopens for append (truncating any torn tail past the manifested
        extents), the segment writer rehydrates its tiered temporaries
        from the manifested sealed sources, and ``ingest()`` +
        ``finish()`` resume exactly where the last publish left off.
        Everything after the last published spill is lost by design; the
        recovered line count is always the last manifested batch
        boundary."""
        mpath = os.path.join(path, MANIFEST_NAME)
        if not os.path.exists(mpath):
            raise FileNotFoundError(
                f"{path}: no {MANIFEST_NAME} — no store was ever published "
                f"here (a crash before the first manifest swap publishes "
                f"nothing)")
        with open(mpath) as f:
            man = json.load(f)
        if man.get("format", 0) > MANIFEST_FORMAT:
            raise ValueError(f"{path}: manifest format {man['format']} is "
                             f"newer than this reader ({MANIFEST_FORMAT})")
        cfg = man["config"]
        finished = bool(man.get("finished", True))
        store = cls(batch_lines=cfg["batch_lines"], mode=cfg["mode"],
                    sig_bits=cfg["sig_bits"], ngrams=cfg["ngrams"],
                    device_query=device_query, columnar=cfg["columnar"],
                    plane_budget_bytes=cfg["plane_budget_bytes"],
                    compact_fanout=cfg["compact_fanout"],
                    auto_compact=cfg["auto_compact"],
                    memory_limit_bytes=cfg.get("memory_limit_bytes",
                                               32 << 20),
                    publish_per_spill=cfg.get("publish_per_spill", True),
                    compact_retry=cfg.get("compact_retry", 3),
                    compact_backoff_s=cfg.get("compact_backoff_s", 0.05),
                    shard_axes=shard_axes, extract_on_device=extract_on_device,
                    background_compact=background_compact, device=device)
        store.path = path
        store.mmap = mmap
        store.fsync = fsync
        store._manifest_gen = int(man["generation"])
        store._seg_seq = int(man["seg_seq"])
        store._blob_name = man["blob_file"]
        # recovery sweep BEFORE anything loads: a crash between a segment
        # write and the manifest swap leaves orphans; the manifest is truth
        _gc_orphan_files(path, {e["file"] for e in man["segments"]})
        store.blobs = BlobFile(os.path.join(path, man["blob_file"]),
                               extents=man["blob_extents"],
                               writable=not finished, fsync=fsync)
        store.batch_start = [int(x) for x in man["batch_start"]]
        store._n_lines = int(man["n_lines"])
        store.stats = IngestStats(**man["stats"])
        segs = []
        for e in man["segments"]:
            fpath = os.path.join(path, e["file"])
            sk = serial.load(fpath, mmap=mmap)
            sk.durable_id = f"{os.path.abspath(fpath)}@g{int(e['gen'])}"
            sk._durable_file = e["file"]
            sk._durable_gen = int(e["gen"])
            sk._durable_bytes = int(e["bytes"])
            segs.append(sk)
        store.segments = segs
        store._seg_by_part = {id(sk.sealed_source): sk for sk in segs
                              if sk.sealed_source is not None}
        store._covered_batches = store._spill_covered = len(store.blobs)
        if store.mode != "segmented" and len(segs) == 1:
            store.sketch = segs[0]
        store._finished = finished
        if not finished:
            if store.mode != "segmented":
                raise ValueError(
                    f"{path}: unfinished manifest with mode="
                    f"{store.mode!r} — only segmented stores publish "
                    f"mid-ingest")
            if any(sk.sealed_source is None for sk in segs):
                raise ValueError(f"{path}: unfinished manifest references "
                                 f"a segment without its sealed source")
            # rehydrate the writer: the manifested segments ARE its
            # tiered temporaries (memmap-backed), ready for more spills
            w = store._writer
            w.temporaries = [sk.sealed_source for sk in segs]
            winfo = man.get("writer") or {}
            w.n_spills = int(winfo.get("n_spills", len(segs)))
            w.n_compactions = int(winfo.get("n_compactions", 0))
        if store.device_query:
            store.engine = store._build_engine()
        return store

    def _build_engine(self) -> QueryEngine:
        """The wave engine over the current segments.  Used at finish()
        AND after every compaction, so rebuilds keep the sharding layout:
        surviving segments reuse their uploaded (per-shard) device
        buffers, merged segments upload once on their first wave."""
        if self.shard_axes is not None:
            from ..core.distributed import ShardedQueryEngine
            return ShardedQueryEngine(self.segments,
                                      n_postings=len(self.blobs),
                                      shard_axes=self.shard_axes,
                                      device=self.device,
                                      extract_on_device=self.extract_on_device)
        return QueryEngine(self.segments, n_postings=len(self.blobs),
                           device=self.device,
                           extract_on_device=self.extract_on_device)

    def index_bytes(self) -> int:
        if self.segments:
            return sum(s.size_bytes() for s in self.segments)
        return self.sketch.size_bytes() if self.sketch else 0

    # ---------------------------------------------------------------- queries
    def _candidates(self, tokens) -> np.ndarray:
        if not self._finished and self.mode == "segmented":
            return self._live_candidates(tokens)
        if self.engine is not None:
            return self.engine.query(tokens, op="and")
        return query_and(self.sketch, tokens)

    def _live_candidates(self, tokens) -> np.ndarray:
        """Queries served DURING ingest (mode='segmented'): each token's
        posting set is the union of (a) exact binary-search lookups in
        every sealed temporary's posting columns and (b) the writer's
        live columnar tail-buffer probe — covering every flushed batch,
        manifested or not, with zero sketch false positives.  The partial
        line buffer (< batch_lines lines) is not a batch yet and is not
        visible.  Single-threaded with the ingester by design; a
        concurrent reader thread uses :meth:`snapshot` instead."""
        fps = [token_fingerprint(t) for t in tokens]
        if not fps:
            return np.empty(0, np.int64)
        with self._seg_lock:
            parts = list(self._writer.temporaries)
            per_token = []
            for fp in fps:
                sets = [got for part in parts
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

    # ---------------------------------------------------------------- serving
    def serving(self, *, n_replicas: int = 1, **scheduler_kw):
        """The wave-coalescing serving front end over this store
        (:class:`~repro_torch.core.serving.StoreServer`): many client
        threads submit term/boolean queries, the scheduler coalesces them
        into shape-bucketed engine waves with ``max_live_waves`` admission
        control, and answers are bit-identical to direct
        ``query_term_batch`` calls.

        A FINISHED store serves itself (all batches).  An unfinished
        segmented store serves :meth:`snapshot` views — point-in-time
        prefixes that a background ``server.refresh()`` cadence
        advances while the writer keeps ingesting; every answer stays
        consistent with some published prefix.  ``n_replicas`` engine
        replicas (cheap: shared per-segment device caches via
        :meth:`~repro_torch.core.query_engine.QueryEngine.clone`) let up
        to ``max_live_waves`` waves overlap.  Close the server (context
        manager or ``close()``) to drain its worker threads."""
        from ..core.serving import StoreServer
        if self._finished:
            if self.engine is None:
                raise ValueError("serving requires device_query=True")
            return StoreServer(lambda: self, n_replicas=n_replicas,
                               **scheduler_kw)
        if self.mode != "segmented":
            raise ValueError("serving an unfinished store requires "
                             "mode='segmented' (snapshot readers)")
        return StoreServer(self.snapshot, n_replicas=n_replicas,
                           **scheduler_kw)

    # ------------------------------------------------------------- live reads
    def snapshot(self) -> "StoreSnapshot":
        """Point-in-time reader over the published prefix; safe to use
        from another thread while this store keeps ingesting.  The engine
        and its covered batch count swap together under the publish lock
        at every spill publish / compaction / finish, so a snapshot
        always sees a complete prefix — never a torn half-published
        state.  RAM stores (and ``publish_per_spill=False``) sync their
        segment view lazily here."""
        with self._seg_lock:
            if self._segments_stale:
                self._sync_segments(publish=False)
            return StoreSnapshot(self)


class StoreSnapshot(_BatchReader):
    """Frozen point-in-time reader over a :class:`DynaWarpStore` prefix.

    Captured atomically under the store's publish lock (see
    :meth:`DynaWarpStore.snapshot`): the engine, the covered batch count,
    and a copy of the batch-start prefix swap together, so every answer
    is exact over the first ``n_batches`` flush batches — the same prefix
    a crash at capture time would recover.  Blob extents and batch starts
    are append-only, so reads below the cutoff stay valid forever while
    the writer keeps appending; the snapshot keeps its own decompress
    LRU because the writer thread mutates the store's."""

    def __init__(self, store: "DynaWarpStore"):
        with store._seg_lock:
            self.engine = store.engine
            self.n_batches = int(store._covered_batches)
            self.batch_start = [int(x)
                                for x in store.batch_start[:self.n_batches + 1]]
            self.blobs = store.blobs
        self.n_lines = self.batch_start[-1] if self.batch_start else 0
        self._batch_cache: OrderedDict[int, tuple] = OrderedDict()
        self._batch_cache_cap = 32
        self._batch_cache_lock = threading.Lock()

    # -------------------------------------------------------- candidates
    def _candidates(self, tokens) -> np.ndarray:
        if self.engine is None or not tokens:
            return np.empty(0, np.int64)
        cand = np.asarray(self.engine.query(tokens, op="and"), np.int64)
        return cand[cand < self.n_batches]

    def candidates_term(self, term: str) -> np.ndarray:
        return self._candidates(term_query_tokens(term))

    def candidates_contains(self, term: str) -> np.ndarray:
        tokens = contains_query_tokens(term)
        if not tokens:
            return np.arange(self.n_batches, dtype=np.int64)
        return self._candidates(tokens)

    def candidates_term_batch(self, terms: list[str]) -> list[np.ndarray]:
        if self.engine is None:
            return [np.empty(0, np.int64) for _ in terms]
        out = self.engine.query_batch(
            [term_query_tokens(t) for t in terms], op="and")
        return [c[c < self.n_batches] for c in out]


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
