"""The paper's own configuration: DynaWarp sketch + log-store parameters
(§4/§5 of the paper) — selectable via --arch dynawarp (alias: copr).

These defaults mirror the reference implementation:
  * 4-byte token fingerprints (2^32 hash space, §4.1)
  * short/long posting-list threshold 16, max 2^16 postings per sketch
  * 8 signature bits (false-positive factor 2^-8, §3.3)
  * BBHash gamma 2.0 (construction-speed-optimal per [20])
  * 512-line compressed batches, zstd level 3, 32 MB mutable-sketch
    memory budget before internal segmentation (§4.3, §5.1.1)

Beyond-paper write-path knobs (columnar batch ingest).  Like the
paper parameters above, these mirror the ``DynaWarpStore`` constructor
defaults (same names) — the store takes them as constructor arguments,
it does not read this dataclass:
  * ``columnar`` — index whole flush batches through the vectorized
    tokenize -> fingerprint -> sort-based-group pipeline (False restores
    the per-line reference loop)
  * ``compact_fanout`` — size-tiered compaction trigger: whenever this
    many segments/temporaries share a power-of-two size tier they merge
    into one, bounding query fan-out at O(log n) segments (<=1 disables)
  * ``auto_compact`` — run the compactor automatically at ``finish()``
    when the segment count exceeds ``compact_fanout``
  * ``ingest_cache_size`` — bounded LRU of per-unique-line fingerprint
    arrays (duplicate log lines tokenize once)

Beyond-paper read-path knobs (sharded device retrieval), also
``DynaWarpStore`` constructor arguments:
  * ``shard_axes`` — ``None`` keeps the single-device ``QueryEngine``.
    Axis tuples (``('data',)``, ``('pod', 'data')``, named as the JAX
    package's mesh axes) route waves through
    ``core.distributed.ShardedQueryEngine``: segments assigned to one
    shard per visible device (leading axes of size 1), each shard's
    probes into a partial OR-ed onto the store's device before the one
    fold and extraction.  ``ShardedQueryEngine(segments, devices=[dev]
    * N)`` holds N logical shards on one card.
  * ``extract_on_device`` — where hit bitmaps become posting ids.
    ``None``/``True`` (default): on the device through the
    ``bitmap_extract`` compaction — one id array of exactly the wave's
    answer size crosses to the host per wave.  ``False``: the folded
    (Q, W) bitmaps cross instead and each non-empty row is decoded on
    the host (flatnonzero over its non-empty words, LRU-cached by
    content); the probes and the fold stay on the device.  Lone queries
    always take the scalar host path and never materialize bitmaps at
    all.

Beyond-paper durability knobs (manifest-based segment store),
also ``DynaWarpStore`` constructor arguments:
  * ``path`` — ``None`` (default) keeps blobs + segments in host RAM
    (the seed behaviour).  A directory path makes the store durable:
    compressed batches append to an on-disk blob file as they flush,
    sealed segments publish as single flat files (``core.serial``,
    bitmap planes + sealed posting columns included so merges work
    from disk), and an atomically-swapped ``MANIFEST.json`` (tmp +
    ``os.replace`` — the paper's §4.2 fault-tolerance primitive) names
    the live segment files and blob extents.
    ``DynaWarpStore.open(path)`` recovers the whole store in a fresh
    process, bit-identical on term/contains/batched queries.
  * ``mmap`` — ``True`` (default): ``open()`` serves segment buffers
    through ``np.memmap`` — only each file's header page is read up
    front; probes page in lazily and the first device wave streams the
    upload straight from the page cache.  ``False``: read segment
    files eagerly into RAM.
  * ``fsync`` — ``False`` (default): publishes are atomic against
    process crashes (rename ordering) but not guaranteed against power
    loss.  ``True``: blob appends, segment files, the manifest, and
    the directory are fsync'd at every publish point.
  * ``background_compact`` — ``False`` (default): ``compact()`` runs
    synchronously (at ``finish()`` under ``auto_compact``, or on
    demand).  ``True``: compaction moves to an opt-in worker thread —
    merges read memmapped sealed sources, publish via the same atomic
    manifest swap, and swap the engine without blocking ingest or
    queries; drain with ``wait_compaction()``, release with
    ``close()``.

Beyond-paper crash-safe live-ingest knobs , also
``DynaWarpStore`` constructor arguments:
  * ``publish_per_spill`` — ``True`` (default): a durable segmented
    store swaps its manifest at EVERY spill, not only at ``finish()``.
    A crashed ingest then loses at most the data since the last spill:
    ``DynaWarpStore.open(path)`` of the unfinished directory truncates
    the blob file to the manifested extents, rehydrates the segment
    writer from the manifested sealed sources, and supports
    reopen-for-append (``ingest()`` + an idempotent ``finish()``
    resume where the last publish left off).  Mid-ingest manifests
    carry ``finished: false``.  ``False``: publish only at
    ``finish()`` (cheaper spills, larger crash window).  Queries during ingest work either way: ``snapshot()``
    captures a point-in-time reader over the published prefix (safe
    from another thread), and direct queries on the writing store take
    an exact host probe over the sealed temporaries + live tail
    buffer.
  * ``compact_retry`` — background-compaction robustness: how many
    times the worker retries a FAILED compaction before surfacing the
    last error at ``wait_compaction()``/``close()`` (3 by default; 0
    disables retries).  Transient I/O errors self-heal instead of
    killing the worker thread or silently dropping the merge.
  * ``compact_backoff_s`` — initial retry backoff in seconds (0.05 by
    default); doubles per retry, capped at 30 s.  The backoff sleeps
    interruptibly so ``close()`` never waits out a pending retry.

Beyond-paper serving knobs (wave-coalescing front end).  Unlike
the store knobs above these parameterize ``DynaWarpStore.serving()`` /
``repro_torch.core.serving.WaveScheduler`` (same names), the layer that turns
concurrent client queries into shape-bucketed engine waves:
  * ``serve_replicas`` — engine replicas behind the one wave queue
    (``QueryEngine.clone()`` per extra replica — clones share every
    per-segment device buffer, so a replica costs an LRU, not segment
    uploads).  Waves round-robin across replicas, each
    guarded by its own lock, so up to ``min(serve_replicas,
    max_live_waves)`` waves execute truly concurrently.
  * ``max_live_waves`` — admission control: at most this many waves in
    flight at once.  When saturated the dispatcher HOLDS further
    flushes — arrivals keep coalescing into bigger waves — and once
    ``serve_max_pending`` queries queue, ``submit()`` blocks the
    client (backpressure; queries are never dropped).
  * ``flush_deadline_s`` — a coalescing group flushes as a wave when
    its oldest request ages past this deadline (a lone straggler waits
    at most this long) or when it reaches the largest wave bucket,
    whichever comes first.
  * ``wave_bucket_sizes`` — sorted supported Q buckets; a flushed wave
    pads up to the smallest covering bucket (and unpads on
    completion), so steady-state serving takes one padded wave shape
    per bucket instead of one per wave size.  Must mirror the engine's
    power-of-two padding geometry.
  * ``serve_max_pending`` — the backpressure bound above.
  * ``cost_model_path`` — per-bucket dispatch-cost JSON emitted by
    ``repro_torch.core.serving.measure_dispatch_costs``
    (``bench_costmodel.json``, the JAX package's format); loaded via
    ``repro_torch.core.serving.CostModel.load`` it drives the
    per-wave host-vs-device decision (``n_queries * host_us_per_query
    <= device_us_per_wave[bucket]`` -> scalar host path).  ``None``
    uses built-in placeholder costs.
"""
from dataclasses import dataclass


@dataclass(frozen=True)
class DynaWarpConfig:
    name: str = "dynawarp"
    fingerprint_bytes: int = 4
    sig_bits: int = 8
    short_list_max: int = 16
    max_postings: int = 1 << 16
    bbhash_gamma: float = 2.0
    batch_lines: int = 512
    zstd_level: int = 3
    memory_limit_bytes: int = 32 << 20
    ngrams: bool = True
    # columnar ingest + compaction (logstore.store.DynaWarpStore)
    columnar: bool = True
    compact_fanout: int = 4
    auto_compact: bool = True
    ingest_cache_size: int = 2048
    # sharded device retrieval (logstore.store.DynaWarpStore)
    shard_axes: tuple | None = None  # e.g. ("data",) / ("pod", "data")
    extract_on_device: bool | None = None
    # durable segment store (logstore.store.DynaWarpStore)
    path: str | None = None          # store directory; None = host RAM
    mmap: bool = True                # open() serves segments via np.memmap
    fsync: bool = False              # fsync every publish (power-loss safe)
    background_compact: bool = False  # compact on a worker thread
    # crash-safe live ingest (logstore.store.DynaWarpStore)
    publish_per_spill: bool = True   # manifest swap at every spill
    compact_retry: int = 3           # worker retries before surfacing
    compact_backoff_s: float = 0.05  # initial retry backoff (doubles)
    # wave-coalescing serving front end (core.serving)
    serve_replicas: int = 2          # engine replicas behind the queue
    max_live_waves: int = 2          # admission: concurrent waves cap
    flush_deadline_s: float = 0.002  # straggler flush deadline
    wave_bucket_sizes: tuple = (8, 16, 32, 64, 128, 256)
    serve_max_pending: int = 8192    # submit() blocks past this
    cost_model_path: str | None = None   # bench_costmodel.json
    # distributed probe layout (the JAX package's dry run reads these)
    segments_axis: str = "data"      # segments shard over data (x pod)
    words_axis: str = "model"        # bitmap words shard over model


CONFIG = DynaWarpConfig()
SMOKE = DynaWarpConfig(name="dynawarp-smoke", batch_lines=32,
                       memory_limit_bytes=1 << 14, compact_fanout=2)
