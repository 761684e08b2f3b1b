"""Segmentation (§4.3): memory-bounded ingest with spill + merge, plus the
size-tiered compaction machinery that keeps segment fan-out bounded.

A ``SegmentWriter`` accepts columnar (fps, postings) batches — buffered as
flat arrays and sealed with the vectorized batch builder on spill — and,
for streamed scalar adds, still feeds the faithful mutable sketch, which
has become the small cross-batch overflow structure.  When the estimated
memory of the buffers + sketch exceeds ``memory_limit_bytes`` the live
content is sealed into a *temporary* segment (which — like the paper —
keeps the full token fingerprints so a later merge is possible; MPHFs
alone are not mergeable).  Temporaries are size-tiered: whenever
``compact_fanout`` temporaries land in the same power-of-two size tier
they merge into one, so the number of live segments stays O(log n).

``finish()`` merges all temporaries plus the live content into one
immutable sketch via the batch builder, equivalent to never having
segmented; ``finish_segments()`` instead builds one immutable sketch per
temporary for the multi-segment query fan-out.
"""
from __future__ import annotations

import numpy as np

from .. import trace
from .batch_builder import build_sealed
from .immutable_sketch import ImmutableSketch, build_immutable
from .mutable_sketch import MutableSketch, SealedContent


def _tier(size: int) -> int:
    """Power-of-two size tier (LSM-style) of a segment size."""
    return max(0, int(size)).bit_length()


def tiered_merge(items: list, *, size_of, merge, fanout: int
                 ) -> tuple[list, int]:
    """Size-tiered compaction: while any power-of-two size tier holds
    >= ``fanout`` items, merge that tier into one item (placed at the
    position of its oldest member).  Returns (items, merge ops).  With N
    inserts of bounded size the surviving item count is O(log N).
    ``fanout <= 1`` disables compaction."""
    if fanout <= 1:
        return items, 0
    n_merges = 0
    while True:
        tiers: dict[int, list[int]] = {}
        for i, it in enumerate(items):
            tiers.setdefault(_tier(size_of(it)), []).append(i)
        crowded = [v for v in tiers.values() if len(v) >= fanout]
        if not crowded:
            return items, n_merges
        idxs = set(crowded[0])
        merged = merge([items[i] for i in sorted(idxs)])
        items = [it for i, it in enumerate(items) if i not in idxs]
        items.insert(min(min(idxs), len(items)), merged)
        n_merges += 1


class SegmentWriter:
    def __init__(self, *, memory_limit_bytes: int = 32 << 20,
                 short_list_threshold: int = 16,
                 sig_bits: int = 8,
                 plane_budget_bytes: int = 64 << 20,
                 compact_fanout: int = 4,
                 auto_spill: bool = True):
        self.memory_limit = memory_limit_bytes
        self.threshold = short_list_threshold
        self.sig_bits = sig_bits
        self.plane_budget = plane_budget_bytes
        self.compact_fanout = compact_fanout
        # auto_spill=False hands spill timing to the caller: the durable
        # store spills only at flush-batch boundaries so every sealed
        # temporary covers exactly the batches already written to the blob
        # file — the invariant per-spill manifest publication relies on.
        self.auto_spill = auto_spill
        self.sketch = MutableSketch(short_list_threshold=short_list_threshold)
        self.temporaries: list[SealedContent] = []
        self._col_fps: list[np.ndarray] = []
        self._col_posts: list[np.ndarray] = []
        self._col_bytes = 0
        self._col_version = 0
        self._live_sorted: tuple | None = None
        self._adds_since_check = 0
        self.n_spills = 0
        self.n_compactions = 0

    # ------------------------------------------------------------- ingest
    def add_line(self, tokens, posting: int) -> None:
        self.sketch.add_line(tokens, posting)
        self._adds_since_check += len(tokens)
        if self._adds_since_check >= 4096:
            self._adds_since_check = 0
            if self.auto_spill and self._memory_bytes() > self.memory_limit:
                self.spill()

    def add_fingerprints(self, fps, posting: int) -> None:
        for fp in fps:
            self.sketch.add_fingerprint(int(fp), posting)
        self._adds_since_check += len(fps)
        if self._adds_since_check >= 4096:
            self._adds_since_check = 0
            if self.auto_spill and self._memory_bytes() > self.memory_limit:
                self.spill()

    def add_fingerprint_batch(self, fps: np.ndarray,
                              postings: np.ndarray) -> None:
        """Columnar ingest: parallel (fp, posting) arrays are buffered as
        flat chunks — no per-token probing — and sealed with the sort-based
        batch builder on spill."""
        fps = np.asarray(fps, dtype=np.uint32)
        postings = np.asarray(postings, dtype=np.int64)
        if fps.shape != postings.shape:
            raise ValueError("fps and postings must be parallel 1-D arrays")
        if fps.size == 0:
            return
        sp = trace.ON and trace.begin("ingest.sketch_add")
        self._col_fps.append(fps)
        self._col_posts.append(postings)
        self._col_bytes += fps.nbytes + postings.nbytes
        self._col_version += 1
        if sp:
            trace.end(sp)
        if self.auto_spill and self._memory_bytes() > self.memory_limit:
            self.spill()

    def _memory_bytes(self) -> int:
        return self._col_bytes + self.sketch.memory_bytes()

    # --------------------------------------------------------- live probe
    def live_postings(self, fp: int) -> np.ndarray:
        """Exact postings of ``fp`` in the LIVE (un-spilled) content: the
        columnar tail buffers plus the mutable overflow sketch.  This is
        the host probe behind queries served *during* ingest — the sealed
        temporaries cover everything up to the last spill, this covers the
        rest.  The sorted view of the tail buffers is cached and only
        rebuilt when the buffers changed since the last probe."""
        parts: list[np.ndarray] = []
        if self._col_fps:
            cache = self._live_sorted
            if cache is None or cache[0] != self._col_version:
                flat = np.concatenate(self._col_fps)
                posts = np.concatenate(self._col_posts)
                order = np.argsort(flat, kind="stable")
                cache = (self._col_version, flat[order], posts[order])
                self._live_sorted = cache
            _, sorted_fps, sorted_posts = cache
            lo = np.searchsorted(sorted_fps, np.uint32(fp), side="left")
            hi = np.searchsorted(sorted_fps, np.uint32(fp), side="right")
            if hi > lo:
                parts.append(np.asarray(sorted_posts[lo:hi], np.int64))
        got = self.sketch.acquire_postings(int(fp))
        if got is not None:
            parts.append(np.asarray(got, np.int64))
        if not parts:
            return np.empty(0, np.int64)
        return np.unique(np.concatenate(parts))

    # -------------------------------------------------------------- spill
    def _live_part(self) -> SealedContent | None:
        """Seal the live columnar buffers + overflow sketch (if any) into
        one SealedContent, resetting the live state."""
        parts: list[SealedContent] = []
        if self._col_fps:
            parts.append(build_sealed(np.concatenate(self._col_fps),
                                      np.concatenate(self._col_posts)))
            self._col_fps, self._col_posts = [], []
            self._col_bytes = 0
            self._col_version += 1
            self._live_sorted = None
        if self.sketch.stats.tokens:
            parts.append(self.sketch.seal())
            self.sketch = MutableSketch(short_list_threshold=self.threshold)
        if not parts:
            return None
        return parts[0] if len(parts) == 1 else merge_sealed(parts)

    def spill(self) -> None:
        """Seal the live content into a temporary segment (full
        fingerprints retained), then size-tier-compact the temporaries."""
        sp = trace.ON and trace.begin("spill.seal")
        part = self._live_part()
        if part is not None:
            self.temporaries.append(part)
            self.n_spills += 1
            self.temporaries, merges = tiered_merge(
                self.temporaries, size_of=lambda p: len(p.fps),
                merge=merge_sealed, fanout=self.compact_fanout)
            self.n_compactions += merges
        if sp:
            trace.end(sp)

    # ------------------------------------------------------------- finish
    def finish(self) -> ImmutableSketch:
        """Merge temporaries + live content into the final immutable
        sketch."""
        parts = self._all_parts()
        merged = merge_sealed(parts)
        return build_immutable(merged, sig_bits=self.sig_bits,
                               plane_budget_bytes=self.plane_budget)

    def finish_segments(self, *, keep_sources: bool = True
                        ) -> list[ImmutableSketch]:
        """Multi-segment finish: every temporary (plus the live content)
        becomes its OWN immutable sketch — no monolithic merge.  Queries
        fan out over the per-segment sketches and OR their per-token
        bitmaps (core.query_engine.QueryEngine); posting ids stay global,
        so the union of a token's per-segment posting sets equals the
        monolithic posting set.  ``keep_sources`` retains each segment's
        SealedContent on ``sealed_source`` so cold segments stay mergeable
        by the store-level compactor."""
        segs = []
        for p in self._all_parts():
            sk = build_immutable(p, sig_bits=self.sig_bits,
                                 plane_budget_bytes=self.plane_budget)
            if keep_sources:
                sk.sealed_source = p
            segs.append(sk)
        return segs

    def _all_parts(self) -> list[SealedContent]:
        """Seal any live content into the temporaries (not counted as a
        spill, no tier merge) and return them.  Idempotent: a second
        finish()/finish_segments() sees the identical parts instead of
        silently dropping content buffered since the last spill."""
        live = self._live_part()
        if live is not None:
            self.temporaries.append(live)
        return list(self.temporaries)


def sealed_postings(content: SealedContent, fp: int) -> np.ndarray | None:
    """Exact postings of token fingerprint ``fp`` in one sealed part, or
    ``None`` when the token is absent.  ``content.fps`` is sorted unique
    (mutable-sketch seal and ``build_sealed`` both guarantee it), so this
    is a binary search — the reader-side probe of sealed-but-unfinished
    temporaries needs no sketch and has no false positives."""
    fps = np.asarray(content.fps)
    i = int(np.searchsorted(fps, np.uint32(fp)))
    if i >= len(fps) or int(fps[i]) != int(fp):
        return None
    return np.asarray(content.lists[int(content.list_ids[i])], np.int64)


def sealed_arrays(content: SealedContent) -> dict[str, np.ndarray]:
    """Flatten a SealedContent into named flat arrays for the segment-file
    serializer: the variable-length posting lists become one int64 column
    plus (L+1,) offsets.  Inverse of :func:`sealed_from_arrays`."""
    lens = np.asarray([len(l) for l in content.lists], np.int64)
    flat = (np.concatenate([np.asarray(l, np.int64) for l in content.lists])
            if lens.sum() else np.empty(0, np.int64))
    offsets = np.concatenate([np.zeros(1, np.int64), np.cumsum(lens)])
    return {
        "fps": np.asarray(content.fps, np.uint32),
        "list_ids": np.asarray(content.list_ids, np.int64),
        "lists_flat": flat,
        "list_offsets": offsets,
        "refcounts": np.asarray(content.refcounts, np.int64),
    }


def sealed_from_arrays(arrs: dict, *, n_postings: int,
                       stats: dict | None = None) -> SealedContent:
    """Rebuild a SealedContent from :func:`sealed_arrays` output.  The
    posting lists are VIEWS into ``lists_flat`` — when that column is an
    ``np.memmap`` the lists stay disk-resident and page in lazily, so the
    cold-segment compactor merges straight from disk."""
    offsets = np.asarray(arrs["list_offsets"], np.int64)
    flat = arrs["lists_flat"]
    lists = [flat[offsets[i]:offsets[i + 1]] for i in range(len(offsets) - 1)]
    return SealedContent(fps=arrs["fps"], list_ids=arrs["list_ids"],
                         lists=lists, refcounts=arrs["refcounts"],
                         n_postings=int(n_postings), stats=dict(stats or {}))


def merge_sealed(parts: list[SealedContent]) -> SealedContent:
    """Union of (fingerprint, posting) pairs across temporary segments,
    re-deduplicated — semantically the paper's merge-into-one-mutable-sketch.

    Fully vectorized: instead of materializing one (fp, postings) chunk
    pair per token (the old per-token ``np.full`` loop dominated
    ``finish()`` for online-mode ingest), each part expands through
    ``np.repeat`` over its per-token list lengths plus one flat gather."""
    if not parts:
        return SealedContent(fps=np.empty(0, np.uint32),
                             list_ids=np.empty(0, np.int64), lists=[],
                             refcounts=np.empty(0, np.int64), n_postings=0)
    fp_chunks, post_chunks = [], []
    stats: dict = {}
    for part in parts:
        if len(part.fps):
            list_lens = np.asarray([len(l) for l in part.lists], np.int64)
            flat = (np.concatenate([np.asarray(l, np.int64)
                                    for l in part.lists])
                    if list_lens.sum() else np.empty(0, np.int64))
            offsets = np.concatenate([[0], np.cumsum(list_lens)])
            tok_lens = list_lens[part.list_ids]
            total = int(tok_lens.sum())
            # flat indices: for token t, offsets[list_ids[t]] + [0..len)
            ends = np.cumsum(tok_lens)
            local = np.arange(total, dtype=np.int64) \
                - np.repeat(ends - tok_lens, tok_lens)
            gather = np.repeat(offsets[part.list_ids], tok_lens) + local
            fp_chunks.append(np.repeat(part.fps, tok_lens))
            post_chunks.append(flat[gather])
        for k, v in part.stats.items():
            if isinstance(v, (int, float)):
                stats[k] = stats.get(k, 0) + v
    if not fp_chunks:
        return SealedContent(fps=np.empty(0, np.uint32),
                             list_ids=np.empty(0, np.int64), lists=[],
                             refcounts=np.empty(0, np.int64), n_postings=0,
                             stats=stats)
    return build_sealed(np.concatenate(fp_chunks),
                        np.concatenate(post_chunks), stats)
