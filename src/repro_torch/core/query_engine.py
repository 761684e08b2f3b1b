"""Batched device query engine — the store-facing read path.

The paper's Algorithm 3 is a sequential host loop; the engine evaluates
*waves* of queries on the device — one probe per segment plus one fold and
one extraction per wave:

  * **Per-segment device cache** — every segment's flat sketch buffers
    (:meth:`ImmutableSketch.device_cache`) are uploaded once and reused by
    all later waves; queries stream only fingerprints.
  * **Wave fingerprinting** — every byte token of a wave is hashed by one
    launch of the CUDA ``token_hash`` kernel (``wave_fingerprints``).
  * **Shape-bucketed batching** — Q queries x T token fingerprints are
    packed into padded (Q_bucket, T_bucket) arrays (powers of two).  Each
    segment's probe (MPHF, signature, CSF rank, plane-row OR) is one launch
    of the CUDA ``sketch_probe`` kernel's fused entry, and the T-axis
    boolean fold one of the CUDA ``bitset_ops`` kernel.
  * **Multi-segment fan-out** — per-spill immutable segments stay
    queryable (no monolithic merge): each segment contributes per-token
    posting bitmaps, OR-ed across segments before the AND/OR fold.  A
    token's posting set is the union of its per-segment sets, so the
    fan-out result is bit-identical to the merged-sketch result.
  * **Host fallback** — segments built without bitmap planes (plane
    budget exceeded) are probed on the host, with an LRU cache of decoded
    BIC posting lists, and their bitmaps OR-ed into the wave.
  * **Device candidate extraction** — the combined hit bitmaps compact
    into posting-id lists on the device (CUDA ``bitmap_extract`` kernel),
    so only a (Q, max_hits) id tensor crosses to the host.

On a CPU device every kernel wrapper takes its plain PyTorch version.
Semantics match the host Alg. 3 loop exactly: an absent token zeroes its
bitmap (AND -> empty), an empty query returns empty.
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.bitmap_extract.ops import bitmap_extract
from ..kernels.bitset_ops.ops import bitset_reduce_batch
from .batch_builder import wave_fingerprints
from .hashing import token_fingerprint

_MIN_Q_BUCKET = 8
_MIN_T_BUCKET = 1
_MIN_HITS_BUCKET = 8


def _bucket(n: int, lo: int) -> int:
    """Next power of two >= max(n, lo)."""
    return 1 << (max(n, lo) - 1).bit_length()


def _as_fp(tok) -> int:
    if isinstance(tok, (bytes, bytearray)):
        return token_fingerprint(tok)
    return int(tok)


class QueryEngine:
    """Evaluates query waves against one or more immutable segments."""

    def __init__(self, segments, *, n_postings: int | None = None,
                 lru_lists: int = 4096, device=None):
        self.segments = [s for s in segments if s.n_tokens > 0]
        self.device = resolve_device(device)
        if n_postings is None:
            n_postings = max((s.n_postings for s in self.segments),
                             default=0)
        self.n_postings = int(n_postings)
        self.words = (max(self.n_postings, 1) + 31) // 32
        self._plane_segs = [(si, s) for si, s in enumerate(self.segments)
                            if s.planes is not None]
        self._host_segs = [(si, s) for si, s in enumerate(self.segments)
                           if s.planes is None]
        self._lru: OrderedDict[tuple, np.ndarray] = OrderedDict()
        self._lru_cap = lru_lists
        self.upload_count = 0       # segment device-cache uploads

    # ------------------------------------------------------------- public
    def query(self, tokens, *, op: str = "and") -> np.ndarray:
        """Single query: posting ids (sorted int64) matching Alg. 3.

        A lone query runs the scalar host probe (microseconds, reusing the
        engine's LRU of decoded BIC lists) rather than paying a device
        wave's dispatch latency; batches go through :meth:`query_batch`."""
        return self.host_query(tokens, op=op)

    def query_batch(self, token_lists, *, op: str = "and"
                    ) -> list[np.ndarray]:
        """A wave of queries; ``token_lists[i]`` is query i's tokens (byte
        tokens, hashed by one ``token_hash`` launch, or integer
        fingerprints)."""
        return self._wave(*wave_fingerprints(token_lists, device=self.device),
                          op)

    def query_fps_batch(self, fps_lists, *, op: str = "and"
                        ) -> list[np.ndarray]:
        """Core wave evaluation over integer fingerprints."""
        lens = np.fromiter((len(fps) for fps in fps_lists), dtype=np.int64,
                           count=len(fps_lists))
        flat = np.fromiter((fp for fps in fps_lists for fp in fps),
                           dtype=np.uint64, count=int(lens.sum()))
        return self._wave(flat.astype(np.uint32), lens, op)

    def _wave(self, flat: np.ndarray, lens: np.ndarray, op: str
              ) -> list[np.ndarray]:
        if op not in ("and", "or"):
            raise ValueError(f"op={op!r}")
        n_queries = len(lens)
        # empty queries resolve to empty immediately (Alg. 3 semantics)
        results: list = [np.empty(0, np.int64)] * n_queries
        live = np.flatnonzero(lens)
        if not live.size or not self.segments or self.n_postings == 0:
            return [np.empty(0, np.int64) for _ in range(n_queries)]

        fps_pad, mask = self._pack(flat, lens[live])
        bitmaps, counts = self._evaluate(fps_pad, mask, op)
        postings = self._extract(bitmaps, counts[:live.size])
        for out, i in zip(postings, live):
            results[int(i)] = out
        return results

    # ------------------------------------------------------------ packing
    def _pack(self, flat: np.ndarray, lens: np.ndarray):
        """The live queries' fingerprints (``flat``, query after query,
        ``lens`` each) -> padded (Qb, Tb) fingerprints and mask."""
        tb = _bucket(int(lens.max()), _MIN_T_BUCKET)
        qb = _bucket(lens.size, _MIN_Q_BUCKET)
        fps = np.zeros((qb, tb), dtype=np.uint32)
        mask = np.zeros((qb, tb), dtype=bool)
        rows = np.repeat(np.arange(lens.size), lens)
        cols = np.arange(flat.size) - np.repeat(np.cumsum(lens) - lens, lens)
        fps[rows, cols] = flat
        mask[rows, cols] = True
        return fps, mask

    # --------------------------------------------------------- evaluation
    def _evaluate(self, fps: np.ndarray, mask: np.ndarray, op: str):
        """(Qb, Tb) wave -> ((Qb, W) device int32 bitmaps, (Qb,) counts).

        Per-token plane accumulation over the plane-backed segments, an OR
        of any host-fallback contribution, then one fold over the T axis.
        The combined bitmaps STAY on the device for the extraction stage;
        only the per-query counts come back here."""
        fps_dev = torch.from_numpy(fps.view(np.int32)).to(self.device)
        acc = self._device_token_planes(fps_dev)
        for si, seg in self._host_segs:
            acc |= torch.from_numpy(
                self._host_token_planes(si, seg, fps, mask).view(np.int32)
            ).to(self.device)
        # masked pad slots take the fold's neutral word
        neutral = -1 if op == "and" else 0
        mask_dev = torch.from_numpy(mask).to(self.device)
        planes = torch.where(mask_dev[:, :, None], acc, neutral)
        combined, counts = bitset_reduce_batch(planes, op=op)
        return combined, counts.cpu().numpy()

    def _device_token_planes(self, fps_dev: torch.Tensor) -> torch.Tensor:
        """(Qb, Tb) device fps -> (Qb, Tb, W) int32 token planes OR-ed over
        the plane-backed segments, one launch of the fused probe per
        segment.  Each segment's rows are cut or zero-padded to the
        engine-global width W."""
        qb, tb = fps_dev.shape
        acc = torch.zeros((qb * tb, self.words), dtype=torch.int32,
                          device=self.device)
        flat = fps_dev.reshape(-1)
        for _, seg in self._plane_segs:
            seg.match_bitmap_torch(flat, self._seg_arrs(seg), out=acc)
        return acc.view(qb, tb, self.words)

    def _seg_arrs(self, seg):
        if not seg.has_device_cache(self.device):
            self.upload_count += 1
        return seg.device_cache(self.device)

    # ------------------------------------------------------ host fallback
    def _host_token_planes(self, si: int, seg, fps: np.ndarray,
                           mask: np.ndarray) -> np.ndarray:
        """Host-side (Qb, Tb, W) bitmaps for a plane-less segment, with an
        LRU of decoded BIC posting lists shared across waves."""
        qb, tb = fps.shape
        rows = np.zeros((qb, tb, self.words), dtype=np.uint32)
        flat_fps, inverse = np.unique(fps[mask], return_inverse=True)
        if flat_fps.size == 0:
            return rows
        present, rank = seg.probe_fingerprints_np(flat_fps)
        fp_rows = np.zeros((flat_fps.size, self.words), dtype=np.uint32)
        for j in np.flatnonzero(present):
            postings = self._cached_postings(si, seg, int(rank[j]))
            np.bitwise_or.at(fp_rows[j], postings >> 5,
                             np.uint32(1) << (postings & 31)
                             .astype(np.uint32))
        # scatter only the real (masked) slots, via the unique-inverse map
        q_idx, t_idx = np.nonzero(mask)
        rows[q_idx, t_idx] = fp_rows[inverse]
        return rows

    def _cached_postings(self, si: int, seg, rank: int) -> np.ndarray:
        key = (si, rank)
        hit = self._lru.get(key)
        if hit is not None:
            self._lru.move_to_end(key)
            return hit
        postings = seg.postings_for_rank(rank)
        self._lru[key] = postings
        if len(self._lru) > self._lru_cap:
            self._lru.popitem(last=False)
        return postings

    # --------------------------------------------------------- extraction
    def _extract(self, bitmaps: torch.Tensor, counts: np.ndarray
                 ) -> list[np.ndarray]:
        """Bitmap -> posting-id compaction for a whole wave on the device;
        one (Qb, max_hits) id tensor crosses to the host.  ``counts`` covers
        only the live rows, and ``max_hits`` is sized from them: pad rows
        (all-ones under AND) are compacted too, and the kernel drops their
        hits past ``max_hits``."""
        n = len(counts)
        out: list[np.ndarray] = [np.empty(0, np.int64)] * n
        nz = np.flatnonzero(counts > 0)
        if nz.size == 0:
            return out
        max_hits = _bucket(int(counts.max()), _MIN_HITS_BUCKET)
        ids, _ = bitmap_extract(bitmaps, max_hits=max_hits)
        ids = ids.cpu().numpy()
        for i in nz:
            out[int(i)] = ids[int(i), :int(counts[int(i)])].astype(np.int64)
        return out

    # ------------------------------------------------------------ replicas
    def clone(self) -> "QueryEngine":
        """A replica over the same segments: shares every per-segment
        device cache but owns its LRU."""
        return QueryEngine(self.segments, n_postings=self.n_postings,
                           lru_lists=self._lru_cap, device=self.device)

    # ------------------------------------------------------------- sizing
    def device_bytes(self) -> int:
        """Bytes of the segments' buffers staged on the device."""
        return sum(s.device_bytes() for s in self.segments)

    def index_bytes(self, **kw) -> int:
        """Bytes of the segments' sketches, as ``ImmutableSketch.size_bytes``
        counts them (``kw`` goes to it)."""
        return sum(s.size_bytes(**kw) for s in self.segments)

    # ----------------------------------------------------- host scalar path
    def host_query(self, tokens, *, op: str = "and") -> np.ndarray:
        """Scalar host path with identical fan-out semantics (per-token
        union across segments, then AND/OR): the single-query fast path
        and the oracle for the device waves.  Decoded BIC posting lists go
        through the engine's LRU."""
        fps = [_as_fp(t) for t in tokens]
        if not fps:
            return np.empty(0, np.int64)
        per_token = []
        for fp in fps:
            parts = []
            for si, seg in enumerate(self.segments):
                pres, rk = seg.probe_fp_scalar(fp)
                if pres:
                    parts.append(self._cached_postings(si, seg, int(rk)))
            per_token.append(
                np.unique(np.concatenate(parts)) if parts
                else np.empty(0, np.int64))
        acc = per_token[0]
        for p in per_token[1:]:
            acc = (np.intersect1d(acc, p, assume_unique=True)
                   if op == "and" else np.union1d(acc, p))
        return acc.astype(np.int64)
