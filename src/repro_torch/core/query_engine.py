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
    boolean fold of the live queries, each over its own token count, one
    of the CUDA ``bitset_ops`` kernel's ragged entry.
  * **Multi-segment fan-out** — per-spill immutable segments stay
    queryable (no monolithic merge): each segment contributes per-token
    posting bitmaps, OR-ed across segments before the AND/OR fold.  A
    token's posting set is the union of its per-segment sets, so the
    fan-out result is bit-identical to the merged-sketch result.
  * **Host fallback** — segments built without bitmap planes (plane
    budget exceeded) are probed on the host, with an LRU cache of decoded
    BIC posting lists, and their bitmaps OR-ed into the wave.
  * **Device candidate extraction** — the fold writes only the live
    queries' bitmaps and counts; the counts cross to the host, their
    prefix sums go back up as row offsets, and the combined hit bitmaps
    compact on the device (CUDA ``bitmap_extract`` kernel's ragged entry)
    into one id array of exactly the wave's answer size, which crosses to
    the host once (into pinned memory) and is cut into the queries'
    arrays as views of one fresh int64 array.  With
    ``extract_on_device=False`` the probes and the fold still run on the
    device, but the folded (Q, W) bitmaps cross to the host and each
    non-empty row is decoded there (flatnonzero over its non-empty words,
    an LRU of decoded rows keyed by content): ``bitmap_extract`` is not
    launched.

On a CPU device every kernel wrapper takes its plain PyTorch version.
Threads may run waves on one engine at once: each copy to the host takes
its own pinned buffer from PyTorch's caching host allocator, and the LRU
takes a lock.  Semantics match the host Alg. 3 loop exactly: an absent
token zeroes its bitmap (AND -> empty), an empty query returns empty.
"""
from __future__ import annotations

import threading
from collections import OrderedDict

import numpy as np
import torch

from .. import trace
from ..device import resolve_device
from ..kernels.bitmap_extract.ops import bitmap_extract_ragged
from ..kernels.bitset_ops.ops import bitset_reduce_ragged
from .batch_builder import wave_fingerprints
from .hashing import token_fingerprint

_MIN_Q_BUCKET = 8
_MIN_T_BUCKET = 1


def _bucket(n: int, lo: int) -> int:
    """Next power of two >= max(n, lo)."""
    return 1 << (max(n, lo) - 1).bit_length()


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A 1-D int32 tensor as a host array.  From the card it is copied
    into a pinned buffer of its own, which lives as long as the array."""
    if t.device.type == "cpu":
        return t.numpy()
    out = torch.empty(t.numel(), dtype=t.dtype, pin_memory=True)
    out.copy_(t)
    return out.numpy()


def _as_fp(tok) -> int:
    if isinstance(tok, (bytes, bytearray)):
        return token_fingerprint(tok)
    return int(tok)


class QueryEngine:
    """Evaluates query waves against one or more immutable segments."""

    def __init__(self, segments, *, n_postings: int | None = None,
                 lru_lists: int = 4096, device=None,
                 extract_on_device: bool | None = None):
        self.segments = [s for s in segments if s.n_tokens > 0]
        self.device = resolve_device(device)
        # None or True: the device compaction; False: the host decode
        self._extract_on_device = (True if extract_on_device is None
                                   else bool(extract_on_device))
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
        self._lru_lock = threading.Lock()
        # host-extraction LRU of decoded bitmap rows (keyed by content),
        # alongside the BIC posting-list LRU above
        self._bm_lru: OrderedDict[bytes, np.ndarray] = OrderedDict()
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
        live = np.flatnonzero(lens)
        if not live.size or not self.segments or self.n_postings == 0:
            return [np.empty(0, np.int64) for _ in range(n_queries)]
        sp = trace.ON and trace.begin("engine.pack")
        fps = self._pack(flat, lens[live])
        if sp:
            trace.end(sp)
            sp = trace.begin("engine.planes")
        planes = self._planes(fps, lens[live])
        if sp:
            trace.end(sp)
            sp = trace.begin("engine.fold")
        bitmaps, counts = self._fold(*planes, op)
        if sp:
            trace.end(sp)
            sp = trace.begin("engine.extract")
        out = self._extract(bitmaps, counts, live, n_queries)
        if sp:
            trace.end(sp)
        return out

    # ------------------------------------------------------------ packing
    def _pack(self, flat: np.ndarray, lens: np.ndarray) -> np.ndarray:
        """The live queries' fingerprints (``flat``, query after query,
        ``lens`` each) -> padded (Qb, Tb) fingerprints, query i in row i."""
        tb = _bucket(int(lens.max()), _MIN_T_BUCKET)
        qb = _bucket(lens.size, _MIN_Q_BUCKET)
        fps = np.zeros((qb, tb), dtype=np.uint32)
        rows = np.repeat(np.arange(lens.size), lens)
        cols = np.arange(flat.size) - np.repeat(np.cumsum(lens) - lens, lens)
        fps[rows, cols] = flat
        return fps

    # --------------------------------------------------------- evaluation
    def _planes(self, fps: np.ndarray, lens: np.ndarray):
        """(Qb, Tb) wave and the live queries' token counts -> ((Qb, Tb, W)
        device int32 token planes, (Q,) device int32 counts).

        The fingerprints and counts go up in one copy; per-token plane
        accumulation over the plane-backed segments, then an OR of any
        host-fallback contribution.  Pad slots and pad rows are left as
        they are: the fold never reads them."""
        qb, tb = fps.shape
        staged = np.empty(qb * tb + lens.size, dtype=np.int32)
        staged[:qb * tb] = fps.reshape(-1).view(np.int32)
        staged[qb * tb:] = lens
        up = torch.from_numpy(staged).to(self.device)
        acc = self._device_token_planes(up[:qb * tb].view(qb, tb))
        if self._host_segs:
            mask = np.zeros((qb, tb), dtype=bool)
            mask[:lens.size] = np.arange(tb) < lens[:, None]
            for si, seg in self._host_segs:
                acc |= torch.from_numpy(
                    self._host_token_planes(si, seg, fps, mask)
                    .view(np.int32)).to(self.device)
        return acc, up[qb * tb:]

    @staticmethod
    def _fold(acc: torch.Tensor, lens: torch.Tensor, op: str):
        """One fold of each live row over its own tokens -> ((Q, W) device
        int32 bitmaps, (Q,) host int32 counts).  The bitmaps STAY on the
        device for the extraction; only the counts come back."""
        combined, counts = bitset_reduce_ragged(acc, lens, op=op)
        return combined, _to_host(counts)

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

    def _seg_arrs(self, seg, device=None):
        """The segment's buffers on ``device`` (the engine's by default),
        uploaded on first use and counted in ``upload_count``."""
        device = self.device if device is None else device
        if not seg.has_device_cache(device):
            self.upload_count += 1
        return seg.device_cache(device)

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
        with self._lru_lock:
            hit = self._lru.get(key)
            if hit is not None:
                self._lru.move_to_end(key)
                return hit
        postings = seg.postings_for_rank(rank)
        with self._lru_lock:
            self._lru[key] = postings
            if len(self._lru) > self._lru_cap:
                self._lru.popitem(last=False)
        return postings

    # --------------------------------------------------------- extraction
    def _extract(self, bitmaps: torch.Tensor, counts: np.ndarray,
                 live: np.ndarray, n_queries: int) -> list[np.ndarray]:
        """Bitmap -> posting-id compaction for a whole wave on the device.
        ``bitmaps`` and ``counts`` are the live queries' (query ``live[i]``
        in row i).  Their prefix sums place each row's ids in one array of
        exactly the wave's answer size, which crosses to the host once; each
        query's answer is a view of one fresh int64 copy of it.  In host
        mode the bitmaps cross instead and ``_decode_bitmap_host`` decodes
        each non-empty row."""
        if not self._extract_on_device:
            out = [np.empty(0, np.int64)] * n_queries
            nz = np.flatnonzero(counts > 0)
            if nz.size:
                q, w = bitmaps.shape
                rows = _to_host(bitmaps.reshape(-1)).view(np.uint32) \
                    .reshape(q, w)
                for i in nz.tolist():
                    out[int(live[i])] = self._decode_bitmap_host(rows[i])
            return out
        starts, ends, offsets = self._offsets(counts, live, n_queries)
        if offsets is None:
            return [np.empty(0, np.int64) for _ in range(n_queries)]
        flat = self._ids(bitmaps, offsets, int(ends[-1])).astype(np.int64)
        return [flat[a:b] for a, b in zip(starts.tolist(), ends.tolist())]

    def _offsets(self, counts: np.ndarray, live: np.ndarray, n_queries: int):
        """-> (starts, ends) of every query's answer in the wave's id array
        and the live rows' starts on the device (None when the wave has no
        answer)."""
        per_query = np.zeros(n_queries, dtype=np.int64)
        per_query[live] = counts
        ends = np.cumsum(per_query)
        starts = ends - per_query
        if ends[-1] == 0:
            return starts, ends, None
        return starts, ends, torch.from_numpy(
            starts[live].astype(np.int32)).to(self.device)

    @staticmethod
    def _ids(bitmaps: torch.Tensor, offsets: torch.Tensor, total: int
             ) -> np.ndarray:
        """The wave's (total,) int32 ids, compacted on the device and
        copied to the host once."""
        return _to_host(bitmap_extract_ragged(bitmaps, offsets, total))

    def _decode_bitmap_host(self, row: np.ndarray) -> np.ndarray:
        """Posting ids of one (W,) uint32 bitmap row, via flatnonzero over
        the non-empty words only (no full bit-matrix expansion), LRU-cached
        by row content so repeated needles skip the decode."""
        key = row.tobytes()
        with self._lru_lock:
            hit = self._bm_lru.get(key)
            if hit is not None:
                self._bm_lru.move_to_end(key)
                return hit
        w_idx = np.flatnonzero(row)
        if w_idx.size == 0:
            ids = np.empty(0, np.int64)
        else:
            sub, lane = np.nonzero(
                (row[w_idx][:, None] >> np.arange(32, dtype=np.uint32)) & 1)
            ids = (w_idx[sub].astype(np.int64) << 5) + lane
            ids = ids[ids < self.n_postings]
        with self._lru_lock:
            self._bm_lru[key] = ids
            if len(self._bm_lru) > self._lru_cap:
                self._bm_lru.popitem(last=False)
        return ids

    # ------------------------------------------------------------ replicas
    def clone(self) -> "QueryEngine":
        """A replica over the same segments: shares every per-segment
        device cache but owns its LRUs; keeps the extraction mode."""
        return QueryEngine(self.segments, n_postings=self.n_postings,
                           lru_lists=self._lru_cap, device=self.device,
                           extract_on_device=self._extract_on_device)

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
        sp = trace.ON and trace.begin("engine.host_query")
        fps = [_as_fp(t) for t in tokens]
        if not fps:
            if sp:
                trace.end(sp)
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
        if sp:
            trace.end(sp)
        return acc.astype(np.int64)
