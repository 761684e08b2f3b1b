"""The immutable DynaWarp sketch (§3.3/§4.2): MPHF + signatures +
compressed static function + BIC posting lists, in a single flat buffer.

Build pipeline (host):
  SealedContent -> rank lists by reference count -> MPHF over fingerprints
  -> CSF(minimal hash -> rank) -> signature bits -> BIC bit stream.

Query pipeline:
  * host   : scalar / numpy probes (Alg. 3 inner loop)
  * device : one launch of the CUDA ``sketch_probe`` kernel's fused entry
             per segment and wave: MPHF probe, signature check, CSF rank
             and the OR of the optional dense bitmap planes (which carry
             boolean algebra across query tokens on the device) into the
             wave's accumulator.  Its plain version is the torch chain
             :func:`match_bitmap_plain`.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..device import canonical_device
from . import bic
from .bitio import np_peek_bits, pack_bitmap_planes, pack_fixed_width
from .csf import CompressedStaticFunction, _peek, build_csf, csf_get_torch
from .hashing import (np_seeded_hash32, scalar_seeded_hash32,
                      token_fingerprint, torch_seeded_hash32)
from .mphf import MPHF, build_mphf, lookup_torch, u32_tensor
from .mutable_sketch import SealedContent

SIG_SEED = 0x516E4715
DEFAULT_SIG_BITS = 8
DEFAULT_PLANE_BUDGET = 64 << 20  # bytes of optional device bitmap planes

# Process-global registries keyed by DURABLE segment id — the id is
# "<abs file path>@g<generation>", assigned by the manifest-based store:
# the device caches by (id, device), the sharded engine's shard slots by
# id.  RAM-only sketches memoize on the object as before; durable sketches
# share these registries so reopening a store in the same process
# re-uploads nothing it already staged and keeps every segment on its
# shard — the id, not Python object identity, names the uploaded buffers.
# Entries are dropped with the segment files (compaction orphan GC calls
# drop_device_cache / discard_durable_caches).
_DURABLE_DEVICE_CACHES: dict[tuple[str, torch.device], dict] = {}
_DURABLE_SHARD_SLOTS: dict[str, int] = {}


def discard_durable_caches(durable_id_or_path: str) -> None:
    """Free every registry entry of a durable segment id, on every device,
    and its shard slot — or, given a bare file path, of EVERY generation of
    that path (orphan GC deletes files; a later path reuse must never see
    stale buffers)."""
    prefix = durable_id_or_path + "@"

    def dead(durable_id: str) -> bool:
        return (durable_id == durable_id_or_path
                or durable_id.startswith(prefix))

    # list() copies the keys in one step: a wave on another thread may
    # stage a segment meanwhile
    for k in list(_DURABLE_DEVICE_CACHES):
        if dead(k[0]):
            _DURABLE_DEVICE_CACHES.pop(k, None)
    for k in list(_DURABLE_SHARD_SLOTS):
        if dead(k):
            _DURABLE_SHARD_SLOTS.pop(k, None)


@dataclass
class ImmutableSketch:
    mphf: MPHF
    csf: CompressedStaticFunction
    signatures: np.ndarray      # packed sig_bits-wide signatures by min-hash
    sig_bits: int
    bic_bits: np.ndarray        # u32 BIC stream of all deduplicated lists
    bic_offsets: np.ndarray     # (L+1,) int64 bit offsets (rank -> offset)
    bic_counts: np.ndarray      # (L,) int64 postings per list
    n_postings: int
    n_tokens: int
    planes: np.ndarray | None = None   # (L, ceil(P/32)) u32 device bitmaps
    stats: dict = field(default_factory=dict)
    # Retained SealedContent (full fingerprints + lists) when the segment
    # must stay mergeable by the cold-segment compactor; MPHFs alone are
    # not mergeable.  Excluded from size accounting (host-side scratch).
    sealed_source: SealedContent | None = None
    # Durable segment id ("<abs path>@g<gen>") once the manifest-based
    # store has published this segment to disk; keys the process-global
    # device-cache registry instead of object identity.
    durable_id: str | None = None

    # ------------------------------------------------------------------ sizes
    @property
    def n_lists(self) -> int:
        return len(self.bic_counts)

    def size_bits(self, *, include_planes: bool = False) -> int:
        total = (self.mphf.size_bits() + self.csf.size_bits()
                 + self.signatures.size * 32
                 + self.bic_bits.size * 32
                 + self.bic_offsets.size * 64 + self.bic_counts.size * 16)
        if include_planes and self.planes is not None:
            total += self.planes.size * 32
        return total

    def size_bytes(self, **kw) -> int:
        return (self.size_bits(**kw) + 7) // 8

    # ------------------------------------------------------------------ query
    def probe_fingerprints_np(self, fps: np.ndarray
                              ) -> tuple[np.ndarray, np.ndarray]:
        """Batched membership probe.  Returns (present bool, rank int64);
        rank is only meaningful where present."""
        fps = np.asarray(fps, dtype=np.uint32)
        idx, absent = self.mphf.lookup_np(fps)
        idx = np.clip(idx, 0, max(self.n_tokens - 1, 0))
        sig = self._sig_at_np(idx)
        want = np_seeded_hash32(fps, SIG_SEED) & np.uint32((1 << self.sig_bits) - 1)
        present = (~absent) & (sig == want) & (self.n_tokens > 0)
        rank = np.where(present, self.csf.get_np(idx), 0)
        return present, rank

    def probe_fp_scalar(self, fp: int) -> tuple[bool, int]:
        """Single-fingerprint probe on the python-int fast path (Alg. 3
        inner loop): MPHF -> signature -> CSF rank, with no per-call numpy
        dispatch."""
        from .bitio import peek_bits
        if self.n_tokens == 0:
            return False, 0
        idx, absent = self.mphf.lookup_scalar(fp)
        if absent:
            return False, 0
        idx = min(idx, self.n_tokens - 1)
        sig = peek_bits(self.signatures, idx * self.sig_bits, self.sig_bits)
        want = scalar_seeded_hash32(fp, SIG_SEED) & ((1 << self.sig_bits) - 1)
        if sig != want:
            return False, 0
        return True, self.csf.get_scalar(idx)

    def _sig_at_np(self, idx: np.ndarray) -> np.ndarray:
        bitpos = idx.astype(np.int64) * self.sig_bits
        return np_peek_bits(self.signatures, bitpos,
                            np.full(idx.shape, self.sig_bits, np.int64))

    def postings_for_rank(self, rank: int) -> np.ndarray:
        return bic.decode_list(self.bic_bits, self.bic_offsets,
                               self.bic_counts, int(rank), self.n_postings)

    def query_token(self, token: bytes) -> np.ndarray | None:
        """Host single-token query: None if definitely/probably absent."""
        fp = np.asarray([token_fingerprint(token)], dtype=np.uint32)
        present, rank = self.probe_fingerprints_np(fp)
        if not present[0]:
            return None
        return self.postings_for_rank(int(rank[0]))

    # ---------------------------------------------------------------- device
    def device_arrays(self, device) -> dict:
        """Every flat buffer of the device probe on ``device``, plus the
        python-int clip bounds the probe reads (``n_tokens1``, ``n_lists1``,
        ``csf_n1``, ``fb_count``)."""
        arrs = dict(self.mphf.device_arrays(device))
        arrs.update({f"csf_{k}": v
                     for k, v in self.csf.device_arrays(device).items()})
        arrs["signatures"] = u32_tensor(self.signatures, device)
        arrs["n_tokens1"] = max(self.n_tokens - 1, 0)
        if self.planes is not None:
            arrs["planes"] = u32_tensor(self.planes, device)
            arrs["n_lists1"] = max(self.n_lists - 1, 0)
        return arrs

    def device_cache(self, device) -> dict:
        """Memoized :meth:`device_arrays` — the per-segment device cache of
        the wave query engine.  The flat sketch buffers are uploaded on
        first use and reused by every later wave; asking for another device
        replaces the memo.  Durable segments (published by the
        manifest-based store) memoize in a process-global registry keyed by
        :attr:`durable_id` and the device, so a store reopened in the same
        process re-uploads nothing it already staged."""
        device = canonical_device(device)
        if self.durable_id is not None:
            key = (self.durable_id, device)
            arrs = _DURABLE_DEVICE_CACHES.get(key)
            if arrs is None:
                arrs = _DURABLE_DEVICE_CACHES[key] = \
                    self.device_arrays(device)
            return arrs
        memo = getattr(self, "_device_cache", None)
        if memo is None or memo[0] != device:
            memo = self._device_cache = (device, self.device_arrays(device))
        return memo[1]

    def has_device_cache(self, device) -> bool:
        """Whether this segment's flat buffers are staged on ``device`` (the
        engine's upload accounting — durable-id aware)."""
        device = canonical_device(device)
        if self.durable_id is not None:
            return (self.durable_id, device) in _DURABLE_DEVICE_CACHES
        memo = getattr(self, "_device_cache", None)
        return memo is not None and memo[0] == device

    def get_shard_slot(self) -> int | None:
        """Stable shard placement (durable-id aware): a segment keeps the
        slot it was first given so its uploaded buffers stay on its shard's
        device across engine rebuilds AND store reopens within one
        process."""
        if self.durable_id is not None:
            return _DURABLE_SHARD_SLOTS.get(self.durable_id)
        return getattr(self, "_shard_slot", None)

    def set_shard_slot(self, slot: int | None) -> None:
        """Place the segment on shard ``slot``; ``None`` forgets the
        placement, so the next sharded engine places it anew."""
        if self.durable_id is not None:
            if slot is None:
                _DURABLE_SHARD_SLOTS.pop(self.durable_id, None)
            else:
                _DURABLE_SHARD_SLOTS[self.durable_id] = int(slot)
        else:
            self._shard_slot = None if slot is None else int(slot)

    def drop_device_cache(self) -> None:
        """Free the memoized device arrays (segments merged away by
        compaction).  A durable segment also loses its registry identity:
        its file is about to be GC'd, and an in-flight wave still probing
        it (background compaction) must fall back to the per-object memo —
        re-inserting under the dead durable id would leak the upload for
        the rest of the process."""
        self._device_cache = None
        if self.durable_id is not None:
            discard_durable_caches(self.durable_id)
            self.durable_id = None

    def _staged(self) -> list[dict]:
        if self.durable_id is not None:
            return [a for (i, _), a in list(_DURABLE_DEVICE_CACHES.items())
                    if i == self.durable_id]
        memo = getattr(self, "_device_cache", None)
        return [] if memo is None else [memo[1]]

    def device_bytes(self) -> int:
        """Bytes of the staged device buffers (0 when nothing is staged)."""
        return sum(v.numel() * v.element_size() for arrs in self._staged()
                   for v in arrs.values() if isinstance(v, torch.Tensor))

    def match_bitmap_torch(self, fps: torch.Tensor, arrs: dict, *,
                           out: torch.Tensor | None = None) -> torch.Tensor:
        """(Q, W) posting bitmaps (int32-viewed u32) per query fingerprint;
        absent tokens yield all-zero rows.  With ``out``, the rows are OR-ed
        into it instead (see :func:`match_bitmap_from`).  Requires bitmap
        planes."""
        if self.planes is None:
            raise ValueError("bitmap planes were not built for this sketch")
        return match_bitmap_from(fps, arrs, sig_bits=self.sig_bits, out=out)


def _resolve_probe(fps, idx, absent, arrs, sig_bits: int):
    """Minimal-hash -> (present, rank): signature check + CSF decode.  Every
    bound comes from ``arrs``."""
    idx = torch.clamp(idx.to(torch.int64), 0, arrs["n_tokens1"])
    sig = _peek(arrs["signatures"], idx * sig_bits, sig_bits)
    want = torch_seeded_hash32(fps, SIG_SEED) & ((1 << sig_bits) - 1)
    present = ~absent & (sig == want)
    csf_arrs = {k[len("csf_"):]: v for k, v in arrs.items()
                if k.startswith("csf_")}
    rank = torch.where(present, csf_get_torch(idx, csf_arrs), 0)
    return present, rank


def probe_tokens_from(fps, arrs, *, sig_bits: int):
    """(present, rank) of each fingerprint: the ``sketch_probe`` kernel's
    probe entry (its plain version on CPU tensors) + signature check + CSF
    rank, over an :meth:`ImmutableSketch.device_arrays` dict, as the JAX
    package's function of the same name returns them.  ``fps`` holds u32
    fingerprints as int32 bits or as int64 values."""
    from ..kernels.sketch_probe.ops import mphf_probe_arrs
    idx, absent = mphf_probe_arrs(fps.to(torch.int32), arrs)
    return _resolve_probe(fps, idx, absent, arrs, sig_bits)


def match_bitmap_from(fps, arrs, *, sig_bits: int, out=None):
    """(Q, W) int32-viewed u32 posting bitmaps of the segment whose
    :meth:`ImmutableSketch.device_arrays` are ``arrs``; absent tokens (and
    all-zero padded rows) yield zero rows.  With ``out``, a (Q, W_out)
    int32 accumulator, each row is OR-ed into it instead, cut or
    zero-padded to W_out, and ``out`` is returned: the query engine's
    per-segment step.  One launch of the fused ``sketch_probe`` entry on
    CUDA tensors, :func:`match_bitmap_plain` on CPU tensors."""
    from ..kernels.sketch_probe.ops import match_planes
    if out is None:
        out = torch.zeros((fps.numel(), arrs["planes"].shape[1]),
                          dtype=torch.int32, device=fps.device)
    return match_planes(fps.to(torch.int32), arrs, out, sig_bits=sig_bits)


def match_bitmap_plain(fps, arrs, acc, *, sig_bits: int):
    """The fused entry's plain version, the torch chain: the MPHF probe's
    plain version, :func:`_resolve_probe`, the plane-row gather, and the OR
    into ``acc`` (rows cut or zero-padded to its width).  Returns ``acc``."""
    idx, absent = lookup_torch(fps, arrs)
    present, rank = _resolve_probe(fps, idx, absent, arrs, sig_bits)
    rows = arrs["planes"][torch.clamp(rank, 0, arrs["n_lists1"])]
    rows = torch.where(present[:, None], rows, 0)
    w = min(rows.shape[1], acc.shape[1])
    acc[:, :w] |= rows[:, :w]
    return acc


# ---------------------------------------------------------------------- build
def build_immutable(content: SealedContent, *,
                    sig_bits: int = DEFAULT_SIG_BITS,
                    plane_budget_bytes: int = DEFAULT_PLANE_BUDGET,
                    gamma: float = 2.0) -> ImmutableSketch:
    n_tokens = len(content.fps)
    n_lists = len(content.lists)
    # 1. rank lists by reference count, descending (§3.3)
    order = np.argsort(-content.refcounts, kind="stable")
    rank_of_list = np.empty(n_lists, dtype=np.int64)
    rank_of_list[order] = np.arange(n_lists)
    token_ranks = rank_of_list[content.list_ids] if n_tokens else \
        np.empty(0, np.int64)

    # 2. MPHF over fingerprints
    mphf = build_mphf(content.fps, gamma=gamma)
    if n_tokens:
        idx, absent = mphf.lookup_np(content.fps)
        assert not absent.any(), "MPHF must resolve every construction key"
        assert len(np.unique(idx)) == n_tokens, "MPHF must be injective"
    else:
        idx = np.empty(0, np.int64)

    # 3. CSF of ranks in minimal-hash order
    values_mh = np.zeros(max(n_tokens, 1), dtype=np.int64)
    values_mh[idx] = token_ranks
    csf = build_csf(values_mh[:n_tokens] if n_tokens else np.zeros(1, np.int64))

    # 4. signature bits in minimal-hash order
    sigs_tok = np_seeded_hash32(content.fps, SIG_SEED) \
        & np.uint32((1 << sig_bits) - 1)
    sigs_mh = np.zeros(max(n_tokens, 1), dtype=np.uint32)
    sigs_mh[idx] = sigs_tok
    signatures = pack_fixed_width(sigs_mh[:max(n_tokens, 1)], sig_bits)

    # 5. BIC-encode lists in rank order
    lists_by_rank = [content.lists[i] for i in order]
    bic_bits, bic_offsets, bic_counts = bic.encode_lists(
        lists_by_rank, content.n_postings)

    # 6. optional device bitmap planes (vectorized scatter over all lists)
    planes = None
    words = (max(content.n_postings, 1) + 31) // 32
    if n_lists and n_lists * words * 4 <= plane_budget_bytes:
        planes = pack_bitmap_planes(lists_by_rank, content.n_postings)

    stats = dict(content.stats)
    stats.update(n_tokens=n_tokens, n_lists=n_lists,
                 n_postings=content.n_postings,
                 dedup_ratio=(1.0 - n_lists / n_tokens) if n_tokens else 0.0)
    return ImmutableSketch(
        mphf=mphf, csf=csf, signatures=signatures, sig_bits=sig_bits,
        bic_bits=bic_bits, bic_offsets=bic_offsets, bic_counts=bic_counts,
        n_postings=content.n_postings, n_tokens=n_tokens, planes=planes,
        stats=stats)
