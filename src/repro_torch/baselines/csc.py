"""Circular Shift and Coalesce (CSC) membership sketch — Li et al.,
SIGMOD'21 (the paper's [19]); the sketch baseline in §2.2/§5.

For each of ``k`` hash functions, a token's anchor position
``h(t) mod m`` is shifted by the partition ``g(S) = S mod p`` of each set
it belongs to, and that bit is set.  A query gathers the ``p`` bits after
each anchor, ANDs the partition masks across the k anchors (and across
``j`` independent repetitions), then expands surviving partitions to the
union of sets they contain.  ``m`` is a power of two so the modulo is a
mask, exactly as in the paper's evaluation setup (§5.1.3).

Build and the numpy probe run on the host; the device probe is the CUDA
``csc_probe`` kernel over :meth:`CSCSketch.device_arrays`, with
:meth:`CSCSketch.partition_mask_torch` as its plain version.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..core.hashing import U32, np_seeded_hash32, torch_seeded_hash32
from ..device import canonical_device

_HASH_SEED = 0xC5C0FFEE


def _seed(rep: int, k: int) -> int:
    return (_HASH_SEED + 0x9E3779B9 * (rep * 131 + k)) & 0xFFFFFFFF


@dataclass
class CSCSketch:
    bits: np.ndarray        # (j, m/32) uint32 — one bit plane per repetition
    m: int                  # power-of-two bit-vector size
    k: int                  # hash functions per repetition
    p: int                  # partitions
    j: int                  # repetitions
    n_sets: int
    upload_count: int = field(default=0, repr=False, compare=False)
    _device_memo: tuple | None = field(default=None, repr=False,
                                       compare=False)

    def size_bits(self) -> int:
        return self.bits.size * 32

    # ------------------------------------------------------------------ build
    @classmethod
    def build(cls, *, m_bits: int, k: int = 4, p: int = 64, j: int = 1,
              n_sets: int = 0) -> "CSCSketch":
        m = 1 << int(np.ceil(np.log2(max(m_bits, 64))))
        return cls(bits=np.zeros((j, m >> 5), dtype=np.uint32),
                   m=m, k=k, p=p, j=j, n_sets=n_sets)

    def insert_batch(self, fps: np.ndarray, set_ids: np.ndarray) -> None:
        """Vectorized insert of parallel (token fingerprint, set id) pairs."""
        fps = np.asarray(fps, dtype=np.uint32)
        set_ids = np.asarray(set_ids, dtype=np.int64)
        self.n_sets = max(self.n_sets, int(set_ids.max(initial=-1)) + 1)
        g = (set_ids % self.p).astype(np.int64)
        mask = np.uint32(self.m - 1)
        for rep in range(self.j):
            for hk in range(self.k):
                anchor = np_seeded_hash32(fps, _seed(rep, hk)) & mask
                pos = (anchor.astype(np.int64) + g) & (self.m - 1)
                np.bitwise_or.at(self.bits[rep], pos >> 5,
                                 np.uint32(1) << (pos & 31).astype(np.uint32))

    # ------------------------------------------------------------------ query
    def partition_mask(self, fps: np.ndarray) -> np.ndarray:
        """(Q, p) bool — surviving partitions per query token (AND across
        k anchors and j repetitions)."""
        fps = np.asarray(fps, dtype=np.uint32)
        mask = np.uint32(self.m - 1)
        out = np.ones((fps.size, self.p), dtype=bool)
        for rep in range(self.j):
            for hk in range(self.k):
                anchor = np_seeded_hash32(fps, _seed(rep, hk)) & mask
                pos = (anchor[:, None].astype(np.int64)
                       + np.arange(self.p)[None, :]) & (self.m - 1)
                bit = (self.bits[rep][pos >> 5]
                       >> (pos & 31).astype(np.uint32)) & 1
                out &= bit.astype(bool)
        return out

    def sets_of(self, partitions: np.ndarray) -> np.ndarray:
        """Set ids whose partition survived in a (p,) bool mask."""
        sets = np.arange(self.n_sets, dtype=np.int64)
        return sets[partitions[sets % self.p]]

    def query(self, fp: int) -> np.ndarray:
        """Membership set M_t: all set ids whose partition survived."""
        return self.sets_of(
            self.partition_mask(np.asarray([fp], np.uint32))[0])

    def query_all_tokens(self, fps: np.ndarray) -> np.ndarray:
        """AND-combined membership across tokens (n-gram intersection mode
        used in §5.2 to lower CSC's error rate)."""
        if len(fps) == 0:
            return np.empty(0, np.int64)
        return self.sets_of(
            self.partition_mask(np.asarray(fps, np.uint32)).all(axis=0))

    # ------------------------------------------------------------------ device
    def device_arrays(self, device) -> dict:
        """The probe's device buffers, uploaded on first use per device and
        reused after: ``bits`` (j, m/32) and the (j * k,) anchor ``seeds``,
        both int32 tensors of the u32 bits.  ``upload_count`` counts the
        uploads."""
        device = canonical_device(device)
        memo = self._device_memo
        if memo is None or memo[0] != device:
            seeds = np.asarray([_seed(rep, hk) for rep in range(self.j)
                                for hk in range(self.k)], np.uint32)
            arrs = dict(
                bits=torch.from_numpy(np.ascontiguousarray(
                    self.bits, np.uint32).view(np.int32)).to(device),
                seeds=torch.from_numpy(seeds.view(np.int32)).to(device))
            memo = self._device_memo = (device, arrs)
            self.upload_count += 1
        return memo[1]

    def partition_mask_torch(self, fps: torch.Tensor, arrs: dict | None = None
                             ) -> torch.Tensor:
        """Plain PyTorch version of the ``csc_probe`` kernel: (Q,) u32
        fingerprints (int32 bits or int64 values) -> (Q, p) bool on their
        device."""
        if arrs is None:
            arrs = self.device_arrays(fps.device)
        offs = torch.arange(self.p, dtype=torch.int64, device=fps.device)
        out = torch.ones((fps.shape[0], self.p), dtype=torch.bool,
                         device=fps.device)
        for rep in range(self.j):
            for hk in range(self.k):
                anchor = torch_seeded_hash32(fps, _seed(rep, hk)) & (self.m - 1)
                pos = (anchor[:, None] + offs[None, :]) & (self.m - 1)
                words = arrs["bits"][rep][pos >> 5].to(torch.int64) & U32
                bit = (words >> (pos & 31)) & 1
                out &= bit.to(torch.bool)
        return out
