"""Per-batch Bloom filter baseline (§2.2, the paper's [3]/[48] family).

One Bloom filter per set/batch; a query probes every filter — the paper's
point about linear growth in both storage access and query cost with the
number of sets.  Included as the third sketch baseline.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core.hashing import np_seeded_hash32

_SEED = 0xB100F


@dataclass
class BloomPerBatch:
    bits: np.ndarray     # (n_sets, m/32) uint32
    m: int
    k: int
    n_sets: int

    @classmethod
    def build(cls, n_sets: int, m_bits: int, k: int = 4) -> "BloomPerBatch":
        m = max(64, ((m_bits + 31) // 32) * 32)
        return cls(bits=np.zeros((n_sets, m >> 5), dtype=np.uint32),
                   m=m, k=k, n_sets=n_sets)

    def insert_batch(self, fps: np.ndarray, set_id: int) -> None:
        fps = np.asarray(fps, dtype=np.uint32)
        for hk in range(self.k):
            pos = (np_seeded_hash32(fps, _SEED + hk * 0x9E3779B9)
                   % np.uint32(self.m)).astype(np.int64)
            np.bitwise_or.at(self.bits[set_id], pos >> 5,
                             np.uint32(1) << (pos & 31).astype(np.uint32))

    def query(self, fp: int) -> np.ndarray:
        """Probe all n_sets filters (the linear cost the paper criticizes)."""
        hit = np.ones(self.n_sets, dtype=bool)
        for hk in range(self.k):
            pos = int(np_seeded_hash32(np.asarray([fp], np.uint32),
                                       _SEED + hk * 0x9E3779B9)[0]) % self.m
            hit &= ((self.bits[:, pos >> 5] >> np.uint32(pos & 31)) & 1
                    ).astype(bool)
        return np.nonzero(hit)[0].astype(np.int64)

    def query_all_tokens(self, fps) -> np.ndarray:
        hit = np.ones(self.n_sets, dtype=bool)
        for fp in fps:
            h = np.zeros(self.n_sets, dtype=bool)
            h[self.query(int(fp))] = True
            hit &= h
        return np.nonzero(hit)[0].astype(np.int64)

    def size_bits(self) -> int:
        return self.bits.size * 32
