"""Posting-list representations (§4.1).

Short lists (below ``short_list_threshold`` postings) are kept as sorted
arrays of u16 posting ids (binary-search insert); longer lists switch to a
dense bitset.  Both give O(1)-amortized inserts and a hard cap of 2^16
postings per sketch, as in the paper.
"""
from __future__ import annotations

import numpy as np

from .hashing import posting_element_hash

MAX_POSTINGS = 1 << 16


class PostingList:
    """A deduplicated set of posting ids with an incrementally-maintained
    commutative postings hash (Def. 3.1) and a token reference count."""

    __slots__ = ("_shorts", "_bitset", "postings_hash", "token_count",
                 "_count", "_threshold")

    def __init__(self, threshold: int = 16):
        self._shorts: list[int] = []
        self._bitset: np.ndarray | None = None
        self.postings_hash: int = 0
        self.token_count: int = 0
        self._count = 0
        self._threshold = threshold

    # -- queries ------------------------------------------------------------
    def __len__(self) -> int:
        return self._count

    def __contains__(self, p: int) -> bool:
        if self._bitset is not None:
            return bool((self._bitset[p >> 5] >> np.uint32(p & 31)) & np.uint32(1))
        import bisect
        i = bisect.bisect_left(self._shorts, p)
        return i < len(self._shorts) and self._shorts[i] == p

    def postings(self) -> np.ndarray:
        if self._bitset is not None:
            words = self._bitset
            out = []
            for w_idx in np.nonzero(words)[0]:
                w = int(words[w_idx])
                base = int(w_idx) << 5
                while w:
                    b = w & -w
                    out.append(base + b.bit_length() - 1)
                    w ^= b
            return np.asarray(out, dtype=np.int64)
        return np.asarray(self._shorts, dtype=np.int64)

    # -- updates ------------------------------------------------------------
    def add(self, p: int) -> bool:
        """Insert posting ``p``; returns False if already present (repeated
        inserts of the same posting must not modify the list, §3.2)."""
        if not 0 <= p < MAX_POSTINGS:
            raise ValueError(f"posting id {p} out of the 2^16 range (§4.1)")
        if p in self:
            return False
        if self._bitset is not None:
            self._bitset[p >> 5] |= np.uint32(1 << (p & 31))
        else:
            import bisect
            bisect.insort(self._shorts, p)
            if len(self._shorts) > self._threshold:
                self._to_bitset()
        self._count += 1
        self.postings_hash ^= posting_element_hash(p)
        return True

    def _to_bitset(self) -> None:
        bs = np.zeros(MAX_POSTINGS >> 5, dtype=np.uint32)
        for p in self._shorts:
            bs[p >> 5] |= np.uint32(1 << (p & 31))
        self._bitset = bs
        self._shorts = []

    def copy_with(self, p: int) -> "PostingList":
        """A copy of this list extended by ``p`` (used when a shared list is
        extended for only one of its referencing tokens)."""
        out = PostingList(self._threshold)
        out._shorts = list(self._shorts)
        out._bitset = None if self._bitset is None else self._bitset.copy()
        out.postings_hash = self.postings_hash
        out._count = self._count
        out.add(p)
        return out

    def equals_postings(self, other: "PostingList") -> bool:
        if self._count != other._count:
            return False
        return np.array_equal(self.postings(), other.postings())

    def memory_bytes(self) -> int:
        if self._bitset is not None:
            return self._bitset.nbytes + 16
        return 2 * len(self._shorts) + 16
