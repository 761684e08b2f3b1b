"""Inverted index baseline (the Lucene analogue from §2.1/§5).

A lexicon of *full original tokens* (sorted, front-coded) + per-term
posting lists (delta + varint encoded).  Term queries are exact lexicon
lookups; ``contains`` queries linearly scan the lexicon for substring
matches and union the posting lists — precisely the capability/cost
trade-off the paper describes for Lucene: no false positives, large
storage (the full token bytes are kept), slow dictionary scans.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


def _varint_encode(arr: np.ndarray, out: bytearray) -> None:
    for v in arr:
        v = int(v)
        while v >= 0x80:
            out.append((v & 0x7F) | 0x80)
            v >>= 7
        out.append(v)


def _varint_decode(buf: memoryview, pos: int, count: int
                   ) -> tuple[np.ndarray, int]:
    out = np.empty(count, dtype=np.int64)
    for i in range(count):
        shift = 0
        v = 0
        while True:
            b = buf[pos]
            pos += 1
            v |= (b & 0x7F) << shift
            if b < 0x80:
                break
            shift += 7
        out[i] = v
    return out, pos


@dataclass
class InvertedIndex:
    # sealed representation
    lexicon: list[bytes] = field(default_factory=list)     # sorted tokens
    lex_blob: bytes = b""            # front-coded lexicon bytes (for sizing)
    postings_blob: bytes = b""       # delta+varint encoded lists
    offsets: np.ndarray | None = None  # (T+1,) int64 byte offsets
    counts: np.ndarray | None = None   # (T,) int64 postings per term
    n_postings: int = 0
    # build-time state
    _building: dict = field(default_factory=dict)

    # ------------------------------------------------------------------ build
    def add(self, token: bytes, posting: int) -> None:
        lst = self._building.get(token)
        if lst is None:
            self._building[token] = [posting]
        elif lst[-1] != posting:
            lst.append(posting)
        self.n_postings = max(self.n_postings, posting + 1)

    def add_line(self, tokens, posting: int) -> None:
        for t in tokens:
            self.add(t, posting)

    def seal(self) -> None:
        tokens = sorted(self._building)
        self.lexicon = tokens
        blob = bytearray()
        offsets = [0]
        counts = []
        for t in tokens:
            lst = np.unique(np.asarray(self._building[t], dtype=np.int64))
            deltas = np.empty_like(lst)
            deltas[0] = lst[0]
            deltas[1:] = np.diff(lst) - 1
            _varint_encode(deltas, blob)
            offsets.append(len(blob))
            counts.append(len(lst))
        self.postings_blob = bytes(blob)
        self.offsets = np.asarray(offsets, dtype=np.int64)
        self.counts = np.asarray(counts, dtype=np.int64)
        # front-code the lexicon: shared-prefix-len, suffix-len, suffix bytes
        lex = bytearray()
        prev = b""
        for t in tokens:
            common = 0
            for a, b in zip(prev, t):
                if a != b:
                    break
                common += 1
            suffix = t[common:]
            lex.append(min(common, 255))
            lex.append(min(len(suffix), 255))
            lex.extend(suffix)
            prev = t
        self.lex_blob = bytes(lex)
        self._building = {}

    # ------------------------------------------------------------------ query
    def _decode(self, ti: int) -> np.ndarray:
        deltas, _ = _varint_decode(memoryview(self.postings_blob),
                                   int(self.offsets[ti]), int(self.counts[ti]))
        out = np.cumsum(deltas + 1) - 1
        return out

    def lookup_term(self, token: bytes) -> np.ndarray:
        import bisect
        i = bisect.bisect_left(self.lexicon, token)
        if i < len(self.lexicon) and self.lexicon[i] == token:
            return self._decode(i)
        return np.empty(0, np.int64)

    def lookup_contains(self, needle: bytes) -> np.ndarray:
        """Lexicon scan: union of postings of every term containing the
        needle (Lucene's dictionary-scan contains mode, §5.2)."""
        parts = [self._decode(i) for i, t in enumerate(self.lexicon)
                 if needle in t]
        if not parts:
            return np.empty(0, np.int64)
        return np.unique(np.concatenate(parts))

    def size_bits(self) -> int:
        return 8 * (len(self.lex_blob) + len(self.postings_blob)
                    + self.offsets.nbytes + self.counts.nbytes)
