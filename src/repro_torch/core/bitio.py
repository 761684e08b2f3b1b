"""Little-endian bit stream over uint32 words (shared by CSF and BIC).

Bit ``b`` of the stream lives in word ``b >> 5`` at in-word position
``b & 31``.  This layout lets the device read any <=32-bit code with two
word gathers and two shifts — the zero-deserialization property the paper
gets from mmap'd byte buffers (§4.2).
"""
from __future__ import annotations

import numpy as np


class BitWriter:
    def __init__(self):
        self.words: list[int] = []
        self.bitpos = 0

    def write(self, value: int, nbits: int) -> None:
        if nbits == 0:
            return
        if nbits < 0 or nbits > 32:
            raise ValueError(f"nbits={nbits} out of range")
        value &= (1 << nbits) - 1
        word = self.bitpos >> 5
        off = self.bitpos & 31
        while word >= len(self.words):
            self.words.append(0)
        self.words[word] |= (value << off) & 0xFFFFFFFF
        spill = off + nbits - 32
        if spill > 0:
            if word + 1 >= len(self.words):
                self.words.append(0)
            self.words[word + 1] |= value >> (nbits - spill)
        self.bitpos += nbits

    def array(self) -> np.ndarray:
        arr = np.asarray(self.words, dtype=np.uint64).astype(np.uint32)
        if arr.size == 0:
            arr = np.zeros(1, dtype=np.uint32)
        return arr


class BitReader:
    def __init__(self, words: np.ndarray, bitpos: int = 0):
        self.words = np.asarray(words, dtype=np.uint32)
        self.bitpos = bitpos

    def read(self, nbits: int) -> int:
        v = peek_bits(self.words, self.bitpos, nbits)
        self.bitpos += nbits
        return v


def peek_bits(words: np.ndarray, bitpos: int, nbits: int) -> int:
    """Read ``nbits`` (<=32) at absolute ``bitpos`` — host reference for the
    device-side two-gather read."""
    if nbits == 0:
        return 0
    word = bitpos >> 5
    off = bitpos & 31
    lo = int(words[word]) >> off
    if off + nbits > 32:
        lo |= int(words[word + 1]) << (32 - off)
    return lo & ((1 << nbits) - 1)


def pack_fixed_width(values: np.ndarray, nbits: int) -> np.ndarray:
    """Vectorized BitWriter for fixed-width codes: packs ``values[i]`` at
    bit position ``i * nbits``.  Bit-identical to writing each value with
    :class:`BitWriter` (little-endian u32 words)."""
    if not 0 < nbits <= 32:
        raise ValueError(f"nbits={nbits} out of range")
    values = np.asarray(values, dtype=np.uint64) \
        & np.uint64((1 << nbits) - 1)
    n = values.size
    total_bits = n * nbits
    n_words = max((total_bits + 31) // 32, 1)
    words = np.zeros(n_words + 1, dtype=np.uint32)  # +1: spill headroom
    bitpos = np.arange(n, dtype=np.int64) * nbits
    word = bitpos >> 5
    off = (bitpos & 31).astype(np.uint64)
    shifted = values << off                      # <= 63 bits used
    np.bitwise_or.at(words, word,
                     (shifted & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    np.bitwise_or.at(words, word + 1,
                     (shifted >> np.uint64(32)).astype(np.uint32))
    return words[:n_words]


def pack_bitmap_planes(lists, n_postings: int) -> np.ndarray:
    """Vectorized dense-bitmap builder: ``lists[r]`` (sorted int64 posting
    ids) becomes row ``r`` of an (L, ceil(P/32)) u32 plane matrix."""
    n_lists = len(lists)
    words = (max(n_postings, 1) + 31) // 32
    planes = np.zeros((n_lists, words), dtype=np.uint32)
    if n_lists == 0:
        return planes
    lengths = np.asarray([len(l) for l in lists], dtype=np.int64)
    if lengths.sum() == 0:
        return planes
    flat = np.concatenate([np.asarray(l, dtype=np.int64) for l in lists])
    row = np.repeat(np.arange(n_lists, dtype=np.int64), lengths)
    np.bitwise_or.at(planes.reshape(-1), row * words + (flat >> 5),
                     np.uint32(1) << (flat & 31).astype(np.uint32))
    return planes


def np_peek_bits(words: np.ndarray, bitpos: np.ndarray, nbits: np.ndarray
                 ) -> np.ndarray:
    """Vectorized bit-field gather: out[i] = bits[bitpos[i] : +nbits[i]]."""
    bitpos = bitpos.astype(np.int64)
    nbits = nbits.astype(np.int64)
    word = bitpos >> 5
    off = (bitpos & 31).astype(np.uint32)
    w0 = words[word].astype(np.uint64)
    w1 = words[np.minimum(word + 1, words.size - 1)].astype(np.uint64)
    combined = (w0 >> off) | np.where(off > 0, w1 << (np.uint32(32) - off),
                                      np.uint64(0))
    mask = (np.uint64(1) << nbits.astype(np.uint64)) - np.uint64(1)
    return (combined & mask).astype(np.uint32)
