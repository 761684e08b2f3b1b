"""Binary Interpolative Coding of posting lists (§4.2, paper's [28]).

Encodes a sorted list of distinct posting ids within a known universe
[0, n_postings).  The middle element is written with
``ceil(log2(range_size))`` bits (its feasible range shrinks by the number
of elements that must fit on each side), then both halves recurse.  Exact,
bit-aligned, <1 bit/posting on clustered lists.

BIC decode is branchy, sequential bit IO — deliberately kept host-side
(see DESIGN.md §3): the paper itself argues decode cost is masked by the
per-posting batch decompression it triggers.
"""
from __future__ import annotations

import numpy as np

from .bitio import BitReader, BitWriter


def _bits_for(range_size: int) -> int:
    """ceil(log2(range_size)) bits; 0 bits when the value is forced."""
    if range_size <= 1:
        return 0
    return int(range_size - 1).bit_length()


def bic_encode(postings: np.ndarray, lo: int, hi: int, writer: BitWriter) -> None:
    """Encode sorted distinct ``postings`` all within [lo, hi] (inclusive)."""
    stack = [(0, len(postings), lo, hi)]
    p = np.asarray(postings, dtype=np.int64)
    while stack:
        start, end, lo_, hi_ = stack.pop()
        n = end - start
        if n == 0:
            continue
        mid = start + (n >> 1)
        v = int(p[mid])
        left = mid - start          # elements that must fit in [lo_, v-1]
        right = end - mid - 1       # elements that must fit in [v+1, hi_]
        vmin = lo_ + left
        vmax = hi_ - right
        writer.write(v - vmin, _bits_for(vmax - vmin + 1))
        # push right first so left is processed first (LIFO)
        stack.append((mid + 1, end, v + 1, hi_))
        stack.append((start, mid, lo_, v - 1))


def bic_decode(count: int, lo: int, hi: int, reader: BitReader) -> np.ndarray:
    """Decode ``count`` postings from the stream; mirrors bic_encode."""
    out = np.empty(count, dtype=np.int64)
    stack = [(0, count, lo, hi)]
    while stack:
        start, end, lo_, hi_ = stack.pop()
        n = end - start
        if n == 0:
            continue
        mid = start + (n >> 1)
        left = mid - start
        right = end - mid - 1
        vmin = lo_ + left
        vmax = hi_ - right
        v = vmin + reader.read(_bits_for(vmax - vmin + 1))
        out[mid] = v
        stack.append((mid + 1, end, v + 1, hi_))
        stack.append((start, mid, lo_, v - 1))
    return out


def encode_lists(lists, n_postings: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Encode many lists into one bit stream.

    Returns (bitseq u32, bit_offsets int64 (L+1,), counts int64 (L,)).
    The offset table is the paper's rank->disk-offset map (§3.3) — tiny
    because lists are deduplicated.
    """
    w = BitWriter()
    offsets = [0]
    counts = []
    hi = max(n_postings - 1, 0)
    for lst in lists:
        lst = np.asarray(lst, dtype=np.int64)
        bic_encode(lst, 0, hi, w)
        offsets.append(w.bitpos)
        counts.append(len(lst))
    return (w.array(), np.asarray(offsets, dtype=np.int64),
            np.asarray(counts, dtype=np.int64))


def decode_list(bitseq: np.ndarray, bit_offsets: np.ndarray,
                counts: np.ndarray, rank: int, n_postings: int) -> np.ndarray:
    r = BitReader(bitseq, int(bit_offsets[rank]))
    return bic_decode(int(counts[rank]), 0, max(n_postings - 1, 0), r)
