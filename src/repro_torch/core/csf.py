"""Compressed static function: minimal-hash -> posting-list rank (§3.3).

Posting lists are ranked by reference count (rank 0 = most referenced).
The rank of entry ``i`` is encoded with ``floor(log2(max(rank,1))) + 1``
bits — *not* uniquely decodable on its own; decodability comes from storing
every entry's bit length in a packed 5-bit array plus a sampled absolute
prefix-sum directory, exactly as the paper describes.

Query path: one sampled-offset gather + a <=SAMPLE-length 5-bit prefix sum
+ a two-word bit-field gather.  Fully vectorized in numpy and torch.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .bitio import BitWriter, np_peek_bits
from .hashing import U32, as_u32

SAMPLE = 32          # prefix-sum sampling interval (configurable, §3.3)
LEN_BITS = 5         # rank < 2^30 -> code length <= 31 -> 5-bit lengths


def code_length(rank: np.ndarray) -> np.ndarray:
    """floor(log2(max(rank,1))) + 1 bits per value."""
    r = np.maximum(np.asarray(rank, dtype=np.int64), 1)
    return np.floor(np.log2(r)).astype(np.int64) + 1


@dataclass
class CompressedStaticFunction:
    bitseq: np.ndarray       # (W,) uint32 concatenated variable-length codes
    lengths: np.ndarray      # (ceil(N*5/32),) uint32 packed 5-bit lengths
    samples: np.ndarray      # (ceil(N/SAMPLE),) int64 absolute bit offsets
    n: int

    def size_bits(self) -> int:
        return 32 * (self.bitseq.size + self.lengths.size) + 64 * self.samples.size

    # ---- host/vectorized decode ------------------------------------------------
    def get_np(self, idx: np.ndarray) -> np.ndarray:
        idx = np.asarray(idx, dtype=np.int64)
        block = idx // SAMPLE
        base = block * SAMPLE
        off = self.samples[block].copy()
        lens_all = np.empty((idx.size, SAMPLE), dtype=np.int64)
        for j in range(SAMPLE):
            lens_all[:, j] = self._len_np(np.minimum(base + j, self.n - 1))
        rel = idx - base
        for j in range(SAMPLE):
            off += np.where(j < rel, lens_all[:, j], 0)
        nbits = lens_all[np.arange(idx.size), rel]
        return np_peek_bits(self.bitseq, off, nbits).astype(np.int64)

    def get_scalar(self, idx: int) -> int:
        """Single-entry decode with python ints (query fast path)."""
        from .bitio import peek_bits
        block = idx // SAMPLE
        base = block * SAMPLE
        off = int(self.samples[block])
        for j in range(base, idx):
            off += peek_bits(self.lengths, min(j, self.n - 1) * LEN_BITS,
                             LEN_BITS)
        nbits = peek_bits(self.lengths, idx * LEN_BITS, LEN_BITS)
        return peek_bits(self.bitseq, off, nbits)

    def _len_np(self, idx: np.ndarray) -> np.ndarray:
        bit = idx * LEN_BITS
        return np_peek_bits(self.lengths, bit,
                            np.full(idx.shape, LEN_BITS, np.int64)).astype(np.int64)

    # ---- device decode -----------------------------------------------------------
    def device_arrays(self, device) -> dict:
        """Decode buffers on ``device``; ``n1`` (= n - 1) rides along as the
        clip bound of :func:`csf_get_torch`."""
        from .mphf import u32_tensor
        return dict(bitseq=u32_tensor(self.bitseq, device),
                    lengths=u32_tensor(self.lengths, device),
                    samples=torch.from_numpy(
                        self.samples.astype(np.int64)).to(device),
                    n1=max(self.n - 1, 0))


def csf_get_torch(idx: torch.Tensor, arrs: dict) -> torch.Tensor:
    """Decode ``idx`` against a :meth:`CompressedStaticFunction.device_arrays`
    dict (int64 result).  The SAMPLE-long 5-bit length prefix sum is one
    (N, SAMPLE) gather instead of SAMPLE sequential steps."""
    idx = idx.to(torch.int64)
    block = idx // SAMPLE
    base = block * SAMPLE
    rel = idx - base
    j = torch.arange(SAMPLE, device=idx.device)
    pos = torch.clamp(base[:, None] + j, max=arrs["n1"]) * LEN_BITS
    lens = _peek(arrs["lengths"], pos, LEN_BITS)               # (N, SAMPLE)
    off = arrs["samples"][block] + (lens * (j < rel[:, None])).sum(dim=1)
    nbits = lens.gather(1, rel[:, None])[:, 0]
    return _peek(arrs["bitseq"], off, nbits)


def _peek(words: torch.Tensor, bitpos: torch.Tensor, nbits) -> torch.Tensor:
    """Bit-field gather of ``nbits`` (an int or a tensor, <= 32) at int64
    ``bitpos`` from int32-viewed u32 words; shifts stay in int64, so the
    off == 0 and nbits == 32 edges need no special case."""
    word = bitpos >> 5
    off = bitpos & 31
    w0 = as_u32(words[word])
    w1 = as_u32(words[torch.clamp(word + 1, max=words.numel() - 1)])
    # bit 31 of w1 would land at bit 63 and past U32 after any shift
    v = ((w0 | ((w1 & 0x7FFFFFFF) << 32)) >> off) & U32
    return v & ((1 << nbits) - 1)


def build_csf(values: np.ndarray) -> CompressedStaticFunction:
    """Encode ``values[i]`` (the rank for minimal hash i)."""
    values = np.asarray(values, dtype=np.int64)
    n = values.size
    lens = code_length(values)
    # code bit-sequence
    w = BitWriter()
    samples = []
    for i in range(n):
        if i % SAMPLE == 0:
            samples.append(w.bitpos)
        w.write(int(values[i]), int(lens[i]))
    bitseq = w.array()
    # packed 5-bit lengths
    lw = BitWriter()
    for i in range(n):
        lw.write(int(lens[i]), LEN_BITS)
    return CompressedStaticFunction(
        bitseq=bitseq, lengths=lw.array(),
        samples=np.asarray(samples if samples else [0], dtype=np.int64), n=n)
