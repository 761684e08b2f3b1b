"""Hash primitives shared by the mutable/immutable sketches and the kernels.

Every hash here exists in three synchronized forms:
  * scalar python  (reference / host builders)
  * vectorized numpy (batch builders, oracles)
  * torch          (device query path; the CUDA kernels mirror these ops)

torch has no unsigned 32-bit shifts, comparisons or ``%``, so the torch
forms carry u32 values in int64 tensors masked with ``& 0xFFFFFFFF``.

The paper (§3.2, Def. 3.1/3.2) requires
  - a token fingerprint hash (4-byte fingerprints in the token map),
  - a per-posting element hash implemented as one LCG step
    (Steele & Vigna multipliers), combined with XOR into the commutative
    *postings hash* used for online posting-list deduplication.
"""
from __future__ import annotations

import numpy as np
import torch

# --- constants -------------------------------------------------------------
U32 = 0xFFFFFFFF
U64 = 0xFFFFFFFFFFFFFFFF

# polynomial rolling-hash multiplier (golden-ratio odd constant)
POLY_M32 = 0x9E3779B1
POLY_SEED = 0x811C9DC5  # FNV offset basis, reused as seed

# 64-bit LCG from Steele & Vigna, "Computationally easy, spectrally good
# multipliers for congruential pseudorandom number generators" (paper's [44]).
LCG_A = 0xD1342543DE82EF95
LCG_C = 0x2545F4914F6CDD1D

# murmur3 fmix32 constants
_FM32_1 = 0x85EBCA6B
_FM32_2 = 0xC2B2AE35
# splitmix64 fmix constants
_FM64_1 = 0xBF58476D1CE4E5B9
_FM64_2 = 0x94D049BB133111EB


# --- scalar (python int) ----------------------------------------------------
def fmix32(h: int) -> int:
    h &= U32
    h ^= h >> 16
    h = (h * _FM32_1) & U32
    h ^= h >> 13
    h = (h * _FM32_2) & U32
    h ^= h >> 16
    return h


def fmix64(h: int) -> int:
    h &= U64
    h ^= h >> 30
    h = (h * _FM64_1) & U64
    h ^= h >> 27
    h = (h * _FM64_2) & U64
    h ^= h >> 31
    return h


def lcg_step(x: int) -> int:
    """One LCG step (Def. 3.2): x_1 = (a * x_0 + c) mod 2^64."""
    return (LCG_A * (x & U64) + LCG_C) & U64


def posting_element_hash(p: int) -> int:
    """hash_element(p) — Def. 3.1 uses one LCG step seeded with the posting."""
    return lcg_step(p)


def postings_hash(postings) -> int:
    """Commutative XOR-combined hash of a set of postings (Def. 3.1)."""
    h = 0
    for p in postings:
        h ^= posting_element_hash(int(p))
    return h


def token_fingerprint(token: bytes, *, seed: int = POLY_SEED) -> int:
    """4-byte token fingerprint (token map key, §4.1)."""
    h = seed & U32
    for b in token:
        h = ((h * POLY_M32) & U32) ^ b
    return fmix32(h ^ (len(token) & U32))


# --- numpy vectorized -------------------------------------------------------
def np_fmix32(h: np.ndarray) -> np.ndarray:
    h = h.astype(np.uint32, copy=True)
    h ^= h >> np.uint32(16)
    h *= np.uint32(_FM32_1)
    h ^= h >> np.uint32(13)
    h *= np.uint32(_FM32_2)
    h ^= h >> np.uint32(16)
    return h


def np_fmix64(h: np.ndarray) -> np.ndarray:
    h = h.astype(np.uint64, copy=True)
    h ^= h >> np.uint64(30)
    h *= np.uint64(_FM64_1)
    h ^= h >> np.uint64(27)
    h *= np.uint64(_FM64_2)
    h ^= h >> np.uint64(31)
    return h


def np_posting_element_hash(p: np.ndarray) -> np.ndarray:
    p = p.astype(np.uint64)
    return np.uint64(LCG_A) * p + np.uint64(LCG_C)


def np_token_fingerprints(tokens_u8: np.ndarray, lengths: np.ndarray,
                          *, seed: int = POLY_SEED) -> np.ndarray:
    """Vectorized fingerprints for a packed (N, L) uint8 token matrix.

    Bytes past ``lengths[i]`` must be zero-padded; they are masked out by
    freezing the rolling state once the position index reaches the length.
    """
    n, max_len = tokens_u8.shape
    h = np.full((n,), seed, dtype=np.uint32)
    lengths = lengths.astype(np.int32)
    for j in range(max_len):
        active = j < lengths
        nh = (h * np.uint32(POLY_M32)) ^ tokens_u8[:, j].astype(np.uint32)
        h = np.where(active, nh, h)
    return np_fmix32(h ^ lengths.astype(np.uint32))


def np_window_fingerprints(mat: np.ndarray, lengths: np.ndarray, n: int,
                           *, seed: int = POLY_SEED
                           ) -> tuple[np.ndarray, np.ndarray]:
    """Fingerprints of every length-``n`` byte window of each row of a
    packed (N, L) u8 token matrix — the vectorized n-gram hasher of the
    columnar ingest path.  A window starting at column j of row i is valid
    when ``j + n <= lengths[i]``; returns (row_idx, fps) over the valid
    windows, bit-identical to ``token_fingerprint`` of each window's bytes.
    """
    N, L = mat.shape
    W = L - n + 1
    if N == 0 or W <= 0:
        return np.empty(0, np.int64), np.empty(0, np.uint32)
    h = np.full((N, W), seed, dtype=np.uint32)
    for k in range(n):
        h = (h * np.uint32(POLY_M32)) ^ mat[:, k:k + W].astype(np.uint32)
    fps = np_fmix32(h ^ np.uint32(n))
    valid = (np.arange(W, dtype=np.int64)[None, :] + n
             <= lengths.astype(np.int64)[:, None])
    rows = np.nonzero(valid)[0]
    return rows, fps[valid]


# --- torch ------------------------------------------------------------------
def as_u32(x: torch.Tensor) -> torch.Tensor:
    """u32 values of ``x`` (an int32 bit view or an int64 tensor) as int64."""
    return x.to(torch.int64) & U32


def mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """``(h * c) mod 2^32`` for int64-carried u32 ``h``: the constant is split
    into 16-bit halves so no partial product leaves int64's range."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & U32


def torch_posting_element_hash(p: torch.Tensor
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The 64-bit LCG step of u32 postings as int64-carried u32 (hi, lo)
    halves: ``(hi << 32) | lo == (LCG_A * p + LCG_C) mod 2^64``.  The low
    word of ``LCG_A`` multiplies the two 16-bit halves of ``p`` apart, so
    no partial product leaves int64's range; the high word needs only its
    product mod 2^32 (:func:`mul32`)."""
    p = as_u32(p)
    a_lo = LCG_A & U32
    low = a_lo * (p & 0xFFFF)                 # < 2^48
    mid = a_lo * (p >> 16)                    # < 2^48, weight 2^16
    low = low + ((mid & 0xFFFF) << 16)        # < 2^49
    carry = (low >> 32) + (mid >> 16)
    hi = (mul32(p, LCG_A >> 32) + carry) & U32
    lo = (low & U32) + (LCG_C & U32)
    hi = (hi + (LCG_C >> 32) + (lo >> 32)) & U32
    return hi, lo & U32


def torch_popcount32(x: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of int64-carried u32 values (torch has no popcount)."""
    x = as_u32(x)
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & U32) >> 24


def torch_fmix32(h: torch.Tensor) -> torch.Tensor:
    h = as_u32(h)
    h = h ^ (h >> 16)
    h = mul32(h, _FM32_1)
    h = h ^ (h >> 13)
    h = mul32(h, _FM32_2)
    return h ^ (h >> 16)


def torch_seeded_hash32(fp: torch.Tensor, seed: int) -> torch.Tensor:
    """Per-level / per-purpose derived 32-bit hash of a fingerprint."""
    return torch_fmix32(as_u32(fp) ^ (seed & U32))


def as_i32(h: torch.Tensor) -> torch.Tensor:
    """int64-carried u32 values as an int32 tensor of the same bits."""
    h = as_u32(h)
    return (h - ((h >> 31) << 32)).to(torch.int32)


def torch_token_fingerprints(tokens_u8: torch.Tensor, lengths: torch.Tensor,
                             *, seed: int = POLY_SEED) -> torch.Tensor:
    """torch mirror of :func:`np_token_fingerprints` over a packed (N, L)
    u8 token matrix: (N,) int64-carried u32 fingerprints.  A column steps
    the rolling state only while its index is below the row's length, so
    a length past L hashes the L bytes but still mixes in the length."""
    n, max_len = tokens_u8.shape
    lengths = lengths.to(torch.int64)
    h = torch.full((n,), seed & U32, dtype=torch.int64,
                   device=tokens_u8.device)
    for j in range(max_len):
        nh = mul32(h, POLY_M32) ^ tokens_u8[:, j].to(torch.int64)
        h = torch.where(j < lengths, nh, h)
    return torch_fmix32(h ^ as_u32(lengths))


def np_seeded_hash32(fp: np.ndarray, seed: int) -> np.ndarray:
    return np_fmix32(fp.astype(np.uint32) ^ np.uint32(seed & U32))


def scalar_seeded_hash32(fp: int, seed: int) -> int:
    return fmix32((fp ^ seed) & U32)
