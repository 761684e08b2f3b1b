"""BBHash-style minimal perfect hash function (§3.3/§4.2, paper's [20]).

Construction (host, numpy): a cascade of bit-vector levels of size
``gamma * |unresolved|``.  At each level every unresolved key hashes to one
position; positions hit exactly once become set bits (those keys are
resolved), collided keys fall through to the next level.  Keys left after
``max_levels`` go to a tiny sorted fallback array.

The minimal hash of a key resolved at level L with bit position p is
``rank(bits, level_offset[L] + p)`` — the number of set bits before it in
the concatenated level bit-vectors; fallback keys get the tail indices.

Query (device): the CUDA ``sketch_probe`` kernel, or :func:`lookup_torch`
(its plain version) — a handful of gathers + popcounts over a flat u32 word
array with a sampled rank directory, no deserialization.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .hashing import (as_u32, np_seeded_hash32, torch_popcount32,
                      torch_seeded_hash32)

GAMMA_DEFAULT = 2.0
MAX_LEVELS_DEFAULT = 12
RANK_BLOCK_WORDS = 8  # one rank sample per 8 u32 words (256 bits)
_LEVEL_SEED = 0x5EED1E5


def _level_seed(level: int) -> int:
    return (_LEVEL_SEED * (level + 1)) & 0xFFFFFFFF


def u32_tensor(a: np.ndarray, device) -> torch.Tensor:
    """A u32 numpy array on ``device`` as an int32 tensor of the same bits.
    A read-only array (a segment file's ``np.memmap``) is copied first: a
    CPU tensor must not alias the mapping's read-only pages."""
    a = np.ascontiguousarray(a, dtype=np.uint32)
    if not a.flags.writeable:
        a = a.copy()
    return torch.from_numpy(a.view(np.int32)).to(device)


@dataclass
class MPHF:
    """Flat-buffer MPHF; all arrays are plain numpy."""
    words: np.ndarray            # (W,) uint32 concatenated level bit-vectors
    level_word_offset: np.ndarray  # (L+1,) int32 word offset of each level
    level_bits: np.ndarray       # (L,) int32 m_l — bit-vector size per level
    block_rank: np.ndarray       # (ceil(W/8),) uint32 popcount before block
    fallback_fps: np.ndarray     # (F,) uint32 sorted fingerprints
    fallback_idx: np.ndarray     # (F,) int64 minimal-hash values
    n_keys: int
    n_rank_bits: int             # set bits across levels (= n_keys - F)

    @property
    def n_levels(self) -> int:
        return len(self.level_bits)

    def size_bits(self) -> int:
        return (self.words.size * 32 + self.block_rank.size * 32
                + self.fallback_fps.size * 96
                + self.level_word_offset.size * 32 + self.level_bits.size * 32)

    # ---- numpy batch query ---------------------------------------------------
    def lookup_np(self, fps: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Returns (idx int64, definitely_absent bool).  For keys in the
        construction set, idx is their unique minimal hash.  For other keys
        idx is arbitrary unless definitely_absent is True."""
        fps = np.asarray(fps, dtype=np.uint32)
        idx = np.zeros(fps.shape, dtype=np.int64)
        found = np.zeros(fps.shape, dtype=bool)
        for lvl in range(self.n_levels):
            m = int(self.level_bits[lvl])
            if m == 0:
                continue
            pos = np_seeded_hash32(fps, _level_seed(lvl)) % np.uint32(m)
            gbit = pos.astype(np.int64) + (int(self.level_word_offset[lvl]) << 5)
            word = gbit >> 5
            hit = (self.words[word] >> (gbit & 31).astype(np.uint32)) & 1
            hit = hit.astype(bool) & ~found
            if hit.any():
                idx[hit] = self._rank_np(gbit[hit])
                found |= hit
        # fallback
        if self.fallback_fps.size:
            fpos = np.searchsorted(self.fallback_fps, fps)
            fpos = np.minimum(fpos, self.fallback_fps.size - 1)
            fhit = (self.fallback_fps[fpos] == fps) & ~found
            idx[fhit] = self.fallback_idx[fpos[fhit]]
            found |= fhit
        return idx, ~found

    # ---- scalar query (single-token fast path) -----------------------------
    def lookup_scalar(self, fp: int) -> tuple[int, bool]:
        """Pure-python-int probe: avoids per-call numpy dispatch for a
        single key (the lone-query path)."""
        from .hashing import scalar_seeded_hash32
        words = self.words
        for lvl in range(self.n_levels):
            m = int(self.level_bits[lvl])
            if m == 0:
                continue
            pos = scalar_seeded_hash32(fp, _level_seed(lvl)) % m
            gbit = pos + (int(self.level_word_offset[lvl]) << 5)
            w = gbit >> 5
            if (int(words[w]) >> (gbit & 31)) & 1:
                block = w >> 3
                r = int(self.block_rank[block])
                for j in range(block << 3, w):
                    r += int(words[j]).bit_count()
                r += (int(words[w]) & ((1 << (gbit & 31)) - 1)).bit_count()
                return r, False
        if self.fallback_fps.size:
            p = int(np.searchsorted(self.fallback_fps, np.uint32(fp)))
            if p < self.fallback_fps.size \
                    and int(self.fallback_fps[p]) == fp:
                return int(self.fallback_idx[p]), False
        return 0, True

    def _rank_np(self, gbit: np.ndarray) -> np.ndarray:
        """Rank of a set bit: sampled block rank + popcounts of the residual
        words — one (N, 8) gather + popcount for the words before the
        target, one masked popcount for the partial word."""
        gbit = np.asarray(gbit, dtype=np.int64)
        word = gbit >> 5
        block = word >> 3
        base = block << 3
        cols = base[:, None] + np.arange(RANK_BLOCK_WORDS, dtype=np.int64)
        pc = _popcount32_np(self.words[np.minimum(cols, self.words.size - 1)])
        before = cols < word[:, None]
        part = _popcount32_np(
            self.words[word]
            & ((np.uint32(1) << (gbit & 31).astype(np.uint32)) - np.uint32(1)))
        return (self.block_rank[block].astype(np.int64)
                + (pc * before).sum(axis=1) + part)

    # ---- device query ----------------------------------------------------------
    def device_arrays(self, device) -> dict:
        """The probe's buffers on ``device``.  u32 arrays travel as int32
        tensors of the same bits (the kernel reads them as ``uint32_t``).
        The fallback pad is 0xFFFFFFFF, so a padded fallback array stays
        sorted as u32; ``fb_count`` bounds the real entries.  ``levels``
        repeats the level table as host ints for the plain version, which
        then never waits on the device to read it."""
        return dict(
            words=u32_tensor(self.words, device),
            block_rank=u32_tensor(self.block_rank, device),
            level_word_offset=torch.from_numpy(
                self.level_word_offset.astype(np.int32)).to(device),
            level_bits=torch.from_numpy(
                self.level_bits.astype(np.int32)).to(device),
            fallback_fps=u32_tensor(
                self.fallback_fps if self.fallback_fps.size else
                np.full(1, 0xFFFFFFFF, np.uint32), device),
            fallback_idx=torch.from_numpy(
                (self.fallback_idx if self.fallback_idx.size else
                 np.zeros(1, np.int64)).astype(np.int32)).to(device),
            fb_count=int(self.fallback_fps.size),
            levels=tuple(zip((int(m) for m in self.level_bits),
                             (int(o) for o in self.level_word_offset))),
        )


def lookup_torch(fps: torch.Tensor, arrs: dict
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch MPHF probe over a :meth:`MPHF.device_arrays` dict:
    (idx int32, absent bool), the plain version of the ``sketch_probe``
    kernel.  Fallback keys resolve against the sorted ``fallback_fps``,
    guarded by ``fb_count``."""
    fps = as_u32(fps)
    words, block_rank = arrs["words"], arrs["block_rank"]
    idx = torch.zeros(fps.shape, dtype=torch.int64, device=fps.device)
    found = torch.zeros(fps.shape, dtype=torch.bool, device=fps.device)
    for lvl, (m, off) in enumerate(arrs["levels"]):
        if m == 0:
            continue
        pos = torch_seeded_hash32(fps, _level_seed(lvl)) % m
        gbit = pos + (off << 5)
        word = gbit >> 5
        hit = ((as_u32(words[word]) >> (gbit & 31)) & 1).bool() & ~found
        idx = torch.where(hit, _rank_torch(gbit, words, block_rank), idx)
        found = found | hit
    fb_fps = as_u32(arrs["fallback_fps"])
    fpos = torch.searchsorted(fb_fps, fps).clamp(0, fb_fps.numel() - 1)
    fhit = (fb_fps[fpos] == fps) & (fpos < arrs["fb_count"]) & ~found
    idx = torch.where(fhit, arrs["fallback_idx"][fpos].to(torch.int64), idx)
    return idx.to(torch.int32), ~(found | fhit)


def _rank_torch(gbit: torch.Tensor, words: torch.Tensor,
                block_rank: torch.Tensor) -> torch.Tensor:
    """Vectorized rank of bit ``gbit`` (int64) in the int32-viewed words."""
    word = gbit >> 5
    block = word >> 3
    cols = (block << 3)[:, None] + torch.arange(
        RANK_BLOCK_WORDS, device=gbit.device)
    pc = torch_popcount32(words[cols.clamp(max=words.numel() - 1)])
    before = cols < word[:, None]
    part = torch_popcount32(as_u32(words[word]) & ((1 << (gbit & 31)) - 1))
    return (as_u32(block_rank[block]) + (pc * before).sum(dim=1) + part)


def _popcount32_np(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint32, copy=True)
    x = x - ((x >> np.uint32(1)) & np.uint32(0x55555555))
    x = (x & np.uint32(0x33333333)) + ((x >> np.uint32(2)) & np.uint32(0x33333333))
    x = (x + (x >> np.uint32(4))) & np.uint32(0x0F0F0F0F)
    return ((x * np.uint32(0x01010101)) >> np.uint32(24)).astype(np.int64)


def build_mphf(keys: np.ndarray, *, gamma: float = GAMMA_DEFAULT,
               max_levels: int = MAX_LEVELS_DEFAULT) -> MPHF:
    keys = np.unique(np.asarray(keys, dtype=np.uint32))
    unresolved = keys
    level_words: list[np.ndarray] = []
    level_bits: list[int] = []
    assigned_key_order: list[np.ndarray] = []  # keys resolved per level
    assigned_pos: list[np.ndarray] = []
    for lvl in range(max_levels):
        if unresolved.size == 0:
            break
        m = int(np.ceil(gamma * unresolved.size))
        m = max(256, ((m + 255) // 256) * 256)  # word+block aligned
        pos = np_seeded_hash32(unresolved, _level_seed(lvl)) % np.uint32(m)
        counts = np.bincount(pos, minlength=m)
        once = counts == 1
        hit = once[pos]
        words = np.zeros(m >> 5, dtype=np.uint32)
        set_pos = pos[hit].astype(np.int64)
        np.bitwise_or.at(words, set_pos >> 5,
                         (np.uint32(1) << (set_pos & 31).astype(np.uint32)))
        level_words.append(words)
        level_bits.append(m)
        assigned_key_order.append(unresolved[hit])
        assigned_pos.append(set_pos)
        unresolved = unresolved[~hit]

    words = (np.concatenate(level_words) if level_words
             else np.zeros(8, dtype=np.uint32))
    # pad to a whole rank block
    pad = (-len(words)) % RANK_BLOCK_WORDS
    if pad:
        words = np.concatenate([words, np.zeros(pad, np.uint32)])
    level_word_offset = np.zeros(len(level_bits) + 1, dtype=np.int32)
    for i, m in enumerate(level_bits):
        level_word_offset[i + 1] = level_word_offset[i] + (m >> 5)

    pop = _popcount32_np(words)
    cum = np.concatenate([[0], np.cumsum(pop)]).astype(np.uint32)
    block_rank = cum[:-1][::RANK_BLOCK_WORDS].copy()
    n_rank_bits = int(cum[-1])

    fallback_order = np.argsort(unresolved, kind="stable")
    fallback_fps = unresolved[fallback_order]
    fallback_idx = (n_rank_bits + np.arange(unresolved.size)).astype(np.int64)
    # indices must follow sorted-fp order for reproducibility
    fallback_idx = fallback_idx  # already aligned with sorted order

    return MPHF(words=words,
                level_word_offset=level_word_offset,
                level_bits=np.asarray(level_bits, dtype=np.int32),
                block_rank=block_rank,
                fallback_fps=fallback_fps,
                fallback_idx=fallback_idx,
                n_keys=int(keys.size),
                n_rank_bits=n_rank_bits)
