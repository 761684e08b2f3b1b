"""Plain PyTorch version of the bitmap_extract kernel (the function of the
JAX ``kernels/bitmap_extract/ref.py``): unpack every bit, give each set bit
its slot by a running count, scatter the slots below ``max_hits``."""
from __future__ import annotations

import torch

from ...core.hashing import as_u32


def bitmap_extract_ref(bitmaps: torch.Tensor, *, max_hits: int
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """(Q, W) int32-viewed u32 hit bitmaps -> ((Q, max_hits) int32 ids,
    (Q,) int32 counts).  Row i holds its set-bit positions in ascending
    order, -1-padded; bits past ``max_hits`` are dropped; counts are the
    full popcounts."""
    q, w = bitmaps.shape
    lanes = torch.arange(32, device=bitmaps.device)
    bits = ((as_u32(bitmaps)[:, :, None] >> lanes) & 1).reshape(q, w * 32)
    slot = torch.cumsum(bits, dim=1) - 1
    keep = (bits == 1) & (slot < max_hits)
    # dropped bits land in a spare column that is cut off afterwards
    col = torch.where(keep, slot, max_hits)
    pos = torch.arange(w * 32, device=bitmaps.device).expand(q, -1)
    ids = torch.full((q, max_hits + 1), -1, dtype=torch.int64,
                     device=bitmaps.device)
    ids.scatter_(1, col, torch.where(keep, pos, -1))
    return ids[:, :max_hits].to(torch.int32), bits.sum(dim=1).to(torch.int32)


def bitmap_extract_ragged_ref(bitmaps: torch.Tensor, offsets: torch.Tensor,
                              total: int) -> torch.Tensor:
    """(Q, W) hit bitmaps, (Q,) row offsets, total -> (total,) int32: every
    row's set-bit positions, ascending, the rows one after another (each
    row of ``bitmap_extract_ref`` cut at its count, concatenated).  Raises
    unless ``offsets`` are the exclusive prefix sums of the rows' counts
    and ``total`` their sum."""
    q, w = bitmaps.shape
    lanes = torch.arange(32, device=bitmaps.device)
    bits = ((as_u32(bitmaps)[:, :, None] >> lanes) & 1).reshape(q, w * 32)
    counts = bits.sum(dim=1)
    if (int(counts.sum()) != total or not torch.equal(
            offsets.to(torch.int64), torch.cumsum(counts, 0) - counts)):
        raise ValueError("offsets and total are not the rows' prefix sums")
    return torch.nonzero(bits)[:, 1].to(torch.int32)
