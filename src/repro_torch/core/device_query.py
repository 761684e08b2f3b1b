"""Device-side batched query evaluation over one immutable sketch.

The paper's Alg. 3 is a sequential host loop; the same semantics evaluate
as dense bitmap algebra on the device: Q queries x T tokens probe the
sketch (the ``sketch_probe`` kernel + signature check + CSF rank) -> each
token resolves to its posting-plane row -> AND/OR across the token axis
(the ``bitset_ops`` kernel) -> per-query candidate bitmaps + popcounts.
On CPU tensors every kernel wrapper takes its plain version.

Requires the immutable sketch to be built with bitmap planes
(``build_immutable(..., plane_budget_bytes=...)``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels.bitset_ops.ops import bitset_reduce_batch


def batched_match_bitmaps(sketch, fps: torch.Tensor, arrs: dict | None = None
                          ) -> torch.Tensor:
    """(Q, T) tensor of u32 fingerprints (int32 bits) -> (Q, T, W) int32
    posting bitmaps on its device (absent tokens give zero rows).  ``arrs``
    defaults to the sketch's device cache on that device."""
    if arrs is None:
        arrs = sketch.device_cache(fps.device)
    q, t = fps.shape
    return sketch.match_bitmap_torch(fps.reshape(-1), arrs).reshape(q, t, -1)


def batched_query(sketch, fps: torch.Tensor, *, op: str = "and",
                  arrs: dict | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Alg. 3 for a (Q, T) token batch on ``fps``'s device.

    Returns (bitmaps (Q, W) int32-viewed u32, counts (Q,) int32).
    ``op='and'``: batches containing every token of the query; ``'or'``:
    any token."""
    planes = batched_match_bitmaps(sketch, fps, arrs).contiguous()
    return bitset_reduce_batch(planes, op=op)


def bitmap_to_postings(bitmap_row: np.ndarray, n_postings: int) -> np.ndarray:
    """Host-side expansion of one (W,) uint32 bitmap into posting ids."""
    bits = np.unpackbits(
        np.asarray(bitmap_row, dtype=np.uint32).view(np.uint8),
        bitorder="little")
    return np.nonzero(bits[:n_postings])[0].astype(np.int64)
