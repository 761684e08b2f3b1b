"""Wrapper of the bitmap_extract kernel: hit bitmaps -> posting ids."""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import build
from .ref import bitmap_extract_ref


@functools.cache
def _kernel():
    lib = build.library("bitmap_extract")
    p, i = ctypes.c_void_p, ctypes.c_int
    return lib, build.declare(lib, "bitmap_extract_launch",
                              p, i, i, i, p, p, p)


def bitmap_extract(bitmaps: torch.Tensor, *, max_hits: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """(Q, W) int32-viewed u32 hit bitmaps -> ((Q, max_hits) int32,
    (Q,) int32).  Row i holds its bitmap's set-bit positions (ascending),
    -1-padded; hits past ``max_hits`` are dropped and never written;
    counts are the full popcounts.  A CUDA tensor launches the kernel; a
    CPU tensor takes the plain version."""
    if (bitmaps.dim() != 2 or bitmaps.dtype != torch.int32
            or not bitmaps.is_contiguous()):
        raise ValueError("bitmaps must be a contiguous 2-D int32 tensor")
    if max_hits < 0:
        raise ValueError(f"max_hits={max_hits}")
    if bitmaps.device.type == "cpu":
        return bitmap_extract_ref(bitmaps, max_hits=max_hits)
    if bitmaps.device.type != "cuda":
        raise ValueError(f"bitmap_extract runs on cuda or cpu, not "
                         f"{bitmaps.device}")
    q, w = bitmaps.shape
    ids = torch.empty((q, max_hits), dtype=torch.int32, device=bitmaps.device)
    counts = torch.empty(q, dtype=torch.int32, device=bitmaps.device)
    if q:
        lib, fn = _kernel()
        with torch.cuda.device(bitmaps.device):
            err = fn(bitmaps.data_ptr(), q, w, max_hits, ids.data_ptr(),
                     counts.data_ptr(), build.stream_of(bitmaps))
        build.check(lib, err, "bitmap_extract")
        bitmap_extract.launch_count += 1
    return ids, counts


bitmap_extract.launch_count = 0
