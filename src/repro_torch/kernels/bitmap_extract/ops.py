"""Wrappers of the bitmap_extract kernel: hit bitmaps -> posting ids, as a
padded (Q, max_hits) matrix or as one compacted array."""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import build
from .ref import bitmap_extract_ragged_ref, bitmap_extract_ref


@functools.cache
def _kernel():
    lib = build.library("bitmap_extract")
    p, i = ctypes.c_void_p, ctypes.c_int
    return (lib,
            build.declare(lib, "bitmap_extract_launch", p, i, i, i, p, p, p),
            build.declare(lib, "bitmap_extract_ragged_launch",
                          p, i, i, p, i, p, p))


def _check(bitmaps: torch.Tensor) -> None:
    if (bitmaps.dim() != 2 or bitmaps.dtype != torch.int32
            or not bitmaps.is_contiguous()):
        raise ValueError("bitmaps must be a contiguous 2-D int32 tensor")
    if bitmaps.device.type not in ("cpu", "cuda"):
        raise ValueError(f"bitmap_extract runs on cuda or cpu, not "
                         f"{bitmaps.device}")


def bitmap_extract(bitmaps: torch.Tensor, *, max_hits: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """(Q, W) int32-viewed u32 hit bitmaps -> ((Q, max_hits) int32,
    (Q,) int32).  Row i holds its bitmap's set-bit positions (ascending),
    -1-padded; hits past ``max_hits`` are dropped and never written;
    counts are the full popcounts.  A CUDA tensor launches the kernel; a
    CPU tensor takes the plain version."""
    _check(bitmaps)
    if max_hits < 0:
        raise ValueError(f"max_hits={max_hits}")
    if bitmaps.device.type == "cpu":
        return bitmap_extract_ref(bitmaps, max_hits=max_hits)
    q, w = bitmaps.shape
    ids = torch.empty((q, max_hits), dtype=torch.int32, device=bitmaps.device)
    counts = torch.empty(q, dtype=torch.int32, device=bitmaps.device)
    if q:
        lib, fn, _ = _kernel()
        with torch.cuda.device(bitmaps.device):
            err = fn(bitmaps.data_ptr(), q, w, max_hits, ids.data_ptr(),
                     counts.data_ptr(), build.stream_of(bitmaps))
        build.check(lib, err, "bitmap_extract")
        build.count_launch(bitmap_extract)
    return ids, counts


def bitmap_extract_ragged(bitmaps: torch.Tensor, offsets: torch.Tensor,
                          total: int) -> torch.Tensor:
    """(Q, W) int32-viewed u32 hit bitmaps, (Q,) int32 row offsets and
    their ``total`` -> (total,) int32: row q's set-bit positions, ascending,
    at ``ids[offsets[q] : offsets[q] + popcount(row q)]``, with no padding.
    A CUDA tensor launches the kernel (``total`` 0 launches nothing); a
    CPU tensor takes the plain version.

    The offsets must be the exclusive prefix sums of the rows' popcounts
    and ``total`` their sum.  The plain version raises otherwise.  The
    kernel does not check (that would cost a round trip to the host): it
    writes row q only inside [offsets[q], offsets[q + 1]) (the last row's
    end is ``total``) cut to [0, total), and a slot that no row fills holds
    whatever the memory held."""
    _check(bitmaps)
    if (offsets.dim() != 1 or offsets.dtype != torch.int32
            or not offsets.is_contiguous()
            or offsets.shape[0] != bitmaps.shape[0]
            or offsets.device != bitmaps.device):
        raise ValueError("offsets must be a contiguous 1-D int32 tensor on "
                         "the bitmaps' device, one per row")
    if not 0 <= total < 2**31:
        raise ValueError(f"total={total}")
    if bitmaps.device.type == "cpu":
        return bitmap_extract_ragged_ref(bitmaps, offsets, total)
    ids = torch.empty(total, dtype=torch.int32, device=bitmaps.device)
    if total:
        q, w = bitmaps.shape
        lib, _, fn = _kernel()
        with torch.cuda.device(bitmaps.device):
            err = fn(bitmaps.data_ptr(), q, w, offsets.data_ptr(), total,
                     ids.data_ptr(), build.stream_of(bitmaps))
        build.check(lib, err, "bitmap_extract_ragged")
        build.count_launch(bitmap_extract_ragged)
    return ids


bitmap_extract.launch_count = 0
bitmap_extract_ragged.launch_count = 0
