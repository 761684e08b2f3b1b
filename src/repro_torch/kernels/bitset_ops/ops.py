"""Wrappers of the bitset_reduce_batch kernel: the AND/OR fold of posting
planes over the token axis plus the popcount of each result row."""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import build
from .ref import (bitset_reduce_batch_ref, bitset_reduce_ragged_ref,
                  bitset_reduce_ref)


@functools.cache
def _kernel():
    lib = build.library("bitset_ops")
    p, i = ctypes.c_void_p, ctypes.c_int
    return lib, build.declare(lib, "bitset_reduce_batch_launch",
                              p, p, i, i, i, i, i, p, p, p)


def _vec_words(w: int, *tensors: torch.Tensor) -> int:
    """The widest load, in words, that a row of W words allows: 4 or 2
    where W is a multiple and every pointer is aligned to it, else 1."""
    for n in (4, 2):
        if w % n == 0 and all(t.data_ptr() % (4 * n) == 0 for t in tensors):
            return n
    return 1


def _launch(planes: torch.Tensor, lens: torch.Tensor | None, q: int,
            op: str) -> tuple[torch.Tensor, torch.Tensor]:
    _, t, w = planes.shape
    out = torch.empty((q, w), dtype=torch.int32, device=planes.device)
    counts = torch.empty(q, dtype=torch.int32, device=planes.device)
    lib, fn = _kernel()
    with torch.cuda.device(planes.device):
        err = fn(planes.data_ptr(), None if lens is None else lens.data_ptr(),
                 q, t, w, int(op == "and"), _vec_words(w, planes, out),
                 out.data_ptr(), counts.data_ptr(), build.stream_of(planes))
    build.check(lib, err, "bitset_reduce_batch")
    return out, counts


def _check(planes: torch.Tensor, op: str, ndim: int) -> None:
    if op not in ("and", "or"):
        raise ValueError(f"op={op!r}")
    if (planes.dim() != ndim or planes.dtype != torch.int32
            or not planes.is_contiguous() or planes.shape[-2] == 0):
        raise ValueError(f"planes must be a contiguous {ndim}-D int32 tensor "
                         f"with at least one token plane")
    if planes.device.type not in ("cpu", "cuda"):
        raise ValueError(f"bitset_ops runs on cuda or cpu, not "
                         f"{planes.device}")


def _empty(q: int, w: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    return (torch.empty((q, w), dtype=torch.int32, device=device),
            torch.empty(q, dtype=torch.int32, device=device))


def bitset_reduce_batch(planes: torch.Tensor, *, op: str = "and"
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """(Q, T, W) int32-viewed u32 planes -> ((Q, W) combined, (Q,) int32
    popcounts).  AND keeps the words every token has; OR any token's.
    A CUDA tensor launches the kernel; a CPU tensor takes the plain
    version."""
    _check(planes, op, 3)
    if planes.device.type == "cpu":
        return bitset_reduce_batch_ref(planes, op=op)
    q, _, w = planes.shape
    if q == 0:      # nothing to launch for
        return _empty(0, w, planes.device)
    out = _launch(planes, None, q, op)
    build.count_launch(bitset_reduce_batch)
    return out


def bitset_reduce_ragged(planes: torch.Tensor, lens: torch.Tensor, *,
                         op: str = "and"
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """The query engine's fold: (Qb, T, W) int32-viewed u32 planes and (Q,)
    int32 token counts, Q <= Qb -> ((Q, W) combined, (Q,) int32
    popcounts), row q folded over its first ``lens[q]`` planes (clamped to
    [0, T]; a row with none gives the fold's neutral word).  Rows past Q
    are neither read nor written.  A CUDA tensor launches the kernel; a
    CPU tensor takes the plain version."""
    _check(planes, op, 3)
    if (lens.dim() != 1 or lens.dtype != torch.int32
            or not lens.is_contiguous() or lens.shape[0] > planes.shape[0]
            or lens.device != planes.device):
        raise ValueError("lens must be a contiguous 1-D int32 tensor on the "
                         "planes' device, with at most one count per row")
    if planes.device.type == "cpu":
        return bitset_reduce_ragged_ref(planes, lens, op=op)
    q, w = lens.shape[0], planes.shape[2]
    if q == 0:
        return _empty(0, w, planes.device)
    out = _launch(planes, lens, q, op)
    build.count_launch(bitset_reduce_ragged)
    return out


def bitset_reduce(planes: torch.Tensor, *, op: str = "and"
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(T, W) planes -> ((W,) combined, () int32 popcount): the Q = 1 call
    of the same kernel."""
    _check(planes, op, 2)
    if planes.device.type == "cpu":
        return bitset_reduce_ref(planes, op=op)
    out, counts = _launch(planes[None], None, 1, op)
    build.count_launch(bitset_reduce)
    return out[0], counts[0]


bitset_reduce_batch.launch_count = 0
bitset_reduce_ragged.launch_count = 0
bitset_reduce.launch_count = 0
