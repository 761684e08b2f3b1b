"""Wrapper of the csc_probe kernel: the batched probe of a
:class:`~repro_torch.baselines.csc.CSCSketch`."""
from __future__ import annotations

import ctypes
import functools

import torch

from ...baselines.csc import _seed
from .. import build
from .ref import csc_probe_ref

MAX_P = 256     # the kernel keeps a row's mask in ceil(p / 32) <= 8 registers


@functools.cache
def _kernel():
    lib = build.library("csc_probe")
    p, i = ctypes.c_void_p, ctypes.c_int
    return lib, build.declare(lib, "csc_probe_launch",
                              p, i, p, i, p, p, i, i, i, p, p)


@functools.cache
def host_seeds(j: int, k: int) -> ctypes.Array:
    """The j * k anchor seeds in host memory, row-major by repetition, as
    ``CSCSketch.device_arrays`` uploads them: the kernel takes the first
    ones by value in its parameters."""
    return (ctypes.c_uint32 * (j * k))(*(_seed(rep, hk) for rep in range(j)
                                         for hk in range(k)))


def csc_partition_mask(sketch, fps: torch.Tensor) -> torch.Tensor:
    """(Q,) int32 tensor of u32 fingerprints -> (Q, p) bool partition
    survival mask against ``sketch``'s device arrays on the same device
    (uploaded once per device).  A CUDA tensor launches the kernel; a CPU
    tensor takes the plain version."""
    if fps.dim() != 1 or fps.dtype != torch.int32 or not fps.is_contiguous():
        raise ValueError("fps must be a contiguous 1-D int32 tensor")
    if not 1 <= sketch.p <= MAX_P:
        raise ValueError(f"csc_probe takes 1 <= p <= {MAX_P}, not {sketch.p}")
    if sketch.m < 64 or sketch.m & (sketch.m - 1) or sketch.m > 1 << 31:
        raise ValueError(f"m must be a power of two in [64, 2^31], "
                         f"not {sketch.m}")
    if fps.device.type == "cpu":
        return csc_probe_ref(sketch, fps)
    if fps.device.type != "cuda":
        raise ValueError(f"csc_probe runs on cuda or cpu, not {fps.device}")
    arrs = sketch.device_arrays(fps.device)
    q = fps.numel()
    out = torch.empty((q, sketch.p), dtype=torch.bool, device=fps.device)
    if q:
        lib, fn = _kernel()
        with torch.cuda.device(fps.device):
            err = fn(fps.data_ptr(), q, arrs["bits"].data_ptr(),
                     sketch.m >> 5, host_seeds(sketch.j, sketch.k),
                     arrs["seeds"].data_ptr(), sketch.j, sketch.k, sketch.p,
                     out.data_ptr(), build.stream_of(fps))
        build.check(lib, err, "csc_probe")
        build.count_launch(csc_partition_mask)
    return out


csc_partition_mask.launch_count = 0
