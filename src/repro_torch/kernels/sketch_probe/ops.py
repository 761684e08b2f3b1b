"""Wrapper of the sketch_probe kernel: the MPHF probe of a batch of u32
fingerprints against a segment's :meth:`MPHF.device_arrays` dict."""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import build
from .ref import sketch_probe_ref

_ARRAYS = ("words", "block_rank", "level_bits", "level_word_offset",
           "fallback_fps", "fallback_idx")


@functools.cache
def _kernel():
    lib = build.library("sketch_probe")
    p, i = ctypes.c_void_p, ctypes.c_int
    return lib, build.declare(lib, "sketch_probe_launch",
                              p, i, p, p, p, p, i, p, p, i, p, p, p)


def mphf_probe_arrs(fps: torch.Tensor, arrs: dict
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """(Q,) int32 tensor of u32 fingerprint bits -> (idx (Q,) int32,
    absent (Q,) bool).  Keys that collided through every level resolve
    against the sorted fallback keys (the first ``fb_count`` entries).

    A CUDA tensor launches the kernel; a CPU tensor takes the plain
    version; any other device raises."""
    if fps.dim() != 1 or fps.dtype != torch.int32 or not fps.is_contiguous():
        raise ValueError("fps must be a contiguous 1-D int32 tensor")
    for name in _ARRAYS:
        a = arrs[name]
        if (a.device != fps.device or a.dtype != torch.int32 or a.dim() != 1
                or not a.is_contiguous()):
            raise ValueError(f"arrs[{name!r}] must be a contiguous 1-D "
                             f"int32 tensor on {fps.device}")
    if fps.device.type == "cpu":
        return sketch_probe_ref(fps, arrs)
    if fps.device.type != "cuda":
        raise ValueError(f"sketch_probe runs on cuda or cpu, not {fps.device}")
    q = fps.numel()
    idx = torch.empty(q, dtype=torch.int32, device=fps.device)
    absent = torch.empty(q, dtype=torch.bool, device=fps.device)
    if q:
        lib, fn = _kernel()
        with torch.cuda.device(fps.device):
            err = fn(fps.data_ptr(), q, arrs["words"].data_ptr(),
                     arrs["block_rank"].data_ptr(),
                     arrs["level_bits"].data_ptr(),
                     arrs["level_word_offset"].data_ptr(),
                     arrs["level_bits"].numel(),
                     arrs["fallback_fps"].data_ptr(),
                     arrs["fallback_idx"].data_ptr(), int(arrs["fb_count"]),
                     idx.data_ptr(), absent.data_ptr(), build.stream_of(fps))
        build.check(lib, err, "sketch_probe")
        mphf_probe_arrs.launch_count += 1
    return idx, absent


def mphf_probe(mphf, fps: torch.Tensor, *, arrs: dict | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched probe of a built :class:`~repro_torch.core.mphf.MPHF`:
    ``mphf_probe_arrs`` over ``arrs``, an ``mphf.device_arrays()`` dict a
    caller already holds (the query engine's per-segment cache), or, when
    it is None, over the MPHF's arrays uploaded to ``fps``'s device."""
    if arrs is None:
        arrs = mphf.device_arrays(fps.device)
    return mphf_probe_arrs(fps, arrs)


mphf_probe_arrs.launch_count = 0
