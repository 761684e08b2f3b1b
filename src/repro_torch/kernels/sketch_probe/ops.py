"""Wrappers of the sketch_probe kernel's two entries: the MPHF probe of a
batch of u32 fingerprints against a segment's :meth:`MPHF.device_arrays`
dict, and the fused segment probe of the query waves (MPHF probe,
signature check, CSF rank and the OR of each posting-plane row into the
wave's accumulator) against an :meth:`ImmutableSketch.device_arrays` dict."""
from __future__ import annotations

import ctypes
import functools

import torch

from ...core.mphf import MAX_LEVELS_DEFAULT as MAX_LEVELS  # kMaxLevels
from .. import build
from .ref import match_planes_ref, sketch_probe_ref

_ARRAYS = ("words", "block_rank", "level_bits", "level_word_offset",
           "fallback_fps", "fallback_idx")
_MATCH_ARRAYS = ("signatures", "csf_bitseq", "csf_lengths")


@functools.cache
def _kernels():
    lib = build.library("sketch_probe")
    p, i = ctypes.c_void_p, ctypes.c_int
    mphf = (p, p, p, p, p, i, p, p, i)
    return (lib,
            build.declare(lib, "sketch_probe_launch", p, i, *mphf, p, p, p),
            build.declare(lib, "sketch_match_launch", p, i, *mphf,
                          p, i, i, i, p, i, p, i, p, p, i, i, p, i, p))


def host_levels(arrs: dict) -> ctypes.Array:
    """The first MAX_LEVELS level sizes, then their word offsets, zero
    past the last level, in host memory: the kernel takes them by value.
    Made once per device-arrays dict and kept in it, so it lives as long
    as the segment's arrays do."""
    table = arrs.get("host_levels")
    if table is None:
        head = arrs["levels"][:MAX_LEVELS]
        pad = [0] * (MAX_LEVELS - len(head))
        table = arrs["host_levels"] = (ctypes.c_uint32 * (2 * MAX_LEVELS))(
            *[m for m, _ in head], *pad, *[o for _, o in head], *pad)
    return table


def _check(fps: torch.Tensor, arrs: dict, names) -> None:
    if fps.dim() != 1 or fps.dtype != torch.int32 or not fps.is_contiguous():
        raise ValueError("fps must be a contiguous 1-D int32 tensor")
    for name in names:
        a = arrs[name]
        if (a.device != fps.device or a.dtype != torch.int32 or a.dim() != 1
                or not a.is_contiguous()):
            raise ValueError(f"arrs[{name!r}] must be a contiguous 1-D "
                             f"int32 tensor on {fps.device}")
    if fps.device.type not in ("cpu", "cuda"):
        raise ValueError(f"sketch_probe runs on cuda or cpu, not {fps.device}")
    if fps.device.type == "cuda" and arrs["words"].data_ptr() % 16:
        # the kernel reads a rank block as two 16-byte vectors
        raise ValueError("arrs['words'] must be 16-byte aligned")


def _mphf_args(arrs: dict) -> tuple:
    return (arrs["words"].data_ptr(), arrs["block_rank"].data_ptr(),
            host_levels(arrs), arrs["level_bits"].data_ptr(),
            arrs["level_word_offset"].data_ptr(), arrs["level_bits"].numel(),
            arrs["fallback_fps"].data_ptr(), arrs["fallback_idx"].data_ptr(),
            int(arrs["fb_count"]))


def mphf_probe_arrs(fps: torch.Tensor, arrs: dict
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """(Q,) int32 tensor of u32 fingerprint bits -> (idx (Q,) int32,
    absent (Q,) bool).  Keys that collided through every level resolve
    against the sorted fallback keys (the first ``fb_count`` entries).

    A CUDA tensor launches the kernel; a CPU tensor takes the plain
    version; any other device raises."""
    _check(fps, arrs, _ARRAYS)
    if fps.device.type == "cpu":
        return sketch_probe_ref(fps, arrs)
    q = fps.numel()
    idx = torch.empty(q, dtype=torch.int32, device=fps.device)
    absent = torch.empty(q, dtype=torch.bool, device=fps.device)
    if q:
        lib, fn, _ = _kernels()
        with torch.cuda.device(fps.device):
            err = fn(fps.data_ptr(), q, *_mphf_args(arrs), idx.data_ptr(),
                     absent.data_ptr(), build.stream_of(fps))
        build.check(lib, err, "sketch_probe")
        build.count_launch(mphf_probe_arrs)
    return idx, absent


def match_planes(fps: torch.Tensor, arrs: dict, acc: torch.Tensor, *,
                 sig_bits: int) -> torch.Tensor:
    """OR, for each fingerprint i of the (Q,) int32 tensor ``fps``, the
    posting-plane row of its token in the segment whose
    :meth:`ImmutableSketch.device_arrays` are ``arrs`` (which must hold
    planes) into row i of the (Q, W_out) int32 accumulator ``acc``, in
    place; the row is cut or zero-padded to W_out, and an absent token
    (absent from the MPHF or rejected by its signature) ORs nothing.
    Returns ``acc``.  A CUDA tensor launches the fused kernel; a CPU
    tensor takes the plain version."""
    _check(fps, arrs, _ARRAYS + _MATCH_ARRAYS)
    planes, samples = arrs["planes"], arrs["csf_samples"]
    for name, t, dtype, dim in (("planes", planes, torch.int32, 2),
                                ("csf_samples", samples, torch.int64, 1),
                                ("acc", acc, torch.int32, 2)):
        if (t.device != fps.device or t.dtype != dtype or t.dim() != dim
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous {dim}-D {dtype} "
                             f"tensor on {fps.device}")
    q = fps.numel()
    if acc.shape[0] != q:
        raise ValueError(f"acc has {acc.shape[0]} rows for {q} fingerprints")
    if not 0 <= sig_bits <= 32:
        raise ValueError(f"sig_bits must be in [0, 32], not {sig_bits}")
    if fps.device.type == "cpu":
        return match_planes_ref(fps, arrs, acc, sig_bits=sig_bits)
    if arrs["csf_n1"] < arrs["n_tokens1"]:
        # a built sketch has one CSF entry per token; the kernel relies on
        # it (no clamp of the CSF positions)
        raise ValueError("the CSF holds fewer entries than the sketch tokens")
    if q:
        lib, _, fn = _kernels()
        with torch.cuda.device(fps.device):
            err = fn(fps.data_ptr(), q, *_mphf_args(arrs),
                     arrs["signatures"].data_ptr(), arrs["signatures"].numel(),
                     sig_bits, int(arrs["n_tokens1"]),
                     arrs["csf_bitseq"].data_ptr(), arrs["csf_bitseq"].numel(),
                     arrs["csf_lengths"].data_ptr(),
                     arrs["csf_lengths"].numel(), samples.data_ptr(),
                     planes.data_ptr(), planes.shape[1],
                     int(arrs["n_lists1"]), acc.data_ptr(), acc.shape[1],
                     build.stream_of(fps))
        build.check(lib, err, "sketch_probe (fused)")
        build.count_launch(match_planes)
    return acc


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
match_planes.launch_count = 0
