"""Wrapper of the embedding_bag kernel: fixed-size bag sums of table rows."""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import build
from .ref import embedding_bag_ref


@functools.cache
def _kernel():
    lib = build.library("embedding_bag")
    p, i = ctypes.c_void_p, ctypes.c_int
    return lib, build.declare(lib, "embedding_bag_launch", p, p, i, i, i, p, p)


def embedding_bag_sum(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(V, D) f32 table, (B, BAG) int32 indices -> (B, D) f32 bag sums
    (the kernel's order of summation is its own, see its note).  Indices
    must satisfy 0 <= idx < V; that is checked
    on CPU tensors only (on the card it would cost a sync).  A CUDA tensor
    launches the kernel; a CPU tensor takes the plain version."""
    if (table.dim() != 2 or table.dtype != torch.float32
            or not table.is_contiguous()):
        raise ValueError("table must be a contiguous (V, D) float32 tensor")
    if (idx.dim() != 2 or idx.dtype != torch.int32 or not idx.is_contiguous()
            or idx.device != table.device):
        raise ValueError(f"idx must be a contiguous (B, BAG) int32 tensor "
                         f"on {table.device}")
    v, d = table.shape
    b, bag = idx.shape
    if table.device.type == "cpu":
        if idx.numel() and not (0 <= int(idx.min()) and int(idx.max()) < v):
            raise ValueError(f"embedding_bag indices must lie in [0, {v})")
        return embedding_bag_ref(table, idx)
    if table.device.type != "cuda":
        raise ValueError(f"embedding_bag runs on cuda or cpu, not "
                         f"{table.device}")
    out = torch.empty((b, d), dtype=torch.float32, device=table.device)
    if b and d:
        lib, fn = _kernel()
        with torch.cuda.device(table.device):
            err = fn(table.data_ptr(), idx.data_ptr(), b, bag, d,
                     out.data_ptr(), build.stream_of(table))
        build.check(lib, err, "embedding_bag")
        build.count_launch(embedding_bag_sum)
    return out


embedding_bag_sum.launch_count = 0
