"""Wrappers of the embedding_bag kernels: fixed-size bag sums of table rows
(``embedding_bag_sum``, differentiable with respect to the table) and
their gradient (``embedding_bag_backward``)."""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import build
from .ref import embedding_bag_backward_ref, embedding_bag_ref


@functools.cache
def _kernel():
    lib = build.library("embedding_bag")
    p, i = ctypes.c_void_p, ctypes.c_int
    return lib, build.declare(lib, "embedding_bag_launch", p, p, i, i, i, p, p)


@functools.cache
def _backward_kernel():
    lib = build.library("embedding_bag")
    p, i = ctypes.c_void_p, ctypes.c_int
    return lib, build.declare(lib, "embedding_bag_backward_launch", p, p, i,
                              i, i, ctypes.c_longlong, p, p)


def _check_idx(idx: torch.Tensor, device) -> None:
    if (idx.dim() != 2 or idx.dtype != torch.int32 or not idx.is_contiguous()
            or idx.device != device):
        raise ValueError(f"idx must be a contiguous (B, BAG) int32 tensor "
                         f"on {device}")


def _check_device(t: torch.Tensor) -> None:
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"embedding_bag runs on cuda or cpu, not {t.device}")


def _forward(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    if table.device.type == "cpu":
        return embedding_bag_ref(table, idx)
    b, d = idx.shape[0], table.shape[1]
    out = torch.empty((b, d), dtype=torch.float32, device=table.device)
    if b and d:
        lib, fn = _kernel()
        with torch.cuda.device(table.device):
            err = fn(table.data_ptr(), idx.data_ptr(), b, idx.shape[1], d,
                     out.data_ptr(), build.stream_of(table))
        build.check(lib, err, "embedding_bag")
        build.count_launch(embedding_bag_sum)
    return out


class _EmbeddingBagSum(torch.autograd.Function):
    """The bag sums, with the table's gradient by ``embedding_bag_backward``
    (the ids get none)."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.rows = table.shape[0]
        return _forward(table, idx)

    @staticmethod
    def backward(ctx, grad_out):
        (idx,) = ctx.saved_tensors
        if not ctx.needs_input_grad[0]:
            return None, None
        return embedding_bag_backward(grad_out.contiguous(), idx,
                                      ctx.rows), None


def embedding_bag_sum(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(V, D) f32 table, (B, BAG) int32 indices -> (B, D) f32 bag sums
    (the kernel's order of summation is its own, see its note).  Indices
    must satisfy 0 <= idx < V; that is checked
    on CPU tensors only (on the card it would cost a sync).  A CUDA tensor
    launches the kernel; a CPU tensor takes the plain version.  Gradients
    reach the table through ``embedding_bag_backward``."""
    if (table.dim() != 2 or table.dtype != torch.float32
            or not table.is_contiguous()):
        raise ValueError("table must be a contiguous (V, D) float32 tensor")
    _check_idx(idx, table.device)
    _check_device(table)
    if table.device.type == "cpu" and idx.numel() and not (
            0 <= int(idx.min()) and int(idx.max()) < table.shape[0]):
        raise ValueError(f"embedding_bag indices must lie in "
                         f"[0, {table.shape[0]})")
    return _EmbeddingBagSum.apply(table, idx)


def embedding_bag_backward(grad_out: torch.Tensor, idx: torch.Tensor,
                           rows: int) -> torch.Tensor:
    """(B, D) f32 gradient of the bag sums, (B, BAG) int32 indices -> the
    (rows, D) f32 gradient of the table: grad_out[b] added into row
    idx[b, j] for every j, duplicates summed (by atomics on the card, in
    an order of their own).  A CUDA tensor launches the kernel; a CPU
    tensor takes the plain version."""
    if (grad_out.dim() != 2 or grad_out.dtype != torch.float32
            or not grad_out.is_contiguous()):
        raise ValueError("grad_out must be a contiguous (B, D) float32 "
                         "tensor")
    _check_idx(idx, grad_out.device)
    _check_device(grad_out)
    if idx.shape[0] != grad_out.shape[0] or rows < 0:
        raise ValueError(f"grad_out has {grad_out.shape[0]} bags and idx "
                         f"{idx.shape[0]}; rows {rows}")
    if grad_out.device.type == "cpu":
        return embedding_bag_backward_ref(grad_out, idx, rows)
    b, d = grad_out.shape
    grad = torch.empty((rows, d), dtype=torch.float32, device=grad_out.device)
    lib, fn = _backward_kernel()
    with torch.cuda.device(grad_out.device):
        err = fn(grad_out.data_ptr(), idx.data_ptr(), b, idx.shape[1], d,
                 rows, grad.data_ptr(), build.stream_of(grad_out))
    build.check(lib, err, "embedding_bag_backward")
    build.count_launch(embedding_bag_backward)
    return grad


embedding_bag_sum.launch_count = 0
embedding_bag_backward.launch_count = 0
