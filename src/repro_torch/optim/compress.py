"""Gradient compression for a cross-pod all-reduce: symmetric int8
quantization with error feedback.

Cross-pod links are an order of magnitude slower than in-pod ones;
quantizing the pod-level gradient all-reduce to int8 cuts that wire traffic
4x (f32), with the residual fed back into the next step so that the
quantization error stays unbiased over time.  ``compressed_psum`` runs
inside a per-rank body (``launch.mesh.shard_map``) and reduces over one
mesh axis' process group.
"""
from __future__ import annotations

import torch

from ..tree import map_tree


def quantize_int8(x: torch.Tensor):
    """Symmetric per-tensor int8 quantization: (q int8, f32 scale)."""
    x32 = x.to(torch.float32)
    amax = x32.abs().max() + 1e-12
    scale = amax / 127.0
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def quantize_with_feedback(grad: torch.Tensor, err: torch.Tensor):
    """Error-feedback quantization: the part of (grad + err) lost to
    rounding becomes the next step's err.  Returns (q, scale, new err)."""
    target = grad.to(torch.float32) + err
    q, scale = quantize_int8(target)
    return q, scale, target - dequantize_int8(q, scale)


def compressed_psum(grad: torch.Tensor, err: torch.Tensor, axis_name, *,
                    mesh=None):
    """Quantize -> sum over ``axis_name`` -> dequantize, with error
    feedback: the int8 payload is summed as int32 over the axis' group and
    the scale averaged, so that the result is total * mean(scale).
    ``mesh`` defaults to ``launch.mesh.current_mesh()``.  Returns (reduced
    gradient f32, new err)."""
    from ..launch.mesh import current_mesh, pmean, psum

    mesh = mesh if mesh is not None else current_mesh()
    q, scale, new_err = quantize_with_feedback(grad, err)
    total = psum(q.to(torch.int32), axis_name, mesh)
    return total.to(torch.float32) * pmean(scale, axis_name, mesh), new_err


def init_error_feedback(params):
    return map_tree(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
