"""Gradient compression for a cross-pod all-reduce: symmetric int8
quantization with error feedback.

The quantize / dequantize pair and the error-feedback step are ported;
``compressed_psum`` reduces over a mesh axis and waits for the mesh.
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


def compressed_psum(grad, err, axis_name):
    raise NotImplementedError("compressed_psum (an int8 all-reduce over a "
                              "mesh axis) is not yet ported")


def init_error_feedback(params):
    return map_tree(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
