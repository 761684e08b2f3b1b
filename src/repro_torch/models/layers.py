"""Shared layers: norms, MLPs, RoPE, initializers.

Parameters are nested dicts of tensors with the JAX package's keys, and
every layer is a plain function on tensors.  Initializers draw from an
explicit ``torch.Generator`` and place their tensors on its device.
"""
from __future__ import annotations

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    if name not in DTYPES:
        raise ValueError(f"dtype {name!r} is not one of {sorted(DTYPES)}")
    return DTYPES[name]


def normal(gen: torch.Generator, shape, scale: float = 1.0,
           dtype=torch.float32) -> torch.Tensor:
    """N(0, scale^2) drawn in f32 on the generator's device, then cast."""
    x = torch.randn(tuple(shape), generator=gen, device=gen.device,
                    dtype=torch.float32)
    if scale != 1.0:
        x.mul_(scale)
    return x.to(dtype)


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype=torch.float32, scale: float | None = None):
    scale = scale if scale is not None else d_in ** -0.5
    return normal(gen, (d_in, d_out), scale, dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype=torch.float32):
    return normal(gen, (vocab, d), 1.0, dtype)


def rms_norm(x: torch.Tensor, weight: torch.Tensor | None = None,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in f32 with the ``(1 + weight)`` gain (weights start at
    zero); ``weight=None`` is the non-parametric variant."""
    x32 = x.to(torch.float32)
    nrm = x32 * torch.rsqrt(x32.square().mean(-1, keepdim=True) + eps)
    if weight is not None:
        nrm = nrm * (1.0 + weight.to(torch.float32))
    return nrm.to(x.dtype)


def layer_norm_nonparam(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Non-parametric LayerNorm (mean-centred, no gain or bias)."""
    x32 = x.to(torch.float32)
    mu = x32.mean(-1, keepdim=True)
    var = x32.var(-1, keepdim=True, unbiased=False)
    return ((x32 - mu) * torch.rsqrt(var + eps)).to(x.dtype)


def mlp_init(gen: torch.Generator, sizes, dtype=torch.float32) -> dict:
    n = len(sizes) - 1
    params = {f"w{i}": dense_init(gen, sizes[i], sizes[i + 1], dtype)
              for i in range(n)}
    params.update({f"b{i}": torch.zeros(sizes[i + 1], dtype=dtype,
                                        device=gen.device)
                   for i in range(n)})
    return params


def mlp_apply(params: dict, x: torch.Tensor, *, act=torch.relu,
              final_act: bool = False) -> torch.Tensor:
    n = len([k for k in params if k.startswith("w")])
    for i in range(n):
        x = x @ params[f"w{i}"] + params[f"b{i}"]
        if i < n - 1 or final_act:
            x = act(x)
    return x


def rope_table(positions: torch.Tensor, d_head: int, theta: float = 10000.0,
               dtype=torch.float32) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., d_head / 2) cos and sin tables for the given positions."""
    half = d_head // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=positions.device) / half))
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(ang).to(dtype), torch.sin(ang).to(dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x (..., S, H, d_head); cos, sin (..., S, d_head / 2).  Half-split
    layout: the first half of each head pairs with the second."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    cos, sin = cos[..., None, :], sin[..., None, :]   # broadcast over heads
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def softcap(logits: torch.Tensor, cap: float | None) -> torch.Tensor:
    """Logit soft-capping: cap * tanh(x / cap)."""
    if cap is None:
        return logits
    return cap * torch.tanh(logits / cap)
