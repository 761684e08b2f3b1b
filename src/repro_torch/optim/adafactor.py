"""Adafactor-style optimizer: factored second moment and an optional bf16
first moment (Shazeer & Stern, arXiv:1804.04235).

It is arctic-480b's optimizer: factoring the second moment keeps it at
O(rows + cols) a matrix, and the bf16 first moment halves the rest.

State leaves mirror the parameter tree:
  mu : like the parameter, in ``mu_dtype`` (bf16 by default)
  vr : param.shape[:-1], the row factor of the second moment  (ndim >= 2)
  vc : param.shape[:-2] + [-1], the column factor              (ndim >= 2)
       below 2 dims vr is the whole second moment and vc a (1,) stub.

A layer-stacked leaf (ndim >= 3 and a leading axis of at least 8) is
updated one leading slice at a time, recursively, as the JAX package's
``fori_loop`` does: the RMS clip of the update is therefore taken over
each innermost slice, not over the leaf (arctic's (L, E, d, f) experts
recurse twice, down to one expert's matrix).  Functional, as
``adam_update``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from ..models.layers import torch_dtype
from ..tree import leaves, map_tree, unflatten
from .adam import _device


@dataclass(frozen=True)
class AdafactorConfig:
    lr: float = 1e-4
    b1: float = 0.9
    decay: float = 0.99
    eps: float = 1e-30
    clip_threshold: float = 1.0
    weight_decay: float = 0.0
    warmup_steps: int = 100
    mu_dtype: str = "bfloat16"


class AdafactorState(NamedTuple):
    step: torch.Tensor
    mu: object
    vr: object
    vc: object


def _factored(p: torch.Tensor) -> bool:
    return p.dim() >= 2


def init_adafactor(cfg: AdafactorConfig, params) -> AdafactorState:
    f32 = dict(dtype=torch.float32)

    def mu(p):
        return torch.zeros(p.shape, dtype=torch_dtype(cfg.mu_dtype),
                           device=p.device)

    def vr(p):
        shape = p.shape[:-1] if _factored(p) else p.shape
        return torch.zeros(shape, device=p.device, **f32)

    def vc(p):
        shape = (p.shape[:-2] + p.shape[-1:]) if _factored(p) else (1,)
        return torch.zeros(shape, device=p.device, **f32)

    return AdafactorState(step=torch.zeros((), dtype=torch.int32,
                                           device=_device(params)),
                          mu=map_tree(mu, params), vr=map_tree(vr, params),
                          vc=map_tree(vc, params))


def _update_leaf(cfg: AdafactorConfig, lr, p, g, mu, vr, vc):
    """(new p, mu, vr, vc) of one leaf; a stacked leaf slice by slice."""
    if p.dim() >= 3 and p.shape[0] >= 8:
        outs = [_update_leaf(cfg, lr, p[i], g[i], mu[i], vr[i], vc[i])
                for i in range(p.shape[0])]
        return tuple(torch.stack([o[k] for o in outs]) for k in range(4))
    d = cfg.decay
    g = g.to(torch.float32)
    g2 = g.square() + cfg.eps
    if _factored(p):
        vr = d * vr + (1 - d) * g2.mean(-1)
        vc = d * vc + (1 - d) * g2.mean(-2)
        rfac = torch.rsqrt(
            vr / vr.mean(-1, keepdim=True).clamp_min(cfg.eps) + cfg.eps)
        cfac = torch.rsqrt(vc + cfg.eps)
        u = g * rfac[..., None] * cfac[..., None, :]
    else:
        vr = d * vr + (1 - d) * g2
        u = g * torch.rsqrt(vr + cfg.eps)
    # update clipping (RMS <= clip_threshold)
    rms = torch.sqrt(u.square().mean() + 1e-30)
    u = u / torch.clamp(rms / cfg.clip_threshold, min=1.0)
    if cfg.b1 > 0:
        mu = (cfg.b1 * mu.to(torch.float32) + (1 - cfg.b1) * u).to(mu.dtype)
        u = mu.to(torch.float32)
    delta = lr * (u + cfg.weight_decay * p.to(torch.float32))
    return (p.to(torch.float32) - delta).to(p.dtype), mu, vr, vc


def adafactor_update(cfg: AdafactorConfig, params, grads,
                     state: AdafactorState):
    """One Adafactor step; returns (new params, new state, metrics)."""
    step = state.step + 1
    warm = (step.to(torch.float32) / max(cfg.warmup_steps, 1)).clamp(max=1.0)
    lr = cfg.lr * warm
    out = [_update_leaf(cfg, lr, *x)
           for x in zip(leaves(params), leaves(grads), leaves(state.mu),
                        leaves(state.vr), leaves(state.vc), strict=True)]
    return (unflatten(params, [o[0] for o in out]),
            AdafactorState(step=step,
                           mu=unflatten(params, [o[1] for o in out]),
                           vr=unflatten(params, [o[2] for o in out]),
                           vc=unflatten(params, [o[3] for o in out])),
            dict(lr=lr))
