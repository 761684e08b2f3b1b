"""AdamW with f32 moments, a global-norm gradient clip and linear warmup.

Parameters may be bf16; the first and second moments are f32 whatever the
parameter's dtype.  Weight decay is decoupled (AdamW).  The state is a
named tuple of trees like the parameters', so that it checkpoints as they
do; ``step`` is a 0-d int32 tensor on the parameters' device, and the
schedule and bias corrections are f32 tensors computed from it there.
The update is functional, as the JAX package's: it returns new tensors
and leaves its arguments as they were.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from ..tree import leaves, map_tree, unflatten


@dataclass(frozen=True)
class AdamConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 1.0
    warmup_steps: int = 100


class AdamState(NamedTuple):
    step: torch.Tensor
    mu: object      # tree like params, f32
    nu: object      # tree like params, f32


def _device(params) -> torch.device:
    ls = leaves(params)
    return ls[0].device if ls else torch.device("cpu")


def init_adam(params) -> AdamState:
    def f32(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return AdamState(step=torch.zeros((), dtype=torch.int32,
                                      device=_device(params)),
                     mu=map_tree(f32, params), nu=map_tree(f32, params))


def _schedule(cfg: AdamConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup from step 1 to ``warmup_steps``, then ``lr``."""
    warm = (step.to(torch.float32) / max(cfg.warmup_steps, 1)).clamp(max=1.0)
    return cfg.lr * warm


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in f32, leaves in order."""
    sq = 0
    for x in leaves(tree):
        sq = sq + x.to(torch.float32).square().sum()
    return torch.sqrt(torch.as_tensor(sq, dtype=torch.float32))


def adam_update(cfg: AdamConfig, params, grads, state: AdamState):
    """One AdamW step; returns (new params, new state, metrics)."""
    gnorm = global_norm(grads)
    scale = (torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
             if cfg.grad_clip > 0 else 1.0)
    step = state.step + 1
    lr = _schedule(cfg, step)
    step_f = step.to(torch.float32)
    b1t = 1.0 - torch.pow(cfg.b1, step_f)
    b2t = 1.0 - torch.pow(cfg.b2, step_f)

    def upd(p, g, mu, nu):
        g = g.to(torch.float32) * scale
        mu = cfg.b1 * mu + (1 - cfg.b1) * g
        nu = cfg.b2 * nu + (1 - cfg.b2) * g.square()
        mhat = mu / b1t
        nhat = nu / b2t
        delta = lr * (mhat / (torch.sqrt(nhat) + cfg.eps)
                      + cfg.weight_decay * p.to(torch.float32))
        return (p.to(torch.float32) - delta).to(p.dtype), mu, nu

    out = [upd(*x) for x in zip(leaves(params), leaves(grads),
                                leaves(state.mu), leaves(state.nu),
                                strict=True)]
    new_p = unflatten(params, [o[0] for o in out])
    new_mu = unflatten(params, [o[1] for o in out])
    new_nu = unflatten(params, [o[2] for o in out])
    return new_p, AdamState(step=step, mu=new_mu, nu=new_nu), \
        dict(grad_norm=gnorm, lr=lr)
