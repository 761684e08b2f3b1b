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

import math
from dataclasses import dataclass
from typing import NamedTuple

import torch

from ..models.layers import is_dtensor, replicated_like, torch_dtype
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


def _update_leaf(cfg: AdafactorConfig, lr, p, g, mu, vr, vc,
                 mean=torch.mean):
    """(new p, mu, vr, vc) of one leaf; a stacked leaf slice by slice.
    ``mean(x, dim=None, keepdim=False)`` takes every mean (the split-leaf
    one in ``_split_update``)."""
    if p.dim() >= 3 and p.shape[0] >= 8:
        outs = [_update_leaf(cfg, lr, p[i], g[i], mu[i], vr[i], vc[i], mean)
                for i in range(p.shape[0])]
        return tuple(torch.stack([o[k] for o in outs]) for k in range(4))
    d = cfg.decay
    g = g.to(torch.float32)
    g2 = g.square() + cfg.eps
    if _factored(p):
        vr = d * vr + (1 - d) * mean(g2, -1)
        vc = d * vc + (1 - d) * mean(g2, -2)
        rfac = torch.rsqrt(
            vr / mean(vr, -1, keepdim=True).clamp_min(cfg.eps) + cfg.eps)
        cfac = torch.rsqrt(vc + cfg.eps)
        u = g * rfac[..., None] * cfac[..., None, :]
    else:
        vr = d * vr + (1 - d) * g2
        u = g * torch.rsqrt(vr + cfg.eps)
    # update clipping (RMS <= clip_threshold)
    rms = torch.sqrt(mean(u.square()) + 1e-30)
    u = u / torch.clamp(rms / cfg.clip_threshold, min=1.0)
    if cfg.b1 > 0:
        mu = (cfg.b1 * mu.to(torch.float32) + (1 - cfg.b1) * u).to(mu.dtype)
        u = mu.to(torch.float32)
    delta = lr * (u + cfg.weight_decay * p.to(torch.float32))
    return (p.to(torch.float32) - delta).to(p.dtype), mu, vr, vc


def _split_update(cfg: AdafactorConfig, lr, p, g, mu, vr, vc):
    """``_update_leaf`` of DTensor leaves on each rank's shards, as a
    sharded optimizer runs it: the slicing follows the global shape, each
    rank walks its own slices, and a mean over a dim that the mesh splits
    is the sum of the ranks' local sums (``launch.mesh.psum``) over the
    dim's global size.  (Indexing a DTensor along a split dim would gather
    it: every rank each whole stacked expert weight.)"""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from ..launch.mesh import psum

    mesh = p.device_mesh
    shape = tuple(p.shape)

    def split_mean(first, x, dim=None, keepdim=False):
        # x's dims are the leaf's from ``first`` on (a row factor's too:
        # it drops the leaf's last dim)
        dims = range(x.dim()) if dim is None else (dim % x.dim(),)
        leaf_dims = {first + i for i in dims}
        ax = tuple(n for n, pl in zip(mesh.mesh_dim_names, p.placements)
                   if isinstance(pl, Shard) and pl.dim in leaf_dims)
        s = x.sum() if dim is None else x.sum(dim, keepdim=keepdim)
        return ((psum(s, ax, mesh) if ax else s)
                / math.prod(shape[i] for i in leaf_dims))

    def walk(lr_l, xs, first):
        if len(shape) - first >= 3 and shape[first] >= 8:
            outs = [walk(lr_l, [x[i] for x in xs], first + 1)
                    for i in range(xs[0].shape[0])]
            return tuple(torch.stack([o[k] for o in outs]) for k in range(4))
        return _update_leaf(cfg, lr_l, *xs,
                            mean=lambda *a, **k: split_mean(first, *a, **k))

    rep = (Replicate(),) * mesh.ndim
    pls = tuple(tuple(t.placements) for t in (p, mu, vr, vc))
    if not is_dtensor(lr):
        lr = replicated_like(torch.as_tensor(lr, device=p.device), p)
    return local_map(lambda lr_l, *xs: walk(lr_l, xs, 0), out_placements=pls,
                     in_placements=(rep, pls[0], pls[0], *pls[1:]),
                     device_mesh=mesh, redistribute_inputs=True)(
        lr, p, g, mu, vr, vc)


def adafactor_update(cfg: AdafactorConfig, params, grads,
                     state: AdafactorState):
    """One Adafactor step; returns (new params, new state, metrics)."""
    step = state.step + 1
    warm = (step.to(torch.float32) / max(cfg.warmup_steps, 1)).clamp(max=1.0)
    lr = cfg.lr * warm
    out = [(_split_update if is_dtensor(x[0]) else _update_leaf)(cfg, lr, *x)
           for x in zip(leaves(params), leaves(grads), leaves(state.mu),
                        leaves(state.vr), leaves(state.vc), strict=True)]
    return (unflatten(params, [o[0] for o in out]),
            AdafactorState(step=step,
                           mu=unflatten(params, [o[1] for o in out]),
                           vr=unflatten(params, [o[2] for o in out]),
                           vc=unflatten(params, [o[3] for o in out])),
            dict(lr=lr))
