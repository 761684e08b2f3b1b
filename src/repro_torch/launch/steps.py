"""Step factories of the ported archs: per-family init, losses, serving
functions and serve steps, and the training step.

``make_train_step`` is the JAX package's large-scale schedule on one
device: microbatched gradient accumulation (a Python loop over rows
``[i * mb, (i + 1) * mb)`` of the batch, the gradients summed in the
arch's ``grad_accum_dtype`` and divided by the microbatch count), remat
inside the layers (``lm_loss`` and ``gnn_loss`` checkpoint each layer),
the sequence-chunked CE, and AdamW (f32 moments) or Adafactor (factored,
bf16 first moment: arctic).  Gradients are ``torch.autograd.grad`` of the
loss over the flattened parameter leaves.  Not yet ported: everything
mesh-related (the dry run's bundles and shardings).
"""
from __future__ import annotations

from dataclasses import replace
from functools import partial

import torch

from ..configs.base import ArchSpec, ShapeSpec
from ..models import gnn as gnn_mod
from ..models import recsys as rs
from ..models import transformer as tf_mod
from ..models.layers import torch_dtype
from ..optim.adafactor import (AdafactorConfig, adafactor_update,
                               init_adafactor)
from ..optim.adam import AdamConfig, adam_update, init_adam
from ..tree import leaves, map_tree, unflatten


def make_optimizer(spec: ArchSpec):
    """(config, init, update) of the arch's optimizer: ``init(cfg,
    params)`` for Adafactor, ``init(params)`` for AdamW, as in the JAX
    package."""
    if spec.optimizer == "adafactor":
        return AdafactorConfig(), init_adafactor, adafactor_update
    return AdamConfig(), init_adam, adam_update


def _init_opt(spec: ArchSpec, ocfg, params):
    if spec.optimizer == "adafactor":
        return init_adafactor(ocfg, params)
    return init_adam(params)


def _opt_update(spec: ArchSpec, ocfg, params, grads, opt):
    if spec.optimizer == "adafactor":
        return adafactor_update(ocfg, params, grads, opt)
    return adam_update(ocfg, params, grads, opt)


def family_loss(spec: ArchSpec):
    """``loss(params, batch)`` of the arch's config: a scalar f32 tensor."""
    cfg = spec.config
    if spec.family == "lm":
        return lambda p, b: tf_mod.lm_loss(cfg, p, b)[0]
    if spec.family == "gnn":
        return lambda p, b: gnn_mod.gnn_loss(cfg, p, b)[0]
    fns = {"XDeepFMConfig": rs.xdeepfm_loss, "SASRecConfig": rs.sasrec_loss,
           "MINDConfig": rs.mind_loss, "TwoTowerConfig": rs.twotower_loss}
    fn = fns[type(cfg).__name__]
    return lambda p, b: fn(cfg, p, b)[0]


def value_and_grad(loss_fn, params, batch):
    """(loss, grads) of ``loss_fn(params, batch)``: the loss detached, the
    gradients a tree like ``params``.  A leaf the loss does not reach gets
    zeros, as ``jax.value_and_grad`` gives it."""
    flat = [p.detach().requires_grad_(True) for p in leaves(params)]
    with torch.enable_grad():
        loss = loss_fn(unflatten(params, flat), batch)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(flat, grads)]
    return loss.detach(), unflatten(params, grads)


def family_init(spec: ArchSpec, smoke: bool = False, cfg_override=None):
    """``init(gen)`` for the arch's config (the smoke config with
    ``smoke``): parameters drawn from the ``torch.Generator`` ``gen``, on
    its device."""
    cfg = cfg_override or (spec.smoke_config if smoke else spec.config)
    if spec.family == "lm":
        return lambda gen: tf_mod.init_params(cfg, gen)
    if spec.family == "gnn":
        return lambda gen: gnn_mod.init_params(cfg, gen)
    fns = {"XDeepFMConfig": rs.xdeepfm_init, "SASRecConfig": rs.sasrec_init,
           "MINDConfig": rs.mind_init, "TwoTowerConfig": rs.twotower_init}
    fn = fns[type(cfg).__name__]
    return lambda gen: fn(cfg, gen)


def serve_fn(spec: ArchSpec, shape: ShapeSpec):
    """``fn(params, batch)`` of a recsys arch for a ``serve`` or
    ``retrieval`` shape."""
    cfg = spec.config
    if shape.kind == "serve":
        fns = {"XDeepFMConfig": lambda p, b: rs.xdeepfm_logits(cfg, p,
                                                               b["idx"]),
               "SASRecConfig": partial(rs.sasrec_serve, cfg),
               "MINDConfig": partial(rs.mind_serve, cfg),
               "TwoTowerConfig": partial(rs.twotower_serve, cfg)}
    elif shape.kind == "retrieval":
        fns = {"XDeepFMConfig": partial(rs.xdeepfm_retrieval, cfg),
               "SASRecConfig": partial(rs.sasrec_retrieval, cfg),
               "MINDConfig": partial(rs.mind_retrieval, cfg),
               "TwoTowerConfig": partial(rs.twotower_retrieval, cfg)}
    else:
        raise ValueError(f"serve_fn takes a serve or retrieval shape, not "
                         f"{shape.kind!r}")
    return fns[type(cfg).__name__]


def _gnn_cfg_for_shape(cfg, shape: ShapeSpec):
    """A GNN config whose node encoder takes the shape's ``d_feat``."""
    return replace(cfg, d_node_in=shape.dims["d_feat"])


def make_train_step(spec: ArchSpec, shape: ShapeSpec):
    """``train_step(params, opt_state, batch) -> (params', opt_state',
    metrics)``, functional: the arguments are left as they were.  With
    ``shape.n_microbatches`` > 1 the batch's leading axis is cut into that
    many equal microbatches, microbatch i its rows [i * mb, (i + 1) * mb);
    the loss is their mean.  Metrics: ``loss`` and the optimizer's
    (``grad_norm`` and ``lr``, or ``lr``), f32 tensors on the device."""
    cfg = spec.config
    if spec.family == "gnn":
        cfg = _gnn_cfg_for_shape(cfg, shape)
    loss_fn = family_loss(replace(spec, config=cfg))
    ocfg = make_optimizer(spec)[0]
    n_micro = shape.n_microbatches
    accum_dt = torch_dtype(spec.grad_accum_dtype)

    def train_step(params, opt_state, batch):
        if n_micro <= 1:
            loss, grads = value_and_grad(loss_fn, params, batch)
        else:
            acc, losses = None, []
            for i in range(n_micro):
                def rows(x):
                    mb = x.shape[0] // n_micro
                    return x[i * mb:(i + 1) * mb]
                l, g = value_and_grad(loss_fn, params, map_tree(rows, batch))
                losses.append(l)
                acc = (map_tree(lambda gg: gg.to(accum_dt), g) if acc is None
                       else map_tree(lambda a, gg: a + gg.to(a.dtype), acc, g))
                del g
            grads = map_tree(lambda a: a / n_micro, acc)
            loss = torch.stack(losses).mean()
        params, opt_state, om = _opt_update(spec, ocfg, params, grads,
                                            opt_state)
        return params, opt_state, dict(loss=loss, **om)

    return train_step


def make_serve_step(spec: ArchSpec, shape: ShapeSpec):
    """``step(params, batch)`` of an arch's serving shape: an LM's prefill
    (``batch["tokens"]``) or decode step (``batch["cache"]`` holding
    ``seq - 1`` positions, ``batch["tokens"]``; the cache is written in
    place), or a recsys arch's ``serve_fn``."""
    cfg = spec.config
    if spec.family == "lm":
        if shape.kind == "prefill":
            return lambda params, batch: tf_mod.prefill(cfg, params,
                                                        batch["tokens"])
        if shape.kind == "decode":
            cache_len = shape.dims["seq"] - 1
            return lambda params, batch: tf_mod.decode_step(
                cfg, params, batch["cache"], batch["tokens"], cache_len)
        raise ValueError(shape.kind)
    return serve_fn(spec, shape)
