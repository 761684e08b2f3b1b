"""Step factories of the ported archs: per-family init, losses, serving
functions and serve steps, and the training step.

``make_train_step`` is the JAX package's large-scale schedule on one
device: microbatched gradient accumulation (a Python loop over rows
``[i * mb, (i + 1) * mb)`` of the batch, the gradients summed in the
arch's ``grad_accum_dtype`` and divided by the microbatch count), remat
inside the layers (``lm_loss`` and ``gnn_loss`` checkpoint each layer),
the sequence-chunked CE, and AdamW (f32 moments) or Adafactor (factored,
bf16 first moment: arctic).  Gradients are ``torch.autograd.grad`` of the
loss over the flattened parameter leaves.

``build_bundle`` gives the dry run (``launch/dryrun.py``) each (arch x
shape x mesh) cell as the JAX package's does: the step function, its
abstract arguments (``TensorSpec`` trees from ``abstract_state``, nothing
allocated), the partition specs of every argument and output from the
rules of ``launch/shardings.py``, and the arguments a caller may donate.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, replace
from functools import partial
from typing import Any, Callable

import torch

from ..configs.base import ArchSpec, ShapeSpec, TensorSpec
from ..models import gnn as gnn_mod
from ..models import recsys as rs
from ..models import transformer as tf_mod
from ..models.layers import torch_dtype
from ..optim.adafactor import (AdafactorConfig, AdafactorState,
                               adafactor_update, init_adafactor)
from ..optim.adam import AdamConfig, AdamState, adam_update, init_adam
from ..tree import leaves, map_tree, unflatten
from . import shardings as sh
from .shardings import P


@dataclass
class StepBundle:
    """A cell's step: ``fn(*args)``, its abstract arguments, one partition
    spec tree an argument (``in_specs``) and for the outputs
    (``out_specs``, None where the layout is the step's own), on ``mesh``;
    ``config`` and ``shape`` as the step runs them (the mesh fields set,
    the microbatch count cut)."""
    name: str
    fn: Callable
    args: tuple                 # abstract arg trees (TensorSpec)
    in_specs: tuple
    out_specs: Any
    mesh: Any
    config: Any = None
    shape: ShapeSpec | None = None
    donate_argnums: tuple = ()


def _drop_axis(spec: P, axis_from_end: int) -> P:
    parts = list(spec)
    if not parts:
        return spec
    idx = len(parts) - axis_from_end
    if 0 <= idx < len(parts):
        parts.pop(idx)
    return P(*parts)


def opt_specs_for(optimizer: str, param_specs, params_abs):
    """The optimizer state's specs from the parameters': AdamW's moments
    take their parameter's; Adafactor's ``vr`` drops the last axis and
    ``vc`` the second-to-last (below 2 dims, ``vr`` keeps the spec and
    ``vc`` is P(None))."""
    is_p = lambda x: isinstance(x, P)  # noqa: E731
    if optimizer == "adamw":
        return AdamState(step=P(), mu=param_specs, nu=param_specs)
    specs = leaves(param_specs, is_leaf=is_p)
    shapes = [a.shape for a in leaves(params_abs)]
    vr = [_drop_axis(s_, 1) if len(a) >= 2 else s_
          for s_, a in zip(specs, shapes, strict=True)]
    vc = [_drop_axis(s_, 2) if len(a) >= 2 else P(None)
          for s_, a in zip(specs, shapes, strict=True)]
    return AdafactorState(step=P(), mu=param_specs,
                          vr=unflatten(param_specs, vr, is_leaf=is_p),
                          vc=unflatten(param_specs, vc, is_leaf=is_p))


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


def _micro_rows(x, i: int, n_micro: int, batch_axes):
    """Microbatch ``i`` of a batch leaf: its rows [i * mb, (i + 1) * mb).
    A DTensor leaf with ``batch_axes`` gives each rank's own rows
    [i * mb_l, (i + 1) * mb_l) of its shard, split over the batch axes as
    the batch is, with nothing sent: slicing the global rows of a split
    batch would gather the whole batch onto every rank.  Every row lies in
    one microbatch either way, so the mean of the microbatch gradients is
    the same."""
    from ..models.layers import is_dtensor

    if batch_axes is None or not is_dtensor(x):
        mb = x.shape[0] // n_micro
        return x[i * mb:(i + 1) * mb]
    from torch.distributed.tensor import DTensor, Shard

    mesh = x.device_mesh
    names = sh.mesh_axis_names(mesh)
    want = tuple(Shard(0) if names[d] in batch_axes else p
                 for d, p in enumerate(x.placements))
    x = x.redistribute(mesh, want)
    local = x.to_local()
    mb = local.shape[0] // n_micro
    part = local[i * mb:(i + 1) * mb]
    shape = torch.Size((x.shape[0] // n_micro, *x.shape[1:]))
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(part, mesh, want, run_check=False, shape=shape,
                              stride=stride)


def make_train_step(spec: ArchSpec, shape: ShapeSpec,
                    batch_axes: tuple | None = None):
    """``train_step(params, opt_state, batch) -> (params', opt_state',
    metrics)``, functional: the arguments are left as they were.  With
    ``shape.n_microbatches`` > 1 the batch's leading axis is cut into that
    many equal microbatches, microbatch i its rows [i * mb, (i + 1) * mb);
    the loss is their mean.  ``batch_axes``: the mesh axes a DTensor
    batch is split over; each microbatch is then cut from every rank's
    own rows and stays split over them (``_micro_rows``).  Metrics:
    ``loss`` and the optimizer's (``grad_norm`` and ``lr``, or ``lr``),
    f32 tensors on the device."""
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
                micro = map_tree(
                    lambda x: _micro_rows(x, i, n_micro, batch_axes), batch)
                l, g = value_and_grad(loss_fn, params, micro)
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


# ------------------------------------------------------------ full bundles
def _spec_of(x) -> TensorSpec:
    return TensorSpec(tuple(x.shape), x.dtype)


def abstract_state(spec: ArchSpec, with_opt: bool, cfg_override=None):
    """The parameter (and optimizer) trees as ``TensorSpec`` leaves: the
    arch's init run under ``FakeTensorMode``, so nothing is allocated."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        params = family_init(spec, cfg_override=cfg_override)(
            torch.Generator())
        opt = (_init_opt(spec, make_optimizer(spec)[0], params) if with_opt
               else None)
    params_abs = map_tree(_spec_of, params)
    return params_abs, (None if opt is None else map_tree(_spec_of, opt))


def _batch_shards(mesh) -> int:
    shape = sh.mesh_shape(mesh)
    n = 1
    for a in sh.batch_axes(mesh):
        n *= shape[a]
    return n


def effective_config(spec: ArchSpec, shape: ShapeSpec, mesh):
    """The arch's config as a cell on ``mesh`` runs it: a GNN's node
    encoder takes the shape's ``d_feat``; an LM gets the mesh fields (the
    activation layout, ``REPRO_ACT_SHARDING`` "2d" by default; the
    sequence-parallel core where the q heads do not divide the model axis,
    outside decode; the expert-parallel MoE dispatch)."""
    cfg = spec.config
    if spec.family == "gnn":
        return _gnn_cfg_for_shape(cfg, shape)
    if spec.family != "lm":
        return cfg
    bd = sh.batch_axes(mesh)
    model = sh.mesh_shape(mesh)["model"]
    act_2d = os.environ.get("REPRO_ACT_SHARDING", "2d") == "2d"
    return replace(
        cfg, act_batch_axes=bd if shape.kind != "decode" else None,
        act_model_axis="model" if act_2d and cfg.d_model % model == 0
        else None,
        attn_seq_parallel=(cfg.n_heads % model != 0
                           and shape.kind != "decode"),
        **(dict(moe_batch_axes=bd, moe_expert_axis="model",
                moe_fsdp_axis="data" if spec.fsdp else None,
                moe_expert_parallel=model) if cfg.is_moe else {}))


def build_bundle(spec: ArchSpec, shape_name: str, mesh) -> StepBundle:
    """The cell (``spec``, ``shape_name``) on ``mesh`` (a ``DeviceMesh`` or
    an ``AbstractMesh``), as the JAX package's ``build_bundle``."""
    shape = spec.shapes[shape_name]
    cfg_eff = effective_config(spec, shape, mesh)
    spec = replace(spec, config=cfg_eff)
    if shape.kind == "train" and shape.n_microbatches > 1:
        # keep >= 1 example per batch shard per microbatch
        shards = _batch_shards(mesh)
        n_eff = max(1, min(shape.n_microbatches,
                           shape.dims["batch"] // shards))
        while shape.dims["batch"] % (n_eff * shards) and n_eff > 1:
            n_eff -= 1
        shape = replace(shape, n_microbatches=n_eff)
    inputs = spec.inputs(cfg_eff, shape)

    param_rule = sh.PARAM_RULES[spec.family](cfg_eff, spec.fsdp, mesh)
    batch_rule = {"lm": sh.lm_batch_spec, "gnn": sh.gnn_batch_spec,
                  "recsys": sh.recsys_batch_spec}[spec.family](
        mesh, shape, cfg_eff)
    batch_specs = sh.tree_specs(inputs, batch_rule)

    if shape.kind == "train":
        params_abs, opt_abs = abstract_state(spec, with_opt=True,
                                             cfg_override=cfg_eff)
        param_specs = sh.tree_specs(params_abs, param_rule)
        opt_specs = opt_specs_for(spec.optimizer, param_specs, params_abs)
        return StepBundle(
            name=f"{spec.id}:{shape_name}:train",
            fn=make_train_step(spec, shape,
                               batch_axes=sh.batch_axes(mesh)),
            args=(params_abs, opt_abs, inputs),
            in_specs=(param_specs, opt_specs, batch_specs),
            out_specs=(param_specs, opt_specs, None), mesh=mesh,
            config=cfg_eff, shape=shape, donate_argnums=(0, 1))

    params_abs, _ = abstract_state(spec, with_opt=False,
                                   cfg_override=cfg_eff)
    param_specs = sh.tree_specs(params_abs, param_rule)
    if spec.family == "lm":
        out = sh.lm_out_spec(mesh, shape, cfg_eff)
        donate = (1,) if shape.kind == "decode" else ()
    else:
        out, donate = None, ()
    return StepBundle(
        name=f"{spec.id}:{shape_name}:{shape.kind}",
        fn=make_serve_step(spec, shape), args=(params_abs, inputs),
        in_specs=(param_specs, batch_specs), out_specs=out, mesh=mesh,
        config=cfg_eff, shape=shape, donate_argnums=donate)


def analysis_variant(spec: ArchSpec, shape_name: str, n_layers: int,
                     mesh=None):
    """A reduced-depth variant of the cell for cost extraction, as the JAX
    package's: ``n_layers`` layers, attention and CE in a single chunk,
    LM training at one microbatch (the batch cut by the returned scale,
    halved while it would not split over the batch axes).  None for the
    recsys family.  Returns (spec', shape', scale)."""
    shape = spec.shapes[shape_name]
    cfg = spec.config
    if spec.family == "lm":
        seq = shape.dims["seq"]
        cfg2 = replace(cfg, n_layers=n_layers, scan_layers=False,
                       q_chunk=seq, kv_chunk=seq, ce_chunk=seq)
        dims = dict(shape.dims)
        scale = 1
        if shape.kind == "train" and shape.n_microbatches > 1:
            shards = 1 if mesh is None else _batch_shards(mesh)
            scale = shape.n_microbatches
            # the analysis batch must still split over the batch axes
            while scale > 1 and (dims["batch"] // scale) % shards:
                scale //= 2
            dims["batch"] = dims["batch"] // scale
        shape2 = replace(shape, dims=dims, n_microbatches=1)
    elif spec.family == "gnn":
        cfg2 = replace(cfg, n_layers=n_layers, scan_layers=False)
        shape2, scale = shape, 1
    else:
        return None
    spec2 = replace(spec, config=cfg2, shapes={**spec.shapes,
                                               shape_name: shape2})
    return spec2, shape2, scale
