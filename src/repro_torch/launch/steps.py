"""Per-family init, serving functions and serve steps for the ported archs.

Not yet ported: ``make_train_step``, the optimizers and everything
mesh-related (the dry run)."""
from __future__ import annotations

from dataclasses import replace
from functools import partial

from ..configs.base import ArchSpec, ShapeSpec
from ..models import gnn as gnn_mod
from ..models import recsys as rs
from ..models import transformer as tf_mod


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
