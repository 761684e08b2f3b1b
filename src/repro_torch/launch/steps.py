"""Per-family init and serving functions for the ported archs.

Not yet ported: ``make_serve_step``, ``make_train_step``, the optimizers and
everything mesh-related (the dry run)."""
from __future__ import annotations

from functools import partial

from ..configs.base import ArchSpec, ShapeSpec
from ..models import recsys as rs
from ..models import transformer as tf_mod


def _by_config(cfg, fns: dict):
    name = type(cfg).__name__
    if name not in fns:
        raise NotImplementedError(f"{name} is not yet ported")
    return fns[name]


def family_init(spec: ArchSpec, smoke: bool = False, cfg_override=None):
    """``init(gen)`` for the arch's config (the smoke config with
    ``smoke``): parameters drawn from the ``torch.Generator`` ``gen``, on
    its device."""
    cfg = cfg_override or (spec.smoke_config if smoke else spec.config)
    if spec.family == "lm":
        return lambda gen: tf_mod.init_params(cfg, gen)
    fn = _by_config(cfg, {"XDeepFMConfig": rs.xdeepfm_init,
                          "TwoTowerConfig": rs.twotower_init})
    return lambda gen: fn(cfg, gen)


def serve_fn(spec: ArchSpec, shape: ShapeSpec):
    """``fn(params, batch)`` of a recsys arch for a ``serve`` or
    ``retrieval`` shape."""
    cfg = spec.config
    if shape.kind == "serve":
        fns = {"XDeepFMConfig": lambda p, b: rs.xdeepfm_logits(cfg, p,
                                                               b["idx"]),
               "TwoTowerConfig": partial(rs.twotower_serve, cfg)}
    elif shape.kind == "retrieval":
        fns = {"XDeepFMConfig": partial(rs.xdeepfm_retrieval, cfg),
               "TwoTowerConfig": partial(rs.twotower_retrieval, cfg)}
    else:
        raise ValueError(f"serve_fn takes a serve or retrieval shape, not "
                         f"{shape.kind!r}")
    return _by_config(cfg, fns)
