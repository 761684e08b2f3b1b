"""Partition-spec rules per architecture family, and their placements on a
``DeviceMesh``.

Mesh axes: ('data', 'model') single-pod, ('pod', 'data', 'model')
multi-pod.  Conventions, as the JAX package's:

  LM    : DP/FSDP over pod x data; TP over model on the fused head dim and
          d_ff; EP over model for MoE expert blocks; vocab over model for
          embed/unembed; KV caches shard batch over data and sequence over
          model (decode_32k) or sequence over data x model (long_500k).
  GNN   : edge arrays over ALL axes (edge parallelism); nodes/params
          replicated; segment_sum partials combined by an all-reduce.
  RecSys: embedding-table rows over model (huge_embedding axis); batch
          over pod x data; retrieval candidates over data x model.

Rules are path-regex based so optimizer-state trees (which mirror param
trees) inherit specs automatically.  A spec is the port's own
``PartitionSpec`` (``P``), a tuple with one entry per tensor dim: ``None``,
a mesh axis name, or a tuple of names (one dim over several axes, major
first).  ``to_placements`` turns it into one DTensor ``Placement`` a mesh
dim; ``tree_shardings`` and ``specs_to_shardings`` give a ``MeshPlacements``
(the mesh and those placements) in place of the JAX package's
``NamedSharding``.

The rules read only a mesh's axis names and sizes: a ``DeviceMesh``, or any
object with ``axis_names`` and a ``shape`` dict (``AbstractMesh``, which
needs no process group).
"""
from __future__ import annotations

import re
from dataclasses import dataclass

from ..tree import leaves, leaves_with_paths, unflatten


class PartitionSpec(tuple):
    """One entry a tensor dim: None, an axis name or a tuple of names (a
    tuple of one name is that name, as in JAX)."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


@dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes with no devices behind them."""
    shape: dict
    axis_names: tuple


@dataclass(frozen=True)
class MeshPlacements:
    """Where a tensor lives: a ``DeviceMesh`` and one placement a mesh
    dim (the port's ``NamedSharding``)."""
    mesh: object
    placements: tuple


def mesh_axis_names(mesh) -> tuple:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def mesh_shape(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` or an ``AbstractMesh``."""
    if isinstance(mesh.shape, dict):
        return dict(mesh.shape)
    return dict(zip(mesh_axis_names(mesh), mesh.shape))


def batch_axes(mesh):
    return (("pod", "data") if "pod" in mesh_axis_names(mesh) else ("data",))


def edge_axes(mesh):
    return mesh_axis_names(mesh)  # all axes combined


def _dim(mesh, name):
    return mesh_shape(mesh)[name]


# --------------------------------------------------------------------- LM
def lm_param_spec(cfg, fsdp: bool, mesh):
    """Returns fn(path_str, shape) -> PartitionSpec."""
    m = _dim(mesh, "model")
    fs = "data" if fsdp else None

    def spec(path: str, shape) -> P:
        nd = len(shape)
        if "embed" in path or "unembed" in path:
            # (V, D) / (D, V): vocab over model
            if path.endswith("embed") and shape[0] == cfg.vocab:
                return P("model", *([None] * (nd - 1)))
            return P(*([None] * (nd - 1)), "model")
        if re.search(r"\bmoe/(w_gate|w_up)$", path):
            return P(None, "model", fs, None)      # (L, E, D, F)
        if re.search(r"\bmoe/w_down$", path):
            return P(None, "model", None, fs)      # (L, E, F, D)
        if re.search(r"\bmoe/router$", path):
            return P(None, fs, None)               # (L, D, E)
        if re.search(r"(mlp|dense)/(w_gate|w_up)$", path):
            return P(None, fs, "model") if shape[-1] % m == 0 \
                else P(None, fs, None)             # (L, D, F)
        if re.search(r"(mlp|dense)/w_down$", path):
            return P(None, "model", fs) if shape[-2] % m == 0 \
                else P(None, None, fs)             # (L, F, D)
        # Attention TP sharding is head-granular: shard q-side iff
        # n_heads % model == 0, kv-side iff n_kv_heads % model == 0.
        # Otherwise the projections fall back to ROW-PARALLEL (the input
        # d_model dim over 'model', one reduction a projection) and the
        # attention core runs data-parallel (arctic: 56 q-heads, 8
        # kv-heads against model=16).
        q_ok = getattr(cfg, "n_heads", 0) % m == 0
        kv_ok = getattr(cfg, "n_kv_heads", 0) % m == 0
        if re.search(r"w[q]$", path):
            return P(None, fs, "model") if q_ok else P(None, "model", fs)
        if re.search(r"w[kv]$", path):
            return P(None, fs, "model") if kv_ok else P(None, "model", fs)
        if path.endswith("wo"):
            return P(None, "model", fs) if q_ok \
                else P(None, fs, "model")          # (L, H*Dh, D)
        return P(*([None] * nd))                   # norms and the rest

    return spec


def lm_batch_spec(mesh, shape_spec, cfg):
    """Rule (path, shape) -> PartitionSpec for LM step inputs."""
    bd = batch_axes(mesh)
    seq_policy = shape_spec.decode_policy == "seq"

    def rule(path: str, shape) -> P:
        if "cache" in path:                        # (L, B, S, Hkv, Dh)
            if seq_policy:
                return P(None, None, mesh_axis_names(mesh), None, None)
            return P(None, bd, "model", None, None)
        if path.endswith("tokens") and len(shape) == 1:   # decode tokens
            return P(None) if seq_policy else P(bd)
        return P(bd, *([None] * (len(shape) - 1)))

    return rule


def lm_out_spec(mesh, shape_spec, cfg):
    """Output specs: prefill -> (cache, logits); decode ->
    (cache, next_tokens, logits)."""
    bd = batch_axes(mesh)
    seq_policy = shape_spec.decode_policy == "seq"
    if shape_spec.kind == "prefill":
        cache = P(None, bd, "model", None, None)   # (L, B, S, Hkv, Dh)
        return ({"k": cache, "v": cache}, P(bd, None))
    if shape_spec.kind == "decode":
        if seq_policy:
            cache = P(None, None, mesh_axis_names(mesh), None, None)
            return ({"k": cache, "v": cache}, P(None), P(None, "model"))
        cache = P(None, bd, "model", None, None)
        return ({"k": cache, "v": cache}, P(bd), P(bd, "model"))
    raise ValueError(shape_spec.kind)


# -------------------------------------------------------------------- GNN
def gnn_batch_spec(mesh, shape_spec, cfg):
    e = edge_axes(mesh)

    def rule(path: str, shape) -> P:
        if any(k in path for k in ("edges", "senders", "receivers",
                                   "edge_mask")):
            return P(e, *([None] * (len(shape) - 1)))
        return P(*([None] * len(shape)))           # nodes/targets replicated

    return rule


def gnn_param_spec(cfg, fsdp, mesh):
    def spec(path, shape):
        return P(*([None] * len(shape)))
    return spec


# ----------------------------------------------------------------- RecSys
# Embedding tables below this size are REPLICATED per device: sharding a
# 200 MB table over 'model' turns every lookup into a dense f32 all-reduce
# of the gathered activations.  Move the small structure to the data,
# never the data to the structure.
REPLICATE_TABLE_BYTES = 512 << 20


def recsys_param_spec(cfg, fsdp, mesh):
    def spec(path, shape):
        nd = len(shape)
        n_bytes = 4
        for s in shape:
            n_bytes *= s
        huge = nd >= 1 and shape[0] >= 10000 \
            and n_bytes > REPLICATE_TABLE_BYTES
        if ("table" in path or "item_emb" in path or "wide" in path
                or "corpus" in path) and huge:
            return P("model", *([None] * (nd - 1)))
        return P(*([None] * nd))

    return spec


def recsys_batch_spec(mesh, shape_spec, cfg):
    bd = batch_axes(mesh)
    cand_ax = mesh_axis_names(mesh)
    kind = shape_spec.kind

    def rule(path: str, shape) -> P:
        if kind == "retrieval":
            if path.endswith("cand"):
                return P(cand_ax, *([None] * (len(shape) - 1)))
            return P(*([None] * len(shape)))     # single query replicated
        return P(bd, *([None] * (len(shape) - 1)))

    return rule


# ------------------------------------------------------------- tree utils
def path_str(path) -> str:
    """A ``tree.leaves_with_paths`` path as '/'-joined keys."""
    return "/".join(str(p) for p in path)


def tree_specs(tree, rule):
    """Map a (path, shape) rule over a tree of tensors (or anything with a
    ``shape``)."""
    return unflatten(tree, [rule(path_str(p), tuple(x.shape))
                            for p, x in leaves_with_paths(tree)])


def spec_leaves(spec_tree) -> list:
    """The specs of a spec tree, in ``tree.leaves`` order."""
    return leaves(spec_tree, is_leaf=lambda x: isinstance(x, P))


# ------------------------------------------------------------- placements
def to_placements(spec, mesh) -> tuple:
    """One DTensor placement a mesh dim: ``Shard(d)`` where tensor dim d
    names that axis, else ``Replicate()``.  A dim over several axes is
    split major to minor in the mesh's axis order, as DTensor splits it
    (the JAX package's order for a spec that names them in that order)."""
    from torch.distributed.tensor import Replicate, Shard

    names = mesh_axis_names(mesh)
    where = {}
    for d, entry in enumerate(spec):
        axes = entry if isinstance(entry, tuple) else (entry,)
        axes = tuple(a for a in axes if a is not None)
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"{spec}: dim {d} names {axes} against the "
                             f"mesh's order {names}; DTensor splits a dim "
                             f"major to minor in mesh order")
        for a in axes:
            if a in where:
                raise ValueError(f"{spec}: axis {a!r} shards two dims")
            where[a] = d
    return tuple(Shard(where[n]) if n in where else Replicate()
                 for n in names)


def _sharding(mesh, spec) -> MeshPlacements:
    return MeshPlacements(mesh, to_placements(spec, mesh))


def tree_shardings(tree, rule, mesh):
    """A ``MeshPlacements`` for each leaf of ``tree`` from a (path, shape)
    rule."""
    return unflatten(tree, [_sharding(mesh, rule(path_str(p),
                                                 tuple(x.shape)))
                            for p, x in leaves_with_paths(tree)])


def specs_to_shardings(spec_tree, mesh):
    """A ``MeshPlacements`` for each spec of a spec tree."""
    return unflatten(spec_tree, [_sharding(mesh, s)
                                 for s in spec_leaves(spec_tree)],
                     is_leaf=lambda x: isinstance(x, P))


def place(x, sharding: MeshPlacements):
    """A DTensor of the full tensor (or numpy array) ``x`` on the
    sharding's mesh: each rank keeps its own slice of the ``x`` it holds
    (every rank holds the same ``x``; nothing is sent)."""
    import numpy as np
    import torch
    from torch.distributed.tensor import DTensor, distribute_tensor

    if isinstance(x, DTensor):
        x = x.full_tensor()
    elif not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x))
    return distribute_tensor(x.detach(), sharding.mesh, sharding.placements,
                             src_data_rank=None)


def distribute_tree(tree, spec_tree, mesh):
    """Each leaf of ``tree`` placed on ``mesh`` by the spec beside it."""
    shardings = leaves(specs_to_shardings(spec_tree, mesh))
    return unflatten(tree, [place(x, s) for x, s in
                            zip(leaves(tree), shardings, strict=True)])


PARAM_RULES = dict(lm=lm_param_spec, gnn=gnn_param_spec,
                   recsys=recsys_param_spec)
