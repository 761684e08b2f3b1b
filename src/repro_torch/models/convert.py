"""Carry weights from the JAX package into the port.

Each function takes a family's parameter pytree as nested dicts and lists
of numpy arrays (``jax.tree.map(np.asarray, params)``) and returns the
port's parameters on a device.  The port keeps the JAX keys, so the
conversion is a name map that checks every key and shape it expects.
JAX bfloat16 arrays come out of ``np.asarray`` as ``ml_dtypes.bfloat16``,
which ``torch.from_numpy`` refuses: they go through float32 (exact) and
back to bfloat16.  The optimizer states (``AdamState``,
``AdafactorState``) carry across the same way, so that both packages can
start a step from one state.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..optim.adafactor import AdafactorState
from ..optim.adam import AdamState
from .gnn import GNNConfig, _mlp_sizes
from .recsys import MINDConfig, SASRecConfig, TwoTowerConfig, XDeepFMConfig
from .transformer import LMConfig, check_supported


def tensor_from_numpy(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)   # a writable copy


def _take(tree: dict, keys, shapes: dict, device, where: str) -> dict:
    """``tree``'s ``keys`` as tensors, each checked against its shape."""
    extra = set(tree) - set(keys)
    missing = set(keys) - set(tree)
    if extra or missing:
        raise ValueError(f"{where}: unexpected keys {sorted(extra)}, missing "
                         f"{sorted(missing)}")
    out = {}
    for k in keys:
        t = tensor_from_numpy(tree[k], device)
        if k in shapes and tuple(t.shape) != shapes[k]:
            raise ValueError(f"{where}.{k}: shape {tuple(t.shape)}, expected "
                             f"{shapes[k]}")
        out[k] = t
    return out


def _mlp(tree: dict, sizes, device, where: str, lead=()) -> dict:
    """An MLP's ``w{i}`` / ``b{i}``, each with the leading axes ``lead``
    (``(n_layers,)`` for a stacked one)."""
    n = len(sizes) - 1
    shapes = {f"w{i}": (*lead, sizes[i], sizes[i + 1]) for i in range(n)}
    shapes.update({f"b{i}": (*lead, sizes[i + 1]) for i in range(n)})
    return _take(tree, list(shapes), shapes, device, where)


def lm_params_from_numpy(cfg: LMConfig, tree: dict, device=None) -> dict:
    """An LM's pytree (``transformer.init_params`` keys: the post-norms
    with ``post_norm``, ``moe`` in place of ``mlp`` for an MoE model, and
    ``dense`` beside it with ``dense_residual``)."""
    check_supported(cfg)
    dev = resolve_device(device)
    n, d, dh = cfg.n_layers, cfg.d_model, cfg.head_dim
    layer_shapes = {"wq": (n, d, cfg.n_heads * dh),
                    "wk": (n, d, cfg.n_kv_heads * dh),
                    "wv": (n, d, cfg.n_kv_heads * dh),
                    "wo": (n, cfg.n_heads * dh, d),
                    "ln_attn": (n, d), "ln_ffn": (n, d)}
    if cfg.post_norm:
        layer_shapes.update(ln_attn_post=(n, d), ln_ffn_post=(n, d))

    def swiglu(lead, f):
        return {"w_gate": (*lead, d, f), "w_up": (*lead, d, f),
                "w_down": (*lead, f, d)}

    subtrees = {}
    if cfg.is_moe:
        e = cfg.n_experts
        subtrees["moe"] = {"router": (n, d, e),
                           **swiglu((n, e), cfg.moe_dff or cfg.d_ff)}
        if cfg.dense_residual:
            subtrees["dense"] = swiglu((n,), cfg.dense_residual_dff
                                       or cfg.d_ff)
    else:
        subtrees["mlp"] = swiglu((n,), cfg.d_ff)
    layers = dict(tree["layers"])
    subs = {name: layers.pop(name, {}) for name in subtrees}
    out_layers = _take(layers, list(layer_shapes), layer_shapes, dev, "layers")
    for name, shapes in subtrees.items():
        out_layers[name] = _take(subs[name], list(shapes), shapes, dev,
                                 f"layers.{name}")
    top = {k: v for k, v in tree.items() if k != "layers"}
    keys = ["embed", "ln_final"] + ([] if cfg.tie_embeddings else ["unembed"])
    params = _take(top, keys, {"embed": (cfg.vocab, d), "ln_final": (d,),
                               "unembed": (d, cfg.vocab)}, dev, "params")
    params["layers"] = out_layers
    return params


def twotower_params_from_numpy(cfg: TwoTowerConfig, tree: dict,
                               device=None) -> dict:
    dev = resolve_device(device)
    fv, fd = cfg.field_vocab, cfg.field_dim
    top = {k: v for k, v in tree.items() if not k.endswith("_mlp")}
    params = _take(top, ["user_table", "item_table", "corpus"],
                   {"user_table": (cfg.n_user_fields * fv, fd),
                    "item_table": (cfg.n_item_fields * fv, fd),
                    "corpus": (cfg.n_corpus, cfg.tower_mlp[-1])}, dev, "params")
    for side, fields in (("user", cfg.n_user_fields),
                         ("item", cfg.n_item_fields)):
        params[f"{side}_mlp"] = _mlp(tree[f"{side}_mlp"],
                                     [fields * fd] + list(cfg.tower_mlp), dev,
                                     f"{side}_mlp")
    return params


def xdeepfm_params_from_numpy(cfg: XDeepFMConfig, tree: dict,
                              device=None) -> dict:
    dev = resolve_device(device)
    m, d = cfg.n_sparse, cfg.embed_dim
    top = {k: v for k, v in tree.items() if k not in ("cin", "dnn")}
    params = _take(top, ["table", "wide", "cin_out", "bias"],
                   {"table": (cfg.total_vocab, d), "wide": (cfg.total_vocab,),
                    "cin_out": (sum(cfg.cin_layers),), "bias": ()}, dev,
                   "params")
    if len(tree["cin"]) != len(cfg.cin_layers):
        raise ValueError(f"cin: {len(tree['cin'])} layers, expected "
                         f"{len(cfg.cin_layers)}")
    params["cin"], h_prev = [], m
    for i, (w, h) in enumerate(zip(tree["cin"], cfg.cin_layers)):
        t = tensor_from_numpy(w, dev)
        if tuple(t.shape) != (h_prev * m, h):
            raise ValueError(f"cin[{i}]: shape {tuple(t.shape)}, expected "
                             f"{(h_prev * m, h)}")
        params["cin"].append(t)
        h_prev = h
    params["dnn"] = _mlp(tree["dnn"], [m * d] + list(cfg.mlp_sizes) + [1],
                         dev, "dnn")
    return params


def sasrec_params_from_numpy(cfg: SASRecConfig, tree: dict,
                             device=None) -> dict:
    dev = resolve_device(device)
    d = cfg.embed_dim
    top = {k: v for k, v in tree.items() if k != "blocks"}
    params = _take(top, ["item_emb", "pos_emb", "ln_f"],
                   {"item_emb": (cfg.n_items, d), "pos_emb": (cfg.seq_len, d),
                    "ln_f": (d,)}, dev, "params")
    blocks = tree.get("blocks", [])
    if len(blocks) != cfg.n_blocks:
        raise ValueError(f"blocks: {len(blocks)}, expected {cfg.n_blocks}")
    shapes = {k: (d, d) for k in ("wq", "wk", "wv", "wo", "ffn_w1",
                                  "ffn_w2")}
    shapes.update({k: (d,) for k in ("ffn_b1", "ffn_b2", "ln1", "ln2")})
    params["blocks"] = [_take(b, list(shapes), shapes, dev, f"blocks[{i}]")
                        for i, b in enumerate(blocks)]
    return params


def mind_params_from_numpy(cfg: MINDConfig, tree: dict, device=None) -> dict:
    dev = resolve_device(device)
    d = cfg.embed_dim
    top = {k: v for k, v in tree.items() if k != "dnn"}
    params = _take(top, ["item_emb", "S", "b_init"],
                   {"item_emb": (cfg.n_items, d), "S": (d, d),
                    "b_init": (cfg.n_interests, cfg.seq_len)}, dev, "params")
    params["dnn"] = _mlp(tree.get("dnn", {}), [d, d, d], dev, "dnn")
    return params


def gnn_params_from_numpy(cfg: GNNConfig, tree: dict, device=None) -> dict:
    """MeshGraphNet's tree: the encoders and the decoder, and the stacked
    processor MLPs ``edge_mlp`` / ``node_mlp`` (leading ``n_layers``)."""
    dev = resolve_device(device)
    h = cfg.d_hidden
    mlps = {"node_enc": (cfg.d_node_in, h, ()),
            "edge_enc": (cfg.d_edge_in, h, ()),
            "edge_mlp": (3 * h, h, (cfg.n_layers,)),
            "node_mlp": (2 * h, h, (cfg.n_layers,)),
            "decoder": (h, cfg.d_out, ())}
    extra = set(tree) - set(mlps)
    if extra:
        raise ValueError(f"params: unexpected keys {sorted(extra)}")
    return {name: _mlp(tree.get(name, {}), _mlp_sizes(cfg, d_in, d_out), dev,
                       name, lead)
            for name, (d_in, d_out, lead) in mlps.items()}


def _tree_from_numpy(tree, device):
    """Nested dicts and lists of numpy arrays -> the same of tensors."""
    if isinstance(tree, dict):
        return {k: _tree_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_from_numpy(v, device) for v in tree]
    return tensor_from_numpy(tree, device)


def _step_from_numpy(step, device) -> torch.Tensor:
    return torch.tensor(int(np.asarray(step)), dtype=torch.int32,
                        device=device)


def adam_state_from_numpy(state, device=None) -> AdamState:
    """The JAX package's ``AdamState`` as numpy leaves
    (``jax.tree.map(np.asarray, state)``): ``step``, ``mu``, ``nu``."""
    dev = resolve_device(device)
    return AdamState(step=_step_from_numpy(state.step, dev),
                     mu=_tree_from_numpy(state.mu, dev),
                     nu=_tree_from_numpy(state.nu, dev))


def adafactor_state_from_numpy(state, device=None) -> AdafactorState:
    """The JAX package's ``AdafactorState`` as numpy leaves: ``step``,
    ``mu`` (bf16 by default), ``vr``, ``vc``."""
    dev = resolve_device(device)
    return AdafactorState(step=_step_from_numpy(state.step, dev),
                          mu=_tree_from_numpy(state.mu, dev),
                          vr=_tree_from_numpy(state.vr, dev),
                          vc=_tree_from_numpy(state.vc, dev))
