"""The LM-family transformer: llama3-8b, gemma2-9b (local and global
layers alternating, attention and final logit soft-capping, sandwich
norms), olmo-1b (non-parametric LayerNorm), phi3.5-moe and arctic-480b
(MoE FFN; arctic adds a dense FFN in parallel).

Parameters are the JAX package's pytree as a dict of tensors: per-layer
weights stacked on a leading (L, ...) axis, run by a Python loop over the
layers.  Serving is ``prefill`` (blockwise attention, returns the per-layer
K/V) and ``decode_step`` (one token; ``flash_decode`` on the card, with
the layer's window and soft-cap, the KV cache updated in place).
Training is ``lm_loss``: ``forward`` with each layer under
``torch.utils.checkpoint`` (``remat``, the JAX package's
``jax.checkpoint`` of the layer body) and the sequence-chunked CE, whose
logits exist for one ``ce_chunk`` of positions at a time (each chunk is
recomputed in the backward pass too).

The mesh fields run over ``launch.mesh.current_mesh()`` (``use_mesh``):
``moe_expert_axis`` sends the FFN through the expert-parallel
``moe_ffn_sharded``; ``attn_seq_parallel`` with both act axes sends prefill
and training attention through ``seq_parallel_attention``.  With plain
tensors the residual stream is a global tensor, the same on every rank;
with DTensor parameters and batch (the dry run's) it is a DTensor, and
``_constrain_act`` pins its layout as the JAX package's activation hints
do, the attention core runs on each rank's batch and head shards
(``attention.sharded_attention``) and a sequence-split KV cache decodes
split (``attention.sharded_decode``).  Decode never takes the
sequence-parallel core.  The JAX package's
model-sharded norm (``_norm_sharded``) computes the same norm from per-shard
partial sums; here the norm is computed on the whole d_model.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from functools import partial

import torch
from torch._subclasses.fake_tensor import is_fake
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from .attention import attention_block
from .layers import (batch_split, dense_init, embed_init, is_dtensor,
                     layer_norm_nonparam, normal, product, rms_norm, rows,
                     softcap, torch_dtype, whole_last_dim)
from .moe import moe_ffn, moe_ffn_sharded


@dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int | None = None          # default d_model // n_heads
    rope_theta: float = 10000.0
    norm: str = "rms"                  # "rms" | "nonparam"
    post_norm: bool = False            # sandwich norms
    attn_softcap: float | None = None
    final_softcap: float | None = None
    sliding_window: int | None = None  # window for local layers
    local_global_period: int = 0       # 0: all global; 2: alternate
    tie_embeddings: bool = True
    embed_scale: bool = False          # x *= sqrt(d_model)
    # MoE
    n_experts: int = 0
    top_k: int = 2
    moe_dff: int | None = None
    dense_residual: bool = False
    dense_residual_dff: int | None = None
    capacity_factor: float = 1.25
    # numerics / scheduling
    dtype: str = "bfloat16"
    q_chunk: int = 512
    kv_chunk: int = 1024
    ce_chunk: int = 512
    aux_loss_weight: float = 0.01
    scan_layers: bool = True
    # mesh fields of the JAX package (sharded MoE dispatch, 2D activation
    # sharding, sequence-parallel attention)
    moe_batch_axes: tuple | None = None
    moe_expert_axis: str | None = None
    moe_fsdp_axis: str | None = None
    moe_expert_parallel: int | None = None
    act_batch_axes: tuple | None = None
    act_model_axis: str | None = None
    attn_seq_parallel: bool = False

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    def layer_is_local(self, i: int) -> bool:
        return (self.local_global_period > 0
                and i % self.local_global_period == 0
                and self.sliding_window is not None)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def param_count(self) -> int:
        """Analytic N (all params)."""
        return self._count(self.n_experts)

    def active_param_count(self) -> int:
        """N_active: with MoE, only the ``top_k`` routed experts count."""
        return self._count(self.top_k) if self.is_moe else self.param_count()

    def _count(self, experts: int) -> int:
        """Params with ``experts`` experts' FFNs a layer (an MoE model)."""
        d, dh = self.d_model, self.head_dim
        attn = d * (self.n_heads + 2 * self.n_kv_heads) * dh \
            + self.n_heads * dh * d
        if self.is_moe:
            ffn = experts * 3 * d * (self.moe_dff or self.d_ff) \
                + d * self.n_experts
            if self.dense_residual:
                ffn += 3 * d * (self.dense_residual_dff or self.d_ff)
        else:
            ffn = 3 * d * self.d_ff
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        return self.n_layers * (attn + ffn) + emb


# --------------------------------------------------------------------- init
def init_params(cfg: LMConfig, gen: torch.Generator) -> dict:
    """Stacked-layer parameters on the generator's device, drawn from it:
    N(0, 1/fan_in) projections, N(0, 1) embeddings, zero norm weights."""
    dt, dev = cfg.compute_dtype, gen.device
    d, dh, n = cfg.d_model, cfg.head_dim, cfg.n_layers

    def stack(shape, fan_in, experts=None):
        lead = (n,) if experts is None else (n, experts)
        out = torch.empty((*lead, *shape), dtype=dt, device=dev)
        if is_fake(out):              # shapes only (``abstract_state``)
            return out
        # one layer's (or one expert's) f32 draw at a time: one arctic
        # layer's w_gate drawn whole in f32 would be 17.8 GB
        for i in itertools.product(*map(range, lead)):
            out[i] = normal(gen, shape, fan_in ** -0.5, dt)
        return out

    def zeros():
        return torch.zeros((n, d), dtype=dt, device=dev)

    def swiglu(f, experts=None):
        return {"w_gate": stack((d, f), d, experts),
                "w_up": stack((d, f), d, experts),
                "w_down": stack((f, d), f, experts)}

    layers = {
        "wq": stack((d, cfg.n_heads * dh), d),
        "wk": stack((d, cfg.n_kv_heads * dh), d),
        "wv": stack((d, cfg.n_kv_heads * dh), d),
        "wo": stack((cfg.n_heads * dh, d), cfg.n_heads * dh),
        "ln_attn": zeros(), "ln_ffn": zeros(),
    }
    if cfg.post_norm:
        layers["ln_attn_post"], layers["ln_ffn_post"] = zeros(), zeros()
    if cfg.is_moe:
        layers["moe"] = {"router": stack((d, cfg.n_experts), d),
                         **swiglu(cfg.moe_dff or cfg.d_ff, cfg.n_experts)}
        if cfg.dense_residual:
            layers["dense"] = swiglu(cfg.dense_residual_dff or cfg.d_ff)
    else:
        layers["mlp"] = swiglu(cfg.d_ff)
    params = {"embed": embed_init(gen, cfg.vocab, d, dt), "layers": layers,
              "ln_final": torch.zeros(d, dtype=dt, device=dev)}
    if not cfg.tie_embeddings:
        params["unembed"] = dense_init(gen, d, cfg.vocab, dt)
    return params


# ------------------------------------------------------------------ forward
def _norm(cfg: LMConfig, x: torch.Tensor, w: torch.Tensor | None):
    x = batch_split(x)      # a DTensor's d_model gathered for the norm
    if cfg.norm == "nonparam":
        return layer_norm_nonparam(x)
    return rms_norm(x, w)


def _swiglu(x: torch.Tensor, w: dict) -> torch.Tensor:
    h = torch.nn.functional.silu(product(x, w["w_gate"])) \
        * product(x, w["w_up"])
    return product(h, w["w_down"])


def _ffn(cfg: LMConfig, x: torch.Tensor, lw: dict):
    """The FFN sub-layer: (y, MoE aux loss: an f32 scalar tensor, 0.0 for a
    dense layer).  With ``moe_expert_axis`` the MoE runs expert-parallel
    over the current mesh."""
    if not cfg.is_moe:
        return _swiglu(x, lw["mlp"]), 0.0
    b, s, d = x.shape
    kw = dict(n_experts=cfg.n_experts, top_k=cfg.top_k,
              capacity_factor=cfg.capacity_factor)
    if cfg.moe_expert_axis is not None:
        y, aux = moe_ffn_sharded(
            x.reshape(b * s, d), lw["moe"],
            batch_axes=cfg.moe_batch_axes or ("data",),
            expert_axis=cfg.moe_expert_axis, fsdp_axis=cfg.moe_fsdp_axis,
            expert_parallel=cfg.moe_expert_parallel, **kw)
    else:
        y, aux = moe_ffn(x.reshape(b * s, d), lw["moe"], **kw)
    y = y.reshape(b, s, d)
    if cfg.dense_residual:
        y = y + _swiglu(x, lw["dense"])
    return y, aux


def _constrain_act(cfg: LMConfig, x: torch.Tensor) -> torch.Tensor:
    """A DTensor residual stream laid out as the JAX package pins it: the
    batch over ``act_batch_axes``, d_model over ``act_model_axis``, the
    rest whole.  A plain tensor, or a config without the act axes, is left
    as it is (it changes no value)."""
    if not cfg.act_batch_axes or not is_dtensor(x):
        return x
    from ..launch.shardings import P, to_placements

    spec = P(cfg.act_batch_axes, *([None] * (x.dim() - 2)),
             cfg.act_model_axis)
    want = to_placements(spec, x.device_mesh)
    return x if tuple(x.placements) == want else x.redistribute(
        x.device_mesh, want)


def _layer_weights(params: dict, i: int) -> dict:
    """Layer i's slice of the stacked weights."""
    lw = params["layers"]
    return {k: ({kk: vv[i] for kk, vv in v.items()} if isinstance(v, dict)
                else v[i]) for k, v in lw.items()}


def layer_window(cfg: LMConfig, i: int) -> int | None:
    """The attention window of layer ``i`` (None: the whole cache)."""
    if cfg.local_global_period == 0 or cfg.layer_is_local(i):
        return cfg.sliding_window
    return None


def _layer(cfg: LMConfig, x: torch.Tensor, lw: dict, i: int, *,
           positions=None, kv_cache=None, cache_len=None):
    """Block ``i``: with local/global alternation a local layer attends
    within ``cfg.sliding_window`` and a global one over the whole cache (the
    JAX package's window of 1 << 30 masks nothing); without it every layer
    takes the window.  With ``attn_seq_parallel`` and both act axes,
    prefill attention is sequence-parallel.  Returns (x', new_kv, MoE aux
    loss)."""
    window = layer_window(cfg, i)
    seq_par = None
    if cfg.attn_seq_parallel and kv_cache is None \
            and cfg.act_batch_axes and cfg.act_model_axis:
        seq_par = (cfg.act_batch_axes, cfg.act_model_axis)
    a, new_kv = attention_block(
        _norm(cfg, x, lw["ln_attn"]), lw, n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads, d_head=cfg.head_dim,
        rope_theta=cfg.rope_theta, window=window,
        attn_softcap=cfg.attn_softcap, positions=positions,
        kv_cache=kv_cache, cache_len=cache_len, q_chunk=cfg.q_chunk,
        kv_chunk=cfg.kv_chunk, seq_parallel=seq_par)
    if cfg.post_norm:
        a = _norm(cfg, a, lw["ln_attn_post"])
    x = x + a
    y, aux = _ffn(cfg, _norm(cfg, x, lw["ln_ffn"]), lw)
    if cfg.post_norm:
        y = _norm(cfg, y, lw["ln_ffn_post"])
    return x + y, new_kv, aux


def _embed(cfg: LMConfig, params: dict, tokens: torch.Tensor):
    x = rows(params["embed"], tokens)
    if cfg.embed_scale:
        x = (x.to(torch.float32) * (cfg.d_model ** 0.5)).to(x.dtype)
    return x


def forward(cfg: LMConfig, params: dict, tokens: torch.Tensor, *,
            positions=None, return_kv: bool = False, remat: bool = True):
    """tokens (B, S) -> final hidden (B, S, D), the MoE aux loss summed over
    the layers (an f32 scalar, 0 for a dense model) and, with
    ``return_kv``, the stacked (L, B, S, Hkv, Dh) K and V for the cache.
    With ``remat`` and gradients on, each layer keeps only its input for
    the backward pass and is run again there."""
    x = _constrain_act(cfg, _embed(cfg, params, tokens))
    aux = 0.0
    ks, vs = [], []
    for i in range(cfg.n_layers):
        layer = partial(_layer, cfg, i=i, positions=positions)
        lw = _layer_weights(params, i)
        if remat and torch.is_grad_enabled():
            x, (k, v), a = checkpoint(layer, x, lw, use_reentrant=False,
                                      preserve_rng_state=False)
        else:
            x, (k, v), a = layer(x, lw)
        x = _constrain_act(cfg, x)
        aux = aux + a
        if return_kv:
            ks.append(k)
            vs.append(v)
    x = _norm(cfg, x, params["ln_final"])
    aux = torch.as_tensor(aux, dtype=torch.float32, device=x.device)
    return x, aux, ((torch.stack(ks), torch.stack(vs)) if return_kv
                    else None)


def _unembed(cfg: LMConfig, params: dict, h: torch.Tensor) -> torch.Tensor:
    w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    return softcap(product(h, w), cfg.final_softcap)


def _ce_chunk(cfg: LMConfig, params: dict, h: torch.Tensor,
              labels: torch.Tensor, mask: torch.Tensor):
    """(sum of the masked NLL, sum of the mask) over one chunk of positions,
    from f32 logits."""
    logits = _unembed(cfg, params, h).to(torch.float32)
    if is_dtensor(logits):
        return _nll_sums_sharded(logits, labels, mask)
    return _nll_sums(logits, labels, mask)


def _nll_sums(logits: torch.Tensor, labels: torch.Tensor,
              mask: torch.Tensor):
    logz = torch.logsumexp(logits, -1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    m = mask.to(torch.float32)
    return ((logz - gold) * m).sum(), m.sum()


def _nll_sums_sharded(logits, labels, mask):
    """``_nll_sums`` of DTensors on each rank's rows: the vocab gathered
    (``whole_last_dim``), the rows kept split as the batch is, each rank's
    sums a Partial over the batch split.  (DTensor's own gather and its
    backward would make a whole-batch tensor of the logits' size.)"""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    logits = whole_last_dim(logits)
    mesh = logits.device_mesh
    split = tuple(p if p == Shard(0) else Replicate()
                  for p in logits.placements)
    sums = tuple(Partial() if p == Shard(0) else Replicate() for p in split)
    return local_map(_nll_sums, out_placements=(sums, sums),
                     in_placements=(split, split, split), device_mesh=mesh,
                     redistribute_inputs=True)(logits, labels, mask)


def chunked_ce_loss(cfg: LMConfig, params: dict, h: torch.Tensor,
                    labels: torch.Tensor, mask: torch.Tensor, *,
                    remat: bool = True) -> torch.Tensor:
    """Sequence-chunked CE over ``n = S // c`` chunks of ``c = min(ce_chunk,
    S)`` positions: as in the JAX package, the last ``S % c`` positions are
    left out.  With ``remat`` and gradients on, a chunk's logits are made
    again in the backward pass, so that one chunk's exist at a time."""
    s = h.shape[1]
    c = min(cfg.ce_chunk, s)
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(s // c):
        part = (h[:, i * c:(i + 1) * c], labels[:, i * c:(i + 1) * c],
                mask[:, i * c:(i + 1) * c])
        if remat and torch.is_grad_enabled():
            t, m = checkpoint(partial(_ce_chunk, cfg), params, *part,
                              use_reentrant=False, preserve_rng_state=False)
        else:
            t, m = _ce_chunk(cfg, params, *part)
        tot, cnt = tot + t, cnt + m
    return tot / cnt.clamp_min(1.0)


def lm_loss(cfg: LMConfig, params: dict, batch: dict, *, remat: bool = True):
    """batch: tokens (B, S), labels (B, S) (already shifted), mask (B, S).
    Returns (CE + aux_loss_weight * aux / n_layers, CE)."""
    h, aux, _ = forward(cfg, params, batch["tokens"], remat=remat)
    ce = chunked_ce_loss(cfg, params, h, batch["labels"], batch["mask"],
                         remat=remat)
    return ce + cfg.aux_loss_weight * aux / cfg.n_layers, ce


# ------------------------------------------------------------------ serving
def init_cache(cfg: LMConfig, batch: int, max_len: int, dtype=None,
               device=None) -> dict:
    """Zero (L, B, max_len, Hkv, Dh) K and V caches on ``device`` (``None``
    means the GPU)."""
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    kw = dict(dtype=dtype or cfg.compute_dtype, device=resolve_device(device))
    return {"k": torch.zeros(shape, **kw), "v": torch.zeros(shape, **kw)}


def prefill(cfg: LMConfig, params: dict, tokens: torch.Tensor):
    """tokens (B, S) -> (cache filled to S, last-position logits (B, V))."""
    h, _, (k, v) = forward(cfg, params, tokens, return_kv=True)
    return {"k": k, "v": v}, _unembed(cfg, params, h[:, -1:, :])[:, 0]


def decode_step(cfg: LMConfig, params: dict, cache: dict,
                tokens: torch.Tensor, cache_len: int):
    """One greedy decode step.  tokens (B,) int; cache dict of (L, B, S, Hkv,
    Dh) tensors; ``cache_len`` (an int) valid positions.  The new token's
    K/V is written into ``cache`` in place, at ``cache_len``.  Returns
    (cache, next tokens (B,) int32, f32 logits (B, V))."""
    x = _embed(cfg, params, tokens[:, None])
    for i in range(cfg.n_layers):
        x, _, _ = _layer(cfg, x, _layer_weights(params, i), i,
                         kv_cache=(cache["k"][i], cache["v"][i]),
                         cache_len=cache_len)
    x = _norm(cfg, x, params["ln_final"])
    logits = _unembed(cfg, params, x)[:, 0].to(torch.float32)
    return (cache, whole_last_dim(logits).argmax(-1).to(torch.int32),
            logits)
