"""The LM-family transformer, dense configurations (llama3-8b).

Parameters are the JAX package's pytree as a dict of tensors: per-layer
weights stacked on a leading (L, ...) axis, run by a Python loop over the
layers.  Serving is ``prefill`` (blockwise attention, returns the per-layer
K/V) and ``decode_step`` (one token; ``flash_decode`` on the card, the KV
cache updated in place).  Not yet ported, and refused by
``check_supported``: MoE layers, sliding-window layers, attention logit
soft-capping (``flash_decode`` has neither a window nor a softcap), sandwich
norms and the mesh fields; training (``lm_loss``) waits as well.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..device import resolve_device
from .attention import attention_block
from .layers import (dense_init, embed_init, layer_norm_nonparam, normal,
                     rms_norm, softcap, torch_dtype)


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
        d, dh = self.d_model, self.head_dim
        attn = d * (self.n_heads + 2 * self.n_kv_heads) * dh \
            + self.n_heads * dh * d
        if self.is_moe:
            f = self.moe_dff or self.d_ff
            ffn = self.n_experts * 3 * d * f + d * self.n_experts
            if self.dense_residual:
                ffn += 3 * d * (self.dense_residual_dff or self.d_ff)
        else:
            ffn = 3 * d * self.d_ff
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        return self.n_layers * (attn + ffn) + emb


def check_supported(cfg: LMConfig) -> None:
    """Raise for the parts of the LM family the port does not run yet."""
    missing = [what for what, on in (
        ("MoE layers", cfg.is_moe),
        ("sliding-window layers", cfg.sliding_window is not None
         or cfg.local_global_period > 0),
        ("attention soft-capping", cfg.attn_softcap is not None),
        ("sandwich norms", cfg.post_norm),
        ("mesh fields", bool(cfg.act_batch_axes or cfg.act_model_axis
                             or cfg.moe_expert_axis or cfg.moe_batch_axes
                             or cfg.attn_seq_parallel))) if on]
    if missing:
        raise NotImplementedError(f"{cfg.name}: {', '.join(missing)} not yet "
                                  f"ported")


# --------------------------------------------------------------------- init
def init_params(cfg: LMConfig, gen: torch.Generator) -> dict:
    """Stacked-layer parameters on the generator's device, drawn from it:
    N(0, 1/fan_in) projections, N(0, 1) embeddings, zero norm weights."""
    check_supported(cfg)
    dt, dev = cfg.compute_dtype, gen.device
    d, dh, n = cfg.d_model, cfg.head_dim, cfg.n_layers

    def stack(shape, fan_in):
        out = torch.empty((n, *shape), dtype=dt, device=dev)
        for i in range(n):             # one layer's f32 draw at a time
            out[i] = normal(gen, shape, fan_in ** -0.5, dt)
        return out

    layers = {
        "wq": stack((d, cfg.n_heads * dh), d),
        "wk": stack((d, cfg.n_kv_heads * dh), d),
        "wv": stack((d, cfg.n_kv_heads * dh), d),
        "wo": stack((cfg.n_heads * dh, d), cfg.n_heads * dh),
        "ln_attn": torch.zeros((n, d), dtype=dt, device=dev),
        "ln_ffn": torch.zeros((n, d), dtype=dt, device=dev),
        "mlp": {"w_gate": stack((d, cfg.d_ff), d),
                "w_up": stack((d, cfg.d_ff), d),
                "w_down": stack((cfg.d_ff, d), cfg.d_ff)},
    }
    params = {"embed": embed_init(gen, cfg.vocab, d, dt), "layers": layers,
              "ln_final": torch.zeros(d, dtype=dt, device=dev)}
    if not cfg.tie_embeddings:
        params["unembed"] = dense_init(gen, d, cfg.vocab, dt)
    return params


# ------------------------------------------------------------------ forward
def _norm(cfg: LMConfig, x: torch.Tensor, w: torch.Tensor | None):
    if cfg.norm == "nonparam":
        return layer_norm_nonparam(x)
    return rms_norm(x, w)


def _ffn(cfg: LMConfig, x: torch.Tensor, lw: dict) -> torch.Tensor:
    mw = lw["mlp"]
    return (torch.nn.functional.silu(x @ mw["w_gate"]) * (x @ mw["w_up"])) \
        @ mw["w_down"]


def _layer_weights(params: dict, i: int) -> dict:
    """Layer i's slice of the stacked weights."""
    lw = params["layers"]
    return {k: ({kk: vv[i] for kk, vv in v.items()} if isinstance(v, dict)
                else v[i]) for k, v in lw.items()}


def _layer(cfg: LMConfig, x: torch.Tensor, lw: dict, *, positions=None,
           kv_cache=None, cache_len=None):
    """One transformer block.  Returns (x', new_kv)."""
    h = _norm(cfg, x, lw["ln_attn"])
    a, new_kv = attention_block(
        h, lw, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        d_head=cfg.head_dim, rope_theta=cfg.rope_theta,
        positions=positions, kv_cache=kv_cache, cache_len=cache_len,
        q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk)
    x = x + a
    return x + _ffn(cfg, _norm(cfg, x, lw["ln_ffn"]), lw), new_kv


def _embed(cfg: LMConfig, params: dict, tokens: torch.Tensor):
    x = params["embed"][tokens]
    if cfg.embed_scale:
        x = (x.to(torch.float32) * (cfg.d_model ** 0.5)).to(x.dtype)
    return x


def forward(cfg: LMConfig, params: dict, tokens: torch.Tensor, *,
            positions=None, return_kv: bool = False):
    """tokens (B, S) -> final hidden (B, S, D) and, with ``return_kv``, the
    stacked (L, B, S, Hkv, Dh) K and V for the cache."""
    check_supported(cfg)
    x = _embed(cfg, params, tokens)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        x, (k, v) = _layer(cfg, x, _layer_weights(params, i),
                           positions=positions)
        if return_kv:
            ks.append(k)
            vs.append(v)
    x = _norm(cfg, x, params["ln_final"])
    return x, ((torch.stack(ks), torch.stack(vs)) if return_kv else None)


def _unembed(cfg: LMConfig, params: dict, h: torch.Tensor) -> torch.Tensor:
    w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    return softcap(h @ w, cfg.final_softcap)


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
    h, (k, v) = forward(cfg, params, tokens, return_kv=True)
    return {"k": k, "v": v}, _unembed(cfg, params, h[:, -1:, :])[:, 0]


def decode_step(cfg: LMConfig, params: dict, cache: dict,
                tokens: torch.Tensor, cache_len: int):
    """One greedy decode step.  tokens (B,) int; cache dict of (L, B, S, Hkv,
    Dh) tensors; ``cache_len`` (an int) valid positions.  The new token's
    K/V is written into ``cache`` in place, at ``cache_len``.  Returns
    (cache, next tokens (B,) int32, f32 logits (B, V))."""
    check_supported(cfg)
    x = _embed(cfg, params, tokens[:, None])
    for i in range(cfg.n_layers):
        x, _ = _layer(cfg, x, _layer_weights(params, i),
                      kv_cache=(cache["k"][i], cache["v"][i]),
                      cache_len=cache_len)
    x = _norm(cfg, x, params["ln_final"])
    logits = _unembed(cfg, params, x)[:, 0].to(torch.float32)
    return cache, logits.argmax(-1).to(torch.int32), logits
