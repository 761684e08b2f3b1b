"""Mixture-of-Experts FFN: a top-k router and a capacity-bounded sort
dispatch, as the JAX package's ``moe_ffn`` (GShard semantics).

Routed tokens are sorted by expert (a stable sort, so that each expert's
queue is in token order), each takes the next slot of its expert's
capacity, and tokens past the capacity are dropped.  The kept tokens fill
an (E, C, D) buffer, the experts run as three batched products, and each
token's outputs come back weighted by their renormalised gates, summed in
float32.  The expert products are ``torch`` matrix products: the JAX
package computes them outside any Pallas kernel too.

The expert-parallel ``moe_ffn_sharded`` needs a mesh and is not yet
ported.
"""
from __future__ import annotations

import torch


def capacity_of(t: int, n_experts: int, top_k: int,
                capacity_factor: float) -> int:
    """Slots of each expert for ``t`` tokens: t * top_k / E * cf rounded
    half up, at least 1 and at most ``t``."""
    return min(max(int(t * top_k / n_experts * capacity_factor + 0.5), 1), t)


def top_k_lower_first(probs: torch.Tensor, k: int):
    """(values, indices) of the ``k`` largest of each row, largest first
    and, among equal values, the lower index first (``jax.lax.top_k``'s
    order; ``torch.topk`` promises none among ties)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def moe_ffn(x: torch.Tensor, w: dict, *, n_experts: int, top_k: int,
            capacity_factor: float = 1.25,
            act=torch.nn.functional.silu):
    """x (T, D) tokens; w: router (D, E), w_gate / w_up (E, D, F), w_down
    (E, F, D).  Returns (out (T, D) in x's dtype, the Switch load-balance
    aux loss as an f32 scalar)."""
    t, d = x.shape
    e = n_experts
    capacity = capacity_of(t, e, top_k, capacity_factor)
    dev = x.device

    logits = (x @ w["router"]).to(torch.float32)           # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate, idx = top_k_lower_first(probs, top_k)            # (T, K)
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)

    # load-balance aux loss (Switch): E * mean(frac_tokens * frac_probs)
    me = probs.mean(0)
    ce = torch.nn.functional.one_hot(idx[:, 0], e).to(torch.float32).mean(0)
    aux = e * (me * ce).sum()

    # sort dispatch: each routed token's slot in its expert's queue
    flat_e = idx.reshape(-1)                               # (T*K,)
    flat_t = torch.arange(t, device=dev).repeat_interleave(top_k)
    order = torch.argsort(flat_e, stable=True)
    se, st = flat_e[order], flat_t[order]
    start = torch.searchsorted(se, torch.arange(e, device=dev))
    pos_in_e = torch.arange(se.numel(), device=dev) - start[se]
    keep = pos_in_e < capacity
    dest = torch.where(keep, se * capacity + pos_in_e, e * capacity)

    buf = torch.zeros((e * capacity + 1, d), dtype=x.dtype, device=dev)
    buf[dest] = x[st]                  # dropped tokens land on the last row
    buf = buf[:-1].reshape(e, capacity, d)                 # (E, C, D)

    h = torch.bmm(buf, w["w_gate"])
    u = torch.bmm(buf, w["w_up"])
    y = torch.bmm(act(h) * u, w["w_down"])                 # (E, C, D)

    # combine back to token order, in f32
    y_flat = y.reshape(e * capacity, d)
    gathered = torch.where(keep[:, None],
                           y_flat[dest.clamp(0, e * capacity - 1)], 0.0)
    sg = gate.reshape(-1)[order]
    contrib = gathered * sg[:, None].to(gathered.dtype)
    out = torch.zeros((t, d), dtype=torch.float32, device=dev)
    out.index_add_(0, st, contrib.to(torch.float32))
    return out.to(x.dtype), aux


def moe_ffn_sharded(*args, **kwargs):
    raise NotImplementedError("moe_ffn_sharded (expert-parallel dispatch over "
                              "a mesh) is not yet ported")
