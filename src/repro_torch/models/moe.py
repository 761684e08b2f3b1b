"""Mixture-of-Experts FFN: a top-k router and a capacity-bounded sort
dispatch, as the JAX package's ``moe_ffn`` (GShard semantics).

Routed tokens are sorted by expert (a stable sort, so that each expert's
queue is in token order), each takes the next slot of its expert's
capacity, and tokens past the capacity are dropped.  The kept tokens fill
an (E, C, D) buffer, the experts run as three batched products, and each
token's outputs come back weighted by their renormalised gates, summed in
float32.  The expert products are ``torch`` matrix products: the JAX
package computes them outside any Pallas kernel too.

``moe_ffn_sharded`` is the expert-parallel dispatch over a mesh
(``launch.mesh``): each rank runs ``moe_local`` on its token shard and its
block of experts, and the partial outputs are summed over the expert axis.
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
    aux loss as an f32 scalar): ``moe_local`` with every expert in one
    block."""
    return moe_local(x, w["router"], w["w_gate"], w["w_up"], w["w_down"],
                     expert_index=0, n_experts=n_experts, top_k=top_k,
                     capacity=capacity_of(x.shape[0], n_experts, top_k,
                                          capacity_factor), act=act)


def moe_local(xs: torch.Tensor, router: torch.Tensor, wg: torch.Tensor,
              wu: torch.Tensor, wd: torch.Tensor, *, expert_index: int,
              n_experts: int, top_k: int, capacity: int,
              act=torch.nn.functional.silu):
    """The dispatch of tokens ``xs`` (T, D) into one block of experts: the
    whole router (D, E) and the block's ``E_local`` experts (``wg``/``wu``
    (E_local, D, F), ``wd`` (E_local, F, D)), the ``expert_index``-th block
    of E / E_local, ``capacity`` slots an expert.

    Every token is routed (the router is replicated), only this block's
    experts are dispatched: a stable sort of the routed (token, k) pairs
    by local expert, with pairs for other blocks' experts in a drop
    bucket.  Returns (the block's partial output (T, D) in x's dtype, the
    Switch aux loss of these tokens, f32)."""
    tl, d = xs.shape
    e_local = wg.shape[0]
    dev = xs.device

    logits = (xs @ router).to(torch.float32)               # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate, idx = top_k_lower_first(probs, top_k)            # (T, K)
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)

    # load-balance aux loss (Switch): E * mean(frac_tokens * frac_probs)
    me = probs.mean(0)
    ce = torch.nn.functional.one_hot(idx[:, 0], n_experts).to(
        torch.float32).mean(0)
    aux = n_experts * (me * ce).sum()

    # sort dispatch: each routed pair's slot in its local expert's queue;
    # e_local is the drop bucket of the other blocks' experts
    flat_t = torch.arange(tl, device=dev).repeat_interleave(top_k)
    rel = idx.reshape(-1) - expert_index * e_local
    le = torch.where((rel >= 0) & (rel < e_local), rel, e_local)
    order = torch.argsort(le, stable=True)
    se, st = le[order], flat_t[order]
    start = torch.searchsorted(se, torch.arange(e_local + 1, device=dev))
    pos = torch.arange(se.numel(), device=dev) - start[se]
    keep = (se < e_local) & (pos < capacity)
    dest = torch.where(keep, se * capacity + pos, e_local * capacity)

    buf = torch.zeros((e_local * capacity + 1, d), dtype=xs.dtype, device=dev)
    buf = buf.index_put((dest,), xs[st])   # dropped pairs land on the last row
    buf = buf[:-1].reshape(e_local, capacity, d)           # (E_local, C, D)

    h = torch.bmm(buf, wg)
    u = torch.bmm(buf, wu)
    y = torch.bmm(act(h) * u, wd)                          # (E_local, C, D)

    # combine back to token order, in f32
    y_flat = y.reshape(e_local * capacity, d)
    gathered = torch.where(keep[:, None],
                           y_flat[dest.clamp(0, e_local * capacity - 1)], 0.0)
    sg = gate.reshape(-1)[order]
    contrib = gathered * sg[:, None].to(gathered.dtype)
    out = torch.zeros((tl, d), dtype=torch.float32, device=dev)
    out = out.index_add(0, st, contrib.to(torch.float32))
    return out.to(xs.dtype), aux


def moe_ffn_sharded(x: torch.Tensor, w: dict, *, n_experts: int, top_k: int,
                    capacity_factor: float = 1.25,
                    act=torch.nn.functional.silu, batch_axes=("data",),
                    expert_axis="model", fsdp_axis=None,
                    expert_parallel: int | None = None, mesh=None):
    """Expert-parallel MoE over a mesh: ``moe_local`` on each rank.

    Layout contract (the JAX package's):
      x        (T, D)    sharded P(batch_axes, None)
      router   (D, E)    replicated
      w_gate/up(E, D, F) sharded P(expert_axis, fsdp_axis, None)
      w_down   (E, F, D) sharded P(expert_axis, None, fsdp_axis)

    Rank (d, m) holds token shard d (replicated over m) and expert block m.
    The only collectives are the FSDP all-gather of the expert weights over
    ``fsdp_axis`` and one sum over the expert axis for the combine, in the
    compute dtype (top-2 partial sums a token: bf16 rounding of two-term
    sums is standard EP practice).  Capacity and the aux loss are per
    token shard (at least 4 slots an expert); ``aux`` is averaged over
    ``batch_axes``.  ``mesh``
    defaults to ``launch.mesh.current_mesh()``; ``expert_parallel`` to the
    expert axis' size.  Returns (out (T, D), aux)."""
    from ..launch.mesh import (all_gather, axis_size, current_mesh, pmean,
                               psum, shard_map)
    from ..launch.shardings import P

    mesh = mesh if mesh is not None else current_mesh()
    m_size = (expert_parallel if expert_parallel is not None
              else axis_size(mesh, expert_axis))
    e_local = n_experts // m_size
    if e_local * m_size != n_experts:
        raise ValueError(f"{n_experts} experts over {m_size} expert ranks")

    def local(xs, router, wg, wu, wd):
        if fsdp_axis is not None:
            wg = all_gather(wg, fsdp_axis, 1, mesh)
            wu = all_gather(wu, fsdp_axis, 1, mesh)
            wd = all_gather(wd, fsdp_axis, 2, mesh)
        tl = xs.shape[0]
        capacity = min(max(capacity_of(tl, n_experts, top_k,
                                       capacity_factor), 4), tl)
        out, aux = moe_local(xs, router, wg, wu, wd,
                             expert_index=mesh.get_local_rank(expert_axis),
                             n_experts=n_experts, top_k=top_k,
                             capacity=capacity, act=act)
        return psum(out, expert_axis, mesh), pmean(aux, batch_axes, mesh)

    xp = P(batch_axes, None)
    wg_spec = P(expert_axis, fsdp_axis, None)
    wd_spec = P(expert_axis, None, fsdp_axis)
    return shard_map(local, mesh=mesh,
                     in_specs=(xp, P(None, None), wg_spec, wg_spec, wd_spec),
                     out_specs=(xp, P()))(
        x, w["router"], w["w_gate"], w["w_up"], w["w_down"])
