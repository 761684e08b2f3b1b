"""Attention for the LM family: GQA, RoPE, blockwise prefill attention and
KV-cache decode attention.

Prefill attention is computed blockwise: a loop over query chunks and,
inside it, over KV chunks with a running (max, sum) online softmax, so the
(S x S) scores never exist whole.  Decode attention on a CUDA tensor goes
through the hand-written ``flash_decode`` kernel; ``decode_attention`` is
its plain version and the path for CPU tensors.  ``seq_parallel_attention``
splits the query sequence over a mesh axis (``launch.mesh``).
"""
from __future__ import annotations

import torch

from ..kernels.flash_decode.ops import flash_decode
from .layers import (apply_rope, is_dtensor, product, replicated_like,
                     rope_table, softcap)

NEG_INF = -2.0e38


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, Hkv, D) -> (B, S, Hkv * n_rep, D) by head repetition (GQA)."""
    if n_rep == 1:
        return x
    b, s, h, d = x.shape
    return x[:, :, :, None, :].expand(b, s, h, n_rep, d) \
        .reshape(b, s, h * n_rep, d)


def _chunk_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, *, causal: bool,
                window: int | None) -> torch.Tensor:
    """(Sq, Sk) bool mask: True = attend."""
    m = replicated_like(torch.ones((q_pos.shape[0], k_pos.shape[0]),
                                   dtype=torch.bool, device=q_pos.device),
                        q_pos)
    if causal:
        m = m & (q_pos[:, None] >= k_pos[None, :])
    if window is not None:
        m = m & (q_pos[:, None] - k_pos[None, :] < window)
    return m


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int | None = None,
                        attn_softcap: float | None = None,
                        q_chunk: int = 512, kv_chunk: int = 1024,
                        q_offset: int = 0) -> torch.Tensor:
    """Flash-style attention in O(S * chunk) memory.

    q (B, Sq, Hq, D); k, v (B, Sk, Hkv, D) with Hq % Hkv == 0; ``q_offset``
    is the absolute position of q[0].  Returns (B, Sq, Hq, D) in q's dtype.
    Under a causal mask a KV chunk that lies wholly after a query chunk is
    skipped: it would add exp(NEG_INF - m) = 0 to every row.
    """
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    n_rep = hq // hkv
    scale = d ** -0.5
    q_chunk, kv_chunk = min(q_chunk, sq), min(kv_chunk, sk)
    # (B, Hkv, G, S, D): the group axis keeps the GQA products batched
    qh = q.reshape(b, sq, hkv, n_rep, d).permute(0, 2, 3, 1, 4)
    kh = k.permute(0, 2, 1, 3)[:, :, None]        # (B, Hkv, 1, Sk, D)
    vh = v.permute(0, 2, 1, 3)[:, :, None]
    dev = q.device
    outs = []
    for q0 in range(0, sq, q_chunk):
        q_blk = qh[:, :, :, q0:q0 + q_chunk]
        nq = q_blk.shape[3]
        q_pos = replicated_like(q_offset + q0 + torch.arange(nq, device=dev),
                                q)
        acc = m_run = l_run = None
        for k0 in range(0, sk, kv_chunk):
            if causal and k0 > q_offset + q0 + nq - 1:
                break
            k_blk, v_blk = kh[:, :, :, k0:k0 + kv_chunk], vh[:, :, :, k0:k0 + kv_chunk]
            k_pos = replicated_like(
                k0 + torch.arange(k_blk.shape[3], device=dev), q)
            # f32 products of the working-type inputs, as the JAX einsums'
            # preferred_element_type=f32
            s = torch.matmul(q_blk.to(torch.float32),
                             k_blk.to(torch.float32).transpose(-1, -2)) * scale
            s = softcap(s, attn_softcap)
            mask = _chunk_mask(q_pos, k_pos, causal=causal, window=window)
            s = torch.where(mask, s, NEG_INF)
            corr = None
            if m_run is None:
                # the first chunk starts the running state: against a zero
                # accumulator, a zero sum and a NEG_INF maximum the update
                # below gives these values exactly
                m_run = s.amax(-1).clamp_min(NEG_INF)
                p = torch.exp(s - m_run[..., None])
                l_run = p.sum(-1)
            else:
                m_new = torch.maximum(m_run, s.amax(-1))
                p = torch.exp(s - m_new[..., None])
                corr = torch.exp(m_run - m_new)
                l_run = l_run * corr + p.sum(-1)
                m_run = m_new
            prod = torch.matmul(p.to(v_blk.dtype).to(torch.float32),
                                v_blk.to(torch.float32))
            acc = prod if corr is None else acc * corr[..., None] + prod
        outs.append(acc / l_run.clamp_min(1e-30)[..., None])
    out = outs[0] if len(outs) == 1 else torch.cat(outs, 3)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d).to(q.dtype)


def sharded_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      **kw) -> torch.Tensor:
    """``blockwise_attention`` of DTensors, run on each rank's shards: the
    batch stays split as q's is, and q's heads as they are split (a head
    split of K/V is kept only where q's heads are split alike; elsewhere
    K/V are whole, and each rank takes the K/V heads its q heads read).
    Any other split (a Partial sum, a split sequence or head dim) is
    resolved first.  K/V's gradient is a Partial sum over the mesh dims on
    which their heads are whole but q's are split."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = q.device_mesh
    q_pl = tuple(p if isinstance(p, Shard) and p.dim in (0, 2) else Replicate()
                 for p in q.placements)
    kv_pl = tuple(qp if qp == Shard(0) or (qp == Shard(2) and kp == qp)
                  else Replicate() for qp, kp in zip(q_pl, k.placements))
    kv_grad = tuple(Partial() if qp != kp else kp
                    for qp, kp in zip(q_pl, kv_pl))
    head_dims = [i for i, p in enumerate(q_pl) if p == Shard(2)]
    n_rep = q.shape[2] // k.shape[2]

    def local(ql, kl, vl):
        n = ql.shape[2]
        if kl.shape[2] * n_rep != n:          # K/V heads whole, q's split
            r = 0
            for i in head_dims:
                r = r * mesh.size(i) + mesh.get_local_rank(i)
            off = r * n
            lo, hi = off // n_rep, (off + n - 1) // n_rep + 1
            if hi - lo == 1 or (off % n_rep == 0 and n % n_rep == 0):
                kl, vl = kl[:, :, lo:hi], vl[:, :, lo:hi]
            else:
                kl = repeat_kv(kl, n_rep)[:, :, off:off + n]
                vl = repeat_kv(vl, n_rep)[:, :, off:off + n]
        return (blockwise_attention(ql, kl, vl, **kw),)

    return local_map(local, out_placements=(q_pl,),
                     in_placements=(q_pl, kv_pl, kv_pl),
                     in_grad_placements=(q_pl, kv_grad, kv_grad),
                     device_mesh=mesh, redistribute_inputs=True)(q, k, v)[0]


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len, *,
                     window: int | None = None,
                     attn_softcap: float | None = None) -> torch.Tensor:
    """One-token decode, the plain version of ``flash_decode``: q (B, 1, Hq,
    D) against caches (B, S, Hkv, D); positions >= ``cache_len`` are masked,
    and a window keeps only the trailing ``window`` positions."""
    b, _, hq, d = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    n_rep = hq // hkv
    qh = q.reshape(b, hkv, n_rep, d)
    scores = torch.einsum("bhgd,bshd->bhgs", qh.to(torch.float32),
                          k_cache.to(torch.float32)) * (d ** -0.5)
    scores = softcap(scores, attn_softcap)
    pos = torch.arange(s, device=q.device)
    valid = pos < cache_len
    if window is not None:
        valid &= pos >= cache_len - window
    scores = torch.where(valid, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", p.to(v_cache.dtype).to(torch.float32),
                       v_cache.to(torch.float32))
    return out.reshape(b, 1, hq, d).to(q.dtype)


def sharded_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   k_cache: torch.Tensor, v_cache: torch.Tensor,
                   cache_len: int, *, window: int | None = None,
                   attn_softcap: float | None = None) -> torch.Tensor:
    """One decode step against a DTensor cache (B, S, Hkv, D) whose batch
    and sequence are split: the new K/V (B, 1, Hkv, D) is written in place
    by the rank that holds position ``cache_len``, each rank attends over
    its own positions, and the partial softmaxes are merged over the
    sequence split (a max, then two sums: FlashDecoding across ranks).
    q (B, 1, Hq, D); returns (B, 1, Hq, D) split as the batch is."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from ..launch.mesh import pmax, psum

    mesh = k_cache.device_mesh
    names = mesh.mesh_dim_names
    c_pl = tuple(p if p in (Shard(0), Shard(1)) else Replicate()
                 for p in k_cache.placements)
    q_pl = tuple(p if p == Shard(0) else Replicate() for p in c_pl)
    seq_dims = [i for i, p in enumerate(c_pl) if p == Shard(1)]
    seq_axes = tuple(names[i] for i in seq_dims)
    n_rep = q.shape[2] // k.shape[2]

    def local(ql, kl, vl, kc, vc):
        b, s_loc, hkv, d = kc.shape
        r = 0
        for i in seq_dims:
            r = r * mesh.size(i) + mesh.get_local_rank(i)
        lo = r * s_loc
        if lo <= cache_len < lo + s_loc:
            kc[:, cache_len - lo] = kl[:, 0]
            vc[:, cache_len - lo] = vl[:, 0]
        qh = ql.reshape(b, hkv, n_rep, d).to(torch.float32)
        sc = torch.einsum("bhgd,bshd->bhgs", qh, kc.to(torch.float32)) \
            * (d ** -0.5)
        sc = softcap(sc, attn_softcap)
        pos = lo + torch.arange(s_loc, device=kc.device)
        valid = pos < cache_len + 1
        if window is not None:
            valid &= pos >= cache_len + 1 - window
        sc = torch.where(valid, sc, NEG_INF)
        m = sc.amax(-1)
        if seq_axes:
            m = pmax(m, seq_axes, mesh)
        p = torch.exp(sc - m[..., None])
        den = p.sum(-1)
        num = torch.einsum("bhgs,bshd->bhgd", p.to(vc.dtype).to(torch.float32),
                           vc.to(torch.float32))
        if seq_axes:
            den, num = psum(den, seq_axes, mesh), psum(num, seq_axes, mesh)
        out = num / den[..., None]
        return (out.reshape(b, 1, hkv * n_rep, d).to(ql.dtype),)

    return local_map(local, out_placements=(q_pl,),
                     in_placements=(q_pl, q_pl, q_pl, c_pl, c_pl),
                     device_mesh=mesh, redistribute_inputs=True)(
        q, k, v, k_cache, v_cache)[0]


def seq_parallel_attention(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *, batch_axes, model_axis,
                           causal: bool = True, window: int | None = None,
                           attn_softcap: float | None = None,
                           q_chunk: int = 512, kv_chunk: int = 1024,
                           mesh=None) -> torch.Tensor:
    """Sequence-parallel attention core, for archs whose head counts do not
    divide the TP axis (arctic: 56 q / 8 kv heads against model=16), where
    the core would otherwise run replicated on every model shard.

    The QUERY sequence is split over ``model_axis`` and the batch over
    ``batch_axes``; each rank gets the full K/V of its batch shard and runs
    ``blockwise_attention`` on its S / model rows with the causal offset
    ``rank_in_axis * S_local``.  ``mesh`` defaults to
    ``launch.mesh.current_mesh()``."""
    from ..launch.mesh import current_mesh, shard_map
    from ..launch.shardings import P

    mesh = mesh if mesh is not None else current_mesh()

    def local(q_loc, k_loc, v_loc):
        return blockwise_attention(
            q_loc, k_loc, v_loc, causal=causal, window=window,
            attn_softcap=attn_softcap, q_chunk=q_chunk, kv_chunk=kv_chunk,
            q_offset=mesh.get_local_rank(model_axis) * q_loc.shape[1])

    kv = P(batch_axes, None, None, None)
    return shard_map(local, mesh=mesh,
                     in_specs=(P(batch_axes, model_axis, None, None), kv, kv),
                     out_specs=P(batch_axes, model_axis, None, None))(q, k, v)


def attention_block(x: torch.Tensor, w: dict, *, n_heads: int,
                    n_kv_heads: int, d_head: int, rope_theta: float,
                    causal: bool = True, window: int | None = None,
                    attn_softcap: float | None = None, positions=None,
                    kv_cache=None, cache_len: int | None = None,
                    q_chunk: int = 512, kv_chunk: int = 1024,
                    seq_parallel=None):
    """Attention sub-layer: qkv projection, RoPE, attention, out projection.

    w: dict(wq (D, Hq*Dh), wk (D, Hkv*Dh), wv, wo (Hq*Dh, D)).  Prefill
    (``kv_cache`` None) returns (out, (k, v)), the layer's whole K/V.
    Decode: x is (B, 1, D) and ``kv_cache`` = (k_cache, v_cache) of shape
    (B, S, Hkv, Dh); the new token's K/V is written at ``cache_len`` IN
    PLACE (the JAX version returns new caches from dynamic_update_slice)
    and (out, (k_cache, v_cache)) is returned.  The decode attention is
    ``flash_decode`` over ``cache_len + 1`` positions, with the layer's
    window and soft-cap.  ``seq_parallel`` = (batch axes, model axis):
    prefill through ``seq_parallel_attention`` over the current mesh.
    DTensor weights and activations (the dry run's) take
    ``sharded_attention``, and a DTensor cache ``sharded_decode`` (its
    plain version: no kernel runs on a mesh), in place of the kernel.
    """
    b, s, _ = x.shape
    q = product(x, w["wq"]).reshape(b, s, n_heads, d_head)
    k = product(x, w["wk"]).reshape(b, s, n_kv_heads, d_head)
    v = product(x, w["wv"]).reshape(b, s, n_kv_heads, d_head)
    if positions is None:
        positions = replicated_like(
            torch.arange(s, device=x.device)[None] if kv_cache is None
            else torch.full((1, 1), int(cache_len), device=x.device), x)
    cos, sin = rope_table(positions, d_head, rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    if kv_cache is None:
        if seq_parallel is not None:
            bd, ma = seq_parallel
            out = seq_parallel_attention(
                q, k, v, batch_axes=bd, model_axis=ma, causal=causal,
                window=window, attn_softcap=attn_softcap, q_chunk=q_chunk,
                kv_chunk=kv_chunk)
        else:
            core = (sharded_attention if is_dtensor(q)
                    else blockwise_attention)
            out = core(q, k, v, causal=causal, window=window,
                       attn_softcap=attn_softcap, q_chunk=q_chunk,
                       kv_chunk=kv_chunk)
        new_kv = (k, v)
    else:
        k_cache, v_cache = kv_cache
        cache_len = int(cache_len)
        if is_dtensor(k_cache):
            out = sharded_decode(q, k, v, k_cache, v_cache, cache_len,
                                 window=window, attn_softcap=attn_softcap)
            return (product(out.reshape(b, s, n_heads * d_head), w["wo"]),
                    (k_cache, v_cache))
        k_cache[:, cache_len:cache_len + s] = k
        v_cache[:, cache_len:cache_len + s] = v
        out = flash_decode(q[:, 0], k_cache, v_cache, cache_len + 1,
                           window=window, softcap=attn_softcap)[:, None]
        new_kv = (k_cache, v_cache)
    return product(out.reshape(b, s, n_heads * d_head), w["wo"]), new_kv
