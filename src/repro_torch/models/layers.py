"""Shared layers: norms, MLPs, RoPE, initializers.

Parameters are nested dicts of tensors with the JAX package's keys, and
every layer is a plain function on tensors.  Initializers draw from an
explicit ``torch.Generator`` and place their tensors on its device.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    if name not in DTYPES:
        raise ValueError(f"dtype {name!r} is not one of {sorted(DTYPES)}")
    return DTYPES[name]


def at_least_f32(dtype: torch.dtype) -> torch.dtype:
    """The dtype the JAX package computes norms in (f32), except that an
    f64 input stays f64: the card's float64 runs check the f32 ones."""
    return torch.promote_types(dtype, torch.float32)


def normal(gen: torch.Generator, shape, scale: float = 1.0,
           dtype=torch.float32) -> torch.Tensor:
    """N(0, scale^2) drawn in f32 on the generator's device, then cast."""
    x = torch.randn(tuple(shape), generator=gen, device=gen.device,
                    dtype=torch.float32)
    if scale != 1.0:
        x.mul_(scale)
    return x.to(dtype)


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype=torch.float32, scale: float | None = None):
    scale = scale if scale is not None else d_in ** -0.5
    return normal(gen, (d_in, d_out), scale, dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype=torch.float32):
    return normal(gen, (vocab, d), 1.0, dtype)


def rms_norm(x: torch.Tensor, weight: torch.Tensor | None = None,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in f32 (f64 stays f64) with the ``(1 + weight)`` gain
    (weights start at zero); ``weight=None`` is the non-parametric
    variant."""
    x32 = x.to(at_least_f32(x.dtype))
    nrm = x32 * torch.rsqrt(x32.square().mean(-1, keepdim=True) + eps)
    if weight is not None:
        nrm = nrm * (1.0 + weight.to(x32.dtype))
    return nrm.to(x.dtype)


def layer_norm_nonparam(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Non-parametric LayerNorm (mean-centred, no gain or bias), in f32
    (f64 stays f64)."""
    x32 = x.to(at_least_f32(x.dtype))
    mu = x32.mean(-1, keepdim=True)
    var = x32.var(-1, keepdim=True, unbiased=False)
    return ((x32 - mu) * torch.rsqrt(var + eps)).to(x.dtype)


def mlp_init(gen: torch.Generator, sizes, dtype=torch.float32) -> dict:
    n = len(sizes) - 1
    params = {f"w{i}": dense_init(gen, sizes[i], sizes[i + 1], dtype)
              for i in range(n)}
    params.update({f"b{i}": torch.zeros(sizes[i + 1], dtype=dtype,
                                        device=gen.device)
                   for i in range(n)})
    return params


def mlp_apply(params: dict, x: torch.Tensor, *, act=torch.relu,
              final_act: bool = False) -> torch.Tensor:
    n = len([k for k in params if k.startswith("w")])
    for i in range(n):
        x = x @ params[f"w{i}"] + params[f"b{i}"]
        if i < n - 1 or final_act:
            x = act(x)
    return x


def is_dtensor(t) -> bool:
    return isinstance(t, DTensor)


def replicated_like(t: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """``t``, made inside a step, as a tensor that combines with ``ref``: a
    replicated DTensor on ``ref``'s mesh when ``ref`` is a DTensor (a
    sharded step's parameters and batch are), else ``t`` itself."""
    if isinstance(t, DTensor) or not isinstance(ref, DTensor):
        return t
    mesh = ref.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _keep_splits(t: torch.Tensor, keep) -> torch.Tensor:
    """A DTensor with every placement for which ``keep(mesh dim name,
    placement)`` is false made ``Replicate`` (a gather, or the sum of a
    Partial); a plain tensor as it is."""
    if not is_dtensor(t):
        return t
    mesh = t.device_mesh
    want = tuple(p if keep(n, p) else Replicate()
                 for n, p in zip(mesh.mesh_dim_names, t.placements))
    return t if want == tuple(t.placements) else t.redistribute(mesh, want)


def batch_split(x: torch.Tensor) -> torch.Tensor:
    """An activation entering a product, split over its batch (dim 0)
    only: a DTensor's other splits are gathered and Partial sums summed,
    so that the product sees (rows, features) with whole features."""
    return _keep_splits(x, lambda n, p: p == Shard(0))


def rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]``.  A DTensor table whose rows are split is looked up on
    each rank (``_split_rows``); a whole DTensor table through
    ``embedding``, its rows split as ``idx`` is."""
    if not is_dtensor(table):
        return table[idx]
    if Shard(0) in table.placements:
        return _split_rows(table, idx)
    return batch_split(torch.nn.functional.embedding(idx, table))


def _split_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` of a row-split DTensor table, as the JAX package's
    sharded gather: each rank looks up the ids that fall in its rows (the
    others read as zeros) and the partial rows are summed over the table's
    split (``launch.mesh``'s ``shard_map`` and ``psum``).  Ids split over a
    mesh dim that also splits the table are first gathered over it, so
    that every rank of a sum looks up the same ids; the rows are split
    back as the ids were afterwards.  Each rank's table gradient is its
    own rows' (DTensor's ``embedding`` rule makes a whole-table gradient
    on every rank)."""
    from ..launch.mesh import psum, shard_map
    from ..launch.shardings import P

    mesh = table.device_mesh
    names = mesh.mesh_dim_names
    t_dims = [d for d, p in enumerate(table.placements) if p == Shard(0)]
    t_axes = tuple(names[d] for d in t_dims)
    i_dims = [d for d, p in enumerate(idx.placements)
              if p == Shard(0)] if is_dtensor(idx) else []
    n_rows = table.shape[0]

    def local(tab, ix):
        # this rank's first row: DTensor's split, one mesh dim after another
        start, size = 0, n_rows
        for d in t_dims:
            chunk, r = -(-size // mesh.size(d)), mesh.get_local_rank(d)
            start += r * chunk
            size = max(0, min(chunk, size - r * chunk))
        n = tab.shape[0]
        loc = ix.long() - start
        hit = (loc >= 0) & (loc < n)
        out = tab[loc.clamp(0, n - 1)] * hit[..., None].to(tab.dtype)
        return psum(out, t_axes, mesh)

    lead = tuple(names[d] for d in i_dims if d not in t_dims) or None
    out = shard_map(local, mesh=mesh,
                    in_specs=(P(t_axes, *([None] * (table.dim() - 1))),
                              P(lead, *([None] * (idx.dim() - 1)))),
                    out_specs=P(lead, *([None] * idx.dim())))(table, idx)
    if any(d in t_dims for d in i_dims):
        # each rank keeps its own ids' rows (a slice, nothing sent)
        out = out.redistribute(mesh, tuple(
            Shard(0) if d in i_dims else Replicate()
            for d in range(mesh.ndim)))
    return out


def model_split(w: torch.Tensor) -> torch.Tensor:
    """A weight entering a product, split over the ``model`` mesh dim
    only: a DTensor's FSDP split over the other dims is gathered (its
    gradient comes back reduce-scattered)."""
    return _keep_splits(w, lambda n, p: n == "model")


def product_input(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x`` laid out for ``x @ w`` with ``w`` a ``model_split`` weight: the
    batch split (dim 0) kept; on a mesh dim where ``w``'s rows (the
    contracted dim) are split, ``x``'s last dim split alike (row-parallel:
    no gather, and the weight's gradient stays a shard); elsewhere whole
    (column-parallel).  A plain ``x`` as it is."""
    if not is_dtensor(x):
        return x
    last = x.dim() - 1
    want = tuple(xp if xp == Shard(0) else
                 Shard(last) if wp == Shard(0) else Replicate()
                 for xp, wp in zip(x.placements, w.placements))
    return x if want == tuple(x.placements) else x.redistribute(
        x.device_mesh, want)


class _ProductGrad(torch.autograd.Function):
    """The identity on a product's DTensor output, whose backward lays the
    cotangent out as the weight's gradient wants it: split over the batch
    (dim 0) and the features (the last dim) as it is, Partial sums summed,
    any other split (a sequence split from a sequence-parallel core)
    gathered.  DTensor would otherwise pick a layout that splits the
    flattened rows over two mesh dims, which its products refuse, or gather
    the weight and repeat every rank's product."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        last = g.dim() - 1
        return _keep_splits(g, lambda n, p: p in (Shard(0), Shard(last)))


def product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w``; on DTensors with the weight's FSDP split gathered
    (``model_split``), ``x`` laid out for it (``product_input``) and the
    cotangent laid out for the weight's gradient (``_ProductGrad``)."""
    if not is_dtensor(x):
        return x @ w
    w = model_split(w)
    return _ProductGrad.apply(product_input(x, w) @ w)


def whole_last_dim(t: torch.Tensor) -> torch.Tensor:
    """``t`` with its last dim whole on every rank (a vocab-split DTensor's
    logits gathered, a Partial one summed; other splits kept); a plain
    tensor as it is."""
    last = t.dim() - 1
    return _keep_splits(t, lambda n, p: isinstance(p, Shard)
                        and p.dim != last)


def rope_table(positions: torch.Tensor, d_head: int, theta: float = 10000.0,
               dtype=torch.float32) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., d_head / 2) cos and sin tables for the given positions."""
    half = d_head // 2
    freqs = replicated_like(1.0 / (theta ** (torch.arange(
        half, dtype=torch.float32, device=positions.device) / half)),
        positions)
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(ang).to(dtype), torch.sin(ang).to(dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x (..., S, H, d_head); cos, sin (..., S, d_head / 2).  Half-split
    layout: the first half of each head pairs with the second."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    cos, sin = cos[..., None, :], sin[..., None, :]   # broadcast over heads
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def softcap(logits: torch.Tensor, cap: float | None) -> torch.Tensor:
    """Logit soft-capping: cap * tanh(x / cap)."""
    if cap is None:
        return logits
    return cap * torch.tanh(logits / cap)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean CE over the valid positions, the logits cast to f32; with a
    mask, sum(nll * mask) / max(sum(mask), 1)."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, -1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is not None:
        m = mask.to(torch.float32)
        return (nll * m).sum() / m.sum().clamp_min(1.0)
    return nll.mean()
