"""The mesh runtime: device meshes, the per-rank map and its collectives.

Execution model.  A mesh is a ``torch.distributed.device_mesh.DeviceMesh``
with the JAX package's axis names (('data', 'model') or ('pod', 'data',
'model')).  A ``PartitionSpec`` becomes one DTensor ``Placement`` a mesh
dimension (``shardings.to_placements``).  Each ``shard_map`` of the JAX
package becomes ``shard_map`` here: a ``local_map`` with the same in/out
specs.  The mesh functions (``moe_ffn_sharded``, ``seq_parallel_attention``,
``compressed_psum``) take and return global tensors, plain or DTensor, as
``shard_map``'s callers do: a plain tensor is the same whole tensor on every
rank, and comes back whole.  The body runs once per rank on that rank's
local shards, with explicit collectives (``psum``, ``pmean``,
``all_gather``) over ``mesh.get_group(axis)``.  Where the JAX package reads
the ambient mesh (``set_mesh``, ``get_abstract_mesh()``), the port takes an
explicit ``mesh=`` keyword, and falls back to ``use_mesh(mesh)`` only where
``LMConfig``'s axis-name fields have to find it.

Gradients are the JAX package's: ``jax.grad`` through its ``shard_map``
equals the gradient of the unsharded function.  Its transpose rules are
kept: ``psum``'s backward is a ``psum``, ``all_gather``'s a reduce-scatter;
an input replicated over an axis sums its ranks' gradients (its grad
placement there is ``Partial``); an output replicated over an axis hands
each rank 1 / (the replicas) of its cotangent.  (A sum whose backward were
itself a sum, with no such scaling, would make expert-parallel gradients
``model``-times too large.)

The ranks of a mesh are global ranks of the default process group, and
every rank of that group takes part in building a mesh.  On the card the
group is NCCL; the CPU tests run ``gloo`` groups of 1 and 4 ranks.
"""
from __future__ import annotations

import contextlib
import contextvars
import math

import torch

from .shardings import P, mesh_axis_names, to_placements

# Per-card constants of the target (NVIDIA H100 SXM datasheet; all for an
# NVIDIA H100 80GB HBM3 at its 700 W limit), under the JAX package's keys
HW = dict(
    peak_flops_bf16=989e12,       # FLOP/s, dense bf16 (H100 SXM, 700 W)
    hbm_bw=3.35e12,               # B/s of HBM3 (H100 SXM, 700 W)
    # the NVLink rate per card (900 GB/s, H100 SXM, 700 W) under the JAX
    # package's inter-chip-interconnect key
    ici_bw=900e9,
    hbm_bytes=80e9,               # bytes of HBM3 (H100 80GB, 700 W)
)

_MESH: contextvars.ContextVar = contextvars.ContextVar("mesh", default=None)


def _init_mesh(device_type: str, shape: tuple, names: tuple):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("no default process group: call "
                           "torch.distributed.init_process_group first")
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise ValueError(f"a {shape} mesh needs {math.prod(shape)} ranks; "
                         f"the default group has {world}")
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """16 x 16 = 256 ranks a pod; 2 pods = 512 ranks multi-pod, over the
    default process group."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _init_mesh(device_type, shape, axes)


def make_host_mesh(device_type: str = "cuda"):
    """A one-rank (1, 1) mesh with the production axis names: every
    sharding rule runs unchanged on one card (or one CPU process)."""
    return _init_mesh(device_type, (1, 1), ("data", "model"))


@contextlib.contextmanager
def use_mesh(mesh):
    """The mesh that ``current_mesh()`` returns inside the block."""
    token = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(token)


def current_mesh():
    mesh = _MESH.get()
    if mesh is None:
        raise ValueError("no mesh: pass mesh= or call inside use_mesh(mesh)")
    return mesh


def axis_size(mesh, axes) -> int:
    axes = axes if isinstance(axes, tuple) else (axes,)
    names = mesh_axis_names(mesh)
    return math.prod(mesh.size(names.index(a)) for a in axes)


# ------------------------------------------------------------ collectives
def _all_reduce(x: torch.Tensor, groups) -> torch.Tensor:
    import torch.distributed as dist

    y = x.clone()
    for g in groups:
        dist.all_reduce(y, group=g)
    return y


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return _all_reduce(x, groups)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.groups), None


class _PMax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        import torch.distributed as dist

        y = x.clone()
        for g in groups:
            dist.all_reduce(y, op=dist.ReduceOp.MAX, group=g)
        ctx.groups = groups
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        held = (x == y).to(g.dtype)
        return g * held / _all_reduce(held, ctx.groups), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        import torch.distributed as dist

        ctx.group, ctx.dim = group, dim
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        total = _all_reduce(g, [ctx.group])
        n = dist.get_world_size(ctx.group)
        return total.chunk(n, ctx.dim)[dist.get_rank(ctx.group)], None, None


def _shard_view(x: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's shard of a whole tensor, as a view: split along each
    ``Shard`` dim, mesh dims in order (major to minor)."""
    for i, p in enumerate(placements):
        if p.is_shard():
            n = mesh.size(i)
            size = x.shape[p.dim] // n
            if size * n != x.shape[p.dim]:
                raise ValueError(f"dim {p.dim} of {tuple(x.shape)} does not "
                                 f"split {n} ways")
            x = x.narrow(p.dim, mesh.get_local_rank(i) * size, size)
    return x


class _LocalShard(torch.autograd.Function):
    """This rank's shard of a tensor that every rank holds whole (no
    copy).  Its backward puts the shard's gradient in place in a zero
    tensor and sums that over the mesh dims the tensor is split on, which
    gathers the other ranks' shards."""

    @staticmethod
    def forward(ctx, x, mesh, placements):
        ctx.mesh, ctx.placements, ctx.shape = mesh, placements, x.shape
        return _shard_view(x, mesh, placements)

    @staticmethod
    def backward(ctx, g):
        full = g.new_zeros(ctx.shape)
        _shard_view(full, ctx.mesh, ctx.placements).copy_(g)
        groups = [ctx.mesh.get_group(i)
                  for i, p in enumerate(ctx.placements) if p.is_shard()]
        return _all_reduce(full, groups), None, None


class _ScaleGrad(torch.autograd.Function):
    """The identity, whose backward scales the cotangent."""

    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def _groups(mesh, axes) -> list:
    axes = axes if isinstance(axes, tuple) else (axes,)
    return [mesh.get_group(a) for a in axes]


def psum(x: torch.Tensor, axes, mesh) -> torch.Tensor:
    """Sum over the ranks of ``axes`` (a name or a tuple of names), in x's
    dtype; its backward is the same sum."""
    return _PSum.apply(x, _groups(mesh, axes))


def pmax(x: torch.Tensor, axes, mesh) -> torch.Tensor:
    """The elementwise maximum over the ranks of ``axes``; its backward
    hands each element's cotangent to the ranks that hold the maximum,
    split evenly among them."""
    return _PMax.apply(x, _groups(mesh, axes))


def pmean(x: torch.Tensor, axes, mesh) -> torch.Tensor:
    return psum(x, axes, mesh) / axis_size(mesh, axes)


def all_gather(x: torch.Tensor, axis: str, dim: int, mesh) -> torch.Tensor:
    """The ``axis`` ranks' shards concatenated along ``dim`` (tiled); its
    backward sums the cotangents over ``axis`` and keeps this rank's
    chunk."""
    return _AllGather.apply(x, mesh.get_group(axis), dim)


# ------------------------------------------------------------- shard_map
def shard_map(fn, *, mesh, in_specs, out_specs):
    """``fn`` run on each rank's local shards: the inputs split by
    ``in_specs``, the outputs put together by ``out_specs`` (a spec, or a
    tuple of specs for a tuple of outputs).  Plain tensors in, plain whole
    tensors out; with any DTensor input, DTensors out.  A plain input's
    shard is a view of it (DTensor's own split would copy it: on one card
    that is a second copy of every expert weight)."""
    from torch.distributed.tensor import DTensor, Partial
    from torch.distributed.tensor.experimental import local_map

    single = isinstance(out_specs, P)
    outs = (out_specs,) if single else tuple(out_specs)
    in_pl = tuple(to_placements(s, mesh) for s in in_specs)
    grad_pl = tuple(tuple(Partial() if p.is_replicate() else p for p in pl)
                    for pl in in_pl)
    out_pl = tuple(to_placements(s, mesh) for s in outs)
    replicas = [math.prod(mesh.size(i) for i, p in enumerate(pl)
                          if p.is_replicate()) for pl in out_pl]

    def body(*local):
        res = fn(*local)
        res = (res,) if single else tuple(res)
        return tuple(_ScaleGrad.apply(r, 1.0 / n) if n > 1 else r
                     for r, n in zip(res, replicas, strict=True))

    mapped = local_map(body, out_placements=out_pl, in_placements=in_pl,
                       in_grad_placements=grad_pl, device_mesh=mesh,
                       redistribute_inputs=True)

    def as_dtensor(a, placements):
        if isinstance(a, DTensor):
            return a
        return DTensor.from_local(_LocalShard.apply(a, mesh, placements),
                                  mesh, placements, run_check=False,
                                  shape=a.shape, stride=a.stride())

    def call(*args):
        distributed = any(isinstance(a, DTensor) for a in args)
        res = mapped(*(as_dtensor(a, pl)
                       for a, pl in zip(args, in_pl, strict=True)))
        if not distributed:
            res = tuple(r.full_tensor() for r in res)
        return res[0] if single else res

    return call
