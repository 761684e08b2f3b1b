"""Multi-pod dry run: every (arch x shape x mesh) cell traced on fake tensors.

Proves the distribution config is coherent without a card, as the JAX
package's dry run does by lowering onto 512 host CPU devices:

  * builds the production mesh (16 x 16 single-pod / 2 x 16 x 16
    multi-pod) over a ``fake`` process group of 256 or 512 ranks (this
    process is rank 0; every collective returns at once),
  * builds the cell's step with ``steps.build_bundle`` and its arguments
    as DTensors whose local shards (rank 0's, DTensor's split where a dim
    does not divide) are fake tensors: nothing is allocated,
  * runs the step once under a ``FakeTensorMode`` that sees every op rank
    0 runs on its local shards, and counts per device: the FLOPs
    (``FlopCounterMode``'s formulas on the local shapes), the bytes
    accessed, the collectives, and the peak of the bytes alive.

The models call no hand-written kernel here: fake CPU tensors take each
kernel's plain version, as the JAX package's dry run lowers its jnp
versions, so the per-device numbers describe the plain versions where the
card would run kernels.  ``bytes_accessed`` is each op's inputs read plus
its outputs written, unfused: it overstates XLA's fused count.  The
roofline terms divide by ``mesh.HW``, the H100's datasheet peaks (not
measurements).

Usage:
  python -m repro_torch.launch.dryrun --arch olmo-1b --shape decode_32k --mesh single
  python -m repro_torch.launch.dryrun --all --mesh both --out results.json [--jobs 4]
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import sys
import time
import traceback
import weakref

import torch

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

# the collective ops DTensor (``_c10d_functional``) and ``torch.distributed``
# (``c10d``, as ``launch/mesh.py``'s psum, pmax and all_gather issue them)
# run, under the JAX package's names
_COLLECTIVE_OPS = {
    "all_reduce": "all-reduce", "allreduce_": "all-reduce",
    "all_gather_into_tensor": "all-gather", "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
}


def parse_collectives(records) -> dict:
    """Per-device collective schedule from (name, bytes) records, one a
    collective issued (``name`` one of ``COLLECTIVES``, ``bytes`` its local
    result's): op counts, bytes and the estimated wire bytes (ring
    algorithm: all-reduce 2x payload, others ~1x), in the JAX package's
    layout."""
    stats = {c: dict(count=0, bytes=0) for c in COLLECTIVES}
    for name, nbytes in records:
        stats[name]["count"] += 1
        stats[name]["bytes"] += int(nbytes)
    wire = sum((2.0 if c == "all-reduce" else 1.0) * st["bytes"]
               for c, st in stats.items())
    return dict(per_op=stats, wire_bytes_per_device=wire)


def roofline_terms(per_dev_flops, per_dev_bytes, wire_bytes, n_chips,
                   hw=None):
    """Seconds of compute, memory and collectives a device needs at the
    peaks of ``hw`` (default ``mesh.HW``: H100 datasheet numbers)."""
    from .mesh import HW
    hw = hw or HW
    return dict(
        compute_s=per_dev_flops / hw["peak_flops_bf16"],
        memory_s=per_dev_bytes / hw["hbm_bw"],
        collective_s=wire_bytes / hw["ici_bw"],
        n_chips=n_chips,
    )


# ----------------------------------------------------------------- tracing
def _tensors(tree):
    from ..tree import leaves
    return [x for x in leaves(tree) if isinstance(x, torch.Tensor)]


def _local(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor
    return t._local_tensor if isinstance(t, DTensor) else t


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _make_tracer():
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import flop_registry

    class Tracer(FakeTensorMode):
        """A FakeTensorMode that counts what rank 0 runs: each op on fake
        local tensors passes through here once."""

        def __init__(self):
            super().__init__(allow_non_fake_inputs=True)
            self.reset()
            self.live = self.peak = 0
            self.paused = 0
            self.depth = 0          # ops issued inside another op's run
            self._held = {}
            self.read = set()       # storages some op read

        def reset(self):
            self.flops = 0
            self.bytes = 0
            self.collectives = []

        def _free(self, key):
            self.live -= self._held.pop(key)

        def _hold(self, t):
            st = t.untyped_storage()
            key = id(st)
            if key in self._held:
                return
            n = st.nbytes()
            self._held[key] = n
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key)

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            # the fake implementation of an op may run other ops through
            # this mode (a meta function's new_empty, a decomposition; only
            # when its result is not in FakeTensorMode's per-process cache
            # yet): they are that op's own work, not rank 0's, so only the
            # outermost op counts
            self.depth += 1
            try:
                out = super().__torch_dispatch__(func, types, args, kwargs)
            finally:
                self.depth -= 1
            if out is NotImplemented or self.paused or self.depth:
                return out
            name = func.__name__.split(".")[0]
            outs = [t for t in _flat(out) if isinstance(t, torch.Tensor)]
            if func.namespace in ("_c10d_functional", "c10d",
                                  "_c10d_functional_autograd"):
                # a collective moves wire bytes, not HBM bytes; its result
                # buffer is the one its wait returns (a new fake tensor
                # here, the same buffer on the card)
                coll = _COLLECTIVE_OPS.get(name)
                if coll is not None:
                    self.read.update(
                        id(t.untyped_storage()) for t in _flat((args, kwargs))
                        if isinstance(t, torch.Tensor))
                    res = outs or [t for t in _flat((args, kwargs))
                                   if isinstance(t, torch.Tensor)][:1]
                    self.collectives.append(
                        (coll, sum(_nbytes(t) for t in res)))
                    if func.namespace == "c10d":
                        for t in outs:
                            self._hold(t)
                elif name == "wait_tensor":
                    for t in outs:
                        self._hold(t)
                return out
            if func.is_view or func.namespace == "prim" or not outs:
                return out
            packet = func._overloadpacket
            if packet in flop_registry:
                self.flops += flop_registry[packet](*args, **kwargs,
                                                    out_val=out)
            ins = {id(t): t for t in _flat((args, kwargs))
                   if isinstance(t, torch.Tensor)}
            self.read.update(id(t.untyped_storage()) for t in ins.values())
            self.bytes += sum(_nbytes(t) for t in ins.values())
            self.bytes += sum(_nbytes(t) for t in outs)
            for t in outs:
                self._hold(t)
            return out

    return Tracer()


@contextlib.contextmanager
def _meta_inference_paused(tracer):
    """DTensor infers an op's output layout and metadata by running ops on
    fake tensors of the GLOBAL shapes (its metadata pass, and for an op
    without a sharding rule of its own, the op's decomposition), which
    reach the tracer too: those runs are not rank 0's work, so the tracer
    counts nothing while they last.  Both are cached per process, so
    counting them would also make a cell's numbers depend on the cells
    traced before it in the same process."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    names = ("propagate_op_sharding_non_cached",
             "_propagate_tensor_meta_non_cached")
    origs = {n: getattr(ShardingPropagator, n) for n in names}

    def paused(orig):
        def run(self, *a, **kw):
            tracer.paused += 1
            try:
                return orig(self, *a, **kw)
            finally:
                tracer.paused -= 1
        return run

    for n, orig in origs.items():
        setattr(ShardingPropagator, n, paused(orig))
    try:
        yield
    finally:
        for n, orig in origs.items():
            setattr(ShardingPropagator, n, orig)


def _flat(x):
    from torch.utils._pytree import tree_leaves
    return tree_leaves(x)


def _fake_args(tree, spec_tree, mesh, tracer):
    """DTensors of the abstract ``tree``'s leaves, split by ``spec_tree``:
    each a fake local shard of rank 0 (DTensor's split: uneven dims give
    the first ranks the larger pieces)."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    from ..tree import leaves, unflatten
    from .shardings import spec_leaves, to_placements

    out = []
    for x, s in zip(leaves(tree), spec_leaves(spec_tree), strict=True):
        pl = to_placements(s, mesh)
        local_shape, _ = compute_local_shape_and_global_offset(
            x.shape, mesh, pl)
        with tracer:
            loc = torch.empty(local_shape, dtype=x.dtype)
        stride = torch.empty(x.shape, device="meta").stride()
        out.append(DTensor.from_local(loc, mesh, pl, run_check=False,
                                      shape=torch.Size(x.shape),
                                      stride=stride))
    return unflatten(tree, out)


def trace_bundle(bundle, mesh) -> dict:
    """Run ``bundle.fn`` once on fake DTensor arguments; the per-device
    counts of what rank 0 ran (``flops``, ``bytes_accessed``, the
    ``collectives`` records, the argument, output, temporary and donated
    (``alias``) bytes, ``read_argument_bytes``: the arguments some op
    reads (XLA leaves an unread argument out of its argument bytes),
    ``live_bytes``: the peak of the bytes alive, the arguments included)
    and ``trace_s``."""
    from .mesh import use_mesh

    tracer = _make_tracer()
    args = tuple(_fake_args(t, s, mesh, tracer)
                 for t, s in zip(bundle.args, bundle.in_specs, strict=True))
    arg_locals = [_local(t) for a in args for t in _tensors(a)]
    arg_bytes = sum(_nbytes(t) for t in arg_locals)
    alias = sum(_nbytes(_local(t)) for i in bundle.donate_argnums
                for t in _tensors(args[i]))
    tracer.reset()
    tracer.peak = tracer.live
    t0 = time.perf_counter()
    with tracer, use_mesh(mesh), _meta_inference_paused(tracer):
        out = bundle.fn(*args)
    trace_s = time.perf_counter() - t0
    arg_storages = {id(t.untyped_storage()) for t in arg_locals}
    out_bytes = sum(_nbytes(_local(t)) for t in _tensors(out)
                    if id(_local(t).untyped_storage()) not in arg_storages)
    read_bytes = sum(_nbytes(t) for t in arg_locals
                     if id(t.untyped_storage()) in tracer.read)
    return dict(flops=float(tracer.flops),
                bytes_accessed=float(tracer.bytes),
                collectives=list(tracer.collectives),
                argument_bytes=arg_bytes, read_argument_bytes=read_bytes,
                output_bytes=out_bytes,
                temp_bytes=tracer.peak - arg_bytes, alias_bytes=alias,
                live_bytes=tracer.peak, trace_s=trace_s)


# ------------------------------------------------------------- the group
def fake_group(world: int) -> None:
    """The default process group as a ``fake`` group of ``world`` ranks,
    this process rank 0 (the group is made anew when its size differs)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("the dry run needs the default process group "
                               "to itself: run it in a process of its own")
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def fake_mesh(shape: tuple, names: tuple):
    """A CPU ``DeviceMesh`` of ``shape`` over a fake group of its size."""
    from .mesh import _init_mesh
    fake_group(math.prod(shape))
    return _init_mesh("cpu", tuple(shape), tuple(names))


def production_mesh(multi_pod: bool):
    if multi_pod:
        return fake_mesh((2, 16, 16), ("pod", "data", "model"))
    return fake_mesh((16, 16), ("data", "model"))


# ----------------------------------------------------------------- costs
def _cost_of(counts: dict, skip_hlo: bool = False):
    coll = (dict(per_op={}, wire_bytes_per_device=0.0) if skip_hlo
            else parse_collectives(counts["collectives"]))
    return counts["flops"], counts["bytes_accessed"], coll


def measured_cost(spec, shape_name, mesh, skip_hlo=False):
    """Per-device cost from two unrolled, single-chunk variants at 2 and 4
    layers, fitted linearly in n_layers, extrapolated to the real depth and
    rescaled by the microbatch count (``steps.analysis_variant``), as the
    JAX package's, so that the two compare cell by cell.  None for the
    recsys family."""
    from .steps import analysis_variant, build_bundle
    if analysis_variant(spec, shape_name, 2, mesh) is None:
        return None
    cfg_layers = spec.config.n_layers
    pts = []
    for L in (2, 4):
        spec2, _, scale = analysis_variant(spec, shape_name, L, mesh)
        counts = trace_bundle(build_bundle(spec2, shape_name, mesh), mesh)
        f, b, c = _cost_of(counts, skip_hlo)
        pts.append((L, f, b, c["wire_bytes_per_device"], scale,
                    counts["read_argument_bytes"]))
    (l1, f1, b1, w1, sc, _), (l2, f2, b2, w2, _, _) = pts

    def fit(c1, c2):
        slope = (c2 - c1) / (l2 - l1)
        return max((c1 - slope * l1) + slope * cfg_layers, 0.0)

    return dict(flops=fit(f1, f2) * sc,
                bytes_accessed=fit(b1, b2) * sc,
                wire_bytes=fit(w1, w2) * sc,
                fit_points=[dict(L=p[0], flops=p[1], bytes=p[2],
                                 wire=p[3], read_argument_bytes=p[5])
                            for p in pts],
                microbatch_scale=sc)


def run_cell(arch_id: str, shape_name: str, multi_pod: bool,
             skip_hlo: bool = False, mesh=None) -> dict:
    """One cell: the full-depth trace gives ``live_bytes``, ``fits_hbm``
    and the raw counts (torch unrolls every loop, so ``raw_while_once``
    holds the full trace's own counts, not one loop body's), the fitted
    variants the FLOPs, bytes and wire bytes (``measured_cost``).  ``mesh``
    replaces the production mesh (a (1, 1) one, for example)."""
    from ..configs import get_arch
    from .mesh import HW
    from .shardings import mesh_shape
    from .steps import build_bundle

    spec = get_arch(arch_id)
    shape = spec.shapes[shape_name]
    tag = "multi" if multi_pod else "single"
    if shape.skip:
        return dict(arch=arch_id, shape=shape_name, mesh=tag,
                    status="skipped", reason=shape.skip)
    t0 = time.time()
    mesh = mesh if mesh is not None else production_mesh(multi_pod)
    n_chips = math.prod(mesh_shape(mesh).values())
    bundle = build_bundle(spec, shape_name, mesh)
    t_lower = time.time() - t0
    counts = trace_bundle(bundle, mesh)
    t_compile = time.time() - t0 - t_lower
    live = counts["live_bytes"]
    raw_flops, raw_bytes, coll = _cost_of(counts, skip_hlo)
    corr = measured_cost(spec, shape_name, mesh, skip_hlo)
    if corr is not None:
        flops, bytes_accessed = corr["flops"], corr["bytes_accessed"]
        wire = corr["wire_bytes"]
    else:
        flops, bytes_accessed = raw_flops, raw_bytes
        wire = coll["wire_bytes_per_device"]
    terms = roofline_terms(flops, bytes_accessed, wire, n_chips)
    mem_info = {k: counts[k] for k in (
        "argument_bytes", "read_argument_bytes", "output_bytes",
        "temp_bytes", "alias_bytes")}
    return dict(
        arch=arch_id, shape=shape_name, mesh=tag, status="ok",
        kind=shape.kind, n_chips=n_chips,
        lower_s=round(t_lower, 1), compile_s=round(t_compile, 1),
        trace_s=round(time.time() - t0 - t_lower, 2),
        per_device=dict(flops=flops, bytes_accessed=bytes_accessed,
                        wire_bytes=wire, live_bytes=live,
                        raw_while_once=dict(flops=raw_flops,
                                            bytes=raw_bytes),
                        code_bytes=None, **mem_info),
        fits_hbm=bool(live <= HW["hbm_bytes"]) if live else None,
        collectives=coll, scan_correction=corr, roofline=terms,
    )


def _run_tagged(job) -> dict:
    """``run_cell`` of one (arch, shape, multi_pod, skip_hlo), a failure
    recorded as an ``error`` result."""
    arch_id, shape_name, mp, skip_hlo = job
    try:
        return run_cell(arch_id, shape_name, mp, skip_hlo=skip_hlo)
    except Exception as e:  # record failures, keep going
        return dict(arch=arch_id, shape=shape_name,
                    mesh="multi" if mp else "single",
                    status="error", error=f"{type(e).__name__}: {e}",
                    trace=traceback.format_exc()[-2000:])


def _line(r: dict) -> str:
    tag = f"{r['arch']}/{r['shape']}/{r['mesh']}"
    extra = ""
    if r["status"] == "ok":
        t = r["roofline"]
        extra = (f" flops/dev={r['per_device']['flops']:.3e}"
                 f" live={r['per_device']['live_bytes']/2**30:.2f}GiB"
                 f" comp={t['compute_s']:.4f}s"
                 f" mem={t['memory_s']:.4f}s"
                 f" coll={t['collective_s']:.4f}s"
                 f" trace={r['trace_s']}s")
    elif r["status"] == "error":
        extra = " " + r["error"][:200]
    return f"[dryrun] {tag}: {r['status']}{extra}"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--skip-hlo", action="store_true",
                    help="skip the collective schedule (faster)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells traced at once, each in a process of its "
                         "own (each makes its own fake group)")
    args = ap.parse_args(argv)

    from ..configs import all_cells
    cells = all_cells(include_skipped=True) if args.all else \
        [(args.arch, args.shape)]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    jobs = [(a, s, mp, args.skip_hlo) for a, s in cells for mp in meshes]
    results = [None] * len(jobs)

    def keep(i, r):
        results[i] = r
        print(_line(r), flush=True)
        if args.out:
            with open(args.out, "w") as f:
                json.dump([x for x in results if x is not None], f,
                          indent=1)

    if args.jobs > 1:
        import multiprocessing as mp_
        with mp_.get_context("spawn").Pool(args.jobs,
                                           maxtasksperchild=1) as pool:
            for i, r in pool.imap_unordered(_indexed, enumerate(jobs)):
                keep(i, r)
    else:
        for i, job in enumerate(jobs):
            keep(i, _run_tagged(job))
    n_err = sum(r["status"] == "error" for r in results)
    print(f"[dryrun] done: {len(results)} cells, {n_err} errors", flush=True)
    return 1 if n_err else 0


def _indexed(item):
    i, job = item
    return i, _run_tagged(job)


if __name__ == "__main__":
    sys.exit(main())
