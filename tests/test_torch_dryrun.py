"""The port's dry run (``launch/dryrun.py``, ``launch/steps.py``'s bundles,
the configs' ``inputs`` and cells) held to the JAX package's.

Four subprocesses run at once (module fixture ``sides``):

  * the reference, with 512 forced host devices, on meshes with ``Auto``
    axes (``jax.make_mesh``'s default ``Explicit`` axes stop its LM cells
    at ``with_sharding_constraint`` and ``dynamic_update_slice`` on JAX
    0.9): the cells, every cell's inputs, every bundle on both production
    meshes, the analysis variants, both optimizers' specs, the collective
    parser on an HLO snippet, and the lowered cost of three cells;
  * the port's side of the same (bundles on ``AbstractMesh``es), plus the
    three cells traced on a fake 256-rank group and an exact sharded
    matmul;
  * the port's every non-skipped cell at its smoke config traced on a
    fake (2, 2) mesh;
  * Adafactor's per-rank update of split leaves on a 4-rank ``gloo``
    (2, 2) mesh against the plain update.

Each writes JSON; the parametrised tests compare a cell each.  Run as a
script (``python tests/test_torch_dryrun.py reference|port|smoke OUT``)
it computes one side into OUT.

FLOPs (a band a cell, FLOPS_BAND, on port / XLA, both fitted to the real
depth as each package's ``measured_cost`` does; measured on a CPU with
JAX 0.9.0): the port counts ``FlopCounterMode``'s formulas
(matmul-class ops only) where XLA's ``cost_analysis`` also counts
elementwise and reduction ops; the port's remat recomputes each layer's
forward in full inside the backward (olmo-1b train_4k: 1.09 at the
2-layer variant, 0.987 fitted to 16 layers; xDeepFM serve_p99: 0.997).
olmo-1b decode_32k reads 0.095: XLA on the Auto mesh runs each layer's
decode attention over the whole 32,768-position cache on every model rank
(2.26e9 a layer), the port over the rank's own 2,048 positions
(``attention.sharded_decode``), so the port's per-layer count is instead
held exactly to the analytic count of its products.
Argument bytes: XLA leaves arguments the step never reads out of its
count (``jax.jit`` drops unused arguments: olmo-1b's non-parametric norms
keep zero weights that decode never reads), so the port's
``read_argument_bytes`` is held to it exactly; the three cells split
evenly, so no shard padding enters.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
# port FLOPs / XLA FLOPs a device (see the module docstring)
FLOPS_BAND = {"olmo-1b/train_4k": (0.9, 1.15),
              "olmo-1b/decode_32k": (0.06, 0.15),
              "xdeepfm/serve_p99": (0.9, 1.1)}
MESHES = ("single", "multi")
COST_CELLS = (("olmo-1b", "train_4k"), ("olmo-1b", "decode_32k"),
              ("xdeepfm", "serve_p99"))
# the collective parser's HLO case (tests/test_runtime.py) as the port's
# records: (name, bytes of the local result)
HLO = """
  %ar = bf16[64,128]{1,0} all-reduce(%x), replica_groups={}
  %ag.1 = f32[256]{0} all-gather(%y), dimensions={0}
  %junk = f32[2] add(%a, %b)
  %rs = (f32[16], f32[16]) reduce-scatter(%z, %w)
"""
HLO_RECORDS = [("all-reduce", 64 * 128 * 2), ("all-gather", 256 * 4),
               ("reduce-scatter", 2 * 16 * 4)]
LM_FIELDS = ("act_batch_axes", "act_model_axis", "attn_seq_parallel",
             "moe_batch_axes", "moe_expert_axis", "moe_fsdp_axis",
             "moe_expert_parallel")
# smoke shapes of the (2, 2) traces: small enough to trace in a second
SMOKE_DIMS = {
    "lm": {"train_4k": dict(seq=32, batch=8),
           "prefill_32k": dict(seq=32, batch=4),
           "decode_32k": dict(seq=32, batch=4),
           "long_500k": dict(seq=64, batch=1)},
    "gnn": dict(n_nodes=24, n_edges=64),
    "recsys": {"train_batch": dict(batch=16), "serve_p99": dict(batch=8),
               "serve_bulk": dict(batch=8),
               "retrieval_cand": dict(batch=1, n_candidates=64)}}


def _cell_ids():
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import all_cells
    return all_cells(), all_cells(include_skipped=True)


CELLS, ALL_CELLS = _cell_ids()


# ------------------------------------------------------------- normalizers
def _entry(e):
    if isinstance(e, (tuple, list)):
        e = [x for x in e]
        return e[0] if len(e) == 1 else e
    return e


def _spec(p) -> list:
    return [_entry(e) for e in p]


def _dtype(dt) -> str:
    return str(dt).replace("torch.", "")


# ------------------------------------------------------------ the reference
def _ref_path(path) -> str:
    from jax.tree_util import DictKey, GetAttrKey, SequenceKey
    out = []
    for k in path:
        if isinstance(k, DictKey):
            out.append(str(k.key))
        elif isinstance(k, GetAttrKey):
            out.append("." + k.name)
        elif isinstance(k, SequenceKey):
            out.append(str(k.idx))
        else:
            out.append(str(k))
    return "/".join(out)


def _ref_leaves(tree, is_leaf=None):
    import jax
    return [(_ref_path(p), x) for p, x in
            jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]]


def _ref_specs(tree):
    from jax.sharding import NamedSharding, PartitionSpec
    is_leaf = lambda x: isinstance(x, (NamedSharding, PartitionSpec))  # noqa
    return [[p, _spec(x.spec if isinstance(x, NamedSharding) else x)]
            for p, x in _ref_leaves(tree, is_leaf)]


def _ref_args(tree):
    return [[p, list(x.shape), _dtype(x.dtype)] for p, x in _ref_leaves(tree)]


def run_reference(out: Path) -> None:
    import inspect

    import jax
    from jax.sharding import AxisType

    from repro.configs import ARCHS, all_cells, get_arch
    from repro.launch import dryrun, mesh as ref_mesh, steps
    from repro.launch import shardings as sh

    def mesh(tag):
        shape, axes = (((2, 16, 16), ("pod", "data", "model"))
                       if tag == "multi" else ((16, 16), ("data", "model")))
        return jax.make_mesh(shape, axes,
                             axis_types=(AxisType.Auto,) * len(shape))

    meshes = {t: mesh(t) for t in MESHES}
    res = dict(cells=dict(all=all_cells(),
                          skipped=all_cells(include_skipped=True),
                          per_arch={a: s.cells() for a, s in ARCHS.items()}),
               hw=dict(ref_mesh.HW))
    res["inputs"] = {f"{a}/{s}": _ref_args(
        ARCHS[a].inputs(ARCHS[a].config, ARCHS[a].shapes[s]))
        for a, s in all_cells(include_skipped=True)}
    bundles = {}
    for a, s in all_cells():
        for tag, m in meshes.items():
            b = steps.build_bundle(get_arch(a), s, m)
            nl = inspect.getclosurevars(b.fn).nonlocals
            cfg = nl["spec"].config if "spec" in nl else nl.get("cfg")
            fields = {}
            if ARCHS[a].family == "lm":
                fields = {f: getattr(cfg, f) for f in LM_FIELDS}
            elif ARCHS[a].family == "gnn":
                fields = dict(d_node_in=cfg.d_node_in)
            outs = None if b.out_shardings is None else [
                None if o is None else _ref_specs(o)
                for o in (b.out_shardings if isinstance(b.out_shardings,
                                                        tuple)
                          else (b.out_shardings,))]
            bundles[f"{a}/{s}/{tag}"] = dict(
                name=b.name, donate=list(b.donate_argnums),
                n_micro=nl.get("n_micro", 1), fields=fields,
                args=[_ref_args(x) for x in b.args],
                in_specs=[_ref_specs(x) for x in b.in_shardings],
                out_specs=outs)
    res["bundles"] = bundles
    res["analysis"] = _analysis(steps.analysis_variant, ARCHS,
                                dict(meshes, none=None))
    res["opt"] = _opt_cases(steps, sh, get_arch, meshes["single"],
                            lambda t: _ref_specs(t))
    res["hlo"] = dryrun.parse_collectives(HLO)
    res["roofline"] = dryrun.roofline_terms(197e12, 819e9, 50e9, 256)
    cost = {}
    for a, s in COST_CELLS:
        spec = get_arch(a)
        corr = dryrun.measured_cost(spec, s, meshes["single"])
        if ARCHS[a].shapes[s].kind == "train":
            # the arguments of the 2-layer variant (the port's fitted
            # points carry them), not the 16-layer cell's own compile
            spec = steps.analysis_variant(spec, s, 2, meshes["single"])[0]
        comp = dryrun._lower_compile(spec, s, meshes["single"])
        flops = (corr["flops"] if corr is not None
                 else dryrun._cost_of(comp, True)[0])
        cost[f"{a}/{s}"] = dict(
            flops=flops,
            argument_bytes=comp.memory_analysis().argument_size_in_bytes)
    res["cost"] = cost
    out.write_text(json.dumps(res))


def _analysis(analysis_variant, archs, meshes) -> dict:
    res = {}
    for a, spec in archs.items():
        for s in spec.shapes:
            for tag, m in meshes.items():
                for L in (2, 4):
                    v = analysis_variant(spec, s, L, m)
                    if v is None:
                        res[f"{a}/{s}/{tag}/{L}"] = None
                        continue
                    spec2, shape2, scale = v
                    c = spec2.config
                    res[f"{a}/{s}/{tag}/{L}"] = dict(
                        n_layers=c.n_layers, scan_layers=c.scan_layers,
                        chunks=[getattr(c, k, None) for k in
                                ("q_chunk", "kv_chunk", "ce_chunk")],
                        dims=dict(shape2.dims),
                        n_micro=shape2.n_microbatches, scale=scale,
                        same_shape=spec2.shapes[s] == shape2)
    return res


def _opt_cases(steps, sh, get_arch, mesh, specs) -> dict:
    """Both optimizers' state specs over two archs' parameters (each arch
    with the optimizer it does not train with as well)."""
    res = {}
    for a in ("llama3-8b", "arctic-480b"):
        spec = get_arch(a)
        params_abs, _ = steps.abstract_state(spec, with_opt=False)
        rule = sh.PARAM_RULES[spec.family](spec.config, spec.fsdp, mesh)
        pspecs = sh.tree_specs(params_abs, rule)
        for opt in ("adamw", "adafactor"):
            res[f"{a}/{opt}"] = specs(steps.opt_specs_for(opt, pspecs,
                                                          params_abs))
    return res


# ----------------------------------------------------------------- the port
def _port_leaves(tree, is_leaf=None):
    from repro_torch.tree import leaves_with_paths
    kw = {} if is_leaf is None else dict(is_leaf=is_leaf)
    return [("/".join(str(k) for k in p), x)
            for p, x in leaves_with_paths(tree, **kw)]


def _port_specs(tree):
    from repro_torch.launch.shardings import P
    return [[p, _spec(x)] for p, x in
            _port_leaves(tree, lambda x: isinstance(x, P))]


def _port_args(tree):
    return [[p, list(x.shape), _dtype(x.dtype)] for p, x in
            _port_leaves(tree)]


def run_port(out: Path) -> None:
    import torch

    from repro_torch.configs import ARCHS, all_cells, get_arch
    from repro_torch.configs.base import TensorSpec
    from repro_torch.launch import dryrun, steps
    from repro_torch.launch import shardings as sh
    from repro_torch.launch.shardings import AbstractMesh, P

    meshes = {"single": AbstractMesh({"data": 16, "model": 16},
                                     ("data", "model")),
              "multi": AbstractMesh({"pod": 2, "data": 16, "model": 16},
                                    ("pod", "data", "model"))}
    res = dict(cells=dict(all=all_cells(),
                          skipped=all_cells(include_skipped=True),
                          per_arch={a: s.cells() for a, s in ARCHS.items()}))
    res["inputs"] = {f"{a}/{s}": _port_args(
        ARCHS[a].inputs(ARCHS[a].config, ARCHS[a].shapes[s]))
        for a, s in all_cells(include_skipped=True)}
    bundles = {}
    for a, s in all_cells():
        for tag, m in meshes.items():
            b = steps.build_bundle(get_arch(a), s, m)
            fields = {}
            if ARCHS[a].family == "lm":
                fields = {f: getattr(b.config, f) for f in LM_FIELDS}
                fields = {k: list(v) if isinstance(v, tuple) else v
                          for k, v in fields.items()}
            elif ARCHS[a].family == "gnn":
                fields = dict(d_node_in=b.config.d_node_in)
            outs = None if b.out_specs is None else [
                None if o is None else _port_specs(o) for o in
                (b.out_specs if isinstance(b.out_specs, tuple)
                 and not isinstance(b.out_specs, P) else (b.out_specs,))]
            bundles[f"{a}/{s}/{tag}"] = dict(
                name=b.name, donate=list(b.donate_argnums),
                n_micro=b.shape.n_microbatches, fields=fields,
                args=[_port_args(x) for x in b.args],
                in_specs=[_port_specs(x) for x in b.in_specs],
                out_specs=outs)
    res["bundles"] = bundles
    res["analysis"] = _analysis(steps.analysis_variant, ARCHS,
                                dict(meshes, none=None))
    res["opt"] = _opt_cases(steps, sh, get_arch, meshes["single"],
                            _port_specs)

    # the three cells on a fake 256-rank group, and a sharded matmul
    cost = {}
    for a, s in COST_CELLS:
        spec = get_arch(a)
        if spec.shapes[s].kind == "train":
            corr = dryrun.measured_cost(spec, s,
                                        dryrun.production_mesh(False))
            cost[f"{a}/{s}"] = dict(
                flops=corr["flops"],
                argument_bytes=corr["fit_points"][0]["read_argument_bytes"])
            continue
        r = dryrun.run_cell(a, s, False)
        cost[f"{a}/{s}"] = dict(
            flops=r["per_device"]["flops"],
            argument_bytes=r["per_device"]["read_argument_bytes"],
            status=r["status"], fits_hbm=r["fits_hbm"],
            fit_points=(r["scan_correction"] or {}).get("fit_points"),
            live_bytes=r["per_device"]["live_bytes"],
            all_argument_bytes=r["per_device"]["argument_bytes"])
    res["cost"] = cost
    mesh = dryrun.production_mesh(False)
    mm = steps.StepBundle(
        name="mm", fn=lambda x, w: x @ w,
        args=(TensorSpec((4096, 4096), torch.float32),
              TensorSpec((4096, 14336), torch.float32)),
        in_specs=(P("data", "model"), P(None, "model")), out_specs=None,
        mesh=mesh)
    res["matmul"] = dryrun.trace_bundle(mm, mesh)
    out.write_text(json.dumps(res))


def smoke_spec(spec, shape_name):
    """The cell at the arch's smoke config and a shape cut to SMOKE_DIMS."""
    from dataclasses import replace
    sh = spec.shapes[shape_name]
    if spec.family == "lm":
        dims = SMOKE_DIMS["lm"][shape_name]
    elif spec.family == "gnn":
        dims = dict(sh.dims, **SMOKE_DIMS["gnn"],
                    d_feat=spec.smoke_config.d_node_in)
    else:
        dims = SMOKE_DIMS["recsys"][shape_name]
    return replace(spec, config=spec.smoke_config,
                   shapes={shape_name: replace(sh, dims=dims)})


def run_smoke(out: Path) -> None:
    import traceback

    from repro_torch.configs import ARCHS, all_cells
    from repro_torch.launch import dryrun
    from repro_torch.launch.steps import build_bundle

    mesh = dryrun.fake_mesh((2, 2), ("data", "model"))
    res = {}
    for a, s in all_cells():
        try:
            c = dryrun.trace_bundle(build_bundle(smoke_spec(ARCHS[a], s), s,
                                                 mesh), mesh)
            res[f"{a}/{s}"] = dict(status="ok", flops=c["flops"],
                                   live=c["live_bytes"],
                                   args=c["argument_bytes"])
        except Exception as e:
            res[f"{a}/{s}"] = dict(status="error", error=repr(e)[:500],
                                   trace=traceback.format_exc()[-1500:])
    out.write_text(json.dumps(res))


def _adafactor_rank(rank, path, out):
    """One rank of ``run_adafactor``: the per-rank Adafactor update of
    split leaves against the plain update of the whole leaves."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch.shardings import P, distribute_tree
    from repro_torch.launch.steps import opt_specs_for
    from repro_torch.optim.adafactor import (AdafactorConfig,
                                             adafactor_update,
                                             init_adafactor)
    from repro_torch.tree import leaves

    dist.init_process_group("gloo", init_method=f"file://{path}", rank=rank,
                            world_size=4)
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    gen = torch.Generator().manual_seed(0)
    # a stacked expert leaf (sliced twice), a matrix, a vector and a
    # stacked leaf with fewer than 8 layers (updated whole)
    shapes = {"e": ((8, 8, 6, 10), torch.bfloat16), "m": ((12, 10), None),
              "v": ((10,), None), "s": ((9, 4, 6), None)}
    params = {k: torch.randn(sh, generator=gen).to(dt or torch.float32)
              for k, (sh, dt) in shapes.items()}
    grads = {k: torch.randn(v.shape, generator=gen).to(v.dtype)
             for k, v in params.items()}
    cfg = AdafactorConfig(lr=1e-2, warmup_steps=1)
    st = init_adafactor(cfg, params)
    st = st._replace(vr={k: v + 0.5 for k, v in st.vr.items()},
                     vc={k: v + 0.25 for k, v in st.vc.items()})
    want = adafactor_update(cfg, params, grads, st)
    specs = {"e": P(None, "model", "data", None), "m": P("data", "model"),
             "v": P("model"), "s": P(None, "data", "model")}
    got = adafactor_update(
        cfg, distribute_tree(params, specs, mesh),
        distribute_tree(grads, specs, mesh),
        distribute_tree(st, opt_specs_for("adafactor", specs, params), mesh))
    err = max(float((a.full_tensor().float() - b.float()).abs().max()
                    / b.float().abs().max().clamp_min(1e-30))
              for a, b in zip(leaves(got[:2]), leaves(want[:2])))
    if rank == 0:
        Path(out).write_text(json.dumps(dict(err=err)))
    dist.destroy_process_group()


def run_adafactor(out: Path) -> None:
    import torch.multiprocessing as mp
    path = str(out) + ".store"
    mp.start_processes(_adafactor_rank, args=(path, str(out)), nprocs=4,
                       start_method="spawn")


# ---------------------------------------------------------------- fixtures
@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    d = tmp_path_factory.mktemp("dryrun")
    base = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                OMP_NUM_THREADS="1")
    ref_env = dict(base, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=512")
    procs = {side: subprocess.Popen(
        [sys.executable, __file__, side, str(d / f"{side}.json")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for side, env in (("reference", ref_env), ("port", base),
                          ("smoke", base), ("adafactor", base))}
    logs = {side: p.communicate(timeout=900)[0] for side, p in procs.items()}
    for side, p in procs.items():
        assert p.returncode == 0, f"{side} side failed:\n{logs[side][-4000:]}"
    return {side: json.loads((d / f"{side}.json").read_text())
            for side in procs}


# ------------------------------------------------------------------- tests
def test_cells_match_reference(sides):
    ref, port = sides["reference"], sides["port"]
    assert len(port["cells"]["all"]) == 36
    assert len(port["cells"]["skipped"]) == 40
    assert port["cells"] == ref["cells"]


@pytest.mark.parametrize("cell", [f"{a}/{s}" for a, s in ALL_CELLS])
def test_inputs_match_reference(sides, cell):
    assert sides["port"]["inputs"][cell] == sides["reference"]["inputs"][cell]


@pytest.mark.parametrize("tag", MESHES)
@pytest.mark.parametrize("cell", [f"{a}/{s}" for a, s in CELLS])
def test_bundle_matches_reference(sides, cell, tag):
    key = f"{cell}/{tag}"
    got = sides["port"]["bundles"][key]
    want = sides["reference"]["bundles"][key]
    for k in ("name", "donate", "n_micro", "fields", "args", "in_specs",
              "out_specs"):
        assert got[k] == want[k], (key, k)


def test_analysis_variants_match_reference(sides):
    got, want = sides["port"]["analysis"], sides["reference"]["analysis"]
    assert got.keys() == want.keys()
    assert sum(v is not None for v in got.values()) == 2 * 3 * 4 * 6
    for k in want:
        assert got[k] == want[k], k


@pytest.mark.parametrize("case", ["llama3-8b/adamw", "llama3-8b/adafactor",
                                  "arctic-480b/adamw",
                                  "arctic-480b/adafactor"])
def test_opt_specs_match_reference(sides, case):
    assert sides["port"]["opt"][case] == sides["reference"]["opt"][case]


def test_roofline_terms_with_the_reference_hw(sides):
    from repro_torch.launch.dryrun import roofline_terms
    ref = sides["reference"]
    got = roofline_terms(197e12, 819e9, 50e9, 256, hw=ref["hw"])
    assert got == pytest.approx(ref["roofline"], rel=1e-12)
    assert got["compute_s"] == pytest.approx(1.0)


def test_collective_records_match_the_reference_parser(sides):
    from repro_torch.launch.dryrun import parse_collectives
    want = sides["reference"]["hlo"]
    got = parse_collectives(HLO_RECORDS)
    assert got == want
    assert got["wire_bytes_per_device"] == 2 * 64 * 128 * 2 + 256 * 4 \
        + 2 * 16 * 4


def test_sharded_matmul_counts_exactly(sides):
    """(4096, 4096) split rows over data and columns over model times
    (4096, 14336) split columns over model, on 16 x 16: rank 0 gathers its
    rows' 4096 columns (one all-gather of 256 x 4096 f32; DTensor gathers
    along dim 0 and moves the pieces into place with a ``cat``), then one
    (256 x 4096) @ (4096 x 896) product."""
    c = sides["port"]["matmul"]
    f32 = 4
    gathered = 256 * 4096 * f32
    args = (256 * 256 + 4096 * 896) * f32
    assert c["flops"] == 2 * 256 * 4096 * 896 == 1_879_048_192
    assert c["collectives"] == [["all-gather", gathered]]
    assert c["argument_bytes"] == c["read_argument_bytes"] == args
    assert c["output_bytes"] == 256 * 896 * f32
    # the cat reads and writes the gathered rows; the product reads both
    # operands and writes its output
    assert c["bytes_accessed"] == 2 * gathered + args - 256 * 256 * f32 \
        + gathered + 256 * 896 * f32
    # alive at once: the arguments, the gathered rows and their cat
    assert c["live_bytes"] == args + 2 * gathered


@pytest.mark.parametrize("cell", [f"{a}/{s}" for a, s in COST_CELLS])
def test_cost_within_band_of_xla(sides, cell):
    got, want = sides["port"]["cost"][cell], sides["reference"]["cost"][cell]
    ratio = got["flops"] / want["flops"]
    lo, hi = FLOPS_BAND[cell]
    assert lo <= ratio <= hi, (cell, ratio)
    assert got["argument_bytes"] == want["argument_bytes"], cell
    if "status" in got:
        assert got["status"] == "ok" and got["fits_hbm"] is True
        assert got["live_bytes"] >= got["all_argument_bytes"]


def test_decode_layer_flops_are_the_analytic_count(sides):
    """olmo-1b decode_32k on 16 x 16, a layer on rank 0: 8 tokens (128 over
    data) through q, k, v, o (2048 x 128 each: 16 heads over model) and the
    MLP (2048 x 512 twice, 512 x 2048: d_ff over model), and both
    attention products over all 16 heads and the rank's 2,048 cached
    positions (the cache's sequence over model)."""
    pts = sides["port"]["cost"]["olmo-1b/decode_32k"]["fit_points"]
    b, d, m, dh, h, s, f = 8, 2048, 16, 128, 16, 32768, 8192
    layer = 2 * b * d * (4 * d // m + 3 * f // m) + 2 * 2 * b * h * (s // m) \
        * dh
    assert (pts[1]["flops"] - pts[0]["flops"]) / 2 == layer


@pytest.mark.parametrize("cell", [f"{a}/{s}" for a, s in CELLS])
def test_every_cell_traces_at_smoke_config_on_a_2x2_fake_mesh(sides, cell):
    r = sides["smoke"][cell]
    assert r["status"] == "ok", r
    assert r["flops"] > 0 and r["live"] >= r["args"] > 0


def test_split_adafactor_update_equals_the_plain_one(sides):
    """Adafactor on DTensor leaves split over a 4-rank (2, 2) gloo mesh
    (each rank walks its own slices; ``optim.adafactor._split_update``)
    against the plain update of the whole leaves: every new parameter and
    state leaf within 2^-20 of its largest value (the split means sum each
    shard first, then across ranks: another f32 order)."""
    assert sides["adafactor"]["err"] <= 2.0 ** -20


def test_skipped_cells_keep_the_reference_reasons():
    """The four long_500k cells of the full-attention archs report
    ``skipped`` with their spec's reason (the reference's, less its note on
    where the instruction came from)."""
    from repro_torch.configs import ARCHS
    from repro_torch.launch.dryrun import run_cell
    skipped = [(a, s) for a, s in ALL_CELLS if (a, s) not in CELLS]
    assert {s for _, s in skipped} == {"long_500k"} and len(skipped) == 4
    for a, s in skipped:
        r = run_cell(a, s, False)
        assert r["status"] == "skipped"
        assert r["reason"] == ARCHS[a].shapes[s].skip
        assert r["reason"].startswith("pure full-attention arch")


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT / "src"))
    {"reference": run_reference, "port": run_port, "smoke": run_smoke,
     "adafactor": run_adafactor}[sys.argv[1]](Path(sys.argv[2]))
