"""The model paths that run on DTensors held to the plain run, with values.

On a 4-rank ``gloo`` (2, 2) mesh, every non-skipped cell at its smoke
config (the shapes of ``test_torch_dryrun.smoke_spec``) runs twice from
the same seeded parameters and batch: plainly, and on DTensors placed by
the cell's ``steps.build_bundle`` specs.  A training cell compares its
loss and every gradient (``steps.value_and_grad``), a serving cell its
outputs (an LM decode step also its cache, written in place on a cache
split over the sequence).  The plain run is itself held to the JAX
package by ``test_torch_models.py``, ``test_torch_train.py`` and
``test_torch_recsys.py``.  This covers ``attention.sharded_attention``
and ``sharded_decode``, ``transformer._constrain_act`` and
``_nll_sums_sharded``, ``layers.rows`` / ``_split_rows`` and
``product``, ``recsys._diagonal`` and ``gnn._aggregate_sharded``.

Extra cases: MeshGraphNet with the max and mean aggregators; every recsys
cell with its tables split over ``model`` (vocabularies of >= 10,000 rows
and ``shardings.REPLICATE_TABLE_BYTES`` 0), where a retrieval cell's
candidates are split over both mesh dims, one of them the table's; and
``layers.rows`` alone with ids and table split over the same mesh dim.

Each leaf's error is its largest absolute difference over its largest
plain value; a case passes at TOL (the split products and sums add in
another f32 order).  Run as a script (``python tests/test_torch_dtensor.py
OUT``) it computes every case into OUT.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5
SPLIT_VOCAB = 10_240        # >= 10,000 rows a table: split over model


def _cases():
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import all_cells
    cells = [f"{a}/{s}" for a, s in all_cells()]
    return (cells
            + [f"meshgraphnet/full_graph_sm/{agg}" for agg in ("max", "mean")]
            + [f"{c}/split" for c in cells
               if c.split("/")[0] in ("xdeepfm", "sasrec", "mind",
                                      "two-tower-retrieval")]
            + ["rows/shared_axis"])


CASES = _cases()


# ------------------------------------------------------------------ worker
def _batch(spec, cfg, inputs, rng):
    """Seeded values for a cell's input specs: ids in their vocabulary,
    every node a receiver, masks and labels of 0 / 1, floats N(0, 1)."""
    import numpy as np
    import torch

    vocab = next(getattr(cfg, k) for k in ("vocab", "vocab_per_field",
                                           "n_items", "field_vocab")
                 if hasattr(cfg, k)) if spec.family != "gnn" else None

    def leaf(name, t, tree):
        shape = tuple(t.shape)
        if t.dtype.is_floating_point:
            if name in ("mask", "edge_mask", "node_mask", "label"):
                x = (rng.random(shape) < 0.8).astype(np.float32)
                x.reshape(-1)[0] = 1.0
            else:
                x = rng.standard_normal(shape).astype(np.float32)
            return torch.from_numpy(x).to(t.dtype)
        if name in ("senders", "receivers"):
            n = tree["nodes"].shape[0]
            x = rng.integers(0, n, shape)
            if name == "receivers":
                x[:n] = np.arange(n)
        else:
            x = rng.integers(0, vocab, shape)
        return torch.from_numpy(np.asarray(x, np.int64)).to(t.dtype)

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else leaf(k, v, tree)
                for k, v in tree.items()}

    return walk(inputs)


def _err(got, want) -> float:
    import torch

    from repro_torch.models.layers import is_dtensor

    got = (got.full_tensor() if is_dtensor(got) else got).detach()
    if not want.dtype.is_floating_point:
        return 0.0 if torch.equal(got, want) else float("inf")
    got, want = got.double(), want.detach().double()
    fin = torch.isfinite(want)
    if not torch.equal(fin, torch.isfinite(got)) or not torch.equal(
            got[~fin].nan_to_num(), want[~fin].nan_to_num()):
        return float("inf")
    if not fin.any():
        return 0.0
    scale = want[fin].abs().max().clamp_min(1e-30)
    return float((got[fin] - want[fin]).abs().max() / scale)


def _tree_err(got, want) -> float:
    from repro_torch.tree import leaves

    g, w = leaves(got), leaves(want)
    assert len(g) == len(w), (len(g), len(w))
    return max((_err(a, b) for a, b in zip(g, w)), default=0.0)


def _shared_axis(mesh) -> float:
    """``layers.rows`` of a (64, 8) table split over ``model`` at ids split
    over (data, model): values and the table's gradient."""
    import torch
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.models.layers import rows

    gen = torch.Generator().manual_seed(1)
    table = torch.randn(64, 8, generator=gen)
    idx = torch.randint(0, 64, (24,), generator=gen, dtype=torch.int32)
    cot = torch.randn(24, 8, generator=gen)
    t = table.clone().requires_grad_(True)
    want = t[idx]
    (want_g,) = torch.autograd.grad((want * cot).sum(), t)
    dt = distribute_tensor(table, mesh, [Replicate(), Shard(0)]
                           ).requires_grad_(True)
    di = distribute_tensor(idx, mesh, [Shard(0), Shard(0)])
    got = rows(dt, di)
    assert tuple(got.placements) == (Shard(0), Shard(0))
    dc = distribute_tensor(cot, mesh, [Shard(0), Shard(0)])
    (got_g,) = torch.autograd.grad((got * dc).sum(), dt)
    return max(_err(got, want.detach()), _err(got_g, want_g))


def _run_case(mesh, case) -> float:
    from dataclasses import replace

    import numpy as np
    import torch

    import test_torch_dryrun as td
    from repro_torch.configs import ARCHS
    from repro_torch.launch import shardings as sh
    from repro_torch.launch.mesh import use_mesh
    from repro_torch.launch.shardings import distribute_tree
    from repro_torch.launch.steps import (build_bundle, family_init,
                                          family_loss, make_serve_step,
                                          value_and_grad)
    from repro_torch.tree import leaves, map_tree
    from torch.distributed.tensor import Shard

    if case == "rows/shared_axis":
        return _shared_axis(mesh)
    arch, shape_name, *extra = case.split("/")
    spec = td.smoke_spec(ARCHS[arch], shape_name)
    cfg = spec.config
    if extra == ["split"]:
        key = next(k for k in ("vocab_per_field", "n_items", "field_vocab")
                   if hasattr(cfg, k))
        cfg = replace(cfg, **{key: SPLIT_VOCAB})
    elif extra:
        cfg = replace(cfg, aggregator=extra[0])
    spec = replace(spec, config=cfg)
    keep = sh.REPLICATE_TABLE_BYTES
    sh.REPLICATE_TABLE_BYTES = 0 if extra == ["split"] else keep
    try:
        b = build_bundle(spec, shape_name, mesh)
    finally:
        sh.REPLICATE_TABLE_BYTES = keep
    shape = b.shape
    # an LM's plain run has no mesh fields, except an MoE arch's: there it
    # runs the expert-parallel dispatch on whole tensors (capacity and aux
    # loss are a token shard's, as in the JAX package)
    plain = replace(spec, config=b.config if spec.family != "lm"
                    or cfg.is_moe else cfg)
    params = family_init(plain)(torch.Generator().manual_seed(0))
    batch = _batch(spec, cfg, b.args[-1], np.random.default_rng(0))
    dparams = distribute_tree(params, b.in_specs[0], mesh)
    dbatch = distribute_tree(batch, b.in_specs[-1], mesh)
    if extra == ["split"]:      # the tables' rows are split over model
        assert any(p.placements[1] == Shard(0) for p in leaves(dparams))
    dspec = replace(spec, config=b.config)
    with use_mesh(mesh):
        if shape.kind == "train":
            want = value_and_grad(family_loss(plain), params, batch)
            got = value_and_grad(family_loss(dspec), dparams, dbatch)
        else:
            pb = map_tree(lambda x: x.clone(), batch)
            want = (make_serve_step(plain, shape)(params, pb), pb)
            got = (b.fn(dparams, dbatch), dbatch)
    return _tree_err(got, want)


def _rank(rank, store, out):
    from datetime import timedelta

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    sys.path[:0] = [str(ROOT / "src"), str(ROOT / "tests")]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=4, timeout=timedelta(seconds=300))
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    res = {}
    for case in CASES:
        try:
            res[case] = dict(err=_run_case(mesh, case))
        except Exception as e:      # every rank fails alike: keep going
            import traceback
            res[case] = dict(error=repr(e)[:300],
                             trace=traceback.format_exc()[-1500:])
    if rank == 0:
        Path(out).write_text(json.dumps(res))
    dist.destroy_process_group()


def run(out: Path) -> None:
    import torch.multiprocessing as mp
    mp.start_processes(_rank, args=(str(out) + ".store", str(out)), nprocs=4,
                       start_method="spawn")


# ------------------------------------------------------------------- tests
@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out = tmp_path_factory.mktemp("dtensor") / "res.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    p = subprocess.run([sys.executable, __file__, str(out)], env=env,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, (p.stdout + p.stderr)[-4000:]
    return json.loads(out.read_text())


@pytest.mark.parametrize("case", CASES)
def test_dtensor_run_equals_the_plain_one(results, case):
    r = results[case]
    assert "err" in r, r
    assert r["err"] <= TOL, (case, r["err"])


if __name__ == "__main__":
    sys.path[:0] = [str(ROOT / "src"), str(ROOT / "tests")]
    run(Path(sys.argv[1]))
