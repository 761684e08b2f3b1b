"""The port's sharding rules and meshes (``repro_torch.launch.shardings``,
``launch.mesh``) against the JAX package's.

Every param rule of the ten archs at their full configs, on the production
mesh shapes (16 x 16 and 2 x 16 x 16) with each arch's ``fsdp``, gives the
reference's ``PartitionSpec`` for every leaf; so do the batch and out rules
for every shape.  The reference rules read only a mesh's ``shape`` and
``axis_names``, so both sides take a mesh with no devices.  The production
meshes themselves are built over a ``fake`` process group of 256 and 512
ranks, in a subprocess so that no default group leaks into other tests.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path
from types import SimpleNamespace

import jax
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.launch import mesh as ref_mesh
from repro.launch import shardings as ref_sh
from repro.launch.steps import family_init as ref_family_init
from repro_torch.configs import get_arch
from repro_torch.device import generator
from repro_torch.launch import mesh as pmesh
from repro_torch.launch import shardings as psh
from repro_torch.launch.steps import family_init
from repro_torch.tree import leaves_with_paths

MESHES = {"pod": ((16, 16), ("data", "model")),
          "multi_pod": ((2, 16, 16), ("pod", "data", "model"))}
ROOT = Path(__file__).resolve().parents[1]


def _meshes(which):
    shape, names = MESHES[which]
    ref = SimpleNamespace(shape=dict(zip(names, shape)), axis_names=names)
    return ref, psh.AbstractMesh(shape=dict(zip(names, shape)),
                                 axis_names=names)


def _ref_paths(tree):
    """(path string, shape) of each leaf of a JAX tree, in flatten order."""
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return [(ref_sh.path_str(p), tuple(x.shape)) for p, x in flat]


def _spec_tuples(specs):
    return [tuple(s) for s in specs]


@pytest.mark.parametrize("which", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(REF_ARCHS))
def test_param_rules_match_reference_at_full_config(arch, which):
    spec = REF_ARCHS[arch]
    ref_mesh_, port_mesh = _meshes(which)
    abstract = jax.eval_shape(lambda: ref_family_init(spec)(
        jax.random.PRNGKey(0)))
    leaves = _ref_paths(abstract)
    ref_rule = ref_sh.PARAM_RULES[spec.family](spec.config, spec.fsdp,
                                               ref_mesh_)
    port_rule = psh.PARAM_RULES[spec.family](get_arch(arch).config,
                                             spec.fsdp, port_mesh)
    want = [tuple(ref_rule(p, s)) for p, s in leaves]
    got = [tuple(port_rule(p, s)) for p, s in leaves]
    assert got == want
    # the port's trees: the same leaf paths (smoke config, real tensors)
    port_tree = family_init(get_arch(arch), smoke=True)(generator(0, "cpu"))
    ref_smoke = jax.eval_shape(lambda: ref_family_init(spec, smoke=True)(
        jax.random.PRNGKey(0)))
    port_paths = [psh.path_str(p) for p, _ in leaves_with_paths(port_tree)]
    assert port_paths == [p for p, _ in _ref_paths(ref_smoke)]
    # tree_specs walks the port's tree as the reference's walks its own
    assert _spec_tuples(psh.spec_leaves(psh.tree_specs(port_tree, port_rule))) \
        == _spec_tuples(jax.tree.leaves(
            ref_sh.tree_specs(ref_smoke, ref_rule),
            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)))


@pytest.mark.parametrize("which", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(REF_ARCHS))
def test_batch_and_out_rules_match_reference(arch, which):
    spec = REF_ARCHS[arch]
    ref_mesh_, port_mesh = _meshes(which)
    batch = {"lm": (ref_sh.lm_batch_spec, psh.lm_batch_spec),
             "gnn": (ref_sh.gnn_batch_spec, psh.gnn_batch_spec),
             "recsys": (ref_sh.recsys_batch_spec, psh.recsys_batch_spec)}
    ref_batch, port_batch = batch[spec.family]
    port_spec = get_arch(arch)
    for name, shape in spec.shapes.items():
        port_shape = port_spec.shapes[name]
        inputs = spec.inputs(spec.config, shape)
        ref_rule = ref_batch(ref_mesh_, shape, spec.config)
        port_rule = port_batch(port_mesh, port_shape, port_spec.config)
        for p, s in _ref_paths(inputs):
            assert tuple(port_rule(p, s)) == tuple(ref_rule(p, s)), (name, p)
        if spec.family == "lm" and shape.kind in ("prefill", "decode"):
            want = jax.tree.leaves(
                ref_sh.lm_out_spec(ref_mesh_, shape, spec.config),
                is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
            got = psh.spec_leaves(psh.lm_out_spec(port_mesh, port_shape,
                                                  port_spec.config))
            assert _spec_tuples(got) == _spec_tuples(want), name


def test_path_str_of_named_tuple_fields_and_indices():
    from repro.optim.adam import init_adam as ref_init_adam
    from repro_torch.optim.adam import init_adam
    state = init_adam({"b": torch.zeros(2), "a": [torch.zeros(3)]})
    paths = [psh.path_str(p) for p, _ in leaves_with_paths(state)]
    ref = ref_init_adam({"b": jax.numpy.zeros(2), "a": [jax.numpy.zeros(3)]})
    assert paths == [p for p, _ in _ref_paths(ref)]


def test_hw_keys_are_the_reference_keys_with_h100_values():
    assert set(pmesh.HW) == set(ref_mesh.HW)
    assert pmesh.HW["hbm_bw"] == 3.35e12 and pmesh.HW["hbm_bytes"] == 80e9
    assert pmesh.HW["peak_flops_bf16"] == 989e12
    assert pmesh.HW["ici_bw"] == 900e9


@pytest.mark.parametrize("spec,err", [
    (psh.P(("model", "data"), None), "mesh's order"),
    (psh.P("data", "data"), "shards two dims")])
def test_to_placements_refuses_what_dtensor_cannot_hold(spec, err):
    mesh = psh.AbstractMesh(shape={"data": 2, "model": 2},
                            axis_names=("data", "model"))
    with pytest.raises(ValueError, match=err):
        psh.to_placements(spec, mesh)


def test_to_placements_major_to_minor():
    from torch.distributed.tensor import Replicate, Shard
    mesh = psh.AbstractMesh(shape={"pod": 2, "data": 2, "model": 2},
                            axis_names=("pod", "data", "model"))
    assert psh.to_placements(psh.P(("pod", "data"), None, "model"), mesh) \
        == (Shard(0), Shard(0), Shard(2))
    assert psh.to_placements(psh.P(), mesh) == (Replicate(),) * 3


_FAKE = textwrap.dedent("""
    import json, sys
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch.mesh import make_production_mesh
    out = {}
    for world in (256, 512, 128):
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world)
        try:
            for multi in (False, True):
                try:
                    m = make_production_mesh(multi_pod=multi,
                                             device_type="cpu")
                    out[f"{world} {multi}"] = [list(m.shape),
                                               list(m.mesh_dim_names)]
                except ValueError as e:
                    out[f"{world} {multi}"] = str(e)
        finally:
            dist.destroy_process_group()
    print(json.dumps(out))
""")


def test_make_production_mesh_over_a_fake_group():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", _FAKE], capture_output=True,
                         text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["256 False"] == [[16, 16], ["data", "model"]]
    assert out["512 True"] == [[2, 16, 16], ["pod", "data", "model"]]
    for key in ("256 True", "512 False", "128 False", "128 True"):
        assert "ranks; the default group has" in out[key], out[key]
