"""The port's mesh functions on real process groups, held to the JAX
package on its own 4-device mesh.

Two module fixtures run every case once:

  * the reference, in a subprocess with 4 CPU devices
    (``--xla_force_host_platform_device_count=4``): outputs, aux and
    ``jax.grad``s through its ``shard_map``, and ``NamedSharding`` slices at
    each mesh coordinate;
  * the port, in one 4-rank ``gloo`` group (a FileStore in the test's
    temporary directory, one thread a rank) spawned from a subprocess.

Device i of the reference's mesh and rank i of the port's sit at the same
row-major mesh coordinate.  Both read the same inputs (numpy, seeded) from
an npz; the parametrised tests then compare a case each.  f32 tolerances
are the reference tests' 1e-5; the sequence-parallel output is also held
bit for bit to the port's own unsharded ``blockwise_attention`` (the same
arithmetic in the same order, row for row).  The world-1 (1, 1) cases that
the reference's own tests cover run in this process, on a 1-rank group.
One MoE case and one attention case run a second time on DTensor inputs
(DTensors in, DTensors out, on the out_specs' placements), held to the
same reference values.

Run as a script (``python tests/test_torch_sharded.py reference|port DIR``)
it computes one side's results into DIR.
"""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-5, atol=1e-5)
AUX_W = 3.0                       # the aux loss' weight in the MoE cases' loss
# MoE cases: (mesh shape, capacity factor, fsdp axis); capacity factor 1.0
# drops tokens (capacity 4 a data shard of 16 tokens, 32 routings over 8
# experts)
MOE = {"2x2": ((2, 2), 8.0, None), "2x2_drops": ((2, 2), 1.0, None),
       "2x2_fsdp": ((2, 2), 2.0, "data"), "1x4": ((1, 4), 8.0, None)}
MOE_T, MOE_D, MOE_E, MOE_F = 32, 16, 8, 24
MOE_OUT = ("out", "aux", "grad_x", "grad_router", "grad_w_gate",
           "grad_w_up", "grad_w_down")
# the MoE case run again on DTensor inputs placed by the in_specs
MOE_DT = "2x2_fsdp"
# sequence-parallel attention: arctic-like heads (7 q, 1 kv), S 32 split
# over model = 2, chunks of 8 so that each rank runs several
ATTN = {"causal": {}, "window": {"window": 5}, "softcap": {"attn_softcap": 2.0}}
ATTN_B, ATTN_S, ATTN_HQ, ATTN_HKV, ATTN_DH, ATTN_CHUNK = 2, 32, 7, 1, 8, 8
ATTN_OUT = ("out", "grad_q", "grad_k", "grad_v")
# the attention case run again on replicated DTensor inputs (which the map
# redistributes to its in_specs)
ATTN_DT = "causal"
# (mesh shape, tensor shape, spec): one entry a tensor dim
PLACE = [((2, 2), (8, 6), ("data", None)),
         ((2, 2), (8, 6), (None, "model")),
         ((2, 2), (8, 6), (("data", "model"), None)),
         ((2, 2), (4, 8, 6), ("model", None, "data")),
         ((2, 2), (8,), ()),
         ((1, 4), (6, 8), (None, "model")),
         ((4, 1), (8, 6, 2), (("data", "model"), None, None))]
LM = ("arctic-480b", "phi3.5-moe-42b-a6.6b")
LM_OUT = ("logits", "cache_k", "cache_v", "loss", "ce")
CPSUM_N = 64
STATE_LEAVES = ("b/c", "w")
STATE_SPECS = {"w": ("data", None), "b/c": (None, "model")}


def _state():
    return {"w": np.arange(48, dtype=np.float32).reshape(8, 6),
            "b": {"c": np.arange(16, dtype=np.float32).reshape(4, 4) * 0.5}}


def _lm_fields(cfg, mesh_model: int, fsdp: bool) -> dict:
    """The mesh fields the JAX package's ``build_bundle`` sets for a
    prefill or training cell on a (data, model) mesh."""
    return dict(act_batch_axes=("data",),
                act_model_axis="model" if cfg.d_model % mesh_model == 0
                else None,
                attn_seq_parallel=cfg.n_heads % mesh_model != 0,
                moe_batch_axes=("data",), moe_expert_axis="model",
                moe_fsdp_axis="data" if fsdp else None,
                moe_expert_parallel=mesh_model)


def _unflatten(flat: dict, prefix: str) -> dict:
    """A nested dict of the npz entries under ``prefix``/."""
    tree: dict = {}
    for key, a in flat.items():
        if not key.startswith(prefix + "/"):
            continue
        *path, leaf = key[len(prefix) + 1:].split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = a
    return tree


def _write_inputs(d: Path) -> None:
    """Seeded inputs of every case, the LM params from the JAX smoke init,
    and a checkpoint written by the JAX package's CheckpointManager."""
    import jax

    from repro.configs import get_arch as ref_get_arch
    from repro.launch.checkpoint import CheckpointManager
    from repro.launch.shardings import path_str
    from repro.launch.steps import family_init

    rng = np.random.default_rng(7)
    a = {}

    def normal(*shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    a["moe/x"] = normal(MOE_T, MOE_D)
    a["moe/g"] = normal(MOE_T, MOE_D)
    a["moe/router"] = normal(MOE_D, MOE_E, scale=0.3)
    a["moe/w_gate"] = normal(MOE_E, MOE_D, MOE_F, scale=0.3)
    a["moe/w_up"] = normal(MOE_E, MOE_D, MOE_F, scale=0.3)
    a["moe/w_down"] = normal(MOE_E, MOE_F, MOE_D, scale=0.3)
    for n, h in (("q", ATTN_HQ), ("k", ATTN_HKV), ("v", ATTN_HKV),
                 ("g", ATTN_HQ)):
        a[f"attn/{n}"] = normal(ATTN_B, ATTN_S, h, ATTN_DH)
    a["cpsum/g"] = normal(4, CPSUM_N) * np.arange(1, 5, dtype=np.float32)[:, None]
    a["cpsum/err"] = normal(4, CPSUM_N, scale=0.01)
    for i, arch in enumerate(LM):
        params = family_init(ref_get_arch(arch), smoke=True)(
            jax.random.PRNGKey(i + 1))
        for p, x in jax.tree_util.tree_flatten_with_path(params)[0]:
            x = np.asarray(x)
            # the zero norm gains get seeded values, so that they take part
            a[f"lm/{arch}/{path_str(p)}"] = x if x.any() else normal(
                *x.shape, scale=0.1)
        cfg = ref_get_arch(arch).smoke_config
        a[f"lm_tokens/{arch}"] = rng.integers(0, cfg.vocab, (2, 32)) \
            .astype(np.int32)
    np.savez(d / "inputs.npz", **a)
    CheckpointManager(str(d / "ckpt")).save(3, _state(), blocking=True)


# ------------------------------------------------------------- reference
def run_reference(d: Path) -> None:
    import jax
    import jax.numpy as jnp
    from dataclasses import replace
    from jax.sharding import Mesh, NamedSharding
    from jax.sharding import PartitionSpec as JP

    from repro import jax_compat
    from repro.configs import get_arch
    from repro.launch.checkpoint import CheckpointManager
    from repro.launch.elastic import remesh_state
    from repro.models import transformer as tf
    from repro.models.attention import seq_parallel_attention
    from repro.models.moe import moe_ffn_sharded
    from repro.optim.compress import compressed_psum

    assert jax.device_count() == 4, jax.devices()
    inp = dict(np.load(d / "inputs.npz"))
    out = {}

    def mesh(shape, names=("data", "model")):
        return Mesh(np.asarray(jax.devices()).reshape(shape), names)

    def shards(arr, m):
        """Each device's shard, by the device's mesh position."""
        by_dev = {s.device: np.asarray(s.data) for s in arr.addressable_shards}
        return [by_dev[dv] for dv in m.devices.flat]

    for i, (ms, shape, spec) in enumerate(PLACE):
        m = mesh(ms)
        idx = NamedSharding(m, JP(*spec)).devices_indices_map(shape)
        full = np.arange(int(np.prod(shape))).reshape(shape)
        for r, dv in enumerate(m.devices.flat):
            out[f"place/{i}/{r}"] = full[idx[dv]]

    w = {k: inp[f"moe/{k}"] for k in ("router", "w_gate", "w_up", "w_down")}
    for name, (ms, cf, fsdp) in MOE.items():
        m = mesh(ms)

        def loss(x, w):
            o, aux = moe_ffn_sharded(
                x, w, n_experts=MOE_E, top_k=2, capacity_factor=cf,
                batch_axes=("data",), expert_axis="model", fsdp_axis=fsdp,
                expert_parallel=ms[1])
            return jnp.sum(o * inp["moe/g"]) + AUX_W * aux, (o, aux)

        with m, jax_compat.set_mesh(m):
            (_, (o, aux)), (gx, gw) = jax.jit(jax.value_and_grad(
                loss, argnums=(0, 1), has_aux=True))(inp["moe/x"], w)
        res = dict(out=o, aux=aux, grad_x=gx,
                   **{f"grad_{k}": v for k, v in gw.items()})
        out.update({f"moe/{name}/{k}": np.asarray(v) for k, v in res.items()})

    m = mesh((2, 2))
    for name, kw in ATTN.items():
        def loss(q, k, v):
            o = seq_parallel_attention(
                q, k, v, batch_axes=("data",), model_axis="model",
                q_chunk=ATTN_CHUNK, kv_chunk=ATTN_CHUNK, **kw)
            return jnp.sum(o * inp["attn/g"]), o

        with m, jax_compat.set_mesh(m):
            (_, o), grads = jax.jit(jax.value_and_grad(
                loss, argnums=(0, 1, 2), has_aux=True))(
                    inp["attn/q"], inp["attn/k"], inp["attn/v"])
        for k, v in zip(ATTN_OUT, (o, *grads)):
            out[f"attn/{name}/{k}"] = np.asarray(v)

    pod = Mesh(np.asarray(jax.devices()), ("pod",))
    with pod, jax_compat.set_mesh(pod):
        total, err = jax_compat.shard_map(
            lambda g, e: compressed_psum(g, e, "pod"),
            in_specs=(JP("pod", None), JP("pod", None)),
            out_specs=(JP("pod", None), JP("pod", None)),
            check_vma=False)(inp["cpsum/g"], inp["cpsum/err"])
    out["cpsum/out"], out["cpsum/err"] = np.asarray(total), np.asarray(err)

    for arch in LM:
        spec = get_arch(arch)
        cfg = replace(spec.smoke_config,
                      **_lm_fields(spec.smoke_config, 2, spec.fsdp))
        params = jax.tree.map(jnp.asarray, _unflatten(inp, f"lm/{arch}"))
        toks = jnp.asarray(inp[f"lm_tokens/{arch}"])
        batch = {"tokens": toks, "labels": jnp.roll(toks, -1, 1),
                 "mask": jnp.ones(toks.shape, jnp.float32)}
        with m, jax_compat.set_mesh(m):
            cache, logits = jax.jit(lambda p, t: tf.prefill(cfg, p, t))(
                params, toks)
            loss, ce = jax.jit(lambda p, b: tf.lm_loss(cfg, p, b))(
                params, batch)
        for k, v in zip(LM_OUT, (logits, cache["k"], cache["v"], loss, ce)):
            out[f"lm/{arch}/{k}"] = np.asarray(v)

    state = _state()
    specs = {"w": JP(*STATE_SPECS["w"]), "b": {"c": JP(*STATE_SPECS["b/c"])}}
    m22, m41 = mesh((2, 2)), mesh((4, 1))
    on22 = remesh_state(state, specs, m22)
    on41 = remesh_state(on22, specs, m41)
    restored, _ = CheckpointManager(str(d / "ckpt")).restore(
        state, shardings=jax.tree.map(lambda s: NamedSharding(m22, s), specs,
                                      is_leaf=lambda x: isinstance(x, JP)))
    for tag, tree, mm in (("remesh22", on22, m22), ("remesh41", on41, m41),
                          ("restore", restored, m22)):
        for leaf in STATE_LEAVES:
            arr = tree["w"] if leaf == "w" else tree["b"]["c"]
            for r, s in enumerate(shards(arr, mm)):
                out[f"{tag}/{leaf}/{r}"] = s
    np.savez(d / "ref.npz", **out)


# ------------------------------------------------------------------ port
def _rank(rank: int, d: str) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    d = Path(d)
    dist.init_process_group("gloo", store=dist.FileStore(str(d / "store"), 4),
                            rank=rank, world_size=4)
    try:
        _rank_cases(rank, d)
    finally:
        dist.destroy_process_group()


def _rank_cases(rank: int, d: Path) -> None:
    from dataclasses import replace

    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_arch
    from repro_torch.launch.checkpoint import CheckpointManager
    from repro_torch.launch.elastic import make_mesh_from_devices, remesh_state
    from repro_torch.launch.mesh import shard_map, use_mesh
    from repro_torch.launch.shardings import (MeshPlacements, P, place,
                                              specs_to_shardings,
                                              to_placements)
    from repro_torch.models import transformer as tf
    from repro_torch.models.attention import (blockwise_attention,
                                              seq_parallel_attention)
    from repro_torch.models.convert import lm_params_from_numpy
    from repro_torch.models.moe import moe_ffn_sharded
    from repro_torch.optim.compress import compressed_psum
    from torch.distributed.tensor import DTensor

    inp = {k: torch.from_numpy(v) for k, v in
           np.load(d / "inputs.npz").items()}
    names = ("data", "model")
    meshes = {ms: init_device_mesh("cpu", ms, mesh_dim_names=names)
              for ms in ((2, 2), (1, 4))}
    meshes[(4, 1)] = make_mesh_from_devices(range(4), (4, 1), names,
                                            device_type="cpu")
    out = {}

    for i, (ms, shape, spec) in enumerate(PLACE):
        full = torch.arange(int(np.prod(shape))).reshape(shape)
        m = meshes[ms]
        out[f"place/{i}"] = place(full, MeshPlacements(
            m, to_placements(P(*spec), m))).to_local().numpy()

    for name, (ms, cf, fsdp) in MOE.items():
        x = inp["moe/x"].clone().requires_grad_()
        w = {k: inp[f"moe/{k}"].clone().requires_grad_()
             for k in ("router", "w_gate", "w_up", "w_down")}
        o, aux = moe_ffn_sharded(x, w, n_experts=MOE_E, top_k=2,
                                 capacity_factor=cf, batch_axes=("data",),
                                 expert_axis="model", fsdp_axis=fsdp,
                                 mesh=meshes[ms])
        loss = (o * inp["moe/g"]).sum() + AUX_W * aux
        grads = torch.autograd.grad(loss, [x, *w.values()])
        for k, v in zip(MOE_OUT, (o, aux, *grads)):
            out[f"moe/{name}/{k}"] = v.detach().numpy()

    # DTensors in give DTensors out, on the out_specs' placements
    ms, cf, fsdp = MOE[MOE_DT]
    m = meshes[ms]
    wg = P("model", fsdp, None)
    specs = {"x": P("data", None), "router": P(None, None), "w_gate": wg,
             "w_up": wg, "w_down": P("model", None, fsdp)}
    dt = {k: place(inp[f"moe/{k}"], MeshPlacements(
        m, to_placements(sp, m))).requires_grad_() for k, sp in specs.items()}
    o, aux = moe_ffn_sharded(dt["x"], {k: dt[k] for k in specs if k != "x"},
                             n_experts=MOE_E, top_k=2, capacity_factor=cf,
                             batch_axes=("data",), expert_axis="model",
                             fsdp_axis=fsdp, mesh=m)
    out["dtensor_out/moe"] = np.array(
        isinstance(o, DTensor) and isinstance(aux, DTensor)
        and o.placements == to_placements(P("data", None), m)
        and aux.placements == to_placements(P(), m))
    loss = (o.full_tensor() * inp["moe/g"]).sum() + AUX_W * aux.full_tensor()
    grads = torch.autograd.grad(loss, list(dt.values()))
    for k, v in zip(MOE_OUT, (o, aux, *grads)):
        out[f"moe_dt/{k}"] = v.full_tensor().detach().numpy()

    m = meshes[(2, 2)]
    for name, kw in ATTN.items():
        q, k, v = (inp[f"attn/{n}"].clone().requires_grad_() for n in "qkv")
        o = seq_parallel_attention(q, k, v, batch_axes=("data",),
                                   model_axis="model", q_chunk=ATTN_CHUNK,
                                   kv_chunk=ATTN_CHUNK, mesh=m, **kw)
        grads = torch.autograd.grad((o * inp["attn/g"]).sum(), [q, k, v])
        for key, val in zip(ATTN_OUT, (o, *grads)):
            out[f"attn/{name}/{key}"] = val.detach().numpy()
        # the unsharded core on each data shard's rows, in the ranks' order
        with torch.no_grad():
            out[f"attn_plain/{name}"] = blockwise_attention(
                q, k, v, q_chunk=ATTN_CHUNK, kv_chunk=ATTN_CHUNK, **kw).numpy()

    replicated = MeshPlacements(m, to_placements(P(), m))
    q, k, v = (place(inp[f"attn/{n}"], replicated).requires_grad_()
               for n in "qkv")
    o = seq_parallel_attention(q, k, v, batch_axes=("data",),
                               model_axis="model", q_chunk=ATTN_CHUNK,
                               kv_chunk=ATTN_CHUNK, mesh=m, **ATTN[ATTN_DT])
    out["dtensor_out/attn"] = np.array(
        isinstance(o, DTensor)
        and o.placements == to_placements(P("data", "model", None, None), m))
    grads = torch.autograd.grad((o.full_tensor() * inp["attn/g"]).sum(),
                                [q, k, v])
    for key, val in zip(ATTN_OUT, (o, *grads)):
        out[f"attn_dt/{key}"] = val.full_tensor().detach().numpy()

    pod = init_device_mesh("cpu", (4,), mesh_dim_names=("pod",))
    total, err = shard_map(
        lambda g, e: compressed_psum(g, e, "pod", mesh=pod), mesh=pod,
        in_specs=(P("pod", None), P("pod", None)),
        out_specs=(P("pod", None), P("pod", None)))(inp["cpsum/g"],
                                                    inp["cpsum/err"])
    out["cpsum/out"], out["cpsum/err"] = total.numpy(), err.numpy()

    for arch in LM:
        spec = get_arch(arch)
        cfg = replace(spec.smoke_config,
                      **_lm_fields(spec.smoke_config, 2, spec.fsdp))
        tree = _unflatten({k: v.numpy() for k, v in inp.items()}, f"lm/{arch}")
        params = lm_params_from_numpy(cfg, tree, "cpu")
        toks = inp[f"lm_tokens/{arch}"]
        batch = {"tokens": toks, "labels": toks.roll(-1, 1),
                 "mask": torch.ones(toks.shape)}
        with use_mesh(m), torch.no_grad():
            cache, logits = tf.prefill(cfg, params, toks)
            loss, ce = tf.lm_loss(cfg, params, batch)
        for k, v in zip(LM_OUT, (logits, cache["k"], cache["v"], loss, ce)):
            out[f"lm/{arch}/{k}"] = v.numpy()

    state = _state()
    specs = {"w": P(*STATE_SPECS["w"]), "b": {"c": P(*STATE_SPECS["b/c"])}}
    on22 = remesh_state(state, specs, meshes[(2, 2)])
    on41 = remesh_state(on22, specs, meshes[(4, 1)])
    like = {"w": torch.zeros(8, 6), "b": {"c": torch.zeros(4, 4)}}
    restored, step = CheckpointManager(str(d / "ckpt")).restore(
        like, shardings=specs_to_shardings(specs, meshes[(2, 2)]))
    assert step == 3
    for tag, tree in (("remesh22", on22), ("remesh41", on41),
                      ("restore", restored)):
        for leaf in STATE_LEAVES:
            t = tree["w"] if leaf == "w" else tree["b"]["c"]
            out[f"{tag}/{leaf}"] = t.to_local().numpy()
    np.savez(d / f"port_{rank}.npz", **out)


def run_port(d: Path) -> None:
    import torch.multiprocessing as mp

    mp.spawn(_rank, args=(str(d),), nprocs=4, join=True)


# ---------------------------------------------------------------- fixtures
@pytest.fixture(scope="module")
def results(tmp_path_factory):
    d = tmp_path_factory.mktemp("sharded")
    _write_inputs(d)
    base = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                OMP_NUM_THREADS="1")
    ref_env = dict(base, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=4")
    procs = {side: subprocess.Popen(
        [sys.executable, __file__, side, str(d)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for side, env in (("reference", ref_env), ("port", base))}
    logs = {side: p.communicate(timeout=600)[0] for side, p in procs.items()}
    for side, p in procs.items():
        assert p.returncode == 0, f"{side} side failed:\n{logs[side][-4000:]}"
    return (dict(np.load(d / "ref.npz")),
            [dict(np.load(d / f"port_{r}.npz")) for r in range(4)])


def _close(got, want, what, tol=TOL):
    np.testing.assert_allclose(got, want, err_msg=what, **tol)


@pytest.mark.parametrize("i", range(len(PLACE)))
def test_placements_hold_the_reference_slices(results, i):
    ref, port = results
    for r in range(4):
        np.testing.assert_array_equal(port[r][f"place/{i}"],
                                      ref[f"place/{i}/{r}"])


@pytest.mark.parametrize("what", MOE_OUT)
@pytest.mark.parametrize("case", sorted(MOE))
def test_moe_ffn_sharded_matches_reference(results, case, what):
    """Output, aux and the gradients of sum(out * g) + 3 aux with respect
    to x and every weight: the unsharded gradients, as ``jax.grad``
    through the reference's ``shard_map`` gives them."""
    ref, port = results
    key = f"moe/{case}/{what}"
    _close(port[0][key], ref[key], key)


@pytest.mark.parametrize("what", ATTN_OUT)
@pytest.mark.parametrize("case", sorted(ATTN))
def test_seq_parallel_attention_matches_reference(results, case, what):
    ref, port = results
    key = f"attn/{case}/{what}"
    _close(port[0][key], ref[key], key)


@pytest.mark.parametrize("what", MOE_OUT)
def test_moe_ffn_sharded_on_dtensor_inputs_matches_reference(results, what):
    """DTensor inputs on their in_specs' placements: the same values and
    gradients as the reference's (and the plain inputs') case."""
    ref, port = results
    _close(port[0][f"moe_dt/{what}"], ref[f"moe/{MOE_DT}/{what}"], what)


@pytest.mark.parametrize("what", ATTN_OUT)
def test_seq_parallel_attention_on_dtensor_inputs_matches_reference(results,
                                                                   what):
    """Replicated DTensor inputs, redistributed by the map: the reference's
    values and gradients."""
    ref, port = results
    _close(port[0][f"attn_dt/{what}"], ref[f"attn/{ATTN_DT}/{what}"], what)


@pytest.mark.parametrize("fn", ["moe", "attn"])
def test_dtensor_inputs_give_dtensors_on_the_out_specs(results, fn):
    _, port = results
    for r in range(4):
        assert port[r][f"dtensor_out/{fn}"]


@pytest.mark.parametrize("case", sorted(ATTN))
def test_seq_parallel_output_is_blockwise_bit_for_bit(results, case):
    _, port = results
    np.testing.assert_array_equal(port[0][f"attn/{case}/out"],
                                  port[0][f"attn_plain/{case}"])


@pytest.mark.parametrize("what", ["out", "err"])
def test_compressed_psum_of_distinct_rank_gradients(results, what):
    ref, port = results
    _close(port[0][f"cpsum/{what}"], ref[f"cpsum/{what}"], what,
           dict(rtol=1e-6, atol=1e-6))
    if what == "out":   # every rank holds the same sum
        assert (port[0]["cpsum/out"] == port[0]["cpsum/out"][:1]).all()


@pytest.mark.parametrize("what", LM_OUT)
@pytest.mark.parametrize("arch", LM)
def test_lm_with_mesh_fields_matches_reference(results, arch, what):
    ref, port = results
    key = f"lm/{arch}/{what}"
    _close(port[0][key], ref[key], key)


@pytest.mark.parametrize("tag", ["remesh22", "remesh41", "restore"])
@pytest.mark.parametrize("leaf", STATE_LEAVES)
def test_remesh_and_restore_hold_the_reference_shards(results, tag, leaf):
    """``remesh_state`` onto (2, 2), then from (2, 2) onto (4, 1), and
    ``restore(shardings=)`` of a checkpoint the JAX package wrote: each
    rank's shard is the reference device's, bit for bit."""
    ref, port = results
    for r in range(4):
        np.testing.assert_array_equal(port[r][f"{tag}/{leaf}"],
                                      ref[f"{tag}/{leaf}/{r}"])


def test_every_rank_returns_the_same_global_values(results):
    _, port = results
    keys = [k for k in port[0] if k.split("/")[0] in
            ("moe", "moe_dt", "attn", "attn_dt", "attn_plain", "cpsum",
             "lm")]
    for r in range(1, 4):
        for k in keys:
            if k == "cpsum/err":      # each rank's own error feedback
                continue
            np.testing.assert_array_equal(port[r][k], port[0][k], err_msg=k)


# -------------------------------------------------- the world-1 (1, 1) mesh
@pytest.fixture(scope="module")
def unit_mesh(tmp_path_factory):
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    store = dist.FileStore(str(tmp_path_factory.mktemp("unit") / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        yield make_host_mesh("cpu")
    finally:
        dist.destroy_process_group()


def _moe_weights(torch, t=64, d=16, e=8, f=32):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(t, d)).astype(np.float32))
    w = {k: torch.from_numpy((rng.normal(size=s) * 0.1).astype(np.float32))
         for k, s in (("router", (d, e)), ("w_gate", (e, d, f)),
                      ("w_up", (e, d, f)), ("w_down", (e, f, d)))}
    return x, w


def test_unit_mesh_moe_sharded_equals_global_dispatch(unit_mesh):
    """The reference's ``test_moe_sharded_equals_global_on_unit_mesh``:
    no drops, the expert axis of size 1; bit for bit against the port's
    ``moe_ffn``, and within 1e-5 of the reference's."""
    import jax.numpy as jnp
    import torch

    from repro.models.moe import moe_ffn as ref_moe_ffn
    from repro_torch.models.moe import moe_ffn, moe_ffn_sharded

    x, w = _moe_weights(torch)
    y, aux = moe_ffn_sharded(x, w, n_experts=8, top_k=2, capacity_factor=8.0,
                             mesh=unit_mesh)
    y0, aux0 = moe_ffn(x, w, n_experts=8, top_k=2, capacity_factor=8.0)
    assert torch.equal(y, y0) and torch.equal(aux, aux0)
    yr, auxr = ref_moe_ffn(jnp.asarray(x.numpy()),
                           {k: jnp.asarray(v.numpy()) for k, v in w.items()},
                           n_experts=8, top_k=2, capacity_factor=8.0)
    _close(y.numpy(), np.asarray(yr), "out")
    _close(float(aux), float(auxr), "aux")


def test_unit_mesh_seq_parallel_equals_blockwise(unit_mesh):
    """The reference's ``test_seq_parallel_attention_equivalence``."""
    import torch

    from repro_torch.models.attention import (blockwise_attention,
                                              seq_parallel_attention)
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 64, 7, 8, generator=g)
    k, v = (torch.randn(2, 64, 1, 8, generator=g) for _ in range(2))
    got = seq_parallel_attention(q, k, v, batch_axes=("data",),
                                 model_axis="model", q_chunk=16, kv_chunk=16,
                                 mesh=unit_mesh)
    assert torch.equal(got, blockwise_attention(q, k, v, q_chunk=16,
                                                kv_chunk=16))


def test_unit_mesh_compressed_psum(unit_mesh):
    """The reference's ``test_compressed_psum_shard_map``: out + new err
    gives back the gradient."""
    import torch

    from repro_torch.launch.mesh import shard_map, use_mesh
    from repro_torch.launch.shardings import P
    from repro_torch.optim.compress import compressed_psum

    g = torch.from_numpy(np.random.default_rng(1).normal(size=64)
                         .astype(np.float32))
    with use_mesh(unit_mesh):
        out, new_err = shard_map(lambda g, e: compressed_psum(g, e, "data"),
                                 mesh=unit_mesh, in_specs=(P(), P()),
                                 out_specs=(P(), P()))(g, torch.zeros_like(g))
    np.testing.assert_allclose((out + new_err).numpy(), g.numpy(), atol=1e-4)


def test_unit_mesh_remesh_state_round_trip(unit_mesh):
    """The reference's ``test_remesh_state_roundtrip``."""
    from repro_torch.launch.elastic import make_mesh_from_devices, remesh_state
    from repro_torch.launch.shardings import P

    mesh = make_mesh_from_devices([0], (1, 1), device_type="cpu")
    state = {"w": np.arange(16.0).reshape(4, 4)}
    out = remesh_state(state, {"w": P("data", None)}, mesh)
    np.testing.assert_array_equal(out["w"].full_tensor().numpy(), state["w"])


@pytest.mark.parametrize("arch", LM)
def test_unit_mesh_lm_with_every_mesh_field_is_the_plain_model(unit_mesh,
                                                               arch):
    """Prefill and loss of the smoke config with every mesh field set, on
    the (1, 1) mesh, equal the plain model's bit for bit (the arithmetic
    is the same; the card's phase 12 holds arctic-480b at full width so)."""
    from dataclasses import replace

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.device import generator
    from repro_torch.launch.mesh import use_mesh
    from repro_torch.models import transformer as tf

    cfg = get_arch(arch).smoke_config
    fields = dict(_lm_fields(cfg, 1, True), attn_seq_parallel=True)
    params = tf.init_params(cfg, generator(0, "cpu"))
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (2, 32)).astype(np.int32))
    batch = {"tokens": toks, "labels": toks.roll(-1, 1),
             "mask": torch.ones(toks.shape)}
    with torch.no_grad():
        want = tf.prefill(cfg, params, toks)[1], tf.lm_loss(cfg, params, batch)
        with use_mesh(unit_mesh):
            got = (tf.prefill(replace(cfg, **fields), params, toks)[1],
                   tf.lm_loss(replace(cfg, **fields), params, batch))
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1][0], want[1][0])


if __name__ == "__main__":
    {"reference": run_reference, "port": run_port}[sys.argv[1]](
        Path(sys.argv[2]))
