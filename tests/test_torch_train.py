"""The port's training path against the JAX package: every arch's
smoke-config loss and gradients (``jax.value_and_grad`` of the reference's
``family_loss``), the sequence-chunked CE with a ragged tail,
``make_train_step`` with microbatches (olmo under AdamW, arctic under
Adafactor with bf16 accumulation), and remat.  Weights are carried across
by ``repro_torch.models.convert``; inputs are made with numpy from a seed
and handed to both packages.

Tolerances: the loss at rtol 1e-5, each gradient leaf at rtol/atol 1e-4
(f32 throughout; the packages sum in other orders through up to 3
layers).  Updated parameters and optimizer states after a step at rtol
1e-5 (atol 1e-6); arctic's bf16 accumulation and bf16 first moment at
one bf16 step, since an f32 difference of an ulp can round a bf16 value
the other way.  Remat against no remat: bit for bit."""
from dataclasses import replace

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, get_arch
from repro_torch.launch import steps as psteps
from repro_torch.models import gnn as pgnn
from repro_torch.models import transformer as ptf
from repro_torch.models.convert import (adafactor_state_from_numpy,
                                        adam_state_from_numpy,
                                        gnn_params_from_numpy,
                                        lm_params_from_numpy,
                                        mind_params_from_numpy,
                                        sasrec_params_from_numpy,
                                        twotower_params_from_numpy,
                                        xdeepfm_params_from_numpy)
from repro_torch.tree import leaves

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro import jax_compat  # noqa: E402
from repro.configs import get_arch as ref_get_arch  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402

LOSS_RTOL = 1e-5
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
STEP_TOL = dict(rtol=1e-5, atol=1e-6)
CONVERT = {"LMConfig": lm_params_from_numpy,
           "GNNConfig": gnn_params_from_numpy,
           "XDeepFMConfig": xdeepfm_params_from_numpy,
           "SASRecConfig": sasrec_params_from_numpy,
           "MINDConfig": mind_params_from_numpy,
           "TwoTowerConfig": twotower_params_from_numpy}


def _smoke(arch_id):
    """(port spec, reference spec), each with its smoke config as config."""
    spec, ref = get_arch(arch_id), ref_get_arch(arch_id)
    return (replace(spec, config=spec.smoke_config),
            replace(ref, config=ref.smoke_config))


def _params(arch_id, seed):
    """(reference params, port params): the JAX smoke init, its all-zero
    leaves (norm gains, the wide table, cin_out, biases) replaced by seeded
    N(0, 0.1^2) values so that every weight takes part."""
    rng = np.random.default_rng(seed)
    ref = ref_get_arch(arch_id)
    params = jsteps.family_init(ref, smoke=True)(jax.random.PRNGKey(seed))

    def fill(a):
        a = np.asarray(a)
        return a if a.any() else (0.1 * rng.normal(size=a.shape)).astype(a.dtype)

    tree = jax.tree.map(fill, params)
    cfg = ref.smoke_config
    port = CONVERT[type(cfg).__name__](get_arch(arch_id).smoke_config, tree,
                                       "cpu")
    return jax.tree.map(jnp.asarray, tree), port


def _batches(arch_id, seed):
    """(reference batch, port batch) from the arch's smoke_batch with one
    numpy seed (two-tower's logQ replaced by seeded values)."""
    spec, ref = get_arch(arch_id), ref_get_arch(arch_id)
    jb = ref.smoke_batch(ref.smoke_config, np.random.default_rng(seed))
    pb = spec.smoke_batch(spec.smoke_config, np.random.default_rng(seed),
                          "cpu")
    for k in jb:
        np.testing.assert_array_equal(np.asarray(jb[k]), pb[k].numpy())
    if arch_id == "two-tower-retrieval":   # a logQ that moves the loss
        logq = np.random.default_rng(seed + 1).normal(
            size=jb["logq"].shape).astype(np.float32)
        jb["logq"], pb["logq"] = jnp.asarray(logq), torch.from_numpy(logq)
    return jb, pb


def _close_trees(got, want, **tol):
    g, w = leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        b = np.asarray(b).astype(np.float32)
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.detach().float().numpy(), b, **tol)


def _with_padding(arch_id, jb, pb):
    """SASRec and MIND batches with left padding (id 0) and, for SASRec,
    padded positives, so that the masks take part."""
    for k in ("seq",) + (("pos", "neg") if arch_id == "sasrec" else ()):
        a = np.asarray(jb[k]).copy()
        for r in range(a.shape[0]):
            a[r, :(3 * r) % a.shape[1]] = 0
        jb[k], pb[k] = jnp.asarray(a), torch.from_numpy(a)
    return jb, pb


@pytest.mark.parametrize("arch_id,padded", [(a, False) for a in sorted(ARCHS)]
                         + [("sasrec", True), ("mind", True)])
def test_loss_and_grads_match_reference(arch_id, padded):
    spec, ref = _smoke(arch_id)
    jp, pp = _params(arch_id, 3)
    jb, pb = _batches(arch_id, 5)
    if padded:
        jb, pb = _with_padding(arch_id, jb, pb)
    want_loss, want_grads = jax.value_and_grad(jsteps.family_loss(ref))(jp, jb)
    loss, grads = psteps.value_and_grad(psteps.family_loss(spec), pp, pb)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=LOSS_RTOL)
    _close_trees(grads, want_grads, **GRAD_TOL)
    assert all(p.grad is None for p in leaves(pp))


def test_chunked_ce_leaves_out_the_ragged_tail():
    """S = 40 over ce_chunk 16: two chunks, positions 32-39 left out, as in
    the JAX package; their labels move nothing."""
    spec, _ = _smoke("olmo-1b")
    cfg = spec.config
    jp, pp = _params("olmo-1b", 4)
    rng = np.random.default_rng(6)
    h = rng.normal(size=(2, 40, cfg.d_model)).astype(np.float32)
    labels = rng.integers(0, cfg.vocab, (2, 40)).astype(np.int32)
    mask = (rng.random((2, 40)) < 0.8).astype(np.float32)
    jcfg = ref_get_arch("olmo-1b").smoke_config
    want = jtf.chunked_ce_loss(jcfg, jp, jnp.asarray(h), jnp.asarray(labels),
                               jnp.asarray(mask))
    t = [torch.from_numpy(x) for x in (h, labels, mask)]
    got = ptf.chunked_ce_loss(cfg, pp, *t)
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)
    t[1][:, 32:] = (t[1][:, 32:] + 1) % cfg.vocab
    assert float(ptf.chunked_ce_loss(cfg, pp, *t)) == float(got)
    t[1][:, 31] = (t[1][:, 31] + 1) % cfg.vocab
    assert float(ptf.chunked_ce_loss(cfg, pp, *t)) != float(got)


def _double_batch(arch_id):
    """Two smoke batches' rows stacked: the microbatched step's input."""
    parts = [_batches(arch_id, s) for s in (7, 8)]
    jb = {k: jnp.concatenate([p[0][k] for p in parts]) for k in parts[0][0]}
    pb = {k: torch.cat([p[1][k] for p in parts]) for k in parts[0][1]}
    return jb, pb


def _ref_step(ref, shape, jp, jo, jb):
    """The reference's make_train_step, run on a 1x1 mesh (its microbatch
    reshape pins a sharding)."""
    fn = jsteps.make_train_step(ref, shape)
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))
    with mesh, jax_compat.set_mesh(mesh):
        return jax.jit(fn)(jp, jo, jb)


def test_make_train_step_microbatched_adamw_matches_reference():
    """olmo smoke, 4 rows as 2 microbatches, 3 steps of AdamW."""
    spec, ref = _smoke("olmo-1b")
    shape = replace(spec.shape("train_4k"), n_microbatches=2)
    jp, pp = _params("olmo-1b", 9)
    jo = jsteps._init_opt(ref, jsteps.make_optimizer(ref)[0], jp)
    po = adam_state_from_numpy(jax.tree.map(np.asarray, jo), "cpu")
    step = psteps.make_train_step(spec, shape)
    for _ in range(3):
        jb, pb = _double_batch("olmo-1b")
        jp, jo, jm = _ref_step(ref, shape, jp, jo, jb)
        pp, po, pm = step(pp, po, pb)
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(pm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
        _close_trees(pp, jp, **STEP_TOL)
    assert int(po.step) == int(jo.step) == 3
    _close_trees(po.mu, jo.mu, **GRAD_TOL)


def test_make_train_step_arctic_adafactor_bf16_accumulation():
    """arctic smoke: Adafactor with its bf16 first moment, gradients of 2
    microbatches summed in bf16."""
    spec, ref = _smoke("arctic-480b")
    assert spec.optimizer == "adafactor" and spec.grad_accum_dtype == "bfloat16"
    shape = replace(spec.shape("train_4k"), n_microbatches=2)
    jp, pp = _params("arctic-480b", 10)
    jo = jsteps._init_opt(ref, jsteps.make_optimizer(ref)[0], jp)
    po = adafactor_state_from_numpy(jax.tree.map(np.asarray, jo), "cpu")
    assert all(m.dtype == torch.bfloat16 for m in leaves(po.mu))
    step = psteps.make_train_step(spec, shape)
    for _ in range(2):
        jb, pb = _double_batch("arctic-480b")
        jp, jo, jm = _ref_step(ref, shape, jp, jo, jb)
        pp, po, pm = step(pp, po, pb)
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                                   rtol=LOSS_RTOL)
        _close_trees(pp, jp, **STEP_TOL)
    for got, want in zip(leaves(po.mu), jax.tree.leaves(jo.mu)):
        want = np.asarray(want).astype(np.float32)
        scale = float(np.abs(want).max()) or 1.0
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7,
                                   atol=2 ** -7 * scale)
    _close_trees(po.vr, jo.vr, rtol=2 ** -6, atol=1e-12)
    _close_trees(po.vc, jo.vc, rtol=2 ** -6, atol=1e-12)


@pytest.mark.parametrize("arch_id", ["olmo-1b", "arctic-480b", "meshgraphnet"])
def test_remat_changes_nothing(arch_id):
    spec, _ = _smoke(arch_id)
    cfg = spec.config
    _, pp = _params(arch_id, 11)
    _, pb = _batches(arch_id, 12)
    loss_of = (ptf.lm_loss if spec.family == "lm" else pgnn.gnn_loss)
    out = [psteps.value_and_grad(
        lambda p, b, r=remat: loss_of(cfg, p, b, remat=r)[0], pp, pb)
        for remat in (True, False)]
    assert float(out[0][0]) == float(out[1][0])
    for a, b in zip(leaves(out[0][1]), leaves(out[1][1])):
        assert torch.equal(a, b)
