"""The port's optimizers, gradient quantizers and the embedding-bag
gradient against the JAX package, on numpy-seeded inputs handed to both.

AdamW and Adafactor run a few steps from the same state with fresh
gradients each step: the global-norm clip active (gradients far past norm
1), warmup crossed, weight decay, bf16 parameters, a layer-stacked (8,
...) leaf and a 4-D (8, 9, ...) leaf, which Adafactor updates slice by
slice twice over.  Tolerances: Adam rtol 1e-6 (atol 1e-7), Adafactor
rtol 1e-5 (atol 1e-6) for f32 states and parameters; a bf16 leaf (a bf16
parameter, Adafactor's bf16 first moment) within one bf16 step (rtol
2^-7, a step's largest share of a value), since f32 values that differ in their last bit can round to
neighbouring bf16 values.  The
int8 quantizers are exact but for the f32 scale (rtol 1e-7).  The
embedding-bag gradient (plain version, the autograd path on the CPU)
against ``jax.vjp`` of the reference's ``embedding_bag`` at rtol/atol
1e-6, with duplicate ids within and across bags, and empty inputs."""
import numpy as np
import pytest
import torch

from repro_torch.kernels.embedding_bag.ops import (embedding_bag_backward,
                                                   embedding_bag_sum)
from repro_torch.kernels.embedding_bag.ref import embedding_bag_backward_ref
from repro_torch.models.convert import (adafactor_state_from_numpy,
                                        adam_state_from_numpy,
                                        tensor_from_numpy)
from repro_torch.optim import adafactor as paf
from repro_torch.optim import adam as pad
from repro_torch.optim import compress as pcq
from repro_torch.tree import leaves

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.models import recsys as jrs  # noqa: E402
from repro.optim import adafactor as jaf  # noqa: E402
from repro.optim import adam as jad  # noqa: E402
from repro.optim import compress as jcq  # noqa: E402

ADAM_TOL = dict(rtol=1e-6, atol=1e-7)
ADAFACTOR_TOL = dict(rtol=1e-5, atol=1e-6)
SHAPES = {"bias": ((5,), "float32"), "w": ((6, 7), "float32"),
          "stack": ((8, 4, 6), "float32"), "deep": ((8, 9, 3, 5), "float32"),
          "emb": ((4, 10), "bfloat16")}


def _tree(rng, scale=1.0):
    """A numpy tree of SHAPES plus a list subtree, f32 values (bf16 leaves
    are cast by each side)."""
    t = {k: (scale * rng.normal(size=s)).astype(np.float32)
         for k, (s, _) in SHAPES.items()}
    t["blocks"] = [(scale * rng.normal(size=(3,))).astype(np.float32),
                   (scale * rng.normal(size=(2, 3))).astype(np.float32)]
    return t


def _as_jax(t):
    out = {k: jnp.asarray(v, SHAPES[k][1] if k in SHAPES else "float32")
           for k, v in t.items() if k != "blocks"}
    out["blocks"] = [jnp.asarray(v) for v in t["blocks"]]
    return out


def _as_port(t):
    return jax.tree.map(lambda a: tensor_from_numpy(np.asarray(a), "cpu"), t)


def _close(got, want, tol):
    g, w = leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert tuple(a.shape) == tuple(np.shape(b))
        assert str(a.dtype).split(".")[-1] == str(np.asarray(b).dtype)
        leaf_tol = (dict(tol, rtol=max(tol["rtol"], 2 ** -7))
                    if a.dtype == torch.bfloat16 else tol)
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(b).astype(np.float32),
                                   **leaf_tol)


@pytest.mark.parametrize("cfg", [
    dict(),
    dict(warmup_steps=3, weight_decay=0.01, lr=1e-2),
    dict(grad_clip=0.0, warmup_steps=1, b2=0.999)])
def test_adam_matches_reference(cfg):
    rng = np.random.default_rng(0)
    jp = _as_jax(_tree(rng))
    pp = _as_port(jp)
    jcfg, pcfg = jad.AdamConfig(**cfg), pad.AdamConfig(**cfg)
    js = jad.init_adam(jp)
    ps = pad.init_adam(pp)
    _close(ps.mu, js.mu, ADAM_TOL)
    for _ in range(5):
        g = _as_jax(_tree(rng, scale=3.0))
        jp, js, jm = jax.jit(lambda p, g, s: jad.adam_update(jcfg, p, g, s))(
            jp, g, js)
        pp, ps, pm = pad.adam_update(pcfg, pp, _as_port(g), ps)
        _close(pp, jp, ADAM_TOL)
        _close(ps.mu, js.mu, ADAM_TOL)
        _close(ps.nu, js.nu, ADAM_TOL)
        np.testing.assert_allclose(float(pm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(pm["lr"]), float(jm["lr"]),
                                   rtol=1e-7)
        assert int(ps.step) == int(js.step)
    if cfg.get("grad_clip", 1.0) > 0:
        assert float(pm["grad_norm"]) > 1.0         # the clip was active


def test_adam_update_leaves_its_arguments():
    rng = np.random.default_rng(1)
    pp = _as_port(_as_jax(_tree(rng)))
    ps = pad.init_adam(pp)
    g = _as_port(_as_jax(_tree(rng)))
    before = [x.clone() for x in leaves((pp, ps))]
    pad.adam_update(pad.AdamConfig(), pp, g, ps)
    assert all(torch.equal(a, b) for a, b in zip(before, leaves((pp, ps))))


@pytest.mark.parametrize("cfg", [
    dict(),
    dict(warmup_steps=3, weight_decay=0.01, lr=1e-2, mu_dtype="float32"),
    dict(b1=0.0, mu_dtype="float32", clip_threshold=0.5)])
def test_adafactor_matches_reference(cfg):
    """The default config keeps its bf16 first moment; the lr-1e-2 case
    keeps it in f32, since there a one-step bf16 rounding difference of
    the moment, times the lr, would pass the parameters' f32 tolerance."""
    rng = np.random.default_rng(2)
    jp = _as_jax(_tree(rng))
    pp = _as_port(jp)
    jcfg, pcfg = jaf.AdafactorConfig(**cfg), paf.AdafactorConfig(**cfg)
    js = jaf.init_adafactor(jcfg, jp)
    ps = paf.init_adafactor(pcfg, pp)
    for part in ("mu", "vr", "vc"):
        _close(getattr(ps, part), getattr(js, part), ADAFACTOR_TOL)
    for _ in range(4):
        g = _as_jax(_tree(rng, scale=3.0))
        jp, js, jm = jax.jit(
            lambda p, g, s: jaf.adafactor_update(jcfg, p, g, s))(jp, g, js)
        pp, ps, pm = paf.adafactor_update(pcfg, pp, _as_port(g), ps)
        _close(pp, jp, ADAFACTOR_TOL)
        for part in ("mu", "vr", "vc"):
            _close(getattr(ps, part), getattr(js, part), ADAFACTOR_TOL)
        np.testing.assert_allclose(float(pm["lr"]), float(jm["lr"]),
                                   rtol=1e-7)


def test_adafactor_clips_each_slice_of_a_stacked_leaf():
    """A stacked leaf's slices are clipped one by one: a slice whose
    gradient is 1000x its neighbours' moves no further than theirs."""
    cfg = paf.AdafactorConfig(b1=0.0, warmup_steps=1, lr=1.0)
    p = {"stack": torch.zeros(8, 4, 6)}
    g = torch.ones(8, 4, 6)
    g[3] *= 1000.0
    s = paf.init_adafactor(cfg, p)
    new, _, _ = paf.adafactor_update(cfg, p, {"stack": g}, s)
    step = new["stack"].abs().amax(dim=(1, 2))
    assert torch.allclose(step, step[0].expand(8), rtol=1e-5)


def test_state_converters_carry_the_reference_state():
    rng = np.random.default_rng(3)
    jp = _as_jax(_tree(rng))
    js = jad.adam_update(jad.AdamConfig(), jp, _as_jax(_tree(rng)),
                         jad.init_adam(jp))[1]
    ps = adam_state_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    assert int(ps.step) == 1 and ps.step.dtype == torch.int32
    _close(ps.mu, js.mu, dict(rtol=0, atol=0))
    acfg = jaf.AdafactorConfig()
    fs = jaf.adafactor_update(acfg, jp, _as_jax(_tree(rng)),
                              jaf.init_adafactor(acfg, jp))[1]
    pf = adafactor_state_from_numpy(jax.tree.map(np.asarray, fs), "cpu")
    for part in ("mu", "vr", "vc"):
        _close(getattr(pf, part), getattr(fs, part), dict(rtol=0, atol=0))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_quantizers_match_reference(dtype):
    rng = np.random.default_rng(4)
    x = jnp.asarray(rng.normal(size=(3, 50)) * 5, dtype)
    err = jnp.asarray(rng.normal(size=(3, 50)) * 0.01, "float32")
    xt, et = (tensor_from_numpy(np.asarray(a), "cpu") for a in (x, err))
    q, scale = pcq.quantize_int8(xt)
    jq, jscale = jcq.quantize_int8(x)
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(float(scale), float(jscale), rtol=1e-7)
    np.testing.assert_allclose(pcq.dequantize_int8(q, scale).numpy(),
                               np.asarray(jcq.dequantize_int8(jq, jscale)),
                               rtol=1e-7)
    q, scale, new_err = pcq.quantize_with_feedback(xt, et)
    jq, jscale, jerr = jcq.quantize_with_feedback(x, err)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(new_err.numpy(), np.asarray(jerr), rtol=1e-6,
                               atol=1e-6)
    fb = pcq.init_error_feedback({"a": xt, "b": [et]})
    assert all(t.dtype == torch.float32 and not t.any() for t in leaves(fb))
    with pytest.raises(NotImplementedError):
        pcq.compressed_psum(xt, et, "pod")


# ------------------------------------------------ the embedding-bag gradient
def _bags(seed, v, d, b, bag):
    """A table, ids with repeats inside bags and across them, and an
    upstream gradient."""
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(v, d)).astype(np.float32)
    idx = rng.integers(0, max(v // 3, 1), (b, bag)).astype(np.int32)
    if b and bag > 1:
        idx[:, 1] = idx[:, 0]            # a repeat inside every bag
    go = rng.normal(size=(b, d)).astype(np.float32)
    return table, idx, go


@pytest.mark.parametrize("v,d,b,bag", [(50, 4, 16, 5), (30, 1, 64, 39),
                                       (7, 3, 9, 70), (20, 8, 0, 3),
                                       (20, 8, 5, 0), (1, 2, 6, 4)])
def test_embedding_bag_backward_matches_jax_grad(v, d, b, bag):
    table, idx, go = _bags(v + d + b + bag, v, d, b, bag)
    _, vjp = jax.vjp(lambda t: jrs.embedding_bag(t, jnp.asarray(idx),
                                                 mode="sum"),
                     jnp.asarray(table))
    want = np.asarray(vjp(jnp.asarray(go))[0])
    tol = dict(rtol=1e-6, atol=1e-6)
    idx_t, go_t = torch.from_numpy(idx), torch.from_numpy(go)
    np.testing.assert_allclose(
        embedding_bag_backward_ref(go_t, idx_t, v).numpy(), want, **tol)
    before = embedding_bag_backward.launch_count
    np.testing.assert_allclose(embedding_bag_backward(go_t, idx_t, v).numpy(),
                               want, **tol)
    t = torch.from_numpy(table).requires_grad_(True)
    embedding_bag_sum(t, idx_t).backward(go_t)
    np.testing.assert_allclose(t.grad.numpy(), want, **tol)
    assert embedding_bag_backward.launch_count == before   # CPU: no kernel


def test_embedding_bag_backward_rejects_bad_arguments():
    go, idx = torch.zeros((2, 3)), torch.zeros((2, 4), dtype=torch.int32)
    for args in ((go.double(), idx, 5), (go, idx.long(), 5),
                 (go, idx[:1].contiguous(), 5), (go, idx, -1),
                 (go.t(), torch.zeros((3, 4), dtype=torch.int32), 5)):
        with pytest.raises(ValueError):
            embedding_bag_backward(*args)
    idx_grad = torch.zeros((2, 4), dtype=torch.int32)
    t = torch.zeros((5, 3), requires_grad=True)
    out = embedding_bag_sum(t, idx_grad)
    assert out.requires_grad and out.grad_fn is not None
    with torch.no_grad():
        assert embedding_bag_sum(t, idx_grad).grad_fn is None
