"""The port's model-serving paths against the JAX package, with weights
carried across by ``repro_torch.models.convert``: the shared layers,
blockwise and decode attention, the MoE FFN, the smoke configs of the five
LM archs (llama3, gemma2, olmo, phi3.5-moe, arctic) through prefill, decode
and greedy generation, two-tower retrieval and xDeepFM scoring; the
registry of all ten archs, the converters and the serving glue (SASRec and
MIND in ``test_torch_recsys.py``, MeshGraphNet in ``test_torch_gnn.py``).  Inputs
are made with numpy from a seed and handed to both packages.

Tolerances: float32 throughout, 2e-5 for single layers and 2e-4 for whole
models (as ``tests/test_models.py`` holds decode against prefill): the two
packages sum in other orders, and a 3-layer model compounds that."""
from dataclasses import replace

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, get_arch
from repro_torch.launch import serve as port_serve
from repro_torch.launch.steps import family_init, make_serve_step, serve_fn
from repro_torch.models import attention as pa
from repro_torch.models import layers as pl
from repro_torch.models import moe as pm
from repro_torch.models import recsys as prs
from repro_torch.models import transformer as ptf
from repro_torch.models.convert import (gnn_params_from_numpy,
                                        lm_params_from_numpy,
                                        mind_params_from_numpy,
                                        sasrec_params_from_numpy,
                                        tensor_from_numpy,
                                        twotower_params_from_numpy,
                                        xdeepfm_params_from_numpy)

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.configs import ARCHS as REF_ARCHS  # noqa: E402
from repro.configs import get_arch as ref_get_arch  # noqa: E402
from repro.launch.steps import family_init as ref_family_init  # noqa: E402
from repro.models import attention as ja  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models import moe as jm  # noqa: E402
from repro.models import recsys as jrs  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402

LAYER_TOL = dict(rtol=2e-5, atol=2e-5)
MODEL_TOL = dict(rtol=2e-4, atol=2e-4)
LM_ARCHS = ("llama3-8b", "gemma2-9b", "olmo-1b", "phi3.5-moe-42b-a6.6b",
            "arctic-480b")


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().cpu().numpy(), np.asarray(want),
                               **tol)


def _numpy_params(arch_id, seed):
    """The JAX smoke init as a numpy tree, its all-zero leaves (norm gains,
    the wide table, cin_out, biases) replaced by seeded N(0, 0.1^2) values
    so that every weight takes part in the comparison."""
    rng = np.random.default_rng(seed)
    params = ref_family_init(ref_get_arch(arch_id), smoke=True)(
        jax.random.PRNGKey(seed))

    def fill(a):
        a = np.asarray(a)
        return a if a.any() else (0.1 * rng.normal(size=a.shape)).astype(a.dtype)

    return jax.tree.map(fill, params)


# ------------------------------------------------------------------ layers
def test_rms_norm_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 64)).astype(np.float32)
    w = (0.1 * rng.normal(size=64)).astype(np.float32)
    _close(pl.rms_norm(torch.from_numpy(x), torch.from_numpy(w)),
           jl.rms_norm(jnp.asarray(x), jnp.asarray(w)), LAYER_TOL)
    _close(pl.rms_norm(torch.from_numpy(x)), jl.rms_norm(jnp.asarray(x)),
           LAYER_TOL)
    _close(pl.layer_norm_nonparam(torch.from_numpy(x)),
           jl.layer_norm_nonparam(jnp.asarray(x)), LAYER_TOL)


def test_rope_matches_reference():
    """The half-split layout: a reference in the interleaved layout would
    differ here."""
    rng = np.random.default_rng(1)
    pos = np.arange(7)[None].repeat(2, 0) + np.array([[0], [40]])
    x = rng.normal(size=(2, 7, 3, 16)).astype(np.float32)
    cos, sin = pl.rope_table(torch.from_numpy(pos), 16, 500000.0)
    jcos, jsin = jl.rope_table(jnp.asarray(pos), 16, 500000.0)
    _close(cos, jcos, LAYER_TOL)
    _close(sin, jsin, LAYER_TOL)
    _close(pl.apply_rope(torch.from_numpy(x), cos, sin),
           jl.apply_rope(jnp.asarray(x), jcos, jsin), LAYER_TOL)


def test_mlp_apply_matches_reference():
    rng = np.random.default_rng(2)
    sizes = [12, 32, 16, 4]
    tree = {f"w{i}": rng.normal(size=(sizes[i], sizes[i + 1])).astype(np.float32)
            for i in range(3)}
    tree.update({f"b{i}": rng.normal(size=sizes[i + 1]).astype(np.float32)
                 for i in range(3)})
    x = rng.normal(size=(5, 12)).astype(np.float32)
    got = pl.mlp_apply({k: torch.from_numpy(v) for k, v in tree.items()},
                       torch.from_numpy(x))
    want = jl.mlp_apply({k: jnp.asarray(v) for k, v in tree.items()},
                        jnp.asarray(x))
    _close(got, want, LAYER_TOL)
    _close(pl.softcap(torch.from_numpy(x), 3.0), jl.softcap(jnp.asarray(x), 3.0),
           LAYER_TOL)


# --------------------------------------------------------------- attention
@pytest.mark.parametrize("sq,sk,hq,hkv,causal,window,cap", [
    (37, 37, 4, 2, True, None, None),       # ragged chunks, GQA
    (16, 40, 2, 2, False, None, None),      # cross lengths, MHA
    (33, 33, 6, 3, True, 9, 20.0),          # window and softcap
])
def test_blockwise_attention_matches_reference(sq, sk, hq, hkv, causal,
                                               window, cap):
    rng = np.random.default_rng(sq + sk + hq)
    q = rng.normal(size=(2, sq, hq, 16)).astype(np.float32)
    k = rng.normal(size=(2, sk, hkv, 16)).astype(np.float32)
    v = rng.normal(size=(2, sk, hkv, 16)).astype(np.float32)
    kw = dict(causal=causal, window=window, attn_softcap=cap, q_chunk=8,
              kv_chunk=16)
    got = pa.blockwise_attention(*map(torch.from_numpy, (q, k, v)), **kw)
    want = ja.blockwise_attention(*map(jnp.asarray, (q, k, v)), **kw)
    _close(got, want, LAYER_TOL)


@pytest.mark.parametrize("window,cap", [(None, None), (5, 30.0)])
def test_decode_attention_matches_reference(window, cap):
    rng = np.random.default_rng(3)
    q = rng.normal(size=(3, 1, 8, 16)).astype(np.float32)
    k = rng.normal(size=(3, 50, 2, 16)).astype(np.float32)
    v = rng.normal(size=(3, 50, 2, 16)).astype(np.float32)
    got = pa.decode_attention(*map(torch.from_numpy, (q, k, v)), 31,
                              window=window, attn_softcap=cap)
    want = ja.decode_attention(*map(jnp.asarray, (q, k, v)), jnp.int32(31),
                               window=window, attn_softcap=cap)
    _close(got, want, LAYER_TOL)
    x = torch.from_numpy(k)
    assert torch.equal(pa.repeat_kv(x, 3),
                       torch.from_numpy(np.array(ja.repeat_kv(jnp.asarray(k), 3))))


# -------------------------------------------------------------------- MoE
def _moe_inputs(seed, t, d, e, f, tie=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(t, d)).astype(np.float32)
    w = {"router": (rng.normal(size=(d, e)) * d ** -0.5).astype(np.float32),
         "w_gate": (rng.normal(size=(e, d, f)) * d ** -0.5).astype(np.float32),
         "w_up": (rng.normal(size=(e, d, f)) * d ** -0.5).astype(np.float32),
         "w_down": (rng.normal(size=(e, f, d)) * f ** -0.5).astype(np.float32)}
    if tie:                            # experts 2 and 5 route identically
        w["router"][:, 5] = w["router"][:, 2]
    return x, w


@pytest.mark.parametrize("cf,tie", [(8.0, False), (1.0, False), (1.0, True)])
def test_moe_ffn_matches_reference(cf, tie):
    """Out and aux against the JAX ``moe_ffn``: at capacity factor 8 no
    token is dropped, at 1.0 some are (and which ones depends on each
    expert's queue order); with two experts whose router columns are
    equal, every token ties between them and ``jax.lax.top_k`` takes the
    lower index."""
    t, d, e, f, k = 40, 16, 8, 24, 2
    x, w = _moe_inputs(int(cf) + tie, t, d, e, f, tie)
    kw = dict(n_experts=e, top_k=k, capacity_factor=cf)
    got, aux = pm.moe_ffn(torch.from_numpy(x),
                          {n: torch.from_numpy(a) for n, a in w.items()}, **kw)
    want, jaux = jm.moe_ffn(jnp.asarray(x),
                            {n: jnp.asarray(a) for n, a in w.items()}, **kw)
    _close(got, want, LAYER_TOL)
    _close(aux, jaux, LAYER_TOL)
    cap = pm.capacity_of(t, e, k, cf)
    probs = torch.softmax(torch.from_numpy(x @ w["router"]), -1)
    routed = torch.bincount(pm.top_k_lower_first(probs, k)[1].reshape(-1),
                            minlength=e)
    assert (int(routed.max()) > cap) == (cf == 1.0)   # drops only at 1.0


def test_top_k_breaks_ties_as_reference():
    rng = np.random.default_rng(14)
    probs = rng.integers(0, 4, (64, 128)).astype(np.float32) / 4
    vals, idx = pm.top_k_lower_first(torch.from_numpy(probs), 3)
    jvals, jidx = jax.lax.top_k(jnp.asarray(probs), 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))
    assert pm.capacity_of(8, 16, 2, 1.25) == 1      # decode: 8 tokens
    assert pm.capacity_of(8, 128, 2, 1.25) == 1
    assert pm.capacity_of(3, 2, 2, 8.0) == 3       # capped at T


# ------------------------------------------------------------ the LM archs
_LM_CASES = {}


def _lm(arch):
    """(JAX smoke config, port smoke config, JAX params, port params)."""
    if arch not in _LM_CASES:
        tree = _numpy_params(arch, 0)
        cfg = get_arch(arch).smoke_config
        _LM_CASES[arch] = (ref_get_arch(arch).smoke_config, cfg,
                           jax.tree.map(jnp.asarray, tree),
                           lm_params_from_numpy(cfg, tree, "cpu"))
    return _LM_CASES[arch]


@pytest.fixture(scope="module")
def llama():
    return _lm("llama3-8b")


def _prefill_decode_and_greedy_tokens_match(jcfg, cfg, jp, pp):
    """Prefill 2 x 24 tokens, then 8 greedy decode steps: logits, caches
    and tokens against the JAX package."""
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (2, 24)) \
        .astype(np.int32)
    jcache, jlogits = jtf.prefill(jcfg, jp, jnp.asarray(toks))
    cache, logits = ptf.prefill(cfg, pp, torch.from_numpy(toks))
    _close(logits, jlogits, MODEL_TOL)
    _close(cache["k"], jcache["k"], MODEL_TOL)
    _close(cache["v"], jcache["v"], MODEL_TOL)

    jfull = jtf.init_cache(jcfg, 2, 32, jnp.float32)
    jfull = {n: jfull[n].at[:, :, :24].set(jcache[n]) for n in ("k", "v")}
    full = ptf.init_cache(cfg, 2, 32, device="cpu")
    for n in ("k", "v"):
        full[n][:, :, :24] = cache[n]
    jtok = jnp.argmax(jlogits, -1).astype(jnp.int32)
    tok = logits.argmax(-1).to(torch.int32)
    for i in range(8):                       # 8 greedy tokens
        jfull, jtok, jstep = jtf.decode_step(jcfg, jp, jfull, jtok, 24 + i)
        full, tok, step = ptf.decode_step(cfg, pp, full, tok, 24 + i)
        _close(step, jstep, MODEL_TOL)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    _close(full["k"], jfull["k"], MODEL_TOL)
    _close(full["v"], jfull["v"], MODEL_TOL)


def test_llama3_prefill_decode_and_greedy_tokens_match_reference(llama):
    _prefill_decode_and_greedy_tokens_match(*llama)


@pytest.mark.parametrize("arch", LM_ARCHS[1:])
def test_lm_prefill_decode_and_greedy_tokens_match_reference(arch):
    """gemma2's 24-token prompt is longer than its smoke window of 8, so
    its local layers' window bites in prefill and in every decode step;
    the MoE archs' decode steps route 2 tokens at capacity 1."""
    jcfg, cfg, jp, pp = _lm(arch)
    assert vars(cfg) == vars(jcfg)
    _prefill_decode_and_greedy_tokens_match(jcfg, cfg, jp, pp)


def test_window_without_alternation_applies_to_every_layer(llama):
    """A sliding window with no local/global period: the JAX package gives
    every layer the window, and so must the port (24 tokens, window 8)."""
    jcfg, cfg, jp, pp = llama
    jcfg, cfg = (replace(c, sliding_window=8) for c in (jcfg, cfg))
    assert all(ptf.layer_window(cfg, i) == 8 for i in range(cfg.n_layers))
    _prefill_decode_and_greedy_tokens_match(jcfg, cfg, jp, pp)


def _decode_matches_longer_prefill(cfg, pp):
    """The port's own invariant, as the JAX package's
    ``test_lm_decode_matches_prefill``: a decode step after prefill gives
    the logits of prefilling the prompt one token longer."""
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab, (2, 20)).astype(np.int32))
    cache, logits = ptf.prefill(cfg, pp, toks)
    full = ptf.init_cache(cfg, 2, 24, device="cpu")
    for n in ("k", "v"):
        full[n][:, :, :20] = cache[n]
    nxt = logits.argmax(-1).to(torch.int32)
    _, _, step = ptf.decode_step(cfg, pp, full, nxt, 20)
    _, longer = ptf.prefill(cfg, pp, torch.cat([toks, nxt[:, None]], 1))
    np.testing.assert_allclose(step.numpy(), longer.numpy(), **MODEL_TOL)


def test_llama3_decode_matches_prefill_of_the_longer_prompt(llama):
    _decode_matches_longer_prefill(llama[1], llama[3])


@pytest.mark.parametrize("arch", ["gemma2-9b", "olmo-1b"])
def test_lm_decode_matches_prefill_of_the_longer_prompt(arch):
    """gemma2's window (8) and olmo's non-parametric norm; not the MoE
    archs, whose capacity depends on the token count."""
    _, cfg, _, pp = _lm(arch)
    _decode_matches_longer_prefill(cfg, pp)


@pytest.mark.parametrize("change", [
    dict(act_batch_axes=("data",)), dict(act_model_axis="model"),
    dict(moe_expert_axis="model"), dict(moe_batch_axes=("data",)),
    dict(attn_seq_parallel=True), "seq_parallel_attention",
    "moe_ffn_sharded"])
def test_unported_lm_features_raise(change):
    """Only the mesh fields (and the functions that need a mesh) wait."""
    if change == "seq_parallel_attention":
        with pytest.raises(NotImplementedError):
            pa.seq_parallel_attention()
        return
    if change == "moe_ffn_sharded":
        with pytest.raises(NotImplementedError):
            pm.moe_ffn_sharded()
        return
    cfg = get_arch("phi3.5-moe-42b-a6.6b").smoke_config
    with pytest.raises(NotImplementedError, match="mesh fields"):
        ptf.init_params(replace(cfg, **change),
                        torch.Generator().manual_seed(0))


# ------------------------------------------------------------------ recsys
def test_two_tower_retrieval_and_serve_match_reference():
    tree = _numpy_params("two-tower-retrieval", 6)
    spec = get_arch("two-tower-retrieval")
    cfg = spec.smoke_config
    jcfg = ref_get_arch("two-tower-retrieval").smoke_config
    jp = jax.tree.map(jnp.asarray, tree)
    pp = twotower_params_from_numpy(cfg, tree, "cpu")
    rng = np.random.default_rng(7)
    user = rng.integers(0, cfg.field_vocab, (1, cfg.n_user_fields)) \
        .astype(np.int32)
    fn = serve_fn(replace(spec, config=cfg), spec.shape("retrieval_cand"))
    scores = fn(pp, {"user_idx": torch.from_numpy(user)})
    want = jrs.twotower_retrieval(jcfg, jp, {"user_idx": jnp.asarray(user)})
    _close(scores, want, LAYER_TOL)
    vals, ids = torch.topk(scores, 10)
    jvals, jids = jax.lax.top_k(want, 10)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    _close(vals, jvals, LAYER_TOL)

    batch = spec.smoke_batch(cfg, np.random.default_rng(8), "cpu")
    got = serve_fn(replace(spec, config=cfg), spec.shape("serve_p99"))(pp, batch)
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    _close(got, jrs.twotower_serve(jcfg, jp, jbatch), LAYER_TOL)


def test_xdeepfm_logits_and_retrieval_match_reference():
    tree = _numpy_params("xdeepfm", 9)
    spec = get_arch("xdeepfm")
    cfg = spec.smoke_config
    jcfg = ref_get_arch("xdeepfm").smoke_config
    jp = jax.tree.map(jnp.asarray, tree)
    pp = xdeepfm_params_from_numpy(cfg, tree, "cpu")
    batch = spec.smoke_batch(cfg, np.random.default_rng(10), "cpu")
    got = serve_fn(replace(spec, config=cfg), spec.shape("serve_p99"))(pp, batch)
    want = jrs.xdeepfm_logits(jcfg, jp, jnp.asarray(batch["idx"].numpy()))
    _close(got, want, MODEL_TOL)

    rng = np.random.default_rng(11)
    one = batch["idx"][:1]
    cand = rng.integers(0, cfg.vocab_per_field, 300).astype(np.int32)
    got = serve_fn(replace(spec, config=cfg), spec.shape("retrieval_cand"))(
        pp, {"idx": one, "cand": torch.from_numpy(cand)})
    want = jrs.xdeepfm_retrieval(jcfg, jp, {"idx": jnp.asarray(one.numpy()),
                                            "cand": jnp.asarray(cand)})
    _close(got, want, MODEL_TOL)


def test_embedding_bag_modes_match_reference():
    rng = np.random.default_rng(12)
    table = rng.normal(size=(50, 6)).astype(np.float32)
    idx = rng.integers(0, 50, (4, 3, 5)).astype(np.int32)
    mask = rng.integers(0, 2, (4, 3, 5)).astype(np.float32)
    mask[0, 0] = 0                                 # an empty bag
    for mode in ("sum", "mean"):
        for m in (None, mask):
            got = prs.embedding_bag(torch.from_numpy(table),
                                    torch.from_numpy(idx), mode=mode,
                                    mask=None if m is None else torch.from_numpy(m))
            want = jrs.embedding_bag(jnp.asarray(table), jnp.asarray(idx),
                                     mode=mode,
                                     mask=None if m is None else jnp.asarray(m))
            _close(got, want, LAYER_TOL)
    np.testing.assert_array_equal(prs._field_offsets([5, 7, 9]).numpy(),
                                  np.asarray(jrs._field_offsets([5, 7, 9])))


# --------------------------------------------------------- registry, glue
def test_registry_holds_the_ported_archs_only():
    """Every arch of the JAX package is ported: the same ids, and each
    config (full and smoke) with the reference's fields and counts."""
    assert sorted(ARCHS) == sorted(REF_ARCHS)
    with pytest.raises(ValueError):
        get_arch("dynawarp")
    with pytest.raises(KeyError):
        get_arch("no-such-arch")
    for arch in REF_ARCHS:
        for full, ref in ((get_arch(arch).config, ref_get_arch(arch).config),
                          (get_arch(arch).smoke_config,
                           ref_get_arch(arch).smoke_config)):
            assert vars(full) == vars(ref), arch
            assert full.param_count() == ref.param_count(), arch
            if arch in LM_ARCHS:
                assert full.active_param_count() == \
                    ref.active_param_count(), arch
        assert sorted(get_arch(arch).shapes) == \
            sorted(ref_get_arch(arch).shapes), arch


def test_port_init_has_the_reference_shapes():
    for arch in ARCHS:
        params = family_init(get_arch(arch), smoke=True)(
            torch.Generator().manual_seed(0))
        ref = ref_family_init(ref_get_arch(arch), smoke=True)(
            jax.random.PRNGKey(0))
        got = {k: tuple(v.shape) for k, v in _flat(params).items()}
        want = {k: tuple(np.shape(v)) for k, v in _flat(ref).items()}
        assert got == want, arch


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{prefix}/{k}"))
    return out


def test_converter_carries_bfloat16_exactly():
    ml_dtypes = pytest.importorskip("ml_dtypes")
    a = np.random.default_rng(13).normal(size=(5, 7)).astype(ml_dtypes.bfloat16)
    t = tensor_from_numpy(a, "cpu")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.to(torch.float32).numpy(),
                                  a.astype(np.float32))
    with pytest.raises(ValueError):
        lm_params_from_numpy(get_arch("llama3-8b").smoke_config,
                             {"embed": np.zeros((2, 2)), "layers": {"mlp": {}}},
                             "cpu")


CONVERTERS = {"sasrec": sasrec_params_from_numpy,
              "mind": mind_params_from_numpy,
              "meshgraphnet": gnn_params_from_numpy}


@pytest.mark.parametrize("arch,path,fault", [
    ("gemma2-9b", "layers/ln_attn_post", "missing"),
    ("gemma2-9b", "layers/ln_ffn_post", "shape"),
    ("phi3.5-moe-42b-a6.6b", "layers/moe", "missing"),
    ("phi3.5-moe-42b-a6.6b", "layers/moe/router", "shape"),
    ("phi3.5-moe-42b-a6.6b", "layers/moe/w_down", "missing"),
    ("arctic-480b", "layers/moe/w_gate", "shape"),
    ("arctic-480b", "layers/dense", "missing"),
    ("arctic-480b", "layers/dense/w_up", "shape"),
    ("sasrec", "pos_emb", "missing"),
    ("sasrec", "blocks/1/ffn_w2", "shape"),
    ("sasrec", "blocks/0/ln1", "missing"),
    ("mind", "b_init", "shape"),
    ("mind", "dnn/b1", "missing"),
    ("mind", "S", "missing"),
    ("meshgraphnet", "edge_mlp/w1", "shape"),
    ("meshgraphnet", "node_mlp/b2", "missing"),
    ("meshgraphnet", "decoder", "missing")])
def test_converter_rejects_missing_or_misshapen_keys(arch, path, fault):
    """Each converter checks its tree key by key and shape by shape (an
    LM's post-norms, ``moe`` and ``dense``; SASRec's blocks; MIND's
    ``dnn``; MeshGraphNet's stacked processor MLPs, whose ``w1`` cut on its
    last axis mis-shapes one layer's weight of the stack); the intact tree
    converts."""
    tree = jax.tree.map(np.asarray, ref_family_init(
        ref_get_arch(arch), smoke=True)(jax.random.PRNGKey(0)))
    cfg = get_arch(arch).smoke_config
    convert = CONVERTERS.get(arch, lm_params_from_numpy)
    convert(cfg, tree, "cpu")
    *parents, leaf = path.split("/")
    node = tree
    for key in parents:
        node = node[int(key)] if isinstance(node, list) else node[key]
    if fault == "missing":
        del node[leaf]
    else:
        node[leaf] = node[leaf][..., :-1]
    with pytest.raises(ValueError, match=leaf if fault == "shape"
                       else "missing"):
        convert(cfg, tree, "cpu")


def test_default_device_without_gpu_raises(monkeypatch):
    from repro_torch.device import generator
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generator(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_serve.main(["--arch", "xdeepfm"])


@pytest.mark.parametrize("arch,want", [
    ("llama3-8b", "generated (4, 16)"), ("two-tower-retrieval", "8 requests"),
    ("gemma2-9b", "gemma2-smoke on cpu: generated (4, 16)"),
    ("olmo-1b", "olmo-smoke on cpu: generated (4, 16)"),
    ("phi3.5-moe-42b-a6.6b", "phi35-smoke on cpu: generated (4, 16)"),
    ("arctic-480b", "arctic-smoke on cpu: generated (4, 16)"),
    ("sasrec", "sasrec-smoke on cpu: 8 requests"),
    ("mind", "mind-smoke on cpu: 8 requests")])
def test_serve_runs_on_cpu_at_smoke_size(arch, want, capsys):
    assert port_serve.main(["--arch", arch, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert want in out
    if arch in ("sasrec", "mind"):           # 32 candidates a request
        assert "scores (8, 32)" in out


def test_serve_refuses_an_arch_without_a_serve_shape():
    """meshgraphnet has no serve shape (the JAX package's serve.py dies on
    a KeyError there); the port names the missing shape."""
    with pytest.raises(ValueError, match="meshgraphnet has no serve shape "
                       "\\('serve_p99'\\)"):
        port_serve.main(["--arch", "meshgraphnet", "--device", "cpu"])


@pytest.mark.parametrize("arch,shape", [
    ("llama3-8b", "prefill_32k"), ("llama3-8b", "decode_32k"),
    ("sasrec", "serve_p99"), ("mind", "retrieval_cand"),
    ("xdeepfm", "serve_p99")])
def test_make_serve_step_matches_the_direct_calls(arch, shape):
    """The serve step of an LM prefill or decode shape (its cache holding
    ``seq - 1`` positions) and of a recsys shape computes what the
    functions it wraps do."""
    spec = get_arch(arch)
    cfg = spec.smoke_config
    spec = replace(spec, config=cfg)
    params = family_init(spec)(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(15)
    if spec.family == "lm":
        sh = replace(spec.shape(shape), dims=dict(seq=12, batch=2))
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 11))
                                .astype(np.int32))
        if shape == "prefill_32k":
            got = make_serve_step(spec, sh)(params, {"tokens": toks})
            want = ptf.prefill(cfg, params, toks)
            torch.testing.assert_close(got[1], want[1])
            return
        cache, logits = ptf.prefill(cfg, params, toks)
        full = ptf.init_cache(cfg, 2, 12, device="cpu")
        for n in ("k", "v"):
            full[n][:, :, :11] = cache[n]
        tok = logits.argmax(-1).to(torch.int32)
        twin = {n: t.clone() for n, t in full.items()}
        _, got_tok, got = make_serve_step(spec, sh)(
            params, {"cache": full, "tokens": tok})
        _, want_tok, want = ptf.decode_step(cfg, params, twin, tok, 11)
        torch.testing.assert_close(got, want)
        assert torch.equal(got_tok, want_tok)
        return
    sh = spec.shape(shape)
    if arch == "xdeepfm":
        batch = spec.smoke_batch(cfg, rng, "cpu")
    else:
        n = 1 if sh.kind == "retrieval" else 4
        batch = {"seq": torch.from_numpy(rng.integers(
            1, cfg.n_items, (n, cfg.seq_len)).astype(np.int32)),
            "cand": torch.from_numpy(rng.integers(
                1, cfg.n_items, (40,) if n == 1 else (n, 9)).astype(np.int32))}
    torch.testing.assert_close(make_serve_step(spec, sh)(params, batch),
                               serve_fn(spec, sh)(params, batch))


@pytest.mark.parametrize("flags", [["--lines", "100"], ["--store", "x"],
                                   ["--flush-deadline-ms", "1.5"]])
def test_serve_store_flags_raise_until_ported(flags):
    """The store server's options (``--arch dynawarp``, named as in the JAX
    package's serve.py) are refused, not silently ignored, with an LM or
    recsys arch."""
    with pytest.raises(ValueError, match=flags[0]):
        port_serve.main(["--arch", "llama3-8b", "--device", "cpu", *flags])
