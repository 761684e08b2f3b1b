"""The port's SASRec, MIND and ragged EmbeddingBag against the JAX package,
with the JAX smoke init carried across by ``repro_torch.models.convert``.
Inputs are made with numpy from a seed and handed to both packages.

Sequences are left-padded (item 0 is padding), as real requests are, and
each batch holds a row that is all padding: SASRec's masked scores are
-1e30, so such a row's query positions take a uniform softmax over every
key, and MIND's routing weights are masked after the softmax.

Tolerance: float32 throughout, rtol = atol = 1e-5 (2 SASRec blocks and 3
MIND routing iterations over 10 positions; the two packages sum in other
orders)."""
from dataclasses import replace

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ragged_ref
from repro_torch.launch.steps import serve_fn
from repro_torch.models import recsys as prs
from repro_torch.models.convert import (mind_params_from_numpy,
                                        sasrec_params_from_numpy)

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.configs import get_arch as ref_get_arch  # noqa: E402
from repro.kernels.embedding_bag.ref import \
    embedding_bag_ragged_ref as jax_ragged_ref  # noqa: E402
from repro.launch.steps import family_init as ref_family_init  # noqa: E402
from repro.models import recsys as jrs  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
CONVERT = {"sasrec": sasrec_params_from_numpy, "mind": mind_params_from_numpy}


def _close(got, want):
    np.testing.assert_allclose(got.detach().cpu().numpy(), np.asarray(want),
                               **TOL)


def _model(arch, seed):
    """(JAX smoke config, port smoke config, JAX params, port params): the
    JAX init, its all-zero leaves (norm gains, biases) replaced by seeded
    N(0, 0.1^2) values so that every weight takes part."""
    rng = np.random.default_rng(seed)
    tree = ref_family_init(ref_get_arch(arch), smoke=True)(
        jax.random.PRNGKey(seed))

    def fill(a):
        a = np.asarray(a)
        return a if a.any() else (0.1 * rng.normal(size=a.shape)).astype(a.dtype)

    tree = jax.tree.map(fill, tree)
    cfg = get_arch(arch).smoke_config
    return (ref_get_arch(arch).smoke_config, cfg,
            jax.tree.map(jnp.asarray, tree), CONVERT[arch](cfg, tree, "cpu"))


def _left_padded(rng, n_items, b, seq_len):
    """(b, seq_len) int32 ids, each row left-padded to a drawn length; with
    more than one row, row 0 is full and row 1 all padding, and one row is
    half padding."""
    lens = rng.integers(1, seq_len + 1, b)
    lens[-1] = seq_len // 2
    if b > 1:
        lens[:2] = seq_len, 0
    seq = rng.integers(1, n_items, (b, seq_len)).astype(np.int32)
    seq[np.arange(seq_len)[None, :] < (seq_len - lens)[:, None]] = 0
    return seq


def _batch(rng, cfg, fn):
    """The inputs of ``fn``: one user and 300 candidates for retrieval, 6
    requests of 7 candidates otherwise."""
    if fn == "retrieval":
        seq = _left_padded(rng, cfg.n_items, 1, cfg.seq_len)
        cand = rng.integers(1, cfg.n_items, 300).astype(np.int32)
    else:
        seq = _left_padded(rng, cfg.n_items, 6, cfg.seq_len)
        cand = rng.integers(1, cfg.n_items, (6, 7)).astype(np.int32)
    return {"seq": seq, "cand": cand}


def _run_both(arch, fn, seed):
    jcfg, cfg, jp, pp = _model(arch, seed)
    batch = _batch(np.random.default_rng(seed + 1), cfg, fn)
    if fn in ("encode", "interests"):
        got = getattr(prs, f"{arch}_{fn}")(cfg, pp,
                                           torch.from_numpy(batch["seq"]))
        want = getattr(jrs, f"{arch}_{fn}")(jcfg, jp, jnp.asarray(batch["seq"]))
    else:
        spec = get_arch(arch)
        shape = spec.shape("retrieval_cand" if fn == "retrieval"
                           else "serve_p99")
        got = serve_fn(replace(spec, config=cfg), shape)(
            pp, {k: torch.from_numpy(v) for k, v in batch.items()})
        want = getattr(jrs, f"{arch}_{fn}")(
            jcfg, jp, {k: jnp.asarray(v) for k, v in batch.items()})
    return batch, got, want


@pytest.mark.parametrize("fn", ["encode", "serve", "retrieval"])
def test_sasrec_matches_reference(fn):
    batch, got, want = _run_both("sasrec", fn, 20)
    _close(got, want)
    assert bool(torch.isfinite(got).all())    # -inf would give NaN here
    if fn == "encode":
        # padded positions are zero; the all-padding row is zero throughout
        pad = torch.from_numpy(batch["seq"] == 0)
        assert pad.any() and not bool(got[pad].any())
        assert not bool(got[1].any())


def test_sasrec_states_ignore_padded_items():
    """The padding mask: a padded position's item reaches no state, whatever
    the table's padding row holds."""
    _, cfg, _, pp = _model("sasrec", 21)
    seq = torch.from_numpy(_left_padded(np.random.default_rng(22),
                                        cfg.n_items, 5, cfg.seq_len))
    before = prs.sasrec_encode(cfg, pp, seq)
    pp = dict(pp, item_emb=pp["item_emb"].clone())
    pp["item_emb"][0] = 100.0
    torch.testing.assert_close(prs.sasrec_encode(cfg, pp, seq), before)


@pytest.mark.parametrize("fn", ["interests", "serve", "retrieval"])
def test_mind_matches_reference(fn):
    batch, got, want = _run_both("mind", fn, 30)
    assert (batch["seq"] == 0).any()
    _close(got, want)


def test_mind_interests_ignore_padded_items():
    """The validity mask: a padded position's item never reaches the
    interests, whatever id the padding row of the table holds."""
    _, cfg, _, pp = _model("mind", 31)
    seq = torch.from_numpy(_left_padded(np.random.default_rng(32),
                                        cfg.n_items, 5, cfg.seq_len))
    before = prs.mind_interests(cfg, pp, seq)
    pp = dict(pp, item_emb=pp["item_emb"].clone())
    pp["item_emb"][0] = 100.0
    torch.testing.assert_close(prs.mind_interests(cfg, pp, seq), before)


@pytest.mark.parametrize("fn", ["model", "oracle"])
def test_embedding_bag_ragged_matches_reference(fn):
    """``embedding_bag_ragged`` and its oracle against the JAX package's
    ``segment_sum`` on 6 bags, bag 2 and the last bag empty."""
    rng = np.random.default_rng(40)
    table = rng.normal(size=(50, 6)).astype(np.float32)
    seg = np.sort(rng.choice([0, 1, 3, 4], 23)).astype(np.int32)
    idx = rng.integers(0, 50, 23).astype(np.int32)
    port = prs.embedding_bag_ragged if fn == "model" \
        else embedding_bag_ragged_ref
    got = port(*map(torch.from_numpy, (table, idx, seg)), 6)
    want = jax_ragged_ref(jnp.asarray(table), jnp.asarray(idx),
                          jnp.asarray(seg), 6)
    _close(got, want)
    assert not bool(got[2].any()) and not bool(got[5].any())
