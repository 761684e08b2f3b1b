"""The port's MeshGraphNet forward pass and neighbor sampler against the JAX
package, with the JAX smoke init carried across by
``repro_torch.models.convert.gnn_params_from_numpy``.  Inputs are made
with numpy from a seed and handed to both packages.

The test graph is padded as a batch is: its last nodes have zero
features and ``node_mask`` 0, its last edges ``edge_mask`` 0 and point at
node 0 (a real node), so that only the masks keep them out of node 0's
sum; node 5 has no edge at all, so under ``max`` its aggregate is -inf
(``segment_max``'s fill) and its state NaN, in both packages.

Tolerance: float32, rtol = atol = 1e-4 (3 message-passing layers, each
with three layer norms; the two packages sum in other orders).  The
sampler is host numpy and must match bit for bit."""
from dataclasses import replace

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.launch.steps import _gnn_cfg_for_shape
from repro_torch.models import gnn as pgnn
from repro_torch.models.convert import gnn_params_from_numpy

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.configs import get_arch as ref_get_arch  # noqa: E402
from repro.models import gnn as jgnn  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
N, E, N_PAD, E_PAD, ISOLATED = 24, 64, 4, 8, 5


def _params(cfg, jcfg, seed):
    """(JAX params, port params): the JAX init with seeded N(0, 0.1^2)
    biases (zero at init) so that every weight takes part."""
    rng = np.random.default_rng(seed)
    tree = jgnn.init_params(jcfg, jax.random.PRNGKey(seed))

    def fill(a):
        a = np.asarray(a)
        return a if a.any() else (0.1 * rng.normal(size=a.shape)).astype(a.dtype)

    tree = jax.tree.map(fill, tree)
    return jax.tree.map(jnp.asarray, tree), gnn_params_from_numpy(cfg, tree,
                                                                  "cpu")


def _graph(cfg, seed):
    """A padded numpy graph (see the module docstring)."""
    rng = np.random.default_rng(seed)
    real = N - N_PAD
    others = np.setdiff1d(np.arange(real), [ISOLATED])
    snd = rng.choice(others, E).astype(np.int32)
    rcv = rng.choice(others, E).astype(np.int32)
    snd[E - E_PAD:] = rng.choice(others, E_PAD)
    rcv[E - E_PAD:] = 0
    nodes = rng.normal(size=(N, cfg.d_node_in)).astype(np.float32)
    nodes[real:] = 0
    edges = rng.normal(size=(E, cfg.d_edge_in)).astype(np.float32)
    edge_mask = (np.arange(E) < E - E_PAD).astype(np.float32)
    node_mask = (np.arange(N) < real).astype(np.float32)
    return dict(nodes=nodes, edges=edges, senders=snd, receivers=rcv,
                edge_mask=edge_mask, node_mask=node_mask)


def _configs(aggregator="sum", scan_layers=True):
    cfg = replace(get_arch("meshgraphnet").smoke_config, aggregator=aggregator,
                  scan_layers=scan_layers)
    jcfg = replace(ref_get_arch("meshgraphnet").smoke_config,
                   aggregator=aggregator, scan_layers=scan_layers)
    assert vars(cfg) == vars(jcfg)
    return cfg, jcfg


@pytest.mark.parametrize("scan_layers", [True, False])
@pytest.mark.parametrize("aggregator", ["sum", "max", "mean"])
def test_gnn_forward_matches_reference(aggregator, scan_layers):
    cfg, jcfg = _configs(aggregator, scan_layers)
    jp, pp = _params(cfg, jcfg, 50)
    g = _graph(cfg, 51)
    got = pgnn.forward(cfg, pp, {k: torch.from_numpy(v) for k, v in g.items()})
    want = jgnn.forward(jcfg, jp, {k: jnp.asarray(v) for k, v in g.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), equal_nan=True,
                               **TOL)
    nan_rows = set(np.flatnonzero(np.isnan(got.numpy()).any(1)))
    if aggregator == "max":       # the nodes no message reaches
        assert nan_rows == {ISOLATED, *range(N - N_PAD, N)}
    else:
        assert not nan_rows
        assert not got[N - N_PAD:].any()          # masked padded nodes


@pytest.mark.parametrize("aggregator", ["sum", "max", "mean"])
def test_aggregate_matches_reference_with_empty_segments(aggregator):
    """Segments 1 and 4 of 5 receive nothing: sum 0, max -inf, mean 0."""
    rng = np.random.default_rng(52)
    msgs = rng.normal(size=(11, 3)).astype(np.float32)
    rcv = rng.choice([0, 2, 3], 11).astype(np.int32)
    cfg, jcfg = _configs(aggregator)
    got = pgnn._aggregate(cfg, torch.from_numpy(msgs),
                          torch.from_numpy(rcv).long(), 5)
    want = jgnn._aggregate(jcfg, jnp.asarray(msgs), jnp.asarray(rcv), 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    fill = -np.inf if aggregator == "max" else 0.0
    assert (got[[1, 4]].numpy() == fill).all()


def test_gnn_edge_mask_keeps_padded_edges_out():
    """Padded edges point at node 0: with their mask the output equals the
    graph without them; with the mask ignored node 0 moves."""
    cfg, jcfg = _configs()
    _, pp = _params(cfg, jcfg, 53)
    g = {k: torch.from_numpy(v) for k, v in _graph(cfg, 54).items()}
    out = pgnn.forward(cfg, pp, g)
    keep = slice(0, E - E_PAD)
    cut = dict(g, **{k: g[k][keep] for k in ("edges", "senders", "receivers",
                                              "edge_mask")})
    torch.testing.assert_close(pgnn.forward(cfg, pp, cut), out, **TOL)
    unmasked = pgnn.forward(cfg, pp, dict(g, edge_mask=torch.ones(E)))
    assert float((unmasked[0] - out[0]).abs().max()) > 0.1


def test_gnn_permutation_invariance():
    """The reference's property (``tests/test_models.py``): permuting the
    edge order never changes the sum aggregator's output."""
    spec = get_arch("meshgraphnet")
    cfg = spec.smoke_config
    params = pgnn.init_params(cfg, torch.Generator().manual_seed(0))
    g = spec.smoke_batch(cfg, np.random.default_rng(1))
    out1 = pgnn.forward(cfg, params, g)
    perm = torch.from_numpy(np.random.default_rng(2).permutation(
        g["senders"].shape[0]))
    g2 = dict(g, **{k: g[k][perm] for k in ("edges", "senders", "receivers",
                                             "edge_mask")})
    torch.testing.assert_close(pgnn.forward(cfg, params, g2), out1,
                               rtol=1e-4, atol=1e-5)


def _csr(rng, n):
    """A CSR graph of ``n`` nodes with degrees 0..7 (some below the
    fanouts, some zero)."""
    deg = rng.integers(0, 8, n)
    indptr = np.concatenate([[0], np.cumsum(deg)])
    return indptr, rng.integers(0, n, int(indptr[-1]))


@pytest.mark.parametrize("seed,seeds,fanouts", [
    (60, [0, 1], [3, 2]), (61, [7, 3, 11, 40], [5, 4, 2]),
    (62, list(range(30)), [6])])
def test_neighbor_sample_equals_reference_exactly(seed, seeds, fanouts):
    indptr, indices = _csr(np.random.default_rng(seed), 50)
    got = pgnn.neighbor_sample(indptr, indices, seeds, fanouts,
                               np.random.default_rng(seed + 100))
    want = jgnn.neighbor_sample(indptr, indices, seeds, fanouts,
                                np.random.default_rng(seed + 100))
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_neighbor_sampler_validity():
    """The reference's property (``tests/test_models.py``): seeds first,
    ids in range, every sampled edge in the CSR graph."""
    rng = np.random.default_rng(0)
    n = 50
    indptr = np.arange(0, 4 * (n + 1), 4)
    indices = rng.integers(0, n, 4 * n)
    nodes, snd, rcv = pgnn.neighbor_sample(indptr, indices, [0, 1], [3, 2],
                                           rng)
    assert set(nodes[:2]) == {0, 1}
    assert snd.max(initial=0) < len(nodes)
    assert rcv.max(initial=0) < len(nodes)
    for s, r in zip(snd, rcv):
        u, v = int(nodes[r]), int(nodes[s])
        assert v in indices[indptr[u]:indptr[u + 1]]


def test_gnn_config_follows_the_shape():
    spec, ref = get_arch("meshgraphnet"), ref_get_arch("meshgraphnet")
    assert {k: vars(v) for k, v in spec.shapes.items()} == \
        {k: vars(v) for k, v in ref.shapes.items()}
    for name, shape in spec.shapes.items():
        cfg = _gnn_cfg_for_shape(spec.config, shape)
        assert cfg.d_node_in == shape.dims["d_feat"]
        assert cfg.param_count() == replace(
            ref.config, d_node_in=shape.dims["d_feat"]).param_count()
