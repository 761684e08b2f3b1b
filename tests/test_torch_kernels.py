"""Each kernel's plain PyTorch version against the JAX package's Pallas
kernel (interpret mode) and its jnp oracle, at the edges the query path
meets: ragged W, Q not a power of two, empty / full / over-max_hits rows,
absent keys, an MPHF with fallback keys, token rows of length 0 and L,
CSC anchors that wrap at m.  The store's data is integer, so there the
tolerance is exact equality.  The model-serving kernels (retrieval_score,
embedding_bag, flash_decode) are float: f32 is held at rtol/atol 2e-5 (the
packages sum in other orders); bf16 as stated at its test.

The ``requires_cuda`` cases hold each CUDA kernel against its plain
version on the card; they skip where there is no GPU.  The JAX package
is imported by the ``jx`` fixture only, so the CUDA cases also run where
JAX is not installed."""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.baselines.csc import CSCSketch, _seed
from repro_torch.core import mphf as port_mphf
from repro_torch.core.batch_builder import LineFingerprinter, build_sealed
from repro_torch.core.hashing import np_seeded_hash32, np_token_fingerprints
from repro_torch.core.immutable_sketch import build_immutable
from repro_torch.kernels.bitmap_extract.ops import (bitmap_extract,
                                                   bitmap_extract_ragged)
from repro_torch.kernels.bitmap_extract.ref import (bitmap_extract_ragged_ref,
                                                   bitmap_extract_ref)
from repro_torch.kernels.bitset_ops.ops import (bitset_reduce,
                                               bitset_reduce_batch,
                                               bitset_reduce_ragged)
from repro_torch.kernels.bitset_ops.ref import (bitset_reduce_batch_ref,
                                               bitset_reduce_ragged_ref)
from repro_torch.kernels.csc_probe.ops import csc_partition_mask, host_seeds
from repro_torch.kernels.csc_probe.ref import csc_probe_ref
from repro_torch.kernels.embedding_bag.ops import embedding_bag_sum
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
from repro_torch.kernels.flash_decode.ops import (blocks_per_sm, flash_decode,
                                                  split_plan, window_start)
from repro_torch.kernels.flash_decode.ref import flash_decode_ref
from repro_torch.kernels.retrieval_score.ops import (retrieval_scores,
                                                     retrieval_topk)
from repro_torch.kernels.retrieval_score.ref import retrieval_score_ref
from repro_torch.kernels.sketch_probe.ops import mphf_probe, mphf_probe_arrs
from repro_torch.kernels.sketch_probe.ref import sketch_probe_ref
from repro_torch.kernels.token_hash.ops import token_fingerprints
from repro_torch.kernels.token_hash.ref import token_hash_ref
from repro_torch.logstore.datasets import generate_dataset


def _i32(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32))


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.uint32)


@pytest.fixture(scope="module")
def jx():
    """The JAX reference: jnp, the MPHF module, and the Pallas kernels'
    wrappers and jnp oracles."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.core import mphf
    from repro.kernels.bitmap_extract.ops import bitmap_extract
    from repro.kernels.bitmap_extract.ref import bitmap_extract_ref
    from repro.kernels.bitset_ops.ops import (bitset_reduce,
                                              bitset_reduce_batch)
    from repro.kernels.bitset_ops.ref import bitset_reduce_batch_ref
    from repro.kernels.csc_probe.ops import csc_partition_mask
    from repro.kernels.sketch_probe.ops import mphf_probe, mphf_probe_arrs
    from repro.kernels.token_hash.ops import token_fingerprints
    from repro.kernels.token_hash.ref import token_hash_ref
    from repro.baselines.csc import CSCSketch
    from repro.kernels.embedding_bag.ops import embedding_bag_sum
    from repro.kernels.embedding_bag.ref import embedding_bag_ref
    from repro.kernels.flash_decode.ops import flash_decode
    from repro.kernels.flash_decode.ref import flash_decode_ref
    from repro.kernels.retrieval_score.ops import (retrieval_scores,
                                                   retrieval_topk)
    from repro.kernels.retrieval_score.ref import retrieval_score_ref
    from repro.models.attention import decode_attention
    return SimpleNamespace(
        jnp=jnp, mphf=mphf, probe=mphf_probe_arrs, mphf_probe=mphf_probe,
        reduce=bitset_reduce,
        reduce_batch=bitset_reduce_batch,
        reduce_batch_ref=bitset_reduce_batch_ref, extract=bitmap_extract,
        extract_ref=bitmap_extract_ref, token_hash=token_fingerprints,
        token_hash_ref=token_hash_ref, csc_mask=csc_partition_mask,
        CSCSketch=CSCSketch, ebag=embedding_bag_sum,
        ebag_ref=embedding_bag_ref, flash_decode=flash_decode,
        flash_decode_ref=flash_decode_ref, scores=retrieval_scores,
        topk=retrieval_topk, scores_ref=retrieval_score_ref,
        decode_attention=decode_attention)


# ----------------------------------------------------------------- inputs
def _mphf_case(seed, n_keys, max_levels):
    rng = np.random.default_rng(seed)
    keys = np.unique(rng.integers(0, 2**32, n_keys, dtype=np.uint64)
                     .astype(np.uint32))
    absent = rng.integers(0, 2**32, 500, dtype=np.uint64).astype(np.uint32)
    fps = np.concatenate([keys, absent, [0, 0xFFFFFFFF]]).astype(np.uint32)
    return keys, fps[rng.permutation(fps.size)][:1021]   # Q not a pow2


def _planes(seed, q, t, w):
    """Random planes with an all-zero row, an all-ones row and a sparse
    row among them."""
    rng = np.random.default_rng(seed)
    p = rng.integers(0, 2**32, (q, t, w), dtype=np.uint64).astype(np.uint32)
    p |= rng.integers(0, 2**32, (q, t, w), dtype=np.uint64).astype(np.uint32)
    p[0] = 0
    if q > 1:
        p[1] = 0xFFFFFFFF
    if q > 2:
        p[2] &= np.uint32(0x00010001)
    return p


def _bitmaps(seed, q, w):
    rng = np.random.default_rng(seed)
    density = rng.choice([0.0, 0.01, 0.1, 0.5], size=(q, 1))
    bits = rng.random((q, w * 32)) < density
    bits[-1] = True                                  # a full row
    return np.packbits(bits.reshape(q, w, 4, 8)[..., ::-1], axis=-1) \
        .reshape(q, w, 4)[..., ::-1].copy().view(np.uint32).reshape(q, w)


def _tokens(seed, n, l):
    """A zero-padded (N, L) token matrix whose lengths cover 0..L, with a
    length-0 row and a full-length row at the front."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 256, (n, l)).astype(np.uint8)
    lens = rng.integers(0, l + 1, n).astype(np.int32)
    lens[:2] = (0, l)[:n]
    toks[np.arange(l)[None, :] >= lens[:, None]] = 0
    return toks, lens


def _csc_case(m_bits, k, p, j, seed):
    """The same CSC sketch built by both packages (inserts from one input)
    plus query fingerprints: inserted ones, random ones, 0 and 2^32 - 1."""
    rng = np.random.default_rng(seed)
    fps = rng.integers(0, 2**32, 1500, dtype=np.uint64).astype(np.uint32)
    sets = rng.integers(0, 50, 1500)
    sk = CSCSketch.build(m_bits=m_bits, k=k, p=p, j=j, n_sets=50)
    sk.insert_batch(fps, sets)
    q = np.concatenate([fps[:100], rng.integers(0, 2**32, 64, dtype=np.uint64)
                        .astype(np.uint32), [0, 0xFFFFFFFF]])
    return sk, fps, sets, q.astype(np.uint32)


# ------------------------------------------------------------ token_hash
TOKEN_SHAPES = [(8, 4), (100, 24), (1025, 32), (4096, 16)]


@pytest.mark.parametrize("n,l", TOKEN_SHAPES)
def test_token_hash_plain_matches_pallas_and_numpy(jx, n, l):
    jnp = jx.jnp
    toks, lens = _tokens(n + l, n, l)
    got = token_fingerprints(torch.from_numpy(toks), torch.from_numpy(lens))
    assert got.dtype == torch.int32 and got.shape == (n,)
    got = _u32(got)
    np.testing.assert_array_equal(got, np_token_fingerprints(toks, lens))
    np.testing.assert_array_equal(got, np.asarray(jx.token_hash_ref(
        jnp.asarray(toks), jnp.asarray(lens))))
    np.testing.assert_array_equal(got, np.asarray(jx.token_hash(
        jnp.asarray(toks), jnp.asarray(lens))))


def test_token_hash_plain_length_past_width_matches_numpy():
    """A length past L hashes the L bytes and mixes in the full length."""
    toks, lens = _tokens(5, 40, 12)
    lens[::3] += 7
    got = token_hash_ref(torch.from_numpy(toks), torch.from_numpy(lens))
    np.testing.assert_array_equal(_u32(got), np_token_fingerprints(toks, lens))


# ------------------------------------------------------------- csc_probe
CSC_CASES = [(1 << 12, 2, 16, 1), (1 << 16, 4, 64, 2),
             (64, 3, 64, 2),           # m = 64: every anchor wraps
             (1 << 16, 4, 64, 3)]      # j x k past the kernel's by-value seeds


@pytest.mark.parametrize("m_bits,k,p,j", CSC_CASES)
def test_csc_probe_plain_matches_pallas_and_numpy(jx, m_bits, k, p, j):
    jnp = jx.jnp
    sk, fps, sets, q = _csc_case(m_bits, k, p, j, m_bits + p)
    ref = jx.CSCSketch.build(m_bits=m_bits, k=k, p=p, j=j, n_sets=50)
    ref.insert_batch(fps, sets)
    np.testing.assert_array_equal(sk.bits, ref.bits)
    got = csc_partition_mask(sk, _i32(q))
    assert got.dtype == torch.bool and got.shape == (q.size, p)
    np.testing.assert_array_equal(got.numpy(), sk.partition_mask(q))
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jx.csc_mask(ref, jnp.asarray(q))))
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        ref.partition_mask_jnp(jnp.asarray(q))))
    as_int64 = sk.partition_mask_torch(torch.from_numpy(q.astype(np.int64)))
    assert torch.equal(as_int64, got)


def test_csc_probe_host_seeds_match_the_uploaded_seeds():
    """The seeds the kernel takes by value are the ones the sketch uploads,
    in the same order."""
    for j, k in ((1, 4), (2, 4), (3, 4), (1, 40)):
        sk = CSCSketch.build(m_bits=1 << 10, k=k, p=16, j=j)
        want = _u32(sk.device_arrays("cpu")["seeds"])
        assert list(host_seeds(j, k)) == want.tolist()
        assert want.tolist() == [_seed(r, h) for r in range(j)
                                 for h in range(k)]


def test_csc_probe_plain_wraps_at_m():
    """Anchors within p bits of m - 1 read the plane's first words."""
    sk = CSCSketch.build(m_bits=1 << 10, k=1, p=64, j=1)
    sk.bits[0, -1] = 0xFFFFFFFF                 # bits m-32 .. m-1
    sk.bits[0, 0] = 0x0000FFFF                  # bits 0 .. 15
    q = np.arange(200_000, dtype=np.uint32)
    anchor = np_seeded_hash32(q, _seed(0, 0)) & np.uint32(sk.m - 1)
    hit = q[anchor == sk.m - 32]
    assert hit.size, "no fingerprint anchors at m - 32"
    got = csc_partition_mask(sk, _i32(hit)).numpy()
    np.testing.assert_array_equal(got, sk.partition_mask(hit))
    assert got[:, :48].all() and not got[:, 48:].any()


# ---------------------------------------------------------- sketch_probe
MPHF_CASES = [(0, 3000, 12), (1, 5000, 1), (2, 40, 12)]


@pytest.mark.parametrize("seed,n_keys,max_levels", MPHF_CASES)
def test_mphf_build_matches_reference(jx, seed, n_keys, max_levels):
    keys, _ = _mphf_case(seed, n_keys, max_levels)
    a = jx.mphf.build_mphf(keys, max_levels=max_levels)
    b = port_mphf.build_mphf(keys, max_levels=max_levels)
    for f in ("words", "level_word_offset", "level_bits", "block_rank",
              "fallback_fps", "fallback_idx"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)
    if max_levels == 1:
        assert b.fallback_fps.size > 0, "case must have fallback keys"


@pytest.mark.parametrize("seed,n_keys,max_levels", MPHF_CASES)
def test_sketch_probe_plain_matches_pallas_and_jnp(jx, seed, n_keys,
                                                   max_levels):
    keys, fps = _mphf_case(seed, n_keys, max_levels)
    jnp = jx.jnp
    m_ref = jx.mphf.build_mphf(keys, max_levels=max_levels)
    m = port_mphf.build_mphf(keys, max_levels=max_levels)
    idx, absent = mphf_probe_arrs(_i32(fps), m.device_arrays("cpu"))
    j_idx, j_abs = jx.probe(
        jnp.asarray(fps), m_ref.device_arrays(),
        level_bits=tuple(int(x) for x in m_ref.level_bits),
        level_word_offset=tuple(int(x) for x in m_ref.level_word_offset))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(absent.numpy(), np.asarray(j_abs))
    o_idx, o_abs = m_ref.lookup_jnp(jnp.asarray(fps))
    np.testing.assert_array_equal(absent.numpy(), np.asarray(o_abs))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(o_idx))
    assert idx.dtype == torch.int32 and absent.dtype == torch.bool
    # every construction key resolves, absent ones mostly do not
    inset = np.isin(fps, keys)
    assert not absent.numpy()[inset].any()
    assert absent.numpy()[~inset].any()


# ------------------------------------------------------------ bitset_ops
BITSET_SHAPES = [(8, 1, 62), (5, 8, 62), (3, 3, 1), (1, 8, 33), (12, 2, 64)]


@pytest.mark.parametrize("seed,n_keys,max_levels", MPHF_CASES)
def test_mphf_probe_matches_reference(jx, seed, n_keys, max_levels):
    """``kernels.mphf_probe`` (the MPHF's own arrays, or ``arrs`` a caller
    holds) gives the reference's ``kernels.mphf_probe``, bit for bit."""
    keys, fps = _mphf_case(seed, n_keys, max_levels)
    m = port_mphf.build_mphf(keys, max_levels=max_levels)
    m_ref = jx.mphf.build_mphf(keys, max_levels=max_levels)
    j_idx, j_abs = jx.mphf_probe(m_ref, jx.jnp.asarray(fps))
    for arrs in (None, m.device_arrays("cpu")):
        idx, absent = mphf_probe(m, _i32(fps), arrs=arrs)
        assert idx.dtype == torch.int32 and absent.dtype == torch.bool
        np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
        np.testing.assert_array_equal(absent.numpy(), np.asarray(j_abs))


@pytest.mark.parametrize("q,t,w", BITSET_SHAPES)
@pytest.mark.parametrize("op", ["and", "or"])
def test_bitset_reduce_batch_plain_matches_pallas_and_jnp(jx, q, t, w, op):
    jnp = jx.jnp
    p = _planes(q * 100 + t + w, q, t, w)
    combined, counts = bitset_reduce_batch(_i32(p), op=op)
    j_c, j_n = jx.reduce_batch(jnp.asarray(p), op=op)
    np.testing.assert_array_equal(_u32(combined), np.asarray(j_c))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(j_n))
    o_c, o_n = jx.reduce_batch_ref(jnp.asarray(p), op=op)
    np.testing.assert_array_equal(_u32(combined), np.asarray(o_c))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(o_n))
    assert counts.dtype == torch.int32


@pytest.mark.parametrize("t,w", [(1, 62), (8, 62), (4, 7)])
@pytest.mark.parametrize("op", ["and", "or"])
def test_bitset_reduce_single_matches_pallas(jx, t, w, op):
    jnp = jx.jnp
    p = _planes(t + w, 1, t, w)[0]
    combined, count = bitset_reduce(_i32(p), op=op)
    j_c, j_n = jx.reduce(jnp.asarray(p), op=op)
    np.testing.assert_array_equal(_u32(combined), np.asarray(j_c))
    assert int(count) == int(j_n) and count.dim() == 0


# --------------------------------------------------------- bitmap_extract
EXTRACT_CASES = [(16, 62, 2048), (7, 62, 64), (5, 3, 8), (9, 1, 32),
                 (4, 40, 0)]


@pytest.mark.parametrize("q,w,max_hits", EXTRACT_CASES)
def test_bitmap_extract_plain_matches_pallas_and_jnp(jx, q, w, max_hits):
    jnp = jx.jnp
    bm = _bitmaps(q + w + max_hits, q, w)
    ids, counts = bitmap_extract(_i32(bm), max_hits=max_hits)
    assert ids.shape == (q, max_hits) and ids.dtype == torch.int32
    o_ids, o_n = jx.extract_ref(jnp.asarray(bm), max_hits=max_hits)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(o_ids))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(o_n))
    if max_hits:
        j_ids, j_n = jx.extract(jnp.asarray(bm), max_hits=max_hits,
                                 use_kernel=True)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(j_ids))
        np.testing.assert_array_equal(counts.numpy(), np.asarray(j_n))
    if max_hits < 32 * w:
        assert (counts.numpy() > max_hits).any(), "case must overflow a row"


# ------------------------------------------- the query engine's entries
# (Qb, Tb, W, lens of the live rows): the 1M-line store's W 62 at the term
# wave's T 1 and a contains wave's T 8, an odd W, a T past the unrolled 16
# and one that is no power of two; live counts short of Qb, rows of every
# length from 1 to Tb, a row with no plane (the neutral word) and one whose
# count is past Tb (clamped)
RAGGED_FOLD_CASES = [(8, 1, 62, [1] * 5), (16, 8, 62, [1, 8, 3, 5, 2, 7, 8]),
                     (8, 4, 7, [4, 1, 2, 3, 4, 1]), (4, 32, 33, [32, 17, 1]),
                     (8, 3, 64, [3, 0, 2, 9, 1]), (8, 2, 1, [2, 1, 2])]


def _ragged_lens(lens):
    return torch.tensor(lens, dtype=torch.int32)


@pytest.mark.parametrize("qb,t,w,lens", RAGGED_FOLD_CASES)
@pytest.mark.parametrize("op", ["and", "or"])
def test_bitset_reduce_ragged_plain_matches_reference_where_and_fold(
        jx, qb, t, w, lens, op):
    """The engine's fold of each live row over its own tokens equals the
    JAX engine's ``_reduce_fn`` body (``jnp.where`` of the pad slots to the
    neutral word, then the fold, here by the Pallas kernel and its jnp
    oracle) on the live rows."""
    jnp = jx.jnp
    p = _planes(qb * 10 + t + w, qb, t, w)
    combined, counts = bitset_reduce_ragged(_i32(p), _ragged_lens(lens),
                                            op=op)
    n = len(lens)
    assert combined.shape == (n, w) and counts.shape == (n,)
    assert counts.dtype == torch.int32
    mask = np.arange(t)[None, :] < np.asarray(lens)[:, None]
    neutral = jnp.uint32(0xFFFFFFFF if op == "and" else 0)
    planes = jnp.where(jnp.asarray(mask)[:, :, None], jnp.asarray(p[:n]),
                       neutral)
    for fold in (jx.reduce_batch, jx.reduce_batch_ref):
        j_c, j_n = fold(planes, op=op)
        np.testing.assert_array_equal(_u32(combined), np.asarray(j_c))
        np.testing.assert_array_equal(counts.numpy(), np.asarray(j_n))


# (Q, W, rows forced empty, rows forced full): W 62 and odd widths; empty
# and full rows; a wave whose rows are all empty (total 0)
RAGGED_EXTRACT_CASES = [(16, 62, (0, 5), (1,)), (7, 61, (3,), ()),
                        (5, 3, (), (0, 4)), (9, 1, (0, 1, 2), (8,)),
                        (4, 40, (0, 1, 2, 3), ())]


def _ragged_bitmaps(q, w, empty, full):
    bm = _bitmaps(q * 7 + w, q, w)
    bm[list(empty)] = 0
    bm[list(full)] = 0xFFFFFFFF
    counts = np.unpackbits(bm.view(np.uint8), axis=1).sum(axis=1)
    ends = np.cumsum(counts)
    return bm, counts, (ends - counts).astype(np.int32), int(ends[-1])


@pytest.mark.parametrize("q,w,empty,full", RAGGED_EXTRACT_CASES)
def test_bitmap_extract_ragged_plain_matches_reference_rows_cut(
        jx, q, w, empty, full):
    """One compacted id array equals the JAX ``bitmap_extract_ref`` rows
    (max_hits = every bit) cut at their counts and concatenated."""
    bm, counts, offsets, total = _ragged_bitmaps(q, w, empty, full)
    ids = bitmap_extract_ragged(_i32(bm), torch.from_numpy(offsets), total)
    assert ids.shape == (total,) and ids.dtype == torch.int32
    j_ids, j_n = jx.extract_ref(jx.jnp.asarray(bm), max_hits=32 * w)
    j_ids, j_n = np.asarray(j_ids), np.asarray(j_n)
    np.testing.assert_array_equal(j_n, counts)
    want = np.concatenate([j_ids[i, :j_n[i]] for i in range(q)])
    np.testing.assert_array_equal(ids.numpy(), want)
    assert (total == 0) == (len(empty) == q)


def test_engine_entries_reject_bad_inputs():
    p = torch.zeros((4, 2, 3), dtype=torch.int32)
    for lens in (torch.zeros(5, dtype=torch.int32),        # more than Qb
                 torch.zeros(2, dtype=torch.int64),
                 torch.zeros((2, 1), dtype=torch.int32)):
        with pytest.raises(ValueError):
            bitset_reduce_ragged(p, lens)
    with pytest.raises(ValueError):
        bitset_reduce_ragged(p, torch.zeros(2, dtype=torch.int32), op="xor")
    bm = _i32(np.full((3, 2), 1, np.uint32))     # one bit a word: 2 a row
    for offsets, total in ((torch.tensor([0, 2], dtype=torch.int32), 6),
                           (torch.tensor([0, 2, 4], dtype=torch.int64), 6),
                           (torch.tensor([0, 2, 4], dtype=torch.int32), -1)):
        with pytest.raises(ValueError):
            bitmap_extract_ragged(bm, offsets, total)
    # offsets and total that are not the rows' prefix sums
    for offsets, total in (([0, 2, 4], 5), ([0, 1, 4], 6)):
        with pytest.raises(ValueError):
            bitmap_extract_ragged(bm, torch.tensor(offsets, dtype=torch.int32),
                                  total)
    assert bitmap_extract_ragged(bm, torch.tensor([0, 2, 4],
                                                  dtype=torch.int32),
                                 6).tolist() == [0, 32, 0, 32, 0, 32]


# ------------------------------------------------ model-serving kernels
F32_TOL = dict(rtol=2e-5, atol=2e-5)
# the tests/test_kernels.py cases, plus C = 1
RETRIEVAL_CASES = [(256, 32), (5000, 64), (10000, 256), (1, 256)]
# (C, D, corpus offset, query offset) at the CUDA kernel's edges: D at each
# boundary of the query's register steps (a lane holds D / 128 float4, up
# to D 512; past it the query is in shared memory) and at MAX_D; D not a
# multiple of 4 on both sides of the scalar loads' register limit (128),
# D = 1; C = 1, C off the 2-row warp turn and the 8-row block; corpus or
# query views 4 bytes off 16-byte alignment (scalar loads)
RETRIEVAL_EDGES = [(300, 4, 0, 0), (300, 128, 0, 0), (300, 132, 0, 0),
                   (300, 384, 0, 0), (300, 512, 0, 0), (300, 516, 0, 0),
                   (37, 12_288, 0, 0), (1, 12_288, 0, 0), (1, 4, 0, 0),
                   (7, 256, 0, 0), (33, 256, 0, 0), (1000, 129, 0, 0),
                   (33, 1, 0, 0), (4097, 256, 1, 1), (1000, 256, 0, 1)]


def _retrieval_inputs(c, d, x_off, q_off, device="cpu"):
    """Seeded (C, D) corpus and (D,) query, each a contiguous view that
    starts ``x_off`` / ``q_off`` floats into its buffer.  Past D 4096 the
    values are integers in [-4, 4]: every partial sum is then an integer
    below 2^24, so each summation order gives the same f32 result (normal
    values at D 12,288 differ by up to ~1e-4 between two orders, beyond
    the f32 tolerances, which are set for dots of a few hundred)."""
    def draw(seed, n):
        if d <= 4096:
            return _normal(seed, n)
        return np.random.default_rng(seed).integers(-4, 5, n) \
            .astype(np.float32)

    x = torch.zeros(c * d + x_off, device=device)
    x[x_off:] = torch.from_numpy(draw(c + d, c * d))
    q = torch.zeros(d + q_off, device=device)
    q[q_off:] = torch.from_numpy(draw(c + d + 1, d))
    return x[x_off:].view(c, d), q[q_off:]


def _retrieval_params(plain, edges=RETRIEVAL_EDGES):
    """(C, D) cases under their ids "C-D" with aligned views, then the
    edges under "C-D-corpus offset-query offset"."""
    return ([pytest.param(c, d, 0, 0, id=f"{c}-{d}") for c, d in plain]
            + list(edges))
# the tests/test_kernels.py cases, plus xDeepFM's wide term: D = 1, BAG = 39
EBAG_CASES = [(100, 8, 8, 2), (1000, 32, 64, 8), (500, 128, 16, 4),
              (39 * 128, 1, 512, 39)]
# the CUDA kernel's layouts: BAG 1, 32, 33 and 70 (one lane group's pass
# and past it), D 1, 17 and 33 (entry lanes, column lanes, a second column
# step), B 1
EBAG_EDGES = [(1000, 1, 33, 1), (1000, 17, 5, 32), (1000, 33, 3, 33),
              (1000, 1, 1, 70), (1000, 17, 1, 70), (2000, 33, 2, 70)]
# the tests/test_kernels.py cases (b, s, hq, hkv, d, cache_len)
# blocks of the bf16 flash_decode kernel that an H100 SM holds at D = 128
# (its 104,448-byte shared-memory ring), as the CUDA runtime counts them
H100_BF16_D128_PER_SM = 2
DECODE_CASES = [(2, 128, 4, 2, 16, 100), (1, 700, 8, 8, 32, 650),
                (4, 64, 16, 2, 8, 64), (2, 256, 6, 3, 64, 17)]


def _normal(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _decode_inputs(seed, b, s, hq, hkv, d):
    return (_normal(seed, b, hq, d), _normal(seed + 1, b, s, hkv, d),
            _normal(seed + 2, b, s, hkv, d))


# (b, s, hq, hkv, d, cache_len, window, softcap): gemma2's local and global
# layers at CPU size (window and cap, cap alone), a window that starts off
# the 64-position tile, a window wider than cache_len, window 1, a window
# alone
WINDOW_CASES = [(2, 300, 8, 4, 32, 257, 100, 50.0),
                (2, 300, 8, 4, 32, 257, None, 50.0),
                (1, 200, 4, 1, 64, 131, 70, 30.0),
                (2, 130, 4, 2, 16, 77, 200, 50.0),
                (1, 64, 4, 1, 16, 40, 1, 30.0),
                (2, 300, 6, 3, 32, 290, 64, None)]


def _capped_inputs(seed, b, s, hq, hkv, d, cap):
    """``_decode_inputs`` with q scaled by 0.8 cap: the scores' std is then
    0.8 cap, so that the largest reach 2-4x the cap and capping moves the
    output (at unit scale a cap of 50 moves nothing)."""
    q, k, v = _decode_inputs(seed, b, s, hq, hkv, d)
    return q * (0.8 * cap if cap else 1.0), k, v


@pytest.mark.parametrize("c,d,x_off,q_off", _retrieval_params(RETRIEVAL_CASES))
def test_retrieval_score_plain_matches_pallas_and_jnp(jx, c, d, x_off, q_off):
    jnp = jx.jnp
    x, q_t = _retrieval_inputs(c, d, x_off, q_off)
    corpus, q = x.numpy(), q_t.numpy()
    got = retrieval_scores(x, q_t)
    assert got.dtype == torch.float32 and got.shape == (c,)
    np.testing.assert_allclose(got.numpy(), np.asarray(jx.scores(
        jnp.asarray(corpus), jnp.asarray(q))), **F32_TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(jx.scores_ref(
        jnp.asarray(corpus), jnp.asarray(q)[None])), **F32_TOL)
    k = min(c, 10)
    vals, ids = retrieval_topk(torch.from_numpy(corpus), torch.from_numpy(q),
                               k)
    j_vals, j_ids = jx.topk(jnp.asarray(corpus), jnp.asarray(q), k)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(j_ids))
    np.testing.assert_allclose(vals.numpy(), np.asarray(j_vals), **F32_TOL)


@pytest.mark.parametrize("v,d,b,bag", EBAG_CASES + EBAG_EDGES)
def test_embedding_bag_plain_matches_pallas_and_jnp(jx, v, d, b, bag):
    jnp = jx.jnp
    table = _normal(v + d, v, d)
    idx = np.random.default_rng(b).integers(0, v, (b, bag)).astype(np.int32)
    idx[0, :] = idx[0, 0]                 # a bag that repeats one row
    got = embedding_bag_sum(torch.from_numpy(table), torch.from_numpy(idx))
    assert got.dtype == torch.float32 and got.shape == (b, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(jx.ebag(
        jnp.asarray(table), jnp.asarray(idx))), **F32_TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(jx.ebag_ref(
        jnp.asarray(table), jnp.asarray(idx))), **F32_TOL)


@pytest.mark.parametrize("b,s,hq,hkv,d,clen", DECODE_CASES)
def test_flash_decode_plain_matches_pallas_and_jnp(jx, b, s, hq, hkv, d,
                                                   clen):
    jnp = jx.jnp
    q, k, v = _decode_inputs(b + s + d, b, s, hq, hkv, d)
    got = flash_decode(*map(torch.from_numpy, (q, k, v)), clen)
    assert got.dtype == torch.float32 and got.shape == (b, hq, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(jx.flash_decode(
        *map(jnp.asarray, (q, k, v)), jnp.int32(clen), block_s=64)), **F32_TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(jx.flash_decode_ref(
        *map(jnp.asarray, (q, k, v)), jnp.int32(clen))), **F32_TOL)


def test_flash_decode_plain_bf16_matches_pallas_and_jnp(jx):
    """bf16 caches, as on the llama3 path.  Both packages accumulate in f32
    and round the output to bf16 (8 significant bits): an element may
    differ by one bf16 step of its value, rtol 2^-7.  Each side also rounds
    its probabilities to bf16 before the product with V (the Pallas kernel
    the unnormalised ones, the plain version the normalised ones).  That
    moves an output by ~2^-9 of the output's own scale per side, not of
    v's (an average over many positions is far smaller than v):
    atol 2^-8 * max|want|."""
    import ml_dtypes
    jnp = jx.jnp
    b, s, hq, hkv, d, clen = 2, 300, 8, 2, 64, 257
    q, k, v = (a.astype(ml_dtypes.bfloat16)
               for a in _decode_inputs(7, b, s, hq, hkv, d))
    got = flash_decode(*(torch.from_numpy(a.astype(np.float32))
                         .to(torch.bfloat16) for a in (q, k, v)), clen)
    assert got.dtype == torch.bfloat16
    got = got.to(torch.float32).numpy()
    for want in (jx.flash_decode(*map(jnp.asarray, (q, k, v)),
                                 jnp.int32(clen), block_s=64),
                 jx.flash_decode_ref(*map(jnp.asarray, (q, k, v)),
                                     jnp.int32(clen))):
        want = np.asarray(want).astype(np.float32)
        np.testing.assert_allclose(got, want, rtol=2 ** -7,
                                   atol=2 ** -8 * np.abs(want).max())


@pytest.mark.parametrize("b,s,hq,hkv,d,clen,window,cap", WINDOW_CASES)
def test_flash_decode_plain_window_softcap_matches_jax(jx, b, s, hq, hkv, d,
                                                       clen, window, cap):
    """The plain version with a window and a soft-cap, and the wrapper on
    CPU tensors, against the JAX package's ``decode_attention`` (the jnp
    decode that its gemma2 layers run), in f32."""
    jnp = jx.jnp
    q, k, v = _capped_inputs(b + s + clen, b, s, hq, hkv, d, cap)
    want = np.asarray(jx.decode_attention(
        jnp.asarray(q)[:, None], jnp.asarray(k), jnp.asarray(v),
        jnp.int32(clen), window=window, attn_softcap=cap))[:, 0]
    args = (*map(torch.from_numpy, (q, k, v)), clen)
    for got in (flash_decode_ref(*args, window=window, softcap=cap),
                flash_decode(*args, window=window, softcap=cap)):
        assert got.dtype == torch.float32 and got.shape == (b, hq, d)
        np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


def test_flash_decode_window_start():
    """A window reads [cache_len - window, cache_len), all of the cache
    when it is as wide or wider; split_plan then cuts only those
    positions."""
    assert window_start(4639, None) == 0
    assert window_start(4639, 4096) == 543
    assert window_start(77, 200) == 0 and window_start(77, 77) == 0
    assert window_start(40, 1) == 39
    chunk, n = split_plan(4, 8, 4639 - 543, 132, 1)
    assert chunk % 64 == 0 and (n - 1) * chunk < 4096 <= n * chunk


# the edges of the CUDA kernel's ring and fragments, at CPU size: cache_len
# 1, within one warp's 16 positions, across warps, one 64-position tile,
# past it, one below the 3-tile ring; n_rep 1, 3, 8 and 16; D 128, 64,
# 256 and 40 (mma steps padded past D)
BF16_EDGE_CASES = [(2, 200, 8, 2, 128, clen) for clen in (1, 15, 17, 63, 65, 191)] + [
    (1, 130, 8, 8, 128, 129), (1, 130, 24, 8, 128, 100),
    (1, 130, 64, 8, 128, 127), (1, 130, 64, 4, 64, 111),
    (1, 130, 8, 2, 256, 97), (1, 130, 12, 4, 40, 129)]


@pytest.mark.parametrize("b,s,hq,hkv,d,clen", BF16_EDGE_CASES)
def test_flash_decode_plain_bf16_edges_match_pallas(jx, b, s, hq, hkv, d,
                                                    clen):
    """The plain version, which the CUDA cases hold the kernel to at these
    shapes, against the Pallas kernel and the jnp oracle in bf16, at the
    tolerance of the bf16 test above."""
    import ml_dtypes
    jnp = jx.jnp
    q, k, v = (a.astype(ml_dtypes.bfloat16)
               for a in _decode_inputs(b + s + d + clen, b, s, hq, hkv, d))
    got = flash_decode(*(torch.from_numpy(a.astype(np.float32))
                         .to(torch.bfloat16) for a in (q, k, v)), clen)
    got = got.to(torch.float32).numpy()
    for want in (jx.flash_decode(*map(jnp.asarray, (q, k, v)),
                                 jnp.int32(clen), block_s=64),
                 jx.flash_decode_ref(*map(jnp.asarray, (q, k, v)),
                                     jnp.int32(clen))):
        want = np.asarray(want).astype(np.float32)
        np.testing.assert_allclose(got, want, rtol=2 ** -7,
                                   atol=2 ** -8 * np.abs(want).max())


@pytest.mark.parametrize("b,s,clen", [(8, 1056, 1055), (1, 32768, 32768)])
def test_flash_decode_bf16_tolerance_rejects_planted_faults(b, s, clen):
    """The bf16 tolerance above (and in ``chip_smoke.py``) scales with the
    output, not with v, so it separates: at the LM path's own call and at
    a 32k cache (where the output is ~1/100 of v), the attention with the
    last of the B = 8 plan's splits dropped, or the newest position
    dropped, falls outside it.  So does, under a window off the tile and a
    soft-cap of 50 with q scaled past the cap (a gemma2 local layer), the
    same call with the window ignored or with the soft-cap ignored."""
    hq, hkv, d = 32, 8, 128
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _decode_inputs(11, b, s, hq, hkv, d))
    want = flash_decode(q, k, v, clen).to(torch.float32)
    tol = dict(rtol=2 ** -7, atol=2 ** -8 * float(want.abs().max()))
    chunk, n_splits = split_plan(8, hkv, clen, 132, H100_BF16_D128_PER_SM)
    assert n_splits > 1
    for n in ((n_splits - 1) * chunk, clen - 1):
        with pytest.raises(AssertionError):
            torch.testing.assert_close(
                flash_decode(q, k, v, n).to(torch.float32), want, **tol)
    window, cap = clen // 2 + 37, 50.0
    q = (q.to(torch.float32) * 0.8 * cap).to(torch.bfloat16)
    want = flash_decode(q, k, v, clen, window=window,
                        softcap=cap).to(torch.float32)
    tol = dict(rtol=2 ** -7, atol=2 ** -8 * float(want.abs().max()))
    for kw in (dict(softcap=cap), dict(window=window)):
        with pytest.raises(AssertionError):
            torch.testing.assert_close(
                flash_decode(q, k, v, clen, **kw).to(torch.float32), want,
                **tol)


def test_flash_decode_split_plan_covers_the_cache():
    """Every plan covers [0, cache_len) with non-empty splits of whole
    tiles; at the main path's shape (B 8, Hkv 8, 32,768 positions, D 128
    bf16: 2 blocks per SM, as test_cuda_flash_decode_blocks_per_sm checks)
    and at the LM path's own call the blocks fill their last wave of an
    H100's 132 SMs at least 90%, and long caches at up to 4 blocks per SM
    do too (at 12 a whole tile per split can be too coarse for that)."""
    for per_sm in (1, 2, 3, 4, 12):
        for b, hkv, clen in ((8, 8, 32768), (8, 8, 30001), (1, 1, 1),
                             (8, 8, 1056), (1, 8, 700), (128, 8, 5),
                             (4, 8, 1037), (1, 8, 32768), (128, 8, 32768),
                             (3, 5, 100_000)):
            chunk, n = split_plan(b, hkv, clen, 132, per_sm)
            assert chunk % 64 == 0 and (n - 1) * chunk < clen <= n * chunk
            if clen >= 32768 and per_sm <= 4:
                wave = 132 * per_sm
                last = b * hkv * n % wave
                assert b * hkv * n >= 0.9 * wave
                assert last == 0 or last >= 0.9 * wave
    for clen in (32768, 1055):
        chunk, n = split_plan(8, 8, clen, 132, H100_BF16_D128_PER_SM)
        assert 0.9 * 264 <= 64 * n <= 264


def test_wrappers_reject_bad_inputs():
    with pytest.raises(ValueError):
        bitset_reduce_batch(torch.zeros((2, 3), dtype=torch.int32))
    with pytest.raises(ValueError):
        bitset_reduce_batch(torch.zeros((2, 1, 3), dtype=torch.int64))
    with pytest.raises(ValueError):
        bitset_reduce_batch(torch.zeros((2, 1, 3), dtype=torch.int32),
                            op="xor")
    with pytest.raises(ValueError):
        bitmap_extract(torch.zeros((2, 3), dtype=torch.int32).t(),
                       max_hits=8)
    m = port_mphf.build_mphf(np.arange(100, dtype=np.uint32))
    with pytest.raises(ValueError):
        mphf_probe_arrs(torch.zeros(4, dtype=torch.int64),
                        m.device_arrays("cpu"))
    with pytest.raises(ValueError):
        token_fingerprints(torch.zeros((4, 8), dtype=torch.int32),
                           torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError):
        token_fingerprints(torch.zeros((4, 8), dtype=torch.uint8),
                           torch.zeros(5, dtype=torch.int32))
    sk = CSCSketch.build(m_bits=1 << 10, p=300)
    with pytest.raises(ValueError):
        csc_partition_mask(sk, torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError):
        csc_partition_mask(CSCSketch.build(m_bits=1 << 10),
                           torch.zeros(4, dtype=torch.int64))
    with pytest.raises(ValueError):
        retrieval_scores(torch.zeros((4, 8)), torch.zeros(7))
    with pytest.raises(ValueError):
        retrieval_scores(torch.zeros((4, 8), dtype=torch.float64),
                         torch.zeros(8, dtype=torch.float64))
    with pytest.raises(ValueError):
        embedding_bag_sum(torch.zeros((4, 8)),
                          torch.zeros((2, 3), dtype=torch.int64))
    with pytest.raises(ValueError):        # an index past V
        embedding_bag_sum(torch.zeros((4, 8)),
                          torch.full((2, 3), 4, dtype=torch.int32))
    q, kv = torch.zeros((1, 4, 8)), torch.zeros((1, 10, 2, 8))
    for clen in (0, 11):
        with pytest.raises(ValueError):
            flash_decode(q, kv, kv, clen)
    with pytest.raises(ValueError):        # Hq not a multiple of Hkv
        flash_decode(torch.zeros((1, 3, 8)), kv, kv, 5)
    with pytest.raises(ValueError):
        flash_decode(q.to(torch.float64), kv, kv, 5)
    for kw in (dict(window=0), dict(softcap=0.0), dict(softcap=-50.0)):
        with pytest.raises(ValueError):
            flash_decode(q, kv, kv, 5, **kw)


# ------------------------------------------------------ CUDA, on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.requires_cuda
@pytest.mark.parametrize("seed,n_keys,max_levels", MPHF_CASES)
def test_cuda_sketch_probe_matches_plain(cuda, seed, n_keys, max_levels):
    keys, fps = _mphf_case(seed, n_keys, max_levels)
    arrs = port_mphf.build_mphf(keys, max_levels=max_levels) \
        .device_arrays(cuda)
    before = mphf_probe_arrs.launch_count
    idx, absent = mphf_probe_arrs(_i32(fps).to(cuda), arrs)
    torch.cuda.synchronize()
    assert mphf_probe_arrs.launch_count == before + 1
    r_idx, r_abs = sketch_probe_ref(_i32(fps).to(cuda), arrs)
    assert torch.equal(idx, r_idx) and torch.equal(absent, r_abs)


@pytest.mark.requires_cuda
def test_cuda_mphf_probe_uploads_and_launches(cuda):
    keys, fps = _mphf_case(*MPHF_CASES[0])
    m = port_mphf.build_mphf(keys, max_levels=MPHF_CASES[0][2])
    before = mphf_probe_arrs.launch_count
    idx, absent = mphf_probe(m, _i32(fps).to(cuda))
    torch.cuda.synchronize()
    assert mphf_probe_arrs.launch_count == before + 1
    assert idx.device.type == "cuda"
    r_idx, r_abs = sketch_probe_ref(_i32(fps), m.device_arrays("cpu"))
    assert torch.equal(idx.cpu(), r_idx) and torch.equal(absent.cpu(), r_abs)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("q,t,w", BITSET_SHAPES + [(4096, 8, 62)])
@pytest.mark.parametrize("op", ["and", "or"])
def test_cuda_bitset_reduce_batch_matches_plain(cuda, q, t, w, op):
    p = _i32(_planes(q + t + w, q, t, w)).to(cuda)
    combined, counts = bitset_reduce_batch(p, op=op)
    r_c, r_n = bitset_reduce_batch_ref(p, op=op)
    assert torch.equal(combined, r_c) and torch.equal(counts, r_n)
    single, count = bitset_reduce(p[0].contiguous(), op=op)
    assert torch.equal(single, r_c[0]) and int(count) == int(r_n[0])


@pytest.mark.requires_cuda
@pytest.mark.parametrize("q,w,max_hits", EXTRACT_CASES + [(4096, 62, 2048)])
def test_cuda_bitmap_extract_matches_plain(cuda, q, w, max_hits):
    bm = _i32(_bitmaps(q + w, q, w)).to(cuda)
    ids, counts = bitmap_extract(bm, max_hits=max_hits)
    r_ids, r_n = bitmap_extract_ref(bm, max_hits=max_hits)
    assert torch.equal(ids, r_ids) and torch.equal(counts, r_n)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("qb,t,w,lens", RAGGED_FOLD_CASES + [
    (4096, 1, 62, [1] * 4096), (1024, 8, 62, [3, 8, 5, 4, 6, 7] * 170),
    (2048, 16, 62, list(range(1, 17)) * 93), (512, 64, 61, [64, 1, 40] * 100),
    (4096, 2, 64, [2, 1] * 1500)])
@pytest.mark.parametrize("op", ["and", "or"])
def test_cuda_bitset_reduce_ragged_matches_plain(cuda, qb, t, w, lens, op):
    """The term wave (4096 x 1 x 62), a contains wave (1024 x 8 x 62), the
    unrolled 16 and the loop past it, 4-, 2- and 1-word loads."""
    p = _i32(_planes(qb + t + w, qb, t, w)).to(cuda)
    ln = _ragged_lens(lens).to(cuda)
    before = bitset_reduce_ragged.launch_count
    combined, counts = bitset_reduce_ragged(p, ln, op=op)
    torch.cuda.synchronize()
    assert bitset_reduce_ragged.launch_count == before + 1
    r_c, r_n = bitset_reduce_ragged_ref(p, ln, op=op)
    assert torch.equal(combined, r_c) and torch.equal(counts, r_n)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("q,w,empty,full", RAGGED_EXTRACT_CASES + [
    (4096, 62, tuple(range(0, 4096, 3)), (7,)), (1024, 62, (), (0, 9)),
    (1000, 61, (), ())])
def test_cuda_bitmap_extract_ragged_matches_plain(cuda, q, w, empty, full):
    bm, _, offsets, total = _ragged_bitmaps(q, w, empty, full)
    b, off = _i32(bm).to(cuda), torch.from_numpy(offsets).to(cuda)
    before = bitmap_extract_ragged.launch_count
    ids = bitmap_extract_ragged(b, off, total)
    torch.cuda.synchronize()
    assert bitmap_extract_ragged.launch_count == before + (total > 0)
    assert torch.equal(ids, bitmap_extract_ragged_ref(b, off, total))


@pytest.mark.requires_cuda
def test_cuda_bitmap_extract_ragged_writes_only_inside_total(cuda):
    """Offsets that are not the rows' prefix sums move ids but never past
    ``total``: a guard word after the array stays as it was."""
    bm = _i32(np.full((4, 3), 0xFFFFFFFF, np.uint32)).to(cuda)  # 96 a row
    buf = torch.full((101,), -7, dtype=torch.int32, device=cuda)
    from repro_torch.kernels.bitmap_extract.ops import _kernel
    _, _, fn = _kernel()
    off = torch.tensor([0, 50, 60, 90], dtype=torch.int32, device=cuda)
    assert fn(bm.data_ptr(), 4, 3, off.data_ptr(), 100, buf.data_ptr(),
              torch.cuda.current_stream().cuda_stream) == 0
    torch.cuda.synchronize()
    got = buf.cpu().numpy()
    assert got[100] == -7
    np.testing.assert_array_equal(got[:50], np.arange(50))
    np.testing.assert_array_equal(got[90:100], np.arange(10))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("n,l", TOKEN_SHAPES + [(32768, 64), (257, 64),
                                                (0, 64), (3, 1)])
def test_cuda_token_hash_matches_plain(cuda, n, l):
    toks, lens = _tokens(n + l, n, l)
    if n > 4:
        lens[4] = l + 9                          # a length past the width
    t, ln = torch.from_numpy(toks).to(cuda), torch.from_numpy(lens).to(cuda)
    before = token_fingerprints.launch_count
    got = token_fingerprints(t, ln)
    torch.cuda.synchronize()
    assert token_fingerprints.launch_count == before + (n > 0)
    assert torch.equal(got, token_hash_ref(t, ln))
    np.testing.assert_array_equal(_u32(got), np_token_fingerprints(toks, lens))


# fingerprints past the largest call that the kernel gives lane groups
CSC_WAVE = 1 << 17


@pytest.mark.requires_cuda
@pytest.mark.parametrize("m_bits,k,p,j", CSC_CASES + [(1 << 20, 4, 40, 1),
                                                      (1 << 14, 2, 256, 1),
                                                      (1 << 27, 4, 64, 1),
                                                      (1 << 20, 40, 16, 1),
                                                      (1 << 20, 3, 48, 3)])
def test_cuda_csc_probe_matches_plain(cuda, m_bits, k, p, j):
    """A small call (lane groups) and a wave (a thread per fingerprint)."""
    sk, _, _, q = _csc_case(m_bits, k, p, j, m_bits + p)
    fps = _i32(q).to(cuda)
    before = csc_partition_mask.launch_count
    got = csc_partition_mask(sk, fps)
    torch.cuda.synchronize()
    assert csc_partition_mask.launch_count == before + 1
    assert torch.equal(got, csc_probe_ref(sk, fps))
    np.testing.assert_array_equal(got.cpu().numpy(), sk.partition_mask(q))
    wave = torch.cat([fps, _i32(np.random.default_rng(p).integers(
        0, 2**32, CSC_WAVE, dtype=np.uint64)).to(cuda)])
    assert torch.equal(csc_partition_mask(sk, wave), csc_probe_ref(sk, wave))
    sk.device_arrays("cuda")                   # another name of the card
    assert sk.upload_count == 1


@pytest.mark.requires_cuda
@pytest.mark.parametrize("q", [1, 15])
def test_cuda_csc_probe_one_query_call(cuda, q):
    """A per-query call's size (one fingerprint, or a term and its n-grams)
    on a sketch of the CSC path's size, m = 2^27."""
    sk, _, _, all_fps = _csc_case(1 << 27, 4, 64, 1, q)
    inserted = q - q // 2               # then random ones, 0 and 2^32 - 1
    fps = np.concatenate([all_fps[:inserted], all_fps[all_fps.size - q // 2:]])
    got = csc_partition_mask(sk, _i32(fps).to(cuda))
    torch.cuda.synchronize()
    assert got.shape == (q, 64) and bool(got[:inserted].any(dim=1).all())
    np.testing.assert_array_equal(got.cpu().numpy(), sk.partition_mask(fps))


@pytest.mark.requires_cuda
def test_cuda_device_cache_keys_on_the_card(cuda):
    """``cuda`` and ``cuda:<current>`` name one card: one upload."""
    rng = np.random.default_rng(0)
    fps = rng.integers(0, 2**32, 500, dtype=np.uint64).astype(np.uint32)
    sk = build_immutable(build_sealed(fps, rng.integers(0, 40, 500)))
    arrs = sk.device_cache("cuda")
    name = f"cuda:{torch.cuda.current_device()}"
    assert sk.has_device_cache(name) and sk.device_cache(name) is arrs


@pytest.mark.requires_cuda
def test_cuda_line_fingerprinter_matches_cpu(cuda):
    """Ingest through ``token_hash`` gives the host pipeline's per-line
    fingerprints, non-ASCII lines included."""
    lines = generate_dataset("fp", n_lines=3000, n_sources=20, seed=1).lines
    lines = lines + ["naïve ünïcode line id=abc", "", "a..b", "x" * 90]
    before = token_fingerprints.launch_count
    got = LineFingerprinter(device=cuda).fingerprint_lines(lines)
    want = LineFingerprinter(device="cpu").fingerprint_lines(lines)
    assert token_fingerprints.launch_count >= before + 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("c,d,x_off,q_off", _retrieval_params(
    RETRIEVAL_CASES + [(1 << 20, 256), (1_000_003, 256), (4097, 30)]))
def test_cuda_retrieval_score_matches_plain(cuda, c, d, x_off, q_off):
    corpus, q = _retrieval_inputs(c, d, x_off, q_off, cuda)
    assert (corpus.data_ptr() % 16 != 0) == bool(x_off)
    before = retrieval_scores.launch_count
    got = retrieval_scores(corpus, q)
    torch.cuda.synchronize()
    assert retrieval_scores.launch_count == before + 1
    torch.testing.assert_close(got, retrieval_score_ref(corpus, q),
                               rtol=2e-5, atol=1e-4)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("v,d,b,bag", EBAG_CASES + EBAG_EDGES + [
    (39_000_000, 1, 512, 39), (10_000, 64, 512, 39), (1000, 17, 33, 5)] + [
    (10_000, d, 77, bag) for d in (1, 17, 33) for bag in (1, 32, 33, 70)])
def test_cuda_embedding_bag_matches_plain(cuda, v, d, b, bag):
    table = torch.from_numpy(_normal(v + d, v, d)).to(cuda)
    idx = torch.from_numpy(np.random.default_rng(b).integers(
        0, v, (b, bag)).astype(np.int32)).to(cuda)
    before = embedding_bag_sum.launch_count
    got = embedding_bag_sum(table, idx)
    torch.cuda.synchronize()
    assert embedding_bag_sum.launch_count == before + 1
    torch.testing.assert_close(got, embedding_bag_ref(table, idx), **F32_TOL)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("d", [4, 64, 128])
def test_cuda_embedding_bag_unaligned_table(cuda, d):
    """A table view off 16-byte alignment takes the scalar loads where an
    aligned one of the same D takes float4 loads."""
    v, b, bag = 5000, 77, 39
    buf = torch.from_numpy(_normal(d, v * d + 1)).to(cuda)
    table = buf[1:].view(v, d)
    assert table.data_ptr() % 16 != 0
    idx = torch.from_numpy(np.random.default_rng(d).integers(
        0, v, (b, bag)).astype(np.int32)).to(cuda)
    got = embedding_bag_sum(table, idx)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, embedding_bag_ref(table, idx), **F32_TOL)
    torch.testing.assert_close(got, embedding_bag_sum(table.clone(), idx),
                               **F32_TOL)


@pytest.mark.requires_cuda
def test_cuda_flash_decode_blocks_per_sm(cuda):
    """The split plan's blocks per SM come from the runtime's occupancy of
    the kernel that runs: the bf16 ring sets it at D = 128 and 256."""
    assert blocks_per_sm(4, 128, torch.bfloat16, cuda) == H100_BF16_D128_PER_SM
    assert blocks_per_sm(4, 256, torch.bfloat16, cuda) == 1
    assert blocks_per_sm(2, 256, torch.bfloat16, cuda, capped=True) == 1
    for n_rep, d in ((1, 8), (16, 64), (128, 8), (3, 40)):
        assert blocks_per_sm(n_rep, d, torch.bfloat16, cuda) >= 1
        assert blocks_per_sm(n_rep, d, torch.float32, cuda) >= 1


@pytest.mark.requires_cuda
@pytest.mark.parametrize("b,s,hq,hkv,d,clen", DECODE_CASES + [
    (8, 4096, 32, 8, 128, 4096), (8, 4096, 32, 8, 128, 3001),
    (2, 1000, 4, 4, 128, 1), (1, 333, 4, 1, 256, 300)] + [
    # one split per (row, kv head) at B * Hkv = 256: cache_len 1, within
    # one warp's 16 positions, across warps, one tile, past it, and one
    # below the bf16 ring's 3 tiles
    (32, 200, 32, 8, 128, clen) for clen in (1, 15, 17, 63, 65, 191)] + [
    (2, 520, 8, 8, 128, 517), (2, 520, 24, 8, 128, 519),   # n_rep 1, 3
    (2, 520, 64, 8, 128, 500), (2, 520, 64, 4, 64, 511),   # n_rep 8, 16
    (2, 520, 8, 2, 64, 449), (2, 520, 8, 2, 256, 449),     # D 64, 256
    (8, 2000, 24, 8, 40, 1999)])                           # D 40: padded steps
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_decode_matches_plain(cuda, b, s, hq, hkv, d, clen, dtype):
    """f32 at 2e-5; bf16 as the CPU bf16 test states it: rtol 2^-7 for the
    output's rounding, atol 2^-8 * max|want| for the plain version's
    rounding of its probabilities (the kernel keeps them in f32)."""
    q, k, v = (torch.from_numpy(a).to(cuda, dtype)
               for a in _decode_inputs(b + s + d, b, s, hq, hkv, d))
    before = flash_decode.launch_count
    got = flash_decode(q, k, v, clen)
    torch.cuda.synchronize()
    assert flash_decode.launch_count == before + 1 and got.dtype == dtype
    want = flash_decode_ref(q, k, v, clen).to(torch.float32)
    tol = F32_TOL if dtype == torch.float32 else dict(
        rtol=2 ** -7, atol=2 ** -8 * float(want.abs().max()))
    torch.testing.assert_close(got.to(torch.float32), want, **tol)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("b,s,hq,hkv,d,clen,window,cap", WINDOW_CASES + [
    # gemma2-9b's own decode call (phase 8's last step): a local layer and
    # a global one
    (4, 4640, 16, 8, 256, 4639, 4096, 50.0),
    (4, 4640, 16, 8, 256, 4639, None, 50.0),
    # windows off the tile across the ring: 1 to 3 tiles, split starts off
    # the tile at B * Hkv = 256
    (32, 600, 32, 8, 128, 599, 130, 50.0), (32, 600, 32, 8, 128, 577, 191, None),
    (2, 5000, 8, 8, 128, 4999, 4097, 30.0)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_decode_window_softcap_matches_plain(
        cuda, b, s, hq, hkv, d, clen, window, cap, dtype):
    """The kernel with a window and a soft-cap against its plain version,
    q scaled past the cap; tolerances as in test_cuda_flash_decode_
    matches_plain."""
    q, k, v = (torch.from_numpy(a).to(cuda, dtype) for a in _capped_inputs(
        b + s + clen, b, s, hq, hkv, d, cap))
    before = flash_decode.launch_count
    got = flash_decode(q, k, v, clen, window=window, softcap=cap)
    torch.cuda.synchronize()
    assert flash_decode.launch_count == before + 1 and got.dtype == dtype
    want = flash_decode_ref(q, k, v, clen, window=window,
                            softcap=cap).to(torch.float32)
    tol = F32_TOL if dtype == torch.float32 else dict(
        rtol=2 ** -7, atol=2 ** -8 * float(want.abs().max()))
    torch.testing.assert_close(got.to(torch.float32), want, **tol)
