"""The port's sketch build and device probe against the JAX package: for
the same sealed content every array of the immutable sketch is equal, the
torch probe (present, rank) and the posting bitmaps equal the JAX device
probe's (Pallas MPHF kernel in interpret mode), and a sketch built by the
JAX package and carried over through ``core/convert.py`` answers the same
queries.  Integer data throughout: the tolerance is exact equality."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import batch_builder as ref_bb
from repro.core import immutable_sketch as ref_sk
from repro.core import segment as ref_seg
from repro.core.query_engine import QueryEngine as RefEngine
from repro_torch.core import batch_builder as port_bb
from repro_torch.core import immutable_sketch as port_sk
from repro_torch.core import segment as port_seg
from repro_torch.core.convert import sketch_arrays, sketch_from_arrays
from repro_torch.core.query_engine import QueryEngine


def _corpus(seed, n_tokens=1500, n_postings=96, n_pairs=12000):
    rng = np.random.default_rng(seed)
    fps = (rng.integers(0, n_tokens, n_pairs).astype(np.uint64)
           * 2654435761 % (1 << 32)).astype(np.uint32)
    posts = rng.integers(0, n_postings, n_pairs).astype(np.int64)
    return rng, fps, posts


def _probe_fps(rng, fps):
    uniq = np.unique(fps)
    absent = rng.integers(0, 2**32, 700, dtype=np.uint64).astype(np.uint32)
    return np.concatenate([uniq, absent, [0, 0xFFFFFFFF]]).astype(np.uint32)


def _assert_sketch_equal(a, b):
    for f in ("words", "level_word_offset", "level_bits", "block_rank",
              "fallback_fps", "fallback_idx"):
        np.testing.assert_array_equal(getattr(a.mphf, f), getattr(b.mphf, f),
                                      f"mphf.{f}")
    for f in ("bitseq", "lengths", "samples"):
        np.testing.assert_array_equal(getattr(a.csf, f), getattr(b.csf, f),
                                      f"csf.{f}")
    for f in ("signatures", "bic_bits", "bic_offsets", "bic_counts"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)
    assert (a.planes is None) == (b.planes is None)
    if a.planes is not None:
        np.testing.assert_array_equal(a.planes, b.planes)
    assert (a.n_tokens, a.n_postings, a.sig_bits, a.csf.n, a.mphf.n_keys) \
        == (b.n_tokens, b.n_postings, b.sig_bits, b.csf.n, b.mphf.n_keys)


@pytest.mark.parametrize("seed,sig_bits", [(0, 8), (1, 5), (2, 12)])
def test_build_immutable_matches_reference(seed, sig_bits):
    _, fps, posts = _corpus(seed)
    sealed_ref = ref_bb.build_sealed(fps, posts)
    sealed = port_bb.build_sealed(fps, posts)
    np.testing.assert_array_equal(sealed.fps, sealed_ref.fps)
    np.testing.assert_array_equal(sealed.list_ids, sealed_ref.list_ids)
    assert sealed.canonical_lists() == sealed_ref.canonical_lists()
    _assert_sketch_equal(port_sk.build_immutable(sealed, sig_bits=sig_bits),
                         ref_sk.build_immutable(sealed_ref,
                                                sig_bits=sig_bits))


def test_segment_writer_matches_reference():
    """Spills, tiered temporaries and per-segment sketches equal the
    reference writer's for the same columnar input."""
    _, fps, posts = _corpus(4, n_pairs=20000)
    kw = dict(memory_limit_bytes=1 << 14, compact_fanout=8)
    w_ref, w = ref_seg.SegmentWriter(**kw), port_seg.SegmentWriter(**kw)
    for lo in range(0, fps.size, 1000):
        w_ref.add_fingerprint_batch(fps[lo:lo + 1000], posts[lo:lo + 1000])
        w.add_fingerprint_batch(fps[lo:lo + 1000], posts[lo:lo + 1000])
    assert (w.n_spills, w.n_compactions) == (w_ref.n_spills,
                                             w_ref.n_compactions)
    segs, segs_ref = w.finish_segments(), w_ref.finish_segments()
    assert len(segs) == len(segs_ref) >= 3
    for a, b in zip(segs, segs_ref):
        _assert_sketch_equal(a, b)


@pytest.mark.parametrize("seed", [0, 3])
def test_device_probe_and_bitmaps_match_reference(seed):
    rng, fps, posts = _corpus(seed)
    sk = port_sk.build_immutable(port_bb.build_sealed(fps, posts))
    sk_ref = ref_sk.build_immutable(ref_bb.build_sealed(fps, posts))
    q = _probe_fps(rng, fps)
    arrs = sk.device_arrays("cpu")
    present, rank = port_sk.probe_tokens_from(
        torch.from_numpy(q.view(np.int32)), arrs, sig_bits=sk.sig_bits)
    lb, lo = sk_ref._level_layout()
    j_pres, j_rank = ref_sk.probe_tokens_from(
        jnp.asarray(q), sk_ref.device_arrays(), level_bits=lb,
        level_word_offset=lo, sig_bits=sk_ref.sig_bits)
    np.testing.assert_array_equal(present.numpy(), np.asarray(j_pres))
    np.testing.assert_array_equal(rank.numpy(), np.asarray(j_rank))
    np_pres, np_rank = sk.probe_fingerprints_np(q)
    np.testing.assert_array_equal(present.numpy(), np_pres)
    np.testing.assert_array_equal(rank.numpy(), np_rank)
    rows = port_sk.match_bitmap_from(torch.from_numpy(q.view(np.int32)),
                                     arrs, sig_bits=sk.sig_bits)
    j_rows = ref_sk.match_bitmap_from(
        jnp.asarray(q), sk_ref.device_arrays(), level_bits=lb,
        level_word_offset=lo, sig_bits=sk_ref.sig_bits)
    np.testing.assert_array_equal(rows.numpy().view(np.uint32),
                                  np.asarray(j_rows))
    assert present.numpy()[:np.unique(fps).size].all()


def test_jax_built_segments_carried_over_answer_the_same():
    """Segments built by the JAX package, carried over as numpy arrays,
    answer waves in the port exactly as the JAX engine does."""
    rng, fps, posts = _corpus(5, n_pairs=15000)
    w = ref_seg.SegmentWriter(memory_limit_bytes=1 << 14)
    for lo in range(0, fps.size, 1500):
        w.add_fingerprint_batch(fps[lo:lo + 1500], posts[lo:lo + 1500])
    segs_ref = w.finish_segments()
    segs = [sketch_from_arrays(sketch_arrays(s)) for s in segs_ref]
    for a, b in zip(segs, segs_ref):
        _assert_sketch_equal(a, b)
        assert a.sealed_source.canonical_lists() \
            == b.sealed_source.canonical_lists()
    uniq = np.unique(fps)
    queries = [[int(x) for x in rng.choice(uniq, int(rng.integers(1, 5)))]
               for _ in range(24)] + [[int(rng.integers(0, 2**32))]]
    eng, eng_ref = QueryEngine(segs, device="cpu"), RefEngine(segs_ref)
    for op in ("and", "or"):
        got = eng.query_fps_batch(queries, op=op)
        want = eng_ref.query_fps_batch(queries, op=op)
        for g, h in zip(got, want):
            np.testing.assert_array_equal(g, h)
