"""The query wave's two device steps against the JAX package: the wave's
token fingerprinting (one ``token_hash`` launch for every byte token of a
wave, of any length) and the fused segment probe (``sketch_probe``'s second
entry: MPHF probe, signature check, CSF rank and the OR of plane rows into
the wave's accumulator).  Inputs come from numpy seeds; the JAX package's
Pallas kernels run in interpret mode, as its own tests run them.  Integer
data throughout: the tolerance is exact equality.

The wave's fold and extraction (``bitset_ops``' and ``bitmap_extract``'s
ragged entries: each live query folded over its own tokens, the answer
compacted into one id array) are held through the engine: pad rows, queries
of different token counts, host-fallback segments, empty and answerless
waves, and answers that outlive the next wave.

The ``requires_cuda`` cases hold the kernels against their plain versions
on the card, at the launched shapes and edges; they skip where there is no
GPU."""
import threading

import numpy as np
import pytest
import torch

from repro_torch.core import batch_builder as port_bb
from repro_torch.core import immutable_sketch as port_sk
from repro_torch.core.batch_builder import wave_fingerprints
from repro_torch.core.hashing import np_token_fingerprints, token_fingerprint
from repro_torch.core.query_engine import QueryEngine
from repro_torch.kernels.bitmap_extract.ops import (bitmap_extract,
                                                   bitmap_extract_ragged)
from repro_torch.kernels.bitset_ops.ops import (bitset_reduce_batch,
                                               bitset_reduce_ragged)
from repro_torch.kernels.sketch_probe.ops import match_planes, mphf_probe_arrs
from repro_torch.kernels.sketch_probe.ref import (match_planes_ref,
                                                  sketch_probe_ref)
from repro_torch.kernels.token_hash.ops import token_fingerprints
from repro_torch.kernels.token_hash.ref import token_hash_ref

# token lengths the wave must hash exactly: empty, one byte, around the
# ingest's 64-byte packing width, and past it
TOKEN_LENGTHS = (0, 1, 63, 64, 65, 200)


def _i32(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32))


def _token(rng, n: int) -> bytes:
    return rng.integers(0, 256, n).astype(np.uint8).tobytes()


def _wave_tokens(seed):
    """Queries of byte tokens of every TOKEN_LENGTHS length, non-ASCII
    tokens, integer fingerprints mixed in, and empty queries."""
    rng = np.random.default_rng(seed)
    waves = [[_token(rng, n) for n in TOKEN_LENGTHS],
             [], ["naïve".encode(), "é".encode() * 40, "日本語".encode()],
             [int(rng.integers(0, 2**32)), b"a", 7, bytearray(b"xyz")],
             [], [_token(rng, 200), 0, 2**32 - 1]]
    return waves + [[_token(rng, int(n)) for n in rng.integers(0, 70, 5)]
                    for _ in range(20)]


def _corpus(seed, extra_tokens=(), n_tokens=1500, n_postings=96,
            n_pairs=12000):
    rng = np.random.default_rng(seed)
    fps = (rng.integers(0, n_tokens, n_pairs).astype(np.uint64)
           * 2654435761 % (1 << 32)).astype(np.uint32)
    extra = np.asarray([token_fingerprint(t) for t in extra_tokens],
                       np.uint32)
    fps = np.concatenate([fps, np.repeat(extra, 3)])
    posts = rng.integers(0, n_postings, fps.size).astype(np.int64)
    return rng, fps, posts


# -------------------------------------------------- wave fingerprinting
@pytest.mark.parametrize("seed", [0, 1])
def test_wave_fingerprints_match_reference_as_fp(seed):
    from repro.core.query_engine import _as_fp
    waves = _wave_tokens(seed)
    flat, lens = wave_fingerprints(waves, device=torch.device("cpu"))
    assert flat.dtype == np.uint32 and lens.tolist() == [len(w) for w in waves]
    want = [_as_fp(t) & 0xFFFFFFFF for toks in waves for t in toks]
    np.testing.assert_array_equal(flat, np.asarray(want, np.uint32))


@pytest.mark.parametrize("n", TOKEN_LENGTHS)
def test_wave_fingerprint_of_one_length_matches_token_fingerprint(n):
    """A wave of tokens all of one length (the matrix width is exactly n)
    and the same tokens beside a longer one (zero-padded rows)."""
    rng = np.random.default_rng(n)
    toks = [_token(rng, n) for _ in range(9)]
    want = np.asarray([token_fingerprint(t) for t in toks], np.uint32)
    for wave in ([toks], [toks, [_token(rng, 300)]]):
        flat, _ = wave_fingerprints(wave, device=torch.device("cpu"))
        np.testing.assert_array_equal(flat[:len(toks)], want)


def test_wave_fingerprints_of_only_ints_or_nothing():
    flat, lens = wave_fingerprints([[3, 2**32 + 5], []],
                                   device=torch.device("cpu"))
    assert flat.tolist() == [3, 5] and lens.tolist() == [2, 0]
    flat, lens = wave_fingerprints([], device=torch.device("cpu"))
    assert flat.size == 0 and lens.size == 0


def test_one_long_token_pads_only_its_own_bucket(monkeypatch):
    """A 4096-token wave with one 20,000-byte raw token: every fingerprint
    equals the JAX package's ``_as_fp``, and the matrices packed hold the
    short tokens at their own width and the long one in a bucket of its
    own, not the wave padded to 20,000 bytes a row."""
    from repro.core.query_engine import _as_fp
    rng = np.random.default_rng(9)
    wave = [[_token(rng, int(n)) for n in rng.integers(1, 65, 8)]
            for _ in range(512)]
    wave[100][3] = _token(rng, 20_000)
    packed, inner = [], port_bb.token_matrix_fingerprints

    def recording(mat, lengths, device):
        packed.append(mat.shape)
        return inner(mat, lengths, device)

    monkeypatch.setattr(port_bb, "token_matrix_fingerprints", recording)
    flat, _ = wave_fingerprints(wave, device=torch.device("cpu"))
    want = [_as_fp(t) & 0xFFFFFFFF for toks in wave for t in toks]
    np.testing.assert_array_equal(flat, np.asarray(want, np.uint32))
    assert sorted(packed) == [(1, 20_000), (4095, 64)]


@pytest.mark.parametrize("seed", [0, 1])
def test_ingest_fingerprint_tokens_keep_the_64_byte_cut(seed):
    """The ingest's batch fingerprints (which share the wave's packer)
    still cut each token to 64 bytes, as the JAX package's do."""
    from repro.core.batch_builder import fingerprint_tokens as ref
    rng = np.random.default_rng(seed)
    toks = [_token(rng, n) for n in TOKEN_LENGTHS] + [
        "é".encode() * 40, "naïve".encode(), b""]
    got = port_bb.fingerprint_tokens(toks, device=torch.device("cpu"))
    np.testing.assert_array_equal(got, ref(toks))
    assert port_bb.fingerprint_tokens([], device=torch.device("cpu")).size == 0


@pytest.mark.parametrize("op", ["and", "or"])
def test_query_batch_with_raw_long_tokens_matches_reference_engine(op):
    """Raw tokens past the ingest's 64-byte width (a 100-byte token, 40 x
    "é") indexed by their full fingerprints: the port's wave answers as the
    JAX engine's, and as the scalar host path."""
    from repro.core import batch_builder as ref_bb
    from repro.core import immutable_sketch as ref_sk
    from repro.core.query_engine import QueryEngine as RefEngine
    long_toks = [b"q" * 100, "é".encode() * 40, bytes(range(200))]
    _, fps, posts = _corpus(3, long_toks)
    half = fps.size // 2
    segs, segs_ref = [], []
    for lo, hi in ((0, half), (half, fps.size)):
        segs.append(port_sk.build_immutable(
            port_bb.build_sealed(fps[lo:hi], posts[lo:hi])))
        segs_ref.append(ref_sk.build_immutable(
            ref_bb.build_sealed(fps[lo:hi], posts[lo:hi])))
    waves = [[long_toks[0]], [long_toks[1]], [long_toks[2]],
             [long_toks[1], long_toks[2]], [], [long_toks[0], int(fps[0])],
             [b"q" * 64], [long_toks[2], b"zz"]]
    eng, eng_ref = QueryEngine(segs, device="cpu"), RefEngine(segs_ref)
    got, want = eng.query_batch(waves, op=op), eng_ref.query_batch(waves,
                                                                   op=op)
    assert len(got) == len(waves)
    for g, w, toks in zip(got, want, waves):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, eng.host_query(toks, op=op))
    assert all(len(g) for g in got[:3]), "a long token found no posting"
    assert len(got[6]) == 0, "a 64-byte cut of a long token matched"


# ---------------------------------------------- fold and extraction
def _engines(seed, host_fallback=False, ref=True):
    """Three segments built by the port (the last without bitmap planes
    when ``host_fallback``: probed on the host), the JAX engine over the
    same segments built by the JAX package (with ``ref``; else None), and
    a wave of 45 queries: 38 live (not a power of two), 7 empty, 1 to 6
    tokens each, present fingerprints, absent ones and byte tokens
    mixed."""
    words = [b"alpha", b"beta", "gamma-\u00e9".encode(), b"x" * 80]
    rng, fps, posts = _corpus(seed, words, n_postings=200)
    cuts = (0, fps.size // 3, 2 * fps.size // 3, fps.size)
    kws = [{"plane_budget_bytes": 0} if host_fallback and i == 2 else {}
           for i in range(3)]
    segs = [port_sk.build_immutable(
        port_bb.build_sealed(fps[lo:hi], posts[lo:hi]), **kw)
        for lo, hi, kw in zip(cuts, cuts[1:], kws)]
    assert (segs[2].planes is None) == host_fallback
    eng_ref = None
    if ref:
        from repro.core import batch_builder as ref_bb
        from repro.core import immutable_sketch as ref_sk
        from repro.core.query_engine import QueryEngine as RefEngine
        eng_ref = RefEngine([ref_sk.build_immutable(
            ref_bb.build_sealed(fps[lo:hi], posts[lo:hi]), **kw)
            for lo, hi, kw in zip(cuts, cuts[1:], kws)])
    wave = []
    for i in range(45):
        if i % 6 == 5:
            wave.append([])
            continue
        # tokens that share a posting, so that most AND answers are not empty
        near = np.unique(fps[posts == rng.integers(0, 200)])
        toks = [int(x) for x in rng.choice(near, 1 + i % 6)]
        if i % 4 == 1:
            toks[-1] = words[i % len(words)]
        if i % 9 == 2:
            toks.append(int(rng.integers(0, 2**32)))      # absent
        wave.append(toks)
    return segs, eng_ref, wave


@pytest.mark.parametrize("host_fallback", [False, True])
@pytest.mark.parametrize("op", ["and", "or"])
def test_query_batch_with_pad_rows_and_mixed_token_counts_matches_reference(
        op, host_fallback):
    """38 live queries (a Qb of 64: 26 pad rows), token counts 1..6 (a Tb
    of 8: pad slots in every row), empty queries between
    them; with a host-fallback segment OR-ing into the accumulator before
    the fold too."""
    segs, eng_ref, wave = _engines(11, host_fallback)
    eng = QueryEngine(segs, device="cpu")
    got, want = eng.query_batch(wave, op=op), eng_ref.query_batch(wave, op=op)
    assert len(got) == len(wave) == 45
    assert sum(map(bool, wave)) == 38
    for g, w, toks in zip(got, want, wave):
        assert g.dtype == np.int64
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, eng.host_query(toks, op=op))
    assert sum(len(g) > 0 for g in got) > 20


def test_wave_answers_are_unchanged_after_the_next_wave():
    """Each wave's answers are its own: a second, larger wave on the same
    engine leaves the first's as they were, and no answer of one wave
    shares memory with another's."""
    segs, _, wave = _engines(12, ref=False)
    eng = QueryEngine(segs, device="cpu")
    first = eng.query_batch(wave[:20])
    kept = [a.copy() for a in first]
    second = eng.query_batch(wave, op="or")
    for a, b in zip(first, kept):
        np.testing.assert_array_equal(a, b)
    assert any(len(a) for a in first)
    assert not any(np.shares_memory(a, b) for a in first for b in second)


def _waves_from_threads(eng, wave, n_threads=4, rounds=6):
    """Every thread runs ``rounds`` waves on ``eng`` at once (a wave, its
    reverse under OR, a prefix), all started together; -> each thread's
    answers, and the same waves run one after another for comparison."""
    jobs = [(wave, "and"), (wave[::-1], "or"), (wave[:17], "and")]
    want = [eng.query_batch(w, op=op) for w, op in jobs]
    start = threading.Barrier(n_threads)
    got = [[] for _ in range(n_threads)]

    def run(i):
        start.wait()
        for r in range(rounds):
            j = (i + r) % len(jobs)
            got[i].append((j, eng.query_batch(jobs[j][0], op=jobs[j][1])))

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return got, want


def _assert_threads_agree(got, want):
    assert all(len(g) for g in got)
    for answers in got:
        for j, out in answers:
            assert len(out) == len(want[j])
            for a, b in zip(out, want[j]):
                np.testing.assert_array_equal(a, b)


def test_waves_from_several_threads_on_one_engine_keep_their_answers():
    """Four threads run waves on one engine at once, with a host-fallback
    segment (whose decoded lists go through the engine's LRU): each gets
    the answers the same wave gets alone."""
    segs, _, wave = _engines(15, host_fallback=True, ref=False)
    eng = QueryEngine(segs, device="cpu", lru_lists=8)
    _assert_threads_agree(*_waves_from_threads(eng, wave))


def test_empty_and_answerless_waves_return_empty_arrays():
    """A wave whose AND answers are all empty (total 0), one of empty
    queries only, and an empty wave."""
    segs, eng_ref, wave = _engines(13)
    eng = QueryEngine(segs, device="cpu")
    absent = [[int(wave[0][0]), 7], [8, 9, 10], [], [11]]
    for w in (absent, [[], []], []):
        got = eng.query_batch(w)
        assert len(got) == len(w)
        assert all(g.dtype == np.int64 and g.size == 0 for g in got)
        for g, r in zip(got, eng_ref.query_batch(w)):
            np.testing.assert_array_equal(g, r)


# ------------------------------------------------------ fused probe
# (seed, tokens, postings, gamma, sig_bits): the default layout; keys in
# the fallback array, more of them than the kernel searches in shared
# memory (gamma 0.1 leaves most keys past the 12 levels) and fewer (gamma
# 0.5, W 63); a one-token segment; 32-bit signatures
FUSED_CASES = [(0, 1500, 96, 2.0, 8), (1, 3000, 40, 0.1, 5),
               (2, 1, 3, 2.0, 8), (3, 3000, 2000, 0.5, 12),
               (4, 4000, 64, 2.0, 32)]


def _fused_case(seed, n_tokens, n_postings, gamma, sig_bits):
    """The same segment built by both packages, plus probe fingerprints:
    every key, absent ones (most hit a level and fail the signature), 0 and
    2^32 - 1."""
    from repro.core import batch_builder as ref_bb
    from repro.core import immutable_sketch as ref_sk
    rng, fps, posts = _corpus(seed, n_tokens=n_tokens,
                              n_postings=n_postings, n_pairs=8 * n_tokens)
    sk = port_sk.build_immutable(port_bb.build_sealed(fps, posts),
                                 sig_bits=sig_bits, gamma=gamma)
    sk_ref = ref_sk.build_immutable(ref_bb.build_sealed(fps, posts),
                                    sig_bits=sig_bits, gamma=gamma)
    q = np.concatenate([np.unique(fps), rng.integers(
        0, 2**32, 600, dtype=np.uint64).astype(np.uint32), [0, 0xFFFFFFFF]])
    q = q.astype(np.uint32)[rng.permutation(q.size)]
    return sk, sk_ref, q, ~np.isin(q, fps)


@pytest.mark.parametrize("seed,n_tokens,n_postings,gamma,sig_bits",
                         FUSED_CASES)
def test_fused_probe_plain_matches_reference_match_bitmap(
        seed, n_tokens, n_postings, gamma, sig_bits):
    """One segment, the accumulator at the segment's width, wider (the
    engine's W past the segment's: zero-padded) and narrower (cut)."""
    import jax.numpy as jnp
    from repro.core import immutable_sketch as ref_sk
    sk, sk_ref, q, absent_keys = _fused_case(seed, n_tokens, n_postings,
                                             gamma, sig_bits)
    if gamma < 1:
        assert 0 < sk.mphf.fallback_fps.size, "no fallback keys"
        assert (sk.mphf.fallback_fps.size > 1024) == (gamma < 0.5)
    lb, lo = sk_ref._level_layout()
    rows = np.asarray(ref_sk.match_bitmap_from(
        jnp.asarray(q), sk_ref.device_arrays(), level_bits=lb,
        level_word_offset=lo, sig_bits=sig_bits))
    arrs = sk.device_arrays("cpu")
    w_seg = rows.shape[1]
    rng = np.random.default_rng(seed)
    for w_out in (w_seg, w_seg + 3, max(w_seg - 1, 1)):
        acc0 = rng.integers(0, 2**32, (q.size, w_out), dtype=np.uint64) \
            .astype(np.uint32)
        got = match_planes(_i32(q), arrs, _i32(acc0), sig_bits=sig_bits)
        want = acc0.copy()
        w = min(w_seg, w_out)
        want[:, :w] |= rows[:, :w]
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    # the fresh-rows form equals the reference's rows
    got = port_sk.match_bitmap_from(_i32(q), arrs, sig_bits=sig_bits)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), rows)
    # the case holds signature rejects: absent keys that the MPHF resolves
    # to a slot and whose rows stay empty
    _, absent = mphf_probe_arrs(_i32(q), arrs)
    rejected = absent_keys & ~absent.numpy() & ~rows.any(axis=1)
    assert rejected.any() or n_tokens == 1
    assert rows[~absent_keys].any(axis=1).all()


def test_fused_probe_plain_ors_over_segments_like_reference_engine():
    """Engine planes OR-ed over segments of different widths (W_seg <
    W_engine) equal the JAX engine's answers, and the accumulator sees one
    fused call per segment."""
    from repro.core import batch_builder as ref_bb
    from repro.core import immutable_sketch as ref_sk
    from repro.core.query_engine import QueryEngine as RefEngine
    rng, fps, posts = _corpus(7, n_postings=300)
    cuts = (0, 4000, 9000, fps.size)
    segs, segs_ref = [], []
    for i, (lo, hi) in enumerate(zip(cuts, cuts[1:])):
        p = posts[lo:hi] % (100 * (i + 1))        # widths 4, 7 and 10 words
        segs.append(port_sk.build_immutable(port_bb.build_sealed(fps[lo:hi], p)))
        segs_ref.append(ref_sk.build_immutable(ref_bb.build_sealed(fps[lo:hi], p)))
    assert len({s.planes.shape[1] for s in segs}) == 3
    uniq = np.unique(fps)
    queries = [[int(x) for x in rng.choice(uniq, int(rng.integers(1, 4)))]
               for _ in range(40)] + [[int(rng.integers(0, 2**32))], []]
    eng, eng_ref = QueryEngine(segs, device="cpu"), RefEngine(segs_ref)
    calls = []
    inner = port_sk.match_bitmap_from

    def counting(*a, **kw):
        calls.append(kw.get("out") is not None)
        return inner(*a, **kw)

    port_sk.match_bitmap_from = counting
    try:
        for op in ("and", "or"):
            for g, w in zip(eng.query_fps_batch(queries, op=op),
                            eng_ref.query_fps_batch(queries, op=op)):
                np.testing.assert_array_equal(g, w)
    finally:
        port_sk.match_bitmap_from = inner
    assert calls == [True] * 6, "not one fused call per segment and wave"


def test_fused_probe_rejects_bad_inputs():
    sk, _, q, _ = _fused_case(*FUSED_CASES[0])
    arrs = sk.device_arrays("cpu")
    fps, w = _i32(q), sk.planes.shape[1]
    with pytest.raises(ValueError):          # acc rows != Q
        match_planes(fps, arrs, torch.zeros((q.size - 1, w), dtype=torch.int32),
                     sig_bits=8)
    with pytest.raises(ValueError):          # acc not int32
        match_planes(fps, arrs, torch.zeros((q.size, w), dtype=torch.int64),
                     sig_bits=8)
    with pytest.raises(ValueError):          # fps not int32
        match_planes(fps.to(torch.int64), arrs,
                     torch.zeros((q.size, w), dtype=torch.int32), sig_bits=8)
    with pytest.raises(ValueError):
        match_planes(fps, arrs, torch.zeros((q.size, w), dtype=torch.int32),
                     sig_bits=33)


# ------------------------------------------------------ CUDA, on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _token_matrix(seed, n, l):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 256, (n, l)).astype(np.uint8)
    lens = rng.integers(0, l + 1, n).astype(np.int32)
    lens[:4] = (0, l, l + 9, -3)[:n]
    toks[np.arange(l)[None, :] >= lens[:, None]] = 0
    return toks, lens


# the median ingest launch, the term and contains waves, the edges: both
# sides of the direct path's widest row (16 bytes), one staging window and
# past it, N off a block, N = 0, L = 0
TOKEN_CUDA_SHAPES = [(12_456, 22), (4096, 16), (6000, 3), (4096, 64),
                     (1, 1), (65, 1), (100, 3), (50, 17), (129, 22),
                     (63, 64), (0, 64), (300, 65), (77, 200), (5, 5000),
                     (10, 0)]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("n,l", TOKEN_CUDA_SHAPES)
@pytest.mark.parametrize("offset", [0, 1, 13])
def test_cuda_token_hash_staged_matches_plain(cuda, n, l, offset):
    """At every width, from a matrix at any byte alignment (``offset``
    bytes into a buffer)."""
    toks, lens = _token_matrix(n * 7 + l, n, l)
    buf = torch.zeros(toks.size + offset, dtype=torch.uint8, device=cuda)
    t = buf[offset:].view(n, l)
    t.copy_(torch.from_numpy(toks).to(cuda))
    ln = torch.from_numpy(lens).to(cuda)
    before = token_fingerprints.launch_count
    got = token_fingerprints(t, ln)
    torch.cuda.synchronize()
    assert token_fingerprints.launch_count == before + (n > 0)
    assert torch.equal(got, token_hash_ref(t, ln))
    np.testing.assert_array_equal(got.cpu().numpy().view(np.uint32),
                                  np_token_fingerprints(toks, lens))


@pytest.mark.requires_cuda
def test_cuda_wave_fingerprints_launch_once(cuda):
    """A wave of tokens of at most 64 bytes is one launch; a wave with
    longer tokens one launch more for each power-of-two width bucket."""
    rng = np.random.default_rng(5)
    short = [[_token(rng, int(n)) for n in rng.integers(0, 65, 6)]
             for _ in range(40)]
    for waves, n_launch in ((short, 1), (_wave_tokens(5), 3)):
        before = token_fingerprints.launch_count
        flat, lens = wave_fingerprints(waves, device=cuda)
        assert token_fingerprints.launch_count == before + n_launch
        want, want_lens = wave_fingerprints(waves,
                                            device=torch.device("cpu"))
        np.testing.assert_array_equal(flat, want)
        np.testing.assert_array_equal(lens, want_lens)


def _many_levels_case():
    """An MPHF past the 12 levels the kernel takes by value (a low gamma
    and many levels allowed)."""
    from repro_torch.core.mphf import build_mphf
    rng = np.random.default_rng(11)
    keys = np.unique(rng.integers(0, 2**32, 3000, dtype=np.uint64)
                     .astype(np.uint32))
    m = build_mphf(keys, gamma=0.3, max_levels=40)
    assert m.n_levels > 12
    q = np.concatenate([keys, rng.integers(0, 2**32, 500, dtype=np.uint64)
                        .astype(np.uint32)])
    return m, q, keys.size


@pytest.mark.requires_cuda
@pytest.mark.parametrize("seed,n_tokens,n_postings,gamma,sig_bits",
                         FUSED_CASES)
def test_cuda_sketch_probe_entries_match_plain(cuda, seed, n_tokens,
                                               n_postings, gamma, sig_bits):
    """Both entries, bit for bit: the probe, and the fused OR into an
    accumulator at, past and under the segment's width."""
    sk, _, q, _ = _fused_case(seed, n_tokens, n_postings, gamma, sig_bits)
    arrs = sk.device_arrays(cuda)
    fps = _i32(q).to(cuda)
    idx, absent = mphf_probe_arrs(fps, arrs)
    r_idx, r_abs = sketch_probe_ref(fps, arrs)
    assert torch.equal(idx, r_idx) and torch.equal(absent, r_abs)
    w_seg = sk.planes.shape[1]
    gen = torch.Generator(device=cuda).manual_seed(seed)
    for w_out in (w_seg, w_seg + 3, max(w_seg - 1, 1), 62):
        acc0 = torch.randint(-2**31, 2**31, (q.size, w_out), generator=gen,
                             device=cuda, dtype=torch.int32)
        before = match_planes.launch_count
        got = match_planes(fps, arrs, acc0.clone(), sig_bits=sig_bits)
        torch.cuda.synchronize()
        assert match_planes.launch_count == before + 1
        want = match_planes_ref(fps, arrs, acc0.clone(), sig_bits=sig_bits)
        assert torch.equal(got, want)


@pytest.mark.requires_cuda
def test_cuda_sketch_probe_past_the_levels_by_value(cuda):
    m, q, n_keys = _many_levels_case()
    arrs = m.device_arrays(cuda)
    fps = _i32(q).to(cuda)
    idx, absent = mphf_probe_arrs(fps, arrs)
    r_idx, r_abs = sketch_probe_ref(fps, arrs)
    assert torch.equal(idx, r_idx) and torch.equal(absent, r_abs)
    assert not absent[:n_keys].any()


@pytest.mark.requires_cuda
@pytest.mark.parametrize("q", [1, 33, 4096, 8192, 100_003])
def test_cuda_fused_probe_at_wave_sizes(cuda, q):
    """The term wave's 4096 fingerprints against a segment of W 62 (1984
    postings), and other wave sizes, with half the fingerprints absent."""
    rng, fps, posts = _corpus(q, n_tokens=20_000, n_postings=1984,
                              n_pairs=200_000)
    sk = port_sk.build_immutable(port_bb.build_sealed(fps, posts))
    assert sk.planes.shape[1] == 62
    uniq = np.unique(fps)
    probe = np.concatenate([rng.choice(uniq, q - q // 2), rng.integers(
        0, 2**32, q // 2, dtype=np.uint64).astype(np.uint32)])
    arrs = sk.device_arrays(cuda)
    f = _i32(probe).to(cuda)
    acc = torch.zeros((q, 62), dtype=torch.int32, device=cuda)
    got = match_planes(f, arrs, acc.clone(), sig_bits=sk.sig_bits)
    want = match_planes_ref(f, arrs, acc.clone(), sig_bits=sk.sig_bits)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert bool(got[:q - q // 2].any(dim=1).all())


@pytest.mark.requires_cuda
def test_cuda_engine_wave_launches_one_hash_and_one_probe_a_segment(cuda):
    rng, fps, posts = _corpus(9, n_postings=300)
    segs = [port_sk.build_immutable(port_bb.build_sealed(fps[lo:hi],
                                                         posts[lo:hi]))
            for lo, hi in ((0, 6000), (6000, fps.size))]
    toks = [[bytes([65 + i % 26]) * (1 + i % 64)] for i in range(300)]
    eng, cpu = QueryEngine(segs, device=cuda), QueryEngine(segs, device="cpu")
    before = (token_fingerprints.launch_count, match_planes.launch_count,
              mphf_probe_arrs.launch_count)
    got = eng.query_batch(toks)
    after = (token_fingerprints.launch_count, match_planes.launch_count,
             mphf_probe_arrs.launch_count)
    assert np.subtract(after, before).tolist() == [1, 2, 0]
    for g, w in zip(got, cpu.query_batch(toks)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.requires_cuda
def test_cuda_engine_wave_folds_and_extracts_in_one_launch_each(cuda):
    """A wave launches the ragged fold once and the ragged extract once
    (the padded entries never), equals the CPU engine, and its answers
    survive the next wave: they are views of a fresh array, not of a
    pinned buffer that a later copy reuses.  An answerless wave launches
    no extract."""
    segs, _, wave = _engines(14, host_fallback=True, ref=False)
    eng, cpu = QueryEngine(segs, device=cuda), QueryEngine(segs, device="cpu")
    entries = (bitset_reduce_ragged, bitmap_extract_ragged,
               bitset_reduce_batch, bitmap_extract)
    before = [e.launch_count for e in entries]
    first = eng.query_batch(wave)
    assert [e.launch_count - b for e, b in zip(entries, before)] == [1, 1, 0, 0]
    kept = [a.copy() for a in first]
    for g, w in zip(first, cpu.query_batch(wave)):
        np.testing.assert_array_equal(g, w)
    second = eng.query_batch(wave[::-1], op="or")
    for g, w in zip(second, cpu.query_batch(wave[::-1], op="or")):
        np.testing.assert_array_equal(g, w)
    for a, b in zip(first, kept):
        np.testing.assert_array_equal(a, b)
    assert not any(np.shares_memory(a, b) for a in first for b in second)
    before = [e.launch_count for e in entries]
    assert not any(len(a) for a in eng.query_batch([[7, 8], [9]]))
    assert [e.launch_count - b for e, b in zip(entries, before)] == [1, 0, 0, 0]


@pytest.mark.requires_cuda
def test_cuda_waves_from_several_threads_on_one_engine(cuda):
    """As on the CPU: four threads' waves on one engine on the card, each
    copying its counts and ids to the host at the same time as the
    others', get the answers the same waves get alone."""
    segs, _, wave = _engines(15, host_fallback=True, ref=False)
    eng = QueryEngine(segs, device=cuda, lru_lists=8)
    _assert_threads_agree(*_waves_from_threads(eng, wave, rounds=24))
