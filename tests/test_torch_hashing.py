"""The port's torch hashes equal the JAX package's jnp and numpy hashes
bit for bit (u32 values carried in int64), edges 0 and 0xFFFFFFFF
included."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hashing as ref
from repro_torch.core import hashing as port

EDGES = np.asarray([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE, 0xFFFFFFFF],
                   np.uint32)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    return np.concatenate([EDGES, rng.integers(0, 2**32, 4096,
                                               dtype=np.uint64)
                           .astype(np.uint32)])


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("as_int32", [False, True])
def test_torch_fmix32_matches_jnp_and_np(seed, as_int32):
    x = _inputs(seed)
    t = torch.from_numpy(x.view(np.int32)) if as_int32 \
        else torch.from_numpy(x.astype(np.int64))
    got = port.torch_fmix32(t).numpy()
    np.testing.assert_array_equal(got, np.asarray(ref.jnp_fmix32(
        jnp.asarray(x))).astype(np.int64))
    np.testing.assert_array_equal(got, port.np_fmix32(x).astype(np.int64))
    assert got.min() >= 0 and got.max() <= 0xFFFFFFFF


@pytest.mark.parametrize("seed_value", [0, 0x5EED1E5, 0x516E4715,
                                        0xFFFFFFFF, (0x5EED1E5 * 7)])
def test_torch_seeded_hash32_matches_jnp_and_np(seed_value):
    x = _inputs(3)
    got = port.torch_seeded_hash32(torch.from_numpy(x.view(np.int32)),
                                   seed_value).numpy()
    np.testing.assert_array_equal(got, np.asarray(ref.seeded_hash32(
        jnp.asarray(x), seed_value)).astype(np.int64))
    np.testing.assert_array_equal(
        got, port.np_seeded_hash32(x, seed_value).astype(np.int64))
    assert got[0] == port.scalar_seeded_hash32(int(x[0]), seed_value)


def test_torch_popcount32_matches_numpy():
    x = _inputs(5)
    got = port.torch_popcount32(torch.from_numpy(x.view(np.int32))).numpy()
    want = np.asarray([bin(int(v)).count("1") for v in x])
    np.testing.assert_array_equal(got, want)


def test_host_hashes_are_the_reference_copies():
    rng = np.random.default_rng(9)
    toks = [bytes(rng.integers(0, 256, int(n), dtype=np.uint8))
            for n in rng.integers(0, 40, 64)]
    for t in toks:
        assert port.token_fingerprint(t) == ref.token_fingerprint(t)
    assert port.postings_hash([1, 5, 9]) == ref.postings_hash([1, 5, 9])


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("as_int32", [False, True])
def test_torch_posting_element_hash_matches_jnp_and_scalar(seed, as_int32):
    """The masked int64 LCG step equals the JAX package's 16-bit-limb
    (hi, lo) pair and the scalar 64-bit step, edges included."""
    x = _inputs(seed)
    t = torch.from_numpy(x.view(np.int32)) if as_int32 \
        else torch.from_numpy(x.astype(np.int64))
    hi, lo = port.torch_posting_element_hash(t)
    ref_hi, ref_lo = ref.jnp_posting_element_hash(jnp.asarray(x))
    np.testing.assert_array_equal(hi.numpy(),
                                  np.asarray(ref_hi).astype(np.int64))
    np.testing.assert_array_equal(lo.numpy(),
                                  np.asarray(ref_lo).astype(np.int64))
    for v, h, l in zip(x[:64].tolist(), hi[:64].tolist(), lo[:64].tolist()):
        assert (h << 32) | l == ref.posting_element_hash(v)
