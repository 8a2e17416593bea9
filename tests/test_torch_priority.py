"""The port's tie-break hash and priority packing vs the JAX package.

``k8s1m_tpu_torch.ops.priority`` does the murmur3 math in int64 masked
to 32 bits; every function must be bit-equal to ``k8s1m_tpu.ops.priority``
(uint32 in JAX) on random grids, negative seeds and the stratum widths
the engine uses.  Tolerance: exact equality — every output is an integer.
"""

import _torch_cpu  # noqa: F401  (bounds torch's CPU threads first)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s1m_tpu.ops import priority as jprio
from k8s1m_tpu_torch.ops import priority as tprio

SEEDS = [0, 1, 1234, -1, -(1 << 31), (1 << 31) - 1, -987654321]


def _i32(rng, shape):
    return rng.integers(-(1 << 31), 1 << 31, size=shape, dtype=np.int64).astype(np.int32)


def test_mix32_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 1 << 32, size=4096, dtype=np.uint64).astype(np.uint32)
    x[:4] = [0, 1, 0xFFFFFFFF, 0x80000000]
    want = np.asarray(jprio.mix32(jnp.asarray(x, jnp.uint32)))
    got = tprio.mix32(torch.from_numpy(x.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("stratum_bits", [0, 1, 11, 20])
def test_hash_jitter_matches_jax(seed, stratum_bits):
    rng = np.random.default_rng(seed & 0xFFFF)
    rows = np.concatenate([np.arange(64), _i32(rng, 64)]).astype(np.int32)[:, None]
    cols = np.concatenate([np.arange(256), _i32(rng, 256)]).astype(np.int32)[None, :]
    want = np.asarray(jprio.hash_jitter(
        jnp.int32(seed), jnp.asarray(rows), jnp.asarray(cols), stratum_bits
    ))
    got = tprio.hash_jitter(
        seed, torch.from_numpy(rows), torch.from_numpy(cols), stratum_bits
    )
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("stratum_bits", [0, 1, 11, 20])
def test_pack_hashed_matches_jax(stratum_bits):
    rng = np.random.default_rng(stratum_bits)
    b, c = 32, 300
    score = rng.integers(-50, 3000, size=(b, c)).astype(np.int32)
    mask = rng.random((b, c)) < 0.7
    rows = (np.arange(b, dtype=np.int32) + 7)[:, None]
    cols = (np.arange(c, dtype=np.int32) + 1000)[None, :]
    for seed in (-5, 99):
        want = np.asarray(jprio.pack_hashed(
            jnp.asarray(score), jnp.int32(seed), jnp.asarray(mask),
            jnp.asarray(rows), jnp.asarray(cols), stratum_bits,
        ))
        got = tprio.pack_hashed(
            torch.from_numpy(score), seed, torch.from_numpy(mask),
            torch.from_numpy(rows), torch.from_numpy(cols), stratum_bits,
        )
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bits", [1, 11, 20])
def test_stratum_hash_matches_jax(bits):
    cols = np.arange(-100, 5000, dtype=np.int32)
    want = np.asarray(jprio.stratum_hash(jnp.asarray(cols), bits))
    got = tprio.stratum_hash(torch.from_numpy(cols), bits)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bits", [0, 21])
def test_stratum_hash_rejects_widths(bits):
    with pytest.raises(ValueError):
        tprio.stratum_hash(torch.arange(4), bits)


def test_unpack_score_matches_jax():
    rng = np.random.default_rng(5)
    prio = _i32(rng, 2048)
    prio[:3] = [-1, 0, (1 << 31) - 1]
    prio = np.where(prio < -1, -1, prio).astype(np.int32)
    want = np.asarray(jprio.unpack_score(jnp.asarray(prio)))
    got = tprio.unpack_score(torch.from_numpy(prio))
    np.testing.assert_array_equal(got.numpy(), want)
    assert tprio.JITTER_BITS == jprio.JITTER_BITS
    assert tprio.MAX_SCORE == jprio.MAX_SCORE
