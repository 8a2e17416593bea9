"""The port's numpy twin of the JAX wave-seed draw against ``jax.random``.

The JAX coordinator keeps ``jax.random.key(seed)``, splits it every wave
and derives the wave's i32 hash seed with one ``jax.random.randint``
draw (``k8s1m_tpu/ops/priority.py::seed_of``).  The port's coordinator
takes the same seeds from ``prng_key``/``prng_split``/``seed_of``
(``k8s1m_tpu_torch/ops/priority.py``).  Over a sweep of seeds and 64
chained splits each, every key and every drawn seed must be equal.
Tolerance: exact equality.
"""

import _torch_cpu  # noqa: F401  (bounds torch's CPU threads first)

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from k8s1m_tpu.ops.priority import seed_of as jax_seed_of
from k8s1m_tpu_torch.ops.priority import prng_key, prng_split, seed_of, threefry2x32

SEEDS = [0, 1, -1, (1 << 31) - 1, -((1 << 31) - 1)] + [
    int(s) for s in np.random.default_rng(7).integers(-(1 << 31), 1 << 31, 3)
]


def _words(key) -> tuple[int, int]:
    return tuple(int(w) for w in jax.random.key_data(key))


def test_threefry_partitionable_layout():
    # The twin follows the partitionable counter layout of split and
    # random_bits; a change of this flag changes both in JAX.
    assert jax.config.jax_threefry_partitionable is True


@pytest.mark.parametrize("seed", SEEDS)
def test_chained_splits_and_seeds_match_jax(seed):
    jk, pk = jax.random.key(seed), prng_key(seed)
    assert _words(jk) == pk
    for _ in range(64):
        jk, jsub = jax.random.split(jk)
        pk, psub = prng_split(pk)
        assert _words(jk) == pk
        assert _words(jsub) == psub
        assert int(jax_seed_of(jsub)) == seed_of(psub)


def test_threefry_block_matches_jax_random_bits():
    # random_bits of a scalar draws counter (0, 0); its two output words
    # xor to the 32-bit draw.
    key = jax.random.key(12345)
    b0, b1 = threefry2x32(_words(key), [0], [0])
    want = int(jax.random.bits(key, (), jnp.uint32))
    assert int(b0[0] ^ b1[0]) == want
