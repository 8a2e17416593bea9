"""Priority packing: integer score + hashed tie-break bits in one int32.

Port of ``k8s1m_tpu/ops/priority.py``.  ``prio = clip(score, 0, 2047) <<
20 | jitter``; the jitter is a stateless separable murmur3 hash of (wave
seed, pod row, node column), so the CUDA kernels, their plain versions
and the JAX package all draw the same bits for the same wave.
``class_key`` is the seed-independent top of a priority, the key of the
deltasched candidate index.

PyTorch has no uint32 multiply or logical right shift, so the hash runs
in int64 on values masked to 32 bits: the int64 product wraps mod 2^64
and its low 32 bits are exactly the uint32 product, and ``>>`` on a
non-negative masked value is the logical shift.  A negative i32 seed
enters as ``seed & 0xFFFFFFFF`` (its uint32 bit pattern).

The wave seed itself comes from a PRNG key the coordinator splits once
per wave.  ``prng_key``/``prng_split``/``seed_of`` are a numpy twin of
``jax.random.key``, ``jax.random.split`` and the one scalar
``jax.random.randint`` draw the JAX step takes (threefry2x32, with the
``jax_threefry_partitionable`` layout of counters), so a port coordinator
draws the same seed for every wave as the JAX coordinator with the same
``seed`` argument.  ``pod_priority_of`` reads a pod object's
``spec.priority``.
"""

from __future__ import annotations

import numpy as np
import torch

from k8s1m_tpu_torch.snapshot.records import pod_priority_of  # noqa: F401 (re-exported)

JITTER_BITS = 20
MAX_SCORE = (1 << 11) - 1  # 2047; 2047 * 2^20 + (2^20 - 1) == int32 max
INFEASIBLE = -1

_M32 = 0xFFFFFFFF


def _u32(x) -> torch.Tensor:
    """The uint32 bit pattern of an integer tensor (or int), as int64."""
    return torch.as_tensor(x).to(torch.int64) & _M32


def mix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer on uint32 values held in int64 (``[0, 2^32)``)."""
    h = h ^ (h >> 16)
    h = (h * 0x7FEB352D) & _M32
    h = h ^ (h >> 15)
    h = (h * 0x846CA68B) & _M32
    h = h ^ (h >> 16)
    return h


def stratum_hash(col_ids, bits: int) -> torch.Tensor:
    """The top ``bits`` tie-break bits as a pure function of the node
    column (seed- and pod-independent), int32."""
    if not 0 < bits <= JITTER_BITS:
        raise ValueError(f"stratum bits must be in [1, {JITTER_BITS}], got {bits}")
    h = mix32((_u32(col_ids) * 0xC2B2AE35) & _M32)
    return (h >> (32 - bits)).to(torch.int32)


def hash_jitter(seed, row_ids, col_ids, stratum_bits: int = 0) -> torch.Tensor:
    """Uniform bits in [0, 2^JITTER_BITS) per (pod, node), int32.

    Each axis is mixed on its own narrow shape (``[B, 1]`` rows,
    ``[1, C]`` cols); the full-width work is one xor and one mask.
    ``stratum_bits`` > 0 replaces the top bits of the draw with
    ``stratum_hash`` of the node column."""
    s = _u32(seed)
    rh = mix32(s ^ ((_u32(row_ids) * 0x9E3779B9) & _M32))
    ch = mix32(s ^ ((_u32(col_ids) * 0x85EBCA6B) & _M32))
    j = ((rh ^ ch) & ((1 << JITTER_BITS) - 1)).to(torch.int32)
    if stratum_bits == 0:
        return j
    low = JITTER_BITS - stratum_bits
    return (stratum_hash(col_ids, stratum_bits) << low) | (j & ((1 << low) - 1))


def pack_hashed(score_int, seed, mask, row_ids, col_ids, stratum_bits: int = 0):
    """(score i32, mask bool) -> priority i32 (-1 where ``mask`` is False)."""
    s = torch.clamp(score_int, 0, MAX_SCORE).to(torch.int32)
    prio = (s << JITTER_BITS) | hash_jitter(seed, row_ids, col_ids, stratum_bits)
    return torch.where(mask, prio, torch.full_like(prio, INFEASIBLE))


def class_key(score_int, col_ids, stratum_bits: int) -> torch.Tensor:
    """The candidate-index stratum class of a (score, node column) pair:
    the top ``11 + stratum_bits`` bits of the packed priority, the part
    that does not depend on (seed, pod row).  With ``low = JITTER_BITS -
    stratum_bits`` every feasible priority is ``(class_key << low) |
    (per-pod jitter & (2^low - 1))``, so a strictly greater class wins
    for every wave seed and pod row (engine/deltacache.py's index)."""
    s = torch.clamp(score_int, 0, MAX_SCORE).to(torch.int32)
    if stratum_bits == 0:
        return s
    return (s << stratum_bits) | stratum_hash(col_ids, stratum_bits)


def unpack_score(prio: torch.Tensor) -> torch.Tensor:
    return torch.where(prio >= 0, prio >> JITTER_BITS, torch.full_like(prio, -1))


# ---- the wave seed: threefry2x32 as jax.random draws it --------------------

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key, x0, x1):
    """Threefry-2x32 (20 rounds) of the counter pairs ``(x0, x1)`` under
    ``key`` (two uint32 words), as ``jax._src.prng`` computes it; uint32
    arithmetic wraps."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(_KS_PARITY))
    x = [np.asarray(x0, np.uint32) + ks[0], np.asarray(x1, np.uint32) + ks[1]]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def prng_key(seed: int) -> tuple[int, int]:
    """``jax.random.key(seed)`` with 64-bit types off: the seed is taken
    as an int32 and the key is ``(0, seed & 0xFFFFFFFF)``."""
    s = int(np.array(seed, np.int64).astype(np.int32))
    return 0, s & _M32


def prng_split(key) -> tuple[tuple[int, int], tuple[int, int]]:
    """``jax.random.split(key)`` into two keys: counters (0, 0) and (0, 1)
    of ``iota_2x32_shape((2,))``, each key the pair of output words."""
    b0, b1 = threefry2x32(key, [0, 0], [0, 1])
    return (int(b0[0]), int(b1[0])), (int(b0[1]), int(b1[1]))


def seed_of(key) -> int:
    """``jax.random.randint(key, (), -2**31, 2**31 - 1, int32)`` — the
    i32 hash seed of one wave.  randint splits the key, draws 32 bits
    from each half (``bits0 ^ bits1`` of counter (0, 0)) and reduces the
    second draw modulo the span 2^32 - 1 (the first draw's multiplier
    2^32 mod span is 0 in uint32 arithmetic)."""
    _hi_key, lo_key = prng_split(key)
    b0, b1 = threefry2x32(lo_key, [0], [0])
    lo = int(b0[0] ^ b1[0])
    off = lo % _M32
    return int(np.array((off - (1 << 31)) & _M32, np.uint32).view(np.int32))
