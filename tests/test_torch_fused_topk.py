"""The port's fused filter+score+top-K vs the JAX package's Pallas kernel.

The same state (built with the JAX package's host classes from numpy
seeds) goes through ``k8s1m_tpu.ops.pallas_topk.fused_topk`` in interpret
mode, its ``np_reference_topk``, and the port's ``fused_topk`` — which on
CPU tensors is the plain version ``fused_topk_reference``.  Inputs reach
the port through ``k8s1m_tpu_torch.interop``.  Both table layouts, taints,
tolerations, invalid tail rows, hash offsets and stratum bits; N=256,
chunk 128, B=16.  Tolerance: exact equality (integer outputs).

The CUDA kernel itself is held against this plain version on the card by
tests/test_torch_gpu.py and chip_smoke.py.
"""

import _torch_cpu  # noqa: F401  (bounds torch's CPU threads first)

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from k8s1m_tpu.config import (
    EFFECT_NO_EXECUTE,
    EFFECT_NO_SCHEDULE,
    EFFECT_PREFER_NO_SCHEDULE,
    PodSpec,
    TableSpec,
)
from k8s1m_tpu.ops import pallas_topk
from k8s1m_tpu.ops.priority import seed_of
from k8s1m_tpu.plugins.registry import Profile as JaxProfile
from k8s1m_tpu.snapshot.node_table import NodeInfo, NodeTableHost, Taint
from k8s1m_tpu.snapshot.packing import build_packing_spec, pack_table_host
from k8s1m_tpu.snapshot.pod_encoding import (
    PodBatchHost,
    PodInfo,
    Toleration,
    unpack_pod_batch,
)
from k8s1m_tpu_torch import interop
from k8s1m_tpu_torch.ops.fused_topk import (
    candidates,
    fused_topk,
    fused_topk_reference,
)
from k8s1m_tpu_torch.plugins.registry import Profile

JAX_BASE = JaxProfile(node_affinity=0, topology_spread=0, interpod_affinity=0)
BASE = Profile(node_affinity=0, topology_spread=0, interpod_affinity=0)
N = 256
CHUNK = 128
B = 16
K = 4


def build_host(rng, *, tight=False):
    """A fleet with hard/soft/NoExecute taints, existing requests, and
    invalid tail rows; ``tight`` leaves most pods fewer than K nodes."""
    spec = TableSpec(max_nodes=N, max_taint_ids=16)
    host = NodeTableHost(spec)
    for i in range(N - 8):
        taints = []
        if i % 5 == 0:
            taints.append(Taint("dedicated", "infra", EFFECT_NO_SCHEDULE))
        if i % 7 == 0:
            taints.append(Taint("flaky", "", EFFECT_PREFER_NO_SCHEDULE))
        if i % 11 == 0:
            taints.append(Taint("evict", "now", EFFECT_NO_EXECUTE))
        host.upsert(NodeInfo(
            f"node-{i}",
            cpu_milli=int(rng.integers(500, 8000)),
            mem_kib=int(rng.integers(1 << 20, 16 << 20)),
            pods=int(rng.integers(1, 16)),
            taints=taints,
        ))
    live = np.arange(N - 8)
    host.cpu_req[live[::3]] = rng.integers(0, 2000, size=len(live[::3]))
    host.mem_req[live[::3]] = rng.integers(0, 1 << 20, size=len(live[::3]))
    if tight:
        # Nearly every node full: only rows % 97 == 1 (three) keep room.
        full = live[live % 97 != 1]
        host.pods_req[full] = host.pods_alloc[full]
    return spec, host


def encode(host, spec, *, names=()):
    enc = PodBatchHost(PodSpec(batch=B), spec, host.vocab)
    infos = []
    for i in range(B - 2):  # two padding slots
        tol = []
        if i % 2:
            tol = [Toleration(key="dedicated"), Toleration(key="flaky")]
        if i % 4 == 3:
            tol.append(Toleration(key="evict"))
        infos.append(PodInfo(
            f"pod-{i}",
            cpu_milli=100 + 50 * (i % 7),
            mem_kib=(100 + 30 * (i % 5)) << 10,
            tolerations=tol,
            node_name=names[i] if i < len(names) else None,
        ))
    return enc.encode_packed(infos)


def jax_tables(spec, host, layout):
    if layout == "plain":
        return host.to_device()
    return pack_table_host(host, build_packing_spec(spec, host.vocab))


def port_table(jt, device="cpu"):
    cols = {
        f.name: np.asarray(getattr(jt, f.name))
        for f in dataclasses.fields(jt) if f.name != "spec"
    }
    return interop.node_table_from_numpy(cols, getattr(jt, "spec", None), device)


def port_batch(pb, device="cpu"):
    return interop.pod_batch_from_packed(
        pb.ints, pb.bools, pb.spec, pb.table_spec, pb.groups, device
    )


def jax_topk(jt, pb, seed, **kw):
    jb = unpack_pod_batch(pb.ints, pb.bools, pb.spec, pb.table_spec, pb.groups)
    idx, prio = pallas_topk.fused_topk(
        jt, jb, jnp.int32(seed), JAX_BASE, chunk=CHUNK, k=K,
        with_affinity=False, interpret=True, **kw,
    )
    return np.asarray(idx), np.asarray(prio)


CASES = [
    # (layout, seed, row_base, col_base, stratum_bits)
    ("plain", 1234, 0, 0, 0),
    ("plain", -7, 3, 1000, 11),
    ("packed", 1234, 0, 0, 0),
    ("packed", -(1 << 31), 5, 77, 11),
]


@pytest.mark.parametrize("layout,seed,row_base,col_base,stratum_bits", CASES)
def test_reference_matches_pallas(rng, layout, seed, row_base, col_base, stratum_bits):
    spec, host = build_host(rng)
    pb = encode(host, spec, names=("node-17", "no-such-node"))
    jt = jax_tables(spec, host, layout)
    kw = dict(row_base=row_base, col_base=col_base, stratum_bits=stratum_bits)
    want_i, want_p = jax_topk(jt, pb, seed, **kw)
    got_i, got_p = fused_topk(port_table(jt), port_batch(pb), seed, BASE, k=K, **kw)
    np.testing.assert_array_equal(got_p.numpy(), want_p)
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    assert (want_p >= 0).any() and (want_p < 0).any()


@pytest.mark.parametrize("layout", ["plain", "packed"])
@pytest.mark.parametrize("stratum_bits", [0, 11])
def test_reference_matches_numpy_oracle(rng, layout, stratum_bits):
    spec, host = build_host(rng)
    pb = encode(host, spec)
    jt = jax_tables(spec, host, layout)
    jb = unpack_pod_batch(pb.ints, pb.bools, pb.spec, pb.table_spec, pb.groups)
    want_i, want_p = pallas_topk.np_reference_topk(
        host.to_device(), jb, 99, JAX_BASE, k=K, with_affinity=False,
        stratum_bits=stratum_bits,
    )
    got_i, got_p = fused_topk(
        port_table(jt), port_batch(pb), 99, BASE, k=K, stratum_bits=stratum_bits
    )
    np.testing.assert_array_equal(got_p.numpy(), want_p)
    np.testing.assert_array_equal(got_i.numpy(), want_i)


@pytest.mark.parametrize("layout", ["plain", "packed"])
def test_fewer_than_k_feasible(rng, layout):
    """Near-full fleet: unfilled slots are prio -1 and idx -1."""
    spec, host = build_host(rng, tight=True)
    pb = encode(host, spec)
    jt = jax_tables(spec, host, layout)
    want_i, want_p = jax_topk(jt, pb, 5)
    got_i, got_p = fused_topk(port_table(jt), port_batch(pb), 5, BASE, k=K)
    np.testing.assert_array_equal(got_p.numpy(), want_p)
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    short = (want_p < 0).sum(axis=1)
    assert ((short > 0) & (short < K)).any()
    assert (got_i.numpy()[want_p < 0] == -1).all()


@pytest.mark.parametrize("chunk", [1, 7, 64, 256])
def test_reference_independent_of_chunk(rng, chunk):
    spec, host = build_host(rng)
    pb = encode(host, spec)
    t, b = port_table(host.to_device()), port_batch(pb)
    want = fused_topk_reference(t, b, 3, BASE, k=K, chunk=N)
    got = fused_topk_reference(t, b, 3, BASE, k=K, chunk=chunk)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


@pytest.mark.parametrize("layout", ["plain", "packed"])
def test_candidates_match_pallas_candidates(rng, layout):
    """Same candidates and payload as ``pallas_candidates`` at a global
    row offset, with the seed the JAX step derives from its key."""
    spec, host = build_host(rng)
    pb = encode(host, spec)
    jt = jax_tables(spec, host, layout)
    jb = unpack_pod_batch(pb.ints, pb.bools, pb.spec, pb.table_spec, pb.groups)
    key = jax.random.key(11)
    want = pallas_topk.pallas_candidates(
        jt, jb, key, JAX_BASE, chunk=CHUNK, k=K, row_offset=1000,
        with_affinity=False, interpret=True,
    )
    seed = int(np.asarray(seed_of(key)))
    got = candidates(
        port_table(jt), port_batch(pb), seed, BASE, chunk=CHUNK, k=K,
        row_offset=1000,
    )
    for f in ("idx", "prio", "cpu", "mem", "pods", "zone", "region"):
        np.testing.assert_array_equal(
            getattr(got, f).numpy(), np.asarray(getattr(want, f)), err_msg=f
        )


@pytest.mark.parametrize("bad", [
    dict(k=0), dict(k=129), dict(stratum_bits=21),
    dict(profile=Profile()),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(rng, bad):
    spec, host = build_host(rng)
    pb = encode(host, spec)
    kw = dict(k=K, profile=BASE)
    kw.update(bad)
    profile = kw.pop("profile")
    with pytest.raises(ValueError):
        fused_topk(port_table(host.to_device()), port_batch(pb), 1, profile, **kw)


def test_candidates_reject_ragged_chunk(rng):
    spec, host = build_host(rng)
    pb = encode(host, spec)
    with pytest.raises(ValueError):
        candidates(port_table(host.to_device()), port_batch(pb), 1, BASE,
                   chunk=100, k=K)


# ---- the affinity stage -----------------------------------------------------

AFF = Profile(topology_spread=0, interpod_affinity=0)
JAX_AFF = JaxProfile(topology_spread=0, interpod_affinity=0)


def _to_jax(x):
    """A port PodInfo (and its nested terms) rebuilt with the JAX classes."""
    from k8s1m_tpu.snapshot import pod_encoding as jpe

    if isinstance(x, list):
        return [_to_jax(y) for y in x]
    if dataclasses.is_dataclass(x):
        cls = getattr(jpe, type(x).__name__)
        return cls(**{f.name: _to_jax(getattr(x, f.name)) for f in dataclasses.fields(x)})
    return x


@functools.lru_cache(maxsize=1)
def build_labeled():
    """Tier/disk/gpu labels and a numeric label beyond 2^24, invalid tail
    rows (tests/test_pallas_topk.py build_labeled)."""
    spec = TableSpec(max_nodes=N, max_taint_ids=16)
    host = NodeTableHost(spec)
    rng = np.random.default_rng(5)
    for i in range(N - 8):
        labels = {"tier": ("web", "db", "cache")[i % 3], "disk": ("ssd", "hdd")[i % 2],
                  "gen": str(100_000_000 + i * 7_919)}
        if i % 4 == 0:
            labels["gpu"] = "true"
        host.upsert(NodeInfo(f"node-{i}", cpu_milli=int(rng.integers(500, 8000)),
                             mem_kib=int(rng.integers(1 << 20, 16 << 20)), pods=8,
                             labels=labels))
    return spec, host


# Slot dims that fit every selector shape of the mix (the interpreted
# Pallas kernel's time grows with the slot count); the numpy oracle test
# keeps the default PodSpec (36 slots, V=8).
SMALL_AFF = dict(aff_terms=2, aff_exprs=2, aff_values=2, pref_terms=2)


def encode_affinity(host, spec, **dims):
    from k8s1m_tpu_torch.cluster.testbeds import affinity_pods

    enc = PodBatchHost(PodSpec(batch=24, **dims), spec, host.vocab)
    return enc.encode_packed(_to_jax(affinity_pods(21, N)))


AFF_CASES = [
    # (layout, fuse_labels, seed, row_base, col_base, stratum_bits)
    ("plain", True, 99, 0, 0, 0),
    ("plain", True, -41, 7, 900, 11),
    ("packed", True, -(1 << 31), 2, 64, 11),
    ("packed", False, 123, 3, 500, 9),
]


@pytest.mark.parametrize("layout,fuse,seed,row_base,col_base,stratum_bits", AFF_CASES)
def test_affinity_reference_matches_pallas(layout, fuse, seed, row_base, col_base,
                                           stratum_bits):
    spec, host = build_labeled()
    pb = encode_affinity(host, spec, **SMALL_AFF)
    assert {"sel", "req", "pref"} <= pb.groups
    jt = (host.to_device() if layout == "plain"
          else pack_table_host(host, build_packing_spec(spec, host.vocab, fuse_labels=fuse)))
    assert layout == "plain" or jt.spec.fuse_labels == fuse
    jb = unpack_pod_batch(pb.ints, pb.bools, pb.spec, pb.table_spec, pb.groups)
    kw = dict(row_base=row_base, col_base=col_base, stratum_bits=stratum_bits)
    want_i, want_p = pallas_topk.fused_topk(
        jt, jb, jnp.int32(seed), JAX_AFF, chunk=CHUNK, k=K, with_affinity=True,
        interpret=True, **kw)
    got_i, got_p = fused_topk(port_table(jt), port_batch(pb), seed, AFF, k=K,
                              with_affinity=True, **kw)
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    want_p = np.asarray(want_p)
    assert (want_p >= 0).any() and (want_p < 0).any()


@pytest.mark.parametrize("stratum_bits", [0, 11])
def test_affinity_reference_matches_numpy_oracle(stratum_bits):
    spec, host = build_labeled()
    pb = encode_affinity(host, spec)
    jb = unpack_pod_batch(pb.ints, pb.bools, pb.spec, pb.table_spec, pb.groups)
    want_i, want_p = pallas_topk.np_reference_topk(
        host.to_device(), jb, 77, JAX_AFF, k=K, with_affinity=True, stratum_bits=stratum_bits)
    got_i, got_p = fused_topk(port_table(host.to_device()), port_batch(pb), 77, AFF, k=K,
                              with_affinity=True, stratum_bits=stratum_bits)
    np.testing.assert_array_equal(got_p.numpy(), want_p)
    np.testing.assert_array_equal(got_i.numpy(), want_i)


def test_wrapper_requires_stats_with_constraints(rng):
    spec, host = build_host(rng)
    pb = encode(host, spec)
    with pytest.raises(ValueError):
        fused_topk(port_table(host.to_device()), port_batch(pb), 1, Profile(), k=K,
                   constraints=object())


# ---- shapes past the CUDA kernel's fast paths ------------------------------
#
# The Pallas kernel loops over whatever query keys, In/NotIn values,
# preferred terms, taint slots and taint ids it is given; the port's kernel
# takes them too (csrc/fused_topk.cuh spills past its fast paths), and its
# plain version must agree with the Pallas kernel at each WIDE_SWEEP point.
# Slot dims aff_terms = aff_exprs = 2 keep the interpreted kernel's time
# down (it unrolls one evaluation per selector slot).

WIDE_N = 256


def _wide_state(shape, layout="plain"):
    from k8s1m_tpu_torch.cluster.testbeds import wide_fleet, wide_pods

    q, v, p, ts, m = shape
    spec = TableSpec(max_nodes=WIDE_N, taint_slots=ts, max_taint_ids=m)
    host = wide_fleet(NodeTableHost(spec), seed=ts + m)
    pods = _to_jax(wide_pods(21, query_keys=q, values=v, pref_terms=p, max_taint_ids=m,
                             seed=q))
    pb = PodBatchHost(PodSpec(batch=24, query_keys=q, aff_values=v, pref_terms=p,
                              aff_terms=2, aff_exprs=2), spec, host.vocab).encode_packed(pods)
    return jax_tables(spec, host, layout), pb


def _wide_cases():
    from k8s1m_tpu_torch.cluster.testbeds import WIDE_SWEEP

    cases = [("plain", s) for s in WIDE_SWEEP]
    cases += [("packed", (80, 8, 4, 8, 128)), ("packed", (16, 8, 4, 8, 1024))]
    return cases


@pytest.mark.parametrize("layout,shape", _wide_cases(),
                         ids=lambda x: x if isinstance(x, str) else "q{}-v{}-p{}-ts{}-m{}".format(*x))
def test_wide_shapes_reference_matches_pallas(layout, shape):
    jt, pb = _wide_state(shape, layout)
    jb = unpack_pod_batch(pb.ints, pb.bools, pb.spec, pb.table_spec, pb.groups)
    kw = dict(stratum_bits=5, row_base=1, col_base=9)
    want_i, want_p = pallas_topk.fused_topk(
        jt, jb, jnp.int32(77), JAX_AFF, chunk=WIDE_N, k=K, with_affinity=True,
        interpret=True, **kw)
    got_i, got_p = fused_topk(port_table(jt), port_batch(pb), 77, AFF, k=K,
                              with_affinity=True, **kw)
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    want_p = np.asarray(want_p)
    assert (want_p >= 0).any() and (want_p < 0).any()


class _FakeEntry:
    """Stands in for the CUDA entry point: records the argument arrays."""

    def __init__(self):
        self.calls = []

    def __call__(self, ptrs, n_ptrs, ints, n_ints, stream):
        self.calls.append((list(ptrs), list(ints)))
        return 0


@pytest.mark.parametrize("shape", [(1024, 32, 16, 32, 1024), (80, 9, 5, 8, 129)],
                         ids=lambda s: "q{}-v{}-p{}-ts{}-m{}".format(*s))
def test_launch_arguments_take_wide_shapes(monkeypatch, shape):
    """The wrapper's argument assembly (checks, group key and order, the
    pointer and integer arrays) takes the wide shapes it used to refuse,
    on both stages; the ctypes call is intercepted, so this runs on CPU
    tensors."""
    import contextlib
    import types as _types

    import torch

    from k8s1m_tpu_torch.ops import fused_topk as ft

    fake = _FakeEntry()
    monkeypatch.setattr(ft, "_kernel_entry", lambda: fake)
    monkeypatch.setattr(ft, "_resident_blocks", lambda *a: 8)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: _types.SimpleNamespace(multi_processor_count=132))
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: _types.SimpleNamespace(cuda_stream=0))
    q, v, p, ts, m = shape
    jt, pb = _wide_state(shape)
    table, batch = port_table(jt), port_batch(pb)
    for with_aff in (False, True):
        before = dict(ft.fused_topk.launches_by_stage)
        run, (idx, prio) = ft.prepare_launch(table, batch, 5, AFF, k=K,
                                             with_affinity=with_aff)
        run()
        stage = "aff" if with_aff else "base"
        assert ft.fused_topk.launches_by_stage[stage] == before[stage] + 1
        ptrs, ints = fake.calls[-1]
        iv = dict(zip(ft._INTS, ints))
        assert (iv["ts"], iv["m"], iv["taint_bytes"]) == (ts, m, 4)
        if with_aff:
            assert (iv["q"], iv["v"], iv["p"]) == (q, v, p)
        assert len(ptrs) == len(ft._PTRS) and idx.shape == (24, K)
        key = ft.group_key(batch, with_affinity=with_aff)
        assert iv["kw"] == key.shape[1]
        order = ft.group_order(key)
        assert sorted(order.tolist()) == list(range(24))
