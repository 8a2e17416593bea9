"""The port's NodeAffinity building blocks vs the JAX package's.

- ``resolve_query_keys`` and ``match_expressions`` (all six selector ops,
  numerics beyond 2^24, negatives and NO_NUMERIC, invalid slots) against
  ``k8s1m_tpu.ops.label_match`` on random label tables from numpy seeds;
- ``plugins.filters.node_affinity`` and ``plugins.scores.
  node_affinity_score`` against the JAX plugins on an encoded pod batch.

Tolerance: exact equality (masks, integer ids, and f32 scores compared
bit for bit).
"""

import _torch_cpu  # noqa: F401  (bounds torch's CPU threads first)

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s1m_tpu.config import NO_NUMERIC, PodSpec, TableSpec
from k8s1m_tpu.ops import label_match as jlm
from k8s1m_tpu.plugins import filters as jfilters
from k8s1m_tpu.plugins import scores as jscores
from k8s1m_tpu.snapshot.node_table import NodeInfo, NodeTableHost
from k8s1m_tpu.snapshot.pod_encoding import PodBatchHost, unpack_pod_batch
from k8s1m_tpu_torch import interop
from k8s1m_tpu_torch.cluster.testbeds import affinity_pods
from k8s1m_tpu_torch.ops import label_match as tlm
from k8s1m_tpu_torch.plugins import filters as tfilters
from k8s1m_tpu_torch.plugins import scores as tscores
from k8s1m_tpu_torch.snapshot import pod_encoding as tpe

N, L, Q = 96, 6, 10


def _t(a):
    return torch.from_numpy(np.array(a))


def _labels(rng):
    """[N, L] label slots with keys unique per node, some empty slots."""
    keys = np.zeros((N, L), np.int32)
    for i in range(N):
        k = rng.choice(np.arange(1, 13), size=L, replace=False)
        keys[i] = np.where(rng.random(L) < 0.3, 0, k)
    vals = rng.integers(1, 9, (N, L)).astype(np.int32)
    nums = rng.choice(
        np.array([NO_NUMERIC, -7, 0, 3, 1 << 24, (1 << 24) + 1, 2_000_000_001], np.int64),
        (N, L),
    ).astype(np.int32)
    qkey = np.concatenate([[0], rng.integers(1, 15, Q - 1)]).astype(np.int32)
    return keys, vals, nums, qkey


def _resolved(rng):
    keys, vals, nums, qkey = _labels(rng)
    want = jlm.resolve_query_keys(*(jnp.asarray(a) for a in (keys, vals, nums, qkey)))
    got = tlm.resolve_query_keys(*(_t(a) for a in (keys, vals, nums, qkey)))
    return want, got


@pytest.mark.parametrize("seed", [0, 1])
def test_resolve_query_keys_matches(seed):
    want, got = _resolved(np.random.default_rng(seed))
    for f in ("found", "val", "num"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)), f)
    assert got.found.any() and not got.found[0].any()


def test_resolve_takes_the_last_matching_slot():
    """Duplicate keys on a node (the host never writes one): the last
    matching slot wins, as in the Pallas kernel; key 0 never matches."""
    keys = np.array([[3, 5, 3, 0], [0, 0, 0, 0], [5, 3, 5, 3]], np.int32)
    vals = np.array([[1, 2, 3, 4], [9, 9, 9, 9], [5, 6, 7, 8]], np.int32)
    nums = vals * 10
    got = tlm.resolve_query_keys(_t(keys), _t(vals), _t(nums), _t(np.array([0, 3, 5], np.int32)))
    np.testing.assert_array_equal(got.found.numpy(), [[0, 0, 0], [1, 0, 1], [1, 0, 1]])
    np.testing.assert_array_equal(got.val.numpy(), [[0, 0, 0], [3, 0, 8], [2, 0, 7]])
    np.testing.assert_array_equal(got.num.numpy(), [[0, 0, 0], [30, 0, 80], [20, 0, 70]])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_match_expressions_matches(seed):
    rng = np.random.default_rng(seed)
    want_r, got_r = _resolved(rng)
    b, t, e, v = 12, 3, 3, 4
    valid = rng.random((b, t, e)) < 0.7
    valid[0] = False                                   # a pod with no live expression
    qidx = rng.integers(0, Q, (b, t, e)).astype(np.int32)
    op = rng.integers(0, 6, (b, t, e)).astype(np.int32)
    vals = np.where(rng.random((b, t, e, v)) < 0.3, 0, rng.integers(1, 9, (b, t, e, v)))
    num = rng.choice(np.array([NO_NUMERIC, -8, 2, 1 << 24, 2_000_000_000]), (b, t, e))
    args = [valid, qidx, op, vals.astype(np.int32), num.astype(np.int32)]
    want_m, want_h = jlm.match_expressions(want_r, *(jnp.asarray(a) for a in args))
    got_m, got_h = tlm.match_expressions(got_r, *(_t(a) for a in args))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    np.testing.assert_array_equal(got_h.numpy(), np.asarray(want_h))
    assert got_m.any() and not got_m.all()


def _labeled_host(n=128):
    spec = TableSpec(max_nodes=n, max_taint_ids=16)
    host = NodeTableHost(spec)
    for i in range(n - 8):
        labels = {"tier": ("web", "db", "cache")[i % 3], "disk": ("ssd", "hdd")[i % 2],
                  "gen": str(100_000_000 + i * 7_919)}
        if i % 4 == 0:
            labels["gpu"] = "true"
        host.upsert(NodeInfo(f"node-{i}", labels=labels))
    return spec, host


def _jax_infos(infos):
    """The port's PodInfos rebuilt with the JAX package's classes."""
    from k8s1m_tpu.snapshot import pod_encoding as jpe

    def conv(x):
        if isinstance(x, list):
            return [conv(y) for y in x]
        if dataclasses.is_dataclass(x):
            cls = getattr(jpe, type(x).__name__)
            return cls(**{f.name: conv(getattr(x, f.name)) for f in dataclasses.fields(x)})
        return x

    return [conv(p) for p in infos]


@pytest.mark.parametrize("spec_kw", [{}, dict(aff_terms=2, aff_exprs=2, aff_values=2, pref_terms=2)])
def test_node_affinity_plugins_match(spec_kw):
    spec, host = _labeled_host()
    infos = affinity_pods(20, 128)
    if spec_kw:
        infos = [p for p in infos if len(p.required_terms) <= 2 and len(p.node_selector) <= 2]
    pb = PodBatchHost(PodSpec(batch=24, **spec_kw), spec, host.vocab).encode_packed(
        _jax_infos(infos))
    jb = unpack_pod_batch(pb.ints, pb.bools, pb.spec, pb.table_spec, pb.groups)
    tb = interop.pod_batch_from_packed(pb.ints, pb.bools, pb.spec, pb.table_spec, pb.groups,
                                       "cpu")
    assert isinstance(tb, tpe.PodBatch)
    t = host.to_device()
    jres = jlm.resolve_query_keys(t.label_key, t.label_val, t.label_num, jb.qkey)
    tres = tlm.resolve_query_keys(*(_t(np.asarray(a)) for a in (
        t.label_key, t.label_val, t.label_num, jb.qkey)))
    want = np.asarray(jfilters.node_affinity(t, jb, jres))
    got = tfilters.node_affinity(tb, tres).numpy()
    np.testing.assert_array_equal(got, want)
    assert want.any() and not want.all()
    want_s = np.asarray(jscores.node_affinity_score(t, jb, jres))
    got_s = tscores.node_affinity_score(tb, tres).numpy()
    assert got_s.dtype == np.float32
    np.testing.assert_array_equal(got_s.view(np.int32), want_s.view(np.int32))
    assert (want_s > 0).any()
