"""The port's constraint state and constraint stage vs the JAX package's.

- ``empty_constraints``, ``commit_constraint_binds`` (commit and roll
  back, hostname/zone/region refs, unbound pods) and ``slice_constraints``
  against ``k8s1m_tpu.snapshot.constraints``; the port commits in place;
- ``topology.prologue`` against ``k8s1m_tpu.plugins.topology.prologue``,
  on the plain table and through the packed table's ``domain_view``;
- the plain version of the kernel with ``constraints``/``stats`` against
  the JAX ``fused_topk`` in interpret mode (both layouts, a window view
  whose count columns are not contiguous, a wave that also carries
  NodeAffinity terms), and against ``score_and_filter`` on feasible set
  and integer scores (tests/test_pallas_topk.py:417-448).

State is built with the JAX package's classes from numpy seeds and crosses
over through ``k8s1m_tpu_torch.interop``.  Tolerance: exact equality.
"""

import _torch_cpu  # noqa: F401  (bounds torch's CPU threads first)

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s1m_tpu.config import PodSpec, TableSpec
from k8s1m_tpu.ops import pallas_topk
from k8s1m_tpu.plugins.registry import Profile as JaxProfile
from k8s1m_tpu.snapshot import constraints as jcons_mod
from k8s1m_tpu.snapshot.node_table import NodeInfo, NodeTableHost
from k8s1m_tpu.snapshot.packing import build_packing_spec, pack_table_host
from k8s1m_tpu.snapshot.pod_encoding import PodBatchHost, unpack_pod_batch
from k8s1m_tpu_torch import interop
from k8s1m_tpu_torch.config import TableSpec as PortTableSpec
from k8s1m_tpu_torch.ops.fused_topk import fused_topk
from k8s1m_tpu_torch.plugins import topology as ttopo
from k8s1m_tpu_torch.plugins.registry import Profile
from k8s1m_tpu_torch.snapshot import constraints as tcons_mod
from k8s1m_tpu_torch.snapshot.constraints import FIELDS

N = 256
CHUNK = 128
K = 4


def port_table(jt):
    cols = {
        f.name: np.asarray(getattr(jt, f.name))
        for f in dataclasses.fields(jt) if f.name != "spec"
    }
    return interop.node_table_from_numpy(cols, getattr(jt, "spec", None), "cpu")


def port_batch(pb):
    return interop.pod_batch_from_packed(
        pb.ints, pb.bools, pb.spec, pb.table_spec, pb.groups, "cpu"
    )


def port_constraints(cons):
    return interop.constraints_from_numpy(
        {f: np.asarray(getattr(cons, f)) for f in FIELDS}, "cpu")


def assert_state_equal(got, want):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)


def jax_tables(spec, host, layout):
    if layout == "plain":
        return host.to_device()
    return pack_table_host(host, build_packing_spec(spec, host.vocab))


# ---- the constraint stage ---------------------------------------------------


@functools.lru_cache(maxsize=2)
def build_constrained(with_selectors=False):
    """JAX-package state: a fleet with missing zone/region labels, count
    tables from one XLA wave, and a constrained batch (test_pallas_topk
    build_cons / _populate_counts)."""
    from k8s1m_tpu.cluster.workload import affinity_deployment, spread_deployment
    from k8s1m_tpu.config import SEL_OP_NOT_IN, TOPO_REGION, TOPO_ZONE
    from k8s1m_tpu.engine.cycle import schedule_batch
    from k8s1m_tpu.snapshot.constraints import ConstraintTracker, empty_constraints
    from k8s1m_tpu.snapshot.node_table import REGION_LABEL, ZONE_LABEL
    from k8s1m_tpu.snapshot.pod_encoding import NodeSelectorTerm, SelectorRequirement

    spec = TableSpec(max_nodes=N, max_zones=8, max_regions=4, spread_slots=8,
                     affinity_slots=8)
    host = NodeTableHost(spec)
    for i in range(N):
        labels = {}
        if i % 11 != 7:
            labels[ZONE_LABEL] = f"z{i % 5}"
        if i % 13 != 5:
            labels[REGION_LABEL] = f"r{i % 3}"
        host.upsert(NodeInfo(name=f"n{i}", cpu_milli=64_000, mem_kib=1 << 26, pods=64,
                             labels=labels))
    tracker = ConstraintTracker(spec)
    pods = (
        spread_deployment(tracker, "sp-z", 6, topo=TOPO_ZONE)
        + spread_deployment(tracker, "sp-r", 4, topo=TOPO_REGION, max_skew=2)
        + affinity_deployment(tracker, "aff", 4, anti=False, required=True)
        + affinity_deployment(tracker, "anti", 6, anti=True, required=True)
        + affinity_deployment(tracker, "pref", 4, required=False, weight=3)
    )
    np.random.default_rng(0).shuffle(pods)
    if with_selectors:
        for i, p in enumerate(pods):
            if i % 3 == 0:
                p.required_terms = [NodeSelectorTerm([
                    SelectorRequirement(ZONE_LABEL, SEL_OP_NOT_IN, ["z1"])])]
    # One ref slot of each kind fits this mix (the interpreted Pallas
    # kernel's time grows with the ref slots); the card tests and
    # chip_smoke.py run the default four.
    enc = PodBatchHost(PodSpec(batch=16, spread_refs=1, affinity_refs=1, spread_incs=1,
                               ipa_incs=1), spec, host.vocab)
    table = host.to_device()
    _t, cons, _a = schedule_batch(
        table, enc.encode(pods[:12]), jax.random.key(11), profile=JaxProfile(),
        constraints=empty_constraints(spec), chunk=CHUNK, k=K, backend="xla",
    )
    return spec, host, enc.encode_packed(pods[12:]), cons


def port_constraints(cons):
    from k8s1m_tpu_torch.snapshot.constraints import FIELDS

    return interop.constraints_from_numpy(
        {f: np.asarray(getattr(cons, f)) for f in FIELDS}, "cpu")


@pytest.mark.parametrize("layout,window,with_selectors", [
    ("plain", False, False), ("packed", False, False),
    ("plain", True, True), ("packed", True, True),
])
def test_constraint_reference_matches_pallas(layout, window, with_selectors):
    from k8s1m_tpu.plugins import topology as jtopo
    from k8s1m_tpu.snapshot.constraints import slice_constraints as jslice

    from k8s1m_tpu_torch.engine.cycle import _prologue_stats
    from k8s1m_tpu_torch.snapshot.constraints import slice_constraints

    spec, host, pb, jcons = build_constrained(with_selectors)
    aff = bool(pb.groups & {"sel", "req", "pref"})
    assert aff == with_selectors
    jt = jax_tables(spec, host, layout)
    jstats = jtopo.prologue(host.to_device(), jcons)
    table, cons = port_table(jt), port_constraints(jcons)
    stats = _prologue_stats(table, cons)
    off, rows = (128, 128) if window else (0, N)
    jview = jax.tree.map(lambda a: a[off:off + rows], jt)
    view = table.narrow(off, rows)
    vcons = slice_constraints(cons, off, rows)
    assert window == (not vcons.tgt_node.is_contiguous())
    jb = unpack_pod_batch(pb.ints, pb.bools, pb.spec, pb.table_spec, pb.groups)
    want_i, want_p = pallas_topk.fused_topk(
        jview, jb, jnp.int32(77), JaxProfile(), chunk=CHUNK, k=K, with_affinity=aff,
        constraints=jslice(jcons, off, rows), stats=jstats, interpret=True, stratum_bits=5)
    got_i, got_p = fused_topk(view, port_batch(pb), 77, Profile(), k=K, with_affinity=aff,
                              constraints=vcons, stats=stats, stratum_bits=5)
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    assert (np.asarray(want_p) >= 0).any()


def test_constraint_reference_matches_xla_feasibility_and_scores():
    """Same feasible set and integer scores as plugins/topology.py on the
    XLA path (tests/test_pallas_topk.py:417-448)."""
    from k8s1m_tpu.plugins import topology as jtopo
    from k8s1m_tpu.plugins.registry import score_and_filter

    from k8s1m_tpu_torch.engine.cycle import _prologue_stats

    spec, host, pb, jcons = build_constrained()
    jt = host.to_device()
    jb = unpack_pod_batch(pb.ints, pb.bools, pb.spec, pb.table_spec, pb.groups)
    jstats = jtopo.prologue(jt, jcons)
    mask, score = score_and_filter(jt, jb, JaxProfile(), jcons, jstats)
    mask = np.asarray(mask & jb.valid[:, None] & jt.valid[None, :])
    score = np.asarray(jnp.where(mask, score, -1))
    table, cons = port_table(jt), port_constraints(jcons)
    idx, prio = fused_topk(table, port_batch(pb), 13, Profile(), k=K, constraints=cons,
                           stats=_prologue_stats(table, cons))
    idx, prio = idx.numpy(), prio.numpy()
    for b in range(jb.batch):
        expect_k = min(K, int(mask[b].sum()))
        assert (prio[b] >= 0).sum() == expect_k, b
        order = np.sort(score[b][mask[b]])[::-1]
        for j in range(expect_k):
            assert mask[b, idx[b, j]], (b, j)
            assert score[b, idx[b, j]] == (prio[b, j] >> 20), (b, j)
        np.testing.assert_array_equal(np.sort(prio[b, :expect_k] >> 20)[::-1],
                                      order[:expect_k])
    assert (mask.sum(1) < N).any()


# ---- state: empty, commit, slice, prologue -----------------------------------


def test_empty_constraints_matches():
    spec = TableSpec(max_nodes=64, max_zones=8, max_regions=4, spread_slots=3,
                     affinity_slots=5)
    got = tcons_mod.empty_constraints(PortTableSpec(**dataclasses.asdict(spec)), "cpu")
    assert_state_equal(got, jcons_mod.empty_constraints(spec))
    assert all(getattr(got, f).dtype == torch.int32 for f in FIELDS)


def _random_counts(rng, spec):
    c, a = spec.spread_slots, spec.affinity_slots
    n, z, r = spec.max_nodes, spec.max_zones, spec.max_regions
    shapes = dict(spread_node=(c, n), spread_zone=(c, z), spread_region=(c, r),
                  tgt_node=(a, n), tgt_zone=(a, z), tgt_region=(a, r),
                  own_node=(a, n), own_zone=(a, z), own_region=(a, r))
    return {f: rng.integers(0, 4, shapes[f]).astype(np.int32) for f in FIELDS}


@pytest.mark.parametrize("sign", [1, -1])
@pytest.mark.parametrize("seed", [0, 1])
def test_commit_constraint_binds_matches(seed, sign):
    rng = np.random.default_rng(seed)
    spec = TableSpec(max_nodes=64, max_zones=8, max_regions=4, spread_slots=3,
                     affinity_slots=5)
    cols = _random_counts(rng, spec)
    b, w = 24, 3
    bound_dom = rng.random(b) < 0.7
    bound_node = bound_dom & (rng.random(b) < 0.8)
    node_row = np.where(bound_node, rng.integers(0, 64, b), 0).astype(np.int32)
    args = [bound_node, bound_dom, node_row,
            rng.integers(0, 8, b).astype(np.int32), rng.integers(0, 4, b).astype(np.int32)]
    for slots in (3, 5, 5):
        args += [rng.random((b, w)) < 0.6, rng.integers(0, slots, (b, w)).astype(np.int32),
                 rng.integers(0, 3, (b, w)).astype(np.int32)]
    want = jcons_mod.commit_constraint_binds(
        jcons_mod.ConstraintState(**{f: jnp.asarray(v) for f, v in cols.items()}),
        *(jnp.asarray(a) for a in args), sign=sign)
    state = interop.constraints_from_numpy(cols, "cpu")
    before = {f: getattr(state, f).data_ptr() for f in FIELDS}
    got = tcons_mod.commit_constraint_binds(
        state, *(torch.from_numpy(np.array(a)) for a in args), sign=sign)
    assert got is state and all(getattr(got, f).data_ptr() == p for f, p in before.items())
    assert_state_equal(got, want)
    assert any(not np.array_equal(np.asarray(getattr(want, f)), cols[f]) for f in FIELDS)


def test_slice_constraints_is_a_column_view():
    rng = np.random.default_rng(3)
    spec = TableSpec(max_nodes=64, max_zones=8, max_regions=4, spread_slots=3,
                     affinity_slots=5)
    cols = _random_counts(rng, spec)
    jstate = jcons_mod.ConstraintState(**{f: jnp.asarray(v) for f, v in cols.items()})
    state = interop.constraints_from_numpy(cols, "cpu")
    got = tcons_mod.slice_constraints(state, 16, 32)
    assert_state_equal(got, jcons_mod.slice_constraints(jstate, 16, 32))
    for f in tcons_mod.NODE_FIELDS:
        view = getattr(got, f)
        assert view.stride() == (64, 1) and not view.is_contiguous()
        assert view.data_ptr() == getattr(state, f).data_ptr() + 16 * 4


@pytest.mark.parametrize("layout", ["plain", "packed"])
@pytest.mark.parametrize("with_selectors", [False, True])
def test_prologue_matches(layout, with_selectors):
    from k8s1m_tpu.engine.cycle import _prologue_stats as jax_prologue

    from k8s1m_tpu_torch.engine.cycle import _prologue_stats

    spec, host, _pb, jcons = build_constrained(with_selectors)
    jt = jax_tables(spec, host, layout)
    want = jax_prologue(jt, jcons)
    got = _prologue_stats(port_table(jt), port_constraints(jcons))
    for f in ("spread_min", "spread_max", "tgt_max", "tgt_total"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)
    assert int(got.tgt_total.sum()) > 0 and int(got.spread_max.max()) > 0


def test_prologue_on_random_counts_and_missing_domains():
    from k8s1m_tpu.plugins import topology as jtopo

    rng = np.random.default_rng(9)
    spec = TableSpec(max_nodes=64, max_zones=8, max_regions=4, spread_slots=3,
                     affinity_slots=5)
    cols = _random_counts(rng, spec)
    valid = rng.random(64) < 0.8
    zone = rng.integers(0, 6, 64).astype(np.int32)       # zones 6, 7 hold no node
    region = rng.integers(0, 3, 64).astype(np.int32)
    from k8s1m_tpu.snapshot.packing import DomainView as JDomainView

    from k8s1m_tpu_torch.snapshot.packing import DomainView

    want = jtopo.prologue(
        JDomainView(valid=jnp.asarray(valid), zone=jnp.asarray(zone), region=jnp.asarray(region)),
        jcons_mod.ConstraintState(**{f: jnp.asarray(v) for f, v in cols.items()}))
    got = ttopo.prologue(
        DomainView(valid=torch.from_numpy(valid), zone=torch.from_numpy(zone),
                   region=torch.from_numpy(region)),
        interop.constraints_from_numpy(cols, "cpu"))
    for f in ("spread_min", "spread_max", "tgt_max", "tgt_total"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)
