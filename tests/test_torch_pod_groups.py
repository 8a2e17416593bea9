"""The pod groups the fused kernel rests on, on the CPU.

The CUDA kernel (``csrc/fused_topk.cuh``) runs the filter and score chain
once per (pod group, row) and broadcasts it to the group's pods, which
differ only in their row hash.  Two things make that exact:

- ``group_key`` holds every per-pod input the launched stages read, so
  pods that differ in any one of them get different key rows, and pods
  equal in all of them get equal rows;
- scoring one representative per group, broadcasting by group and xoring
  each pod's row hash gives the plain version's result, and the JAX
  package's (Pallas in interpret mode, as its own tests run it), for
  equal pods, all-distinct pods, a three-group mix and a window that
  starts at an unaligned row.

Inputs are built with the JAX package's host classes from fixed seeds and
cross over through ``k8s1m_tpu_torch.interop``.  Tolerance: exact equality
(integer outputs).
"""

import _torch_cpu  # noqa: F401  (bounds torch's CPU threads first)

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s1m_tpu.config import EFFECT_NO_SCHEDULE, PodSpec, TableSpec
from k8s1m_tpu.ops import pallas_topk
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
from k8s1m_tpu_torch.engine.cycle import _prologue_stats
from k8s1m_tpu_torch.ops.fused_topk import (
    _cons_pod_inputs,
    fused_topk,
    fused_topk_reference,
    group_key,
    group_order,
    mask_and_score,
)
from k8s1m_tpu_torch.ops.priority import pack_hashed
from k8s1m_tpu_torch.plugins.registry import Profile
from k8s1m_tpu_torch.snapshot.constraints import FIELDS, slice_constraints

N = 256
CHUNK = 128
B = 16
K = 4
_M32 = 0xFFFFFFFF


def port_table(jt):
    cols = {f.name: np.asarray(getattr(jt, f.name))
            for f in dataclasses.fields(jt) if f.name != "spec"}
    return interop.node_table_from_numpy(cols, getattr(jt, "spec", None), "cpu")


def port_batch(pb):
    return interop.pod_batch_from_packed(pb.ints, pb.bools, pb.spec, pb.table_spec, pb.groups,
                                         "cpu")


def take_pods(batch, idx):
    """The batch of pods ``idx`` (``qkey`` is the batch's own)."""
    fields = {f.name: getattr(batch, f.name) for f in dataclasses.fields(batch)}
    return type(batch)(**{n: t if n == "qkey" else t[idx].contiguous()
                          for n, t in fields.items()})


# ---- 1. the key rows ---------------------------------------------------------

BASE_FIELDS = ("valid", "cpu", "mem", "node_name_id", "tolerated")
AFF_FIELDS = ("sel_valid", "sel_qidx", "sel_val", "req_term_valid", "req_expr_valid",
              "req_qidx", "req_op", "req_num", "req_vals", "pref_term_valid", "pref_weight",
              "pref_expr_valid", "pref_qidx", "pref_op", "pref_num", "pref_vals")
# The constraint stage's per-pod records (fields x refs x pods) and cs.
CONS_FIELDS = (tuple(("sp", f) for f in range(8)) + tuple(("ia", f) for f in range(6))
               + tuple(("ii", f) for f in range(3)) + tuple(("cs", f) for f in range(3)))


def _key_cases():
    for stage in ("base", "aff", "cons", "aff+cons"):
        fields = list(BASE_FIELDS)
        if "aff" in stage:
            fields += AFF_FIELDS
        if "cons" in stage:
            fields += CONS_FIELDS
        for field in fields:
            yield stage, field


@functools.lru_cache(maxsize=1)
def _two_pods():
    """Two copies of one pod, with every selector and ref slot present."""
    spec = TableSpec(max_nodes=64, max_taint_ids=16)
    host = NodeTableHost(spec)
    host.upsert(NodeInfo("n0", cpu_milli=1000, mem_kib=1 << 20, pods=8))
    enc = PodBatchHost(PodSpec(batch=2, aff_terms=2, aff_exprs=2, aff_values=2, pref_terms=2,
                               spread_refs=1, affinity_refs=1, spread_incs=1, ipa_incs=1),
                       spec, host.vocab)
    pb = enc.encode_packed([PodInfo("a", cpu_milli=100, mem_kib=1 << 10)] * 2)
    return port_batch(pb)


@pytest.mark.parametrize("stage,field", list(_key_cases()))
def test_group_key_separates_each_input(stage, field):
    batch = _two_pods()
    with_aff = "aff" in stage
    cons = None
    if "cons" in stage:
        recs = {f: torch.zeros((n, 1, 2), dtype=torch.int32) for f, n in
                (("sp", 8), ("ia", 6), ("ii", 3))}
        cons = dict(recs, cs=torch.ones((3, 2), dtype=torch.int32))
    key = group_key(batch, with_affinity=with_aff, cons_inputs=cons)
    assert torch.equal(key[0], key[1])                 # equal inputs, equal rows
    if isinstance(field, tuple):
        rec, f = field
        cons = {name: t.clone() for name, t in cons.items()}
        if rec == "cs":
            cons[rec][f, 1] += 1
        else:
            cons[rec][f, 0, 1] += 1
    else:
        batch = dataclasses.replace(batch, **{field: getattr(batch, field).clone()})
        col = getattr(batch, field)[1].view(-1)
        col[0] = ~col[0] if col.dtype == torch.bool else col[0] + 1
    key = group_key(batch, with_affinity=with_aff, cons_inputs=cons)
    assert not torch.equal(key[0], key[1])
    order = group_order(key)
    assert sorted(order.tolist()) == [0, 1]


# ---- 2. one score per group ----------------------------------------------------


def decomposed_topk(table, batch, seed, profile, *, k, row_base=0, col_base=0,
                    stratum_bits=0, with_affinity=False, constraints=None, stats=None):
    """Score one representative per group (``torch.unique`` over the key
    rows), broadcast by group, xor each pod's row hash (``pack_hashed``),
    keep the top K by (priority, earlier row)."""
    cons_in = _cons_pod_inputs(batch, stats) if constraints is not None else None
    key = group_key(batch, with_affinity=with_affinity, cons_inputs=cons_in)
    _u, inv = torch.unique(key, dim=0, return_inverse=True)
    pos = torch.arange(key.shape[0])
    reps = torch.full((int(inv.max()) + 1,), key.shape[0]).scatter_reduce(0, inv, pos, "amin")
    n = table.num_rows
    mask, score = mask_and_score(table, take_pods(batch, reps), profile, 0, n,
                                 with_affinity=with_affinity, constraints=constraints,
                                 stats=stats)
    rows = torch.arange(batch.batch, dtype=torch.int64)[:, None] + row_base
    cols = torch.arange(n, dtype=torch.int64)
    prio = pack_hashed(score[inv], seed, mask[inv], rows, (cols + col_base)[None],
                       stratum_bits)
    top = torch.topk((prio.to(torch.int64) << 32) + (_M32 - cols)[None], k, dim=1).values
    p = (top >> 32).to(torch.int32)
    r = (_M32 - (top & _M32)).to(torch.int32)
    return torch.where(p >= 0, r, torch.full_like(r, -1)), p, inv


def _templates(stage):
    """Three distinct pod templates of the stage, and its fleet."""
    from k8s1m_tpu.snapshot.pod_encoding import (
        NodeSelectorTerm,
        PreferredSchedulingTerm,
        SelectorRequirement,
    )

    if stage != "cons":
        spec = TableSpec(max_nodes=N, max_taint_ids=16)
        host = NodeTableHost(spec)
        rng = np.random.default_rng(3)
        for i in range(N - 8):
            host.upsert(NodeInfo(
                f"node-{i}", cpu_milli=int(rng.integers(500, 8000)),
                mem_kib=int(rng.integers(1 << 20, 16 << 20)), pods=int(rng.integers(1, 16)),
                labels={"tier": ("web", "db", "cache")[i % 3], "disk": ("ssd", "hdd")[i % 2]},
                taints=[Taint("dedicated", "x", EFFECT_NO_SCHEDULE)] if i % 5 == 0 else []))
        if stage == "base":
            return spec, host, None, [
                PodInfo("t0", cpu_milli=100, mem_kib=100 << 10),
                PodInfo("t1", cpu_milli=300, mem_kib=50 << 10,
                        tolerations=[Toleration(key="dedicated")]),
                PodInfo("t2", cpu_milli=100, mem_kib=100 << 10, node_name="node-17"),
            ]

        def term(op, key, vals):
            return [NodeSelectorTerm([SelectorRequirement(key, op, vals)])]
        return spec, host, None, [
            PodInfo("t0", cpu_milli=100, mem_kib=1 << 10, node_selector={"disk": "ssd"}),
            PodInfo("t1", cpu_milli=100, mem_kib=1 << 10, required_terms=term(0, "tier", ["db"])),
            PodInfo("t2", cpu_milli=100, mem_kib=1 << 10, preferred_terms=[
                PreferredSchedulingTerm(3, term(1, "tier", ["web"])[0])]),
        ]
    from k8s1m_tpu.cluster.workload import affinity_deployment, spread_deployment
    from k8s1m_tpu.config import TOPO_ZONE
    from k8s1m_tpu.engine.cycle import schedule_batch
    from k8s1m_tpu.snapshot.constraints import ConstraintTracker, empty_constraints
    from k8s1m_tpu.snapshot.node_table import REGION_LABEL, ZONE_LABEL

    spec = TableSpec(max_nodes=N, max_zones=8, max_regions=4, spread_slots=8, affinity_slots=8)
    host = NodeTableHost(spec)
    for i in range(N):
        labels = {ZONE_LABEL: f"z{i % 5}"} if i % 11 != 7 else {}
        labels[REGION_LABEL] = f"r{i % 3}"
        host.upsert(NodeInfo(name=f"n{i}", cpu_milli=64_000, mem_kib=1 << 26, pods=64,
                             labels=labels))
    tracker = ConstraintTracker(spec)
    pods = (spread_deployment(tracker, "sp", 4, topo=TOPO_ZONE)
            + affinity_deployment(tracker, "anti", 4, anti=True, required=True)
            + affinity_deployment(tracker, "pref", 4, required=False, weight=3))
    enc = PodBatchHost(_pod_spec("cons"), spec, host.vocab)
    _t, cons, _a = schedule_batch(
        host.to_device(), enc.encode(pods[:8] + pods[8:10]), jax.random.key(5),
        profile=JaxProfile(), constraints=empty_constraints(spec), chunk=CHUNK, k=K,
        backend="xla")
    return spec, host, cons, [pods[0], pods[4], pods[8]]


def _pod_spec(stage):
    if stage == "aff":
        return PodSpec(batch=B, aff_terms=1, aff_exprs=1, aff_values=2, pref_terms=1)
    if stage == "cons":
        return PodSpec(batch=B, spread_refs=1, affinity_refs=1, spread_incs=1, ipa_incs=1)
    return PodSpec(batch=B)


def _pods(templates, case):
    out = []
    for i in range(B - 2):                              # two padding slots
        t = templates[0] if case == "equal" else templates[i % 3]
        cpu = t.cpu_milli + (7 * i if case == "distinct" else 0)
        out.append(dataclasses.replace(t, name=f"pod-{i}", cpu_milli=cpu))
    return out


CASES = ("equal", "distinct", "mix3", "window")


@pytest.mark.parametrize("stage", ["base", "aff", "cons"])
@pytest.mark.parametrize("case", CASES)
def test_one_score_per_group_matches_plain_and_pallas(stage, case):
    from k8s1m_tpu.plugins import topology as jtopo
    from k8s1m_tpu.snapshot.constraints import slice_constraints as jslice

    spec, host, jcons, templates = _templates(stage)
    pb = PodBatchHost(_pod_spec(stage), spec, host.vocab).encode_packed(
        _pods(templates, "mix3" if case == "window" else case))
    jt = (host.to_device() if stage == "base" else
          pack_table_host(host, build_packing_spec(spec, host.vocab)))
    table, batch = port_table(jt), port_batch(pb)
    off, rows = (37, CHUNK) if case == "window" else (0, N)
    view = table.narrow(off, rows)
    jview = jax.tree.map(lambda a: a[off:off + rows], jt)
    profile = Profile() if stage == "cons" else Profile(topology_spread=0, interpod_affinity=0)
    jprofile = JaxProfile() if stage == "cons" else JaxProfile(topology_spread=0,
                                                                interpod_affinity=0)
    kw = dict(k=K, row_base=5 if case == "window" else 0, col_base=1000 + off,
              stratum_bits=7 if case == "window" else 0, with_affinity=stage == "aff")
    jkw = dict(kw)
    if stage == "cons":
        cons = interop.constraints_from_numpy(
            {f: np.asarray(getattr(jcons, f)) for f in FIELDS}, "cpu")
        kw.update(constraints=slice_constraints(cons, off, rows),
                  stats=_prologue_stats(table, cons))
        jkw.update(constraints=jslice(jcons, off, rows),
                   stats=jtopo.prologue(host.to_device(), jcons))
    idx, prio, inv = decomposed_topk(view, batch, -31337, profile, **kw)
    groups = int(inv[batch.valid].unique().numel())
    assert groups == {"equal": 1, "distinct": B - 2, "mix3": 3, "window": 3}[case]
    want_i, want_p = fused_topk_reference(view, batch, -31337, profile, **kw)
    assert torch.equal(prio, want_p) and torch.equal(idx, want_i)
    got_i, got_p = fused_topk(view, batch, -31337, profile, **kw)
    assert torch.equal(prio, got_p) and torch.equal(idx, got_i)
    jb = unpack_pod_batch(pb.ints, pb.bools, pb.spec, pb.table_spec, pb.groups)
    k = jkw.pop("k")
    pal_i, pal_p = pallas_topk.fused_topk(jview, jb, jnp.int32(-31337), jprofile, chunk=CHUNK,
                                          k=k, interpret=True, **jkw)
    np.testing.assert_array_equal(prio.numpy(), np.asarray(pal_p))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(pal_i))
    assert (np.asarray(pal_p) >= 0).any()
