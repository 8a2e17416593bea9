"""The port's standalone filter and score plugins vs the JAX package's XLA
path, and the host/device helpers the deltasched slice adds.

``k8s1m_tpu_torch.plugins.registry.score_and_filter`` (and each filter and
score on its own) against ``k8s1m_tpu.plugins.registry.score_and_filter``
on the same fleet, plain and packed layout (for packed, JAX's
``unpack_chunk`` and the port's decode the table first).  The fleets carry
hard and soft taints with tolerating pods, invalid rows, near-full nodes,
``mem_alloc``/``mem_req`` above 2^24 that are not multiples of a power of
two (so the XLA expression order is what is tested), label selectors of
every op and preferred terms.  Also ``class_key``, ``scatter_rows`` /
``apply_delta`` and ``RowVersions`` against JAX.  Inputs come from numpy
with a seed.  Tolerance: exact equality (bool masks, integer scores).
"""

import _torch_cpu  # noqa: F401  (bounds torch's CPU threads first)

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s1m_tpu.config import (
    EFFECT_NO_EXECUTE,
    EFFECT_NO_SCHEDULE,
    EFFECT_PREFER_NO_SCHEDULE,
    SEL_OP_DOES_NOT_EXIST,
    SEL_OP_EXISTS,
    SEL_OP_GT,
    SEL_OP_IN,
    SEL_OP_LT,
    SEL_OP_NOT_IN,
    PodSpec,
    TableSpec,
)
from k8s1m_tpu.ops.label_match import resolve_query_keys as jax_resolve
from k8s1m_tpu.ops.priority import class_key as jax_class_key
from k8s1m_tpu.plugins import filters as jf
from k8s1m_tpu.plugins import scores as js
from k8s1m_tpu.plugins.registry import Profile as JaxProfile
from k8s1m_tpu.plugins.registry import score_and_filter as jax_score_and_filter
from k8s1m_tpu.snapshot import node_table as jnt
from k8s1m_tpu.snapshot.node_table import NodeInfo, NodeTableHost, Taint
from k8s1m_tpu.snapshot.packing import build_packing_spec, pack_table_host
from k8s1m_tpu.snapshot.packing import unpack_chunk as jax_unpack_chunk
from k8s1m_tpu.snapshot.pod_encoding import (
    NodeSelectorTerm,
    PodBatchHost,
    PodInfo,
    PreferredSchedulingTerm,
    SelectorRequirement,
    Toleration,
    unpack_pod_batch,
)
from k8s1m_tpu_torch import interop
from k8s1m_tpu_torch.ops.priority import class_key
from k8s1m_tpu_torch.ops.label_match import resolve_query_keys
from k8s1m_tpu_torch.plugins import filters, scores
from k8s1m_tpu_torch.plugins.registry import Profile, default_profile, score_and_filter
from k8s1m_tpu_torch.snapshot import node_table as tnt
from k8s1m_tpu_torch.snapshot.packing import is_packed, unpack_chunk

N = 192
B = 24
BIG = 1 << 24


def build_fleet(rng):
    """Taints of every effect, labels (a numeric one), invalid tail rows,
    near-full nodes and memory columns beyond 2^24, not powers of two."""
    spec = TableSpec(max_nodes=N, max_taint_ids=16)
    host = NodeTableHost(spec)
    live = N - 12
    for i in range(live):
        taints = []
        if i % 5 == 0:
            taints.append(Taint("dedicated", "infra", EFFECT_NO_SCHEDULE))
        if i % 7 == 0:
            taints.append(Taint("flaky", "", EFFECT_PREFER_NO_SCHEDULE))
        if i % 9 == 0:
            taints.append(Taint("slow", "", EFFECT_PREFER_NO_SCHEDULE))
        if i % 11 == 0:
            taints.append(Taint("evict", "now", EFFECT_NO_EXECUTE))
        labels = {"tier": ("web", "db", "cache")[i % 3], "zone": f"z{i % 4}"}
        if i % 2:
            labels["gen"] = str(int(rng.integers(0, 40)))
        if i % 6 == 0:
            labels["gpu"] = "yes"
        host.upsert(NodeInfo(
            f"node-{i}",
            cpu_milli=int(rng.integers(500, 9000)),
            mem_kib=int(rng.integers(BIG + 1, 1 << 30)) | 1,
            pods=int(rng.integers(1, 12)),
            labels=labels, taints=taints,
        ))
    rows = np.arange(live)
    some = rows[::2]
    host.cpu_req[some] = rng.integers(0, 3000, size=len(some))
    host.mem_req[some] = rng.integers(BIG + 1, 1 << 29, size=len(some)) | 3
    full = rows[rows % 13 == 4]                       # near-full: no pod slot left
    host.pods_req[full] = host.pods_alloc[full]
    host.valid[live - 3:live] = False                 # invalidated live rows too
    assert (host.mem_alloc[:live].astype(np.float32).astype(np.int64)
            != host.mem_alloc[:live]).any()
    return spec, host


def _req(key, op, values=()):
    return SelectorRequirement(key, op, list(values))


def encode(spec, host, kind):
    pods = []
    for i in range(B - 3):
        p = PodInfo(f"p{i}", cpu_milli=100 + 173 * (i % 11),
                    mem_kib=BIG // 3 + 7919 * i + (i % 5) * (1 << 25))
        if kind != "plain":
            if i % 2:
                p.tolerations = [Toleration(key="dedicated"), Toleration(key="flaky")]
            if i % 4 == 3:
                p.tolerations.append(Toleration(key="evict"))
        if kind == "selectors":
            if i % 3 == 0:
                p.node_selector = {"tier": ("web", "db")[i % 2]}
            if i % 3 == 1:
                p.required_terms = [
                    NodeSelectorTerm([_req("zone", SEL_OP_IN, ["z1", "z2"]),
                                      _req("gen", SEL_OP_GT, ["12"])]),
                    NodeSelectorTerm([_req("gpu", SEL_OP_EXISTS)]),
                ]
            if i % 4 == 2:
                p.required_terms = [NodeSelectorTerm([
                    _req("tier", SEL_OP_NOT_IN, ["cache"]), _req("gen", SEL_OP_LT, ["30"]),
                    _req("gpu", SEL_OP_DOES_NOT_EXIST)])]
            p.preferred_terms = [
                PreferredSchedulingTerm(1 + i % 5, NodeSelectorTerm([_req("zone", SEL_OP_IN,
                                                                           ["z0"])])),
                PreferredSchedulingTerm(3, NodeSelectorTerm([_req("tier", SEL_OP_IN, ["db"])])),
            ][: i % 3]
        if i == 6:
            p.node_name = "node-17"
        pods.append(p)
    pspec = PodSpec(batch=B, aff_terms=2, aff_exprs=3, aff_values=2, pref_terms=2)
    return PodBatchHost(pspec, spec, host.vocab).encode_packed(pods)


@pytest.fixture(scope="module", params=["plain", "tolerating", "selectors"])
def state(request):
    spec, host = build_fleet(np.random.default_rng(3))
    pb = encode(spec, host, request.param)
    return spec, host, pb


def _tables(spec, host, layout):
    """(JAX plain-layout table, port plain-layout table) of one layout."""
    jt = host.to_device() if layout == "plain" else pack_table_host(
        host, build_packing_spec(spec, host.vocab))
    cols = {f.name: np.asarray(getattr(jt, f.name))
            for f in dataclasses.fields(jt) if f.name != "spec"}
    tt = interop.node_table_from_numpy(cols, getattr(jt, "spec", None), "cpu")
    assert is_packed(tt) == (layout == "packed")
    if layout == "packed":
        return jax_unpack_chunk(jt), unpack_chunk(tt)
    return jt, tt


def _batches(pb):
    jb = unpack_pod_batch(pb.ints, pb.bools, pb.spec, pb.table_spec, pb.groups)
    tb = interop.pod_batch_from_packed(pb.ints, pb.bools, pb.spec, pb.table_spec, pb.groups,
                                       "cpu")
    return jb, tb


def _eq(port, ref, what):
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref), err_msg=what)


PROFILES = [
    (JaxProfile(topology_spread=0, interpod_affinity=0),
     Profile(topology_spread=0, interpod_affinity=0)),
    (JaxProfile(least_allocated=3, balanced_allocation=0, taint_toleration=1, node_affinity=5),
     Profile(least_allocated=3, balanced_allocation=0, taint_toleration=1, node_affinity=5)),
]


@pytest.mark.parametrize("layout", ["plain", "packed"])
@pytest.mark.parametrize("prof", range(len(PROFILES)))
def test_score_and_filter_matches_jax(state, layout, prof):
    spec, host, pb = state
    jt, tt = _tables(spec, host, layout)
    jb, tb = _batches(pb)
    jprof, tprof = PROFILES[prof]
    jmask, jscore = jax_score_and_filter(jt, jb, jprof)
    for groups in (pb.groups, None):       # the absent-group skip changes nothing
        mask, score = score_and_filter(tt, tb, tprof, groups=groups)
        _eq(mask, jmask, f"mask groups={groups}")
        _eq(score, jscore, f"score groups={groups}")
    assert bool(mask.any()) and not bool(mask.all())
    assert default_profile() == Profile()


@pytest.mark.parametrize("layout", ["plain", "packed"])
def test_each_plugin_matches_jax(state, layout):
    spec, host, pb = state
    jt, tt = _tables(spec, host, layout)
    jb, tb = _batches(pb)
    jres = jax_resolve(jt.label_key, jt.label_val, jt.label_num, jb.qkey)
    tres = resolve_query_keys(tt.label_key, tt.label_val, tt.label_num, tb.qkey)
    _eq(filters.fits_resources(tt, tb), jf.fits_resources(jt, jb), "fits_resources")
    _eq(filters.node_name(tt, tb), jf.node_name(jt, jb), "node_name")
    _eq(filters.tolerates_taints(tt, tb, pb.groups), jf.tolerates_taints(jt, jb), "taints")
    _eq(filters.tolerates_taints(tt, tb), jf.tolerates_taints(jt, jb), "taints, no skip")
    _eq(filters.node_affinity(tb, tres), jf.node_affinity(jt, jb, jres), "node_affinity")
    _eq(filters.feasible_mask(tt, tb, tres, pb.groups), jf.feasible_mask(jt, jb, jres),
        "feasible_mask")
    for name in ("least_allocated", "balanced_allocation", "taint_toleration"):
        _eq(getattr(scores, name)(tt, tb), getattr(js, name)(jt, jb), name)
    _eq(scores.node_affinity_score(tb, tres), js.node_affinity_score(jt, jb, jres),
        "node_affinity_score")


def test_least_allocated_follows_xla_order():
    """The XLA order (int32 subtraction, then f32) is not the kernel's
    (f32 subtraction): on memory columns beyond 2^24 the port's plugin
    matches the JAX XLA plugin, including where the two orders differ."""
    spec, host = build_fleet(np.random.default_rng(3))
    pb = encode(spec, host, "plain")
    jt, tt = _tables(spec, host, "plain")
    jb, tb = _batches(pb)
    got = scores.least_allocated(tt, tb)
    _eq(got, js.least_allocated(jt, jb), "least_allocated")
    mem_after = (tt.mem_req[None, :] + tb.mem[:, None]).to(torch.float32)
    alloc = tt.mem_alloc.clamp(min=1).to(torch.float32)[None, :]
    pallas_order = (alloc - mem_after) / alloc
    xla_order = (tt.mem_alloc.clamp(min=1)[None, :]
                 - (tt.mem_req[None, :] + tb.mem[:, None])).to(torch.float32) / alloc
    assert bool((pallas_order != xla_order).any())


@pytest.mark.parametrize("bits", [0, 1, 8, 11, 20])
def test_class_key_matches_jax(bits):
    rng = np.random.default_rng(bits)
    sc = rng.integers(-5000, 5000, (6, 300)).astype(np.int32)
    cols = rng.integers(0, 1 << 31, (1, 300)).astype(np.int32)
    got = class_key(torch.from_numpy(sc), torch.from_numpy(cols), bits)
    _eq(got, jax_class_key(jnp.asarray(sc), jnp.asarray(cols), bits), f"bits={bits}")


@pytest.mark.parametrize("layout", ["plain", "packed"])
def test_scatter_rows_and_apply_delta_match_jax(layout):
    spec, host = build_fleet(np.random.default_rng(5))
    jt, tt = _tables(spec, host, "plain")
    if layout == "packed":
        jt = pack_table_host(host, build_packing_spec(spec, host.vocab))
        cols = {f.name: np.asarray(getattr(jt, f.name))
                for f in dataclasses.fields(jt) if f.name != "spec"}
        tt = interop.node_table_from_numpy(cols, jt.spec, "cpu")
    rng = np.random.default_rng(6)
    rows = rng.choice(N, 9, replace=False).astype(np.int32)
    delta = {"cpu_req": rng.integers(0, 5000, 9).astype(np.int32),
             "mem_req": rng.integers(0, 1 << 30, 9).astype(np.int32)}
    jt = jnt.scatter_rows(jt, jnp.asarray(rows), {k: jnp.asarray(v) for k, v in delta.items()})
    assert tnt.scatter_rows(tt, rows, delta) is tt
    for f in dataclasses.fields(jt):
        if f.name != "spec":
            _eq(getattr(tt, f.name), getattr(jt, f.name), f"scatter_rows {f.name}")
    # A whole-row delta: the first rows of a shuffled copy of the table.
    src = rng.permutation(N)[:5]
    jd = type(jt)(**{f.name: (getattr(jt, f.name) if f.name == "spec"
                              else getattr(jt, f.name)[jnp.asarray(src)])
                     for f in dataclasses.fields(jt)})
    td = dataclasses.replace(tt, **{f.name: getattr(tt, f.name)[torch.from_numpy(src)]
                                    for f in dataclasses.fields(tt) if f.name != "spec"})
    dst = rng.choice(N, 5, replace=False).astype(np.int32)
    jt = jnt.apply_delta(jt, jnp.asarray(dst), jd) if layout == "plain" else jt.replace(**{
        f.name: getattr(jt, f.name).at[jnp.asarray(dst)].set(getattr(jd, f.name))
        for f in dataclasses.fields(jt) if f.name != "spec"})
    tnt.apply_delta(tt, torch.from_numpy(dst), td)
    for f in dataclasses.fields(jt):
        if f.name != "spec":
            _eq(getattr(tt, f.name), getattr(jt, f.name), f"apply_delta {f.name}")
    assert tnt.ALL_COLUMNS == jnt.ALL_COLUMNS and tnt.CAP_COLUMNS == jnt.CAP_COLUMNS


def test_row_versions_match_jax():
    """One random sequence of notes, compactions and releases through both
    journals: versions, floors, lengths and every rows_since agree."""
    rng = np.random.default_rng(11)
    jr, tr = jnt.RowVersions(cap=24), tnt.RowVersions(cap=24)
    for step in range(60):
        op = rng.integers(0, 6)
        if op < 4:
            rows = rng.integers(0, 50, rng.integers(0, 7)).tolist()
            assert jr.note(rows) == tr.note(rows)
        elif op == 4:
            v = int(rng.integers(0, jr.ver + 2))
            jr.release(v)
            tr.release(v)
        else:
            keep = int(rng.integers(0, 20))
            jr.compact(keep)
            tr.compact(keep)
        assert (jr.ver, jr.floor, len(jr)) == (tr.ver, tr.floor, len(tr)), step
        for v in range(0, jr.ver + 1):
            assert jr.rows_since(v) == tr.rows_since(v), (step, v)
