"""The port's scan backend ("xla") against the JAX package's, on the CPU.

- ``topk_by_argmax`` against ``lax.top_k`` and the port's ``chunk_topk``
  on rows built with ties, every value of k;
- ``filter_score_topk``: all seven Candidates fields against
  ``k8s1m_tpu.engine.cycle.filter_score_topk`` on BASELINE config 1
  (a tainted fleet, tolerating pods), config 2 (NodeAffinity pods) and
  configs 3-4 (spread and (anti-)affinity pods over count tables), both
  table layouts, with ``row_offset``/``pod_offset`` set;
- the unpacked ``schedule_batch`` (Assignment, post-commit request
  columns, the nine count tables) against the JAX one with
  ``backend="xla"``, on both port backends;
- ``schedule_batch_packed``/``schedule_batch_delta`` with ``backend="xla"``
  against ``"pallas"`` (the kernels' plain versions here): the same bound
  rows; delta candidates differ on padding pods at most;
- ``PodBatchHost.encode`` field for field against the JAX encoder and
  against ``unpack_pod_batch(encode_packed(...))``.

State is built with the JAX package's classes from numpy seeds and crosses
over through ``k8s1m_tpu_torch.interop``.  Tolerance: exact equality.
"""

import _torch_cpu  # noqa: F401  (bounds torch's CPU threads first)

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from k8s1m_tpu.cluster import populate_kwok_nodes as jax_populate
from k8s1m_tpu.cluster.workload import (
    affinity_deployment,
    node_affinity_pods,
    spread_deployment,
)
from k8s1m_tpu.config import EFFECT_NO_SCHEDULE, EFFECT_PREFER_NO_SCHEDULE, TOPO_ZONE
from k8s1m_tpu.config import PodSpec as JPodSpec
from k8s1m_tpu.config import TableSpec as JTableSpec
from k8s1m_tpu.engine import cycle as jcycle
from k8s1m_tpu.ops.priority import seed_of
from k8s1m_tpu.plugins.registry import Profile as JProfile
from k8s1m_tpu.snapshot import node_table as jnt
from k8s1m_tpu.snapshot import packing as jpk
from k8s1m_tpu.snapshot import pod_encoding as jpe
from k8s1m_tpu.snapshot.constraints import ConstraintTracker, empty_constraints
from k8s1m_tpu_torch import interop
from k8s1m_tpu_torch.cluster import populate_kwok_nodes, uniform_pods
from k8s1m_tpu_torch.config import PodSpec, TableSpec
from k8s1m_tpu_torch.engine import cycle
from k8s1m_tpu_torch.plugins.registry import Profile
from k8s1m_tpu_torch.snapshot.constraints import FIELDS as CONS_FIELDS
from k8s1m_tpu_torch.snapshot.node_table import NodeTableHost
from k8s1m_tpu_torch.snapshot.pod_encoding import PodBatchHost, unpack_pod_batch

N = 512
CHUNK = 128
B = 64
K = 4
BASE = dict(node_affinity=0, topology_spread=0, interpod_affinity=0)
# The profile each configuration runs, and its name.
PROFILES = {"c1": dict(BASE), "c2": dict(topology_spread=0, interpod_affinity=0), "c34": {}}


# ---- top-k --------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_topk_by_argmax_matches_lax_top_k(seed):
    rng = np.random.default_rng(seed)
    # Few distinct values: every row is full of ties, -1 (infeasible) too.
    prio = rng.choice(np.array([-1, 0, 5, 1 << 20, (1 << 31) - 1], np.int32), size=(24, 40))
    prio[3] = -1
    prio[4] = 7
    t = torch.from_numpy(prio)
    for k in (1, 2, 4, 17, 40):
        want_v, want_i = jax.lax.top_k(jax.numpy.asarray(prio), k)
        got_v, got_i = cycle.topk_by_argmax(t, k)
        ch_v, ch_i = cycle.chunk_topk(t, k)
        for v, i in ((got_v, got_i), (ch_v, ch_i)):
            assert v.dtype == torch.int32 and i.dtype == torch.int32
            np.testing.assert_array_equal(v.numpy(), np.asarray(want_v), err_msg=f"k={k}")
            np.testing.assert_array_equal(i.numpy(), np.asarray(want_i), err_msg=f"k={k}")
    with pytest.raises(ValueError):
        cycle.topk_by_argmax(t, 41)


# ---- state --------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _state(config: str):
    """JAX-package state: (TableSpec, NodeTableHost, PodSpec, pods,
    ConstraintState or None) of one BASELINE configuration."""
    if config == "c34":
        spec = JTableSpec(max_nodes=N, max_zones=16, max_regions=8, spread_slots=8,
                          affinity_slots=8)
    else:
        spec = JTableSpec(max_nodes=N)
    host = jnt.NodeTableHost(spec)
    jax_populate(host, N - 16, zones=8, regions=4, tainted_fraction=0.2, seed=3)
    rng = np.random.default_rng(1)
    live = host.valid
    host.cpu_alloc[:] = np.where(live, rng.integers(300, 1200, N), 0)
    host.pods_alloc[:] = np.where(live, rng.integers(1, 4, N), 0)
    host.taint_effect[::9, 1] = EFFECT_PREFER_NO_SCHEDULE
    host.taint_id[::9, 1] = host.vocab.taints.intern(("soft", "", EFFECT_PREFER_NO_SCHEDULE))
    host.taint_effect[::13, 2] = EFFECT_NO_SCHEDULE
    host.taint_id[::13, 2] = host.vocab.taints.intern(("hard", "", EFFECT_NO_SCHEDULE))
    pspec = JPodSpec(batch=B)
    cons = None
    if config == "c1":
        pods = [
            jpe.PodInfo(f"p{i}", cpu_milli=250 + 10 * (i % 5), mem_kib=200 << 10,
                        tolerations=[jpe.Toleration(key="dedicated")] if i % 3 == 0 else [])
            for i in range(B - 4)
        ]
    elif config == "c2":
        pods = node_affinity_pods(B - 4, zones=8, regions=4, cpu_milli=250)
    else:
        pspec = JPodSpec(batch=B, spread_refs=1, affinity_refs=1, spread_incs=1, ipa_incs=1)
        tracker = ConstraintTracker(spec)
        pods = (spread_deployment(tracker, "spread", 40, topo=TOPO_ZONE, cpu_milli=200)
                + affinity_deployment(tracker, "anti", 40, anti=True, cpu_milli=200))
        np.random.default_rng(2).shuffle(pods)
        # Count tables from one earlier wave.
        enc = jpe.PodBatchHost(pspec, spec, host.vocab)
        _t, cons, _a = jcycle.schedule_batch(
            host.to_device(), enc.encode(pods[:B]), jax.random.key(11),
            profile=JProfile(), constraints=empty_constraints(spec), chunk=CHUNK, k=K,
            backend="xla")
        pods = pods[B:]
    return spec, host, pspec, pods, cons


def _jax_table(spec, host, layout):
    if layout == "plain":
        return host.to_device()
    return jpk.pack_table_host(host, jpk.build_packing_spec(spec, host.vocab))


def _port_table(jt):
    cols = {f.name: np.asarray(getattr(jt, f.name))
            for f in dataclasses.fields(jt) if f.name != "spec"}
    return interop.node_table_from_numpy(cols, getattr(jt, "spec", None), "cpu")


def _port_cons(cons):
    if cons is None:
        return None
    return interop.constraints_from_numpy(
        {f: np.asarray(getattr(cons, f)) for f in CONS_FIELDS}, "cpu")


def _assert_cons_equal(got, want):
    for f in CONS_FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)


CASES = [(c, lay) for c in ("c1", "c2", "c34") for lay in ("plain", "packed")]


# ---- filter_score_topk ----------------------------------------------------------


@pytest.mark.parametrize("config,layout", CASES)
def test_filter_score_topk_matches_jax(config, layout):
    spec, host, pspec, pods, cons = _state(config)
    jt = _jax_table(spec, host, layout)
    pb = jpe.PodBatchHost(pspec, spec, host.vocab).encode_packed(pods)
    jb = jpe.unpack_pod_batch(pb.ints, pb.bools, pb.spec, pb.table_spec, pb.groups)
    key = jax.random.key(5)
    kw = dict(chunk=CHUNK, k=K, row_offset=1024, pod_offset=B, stratum_bits=3)
    want = jcycle.filter_score_topk(jt, jb, key, JProfile(**PROFILES[config]),
                                    constraints=cons, **kw)
    batch = interop.pod_batch_from_packed(pb.ints, pb.bools, pb.spec, pb.table_spec,
                                          pb.groups, "cpu")
    seed = int(np.asarray(seed_of(key)))
    for groups in (None, pb.groups):
        got = cycle.filter_score_topk(_port_table(jt), batch, seed,
                                      Profile(**PROFILES[config]),
                                      constraints=_port_cons(cons), groups=groups, **kw)
        for f in ("idx", "prio", "cpu", "mem", "pods", "zone", "region"):
            np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                          err_msg=f)
    # Both feasible and infeasible candidates occur.
    assert (got.idx >= 1024).any() and (got.idx == -1).any()


# ---- schedule_batch ---------------------------------------------------------------


@pytest.mark.parametrize("config,layout", CASES)
def test_schedule_batch_matches_jax(config, layout):
    spec, host, pspec, pods, cons = _state(config)
    jt = _jax_table(spec, host, layout)
    jenc = jpe.PodBatchHost(pspec, spec, host.vocab)
    key = jax.random.key(9)
    jt2, jcons, jasg = jcycle.schedule_batch(
        jt, jenc.encode(pods), key, profile=JProfile(**PROFILES[config]),
        constraints=None if cons is None else jax.tree.map(jax.numpy.array, cons),
        chunk=CHUNK, k=K, backend="xla")
    pb = jenc.encode_packed(pods)
    for backend in ("xla", "pallas"):
        table = _port_table(jt)
        tcons = _port_cons(cons)
        batch = interop.pod_batch_from_packed(pb.ints, pb.bools, pb.spec, pb.table_spec,
                                              pb.groups, "cpu")
        table, tcons, asg = cycle.schedule_batch(
            table, batch, int(np.asarray(seed_of(key))),
            profile=Profile(**PROFILES[config]), constraints=tcons, chunk=CHUNK, k=K,
            backend=backend, with_affinity=config == "c2")
        for f in ("node_row", "bound", "score", "zone", "region"):
            np.testing.assert_array_equal(getattr(asg, f).numpy(), np.asarray(getattr(jasg, f)),
                                          err_msg=f"{backend} {f}")
        for c in ("cpu_req", "mem_req", "pods_req"):
            np.testing.assert_array_equal(getattr(table, c).numpy(), np.asarray(getattr(jt2, c)),
                                          err_msg=f"{backend} {c}")
        if cons is not None:
            _assert_cons_equal(tcons, jcons)
    bound = np.asarray(jasg.bound)
    assert bound.any() and not bound.all()


def test_schedule_batch_checks_backend():
    spec, host, pspec, pods, _cons = _state("c1")
    table = _port_table(host.to_device())
    enc = jpe.PodBatchHost(pspec, spec, host.vocab).encode_packed(pods)
    batch = interop.pod_batch_from_packed(enc.ints, enc.bools, enc.spec, enc.table_spec,
                                          enc.groups, "cpu")
    with pytest.raises(ValueError):
        cycle.schedule_batch(table, batch, 1, profile=Profile(**BASE), chunk=CHUNK,
                             backend="tpu")
    # The constraint plugins need constraint state on the kernel only.
    with pytest.raises(ValueError):
        cycle.schedule_batch(table, batch, 1, profile=Profile(), chunk=CHUNK)
    cycle.schedule_batch(table, batch, 1, profile=Profile(), chunk=CHUNK, backend="xla")
    assert cycle.resolve_backend("auto", "cpu") == "xla"
    assert cycle.resolve_backend("auto", torch.device("cuda")) == "pallas"


# ---- the packed and delta waves: xla against pallas --------------------------


@pytest.mark.parametrize("config,layout", CASES)
def test_packed_wave_backends_agree(config, layout):
    spec, host, pspec, pods, cons = _state(config)
    jt = _jax_table(spec, host, layout)
    pb = jpe.PodBatchHost(pspec, spec, host.vocab).encode_packed(pods)
    packed = interop.packed_pod_batch(pb.ints, pb.bools, pb.spec, pb.table_spec, pb.groups)
    out = {}
    for backend in ("xla", "pallas"):
        table, tcons = _port_table(jt), _port_cons(cons)
        _t, asg, rows = cycle.schedule_batch_packed(
            table, packed, 123, profile=Profile(**PROFILES[config]), constraints=tcons,
            chunk=CHUNK, k=K, backend=backend, sample_rows=256, sample_offset=128)
        out[backend] = (rows, table, tcons)
    assert torch.equal(out["xla"][0], out["pallas"][0])
    assert torch.equal(out["xla"][1].pods_req, out["pallas"][1].pods_req)
    if cons is not None:
        for f in CONS_FIELDS:
            assert torch.equal(getattr(out["xla"][2], f), getattr(out["pallas"][2], f)), f
    assert (out["xla"][0] >= 0).any()


@pytest.mark.parametrize("config", ["c1", "c2"])
def test_delta_wave_backends_agree(config):
    spec, host, pspec, pods, _cons = _state(config)
    pb = jpe.PodBatchHost(pspec, spec, host.vocab).encode_packed(pods)
    packed = interop.packed_pod_batch(pb.ints, pb.bools, pb.spec, pb.table_spec, pb.groups)
    profile = Profile(**PROFILES[config])
    out = {}
    for backend in ("xla", "pallas"):
        table = _port_table(host.to_device())
        planes = (torch.zeros((B, N), dtype=torch.bool),
                  torch.zeros((B, N), dtype=torch.int32))
        # One slot per pod (the last four are padding: slot S), planes
        # filled for every pod, 16 dirty rows.
        slots = np.full(B, B, np.int32)
        slots[: len(pods)] = np.arange(len(pods))
        planes = cycle.fill_shape_planes(table, packed, slots, planes, profile=profile,
                                         chunk=CHUNK)
        dirty = np.arange(0, N, N // 16, dtype=np.int32)
        _t, asg, rows, planes = cycle.schedule_batch_delta(
            table, packed, 77, profile=profile, slot_ids=slots, planes=planes, dirty=dirty,
            chunk=CHUNK, k=K, backend=backend)
        out[backend] = (rows, table, planes)
    assert torch.equal(out["xla"][0], out["pallas"][0])
    assert torch.equal(out["xla"][1].pods_req, out["pallas"][1].pods_req)
    for a, b in zip(out["xla"][2], out["pallas"][2]):
        assert torch.equal(a, b)
    assert (out["xla"][0] >= 0).any()


# ---- PodBatchHost.encode ----------------------------------------------------------


@pytest.mark.parametrize("config", ["c1", "c2", "c34"])
def test_encode_matches_jax_and_packed(config):
    spec, host, pspec, pods, _cons = _state(config)
    want = jpe.PodBatchHost(pspec, spec, host.vocab).encode(pods)
    # The port's encoder over a host built the same way.
    th = NodeTableHost(TableSpec(**dataclasses.asdict(spec)))
    populate_kwok_nodes(th, N - 16, zones=8, regions=4, tainted_fraction=0.2, seed=3)
    th.vocab.taints.intern(("soft", "", EFFECT_PREFER_NO_SCHEDULE))
    th.vocab.taints.intern(("hard", "", EFFECT_NO_SCHEDULE))
    tenc = PodBatchHost(PodSpec(**dataclasses.asdict(pspec)), th.spec, th.vocab)
    tpods = _port_pods(pods)
    got = tenc.encode(tpods, device="cpu")
    tp = tenc.encode_packed(tpods)
    unpacked = unpack_pod_batch(tp.ints, tp.bools, tp.spec, tp.table_spec, tp.groups, "cpu")
    for f in dataclasses.fields(got):
        g = getattr(got, f.name)
        np.testing.assert_array_equal(g.numpy(), np.asarray(getattr(want, f.name)),
                                      err_msg=f.name)
        assert g.dtype == getattr(unpacked, f.name).dtype, f.name
        assert torch.equal(g, getattr(unpacked, f.name)), f.name
    assert got.batch == B and bool(got.valid[: len(pods)].all())


def _port_pods(pods):
    """The port's PodInfo twins of JAX PodInfos (same fields)."""
    from k8s1m_tpu_torch.snapshot import pod_encoding as tpe

    def conv(obj):
        if dataclasses.is_dataclass(obj):
            cls = getattr(tpe, type(obj).__name__)
            return cls(**{f.name: conv(getattr(obj, f.name)) for f in dataclasses.fields(obj)})
        if isinstance(obj, list):
            return [conv(x) for x in obj]
        return obj

    return [conv(p) for p in pods]


def test_uniform_pods_encode_plain_groups():
    th = NodeTableHost(TableSpec(max_nodes=64))
    populate_kwok_nodes(th, 32)
    enc = PodBatchHost(PodSpec(batch=16), th.spec, th.vocab)
    got = enc.encode(uniform_pods(10), device="cpu")
    assert int(got.valid.sum()) == 10 and not bool(got.sel_valid.any())
