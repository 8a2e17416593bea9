"""Whole deltasched waves of the port vs the JAX package.

Three consecutive ``schedule_batch_delta`` waves against
``k8s1m_tpu.engine.cycle.schedule_batch_delta`` on the same state: planes
filled by ``fill_shape_planes`` (compared too), then per wave real churn —
``scatter_rows`` on ``cpu_req`` of a few journaled rows, which form the
wave's dirty vector — and the previous wave's bound rows as
``inflight_rows``.  Both table layouts; uniform pods (one shape) and
``node_affinity_pods`` (eight shapes); without the candidate index, and
with ``index_k=8`` at stratum bits 0 and 11 and a dirty cap the wave
exceeds (the index tail, the fail-closed plane tail and the oversized
path are all taken); one configuration on the JAX Pallas backend
(interpret mode).  Bound rows, ``Assignment``, the table, both planes, the
index triple and the path flag must be identical.  The port takes the i32
seed the JAX step derives from its key (``seed_of``).

Also, port only: a delta wave equals the full wave
(``schedule_batch_packed(sample_rows=None)``) from the same table and
seed, and its merged planes equal a fresh fill over the pre-wave table —
the deltasched contract.  Tolerance: exact equality.
"""

import _torch_cpu  # noqa: F401  (bounds torch's CPU threads first)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s1m_tpu.cluster import populate_kwok_nodes as jax_populate
from k8s1m_tpu.cluster import workload as jwl
from k8s1m_tpu.config import PodSpec, TableSpec
from k8s1m_tpu.engine import cycle as jcycle
from k8s1m_tpu.engine.deltacache import INDEX_FLOOR_UNBUILT
from k8s1m_tpu.ops.priority import seed_of
from k8s1m_tpu.plugins.registry import Profile as JaxProfile
from k8s1m_tpu.snapshot import node_table as jnt
from k8s1m_tpu.snapshot.hotfeed import shape_key as jax_shape_key
from k8s1m_tpu.snapshot.node_table import NodeTableHost
from k8s1m_tpu.snapshot.packing import build_packing_spec, pack_table_host
from k8s1m_tpu.snapshot.pod_encoding import PodBatchHost
from k8s1m_tpu_torch import interop
from k8s1m_tpu_torch.cluster import populate_kwok_nodes, uniform_pods
from k8s1m_tpu_torch.cluster.workload import node_affinity_pods
from k8s1m_tpu_torch.config import PodSpec as TPodSpec
from k8s1m_tpu_torch.config import TableSpec as TTableSpec
from k8s1m_tpu_torch.engine.cycle import (
    fill_shape_planes,
    schedule_batch_delta,
    schedule_batch_packed,
)
from k8s1m_tpu_torch.plugins.registry import Profile
from k8s1m_tpu_torch.snapshot import node_table as tnt
from k8s1m_tpu_torch.snapshot.hotfeed import shape_key
from k8s1m_tpu_torch.snapshot.node_table import NodeTableHost as TNodeTableHost
from k8s1m_tpu_torch.snapshot.packing import (
    build_packing_spec as t_build_packing_spec,
)
from k8s1m_tpu_torch.snapshot.packing import pack_table_host as t_pack_table_host
from k8s1m_tpu_torch.snapshot.pod_encoding import PodBatchHost as TPodBatchHost

N = 512
CHUNK = 128
B = 48
FB = 4               # representatives per fill batch
ZONES, REGIONS = 8, 3
DIRTY = 6            # churned rows per wave
I32 = np.int32
COLS = ("cpu_req", "mem_req", "pods_req")


def _jax_state(config, layout):
    spec = TableSpec(max_nodes=N)
    host = NodeTableHost(spec)
    jax_populate(host, N - 16, zones=ZONES, regions=REGIONS, seed=3)
    rng = np.random.default_rng(1)
    host.cpu_alloc[:] = np.where(host.valid, rng.integers(250, 1400, N), 0)
    host.pods_alloc[:] = np.where(host.valid, rng.integers(1, 4, N), 0)
    if config == "uniform":
        pods = jwl.uniform_pods(B - 4, cpu_milli=200)
        pspec = PodSpec(batch=B)
        profile = (JaxProfile(node_affinity=0, topology_spread=0, interpod_affinity=0),
                   Profile(node_affinity=0, topology_spread=0, interpod_affinity=0))
    else:
        pods = jwl.node_affinity_pods(B - 4, zones=ZONES, regions=REGIONS, cpu_milli=200)
        pspec = PodSpec(batch=B, aff_terms=1, aff_exprs=2, aff_values=2, pref_terms=1)
        profile = (JaxProfile(topology_spread=0, interpod_affinity=0),
                   Profile(topology_spread=0, interpod_affinity=0))
    pb = PodBatchHost(pspec, spec, host.vocab).encode_packed(pods)
    keys = [jax_shape_key(p) for p in pods]
    shapes = list(dict.fromkeys(keys))
    slot_ids = np.full(B, len(shapes), I32)
    slot_ids[: len(pods)] = [shapes.index(k) for k in keys]
    fill_enc = PodBatchHost(dataclasses.replace(pspec, batch=FB), spec, host.vocab)
    fills = []
    for off in range(0, len(shapes), FB):
        reps = [pods[keys.index(s)] for s in shapes[off:off + FB]]
        fs = np.full(FB, len(shapes), I32)
        fs[: len(reps)] = range(off, off + len(reps))
        fills.append((fill_enc.encode_packed(reps), fs))
    jt = (host.to_device() if layout == "plain"
          else pack_table_host(host, build_packing_spec(spec, host.vocab)))
    return jt, pb, profile, slot_ids, len(shapes), fills


def _port(jt, pb):
    cols = {f.name: np.asarray(getattr(jt, f.name)) for f in dataclasses.fields(jt)
            if f.name != "spec"}
    table = interop.node_table_from_numpy(cols, getattr(jt, "spec", None), "cpu")
    return table, interop.packed_pod_batch(pb.ints, pb.bools, pb.spec, pb.table_spec,
                                           pb.groups)


def _eq(port, ref, what):
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref), err_msg=what)


def _fill_both(jt, table, s, fills, jprof, tprof):
    jplanes = (jnp.zeros((s, N), jnp.bool_), jnp.zeros((s, N), jnp.int32))
    planes = interop.planes_from_numpy(np.zeros((s, N), bool), np.zeros((s, N), I32), "cpu")
    for fpb, fs in fills:
        jplanes = jcycle.fill_shape_planes(jt, fpb, jnp.asarray(fs), jplanes, profile=jprof,
                                           chunk=CHUNK)
        tfpb = interop.packed_pod_batch(fpb.ints, fpb.bools, fpb.spec, fpb.table_spec,
                                        fpb.groups)
        out = fill_shape_planes(table, tfpb, fs, planes, profile=tprof, chunk=CHUNK)
        assert out[0] is planes[0] and out[1] is planes[1]     # in place
    _eq(planes[0], jplanes[0], "filled mask plane")
    _eq(planes[1], jplanes[1], "filled score plane")
    assert bool(planes[0].any()) and not bool(planes[0].all())
    return jplanes, planes


def _index_plumbing(slot_ids, s):
    rep = np.full(s, B, I32)
    for i, sl in enumerate(slot_ids.tolist()):
        if sl < s and rep[sl] == B:
            rep[sl] = i
    rebuild = np.full(max(s, 8), s, I32)
    rebuild[:s] = np.arange(s)
    return rep, rebuild


def _run_waves(config, layout, *, backend="xla", index=None):
    """Three churned waves through both packages; returns the path flags."""
    jt, pb, (jprof, tprof), slot_ids, s, fills = _jax_state(config, layout)
    table, packed = _port(jt, pb)
    jplanes, planes = _fill_both(jt, table, s, fills, jprof, tprof)
    kw = dict(chunk=CHUNK, k=4)
    if index is not None:
        hb, cap = index
        k_idx = 8
        jidx = (jnp.full((s, k_idx), N, jnp.int32), jnp.full((s, k_idx), -1, jnp.int32),
                jnp.full((s,), INDEX_FLOOR_UNBUILT, jnp.int32))
        tidx = interop.index_from_numpy(*(np.asarray(a) for a in jidx), device="cpu")
        rep, rebuild = _index_plumbing(slot_ids, s)
        kw.update(stratum_bits=hb, index_dirty_cap=cap, rep_idx=rep, rebuild_slots=rebuild)
    keys = jax.random.split(jax.random.key(11), 3)
    rng = np.random.default_rng(5)
    jprev = tprev = None
    flags, binds = [], 0
    live = np.flatnonzero(np.asarray(jt.cpu_alloc) > 0)
    for w in range(3):
        churn = np.sort(rng.choice(live, DIRTY, replace=False)).astype(I32)
        vals = rng.integers(0, 900, DIRTY).astype(I32)
        jt = jnt.scatter_rows(jt, jnp.asarray(churn), {"cpu_req": jnp.asarray(vals)})
        tnt.scatter_rows(table, churn, {"cpu_req": vals})
        dirty = np.full(8, N, I32)
        dirty[:DIRTY] = churn
        jinfl = () if jprev is None else (jprev,)
        tinfl = () if tprev is None else (tprev,)
        common = dict(profile=jprof, slot_ids=jnp.asarray(slot_ids), planes=jplanes,
                      dirty=jnp.asarray(dirty), inflight_rows=jinfl, backend=backend)
        seed = int(np.asarray(seed_of(keys[w])))
        if index is None:
            jt, jasg, jrows, jplanes = jcycle.schedule_batch_delta(jt, pb, keys[w], **common,
                                                                   **kw)
            table, asg, rows, planes = schedule_batch_delta(
                table, packed, seed, profile=tprof, slot_ids=slot_ids, planes=planes,
                dirty=dirty, inflight_rows=tinfl, **kw)
        else:
            jt, jasg, jrows, jplanes, jidx, jflag = jcycle.schedule_batch_delta(
                jt, pb, keys[w], index=jidx, **common, **kw)
            table, asg, rows, planes, tidx, flag = schedule_batch_delta(
                table, packed, seed, profile=tprof, slot_ids=slot_ids, planes=planes,
                dirty=dirty, inflight_rows=tinfl, index=tidx, **kw)
            assert int(flag) == int(jflag), f"path flag wave {w}"
            flags.append(int(flag))
            for got, ref, what in zip(tidx, jidx, ("idx_row", "idx_class", "idx_floor")):
                _eq(got, ref, f"{what} wave {w}")
        _eq(rows, jrows, f"rows wave {w}")
        for f in ("node_row", "bound", "score", "zone", "region"):
            _eq(getattr(asg, f), getattr(jasg, f), f"{f} wave {w}")
        for f in dataclasses.fields(jt):
            if f.name != "spec":
                _eq(getattr(table, f.name), getattr(jt, f.name), f"{f.name} wave {w}")
        _eq(planes[0], jplanes[0], f"mask plane wave {w}")
        _eq(planes[1], jplanes[1], f"score plane wave {w}")
        binds += int((rows >= 0).sum())
        jprev, tprev = jrows, rows
    assert binds > 0
    return flags


@pytest.mark.parametrize("config", ["uniform", "affinity"])
@pytest.mark.parametrize("layout", ["plain", "packed"])
def test_delta_waves_match_jax(config, layout):
    _run_waves(config, layout)


@pytest.mark.parametrize("layout,hb,cap", [
    ("plain", 11, 256), ("packed", 0, 256), ("packed", 11, 256), ("packed", 11, 8),
])
def test_delta_waves_with_index_match_jax(layout, hb, cap):
    flags = _run_waves("affinity", layout, index=(hb, cap))
    assert flags[0] == 0                     # fresh index: fails closed, rebuilds
    if hb and cap >= 256:
        assert 1 in flags                    # then the index tail engages
    if cap < 64:
        assert flags == [0, 0, 0]            # oversized dirty slice: plane tail


def test_delta_wave_pallas_matches_jax():
    """The JAX step on its Pallas plane tail (interpret mode): the port's
    waves equal it too (padding pods differ in candidates only, never in
    what binds)."""
    _run_waves("affinity", "packed", backend="pallas")


# ---- port only: the deltasched contract -------------------------------------


def _port_state(config, layout, n=1024):
    spec = TTableSpec(max_nodes=n)
    host = TNodeTableHost(spec)
    populate_kwok_nodes(host, n - 8, zones=ZONES, regions=REGIONS, seed=2)
    rng = np.random.default_rng(3)
    host.cpu_alloc[:] = np.where(host.valid, rng.integers(300, 2000, n), 0)
    if config == "uniform":
        pods = uniform_pods(B, cpu_milli=300)
        pspec = TPodSpec(batch=B)
        profile = Profile(node_affinity=0, topology_spread=0, interpod_affinity=0)
    else:
        pods = node_affinity_pods(B, zones=ZONES, regions=REGIONS, cpu_milli=300)
        pspec = TPodSpec(batch=B, aff_terms=1, aff_exprs=2, aff_values=2, pref_terms=1)
        profile = Profile(topology_spread=0, interpod_affinity=0)
    keys = [shape_key(p) for p in pods]
    shapes = list(dict.fromkeys(keys))
    slot_ids = np.array([shapes.index(k) for k in keys], I32)
    enc = TPodBatchHost(pspec, spec, host.vocab)
    fill_enc = TPodBatchHost(dataclasses.replace(pspec, batch=len(shapes)), spec, host.vocab)
    reps = fill_enc.encode_packed([pods[keys.index(s)] for s in shapes])
    table = (host.to_device("cpu") if layout == "plain" else
             t_pack_table_host(host, t_build_packing_spec(spec, host.vocab), "cpu"))
    return table, enc.encode_packed(pods), reps, slot_ids, len(shapes), profile


@pytest.mark.parametrize("config", ["uniform", "affinity"])
@pytest.mark.parametrize("layout", ["plain", "packed"])
def test_port_delta_wave_equals_full_wave(config, layout):
    table, packed, reps, slot_ids, s, profile = _port_state(config, layout)
    n = table.num_rows
    planes = (torch.zeros((s, n), dtype=torch.bool), torch.zeros((s, n), dtype=torch.int32))
    fill_shape_planes(table, reps, np.arange(s, dtype=I32), planes, profile=profile, chunk=256)
    rng = np.random.default_rng(8)
    prev = None
    for w in range(3):
        churn = np.sort(rng.choice(n - 8, DIRTY, replace=False)).astype(I32)
        tnt.scatter_rows(table, churn, {"cpu_req": rng.integers(0, 1500, DIRTY)})
        dirty = np.concatenate([churn, np.full(2, n, I32)])
        before = table.clone()
        full_t, full_asg, full_rows = schedule_batch_packed(
            table.clone(), packed, 1000 + w, profile=profile, chunk=256, k=4)
        table, asg, rows, planes = schedule_batch_delta(
            table, packed, 1000 + w, profile=profile, slot_ids=slot_ids, planes=planes,
            dirty=dirty, inflight_rows=() if prev is None else (prev,), chunk=256, k=4)
        assert torch.equal(rows, full_rows), w
        for f in ("node_row", "bound", "score", "zone", "region"):
            assert torch.equal(getattr(asg, f), getattr(full_asg, f)), (w, f)
        for c in COLS:
            assert torch.equal(getattr(table, c), getattr(full_t, c)), (w, c)
        fresh = (torch.zeros_like(planes[0]), torch.zeros_like(planes[1]))
        fill_shape_planes(before, reps, np.arange(s, dtype=I32), fresh, profile=profile,
                          chunk=256)
        assert torch.equal(fresh[0], planes[0]) and torch.equal(fresh[1], planes[1]), w
        assert int((rows >= 0).sum()) > 0
        prev = rows
