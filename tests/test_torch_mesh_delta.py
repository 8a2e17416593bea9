"""The port's sharded delta wave and plane fill against the JAX mesh's.

The same fleet, pods, shape slots and churn (numpy, seeded) go through
``k8s1m_tpu.engine.cycle.fill_shape_planes``/``schedule_batch_delta`` with
``mesh=`` on the 8-device virtual CPU mesh (planes sharded
``P(None, "sp")``) and through the port's with ``mesh=`` over a
ShardedTable and planes split over sp.  Three churned waves, each taking
the previous wave's bound rows in flight: the bound rows, the Assignment,
every table column and both planes (the port's gathered) must be
identical, at 2x4, 1x4 and 2x2, both table layouts.  The delta wave over
the mesh also equals the port's single-device delta wave.  Then the
coordinator with the deltacache on over a mesh, in lockstep with the JAX
one (twins of tests/test_deltasched.py:500 and :595), and the candidate
index's refusal under a mesh (tests/test_deltasched.py:947-967).
Tolerance: exact equality.
"""

import _torch_cpu  # noqa: F401  (bounds torch's CPU threads first)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import k8s1m_tpu.tenancy as jten
from k8s1m_tpu.cluster import populate_kwok_nodes as jax_populate
from k8s1m_tpu.cluster import workload as jwl
from k8s1m_tpu.config import PodSpec, TableSpec
from k8s1m_tpu.engine import cycle as jcycle
from k8s1m_tpu.ops.priority import seed_of
from k8s1m_tpu.parallel import make_mesh as jax_make_mesh
from k8s1m_tpu.plugins.registry import Profile as JaxProfile
from k8s1m_tpu.snapshot import node_table as jnt
from k8s1m_tpu.snapshot.hotfeed import shape_key as jax_shape_key
from k8s1m_tpu.snapshot.node_table import NodeTableHost
from k8s1m_tpu.snapshot.packing import build_packing_spec, pack_table_host
from k8s1m_tpu.snapshot.pod_encoding import PodBatchHost
from k8s1m_tpu_torch import interop
from k8s1m_tpu_torch import parallel as tpar
from k8s1m_tpu_torch import tenancy as tten
from k8s1m_tpu_torch.config import PodSpec as TPodSpec
from k8s1m_tpu_torch.config import TableSpec as TTableSpec
from k8s1m_tpu_torch.control.coordinator import Coordinator
from k8s1m_tpu_torch.engine import deltacache as dc
from k8s1m_tpu_torch.engine.cycle import fill_shape_planes, schedule_batch_delta
from k8s1m_tpu_torch.parallel.sharded_cycle import sharded_scatter
from k8s1m_tpu_torch.plugins.registry import Profile
from k8s1m_tpu_torch.snapshot import node_table as tnt
from k8s1m_tpu_torch.store import native as tnative

from test_torch_mesh_coordinator import MeshPair, fleet, node_item, pod_item, pods

N = 512
CHUNK = 64
B = 48
FB = 4
DIRTY = 6
I32 = np.int32
MESHES = [(2, 4), (1, 4), (2, 2)]


def _state(config, layout):
    spec = TableSpec(max_nodes=N)
    host = NodeTableHost(spec)
    jax_populate(host, N - 16, zones=8, regions=3, seed=3)
    rng = np.random.default_rng(1)
    host.cpu_alloc[:] = np.where(host.valid, rng.integers(250, 1400, N), 0)
    host.pods_alloc[:] = np.where(host.valid, rng.integers(1, 4, N), 0)
    if config == "uniform":
        pods_ = jwl.uniform_pods(B - 4, cpu_milli=200)
        pspec = PodSpec(batch=B)
        prof = (JaxProfile(node_affinity=0, topology_spread=0, interpod_affinity=0),
                Profile(node_affinity=0, topology_spread=0, interpod_affinity=0))
    else:
        pods_ = jwl.node_affinity_pods(B - 4, zones=8, regions=3, cpu_milli=200)
        pspec = PodSpec(batch=B, aff_terms=1, aff_exprs=2, aff_values=2, pref_terms=1)
        prof = (JaxProfile(topology_spread=0, interpod_affinity=0),
                Profile(topology_spread=0, interpod_affinity=0))
    pb = PodBatchHost(pspec, spec, host.vocab).encode_packed(pods_)
    keys = [jax_shape_key(p) for p in pods_]
    shapes = list(dict.fromkeys(keys))
    slot_ids = np.full(B, len(shapes), I32)
    slot_ids[: len(pods_)] = [shapes.index(k) for k in keys]
    fill_enc = PodBatchHost(dataclasses.replace(pspec, batch=FB), spec, host.vocab)
    fills = []
    for off in range(0, len(shapes), FB):
        reps = [pods_[keys.index(s)] for s in shapes[off:off + FB]]
        fs = np.full(FB, len(shapes), I32)
        fs[: len(reps)] = range(off, off + len(reps))
        fills.append((fill_enc.encode_packed(reps), fs))
    jt = (host.to_device() if layout == "plain"
          else pack_table_host(host, build_packing_spec(spec, host.vocab)))
    return jt, pb, prof, slot_ids, len(shapes), fills


def _tpacked(pb):
    return interop.packed_pod_batch(pb.ints, pb.bools, pb.spec, pb.table_spec, pb.groups)


def _ttable(jt):
    cols = {f.name: np.asarray(getattr(jt, f.name)) for f in dataclasses.fields(jt)
            if f.name != "spec"}
    return interop.node_table_from_numpy(cols, getattr(jt, "spec", None), "cpu")


def _eq(port, ref, what):
    if isinstance(port, (tpar.ShardedTensor,)):
        port = port.gather()
    np.testing.assert_array_equal(port.cpu().numpy(), np.asarray(ref), err_msg=what)


def _waves(config, layout, mesh):
    """Plane fills then three churned delta waves; ``mesh`` None runs
    both packages on one device."""
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    jt, pb, (jprof, tprof), slot_ids, s, fills = _state(config, layout)
    table, packed = _ttable(jt), _tpacked(pb)
    jplanes = (jnp.zeros((s, N), jnp.bool_), jnp.zeros((s, N), jnp.int32))
    planes = interop.planes_from_numpy(np.zeros((s, N), bool), np.zeros((s, N), I32), "cpu")
    jmesh = pmesh = None
    scatter = tnt.scatter_rows
    if mesh is not None:
        jmesh, pmesh = jax_make_mesh(*mesh), tpar.make_mesh(*mesh, device="cpu")
        jt = jax.device_put(jt, NamedSharding(jmesh, P("sp")))
        jplanes = jax.device_put(jplanes, NamedSharding(jmesh, P(None, "sp")))
        table = tpar.shard_table(table, pmesh)
        planes = tuple(tpar.shard_planes(x, pmesh) for x in planes)
        scatter = sharded_scatter
    for fpb, fs in fills:
        jplanes = jcycle.fill_shape_planes(jt, fpb, jnp.asarray(fs), jplanes, profile=jprof,
                                           chunk=CHUNK, mesh=jmesh)
        out = fill_shape_planes(table, _tpacked(fpb), fs, planes, profile=tprof, chunk=CHUNK,
                                mesh=pmesh)
        assert out[0] is planes[0] and out[1] is planes[1]          # in place
    _eq(planes[0], jplanes[0], "filled mask")
    _eq(planes[1], jplanes[1], "filled score")
    keys = jax.random.split(jax.random.key(11), 3)
    rng = np.random.default_rng(5)
    jprev = tprev = None
    live = np.flatnonzero(np.asarray(jt.cpu_alloc) > 0)
    out = []
    for w in range(3):
        churn = np.sort(rng.choice(live, DIRTY, replace=False)).astype(I32)
        vals = rng.integers(0, 900, DIRTY).astype(I32)
        jt = jnt.scatter_rows(jt, jnp.asarray(churn), {"cpu_req": jnp.asarray(vals)})
        scatter(table, churn, {"cpu_req": vals})
        dirty = np.full(8, N, I32)
        dirty[:DIRTY] = churn
        jt, jasg, jrows, jplanes = jcycle.schedule_batch_delta(
            jt, pb, keys[w], profile=jprof, slot_ids=jnp.asarray(slot_ids), planes=jplanes,
            dirty=jnp.asarray(dirty), inflight_rows=() if jprev is None else (jprev,),
            chunk=CHUNK, k=4, mesh=jmesh)
        table, asg, rows, planes = schedule_batch_delta(
            table, packed, int(np.asarray(seed_of(keys[w]))), profile=tprof,
            slot_ids=slot_ids, planes=planes, dirty=dirty,
            inflight_rows=() if tprev is None else (tprev,), chunk=CHUNK, k=4, mesh=pmesh)
        _eq(rows, jrows, f"rows wave {w}")
        for f in ("node_row", "bound", "score", "zone", "region"):
            _eq(getattr(asg, f), getattr(jasg, f), f"{f} wave {w}")
        full = table.gather() if mesh is not None else table
        for f in dataclasses.fields(jt):
            if f.name != "spec":
                _eq(getattr(full, f.name), getattr(jt, f.name), f"{f.name} wave {w}")
        _eq(planes[0], jplanes[0], f"mask wave {w}")
        _eq(planes[1], jplanes[1], f"score wave {w}")
        jprev, tprev = jrows, rows
        out.append(rows.clone())
    assert sum(int((r >= 0).sum()) for r in out) > 0
    return out


@pytest.mark.parametrize("dp,sp", MESHES, ids=lambda v: str(v))
@pytest.mark.parametrize("config,layout", [("uniform", "packed"), ("affinity", "plain")])
def test_sharded_delta_waves_match_jax_mesh(dp, sp, config, layout):
    rows = _waves(config, layout, (dp, sp))
    single = _waves(config, layout, None)
    for a, b in zip(rows, single):
        assert bool((a == b).all())


def test_index_refused_under_mesh():
    """Twin of tests/test_deltasched.py:947-967."""
    mesh = tpar.make_mesh(2, 4, device="cpu")
    with pytest.raises(ValueError, match="mesh"):
        dc.DeltaPlaneCache(64, slots=2, index_k=8, sharding=mesh, device="cpu")
    with pytest.raises(TypeError):
        dc.DeltaPlaneCache(64, slots=2, sharding=object(), device="cpu")
    with tnative.MemStore() as store:
        with pytest.raises(ValueError, match="mesh"):
            Coordinator(store, TTableSpec(max_nodes=512), TPodSpec(batch=64),
                        Profile(node_affinity=0, topology_spread=0, interpod_affinity=0),
                        chunk=64, k=4, with_constraints=False, deltacache=True,
                        delta_index_k=8, mesh=mesh, device="cpu")
    with pytest.raises(ValueError, match="candidate index"):
        schedule_batch_delta(None, None, 0, profile=Profile(), slot_ids=None, planes=(None, None),
                             dirty=None, index=(None, None, None), mesh=mesh)


# ---- the coordinator: deltacache over the mesh, lockstep with JAX -------------


@pytest.fixture
def pair():
    made = []

    def make(*a, **kw):
        p = MeshPair(*a, **kw)
        made.append(p)
        return p

    yield make
    for p in made:
        p.close()


def test_delta_mesh_overflow_rebuild_lockstep(pair):
    """Twin of tests/test_deltasched.py:500: a packed-layout overflow
    mid-pipeline on the mesh drops the cached planes wholesale; the run
    stays byte-identical to the JAX mesh's."""
    from k8s1m_tpu.snapshot.packing import build_packing_spec as jbuild
    from k8s1m_tpu.snapshot.packing import pack_table_host as jpack
    from k8s1m_tpu_torch.snapshot.packing import build_packing_spec as tbuild
    from k8s1m_tpu_torch.snapshot.packing import pack_table_host as tpack

    p = pair((2, 4), max_nodes=256, batch=32, chunk=32, packing="packed", pipeline=True,
             depth=2, seed=1, deltacache="on", max_attempts=8)
    p.write(fleet(8))
    p.bootstrap()
    for c, build, pack in ((p.j, jbuild, jpack), (p.t, tbuild, tpack)):
        tight = dataclasses.replace(
            build(c.table_spec, c.host.vocab),
            val_bits=max(len(c.host.vocab.label_values).bit_length(), 2))
        c._packing_spec = tight
        if c is p.j:
            c.table = pack(c.host, tight, c._table_sharding)
        else:
            c.table = tpar.shard_table(pack(c.host, tight, "cpu"), c.mesh)
        while len(c.host.vocab.label_values) < (1 << tight.val_bits):
            c.host.vocab.label_values.intern(f"pad-{len(c.host.vocab.label_values)}")
    for w in range(2):
        p.write([pod_item(f"warm-{w}")])
        p.step()
    p.run_until_idle()
    assert p.t._delta.resident > 0
    p.write([pod_item("inflight")])
    p.step()
    p.write([node_item(0, labels={"drift": "novel-value"}), pod_item("p0")])
    p.run_until_idle()
    assert p.t._delta.resident == p.j._delta.resident
    for w in range(3):
        p.write([pod_item(f"tail-{w}")])
        p.step()
    p.run_until_idle()
    stored = p.check()
    assert len(stored) == 7


def test_delta_composed_4096_mesh_lockstep(pair):
    """Twin of tests/test_deltasched.py:595: packed x sharded x in-place
    delta waves at pipeline depth 3 with capacity churn, structural adds,
    priority preemption and an all-or-none gang — lockstep with the JAX
    mesh, and the same stored pods as the port's single-device full
    recompute."""
    def drive(mesh, delta, packing):
        p = pair(mesh, pipeline=True, depth=3, seed=7, max_attempts=8, packing=packing,
                 deltacache=delta, tkw=dict(tenancy=tten.TenancyController(
                     tten.TenancyPolicy(log_preemptions=True))),
                 jkw=dict(tenancy=jten.TenancyController(
                     jten.TenancyPolicy(log_preemptions=True))))
        p.write(fleet(4090))
        p.write([node_item(5000, labels={"pool": "hot"}, pods=2),
                 node_item(5001, labels={"pool": "hot"}, pods=2)])
        p.bootstrap()
        p.write([pod_item(f"low-{i}", ns="ten-b", node_selector={"pool": "hot"})
                 for i in range(4)])
        p.run_until_idle()
        for w in range(5):
            p.write(pods(f"w{w}", 48))
            p.write([node_item((17 * w + j) % 4090, cpu_milli=4000 + 100 * w)
                     for j in range(4)])
            if w == 1:
                p.write([pod_item(f"g-{j}", ns="ten-a", labels={
                    "k8s1m.io/gang": "g3", "k8s1m.io/gang-size": "3"}) for j in range(3)])
            if w == 2:
                p.write([node_item(6000), node_item(6001)])
            if w == 3:
                p.write([pod_item(f"hi-{j}", ns="ten-a", priority=5,
                                  node_selector={"pool": "hot"}) for j in range(2)])
            p.step()
        p.run_until_idle()
        return p

    m = drive((2, 4), "on", "packed")
    stored = m.check()
    assert m.t.waves["delta"] > 0
    s = drive(None, "off", "off")
    assert s.stored() == stored


def test_sharded_factories_match_the_engine_route():
    """``make_sharded_plane_fill`` and ``make_sharded_delta_step`` (the JAX
    module's factories) give the engine route's bytes; ``donate=False``
    leaves the caller's table and planes as they were, ``donate=True``
    writes them."""
    from k8s1m_tpu_torch.parallel.sharded_cycle import (
        make_sharded_delta_step,
        make_sharded_plane_fill,
    )

    jt, pb, (_jprof, tprof), slot_ids, s, fills = _state("uniform", "packed")
    mesh = tpar.make_mesh(2, 2, device="cpu")
    packed = _tpacked(pb)
    dirty = np.full(8, N, I32)
    dirty[:3] = [5, 300, 511]

    def fresh():
        table = tpar.shard_table(_ttable(jt), mesh)
        planes = tuple(tpar.mesh.zeros_planes(mesh, s, N, dt) for dt in (torch.bool, torch.int32))
        return table, planes

    table, planes = fresh()
    for fpb, fs in fills:
        fill_shape_planes(table, _tpacked(fpb), fs, planes, profile=tprof, chunk=CHUNK,
                          mesh=mesh)
    want = schedule_batch_delta(table.clone(), packed, 99, profile=tprof, slot_ids=slot_ids,
                                planes=(planes[0].clone(), planes[1].clone()), dirty=dirty,
                                chunk=CHUNK, k=4, mesh=mesh)
    t2, planes2 = fresh()
    for fpb, fs in fills:
        fill = make_sharded_plane_fill(mesh, tprof, chunk=CHUNK, pod_spec=_tpacked(fpb).spec,
                                       table_spec=_tpacked(fpb).table_spec, groups=fpb.groups)
        out = fill(t2, fpb.ints, fpb.bools, fs, *planes2)
        assert out[0] is planes2[0]
    for donate in (False, True):
        step = make_sharded_delta_step(mesh, tprof, chunk=CHUNK, k=4, pod_spec=packed.spec,
                                       table_spec=packed.table_spec, groups=pb.groups,
                                       n_inflight=0, donate=donate)
        before = t2.gather().cpu_req.clone()
        tab, asg, rows, pm, ps = step(t2, pb.ints, pb.bools, 99, slot_ids, *planes2, dirty)
        assert torch.equal(rows, want[2]) and torch.equal(asg.node_row, want[1].node_row)
        assert torch.equal(tab.gather().cpu_req, want[0].gather().cpu_req)
        assert torch.equal(pm.gather(), want[3][0].gather())
        assert (tab is t2) == donate
        if not donate:
            assert torch.equal(t2.gather().cpu_req, before)
