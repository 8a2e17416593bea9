"""The port's sharded wave (``parallel/sharded_cycle.py``) against the JAX
mesh on its 8-device virtual CPU mesh, and against the port's own single
device.

The same state is built with the JAX package's host encoders (numpy,
seeded) and carried across through ``interop``; both meshes run the wave
at the same dp x sp shape (2x4, 1x4, 2x2) and the same seed (the port
takes the i32 ``seed_of`` the JAX step derives from its key).  Compared:
the candidates' bound rows, the Assignment, the request columns and all
nine count tables after commit (the port's gathered to one table).  At
score-pct 100 the mesh also equals the port's single-device wave (the
byte-identity contract); sampled windows rotate shard-locally and are
held to the JAX mesh only.  Also: the sp merge keeps ``lax.top_k``'s tie
order on ties between shards, and with dp = 2 an sp shard that two dp
ranks share takes each commit once.  Tolerance everywhere: exact
equality (integer outputs).
"""

import _torch_cpu  # noqa: F401  (bounds torch's CPU threads first)

import dataclasses

import jax
import numpy as np
import pytest
import torch

from k8s1m_tpu.cluster import populate_kwok_nodes as jax_populate
from k8s1m_tpu.cluster import uniform_pods as jax_uniform
from k8s1m_tpu.cluster.workload import affinity_deployment, spread_deployment
from k8s1m_tpu.config import TOPO_ZONE, PodSpec, TableSpec
from k8s1m_tpu.engine.cycle import schedule_batch_packed as jax_schedule_packed
from k8s1m_tpu.ops.priority import seed_of
from k8s1m_tpu.parallel import make_mesh as jax_make_mesh
from k8s1m_tpu.parallel import make_sharded_step as jax_sharded_step
from k8s1m_tpu.plugins.registry import Profile as JaxProfile
from k8s1m_tpu.snapshot import NodeInfo, NodeTableHost, PodBatchHost, PodInfo
from k8s1m_tpu.snapshot import constraints as jcons
from k8s1m_tpu.snapshot import packing as jpk
from k8s1m_tpu.snapshot.node_table import ZONE_LABEL
from k8s1m_tpu_torch import interop
from k8s1m_tpu_torch import parallel as tpar
from k8s1m_tpu_torch.engine.cycle import Candidates, schedule_batch, schedule_batch_packed
from k8s1m_tpu_torch.parallel.sharded_cycle import merge_shards
from k8s1m_tpu_torch.plugins.registry import Profile
from k8s1m_tpu_torch.snapshot import pod_encoding as tpe
from k8s1m_tpu_torch.snapshot.constraints import FIELDS as CONS_FIELDS
from k8s1m_tpu_torch.snapshot.packing import donation_inplace, donation_probe

SPEC = TableSpec(max_nodes=64, max_zones=8, max_regions=4)
JPROFILE = JaxProfile(topology_spread=0, interpod_affinity=0)
PROFILE = Profile(topology_spread=0, interpod_affinity=0)
MESHES = [(2, 4), (1, 4), (2, 2)]
REQ = ("cpu_req", "mem_req", "pods_req")


def _seed(key) -> int:
    return int(np.asarray(seed_of(key)))


def _table(jt):
    """The JAX table (either layout) as the port's, on the CPU."""
    cols = {f.name: np.asarray(getattr(jt, f.name))
            for f in dataclasses.fields(jt) if f.name != "spec"}
    return interop.node_table_from_numpy(cols, getattr(jt, "spec", None), "cpu")


def _batch(jb):
    """A JAX (unpacked) PodBatch as the port's."""
    return tpe.PodBatch(**{f.name: torch.tensor(np.asarray(getattr(jb, f.name)))
                           for f in dataclasses.fields(tpe.PodBatch)})


def _packed(pb):
    return interop.packed_pod_batch(pb.ints, pb.bools, pb.spec, pb.table_spec, pb.groups)


def _cons(jc):
    return interop.constraints_from_numpy(
        {f: np.asarray(getattr(jc, f)) for f in CONS_FIELDS}, device="cpu")


def _same_asg(asg, jasg, what=""):
    for f in ("node_row", "bound", "score", "zone", "region"):
        np.testing.assert_array_equal(getattr(asg, f).cpu().numpy(),
                                      np.asarray(getattr(jasg, f)), err_msg=f"{what} {f}")


def _same_req(table, jt, what=""):
    full = table.gather() if isinstance(table, tpar.ShardedTable) else table
    for c in REQ:
        np.testing.assert_array_equal(getattr(full, c).numpy(), np.asarray(getattr(jt, c)),
                                      err_msg=f"{what} {c}")


def _same_cons(cons, jc, what=""):
    full = cons.gather() if isinstance(cons, tpar.ShardedConstraints) else cons
    for f in CONS_FIELDS:
        np.testing.assert_array_equal(getattr(full, f).numpy(), np.asarray(getattr(jc, f)),
                                      err_msg=f"{what} {f}")


def _setup(num_nodes=48, num_pods=16, batch=16):
    host = NodeTableHost(SPEC)
    for i in range(num_nodes):
        host.upsert(NodeInfo(name=f"n{i}", cpu_milli=1000 + 37 * i,
                             mem_kib=(1 << 20) + (i << 12), pods=4))
    enc = PodBatchHost(PodSpec(batch=batch), SPEC, host.vocab)
    pods = [PodInfo(name=f"p{i}", cpu_milli=100 + 7 * i, mem_kib=1 << 14)
            for i in range(num_pods)]
    return host, enc.encode(pods)


# ---- twins of tests/test_sharded.py -----------------------------------------


@pytest.mark.parametrize("dp,sp", MESHES, ids=lambda v: str(v))
@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_sharded_step_matches_jax_and_single_device(dp, sp, backend):
    host, jb = _setup()
    key = jax.random.key(0)
    jt, _, jasg = jax_sharded_step(jax_make_mesh(dp, sp), JPROFILE, chunk=8, k=4)(
        host.to_device(), jb, key)
    step = tpar.make_sharded_step(tpar.make_mesh(dp, sp, device="cpu"), PROFILE, chunk=8, k=4,
                                  backend=backend)
    table = _table(host.to_device())
    t, cons, asg = step(table, _batch(jb), _seed(key))
    assert cons is None and isinstance(t, tpar.ShardedTable)
    _same_asg(asg, jasg)
    _same_req(t, jt)
    # The replay step never writes its input table.
    assert int(table.pods_req.sum()) == 0
    # Byte-identity with the single device at score-pct 100.
    t1, _, a1 = schedule_batch(_table(host.to_device()), _batch(jb), _seed(key),
                               profile=PROFILE, chunk=16, k=4, backend=backend)
    for f in ("node_row", "bound", "score"):
        assert torch.equal(getattr(asg, f), getattr(a1, f)), f
    _same_req(t, t1)


def test_sharded_conflicts_across_dp_shards():
    host = NodeTableHost(SPEC)
    host.upsert(NodeInfo(name="only", cpu_milli=1000, mem_kib=1 << 20, pods=1))
    jb = PodBatchHost(PodSpec(batch=16), SPEC, host.vocab).encode(
        [PodInfo(name=f"p{i}", cpu_milli=800, mem_kib=1 << 16) for i in range(16)])
    key = jax.random.key(1)
    jt, _, jasg = jax_sharded_step(jax_make_mesh(2, 4), JPROFILE, chunk=8, k=4)(
        host.to_device(), jb, key)
    step = tpar.make_sharded_step(tpar.make_mesh(2, 4, device="cpu"), PROFILE, chunk=8, k=4)
    t, _, asg = step(_table(host.to_device()), _batch(jb), _seed(key))
    assert int(asg.bound.sum()) == 1 and int(t.gather().pods_req.sum()) == 1
    _same_asg(asg, jasg)
    _same_req(t, jt)


def test_sharded_table_feedback_across_batches():
    host, jb = _setup(num_nodes=32, num_pods=16)
    jstep = jax_sharded_step(jax_make_mesh(2, 4), JPROFILE, chunk=8, k=4)
    step = tpar.make_sharded_step(tpar.make_mesh(2, 4, device="cpu"), PROFILE, chunk=8, k=4)
    jt, t = host.to_device(), _table(host.to_device())
    for i in range(2):
        key = jax.random.key(i)
        jt, _, jasg = jstep(jt, jb, key)
        t, _, asg = step(t, _batch(jb), _seed(key))
        assert int(asg.bound.sum()) == 16
        _same_asg(asg, jasg, f"wave {i}")
        _same_req(t, jt, f"wave {i}")
    assert int(t.gather().pods_req.sum()) == 32


def test_sp_only_mesh():
    host, jb = _setup(num_nodes=32, num_pods=8, batch=8)
    key = jax.random.key(0)
    jt, _, jasg = jax_sharded_step(jax_make_mesh(1, 8), JPROFILE, chunk=4, k=2)(
        host.to_device(), jb, key)
    t, _, asg = tpar.make_sharded_step(tpar.make_mesh(1, 8, device="cpu"), PROFILE,
                                       chunk=4, k=2)(_table(host.to_device()), _batch(jb),
                                                     _seed(key))
    assert int(asg.bound.sum()) == 8
    _same_asg(asg, jasg)
    _same_req(t, jt)


def _constrained():
    spec = TableSpec(max_nodes=32, max_zones=8, max_regions=4, spread_slots=4,
                     affinity_slots=4)
    host = NodeTableHost(spec)
    for i in range(32):
        host.upsert(NodeInfo(name=f"n{i}", cpu_milli=8000, mem_kib=1 << 22, pods=8,
                             labels={ZONE_LABEL: f"z{i % 4}"}))
    tracker = jcons.ConstraintTracker(spec)
    pods = (spread_deployment(tracker, "sp", 8, topo=1)
            + affinity_deployment(tracker, "anti", 8, anti=True))
    enc = PodBatchHost(PodSpec(batch=16), spec, host.vocab)
    return spec, host, tracker, enc, enc.encode(pods)


@pytest.mark.parametrize("dp,sp", MESHES, ids=lambda v: str(v))
def test_sharded_constrained_matches_jax(dp, sp):
    """Spread + anti-affinity over sharded count tables: the cross-shard
    prologue, the cons stage per cell and the sharded commit give the
    JAX mesh's binds and count tables, two waves running."""
    spec, host, tracker, enc, jb = _constrained()
    jstep = jax_sharded_step(jax_make_mesh(dp, sp), JaxProfile(), chunk=8, k=4)
    step = tpar.make_sharded_step(tpar.make_mesh(dp, sp, device="cpu"), Profile(),
                                  chunk=8, k=4)
    jt, jc = host.to_device(), jcons.empty_constraints(spec)
    t, c = _table(jt), _cons(jc)
    batches = [jb, enc.encode(affinity_deployment(tracker, "anti", 4, anti=True))]
    for i, b in enumerate(batches):
        key = jax.random.key(7 + i)
        jt, jc, jasg = jstep(jt, b, key, jc)
        t, c, asg = step(t, _batch(b), _seed(key), c)
        _same_asg(asg, jasg, f"wave {i}")
        _same_req(t, jt, f"wave {i}")
        _same_cons(c, jc, f"wave {i}")
    # Single device, same two waves: the same bytes.
    t1, c1 = _table(host.to_device()), _cons(jcons.empty_constraints(spec))
    for i, b in enumerate(batches):
        t1, c1, a1 = schedule_batch(t1, _batch(b), _seed(jax.random.key(7 + i)),
                                    profile=Profile(), constraints=c1, chunk=8, k=4)
    _same_req(t, t1)
    full = c.gather()
    for f in CONS_FIELDS:
        assert torch.equal(getattr(full, f), getattr(c1, f)), f


def test_sharded_constraints_match_jax_zone_spread():
    """Twin of tests/test_topology.py:149: zone spread over a 2x4 mesh."""
    spec = TableSpec(max_nodes=64, max_zones=8, max_regions=4)
    host = NodeTableHost(spec)
    for i in range(16):
        host.upsert(NodeInfo(name=f"n{i}", cpu_milli=4000, mem_kib=1 << 22, pods=16,
                             labels={ZONE_LABEL: f"z{i % 4}"}))
    tracker = jcons.ConstraintTracker(spec)
    jb = PodBatchHost(PodSpec(batch=8), spec, host.vocab).encode(
        spread_deployment(tracker, "web", 8, topo=TOPO_ZONE, max_skew=2))
    key = jax.random.key(0)
    jt, jc, jasg = jax_sharded_step(jax_make_mesh(2, 4), JPROFILE, chunk=4, k=4)(
        host.to_device(), jb, key, jcons.empty_constraints(spec))
    t, c, asg = tpar.make_sharded_step(tpar.make_mesh(2, 4, device="cpu"), PROFILE, chunk=4,
                                       k=4)(_table(host.to_device()), _batch(jb), _seed(key),
                                            _cons(jcons.empty_constraints(spec)))
    assert int(asg.bound.sum()) == 8 and int(c.gather().spread_zone.sum()) == 8
    _same_asg(asg, jasg)
    _same_req(t, jt)
    _same_cons(c, jc)


# ---- twins of tests/test_mesh_e2e.py and tests/test_meshpack.py -------------


def _kwok(n_nodes, cap, pods, batch):
    spec = TableSpec(max_nodes=cap)
    host = NodeTableHost(spec)
    jax_populate(host, n_nodes)
    pb = PodBatchHost(PodSpec(batch=batch), spec, host.vocab).encode_packed(jax_uniform(pods))
    return spec, host, pb


def _jax_sharded(host, mesh):
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    return host.to_device(NamedSharding(mesh, P("sp")))


@pytest.mark.parametrize("dp,sp", MESHES, ids=lambda v: str(v))
def test_sharded_packed_matches_jax_and_single_device(dp, sp):
    """Twin of test_mesh_e2e.py:57 over both table layouts."""
    spec, host, pb = _kwok(96, 128, 24, 32)
    key = jax.random.key(0)
    jmesh = jax_make_mesh(dp, sp)
    pmesh = tpar.make_mesh(dp, sp, device="cpu")
    pspec = jpk.build_packing_spec(spec, host.vocab)
    for layout, jt in (("plain", _jax_sharded(host, jmesh)),
                       ("packed", jpk.pack_table_host(host, pspec))):
        jt, _, jasg, jrows = jax_schedule_packed(jt, pb, key, profile=JPROFILE, chunk=16, k=4,
                                                 mesh=jmesh)
        t = tpar.shard_table(_table(host.to_device() if layout == "plain"
                                    else jpk.pack_table_host(host, pspec)), pmesh)
        t, asg, rows = schedule_batch_packed(t, _packed(pb), _seed(key), profile=PROFILE,
                                             chunk=16, k=4, mesh=pmesh)
        np.testing.assert_array_equal(rows.numpy(), np.asarray(jrows), err_msg=layout)
        _same_asg(asg, jasg, layout)
        _same_req(t, jt, layout)
        assert t.packed == (layout == "packed")
        t1, a1, rows1 = schedule_batch_packed(_table(host.to_device()), _packed(pb),
                                              _seed(key), profile=PROFILE, chunk=32, k=4)
        assert torch.equal(rows, rows1), layout
        _same_req(t, t1, layout)


@pytest.mark.parametrize("dp,sp", MESHES, ids=lambda v: str(v))
def test_sharded_packed_sampled_window_matches_jax(dp, sp):
    """Twin of test_mesh_e2e.py:87: each shard scores its own window."""
    spec, host, pb = _kwok(128, 128, 16, 32)
    rows_local = 128 // sp
    win, off = rows_local // 2, rows_local // 2
    key = jax.random.key(2)
    jmesh = jax_make_mesh(dp, sp)
    jt, _, jasg, jrows = jax_schedule_packed(
        _jax_sharded(host, jmesh), pb, key, profile=JPROFILE, chunk=16, k=4,
        sample_rows=win, sample_offset=off, mesh=jmesh)
    pmesh = tpar.make_mesh(dp, sp, device="cpu")
    t, asg, rows = schedule_batch_packed(
        tpar.shard_table(_table(host.to_device()), pmesh), _packed(pb), _seed(key),
        profile=PROFILE, chunk=16, k=4, sample_rows=win, sample_offset=off, mesh=pmesh)
    np.testing.assert_array_equal(rows.numpy(), np.asarray(jrows))
    _same_asg(asg, jasg)
    _same_req(t, jt)
    r = rows.numpy()
    assert int(asg.bound.sum()) == 16 and ((r[r >= 0] % rows_local) >= off).all()


def test_sharded_packed_pallas_backend_matches_xla():
    """Twin of test_mesh_e2e.py:255: the kernel path (its plain version
    here) and the scan path give the same binds over the mesh."""
    spec, host, pb = _kwok(64, 64, 16, 32)
    pmesh = tpar.make_mesh(2, 4, device="cpu")
    out = {}
    for backend in ("xla", "pallas"):
        t, asg, rows = schedule_batch_packed(
            tpar.shard_table(_table(host.to_device()), pmesh), _packed(pb), 12345,
            profile=PROFILE, chunk=8, k=4, backend=backend, mesh=pmesh)
        out[backend] = (rows, asg.score, t.gather().cpu_req)
    for a, b in zip(out["xla"], out["pallas"]):
        assert torch.equal(a, b)


def test_packed_mesh_step_byte_identical_and_in_place():
    """Twin of test_meshpack.py:70: the donating packed mesh step equals
    the single device and commits into every shard's own storage."""
    spec, host, pb = _kwok(512, 512, 64, 64)
    key = jax.random.key(3)
    pspec = jpk.build_packing_spec(spec, host.vocab)
    pmesh = tpar.make_mesh(2, 4, device="cpu")
    _t1, _a1, r1 = schedule_batch_packed(_table(host.to_device()), _packed(pb), _seed(key),
                                         profile=PROFILE, chunk=128, k=4)
    packed = tpar.shard_table(_table(jpk.pack_table_host(host, pspec)), pmesh)
    probe = donation_probe(packed)
    step = tpar.make_sharded_packed_step(
        pmesh, PROFILE, chunk=128, k=4, pod_spec=_packed(pb).spec,
        table_spec=_packed(pb).table_spec, groups=pb.groups, donate=True)
    t2, _c, _a2, r2 = step(packed, pb.ints, pb.bools, _seed(key), 0)
    assert t2 is packed and torch.equal(r1, r2) and (r1 >= 0).any()
    assert donation_inplace(t2, probe)
    jt, _, _ja, jr = jax_schedule_packed(jpk.pack_table_host(host, pspec), pb, key,
                                         profile=JPROFILE, chunk=128, k=4,
                                         mesh=jax_make_mesh(2, 4))
    np.testing.assert_array_equal(r2.numpy(), np.asarray(jr))
    _same_req(t2, jt)


def test_packed_mesh_sampled_window_matches_unpacked_mesh():
    """Twin of test_meshpack.py:101."""
    spec, host, pb = _kwok(512, 512, 64, 64)
    pmesh = tpar.make_mesh(2, 4, device="cpu")
    pspec = jpk.build_packing_spec(spec, host.vocab)
    seed = _seed(jax.random.key(5))
    kw = dict(profile=PROFILE, chunk=64, k=4, mesh=pmesh, sample_rows=64, sample_offset=64)
    _t, _a, r1 = schedule_batch_packed(tpar.shard_table(_table(host.to_device()), pmesh),
                                       _packed(pb), seed, **kw)
    _t, _a, r2 = schedule_batch_packed(
        tpar.shard_table(_table(jpk.pack_table_host(host, pspec)), pmesh), _packed(pb), seed,
        **kw)
    assert torch.equal(r1, r2) and (r1 >= 0).any()


@pytest.mark.parametrize("dp,sp", [(2, 4), (2, 2)], ids=lambda v: str(v))
def test_sharded_step_byte_identical_at_4096_nodes(dp, sp):
    """Twin of test_mesh_differential.py:55: 4096 KWOK nodes (capacities
    repeat across groups: maximum tie pressure), 64 pods."""
    spec = TableSpec(max_nodes=4096, max_zones=16, max_regions=8)
    host = NodeTableHost(spec)
    jax_populate(host, 4096, zones=8, regions=4)
    pb = PodBatchHost(PodSpec(batch=64), spec, host.vocab).encode_packed(jax_uniform(64))
    key = jax.random.key(3)
    jmesh = jax_make_mesh(dp, sp)
    jt, _, jasg, jrows = jax_schedule_packed(_jax_sharded(host, jmesh), pb, key,
                                             profile=JPROFILE, chunk=512, k=4, mesh=jmesh)
    pmesh = tpar.make_mesh(dp, sp, device="cpu")
    t, asg, rows = schedule_batch_packed(tpar.shard_table(_table(host.to_device()), pmesh),
                                         _packed(pb), _seed(key), profile=PROFILE, chunk=512,
                                         k=4, mesh=pmesh)
    np.testing.assert_array_equal(rows.numpy(), np.asarray(jrows))
    _same_asg(asg, jasg)
    _same_req(t, jt)
    _t1, _a1, rows1 = schedule_batch_packed(_table(host.to_device()), _packed(pb), _seed(key),
                                            profile=PROFILE, chunk=512, k=4)
    assert torch.equal(rows, rows1)


# ---- the port's own invariants ------------------------------------------------


def test_sp_merge_keeps_lax_top_k_order_on_ties_across_shards():
    """Priorities drawn from four values: ties between shards everywhere.
    The merge must pick what ``lax.top_k`` picks on the shard-major
    concatenation (the lower shard, then the lower row, first)."""
    rng = np.random.default_rng(11)
    b, k, sp = 32, 4, 4
    parts = []
    for s in range(sp):
        prio = -np.sort(-rng.integers(-1, 3, (b, k)), axis=1)
        idx = np.where(prio >= 0, rng.integers(0, 64, (b, k)) + 64 * s, -1)
        vals = {f.name: torch.tensor(rng.integers(0, 100, (b, k)), dtype=torch.int32)
                for f in dataclasses.fields(Candidates)}
        vals.update(prio=torch.tensor(prio, dtype=torch.int32),
                    idx=torch.tensor(idx, dtype=torch.int32))
        parts.append(Candidates(**vals))
    got = merge_shards(parts, k, torch.device("cpu"))
    cat = {f.name: np.concatenate([getattr(p, f.name).numpy() for p in parts], axis=1)
           for f in dataclasses.fields(Candidates)}
    top, sel = jax.lax.top_k(jax.numpy.asarray(cat["prio"]), k)
    sel = np.asarray(sel)
    assert (cat["prio"][:, :, None] == cat["prio"][:, None, :]).sum() > b * sp * k
    np.testing.assert_array_equal(got.prio.numpy(), np.asarray(top))
    for f in dataclasses.fields(Candidates):
        np.testing.assert_array_equal(getattr(got, f.name).numpy(),
                                      np.take_along_axis(cat[f.name], sel, axis=1),
                                      err_msg=f.name)


def test_dp_ranks_sharing_a_shard_commit_once():
    """A 2x2 mesh on one device: both dp ranks read the same copy of each
    sp shard (and one zone/region table).  Every bind must land once: a
    commit per cell instead of per storage would double the request and
    count columns."""
    mesh = tpar.make_mesh(2, 2, device="cpu")
    assert len(mesh.storages) == 2 and mesh.domain_owner == (True, False)
    spec, host, tracker, enc, jb = _constrained()
    key = jax.random.key(7)
    t = tpar.shard_table(_table(host.to_device()), mesh)
    c = tpar.shard_constraints(_cons(jcons.empty_constraints(spec)), mesh)
    assert t.part(0, 1) is t.part(1, 1) and c.part(0, 0).spread_zone is c.part(1, 1).spread_zone
    t, c, asg = tpar.make_sharded_step(mesh, Profile(), chunk=8, k=4)(t, _batch(jb), _seed(key), c)
    n = int(asg.bound.sum())
    full, cons = t.gather(), c.gather()
    assert n == 16 and int(full.pods_req.sum()) == n
    assert int(full.cpu_req.sum()) == int((_batch(jb).cpu * asg.bound).sum())
    jt, jc, _ = jax_sharded_step(jax_make_mesh(2, 2), JaxProfile(), chunk=8, k=4)(
        host.to_device(), jb, key, jcons.empty_constraints(spec))
    assert int(cons.spread_zone.sum()) == int(np.asarray(jc.spread_zone).sum()) > 0
    _same_cons(cons, jc)
    _same_req(full, jt)
