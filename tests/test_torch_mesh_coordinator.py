"""The port's Coordinator with ``mesh=`` against the JAX coordinator with
its mesh, on the CPU, stepped in lockstep.

Each package gets the same store writes (its own ``MemStore``); the JAX
coordinator runs its dp x sp mesh on the 8-device virtual CPU mesh, the
port's the same shape on ``device="cpu"`` (every cell on the one host
device: several shards per device, dp ranks sharing each shard's copy).
Backoff is deterministic (zero delay, zero jitter).  After every step the
bind counts agree; at the end every stored pod value is byte-identical, as
are the host mirror, the device table (the port's gathered from its
shards) and all nine count tables.  At score-pct 100 the mesh run also
equals the port's single-device run.  ``list_prefix_sharded`` is held to
``list_prefix`` over a MemStore and over the wire.  Tolerance: exact
equality.
"""

import _torch_cpu  # noqa: F401  (bounds torch's CPU threads first)

import dataclasses
import json

import numpy as np
import pytest
import torch

import k8s1m_tpu.config as jconfig
import k8s1m_tpu.control.coordinator as jcoord
import k8s1m_tpu.control.objects as jobj
import k8s1m_tpu.faultline as jfault
import k8s1m_tpu.plugins.registry as jreg
import k8s1m_tpu.snapshot.pod_encoding as jpe
import k8s1m_tpu.store.native as jnative
from k8s1m_tpu.parallel import make_mesh as jax_make_mesh
from k8s1m_tpu.tools.make_nodes import build_node
from k8s1m_tpu_torch import interop
from k8s1m_tpu_torch import parallel as tpar
from k8s1m_tpu_torch.config import PodSpec, TableSpec
from k8s1m_tpu_torch.control.coordinator import Coordinator
from k8s1m_tpu_torch.faultline import RetryPolicy
from k8s1m_tpu_torch.obs.metrics import REGISTRY
from k8s1m_tpu_torch.plugins.registry import Profile
from k8s1m_tpu_torch.snapshot.constraints import FIELDS as CONSTRAINT_FIELDS
from k8s1m_tpu_torch.snapshot.hotfeed import ShardedHostFeed
from k8s1m_tpu_torch.snapshot.packing import is_packed
from k8s1m_tpu_torch.store import native as tnative

BASE = dict(node_affinity=0, topology_spread=0, interpod_affinity=0)
SPREAD = [{
    "topologyKey": "topology.kubernetes.io/zone", "maxSkew": 1,
    "whenUnsatisfiable": "DoNotSchedule", "labelSelector": {"matchLabels": {"app": "web"}},
}]


def node_item(i, **kw):
    node = dataclasses.replace(build_node(i), **kw)
    return jobj.node_key(node.name), jobj.encode_node(node)


def pod_item(name, ns="default", cpu=10, mem=1024, **kw):
    raw = {k: kw.pop(k) for k in ("raw_spread", "raw_affinity") if k in kw}
    pod = jpe.PodInfo(name, namespace=ns, cpu_milli=cpu, mem_kib=mem, **kw)
    return jobj.pod_key(ns, name), jobj.encode_pod(pod, **raw)


def fleet(n, **kw):
    return [node_item(i, **kw) for i in range(n)]


def pods(prefix, count, **kw):
    return [pod_item(f"{prefix}-{i}", cpu=10 + i % 3, **kw) for i in range(count)]


class MeshPair:
    """A JAX and a port coordinator with the same mesh shape (``None`` =
    single device for both), each over its own store; ``jkw``/``tkw``
    are per-package keywords (objects of each package's own classes)."""

    def __init__(self, mesh=(2, 4), *, profile=BASE, max_nodes=4096, batch=64, chunk=512,
                 k=4, jkw=None, tkw=None, **kw):
        self.jstore, self.tstore = jnative.MemStore(), tnative.MemStore()
        dims = dict(max_nodes=max_nodes, max_zones=16, max_regions=8)
        pdims = dict(batch=batch, spread_refs=1, affinity_refs=1, spread_incs=1, ipa_incs=1)
        pol = dict(component="coordinator.bind", base_delay_s=0.0, jitter=0.0)
        kw.setdefault("with_constraints", False)
        jm = jax_make_mesh(*mesh) if mesh else "none"
        tm = tpar.make_mesh(*mesh, device="cpu") if mesh else "none"
        self.j = jcoord.Coordinator(
            self.jstore, jconfig.TableSpec(**dims), jconfig.PodSpec(**pdims),
            jreg.Profile(**profile), chunk=chunk, k=k, backend="xla",
            retry_policy=jfault.RetryPolicy(**pol), mesh=jm, **kw, **(jkw or {}))
        self.t = Coordinator(
            self.tstore, TableSpec(**dims), PodSpec(**pdims), Profile(**profile),
            chunk=chunk, k=k, retry_policy=RetryPolicy(**pol), device="cpu", mesh=tm, **kw,
            **(tkw or {}))
        self.bound = 0

    def write(self, items):
        for store in (self.jstore, self.tstore):
            store.put_batch(items)

    def bootstrap(self):
        self.j.bootstrap()
        self.t.bootstrap()

    def step(self):
        got, want = self.t.step(), self.j.step()
        assert got == want
        self.bound += got
        return got

    def run_until_idle(self):
        got, want = self.t.run_until_idle(), self.j.run_until_idle()
        assert got == want
        self.bound += got

    def stored(self):
        tkv, _ = tnative.list_prefix(self.tstore, b"/registry/pods/")
        return [(kv.key, kv.value) for kv in tkv]

    def check(self):
        jkv, _ = jnative.list_prefix(self.jstore, b"/registry/pods/")
        stored = self.stored()
        assert stored == [(kv.key, kv.value) for kv in jkv]
        jh, th = self.j.host, self.t.host
        assert th._row_of == jh._row_of
        for c in ("valid", "cpu_alloc", "mem_alloc", "pods_alloc", "cpu_req", "mem_req",
                  "pods_req", "label_key", "label_val", "zone", "region", "name_id"):
            np.testing.assert_array_equal(getattr(th, c), getattr(jh, c), err_msg=c)
        jt = self.j.table
        tt = self.t.table.gather() if self.t.mesh is not None else self.t.table
        assert is_packed(tt) == (type(jt).__name__ == "PackedNodeTable")
        names = [f.name for f in dataclasses.fields(tt) if f.name != "spec"]
        carried = interop.node_table_from_numpy(
            {f: np.asarray(getattr(jt, f)) for f in names},
            packing=jt.spec if is_packed(tt) else None, device="cpu")
        for f in names:
            assert torch.equal(getattr(tt, f), getattr(carried, f)), f
        if not self.t._inflights:
            for c in ("cpu_req", "mem_req", "pods_req"):
                np.testing.assert_array_equal(getattr(tt, c).numpy(), getattr(th, c),
                                              err_msg=c)
        if self.t.constraints is not None:
            tc = self.t.constraints
            tc = tc.gather() if self.t.mesh is not None else tc
            for f in CONSTRAINT_FIELDS:
                np.testing.assert_array_equal(getattr(tc, f).numpy(),
                                              np.asarray(getattr(self.j.constraints, f)),
                                              err_msg=f)
        assert self.t.unschedulable.keys() == self.j.unschedulable.keys()
        return stored

    def close(self):
        self.t.close()
        self.j.close()
        self.tstore.close()
        self.jstore.close()


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


def _all_bound(stored):
    return all(b'"nodeName"' in v for _k, v in stored)


def _churned(p, waves=5):
    """test_mesh_differential's 4096 drive: pod waves, capacity churn on
    held rows and structural adds, all landing while waves are in
    flight."""
    p.write(fleet(4090))
    p.bootstrap()
    depth = 0
    for w in range(waves):
        p.write(pods(f"w{w}", 48))
        p.write([node_item((17 * w + j) % 4090, cpu_milli=4000 + 100 * w) for j in range(4)])
        if w == 2:
            p.write([node_item(5000), node_item(5001)])
        p.step()
        depth = max(depth, len(p.t._inflights))
    p.run_until_idle()
    return depth


@pytest.mark.parametrize("mesh,packing", [((2, 4), "off"), ((2, 2), "packed")],
                         ids=["2x4-off", "2x2-packed"])
def test_mesh_coordinator_byte_identical_under_churn_4096(pair, mesh, packing):
    """Twins of test_mesh_differential.py:166 and test_meshpack.py:197:
    lockstep with the JAX mesh, then equal to the port's single device."""
    scatters = REGISTRY.get("mesh_sharded_scatter_total")
    base = scatters.value(cols="cap")
    p = pair(mesh, pipeline=True, depth=3, seed=7, max_attempts=8, packing=packing)
    assert _churned(p) >= 2
    stored = p.check()
    assert p.bound == 5 * 48 and _all_bound(stored)
    assert scatters.value(cols="cap") > base
    assert p.t.donation_inplace is True
    s = pair(None, pipeline=True, depth=3, seed=7, max_attempts=8, packing="off")
    _churned(s)
    assert s.stored() == stored


def test_mesh_remove_readd_no_row_aliasing(pair):
    """Twin of test_mesh_differential.py:188."""
    p = pair((2, 4), max_nodes=128, batch=32, chunk=16, pipeline=True, depth=2,
             max_attempts=8)
    p.write([node_item(0, labels={"disk": "ssd"})])
    p.bootstrap()
    p.write([pod_item("p0", node_selector={"disk": "ssd"})])
    p.step()
    assert len(p.t._inflights) == 1
    old = p.t.host.row_of("kwok-node-0")
    p.write([(jobj.node_key("kwok-node-0"), None), node_item(0, labels={"disk": "ssd"})])
    for c in (p.t, p.j):
        assert c._drain_node_events() == 2
    assert p.t.host.row_of("kwok-node-0") != old and p.t.host.quarantined == 1
    p.run_until_idle()
    assert p.bound == 1
    p.check()


def test_mesh_quarantine_exhaustion_differential(pair):
    """Twin of test_mesh_differential.py:250: the structural quiesce."""
    p = pair((2, 4), max_nodes=8, batch=8, chunk=2, k=2, pipeline=True, depth=2, seed=3,
             max_attempts=8)
    p.write(fleet(8))
    p.bootstrap()
    p.write([pod_item("p0")])
    p.step()
    p.write([(jobj.node_key("kwok-node-0"), None), node_item(9)])
    for c in (p.t, p.j):
        c._drain_node_events()
        assert not c._inflights
    p.run_until_idle()
    assert p.bound == 1
    p.check()


def test_sharded_feed_stages_and_stays_identical(pair):
    """Twin of test_mesh_differential.py:359: the per-dp-rank feed stages
    real waves and the run stays byte-identical."""
    used = REGISTRY.get("hotfeed_staged_used_total")
    before = used.value()
    p = pair((2, 4), max_nodes=128, batch=32, chunk=16, pipeline=True, depth=2, seed=11,
             hotfeed=True)
    assert isinstance(p.t._feed, ShardedHostFeed) and len(p.t._feed.feeds) == 2
    p.write(fleet(64))
    p.bootstrap()
    p.write(pods("p", 192))
    p.run_until_idle()
    assert p.bound == 192 and used.value() > before
    p.check()
    assert REGISTRY.get("mesh_feed_staged_depth").value() >= 0


def test_mesh_overflow_widening_rebuild(pair):
    """Twin of test_meshpack.py:276: a dirty-row delta overflows the
    packed layout mid-pipeline; the layout widens once, on the host, and
    the rebuilt sharded table equals the JAX mesh's."""
    from k8s1m_tpu.snapshot.packing import build_packing_spec as jbuild
    from k8s1m_tpu.snapshot.packing import pack_table_host as jpack
    from k8s1m_tpu_torch.snapshot.packing import build_packing_spec, pack_table_host

    p = pair((2, 4), max_nodes=128, batch=32, chunk=16, packing="packed", pipeline=True,
             depth=2, seed=1)
    p.write(fleet(8))
    p.bootstrap()
    for c, build, pack, host_dev in (
        (p.j, jbuild, jpack, lambda c: c._table_sharding),
        (p.t, build_packing_spec, pack_table_host, lambda c: "cpu"),
    ):
        tight = dataclasses.replace(
            build(c.table_spec, c.host.vocab),
            val_bits=max(len(c.host.vocab.label_values).bit_length(), 2))
        c._packing_spec = tight
        table = pack(c.host, tight, host_dev(c))
        c.table = table if c is p.j else tpar.shard_table(table, c.mesh)
        while len(c.host.vocab.label_values) < (1 << tight.val_bits):
            c.host.vocab.label_values.intern(f"pad-{len(c.host.vocab.label_values)}")
    p.write([pod_item("inflight")])
    p.step()
    p.write([node_item(0, labels={"drift": "novel-value"}), pod_item("p0")])
    p.run_until_idle()
    assert p.t.table.packed and not p.t.table.spec.fuse_labels
    stored = p.check()
    assert len(stored) == 2 and _all_bound(stored)


def test_packed_mesh_construction_stays_packed():
    """Twin of test_meshpack.py:288."""
    with tnative.MemStore() as store:
        store.put_batch(fleet(8))
        c = Coordinator(store, TableSpec(max_nodes=128), PodSpec(batch=32), Profile(**BASE),
                        chunk=16, k=4, with_constraints=False, packing="packed", mesh="2x4",
                        device="cpu")
        c.bootstrap()
        assert isinstance(c.table, tpar.ShardedTable) and c.table.packed
        assert c.table.rows_per_shard == 32 and len(c.table.parts) == 4
        c.close()


# ---- twins of tests/test_mesh_e2e.py:139-204 ----------------------------------


def test_mesh_binds_all_pods_and_pipelines(pair):
    for pipeline in (False, True):
        p = pair((2, 4), max_nodes=128, batch=32, chunk=16, pipeline=pipeline, depth=2)
        p.write(fleet(8, pods=16))
        p.bootstrap()
        p.write(pods("p", 100))
        p.run_until_idle()
        assert p.bound == 100 and int(p.t.host.pods_req.sum()) == 100
        p.check()


def test_mesh_delete_frees_capacity(pair):
    p = pair((2, 4), max_nodes=128, batch=32, chunk=16, max_attempts=3)
    p.write([node_item(0, pods=2)])
    p.bootstrap()
    p.write(pods("a", 2))
    p.run_until_idle()
    p.write([pod_item("c")])
    p.run_until_idle()
    assert p.bound == 2
    p.write([(pods("a", 2)[0][0], None)])
    for c in (p.t, p.j):
        c.unschedulable.clear()
    key = pod_item("c")
    p.write([key])
    p.run_until_idle()
    assert p.bound == 3
    p.check()


def test_mesh_sampled_window(pair):
    """Shard-local windows at score-pct 50: held to the JAX mesh."""
    p = pair((2, 4), max_nodes=128, batch=32, chunk=16, score_pct=50, max_attempts=16,
             pipeline=True, depth=2)
    assert p.t._sample_rows == 16 and p.t._window_nodes == 32
    p.write(fleet(8, pods=16))
    p.bootstrap()
    p.write(pods("p", 64))
    p.run_until_idle()
    assert p.bound == 64 and p.t._window_i == p.j._window_i
    p.check()


def test_mesh_constraints(pair):
    """Spread over sharded count tables, one pod per wave, then a delete
    through the sharded count-table correction."""
    p = pair((2, 4), profile=dict(interpod_affinity=0), max_nodes=128, batch=32, chunk=16,
             with_constraints=True)
    p.write([node_item(i, labels={"topology.kubernetes.io/zone": f"z{i % 2}"}, pods=64)
             for i in range(8)])
    p.bootstrap()
    items = pods("w", 8, labels={"app": "web"}, raw_spread=SPREAD)
    for item in items:
        p.write([item])
        p.run_until_idle()
    assert p.bound == 8
    zones = [json.loads(v)["spec"]["nodeName"] for _k, v in p.check()]
    assert sorted(int(z.rsplit("-", 1)[1]) % 2 for z in zones) == [0] * 4 + [1] * 4
    before = int(p.t.constraints.gather().spread_zone.sum())
    p.write([(items[0][0], None)])
    p.run_until_idle()
    assert int(p.t.constraints.gather().spread_zone.sum()) == before - 1
    p.check()


def test_mesh_refuses_row_masks_and_bad_shapes():
    with tnative.MemStore() as store:
        c = Coordinator(store, TableSpec(max_nodes=128), PodSpec(batch=32), Profile(**BASE),
                        chunk=16, with_constraints=False, mesh="2x4", device="cpu")
        with pytest.raises(ValueError, match="mesh"):
            c.set_row_mask(np.ones(128, bool))
        c.close()
        for mesh, msg in (("1x3", "sp=3"), ("1x16", "chunk"), ("3x1", "dp=3")):
            with pytest.raises(ValueError, match=msg):
                Coordinator(store, TableSpec(max_nodes=128), PodSpec(batch=32),
                            Profile(**BASE), chunk=16, mesh=mesh, device="cpu")


# ---- list_prefix_sharded ------------------------------------------------------


def _kv_tuple(kv):
    return (kv.key, kv.value, kv.mod_revision, kv.create_revision, kv.version)


def _same_lists(store):
    want, rev = tnative.list_prefix(store, b"/registry/minions/", page=97)
    assert len(want) == 1000
    for shards in (1, 3, 8):
        got, grev = tnative.list_prefix_sharded(store, b"/registry/minions/", shards=shards,
                                                page=97)
        assert grev == rev and [_kv_tuple(k) for k in got] == [_kv_tuple(k) for k in want]
        vals, vrev = tnative.list_prefix_sharded(store, b"/registry/minions/", shards=shards,
                                                 page=97, values_only=True)
        assert vrev == rev and vals == [kv.value for kv in want]


def test_list_prefix_sharded_matches_list_prefix_memstore():
    """Pages of 97 keys straddle every shard bound; 1, 3 and 8 shards."""
    with tnative.MemStore() as store:
        store.put_batch(fleet(1000))
        store.put_batch([node_item(i, cpu_milli=9000) for i in range(0, 1000, 7)])
        _same_lists(store)


def test_list_prefix_sharded_matches_list_prefix_over_the_wire():
    from k8s1m_tpu_torch.store.remote import RemoteStore
    from k8s1m_tpu_torch.store.server_main import serve_subprocess

    with serve_subprocess() as (_proc, target):
        store = RemoteStore(target)
        try:
            store.put_batch(fleet(1000))
            store.put_batch([node_item(i, cpu_milli=9000) for i in range(0, 1000, 7)])
            _same_lists(store)
        finally:
            store.close()
