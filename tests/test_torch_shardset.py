"""The port's shard set (``k8s1m_tpu_torch/control/shardset.py``) against the
JAX package's, on the CPU.

Twins of the 11 tests of tests/test_shardset.py.  Each scenario is built
twice, once per package, each over its own ``MemStore`` with that package's
own encoders, and the members are stepped in lockstep: the port's
coordinators with ``device="cpu"`` (the plain versions of the kernels), the
JAX ones on their XLA path.  Retries have zero delay and zero jitter, so a
retried pod's next wave does not depend on the clock.  After every tick the
bind counts, the ownership masks and the stored assignment must agree, and
at the end every stored pod value must be byte-identical; the JAX file's
own assertions are kept on the port's run.  The hashes, the assignment
codec and the rebalance function are held to the JAX functions on seeded
random inputs.  Tolerance: exact equality.
"""

from __future__ import annotations

import _torch_cpu  # noqa: F401  (bounds torch's CPU threads first)

import json
import types

import numpy as np
import pytest

import k8s1m_tpu.config as jconfig
import k8s1m_tpu.control.coordinator as jcoord
import k8s1m_tpu.control.objects as jobj
import k8s1m_tpu.control.shardset as jshard
import k8s1m_tpu.faultline as jfault
import k8s1m_tpu.plugins.registry as jreg
import k8s1m_tpu.snapshot.node_table as jnt
import k8s1m_tpu.snapshot.pod_encoding as jpe
import k8s1m_tpu.store.native as jnative
import k8s1m_tpu_torch.config as tconfig
import k8s1m_tpu_torch.control.coordinator as tcoord
import k8s1m_tpu_torch.control.objects as tobj
import k8s1m_tpu_torch.control.shardset as tshard
import k8s1m_tpu_torch.faultline as tfault
import k8s1m_tpu_torch.plugins.registry as treg
import k8s1m_tpu_torch.snapshot.node_table as tnt
import k8s1m_tpu_torch.snapshot.pod_encoding as tpe
import k8s1m_tpu_torch.store.native as tnative

PORT = types.SimpleNamespace(
    name="port", config=tconfig, coord=tcoord, obj=tobj, shard=tshard, fault=tfault,
    reg=treg, nt=tnt, pe=tpe, native=tnative, coord_kw=dict(device="cpu"),
)
JAX = types.SimpleNamespace(
    name="jax", config=jconfig, coord=jcoord, obj=jobj, shard=jshard, fault=jfault,
    reg=jreg, nt=jnt, pe=jpe, native=jnative, coord_kw={},
)
PKGS = (PORT, JAX)
NUM_GROUPS = tshard.NUM_GROUPS
ZERO_DELAY = dict(component="coordinator.bind", base_delay_s=0.0, jitter=0.0)


class Side:
    """One package's half of a scenario: its store, writes and members."""

    def __init__(self, P):
        self.P = P
        self.store = P.native.MemStore()
        self.members = []

    def put_node(self, name, cpu=4000, mem=8 << 20, pods=32):
        labels = {"topology.kubernetes.io/zone": "z0"}
        node = self.P.nt.NodeInfo(name=name, cpu_milli=cpu, mem_kib=mem, pods=pods,
                                  labels=labels)
        self.store.put(self.P.obj.node_key(name), self.P.obj.encode_node(node))

    def put_pod(self, name, ns="default", cpu=100, mem=200 << 10):
        pod = self.P.pe.PodInfo(name=name, namespace=ns, cpu_milli=cpu, mem_kib=mem)
        self.store.put(self.P.obj.pod_key(ns, name), self.P.obj.encode_pod(pod))

    def seed_assignment(self, groups, num_shards):
        a = self.P.shard.Assignment(1, num_shards, list(groups))
        self.store.cas(self.P.shard.ASSIGN_KEY, a.encode(), required_version=0)

    def make_member(self, idx, n):
        P = self.P
        c = P.coord.Coordinator(
            self.store, P.config.TableSpec(max_nodes=64, max_zones=16, max_regions=8),
            P.config.PodSpec(batch=16), P.reg.Profile(topology_spread=0, interpod_affinity=0),
            chunk=32, k=4, with_constraints=False,
            retry_policy=P.fault.RetryPolicy(**ZERO_DELAY), **P.coord_kw,
        )
        m = P.shard.ShardMember(self.store, c, idx, n)
        self.members.append(m)
        return m

    def rebalancer(self, n, **kw):
        return self.P.shard.Rebalancer(self.store, self.members[0].coordinator.host, n, **kw)

    def stored_pods(self):
        kvs, _ = self.P.native.list_prefix(self.store, b"/registry/pods/")
        return [(kv.key, kv.value) for kv in kvs]

    def bound_node(self, ns, name):
        kv = self.store.get(self.P.obj.pod_key(ns, name))
        return json.loads(kv.value)["spec"].get("nodeName")

    def close(self):
        for m in self.members:
            m.close()
        self.store.close()


class Lock:
    """The two sides of one scenario, stepped and compared together."""

    def __init__(self):
        self.t, self.j = Side(PORT), Side(JAX)

    def each(self, fn):
        return fn(self.t), fn(self.j)

    def start(self, n, now=0.0):
        for i in range(n):
            self.t.make_member(i, n)
            self.j.make_member(i, n)
        for tm, jm in zip(self.t.members, self.j.members):
            tm.start(now=now)
            jm.start(now=now)
        self.check()

    def tick(self, i, now):
        got = self.t.members[i].tick(now)
        want = self.j.members[i].tick(now)
        assert got == want
        return got

    def masks(self):
        return [m.coordinator._row_mask_np for m in self.t.members]

    def check(self):
        """Masks, claimed and pending groups, and the stored assignment equal
        the JAX members' and store's."""
        for tm, jm in zip(self.t.members, self.j.members):
            np.testing.assert_array_equal(tm.coordinator._row_mask_np,
                                          jm.coordinator._row_mask_np)
            assert tm._claimed == jm._claimed and tm._pending_claim == jm._pending_claim
            assert tm.assignment.encode() == jm.assignment.encode()
        ta, ja = (tshard.load_assignment(self.t.store), jshard.load_assignment(self.j.store))
        assert (ta is None) == (ja is None)
        if ta is not None:
            assert (ta.encode(), ta.mod_revision) == (ja.encode(), ja.mod_revision)

    def run_until_idle(self, max_ticks=200):
        """Round-robin member ticks (both packages) until no member has work."""
        bound, now = 0, 0.0
        for _ in range(max_ticks):
            now += 1.0
            progressed = sum(self.tick(i, now) for i in range(len(self.t.members)))
            self.check()
            bound += progressed
            if progressed == 0:
                # Zero-delay retries: a parked pod is released on the next tick.
                if any(m.coordinator._backoff for m in self.t.members):
                    continue
                if all(not m.coordinator.queue and not m.coordinator._inflights
                       for m in self.t.members):
                    break
        assert all(not m.coordinator._backoff for m in self.j.members)
        return bound

    def check_pods(self):
        pods = self.t.stored_pods()
        assert pods == self.j.stored_pods()
        return pods

    def close(self):
        self.t.close()
        self.j.close()


@pytest.fixture()
def lock():
    pair = Lock()
    yield pair
    pair.close()


# ---- hashes, codec and the pure rebalance function ---------------------------


def _names(seed, n=200):
    rng = np.random.default_rng(seed)
    alphabet = np.array(list("abcdefghijklmnopqrstuvwxyz0123456789-./"))
    out = []
    for _ in range(n):
        k = int(rng.integers(1, 40))
        out.append("".join(rng.choice(alphabet, size=k)))
    return out + ["", "default/p0", "kwok-node-1048575", "ü/ñ"]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hashes_equal_jax_on_random_names(seed):
    names = _names(seed)
    for name in names:
        assert tshard.fnv32(name) == jshard.fnv32(name)
        assert tshard.group_of(name) == jshard.group_of(name)
        for n in (1, 2, 3, 4, 7, 256):
            assert tshard.pod_shard(name, n) == jshard.pod_shard(name, n)
    # The port's vectorized fold of many names at once.
    got = tshard.groups_of(names)
    assert got.dtype == np.int32
    assert got.tolist() == [jshard.group_of(n) for n in names]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_assignment_codec_equals_jax(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 9))
    groups = [int(g) for g in rng.integers(0, n, NUM_GROUPS)]
    version = int(rng.integers(1, 1 << 20))
    got = tshard.Assignment(version, n, groups).encode()
    assert got == jshard.Assignment(version, n, groups).encode()
    back = tshard.Assignment.decode(got, 17)
    assert (back.version, back.num_shards, back.groups, back.mod_revision) == (
        version, n, groups, 17)
    with pytest.raises(ValueError, match="expected 256"):
        tshard.Assignment.decode(json.dumps(
            {"version": 1, "numShards": 1, "groups": [0] * 3}).encode())


@pytest.mark.parametrize("seed", range(6))
def test_rebalance_equals_jax_on_random_loads(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 6))
    load = rng.integers(0, 50, NUM_GROUPS).astype(np.int64)
    groups = [int(g) for g in rng.integers(0, n, NUM_GROUPS)]
    alive = {int(s) for s in rng.choice(n, size=int(rng.integers(1, n + 1)), replace=False)}
    for cap in (0, 5, 32, 1000):
        got = tshard.rebalance_groups(groups, load, alive, cap)
        assert got == jshard.rebalance_groups(groups, load, alive, cap)
        assert all(g in alive for g in got)


def test_rebalance_evens_out_and_minimizes_moves():
    load = np.ones(NUM_GROUPS, np.int64)
    groups = [0] * NUM_GROUPS
    out = tshard.rebalance_groups(groups, load, alive={0, 1}, max_moves=1000)
    assert out == jshard.rebalance_groups(groups, load, alive={0, 1}, max_moves=1000)
    c0, c1 = out.count(0), out.count(1)
    assert abs(c0 - c1) <= 1
    assert sum(1 for a, b in zip(groups, out) if a != b) == c1


def test_rebalance_respects_move_cap():
    load = np.ones(NUM_GROUPS, np.int64)
    out = tshard.rebalance_groups([0] * NUM_GROUPS, load, alive={0, 1}, max_moves=5)
    assert out == jshard.rebalance_groups([0] * NUM_GROUPS, load, alive={0, 1}, max_moves=5)
    assert sum(1 for g in out if g == 1) == 5


def test_rebalance_evacuates_dead_shards_past_cap():
    load = np.ones(NUM_GROUPS, np.int64)
    groups = [g % 3 for g in range(NUM_GROUPS)]
    out = tshard.rebalance_groups(groups, load, alive={0, 1}, max_moves=0)
    assert out == jshard.rebalance_groups(groups, load, alive={0, 1}, max_moves=0)
    assert all(g in (0, 1) for g in out)


def test_rebalance_noop_when_balanced():
    load = np.ones(NUM_GROUPS, np.int64)
    groups = [g % 2 for g in range(NUM_GROUPS)]
    assert tshard.rebalance_groups(groups, load, alive={0, 1}) == groups
    assert jshard.rebalance_groups(groups, load, alive={0, 1}) == groups


# ---- multi-coordinator end to end --------------------------------------------


def test_shards_split_pods_and_nodes_disjointly(lock):
    n_shards = 3
    rng = np.random.default_rng(0)
    cpus = [int(c) for c in rng.integers(50, 200, 60)]
    for side in (lock.t, lock.j):
        for i in range(24):
            side.put_node(f"n{i}")
        for i in range(60):
            side.put_pod(f"p{i}", cpu=cpus[i])
    lock.start(n_shards)

    masks = lock.masks()
    union = np.zeros_like(masks[0])
    for a in masks:
        for b in masks:
            if a is not b:
                assert not (a & b).any()
        union |= a
    assert union.sum() == 24

    assert lock.run_until_idle() == 60
    lock.check_pods()
    asg = tshard.load_assignment(lock.t.store)
    for i in range(60):
        node = lock.t.bound_node("default", f"p{i}")
        assert node is not None, f"p{i} never bound"
        assert asg.groups[tshard.group_of(node)] == tshard.pod_shard(f"default/p{i}", n_shards)


def test_intake_filter_excludes_foreign_pods(lock):
    for side in (lock.t, lock.j):
        for i in range(8):
            side.put_node(f"n{i}")
        for i in range(40):
            side.put_pod(f"p{i}")
    # One member of a two-shard set: only shard 0 runs.
    tm, jm = lock.t.make_member(0, 2), lock.j.make_member(0, 2)
    tm.start(now=0.0)
    jm.start(now=0.0)
    mine = [i for i in range(40) if tshard.pod_shard(f"default/p{i}", 2) == 0]
    lock.run_until_idle()
    lock.check_pods()
    for i in range(40):
        node = lock.t.bound_node("default", f"p{i}")
        if i in mine:
            assert node is not None
        else:
            assert node is None


def test_external_binds_fold_into_every_shard(lock):
    """A pod bound by shard 1 appears in shard 0's usage accounting."""
    for side in (lock.t, lock.j):
        for i in range(4):
            side.put_node(f"n{i}")
        for i in range(20):
            side.put_pod(f"p{i}", cpu=500)
    lock.start(2)
    lock.run_until_idle()
    lock.check_pods()
    total_req = [int(m.coordinator.host.cpu_req.sum()) for m in lock.t.members]
    assert total_req[0] == total_req[1] == 20 * 500
    for tm, jm in zip(lock.t.members, lock.j.members):
        np.testing.assert_array_equal(tm.coordinator.host.cpu_req, jm.coordinator.host.cpu_req)


def test_rebalancer_rebalances_skew_and_members_follow(lock):
    n_shards = 2
    for side in (lock.t, lock.j):
        for i in range(32):
            side.put_node(f"n{i}")
        side.seed_assignment([0] * NUM_GROUPS, n_shards)
    lock.start(n_shards)
    assert lock.masks()[1].sum() == 0

    rebs = lock.each(lambda s: s.rebalancer(n_shards, min_interval=0.0,
                                            max_moves=NUM_GROUPS, dead_after=60.0))
    assert [r.run_once(now=1.0, force=True) for r in rebs] == [True, True]
    lock.check()
    for t in (2.0, 3.0):
        for i in range(n_shards):
            lock.tick(i, t)
        lock.check()
    owned = [int(m.sum()) for m in lock.masks()]
    assert sum(owned) == 32
    assert abs(owned[0] - owned[1]) <= max(2, 32 // 4)


def test_rebalancer_evacuates_dead_member(lock):
    n_shards = 2
    for side in (lock.t, lock.j):
        for i in range(16):
            side.put_node(f"n{i}")
    lock.start(n_shards)
    for side in (lock.t, lock.j):
        side.members[0].heartbeat(now=100.0)       # shard 1 goes silent
    rebs = lock.each(lambda s: s.rebalancer(n_shards, min_interval=0.0, dead_after=15.0))
    assert [r.alive_shards(100.0) for r in rebs] == [{0}, {0}]
    assert [r.run_once(now=100.0, force=True) for r in rebs] == [True, True]
    lock.tick(0, 101.0)
    lock.tick(0, 102.0)                            # the deferred claim lands
    lock.check()
    assert lock.masks()[0].sum() == 16
    assert np.array_equal(rebs[0].group_loads(), rebs[1].group_loads())


def test_init_assignment_races_converge(lock):
    for side in (lock.t, lock.j):
        a1 = side.P.shard.init_assignment(side.store, 3)
        a2 = side.P.shard.init_assignment(side.store, 3)
        assert a1.groups == a2.groups and a1.version == a2.version
    lock.check()


def test_drop_before_claim_handoff(lock):
    """During a rebalance the donor drops a group before the receiver claims
    it: no tick has two masks overlapping, and moved nodes are briefly owned
    by nobody rather than by both."""
    for side in (lock.t, lock.j):
        for i in range(16):
            side.put_node(f"n{i}")
        side.seed_assignment([0] * NUM_GROUPS, 2)
    lock.start(2)
    rebs = lock.each(lambda s: s.rebalancer(2, min_interval=0.0, max_moves=NUM_GROUPS,
                                            dead_after=60.0))
    assert [r.run_once(now=1.0, force=True) for r in rebs] == [True, True]

    for i in range(2):
        lock.tick(i, 2.0)
    lock.check()
    m0, m1 = lock.masks()
    assert not (m0 & m1).any()
    assert m1.sum() == 0
    assert m0.sum() < 16

    for i in range(2):
        lock.tick(i, 3.0)
    lock.check()
    m0, m1 = lock.masks()
    assert not (m0 & m1).any()
    assert m0.sum() + m1.sum() == 16


def test_row_reuse_folds_like_jax(lock):
    """A deleted node frees its row and a new node takes it: the members'
    journal fold, masks and group loads equal the JAX members' after every
    tick."""
    for side in (lock.t, lock.j):
        for i in range(16):
            side.put_node(f"n{i}")
    lock.start(2)
    for side in (lock.t, lock.j):
        side.store.put_batch([(side.P.obj.node_key("n3"), None),
                              (side.P.obj.node_key("n7"), None)])
    for i in range(2):
        lock.tick(i, 1.0)
    lock.check()
    for side in (lock.t, lock.j):
        side.put_node("n99")
        side.put_node("n100")
    for i in range(2):
        lock.tick(i, 2.0)
    lock.check()
    for tm, jm in zip(lock.t.members, lock.j.members):
        np.testing.assert_array_equal(tm._row_group, jm._row_group)
    assert int(sum(m.sum() for m in lock.masks())) == 16
    rebs = lock.each(lambda s: s.rebalancer(2))
    np.testing.assert_array_equal(rebs[0].group_loads(), rebs[1].group_loads())
