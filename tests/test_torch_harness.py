"""The port's cluster harness (``k8s1m_tpu_torch/cluster/harness.py``) on
the CPU, against the JAX package's.

Every case of ``tests/test_harness.py`` and the harness case of
``tests/test_tier_replicas.py``, with the same shapes and assertions, on
the port's ``Cluster`` (``device="cpu"``): the store and the tier replicas
run as the port's children (``python -m k8s1m_tpu_torch.store.server_main``
and ``...store.watch_cache``) and every component crosses the wire.  Then
the lockstep: a JAX ``Cluster`` and a port ``Cluster`` driven through the
same tick-driven script at 128 nodes, directly and behind the secured
watch-cache tier, each tick behind a barrier that waits until every watch
of every component has seen every event of its prefix; the stored pods'
values must be byte-identical, the nodes' values and revisions too, and
the pods bound per tick equal (the ticks after the last bind, which only
wait for KWOK, left out).

Tolerance: exact equality.
"""

import _torch_cpu  # noqa: F401  (bounds torch's CPU threads first)

import glob
import json
import os
import ssl
import subprocess
import sys
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from k8s1m_tpu_torch.cluster.harness import Cluster, ClusterSpec
from k8s1m_tpu_torch.control.objects import encode_pod, pod_key
from k8s1m_tpu_torch.control.shardset import group_of, load_assignment, pod_shard
from k8s1m_tpu_torch.snapshot.pod_encoding import PodInfo
from k8s1m_tpu_torch.store.native import prefix_end
from k8s1m_tpu_torch.store.remote import RemoteStore
from k8s1m_tpu_torch.store.wire import StatusCode, WireError

PODS = b"/registry/pods/"
NODES = b"/registry/minions/"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pods(store) -> list:
    return [json.loads(kv.value) for kv in store.range(PODS, prefix_end(PODS)).kvs]


@pytest.fixture(scope="module")
def cluster():
    spec = ClusterSpec(
        nodes=64, kwok_groups=2, coordinators=2, pod_batch=16, chunk=64,
        wal_mode="none", device="cpu",
    )
    with Cluster(spec) as c:
        c.make_nodes()
        yield c


def test_leader_elected_and_nodes_adopted(cluster):
    cluster.tick(0.0)
    assert cluster.leader is not None
    assert cluster.leader.coord.host.num_nodes == 64
    assert cluster.leader.coord.device.type == "cpu"
    # KWOK controllers adopted their groups and renewed leases.
    assert sum(len(k.nodes) for k in cluster.kwoks) == 64
    stats = cluster.tick(1.0)
    assert stats["leases_renewed"] >= 0
    # The standby holds no coordinator and binds nothing.
    standby = [ha for ha in cluster.coordinators if ha is not cluster.leader]
    assert len(standby) == 1 and standby[0].coord is None


def test_pods_scheduled_end_to_end(cluster):
    stats = cluster.run_pods(40, max_ticks=50)
    assert stats["bound"] == 40
    assert stats["running"] == 40
    assert stats["binds_per_sec"] > 0
    # Every pod really is bound+Running in the store.
    byname = {o["metadata"]["name"]: o for o in _pods(cluster._clients[0])}
    for i in range(40):
        obj = byname[f"{stats['prefix']}-{i}"]
        assert obj["spec"]["nodeName"]
        assert obj["status"]["phase"] == "Running"
    # The ticks' host seconds are split among the components.
    assert set(cluster.tick_seconds) == {"coordinator", "kwok", "compaction"}
    assert cluster.tick_seconds["coordinator"] > 0 and cluster.tick_seconds["kwok"] > 0


def test_webhook_path_end_to_end(cluster):
    stats = cluster.run_pods(10, via_webhook=True, max_ticks=50)
    assert stats["bound"] == 10
    store = cluster._clients[0]
    obj = json.loads(store.get(pod_key("default", f"{stats['prefix']}-0")).value)
    assert obj["spec"]["nodeName"]


def test_webhook_tls_end_to_end():
    """Intake over HTTPS with rig-provisioned certs (``cluster/certs.py``):
    run_pods' webhook client trusts only the rig CA, so a bound pod proves
    the whole chain: provision -> serve -> verify -> admit -> schedule."""
    spec = ClusterSpec(
        nodes=16, kwok_groups=1, coordinators=1, pod_batch=8, chunk=16,
        wal_mode="none", webhook_tls=True, device="cpu",
    )
    with Cluster(spec) as c:
        c.make_nodes()
        stats = c.run_pods(6, via_webhook=True, max_ticks=50)
        assert stats["bound"] == 6
        # Verification is real: a client that does NOT trust the rig CA
        # fails the handshake.
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
        with pytest.raises(urllib.error.URLError):
            urllib.request.urlopen(f"https://127.0.0.1:{c.webhook.port}/validate",
                                   timeout=5, context=ctx)


def test_leases_written_on_wire(cluster):
    # A full renew interval (10s) of simulated time must elapse for every
    # node's staggered first renewal to come due.
    for _ in range(12):
        cluster.tick()
    store = cluster._clients[0]
    pfx = b"/registry/leases/kube-node-lease/"
    res = store.range(pfx, prefix_end(pfx))
    assert res.count == 64
    lease = json.loads(res.kvs[0].value)
    assert lease["spec"]["leaseDurationSeconds"] == 40


def test_store_crash_recovery_via_wal(tmp_path):
    """Kill the store server mid-run: WAL replay restores state, the
    coordinators and KWOK controllers resync over their broken streams,
    and scheduling continues."""
    spec = ClusterSpec(
        nodes=32, kwok_groups=1, coordinators=1, pod_batch=16, chunk=64,
        wal_mode="buffered", no_write_prefixes=(), device="cpu",
    )
    with Cluster(spec, wal_dir=str(tmp_path)) as c:
        c.make_nodes()
        c.tick()
        stats = c.run_pods(10, max_ticks=30)
        assert stats["bound"] == 10

        c.restart_store()
        # Everything written before the crash survived the WAL.
        store = c._clients[0]
        assert store.range(NODES, prefix_end(NODES)).count == 32

        # Consumers detect the broken streams, resync, and keep working.
        stats = c.run_pods(10, max_ticks=60)
        assert stats["bound"] == 10
        assert stats["running"] == 10


def test_shard_set_cluster_schedules_and_stays_disjoint():
    """Shard-mode control plane: 3 cooperating coordinators over the wire
    split pods by FNV hash and nodes by ownership masks; every pod binds
    exactly once and on a node its owning shard controls."""
    spec = ClusterSpec(
        nodes=48, kwok_groups=1, shards=3, pod_batch=16, chunk=16,
        wal_mode="none", rebalance_interval_s=1e9, device="cpu",
    )
    with Cluster(spec) as c:
        c.make_nodes()
        stats = c.run_pods(60, max_ticks=80)
        assert stats["bound"] == 60

        masks = [m.coordinator._row_mask_np for m in c.shard_members]
        union = np.zeros_like(masks[0])
        for i, a in enumerate(masks):
            for b in masks[i + 1:]:
                assert not (a & b).any()
            union |= a
        assert union.sum() == 48

        asg = load_assignment(c._clients[0])
        checked = 0
        for obj in _pods(c._clients[0]):
            node = obj["spec"].get("nodeName")
            name = obj["metadata"]["name"]
            if not name.startswith(stats["prefix"]):
                continue
            assert node, f"{name} unbound"
            assert asg.groups[group_of(node)] == pod_shard(f"default/{name}", 3)
            checked += 1
        assert checked == 60

        # A forced rebalance over the wire: masks stay DISJOINT at every
        # tick and become full again once deferred claims land (the
        # assignment travels a real watch, so tick with a short real
        # sleep between attempts).
        c._rebalancer.run_once(c.now, force=True)
        for attempt in range(100):
            for m in c.shard_members:
                m.tick(c.now + 1.0 + attempt)
            union = np.zeros_like(masks[0])
            fresh = [m.coordinator._row_mask_np for m in c.shard_members]
            for i, a in enumerate(fresh):
                for b in fresh[i + 1:]:
                    assert not (a & b).any()
                union |= a
            if union.sum() == 48:
                break
            time.sleep(0.02)
        assert union.sum() == 48


def test_cluster_behind_watch_cache_tier():
    """KWOK controllers list/watch/write through the port's watch-cache
    child; scheduling completes and pods reach Running via tier-proxied
    status writes."""
    spec = ClusterSpec(
        nodes=32, kwok_groups=2, coordinators=1, pod_batch=16, chunk=64,
        wal_mode="none", watch_cache=True, device="cpu",
    )
    with Cluster(spec) as c:
        assert c.tier_port is not None and c.tier_port != c.port
        c.make_nodes()
        stats = c.run_pods(20, max_ticks=60)
        assert stats["bound"] == 20
        assert stats["running"] == 20
        for obj in _pods(c._clients[0]):
            assert obj["spec"]["nodeName"]
            assert obj["status"]["phase"] == "Running"


def test_cluster_behind_secured_tier():
    """The tier serves TLS + bearer auth; KWOK controllers authenticate
    with the rig CA + token and the experiment completes.  A client with
    the CA but no token is refused UNAUTHENTICATED."""
    spec = ClusterSpec(
        nodes=32, kwok_groups=2, coordinators=1, pod_batch=16, chunk=64,
        wal_mode="none", watch_cache=True, tier_tls=True, device="cpu",
    )
    with Cluster(spec) as c:
        assert c.tier_token is not None
        c.make_nodes()
        stats = c.run_pods(12, max_ticks=60)
        assert stats["bound"] == 12
        assert stats["running"] == 12
        bare = RemoteStore(f"127.0.0.1:{c.tier_port}", ca_pem=c.certs.ca_pem)
        try:
            with pytest.raises(WireError) as ei:
                bare.get(b"/registry/pods/x")
            assert ei.value.code == StatusCode.UNAUTHENTICATED
        finally:
            bare.close()


def test_shard_set_behind_watch_cache_tier():
    """N scheduler shards + the apiserver tier in one cluster: shards split
    the pod stream, KWOK runs behind the tier, every pod lands once."""
    spec = ClusterSpec(
        nodes=32, kwok_groups=2, shards=2, pod_batch=16, chunk=64,
        wal_mode="none", watch_cache=True, device="cpu",
    )
    with Cluster(spec) as c:
        c.make_nodes()
        stats = c.run_pods(24, max_ticks=80)
        assert stats["bound"] == 24
        objs = _pods(c._clients[0])
        assert len(objs) == 24 and all(o["spec"]["nodeName"] for o in objs)
        # Both shards actually scheduled (pod-hash split is ~even at 24).
        assert all(len(m.coordinator._bound) > 0 for m in c.shard_members)


def test_store_crash_recovery_behind_tier(tmp_path):
    """Store crash with the tier deployed: the tier's upstream watch
    breaks, it relists and invalidates (its clients relist), and the
    cluster keeps scheduling through the proxied wire."""
    spec = ClusterSpec(
        nodes=32, kwok_groups=1, coordinators=1, pod_batch=16, chunk=64,
        wal_mode="buffered", no_write_prefixes=(), watch_cache=True, device="cpu",
    )
    with Cluster(spec, wal_dir=str(tmp_path)) as c:
        c.make_nodes()
        c.tick()
        stats = c.run_pods(10, max_ticks=30)
        assert stats["bound"] == 10

        c.restart_store()
        store = c._clients[0]
        assert store.range(NODES, prefix_end(NODES)).count == 32

        # The tier reconnects on a real 0.2 s backoff: tick with real
        # sleeps until the KWOK side has started every bound pod.
        stats = c.run_pods(10, max_ticks=80)
        assert stats["bound"] == 10
        running = stats["running"]
        for _ in range(200):
            if running >= 10:
                break
            time.sleep(0.05)
            c.tick()
            running = sum(1 for o in _pods(store)
                          if o["metadata"]["name"].startswith(stats["prefix"])
                          and o["status"]["phase"] == "Running")
        assert running == 10


def test_log_aggregation_one_jsonl_per_run(tmp_path, monkeypatch):
    """``ClusterSpec.log_dir`` funnels every child's stderr into one
    timestamped JSONL (``obs/logship.py``).  Run from another directory:
    the port's children start from the repository root all the same."""
    monkeypatch.chdir(tmp_path)
    spec = ClusterSpec(
        nodes=16, kwok_groups=1, coordinators=1, pod_batch=8, chunk=16,
        wal_mode="none", watch_cache=True, log_dir=str(tmp_path / "logs"), device="cpu",
    )
    with Cluster(spec) as c:
        c.make_nodes()
        stats = c.run_pods(4)
        assert stats["bound"] == 4
        path = c.log_shipper.path
        # The children are the port's, never the JAX package's.
        assert c._server.args[1:3] == ["-m", "k8s1m_tpu_torch.store.server_main"]
        assert [t.args[1:3] for t in c._tiers] == [["-m", "k8s1m_tpu_torch.store.watch_cache"]]
    assert glob.glob(str(tmp_path / "logs" / "cluster-*.jsonl")) == [path]
    srcs = set()
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            assert {"ts", "src", "line"} <= set(rec)
            srcs.add(rec["src"])
    assert {"store", "tier-0"} <= srcs, srcs


def test_harness_tier_replicas_round_robin_and_kill():
    """``ClusterSpec(tier_replicas=2)`` spawns two tier children; consumers
    round-robin across them; killing one leaves the cluster functional
    with new consumers pinned to the survivor."""
    spec = ClusterSpec(
        nodes=64, kwok_groups=2, coordinators=1, watch_cache=True, tier_replicas=2,
        wal_mode="none", chunk=64, device="cpu",
    )
    cluster = Cluster(spec)
    try:
        assert len(cluster.tier_ports) == 2
        c0 = cluster._kwok_client()
        c1 = cluster._kwok_client()
        assert c0.target != c1.target
        cluster.make_nodes()
        stats = cluster.run_pods(30, max_ticks=60)
        assert stats["bound"] == 30
        cluster.kill_tier_replica(1)
        c2 = cluster._kwok_client()
        c3 = cluster._kwok_client()
        assert c2.target == c3.target
        assert str(cluster.tier_ports[0]) in c2.target
    finally:
        cluster.shutdown()


# ---- spec checks and the device ------------------------------------------------


@pytest.mark.parametrize("bad", [
    dict(watch_cache_index="trie"),
    dict(tier_tls=True),
    dict(tier_replicas=0),
    dict(tier_replicas=2),
    dict(mesh="1x2", shards=2),
])
def test_spec_rejects_what_the_jax_spec_rejects(bad):
    from k8s1m_tpu.cluster.harness import ClusterSpec as JaxSpec

    for cls in (ClusterSpec, JaxSpec):
        with pytest.raises(ValueError):
            cls(**bad)


def test_spec_fields_and_defaults_are_the_jax_specs():
    import dataclasses

    from k8s1m_tpu.cluster.harness import ClusterSpec as JaxSpec

    port = {f.name: f for f in dataclasses.fields(ClusterSpec)}
    jax = {f.name: f for f in dataclasses.fields(JaxSpec)}
    assert set(port) == set(jax) | {"device"}
    for name in jax:
        if name != "profile":
            assert port[name].default == jax[name].default, name
    assert ClusterSpec().device == "cuda" and ClusterSpec().backend == "xla"
    assert dataclasses.astuple(ClusterSpec(nodes=1000).table_spec()) == \
        dataclasses.astuple(JaxSpec(nodes=1000).table_spec())


def test_cuda_without_a_card_raises_before_any_child(monkeypatch):
    import torch

    started = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(subprocess, "Popen", lambda *a, **k: started.append(a))
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        Cluster(ClusterSpec(nodes=16))
    assert started == []


_UP_BLOCKED = r"""
import sys
for name in ("grpc", "google.protobuf", "jax", "k8s1m_tpu"):
    sys.modules[name] = None
from k8s1m_tpu_torch.cluster import up
up.main(sys.argv[1:])
"""


def test_up_from_another_directory(tmp_path):
    """``cluster.up --device cpu`` with grpc, protobuf, JAX and the JAX
    package blocked, from a directory outside the repository, prints the
    JAX tool's summary keys with every pod bound and Running."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run(
        [sys.executable, "-c", _UP_BLOCKED, "--nodes", "64", "--pods", "48",
         "--pod-batch", "16", "--chunk", "64", "--wal-mode", "none", "--device", "cpu"],
        cwd=str(tmp_path), capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    stats = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(stats) == {"pods", "prefix", "created_s", "bound", "running", "total_s",
                          "binds_per_sec"}
    assert stats["bound"] == stats["running"] == 48


# ---- lockstep with the JAX harness ---------------------------------------------


def _watched(cluster) -> list:
    """(watcher, prefix) of every component's live watch."""
    out = []
    for k in cluster.kwoks:
        out += [(k._nodes_watch, NODES), (k._pods_watch, PODS)]
    for ha in cluster.coordinators:
        if ha.coord is not None:
            out += [(ha.coord._nodes_watch, NODES), (ha.coord._pods_watch, PODS)]
    return [(w, p) for w, p in out if w is not None]


def _record_starts(cluster) -> None:
    """Each client's watches remember their start revision (the barrier
    below must not wait for an event a relist already covered)."""
    for client in cluster._clients:
        def watch(*a, _orig=client.watch, **kw):
            w = _orig(*a, **kw)
            w.barrier_start = kw.get("start_revision", 0)
            return w
        client.watch = watch


def _barrier(cluster) -> None:
    """Wait until every component's watch holds every event of its prefix
    up to the store's newest one there."""
    store = cluster._clients[0]
    want = {p: max((kv.mod_revision for kv in store.range(p, prefix_end(p)).kvs), default=0)
            for p in (NODES, PODS)}
    deadline = time.monotonic() + 30
    for w, p in _watched(cluster):
        while w.seen_revision < want[p] and w.barrier_start <= want[p]:
            assert time.monotonic() < deadline, "a watch never caught up"
            time.sleep(0.002)


def _script(cluster, pods: int) -> dict:
    """make_nodes; the first tick (election, bootstraps); the pods in one
    put each; then ticks, each behind the barrier, until every pod is
    bound and Running."""
    _record_starts(cluster)
    cluster.make_nodes()
    cluster.tick(0.0)
    store = cluster._clients[0]
    for i in range(pods):
        store.put(pod_key("default", f"ls-{i}"),
                  encode_pod(PodInfo(f"ls-{i}", cpu_milli=100, mem_kib=200 << 10)))
    per_tick = []
    for _ in range(60):
        _barrier(cluster)
        per_tick.append(cluster.tick()["bound"])
        objs = _pods(store)
        if sum(per_tick) >= pods and all(o["status"]["phase"] == "Running" for o in objs):
            break
    _barrier(cluster)
    leaders = [ha.elector.identity for ha in cluster.coordinators if ha.elector.is_leader]
    # The ticks after the last bind only wait for KWOK, which may or may
    # not see a tick's binds within that same tick: they are left out.
    while per_tick and per_tick[-1] == 0:
        per_tick.pop()
    return {"per_tick": per_tick, "leaders": leaders,
            "nodes": [(kv.key, kv.value, kv.mod_revision)
                      for kv in store.range(NODES, prefix_end(NODES)).kvs],
            "pods": {kv.key: kv.value for kv in store.range(PODS, prefix_end(PODS)).kvs}}


@pytest.mark.parametrize("tier", ["direct", "secured_tier"])
def test_stored_pods_byte_identical_to_jax(tier):
    from k8s1m_tpu.cluster.harness import Cluster as JaxCluster
    from k8s1m_tpu.cluster.harness import ClusterSpec as JaxSpec

    shape = dict(nodes=128, kwok_groups=2, coordinators=2, pod_batch=32, chunk=64,
                 wal_mode="none")
    if tier == "secured_tier":
        shape.update(watch_cache=True, tier_tls=True)
    with JaxCluster(JaxSpec(**shape)) as jc:
        jout = _script(jc, 200)
    with Cluster(ClusterSpec(**shape, device="cpu")) as tc:
        tout = _script(tc, 200)
    assert sum(tout["per_tick"]) == 200
    assert len(tout["leaders"]) == 1
    assert tout["per_tick"] == jout["per_tick"] and tout["leaders"] == jout["leaders"]
    assert len(tout["pods"]) == 200
    assert all(json.loads(v)["status"]["phase"] == "Running" for v in tout["pods"].values())
    assert tout["pods"] == jout["pods"]
    # make_nodes: the JAX harness's bytes at its revisions, in frames.
    assert len(tout["nodes"]) == 128 and tout["nodes"] == jout["nodes"]
