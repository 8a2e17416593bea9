"""The port's kubelet-faithful node agent (``cluster/kubelet_sim.py``) and
the KWOK-vs-kubelet A/B (``tools/fidelity_ab.py``) against the JAX
package's, on the CPU.

Every case of ``tests/test_kubelet_sim.py`` runs its script twice: on a
JAX ``MemStore`` with the JAX ``KubeletPool`` and on a port ``MemStore``
with the port's pool.  The JAX test's assertions hold on the port's side,
and the two stores must hold the same keys with the same values,
revisions and versions, the pools the same soft state, and the
``kubelet_sim_writes_total`` counters the same deltas.  The A/B reports
of both tools at a small shape must be equal.

Tolerance: exact equality.
"""

import _torch_cpu  # noqa: F401  (bounds torch's CPU threads first)

import contextlib
import io
import json

import pytest

import k8s1m_tpu.cluster.kubelet_sim as jsim
import k8s1m_tpu.control.objects as jobjects
import k8s1m_tpu.snapshot.node_table as jnode_table
import k8s1m_tpu.snapshot.pod_encoding as jpod_encoding
import k8s1m_tpu.store.native as jnative
from k8s1m_tpu_torch.cluster import kubelet_sim as tsim
from k8s1m_tpu_torch.control import objects as tobjects
from k8s1m_tpu_torch.snapshot import node_table as tnode_table
from k8s1m_tpu_torch.snapshot import pod_encoding as tpod_encoding
from k8s1m_tpu_torch.store import native as tnative


class Pkg:
    """One package's side of a twin: its store, pool and encoders."""

    def __init__(self, sim, objects, node_table, pod_encoding, native):
        self.sim, self.o, self.nt, self.pe, self.n = sim, objects, node_table, pod_encoding, native


JAX = Pkg(jsim, jobjects, jnode_table, jpod_encoding, jnative)
PORT = Pkg(tsim, tobjects, tnode_table, tpod_encoding, tnative)
KINDS = ("event", "pod_status", "lease", "node_status", "node_status_conflict")


def setup_pool(pkg, store, nodes=3):
    for i in range(nodes):
        store.put(pkg.o.node_key(f"n{i}"), pkg.o.encode_node(pkg.nt.NodeInfo(f"n{i}")))
    pool = pkg.sim.KubeletPool(store)
    pool.bootstrap(0.0)
    return pool


def bind_pod(pkg, store, name, node):
    store.put(pkg.o.pod_key("default", name),
              pkg.o.encode_pod(pkg.pe.PodInfo(name, node_name=node)))


def _writes(pkg) -> dict:
    return {k: pkg.sim._WRITES.value(kind=k) for k in KINDS}


def _dump(store) -> list:
    res = store.range(b"\x00", b"\xff")
    return [(kv.key, kv.value, kv.create_revision, kv.mod_revision, kv.version)
            for kv in res.kvs] + [store.current_revision]


def twin(scenario) -> tuple:
    """Run ``scenario(pkg, store)`` on both packages; the stores, the
    pools' soft state and the write-counter deltas must be equal.  Returns
    the port's (store, pool, scenario result) with the store still open."""
    out = {}
    for name, pkg in (("jax", JAX), ("port", PORT)):
        store = pkg.n.MemStore()
        before = _writes(pkg)
        pool, res = scenario(pkg, store)
        after = _writes(pkg)
        out[name] = {
            "dump": _dump(store),
            "soft": (sorted(pool.nodes.items()), sorted(pool._starting), sorted(pool.running_pods),
                     sorted(pool._node_mod.items()), sorted(pool._next_renewal.items()),
                     sorted(pool._next_status.items())),
            "writes": {k: after[k] - before[k] for k in KINDS},
            "store": store, "pool": pool, "res": res,
        }
    j, t = out["jax"], out["port"]
    try:
        assert t["dump"] == j["dump"]
        assert t["soft"] == j["soft"]
        assert t["writes"] == j["writes"]
    finally:
        j["pool"].close()
        j["store"].close()
    return t["store"], t["pool"], t["res"]


@pytest.fixture
def closing():
    opened = []
    yield opened.append
    for pool, store in opened:
        pool.close()
        store.close()


def test_pod_starts_in_stages_with_events(closing):
    def scenario(pkg, store):
        pool = setup_pool(pkg, store)
        bind_pod(pkg, store, "p0", "n0")
        pool.tick(1.0)   # observe + ContainerCreating
        creating = json.loads(store.get(pkg.o.pod_key("default", "p0")).value)
        starting = "default/p0" in pool._starting
        pool.tick(2.0)   # Running
        return pool, (creating, starting)

    store, pool, (creating, starting) = twin(scenario)
    closing((pool, store))
    assert creating["status"]["reason"] == "ContainerCreating" and starting
    obj = json.loads(store.get(tobjects.pod_key("default", "p0")).value)
    assert obj["status"]["phase"] == "Running"
    assert "default/p0" in pool.running_pods
    evs = store.range(b"/registry/events/", tnative.prefix_end(b"/registry/events/"))
    reasons = sorted(json.loads(kv.value)["reason"] for kv in evs.kvs)
    assert reasons == ["Created", "Pulled", "Scheduled", "Started"]


def test_node_heartbeats_and_leases(closing):
    def scenario(pkg, store):
        pool = setup_pool(pkg, store, nodes=2)
        rev0 = store.current_revision
        for t in range(1, 22):
            pool.tick(float(t))
        return pool, rev0

    store, pool, rev0 = twin(scenario)
    closing((pool, store))
    pfx = b"/registry/leases/kube-node-lease/"
    assert store.range(pfx, tnative.prefix_end(pfx)).count == 2
    assert store.current_revision - rev0 >= 8
    node = json.loads(store.get(tobjects.node_key("n0")).value)
    assert node["metadata"]["name"] == "n0"


def test_status_cas_conflict_rebases(closing):
    def scenario(pkg, store):
        pool = setup_pool(pkg, store)
        bind_pod(pkg, store, "p0", "n0")
        pool.tick(1.0)
        kv = store.get(pkg.o.pod_key("default", "p0"))
        obj = json.loads(kv.value)
        obj["metadata"]["labels"] = {"touched": "yes"}
        store.put(pkg.o.pod_key("default", "p0"), json.dumps(obj).encode())
        pool.tick(2.0)   # CAS fails, rebases
        pool.tick(3.0)   # succeeds
        return pool, None

    store, pool, _ = twin(scenario)
    closing((pool, store))
    obj = json.loads(store.get(tobjects.pod_key("default", "p0")).value)
    assert obj["status"]["phase"] == "Running"
    assert obj["metadata"]["labels"] == {"touched": "yes"}


def test_node_delete_stops_heartbeats(closing):
    def scenario(pkg, store):
        pool = setup_pool(pkg, store, nodes=2)
        store.delete(pkg.o.node_key("n0"))
        store.delete(pkg.o.lease_key("kube-node-lease", "n0"))
        for t in range(1, 25):
            pool.tick(float(t))
        return pool, None

    store, pool, _ = twin(scenario)
    closing((pool, store))
    assert store.get(tobjects.node_key("n0")) is None
    assert store.get(tobjects.lease_key("kube-node-lease", "n0")) is None
    assert "n0" not in pool.nodes
    assert store.get(tobjects.node_key("n1")) is not None


def test_pod_deleted_mid_startup(closing):
    def scenario(pkg, store):
        pool = setup_pool(pkg, store)
        bind_pod(pkg, store, "p0", "n0")
        pool.tick(1.0)
        store.delete(pkg.o.pod_key("default", "p0"))
        pool.tick(2.0)
        pool.tick(3.0)
        return pool, None

    store, pool, _ = twin(scenario)
    closing((pool, store))
    assert "default/p0" not in pool._starting
    assert "default/p0" not in pool.running_pods


def test_node_heartbeat_never_clobbers_external_update(closing):
    def scenario(pkg, store):
        pool = setup_pool(pkg, store)
        pool.tick(1.0)
        kv = store.get(pkg.o.node_key("n0"))
        obj = json.loads(kv.value)
        obj["metadata"].setdefault("labels", {})["moved"] = "yes"
        store.put(pkg.o.node_key("n0"), json.dumps(obj, separators=(",", ":")).encode())
        pool.tick(100.0)
        pool.tick(200.0)
        return pool, None

    store, pool, _ = twin(scenario)
    closing((pool, store))
    final = json.loads(store.get(tobjects.node_key("n0")).value)
    assert final["metadata"]["labels"]["moved"] == "yes"


def test_watch_overflow_resyncs_like_jax(closing):
    """A dropped watch resets every piece of soft state and relists, in
    both packages alike (the resync contract at the top of ``tick``)."""
    def scenario(pkg, store):
        pool = setup_pool(pkg, store)
        bind_pod(pkg, store, "p0", "n0")
        pool.tick(1.0)
        pool._pods_watch.cancel()
        pool._pods_watch = store.watch(b"/registry/pods/", b"/registry/pods0",
                                       start_revision=store.current_revision + 1, queue_cap=1)
        bind_pod(pkg, store, "p1", "n1")
        bind_pod(pkg, store, "p2", "n2")
        dropped = pool._pods_watch.dropped > 0
        for t in (2.0, 3.0, 4.0):
            pool.tick(t)
        return pool, dropped

    store, pool, dropped = twin(scenario)
    closing((pool, store))
    assert dropped
    assert pool.running_pods == {"default/p0", "default/p1", "default/p2"}


def test_fidelity_ab_report_equals_jax():
    """The two tools' reports at 256 nodes x 300 pods, 20 simulated
    seconds: the same write, key, event and lease counts and DB sizes."""
    from k8s1m_tpu.tools import fidelity_ab as jfidelity
    from k8s1m_tpu_torch.tools import fidelity_ab

    argv = ["--nodes", "256", "--pods", "300", "--sim-seconds", "20", "--batch", "64"]
    with contextlib.redirect_stdout(io.StringIO()):
        port = fidelity_ab.main(argv + ["--device", "cpu"])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jfidelity.main(argv)
    assert port == json.loads(buf.getvalue())
    assert port["kwok"]["bound"] == port["kubelet_sim"]["bound"] == 300
    assert port["kubelet_sim"]["events"] == 4 * 300 and port["kwok"]["events"] == 0
