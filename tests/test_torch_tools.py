"""The port's load tools on the CPU: the reference's experiment in
miniature (make_nodes -> KWOK adoption -> make_pods -> scheduling ->
leases -> delete_pods, SURVEY §3.5) through the port's tools, KWOK
controllers and coordinator, held to the JAX package's.

- Twins of ``tests/test_tools.py`` (all but ``test_kernel_probe_runs``,
  which ``tests/test_torch_kernel_probe.py`` covers): the full system, the
  lease flood with the store stress (both lanes), the watch stress against
  the port's own server process, the lease-delay metric, the bounded
  parking lot, ``verify_cluster`` (and its CLI) and ``docs_build``.
- The lockstep case: the same flow once through the JAX tools, the JAX
  coordinator and the JAX controllers, once through the port's, each over
  the wire (``RemoteStore``) against a fresh server of one kind (the JAX
  asyncio server or the port's ``WireFront``), with ``--concurrency 1
  --clients 1`` so that revisions are comparable.  After every step the two
  stores' pods, nodes and leases must be equal: keys, values and
  revisions.

Tolerance: exact bytes.
"""

import _torch_cpu  # noqa: F401  (bounds torch's CPU threads first)

import asyncio
import json
import time

import pytest

import k8s1m_tpu.cluster.kwok_controller as jkwok
import k8s1m_tpu.config as jconfig
import k8s1m_tpu.control.coordinator as jcoord
import k8s1m_tpu.plugins.registry as jreg
import k8s1m_tpu.store.remote as jremote
import k8s1m_tpu.tools.delete_pods as jdelete_pods
import k8s1m_tpu.tools.make_nodes as jmake_nodes
import k8s1m_tpu.tools.make_pods as jmake_pods
import k8s1m_tpu.tools.watch_stress as jwatch_stress
from k8s1m_tpu.store.etcd_server import serve
from k8s1m_tpu.store.native import MemStore as JaxMemStore
from k8s1m_tpu.tools.docs_build import md_to_html as jax_md_to_html
from k8s1m_tpu_torch.cluster import kwok_controller as kc
from k8s1m_tpu_torch.cluster.kwok_controller import LEASE_NS, KwokController
from k8s1m_tpu_torch.config import PodSpec, TableSpec
from k8s1m_tpu_torch.control.coordinator import Coordinator
from k8s1m_tpu_torch.control.objects import encode_node, encode_pod, node_key, pod_key
from k8s1m_tpu_torch.obs.metrics import REGISTRY
from k8s1m_tpu_torch.plugins.registry import Profile
from k8s1m_tpu_torch.snapshot.node_table import NodeInfo
from k8s1m_tpu_torch.snapshot.pod_encoding import PodInfo
from k8s1m_tpu_torch.store.native import MemStore, WireFront, prefix_end
from k8s1m_tpu_torch.store.remote import RemoteStore
from k8s1m_tpu_torch.store.server_main import serve_subprocess
from k8s1m_tpu_torch.tools import (
    delete_pods,
    docs_build,
    lease_flood,
    make_nodes,
    make_pods,
    store_stress,
    verify_cluster,
    watch_stress,
)
from test_torch_wire import AsyncioServer, NativeServer

PODS = b"/registry/pods/"
NODES = b"/registry/minions/"
LEASES = f"/registry/leases/{LEASE_NS}/".encode()
PROFILE = dict(topology_spread=0, interpod_affinity=0)


@pytest.fixture()
def env():
    """The port's ``WireFront`` over the port's MemStore; the tools reach it
    over the wire, the controllers and the coordinator in-process (the
    shape of the JAX test's fixture)."""
    store = MemStore()
    wf = WireFront(store)
    yield store, f"127.0.0.1:{wf.port}"
    wf.close()
    store.close()


def run_tool(mod, argv):
    return asyncio.run(mod.amain(mod.parse_args(argv)))


def test_full_system_make_nodes_pods_schedule_run(env):
    store, target = env
    base = ["--target", target, "--quiet", "--concurrency", "16", "--clients", "2"]

    out = run_tool(make_nodes, base + ["--count", "40", "--zones", "4"])
    assert out["count"] == 40 and out["errors"] == 0

    controllers = [KwokController(store, g) for g in range(10)]
    for c in controllers:
        c.bootstrap(now=0.0)
    assert sum(len(c.nodes) for c in controllers) == 40

    out = run_tool(make_pods, base + ["--count", "60"])
    assert out["count"] == 60 and out["errors"] == 0

    coord = Coordinator(store, TableSpec(max_nodes=64, max_zones=8, max_regions=8),
                        PodSpec(batch=32), Profile(**PROFILE), chunk=32, k=4,
                        with_constraints=False, device="cpu")
    coord.bootstrap()
    assert coord.run_until_idle() == 60

    for t in (10.0, 20.0):
        for c in controllers:
            c.tick(now=t)
    assert sum(len(c.running_pods) for c in controllers) == 60
    assert store.range(LEASES, prefix_end(LEASES), count_only=True).count == 40
    phases = {json.loads(kv.value)["status"]["phase"] for kv in store.range(PODS, b"/registry/pods0").kvs}
    assert phases == {"Running"}

    out = run_tool(delete_pods, base + ["--prefix", "bench-pod"])
    assert out["count"] == 60
    assert store.range(PODS, b"/registry/pods0", count_only=True).count == 0
    coord.close()
    for c in controllers:
        c.close()


@pytest.mark.parametrize("batch", [0, 16])
def test_lease_flood_and_store_stress(env, batch):
    store, target = env
    base = ["--target", target, "--quiet", "--concurrency", "8", "--clients", "2"]
    out = run_tool(lease_flood, base + ["--nodes", "20", "--rounds", "5", "--batch", str(batch)])
    assert out["count"] == 100 and out["errors"] == 0 and out["puts_per_sec"] > 0
    # Renewals are updates of the same 20 keys, each a lease of one of the
    # rounds (concurrent writers land the rounds in any order).
    res = store.range(LEASES, prefix_end(LEASES))
    assert res.count == 20
    assert all(kv.version == 5 for kv in res.kvs)
    assert all(kv.value in {lease_flood.lease_value(kv.key.rsplit(b"/", 1)[1].decode(), seq)
                            for seq in range(5)} for kv in res.kvs)

    out = run_tool(store_stress, base + ["--puts", "200", "--ranges", "20", "--value-size", "64"])
    assert out["puts_per_sec"] > 0 and out["ranges_per_sec"] > 0
    assert out["put_errors"] == out["range_errors"] == 0
    sp = store_stress.PREFIX
    assert store.range(sp, prefix_end(sp), count_only=True).count == 200

    out = run_tool(store_stress, base + ["--native-client", "--puts", "2000",
                                         "--key-count", "100", "--value-size", "32"])
    assert out["puts"] == 2000 and out["client"] == "native-per-rpc"
    assert store.get(sp + b"00000042").version == 20


def test_store_stress_fault_plan_fires_as_jax(env):
    """``--fault-plan`` through the port's store_stress and the JAX tool,
    one writer each against the same server: a seeded plan of 5xx errors
    at the ``store.wire`` hook fires as often in both, and the items that
    run out of retries are counted as errors in both."""
    import k8s1m_tpu.faultline as jfaultline
    import k8s1m_tpu.tools.store_stress as jstore_stress
    from k8s1m_tpu_torch import faultline

    _store, target = env
    plan = json.dumps({"seed": 11, "faults": [
        {"component": "store.wire", "op": "put", "kind": "err5xx", "probability": 0.4},
        {"component": "store.wire", "op": "range", "kind": "err5xx", "every_n": 3},
    ]})
    argv = ["--target", target, "--quiet", "--concurrency", "1", "--clients", "1",
            "--puts", "40", "--ranges", "12", "--value-size", "16", "--fault-plan", plan]
    try:
        out = run_tool(store_stress, argv)
        jout = run_tool(jstore_stress, argv)
    finally:
        faultline.install_plan(None)
        jfaultline.install_plan(None)
    keys = ("faults_injected", "put_errors", "range_errors")
    assert {k: out[k] for k in keys} == {k: jout[k] for k in keys}
    assert out["faults_injected"]["err5xx"] > out["put_errors"] + out["range_errors"] > 0


def test_wire_watch_overflow_cancels_and_the_coordinator_resyncs(env):
    """A burst past the server's per-watch queue (10,000 events,
    ``WATCH_QUEUE_CAP`` in native/wirefront/wirefront.cc; the JAX server
    cancels the same way) ends the watch with "watcher overflowed; events
    dropped" instead of leaving a gap.  A coordinator over the wire counts
    the drop, relists, and binds every pod once: the designed resync that
    shard_bench's workers meet when their pod watches fall behind."""
    from k8s1m_tpu_torch.control import coordinator as coordmod

    store, target = env
    nodes, pods = 128, 10_500
    store.put_batch([(node_key(n.name), encode_node(n))
                     for n in (make_nodes.build_node(i) for i in range(nodes))])
    with RemoteStore(target) as remote:
        coord = Coordinator(remote, TableSpec(max_nodes=nodes), PodSpec(batch=1024),
                            Profile(**PROFILE), chunk=128, k=4, with_constraints=False,
                            device="cpu")
        coord.bootstrap()
        resyncs = coordmod._RESYNCS.value()
        pod_watch = coord._pods_watch
        store.put_batch([(pod_key("default", f"burst-{i}"),
                          encode_pod(PodInfo(name=f"burst-{i}", cpu_milli=10, mem_kib=1024)))
                         for i in range(pods)])
        pod_watch.progress()  # every event delivered, or the watch ended
        assert coord.run_until_idle() == pods
        assert pod_watch.canceled and pod_watch.dropped > 0
        assert coordmod._RESYNCS.value() > resyncs
        coord.close()
    bound = [json.loads(kv.value)["spec"].get("nodeName")
             for kv in store.range(PODS, prefix_end(PODS)).kvs]
    assert len(bound) == pods and all(bound)


_IMPORT_WITHOUT_TORCH = """
import importlib, sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("torch", "numpy"):
            raise ImportError("blocked: " + name)

sys.meta_path.insert(0, Block())
for m in sys.argv[1:]:
    importlib.import_module(m)
"""


def test_load_tools_import_without_torch():
    """The load tools' work is host-only: a tool process starts without
    importing torch or numpy (control/objects.py reads snapshot/records.py)."""
    import os
    import pathlib
    import subprocess
    import sys

    root = str(pathlib.Path(__file__).resolve().parents[1])
    mods = [f"k8s1m_tpu_torch.tools.{t}" for t in (
        "make_nodes", "make_pods", "delete_pods", "lease_flood", "store_stress",
        "verify_cluster")] + ["k8s1m_tpu_torch.control.objects"]
    out = subprocess.run([sys.executable, "-c", _IMPORT_WITHOUT_TORCH, *mods], cwd=root,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=root))
    assert out.returncode == 0, out.stderr[-3000:]


def test_lease_values_equal_jax():
    from k8s1m_tpu.tools.lease_flood import lease_value as jax_lease_value

    for node, seq in (("kwok-node-0", 0), ("kwok-node-1048575", 9)):
        assert lease_flood.lease_value(node, seq) == jax_lease_value(node, seq)


def test_watch_stress_counts_amplification():
    """The port's watch_stress against the port's server process, and the
    JAX tool against the JAX asyncio server: every write reaches every
    watcher in both."""
    with serve_subprocess() as (_proc, target):
        out = watch_stress.run(watch_stress.parse_args(
            ["--target", target, "--quiet", "--watchers", "5", "--writes", "40",
             "--write-concurrency", "4"]))
    loop = asyncio.new_event_loop()
    store = JaxMemStore()
    try:
        server, port = loop.run_until_complete(serve(store, port=0))
        jout = loop.run_until_complete(jwatch_stress.amain(jwatch_stress.parse_args(
            ["--target", f"127.0.0.1:{port}", "--quiet", "--watchers", "5", "--writes", "40",
             "--write-concurrency", "4"])))
        loop.run_until_complete(server.stop(None))
    finally:
        # Drain the executor the server's watch pumps poll the store on
        # before the store closes (``loop.close()`` does not wait).
        loop.run_until_complete(loop.shutdown_default_executor())
        loop.close()
        store.close()
    for o in (out, jout):
        assert o["events_delivered"] == 5 * 40 and o["events_per_sec"] > 0
    assert out["stream_errors"] == 0
    assert {k: out[k] for k in ("events_delivered", "amplification")} == \
        {k: jout[k] for k in ("events_delivered", "amplification")}


def test_kwok_lease_delay_metric(env):
    store, target = env
    run_tool(make_nodes, ["--target", target, "--quiet", "--count", "5"])
    c = KwokController(store, 0)
    c.bootstrap(now=0.0)
    assert c.tick(now=100.0)["renewed"] == 1            # kwok-node-0 only
    rendered = REGISTRY.render()
    assert "kwok_node_lease_delay_seconds" in rendered
    assert 'kwok_lease_renewals_total{group="0"}' in rendered
    c.close()


def test_kwok_waiting_parking_lot_is_bounded(env, monkeypatch):
    """Pods bound to a node name that never appears are evicted once the
    parking lot exceeds its cap and the grace period, not kept forever."""
    store, _target = env
    c = KwokController(store, 0)
    c.bootstrap(now=0.0)
    monkeypatch.setattr(kc, "MAX_WAITING_PODS", 16)
    for i in range(40):
        store.put(pod_key("default", f"ghost-{i}"),
                  encode_pod(PodInfo(f"ghost-{i}", node_name=f"no-such-node-{i}")))
    c.tick(now=1.0)
    assert sum(len(w) for w in c._waiting.values()) == 40
    c.tick(now=1.0 + kc.WAITING_GRACE_S + 1.0)
    assert sum(len(w) for w in c._waiting.values()) <= 16
    c.close()


def _verify_fixture(store) -> None:
    for i in (0, 1, 2, 4, 5, 9):        # holes at 3, 6-8
        store.put(node_key(f"kwok-node-{i}"),
                  encode_node(NodeInfo(name=f"kwok-node-{i}", cpu_milli=1000,
                                       mem_kib=1 << 20, pods=8)))
    store.put(pod_key("default", "a-0"), encode_pod(PodInfo("a-0", cpu_milli=1, mem_kib=1)))
    bound = json.loads(encode_pod(PodInfo("a-1", cpu_milli=1, mem_kib=1)))
    bound["spec"]["nodeName"] = "kwok-node-0"
    bound["status"] = {"phase": "Running"}
    store.put(pod_key("default", "a-1"), json.dumps(bound).encode())


def test_verify_cluster_counts_and_gaps(capsys):
    from k8s1m_tpu.tools.verify_cluster import count_ready as jax_count_ready
    from k8s1m_tpu.tools.verify_cluster import find_gaps as jax_find_gaps

    with MemStore() as store, JaxMemStore() as jstore:
        _verify_fixture(store)
        _verify_fixture(jstore)
        counts = verify_cluster.count_ready(store)
        assert counts == jax_count_ready(jstore)
        assert sum(counts["nodes"].values()) == 6
        assert counts["pods"].get("Running") == 1
        assert counts["pods"].get("Pending(unbound)") == 1
        assert verify_cluster.find_gaps(store) == jax_find_gaps(jstore) == [(3, 3), (6, 8)]
        # The CLI over the wire: the same counts, and the gaps with exit code 1.
        with WireFront(store) as wf:
            target = f"127.0.0.1:{wf.port}"
            capsys.readouterr()
            assert verify_cluster.main(["--target", target, "count-ready"]) == 0
            assert json.loads(capsys.readouterr().out.splitlines()[-1]) == counts
            assert verify_cluster.main(["--target", target, "find-gaps"]) == 1
            lines = capsys.readouterr().out.splitlines()
            assert lines == ["Gap detected: 3 to 3", "Gap detected: 6 to 8", '{"gaps": 2}']


DOC = ("# Title\n\npara with `code` and **bold**\n\n"
       "| a | b |\n|---|---|\n| 1 | [x](other.md) |\n\n"
       "```\nliteral <tags> & stuff\n```\n- item\n")


def test_docs_build_renders_site(tmp_path):
    html_out = docs_build.md_to_html(DOC)
    assert html_out == jax_md_to_html(DOC)
    assert "<h1>Title</h1>" in html_out
    assert "<code>code</code>" in html_out and "<strong>bold</strong>" in html_out
    assert "<table>" in html_out and '<a href="other.html">x</a>' in html_out
    assert "literal &lt;tags&gt; &amp; stuff" in html_out
    assert "<li>item</li>" in html_out

    from k8s1m_tpu.tools.docs_build import build as jax_build

    repo = tmp_path / "repo"
    repo.mkdir()
    (repo / "README.md").write_text("# Hello\n\ndocs body\n")
    written = docs_build.build(repo, tmp_path / "site", ["README.md", "MISSING.md"])
    assert set(written) == {"readme.html", "index.html"}
    jax_build(repo, tmp_path / "jsite", ["README.md", "MISSING.md"])
    for name in written:
        assert (tmp_path / "site" / name).read_bytes() == (tmp_path / "jsite" / name).read_bytes()
    assert "docs body" in (tmp_path / "site" / "readme.html").read_text()


# ---- lockstep: the JAX flow and the port's flow, step by step ------------------

LOCK_NODES, LOCK_PODS = 40, 60


class Flow:
    """One package's tools, controllers and coordinator."""

    def __init__(self, jax: bool):
        self.jax = jax
        if jax:
            self.make_nodes, self.make_pods, self.delete_pods = (
                jmake_nodes, jmake_pods, jdelete_pods)
            self.remote, self.kwok = jremote.RemoteStore, jkwok.KwokController
        else:
            self.make_nodes, self.make_pods, self.delete_pods = make_nodes, make_pods, delete_pods
            self.remote, self.kwok = RemoteStore, KwokController

    def coordinator(self, store):
        dims = dict(max_nodes=64, max_zones=8, max_regions=8)
        if self.jax:
            return jcoord.Coordinator(store, jconfig.TableSpec(**dims), jconfig.PodSpec(batch=32),
                                      jreg.Profile(**PROFILE), chunk=32, k=4,
                                      with_constraints=False, backend="xla")
        return Coordinator(store, TableSpec(**dims), PodSpec(batch=32), Profile(**PROFILE),
                           chunk=32, k=4, with_constraints=False, device="cpu")

    def settle(self, watch, local, prefix) -> None:
        """Every event of ``prefix`` written so far is in ``watch``'s queue:
        the port's watcher has a progress barrier; the JAX one is waited on
        until it has seen the newest revision under the prefix."""
        if not self.jax:
            watch.progress()
            return
        res = local.range(prefix, prefix_end(prefix))
        want = max((kv.mod_revision for kv in res.kvs), default=0)
        deadline = time.monotonic() + 30
        while watch.seen_revision < want:
            assert time.monotonic() < deadline, "the JAX watch never caught up"
            time.sleep(0.001)


def _dump(local) -> dict:
    out = {}
    for prefix in (PODS, NODES, LEASES):
        res = local.range(prefix, prefix_end(prefix))
        out[prefix] = [(kv.key, kv.value, kv.create_revision, kv.mod_revision, kv.version)
                       for kv in res.kvs]
    return out


def _lockstep(flow: Flow, server_kind: str) -> list:
    srv = {"asyncio": AsyncioServer, "native": NativeServer}[server_kind]()
    target = f"127.0.0.1:{srv.port}"
    base = ["--target", target, "--quiet", "--concurrency", "1", "--clients", "1"]
    snaps = []
    stores = [flow.remote(target) for _ in range(11)]
    controllers, coord = [], None

    def tool(mod, argv):
        out = asyncio.run(mod.amain(mod.parse_args(base + argv)))
        snaps.append((mod.__name__.rsplit(".", 1)[1], out["count"], out["errors"],
                      _dump(srv.store)))

    try:
        tool(flow.make_nodes, ["--count", str(LOCK_NODES), "--zones", "4", "--bulk", "8"])
        controllers = [flow.kwok(stores[g], g) for g in range(10)]
        for c in controllers:
            c.bootstrap(now=0.0)
        snaps.append(("adopted", sorted(len(c.nodes) for c in controllers)))
        tool(flow.make_pods, ["--count", str(LOCK_PODS)])
        coord = flow.coordinator(stores[10])
        coord.bootstrap()
        snaps.append(("bound", coord.run_until_idle(), _dump(srv.store)))
        for t in (10.0, 20.0):
            stats = []
            for c in controllers:
                flow.settle(c._pods_watch, srv.store, PODS)
                stats.append(c.tick(now=t))
            snaps.append((f"tick {t}", stats, _dump(srv.store)))
        tool(flow.delete_pods, ["--prefix", "bench-pod"])
    finally:
        if coord is not None:
            coord.close()
        for c in controllers:
            c.close()
        for s in stores:
            s.close()
        srv.close()
    return snaps


@pytest.mark.parametrize("server_kind", ["asyncio", "native"])
def test_lockstep_port_flow_equals_jax_flow(server_kind):
    port = _lockstep(Flow(jax=False), server_kind)
    jax = _lockstep(Flow(jax=True), server_kind)
    assert [s[0] for s in port] == [s[0] for s in jax]
    for p, j in zip(port, jax):
        assert p == j, p[0]
    by = {s[0]: s for s in port}
    assert by["make_nodes"][1:3] == (LOCK_NODES, 0)
    assert sum(by["adopted"][1]) == LOCK_NODES
    assert by["bound"][1] == LOCK_PODS
    ticked = by["tick 20.0"][2]
    assert {json.loads(v)["status"]["phase"] for _k, v, *_ in ticked[PODS]} == {"Running"}
    assert len(ticked[LEASES]) == LOCK_NODES
    assert sum(s["started"] for s in by["tick 10.0"][1]) == LOCK_PODS
    assert by["delete_pods"][1:3] == (LOCK_PODS, 0) and by["delete_pods"][3][PODS] == []
