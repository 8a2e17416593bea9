"""The port's ``RemoteStore`` against the JAX package's, on the CPU.

Each client talks to its own server, and both get the same operations:
parametrised over the native front-end (the port's ``WireFront`` for the
port, the JAX ``WireFront`` for JAX) and grpcio's server (the JAX asyncio
``etcd_server``, one each).  Compared: revisions, KVs, range results,
watch events (created, past, live, ``prev_kv``, a compacted start,
progress), ``BatchKV`` frames, and the types of the errors raised — the
coverage of ``tests/test_etcd_server.py``.  Then the faultline twins (one
seeded plan installed in both packages: the same injected faults, retries
and results; client-side coalescing with no drops), TLS with a bearer
token against the JAX secured watch-cache tier, and the coordinator over
the wire: the port's ``Coordinator`` over a ``RemoteStore``, the JAX one
over the JAX ``RemoteStore`` and the port's over its in-process store,
stepped in lockstep with a barrier before every step (every event up to
the store's revision queued), leave byte-identical stored pods.

Tolerance: byte identity everywhere.
"""

import _torch_cpu  # noqa: F401  (bounds torch's CPU threads first)

import dataclasses
import json
import time

import grpc
import pytest

import k8s1m_tpu.config as jconfig
import k8s1m_tpu.control.coordinator as jcoord
import k8s1m_tpu.faultline as jfault
import k8s1m_tpu.plugins.registry as jreg
import k8s1m_tpu.store.native as jnative
import k8s1m_tpu.store.remote as jremote
from k8s1m_tpu.control.objects import encode_pod, pod_key
from k8s1m_tpu.snapshot.pod_encoding import PodInfo
from k8s1m_tpu_torch import faultline
from k8s1m_tpu_torch.config import PodSpec, TableSpec
from k8s1m_tpu_torch.control.coordinator import Coordinator
from k8s1m_tpu_torch.plugins.registry import Profile
from k8s1m_tpu_torch.store import native as tnative
from k8s1m_tpu_torch.store.native import prefix_end
from k8s1m_tpu_torch.store.remote import RemoteStore
from k8s1m_tpu_torch.store.wire import StatusCode, WireError
from k8s1m_tpu_torch.tools.sched_bench import _settle, write_nodes
from test_torch_wire import AsyncioServer, NativeServer

PODS = b"/registry/pods/"
FAST = dict(component="store.wire", base_delay_s=0.0, jitter=0.0, max_attempts=5)


class JaxNativeServer:
    """The JAX package's ``WireFront`` over a JAX MemStore."""

    def __init__(self):
        self.store = jnative.MemStore()
        self.wf = jnative.WireFront(self.store)
        self.port = self.wf.port

    def close(self):
        self.wf.close()
        self.store.close()


class Twins:
    """A port RemoteStore and a JAX RemoteStore, each on its own server."""

    def __init__(self, kind: str):
        self.servers = ((NativeServer(), JaxNativeServer()) if kind == "native"
                        else (AsyncioServer(), AsyncioServer()))
        self.t = RemoteStore(f"127.0.0.1:{self.servers[0].port}",
                             retry_policy=faultline.RetryPolicy(**FAST))
        self.j = jremote.RemoteStore(f"127.0.0.1:{self.servers[1].port}",
                                     retry_policy=jfault.RetryPolicy(**FAST))

    def both(self, op, *args, **kw):
        """Run one operation on both clients; results (or raised error
        types) must agree."""
        out = []
        for c in (self.t, self.j):
            try:
                out.append(("ok", _norm(getattr(c, op)(*args, **kw))))
            except Exception as e:  # graftlint: disable=broad-except (the error type is compared)
                out.append(("raise", type(e).__name__))
        assert out[0] == out[1], (op, args, kw, out)
        return out[0][1]

    def close(self):
        self.t.close()
        self.j.close()
        for s in self.servers:
            s.close()


def _norm(v):
    """Results of either package as plain tuples."""
    if dataclasses.is_dataclass(v):
        return tuple(_norm(getattr(v, f.name)) for f in dataclasses.fields(v))
    if isinstance(v, (list, tuple)):
        return type(v)(_norm(x) for x in v)
    return v


@pytest.fixture(params=["native", "asyncio"])
def twins(request):
    tw = Twins(request.param)
    try:
        yield tw
    finally:
        tw.close()


def _collect(w, n: int, timeout: float = 15.0) -> list:
    out = []
    deadline = time.monotonic() + timeout
    while len(out) < n and time.monotonic() < deadline:
        out += w.poll(1000)
        if len(out) < n:
            time.sleep(0.005)
    return out


def test_kv_corpus(twins):
    tw = twins
    assert tw.both("put", b"/registry/pods/default/a", b"v1") == 2
    tw.both("put", b"/registry/pods/default/a", b"v2")
    tw.both("get", b"/registry/pods/default/a")
    tw.both("get", b"/registry/pods/default/none")
    for i in range(10):
        tw.both("put", b"/registry/pods/ns/p%03d" % i, b"x" * 10, lease=i % 2)
    tw.both("range", PODS, prefix_end(PODS), limit=3)
    tw.both("range", PODS, prefix_end(PODS), keys_only=True)
    tw.both("range", PODS, prefix_end(PODS), count_only=True)
    tw.both("range", PODS, prefix_end(PODS), revision=5)
    # CAS: create at mod 0, conflict (current KV back), update, version delete.
    k = b"/registry/pods/ns/cas"
    ok, rev1, _ = tw.both("cas", k, b"v1", required_mod=0)
    assert ok
    ok, _, cur = tw.both("cas", k, b"v2", required_mod=0)
    assert not ok and cur[1] == b"v1"
    assert tw.both("cas", k, b"v2", required_mod=rev1)[0]
    assert tw.both("cas", k, None, required_version=2)[0]
    assert tw.both("get", k) is None
    with pytest.raises(ValueError):
        tw.t.cas(k, b"x")
    assert tw.both("delete", b"/registry/pods/ns/p000")[1] is True
    assert tw.both("delete", b"/registry/pods/ns/p000") == (0, False)
    # Compaction and future revisions raise the same error types.
    tw.both("compact", 8)
    assert tw.both("range", k, revision=3) == "CompactedError"
    assert tw.both("range", k, revision=10**9) == "FutureRevError"
    assert tw.t.current_revision == tw.j.current_revision


def test_batch_frames(twins):
    tw = twins
    tw.both("put", b"/registry/leases/ns/doomed", b"x")
    items = [(b"/registry/leases/ns/l%03d" % i, b"v%d" % i) for i in range(50)]
    items.append((b"/registry/leases/ns/doomed", None))
    rev = tw.both("put_batch", items)
    assert rev == tw.t.current_revision
    tw.both("range", b"/registry/leases/", prefix_end(b"/registry/leases/"))
    k1, k2 = pod_key("default", "p1"), pod_key("default", "p2")
    r1 = tw.both("put", k1, encode_pod(PodInfo("p1")))
    r2 = tw.both("put", k2, encode_pod(PodInfo("p2")))
    k3 = b"/registry/pods/default/notjson"
    r3 = tw.both("put", k3, b"not a pod object")
    revs = tw.both("bind_batch", [(k1, r1, b"node-a"), (k2, r2 - 1, b"node-b"),
                                  (k3, r3, b"node-c")])
    assert revs[0] > 0 and revs[1] == -1 and revs[2] == -5
    assert json.loads(tw.t.get(k1).value)["spec"]["nodeName"] == "node-a"
    tw.both("range", PODS, prefix_end(PODS))
    # The light relist gives the full range's bytes.
    full = tw.t.range(PODS, prefix_end(PODS))
    rev, more, values, last = tw.t.range_values(PODS, prefix_end(PODS), limit=2)
    assert (rev, more, values, last) == (full.revision, True,
                                         [kv.value for kv in full.kvs[:2]], full.kvs[1].key)
    assert tw.t.range_items(PODS, prefix_end(PODS))[2] == [(kv.key, kv.value) for kv in full.kvs]
    assert tw.t.range_items(PODS, prefix_end(PODS), keys_only=True)[2] == [
        kv.key for kv in full.kvs]
    vals, vrev = tnative.list_prefix_values(tw.t, PODS, page=1)
    assert vals == [kv.value for kv in full.kvs] and vrev == full.revision
    assert tnative.list_prefix_items(tw.t, PODS, page=2) == [(kv.key, kv.value)
                                                             for kv in full.kvs]


def test_watch_corpus(twins):
    tw = twins
    rev0 = tw.both("put", b"/registry/pods/ns/before", b"old")
    ws = [c.watch(PODS, prefix_end(PODS), start_revision=rev0, prev_kv=True)
          for c in (tw.t, tw.j)]
    try:
        for c in (tw.t, tw.j):
            c.put(b"/registry/pods/ns/a", b"v1")
            c.put(b"/registry/pods/ns/a", b"v2")
            c.delete(b"/registry/pods/ns/a")
            c.put(b"/registry/other", b"not watched")
        got = [_norm(_collect(w, 4)) for w in ws]
        assert got[0] == got[1] and len(got[0]) == 4
        assert [e[0] for e in got[0]] == ["PUT", "PUT", "PUT", "DELETE"]
        assert got[0][2][2][1] == b"v1"                     # prev_kv of the second put
        # The port's progress request is a barrier behind every event.
        for i in range(100):
            tw.t.put(b"/registry/pods/ns/p%03d" % i, b"x")
        last = tw.t.current_revision
        assert ws[0].progress() >= last and ws[0].pending == 100
        assert ws[0].seen_revision == last and ws[0].dropped == 0
        assert [e[0] for e in ws[0].poll_light(1000)] == [0] * 100
    finally:
        for w in ws:
            w.cancel()
    assert [w.canceled for w in ws] == [True, True] and [w.dropped for w in ws] == [0, 0]
    # A watch from a compacted revision: dropped once, ended, on both.
    for c in (tw.t, tw.j):
        for i in range(5):
            c.put(b"/registry/x", b"%d" % i)
        c.compact(c.current_revision)
    ws = [c.watch(b"/registry/x", start_revision=2) for c in (tw.t, tw.j)]
    deadline = time.monotonic() + 15
    while not all(w.canceled for w in ws) and time.monotonic() < deadline:
        time.sleep(0.005)
    assert [(w.canceled, w.dropped) for w in ws] == [(True, 1), (True, 1)]


def test_watch_poll_pods_columnar(twins):
    """``poll_pods`` over the wire gives the native columnar frame of the
    in-process watcher for the same events."""
    tw = twins
    with tnative.MemStore() as local:
        lw = local.watch(PODS, prefix_end(PODS))
        w = tw.t.watch(PODS, prefix_end(PODS), start_revision=tw.t.current_revision + 1)
        try:
            for store in (local, tw.t):
                for i in range(20):
                    store.put(pod_key("default", f"p{i}"),
                              encode_pod(PodInfo(f"p{i}", cpu_milli=10 + i, mem_kib=64)))
                store.put_batch([(pod_key("default", "p3"), None)])
            w.progress()
            a, b = w.poll_pods(1000), lw.poll_pods(1000)
            assert a.n == b.n == 21
            for f in ("etype", "flags", "cpu", "mem", "koff", "aoff"):
                assert (getattr(a, f) == getattr(b, f)).all(), f
            assert a.key_blob == b.key_blob and a.aux_blob == b.aux_blob
        finally:
            w.cancel()
            lw.cancel()


# ---- faultline twins -----------------------------------------------------------

PLAN = {"seed": 11, "faults": [
    {"component": "store.wire", "op": "put", "kind": "disconnect", "every_n": 3},
    {"component": "store.wire", "op": "range", "kind": "stale_revision", "every_n": 4},
    {"component": "store.wire", "op": "put_batch", "kind": "partial_write", "every_n": 2},
    {"component": "store.wire", "op": "bind_batch", "kind": "partial_write", "every_n": 2},
    {"component": "store.wire", "op": "txn", "kind": "err5xx", "probability": 0.5},
    {"component": "store.wire", "op": "status", "kind": "delay", "delay_s": 0.0, "every_n": 2},
]}


@pytest.fixture
def plans():
    faultline.install_plan(PLAN)
    jfault.install_plan(PLAN)
    try:
        yield
    finally:
        faultline.install_plan(None)
        jfault.install_plan(None)


def test_faultline_twins(twins, plans):
    """One seeded plan in both injectors: the same injected faults, the
    same retries (the store.wire policy with zero delay) and the same
    results — a partial write's retried batch lands exactly once."""
    tw = twins
    t_retry0 = faultline.retry_counts().get("store.wire", 0.0)
    j_retry0 = jfault.retry_counts().get("store.wire", 0.0)
    for i in range(12):
        tw.both("put", b"/registry/pods/f/p%02d" % i, b"v%d" % i)
    for i in range(6):
        tw.both("range", b"/registry/pods/f/p%02d" % i)
    for w in range(4):
        tw.both("put_batch", [(b"/registry/leases/f/w%d-%d" % (w, i), b"x") for i in range(8)])
    keys = [pod_key("f", f"b{i}") for i in range(8)]
    revs = [tw.t.put(k, encode_pod(PodInfo(f"b{i}", namespace="f"))) for i, k in enumerate(keys)]
    jrevs = [tw.j.put(k, encode_pod(PodInfo(f"b{i}", namespace="f"))) for i, k in enumerate(keys)]
    assert revs == jrevs
    tw.both("bind_batch", [(k, r, b"node-a") for k, r in zip(keys, revs)])
    for i in range(8):
        tw.both("cas", b"/registry/pods/f/c%d" % i, b"v", required_mod=0)
    for _ in range(4):
        assert tw.t.current_revision == tw.j.current_revision
    tw.both("range", b"/registry/", prefix_end(b"/registry/"))
    assert faultline.active_injector().fire_counts() == jfault.active_injector().fire_counts()
    assert faultline.active_injector().fire_counts()["partial_write"] > 0
    assert (faultline.retry_counts().get("store.wire", 0.0) - t_retry0
            == jfault.retry_counts().get("store.wire", 0.0) - j_retry0 > 0)


def test_coalescing_latest_only_without_drops(twins):
    """The client's opt-in bounded-lag mirror on both packages: a 103-event
    history through an 8-slot FIFO folds latest-only per key, with no drop
    and the same net state."""
    pfx = b"/registry/coal/"
    states = []
    for c in (twins.t, twins.j):
        c.put(pfx + b"a", b"seed")
        for i in range(100):
            c.put(pfx + b"hot", b"%03d" % i)
        c.put(pfx + b"b", b"last")
        w = c.watch(pfx, prefix_end(pfx), start_revision=1, queue_cap=8, coalesce=True)
        try:
            state, last_rev = {}, {}
            deadline = time.monotonic() + 20
            while time.monotonic() < deadline:
                for ev in w.poll(max_events=16):
                    assert ev.kv.mod_revision >= last_rev.get(ev.kv.key, 0)
                    last_rev[ev.kv.key] = ev.kv.mod_revision
                    state[ev.kv.key] = ev.kv.value
                if state.get(pfx + b"hot") == b"099" and pfx + b"b" in state:
                    break
                time.sleep(0.01)
            assert w.dropped == 0
            states.append(state)
        finally:
            w.cancel()
    assert states[0] == states[1] == {pfx + b"a": b"seed", pfx + b"hot": b"099",
                                      pfx + b"b": b"last"}


# ---- TLS and bearer tokens against the JAX secured tier ------------------------

TLS_PFX = b"/registry/pods/tlsns/"
TOKEN = "rig-scrape-token"


@pytest.fixture
def tier(tmp_path):
    """The fixture of tests/test_tier_tls.py on a background event loop:
    the JAX asyncio server, and the watch-cache tier in front of it
    serving TLS with the rig CA and a bearer token."""
    from k8s1m_tpu.cluster.certs import provision
    from k8s1m_tpu.store.watch_cache import serve_watch_cache

    certs = provision(str(tmp_path))
    srv = AsyncioServer()
    up = jremote.RemoteStore(f"127.0.0.1:{srv.port}")
    up.put(TLS_PFX + b"seed", b"s0")
    tier = srv.run(serve_watch_cache(f"127.0.0.1:{srv.port}", [TLS_PFX], port=0, tls=certs,
                                     auth_token=TOKEN))
    try:
        yield certs, f"127.0.0.1:{tier.port}"
    finally:
        up.close()
        srv.run(tier.close())
        srv.close()


def test_tls_bearer_roundtrip_and_watch(tier):
    certs, target = tier
    rs = RemoteStore(target, ca_pem=certs.ca_pem, token=TOKEN)
    jrs = jremote.RemoteStore(target, ca_pem=certs.ca_pem, token=TOKEN)
    try:
        rev = rs.put(TLS_PFX + b"a", b"v1")
        assert rs.get(TLS_PFX + b"a").value == b"v1"
        assert _norm(rs.get(TLS_PFX + b"a")) == _norm(jrs.get(TLS_PFX + b"a"))
        # The tier registers a watch apart from the writes: start it at a
        # revision so the next write cannot slip past it.
        w = rs.watch(TLS_PFX + b"a", start_revision=rev + 1)
        try:
            rs.put(TLS_PFX + b"a", b"v2")
            evs = _collect(w, 1)
            assert [(e.type, e.kv.value) for e in evs] == [("PUT", b"v2")]
        finally:
            w.cancel()
    finally:
        rs.close()
        jrs.close()


@pytest.mark.parametrize("token", [None, "nope"], ids=["missing", "wrong"])
def test_tls_missing_or_wrong_token_refused_like_jax(tier, token):
    certs, target = tier
    rs = RemoteStore(target, ca_pem=certs.ca_pem, token=token)
    jrs = jremote.RemoteStore(target, ca_pem=certs.ca_pem, token=token)
    try:
        with pytest.raises(WireError) as ei:
            rs.range(TLS_PFX + b"seed")
        with pytest.raises(grpc.RpcError) as ji:
            jrs.range(TLS_PFX + b"seed")
        assert ei.value.code.name == ji.value.code().name == "UNAUTHENTICATED"
    finally:
        rs.close()
        jrs.close()


def test_tls_plaintext_client_rejected(tier):
    _certs, target = tier
    once = faultline.RetryPolicy(component="store.wire", max_attempts=1)
    rs = RemoteStore(target, retry_policy=once)
    try:
        with pytest.raises(faultline.GiveUp) as ei:
            rs.range(TLS_PFX + b"seed")
        assert isinstance(ei.value.cause, WireError)
        assert ei.value.cause.code == StatusCode.UNAVAILABLE
    finally:
        rs.close()


# ---- the coordinator over the wire ---------------------------------------------

NODES, BATCH, CHUNK = 2048, 128, 512
BASE = dict(node_affinity=0, topology_spread=0, interpod_affinity=0)
ZERO = dict(component="coordinator.bind", base_delay_s=0.0, jitter=0.0)


def _jax_barrier(coord, store) -> None:
    """Every event up to the store's revision in the JAX watcher's queue:
    after bootstrap only pods are written, so the pods watch sees them all."""
    rev = store.current_revision
    deadline = time.monotonic() + 30
    while coord._pods_watch.seen_revision < rev and rev > coord._boot_rev:
        assert time.monotonic() < deadline, "JAX watch never caught up"
        time.sleep(0.001)


def test_coordinator_over_the_wire_equals_jax_and_in_process():
    tsrv, jsrv = NativeServer(), JaxNativeServer()
    tstore = RemoteStore(f"127.0.0.1:{tsrv.port}")
    jstore = jremote.RemoteStore(f"127.0.0.1:{jsrv.port}")
    local = tnative.MemStore()
    dims = dict(max_nodes=NODES, max_zones=16, max_regions=8)
    try:
        for s in (tstore, jstore, local):
            write_nodes(s, NODES)
        tw = Coordinator(tstore, TableSpec(**dims), PodSpec(batch=BATCH), Profile(**BASE),
                         chunk=CHUNK, k=4, with_constraints=False, score_pct=25,
                         retry_policy=faultline.RetryPolicy(**ZERO), device="cpu")
        ti = Coordinator(local, TableSpec(**dims), PodSpec(batch=BATCH), Profile(**BASE),
                         chunk=CHUNK, k=4, with_constraints=False, score_pct=25,
                         retry_policy=faultline.RetryPolicy(**ZERO), device="cpu")
        jc = jcoord.Coordinator(
            jstore, jconfig.TableSpec(**dims), jconfig.PodSpec(batch=BATCH),
            jreg.Profile(**BASE), chunk=CHUNK, k=4, with_constraints=False, score_pct=25,
            backend="xla", retry_policy=jfault.RetryPolicy(**ZERO))
        coords = (tw, ti, jc)
        for c in coords:
            c.bootstrap()
        jc._boot_rev = jstore.current_revision
        pods = [(pod_key("default", f"p{i}"),
                 encode_pod(PodInfo(f"p{i}", cpu_milli=10 + i % 3, mem_kib=1024)))
                for i in range(6 * BATCH)]

        def step_all():
            _settle(tw)
            _jax_barrier(jc, jstore)
            got = [c.step() for c in coords]
            assert got[0] == got[1] == got[2], got
            return got[0]

        bound = 0
        for off in range(0, len(pods), BATCH):
            for s in (tstore, jstore, local):
                s.put_batch(pods[off:off + BATCH])
            bound += step_all()
        for _ in range(20):
            bound += step_all()
        for c in coords:
            c.flush()
        stored = [{kv.key: kv.value for kv in tnative.list_prefix(s, PODS)[0]}
                  for s in (tstore, local)]
        stored.append({kv.key: kv.value for kv in jnative.list_prefix(jstore, PODS)[0]})
        assert stored[0] == stored[1] == stored[2]
        assert len(stored[0]) == len(pods) and bound == len(pods)
        assert all(b'"nodeName"' in v for v in stored[0].values())
        for c in coords:
            c.close()
    finally:
        tstore.close()
        jstore.close()
        local.close()
        tsrv.close()
        jsrv.close()


def test_server_restart_breaks_watches_and_clients_reconnect():
    """A store server that goes away ends every watch as dropped (the owner
    relists), in both packages; a server back on the same port serves the
    same clients again (a new connection, as a gRPC channel reconnects)."""
    stores = (tnative.MemStore(), jnative.MemStore())
    fronts = [tnative.WireFront(stores[0]), jnative.WireFront(stores[1])]
    ports = [f.port for f in fronts]
    clients = (RemoteStore(f"127.0.0.1:{ports[0]}", retry_policy=faultline.RetryPolicy(**FAST)),
               jremote.RemoteStore(f"127.0.0.1:{ports[1]}",
                                   retry_policy=jfault.RetryPolicy(**FAST)))
    try:
        # From the next revision on: a JAX watch registers asynchronously.
        ws = [c.watch(PODS, prefix_end(PODS), start_revision=c.current_revision + 1)
              for c in clients]
        for c in clients:
            c.put(PODS + b"a", b"v1")
        assert [len(_collect(w, 1)) for w in ws] == [1, 1]
        for f in fronts:
            f.close()
        deadline = time.monotonic() + 15
        while not all(w.canceled for w in ws) and time.monotonic() < deadline:
            time.sleep(0.005)
        assert [(w.canceled, w.dropped) for w in ws] == [(True, 1), (True, 1)]
        fronts = [tnative.WireFront(stores[0], port=ports[0]),
                  jnative.WireFront(stores[1], port=ports[1])]
        revs = [c.put(PODS + b"a", b"v2") for c in clients]
        assert revs[0] == revs[1] == 3
        assert _norm(clients[0].get(PODS + b"a")) == _norm(clients[1].get(PODS + b"a"))
    finally:
        for c in clients:
            c.close()
        for f in fronts:
            f.close()
        for s in stores:
            s.close()


def test_memstore_write_ahead_log_replays_like_jax(tmp_path):
    """``MemStore(wal_dir=, wal_mode=, no_write_prefixes=)`` as the JAX
    store takes them: a reopened store replays the logged writes and not
    the prefixes that skip the log, with the JAX store's revisions."""
    got = []
    for pkg, sub in ((tnative, "port"), (jnative, "jax")):
        d = str(tmp_path / sub)
        with pkg.MemStore(wal_dir=d, wal_mode="fsync",
                          no_write_prefixes=("/registry/leases/",)) as s:
            s.put(PODS + b"a", b"v1")
            s.put(b"/registry/leases/l", b"x")
            s.put_batch([(PODS + b"b", b"v2"), (PODS + b"a", None)])
        with pkg.MemStore(wal_dir=d, wal_mode="fsync") as s:
            got.append((_norm(s.get(PODS + b"a")), _norm(s.get(PODS + b"b")),
                        _norm(s.get(b"/registry/leases/l"))))
    assert got[0] == got[1]
    assert got[0][0] is None and got[0][1][1] == b"v2" and got[0][2] is None


@pytest.mark.parametrize("argv", [["--wire", "asyncio"], ["--metrics-port", "9000"]])
def test_server_main_refuses_what_the_port_lacks(argv, capsys):
    """``--wire asyncio`` (``store/etcd_server.py``) and
    ``--metrics-port`` (``obs/http.py``) are ported and kept; a wire that
    neither package offers exits with argparse's status 2."""
    from k8s1m_tpu_torch.store import server_main

    if "--metrics-port" in argv:
        assert server_main.parse_args(argv).metrics_port == 9000
    else:
        assert server_main.parse_args(argv).wire == "asyncio"
        with pytest.raises(SystemExit) as ei:
            server_main.parse_args(["--wire", "grpcio"])
        assert ei.value.code == 2
        assert "invalid choice" in capsys.readouterr().err
    args = server_main.parse_args(["--port", "0", "--wal-no-write-prefix", "/registry/leases/"])
    assert (args.wire, args.metrics_port, args.wal_no_write_prefix) == (
        "native", 0, ["/registry/leases/"])
