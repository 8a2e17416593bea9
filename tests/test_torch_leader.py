"""The port's leader election and HA coordinator against the JAX package's,
on the CPU.

Twins of tests/test_leader_webhook.py's elector and failover tests
(acquire, renew, expiry takeover, clean release, same-identity restart,
the expired-lease steal race, the epoch bump on every acquisition, clock
skew, monotone ``leaseTransitions``, a standby rescheduling the backlog)
and of ``test_ha_sink_survives_failover`` with the port's
``WebhookServer``.  Each scenario runs once per package, each over its
own store, driven by the same injected clock: every observation (tick
results, leadership, epochs, decoded lease records) must agree, the
stored lease bytes must be identical after every step, and the JAX
file's own assertions are kept on the port's run.  Tolerance: exact.
"""

from __future__ import annotations

import _torch_cpu  # noqa: F401  (bounds torch's CPU threads first)

import json
import types
import urllib.request

import pytest

import k8s1m_tpu.config as jconfig
import k8s1m_tpu.control.coordinator as jcoord
import k8s1m_tpu.control.leader as jleader
import k8s1m_tpu.control.objects as jobj
import k8s1m_tpu.loadshed as jls
import k8s1m_tpu.plugins.registry as jreg
import k8s1m_tpu.snapshot.node_table as jnt
import k8s1m_tpu.snapshot.pod_encoding as jpe
import k8s1m_tpu.store.native as jnative
import k8s1m_tpu_torch.config as tconfig
import k8s1m_tpu_torch.control.coordinator as tcoord
import k8s1m_tpu_torch.control.leader as tleader
import k8s1m_tpu_torch.control.objects as tobj
import k8s1m_tpu_torch.loadshed as tls
import k8s1m_tpu_torch.plugins.registry as treg
import k8s1m_tpu_torch.snapshot.node_table as tnt
import k8s1m_tpu_torch.snapshot.pod_encoding as tpe
import k8s1m_tpu_torch.store.native as tnative
from k8s1m_tpu_torch.control.webhook import WebhookServer

PORT = types.SimpleNamespace(
    name="port", config=tconfig, coord=tcoord, leader=tleader, obj=tobj, ls=tls, reg=treg,
    nt=tnt, pe=tpe, native=tnative, coord_kw=dict(device="cpu"),
)
JAX = types.SimpleNamespace(
    name="jax", config=jconfig, coord=jcoord, leader=jleader, obj=jobj, ls=jls, reg=jreg,
    nt=jnt, pe=jpe, native=jnative, coord_kw={},
)
PKGS = (PORT, JAX)


def put_nodes(P, store, n=8, *, cpu_milli=4000, pods=16):
    for i in range(n):
        node = P.nt.NodeInfo(f"node-{i}", cpu_milli=cpu_milli, mem_kib=8 << 20, pods=pods)
        store.put(P.obj.node_key(node.name), P.obj.encode_node(node))


def put_pods(P, store, n, prefix="pod", ns="default", cpu_milli=100):
    for i in range(n):
        p = P.pe.PodInfo(f"{prefix}-{i}", namespace=ns, cpu_milli=cpu_milli, mem_kib=1 << 10)
        store.put(P.obj.pod_key(ns, p.name), P.obj.encode_pod(p))


def make_coord(P, store, *, batch=16, **kw):
    kw.setdefault("with_constraints", False)
    return P.coord.Coordinator(
        store,
        P.config.TableSpec(max_nodes=64, max_zones=16, max_regions=8),
        P.config.PodSpec(batch=batch),
        P.reg.Profile(topology_spread=0, interpod_affinity=0),
        chunk=64, k=4, **kw, **P.coord_kw,
    )


def stored_pods(P, store) -> list:
    kvs, _ = P.native.list_prefix(store, b"/registry/pods/")
    return [(kv.key, kv.value) for kv in kvs]


def lease_bytes(store, key):
    kv = store.get(key)
    return None if kv is None else kv.value


def host_mirror(coord) -> tuple:
    h = coord.host
    rows = sorted(h._row_of.items())
    return (rows, [(int(h.cpu_req[r]), int(h.mem_req[r]), int(h.pods_req[r])) for _, r in rows],
            sorted(coord._bound))


def run_both(scenario):
    """Run ``scenario(P, store, rec)`` once per package over a fresh store;
    ``rec`` collects observations.  The observations and the stored pods
    must agree; returns the port's observations."""
    got = {}
    for P in PKGS:
        store = P.native.MemStore()
        rec: list = []
        try:
            scenario(P, store, rec)
            rec.append(("pods", stored_pods(P, store)))
        finally:
            store.close()
        got[P.name] = rec
    assert got["port"] == got["jax"]
    return got["port"]


# ---- LeaderElector ------------------------------------------------------------


def test_single_candidate_acquires_and_renews():
    def scenario(P, store, rec):
        e = P.leader.LeaderElector(store, "a")
        assert e.tick(0.0)
        rec.append(lease_bytes(store, e.key))
        assert e.tick(5.0)          # within renew period: no write needed
        rec_ = P.leader.LeaseRecord.decode(store.get(e.key).value)
        assert rec_.holder == "a" and rec_.renew_time == 0.0
        assert e.tick(11.0)         # past renew period: renews
        rec_ = P.leader.LeaseRecord.decode(store.get(e.key).value)
        assert rec_.renew_time == 11.0
        rec.append(lease_bytes(store, e.key))

    run_both(scenario)


def test_second_candidate_waits_then_takes_over_on_expiry():
    def scenario(P, store, rec):
        a = P.leader.LeaderElector(store, "a")
        b = P.leader.LeaderElector(store, "b")
        assert a.tick(0.0)
        assert not b.tick(1.0)      # lease held and fresh
        t = 1.0
        while t < 12.9:
            t += 2.0
            rec.append(b.tick(t))
        assert not any(rec)
        assert b.tick(15.1)         # 15s lease duration elapsed
        assert not a.tick(16.0)     # a's renew CAS fails: it steps down
        assert not a.is_leader
        rec.append(lease_bytes(store, a.key))

    run_both(scenario)


def test_clean_release_allows_fast_handover():
    def scenario(P, store, rec):
        a = P.leader.LeaderElector(store, "a")
        b = P.leader.LeaderElector(store, "b")
        assert a.tick(0.0)
        a.release()
        rec.append(lease_bytes(store, a.key))
        assert b.tick(2.5)          # no need to wait out the 15s duration
        rec.append(lease_bytes(store, a.key))

    run_both(scenario)


def test_reacquire_own_lease_after_restart():
    def scenario(P, store, rec):
        a1 = P.leader.LeaderElector(store, "a")
        assert a1.tick(0.0)
        a2 = P.leader.LeaderElector(store, "a")   # same identity, fresh process
        assert a2.tick(1.0)
        rec.append((a2.current_epoch(), lease_bytes(store, a2.key)))

    run_both(scenario)


def test_expired_lease_steal_race_single_winner():
    def scenario(P, store, rec):
        a = P.leader.LeaderElector(store, "a")
        assert a.tick(0.0)              # then a dies; lease expires at 15
        b = P.leader.LeaderElector(store, "b")
        c = P.leader.LeaderElector(store, "c")
        b._observe()                    # both observe the expired record
        c._observe()
        assert c.tick(16.0)             # c wins the CAS
        stale = b._observed
        assert not b._try_write(
            P.leader.LeaseRecord("b", 16.0, 16.0, b.lease_duration_s, stale.transitions + 1)
        )
        assert not b.is_leader
        assert b._observed.holder == "c"   # re-read the truth, not assumed
        assert not b.tick(16.5)
        assert P.leader.LeaseRecord.decode(store.get(b.key).value).holder == "c"
        rec.append((c.current_epoch(), lease_bytes(store, b.key)))

    run_both(scenario)


def test_release_fast_handover_bumps_epoch():
    def scenario(P, store, rec):
        a = P.leader.LeaderElector(store, "a")
        assert a.tick(0.0)
        e0 = a.current_epoch()
        a.release()
        b = P.leader.LeaderElector(store, "b")
        assert b.tick(2.5)
        assert b.current_epoch() == e0 + 1
        assert a.current_epoch() == -1
        rec.append((e0, b.current_epoch(), lease_bytes(store, b.key)))

    run_both(scenario)


def test_clock_skew_regression():
    def scenario(P, store, rec):
        a = P.leader.LeaderElector(store, "a")
        assert a.tick(100.0)
        assert a.tick(50.0)             # the holder's clock jumped back
        assert a.is_leader
        b = P.leader.LeaderElector(store, "b")
        assert not b.tick(60.0)         # behind renew_time: fresh, not expired
        assert not b.is_leader
        assert b.tick(200.0)            # forward skew past the duration
        rec.append(lease_bytes(store, b.key))

    run_both(scenario)


def test_lease_transitions_monotonic():
    def scenario(P, store, rec):
        a = P.leader.LeaderElector(store, "a")
        assert a.tick(0.0)
        rec.append(a.current_epoch())
        b = P.leader.LeaderElector(store, "b")
        assert b.tick(16.0)             # steal after expiry
        rec.append(b.current_epoch())
        b.release()
        a2 = P.leader.LeaderElector(store, "a")
        assert a2.tick(18.0)            # fast handover
        rec.append(a2.current_epoch())
        a3 = P.leader.LeaderElector(store, "a")
        assert a3.tick(19.0)            # same identity, fresh process
        rec.append(a3.current_epoch())
        assert rec == sorted(rec) and len(set(rec)) == len(rec)

    run_both(scenario)


def test_leader_metrics_registered_once():
    """The four leader metrics live once in the port's registry."""
    from k8s1m_tpu_torch.obs.metrics import REGISTRY

    for name in ("leader_transitions_total", "leader_is_leader", "failover_takeovers_total",
                 "failover_recovery_seconds", "fencing_rejected_total",
                 "standby_mirror_lag_rows", "failover_reconcile_repairs_total"):
        assert REGISTRY.get(name) is not None, name


# ---- HACoordinator failover ----------------------------------------------------


def test_failover_reschedules_backlog():
    def scenario(P, store, rec):
        put_nodes(P, store)
        put_pods(P, store, 12, prefix="early")
        ha_a = P.leader.HACoordinator(P.leader.LeaderElector(store, "a"),
                                      lambda: make_coord(P, store))
        ha_b = P.leader.HACoordinator(P.leader.LeaderElector(store, "b", retry_period_s=1.0),
                                      lambda: make_coord(P, store))
        bound = ha_a.tick(0.0)
        assert ha_a.elector.is_leader
        assert bound == 12
        assert ha_b.tick(0.5) == 0
        put_pods(P, store, 7, prefix="late")
        t, total_b = 1.0, 0
        while t < 30.0:
            t += 1.0
            got = ha_b.tick(t)
            rec.append(got)
            total_b += got
        assert ha_b.elector.is_leader
        assert total_b == 7
        rec.append(host_mirror(ha_b.coord))
        for prefix, n in (("early", 12), ("late", 7)):
            for i in range(n):
                obj = json.loads(store.get(P.obj.pod_key("default", f"{prefix}-{i}")).value)
                assert obj["spec"].get("nodeName"), f"{prefix}-{i} unbound"
        ha_b.stop()
        ha_a.kill()

    run_both(scenario)


def post_review(port, pod_obj, uid="u1"):
    review = {"apiVersion": "admission.k8s.io/v1", "kind": "AdmissionReview",
              "request": {"uid": uid, "object": pod_obj}}
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/validate", data=json.dumps(review).encode(),
        headers={"Content-Type": "application/json"}, method="POST",
    )
    with urllib.request.urlopen(req, timeout=5) as resp:
        return json.loads(resp.read())


def test_ha_sink_survives_failover():
    """A port WebhookServer wired to the port's HACoordinator keeps feeding
    whichever coordinator currently reigns (tests/test_leader_webhook.py
    ``test_ha_sink_survives_failover``)."""
    P = PORT
    store = P.native.MemStore()
    put_nodes(P, store)
    ha_a = P.leader.HACoordinator(P.leader.LeaderElector(store, "a"),
                                  lambda: make_coord(P, store))
    ha_b = P.leader.HACoordinator(P.leader.LeaderElector(store, "b", retry_period_s=1.0),
                                  lambda: make_coord(P, store))
    srv_a = WebhookServer(ha_a.submit_external).start()
    srv_b = WebhookServer(ha_b.submit_external).start()
    try:
        ha_a.tick(0.0)
        assert ha_a.elector.is_leader
        old_coord = ha_a.coord
        t = 0.0
        while t < 30.0:
            t += 1.0
            ha_b.tick(t)
        assert ha_b.elector.is_leader
        p = P.pe.PodInfo("after-failover", cpu_milli=10, mem_kib=1 << 10)
        post_review(srv_b.port, json.loads(P.obj.encode_pod(p)))
        store.put(P.obj.pod_key("default", p.name), P.obj.encode_pod(p))
        assert ha_b.tick(t + 1.0) == 1
        # a comes back, discovers the loss and tears its reign down
        # (watches cancelled); its sink now refuses instead of staging
        # into the dead coordinator forever.
        assert ha_a.tick(t + 2.0) == 0
        assert ha_a.coord is None
        assert old_coord._nodes_watch is None
        post_review(srv_a.port, json.loads(P.obj.encode_pod(P.pe.PodInfo("to-standby"))))
        assert not old_coord._external
    finally:
        srv_a.stop()
        srv_b.stop()
        ha_b.stop()
        store.close()


def test_ha_no_leader_sink_answers_as_the_jax_webhook():
    """With no reign and no mirror, the HA sink raises Overloaded(reason=
    "no-leader"); the webhook answers before it calls the sink, so the
    port's and the JAX package's servers answer the same review with the
    same status and body, and neither stages the pod anywhere."""
    import http.client

    import k8s1m_tpu.control.webhook as jwebhook

    answers = {}
    for P, server in ((PORT, WebhookServer), (JAX, jwebhook.WebhookServer)):
        store = P.native.MemStore()
        ha = P.leader.HACoordinator(P.leader.LeaderElector(store, "a"),
                                    lambda P=P, store=store: make_coord(P, store))
        with pytest.raises(P.ls.Overloaded) as ei:
            ha.submit_external(json.loads(P.obj.encode_pod(P.pe.PodInfo("direct"))))
        assert ei.value.reason == "no-leader" and ei.value.retry_after_s > 0
        srv = server(ha.submit_external).start()
        try:
            body = json.dumps({"apiVersion": "admission.k8s.io/v1", "kind": "AdmissionReview",
                               "request": {"uid": "u9", "object": json.loads(
                                   P.obj.encode_pod(P.pe.PodInfo("orphan")))}}).encode()
            conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=5)
            conn.request("POST", "/validate", body, {"Content-Type": "application/json"})
            resp = conn.getresponse()
            answers[P.name] = (resp.status, resp.read())
            conn.close()
        finally:
            srv.stop()
            store.close()
        assert ha.coord is None and ha._mirror is None
    assert answers["port"] == answers["jax"]
    assert answers["port"][0] == 200
