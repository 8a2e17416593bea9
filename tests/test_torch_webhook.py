"""The port's admission webhook against the JAX package's, on the CPU.

Twins of the single-coordinator webhook tests of
tests/test_leader_webhook.py, of ``test_webhook_429_retry_after_sheds_by_
priority`` (tests/test_loadshed.py) and ``test_webhook_429_per_tenant``
(tests/test_tenancy.py), the admit span of a webhook-opened trace, the
sink-error close of a receipt-anchored trace, and a lockstep run: the
same AdmissionReview sequence POSTed to a port server and a JAX server,
each in front of its own coordinator under a HealthController driven to
SHEDDING, gives the same status, headers (apart from ``Date``) and body
bytes for every request, and then byte-identical stored pods.
Tolerance: exact.
"""

from __future__ import annotations

import _torch_cpu  # noqa: F401  (bounds torch's CPU threads first)

import http.client
import json
import threading
import urllib.error
import urllib.request

import pytest

import k8s1m_tpu.control.webhook as jwebhook
import k8s1m_tpu.loadshed as jls
from k8s1m_tpu_torch.config import PodSpec, TableSpec
from k8s1m_tpu_torch.control.coordinator import Coordinator
from k8s1m_tpu_torch.control.objects import encode_node, encode_pod, node_key, pod_key
from k8s1m_tpu_torch.control.webhook import WebhookServer, review_response
from k8s1m_tpu_torch.loadshed import HealthController, LoadshedConfig, Signals
from k8s1m_tpu_torch.obs.podtrace import PodTracer
from k8s1m_tpu_torch.plugins.registry import Profile
from k8s1m_tpu_torch.snapshot.node_table import NodeInfo
from k8s1m_tpu_torch.snapshot.pod_encoding import PodInfo
from k8s1m_tpu_torch.store.native import MemStore
from k8s1m_tpu_torch.tenancy import FairAdmission, TenancyController, TenancyPolicy
from test_torch_loadshed import lockpair  # noqa: F401  (fixture)


@pytest.fixture
def store():
    s = MemStore()
    yield s
    s.close()


def put_nodes(store, n=8):
    for i in range(n):
        node = NodeInfo(f"node-{i}", cpu_milli=4000, mem_kib=8 << 20, pods=16)
        store.put(node_key(node.name), encode_node(node))


def make_coord(store, **kw):
    return Coordinator(
        store, TableSpec(max_nodes=64, max_zones=16, max_regions=8), PodSpec(batch=16),
        Profile(topology_spread=0, interpod_affinity=0),
        chunk=64, k=4, with_constraints=False, device="cpu", **kw,
    )


def review(pod_obj, uid="u1") -> bytes:
    return json.dumps({
        "apiVersion": "admission.k8s.io/v1", "kind": "AdmissionReview",
        "request": {"uid": uid, "object": pod_obj},
    }).encode()


def post_review(port, pod_obj, uid="u1"):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/validate", data=review(pod_obj, uid),
        headers={"Content-Type": "application/json"}, method="POST",
    )
    with urllib.request.urlopen(req, timeout=5) as resp:
        return json.loads(resp.read())


def post_raw(port, body: bytes):
    """(status, headers without Date, body bytes) of one POST."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
    try:
        conn.request("POST", "/validate", body=body,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        data = resp.read()
        headers = [(k, v) for k, v in resp.getheaders() if k.lower() != "date"]
        return resp.status, headers, data
    finally:
        conn.close()


# ---- twins of tests/test_leader_webhook.py ------------------------------


def test_webhook_allows_and_enqueues():
    got = []
    srv = WebhookServer(got.append).start()
    try:
        pod = json.loads(encode_pod(PodInfo("web-0")))
        out = post_review(srv.port, pod)
        assert out["response"]["allowed"] is True
        assert out["response"]["uid"] == "u1"
        foreign = json.loads(encode_pod(PodInfo("web-1", scheduler_name="other")))
        assert post_review(srv.port, foreign)["response"]["allowed"] is True
        bound = json.loads(encode_pod(PodInfo("web-2", node_name="n1")))
        assert post_review(srv.port, bound)["response"]["allowed"] is True
    finally:
        srv.stop()
    assert [p["metadata"]["name"] for p in got] == ["web-0"]
    assert review_response("u9") == jwebhook.review_response("u9")


def test_webhook_intake_binds_before_watch(store):
    """A webhook pod binds although the store write lands after admission."""
    put_nodes(store)
    coord = make_coord(store)
    coord.bootstrap()
    srv = WebhookServer(coord.submit_external).start()
    try:
        p = PodInfo("hooked", cpu_milli=100, mem_kib=1 << 10)
        post_review(srv.port, json.loads(encode_pod(p)))
        store.put(pod_key("default", p.name), encode_pod(p))
        assert coord.step() == 1
        obj = json.loads(store.get(pod_key("default", "hooked")).value)
        assert obj["spec"]["nodeName"]
        # The watch echo of the original create must not double-schedule.
        assert coord.run_until_idle() == 0
    finally:
        srv.stop()
        coord.close()


def test_webhook_pod_never_persisted_is_dropped(store):
    put_nodes(store)
    coord = make_coord(store)
    coord.bootstrap()
    try:
        coord.submit_external(json.loads(encode_pod(PodInfo("ghost"))))
        assert coord.run_until_idle() == 0
        assert not coord.queue
        store.put(pod_key("default", "ghost"), encode_pod(PodInfo("ghost")))
        assert coord.run_until_idle() == 1
    finally:
        coord.close()


def test_webhook_unset_scheduler_name_belongs_to_default_scheduler():
    got = []
    srv = WebhookServer(got.append).start()
    try:
        pod = json.loads(encode_pod(PodInfo("web-noname")))
        del pod["spec"]["schedulerName"]
        assert post_review(srv.port, pod)["response"]["allowed"] is True
    finally:
        srv.stop()
    assert got == []


# ---- 429 with Retry-After (twins of the loadshed and tenancy tests) ------


def _post(port, obj, timeout=5):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/validate", data=review(obj),
        headers={"Content-Type": "application/json"}, method="POST",
    )
    return urllib.request.urlopen(req, timeout=timeout)


def test_webhook_429_retry_after_sheds_by_priority():
    got = []

    def sink(obj, admitted=False):
        got.append((obj, admitted))

    ls = HealthController(LoadshedConfig(
        queue_degraded=10, queue_shed=20, queue_cap=40, queue_recover=4, recover_cycles=2,
    ), name="hook")
    for p in range(4):
        ls.admit(p)
    ls.tick(Signals(queue_depth=25))       # SHEDDING, floor 1
    srv = WebhookServer(sink, controller=ls).start()
    try:
        low = json.loads(encode_pod(PodInfo("low")))
        low["spec"]["priority"] = 0
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(srv.port, low)
        assert ei.value.code == 429
        assert int(ei.value.headers["Retry-After"]) >= 1
        high = json.loads(encode_pod(PodInfo("high")))
        high["spec"]["priority"] = 3
        assert json.loads(_post(srv.port, high).read())["response"]["allowed"]
        foreign = json.loads(encode_pod(PodInfo("other", scheduler_name="someone-else")))
        assert json.loads(_post(srv.port, foreign).read())["response"]["allowed"]
    finally:
        srv.stop()
    assert [(p["metadata"]["name"], adm) for p, adm in got] == [("high", True)]
    assert "_k8s1m_admitted" not in got[0][0]


def test_webhook_429_per_tenant():
    got = []

    def sink(obj, admitted=False):
        got.append((obj["metadata"]["namespace"], admitted))

    fa = FairAdmission(
        TenancyPolicy(weights={"flood": 1, "calm": 1}),
        HealthController(LoadshedConfig(
            queue_degraded=10, queue_shed=20, queue_cap=100_000, queue_recover=4,
            recover_cycles=2,
        ), name="fa-hook"),
        capacity_per_tick=4,
    )
    fa.controller.tick(Signals(queue_depth=50))     # SHEDDING
    fa.tick(capacity=4)
    while fa.try_admit("flood") is None:
        pass
    srv = WebhookServer(sink, controller=fa).start()
    try:
        flood = json.loads(encode_pod(PodInfo("f1", namespace="flood")))
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(srv.port, flood)
        assert ei.value.code == 429
        assert int(ei.value.headers["Retry-After"]) >= 1
        calm = json.loads(encode_pod(PodInfo("c1", namespace="calm")))
        assert json.loads(_post(srv.port, calm).read())["response"]["allowed"]
    finally:
        srv.stop()
    assert got == [("calm", True)]


# ---- tracing through the webhook -----------------------------------------


def test_submit_external_admit_span_even_when_webhook_began_trace(store):
    """A shared tracer: the webhook opens the trace at receipt
    (``source="webhook"``) and submit_external still emits the admit span,
    with the tenant and its bucket level."""
    tracer = PodTracer(sample_n=1)
    put_nodes(store, 1)
    coord = make_coord(store, tenancy=TenancyController(TenancyPolicy()), tracer=tracer)
    coord.bootstrap()
    sunk = threading.Event()

    def sink(obj):
        coord.submit_external(obj)
        sunk.set()

    srv = WebhookServer(sink, tracer=tracer).start()
    try:
        pod = PodInfo("w0", cpu_milli=10, mem_kib=1024)
        assert post_review(srv.port, json.loads(encode_pod(pod)))["response"]["allowed"]
        # The server answers before it calls the sink: the store write
        # (and its watch intake) must come after the staging.
        assert sunk.wait(5)
        store.put(pod_key("default", "w0"), encode_pod(pod))
        assert coord.run_until_idle() == 1
    finally:
        srv.stop()
        coord.close()
    done = [t for t in tracer.completed() if t.key == "default/w0"]
    assert done and done[0].attrs["source"] == "webhook"
    spans = [s[0] for s in done[0].spans]
    assert spans[0] == "admit" and spans[-1] == "bind"
    attrs = done[0].spans[0][3]
    assert attrs["tenant"] == "default" and "bucket" in attrs


def test_sink_error_closes_the_receipt_trace():
    tracer = PodTracer(sample_n=1)

    def sink(obj):
        raise RuntimeError("sink down")

    srv = WebhookServer(sink, tracer=tracer).start()
    try:
        assert post_review(srv.port, json.loads(encode_pod(PodInfo("e0"))))["response"]["allowed"]
    finally:
        srv.stop()
    assert tracer.live_count() == 0
    (done,) = tracer.completed()
    assert done.key == "default/e0" and done.attrs["source"] == "webhook"
    assert [(s[0], s[3]) for s in done.spans] == [("requeue", {"outcome": "sink_error"})]


# ---- lockstep with the JAX server ---------------------------------------


def test_lockstep_responses_and_stored_pods_equal_jax(lockpair):
    from test_torch_coordinator import node_item

    cfg = dict(queue_degraded=16, queue_shed=32, queue_cap=64, queue_recover=4,
               recover_cycles=2)
    ls = HealthController(LoadshedConfig(**cfg), name="hook-lock")
    jl = jls.HealthController(jls.LoadshedConfig(**cfg), name="hook-lock")
    p = lockpair(max_nodes=64, batch=16, chunk=32, tkw=dict(loadshed=ls),
                 jkw=dict(loadshed=jl))
    p.write([node_item(i) for i in range(32)])
    p.bootstrap()
    # The server answers before it calls the sink: each request waits for
    # both sinks, so both coordinators step over the same staged pods.
    sunk = threading.Semaphore(0)

    def sink_of(coord):
        def sink(obj, admitted=False):
            coord.submit_external(obj, admitted=admitted)
            sunk.release()
        return sink

    srv = WebhookServer(sink_of(p.t), controller=ls).start()
    jsrv = jwebhook.WebhookServer(sink_of(p.j), controller=jl).start()
    statuses = []
    shed = []
    try:
        seq = 0
        for rnd in range(8):
            # A burst of 40 pods a round against a 16-pod wave drives the
            # controller to SHEDDING; the last rounds let it recover.
            for _ in range(40 if rnd < 5 else 4):
                pod = PodInfo(f"p{seq:04d}", cpu_milli=10, mem_kib=1 << 10)
                obj = json.loads(encode_pod(pod))
                obj["spec"]["priority"] = 3 - seq % 4
                body = review(obj, uid=f"u{seq}")
                got, want = post_raw(srv.port, body), post_raw(jsrv.port, body)
                assert got == want, (seq, got, want)
                statuses.append(got[0])
                if got[0] == 200:
                    assert sunk.acquire(timeout=5) and sunk.acquire(timeout=5)
                    # The apiserver stores the admitted pod.
                    p.put(pod_key("default", pod.name), encode_pod(pod))
                else:
                    shed.append(pod.name)
                seq += 1
            p.step()
        p.run_until_idle()
    finally:
        srv.stop()
        jsrv.stop()
    kvs = p.check()
    assert 429 in statuses and 200 in statuses and shed
    assert len(kvs) == statuses.count(200)
    assert all(b'"nodeName"' in kv.value for kv in kvs)
    names = {kv.key.rsplit(b"/", 1)[1].decode() for kv in kvs}
    assert not names & set(shed)
