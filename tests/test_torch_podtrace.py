"""The port's per-pod tracing, flight recorder and sampling profiler, on the
CPU, against the JAX package's.

Twins of tests/test_podtrace.py, tests/test_trace.py and
tests/test_profiler.py for ``k8s1m_tpu_torch.obs`` and the port's
coordinator hooks, plus:

- the pure tracer and exporter driven through the same script in both
  packages give the same sampling decisions, spans, attribution and
  trace-event document;
- a lockstep run: both coordinators with ``PodTracer(sample_n=1)`` over
  the same store writes (zero-delay retries) bind the same pods, trace
  the same pod keys with the same span names in the same order per pod,
  and both packages' ``validate_trace`` accept the port's export.

Tolerance: exact, apart from span durations (host timings), which are
checked for contiguity and coverage only.
"""

from __future__ import annotations

import _torch_cpu  # noqa: F401  (bounds torch's CPU threads first)

import json
import logging
import os
import sys
import threading
import time

import k8s1m_tpu.obs.podtrace as jpodtrace
from k8s1m_tpu_torch.config import PodSpec, TableSpec
from k8s1m_tpu_torch.control.coordinator import Coordinator
from k8s1m_tpu_torch.control.objects import encode_node, encode_pod, node_key, pod_key
from k8s1m_tpu_torch.obs.metrics import REGISTRY
from k8s1m_tpu_torch.obs.podtrace import NULL_TRACER, STAGES, PodTracer, validate_trace
from k8s1m_tpu_torch.obs.profiler import SamplingProfiler
from k8s1m_tpu_torch.obs.trace import FlightRecorder
from k8s1m_tpu_torch.plugins.registry import Profile
from k8s1m_tpu_torch.snapshot.node_table import NodeInfo
from k8s1m_tpu_torch.snapshot.pod_encoding import PodInfo
from k8s1m_tpu_torch.store.native import MemStore
from k8s1m_tpu_torch.tenancy import TenancyController
from k8s1m_tpu_torch.tenancy.policy import TenancyPolicy
from test_torch_loadshed import lockpair  # noqa: F401  (fixture)

PROFILE = Profile(topology_spread=0, interpod_affinity=0)


# ---- 1. the tracer -----------------------------------------------------


def test_sampling_is_deterministic_and_head_based():
    t1 = PodTracer(sample_n=4)
    t2 = PodTracer(sample_n=4)
    keys = [f"ns/pod-{i}" for i in range(400)]
    picked = [k for k in keys if t1.sampled(k)]
    assert picked == [k for k in keys if t2.sampled(k)]
    # The JAX tracer picks the same pods (crc32 of the key).
    assert picked == [k for k in keys if jpodtrace.PodTracer(sample_n=4).sampled(k)]
    assert 50 <= len(picked) <= 150
    assert all(PodTracer(sample_n=1).sampled(k) for k in keys)


def _chain_script(mod):
    tr = mod.PodTracer(sample_n=1)
    assert tr.begin("ns/p", 10.0, source="test")
    assert not tr.begin("ns/p", 11.0)
    tr.emit("ns/p", "queue_wait", t=10.5)
    tr.emit("ns/p", "encode", t=10.6)
    tr.emit("ns/p", "device", t=10.4)      # non-monotone: clamps
    done = tr.finish("ns/p", "bind", t=11.0, outcome="bound")
    tr.begin("ns/q", 10.2, source="test")
    tr.emit("ns/q", "queue_wait", t=10.3, attempts=0)
    tr.finish("ns/q", "bind", t=10.9, outcome="bound")
    return tr, done


def test_span_chain_is_contiguous_and_telescopes():
    tr, done = _chain_script(sys.modules[PodTracer.__module__])
    assert done is not None
    spans = done.spans
    assert [s[0] for s in spans] == ["queue_wait", "encode", "device", "bind"]
    for (_, _, t1, _), (_, t0, _, _) in zip(spans, spans[1:]):
        assert t0 == t1
    assert sum(t1 - t0 for _, t0, t1, _ in spans) == 11.0 - 10.0
    assert tr.live_count() == 0
    assert not tr.emit("ns/p", "late")
    assert not tr.emit("ns/other", "late")
    # The same script through the JAX tracer: the same chains, the same
    # waterfall and the same trace-event document.
    jtr, jdone = _chain_script(jpodtrace)
    assert done.doc() == jdone.doc()
    assert tr.attribution() == jtr.attribution()
    assert tr.to_trace_events() == jtr.to_trace_events()


def test_tracer_bounds_live_and_ring():
    tr = PodTracer(sample_n=1, max_live=8, ring=4)
    dropped = REGISTRY.get("podtrace_pods_total").value(outcome="dropped")
    opened = sum(tr.begin(f"ns/p{i}", float(i)) for i in range(20))
    assert opened == 8
    assert REGISTRY.get("podtrace_pods_total").value(outcome="dropped") == dropped + 12
    for i in range(8):
        tr.finish(f"ns/p{i}", "bind", t=100.0)
    assert len(tr.completed()) == 4


def test_null_tracer_is_inert():
    assert not NULL_TRACER.enabled
    assert not NULL_TRACER.begin("k", 0.0)
    assert not NULL_TRACER.emit("k", "bind")
    assert NULL_TRACER.finish("k", "bind") is None
    assert NULL_TRACER.spans_of("k") == []
    assert NULL_TRACER.attribution() == {}


# ---- 2. exporter + validator ------------------------------------------


def _traced_run(*, flight=None, sample_n=1, pods=6, profiler=None):
    store = MemStore()
    for i in range(32):
        store.put(node_key(f"n-{i}"), encode_node(NodeInfo(
            name=f"n-{i}", cpu_milli=64000, mem_kib=1 << 24, pods=110,
        )))
    tracer = PodTracer(sample_n=sample_n)
    coord = Coordinator(
        store, TableSpec(max_nodes=64), PodSpec(batch=8), PROFILE,
        chunk=64, with_constraints=False, tracer=tracer,
        flight_recorder=flight, profiler=profiler, device="cpu",
    )
    try:
        coord.bootstrap()
        for i in range(pods):
            store.put(
                pod_key("default", f"p{i}"),
                encode_pod(PodInfo(f"p{i}", cpu_milli=10, mem_kib=1024)),
            )
        assert coord.run_until_idle() == pods
    finally:
        coord.close()
        store.close()
    return tracer


def test_export_validates_and_flows_resolve(tmp_path):
    tracer = _traced_run()
    path = str(tmp_path / "sub" / "trace.json")
    tracer.export(path)
    with open(path) as f:
        doc = json.load(f)
    assert validate_trace(doc) == []
    assert jpodtrace.validate_trace(doc) == []
    evs = doc["traceEvents"]
    assert {"M", "X", "s", "f"} <= {e["ph"] for e in evs}
    names = {
        e["args"]["name"] for e in evs
        if e["ph"] == "M" and e["name"] == "thread_name"
    }
    assert {"queue_wait", "encode", "device", "bind"} <= names
    assert names <= set(STAGES)
    dev = [e for e in evs if e["ph"] == "X" and e["name"] == "device"]
    assert dev and all(
        "wave_epoch" in e["args"] and e["args"]["path"] in ("full", "delta")
        and e["args"]["depth"] >= 1
        for e in dev
    )


def test_validator_rejects_malformed_documents():
    assert validate_trace({}) != []
    assert validate_trace({"traceEvents": "nope"}) != []
    bad_order = {"traceEvents": [
        {"ph": "X", "pid": 1, "tid": 1, "name": "a", "ts": 10, "dur": 1},
        {"ph": "X", "pid": 1, "tid": 1, "name": "b", "ts": 5, "dur": 1},
    ]}
    assert any("monotone" in e for e in validate_trace(bad_order))
    dangling = {"traceEvents": [
        {"ph": "f", "pid": 1, "tid": 1, "ts": 1, "id": 7},
        {"ph": "s", "pid": 1, "tid": 1, "ts": 2, "id": 8},
    ]}
    errs = validate_trace(dangling)
    assert any("before its 's'" in e for e in errs)
    assert any("never finished" in e for e in errs)
    for doc in ({}, bad_order, dangling):
        assert validate_trace(doc) == jpodtrace.validate_trace(doc)


def test_submit_external_admit_span_even_when_webhook_began_trace():
    """The admit span (with tenant and bucket attributes) lands whether the
    webhook opened the trace at receipt or submit_external did."""
    tracer = PodTracer(sample_n=1)
    with MemStore() as store:
        store.put(node_key("n-0"), encode_node(NodeInfo(
            name="n-0", cpu_milli=64000, mem_kib=1 << 24, pods=110,
        )))
        tn = TenancyController(TenancyPolicy())
        coord = Coordinator(
            store, TableSpec(max_nodes=16), PodSpec(batch=8), PROFILE,
            chunk=16, with_constraints=False, tenancy=tn, tracer=tracer, device="cpu",
        )
        try:
            coord.bootstrap()
            pod = PodInfo("w0", cpu_milli=10, mem_kib=1024)
            obj = json.loads(encode_pod(pod))
            tracer.begin("default/w0", time.perf_counter(), source="webhook")
            coord.submit_external(obj)
            store.put(pod_key("default", "w0"), encode_pod(pod))
            assert coord.run_until_idle() == 1
        finally:
            coord.close()
    done = [t for t in tracer.completed() if t.key == "default/w0"]
    assert done
    admit = [s for s in done[0].spans if s[0] == "admit"]
    assert admit, [s[0] for s in done[0].spans]
    attrs = admit[0][3]
    assert attrs["tenant"] == "default" and "bucket" in attrs
    assert done[0].attrs["source"] == "webhook"


def test_committed_perfetto_artifact_validates():
    """The JAX package's committed sample export validates under the
    port's validator as under its own."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = os.path.join(repo, "artifacts", "podtrace_steady_smoke.trace.json")
    with open(path) as f:
        doc = json.load(f)
    assert validate_trace(doc) == [] == jpodtrace.validate_trace(doc)
    assert len(doc["traceEvents"]) > 100


# ---- 3. the composed acceptance gate ----------------------------------


def test_podtrace_composed_4096_coverage_gate():
    """At 4096 nodes under capacity churn, tenants and depth-3 pipelining,
    every traced pod's stage spans cover >= 95% of its schedule-to-bind
    time and the waterfall's shares sum to ~1."""
    tracer = PodTracer(sample_n=4)
    with MemStore() as store:
        for i in range(4096):
            store.put(node_key(f"n{i:05d}"), encode_node(NodeInfo(
                name=f"n{i:05d}", cpu_milli=1 << 22, mem_kib=1 << 30,
                pods=(1 << 15) - 1,
            )))
        tn = TenancyController(TenancyPolicy())
        coord = Coordinator(
            store, TableSpec(max_nodes=4096, max_zones=16, max_regions=8),
            PodSpec(batch=64), PROFILE, chunk=512, k=4,
            with_constraints=False, seed=13, pipeline=True, depth=3,
            tenancy=tn, tracer=tracer, device="cpu",
        )
        try:
            coord.bootstrap()
            seq = 0
            for wave in range(6):
                for i in range(48):
                    seq += 1
                    ns = f"tenant-{i % 3}"
                    store.put(
                        pod_key(ns, f"p{seq:05d}"),
                        encode_pod(PodInfo(
                            f"p{seq:05d}", namespace=ns,
                            cpu_milli=10, mem_kib=1 << 10,
                        )),
                    )
                for j in range(8):
                    i = (17 * wave + j) % 4096
                    store.put(node_key(f"n{i:05d}"), encode_node(NodeInfo(
                        name=f"n{i:05d}", cpu_milli=(1 << 22) + wave,
                        mem_kib=1 << 30, pods=(1 << 15) - 1,
                    )))
                coord.step()
            coord.run_until_idle()
        finally:
            coord.close()
    traces = tracer.completed()
    assert len(traces) >= 40
    for t in traces:
        total = t.last_t - t.t0
        covered = sum(t1 - t0 for _, t0, t1, _ in t.spans)
        assert covered >= 0.95 * total, (t.key, covered, total)
    att = tracer.attribution()
    assert att["coverage"] >= 0.95
    assert abs(sum(s["share"] for s in att["stages"].values()) - 1.0) < 0.05
    assert {"queue_wait", "encode", "dispatch_wait", "device", "bind"} <= set(att["stages"])
    assert att["end_to_end"]["p50_ms"] > 0
    depths = {
        a.get("depth") for t in traces
        for s, _, _, a in t.spans if s == "device"
    }
    assert max(d for d in depths if d is not None) > 1


# ---- 4. flight-recorder integration -----------------------------------


def test_slow_pod_flight_dump_attaches_span_chain(tmp_path):
    flight = FlightRecorder(threshold_s=0.0, dump_dir=str(tmp_path))
    _traced_run(flight=flight, pods=3)
    dumps = sorted(f for f in os.listdir(tmp_path) if f.startswith("flight-"))
    assert dumps
    slow = None
    for fn in dumps:
        with open(tmp_path / fn) as f:
            doc = json.load(f)
        if "pod" in doc:
            slow = doc
            break
    assert slow is not None, dumps
    assert slow["pod"].startswith("default/p")
    stages = [s["stage"] for s in slow["pod_spans"]]
    assert "bind" in stages and "device" in stages
    assert all("dur_s" in s for s in slow["pod_spans"])
    assert slow["reason"].startswith(f"pod {slow['pod']}")


# ---- 5. the flight recorder (twin of tests/test_trace.py) ----------------

_DUMPS = REGISTRY.get("flight_dumps_total")


def _outcomes() -> dict:
    return {o: _DUMPS.value(outcome=o) for o in ("written", "suppressed", "error")}


def test_threshold_triggered_dump(tmp_path):
    rec = FlightRecorder(threshold_s=0.010, dump_dir=str(tmp_path))
    base = _outcomes()
    rec.record("fast", 0.001, queue=3)
    assert os.listdir(tmp_path) == []
    rec.record("slow", 0.050, queue=9)
    files = os.listdir(tmp_path)
    assert len(files) == 1
    with open(tmp_path / files[0]) as f:
        doc = json.load(f)
    assert "slow took" in doc["reason"]
    assert [s["name"] for s in doc["spans"]] == ["fast", "slow"]
    assert _outcomes()["written"] == base["written"] + 1


def test_ring_capacity_bound(tmp_path):
    rec = FlightRecorder(threshold_s=1.0, capacity=4, dump_dir=str(tmp_path))
    for i in range(10):
        rec.record(f"ev-{i}", 0.0)
    path = rec.dump(reason="manual")
    with open(path) as f:
        doc = json.load(f)
    assert [s["name"] for s in doc["spans"]] == ["ev-6", "ev-7", "ev-8", "ev-9"]


def test_max_dumps_suppression_counted_and_logged_once(tmp_path, caplog):
    rec = FlightRecorder(threshold_s=0.010, dump_dir=str(tmp_path), max_dumps=2)
    base = _outcomes()
    with caplog.at_level(logging.WARNING, logger="k8s1m.trace"):
        for _ in range(5):
            rec.record("slow", 0.050)
    assert len(os.listdir(tmp_path)) == 2
    out = _outcomes()
    assert out["written"] == base["written"] + 2
    assert out["suppressed"] == base["suppressed"] + 3
    suppression_logs = [
        r for r in caplog.records if "further dumps suppressed" in r.message
    ]
    assert len(suppression_logs) == 1


def test_oserror_dump_path_counted(tmp_path):
    rec = FlightRecorder(threshold_s=1.0, dump_dir=str(tmp_path / "does" / "not" / "exist"))
    rec.record("ev", 0.0)
    base = _outcomes()
    assert rec.dump(reason="manual") is None
    assert _outcomes()["error"] == base["error"] + 1


def test_dump_extra_payload_lands_in_doc(tmp_path):
    rec = FlightRecorder(threshold_s=1.0, dump_dir=str(tmp_path))
    rec.record("ev", 0.0)
    path = rec.dump(reason="manual", extra={"pod": "ns/p", "pod_spans": [{"stage": "bind"}]})
    with open(path) as f:
        doc = json.load(f)
    assert doc["pod"] == "ns/p"
    assert doc["pod_spans"] == [{"stage": "bind"}]
    assert doc["spans"]


# ---- 6. the sampling profiler (twin of tests/test_profiler.py) ------------


def _spin(deadline):
    x = 0
    while time.perf_counter() < deadline:
        for _ in range(1000):
            x += 1
    return x


def test_profiler_attributes_hot_function(tmp_path):
    old = sys.getswitchinterval()
    sys.setswitchinterval(0.001)
    try:
        prof = SamplingProfiler(hz=250)
        deadline = time.perf_counter() + 20.0
        with prof:
            while prof.samples < 25 and time.perf_counter() < deadline:
                _spin(time.perf_counter() + 0.3)
    finally:
        sys.setswitchinterval(old)
    assert prof.samples > 5
    rep = prof.report(top=1000)
    assert rep["top_self"], rep
    assert any("_spin" in row["frame"] for row in rep["top_self"]), rep["top_self"][:5]
    assert any("_spin" in stack.split(";")[-1] for stack in rep["collapsed"])
    path = prof.dump(str(tmp_path / "p.json"))
    with open(path) as f:
        disk = json.load(f)
    assert disk["thread_samples"] == rep["thread_samples"]
    assert prof.format_top().startswith("profile:")


def test_profiler_samples_other_threads():
    stop = threading.Event()

    def worker():
        while not stop.is_set():
            _spin(time.perf_counter() + 0.01)

    def seen_in_collapsed(rep):
        return any("_spin" in s for s in rep["collapsed"])

    t = threading.Thread(target=worker, name="hot-worker", daemon=True)
    t.start()
    try:
        with SamplingProfiler(hz=250) as prof:
            deadline = time.monotonic() + 10.0
            while time.monotonic() < deadline:
                time.sleep(0.25)
                if seen_in_collapsed(prof.report()):
                    break
    finally:
        stop.set()
        t.join()
    assert seen_in_collapsed(prof.report())


def test_profiler_excludes_late_started_profiler_thread():
    stop = threading.Event()

    def _late_decoy_spin():
        while not stop.is_set():
            time.sleep(0.002)

    prof = SamplingProfiler(hz=250).start()
    late = threading.Thread(target=_late_decoy_spin, name="sampling-profiler-late", daemon=True)
    try:
        late.start()
        deadline = time.monotonic() + 10.0
        while prof.samples < 10 and time.monotonic() < deadline:
            _spin(time.perf_counter() + 0.05)
    finally:
        stop.set()
        prof.stop()
        late.join()
    assert prof.samples > 0
    assert not any("_late_decoy_spin" in s for s in prof.stacks)


def test_slow_cycle_dumps_profile_artifact(tmp_path):
    """A cycle over the flight threshold writes a profile-slowcycle-*.json
    next to the flight dump."""
    prof = SamplingProfiler(hz=250).start()
    try:
        _traced_run(
            flight=FlightRecorder(threshold_s=0.0, dump_dir=str(tmp_path)),
            profiler=prof, pods=1,
        )
    finally:
        prof.stop()
    dumps = [f for f in os.listdir(tmp_path) if f.startswith("profile-slowcycle-")]
    assert dumps
    with open(tmp_path / dumps[0]) as f:
        art = json.load(f)
    assert "top_self" in art and "collapsed" in art


# ---- 7. lockstep with the JAX coordinator --------------------------------


def test_lockstep_traced_spans_equal_jax(lockpair):
    """Both coordinators trace every pod (sample_n=1) over the same writes:
    the same bind counts per step, byte-identical stores, the same traced
    pod keys with the same span names in the same order per pod; both
    validators accept the port's export."""
    from test_torch_coordinator import node_item, pod_item

    tracer, jtracer = PodTracer(sample_n=1), jpodtrace.PodTracer(sample_n=1)
    p = lockpair(max_nodes=64, batch=16, chunk=32, pipeline=True, depth=2,
                 tkw=dict(tracer=tracer), jkw=dict(tracer=jtracer))
    p.write([node_item(i, pods=4) for i in range(8)])
    p.bootstrap()
    for w in range(3):
        p.write([pod_item(f"p{w}-{i}") for i in range(12)])
        p.step()
    # More pods than pod slots: some park unschedulable after their retries.
    p.write([pod_item(f"x{i}") for i in range(6)])
    p.run_until_idle()
    p.check()

    def chains(tr):
        return {t.key: [s[0] for s in t.spans] for t in tr.completed()}

    got, want = chains(tracer), chains(jtracer)
    assert got == want and len(got) == 42
    assert {"queue_wait", "encode", "dispatch_wait", "device", "bind"} <= {
        s for c in got.values() for s in c}
    assert any(c[-1] == "requeue" for c in got.values())
    doc = tracer.to_trace_events()
    assert validate_trace(doc) == [] == jpodtrace.validate_trace(doc)
    assert tracer.attribution()["coverage"] == 1.0
