"""The port's ``sched_bench`` entry point end to end on the CPU.

``python -m k8s1m_tpu_torch.tools.sched_bench ... --device cpu`` writes
4096 nodes and 8192 pods into its in-process store and drives the
coordinator to completion: every pod must bind (the warm-up pod outside
the measured window, the rest inside it), and the report must carry the
fields the chip run reads.  Tolerance: exact counts.
"""

import _torch_cpu  # noqa: F401  (bounds torch's CPU threads first)

import json

import pytest

from k8s1m_tpu_torch.store.native import list_prefix
from k8s1m_tpu_torch.tools import sched_bench

ARGS = ["--nodes", "4096", "--pods", "8192", "--device", "cpu"]


@pytest.mark.parametrize("extra", [[], ["--deltacache", "on", "--packing", "packed"]],
                         ids=["full", "deltacache"])
def test_main_binds_every_pod(tmp_path, extra):
    out = tmp_path / "report.json"
    report = sched_bench.main(ARGS + extra + ["--out", str(out)])
    d = report["detail"]
    assert d["bound"] + 1 == 8192
    assert json.loads(out.read_text()) == report
    assert d["device"] == "cpu"
    # On the CPU the wrappers run their plain versions: no launch.
    assert d["launches"] == {"fused_topk": 0, "delta_plane_topk": 0, "fused_topk_by_stage": {
        "base": 0, "aff": 0, "cons": 0, "aff+cons": 0}}
    waves = d["waves"]
    if extra:
        assert waves["delta"] > 0 and d["delta_enabled"]
    else:
        assert waves == {"full": 2, "delta": 0}
    for key in ("p50_ms", "p99_ms", "node_create_s", "cold_build_s", "stage_means_ms",
                "device_share"):
        assert key in d
    assert {"encode", "device", "sync_out", "bind"} <= d["stage_means_ms"].keys()


def test_churn_deletes_bound_pods_and_store_agrees():
    args = sched_bench.parse_args(ARGS + ["--pods", "4096", "--batch", "512", "--churn",
                                          "--score-pct", "25", "--no-pipeline"])
    report, coord, store = sched_bench.run(args)
    try:
        d = report["detail"]
        assert d["bound"] + 1 == 4096 and d["deleted"] > 0
        kvs, _ = list_prefix(store, b"/registry/pods/")
        assert len(kvs) == 4096 - d["deleted"]
        assert all(b'"nodeName"' in kv.value for kv in kvs)
        coord.drain_watches()
        assert int(coord.host.pods_req.sum()) == len(kvs)
    finally:
        coord.close()
        store.close()


# ---- the lanes of this slice ---------------------------------------------------

SMALL = ["--nodes", "256", "--batch", "128", "--device", "cpu"]
# Flags of the JAX tool the port leaves out, and the report keys they own
# (none since the port runs the mesh).
JAX_ONLY_KEYS: set = set()


def _stored(store):
    kvs, _ = list_prefix(store, b"/registry/pods/")
    return {kv.key: kv.value for kv in kvs}


def _run(argv, **kw):
    report, coord, store = sched_bench.run(sched_bench.parse_args(argv), **kw)
    try:
        coord.flush()
        return report, coord, _stored(store)
    finally:
        coord.close()
        store.close()


def test_seed_does_not_reach_the_wave():
    """``--seed`` seeds the tenant and shape draws only: without either
    lane, two seeds leave the same stored pods (the JAX tool never passes
    it to its Coordinator, so every run uses wave seed 0)."""
    argv = ["--nodes", "1024", "--pods", "1024", "--batch", "256", "--no-pipeline",
            "--device", "cpu"]
    _r0, c0, s0 = _run(argv + ["--seed", "0"])
    _r1, c1, s1 = _run(argv + ["--seed", "1"])
    assert s0 == s1 and len(s0) == 1024
    assert all(b'"nodeName"' in v for v in s0.values())
    assert c0.key == c1.key


def _key_sets(report, prefix=""):
    """Every key path of a report, nested dicts included (except the maps
    whose keys are data: levels, variants, and the reasons counted so far
    in the process)."""
    out = set()
    for k, v in report.items():
        path = f"{prefix}{k}"
        out.add(path)
        if isinstance(v, dict) and k not in ("depth_seconds", "ms_per_batch", "stages",
                                              "drops", "packing_fallbacks"):
            out |= _key_sets(v, path + ".")
    return out


@pytest.mark.parametrize("lane", [
    ["--pods", "2048", "--depth", "3", "--node-churn", "4000", "--shape-pool", "4",
     "--shape-share", "0.9", "--seed", "3", "--tenants", "3", "--tenant-schedule", "flash",
     "--encode-profile", "--delta-profile", "--stats", "--packing", "packed"],
    ["--pods", "1024", "--rate", "4000", "--overload-at", "0.1", "--overload-seconds",
     "0.1", "--overload-factor", "3", "--shape-cold", "--deltacache", "on",
     "--delta-profile", "--churn"],
    ["--pods", "1024", "--trace", "4"],
    ["--pods", "1024", "--mesh", "2x2", "--kernel-profile"],
], ids=["closed", "paced", "trace", "mesh"])
def test_report_keys_match_jax(tmp_path, lane):
    """The port's report carries every key the JAX tool's report carries
    at the same arguments, except those of the JAX-only flags."""
    from k8s1m_tpu.tools.sched_bench import main as jax_main

    want = jax_main(["--nodes", "256", "--batch", "128", "--backend", "xla"] + lane)
    got = sched_bench.main(SMALL + lane + ["--out", str(tmp_path / "r.json")])
    missing = {k for k in _key_sets(want) - _key_sets(got)
               if k.split(".")[1] not in JAX_ONLY_KEYS}
    assert not missing
    d = got["detail"]
    assert d["bound"] == want["detail"]["bound"] and d["backend"] == "xla"
    assert d["pipeline_quiesce"]["structural"] == d["pipeline_quiesce"]["resync"] == 0
    if "--rate" in lane:
        assert d["unbound"] == 0 and d["deleted"] > 0
        assert d["pipeline_quiesce"]["adaptive"] > 0
        assert d["p50_ms"] <= d["p95_ms"] <= d["p99_ms"]
        assert d["overload"] == {"at_s": 0.1, "seconds": 0.1, "factor": 3.0}
        # Every pod its own shape: the plane cache never serves a wave.
        assert d["delta_profile"]["delta_waves"] == 0
    elif "--mesh" in lane:
        assert d["mesh"] == "2x2" and d["mesh_exec"].keys() == want["detail"]["mesh_exec"].keys()
        assert (d["mesh_exec"]["dp"], d["mesh_exec"]["sp"]) == (2, 2)
        assert d["kernel_profile"]["mesh"] == want["detail"]["kernel_profile"]["mesh"]
    elif "--trace" in lane:
        att, jatt = d["latency_attribution"], want["detail"]["latency_attribution"]
        assert att["pods"] == jatt["pods"] and att["sample_n"] == 4
        assert att["stages"].keys() == jatt["stages"].keys()
        assert att["coverage"] == 1.0
    else:
        assert d["tenant_load"]["schedule"] == "flash"
        assert d["encode_profile"]["cache_hit_rate"] > 0.9


def test_node_churn_holds_the_pipeline():
    """The JAX churn smoke's gate (tests/test_pipeline_churn.py) on the
    port: capacity-only node churn never quiesces the pipeline, which
    holds its depth while the producer is live, and every pod binds."""
    report = sched_bench.main(SMALL + ["--pods", "2048", "--depth", "3",
                                       "--node-churn", "4000"])
    d = report["detail"]
    assert d["node_churn_events"] > 0
    assert d["pipeline_quiesce"]["structural"] == 0
    assert d["pipeline_quiesce"]["resync"] == 0
    assert d["sustained_inflight_depth"] == 3
    assert d["max_inflight_depth"] == 3
    assert d["bound"] == 2047


def test_shape_pool_and_tenants_shape_the_pods():
    """``--shape-pool`` turns the affinity plugin on and stores the
    template terms; ``--tenants`` spreads the pods over the namespaces
    ``tenant_assignments`` draws from ``--seed``."""
    from k8s1m_tpu_torch.cluster.workload import tenant_assignments

    report, coord, stored = _run(SMALL + [
        "--pods", "1024", "--shape-pool", "4", "--shape-share", "0.5", "--seed", "5",
        "--tenants", "4", "--tenant-skew", "1.5", "--tenant-schedule", "diurnal"])
    assert coord.profile.node_affinity > 0 and report["detail"]["bound"] == 1023
    ids = tenant_assignments(1024, 4, skew=1.5, seed=5, schedule="diurnal")
    want = {f"/registry/pods/tenant-{t}/bench-{i}".encode() for i, t in enumerate(ids)}
    assert set(stored) == want
    assert all(b"nodeAffinity" in v for v in stored.values())


def test_kernel_profile_lane():
    report = sched_bench.main(SMALL + ["--pods", "512", "--packing", "packed",
                                       "--kernel-profile"])
    kp = report["detail"]["kernel_profile"]
    assert kp["backend"] == "xla" and kp["batch"] == 128
    assert kp["ms_per_batch"]["full"] > 0 and kp["stages"]["filter_topk_floor"] > 0
    assert kp["bytes_per_node"]["layout"] == "packed"


def test_offered_pods_at_steps_the_rate():
    args = sched_bench.parse_args(["--rate", "100", "--overload-at", "2",
                                   "--overload-seconds", "1", "--overload-factor", "4"])
    assert [sched_bench.offered_pods_at(args, t) for t in (1, 2, 3, 4)] == [
        100, 200, 600, 700]
    with pytest.raises(SystemExit):
        sched_bench.parse_args(["--overload-at", "2"])
    # The JAX tool's mesh, remote-store, fault-plan, trace and profile
    # flags are the port's too.
    assert sched_bench.parse_args(["--mesh", "2x2"]).mesh == "2x2"
    args = sched_bench.parse_args(["--target", "h:1", "--ca-pem", "ca.pem", "--token", "t",
                                   "--stress-watchers", "2", "--stress-write-concurrency", "3"])
    assert (args.target, args.ca_pem, args.token, args.stress_watchers,
            args.stress_write_concurrency) == ("h:1", "ca.pem", "t", 2, 3)
    assert sched_bench.parse_args(["--fault-plan", "watchstorm"]).fault_plan == "watchstorm"
    args = sched_bench.parse_args(["--trace", "4", "--trace-out", "t.json", "--profile", "p.json"])
    assert (args.trace, args.trace_out, args.profile) == (4, "t.json", "p.json")
    with pytest.raises(SystemExit):
        sched_bench.parse_args(["--trace-out", "t.json"])


def test_write_nodes_writes_encode_node_bytes():
    """The spliced node writer stores exactly ``encode_node(build_node(i))``
    (and the JAX tool's bytes) for every node, across label periods and
    name lengths."""
    from k8s1m_tpu.control.objects import encode_node as jax_encode_node
    from k8s1m_tpu.tools.make_nodes import build_node as jax_build_node
    from k8s1m_tpu_torch.control.objects import encode_node
    from k8s1m_tpu_torch.store.native import MemStore
    from k8s1m_tpu_torch.tools.make_nodes import build_node

    for n in (3, 10_123):
        with MemStore() as store:
            sched_bench.write_nodes(store, n)
            kvs, _ = list_prefix(store, b"/registry/minions/")
            got = {kv.key: kv.value for kv in kvs}
        assert len(got) == n
        for i in range(n):
            v = got[f"/registry/minions/kwok-node-{i}".encode()]
            assert v == encode_node(build_node(i))
            if i % 97 == 0:
                assert v == jax_encode_node(jax_build_node(i))


# ---- the wire lanes (--target, --stress-watchers) ------------------------------


def test_stress_watchers_need_a_target():
    """Refused with the JAX tool's message, before anything is written."""
    with pytest.raises(SystemExit, match="--stress-watchers requires --target"):
        sched_bench.main(SMALL + ["--pods", "64", "--stress-watchers", "2"])


@pytest.mark.parametrize("lane", [[], ["--churn", "--stress-watchers", "4"]],
                         ids=["target", "config5"])
def test_target_report_keys_match_jax(lane):
    """``--target`` against a store server, the port's tool against the
    port's server and the JAX tool against the JAX one: the port's report
    carries the JAX report's keys (``stress_watchers`` included), every pod
    binds over the wire, and with ``--stress-watchers`` the stressor's own
    report is read back (every event delivered to every watcher, no failed
    stream) and its process is gone."""
    import k8s1m_tpu.store.native as jnative
    from k8s1m_tpu.tools.sched_bench import main as jax_main
    from k8s1m_tpu_torch.store.server_main import serve_subprocess

    shape = ["--nodes", "256", "--batch", "128", "--pods", "1024"]
    with jnative.MemStore() as js, jnative.WireFront(js) as jwf:
        want = jax_main(shape + ["--backend", "xla", "--target", f"127.0.0.1:{jwf.port}"]
                        + lane)
    with serve_subprocess() as (proc, target):
        args = sched_bench.parse_args(shape + ["--device", "cpu", "--target", target] + lane)
        report, coord, store = sched_bench.run(args)
        try:
            coord.flush()
            stored = _stored(store)
        finally:
            coord.close()
            store.close()
    assert proc.returncode is not None
    missing = {k for k in _key_sets(want) - _key_sets(report)
               if k.split(".")[1] not in JAX_ONLY_KEYS}
    assert not missing
    d = report["detail"]
    assert d["bound"] == 1023 and d["target"] == target
    if lane:
        assert d["deleted"] > 0 and len(stored) == 1024 - d["deleted"]
        ws = d["watch_stress"]
        assert d["stress_watchers"] == ws["watchers"] == 4 and d["watch_stress_rc"] == 0
        assert ws["stream_errors"] == 0 and ws["writes"] > 0
        assert ws["events_delivered"] == 4 * ws["writes"]
    else:
        assert len(stored) == 1024 and all(b'"nodeName"' in v for v in stored.values())
        assert d["stress_watchers"] == 0 and "watch_stress" not in d
