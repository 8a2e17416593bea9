"""The port's megarow drill against the JAX package's, on the CPU.

- The incremental preemption-victims index equals the full ``_bound``
  scan through binds, deletions, a preemption, a node removal and a
  resync (twin of tests/test_megarow.py's victims test), with both
  coordinators in lockstep.
- ``index_differential`` at 8,192 nodes: the port's deltacache+index lane
  and full-recompute lane leave the same stored pods, pod for pod, as the
  JAX drill's two lanes (each lane's store is read as it closes).
- The port's drill passes its own gates on the CPU at a reduced shape:
  16,384 nodes, batch 128, chunk 1024, differential at 8,192 nodes, 8
  steady + 6 overload + 40 recover + 8 saturated ticks, 64 node updates
  per tick.  The comparison lane's >= 3x cold-build gate is a timing
  ratio, which a shared CPU at this scale does not hold steadily (2.3x to
  3.7x at 8,192-65,536 nodes); the run skips the lane (``--compare-nodes
  0``), a separate test holds the two lanes' tables byte-identical, and
  the card run of ``chip_smoke.py`` gates the ratio at 131,072 nodes.
Tolerance: exact equality.
"""

import _torch_cpu  # noqa: F401  (bounds torch's CPU threads first)

import numpy as np
import pytest

import k8s1m_tpu.store.native as jnative
import k8s1m_tpu.tools.megarow_drill as jdrill
import k8s1m_tpu.tenancy as jtn
from k8s1m_tpu_torch.control.objects import encode_node, encode_pod, node_key, pod_key
from k8s1m_tpu_torch.snapshot.node_table import NodeInfo
from k8s1m_tpu_torch.snapshot.pod_encoding import PodInfo
from k8s1m_tpu_torch.store import native as tnative
from k8s1m_tpu_torch.tenancy import TenancyController, TenancyPolicy
from k8s1m_tpu_torch.tools import megarow_drill as drill
from test_torch_loadshed import LockPair


def _victims(index):
    return {row: sorted(tuple(getattr(v, f) for f in (
        "key", "node", "row", "cpu_milli", "mem_kib", "priority", "seq", "tenant"))
        for v in vs) for row, vs in dict(index.items()).items()}


def test_victims_index_incremental_matches_full_scan():
    pol = dict(log_preemptions=True)
    p = LockPair(max_nodes=16, zones=4, regions=2, batch=16, chunk=16, seed=3,
                 tkw=dict(tenancy=TenancyController(TenancyPolicy(**pol))),
                 jkw=dict(tenancy=jtn.TenancyController(jtn.TenancyPolicy(**pol))))
    try:
        p.write([(node_key(f"n{i:03d}"), encode_node(NodeInfo(
            name=f"n{i:03d}", cpu_milli=8000, mem_kib=1 << 20, pods=16))) for i in range(8)])
        p.bootstrap()
        coord = p.t
        assert coord._track_victims

        def check():
            assert coord._victims_index() == coord._victims_index_full()
            assert _victims(coord._victims_index()) == _victims(p.j._victims_index())

        for i in range(48):
            pod = PodInfo(f"f-{i:03d}", namespace=f"t{i % 3}", cpu_milli=1000, mem_kib=1 << 10)
            p.put(pod_key(pod.namespace, pod.name), encode_pod(pod))
        p.run_until_idle()
        assert p.bound == 48
        check()
        for store in (p.jstore, p.tstore):
            store.put_batch([(pod_key("t0", "f-000"), None), (pod_key("t1", "f-001"), None)])
        coord.drain_watches()
        p.j.drain_watches()
        check()
        p.put(pod_key("t9", "pre"), encode_pod(PodInfo("pre", namespace="t9", cpu_milli=8000,
                                                       mem_kib=1 << 10, priority=5)))
        p.run_until_idle()
        assert coord.preempt_log and coord.preempt_log == p.j.preempt_log
        check()
        for store in (p.jstore, p.tstore):
            store.put_batch([(node_key("n003"), None)])
        coord.drain_watches()
        p.j.drain_watches()
        check()
        coord.resync()
        p.j.resync()
        check()
        p.step()            # the sync uploads the relisted rows
        p.check()
    finally:
        p.close()


def _capturing(module, monkeypatch):
    """Replace ``module.MemStore`` by a subclass that records every pod's
    stored bytes as the store closes; returns the list of records."""
    captured = []
    base = module.MemStore

    class Capture(base):
        def close(self):
            kvs, _ = module.list_prefix(self, b"/registry/pods/")
            captured.append({kv.key: kv.value for kv in kvs})
            super().close()

    monkeypatch.setattr(module, "MemStore", Capture)
    return captured


def test_index_differential_matches_jax(monkeypatch):
    argv = ["--nodes", "8192", "--batch", "128", "--chunk", "1024",
            "--differential-nodes", "8192"]
    got_cap = _capturing(tnative, monkeypatch)
    got = drill.index_differential(8192, drill.parse_args([*argv, "--device", "cpu"]))
    want_cap = _capturing(jnative, monkeypatch)
    want = jdrill.index_differential(8192, jdrill.parse_args(argv))
    assert got == want
    assert got["byte_identical"] and got["index_waves"] > 0 and got["bound"] > 0
    # Lane for lane (index, then full recompute), stored pod for stored pod.
    assert len(got_cap) == len(want_cap) == 2
    assert got_cap == want_cap
    assert all(b'"nodeName"' in v for v in got_cap[0].values())


def test_parse_args_match_jax():
    for argv in ([], ["--smoke"], ["--nodes", "65536", "--stratum-bits", "0"]):
        got, want = vars(drill.parse_args(argv)), vars(jdrill.parse_args(argv))
        assert got.pop("device") == "cuda"
        assert got == want
    assert drill.stratum_bits_for(1 << 20) == jdrill.stratum_bits_for(1 << 20) == 15


def test_cold_build_lanes_byte_identical():
    out = drill.cold_build_compare(8192, "packed", "cpu")
    assert out["byte_identical"] and out["nodes"] == 8192
    assert out["bulk_lane_seconds"] > 0 and out["per_node_loop_seconds"] > 0


def test_drill_passes_gates_on_cpu():
    result = drill.main([
        "--device", "cpu", "--nodes", "16384", "--batch", "128", "--chunk", "1024",
        "--compare-nodes", "0", "--differential-nodes", "8192",
        "--steady-ticks", "8", "--overload-ticks", "6", "--recover-ticks", "40",
        "--sat-ticks", "8", "--churn-per-tick", "64",
    ])
    ev = result["evidence"]
    assert result["metric"] == "pod_binds_per_sec_16384_nodes"
    assert result["passed"], ev
    assert ev["lost"] == 0 and ev["retry_give_ups"] == 0
    assert ev["pipeline_quiesce"] == {"structural": 0, "resync": 0}
    assert ev["states_seen"] == ["degraded", "healthy", "shedding"]
    assert ev["recovered_at_tick"] is not None and ev["rejected"] > 0
    assert ev["cold_build_compare"] is None
    assert ev["index_differential"]["byte_identical"]
    assert ev["index_waves"]["index"] > 0
    assert ev["host_mirror_bytes"] == ev["host_mirror_bytes_metric"] > 0
    assert ev["binds_per_sec"] > 0 and np.isfinite(ev["binds_per_sec_composed"])
    assert set(ev) == set(_JAX_EVIDENCE_KEYS)


# The evidence keys of the JAX drill's result (megarow_drill.py:657-721).
_JAX_EVIDENCE_KEYS = (
    "nodes", "weights", "packing", "deltacache", "score_pct", "delta_index_k",
    "stratum_bits", "index_waves", "index_drops", "index_differential", "bulk_ingest",
    "cold_build_seconds", "cold_build_metric_seconds", "cold_build_compare",
    "host_mirror_bytes", "host_mirror_bytes_metric", "peak_rss_mib", "rss_budget_mib",
    "window_seconds", "window_bound", "binds_per_sec_composed", "saturated_seconds",
    "saturated_bound", "binds_per_sec", "admitted", "rejected", "lost", "node_churn_events",
    "pipeline_quiesce", "sustained_inflight_depth", "max_inflight_depth", "states_seen",
    "recovered_at_tick", "retry_give_ups", "packing_fallbacks", "passed",
)


@pytest.fixture(autouse=True)
def _no_plan_leak():
    from k8s1m_tpu_torch.faultline import install_plan

    yield
    install_plan(None)
