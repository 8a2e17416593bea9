"""The port's ``sched_bench`` entry point end to end on the CPU.

``python -m k8s1m_tpu_torch.tools.sched_bench ... --device cpu`` writes
4096 nodes and 8192 pods into its in-process store and drives the
coordinator to completion: every pod must bind (the warm-up pod outside
the measured window, the rest inside it), and the report must carry the
fields the chip run reads.  Tolerance: exact counts.
"""

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
    assert d["launches"] == {"fused_topk": 0, "delta_plane_topk": 0}
    waves = d["waves"]
    if extra:
        assert waves["delta"] > 0 and d["delta_enabled"]
    else:
        assert waves == {"full": 2, "delta": 0}
    for key in ("p50_ms", "p99_ms", "node_write_s", "cold_build_s", "stage_means_ms",
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
