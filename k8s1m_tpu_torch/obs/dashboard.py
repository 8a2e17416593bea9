"""Grafana dashboard generator — the grafana-dashboard/ equivalent.

The reference ships a hand-maintained 66-panel dashboard JSON with
dedicated Scheduler / etcd / apiserver / kwok rows
(reference grafana-dashboard/dashboard.json; panels like "Scheduling
attempt rate" and "kwok_node_lease_delay_percentile max").  Hand-written
dashboards drift as metrics change, so here the dashboard is *generated*
from the metric registry: every Counter becomes a rate panel, every
Gauge a timeseries, every Histogram a p50/p99 percentile panel, grouped
into rows by subsystem prefix.

    python -m k8s1m_tpu_torch.obs.dashboard > dashboard.json

imports the subsystems first so their metrics register, then emits a
Grafana v10 schema dashboard for a Prometheus datasource scraping
obs.http.start_metrics_server / the store server's --metrics-port.

The port's own copy of ``k8s1m_tpu/obs/dashboard.py``, over the port's
registry: the metric names are the JAX package's, so the panels are too.
"""

from __future__ import annotations

import json

from k8s1m_tpu_torch.obs.metrics import (
    CallbackMetric,
    Counter,
    Gauge,
    Histogram,
    REGISTRY,
)

# Row layout mirrors the reference dashboard's subsystem rows and is the
# JAX package's list: every metric the port declares must land under some
# prefix (no unobservable evidence; tests/test_torch_dashboard.py checks
# it), and a row whose prefixes match no declared metric is left out.
ROWS = [
    ("Scheduler", ("coordinator_", "leader_", "webhook_", "shardset_")),
    # Quiesce-free pipelining evidence: quiesce reasons, in-flight depth,
    # and the host-stage overlap split (pipeline_* in control/coordinator).
    ("Scheduling cycle", ("pipeline_",)),
    # Per-pod lifecycle tracing (obs/podtrace.py): the schedule-to-bind
    # latency decomposed by stage, trace-bus accounting, and the
    # flight recorder's dump-budget outcomes (obs/trace.py).
    ("Latency attribution", ("pod_stage_", "podtrace_", "flight_")),
    # Cached + overlapped pod encoding (snapshot/hotfeed.py): encode
    # seconds by path, template-cache hit/miss, staged-batch use and the
    # stale-discard reasons.
    ("Host feed", ("hotfeed_",)),
    # The dp x sp sharded execution path (parallel/): mesh axis sizes,
    # sharded dirty-row scatters by column class, per-dp-shard feed depth.
    ("Mesh (dp x sp sharded cycle)", ("mesh_",)),
    # Incremental scheduling (engine/deltacache.py): delta vs full wave
    # split, per-pod shape hit/miss, plane fills and LRU evictions
    # (HBM-budget pressure), journaled dirty rows (mean dirty fraction),
    # and planes resident across live caches.
    ("Incremental scheduling (deltasched)", ("deltasched_",)),
    # The 1,048,576-row operating shape (the megarow drill): cold-build
    # wall seconds (bootstrap relist -> bulk ingest -> device table),
    # bulk-ingest row rate (snapshot/bulkload + bulk_upsert), and the
    # host mirror's column-byte budget under the narrow-dtype rule.
    ("Million-row (megarow)", ("megarow_",)),
    # Packed device snapshot + buffer donation (snapshot/packing.py):
    # table HBM bytes by layout, per-wave commit donations split by
    # whether the runtime honored them in place, and fail-closed
    # packed-layout rebuilds by overflow reason.
    ("Device memory", ("device_", "commit_donation_")),
    ("Overload control", ("loadshed_", "admission_", "breaker_",
                          "degraded_")),
    # Multi-tenant fairness (tenancy/): per-class admitted
    # throughput and debt, preemption evictions, gang all-or-none
    # settlement outcomes.
    ("Multi-tenant fairness", ("tenant_", "preemption_", "gang_")),
    # Coordinator failover (control/leader.py): takeover counts and
    # recovery seconds by warm/cold mode, lease-epoch fence rejections
    # by write path, the standby mirror's watch lag, and reconcile
    # repairs at takeover.
    ("Failover", ("failover_", "fencing_", "standby_")),
    # Fault injection + the one shared RetryPolicy (faultline/).
    ("Resilience (faultline)", ("faultline_", "retry_")),
    ("Store (mem-etcd)", ("memstore_",)),
    # The apiserver-tier fan-out under storm (the watch-cache tier):
    # upstream breaks split into diff-replay resumes vs cancel-everyone
    # invalidations, per-subscriber latest-only coalescing volume, and
    # the live count of lag-degraded watchers.
    ("Watch fanout (watchplane)", ("watchcache_",)),
    ("KWOK nodes", ("kwok_", "kubelet_")),
]

_PANEL_W = 8
_PANEL_H = 7


def _target(expr: str, legend: str = "") -> dict:
    return {"expr": expr, "legendFormat": legend or "{{instance}}"}


def _panel(pid: int, title: str, targets: list[dict], x: int, y: int) -> dict:
    return {
        "id": pid,
        "title": title,
        "type": "timeseries",
        "datasource": {"type": "prometheus", "uid": "${datasource}"},
        "gridPos": {"h": _PANEL_H, "w": _PANEL_W, "x": x, "y": y},
        "fieldConfig": {"defaults": {"unit": "short"}, "overrides": []},
        "targets": targets,
    }


def _panels_for(metric) -> list[tuple[str, list[dict]]]:
    name = metric.name
    labels = "by (%s) " % ", ".join(metric.labelnames) if metric.labelnames else ""
    if isinstance(metric, Counter):
        return [(
            f"{name} rate",
            [_target(f"sum {labels}(rate({name}[1m]))",
                     "-".join("{{%s}}" % l for l in metric.labelnames))],
        )]
    if isinstance(metric, Histogram):
        return [(
            f"{name} p50/p99",
            [
                _target(
                    f"histogram_quantile(0.5, sum by (le) (rate({name}_bucket[1m])))",
                    "p50",
                ),
                _target(
                    f"histogram_quantile(0.99, sum by (le) (rate({name}_bucket[1m])))",
                    "p99",
                ),
            ],
        )]
    if isinstance(metric, Gauge):
        return [(
            name,
            [_target(f"sum {labels}({name})",
                     "-".join("{{%s}}" % l for l in metric.labelnames))],
        )]
    if isinstance(metric, CallbackMetric):
        # Scrape-computed sample sets (e.g. the store's lock-contention
        # cells, labeled by method/structure/rw, reference
        # "mem_etcd_lock_count" panels).
        if metric.kind == "counter":
            return [(f"{name} rate", [_target(f"rate({name}[1m])")])]
        return [(name, [_target(name)])]
    return []


def build_dashboard(registry=None) -> dict:
    registry = registry or REGISTRY
    panels = []
    pid = 1
    y = 0
    for row_title, prefixes in ROWS:
        row_metrics = [
            m for m in registry.metrics()
            if any(m.name.startswith(p) for p in prefixes)
        ]
        if not row_metrics:
            continue
        panels.append({
            "id": pid, "type": "row", "title": row_title,
            "collapsed": False,
            "gridPos": {"h": 1, "w": 24, "x": 0, "y": y},
        })
        pid += 1
        y += 1
        x = 0
        for m in sorted(row_metrics, key=lambda m: m.name):
            for title, targets in _panels_for(m):
                panels.append(_panel(pid, title, targets, x, y))
                pid += 1
                x += _PANEL_W
                if x >= 24:
                    x = 0
                    y += _PANEL_H
        if x:
            y += _PANEL_H
    return {
        "title": "k8s1m-tpu",
        "uid": "k8s1m-tpu",
        "schemaVersion": 39,
        "refresh": "10s",
        "time": {"from": "now-30m", "to": "now"},
        "templating": {
            "list": [{
                "name": "datasource", "type": "datasource",
                "query": "prometheus",
            }]
        },
        "panels": panels,
    }


def main() -> None:
    # Import the subsystems for their metric registrations — the
    # dashboard covers whatever the code actually exports.
    import k8s1m_tpu_torch.cluster.kwok_controller  # noqa: F401
    import k8s1m_tpu_torch.control.coordinator  # noqa: F401
    import k8s1m_tpu_torch.control.leader  # noqa: F401
    import k8s1m_tpu_torch.control.webhook  # noqa: F401
    import k8s1m_tpu_torch.loadshed  # noqa: F401
    import k8s1m_tpu_torch.store.etcd_server  # noqa: F401
    import k8s1m_tpu_torch.store.watch_cache  # noqa: F401
    import k8s1m_tpu_torch.tenancy  # noqa: F401

    print(json.dumps(build_dashboard(), indent=1))


if __name__ == "__main__":
    main()
