"""End-to-end scheduling benchmark: store -> watch -> wave -> CAS binds.

The port's counterpart of ``k8s1m_tpu/tools/sched_bench.py``: the full
loop the coordinator runs, on the port's engine and kernels.  Nodes are
written into the store in waves of 8192, the coordinator
bootstraps (relist + bulk ingest + device table), one pod warms every
path up, and then one of two measured windows runs:

- **closed loop** (default): the pods are written one batch-sized wave at
  a time with a ``step()`` after each (the saturated loop), and
  ``run_until_idle`` drains the tail.  Reports binds/s.
- **paced** (``--rate R``): a producer emits pods on the offered-load
  schedule (``offered_pods_at``; ``--overload-at/-factor/-seconds`` step
  the rate up and back down) while the coordinator steps continuously
  with adaptive batch buckets, each bucket warmed before the window.
  Reports schedule-to-bind p50/p95/p99 at that load.

    python -m k8s1m_tpu_torch.tools.sched_bench --nodes 100000 --pods 50000
    python -m k8s1m_tpu_torch.tools.sched_bench --nodes 4096 --pods 8192 --device cpu
    python -m k8s1m_tpu_torch.tools.sched_bench --nodes 4096 --pods 4096 --rate 2000 \\
        --node-churn 4000 --shape-pool 8 --shape-share 0.9 --device cpu

Lanes that shape the load: ``--churn`` (delete bound pods behind the
producer), ``--node-churn RATE`` (capacity-only node updates at a wall-
clock rate), ``--shape-pool N``/``--shape-share F``/``--shape-cold``
(template-shaped pods with NodeAffinity terms, which turn the affinity
plugin on), ``--tenants N``/``--tenant-skew``/``--tenant-schedule`` (a
zipf tenant mix over namespaces).  ``--seed`` seeds the tenant and shape
draws only; every run uses wave seed 0, the JAX coordinator's.  Report
lanes: ``--stats`` (stage totals to stderr), ``--encode-profile``,
``--delta-profile`` and ``--kernel-profile`` (``tools/kernel_probe.py``
over the live table).

``--backend auto`` (default) runs the kernels on ``cuda`` and the scan
path on the CPU; ``--chunk`` defaults to 4096 for the kernels and 16384
for the scan path, clamped to the table.

The report (one JSON line, also written to ``--out``) carries the JAX
tool's keys for the lanes the port has, plus the port's own: the device,
``stage_means_ms`` of ``coordinator_cycle_seconds{stage}``, waves by path
(full / delta), and the kernel launches in the window (0 on the CPU,
where the wrappers run their plain versions), the fused kernel's also by
stage.  ``--fault-plan`` installs a faultline plan (inline JSON, ``@path``
or a named plan) for the run; the injected-fault and retry counts land in
the report.  ``--trace N`` traces 1-in-N pods through their lifecycle
(``obs/podtrace.py``; the waterfall lands in ``latency_attribution``,
``--trace-out`` writes the Perfetto export) and ``--profile PATH`` samples
the measured window (``obs/profiler.py``).  With nothing to compile,
``--churn`` skips the JAX tool's warm-up wave of 4096 throwaway pods.

``--mesh DPxSP`` (or ``auto``; unset defers to ``K8S1M_MESH``) runs every
wave over a dp x sp mesh (``parallel/``): the table's rows split over sp
shards, each wave's pods over dp ranks, several shards per card when the
mesh has more cells than the machine has cards.  The report's
``mesh_exec`` carries the axes, the sharded dirty-row scatters and the
per-dp-rank staged feed depth; ``--kernel-profile`` then times the
shard-local candidate step (``kernel_profile.mesh``).

    python -m k8s1m_tpu_torch.tools.sched_bench --nodes 4096 --pods 8192 \
        --mesh 2x2 --device cpu

The store is in-process by default (store and scheduler colocated, like
the reference's mem_etcd benchmarks).  ``--target host:port`` drives a
remote etcd-wire server instead (``store/remote.py`` over the port's own
HTTP/2 client; ``--ca-pem``/``--token`` for a TLS tier with bearer auth),
adding the wire hop to every write, relist, watch event and bind — the
deployed topology, where the scheduler is a client of the store:

    python -m k8s1m_tpu_torch.store.server_main --port 2379 &
    python -m k8s1m_tpu_torch.tools.sched_bench --target 127.0.0.1:2379 \
        --nodes 4096 --pods 8192 --device cpu

Over the wire a write's watch event can still be in flight when the
coordinator finds its queue empty, so the window's tail first waits on a
watch progress barrier (``RemoteWatcher.progress``).  ``--stress-watchers
N`` (needs ``--target``) runs ``tools/watch_stress.py`` against the same
server for the whole measured window — BASELINE config 5 is churn under
that apiserver stress — and its report (delivered events, stream errors)
lands in the report's ``watch_stress``.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import math
import os
import random
import signal
import subprocess
import sys
import time

import numpy as np

from k8s1m_tpu_torch import faultline
from k8s1m_tpu_torch.config import PodSpec, TableSpec
from k8s1m_tpu_torch.control.coordinator import OVERLAP_STAGES, Coordinator
from k8s1m_tpu_torch.control.objects import encode_node, encode_pod, node_key, pod_key
from k8s1m_tpu_torch.device import resolve_device
from k8s1m_tpu_torch.engine import deltacache
from k8s1m_tpu_torch.engine.cycle import BACKENDS, resolve_backend
from k8s1m_tpu_torch.obs.metrics import REGISTRY, quantile_report_ms
from k8s1m_tpu_torch.ops import delta_topk, fused_topk
from k8s1m_tpu_torch.parallel.mesh import resolve_mesh
from k8s1m_tpu_torch.plugins.registry import Profile
from k8s1m_tpu_torch.snapshot.hotfeed import ShardedHostFeed
from k8s1m_tpu_torch.snapshot.packing import FALLBACK_REASONS, bytes_report
from k8s1m_tpu_torch.snapshot.pod_encoding import PodInfo
from k8s1m_tpu_torch.store.native import MemStore
from k8s1m_tpu_torch.tools.make_nodes import KWOK_GROUPS, build_node

REFERENCE_E2E = 14_000.0
# build_node's labels repeat with its kwok groups, 8 zones and 4 regions.
NODE_PERIOD = math.lcm(KWOK_GROUPS, 8, 4)
STAGES = ("bootstrap", "drain", "encode", "sync", "device", "sync_out", "bind")
QUIESCE_REASONS = ("structural", "resync", "breaker", "adaptive")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="end-to-end scheduling bench (port)")
    ap.add_argument("--nodes", type=int, default=100_000)
    ap.add_argument("--pods", type=int, default=50_000)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--chunk", type=int, default=None,
                    help="scan chunk; default 4096 for the kernels, 16384 for the "
                    "scan path, clamped to the table")
    ap.add_argument("--backend", choices=BACKENDS, default="auto",
                    help="'pallas' = the hand-written CUDA kernels (their plain "
                    "versions on the CPU), 'xla' = the torch-op scan path, 'auto' "
                    "= the kernels on cuda and the scan path on the CPU")
    ap.add_argument("--rate", type=int, default=0,
                    help="offered load in pods/s (paced producer + adaptive batch "
                    "buckets; reports p50/p95/p99 schedule-to-bind).  0 = the "
                    "closed loop")
    ap.add_argument("--score-pct", type=int, default=100,
                    help="percentageOfNodesToScore (the reference's 1M-node "
                    "production config uses 5)")
    ap.add_argument("--no-pipeline", action="store_true")
    ap.add_argument("--stats", action="store_true",
                    help="print per-stage coordinator time totals to stderr")
    ap.add_argument("--encode-profile", action="store_true",
                    help="add host-feed evidence (encode seconds by path, template "
                    "cache hit rate, staged batches used and discarded)")
    ap.add_argument("--packing", choices=("off", "packed"), default=None,
                    help="device table layout; unset defers to K8S1M_PACKING")
    ap.add_argument("--deltacache", choices=("off", "on"), default=None,
                    help="cached per-shape planes (engine/deltacache.py); "
                    "unset defers to K8S1M_DELTASCHED")
    ap.add_argument("--delta-profile", action="store_true",
                    help="add delta-plane-cache evidence (delta vs full waves, "
                    "shape hit rate, dirty fraction, fills, evictions, index)")
    ap.add_argument("--delta-index-k", type=int, default=0, metavar="K",
                    help="per-plane top-K candidate index (needs --deltacache on)")
    ap.add_argument("--stratum-bits", type=int, default=0, metavar="B",
                    help="high jitter bits drawn from a per-node stratum hash")
    ap.add_argument("--shape-pool", type=int, default=0, metavar="N",
                    help="pods draw NodeAffinity shapes (required + preferred "
                    "terms) from a pool of N templates; turns the affinity "
                    "plugin on.  0 = plain pods")
    ap.add_argument("--shape-share", type=float, default=1.0, metavar="F",
                    help="with --shape-pool: share of pods drawing from the hot "
                    "pool; the rest draw from a 4N-template tail")
    ap.add_argument("--shape-cold", action="store_true",
                    help="every pod its own shape (unique request scalars)")
    ap.add_argument("--depth", type=int, default=2,
                    help="scheduling pipeline depth (waves in flight)")
    ap.add_argument("--churn", action="store_true",
                    help="delete the pods bound two waves ago while new waves "
                    "arrive (sustained create+delete instead of a fill-up)")
    ap.add_argument("--node-churn", type=float, default=0.0, metavar="RATE",
                    help="capacity-only node updates per second during the "
                    "measured window (heartbeat / capacity traffic)")
    ap.add_argument("--overload-at", type=float, default=0.0,
                    help="seconds into the paced window to step the offered rate "
                    "up by --overload-factor for --overload-seconds (needs --rate)")
    ap.add_argument("--overload-seconds", type=float, default=300.0)
    ap.add_argument("--overload-factor", type=float, default=5.0)
    ap.add_argument("--tenants", type=int, default=0,
                    help="spread the pods over N tenant namespaces with zipf "
                    "sizes (cluster/workload.py tenant_assignments).  0 = one "
                    "namespace")
    ap.add_argument("--tenant-skew", type=float, default=1.0,
                    help="zipf skew of tenant sizes (0 = uniform)")
    ap.add_argument("--tenant-schedule", default="steady",
                    choices=("steady", "diurnal", "flash"),
                    help="tenant-mix shape along the emission sequence")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the tenant and shape draws (never the wave seed)")
    ap.add_argument("--kernel-profile", action="store_true",
                    help="after the window, time the plugin-knockout variants of "
                    "the candidate step over the live table (tools/kernel_probe.py)")
    ap.add_argument("--fault-plan", default=None,
                    help="faultline plan: inline JSON, @path or a named plan "
                    "(deterministic drop/delay/disconnect/conflict injection at the "
                    "coordinator's bind, watch and dispatch hooks); the injected-fault "
                    "and retry counts land in the report")
    ap.add_argument("--trace", type=int, default=0, metavar="N",
                    help="podtrace (obs/podtrace.py): trace 1-in-N pods through the "
                    "whole lifecycle (head-sampled by pod-key hash); the stage-"
                    "attribution waterfall lands in the report's latency_attribution "
                    "detail.  0 = off (the null tracer)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="with --trace: write the Chrome/Perfetto trace-event JSON "
                    "export to PATH (stages as tracks, pods as flow events)")
    ap.add_argument("--profile", default=None, metavar="PATH",
                    help="sample the measured window with obs/profiler.py, write the "
                    "collapsed-stack artifact to PATH and print the self-time top "
                    "table to stderr")
    ap.add_argument("--target", default=None,
                    help="remote store addr host:port (default: in-process store)")
    ap.add_argument("--ca-pem", default=None,
                    help="TLS: trust this CA for --target (a secured tier)")
    ap.add_argument("--token", default=None, help="bearer token for --target")
    ap.add_argument("--stress-watchers", type=int, default=0,
                    help="run the apiserver-stress equivalent (tools/watch_stress) as a "
                    "subprocess against the same --target for the whole measured window "
                    "(config 5 is churn under watch stress).  Requires --target")
    ap.add_argument("--stress-write-concurrency", type=int, default=1,
                    help="stressor's concurrent writers (keep low, or the stressor "
                    "starves the scheduler it is stressing)")
    ap.add_argument("--mesh", default=None, metavar="DPxSP",
                    help="run the waves over a dp x sp mesh (parallel/sharded_cycle.py): "
                    "DPxSP or DP,SP (cells go round-robin over the visible cards), or "
                    "'auto' (largest workload-valid split of the cards); unset defers to "
                    "K8S1M_MESH, 'none' opts out.  Byte-identical to one device at "
                    "score-pct 100")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default=None, metavar="PATH",
                    help="also write the report JSON to PATH")
    args = ap.parse_args(argv)
    if args.overload_at and not args.rate:
        ap.error("--overload-at requires --rate (the paced producer)")
    if args.trace_out and not args.trace:
        ap.error("--trace-out requires --trace (the pod tracer)")
    return args


def offered_pods_at(args, t: float) -> float:
    """Cumulative offered pods ``t`` seconds into the paced window: the
    integral of the piecewise-constant offered rate, so the overload
    phase is a rate step, not a one-off burst."""
    if not args.overload_at or args.overload_factor <= 1.0:
        return args.rate * t
    t1 = args.overload_at
    t2 = t1 + args.overload_seconds
    total = args.rate * min(t, t1)
    if t > t1:
        total += args.rate * args.overload_factor * (min(t, t2) - t1)
    if t > t2:
        total += args.rate * (t - t2)
    return total


def write_wave(store, items) -> None:
    """Apply (key, value | None-for-delete) pairs in one batched call."""
    store.put_batch(items)


def write_nodes(store, nodes: int) -> None:
    """Write ``nodes`` KWOK nodes in waves of 8192, each value byte for
    byte ``encode_node(build_node(i))``.  The objects differ only in the
    name and in three labels that repeat every ``NODE_PERIOD`` nodes, so
    each residue is encoded once and the name spliced in (a 1M-node fleet
    in about a tenth of the time of one encode per node)."""
    parts = []
    for r in range(min(NODE_PERIOD, nodes)):
        enc = encode_node(build_node(r))
        at = enc.index(f'"name":"kwok-node-{r}"'.encode()) + len('"name":"')
        parts.append((enc[:at], enc[at + len(f"kwok-node-{r}"):]))
    for i0 in range(0, nodes, 8192):
        items = []
        for i in range(i0, min(nodes, i0 + 8192)):
            name = f"kwok-node-{i}"
            pre, post = parts[i % NODE_PERIOD]
            items.append((node_key(name), pre + name.encode() + post))
        write_wave(store, items)


class _ChurnFrontier:
    """Which emitted pods are safe to delete: only BOUND ones, and a pod
    that binds after the frontier swept past is deleted later."""

    def __init__(self, coord, key_strs, start: int = 1):
        self._coord = coord
        self._key_strs = key_strs
        self._at = start
        self._pending: list[int] = []

    def advance(self, frontier: int) -> list[int]:
        if frontier > self._at:
            self._pending.extend(range(self._at, frontier))
            self._at = frontier
        bound = self._coord._bound
        dels = [i for i in self._pending if self._key_strs[i] in bound]
        if dels:
            hit = set(dels)
            self._pending = [i for i in self._pending if i not in hit]
        return dels


class _NodeChurn:
    """Paced capacity-only node updates (same name and labels, wiggled
    allocatable cpu): every update targets a node the table holds, so the
    pipelined coordinator scatters it mid-flight without a quiesce.
    ``advance(elapsed_s)`` writes the updates due by then, at most 4096
    per call, so a long wave cannot turn catch-up into one giant write."""

    def __init__(self, store, nodes: int, rate: float):
        self._store = store
        self._nodes = nodes
        self._rate = rate
        self.emitted = 0

    def advance(self, elapsed_s: float) -> None:
        due = min(int(self._rate * elapsed_s), self.emitted + 4096)
        if due <= self.emitted:
            return
        items = []
        for j in range(self.emitted, due):
            i = j % self._nodes
            items.append((
                node_key(f"kwok-node-{i}"),
                encode_node(build_node(i, cpu_milli=32000 + (j // self._nodes) % 16)),
            ))
        write_wave(self._store, items)
        self.emitted = due


def _stage_means_ms() -> dict:
    cyc = REGISTRY.get("coordinator_cycle_seconds")
    out = {}
    for stage in STAGES:
        n = cyc.count(stage=stage)
        if n:
            out[stage] = round(cyc.sum(stage=stage) / n * 1e3, 3)
    return out


def _print_stage_stats(window_s: float) -> None:
    """Per-stage coordinator time totals over the measured window."""
    cyc = REGISTRY.get("coordinator_cycle_seconds")
    for key in sorted(cyc.label_keys()):
        stage = dict(zip(cyc.labelnames, key)).get("stage", "?")
        total = cyc.sum(stage=stage)
        print(f"# stage {stage:10s} {total * 1e3:9.1f} ms total "
              f"({total / window_s * 100:5.1f}% of window)", file=sys.stderr)


def _quiesce_counts() -> dict:
    q = REGISTRY.get("pipeline_quiesce_total")
    return {r: q.value(reason=r) for r in QUIESCE_REASONS}


def _overlap_totals() -> tuple[float, float]:
    """(hidden, exposed) host-stage seconds so far."""
    ov = REGISTRY.get("pipeline_stage_overlap_seconds_total")
    return (
        sum(ov.value(stage=s, inflight="yes") for s in OVERLAP_STAGES),
        sum(ov.value(stage=s, inflight="no") for s in OVERLAP_STAGES),
    )


def _encode_counts() -> dict:
    enc = REGISTRY.get("hotfeed_encode_seconds_total")
    stale = REGISTRY.get("hotfeed_stale_batches_total")
    return {
        "inline": enc.value(path="inline"),
        "feed": enc.value(path="feed"),
        "hits": REGISTRY.get("hotfeed_cache_hits_total").value(),
        "misses": REGISTRY.get("hotfeed_cache_misses_total").value(),
        "used": REGISTRY.get("hotfeed_staged_used_total").value(),
        **{f"stale_{r}": stale.value(reason=r) for r in ("vocab", "reordered", "error",
                                                         "merge")},
    }


class _Window:
    """The baselines of one measured window, taken after the warm-up (warm
    waves count adaptive quiesces): quiesce and overlap totals, the
    host-feed and deltacache counters, the depth samples and the node
    churn source."""

    def __init__(self, coord, store, args):
        coord.depth_timer.reset()
        self.quiesce = _quiesce_counts()
        self.overlap = _overlap_totals()
        self.encode = _encode_counts()
        self.delta = copy.deepcopy(deltacache.COUNTERS)
        self.depth_samples: list[int] = []
        # Per-dp-rank staged feed depth, sampled with depth_samples.
        self.feed_depth_samples: list[list[int]] = []
        self.node_churn = (_NodeChurn(store, args.nodes, args.node_churn)
                           if args.node_churn else None)

    def sample(self, coord) -> None:
        """One depth sample (after a step while the producer is live)."""
        self.depth_samples.append(len(coord._inflights))
        feed = getattr(coord, "_feed", None)
        if isinstance(feed, ShardedHostFeed):
            self.feed_depth_samples.append(feed.depths())

    def mesh_detail(self, coord) -> dict:
        """dp x sp execution evidence (empty on a single device): the
        axes, the sharded dirty-row scatters, and the per-dp-rank staged
        feed depth sampled while the producer was live."""
        if coord.mesh is None:
            return {}
        sc = REGISTRY.get("mesh_sharded_scatter_total")
        detail = {
            "dp": int(coord.mesh.shape["dp"]),
            "sp": int(coord.mesh.shape["sp"]),
            "sharded_scatters": {c: int(sc.value(cols=c)) for c in ("full", "cap")},
        }
        if self.feed_depth_samples:
            per_shard = np.asarray(self.feed_depth_samples)      # [samples, dp]
            detail["feed_staged_depth_per_shard"] = {
                "max": per_shard.max(axis=0).tolist(),
                "mean": [round(float(v), 3) for v in per_shard.mean(axis=0)],
            }
        return {"mesh_exec": detail}

    def pipeline_detail(self, coord) -> dict:
        """Quiesce / in-flight-depth / overlap evidence for the report."""
        hid, exposed = _overlap_totals()
        hid -= self.overlap[0]
        exposed -= self.overlap[1]
        now = _quiesce_counts()
        samples = np.asarray(self.depth_samples or [0])
        churn = self.node_churn
        return {
            "node_churn_rate": churn._rate if churn else 0.0,
            "node_churn_events": churn.emitted if churn else 0,
            "pipeline_quiesce": {
                r: int(now[r] - self.quiesce[r]) for r in QUIESCE_REASONS
            },
            # Depth sampled after every step while the producer was live.
            "sustained_inflight_depth": int(np.median(samples)),
            "max_inflight_depth": int(samples.max()),
            "depth_seconds": {
                str(k): round(v, 4) for k, v in coord.depth_timer.seconds().items()
            },
            # Share of host-stage time that ran while waves were in flight.
            "stage_overlap_ratio": (
                round(hid / (hid + exposed), 4) if hid + exposed else None
            ),
        }

    def encode_profile(self, enabled: bool) -> dict:
        """Host-feed evidence over the window (empty unless asked for)."""
        if not enabled:
            return {}
        now = _encode_counts()
        d = {k: now[k] - self.encode[k] for k in now}
        cyc = REGISTRY.get("coordinator_cycle_seconds")
        hm = d["hits"] + d["misses"]
        return {"encode_profile": {
            "host_encode_seconds": {
                "inline": round(d["inline"], 4), "feed": round(d["feed"], 4),
            },
            "encode_stage_seconds": round(cyc.sum(stage="encode"), 4),
            "cache_hit_rate": round(d["hits"] / hm, 4) if hm else None,
            "staged_used": int(d["used"]),
            "staged_stale": {
                r: int(d[f"stale_{r}"]) for r in ("vocab", "reordered", "error", "merge")
            },
            "staged_depth": int(REGISTRY.get("hotfeed_staged_depth").value()),
        }}

    def delta_profile(self, enabled: bool, coord) -> dict:
        """Delta-plane-cache evidence over the window (empty unless asked
        for)."""
        if not enabled:
            return {}
        c = deltacache.COUNTERS

        def delta(name, label=""):
            return c[name][label] - self.delta[name][label]

        delta_waves = delta("deltasched_waves_total", "delta")
        hits = delta("deltasched_shape_hits_total")
        misses = delta("deltasched_shape_misses_total")
        rows = coord.table_spec.max_nodes
        detail = {
            "enabled": coord.delta_enabled,
            "delta_waves": int(delta_waves),
            "full_waves": int(delta("deltasched_waves_total", "full")),
            "shape_hit_rate": round(hits / (hits + misses), 4) if hits + misses else None,
            # Journaled dirty rows recomputed, as a share of the full
            # recompute the delta waves displaced.
            "mean_dirty_fraction": (
                round(delta("deltasched_dirty_rows_total") / (delta_waves * rows), 6)
                if delta_waves else None
            ),
            "planes_resident": deltacache.planes_resident(),
            "fills": int(delta("deltasched_fills_total")),
            "evictions": int(delta("deltasched_evictions_total")),
        }
        cache = coord._delta
        if cache is not None and cache.index_k:
            idx_waves = delta("deltasched_index_waves_total", "index")
            plane_waves = delta("deltasched_index_waves_total", "plane")
            t_idx = delta("deltasched_index_touched_rows_total", "index")
            t_plane = delta("deltasched_index_touched_rows_total", "plane")
            reasons = ("underflow", "oversized-dirty", "fill", "generation", "resync",
                       "packing", "fill-error", "dispatch-error")
            detail["index"] = {
                "index_k": int(cache.index_k),
                "stratum_bits": int(cache.stratum_bits),
                "index_waves": int(idx_waves),
                "plane_waves": int(plane_waves),
                "mean_touched_rows": {
                    "index": round(t_idx / idx_waves, 1) if idx_waves else None,
                    "plane": round(t_plane / plane_waves, 1) if plane_waves else None,
                },
                "index_touched_fraction_of_n": (
                    round(t_idx / (idx_waves * rows), 6) if idx_waves else None
                ),
                "drops": {
                    r: int(delta("deltasched_index_drops_total", r)) for r in reasons
                    if delta("deltasched_index_drops_total", r)
                },
            }
        return {"delta_profile": detail}


def _trace_detail(args, tracer) -> dict:
    """Stage-attribution waterfall for the report (empty without
    --trace): per-stage p50/p99 and share of the end-to-end total,
    coverage, and the optional Perfetto export."""
    from k8s1m_tpu_torch.obs.podtrace import trace_report_detail

    return trace_report_detail(tracer, args.trace_out)


@contextlib.contextmanager
def _profiled(args, coord):
    """The sampling profiler around the measured window (``--profile``):
    dumped to the path and its top table printed to stderr even when the
    window raises."""
    prof = None
    if args.profile:
        from k8s1m_tpu_torch.obs.profiler import SamplingProfiler

        prof = SamplingProfiler().start()
        coord.profiler = prof
    try:
        yield
    finally:
        if prof is not None:
            prof.stop()
            prof.dump(args.profile)
            print(prof.format_top(), file=sys.stderr)


def _start_watch_stress(args) -> subprocess.Popen:
    """Spawn the apiserver-stress equivalent against ``--target`` for the
    measured window (``_stressed`` stops it)."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    cmd = [sys.executable, "-m", "k8s1m_tpu_torch.tools.watch_stress",
           "--target", args.target, "--watchers", str(args.stress_watchers),
           "--write-concurrency", str(args.stress_write_concurrency),
           "--writes", str(1 << 30)]
    if args.ca_pem:
        cmd += ["--ca-pem", args.ca_pem]
    if args.token:
        cmd += ["--token", args.token]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p))
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
                            text=True, env=env, cwd=root)


@contextlib.contextmanager
def _stressed(args, out: dict):
    """The watch stressor around the measured window (``--stress-watchers``):
    SIGTERM at the end, its report into ``out["watch_stress"]``; on every
    exit path the process is stopped (killed if it lingers) and reaped."""
    if not args.stress_watchers:
        yield
        return
    proc = _start_watch_stress(args)
    try:
        yield
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            stdout, _ = proc.communicate(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            stdout, _ = proc.communicate()
        lines = (stdout or "").strip().splitlines()
        out["watch_stress"] = json.loads(lines[-1]) if lines else None
        out["watch_stress_rc"] = proc.returncode


def _settle(coord) -> None:
    """Over the wire a write's watch event may still be in flight when the
    coordinator finds its queue empty: a progress barrier on each watch
    brings every event written so far into its queue.  The in-process
    watcher has no ``progress`` and needs none."""
    for w in (coord._nodes_watch, coord._pods_watch):
        progress = getattr(w, "progress", None)
        if progress is not None:
            progress()


def _tenant_detail(args) -> dict:
    """Tenant-load shape for the report (empty without --tenants)."""
    if not args.tenants:
        return {}
    return {"tenant_load": {
        "tenants": args.tenants,
        "skew": args.tenant_skew,
        "schedule": args.tenant_schedule,
        "seed": args.seed,
    }}


def _device_state_detail(coord) -> dict:
    """Table layout, bytes per node and whether the wave commits in place,
    plus any fail-closed layout rebuilds."""
    fb = REGISTRY.get("device_packing_fallback_total")
    return {"device_state": {
        **bytes_report(coord.table, coord.table_spec),
        "donation_inplace": coord.donation_inplace,
        "packing_fallbacks": {
            r: int(fb.value(reason=r)) for r in FALLBACK_REASONS if fb.value(reason=r)
        },
    }}


def _kernel_profile_detail(args, coord) -> dict:
    """Plugin-knockout decomposition of the candidate step over the
    coordinator's live table (empty unless --kernel-profile).  Under
    --mesh it times the SHARD-LOCAL step over the first sp shard (the live
    layout, read only) and records dp/sp and rows_per_shard, so the
    ms/batch numbers read as one cell's cost at the full batch."""
    if not args.kernel_profile:
        return {}
    from k8s1m_tpu_torch.tools.kernel_probe import profile_stages

    table = coord.table if coord.mesh is None else coord.table.shard(0)
    prof = profile_stages(table, coord.encoder, chunk=args.chunk, k=coord.k,
                          steps=3, backend=args.backend)
    if coord.mesh is not None:
        prof["mesh"] = {
            "dp": int(coord.mesh.shape["dp"]),
            "sp": int(coord.mesh.shape["sp"]),
            "rows_per_shard": int(table.num_rows),
        }
    prof["bytes_per_node"] = bytes_report(table, coord.table_spec)
    prof["batch"] = coord.pod_spec.batch
    return {"kernel_profile": prof}


def _launches() -> dict:
    return {
        "fused_topk": fused_topk.fused_topk.launches,
        "delta_plane_topk": delta_topk.delta_plane_topk.launches,
        "fused_topk_by_stage": dict(fused_topk.fused_topk.launches_by_stage),
    }


def _pod_values(args):
    """(values, keys, key strings) of the bench pods: the tenant
    namespaces (``--tenants``, drawn from ``--seed``) and the pod shapes
    (``--shape-cold``, or ``--shape-pool`` templates drawn per pod from
    ``random.Random((seed << 20) | i)``)."""
    if args.tenants > 0:
        from k8s1m_tpu_torch.cluster.workload import tenant_assignments

        tenant_ids = tenant_assignments(args.pods, args.tenants, skew=args.tenant_skew,
                                        seed=args.seed, schedule=args.tenant_schedule)
        namespaces = [f"tenant-{t}" for t in tenant_ids]
    else:
        namespaces = ["default"] * args.pods
    templates = []
    if args.shape_pool:
        # Deployment-template shapes against the KWOK zone/region labels
        # (a required In over two zones and a region NotIn, plus a
        # preferred zone), made key-distinct by the request scalar: a
        # hot pool of N and a 4N tail.
        from k8s1m_tpu_torch.cluster.workload import node_affinity_pods

        templates = node_affinity_pods(5 * args.shape_pool, zones=8, regions=4)
        for j, t in enumerate(templates):
            t.cpu_milli = 10 + j

    def bench_pod(i: int) -> PodInfo:
        p = PodInfo(f"bench-{i}", namespace=namespaces[i], cpu_milli=10, mem_kib=1024)
        if args.shape_cold:
            p.cpu_milli = 10 + i
            return p
        if templates:
            rng = random.Random((args.seed << 20) | i)
            hot = rng.random() < args.shape_share
            j = (rng.randrange(args.shape_pool) if hot
                 else args.shape_pool + rng.randrange(4 * args.shape_pool))
            t = templates[j]
            p.cpu_milli = t.cpu_milli
            p.required_terms = t.required_terms
            p.preferred_terms = t.preferred_terms
        return p

    values = [encode_pod(bench_pod(i)) for i in range(args.pods)]
    keys = [pod_key(namespaces[i], f"bench-{i}") for i in range(args.pods)]
    key_strs = [f"{namespaces[i]}/bench-{i}" for i in range(args.pods)]
    return values, keys, key_strs


def _warm_buckets(coord, store) -> None:
    """One wave of every adaptive bucket (and the full batch) before the
    paced window, in its own namespace."""
    b = coord.min_batch
    warm = {coord.pod_spec.batch}
    while b <= coord.pod_spec.batch:
        warm.add(b)
        b <<= 1
    woff = 0
    for b in sorted(warm):
        write_wave(store, [
            (pod_key("warm2", f"r-{woff + i}"),
             encode_pod(PodInfo(f"r-{woff + i}", cpu_milli=1, mem_kib=1)))
            for i in range(b)
        ])
        woff += b
        coord.run_until_idle()
    # Every warm pod bound before the window opens, or it would count in it.
    deadline = time.perf_counter() + 30.0
    while (sum(1 for k in coord._bound if k.startswith("warm2/")) < woff
           and time.perf_counter() < deadline):
        coord.run_until_idle()
        time.sleep(0.05)


def _reset_window_metrics(coord) -> None:
    REGISTRY.get("coordinator_schedule_to_bind_seconds").reset()
    REGISTRY.get("coordinator_cycle_seconds").reset()
    coord.waves.clear()
    fused_topk.reset_launches()
    delta_topk.reset_launches()


def _paced_window(args, coord, store, values, keys, key_strs):
    """The paced producer: pods emitted on the offered-load schedule while
    the coordinator steps continuously.  Returns (bound, deleted,
    seconds, window)."""
    lag = min(3 * coord.pod_spec.batch, max(args.pods // 4, 64))
    win = _Window(coord, store, args)
    churn = _ChurnFrontier(coord, key_strs)
    bound = deleted = 0
    emitted = 1
    t0 = time.perf_counter()
    while emitted < args.pods or coord.queue or coord._inflights or coord._backoff:
        due = min(args.pods, 1 + int(offered_pods_at(args, time.perf_counter() - t0)))
        if due > emitted:
            write_wave(store, list(zip(keys[emitted:due], values[emitted:due])))
            emitted = due
        if win.node_churn is not None:
            win.node_churn.advance(time.perf_counter() - t0)
        if args.churn:
            # Every cycle, not only on emission: binds that land after the
            # producer finished must still be deleted.
            dels = churn.advance(emitted - lag)
            if dels:
                write_wave(store, [(keys[i], None) for i in dels])
                deleted += len(dels)
        bound += coord.step()
        if emitted < args.pods:
            win.sample(coord)
        if (emitted >= args.pods and not coord.queue and not coord._inflights
                and not coord._backoff):
            _settle(coord)
            bound += coord.run_until_idle()
            if args.churn:
                dels = churn.advance(emitted - lag)
                if dels:
                    write_wave(store, [(keys[i], None) for i in dels])
                    deleted += len(dels)
            break
    return bound, deleted, time.perf_counter() - t0, win


def _closed_window(args, coord, store, values, keys, key_strs):
    """The closed loop: one batch-sized wave of pods per ``step()``, then
    the tail.  Returns (bound, deleted, seconds, window)."""
    wave = args.batch
    win = _Window(coord, store, args)
    churn = _ChurnFrontier(coord, key_strs)
    bound = deleted = 0
    off = 1
    t0 = time.perf_counter()
    while off < args.pods:
        write_wave(store, list(zip(keys[off:off + wave], values[off:off + wave])))
        if win.node_churn is not None:
            win.node_churn.advance(time.perf_counter() - t0)
        if args.churn:
            dels = churn.advance(off - 2 * wave)
            if dels:
                write_wave(store, [(keys[i], None) for i in dels])
                deleted += len(dels)
        off += wave
        bound += coord.step()
        if off < args.pods:
            win.sample(coord)
    _settle(coord)
    bound += coord.run_until_idle()
    seconds = time.perf_counter() - t0
    if args.churn:
        dels = churn.advance(args.pods)
        if dels:
            write_wave(store, [(keys[i], None) for i in dels])
            deleted += len(dels)
    return bound, deleted, seconds, win


def _resilience_detail() -> dict:
    """Injected-fault and retry evidence (empty when no plan fired)."""
    fired = faultline.active_injector().fire_counts()
    if not fired:
        return {}
    return {
        "faults_injected": fired,
        "retry_attempts": faultline.retry_counts(),
        "give_ups": faultline.give_up_counts(),
        "recovery": faultline.recovery_stats(),
    }


def run(args, **coord_kw):
    """Drive the bench; returns (report, coordinator, store).  The store
    and the coordinator stay open for the caller's checks
    (``chip_smoke.py`` reads both); ``main`` closes them.  ``coord_kw``
    goes to the Coordinator (a test's deterministic ``retry_policy``)."""
    if args.stress_watchers and not args.target:
        raise SystemExit("--stress-watchers requires --target (wire store)")
    device = resolve_device(args.device)
    args.backend = resolve_backend(args.backend, device)
    if args.chunk is None:
        args.chunk = (1 << 12) if args.backend == "pallas" else (1 << 14)
    if args.fault_plan:
        faultline.install_plan(faultline.FaultPlan.from_arg(args.fault_plan))

    if args.target:
        from k8s1m_tpu_torch.store.remote import RemoteStore

        store = RemoteStore(args.target, ca_pem=args.ca_pem, token=args.token)
    else:
        store = MemStore()
    t0 = time.perf_counter()
    write_nodes(store, args.nodes)
    nodes_s = time.perf_counter() - t0

    cap = 1 << max(10, (args.nodes - 1).bit_length())
    # The chunked scan needs chunk <= table rows (both powers of two).
    args.chunk = min(args.chunk, cap)
    # One resolve here (explicit --mesh, or K8S1M_MESH when unset) so the
    # chunk clamp applies however the mesh was selected, and `--mesh none`
    # opts out even where the environment sets K8S1M_MESH.
    mesh = resolve_mesh(args.mesh, batch=args.batch, max_nodes=cap, chunk=args.chunk,
                        device=device)
    if mesh is not None:
        # The chunked scan runs per shard; clamp to the shard's rows.
        args.chunk = min(args.chunk, cap // mesh.shape["sp"])
    # Template-shaped pods do per-(pod, node) selector work, so the
    # affinity plugin is on for them; plain pods keep it off.
    profile = (
        Profile(topology_spread=0, interpod_affinity=0) if args.shape_pool
        else Profile(node_affinity=0, topology_spread=0, interpod_affinity=0)
    )
    tracer = None
    if args.trace:
        from k8s1m_tpu_torch.obs.podtrace import PodTracer

        tracer = PodTracer(sample_n=args.trace)
    coord = Coordinator(
        store, TableSpec(max_nodes=cap), PodSpec(batch=args.batch), profile,
        chunk=args.chunk, with_constraints=False, backend=args.backend,
        pipeline=not args.no_pipeline, depth=args.depth,
        score_pct=args.score_pct, adaptive_batch=bool(args.rate),
        packing=args.packing, deltacache=args.deltacache,
        delta_index_k=args.delta_index_k, stratum_bits=args.stratum_bits,
        device=device, tracer=tracer, mesh=mesh if mesh is not None else "none",
        **coord_kw,
    )
    t0 = time.perf_counter()
    coord.bootstrap()
    bootstrap_s = time.perf_counter() - t0
    cold_build_s = REGISTRY.get("megarow_cold_build_seconds").value()

    # Pre-encode pod values (the writer's cost, not the scheduler's).
    values, keys, key_strs = _pod_values(args)
    # Warm every path up outside the measured window (one pod).
    store.put(keys[0], values[0])
    while coord.run_until_idle() == 0:
        pass
    if args.rate:
        _warm_buckets(coord, store)
    _reset_window_metrics(coord)
    window = _paced_window if args.rate else _closed_window
    stress: dict = {}
    with _stressed(args, stress), _profiled(args, coord):
        bound, deleted, sched_s, win = window(args, coord, store, values, keys, key_strs)
    launches = _launches()
    if args.stats:
        _print_stage_stats(sched_s)

    lat = REGISTRY.get("coordinator_schedule_to_bind_seconds")
    cyc = REGISTRY.get("coordinator_cycle_seconds")
    e2e = bound / sched_s if sched_s else 0.0
    detail = {
        "device": str(coord.device),
        "backend": args.backend,
        "nodes": args.nodes,
        "pods": args.pods,
        "batch": args.batch,
        "chunk": args.chunk,
        "score_pct": args.score_pct,
        "pipeline": not args.no_pipeline,
        "depth": args.depth,
        "bound": bound,
        "deleted": deleted,
        "node_create_s": round(nodes_s, 3),
        "bootstrap_s": round(bootstrap_s, 3),
        "cold_build_s": round(cold_build_s, 3),
        "schedule_s": round(sched_s, 3),
        "stage_means_ms": _stage_means_ms(),
        "device_share": round(cyc.sum(stage="device") / sched_s, 4) if sched_s else None,
        "waves": {p: coord.waves[p] for p in ("full", "delta")},
        "launches": launches,
        "delta_enabled": coord.delta_enabled,
        "target": args.target,
        "stress_watchers": args.stress_watchers,
        "mesh": args.mesh,
        **win.mesh_detail(coord),
        **stress,
        **win.pipeline_detail(coord),
        **_tenant_detail(args),
        **_trace_detail(args, tracer),
        **win.encode_profile(args.encode_profile),
        **win.delta_profile(args.delta_profile, coord),
        **_device_state_detail(coord),
        **_kernel_profile_detail(args, coord),
        **_resilience_detail(),
    }
    if args.rate:
        q = quantile_report_ms(lat)
        report = {
            "metric": f"e2e_p50_bind_ms_{args.nodes}_nodes_at_{args.rate}",
            "value": q["p50_ms"],
            "unit": "ms",
            "vs_baseline": None,
            "detail": {
                "rate": args.rate,
                "overload": (
                    {"at_s": args.overload_at, "seconds": args.overload_seconds,
                     "factor": args.overload_factor}
                    if args.overload_at else None
                ),
                "binds_per_sec": round(e2e, 1),
                "unbound": args.pods - 1 - bound,
                **q,
                **detail,
            },
        }
    else:
        q = quantile_report_ms(lat, (0.5, 0.99))
        suffix = f"_pct{args.score_pct}" if args.score_pct != 100 else ""
        report = {
            "metric": f"e2e_binds_per_sec_{args.nodes}_nodes{suffix}",
            "value": round(e2e, 1),
            "unit": "binds/s",
            "vs_baseline": round(e2e / REFERENCE_E2E, 3),
            "detail": {
                "pod_create_per_sec": round(args.pods / sched_s, 1) if sched_s else None,
                "p50_bind_ms": q["p50_ms"],
                **q,
                **detail,
            },
        }
    return report, coord, store


def main(argv=None) -> dict:
    from k8s1m_tpu_torch.obs.profiler import install_signal_dump

    # On-demand stack dump (SIGUSR2 -> stacks-<pid>-<t>.txt in the
    # temporary directory): a run that stops progressing can be asked
    # where it is without being killed.
    install_signal_dump()
    args = parse_args(argv)
    try:
        report, coord, store = run(args)
    finally:
        if args.fault_plan:
            faultline.install_plan(None)
    coord.close()
    store.close()
    print(json.dumps(report), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return report


if __name__ == "__main__":
    main()
