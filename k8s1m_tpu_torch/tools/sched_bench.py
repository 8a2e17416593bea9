"""End-to-end scheduling benchmark: store -> watch -> wave -> CAS binds.

The port's counterpart of ``k8s1m_tpu/tools/sched_bench.py``: the full
loop the coordinator runs, on the port's engine and kernels.  Nodes are
written into an in-process store in waves of 8192, the coordinator
bootstraps (relist + bulk ingest + device table), one pod warms every
path up, and then the pods are written one batch-sized wave at a time
with a ``step()`` after each (the closed, saturated loop), and
``run_until_idle`` drains the tail.

    python -m k8s1m_tpu_torch.tools.sched_bench --nodes 100000 --pods 50000
    python -m k8s1m_tpu_torch.tools.sched_bench --nodes 4096 --pods 8192 --device cpu

The report (one JSON line, also written to ``--out``): binds/s over the
measured window, schedule-to-bind p50/p99
(``coordinator_schedule_to_bind_seconds``, the warm-up pod excluded),
node write and bootstrap (cold build) seconds, per-stage means of
``coordinator_cycle_seconds{stage}``, waves by path (full / delta) and
the launches of each kernel in the window (0 on the CPU, where the
wrappers run their plain versions).  ``--seed`` seeds the coordinator's
wave PRNG (the JAX tool's ``--seed`` seeds tenant mixes, which the port
does not have; both default to 0, which is the JAX coordinator's seed).
"""

from __future__ import annotations

import argparse
import json
import time

from k8s1m_tpu_torch.config import PodSpec, TableSpec
from k8s1m_tpu_torch.control.coordinator import OVERLAP_STAGES, Coordinator
from k8s1m_tpu_torch.control.objects import encode_node, encode_pod, node_key, pod_key
from k8s1m_tpu_torch.obs.metrics import REGISTRY, quantile_report_ms
from k8s1m_tpu_torch.ops import delta_topk, fused_topk
from k8s1m_tpu_torch.plugins.registry import Profile
from k8s1m_tpu_torch.snapshot.packing import bytes_report
from k8s1m_tpu_torch.snapshot.pod_encoding import PodInfo
from k8s1m_tpu_torch.store.native import MemStore
from k8s1m_tpu_torch.tools.make_nodes import build_node

STAGES = ("bootstrap", "drain", "encode", "sync", "device", "sync_out", "bind")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="end-to-end scheduling bench (port)")
    ap.add_argument("--nodes", type=int, default=100_000)
    ap.add_argument("--pods", type=int, default=50_000)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--chunk", type=int, default=4096)
    ap.add_argument("--depth", type=int, default=2,
                    help="scheduling pipeline depth (waves in flight)")
    ap.add_argument("--no-pipeline", action="store_true")
    ap.add_argument("--score-pct", type=int, default=100,
                    help="percentageOfNodesToScore (the reference's 1M-node "
                    "production config uses 5)")
    ap.add_argument("--packing", choices=("off", "packed"), default=None,
                    help="device table layout; unset defers to K8S1M_PACKING")
    ap.add_argument("--deltacache", choices=("off", "on"), default=None,
                    help="cached per-shape planes (engine/deltacache.py); "
                    "unset defers to K8S1M_DELTASCHED")
    ap.add_argument("--delta-index-k", type=int, default=0, metavar="K",
                    help="per-plane top-K candidate index (needs --deltacache on)")
    ap.add_argument("--stratum-bits", type=int, default=0, metavar="B",
                    help="high jitter bits drawn from a per-node stratum hash")
    ap.add_argument("--seed", type=int, default=0, help="coordinator wave PRNG seed")
    ap.add_argument("--churn", action="store_true",
                    help="delete the pods bound two waves ago while new waves "
                    "arrive (sustained create+delete instead of a fill-up)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default=None, metavar="PATH",
                    help="also write the report JSON to PATH")
    return ap.parse_args(argv)


def write_wave(store, items) -> None:
    """Apply (key, value | None-for-delete) pairs in one batched call."""
    store.put_batch(items)


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


def _stage_means_ms() -> dict:
    cyc = REGISTRY.get("coordinator_cycle_seconds")
    out = {}
    for stage in STAGES:
        n = cyc.count(stage=stage)
        if n:
            out[stage] = round(cyc.sum(stage=stage) / n * 1e3, 3)
    return out


def run(args, **coord_kw):
    """Drive the bench; returns (report, coordinator, store).  The store
    and the coordinator stay open for the caller's checks
    (``chip_smoke.py`` reads both); ``main`` closes them.  ``coord_kw``
    goes to the Coordinator (a test's deterministic ``retry_policy``)."""
    store = MemStore()
    t0 = time.perf_counter()
    items = []
    for i in range(args.nodes):
        items.append((node_key(f"kwok-node-{i}"), encode_node(build_node(i))))
        if len(items) == 8192:
            write_wave(store, items)
            items.clear()
    if items:
        write_wave(store, items)
    nodes_s = time.perf_counter() - t0

    cap = 1 << max(10, (args.nodes - 1).bit_length())
    chunk = min(args.chunk, cap)
    coord = Coordinator(
        store, TableSpec(max_nodes=cap), PodSpec(batch=args.batch),
        Profile(node_affinity=0, topology_spread=0, interpod_affinity=0),
        chunk=chunk, with_constraints=False,
        pipeline=not args.no_pipeline, depth=args.depth,
        score_pct=args.score_pct, packing=args.packing,
        deltacache=args.deltacache, delta_index_k=args.delta_index_k,
        stratum_bits=args.stratum_bits, seed=args.seed, device=args.device,
        **coord_kw,
    )
    t0 = time.perf_counter()
    coord.bootstrap()
    bootstrap_s = time.perf_counter() - t0
    cold_build_s = REGISTRY.get("megarow_cold_build_seconds").value()

    # Pre-encode pod values (the writer's cost, not the scheduler's).
    values = [
        encode_pod(PodInfo(f"bench-{i}", cpu_milli=10, mem_kib=1024))
        for i in range(args.pods)
    ]
    keys = [pod_key("default", f"bench-{i}") for i in range(args.pods)]
    key_strs = [f"default/bench-{i}" for i in range(args.pods)]

    # Warm every path up outside the measured window (one pod).
    store.put(keys[0], values[0])
    while coord.run_until_idle() == 0:
        pass

    REGISTRY.get("coordinator_schedule_to_bind_seconds").reset()
    REGISTRY.get("coordinator_cycle_seconds").reset()
    coord.waves.clear()
    coord.depth_timer.reset()
    fused_topk.reset_launches()
    delta_topk.reset_launches()
    depth_samples: list[int] = []
    wave = args.batch
    t0 = time.perf_counter()
    bound = 0
    off = 1
    deleted = 0
    churn = _ChurnFrontier(coord, key_strs)
    while off < args.pods:
        write_wave(store, list(zip(keys[off:off + wave], values[off:off + wave])))
        if args.churn:
            dels = churn.advance(off - 2 * wave)
            if dels:
                write_wave(store, [(keys[i], None) for i in dels])
                deleted += len(dels)
        off += wave
        bound += coord.step()
        if off < args.pods:
            depth_samples.append(len(coord._inflights))
    bound += coord.run_until_idle()
    sched_s = time.perf_counter() - t0
    launches = {
        "fused_topk": fused_topk.fused_topk.launches,
        "delta_plane_topk": delta_topk.delta_plane_topk.launches,
    }
    if args.churn:
        dels = churn.advance(args.pods)
        if dels:
            write_wave(store, [(keys[i], None) for i in dels])
            deleted += len(dels)

    lat = REGISTRY.get("coordinator_schedule_to_bind_seconds")
    cyc = REGISTRY.get("coordinator_cycle_seconds")
    ov = REGISTRY.get("pipeline_stage_overlap_seconds_total")
    hidden = sum(ov.value(stage=s, inflight="yes") for s in OVERLAP_STAGES)
    exposed = sum(ov.value(stage=s, inflight="no") for s in OVERLAP_STAGES)
    e2e = bound / sched_s if sched_s else 0.0
    suffix = f"_pct{args.score_pct}" if args.score_pct != 100 else ""
    report = {
        "metric": f"e2e_binds_per_sec_{args.nodes}_nodes{suffix}",
        "value": round(e2e, 1),
        "unit": "binds/s",
        "detail": {
            "device": str(coord.device),
            "nodes": args.nodes,
            "pods": args.pods,
            "batch": args.batch,
            "chunk": chunk,
            "score_pct": args.score_pct,
            "pipeline": not args.no_pipeline,
            "depth": args.depth,
            "bound": bound,
            "deleted": deleted,
            "node_write_s": round(nodes_s, 3),
            "bootstrap_s": round(bootstrap_s, 3),
            "cold_build_s": round(cold_build_s, 3),
            "schedule_s": round(sched_s, 3),
            **quantile_report_ms(lat, (0.5, 0.99)),
            "stage_means_ms": _stage_means_ms(),
            "device_share": round(cyc.sum(stage="device") / sched_s, 4) if sched_s else None,
            "stage_overlap_ratio": (
                round(hidden / (hidden + exposed), 4) if hidden + exposed else None
            ),
            "depth_seconds": {
                str(k): round(v, 4) for k, v in coord.depth_timer.seconds().items()
            },
            "sustained_inflight_depth": (
                sorted(depth_samples)[len(depth_samples) // 2] if depth_samples else 0
            ),
            "waves": {p: coord.waves[p] for p in ("full", "delta")},
            "launches": launches,
            "delta_enabled": coord.delta_enabled,
            "device_state": {
                **bytes_report(coord.table, coord.table_spec),
                "inplace": coord.donation_inplace,
            },
        },
    }
    return report, coord, store


def main(argv=None) -> dict:
    args = parse_args(argv)
    report, coord, store = run(args)
    coord.close()
    store.close()
    print(json.dumps(report), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return report


if __name__ == "__main__":
    main()
