"""Multi-shard end-to-end benchmark: N coordinator PROCESSES against one
store at scale — the process topology of the reference's 256-replica
fleet (reference README.adoc:697-730: near-linear scaling to 256
replicas at 1M nodes).

The port's counterpart of ``k8s1m_tpu/tools/shard_bench.py``.  Each worker
process runs a full ShardMember (``control/shardset.py``): FNV pod-hash
intake split, node space owned via group masks, CAS binds — the same
machinery the in-process tests pin, here across real process and wire
boundaries.  The parent starts the port's store server
(``python -m k8s1m_tpu_torch.store.server_main``, the native front-end)
unless ``--target`` names one, populates the nodes, spawns the workers
(``python -m k8s1m_tpu_torch.tools.shard_bench --worker I``, the repository
root first on ``PYTHONPATH``), paces the pod load (``--rate``, or as fast
as the store takes it), and aggregates binds/s and latency from the
workers' status heartbeats written through the store (the channel the
shard set's own heartbeats use).

    python -m k8s1m_tpu_torch.tools.shard_bench --nodes 1048576 --pods 65536 \\
        --shards 4 --score-pct 5
    python -m k8s1m_tpu_torch.tools.shard_bench --nodes 1024 --pods 300 \\
        --shards 2 --batch 64 --score-pct 100 --device cpu

Every worker opens the device ``--device`` names (default ``cuda``): on one
card, each worker is its own process with its own GIL and its own CUDA
context, and the contexts time-slice the card.  A worker that cannot open
the device exits non-zero and the parent raises; no worker falls back to
the CPU.  ``--backend auto`` (default) runs the kernels on ``cuda`` and the
scan path on the CPU; ``--chunk`` defaults to 4096 for the kernels and
16384 for the scan path, clamped to the table.  The JAX tool's
``--tpu-worker`` existed because its accelerator served one process at a
time; it is not part of the port and is an unknown flag here.

The report (one JSON line) carries the JAX tool's keys and each worker's
status document with the JAX keys, plus the port's own: the device, the
backend and chunk, the node write's seconds (``populate_s``), the seconds
from spawning the workers to the last one's ready line (``ready_s``: import,
device, bootstrap over the wire, warm-up pod), the host's
cores (``cpu_count`` and ``affinity_cpus``); per worker the device, peak
card memory (``max_memory_allocated``, null on the CPU), peak host RSS
(sampled every 50 ms), its
waves and the mean ms per stage of ``coordinator_cycle_seconds`` in the
window, the kernel launches in the window (the fused kernel's by stage),
and the time and new bytes of one ``engine/cycle.py::mask_rows`` view of
its table.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import select
import subprocess
import sys
import threading
import time

from k8s1m_tpu_torch.control.objects import encode_pod, pod_key
from k8s1m_tpu_torch.snapshot.pod_encoding import PodInfo

STATUS_PREFIX = b"/bench/shard-status/"
START_KEY = b"/bench/start"
END_KEY = b"/bench/end"

REFERENCE_E2E = 14_000.0
# A worker reports ready after its bootstrap (relist of the whole fleet over
# the wire) and its warm-up pod; past this the parent gives up on it.
READY_TIMEOUT_S = 900.0


def parse_args(argv=None):
    from k8s1m_tpu_torch.engine.cycle import BACKENDS

    ap = argparse.ArgumentParser(description="multi-shard e2e bench (port)")
    ap.add_argument("--nodes", type=int, default=262_144)
    ap.add_argument("--pods", type=int, default=100_000)
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--chunk", type=int, default=None,
                    help="scan chunk; default 4096 for the kernels, 16384 for the scan path")
    ap.add_argument("--backend", choices=BACKENDS, default="auto",
                    help="auto = the kernels on cuda, the scan path on the CPU")
    ap.add_argument("--score-pct", type=int, default=5)
    ap.add_argument("--rate", type=int, default=0,
                    help="offered pods/s (0 = max-throughput fill)")
    ap.add_argument("--target", default=None,
                    help="existing store addr (default: spawn one)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; every worker opens it")
    ap.add_argument("--worker", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--json", action="store_true",
                    help="print one machine-readable result line")
    return ap.parse_args(argv)


# ---------------------------------------------------------------------------
# Worker process
# ---------------------------------------------------------------------------


def _rss_mb() -> float | None:
    """This process's resident set now, MB (``/proc/self/statm``), or None
    where the kernel gives no such file."""
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
    except (OSError, IndexError, ValueError):
        return None
    return pages * os.sysconf("SC_PAGE_SIZE") / 2**20


class _PeakRss:
    """Peak resident set of this process, MB, sampled every 50 ms by a
    daemon thread (None where ``_rss_mb`` is).  ``ru_maxrss`` would not do:
    Linux carries the forked copy of the parent's resident set across
    ``exec`` into it, and not every kernel gives ``VmHWM``."""

    def __init__(self):
        self.mb = _rss_mb()
        self._stop = threading.Event()
        if self.mb is not None:
            threading.Thread(target=self._run, name="peak-rss", daemon=True).start()

    def _run(self) -> None:
        while not self._stop.wait(0.05):
            self.mb = max(self.mb, _rss_mb() or 0.0)

    def value(self) -> float | None:
        return None if self.mb is None else round(self.mb, 1)

    def stop(self) -> None:
        self._stop.set()


def _mask_rows_probe(coord, reps: int = 5) -> dict:
    """Mean ms of one ``mask_rows`` view of the coordinator's table under its
    row mask (CUDA events on the card, the host clock on the CPU), and the
    bytes of the view's new tensors: what every masked wave allocates."""
    import dataclasses

    import torch

    from k8s1m_tpu_torch.engine.cycle import mask_rows

    table, mask = coord.table, coord._row_mask_dev
    view = mask_rows(table, mask)
    new_bytes = sum(
        v.numel() * v.element_size() for f in dataclasses.fields(view)
        if isinstance(v := getattr(view, f.name), torch.Tensor)
        and v is not getattr(table, f.name))
    del view
    if coord.device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            mask_rows(table, mask)
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / reps
    else:
        t0 = time.perf_counter()
        for _ in range(reps):
            mask_rows(table, mask)
        ms = (time.perf_counter() - t0) * 1e3 / reps
    return {"mask_rows_ms": round(ms, 4), "mask_rows_bytes": new_bytes}


def run_worker(args) -> None:
    import torch

    from k8s1m_tpu_torch.config import PodSpec, TableSpec
    from k8s1m_tpu_torch.control.coordinator import Coordinator
    from k8s1m_tpu_torch.control.shardset import ShardMember, pod_shard
    from k8s1m_tpu_torch.device import resolve_device
    from k8s1m_tpu_torch.envboot import tune_gc
    from k8s1m_tpu_torch.obs.metrics import REGISTRY, quantile_report_ms
    from k8s1m_tpu_torch.ops import delta_topk, fused_topk
    from k8s1m_tpu_torch.plugins.registry import Profile
    from k8s1m_tpu_torch.store.remote import RemoteStore
    from k8s1m_tpu_torch.tools.sched_bench import _launches, _stage_means_ms

    peak_rss = _PeakRss()
    device = resolve_device(args.device)
    store = RemoteStore(args.target)
    cap = 1 << max(10, (args.nodes - 1).bit_length())
    coord = Coordinator(
        store, TableSpec(max_nodes=cap), PodSpec(batch=args.batch),
        Profile(node_affinity=0, topology_spread=0, interpod_affinity=0),
        chunk=min(args.chunk, cap), with_constraints=False,
        backend=args.backend, score_pct=args.score_pct, device=device,
    )
    member = ShardMember(store, coord, args.worker, args.shards)
    member.start(now=time.monotonic())

    # Warm every path before reporting ready (a first-wave stall would look
    # like a straggler shard).  The warm pod's name must HASH to this shard
    # or the intake filter drops it.
    n = 0
    while pod_shard(f"warm/w{args.worker}-{n}", args.shards) != args.worker:
        n += 1
    warm_name = f"w{args.worker}-{n}"
    store.put(
        pod_key("warm", warm_name),
        encode_pod(PodInfo(warm_name, namespace="warm", cpu_milli=1, mem_kib=1)),
    )
    deadline = time.monotonic() + 180
    while time.monotonic() < deadline:
        member.tick(time.monotonic())
        if f"warm/{warm_name}" in coord._bound:
            break
    tune_gc()
    hist = REGISTRY.get("coordinator_schedule_to_bind_seconds")
    hist.reset()
    cycle = REGISTRY.get("coordinator_cycle_seconds")
    cycle.reset()
    # Own binds only: coord._bound also tracks binds OBSERVED from other
    # shards via the pod watch (cluster-wide churn accounting), so the
    # shard's throughput stat must come from its bind counter.
    sched = REGISTRY.get("coordinator_pods_scheduled_total")
    warm_bound = int(sched.value(outcome="bound"))
    fused_topk.reset_launches()
    delta_topk.reset_launches()
    on_card = device.type == "cuda"

    def post_status(done: bool, **extra) -> None:
        doc = {
            "worker": args.worker,
            "bound": int(sched.value(outcome="bound")) - warm_bound,
            "conflicts": int(sched.value(outcome="conflict")),
            **quantile_report_ms(hist, (0.5, 0.99)),
            "done": done,
            "device": str(device),
            "peak_card_mb": (round(torch.cuda.max_memory_allocated(device) / 2**20, 1)
                             if on_card else None),
            "peak_rss_mb": peak_rss.value(),
            "waves": cycle.count(stage="device"),
            "stage_means_ms": _stage_means_ms(),
            "launches": _launches(),
            **extra,
        }
        store.put(STATUS_PREFIX + str(args.worker).encode(), json.dumps(doc).encode())

    print(json.dumps({"ready": args.worker}), flush=True)
    while store.get(START_KEY) is None:
        time.sleep(0.05)

    last_beat = 0.0
    idle_ticks = 0
    ended = False
    while idle_ticks < 40:
        n = member.tick(time.monotonic())
        if (
            n == 0 and not coord.queue and not coord._inflights
            and not coord._backoff
        ):
            # Only start counting down once the producer declared done —
            # a rate-paced load has idle gaps longer than the countdown.
            if ended or (ended := store.get(END_KEY) is not None):
                idle_ticks += 1
            time.sleep(0.005)
        else:
            idle_ticks = 0
        now = time.monotonic()
        if now - last_beat > 0.25:
            post_status(False)
            last_beat = now
    post_status(True, **_mask_rows_probe(coord))
    peak_rss.stop()
    member.close()
    store.close()


# ---------------------------------------------------------------------------
# Parent: populate, spawn, pace, aggregate
# ---------------------------------------------------------------------------


def _spawn_worker(args, idx: int):
    from k8s1m_tpu_torch.store.server_main import child_env

    root, env = child_env()
    cmd = [
        sys.executable, "-m", "k8s1m_tpu_torch.tools.shard_bench",
        "--worker", str(idx), "--shards", str(args.shards),
        "--target", args.target, "--nodes", str(args.nodes),
        "--pods", str(args.pods), "--batch", str(args.batch),
        "--backend", args.backend, "--score-pct", str(args.score_pct),
        "--chunk", str(args.chunk), "--device", args.device,
    ]
    return subprocess.Popen(cmd, env=env, cwd=root, stdout=subprocess.PIPE, text=True)


def _wait_ready(workers) -> None:
    deadline = time.monotonic() + READY_TIMEOUT_S
    for w in workers:
        ready, _, _ = select.select([w.stdout], [], [], max(0.0, deadline - time.monotonic()))
        line = w.stdout.readline() if ready else ""
        if not line or "ready" not in line:
            raise RuntimeError(f"worker failed to start (exit code {w.poll()}): {line!r}")


def _read_status(store, stats: dict) -> int:
    from k8s1m_tpu_torch.store.native import prefix_end

    res = store.range(STATUS_PREFIX, prefix_end(STATUS_PREFIX))
    total = 0
    for kv in res.kvs:
        doc = json.loads(kv.value)
        stats[doc["worker"]] = doc
        total += doc["bound"]
    return total


def main(argv=None) -> dict | None:
    from k8s1m_tpu_torch.engine.cycle import resolve_backend

    args = parse_args(argv)
    args.backend = resolve_backend(args.backend, args.device)
    if args.chunk is None:
        args.chunk = (1 << 12) if args.backend == "pallas" else (1 << 14)
    if args.worker is not None:
        run_worker(args)
        return None

    from k8s1m_tpu_torch.control.shardset import init_assignment, pod_shard
    from k8s1m_tpu_torch.store.remote import RemoteStore
    from k8s1m_tpu_torch.store.server_main import serve_subprocess
    from k8s1m_tpu_torch.tools.sched_bench import write_nodes

    with contextlib.ExitStack() as stack:
        if not args.target:
            _proc, args.target = stack.enter_context(serve_subprocess())
        store = RemoteStore(args.target)
        stack.callback(store.close)

        t0 = time.perf_counter()
        write_nodes(store, args.nodes)
        init_assignment(store, args.shards)
        populate_s = time.perf_counter() - t0
        print(f"# {args.nodes} nodes in {populate_s:.1f}s", file=sys.stderr)

        t_spawn = time.perf_counter()
        workers = [_spawn_worker(args, i) for i in range(args.shards)]
        try:
            _wait_ready(workers)
            ready_s = time.perf_counter() - t_spawn
            print("# workers ready", file=sys.stderr)

            # Pre-encode pods; split stats for the report.
            values = [
                encode_pod(PodInfo(f"bench-{i}", cpu_milli=10, mem_kib=1024))
                for i in range(args.pods)
            ]
            keys = [pod_key("default", f"bench-{i}") for i in range(args.pods)]
            share = [0] * args.shards
            for i in range(args.pods):
                share[pod_shard(f"default/bench-{i}", args.shards)] += 1

            store.put(START_KEY, b"go")
            t0 = time.perf_counter()
            emitted = 0
            while emitted < args.pods:
                if args.rate:
                    due = min(args.pods, 1 + int(args.rate * (time.perf_counter() - t0)))
                else:
                    due = min(args.pods, emitted + 8192)
                if due > emitted:
                    store.put_batch(list(zip(keys[emitted:due], values[emitted:due])))
                    emitted = due
                else:
                    time.sleep(0.002)
            store.put(END_KEY, b"done")

            # Aggregate from status heartbeats until every pod is bound.
            stats: dict = {}
            while True:
                total = _read_status(store, stats)
                if total >= args.pods:
                    break
                # A worker that drained its share posts done:true and EXITS
                # (rc=0) while slower shards are still binding.  Only a
                # non-zero exit is a death.
                if any(w.poll() not in (None, 0) for w in workers):
                    rcs = [w.poll() for w in workers]
                    raise RuntimeError(f"a shard worker died mid-run: rcs={rcs}")
                if all(w.poll() is not None for w in workers):
                    # Everyone exited cleanly and the refresh above ran after
                    # that: a short total means pods were lost.
                    raise RuntimeError(f"workers exited with {total}/{args.pods} bound")
                time.sleep(0.1)
            window = time.perf_counter() - t0
            # The window closed at the last bind; workers post their final
            # done:true status only after their idle countdown.
            deadline = time.monotonic() + 10.0
            while (not all(s.get("done") for s in stats.values())
                   and time.monotonic() < deadline):
                time.sleep(0.05)
                _read_status(store, stats)
                if all(w.poll() is not None for w in workers):
                    # Every worker exited and the refresh above ran after
                    # that: a crashed worker's done:false surfaces in the
                    # report instead of spinning out the deadline.
                    break
            # A worker exits on its own after its final status; wait for
            # that, so its exit code is its own and not the terminate below.
            for w in workers:
                w.wait(timeout=60)
        finally:
            for w in workers:
                if w.poll() is None:
                    w.terminate()
            for w in workers:
                try:
                    w.wait(timeout=15)
                except subprocess.TimeoutExpired:
                    w.kill()
                    w.wait()
                w.stdout.close()

    binds_s = args.pods / window
    result = {
        "metric": "shard_e2e_binds_per_sec",
        "value": round(binds_s, 1),
        "unit": "binds/s",
        "vs_baseline": round(binds_s / REFERENCE_E2E, 3),
        "shards": args.shards,
        "nodes": args.nodes,
        "pods": args.pods,
        "window_s": round(window, 2),
        "pod_share": share,
        "per_worker": [stats.get(i) for i in range(args.shards)],
        "device": args.device,
        "backend": args.backend,
        "chunk": args.chunk,
        "rate": args.rate,
        "populate_s": round(populate_s, 3),
        "ready_s": round(ready_s, 3),
        "cpu_count": os.cpu_count(),
        "affinity_cpus": len(os.sched_getaffinity(0)),
        "worker_rcs": [w.returncode for w in workers],
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
