"""Latency/throughput curve: p50/p95/p99 schedule-to-bind vs offered load.

The port's own copy of ``k8s1m_tpu/tools/latency_curve.py``: each point is
one subprocess of ``python -m k8s1m_tpu_torch.tools.sched_bench --rate R``
on ``--device`` (the card unless ``cpu``), with ``--backend auto`` by
default (the kernels on ``cuda``, the scan path on the CPU) where the JAX
tool defaults to its XLA path.

The reference's primary metric is two-headed — binds/s AND p50
schedule-to-bind (SURVEY.md:27; the fleet's ~560µs/pod at 14K/s,
reference README.adoc:783-787).  One operating point says nothing about
the shape: latency at low load shows the floor (batch formation +
device round trip), latency near saturation shows the knee.  This
tool sweeps ``sched_bench --rate`` over a list of offered loads, one
fresh subprocess per point (clean store, clean metrics), and writes the
curve as JSONL plus a markdown table.

    python -m k8s1m_tpu_torch.tools.latency_curve --nodes 1048576 \
        --rates 2000,4000,8000 --seconds 4 --min-pods 8192 \
        --out chiprun_out/latency_curve.jsonl
    python -m k8s1m_tpu_torch.tools.latency_curve --device cpu --nodes 1024 \
        --rates 500,1000 --seconds 1 --min-pods 512 --out curve.jsonl
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import time


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="p50-vs-rate curve")
    ap.add_argument("--nodes", type=int, default=1_048_576)
    ap.add_argument("--score-pct", type=int, default=5)
    ap.add_argument("--batch", type=int, default=4096,
                    help="sched_bench --batch of every point (its largest adaptive "
                    "bucket; each bucket is warmed before the window)")
    ap.add_argument("--backend", choices=("auto", "xla", "pallas"), default="auto",
                    help="'auto' = the kernels on cuda, the scan path on the CPU")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument(
        "--rates", default="2000,4000,6000,8000,10000,12000,16000,20000",
        help="comma-separated offered loads (pods/s)",
    )
    ap.add_argument(
        "--seconds", type=float, default=12.0,
        help="target measured window per point (pods = rate * seconds)",
    )
    ap.add_argument("--min-pods", type=int, default=20_000)
    ap.add_argument("--out", default="latency_curve.jsonl")
    ap.add_argument("--reports", default=None, metavar="PATH",
                    help="also append every point's whole sched_bench report (one JSON "
                    "line each: stage means, waves, kernel launches) to PATH")
    ap.add_argument("--timeout", type=float, default=1800.0,
                    help="per-point subprocess timeout (s)")
    return ap.parse_args(argv)


def _deadline_wrapper() -> str | None:
    """Locate tools/with_deadline.py: K8S1M_WITH_DEADLINE wins (how an
    installed/wheel deployment points at it), else the repo-checkout
    layout (this file's ``parents[2]/tools/``).  None = not found; the
    caller warns and runs the point unwrapped rather than failing the
    sweep — an unwrapped point merely loses the in-process deadline."""
    env = os.environ.get("K8S1M_WITH_DEADLINE")
    if env:
        if pathlib.Path(env).is_file():
            return env
        print(f"# K8S1M_WITH_DEADLINE={env!r} does not exist",
              file=sys.stderr)
        return None
    p = pathlib.Path(__file__).resolve().parents[2] / "tools" / "with_deadline.py"
    return str(p) if p.is_file() else None


def run_point(args, rate: int) -> dict | None:
    pods = max(args.min_pods, int(rate * args.seconds))
    # The point self-deadlines IN-PROCESS (tools/with_deadline.py), so it
    # exits on its own instead of being killed mid-launch.  The outer
    # timeout stays as a last resort, with slack so it should never fire
    # first.
    wrapper = _deadline_wrapper()
    if wrapper is None:
        print("# with_deadline.py not found (set K8S1M_WITH_DEADLINE); "
              "running unwrapped — only the outer timeout guards this "
              "point", file=sys.stderr)
        head = [sys.executable]
    else:
        head = [sys.executable, wrapper, str(args.timeout)]
    cmd = head + [
        "-m", "k8s1m_tpu_torch.tools.sched_bench",
        "--nodes", str(args.nodes), "--pods", str(pods),
        "--rate", str(rate), "--score-pct", str(args.score_pct),
        "--backend", args.backend, "--device", args.device,
        "--batch", str(args.batch),
    ]
    # The package's parent directory on the child's path, whatever the
    # caller's working directory.
    root = str(pathlib.Path(__file__).resolve().parents[2])
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, env.get("PYTHONPATH")) if p
    )
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            cmd, stdout=subprocess.PIPE, text=True, timeout=args.timeout + 300,
            env=env,
        )
    except subprocess.TimeoutExpired:
        # Should never fire (the in-process deadline + watchdog act
        # first); if it does, record the point as failed but keep the
        # sweep going — the remaining rates still produce a curve.
        print(f"# rate={rate}: outer timeout", file=sys.stderr)
        return None
    if proc.returncode != 0:
        print(f"# rate={rate}: rc={proc.returncode}", file=sys.stderr)
        return None
    doc = json.loads(proc.stdout.strip().splitlines()[-1])
    if args.reports:
        with open(args.reports, "a") as f:
            f.write(json.dumps(doc) + "\n")
    det = doc["detail"]
    return {
        "rate": rate,
        "pods": pods,
        "binds_per_sec": det["binds_per_sec"],
        "p50_ms": det["p50_ms"],
        "p95_ms": det["p95_ms"],
        "p99_ms": det["p99_ms"],
        "bound": det["bound"],
        "point_wall_s": round(time.perf_counter() - t0, 1),
    }


def main(argv=None):
    args = parse_args(argv)
    rates = [int(r) for r in args.rates.split(",") if r]
    rows = []
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        for rate in rates:
            row = run_point(args, rate)
            if row is None:
                continue
            rows.append(row)
            f.write(json.dumps(row) + "\n")
            f.flush()
            print(f"# rate={rate}: p50={row['p50_ms']}ms "
                  f"p99={row['p99_ms']}ms ach={row['binds_per_sec']}/s",
                  file=sys.stderr)
    # Markdown table of the curve.
    print("| offered pods/s | achieved binds/s | p50 ms | p95 ms | p99 ms |")
    print("|---|---|---|---|---|")
    for r in rows:
        print(f"| {r['rate']} | {r['binds_per_sec']} | {r['p50_ms']} "
              f"| {r['p95_ms']} | {r['p99_ms']} |")
    return rows


if __name__ == "__main__":
    main()
