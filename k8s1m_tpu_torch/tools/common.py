"""Shared scaffolding of the port's tools and load generators.

The port's copy of ``k8s1m_tpu/tools/common.py``.  The reference's
generators shard work across 10-12 clientsets x 100 goroutines and report
rates to stdout (reference kwok/make_pods/main.go:38,85-102,
etcd-lease-flood/main.go:88-101); here each tool is an asyncio worker pool
over one or more ``EtcdClient``s (``store/etcd_client.py``, each its own
HTTP/2 connection) with a periodic rate reporter.
"""

from __future__ import annotations

import asyncio
import dataclasses
import sys
import time

from k8s1m_tpu_torch import faultline
from k8s1m_tpu_torch.faultline import GiveUp, policy_for
from k8s1m_tpu_torch.store.etcd_client import EtcdClient

# Retries of a failing work item under the ``tools.loadgen`` policy.
RETRIES = 2


class RateReporter:
    """Prints ops/sec once per interval, and a progress line every
    ``milestone`` ops even when ``quiet``."""

    def __init__(
        self, label: str, interval_s: float = 1.0, quiet: bool = False,
        milestone: int = 0,
    ):
        self.label = label
        self.interval_s = interval_s
        self.quiet = quiet
        self.milestone = milestone
        self._milestones = 0
        self.count = 0
        self.errors = 0
        self._t0 = time.perf_counter()
        self._last = self._t0
        self._last_count = 0

    def add(self, n: int = 1) -> None:
        self.count += n
        now = time.perf_counter()
        if self.milestone and self.count // self.milestone > self._milestones:
            self._milestones = self.count // self.milestone
            rate = self.count / max(now - self._t0, 1e-9)
            print(
                f"{self.label}: {self.count:,} "
                f"({now - self._t0:,.1f}s, {rate:,.0f}/s overall)",
                flush=True,
            )
            self._last, self._last_count = now, self.count
            return
        if not self.quiet and now - self._last >= self.interval_s:
            rate = (self.count - self._last_count) / (now - self._last)
            print(f"{self.label}: {self.count} total, {rate:,.0f}/s", flush=True)
            self._last, self._last_count = now, self.count

    def summary(self) -> dict:
        dt = time.perf_counter() - self._t0
        return {
            "label": self.label,
            "count": self.count,
            "errors": self.errors,
            "seconds": round(dt, 3),
            "rate": round(self.count / dt, 1) if dt > 0 else 0.0,
        }


async def run_sharded(
    total: int,
    concurrency: int,
    make_client,
    work,
    *,
    clients: int = 1,
    reporter: RateReporter | None = None,
):
    """Run ``work(client, index)`` for index in [0, total) across
    ``concurrency`` workers on one event loop; ``clients`` separate
    connections spread HTTP/2 stream contention the way the reference uses
    several clientsets.

    A failing item is retried under the shared ``tools.loadgen``
    RetryPolicy (``faultline/policy.py``: jittered backoff, ``RETRIES``
    retries), then counted in ``reporter.errors`` and skipped: one
    transient wire error must not abort an hours-long load run.  More
    errors than 1% of total (at least 100) abort a run whose target is
    down.  A work item that returns an int covers that
    many logical ops (one batched RPC of N puts)."""
    max_errors = max(100, total // 100)
    policy = dataclasses.replace(policy_for("tools.loadgen"), max_attempts=RETRIES + 1)
    pool = [make_client() for _ in range(max(1, clients))]
    queue: asyncio.Queue = asyncio.Queue()
    for i in range(total):
        queue.put_nowait(i)
    errors = 0

    async def worker(wid: int):
        nonlocal errors
        client = pool[wid % len(pool)]
        while True:
            try:
                i = queue.get_nowait()
            except asyncio.QueueEmpty:
                return
            try:
                done = await policy.acall(lambda: work(client, i), op="work",
                                          retryable=lambda e: True)
                if reporter:
                    reporter.add(done if isinstance(done, int) else 1)
            except GiveUp as e:
                errors += 1
                if reporter:
                    reporter.errors += 1
                print(f"work item {i} failed after {e.attempts} attempts: {e.cause!r}",
                      file=sys.stderr)
                if errors > max_errors:
                    raise
            if errors > max_errors:
                return

    try:
        await asyncio.gather(*(worker(w) for w in range(concurrency)))
    finally:
        for c in pool:
            await c.close()


def add_common_args(ap):
    ap.add_argument("--target", default="127.0.0.1:2379", help="etcd server addr")
    ap.add_argument("--concurrency", type=int, default=100)
    ap.add_argument("--clients", type=int, default=4, help="separate HTTP/2 connections")
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--ca-pem", default=None,
                    help="TLS: trust this CA for --target (rig chain)")
    ap.add_argument("--token", default=None,
                    help="bearer token sent as authorization metadata")
    ap.add_argument("--fault-plan", default=None,
                    help="faultline plan: inline JSON or @path (deterministic fault "
                    "injection for the run)")


def apply_fault_plan(args) -> None:
    """Install the --fault-plan (if any) as the process's injector."""
    fp = getattr(args, "fault_plan", None)
    if fp:
        faultline.install_plan(faultline.FaultPlan.from_arg(fp))


def client_factory(args):
    """A maker of ``EtcdClient``s for ``run_sharded``: each owns its channel,
    so each ``--clients`` member is its own connection."""
    return lambda: EtcdClient(args.target, ca_pem=getattr(args, "ca_pem", None),
                              token=getattr(args, "token", None))
