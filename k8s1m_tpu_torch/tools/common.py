"""Shared scaffolding of the port's tools.

The port's own copy of ``RateReporter`` from ``k8s1m_tpu/tools/common.py``
(the JAX module's asyncio gRPC worker pool waits for the wire store).
"""

from __future__ import annotations

import time


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
