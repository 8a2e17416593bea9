"""Prometheus-style metrics, self-contained (no client library).

The port's own copy of ``k8s1m_tpu/obs/metrics.py``: counters, gauges,
histograms with labels, ``CallbackMetric`` (a sample set computed at read
time) and ``AlertingHistogram`` (logs any observation over its alert
threshold, the reference's ``AlertingHistogramTimer``) in a registry of
their own (``REGISTRY``, rendered in the Prometheus text exposition
format by ``Registry.render`` and served by
``obs/http.start_metrics_server``), the ``LevelTimer`` of the pipeline
depth and ``quantile_report_ms``.  The
metric names are the JAX package's; a process that imports both packages
holds two registries, so no name is registered twice in one.
"""

from __future__ import annotations

import bisect
import logging
import threading
import time
from contextlib import contextmanager

log = logging.getLogger("k8s1m.metrics")

# Exponential latency buckets: 10us .. ~160s.
DEFAULT_BUCKETS = tuple(1e-5 * (2**i) for i in range(24))


def _label_str(labels: dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


class Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str, labelnames: tuple[str, ...] = (),
                 registry: "Registry | None" = None):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        (registry if registry is not None else REGISTRY).register(self)

    def _key(self, labels: dict[str, str]) -> tuple:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: got labels {sorted(labels)}, want {self.labelnames}"
            )
        return tuple(str(labels[k]) for k in self.labelnames)

    def render(self) -> list[str]:
        raise NotImplementedError

class Counter(Metric):
    kind = "counter"

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._values: dict[tuple, float] = {}

    def inc(self, n: float = 1.0, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + n

    def value(self, **labels) -> float:
        return self._values.get(self._key(labels), 0.0)

    def render(self) -> list[str]:
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} counter"]
        with self._lock:
            for key, v in sorted(self._values.items()):
                lbl = _label_str(dict(zip(self.labelnames, key)))
                out.append(f"{self.name}{lbl} {v}")
        return out


class Gauge(Metric):
    kind = "gauge"

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._values: dict[tuple, float] = {}
        self._callbacks: dict[tuple, object] = {}

    def set(self, v: float, **labels) -> None:
        with self._lock:
            self._values[self._key(labels)] = float(v)

    def set_function(self, fn, **labels) -> None:
        """Gauge computed at scrape time (e.g. store.num_keys)."""
        with self._lock:
            self._callbacks[self._key(labels)] = fn

    def inc(self, n: float = 1.0, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + n

    def dec(self, n: float = 1.0, **labels) -> None:
        self.inc(-n, **labels)

    def value(self, **labels) -> float:
        key = self._key(labels)
        if key in self._callbacks:
            return float(self._callbacks[key]())
        return self._values.get(key, 0.0)

    def render(self) -> list[str]:
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} gauge"]
        with self._lock:
            items = dict(self._values)
            for key, fn in self._callbacks.items():
                try:
                    items[key] = float(fn())
                except Exception:  # graftlint: disable=broad-except (scrape must not die with the callback)
                    continue
        for key, v in sorted(items.items()):
            lbl = _label_str(dict(zip(self.labelnames, key)))
            out.append(f"{self.name}{lbl} {v}")
        return out


class CallbackMetric(Metric):
    """Metric whose whole sample set is computed at read time.

    ``fn`` returns ``[(labels_dict, value), ...]``; label sets may vary
    from one read to the next.  A failing callback yields no samples: a
    read must never die with its source."""

    def __init__(self, name: str, help: str, fn, kind: str = "gauge",
                 registry: "Registry | None" = None):
        super().__init__(name, help, (), registry)
        self._fn = fn
        self.kind = kind

    def render(self) -> list[str]:
        out = [f"# HELP {self.name} {self.help}",
               f"# TYPE {self.name} {self.kind}"]
        try:
            samples = self._fn()
        # A failing callback yields no samples (class contract above).
        except Exception:  # graftlint: disable=broad-except
            return out
        for labels, v in samples:
            out.append(f"{self.name}{_label_str(dict(labels))} {v}")
        return out


class Histogram(Metric):
    kind = "histogram"

    def __init__(self, name: str, help: str, labelnames: tuple[str, ...] = (),
                 buckets: tuple[float, ...] = DEFAULT_BUCKETS,
                 registry: "Registry | None" = None):
        super().__init__(name, help, labelnames, registry)
        self.buckets = tuple(sorted(buckets))
        self._counts: dict[tuple, list[int]] = {}
        self._sums: dict[tuple, float] = {}
        self._totals: dict[tuple, int] = {}

    def observe(self, v: float, **labels) -> None:
        key = self._key(labels)
        i = bisect.bisect_left(self.buckets, v)
        with self._lock:
            if key not in self._counts:
                self._counts[key] = [0] * (len(self.buckets) + 1)
                self._sums[key] = 0.0
                self._totals[key] = 0
            self._counts[key][i] += 1
            self._sums[key] += v
            self._totals[key] += 1

    def reset(self) -> None:
        """Drop all recorded samples (benchmark windows only)."""
        with self._lock:
            self._counts.clear()
            self._sums.clear()
            self._totals.clear()

    def observe_many(self, values, **labels) -> None:
        """Batch observe: one bucket pass and one lock acquisition for a
        whole wave (the per-pod path is measurable at 10K+ binds/s)."""
        if len(values) == 0:
            return
        import numpy as _np

        v = _np.asarray(values, float)
        idx = _np.searchsorted(self.buckets, v, side="left")
        counts = _np.bincount(idx, minlength=len(self.buckets) + 1)
        key = self._key(labels)
        with self._lock:
            if key not in self._counts:
                self._counts[key] = [0] * (len(self.buckets) + 1)
                self._sums[key] = 0.0
                self._totals[key] = 0
            c = self._counts[key]
            for i, n in enumerate(counts):
                if n:
                    c[i] += int(n)
            self._sums[key] += float(v.sum())
            self._totals[key] += int(v.size)

    @contextmanager
    def time(self, **labels):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.observe(time.perf_counter() - t0, **labels)

    def sum(self, **labels) -> float:
        """Total of observed values for one label set (bench reporting)."""
        with self._lock:
            return self._sums.get(self._key(labels), 0.0)

    def count(self, **labels) -> int:
        """Number of observations for one label set."""
        with self._lock:
            return self._totals.get(self._key(labels), 0)

    def label_keys(self) -> list[tuple]:
        with self._lock:
            return list(self._counts)

    def quantile(self, q: float, **labels) -> float:
        """Approximate quantile, linearly interpolated within the bucket
        (Prometheus histogram_quantile semantics) — edge-snapping made a
        whole latency curve report one flat number per bucket."""
        key = self._key(labels)
        with self._lock:
            counts = list(self._counts.get(key, []))
            total = self._totals.get(key, 0)
        if not total:
            return 0.0
        target = q * total
        seen = 0
        for i, c in enumerate(counts):
            if seen + c >= target:
                if i >= len(self.buckets):
                    return float("inf")
                hi = self.buckets[i]
                lo = self.buckets[i - 1] if i > 0 else 0.0
                # q=0 (or an empty leading bucket) must report the
                # bucket's LOWER edge, not snap to its upper bound.
                frac = (target - seen) / c if c else 0.0
                return lo + (hi - lo) * frac
            seen += c
        return float("inf")

    def render(self) -> list[str]:
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} histogram"]
        with self._lock:
            for key in sorted(self._counts):
                base = dict(zip(self.labelnames, key))
                cum = 0
                for i, ub in enumerate(self.buckets):
                    cum += self._counts[key][i]
                    lbl = _label_str({**base, "le": repr(ub)})
                    out.append(f"{self.name}_bucket{lbl} {cum}")
                lbl = _label_str({**base, "le": "+Inf"})
                out.append(f"{self.name}_bucket{lbl} {self._totals[key]}")
                out.append(f"{self.name}_sum{_label_str(base)} {self._sums[key]}")
                out.append(f"{self.name}_count{_label_str(base)} {self._totals[key]}")
        return out

class AlertingHistogram(Histogram):
    """Histogram that logs any observation above ``alert_s`` immediately
    (reference AlertingHistogramTimer, mem_etcd/src/store.rs:883-907)."""

    def __init__(self, *args, alert_s: float = 0.1, **kwargs):
        super().__init__(*args, **kwargs)
        self.alert_s = alert_s

    def observe(self, v: float, **labels) -> None:
        super().observe(v, **labels)
        if v > self.alert_s:
            log.warning("%s%s took %.1fms", self.name, labels or "", v * 1e3)


class LevelTimer:
    """Time-weighted occupancy of small integer levels.

    Built for the scheduling pipeline's in-flight depth: the coordinator
    calls ``set_level(len(inflights))`` whenever the pipeline grows or
    shrinks, and ``seconds()`` reports how long each depth was held —
    the evidence behind "sustained in-flight depth" in the churn bench
    (a plain gauge only shows the instant of the scrape).  Not a Metric:
    it has no labels; consumers (sched_bench) read
    it directly.
    """

    def __init__(self, clock=time.perf_counter):
        self._clock = clock
        self._level = 0
        # Start accumulating at level 0 immediately — deferring to the
        # first set_level would silently drop the initial interval.
        self._since: float = self._clock()
        self._seconds: dict[int, float] = {}

    def set_level(self, level: int) -> None:
        now = self._clock()
        self._seconds[self._level] = (
            self._seconds.get(self._level, 0.0) + now - self._since
        )
        self._level = int(level)
        self._since = now

    def seconds(self) -> dict[int, float]:
        """Seconds spent at each level so far (open interval included)."""
        out = dict(self._seconds)
        out[self._level] = (
            out.get(self._level, 0.0) + self._clock() - self._since
        )
        return out

    def reset(self) -> None:
        """Drop history; the current level keeps accumulating from now
        (benchmark windows only)."""
        self._seconds.clear()
        self._since = self._clock()


def quantile_report_ms(
    hist: Histogram,
    quantiles: tuple[float, ...] = (0.5, 0.95, 0.99),
    **labels,
) -> dict:
    """``{"p50_ms": ..., "p95_ms": ...}`` for one histogram label set —
    the schedule-to-bind report shape every bench shares (sched_bench's
    paced and fill reports, shard_bench's status doc).  One helper so
    the rounding/naming never drifts between the call sites."""
    out = {}
    for q in quantiles:
        pct = f"{q * 100:g}".replace(".", "_")
        out[f"p{pct}_ms"] = round(hist.quantile(q, **labels) * 1e3, 2)
    return out


class Registry:
    def __init__(self):
        self._metrics: dict[str, Metric] = {}
        self._lock = threading.Lock()

    def register(self, m: Metric) -> None:
        with self._lock:
            if m.name in self._metrics:
                raise ValueError(f"duplicate metric {m.name}")
            self._metrics[m.name] = m

    def get(self, name: str) -> Metric | None:
        return self._metrics.get(name)

    def metrics(self) -> list[Metric]:
        """Every registered metric, in registration order."""
        with self._lock:
            return list(self._metrics.values())

    def render(self) -> str:
        """Every metric in the Prometheus text exposition format."""
        lines: list[str] = []
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            lines.extend(m.render())
        return "\n".join(lines) + "\n"


REGISTRY = Registry()
