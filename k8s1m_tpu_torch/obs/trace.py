"""Flight recorder: always-on ring of recent spans, dumped on slow ops.

The port's own copy of ``k8s1m_tpu/obs/trace.py`` (its counter lives in
the port's registry; dumps default to the process's temporary directory,
``tempfile.gettempdir()``).

The reference keeps golang.org/x/exp/trace.NewFlightRecorder running and
dumps flight-<pod>-<ts>.perf whenever a pod takes >10ms to schedule
(reference cmd/dist-scheduler/scheduler.go:333,448,556-565).  This is the
same idea without the Go runtime: every span lands in a bounded ring; a
span over ``threshold_s`` dumps the ring as JSON so the events *leading
up to* the slow op are preserved.
"""

from __future__ import annotations

import collections
import json
import logging
import os
import tempfile
import threading
import time

from k8s1m_tpu_torch.obs.metrics import Counter

log = logging.getLogger("k8s1m.trace")

_DUMPS = Counter(
    "flight_dumps_total",
    "Flight-recorder dump attempts by outcome (suppressed = the "
    "max_dumps budget is spent — later slow ops leave no artifact; "
    "error = the dump write itself failed)",
    ("outcome",),
)


class FlightRecorder:
    def __init__(
        self,
        threshold_s: float = 0.010,
        capacity: int = 4096,
        dump_dir: str | None = None,
        max_dumps: int = 16,
    ):
        self.threshold_s = threshold_s
        self.dump_dir = dump_dir if dump_dir is not None else tempfile.gettempdir()
        self.max_dumps = max_dumps
        self._ring: collections.deque = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._dumps = 0
        self._suppression_logged = False

    def record(self, name: str, duration_s: float, **fields) -> None:
        # graftlint: disable=no-wall-clock (span wall stamp for cross-process correlation; dur_s is caller-measured monotonic)
        span = {"name": name, "t": time.time(), "dur_s": duration_s, **fields}
        with self._lock:
            self._ring.append(span)
        if duration_s > self.threshold_s:
            self.dump(reason=f"{name} took {duration_s * 1e3:.1f}ms")

    def span(self, name: str, **fields):
        return _Span(self, name, fields)

    def dump(self, reason: str = "", extra: dict | None = None) -> str | None:
        """Write the ring (+ optional ``extra`` payload — the slow pod's
        podtrace span chain) to a dump file.  Exhaustion of the
        ``max_dumps`` budget is not silent: it is counted in
        ``flight_dumps_total{outcome="suppressed"}`` and logged once."""
        suppressed = first = False
        with self._lock:
            if self._dumps >= self.max_dumps:
                suppressed = True
                first = not self._suppression_logged
                self._suppression_logged = True
            else:
                self._dumps += 1
                ring = list(self._ring)
                n = self._dumps
        if suppressed:
            if first:
                log.warning(
                    "flight recorder: max_dumps=%d budget spent; further "
                    "dumps suppressed (flight_dumps_total{outcome="
                    '"suppressed"} keeps counting)', self.max_dumps,
                )
            _DUMPS.inc(outcome="suppressed")
            return None
        path = os.path.join(
            # graftlint: disable=no-wall-clock (epoch-ms dump name, correlates across restarts)
            self.dump_dir, f"flight-{int(time.time() * 1e3)}-{n}.json"
        )
        doc = {"reason": reason, "spans": ring}
        if extra:
            doc.update(extra)
        try:
            with open(path, "w") as f:
                json.dump(doc, f)
        except OSError:
            _DUMPS.inc(outcome="error")
            return None
        _DUMPS.inc(outcome="written")
        log.warning("flight recorder dump: %s (%s)", path, reason)
        return path


class _Span:
    def __init__(self, rec: FlightRecorder, name: str, fields: dict):
        self.rec, self.name, self.fields = rec, name, fields

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.rec.record(self.name, time.perf_counter() - self._t0, **self.fields)
