"""podtrace: end-to-end per-pod lifecycle tracing with stage attribution.

The port's own copy of ``k8s1m_tpu/obs/podtrace.py`` (its histogram and
counter live in the port's registry).  On the card the ``device`` span
closes when the wave's bound rows have reached the host: the retire takes
its ``t_sync`` after waiting on the pinned copy's event, so the card's
time is attributed to ``device``, never to ``bind``.

The north-star latency metric (`coordinator_schedule_to_bind_seconds`)
is one opaque histogram: nothing says how much of a pod's journey went
to admission, queue wait, gang staging, encode, pipeline depth, device
dispatch, or bind-CAS retries.  The reference answers "where did the
microseconds go" per pod — dist-scheduler dumps a flight trace for
every pod that takes >10ms to schedule (reference
cmd/dist-scheduler/scheduler.go:333,448,556-565).  This module is the
per-pod half of that answer:

- **PodTracer** — a lock-sharded, bounded, head-sampled (1-in-N pods,
  deterministic by pod-key hash: no RNG, no wall clock — durations are
  ``perf_counter`` intervals) trace bus.  A sampled pod's lifecycle is
  a CONTIGUOUS span chain: every ``emit`` opens its span at the
  previous span's end, so the chain telescopes to the pod's whole
  schedule-to-bind window and stage attribution sums to the end-to-end
  latency by construction (the ≥95% coverage gate in
  tests/test_torch_podtrace.py guards dropped spans and missed anchors, the
  two ways attribution can silently go partial).
- **Stage histograms** — every span lands in
  ``pod_stage_seconds{stage}``, so the schedule-to-bind p50/p99
  decomposes into per-stage components on the dashboard's "Latency
  attribution" row.
- **Perfetto export** — ``export(path)`` writes Chrome trace-event
  JSON (load in ui.perfetto.dev / chrome://tracing): stages as tracks,
  pods as flow events arrowing each pod's journey across waves.
  ``validate_trace`` is the structural gate (monotone per-track
  timestamps, every flow event resolves) run in tier-1.
- **Attribution report** — ``attribution()`` returns the latency
  waterfall (per-stage p50/p99 + share of total + coverage), the
  ``latency_attribution`` detail of sched_bench.

Tracing off must be FREE: ``NULL_TRACER`` (the null-tracer pattern) is
what a coordinator holds by default — a single ``.enabled`` attribute
read per site, and every span or attribute is built behind that guard
(the rule the JAX package's graftlint pass ``trace-lazy-emit`` enforces
there).

Attribution contract for NEW lifecycle stages (MIGRATION.md
"Per-pod tracing"): a stage is a contiguous interval — ``emit`` anchors
its start at the previous span's end, so never pre-compute a span start
yourself; emit behind the ``enabled`` guard; and add the stage name to
``STAGES`` so the exporter gives it a stable track and the dashboard a
bounded label set.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import threading
import time
import zlib

import numpy as np

from k8s1m_tpu_torch.obs.metrics import Counter, Histogram

# Track order in the Perfetto export; also the bounded label set of
# pod_stage_seconds.  Keep in sync with the coordinator's emit sites
# (the attribution contract above).
STAGES = (
    "admit",          # webhook/submit_external admission decision + staging
    "gang_stage",     # all-or-none gang assembly wait (tenancy/gang.py)
    "queue_wait",     # pending-queue (+ retry backoff) residence
    "encode",         # host encode (hotfeed claim or inline; cache attrs)
    "dispatch_wait",  # encode end -> device dispatch (pipeline slot wait)
    "device",         # dispatch -> result sync (wave epoch/depth/path attrs)
    "bind",           # bind CAS + wave settlement (outcome attr)
    "requeue",        # terminal non-bind settlement (unschedulable, deleted)
)

_STAGE_SECONDS = Histogram(
    "pod_stage_seconds",
    "Per-pod lifecycle stage seconds for traced pods (obs/podtrace.py; "
    "the schedule-to-bind histogram decomposed by stage)",
    ("stage",),
)
_PODS = Counter(
    "podtrace_pods_total",
    "Traced pods by outcome: sampled = trace opened, finished = span "
    "chain closed at a terminal stage, dropped = head-sample hit the "
    "live-trace bound (raise max_live or sample wider)",
    ("outcome",),
)


@dataclasses.dataclass
class PodTrace:
    """One pod's contiguous span chain: ``spans`` is a list of
    ``(stage, t0, t1, attrs)`` with ``spans[i+1].t0 == spans[i].t1``."""

    key: str
    t0: float
    attrs: dict
    last_t: float = 0.0
    spans: list = dataclasses.field(default_factory=list)

    def doc(self) -> dict:
        """JSON-ready form (flight-recorder dumps, debugging)."""
        return {
            "pod": self.key,
            "total_s": round(self.last_t - self.t0, 6),
            **self.attrs,
            "spans": [
                {"stage": s, "dur_s": round(t1 - t0, 6), **a}
                for s, t0, t1, a in self.spans
            ],
        }


class PodTracer:
    """Lock-sharded, bounded, head-sampled per-pod trace bus.

    ``sample_n`` traces 1-in-N pods, chosen deterministically by pod-key
    hash (two runs over the same population trace the same pods — the
    faultline determinism contract extended to observability).
    ``max_live`` bounds in-flight trace memory; ``ring`` bounds the
    completed-trace history the exporter/attribution read.
    """

    enabled = True

    def __init__(
        self,
        sample_n: int = 16,
        *,
        max_live: int = 4096,
        ring: int = 8192,
        shards: int = 8,
    ):
        if sample_n < 1:
            raise ValueError(f"sample_n must be >= 1, got {sample_n}")
        self.sample_n = sample_n
        self.max_live = max_live
        # Power-of-two shard count so the shard pick is a mask.
        n = 1
        while n < shards:
            n <<= 1
        self._mask = n - 1
        self._shards: list[dict[str, PodTrace]] = [{} for _ in range(n)]
        self._locks = [threading.Lock() for _ in range(n)]
        self._done: collections.deque[PodTrace] = collections.deque(
            maxlen=ring
        )
        self._done_lock = threading.Lock()

    # ---- sampling ------------------------------------------------------

    def sampled(self, key: str) -> bool:
        """Deterministic head-sample decision for a pod key."""
        if self.sample_n <= 1:
            return True
        return zlib.crc32(key.encode()) % self.sample_n == 0

    def _shard(self, key: str) -> int:
        return zlib.crc32(key.encode()[::-1]) & self._mask

    # ---- the span chain ------------------------------------------------

    def begin(self, key: str, t: float, **attrs) -> bool:
        """Open a trace anchored at ``t`` (the intake timestamp).  A
        no-op for unsampled keys and for keys already live (webhook
        intake begins before the watch echo re-begins); False either
        way, True when a fresh trace opened."""
        if not self.sampled(key):
            return False
        i = self._shard(key)
        with self._locks[i]:
            shard = self._shards[i]
            if key in shard:
                return False
            if sum(len(s) for s in self._shards) >= self.max_live:
                _PODS.inc(outcome="dropped")
                return False
            shard[key] = PodTrace(key, t, attrs, last_t=t)
        _PODS.inc(outcome="sampled")
        return True

    def emit(self, key: str, stage: str, t: float | None = None,
             **attrs) -> bool:
        """Close the span ``[last_t, t]`` under ``stage``.  ``t=None``
        reads ``perf_counter`` now.  No-op (False) for keys without a
        live trace — unsampled pods early-out on one hash, before any
        lock, so tracing-on overhead scales with the SAMPLED count,
        not the batch size."""
        if not self.sampled(key):
            return False
        if t is None:
            t = time.perf_counter()
        i = self._shard(key)
        with self._locks[i]:
            tr = self._shards[i].get(key)
            if tr is None:
                return False
            t = max(t, tr.last_t)     # monotone chain, clock never rewinds
            tr.spans.append((stage, tr.last_t, t, attrs))
            dur = t - tr.last_t
            tr.last_t = t
        _STAGE_SECONDS.observe(dur, stage=stage)
        return True

    def finish(self, key: str, stage: str, t: float | None = None,
               **attrs) -> PodTrace | None:
        """Terminal ``emit``: close the chain and move the trace to the
        completed ring.  Returns the completed trace (the flight
        recorder attaches its span chain to slow-pod dumps)."""
        if not self.emit(key, stage, t, **attrs):
            return None
        i = self._shard(key)
        with self._locks[i]:
            tr = self._shards[i].pop(key, None)
        if tr is None:
            return None
        with self._done_lock:
            self._done.append(tr)
        _PODS.inc(outcome="finished")
        return tr

    # ---- reads ---------------------------------------------------------

    def spans_of(self, key: str) -> list[dict]:
        """The live span chain for a pod (flight-recorder dumps); []
        when the pod is not being traced."""
        i = self._shard(key)
        with self._locks[i]:
            tr = self._shards[i].get(key)
            if tr is None:
                return []
            spans = list(tr.spans)
        return [
            {"stage": s, "dur_s": round(t1 - t0, 6), **a}
            for s, t0, t1, a in spans
        ]

    def live_count(self) -> int:
        return sum(len(s) for s in self._shards)

    def completed(self) -> list[PodTrace]:
        with self._done_lock:
            return list(self._done)

    # ---- consumers -----------------------------------------------------

    def attribution(self) -> dict:
        """The latency waterfall over completed traces: per-stage
        p50/p99 + share of total, end-to-end p50/p99, and coverage
        (sum of stage spans vs end-to-end — the ≥0.95 acceptance gate;
        1.0 by construction unless spans were dropped or anchors
        missed)."""
        traces = self.completed()
        if not traces:
            return {"pods": 0, "stages": {}, "end_to_end": None,
                    "coverage": None}
        by_stage: dict[str, list[float]] = {}
        totals: list[float] = []
        covered: list[float] = []
        for tr in traces:
            total = tr.last_t - tr.t0
            totals.append(total)
            covered.append(sum(t1 - t0 for _, t0, t1, _ in tr.spans))
            for s, t0, t1, _ in tr.spans:
                by_stage.setdefault(s, []).append(t1 - t0)
        grand = sum(totals) or 1.0
        stages = {}
        order = {s: i for i, s in enumerate(STAGES)}
        for s in sorted(by_stage, key=lambda s: order.get(s, len(order))):
            d = np.asarray(by_stage[s])
            stages[s] = {
                "p50_ms": round(float(np.percentile(d, 50)) * 1e3, 3),
                "p99_ms": round(float(np.percentile(d, 99)) * 1e3, 3),
                "seconds": round(float(d.sum()), 4),
                "share": round(float(d.sum()) / grand, 4),
                "spans": int(d.size),
            }
        e2e = np.asarray(totals)
        return {
            "pods": len(traces),
            "sample_n": self.sample_n,
            "stages": stages,
            "end_to_end": {
                "p50_ms": round(float(np.percentile(e2e, 50)) * 1e3, 3),
                "p99_ms": round(float(np.percentile(e2e, 99)) * 1e3, 3),
            },
            "coverage": round(sum(covered) / grand, 4),
        }

    def to_trace_events(self) -> dict:
        """Chrome trace-event JSON (the Perfetto/chrome://tracing
        format): each stage is a track (tid), each span a complete "X"
        event, and each pod's journey a flow (s/t/f arrows binding its
        spans across tracks and waves)."""
        traces = self.completed()
        tids = {s: i + 1 for i, s in enumerate(STAGES)}
        events: list[dict] = [{
            "ph": "M", "pid": 1, "tid": 0, "ts": 0,
            "name": "process_name", "args": {"name": "k8s1m coordinator"},
        }]
        epoch = min((tr.t0 for tr in traces), default=0.0)

        def us(t: float) -> int:
            return int(round((t - epoch) * 1e6))

        flow_id = 0
        for tr in traces:
            flow_id += 1
            n = len(tr.spans)
            for j, (stage, t0, t1, attrs) in enumerate(tr.spans):
                tid = tids.setdefault(stage, len(tids) + 1)
                events.append({
                    "ph": "X", "pid": 1, "tid": tid, "name": stage,
                    "cat": "pod", "ts": us(t0), "dur": max(0, us(t1) - us(t0)),
                    "args": {"pod": tr.key, **attrs},
                })
                if n < 2:
                    continue
                # Flow arrows: s at the first span's end, t at each
                # middle span's start, f at the last span's start.
                if j == 0:
                    events.append({
                        "ph": "s", "pid": 1, "tid": tid, "name": "pod",
                        "cat": "flow", "id": flow_id, "ts": us(t1),
                    })
                elif j == n - 1:
                    events.append({
                        "ph": "f", "bp": "e", "pid": 1, "tid": tid,
                        "name": "pod", "cat": "flow", "id": flow_id,
                        "ts": us(t0),
                    })
                else:
                    events.append({
                        "ph": "t", "pid": 1, "tid": tid, "name": "pod",
                        "cat": "flow", "id": flow_id, "ts": us(t0),
                    })
        for stage, tid in tids.items():
            events.append({
                "ph": "M", "pid": 1, "tid": tid, "ts": 0,
                "name": "thread_name", "args": {"name": stage},
            })
        # Monotone per-track order: one stable global sort by timestamp
        # (metadata first; a flow start sorts before the step/finish it
        # feeds at equal timestamps).
        ph_rank = {"M": -1, "X": 0, "s": 1, "t": 2, "f": 3}
        events.sort(key=lambda e: (e["ts"], ph_rank.get(e["ph"], 4)))
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def export(self, path: str) -> dict:
        """Write the trace-event export (parent directory created —
        an end-of-run export must not lose the whole run's report to a
        missing output dir)."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        doc = self.to_trace_events()
        with open(path, "w") as f:
            json.dump(doc, f)
        return doc


def trace_report_detail(tracer, trace_out: str | None = None) -> dict:
    """The shared ``latency_attribution`` report block for tools
    (sched_bench, steady_drill): the waterfall, plus the Perfetto
    export when ``trace_out`` is given.  {} when tracing is off."""
    if tracer is None:
        return {}
    out = {"latency_attribution": tracer.attribution()}
    if trace_out:
        tracer.export(trace_out)
        out["trace_out"] = trace_out
    return out


class _NullTracer:
    """Tracing off: the coordinator's default collaborator.  Every
    surface exists and no-ops; hot paths check ``enabled`` once and
    skip span/attr construction entirely (the trace-lazy-emit lint
    contract)."""

    enabled = False
    sample_n = 0

    def sampled(self, key: str) -> bool:
        return False

    def begin(self, key: str, t: float, **attrs) -> bool:
        return False

    def emit(self, key: str, stage: str, t=None, **attrs) -> bool:
        return False

    def finish(self, key: str, stage: str, t=None, **attrs):
        return None

    def spans_of(self, key: str) -> list:
        return []

    def completed(self) -> list:
        return []

    def attribution(self) -> dict:
        return {}


NULL_TRACER = _NullTracer()


def validate_trace(doc) -> list[str]:
    """Structural validation of a trace-event export (the tier-1 gate):
    well-formed events, monotone per-track timestamps, and every flow
    step/finish resolving to an earlier flow start whose chain also
    terminates.  Returns problems; [] means valid."""
    errs: list[str] = []
    evs = doc.get("traceEvents") if isinstance(doc, dict) else None
    if not isinstance(evs, list):
        return ["traceEvents is not a list"]
    last_ts: dict[tuple, int] = {}
    started: set = set()
    finished: set = set()
    for i, e in enumerate(evs):
        ph = e.get("ph")
        if ph not in ("M", "X", "s", "t", "f"):
            errs.append(f"event {i}: unknown ph {ph!r}")
            continue
        ts = e.get("ts")
        if not isinstance(ts, int) or ts < 0:
            errs.append(f"event {i}: bad ts {ts!r}")
            continue
        if ph == "M":
            continue
        track = (e.get("pid"), e.get("tid"))
        if ph == "X":
            if not e.get("name"):
                errs.append(f"event {i}: X event without a name")
            dur = e.get("dur")
            if not isinstance(dur, int) or dur < 0:
                errs.append(f"event {i}: bad dur {dur!r}")
            if ts < last_ts.get(track, 0):
                errs.append(
                    f"event {i}: track {track} timestamps not monotone "
                    f"({ts} after {last_ts[track]})"
                )
            last_ts[track] = max(last_ts.get(track, 0), ts)
            continue
        fid = e.get("id")
        if fid is None:
            errs.append(f"event {i}: flow event without an id")
            continue
        if ph == "s":
            started.add(fid)
        elif fid not in started:
            errs.append(f"event {i}: flow {ph!r} id {fid} before its 's'")
        if ph == "f":
            finished.add(fid)
    for fid in sorted(started - finished, key=str):
        errs.append(f"flow id {fid} started but never finished")
    return errs
