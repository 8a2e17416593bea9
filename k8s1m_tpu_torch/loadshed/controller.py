"""The overload health controller: HEALTHY -> DEGRADED -> SHEDDING.

The port's own copy of ``k8s1m_tpu/loadshed/controller.py``.

The reference survives 1M nodes by never letting a control-plane
component take more work than it can finish: mem_etcd keeps its API
minimal and alarms on slow ops (``AlertingHistogramTimer``, reference
store.rs:883-907), and dist-scheduler's ``percentageOfNodesToScore: 5``
is itself a *static* degradation knob baked into the production config
(reference README.adoc:525-531).  This module makes that posture
dynamic: a small state machine fed by the signals the coordinator
already exports — queue depth, backoff depth, bind-conflict rate, cycle
latency, watch-overflow resyncs — that tells the enforcement points how
much to give up:

- **HEALTHY**  — full plugin set, configured ``score_pct``, adaptive
  small-batch buckets, admit everything.
- **DEGRADED** — shrink ``score_pct`` to ``degraded_score_pct``, drop
  the PodTopologySpread / InterPodAffinity *scoring* (hard constraint
  filtering always stays — correctness is never degraded), widen batch
  windows (no small buckets: throughput over latency).  Admission still
  accepts everything below the hard queue cap.
- **SHEDDING** — everything DEGRADED does, plus admission control: pods
  below an adaptive priority floor are rejected (HTTP 429 +
  ``Retry-After`` at the webhook, ``Overloaded`` from
  ``Coordinator.submit_external``).  The floor climbs one priority
  level per still-overloaded tick and falls back when pressure clears,
  so the *lowest-priority* pods are always the ones shed — the same
  ordering contract as kube-apiserver priority-and-fairness.

Escalation is immediate (one bad tick), recovery is hysteretic: the
controller must see ``recover_cycles`` consecutive calm ticks (load
under ``queue_recover``) to step DOWN one state, so a load hovering at
a watermark cannot flap the whole stack between modes.

Everything is integer thresholds and counters — no RNG, no wall clock —
so a drill on a virtual clock replays the same state trajectory from
the same signal sequence (the faultline determinism contract extended
to overload).

Metrics: ``loadshed_state{controller}`` (0/1/2),
``loadshed_transitions_total{controller,from,to}``,
``admission_rejected_total{point,reason}`` (reason ``priority`` = under
the floor, ``cap`` = hard queue cap), ``degraded_cycles_total{mode}``.
"""

from __future__ import annotations

import dataclasses
import threading

from k8s1m_tpu_torch.lint import guarded_by
from k8s1m_tpu_torch.obs.metrics import Counter, Gauge

HEALTHY, DEGRADED, SHEDDING = 0, 1, 2
STATE_NAMES = ("healthy", "degraded", "shedding")

_STATE = Gauge(
    "loadshed_state",
    "Overload state: 0 healthy, 1 degraded, 2 shedding",
    ("controller",),
)
_TRANSITIONS = Counter(
    "loadshed_transitions_total",
    "Overload state transitions",
    ("controller", "from", "to"),
)
_REJECTED = Counter(
    "admission_rejected_total",
    "Pods rejected at admission, by enforcement point and reason",
    ("point", "reason"),
)
_DEGRADED_CYCLES = Counter(
    "degraded_cycles_total",
    "Scheduling waves run with degraded knobs, by mode",
    ("mode",),
)


class Overloaded(Exception):
    """Admission rejected under overload; carries the backoff hint the
    webhook maps onto an HTTP 429 ``Retry-After`` header."""

    def __init__(self, retry_after_s: float, reason: str = "priority"):
        super().__init__(
            f"admission shed ({reason}); retry after {retry_after_s:.1f}s"
        )
        self.retry_after_s = retry_after_s
        self.reason = reason


@dataclasses.dataclass
class Signals:
    """One tick's worth of overload evidence, sampled by the coordinator."""

    queue_depth: int = 0     # pending pods (queue + staged webhook intake)
    backoff_depth: int = 0   # pods waiting out a retry backoff
    conflicts: int = 0       # bind CAS conflicts since the last tick
    resyncs: int = 0         # watch-overflow relists since the last tick
    cycle_s: float = 0.0     # last completed cycle's wall time

    @property
    def load(self) -> int:
        return self.queue_depth + self.backoff_depth


@dataclasses.dataclass(frozen=True)
class LoadshedConfig:
    """Operator knobs (see README "Overload & degraded modes").

    Watermarks are in pods of *load* (queue + backoff depth); they must
    satisfy ``queue_recover < queue_degraded <= queue_shed <= queue_cap``.
    ``queue_cap`` is the hard bound admission enforces regardless of
    priority — the "coordinator queue stays under its cap" guarantee.
    """

    queue_degraded: int = 8192     # load >= this -> DEGRADED
    queue_shed: int = 16384        # load >= this -> SHEDDING (high watermark)
    queue_cap: int = 32768         # hard cap: reject every priority past it
    queue_recover: int = 2048      # hysteresis: a tick is calm below this
    recover_cycles: int = 8        # calm ticks per one-state step-down
    cycle_slow_s: float = float("inf")   # cycle p99 past this -> DEGRADED
    conflicts_degraded: int = 1 << 30    # conflicts/tick past this -> DEGRADED
    latency_window: int = 64       # cycle samples kept for the p99
    degraded_score_pct: int = 1    # score_pct while degraded/shedding
    retry_after_s: float = 1.0     # the 429 Retry-After hint

    def __post_init__(self):
        if not (
            0 <= self.queue_recover
            < self.queue_degraded
            <= self.queue_shed
            <= self.queue_cap
        ):
            raise ValueError(
                "want queue_recover < queue_degraded <= queue_shed <= "
                f"queue_cap, got {self.queue_recover}/{self.queue_degraded}"
                f"/{self.queue_shed}/{self.queue_cap}"
            )
        if self.recover_cycles < 1:
            raise ValueError("recover_cycles must be >= 1")
        if not 1 <= self.degraded_score_pct <= 100:
            raise ValueError(
                f"degraded_score_pct must be in [1, 100], "
                f"got {self.degraded_score_pct}"
            )


@guarded_by(
    # Everything the webhook handler threads and the cycle thread both
    # touch lives under the admission lock: the sampled load + intra-tick
    # admission count (the hard-cap arithmetic), the shedding floor and
    # priority bounds (written by tick, read by every admission), and the
    # state itself (read by admissions and the degraded-knobs switch).
    # The lint/guards.py audit raises on any access outside the lock.
    _load="_admit_lock",
    _admitted_since_tick="_admit_lock",
    _floor="_admit_lock",
    _prio_lo="_admit_lock",
    _prio_hi="_admit_lock",
    _prio_seen="_admit_lock",
    state="_admit_lock",
)
class HealthController:
    """The overload state machine; one per coordinator.

    ``tick(signals)`` once per scheduling cycle moves the state;
    ``admit(priority, point)`` is the admission predicate the webhook
    and ``submit_external`` consult.  Admissions between ticks count
    against the sampled load, so the ``queue_cap`` bound holds even
    when a burst lands entirely inside one cycle.
    """

    def __init__(
        self, config: LoadshedConfig | None = None, name: str = "coordinator"
    ):
        self.config = config or LoadshedConfig()
        self.name = name
        self.state = HEALTHY
        self._calm = 0
        self._load = 0
        self._admitted_since_tick = 0
        # Adaptive priority floor: pods with priority < floor are shed
        # while SHEDDING.  Bounds track the priorities actually offered,
        # so the floor can always climb high enough to bite and never
        # chases values nobody submits.  The bounds (and the floor) are
        # seeded by the FIRST offered priority, not by 0 — a workload
        # submitting only negative priorities must not find itself shed
        # entirely by a floor stuck at a level nobody ever offered.
        self._prio_lo = 0
        self._prio_hi = 0
        self._prio_seen = False
        self._floor = 0
        self.ticks = 0
        # Recent cycle wall times (newest latency_window samples).
        self._lat: list[float] = []
        # admit() runs concurrently from webhook handler threads; the
        # cap check-then-increment must be one atomic step or a burst
        # of parallel admissions overshoots the "hard" queue_cap.
        self._admit_lock = threading.Lock()
        _STATE.set(HEALTHY, controller=name)

    # ---- state machine -------------------------------------------------

    def _set_state(self, new: int) -> None:
        """State transition; caller must hold ``_admit_lock`` (state and
        the shedding floor are read concurrently by admissions)."""
        if new == self.state:
            return
        _TRANSITIONS.inc(
            controller=self.name,
            **{"from": STATE_NAMES[self.state], "to": STATE_NAMES[new]},
        )
        self.state = new
        _STATE.set(new, controller=self.name)
        if new < SHEDDING:
            self._floor = self._prio_lo   # stop shedding: admit all again

    def tick(self, signals: Signals) -> int:
        """Advance one cycle; returns the (possibly new) state."""
        self.ticks += 1
        cfg = self.config
        self._lat.append(signals.cycle_s)
        if len(self._lat) > cfg.latency_window:
            self._lat.pop(0)

        overloaded = signals.load >= cfg.queue_shed
        strained = (
            signals.load >= cfg.queue_degraded
            or self.cycle_p99() >= cfg.cycle_slow_s
            or signals.conflicts >= cfg.conflicts_degraded
            or signals.resyncs > 0
        )
        # The whole transition runs under the admission lock: webhook
        # handler threads read state/floor on every admission, and a
        # half-applied transition (state moved, floor not yet) would
        # leak exactly the burst the watermarks exist to stop.
        with self._admit_lock:
            self._load = signals.load
            self._admitted_since_tick = 0
            if overloaded:
                self._calm = 0
                self._set_state(SHEDDING)
                # Still at/above the high watermark: shed one priority
                # level deeper.  Deterministic — pure function of the
                # load series.
                self._floor = min(self._floor + 1, self._prio_hi)
            elif strained:
                self._calm = 0
                if self.state < DEGRADED:
                    self._set_state(DEGRADED)
            elif signals.load <= cfg.queue_recover:
                self._calm += 1
                if self._calm >= cfg.recover_cycles and self.state > HEALTHY:
                    # Hysteresis: one state per recover_cycles calm
                    # ticks, never a straight SHEDDING -> HEALTHY jump.
                    self._set_state(self.state - 1)
                    self._calm = 0
            else:
                # Between recover and degraded watermarks: hold.
                self._calm = 0
            return self.state

    def cycle_p99(self) -> float:
        if not self._lat:
            return 0.0
        s = sorted(self._lat)
        return s[min(len(s) - 1, int(len(s) * 0.99))]

    @property
    def degraded(self) -> bool:
        with self._admit_lock:
            return self.state != HEALTHY

    def current_state(self) -> int:
        """Locked state read for composing layers (tenancy's weighted-
        fair admission keys its enforcement on it; a bare ``.state``
        read would violate the declared lock discipline)."""
        with self._admit_lock:
            return self.state

    def lag_budget(self, full: int) -> int:
        """Degradation knob for fan-out tiers (store/watch_cache.py):
        the per-subscriber FIFO depth a consumer may lag before
        latest-only coalescing engages.  HEALTHY keeps the configured
        budget, DEGRADED quarters it, SHEDDING zeroes it (coalesce
        immediately, tier-wide).  Depth-triggered enforcement means the
        deepest-backlog — i.e. floodiest — watchers degrade first; this
        method just sets how hard the controller squeezes."""
        with self._admit_lock:
            s = self.state
        if s == SHEDDING:
            return 0
        if s == DEGRADED:
            return max(1, full // 4)
        return full

    # ---- admission -----------------------------------------------------

    def try_admit(
        self, priority: int = 0, point: str = "coordinator",
        *, floor: bool = True,
    ) -> str | None:
        """Admission predicate: None = admitted, else the rejection
        reason (``"cap"`` = hard queue bound, any priority; ``"priority"``
        = under the shedding floor — the client's cue to raise its
        PriorityClass rather than just back off).  Counts every accept
        against the load sampled at the last tick so ``queue_cap`` is a
        hard bound, not a per-tick approximation.

        ``floor=False`` keeps the hard cap but skips the adaptive
        priority floor — the tenancy layer's form (k8s1m_tpu/tenancy):
        it sheds proportionally by tenant instead of globally by
        priority, and priority's job moves to preemption."""
        with self._admit_lock:
            # Bounds tracking moved under the lock: concurrent admissions
            # used to lose min/max updates (the shedding floor could then
            # never climb high enough to bite) — found by the guard audit.
            if not self._prio_seen:
                # First offer seeds the band AND — outside SHEDDING —
                # the floor (floor at the observed minimum = admit
                # everything, the same level recovery resets to).
                self._prio_seen = True
                self._prio_lo = self._prio_hi = priority
                if self.state < SHEDDING:
                    self._floor = priority
            else:
                if priority < self._prio_lo:
                    self._prio_lo = priority
                    # The floor tracks the observed MINIMUM until a
                    # shedding episode actually escalates it: a high-
                    # priority first pod must not pre-arm the floor so
                    # that entering SHEDDING instantly sheds everything
                    # below it instead of one level per tick.
                    if self.state < SHEDDING:
                        self._floor = priority
                self._prio_hi = max(self._prio_hi, priority)
            if (
                self._load + self._admitted_since_tick
                >= self.config.queue_cap
            ):
                reason = "cap"
            elif floor and self.state == SHEDDING and priority < self._floor:
                reason = "priority"
            else:
                self._admitted_since_tick += 1
                return None
        _REJECTED.inc(point=point, reason=reason)
        return reason

    def admit(self, priority: int = 0, point: str = "coordinator") -> bool:
        """Boolean form of ``try_admit`` (the webhook's 429 gate)."""
        return self.try_admit(priority, point) is None

    def check_admit(self, priority: int = 0, point: str = "coordinator") -> None:
        """``try_admit`` that raises ``Overloaded`` (submit_external's
        form), carrying the real rejection reason."""
        reason = self.try_admit(priority, point)
        if reason is not None:
            raise Overloaded(self.config.retry_after_s, reason)

    def retry_after_s(self) -> float:
        return self.config.retry_after_s

    def note_degraded_cycle(self) -> None:
        """Called by the coordinator for every wave launched with
        degraded knobs (the ``degraded_cycles_total`` evidence)."""
        with self._admit_lock:
            mode = STATE_NAMES[self.state]
        _DEGRADED_CYCLES.inc(mode=mode)
