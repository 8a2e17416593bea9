"""Circuit breaker around device cycle dispatch.

The port's own copy of ``k8s1m_tpu/loadshed/breaker.py``.

A wedged device runtime (driver hang, injected ``stall``, a mesh peer
gone) must not take scheduling down with it: after
``failure_threshold`` consecutive dispatch failures the breaker OPENs
and the coordinator stops launching device waves, scheduling small
batches through the host-side ``oracle/`` reference scheduler instead
— slower, but byte-identical placements and never a full stop.  After
``cooldown_cycles`` open cycles the breaker goes HALF_OPEN and lets
exactly one probe wave through; success closes it, failure re-opens
with a fresh cooldown.

Time is counted in *cycles*, not seconds, so the breaker replays
identically on a virtual clock (tools/overload_drill.py tier-1 smoke)
and in wall-clock soaks alike.

Scope: failures are observed at *dispatch* (the launch raises — the
faultline ``stall`` kind, driver rejections) and successes at *retire*
(the wave's results came back).  A runtime that accepts the async
dispatch and then never completes blocks the caller inside the
device fetch, where no portable timeout exists — that class needs an
external watchdog (``tools/with_deadline.py`` process-level deadlines),
not this breaker.  Under a deep pipeline an open can lag dispatch
failures by up to ``depth`` retires (old waves retiring successfully
reset the consecutive count) — by design: a device draining real work
is not yet dead.

Metrics: ``breaker_state{component}`` (0 closed, 1 open, 2 half-open),
``breaker_transitions_total{component,from,to}``,
``breaker_fallback_binds_total``.
"""

from __future__ import annotations

import dataclasses
import logging

from k8s1m_tpu_torch.obs.metrics import Counter, Gauge

log = logging.getLogger("k8s1m.loadshed")

CLOSED, OPEN, HALF_OPEN = 0, 1, 2
BREAKER_STATE_NAMES = ("closed", "open", "half_open")

_BREAKER_STATE = Gauge(
    "breaker_state",
    "Cycle-dispatch circuit breaker: 0 closed, 1 open, 2 half-open",
    ("component",),
)
_BREAKER_TRANSITIONS = Counter(
    "breaker_transitions_total",
    "Circuit breaker transitions",
    ("component", "from", "to"),
)
FALLBACK_BINDS = Counter(
    "breaker_fallback_binds_total",
    "Pods bound via the host-side oracle while the breaker was open",
    (),
)


@dataclasses.dataclass(frozen=True)
class BreakerConfig:
    failure_threshold: int = 3   # consecutive dispatch failures to OPEN
    cooldown_cycles: int = 8     # open cycles before the half-open probe
    fallback_batch: int = 64     # pods per open-state oracle fallback wave

    def __post_init__(self):
        if self.failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        if self.cooldown_cycles < 1:
            raise ValueError("cooldown_cycles must be >= 1")
        if self.fallback_batch < 1:
            raise ValueError("fallback_batch must be >= 1")


class CircuitBreaker:
    """CLOSED -> OPEN -> HALF_OPEN -> CLOSED, clocked in cycles.

    Protocol per cycle with a batch to dispatch:

    - ``allow()`` — True: launch the device wave, then report the
      outcome with ``record_success()`` / ``record_failure()``.
      False: the breaker is open; schedule the fallback batch instead.
    - In HALF_OPEN, ``allow()`` admits exactly one probe at a time;
      its outcome decides CLOSED vs a fresh OPEN cooldown.
    """

    def __init__(
        self,
        config: BreakerConfig | None = None,
        component: str = "coordinator.cycle",
    ):
        self.config = config or BreakerConfig()
        self.component = component
        self.state = CLOSED
        self._failures = 0
        self._open_cycles = 0
        self._probe_inflight = False
        _BREAKER_STATE.set(CLOSED, component=component)

    def _set_state(self, new: int) -> None:
        if new == self.state:
            return
        _BREAKER_TRANSITIONS.inc(
            component=self.component,
            **{
                "from": BREAKER_STATE_NAMES[self.state],
                "to": BREAKER_STATE_NAMES[new],
            },
        )
        log.warning(
            "%s breaker %s -> %s", self.component,
            BREAKER_STATE_NAMES[self.state], BREAKER_STATE_NAMES[new],
        )
        self.state = new
        _BREAKER_STATE.set(new, component=self.component)

    def allow(self) -> bool:
        if self.state == CLOSED:
            return True
        if self.state == OPEN:
            self._open_cycles += 1
            if self._open_cycles >= self.config.cooldown_cycles:
                self._set_state(HALF_OPEN)
                self._probe_inflight = True
                return True
            return False
        # HALF_OPEN: one probe at a time.
        if self._probe_inflight:
            return False
        self._probe_inflight = True
        return True

    def record_success(self) -> None:
        self._failures = 0
        if self.state == HALF_OPEN:
            self._probe_inflight = False
            self._set_state(CLOSED)
        # OPEN stays OPEN: a pre-failure wave retiring during the
        # open-state quiesce is not the probe — recovery goes through
        # the half-open protocol, never around it.

    def record_failure(self) -> None:
        self._probe_inflight = False
        if self.state == HALF_OPEN:
            self._open_cycles = 0
            self._set_state(OPEN)
            return
        self._failures += 1
        if self.state == CLOSED and (
            self._failures >= self.config.failure_threshold
        ):
            self._open_cycles = 0
            self._set_state(OPEN)
