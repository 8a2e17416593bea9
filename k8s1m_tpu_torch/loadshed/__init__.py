"""loadshed: adaptive overload control, admission shedding, graceful
degradation.

The port's own copy of ``k8s1m_tpu/loadshed``.  The webhook enforcement
point (``control/webhook.py``) is not part of the port yet.

PR 1 (faultline) made failures *visible* — conflict storms surface as
backoff backpressure, watch loss as resyncs.  This package makes the
system *react*: a health controller (``controller.py``) watches those
signals and drives three enforcement points —

1. **Admission control** — ``control/webhook.py`` answers 429 +
   ``Retry-After`` and ``Coordinator.submit_external`` raises
   ``Overloaded`` past the high watermark, shedding lowest-priority
   pods first (``ops/priority.py pod_priority_of``), with a hard
   ``queue_cap`` no priority can pass.
2. **Degraded scheduling modes** — the coordinator shrinks
   ``score_pct`` (the ``sample_rows_for`` path), drops the expensive
   PodTopologySpread / InterPodAffinity plugins to filter-only scoring
   (hard constraints always keep filtering), and widens batch windows,
   so binds/sec degrades gracefully instead of latency exploding.
3. **Circuit breaker** (``breaker.py``) — consecutive cycle-dispatch
   failures open it; while open, small batches fall back to the
   host-side ``oracle/`` scheduler (byte-identical placements), so
   scheduling never fully stops; half-open probes close it again.

All state is integer counters clocked in cycles — deterministic on a
virtual clock (tools/overload_drill.py) and in wall-clock soaks alike.
"""

from k8s1m_tpu_torch.loadshed.breaker import (
    BREAKER_STATE_NAMES,
    CLOSED,
    HALF_OPEN,
    OPEN,
    BreakerConfig,
    CircuitBreaker,
)
from k8s1m_tpu_torch.loadshed.controller import (
    DEGRADED,
    HEALTHY,
    SHEDDING,
    STATE_NAMES,
    HealthController,
    LoadshedConfig,
    Overloaded,
    Signals,
)

__all__ = [
    "BREAKER_STATE_NAMES",
    "BreakerConfig",
    "CLOSED",
    "CircuitBreaker",
    "DEGRADED",
    "HALF_OPEN",
    "HEALTHY",
    "HealthController",
    "LoadshedConfig",
    "OPEN",
    "Overloaded",
    "SHEDDING",
    "STATE_NAMES",
    "Signals",
]
