"""The one retry/backoff policy every component shares.

The port's own copy of ``k8s1m_tpu/faultline/policy.py``.  The port has
no wire store yet, so ``default_retryable`` knows no gRPC status codes.

Before this module, failure handling was hand-rolled per call site:
``control/coordinator.py`` counted flat attempts with no backoff (a
conflict storm re-entered the very next wave), ``tools/common.py`` ran a
bare ``for attempt in range(retries+1)`` with zero sleep, and
``store/watch_cache.py`` relisted on a fixed 200ms nap.  ``RetryPolicy``
replaces all of them: capped exponential backoff with full jitter
(the AWS-style decorrelated-sleep shape that keeps retry waves from
synchronizing into thundering herds) under a total deadline budget, with
per-component defaults in ``DEFAULT_POLICIES``.

Give-up is a *policy edge*, not an error path: ``call`` raises
``GiveUp`` carrying the last error, and each component maps that to its
graceful degradation — the watch consumer relists from its last resume
revision, the coordinator parks the pod as unschedulable after bounded
requeues, the shardset lets the rebalancer evacuate a shard that cannot
heartbeat.

Metrics: ``retry_attempts_total{component}`` (every retry, i.e. attempts
beyond the first), ``retry_give_ups_total{component}``.
Each successful call that needed retries also records a *recovery
sample* — wall time from the first failure to the eventual success —
keyed by fault class (the injected kind when the first error was an
``InjectedFault``, else the component name).  ``recovery_stats()``
reduces the samples to count/p50/p99 per class: the soak's
"p99 recovery time per fault class" evidence.
"""

from __future__ import annotations

import dataclasses
import random
import threading
import time

from k8s1m_tpu_torch.faultline.plan import InjectedFault
from k8s1m_tpu_torch.obs.metrics import Counter

_RETRIES = Counter(
    "retry_attempts_total",
    "Retry attempts (beyond the first try), by component",
    ("component",),
)
_GIVEUPS = Counter(
    "retry_give_ups_total",
    "Operations abandoned after exhausting the retry budget",
    ("component",),
)

# Recovery samples: first-failure -> eventual-success wall time, by
# fault class.  Bounded per class so a week-long soak cannot grow this
# without limit (the tail quantiles stabilize long before the cap).
_REC_CAP = 65536
_REC_LOCK = threading.Lock()
_recovery: dict[str, list[float]] = {}


def _fault_class(e: Exception, component: str) -> str:
    return e.decision.kind if isinstance(e, InjectedFault) else component


def note_recovery(fault_class: str, seconds: float) -> None:
    """Record one recovered-after-failure duration (also called by the
    soak driver for process-level classes like ``tier_kill``)."""
    with _REC_LOCK:
        samples = _recovery.setdefault(fault_class, [])
        if len(samples) < _REC_CAP:
            samples.append(seconds)


def recovery_stats() -> dict[str, dict]:
    """count / p50 / p99 / max seconds per fault class so far."""
    out: dict[str, dict] = {}
    with _REC_LOCK:
        for cls, samples in _recovery.items():
            if not samples:
                continue
            s = sorted(samples)
            out[cls] = {
                "count": len(s),
                "p50_s": round(s[len(s) // 2], 4),
                "p99_s": round(s[min(len(s) - 1, int(len(s) * 0.99))], 4),
                "max_s": round(s[-1], 4),
            }
    return out


class GiveUp(Exception):
    """Retry budget exhausted; ``cause`` is the last underlying error."""

    def __init__(self, component: str, op: str, attempts: int, cause: Exception):
        super().__init__(
            f"{component}/{op}: gave up after {attempts} attempt(s): {cause!r}"
        )
        self.component = component
        self.op = op
        self.attempts = attempts
        self.cause = cause


def default_retryable(e: Exception) -> bool:
    """Transient-error test shared by the store-facing components:
    injected faults, connection resets and timeouts.  Semantic errors
    (CompactedError, CAS conflicts, bad requests) are never retried
    here — they have their own recovery contracts (relist, requeue)."""
    return isinstance(e, (InjectedFault, ConnectionError, TimeoutError))


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Capped exponential backoff + full jitter + deadline budget.

    ``max_attempts`` counts tries, not retries (1 = never retry).
    ``deadline_s`` bounds the SUM of sleeps, so a component's worst-case
    stall is explicit instead of emergent from per-site constants."""

    component: str = ""
    max_attempts: int = 5
    base_delay_s: float = 0.02
    max_delay_s: float = 2.0
    multiplier: float = 2.0
    jitter: float = 0.5            # fraction of each delay randomized
    deadline_s: float = 30.0

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if not 0.0 <= self.jitter <= 1.0:
            raise ValueError("jitter must be in [0, 1]")

    def delay_for(self, attempt: int, rng: random.Random | None = None) -> float:
        """Sleep before try ``attempt+1`` (attempt is 1-based: the delay
        after the attempt-th failure).  Deterministic when ``rng`` is
        supplied — the coordinator's backoff requeue threads a seeded rng
        through so a replayed fault plan replays the same schedule."""
        # Exponent capped: retry-forever components (watch.tier) feed an
        # unbounded attempt count through here, and 2.0 ** ~1024 raises
        # OverflowError — the cap is far past where max_delay_s wins.
        d = min(
            self.max_delay_s,
            self.base_delay_s * (self.multiplier ** min(max(0, attempt - 1), 64)),
        )
        if self.jitter:
            r = (rng or random).random()
            d *= (1.0 - self.jitter) + self.jitter * r
        return d

    def _sleeps(self, rng: random.Random | None = None):
        """The bounded sleep schedule: one entry per allowed RETRY."""
        budget = self.deadline_s
        for attempt in range(1, self.max_attempts):
            d = min(self.delay_for(attempt, rng), budget)
            budget -= d
            yield d
            if budget <= 0:
                return

    def call(
        self,
        fn,
        *,
        op: str = "",
        retryable=default_retryable,
        rng: random.Random | None = None,
        sleep=time.sleep,
    ):
        """Run ``fn()`` under this policy; raises GiveUp when the budget
        is exhausted (non-retryable errors propagate immediately)."""
        attempts = 0
        sleeps = self._sleeps(rng)
        first_fail: tuple[float, str] | None = None
        while True:
            attempts += 1
            try:
                result = fn()
            except Exception as e:
                if not retryable(e):
                    raise
                if first_fail is None:
                    first_fail = (
                        time.monotonic(), _fault_class(e, self.component)
                    )
                try:
                    d = next(sleeps)
                except StopIteration:
                    _GIVEUPS.inc(component=self.component)
                    raise GiveUp(self.component, op, attempts, e) from e
                _RETRIES.inc(component=self.component)
                sleep(d)
            else:
                if first_fail is not None:
                    note_recovery(
                        first_fail[1], time.monotonic() - first_fail[0]
                    )
                return result

    async def acall(
        self,
        fn,
        *,
        op: str = "",
        retryable=default_retryable,
        rng: random.Random | None = None,
    ):
        """``call`` for coroutine ``fn`` (asyncio sleeps between tries)."""
        import asyncio

        attempts = 0
        sleeps = self._sleeps(rng)
        first_fail: tuple[float, str] | None = None
        while True:
            attempts += 1
            try:
                result = await fn()
            except Exception as e:
                if not retryable(e):
                    raise
                if first_fail is None:
                    first_fail = (
                        time.monotonic(), _fault_class(e, self.component)
                    )
                try:
                    d = next(sleeps)
                except StopIteration:
                    _GIVEUPS.inc(component=self.component)
                    raise GiveUp(self.component, op, attempts, e) from e
                _RETRIES.inc(component=self.component)
                await asyncio.sleep(d)
            else:
                if first_fail is not None:
                    note_recovery(
                        first_fail[1], time.monotonic() - first_fail[0]
                    )
                return result


# Per-component defaults.  Tuning rationale:
# - store.wire: RPCs on the scheduling hot path; short base so a blip
#   costs ms, capped deadline so a dead store surfaces within ~10s.
# - watch.tier / consumer resync loops: relist is expensive — back off
#   harder, effectively retry forever (the tier's job is to outlive
#   outages; GiveUp would mean abandoning the cache).
# - coordinator.bind: attempts-as-requeues with backoff; matches the
#   historical max_attempts=5 so scheduling-outcome tests keep passing.
# - shardset.lease: a couple of quick tries per tick; the real recovery
#   is the rebalancer's dead-shard evacuation, so give up fast.
# - tools.loadgen: the old run_sharded retried twice flat; keep 3 tries
#   but with jittered backoff so a stressed store is not hammered.
DEFAULT_POLICIES: dict[str, RetryPolicy] = {
    "store.wire": RetryPolicy(
        "store.wire", max_attempts=5, base_delay_s=0.02, max_delay_s=1.0,
        deadline_s=10.0,
    ),
    "watch.tier": RetryPolicy(
        "watch.tier", max_attempts=1_000_000, base_delay_s=0.05,
        max_delay_s=5.0, deadline_s=float("inf"),
    ),
    # The tier's RESUME relist (watch_cache.run_upstream once primed):
    # same retry-forever posture, but a tighter base/cap — a resume
    # races client-visible delivery lag (the watchstorm p99 gate), not
    # bootstrap, and the clients are all still attached and waiting.
    "watch.resume": RetryPolicy(
        "watch.resume", max_attempts=1_000_000, base_delay_s=0.02,
        max_delay_s=1.0, deadline_s=float("inf"),
    ),
    "coordinator.bind": RetryPolicy(
        "coordinator.bind", max_attempts=5, base_delay_s=0.01,
        max_delay_s=0.5, deadline_s=30.0,
    ),
    "shardset.lease": RetryPolicy(
        "shardset.lease", max_attempts=3, base_delay_s=0.01, max_delay_s=0.2,
        deadline_s=2.0,
    ),
    "tools.loadgen": RetryPolicy(
        "tools.loadgen", max_attempts=3, base_delay_s=0.05, max_delay_s=1.0,
        deadline_s=10.0,
    ),
}


def note_retry(component: str) -> None:
    """Count a retry performed outside ``call`` (e.g. the coordinator's
    backoff REQUEUE, where the 'retry' is a later scheduling wave rather
    than a blocked re-invocation) in the same metric."""
    _RETRIES.inc(component=component)


def note_give_up(component: str) -> None:
    _GIVEUPS.inc(component=component)


def retry_counts() -> dict[str, float]:
    """Per-component retry totals so far (evidence reporting)."""
    with _RETRIES._lock:
        return {k[0]: v for k, v in _RETRIES._values.items()}


def give_up_counts() -> dict[str, float]:
    with _GIVEUPS._lock:
        return {k[0]: v for k, v in _GIVEUPS._values.items()}


def policy_for(component: str) -> RetryPolicy:
    """The default policy for ``component`` (an unknown component gets a
    generic conservative policy tagged with its own name)."""
    p = DEFAULT_POLICIES.get(component)
    if p is None:
        p = dataclasses.replace(RetryPolicy(), component=component)
    return p
