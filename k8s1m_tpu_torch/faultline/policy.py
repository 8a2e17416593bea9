"""The retry/backoff policy of the coordinator's bind path.

The port's own copy of the part of ``k8s1m_tpu/faultline/policy.py`` the
coordinator uses: ``RetryPolicy`` (capped exponential backoff with full
jitter under a deadline budget), ``policy_for`` and its per-component
defaults, and the retry / give-up counters.  A pod whose bind CAS fails
or that finds no feasible node is requeued after ``delay_for(attempt)``
and parked as unschedulable after ``max_attempts`` tries.  The fault
injector of the JAX package is not part of the port.

Metrics: ``retry_attempts_total{component}`` (every retry, i.e. attempts
beyond the first), ``retry_give_ups_total{component}``.
"""

from __future__ import annotations

import dataclasses
import random

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


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Capped exponential backoff + full jitter + deadline budget.

    ``max_attempts`` counts tries, not retries (1 = never retry)."""

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
        supplied — the coordinator threads a seeded rng through, so a
        replayed run replays the same schedule."""
        # Exponent capped: 2.0 ** ~1024 raises OverflowError, far past
        # where max_delay_s wins.
        d = min(
            self.max_delay_s,
            self.base_delay_s * (self.multiplier ** min(max(0, attempt - 1), 64)),
        )
        if self.jitter:
            r = (rng or random).random()
            d *= (1.0 - self.jitter) + self.jitter * r
        return d


# coordinator.bind: attempts-as-requeues with backoff (the JAX package's
# default for the same component).
DEFAULT_POLICIES: dict[str, RetryPolicy] = {
    "coordinator.bind": RetryPolicy(
        "coordinator.bind", max_attempts=5, base_delay_s=0.01,
        max_delay_s=0.5, deadline_s=30.0,
    ),
}


def note_retry(component: str) -> None:
    """Count a retry performed as a later scheduling wave (the
    coordinator's backoff requeue)."""
    _RETRIES.inc(component=component)


def note_give_up(component: str) -> None:
    _GIVEUPS.inc(component=component)


def policy_for(component: str) -> RetryPolicy:
    """The default policy for ``component`` (an unknown component gets a
    generic policy tagged with its own name)."""
    p = DEFAULT_POLICIES.get(component)
    if p is None:
        p = dataclasses.replace(RetryPolicy(), component=component)
    return p
