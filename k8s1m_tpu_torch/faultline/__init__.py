"""faultline: deterministic fault injection + unified retry/backoff.

The port's own copy of ``k8s1m_tpu/faultline``.

The reference survives week-long watch sessions, an 11-replica apiserver
tier, and kubelet churn at 1M nodes (reference README.adoc:410-416,
server.tf:230-251) — but every recovery behavior this repro claims
(watch re-attach, CAS-bind conflict handling, dead-shard evacuation,
tier-replica failover) used to be exercised by one bespoke kill drill
each, with retries and timeouts hand-rolled per call site.  This package
replaces both halves with a reusable subsystem:

- **Injection** (`plan.py`): a seeded, deterministic ``FaultPlan`` —
  drop / delay / disconnect / err5xx / partial-write / stale-revision
  / stall / slow-cycle faults keyed by component x operation, fired by
  probability or schedule — with hooks threaded into the store wire
  client (store/remote.py), the watch-cache event pump
  (store/watch_cache.py), the coordinator's bind/CAS, watch-drain and
  cycle-dispatch paths (control/coordinator.py; the overload-shaped
  ``stall`` / ``slow_cycle`` kinds drive the loadshed breaker and
  latency signals), and the shardset lease/rebalance loop
  (control/shardset.py).  Enabled via ``ClusterSpec(fault_plan=...)``,
  a ``--fault-plan JSON`` flag on sched_bench / store_stress / soak, or
  the ``K8S1M_FAULT_PLAN`` env var (how subprocess topologies inherit
  the plan).  Same seed => same injected-fault sequence, asserted in
  tests/test_faultline.py.

- **Resilience** (`policy.py`): one ``RetryPolicy`` (capped exponential
  backoff + jitter + deadline budget) with per-component defaults,
  replacing the scattered hand-rolled loops.  Give-up degrades
  gracefully rather than erroring out: a broken watch falls back to
  relist-from-last-revision (the consumer resync contract), the
  coordinator requeues conflicted pods with backoff (conflict storms
  become backpressure, not a tight loop), and the shardset masks a
  silent shard dead and evacuates its groups.

Metrics: ``faultline_injected_total{component,kind}``,
``retry_attempts_total{component}``, ``retry_give_ups_total{component}``.
"""

from k8s1m_tpu_torch.faultline.plan import (
    FAULT_KINDS,
    NAMED_PLANS,
    FaultDecision,
    FaultPlan,
    FaultSpec,
    InjectedFault,
    Injector,
    acheck,
    active_injector,
    check,
    decide,
    install_plan,
)
from k8s1m_tpu_torch.faultline.policy import (
    DEFAULT_POLICIES,
    GiveUp,
    RetryPolicy,
    give_up_counts,
    note_give_up,
    note_recovery,
    note_retry,
    policy_for,
    recovery_stats,
    retry_counts,
)

__all__ = [
    "FAULT_KINDS",
    "NAMED_PLANS",
    "acheck",
    "FaultDecision",
    "FaultPlan",
    "FaultSpec",
    "InjectedFault",
    "Injector",
    "active_injector",
    "check",
    "decide",
    "install_plan",
    "DEFAULT_POLICIES",
    "GiveUp",
    "RetryPolicy",
    "give_up_counts",
    "note_give_up",
    "note_recovery",
    "note_retry",
    "policy_for",
    "recovery_stats",
    "retry_counts",
]
