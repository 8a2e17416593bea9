"""Weighted-fair admission: per-tenant token buckets under overload.

The port's own copy of ``k8s1m_tpu/tenancy/admission.py``.

PR 2's loadshed gave admission ONE global lever — an adaptive priority
floor — so a flash-crowd tenant submitting at priority 5 starves every
tenant submitting at 4, forever.  ``FairAdmission`` replaces the floor
with a proportional-share answer layered on the same HealthController:

- **HEALTHY** — admit everything (the buckets refill to their burst cap
  but are never drawn, so enforcement starts with a full cushion).
- **DEGRADED / SHEDDING** — every admission draws one token from its
  tenant's bucket; an empty bucket rejects with reason ``"tenant"``
  (HTTP 429 at the webhook, ``Overloaded`` from ``submit_external``).
  Buckets refill once per scheduling cycle (``tick``), each active
  tenant getting ``capacity * weight / sum(active weights)`` tokens —
  so under N-fold overload every tenant's *admitted* throughput
  converges to its weight share, and the overload degrades the flash
  crowd instead of the cluster.
- The HealthController's hard ``queue_cap`` stays global (a full queue
  is full no matter whose pods fill it); its priority *floor* is
  bypassed (``floor=False``) — priority's job moves to preemption
  (tenancy/preempt.py), fairness's job lives here.

State discipline: everything webhook handler threads and the cycle
thread both touch lives under ``_admit_lock`` (``@guarded_by``-declared;
the lint static pass and the runtime audit both prove it).  No RNG, no
wall clock: buckets move only on ``tick`` and on admission calls, so a
drill replays the same admit/reject trajectory from the same submit
schedule (the faultline determinism contract, extended to tenancy).

Metrics: ``tenant_admitted_total{tenant_class}`` and
``tenant_debt{tenant_class}`` (tokens of unmet demand, decaying as
refills catch up); rejections land in the existing
``admission_rejected_total{point,reason}`` with reason ``tenant``.
"""

from __future__ import annotations

import threading

from k8s1m_tpu_torch.lint import guarded_by
from k8s1m_tpu_torch.loadshed.controller import (
    HEALTHY,
    HealthController,
    Overloaded,
    _REJECTED,
)
from k8s1m_tpu_torch.obs.metrics import Counter, Gauge
from k8s1m_tpu_torch.ops.priority import pod_priority_of
from k8s1m_tpu_torch.tenancy.policy import TenancyPolicy, tenant_of_obj

_ADMITTED = Counter(
    "tenant_admitted_total",
    "Pods admitted, by tenant class (bounded-cardinality: tenants are "
    "grouped by TenancyPolicy class, never labeled by name)",
    ("tenant_class",),
)
_DEBT = Gauge(
    "tenant_debt",
    "Tokens of unmet tenant demand (rejections not yet covered by "
    "refills) — a persistently indebted class is over its weight share",
    ("tenant_class",),
)


@guarded_by(
    # Webhook handler threads and the cycle thread race on all of it:
    # buckets (drawn per admission, refilled per tick), the demand
    # window (drives the active set), debt, and the cumulative
    # admitted/rejected ledger the drills settle on.
    _buckets="_admit_lock",
    _demand="_admit_lock",
    _debt="_admit_lock",
    _admitted="_admit_lock",
    _rejected="_admit_lock",
    _last_active="_admit_lock",
    _tick_n="_admit_lock",
    _debt_classes="_admit_lock",
)
class FairAdmission:
    """Per-tenant weighted-fair token buckets over a HealthController.

    Presents the same surface the webhook and ``submit_external``
    already consume (``admit``/``check_admit``/``retry_after_s``) plus
    the object-aware forms (``admit_obj``/``check_admit_obj``) that
    derive the tenant — callers with a pod object should prefer those.
    """

    def __init__(
        self,
        policy: TenancyPolicy | None = None,
        controller: HealthController | None = None,
        *,
        capacity_per_tick: int = 256,
    ):
        self.policy = policy or TenancyPolicy()
        self.controller = controller or HealthController()
        if capacity_per_tick < 1:
            raise ValueError("capacity_per_tick must be >= 1")
        self.capacity_per_tick = capacity_per_tick
        # First-sight cushion: a tenant first seen mid-pressure gets a
        # small starter bucket instead of an instant reject (its first
        # refill lands at the next tick).
        self._starter = max(1.0, self.policy.burst_ticks)
        self._buckets: dict[str, float] = {}
        self._demand: dict[str, int] = {}     # try_admit calls this tick
        self._debt: dict[str, float] = {}
        self._admitted: dict[str, int] = {}   # cumulative, per tenant
        self._rejected: dict[str, int] = {}   # cumulative "tenant" rejects
        # Idle-tenant eviction: the working state (_buckets/_debt) is
        # bounded by ACTIVE tenants, not tenants-ever-seen —
        # with tenants derived from namespaces, namespace churn must
        # not grow tick()'s per-cycle work (run under _admit_lock, the
        # lock webhook threads contend on) forever.  A long-idle
        # tenant forfeits its banked burst and re-enters on the starter
        # cushion.  The cumulative _admitted/_rejected ledger is kept
        # (drill evidence; a few ints per tenant-ever-seen).
        self._last_active: dict[str, int] = {}
        self._tick_n = 0
        # Classes whose debt gauge is currently nonzero — zeroed when
        # their debt fully decays (entries are dropped from _debt, so
        # the gauge would otherwise freeze at the last nonzero value).
        self._debt_classes: set[str] = set()
        self._idle_evict_ticks = max(8, int(4 * self.policy.burst_ticks))
        self._admit_lock = threading.Lock()

    # ---- admission -----------------------------------------------------

    def try_admit(
        self, tenant: str, priority: int = 0, point: str = "coordinator"
    ) -> str | None:
        """None = admitted; else the rejection reason: ``"tenant"`` =
        over the tenant's fair share while the controller is under
        pressure, ``"cap"`` = the global hard queue bound (any tenant,
        any priority).  The loadshed priority floor does NOT run here
        (``floor=False``): under tenancy, shedding is proportional by
        tenant, and priority acts through preemption instead."""
        # Controller state is read through its own locked accessor BEFORE
        # taking ours: lock order is FairAdmission -> HealthController,
        # never the reverse (artifacts/lockgraph.json).
        enforcing = self.controller.current_state() != HEALTHY
        cls = self.policy.class_of(tenant)
        with self._admit_lock:
            self._demand[tenant] = self._demand.get(tenant, 0) + 1
            if enforcing:
                bucket = self._buckets.get(tenant, self._starter)
                if bucket < 1.0:
                    self._debt[tenant] = self._debt.get(tenant, 0.0) + 1.0
                    self._rejected[tenant] = self._rejected.get(tenant, 0) + 1
                    reason = "tenant"
                else:
                    reason = self.controller.try_admit(
                        priority, point, floor=False
                    )
                    if reason is None:
                        self._buckets[tenant] = bucket - 1.0
                        self._admitted[tenant] = (
                            self._admitted.get(tenant, 0) + 1
                        )
            else:
                reason = self.controller.try_admit(priority, point, floor=False)
                if reason is None:
                    self._admitted[tenant] = self._admitted.get(tenant, 0) + 1
        if reason is None:
            _ADMITTED.inc(tenant_class=cls)
        elif reason == "tenant":
            # "cap"/other reasons were already counted by the controller.
            _REJECTED.inc(point=point, reason="tenant")
        return reason

    def try_admit_obj(self, obj: dict, point: str = "coordinator") -> str | None:
        return self.try_admit(tenant_of_obj(obj), pod_priority_of(obj), point)

    def admit_obj(self, obj: dict, point: str = "coordinator") -> bool:
        """Boolean form for the webhook's 429 gate."""
        return self.try_admit_obj(obj, point) is None

    def admit(self, priority: int = 0, point: str = "coordinator") -> bool:
        """Legacy priority-only form (no object in hand): the caller
        could not name a tenant, so the pod draws from ``"default"``."""
        return self.try_admit("default", priority, point) is None

    def check_admit_obj(self, obj: dict, point: str = "coordinator") -> None:
        """``try_admit_obj`` that raises ``Overloaded`` (the
        ``submit_external`` form), carrying the real reason."""
        reason = self.try_admit_obj(obj, point)
        if reason is not None:
            raise Overloaded(self.controller.retry_after_s(), reason)

    def retry_after_s(self) -> float:
        return self.controller.retry_after_s()

    def bucket_level(self, tenant: str) -> float:
        """Current token balance of ``tenant``'s bucket (the starter
        cushion for a tenant not yet seen) — a cheap locked read for
        observability (the podtrace admit-span attribute), never an
        admission decision."""
        with self._admit_lock:
            return round(self._buckets.get(tenant, self._starter), 3)

    # ---- the per-cycle refill ------------------------------------------

    def tick(self, capacity: int | None = None) -> None:
        """Refill buckets once per scheduling cycle.

        ``capacity`` is this cycle's admit budget (the coordinator
        passes its batch size).  Active tenants — those that offered
        load since the last tick, or still carry debt — split it by
        weight; each bucket caps at ``burst_ticks`` ticks of that
        tenant's share, so an idle tenant banks a bounded burst, never
        an unbounded one.  Debt decays by the refill: a tenant whose
        rejections were transient returns to zero, one persistently
        over its share keeps a visible balance."""
        cap = float(capacity if capacity is not None else self.capacity_per_tick)
        per_class: dict[str, float] = {}
        with self._admit_lock:
            self._tick_n += 1
            active = sorted(
                set(t for t, d in self._demand.items() if d > 0)
                | set(t for t, d in self._debt.items() if d > 0)
            )
            total_w = sum(self.policy.weight_of(t) for t in active)
            for t in active:
                share = cap * self.policy.weight_of(t) / total_w
                burst = max(1.0, self.policy.burst_ticks * share)
                self._buckets[t] = min(
                    self._buckets.get(t, self._starter) + share, burst
                )
                debt = max(0.0, self._debt.get(t, 0.0) - share)
                if debt > 0.0:
                    self._debt[t] = debt
                else:
                    self._debt.pop(t, None)
                self._last_active[t] = self._tick_n
            self._demand = {}
            if self._tick_n % self._idle_evict_ticks == 0:
                horizon = self._tick_n - self._idle_evict_ticks
                stale = [
                    t for t, last in self._last_active.items()
                    if last <= horizon
                ]
                for t in stale:
                    del self._last_active[t]
                    self._buckets.pop(t, None)
                    self._debt.pop(t, None)
            for t, d in self._debt.items():
                c = self.policy.class_of(t)
                per_class[c] = per_class.get(c, 0.0) + d
            for c in self._debt_classes - set(per_class):
                per_class[c] = 0.0
            self._debt_classes = {c for c, d in per_class.items() if d > 0}
        for c, d in per_class.items():
            _DEBT.set(round(d, 3), tenant_class=c)

    # ---- evidence ------------------------------------------------------

    def counters(self) -> dict:
        """Cumulative per-tenant admit/reject snapshot (drill evidence;
        values are plain ints so the dict is JSON-ready)."""
        with self._admit_lock:
            return {
                "admitted": dict(self._admitted),
                "rejected": dict(self._rejected),
                "debt": {t: round(d, 3) for t, d in self._debt.items() if d},
            }
