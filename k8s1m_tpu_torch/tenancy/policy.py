"""Tenancy policy: who a pod belongs to and what that tenant is owed.

The port's own copy of ``k8s1m_tpu/tenancy/policy.py``.

The reference schedules one undifferentiated pod queue; at "millions of
users" scale the queue is really thousands of tenants with conflicting
demand, and the admission chain the reference delegates to webhooks and
kube-apiserver priority-and-fairness (PAPER.md §1) has to answer a
different question: not "is the cluster overloaded" but "is THIS tenant
over its share".  This module is the pure-configuration half of that
answer:

- **tenant identity** — a pod's tenant is its namespace, unless the
  ``k8s1m.io/tenant`` label overrides it (the multi-namespace-tenant
  shape real multi-tenancy layers use).  Identity is derivable from the
  pod key alone for label-less fast-lane pods, so the hot intake path
  never decodes an object to find its tenant.
- **weights** — ``TenancyPolicy.weights`` maps tenant -> integer weight;
  unknown tenants get ``default_weight``.  A tenant's *fair share* of
  any contended capacity is ``weight / sum(weights of active tenants)``
  — the same proportional-share contract as WFQ / DRF, enforced by
  token buckets in ``tenancy/admission.py``.
- **classes** — metrics label tenants by *class* (``classes`` mapping,
  default ``w<weight>``), never by raw tenant name: per-tenant metric
  cardinality at thousands of tenants would melt the scrape path.
- **knobs** — preemption (minimum preemptor priority, how many failed
  waves before a pod may evict) and gang scheduling toggles, plus the
  token-bucket burst depth.

Everything here is a frozen dataclass of plain ints/strings: policy is
config, state lives in the admission controller.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Mapping

# Label keys (pod metadata.labels).  A pod carrying any of these falls
# off the native label-less fast lane into the full decode path — which
# is exactly where gang/priority handling lives, so the fast lane stays
# fast for the plain-pod firehose.
TENANT_LABEL = "k8s1m.io/tenant"
GANG_LABEL = "k8s1m.io/gang"
GANG_SIZE_LABEL = "k8s1m.io/gang-size"


def tenant_of_namespace(namespace: str, labels: Mapping[str, str] | None = None) -> str:
    """Tenant identity: the ``k8s1m.io/tenant`` label when present, else
    the namespace (the common one-namespace-per-tenant shape)."""
    if labels:
        t = labels.get(TENANT_LABEL)
        if t:
            return t
    return namespace or "default"


def tenant_of_obj(obj: dict) -> str:
    """Tenant of a pod API object dict (webhook/submit_external intake)."""
    meta = obj.get("metadata") or {}
    labels = meta.get("labels") or {}
    return tenant_of_namespace(meta.get("namespace") or "default", labels)


def tenant_of_pod(pod) -> str:
    """Tenant of a decoded PodInfo."""
    return tenant_of_namespace(pod.namespace, pod.labels)


def tenant_of_key(key_str: str) -> str:
    """Tenant of a ``<ns>/<name>`` pod key — the fast-lane form (label-
    less by construction, so the namespace IS the tenant)."""
    ns, _, _ = key_str.partition("/")
    return ns or "default"


def gang_of_labels(labels: Mapping[str, str], namespace: str) -> tuple[str, int] | None:
    """(gang id, declared size) from pod labels, or None.

    The gang id is namespace-qualified so two tenants' ``web`` gangs
    never merge.  A malformed or <=1 size means "not a gang" — degrade
    to plain scheduling rather than wedging the pod in staging."""
    name = labels.get(GANG_LABEL)
    if not name:
        return None
    try:
        size = int(labels.get(GANG_SIZE_LABEL, "0"))
    except (TypeError, ValueError):
        return None
    if size <= 1:
        return None
    return f"{namespace}/{name}", size


@dataclasses.dataclass(frozen=True)
class TenancyPolicy:
    """Operator knobs for the tenancy subsystem (see README
    "Multi-tenant fairness, preemption & gangs").

    ``weights`` are integers >= 1; a tenant's fair share of admission
    capacity under pressure is ``weight / sum(active weights)``.
    ``burst_ticks`` sizes each token bucket in ticks of fair share: a
    tenant idle for a while may burst up to ``burst_ticks`` ticks' worth
    of its share before the bucket gates it — absorbing diurnal ramp-up
    without letting a flash crowd starve anyone.
    """

    weights: Mapping[str, int] = dataclasses.field(default_factory=dict)
    default_weight: int = 1
    # Metrics label tenants by class, never by name (cardinality).
    classes: Mapping[str, str] = dataclasses.field(default_factory=dict)
    burst_ticks: float = 4.0
    # Preemption: only pods at/above this priority may evict, and only
    # after this many failed waves (1 = the first no-feasible-row wave).
    preempt_enabled: bool = True
    preempt_min_priority: int = 1
    preempt_after_attempts: int = 1
    # Gang scheduling (all-or-none pod groups riding one wave).
    gang_enabled: bool = True
    # Drill/test evidence: record a replayable pre-state snapshot per
    # preemption in Coordinator.preempt_log.  Off in production — the
    # snapshot is O(bound pods on candidate nodes) per event.
    log_preemptions: bool = False

    def __post_init__(self):
        if self.default_weight < 1:
            raise ValueError("default_weight must be >= 1")
        for t, w in self.weights.items():
            if int(w) < 1:
                raise ValueError(f"weight for tenant {t!r} must be >= 1")
        if self.burst_ticks < 1.0:
            raise ValueError("burst_ticks must be >= 1.0")
        if self.preempt_after_attempts < 1:
            raise ValueError("preempt_after_attempts must be >= 1")

    def weight_of(self, tenant: str) -> int:
        return max(1, int(self.weights.get(tenant, self.default_weight)))

    def class_of(self, tenant: str) -> str:
        """Bounded-cardinality metrics class for a tenant: the explicit
        class when configured, else ``w<weight>`` (tenants of equal
        weight share a class by construction)."""
        c = self.classes.get(tenant)
        if c:
            return c
        return f"w{self.weight_of(tenant)}"

    def to_json(self) -> str:
        return json.dumps({
            "weights": dict(self.weights),
            "default_weight": self.default_weight,
            "classes": dict(self.classes),
            "burst_ticks": self.burst_ticks,
            "preempt_enabled": self.preempt_enabled,
            "preempt_min_priority": self.preempt_min_priority,
            "preempt_after_attempts": self.preempt_after_attempts,
            "gang_enabled": self.gang_enabled,
        }, separators=(",", ":"))

    @classmethod
    def from_arg(cls, arg: str) -> "TenancyPolicy":
        """Inline JSON or ``@path`` (the faultline FaultPlan.from_arg
        convention, so drill/bench flags compose the same way)."""
        if arg.startswith("@"):
            with open(arg[1:]) as f:
                obj = json.load(f)
        else:
            obj = json.loads(arg)
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in obj.items() if k in known})
