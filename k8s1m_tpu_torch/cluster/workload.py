"""Synthetic pod workloads (port of the part of ``k8s1m_tpu/cluster/workload.py``
the port's paths use): the uniform pods the reference's make_pods floods
the cluster with, the NodeAffinity, topology-spread and (anti-)affinity
shapes of BASELINE configs 2-4, and the tenant stream of ``sched_bench
--tenants``.

``zipf_weights`` / ``tenant_assignments`` turn a pod-index sequence into a
seed-deterministic tenant stream with zipf-skewed tenant sizes and three
arrival shapes — ``steady`` (the mix is constant), ``diurnal`` (each
tenant's offered rate follows a phase-shifted day curve), ``flash``
(tenant 0 flash-crowds to 10x its weight for the middle fifth of the
sequence).  The paced producer emits pods in index order, so position in
the sequence is arrival time and the schedules reproduce exactly by seed.
"""

from __future__ import annotations

import math
import random

from k8s1m_tpu_torch.config import (
    SEL_OP_IN,
    SEL_OP_NOT_IN,
    SPREAD_DO_NOT_SCHEDULE,
    TOPO_HOSTNAME,
    TOPO_ZONE,
)
from k8s1m_tpu_torch.snapshot.constraints import ConstraintTracker
from k8s1m_tpu_torch.snapshot.node_table import REGION_LABEL, ZONE_LABEL
from k8s1m_tpu_torch.snapshot.pod_encoding import (
    AffinityTermRef,
    NodeSelectorTerm,
    PodInfo,
    PreferredSchedulingTerm,
    SelectorRequirement,
    SpreadConstraintRef,
)

TENANT_SCHEDULES = ("steady", "diurnal", "flash")


def zipf_weights(tenants: int, skew: float = 1.0) -> list[float]:
    """Zipf-skewed tenant sizes: weight of tenant t is 1/(t+1)^skew,
    normalized to sum 1 (skew 0 is uniform)."""
    if tenants < 1:
        raise ValueError("tenants must be >= 1")
    w = [1.0 / (t + 1) ** skew for t in range(tenants)]
    s = sum(w)
    return [x / s for x in w]


def tenant_rate_multipliers(schedule: str, frac: float, tenants: int) -> list[float]:
    """Per-tenant offered-rate multiplier at position ``frac`` in [0, 1)
    of the sequence (multiplies the zipf base weight): ``steady`` 1.0;
    ``diurnal`` 1 + 0.8*sin(2*pi*(2*frac + t/T)), two phase-shifted days;
    ``flash`` 10x for tenant 0 while frac is in [0.4, 0.6)."""
    if schedule == "steady":
        return [1.0] * tenants
    if schedule == "diurnal":
        return [
            1.0 + 0.8 * math.sin(2.0 * math.pi * (2.0 * frac + t / tenants))
            for t in range(tenants)
        ]
    if schedule == "flash":
        m = [1.0] * tenants
        if 0.4 <= frac < 0.6:
            m[0] = 10.0
        return m
    raise ValueError(f"unknown tenant schedule {schedule!r} "
                     f"(want one of {TENANT_SCHEDULES})")


def tenant_assignments(count: int, tenants: int, *, skew: float = 1.0, seed: int = 0,
                       schedule: str = "steady") -> list[int]:
    """Tenant id per pod index, deterministic by (seed, shape args).  The
    mixture is re-derived every 256 pods and each block is ONE weighted
    draw (``random.choices`` rebuilds its cumulative table per call)."""
    base = zipf_weights(tenants, skew)
    rng = random.Random(seed ^ 0x7E4A47)
    ids = list(range(tenants))
    out: list[int] = []
    step = 256
    for off in range(0, count, step):
        frac = off / max(count, 1)
        mult = tenant_rate_multipliers(schedule, frac, tenants)
        weights = [b * m for b, m in zip(base, mult)]
        out.extend(rng.choices(ids, weights=weights, k=min(step, count - off)))
    return out


def uniform_pods(
    count: int,
    *,
    cpu_milli: int = 100,
    mem_kib: int = 200 << 10,
    name_prefix: str = "pod",
    namespace: str = "default",
) -> list[PodInfo]:
    return [
        PodInfo(
            name=f"{name_prefix}-{i}",
            namespace=namespace,
            cpu_milli=cpu_milli,
            mem_kib=mem_kib,
        )
        for i in range(count)
    ]


def node_affinity_pods(
    count: int,
    *,
    zones: int = 64,
    regions: int = 8,
    cpu_milli: int = 100,
    mem_kib: int = 200 << 10,
    name_prefix: str = "aff-pod",
    namespace: str = "default",
) -> list[PodInfo]:
    """Pods exercising NodeAffinity against KWOK node labels: each pod
    REQUIRES one of two zones (In) while excluding one region (NotIn),
    and PREFERS its primary zone (weight 2) — BASELINE config 2."""
    out = []
    for i in range(count):
        z1, z2 = i % zones, (i + zones // 2) % zones
        out.append(
            PodInfo(
                name=f"{name_prefix}-{i}",
                namespace=namespace,
                cpu_milli=cpu_milli,
                mem_kib=mem_kib,
                required_terms=[
                    NodeSelectorTerm([
                        SelectorRequirement(
                            ZONE_LABEL, SEL_OP_IN, [f"zone-{z1}", f"zone-{z2}"]
                        ),
                        SelectorRequirement(
                            REGION_LABEL, SEL_OP_NOT_IN,
                            [f"region-{(i + 1) % regions}"],
                        ),
                    ])
                ],
                preferred_terms=[
                    PreferredSchedulingTerm(
                        2,
                        NodeSelectorTerm([
                            SelectorRequirement(ZONE_LABEL, SEL_OP_IN, [f"zone-{z1}"])
                        ]),
                    )
                ],
            )
        )
    return out


def spread_deployment(
    tracker: ConstraintTracker,
    name: str,
    replicas: int,
    *,
    namespace: str = "default",
    topo: int = TOPO_ZONE,
    max_skew: int = 1,
    mode: int = SPREAD_DO_NOT_SCHEDULE,
    cpu_milli: int = 100,
    mem_kib: int = 200 << 10,
    start: int = 0,
) -> list[PodInfo]:
    """Replicas of a Deployment with a topologySpreadConstraint on its own
    ``app=<name>`` selector — BASELINE config 3's workload shape."""
    selector = {"app": name}
    cid = tracker.spread_slot(namespace, selector, topo)
    pods = []
    for i in range(start, start + replicas):
        labels = dict(selector)
        pods.append(PodInfo(
            name=f"{name}-{i}", namespace=namespace,
            cpu_milli=cpu_milli, mem_kib=mem_kib, labels=labels,
            spread_refs=[SpreadConstraintRef(cid, topo, max_skew, mode, True)],
            spread_incs=tracker.spread_matches(namespace, labels),
            ipa_incs=tracker.affinity_matches(namespace, labels),
        ))
    return pods


def affinity_deployment(
    tracker: ConstraintTracker,
    name: str,
    replicas: int,
    *,
    namespace: str = "default",
    target: dict[str, str] | None = None,
    topo: int = TOPO_HOSTNAME,
    required: bool = True,
    anti: bool = False,
    weight: int = 1,
    cpu_milli: int = 100,
    mem_kib: int = 200 << 10,
    start: int = 0,
) -> list[PodInfo]:
    """Replicas carrying one (anti)affinity term — config 4's shape.
    ``target`` defaults to the deployment's own ``app=<name>`` selector."""
    selector = dict(target) if target is not None else {"app": name}
    tid = tracker.affinity_slot(namespace, selector, topo)
    pods = []
    for i in range(start, start + replicas):
        labels = {"app": name}
        pods.append(PodInfo(
            name=f"{name}-{i}", namespace=namespace,
            cpu_milli=cpu_milli, mem_kib=mem_kib, labels=labels,
            affinity_refs=[AffinityTermRef(
                tid, topo, required, anti, weight,
                self_match=ConstraintTracker.selector_matches(selector, labels),
            )],
            spread_incs=tracker.spread_matches(namespace, labels),
            ipa_incs=tracker.affinity_matches(namespace, labels),
        ))
    return pods
