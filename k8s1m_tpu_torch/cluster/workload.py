"""Synthetic pod workloads (port of the part of ``k8s1m_tpu/cluster/workload.py``
the port's paths use): the uniform pods the reference's make_pods floods
the cluster with, and the NodeAffinity, topology-spread and
(anti-)affinity shapes of BASELINE configs 2-4."""

from __future__ import annotations

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
