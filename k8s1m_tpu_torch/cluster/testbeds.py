"""Fleets and pod mixes that hold the kernel's affinity and constraint
stages against their plain versions (``chip_smoke.py`` phases 3b/3c and
``tests/test_torch_gpu.py``).

- ``labeled_fleet``: tier/disk/gpu labels and a numeric ``gen`` label
  beyond 2^24 (an f32 would round it), invalid tail rows;
- ``affinity_pods``: nodeSelector, all six selector ops, OR of terms,
  preferred weights, an unsatisfiable selector, empty terms, plain pods
  mixed in;
- ``constraint_fleet``: nodes over zones/regions with rows missing the
  zone or the region label (domain 0);
- ``constraint_pods``: zone- and region-keyed spread, required affinity
  (its first replica bootstraps), required anti-affinity, preferred terms
  — and, with ``with_selectors``, NodeAffinity terms on the same pods, so
  one launch runs both stages.

Everything is made from ``seed`` with numpy; the shapes follow
tests/test_pallas_topk.py's labeled and constraint fleets.
"""

from __future__ import annotations

import numpy as np

from k8s1m_tpu_torch.cluster.workload import affinity_deployment, spread_deployment
from k8s1m_tpu_torch.config import (
    SEL_OP_DOES_NOT_EXIST,
    SEL_OP_EXISTS,
    SEL_OP_GT,
    SEL_OP_IN,
    SEL_OP_LT,
    SEL_OP_NOT_IN,
    TOPO_REGION,
    TOPO_ZONE,
    TableSpec,
)
from k8s1m_tpu_torch.snapshot.constraints import ConstraintTracker
from k8s1m_tpu_torch.snapshot.node_table import (
    REGION_LABEL,
    ZONE_LABEL,
    NodeInfo,
    NodeTableHost,
)
from k8s1m_tpu_torch.snapshot.pod_encoding import (
    NodeSelectorTerm,
    PodInfo,
    PreferredSchedulingTerm,
    SelectorRequirement,
)

TIERS = ("web", "db", "cache")
GEN_BASE = 100_000_000      # > 2^24
GEN_STEP = 7_919


def labeled_fleet(n: int, *, seed: int = 0, invalid_tail: int = 8):
    """(TableSpec, NodeTableHost) of ``n`` rows; the last ``invalid_tail``
    rows hold no node."""
    rng = np.random.default_rng(seed)
    spec = TableSpec(max_nodes=n, max_taint_ids=16)
    host = NodeTableHost(spec)
    live = n - invalid_tail
    cpu = rng.integers(500, 8000, live)
    mem = rng.integers(1 << 20, 16 << 20, live)
    for i in range(live):
        labels = {
            "tier": TIERS[i % 3],
            "disk": ("ssd", "hdd")[i % 2],
            "gen": str(GEN_BASE + i * GEN_STEP),
        }
        if i % 4 == 0:
            labels["gpu"] = "true"
        host.upsert(NodeInfo(f"node-{i}", cpu_milli=int(cpu[i]), mem_kib=int(mem[i]),
                             pods=8, labels=labels))
    return spec, host


def _req(key, op, values=()):
    return SelectorRequirement(key, op, list(values))


def affinity_pods(count: int, n: int) -> list[PodInfo]:
    """``count`` pods cycling through every selector shape; the Gt/Lt
    window is placed inside a fleet of ``n`` rows."""
    lo = GEN_BASE + (n // 3) * GEN_STEP
    hi = lo + (n // 5) * GEN_STEP
    shapes = [
        dict(node_selector={"tier": "db"}),
        dict(required_terms=[NodeSelectorTerm([_req("tier", SEL_OP_IN, ["web", "cache"])])]),
        dict(required_terms=[NodeSelectorTerm([
            _req("disk", SEL_OP_NOT_IN, ["hdd"]), _req("gpu", SEL_OP_EXISTS)])]),
        dict(required_terms=[
            NodeSelectorTerm([_req("tier", SEL_OP_IN, ["db"])]),
            NodeSelectorTerm([_req("gpu", SEL_OP_EXISTS)])]),
        dict(required_terms=[NodeSelectorTerm([
            _req("gen", SEL_OP_GT, [str(lo)]), _req("gen", SEL_OP_LT, [str(hi)])])]),
        dict(required_terms=[NodeSelectorTerm([_req("gpu", SEL_OP_DOES_NOT_EXIST)])]),
        dict(node_selector={"tier": "never-seen"}),
        dict(preferred_terms=[
            PreferredSchedulingTerm(3, NodeSelectorTerm([_req("tier", SEL_OP_IN, ["db"])])),
            PreferredSchedulingTerm(1, NodeSelectorTerm([_req("disk", SEL_OP_IN, ["ssd"])]))]),
        dict(node_selector={"disk": "ssd"},
             required_terms=[NodeSelectorTerm([_req("gen", SEL_OP_LT, ["x"])]),
                             NodeSelectorTerm([_req("tier", SEL_OP_NOT_IN, ["web"])])],
             preferred_terms=[PreferredSchedulingTerm(
                 5, NodeSelectorTerm([_req("gpu", SEL_OP_DOES_NOT_EXIST)]))]),
        # Empty terms: a required term without expressions is dead (alone,
        # nothing passes); an empty preferred term adds no weight.
        dict(required_terms=[NodeSelectorTerm([])]),
        dict(required_terms=[NodeSelectorTerm([]),
                             NodeSelectorTerm([_req("tier", SEL_OP_IN, ["cache"])])],
             preferred_terms=[
                 PreferredSchedulingTerm(4, NodeSelectorTerm([])),
                 PreferredSchedulingTerm(1, NodeSelectorTerm([_req("gpu", SEL_OP_EXISTS)]))]),
        dict(),                                   # a plain pod
    ]
    return [
        PodInfo(f"aff-{i}", cpu_milli=100 + 7 * (i % 13), mem_kib=(128 + i % 50) << 10,
                **shapes[i % len(shapes)])
        for i in range(count)
    ]


def constraint_fleet(n: int, *, zones: int = 5, regions: int = 3):
    """(TableSpec, NodeTableHost): ``n`` nodes over ``zones`` zones and
    ``regions`` regions; rows i % 11 == 7 lack the zone label, rows
    i % 13 == 5 the region label."""
    spec = TableSpec(max_nodes=n, max_zones=8, max_regions=4,
                     spread_slots=8, affinity_slots=8)
    host = NodeTableHost(spec)
    for i in range(n):
        labels = {}
        if i % 11 != 7:
            labels[ZONE_LABEL] = f"z{i % zones}"
        if i % 13 != 5:
            labels[REGION_LABEL] = f"r{i % regions}"
        host.upsert(NodeInfo(name=f"n{i}", cpu_milli=64_000, mem_kib=1 << 26, pods=64,
                             labels=labels))
    return spec, host


def constraint_pods(tracker: ConstraintTracker, count: int, *, seed: int = 0,
                    with_selectors: bool = False) -> list[PodInfo]:
    """``count`` constrained pods in a seed-shuffled mix of spread, required
    affinity, required anti-affinity and preferred-term deployments."""
    per = max(1, count // 5)
    pods = (
        spread_deployment(tracker, "sp-z", per, topo=TOPO_ZONE)
        + spread_deployment(tracker, "sp-r", per, topo=TOPO_REGION, max_skew=2)
        + affinity_deployment(tracker, "aff", per, anti=False, required=True)
        + affinity_deployment(tracker, "anti", per, anti=True, required=True)
        + affinity_deployment(tracker, "pref", count - 4 * per, required=False, weight=3)
    )
    order = np.random.default_rng(seed).permutation(len(pods))
    pods = [pods[i] for i in order]
    if with_selectors:
        for i, pod in enumerate(pods):
            if i % 3 == 0:
                pod.required_terms = [NodeSelectorTerm([_req(ZONE_LABEL, SEL_OP_NOT_IN, ["z1"])])]
            if i % 4 == 1:
                pod.preferred_terms = [PreferredSchedulingTerm(
                    2, NodeSelectorTerm([_req(REGION_LABEL, SEL_OP_IN, ["r0"])]))]
    return pods
