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
  one launch runs both stages;
- ``wide_fleet`` / ``wide_pods``: the shapes past the fused kernel's
  fast paths (query keys past its shared resolve table, In/NotIn sets
  past its registers, preferred terms past its masks, rows with more
  taints than it stages and taint ids past its register bits), for any
  ``PodSpec`` query_keys/aff_values/pref_terms and ``TableSpec``
  taint_slots/max_taint_ids.

Everything is made from ``seed`` with numpy; the shapes follow
tests/test_pallas_topk.py's labeled and constraint fleets.
"""

from __future__ import annotations

import numpy as np

from k8s1m_tpu_torch.cluster.workload import affinity_deployment, spread_deployment
from k8s1m_tpu_torch.config import (
    EFFECT_NO_EXECUTE,
    EFFECT_NO_SCHEDULE,
    EFFECT_PREFER_NO_SCHEDULE,
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
from k8s1m_tpu_torch.snapshot.interning import numeric_of
from k8s1m_tpu_torch.snapshot.pod_encoding import (
    NodeSelectorTerm,
    PodInfo,
    PreferredSchedulingTerm,
    SelectorRequirement,
    Toleration,
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


# ---- wide shapes ---------------------------------------------------------

WIDE_KEYS = 1100         # label-key pool of wide_fleet: room for 1,024 query keys
WIDE_VALUES = 40         # distinct numeric label values per key

# (query_keys, aff_values, pref_terms, taint_slots, max_taint_ids): the
# default PodSpec/TableSpec point, each dimension alone past the fused
# kernel's fast paths (16 resolved keys, 8 register values, 4 register
# preferred terms, 16 staged taints, 128 register tolerated bits), and all
# of them at once.
WIDE_SWEEP = (
    (1, 8, 4, 8, 128), (16, 8, 4, 8, 128), (17, 8, 4, 8, 128), (80, 8, 4, 8, 128),
    (1024, 8, 4, 8, 128),
    (16, 9, 4, 8, 128), (16, 32, 4, 8, 128),
    (16, 8, 5, 8, 128), (16, 8, 16, 8, 128),
    (16, 8, 4, 16, 128), (16, 8, 4, 17, 128), (16, 8, 4, 32, 128),
    (16, 8, 4, 8, 129), (16, 8, 4, 8, 1024),
    (1024, 32, 16, 32, 1024),
)


def _wide_taint_effect(j: int) -> int:
    """8% of the taint triples hard (NoSchedule, NoExecute), the rest soft."""
    hard = (EFFECT_NO_SCHEDULE, EFFECT_NO_EXECUTE)
    return hard[j % 25] if j % 25 < len(hard) else EFFECT_PREFER_NO_SCHEDULE


def wide_fleet(host, *, seed: int = 0, invalid_tail: int = 8):
    """Fill an empty ``NodeTableHost`` (the port's or the JAX package's:
    the same attributes) with every row but the last ``invalid_tail``:
    each row carries ``label_slots - 1`` keys of a ``WIDE_KEYS`` pool with
    numeric values, rows i % 5 == 0 repeat slot 0's key with another value
    in the last slot (the last matching slot wins), and row i fills
    i % (taint_slots + 1) taint slots with ids over the whole
    ``max_taint_ids`` range (8% of the triples hard).  Columns are written
    with numpy, as ``populate_kwok_nodes`` does.  Returns the host."""
    spec = host.spec
    v = host.vocab
    n = spec.max_nodes
    live = n - invalid_tail
    rng = np.random.default_rng(seed)
    rows = host.alloc_rows([f"wide-{i}" for i in range(live)])
    host.cpu_alloc[rows] = rng.integers(2000, 16000, live)
    host.mem_alloc[rows] = rng.integers(4 << 20, 32 << 20, live)
    host.pods_alloc[rows] = 32
    host.cpu_req[rows] = rng.integers(0, 1500, live)
    host.name_id[rows] = np.fromiter((v.node_names.intern(f"wide-{i}") for i in range(live)),
                                     np.int32, live)

    key_ids = np.array([v.label_keys.intern(f"wk{j:04d}") for j in range(WIDE_KEYS)], np.int32)
    vals = [str(100 + x) for x in range(WIDE_VALUES)]
    val_ids = np.array([v.label_values.intern(x) for x in vals], np.int32)
    val_nums = np.array([numeric_of(x) for x in vals], np.int32)
    slots = spec.label_slots
    stride = WIDE_KEYS // slots
    i = np.arange(live)
    for s_ in range(slots - 1):
        kj = (i * 3 + s_ * stride) % WIDE_KEYS
        vj = (i * 7 + s_ * 11) % WIDE_VALUES
        host.label_key[rows, s_] = key_ids[kj]
        host.label_val[rows, s_] = val_ids[vj]
        host.label_num[rows, s_] = val_nums[vj]
    dup = rows[i % 5 == 0]
    host.label_key[dup, slots - 1] = host.label_key[dup, 0]
    vj = (i[i % 5 == 0] + 17) % WIDE_VALUES
    host.label_val[dup, slots - 1] = val_ids[vj]
    host.label_num[dup, slots - 1] = val_nums[vj]

    m = spec.max_taint_ids
    ts = spec.taint_slots
    tids = np.array([v.taints.intern((f"wt{j:05d}", "", _wide_taint_effect(j)))
                     for j in range(m - 1)], np.int64)
    effs = np.array([_wide_taint_effect(j) for j in range(m - 1)], np.int32)
    if tids.max(initial=0) >= m:
        raise ValueError("distinct taint triples overflow TableSpec.max_taint_ids")
    count = i % (ts + 1)
    for t in range(ts):
        on = count > t
        j = (i[on] * 13 + t * 7) % (m - 1)
        host.taint_id[rows[on], t] = tids[j]
        host.taint_effect[rows[on], t] = effs[j]
    return host


def wide_pods(count: int, *, query_keys: int, values: int, pref_terms: int,
              max_taint_ids: int, seed: int = 0) -> list[PodInfo]:
    """``count`` pods for a ``PodSpec(query_keys, aff_values=values,
    pref_terms=pref_terms, aff_terms >= 2, aff_exprs >= 2)`` over
    ``wide_fleet``: together they reference up to ``query_keys - 1``
    distinct keys (so the late query indices are in use), In/NotIn sets of
    exactly ``values`` values, up to ``pref_terms`` preferred terms, and
    tolerations of four soft and two hard taint ids spread over
    ``max_taint_ids`` (past id 127 when there is room).  With
    ``query_keys == 1`` no pod has a selector."""
    rng = np.random.default_rng(seed)
    usable = min(query_keys - 1, WIDE_KEYS)     # query index 0 is "no key"

    def key(x: int) -> str:
        # ``usable`` distinct keys spread over the pool.
        return f"wk{(x % usable) * (WIDE_KEYS // usable):04d}"

    def vset(x: int) -> list[str]:
        return [str(100 + (x + y) % (WIDE_VALUES + 8)) for y in range(values)]

    pods = []
    for p in range(count):
        kw = {}
        if usable > 0:
            a, b = key(p), key(p * 7 + 3)
            shape = p % 6
            if shape == 0:
                kw["node_selector"] = {a: str(100 + p % WIDE_VALUES)}
            elif shape == 1:
                kw["required_terms"] = [NodeSelectorTerm([
                    _req(a, SEL_OP_IN, vset(p)), _req(b, SEL_OP_NOT_IN, vset(p + 5))])]
            elif shape == 2:
                kw["required_terms"] = [NodeSelectorTerm([_req(a, SEL_OP_EXISTS)]),
                                        NodeSelectorTerm([_req(b, SEL_OP_GT, ["118"])])]
            elif shape == 3:
                kw["required_terms"] = [NodeSelectorTerm([
                    _req(a, SEL_OP_LT, ["130"]), _req(b, SEL_OP_DOES_NOT_EXIST)])]
            else:
                kw["preferred_terms"] = [
                    PreferredSchedulingTerm(1 + (p + x) % 9, NodeSelectorTerm([
                        _req(key(p * 3 + x), SEL_OP_IN if x % 2 == 0 else SEL_OP_NOT_IN,
                             vset(p + x))]))
                    for x in range(pref_terms)]
                if shape == 5:
                    kw["required_terms"] = [NodeSelectorTerm([_req(b, SEL_OP_NOT_IN, vset(p))])]
        room = max_taint_ids - 1
        soft = [int(x) for x in rng.integers(0, room, 4)]
        hard = [25 * int(rng.integers(0, max(room // 25, 1))) + y for y in (0, 1)]
        tol = [Toleration(key=f"wt{j:05d}") for j in soft + hard if j < room]
        pods.append(PodInfo(f"wide-{p}", cpu_milli=100 + 7 * (p % 13),
                            mem_kib=(128 + p % 50) << 10, tolerations=tol, **kw))
    return pods
