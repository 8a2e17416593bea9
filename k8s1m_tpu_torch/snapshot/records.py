"""Host-side records of nodes and pods, and the helpers that read them.

The node and pod records (``NodeInfo``, ``PodInfo`` and their parts), the
constraint interner (``ConstraintTracker``) and ``pod_priority_of`` are
plain Python: ``control/objects.py`` encodes and decodes Kubernetes
objects with them, and the load tools (``tools/make_nodes.py``,
``make_pods.py``, ``lease_flood.py``) build objects from them, so neither
imports torch or numpy.  ``snapshot/node_table.py``,
``snapshot/pod_encoding.py``, ``snapshot/constraints.py`` and
``ops/priority.py`` re-export them under their JAX package paths.
"""

from __future__ import annotations

import dataclasses

from k8s1m_tpu_torch.config import (
    DEFAULT_SCHEDULER,
    EFFECT_NO_SCHEDULE,
    EFFECT_NONE,
    SPREAD_DO_NOT_SCHEDULE,
    TOL_OP_EXISTS,
    TOPO_HOSTNAME,
    TableSpec,
)


UNSCHEDULABLE_TAINT_KEY = "node.kubernetes.io/unschedulable"
ZONE_LABEL = "topology.kubernetes.io/zone"
REGION_LABEL = "topology.kubernetes.io/region"
HOSTNAME_LABEL = "kubernetes.io/hostname"


@dataclasses.dataclass
class Taint:
    key: str
    value: str = ""
    effect: int = EFFECT_NO_SCHEDULE


@dataclasses.dataclass
class NodeInfo:
    """Host-side description of one node (the parsed KWOK/real Node object)."""

    name: str
    cpu_milli: int = 4000
    mem_kib: int = 8 << 20          # 8 GiB
    pods: int = 110
    labels: dict[str, str] = dataclasses.field(default_factory=dict)
    taints: list[Taint] = dataclasses.field(default_factory=list)
    unschedulable: bool = False


@dataclasses.dataclass
class Toleration:
    key: str = ""                  # "" tolerates every key (with op Exists)
    op: int = TOL_OP_EXISTS
    value: str = ""
    effect: int = EFFECT_NONE      # EFFECT_NONE tolerates every effect


@dataclasses.dataclass
class SelectorRequirement:
    key: str
    op: int                        # SEL_OP_*
    values: list[str] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class NodeSelectorTerm:
    match_expressions: list[SelectorRequirement] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class PreferredSchedulingTerm:
    weight: int
    term: NodeSelectorTerm


@dataclasses.dataclass
class SpreadConstraintRef:
    """A pod's reference to an interned topologySpreadConstraint slot."""

    cid: int
    topo: int
    max_skew: int = 1
    mode: int = SPREAD_DO_NOT_SCHEDULE
    self_match: bool = True


@dataclasses.dataclass
class AffinityTermRef:
    """A pod's reference to an interned (anti)affinity term slot."""

    tid: int
    topo: int = TOPO_HOSTNAME
    required: bool = False
    anti: bool = False
    weight: int = 1
    self_match: bool = False


@dataclasses.dataclass
class PodInfo:
    """Host-side description of one pending pod."""

    name: str
    namespace: str = "default"
    cpu_milli: int = 100
    mem_kib: int = 200 << 10       # 200 MiB
    scheduler_name: str = DEFAULT_SCHEDULER
    node_name: str | None = None
    node_selector: dict[str, str] = dataclasses.field(default_factory=dict)
    tolerations: list[Toleration] = dataclasses.field(default_factory=list)
    required_terms: list[NodeSelectorTerm] = dataclasses.field(default_factory=list)
    preferred_terms: list[PreferredSchedulingTerm] = dataclasses.field(default_factory=list)
    spread_refs: list[SpreadConstraintRef] = dataclasses.field(default_factory=list)
    affinity_refs: list[AffinityTermRef] = dataclasses.field(default_factory=list)
    spread_incs: list[tuple[int, int]] = dataclasses.field(default_factory=list)
    ipa_incs: list[tuple[int, int]] = dataclasses.field(default_factory=list)
    labels: dict[str, str] = dataclasses.field(default_factory=dict)
    priority: int = 0

    @property
    def key(self) -> str:
        return f"{self.namespace}/{self.name}"


@dataclasses.dataclass(frozen=True)
class SelectorKey:
    """Identity of a constraint: namespace + matchLabels + topology key."""

    namespace: str
    match_labels: tuple[tuple[str, str], ...]
    topo: int


class ConstraintTracker:
    """Interns spread constraints and affinity terms into device slots
    (a small fixed pool: TableSpec.spread_slots/affinity_slots)."""

    def __init__(self, spec: TableSpec) -> None:
        self.spec = spec
        self._spread: dict[SelectorKey, int] = {}
        self._affinity: dict[SelectorKey, int] = {}

    @staticmethod
    def _key(namespace: str, selector: dict[str, str], topo: int) -> SelectorKey:
        return SelectorKey(namespace, tuple(sorted(selector.items())), topo)

    def spread_slot(self, namespace: str, selector: dict[str, str], topo: int) -> int:
        key = self._key(namespace, selector, topo)
        slot = self._spread.get(key)
        if slot is None:
            slot = len(self._spread)
            if slot >= self.spec.spread_slots:
                raise ValueError("out of spread constraint slots; grow TableSpec.spread_slots")
            self._spread[key] = slot
        return slot

    def affinity_slot(self, namespace: str, selector: dict[str, str], topo: int) -> int:
        key = self._key(namespace, selector, topo)
        slot = self._affinity.get(key)
        if slot is None:
            slot = len(self._affinity)
            if slot >= self.spec.affinity_slots:
                raise ValueError("out of affinity term slots; grow TableSpec.affinity_slots")
            self._affinity[key] = slot
        return slot

    @staticmethod
    def selector_matches(selector: dict[str, str], labels: dict[str, str]) -> bool:
        return all(labels.get(k) == v for k, v in selector.items())

    def spread_matches(self, namespace: str, labels: dict[str, str]):
        """(slot, topo) of every interned spread constraint matching a pod."""
        return [
            (slot, key.topo)
            for key, slot in self._spread.items()
            if key.namespace == namespace
            and self.selector_matches(dict(key.match_labels), labels)
        ]

    def affinity_matches(self, namespace: str, labels: dict[str, str]):
        return [
            (slot, key.topo)
            for key, slot in self._affinity.items()
            if key.namespace == namespace
            and self.selector_matches(dict(key.match_labels), labels)
        ]


def pod_priority_of(obj: dict) -> int:
    """``spec.priority`` of a pod API object dict (0 when unset or not an
    integer) — the pod's PriorityClass value, never encoded for the
    device."""
    try:
        return int((obj.get("spec") or {}).get("priority") or 0)
    except (TypeError, ValueError, AttributeError):
        return 0
