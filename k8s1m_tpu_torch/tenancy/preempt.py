"""Priority preemption: victim selection as a pure, replayable function.

The port's own copy of ``k8s1m_tpu/tenancy/preempt.py``.

The reference cluster leaves preemption to the upstream scheduler's
PostFilter; here the coordinator owns the whole evict-and-rebind path,
so the selection logic must be a pure function of the host mirror — the
drill replays it against a frozen snapshot and asserts the stored bytes
byte-identical (the same contract as the breaker's oracle fallback,
tools/overload_drill.py phase 4).

Selection contract (documented order, gated by tests):

1. A node already feasible for the pod WITHOUT eviction means no
   preemption (``None``): the pod simply hasn't met its row in a
   sampled score window yet — retrying is cheaper than evicting.
2. Per candidate node, victims are considered **lowest priority first;
   at equal priority, other-tenant pods before the preemptor's own
   tenant (same-tenant-last); then newest bind first** — and only pods
   strictly below the preemptor's priority are evictable.  Victims are
   taken greedily until the node turns feasible.
3. Among nodes that CAN be made feasible, pick the one needing the
   fewest victims; break ties by the lowest maximum victim priority
   (disturb the least important work), then by the lowest row (the
   device path's earlier-index rule).

Eviction itself lives in the coordinator (store CAS + the pipedream
dirty-row/quarantine machinery); this module never touches state.
"""

from __future__ import annotations

import dataclasses

from k8s1m_tpu_torch.obs.metrics import Counter
from k8s1m_tpu_torch.oracle import oracle_feasible

_EVICTIONS = Counter(
    "preemption_evictions_total",
    "Bound pods evicted (CAS'd back to pending and requeued) to make "
    "room for a higher-priority pod",
    (),
)


def note_eviction() -> None:
    """Counted at the coordinator's eviction CAS (kept here so the
    tenancy subsystem owns its own evidence)."""
    _EVICTIONS.inc()


@dataclasses.dataclass(frozen=True)
class Victim:
    """One bound pod as a preemption candidate (host-mirror view)."""

    key: str          # "<ns>/<name>"
    node: str
    row: int
    cpu_milli: int
    mem_kib: int
    priority: int
    seq: int          # bind sequence; larger = bound more recently
    tenant: str


def victim_sort_key(preemptor_tenant: str):
    """Victim preference within one node (see module doc, rule 2)."""
    def key(v: Victim):
        return (v.priority, v.tenant == preemptor_tenant, -v.seq)

    return key


@dataclasses.dataclass(frozen=True)
class PreemptionChoice:
    row: int
    node: str
    victims: tuple[Victim, ...]


def select_preemption(
    pod,
    preemptor_tenant: str,
    preemptor_priority: int,
    nodes,                 # [(row, NodeInfo)] ascending row
    usage: dict,           # row -> (cpu_req, mem_kib_req, pods_req)
    victims_by_row: dict,  # row -> list[Victim] (any order)
) -> PreemptionChoice | None:
    """Pick (node, victims) for ``pod``, or None when preemption is not
    warranted (already feasible somewhere) or cannot help (no node can
    be made feasible by evicting strictly-lower-priority pods).

    Pure: consumes only its arguments, so a drill that logged them can
    replay the exact choice.  ``nodes`` ascending-row keeps every
    tie-break deterministic.
    """
    # Rule 1: feasible somewhere as-is -> not a preemption case.
    for row, nd in nodes:
        if oracle_feasible(nd, pod, usage.get(row, (0, 0, 0))):
            return None

    best: tuple[int, int, int, PreemptionChoice] | None = None
    order = victim_sort_key(preemptor_tenant)
    for row, nd in nodes:
        candidates = sorted(
            (
                v for v in victims_by_row.get(row, ())
                if v.priority < preemptor_priority
            ),
            key=order,
        )
        if not candidates:
            continue
        cpu, mem, pods = usage.get(row, (0, 0, 0))
        taken: list[Victim] = []
        feasible = False
        for v in candidates:
            taken.append(v)
            cpu -= v.cpu_milli
            mem -= v.mem_kib
            pods -= 1
            if oracle_feasible(nd, pod, (cpu, mem, pods)):
                feasible = True
                break
        if not feasible:
            # Even a fully-evicted node can stay infeasible (static
            # filters: taints, selectors, allocatable too small).
            continue
        rank = (len(taken), max(v.priority for v in taken), row)
        if best is None or rank < best[:3]:
            best = (*rank, PreemptionChoice(row, nd.name, tuple(taken)))
    return best[3] if best is not None else None
