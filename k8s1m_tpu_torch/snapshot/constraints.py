"""Topology-spread and inter-pod-affinity constraint state.

Port of ``k8s1m_tpu/snapshot/constraints.py``.  Constraints (namespace +
labelSelector + topologyKey) are interned on the host into dense slots
(``ConstraintTracker``, a copy of the JAX package's), and the device
keeps count tables per (slot, domain):

- hostname-keyed domains are nodes, so counts are [slots, N];
- zone/region-keyed domains are small dense tables.

``commit_constraint_binds`` folds a wave's binds into the tables IN
PLACE, right after the capacity commit, so the next wave sees them.

Inter-pod affinity keeps two tables per granularity: ``tgt`` counts pods
*matched by* a term's selector (the incoming pod's own terms), ``own``
counts pods *carrying* a required anti-affinity term (the symmetry rule).
"""

from __future__ import annotations

import dataclasses

import torch

from k8s1m_tpu_torch.config import TOPO_HOSTNAME, TOPO_REGION, TOPO_ZONE, TableSpec
from k8s1m_tpu_torch.device import resolve_device
from k8s1m_tpu_torch.snapshot.records import ConstraintTracker, SelectorKey  # noqa: F401 (re-exported)

# Field order of ConstraintState (also the order interop and the tests use).
FIELDS = (
    "spread_node", "spread_zone", "spread_region",
    "tgt_node", "tgt_zone", "tgt_region",
    "own_node", "own_zone", "own_region",
)
NODE_FIELDS = ("spread_node", "tgt_node", "own_node")


@dataclasses.dataclass
class ConstraintState:
    # PodTopologySpread: matching-pod counts per (constraint slot, domain).
    spread_node: torch.Tensor    # i32[C, N]
    spread_zone: torch.Tensor    # i32[C, Z]
    spread_region: torch.Tensor  # i32[C, R]
    # InterPodAffinity target counts (pods matching the term's selector).
    tgt_node: torch.Tensor       # i32[A, N]
    tgt_zone: torch.Tensor       # i32[A, Z]
    tgt_region: torch.Tensor     # i32[A, R]
    # InterPodAffinity owner counts (pods carrying a required anti term).
    own_node: torch.Tensor       # i32[A, N]
    own_zone: torch.Tensor       # i32[A, Z]
    own_region: torch.Tensor     # i32[A, R]

    def clone(self) -> "ConstraintState":
        return ConstraintState(**{f: getattr(self, f).clone() for f in FIELDS})


def empty_constraints(spec: TableSpec, device: str | torch.device = "cuda") -> ConstraintState:
    c, a = spec.spread_slots, spec.affinity_slots
    n, z, r = spec.max_nodes, spec.max_zones, spec.max_regions
    dev = resolve_device(device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.int32, device=dev)

    return ConstraintState(
        spread_node=zeros(c, n), spread_zone=zeros(c, z), spread_region=zeros(c, r),
        tgt_node=zeros(a, n), tgt_zone=zeros(a, z), tgt_region=zeros(a, r),
        own_node=zeros(a, n), own_zone=zeros(a, z), own_region=zeros(a, r),
    )


def slice_constraints(state: ConstraintState, start: int, rows: int) -> ConstraintState:
    """The node-domain tables cut to node rows ``[start, start+rows)`` as
    column views (``narrow(1, ...)``: no copy, NOT contiguous — the row
    stride stays the full table width); zone/region tables pass whole."""
    return dataclasses.replace(state, **{
        f: getattr(state, f).narrow(1, start, rows) for f in NODE_FIELDS
    })


# ---- host-side interning ---------------------------------------------------


# ---- device-side commit ----------------------------------------------------


def commit_constraint_binds(
    state: ConstraintState,
    bound_node,    # bool[B] gate for node-domain tables
    bound_domain,  # bool[B] gate for zone/region tables
    node_row,      # i32[B] (clipped to a valid row where unbound)
    zone,          # i32[B] domain of the bound node
    region,        # i32[B]
    sinc_valid,    # bool[B, SI] pod matches spread constraint sinc_cid[b, j]
    sinc_cid,      # i32[B, SI]
    sinc_topo,     # i32[B, SI]
    iinc_valid,    # bool[B, AI] pod matches affinity term iinc_tid[b, j]
    iinc_tid,      # i32[B, AI]
    iinc_topo,     # i32[B, AI]
    own_valid,     # bool[B, AR] pod carries affinity term own_tid[b, j]
    own_tid,       # i32[B, AR]
    own_topo,      # i32[B, AR]
    sign: int = 1,  # +1 commit, -1 roll back
) -> ConstraintState:
    """Fold a batch's binds into the count tables, IN PLACE: one
    ``index_put_(..., accumulate=True)`` per table — the port's form of
    the JAX step's buffer donation (the tables are updated in their own
    storage, nothing is copied).  Callers that must keep the pre-commit
    counts clone first.  Returns ``state`` for call-chaining."""
    i32 = torch.int32
    zero = torch.zeros((), dtype=i32, device=node_row.device)

    def flat(x, width):
        return x[:, None].expand(-1, width).reshape(-1).to(torch.int64)

    def apply(node_tab, zone_tab, region_tab, valid, slot, topo):
        w = valid.shape[1]
        inc_node = sign * (valid & bound_node[:, None]).to(i32).reshape(-1)
        inc_dom = sign * (valid & bound_domain[:, None]).to(i32).reshape(-1)
        slot = slot.reshape(-1).to(torch.int64)
        topo = topo.reshape(-1)
        node_tab.index_put_(
            (slot, flat(node_row, w)), torch.where(topo == TOPO_HOSTNAME, inc_node, zero),
            accumulate=True,
        )
        zone_tab.index_put_(
            (slot, flat(zone, w)), torch.where(topo == TOPO_ZONE, inc_dom, zero),
            accumulate=True,
        )
        region_tab.index_put_(
            (slot, flat(region, w)), torch.where(topo == TOPO_REGION, inc_dom, zero),
            accumulate=True,
        )

    apply(state.spread_node, state.spread_zone, state.spread_region,
          sinc_valid, sinc_cid, sinc_topo)
    apply(state.tgt_node, state.tgt_zone, state.tgt_region,
          iinc_valid, iinc_tid, iinc_topo)
    apply(state.own_node, state.own_zone, state.own_region,
          own_valid, own_tid, own_topo)
    return state
