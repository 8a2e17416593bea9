"""Static shape configuration for device-resident tables.

A copy of ``k8s1m_tpu/config.py``: every table and pod batch has a
static padded shape, sized by these two specs.  The port keeps its own
copy so that it imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class TableSpec:
    """Shape of the device-resident node table."""

    max_nodes: int = 1 << 20
    label_slots: int = 16      # padded label (key,value) pairs per node
    taint_slots: int = 8       # padded taints per node
    max_taint_ids: int = 128   # distinct (key,value,effect) taint triples cluster-wide
    max_zones: int = 512       # distinct topology.kubernetes.io/zone values
    max_regions: int = 64
    spread_slots: int = 16
    affinity_slots: int = 16

    def __post_init__(self):
        if self.max_nodes <= 0:
            raise ValueError("max_nodes must be positive")


@dataclasses.dataclass(frozen=True)
class PodSpec:
    """Shape of one encoded pod batch."""

    batch: int = 256
    query_keys: int = 16       # distinct label keys referenced by one batch's selectors
    aff_terms: int = 4         # required nodeAffinity terms (OR of terms)
    aff_exprs: int = 4         # expressions per term (ANDed)
    aff_values: int = 8        # values per expression (In/NotIn sets)
    pref_terms: int = 4        # preferred nodeAffinity terms
    spread_refs: int = 4       # topologySpreadConstraints per pod
    affinity_refs: int = 4     # (anti)affinity terms per pod
    spread_incs: int = 4       # spread constraints whose selector matches the pod
    ipa_incs: int = 4          # affinity terms whose selector matches the pod


# Sentinel id meaning "no string" in every interned column.  Real ids start
# at 1 so zero-initialised padding is automatically "absent".
NONE_ID = 0

# The schedulerName this framework answers to.
DEFAULT_SCHEDULER = "dist-scheduler"
# What Kubernetes assigns when spec.schedulerName is unset; such pods
# belong to the stock scheduler, never to this framework's intake.
K8S_DEFAULT_SCHEDULER = "default-scheduler"

# Taint / toleration effects.
EFFECT_NONE = 0                # toleration with no effect: matches all
EFFECT_NO_SCHEDULE = 1
EFFECT_PREFER_NO_SCHEDULE = 2
EFFECT_NO_EXECUTE = 3

# Toleration operators.
TOL_OP_EQUAL = 0
TOL_OP_EXISTS = 1

# NodeSelector operators (upstream v1.NodeSelectorOperator).
SEL_OP_IN = 0
SEL_OP_NOT_IN = 1
SEL_OP_EXISTS = 2
SEL_OP_DOES_NOT_EXIST = 3
SEL_OP_GT = 4
SEL_OP_LT = 5

# Topology keys.
TOPO_HOSTNAME = 0              # kubernetes.io/hostname — domain == node
TOPO_ZONE = 1                  # topology.kubernetes.io/zone
TOPO_REGION = 2                # topology.kubernetes.io/region

# whenUnsatisfiable modes for topology spread.
SPREAD_DO_NOT_SCHEDULE = 0
SPREAD_SCHEDULE_ANYWAY = 1

# Numeric value parsed out of a label for Gt/Lt node-affinity operators;
# this sentinel means "not an integer".
NO_NUMERIC = -(1 << 31)
