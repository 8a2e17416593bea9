from k8s1m_tpu_torch.cluster.kwok import KwokShape, populate_kwok_nodes
from k8s1m_tpu_torch.cluster.workload import (
    affinity_deployment,
    node_affinity_pods,
    spread_deployment,
    uniform_pods,
)

__all__ = [
    "populate_kwok_nodes", "KwokShape", "uniform_pods", "node_affinity_pods",
    "spread_deployment", "affinity_deployment",
]
