"""KWOK-style Node objects, as the JAX package's ``tools/make_nodes.py``
builds them (the reference's kwok/make_nodes shape): a ``type=kwok``
label, a ``kwok-group`` shard label (10 groups), topology zone/region
labels and allocatable capacity.  The port keeps ``build_node`` only;
``tools/sched_bench.py`` writes the nodes into its in-process store."""

from __future__ import annotations

from k8s1m_tpu_torch.snapshot.node_table import NodeInfo

KWOK_GROUPS = 10


def build_node(
    i: int,
    *,
    prefix: str = "kwok-node",
    zones: int = 8,
    regions: int = 4,
    cpu_milli: int = 32000,
    mem_kib: int = 64 << 20,
    pods: int = 110,
) -> NodeInfo:
    return NodeInfo(
        name=f"{prefix}-{i}",
        cpu_milli=cpu_milli,
        mem_kib=mem_kib,
        pods=pods,
        labels={
            "type": "kwok",
            "kwok-group": str(i % KWOK_GROUPS),
            "topology.kubernetes.io/zone": f"zone-{i % zones}",
            "topology.kubernetes.io/region": f"region-{i % regions}",
        },
    )
