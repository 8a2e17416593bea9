"""KWOK-vs-kubelet fidelity A/B — the reference's realism experiment.

The reference ran the same workload under KWOK fake nodes and under
100K real kubelets-in-pods and compared control-plane load shapes
(reference README.adoc:789-861): request rates were about equal, but
kubelets added more watches, more Events, and more DB size.  This tool
reproduces that comparison against our store with our two simulators:

    python -m k8s1m_tpu_torch.tools.fidelity_ab --nodes 2000 --pods 2000
    python -m k8s1m_tpu_torch.tools.fidelity_ab --device cpu

Each arm gets a fresh in-process store: make nodes, run a coordinator
to bind pods, drive the node simulator for --sim-seconds of simulated
time, then report write counts (revision delta), key counts, and DB
size.  The expected shape mirrors the reference's finding: kubelet
arms write Events and full-Node heartbeats that KWOK skips.

The port's own copy of ``k8s1m_tpu/tools/fidelity_ab.py``.  Both arms
bind through a port ``Coordinator`` on ``--device`` (default cuda, where
the wave is the fused kernel; on the CPU it is the scan path the JAX tool
runs).  The report holds no clock, so a card run and a CPU run at one
shape print the same report.
"""

from __future__ import annotations

import argparse
import json

from k8s1m_tpu_torch.cluster.kubelet_sim import EVENTS_PREFIX, KubeletPool
from k8s1m_tpu_torch.cluster.kwok_controller import KwokController
from k8s1m_tpu_torch.config import PodSpec, TableSpec
from k8s1m_tpu_torch.control.coordinator import Coordinator
from k8s1m_tpu_torch.control.objects import encode_node, encode_pod, node_key, pod_key
from k8s1m_tpu_torch.device import resolve_device
from k8s1m_tpu_torch.plugins.registry import Profile
from k8s1m_tpu_torch.snapshot.pod_encoding import PodInfo
from k8s1m_tpu_torch.store.native import MemStore, prefix_end
from k8s1m_tpu_torch.tools.make_nodes import build_node

LEASES_PREFIX = b"/registry/leases/"


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="kwok vs kubelet-sim load A/B")
    ap.add_argument("--nodes", type=int, default=2000)
    ap.add_argument("--pods", type=int, default=2000)
    ap.add_argument("--sim-seconds", type=int, default=60)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def run_arm(args, make_sim) -> dict:
    store = MemStore()
    for i in range(args.nodes):
        node = build_node(i)
        node.labels["kwok-group"] = "0"
        store.put(node_key(node.name), encode_node(node))
    rev_after_nodes = store.current_revision

    cap = 1 << max(10, (args.nodes - 1).bit_length())
    # backend "auto": the fused kernel on cuda, the scan path on the CPU;
    # one chunk on both, so both bind the same pods to the same nodes.
    coord = Coordinator(
        store, TableSpec(max_nodes=cap), PodSpec(batch=args.batch),
        Profile(node_affinity=0, topology_spread=0, interpod_affinity=0),
        chunk=1 << 10, with_constraints=False, backend="auto", device=args.device,
    )
    coord.bootstrap()
    sim = make_sim(store)
    sim.bootstrap(0.0)

    for i in range(args.pods):
        store.put(
            pod_key("default", f"ab-{i}"),
            encode_pod(PodInfo(f"ab-{i}", cpu_milli=10, mem_kib=1024)),
        )
    bound = coord.run_until_idle()

    now = 0.0
    while now < args.sim_seconds:
        now += 1.0
        sim.tick(now)

    stats = {
        "bound": bound,
        "writes_total": store.current_revision - rev_after_nodes,
        "num_keys": store.num_keys,
        "db_size": store.db_size,
        "events": store.range(
            EVENTS_PREFIX, prefix_end(EVENTS_PREFIX), count_only=True
        ).count,
        "leases": store.range(
            LEASES_PREFIX, prefix_end(LEASES_PREFIX), count_only=True
        ).count,
    }
    sim.close()
    coord.close()
    store.close()
    return stats


def main(argv=None) -> dict:
    args = parse_args(argv)
    resolve_device(args.device)  # a missing card raises before any store opens
    kwok = run_arm(args, lambda s: KwokController(s, group=0))
    kubelet = run_arm(args, lambda s: KubeletPool(s))
    report = {
        "config": {"nodes": args.nodes, "pods": args.pods,
                   "sim_seconds": args.sim_seconds},
        "kwok": kwok,
        "kubelet_sim": kubelet,
        "ratios": {
            k: round(kubelet[k] / kwok[k], 2) if kwok[k] else None
            for k in ("writes_total", "num_keys", "db_size", "events")
        },
    }
    print(json.dumps(report, indent=1))
    return report


if __name__ == "__main__":
    main()
