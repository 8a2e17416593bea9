"""Bring up a full cluster and run the standard experiment.

The single-command equivalent of the reference's terraform apply +
make_nodes + make_pods recipe (reference README.adoc:732-738):

    python -m k8s1m_tpu_torch.cluster.up --nodes 10000 --pods 10000
    python -m k8s1m_tpu_torch.cluster.up --nodes 1000 --pods 1000 --device cpu

Starts the native store server (etcd wire), leader+standby coordinators
and KWOK controllers over gRPC, creates the nodes, streams the pods, and
prints one JSON summary with end-to-end binds/sec.  The port's own copy of
``k8s1m_tpu/cluster/up.py``; the coordinators run on ``--device``
(default cuda), and ``--backend pallas`` is the fused kernel.
"""

from __future__ import annotations

import argparse
import json

from k8s1m_tpu_torch.cluster.harness import Cluster, ClusterSpec


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="cluster bring-up + experiment")
    ap.add_argument("--nodes", type=int, default=1000)
    ap.add_argument("--pods", type=int, default=1000)
    ap.add_argument("--kwok-groups", type=int, default=2)
    ap.add_argument("--coordinators", type=int, default=2)
    ap.add_argument("--shards", type=int, default=1,
                    help=">1 deploys the scheduler shard set (pod-hash "
                    "intake split + node ownership masks + rebalancer)")
    ap.add_argument("--watch-cache", action="store_true",
                    help="deploy the apiserver tier; KWOK controllers "
                    "connect through it")
    ap.add_argument("--watch-cache-index", choices=("hash", "btree"),
                    default="hash")
    ap.add_argument("--pod-batch", type=int, default=256)
    ap.add_argument("--chunk", type=int, default=1 << 10)
    ap.add_argument("--backend", choices=("xla", "pallas"), default="xla")
    ap.add_argument("--wal-mode", choices=("none", "buffered", "fsync"),
                    default="buffered")
    ap.add_argument("--via-webhook", action="store_true",
                    help="feed pods through the admission webhook path")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    from k8s1m_tpu_torch.envboot import tune_gc

    tune_gc()
    args = parse_args(argv)
    spec = ClusterSpec(
        nodes=args.nodes,
        kwok_groups=args.kwok_groups,
        coordinators=args.coordinators,
        shards=args.shards,
        watch_cache=args.watch_cache,
        watch_cache_index=args.watch_cache_index,
        pod_batch=args.pod_batch,
        chunk=args.chunk,
        backend=args.backend,
        wal_mode=args.wal_mode,
        device=args.device,
    )
    with Cluster(spec) as cluster:
        cluster.make_nodes()
        cluster.tick(0.0)  # elect a leader, bootstrap kwok + snapshot
        stats = cluster.run_pods(args.pods, via_webhook=args.via_webhook)
        print(json.dumps(stats))
    return stats


if __name__ == "__main__":
    main()
