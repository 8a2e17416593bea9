"""Flood the store with node-lease updates, the dominant write load of a
1M-node cluster (the etcd-lease-flood equivalent, reference
etcd-lease-flood/main.go:117-149: 1M kubelets renewing a 40 s lease every
10 s is ~100K writes/s, README.adoc:142-151); the port's copy of
``k8s1m_tpu/tools/lease_flood.py``.

Progress prints every 100K leases, and ``--fault-plan``
(``tools/common.py``) installs a deterministic injector for the run.

    python -m k8s1m_tpu_torch.tools.lease_flood --target 127.0.0.1:2379 \\
        --nodes 10000 --rounds 10 [--batch 1024]
"""

from __future__ import annotations

import argparse
import asyncio
import json
import time

from k8s1m_tpu_torch.control.objects import lease_key
from k8s1m_tpu_torch.tools.common import (
    RateReporter,
    add_common_args,
    apply_fault_plan,
    client_factory,
    run_sharded,
)

LEASE_NS = "kube-node-lease"


def lease_value(node: str, seq: int) -> bytes:
    # Kubernetes Lease objects are small; model the renewTime bump that
    # makes every renewal a fresh write.
    return json.dumps(
        {
            "apiVersion": "coordination.k8s.io/v1",
            "kind": "Lease",
            "metadata": {"name": node, "namespace": LEASE_NS},
            "spec": {
                "holderIdentity": node,
                "leaseDurationSeconds": 40,
                "renewTime": f"seq-{seq}",
            },
        },
        separators=(",", ":"),
    ).encode()


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="node-lease write flood")
    add_common_args(ap)
    ap.add_argument("--nodes", type=int, default=1000)
    ap.add_argument("--rounds", type=int, default=10, help="lease renewals per node")
    ap.add_argument("--prefix", default="kwok-node")
    ap.add_argument("--batch", type=int, default=0,
                    help="puts per BatchKV.PutFrame RPC (0 = per-put RPCs like the "
                    "reference's etcd-lease-flood; >0 pipelines waves over the private "
                    "batch wire)")
    return ap.parse_args(argv)


async def amain(args) -> dict:
    apply_fault_plan(args)
    reporter = RateReporter("lease puts", quiet=args.quiet, milestone=100_000)
    total = args.nodes * args.rounds

    async def work(client, i):
        node = f"{args.prefix}-{i % args.nodes}"
        await client.put(lease_key(LEASE_NS, node), lease_value(node, i // args.nodes))

    async def work_batched(client, bi):
        lo = bi * args.batch
        items = []
        for i in range(lo, min(lo + args.batch, total)):
            node = f"{args.prefix}-{i % args.nodes}"
            items.append((lease_key(LEASE_NS, node), lease_value(node, i // args.nodes)))
        await client.put_batch(items)
        return len(items)           # run_sharded counts puts, not RPCs

    t0 = time.perf_counter()
    if args.batch > 0:
        n_batches = (total + args.batch - 1) // args.batch
        await run_sharded(n_batches, args.concurrency, client_factory(args), work_batched,
                          clients=args.clients, reporter=reporter)
    else:
        await run_sharded(total, args.concurrency, client_factory(args), work,
                          clients=args.clients, reporter=reporter)
    out = reporter.summary()
    out["count"] = total
    out["puts_per_sec"] = round(total / (time.perf_counter() - t0), 1)
    return out


def main(argv=None):
    print(json.dumps(asyncio.run(amain(parse_args(argv)))))


if __name__ == "__main__":
    main()
