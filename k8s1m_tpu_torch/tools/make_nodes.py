"""Bulk-create KWOK-style Node objects over the etcd wire (the make_nodes
equivalent, reference kwok/make_nodes/main.go:116-182); the port's copy of
``k8s1m_tpu/tools/make_nodes.py``.

    python -m k8s1m_tpu_torch.tools.make_nodes --target 127.0.0.1:2379 \\
        --count 1048576 --bulk 1024

Nodes get the shape the reference gives its KWOK nodes: a ``type=kwok``
label, a ``kwok-group`` shard label (10 groups, matching the reference's
10-controller StatefulSet, kwok-controller.yaml:9,53), topology
zone/region labels and allocatable capacity.  The last line on stdout is
the run's JSON summary.
"""

from __future__ import annotations

import argparse
import asyncio
import json

from k8s1m_tpu_torch.control.objects import encode_node, node_key
from k8s1m_tpu_torch.snapshot.records import NodeInfo
from k8s1m_tpu_torch.tools.common import (
    RateReporter,
    add_common_args,
    client_factory,
    run_sharded,
)

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


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="bulk-create KWOK-style nodes")
    add_common_args(ap)
    ap.add_argument("--count", type=int, default=1000)
    ap.add_argument("--start", type=int, default=0)
    ap.add_argument("--prefix", default="kwok-node")
    ap.add_argument("--zones", type=int, default=8)
    ap.add_argument("--regions", type=int, default=4)
    ap.add_argument("--cpu", type=int, default=32000, help="milliCPU allocatable")
    ap.add_argument("--mem-kib", type=int, default=64 << 20)
    ap.add_argument("--pods", type=int, default=110)
    ap.add_argument("--bulk", type=int, default=1,
                    help="batch N node puts per RPC over the BatchKV put-frame extension "
                    "(this repository's store server); one put per node is itself a "
                    "bottleneck at 1M nodes, --bulk 1024 is the megarow registration lane")
    return ap.parse_args(argv)


async def amain(args) -> dict:
    reporter = RateReporter("nodes created", quiet=args.quiet, milestone=100_000)

    def node_item(n: int) -> tuple[bytes, bytes]:
        node = build_node(
            n, prefix=args.prefix, zones=args.zones, regions=args.regions,
            cpu_milli=args.cpu, mem_kib=args.mem_kib, pods=args.pods,
        )
        return node_key(node.name), encode_node(node)

    if args.bulk > 1:
        bulk = args.bulk

        async def work(client, b):
            lo = args.start + b * bulk
            hi = min(lo + bulk, args.start + args.count)
            items = [node_item(n) for n in range(lo, hi)]
            await client.put_batch(items)
            return len(items)

        total = -(-args.count // bulk)
    else:
        async def work(client, i):
            key, value = node_item(args.start + i)
            await client.put(key, value)

        total = args.count

    await run_sharded(total, args.concurrency, client_factory(args), work,
                      clients=args.clients, reporter=reporter)
    return reporter.summary()


def main(argv=None):
    print(json.dumps(asyncio.run(amain(parse_args(argv)))))


if __name__ == "__main__":
    main()
