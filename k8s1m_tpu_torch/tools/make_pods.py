"""Bulk-create pending pods for the scheduler over the etcd wire (the
make_pods equivalent, reference kwok/make_pods/main.go:109-172); the port's
copy of ``k8s1m_tpu/tools/make_pods.py``.

    python -m k8s1m_tpu_torch.tools.make_pods --target 127.0.0.1:2379 \\
        --count 100000 --cpu 100 --mem-mib 200
"""

from __future__ import annotations

import argparse
import asyncio
import json

from k8s1m_tpu_torch.control.objects import encode_pod, pod_key
from k8s1m_tpu_torch.snapshot.records import PodInfo, Toleration
from k8s1m_tpu_torch.tools.common import (
    RateReporter,
    add_common_args,
    client_factory,
    run_sharded,
)


def build_pod(
    i: int,
    *,
    prefix: str = "bench-pod",
    namespace: str = "default",
    cpu_milli: int = 100,
    mem_kib: int = 200 << 10,
    tolerate_kwok: bool = True,
) -> PodInfo:
    return PodInfo(
        name=f"{prefix}-{i}",
        namespace=namespace,
        cpu_milli=cpu_milli,
        mem_kib=mem_kib,
        labels={"app": prefix},
        # The reference's pods tolerate the kwok taint
        # (make_pods/main.go sets tolerations for kwok.x-k8s.io/node).
        tolerations=([Toleration(key="kwok.x-k8s.io/node")] if tolerate_kwok else []),
    )


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="bulk-create pending pods")
    add_common_args(ap)
    ap.add_argument("--count", type=int, default=1000)
    ap.add_argument("--start", type=int, default=0)
    ap.add_argument("--prefix", default="bench-pod")
    ap.add_argument("--namespace", default="default")
    ap.add_argument("--cpu", type=int, default=100, help="milliCPU request")
    ap.add_argument("--mem-mib", type=int, default=200)
    ap.add_argument("--tenants", type=int, default=0,
                    help="spread pods over N tenant namespaces (tenant-0..tenant-N-1) with "
                    "zipf-skewed tenant sizes (cluster/workload.py); 0 = the single "
                    "--namespace")
    ap.add_argument("--tenant-skew", type=float, default=1.0,
                    help="zipf skew of tenant sizes (0 = uniform)")
    ap.add_argument("--tenant-schedule", default="steady",
                    choices=("steady", "diurnal", "flash"),
                    help="arrival shape of the tenant mix along the index sequence "
                    "(flash: tenant-0 crowds 10x in the middle fifth)")
    ap.add_argument("--seed", type=int, default=0,
                    help="tenant-assignment seed (deterministic stream)")
    return ap.parse_args(argv)


async def amain(args) -> dict:
    reporter = RateReporter("pods created", quiet=args.quiet)
    tenant_of = None
    if args.tenants > 0:
        from k8s1m_tpu_torch.cluster.workload import tenant_assignments

        tenant_of = tenant_assignments(
            args.count, args.tenants, skew=args.tenant_skew,
            seed=args.seed, schedule=args.tenant_schedule,
        )

    async def work(client, i):
        ns = args.namespace if tenant_of is None else f"tenant-{tenant_of[i]}"
        pod = build_pod(
            args.start + i, prefix=args.prefix, namespace=ns,
            cpu_milli=args.cpu, mem_kib=args.mem_mib << 10,
        )
        await client.put(pod_key(pod.namespace, pod.name), encode_pod(pod))

    await run_sharded(args.count, args.concurrency, client_factory(args), work,
                      clients=args.clients, reporter=reporter)
    return reporter.summary()


def main(argv=None):
    print(json.dumps(asyncio.run(amain(parse_args(argv)))))


if __name__ == "__main__":
    main()
