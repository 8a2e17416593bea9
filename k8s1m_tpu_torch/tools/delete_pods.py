"""Bulk pod deletion over the etcd wire (the delete_pods equivalent,
reference kwok/delete_pods/main.go:80-92); the port's copy of
``k8s1m_tpu/tools/delete_pods.py``.

    python -m k8s1m_tpu_torch.tools.delete_pods --target 127.0.0.1:2379 \\
        --namespace default --prefix bench-pod
"""

from __future__ import annotations

import argparse
import asyncio
import json

from k8s1m_tpu_torch.store.etcd_client import EtcdClient
from k8s1m_tpu_torch.store.native import prefix_end
from k8s1m_tpu_torch.tools.common import (
    RateReporter,
    add_common_args,
    client_factory,
    run_sharded,
)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="bulk-delete pods")
    add_common_args(ap)
    ap.add_argument("--namespace", default="default")
    ap.add_argument("--prefix", default="", help="pod-name prefix filter")
    return ap.parse_args(argv)


async def amain(args) -> dict:
    lister = EtcdClient(args.target, ca_pem=args.ca_pem, token=args.token)
    key_prefix = f"/registry/pods/{args.namespace}/{args.prefix}".encode()
    try:
        resp = await lister.range(key_prefix, prefix_end(key_prefix), keys_only=True)
    finally:
        await lister.close()
    keys = [kv.key for kv in resp.kvs]

    reporter = RateReporter("pods deleted", quiet=args.quiet)

    async def work(client, i):
        await client.delete(keys[i])

    await run_sharded(len(keys), args.concurrency, client_factory(args), work,
                      clients=args.clients, reporter=reporter)
    return reporter.summary()


def main(argv=None):
    print(json.dumps(asyncio.run(amain(parse_args(argv)))))


if __name__ == "__main__":
    main()
