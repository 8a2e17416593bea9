"""Put/range throughput benchmark against the store over the etcd wire (the
stress-client equivalent, reference mem_etcd/stress-client/src/main.rs:42-107);
the port's copy of ``k8s1m_tpu/tools/store_stress.py``.

    python -m k8s1m_tpu_torch.tools.store_stress --target 127.0.0.1:2379 \\
        --puts 50000 --ranges 1000 [--native-client]
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import time

from k8s1m_tpu_torch import faultline
from k8s1m_tpu_torch.store.native import prefix_end
from k8s1m_tpu_torch.tools.common import (
    RateReporter,
    add_common_args,
    apply_fault_plan,
    client_factory,
    run_sharded,
)

PREFIX = b"/stress/keys/"


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="store put/range stress")
    add_common_args(ap)
    ap.add_argument("--puts", type=int, default=10000)
    ap.add_argument("--ranges", type=int, default=100)
    ap.add_argument("--value-size", type=int, default=256)
    ap.add_argument("--range-limit", type=int, default=100)
    ap.add_argument("--native-client", action="store_true",
                    help="drive the standard per-RPC Put path with the native pipelined "
                    "client (wf_stress_put) instead of the Python client: a Python client "
                    "saturates one core long before the server does, so this measures the "
                    "SERVER (the reference's stress-client is native for the same reason)")
    ap.add_argument("--key-count", type=int, default=10000,
                    help="distinct keys cycled by --native-client")
    return ap.parse_args(argv)


async def amain(args) -> dict:
    apply_fault_plan(args)
    if args.native_client:
        from k8s1m_tpu_torch.store.native import wire_stress_put

        host, _, port = args.target.rpartition(":")
        n, elapsed = await asyncio.get_running_loop().run_in_executor(
            None, lambda: wire_stress_put(
                host or "127.0.0.1", int(port), args.puts,
                concurrency=args.concurrency, prefix=PREFIX.decode(),
                key_count=args.key_count, val_len=args.value_size,
            )
        )
        return {"puts": n, "puts_per_sec": round(n / elapsed, 1),
                "client": "native-per-rpc"}
    value = os.urandom(args.value_size)
    put_rep = RateReporter("puts", quiet=args.quiet)

    async def put_work(client, i):
        # Faultline hook at the asyncio client's wire edge, so --fault-plan
        # reaches the load generators too.
        await faultline.acheck("store.wire", "put")
        await client.put(PREFIX + b"%012d" % i, value)

    t0 = time.perf_counter()
    await run_sharded(args.puts, args.concurrency, client_factory(args), put_work,
                      clients=args.clients, reporter=put_rep)
    put_s = time.perf_counter() - t0

    range_rep = RateReporter("ranges", quiet=args.quiet)

    async def range_work(client, i):
        await faultline.acheck("store.wire", "range")
        start = PREFIX + b"%012d" % ((i * 37) % max(1, args.puts))
        await client.range(start, prefix_end(PREFIX), limit=args.range_limit)

    t1 = time.perf_counter()
    await run_sharded(args.ranges, args.concurrency, client_factory(args), range_work,
                      clients=args.clients, reporter=range_rep)
    range_s = time.perf_counter() - t1

    out = {
        "puts": args.puts,
        "puts_per_sec": round(args.puts / put_s, 1),
        "put_errors": put_rep.errors,
        "ranges": args.ranges,
        "ranges_per_sec": round(args.ranges / range_s, 1) if args.ranges else 0,
        "range_errors": range_rep.errors,
    }
    fired = faultline.active_injector().fire_counts()
    if fired:
        out["faults_injected"] = fired
    return out


def main(argv=None):
    print(json.dumps(asyncio.run(amain(parse_args(argv)))))


if __name__ == "__main__":
    main()
