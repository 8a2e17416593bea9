"""Cluster verification: the kwok repository's shell one-liners as store
tools (reference kwok/count_ready.sh, kwok/find-gaps.sh); the port's copy
of ``k8s1m_tpu/tools/verify_cluster.py``.

- ``count-ready`` tallies nodes by Ready condition and pods by phase.
- ``find-gaps`` scans ``<prefix>-<i>`` numbering for holes: the smoke test
  that make_nodes/make_pods delivered a dense index range.

Both stream the store with paginated ranges (``native.scan_prefix``, the
light parse: keys and values only) rather than materialising the object
list, so they stay cheap at 1M objects.

    python -m k8s1m_tpu_torch.tools.verify_cluster --target 127.0.0.1:2379 count-ready
    python -m k8s1m_tpu_torch.tools.verify_cluster --target 127.0.0.1:2379 find-gaps
"""

from __future__ import annotations

import argparse
import collections
import json
import re
import sys

from k8s1m_tpu_torch.store.native import scan_prefix

NODES_PREFIX = b"/registry/minions/"
PODS_PREFIX = b"/registry/pods/"


def count_ready(store) -> dict:
    """{'nodes': {status: count}, 'pods': {phase: count}}."""
    nodes: collections.Counter = collections.Counter()
    for _key, value in scan_prefix(store, NODES_PREFIX):
        try:
            obj = json.loads(value)
            ready = "Unknown"
            for cond in obj.get("status", {}).get("conditions", []):
                if cond.get("type") == "Ready":
                    ready = cond.get("status", "Unknown")
            nodes["Ready" if ready == "True" else f"NotReady({ready})"] += 1
        # Counted: "undecodable" in the report IS the diagnosis.
        except Exception:  # graftlint: disable=broad-except
            nodes["undecodable"] += 1
    pods: collections.Counter = collections.Counter()
    for _key, value in scan_prefix(store, PODS_PREFIX):
        try:
            obj = json.loads(value)
            phase = obj.get("status", {}).get("phase", "Pending")
            if not obj.get("spec", {}).get("nodeName"):
                phase = f"{phase}(unbound)"
            pods[phase] += 1
        # Counted: "undecodable" in the report IS the diagnosis.
        except Exception:  # graftlint: disable=broad-except
            pods["undecodable"] += 1
    return {"nodes": dict(nodes), "pods": dict(pods)}


def find_gaps(store, prefix: bytes = NODES_PREFIX, pattern: str = r"-(\d+)$"):
    """Missing indices in a dense ``<name>-<i>`` keyspace, as inclusive
    (lo, hi) ranges."""
    rx = re.compile(pattern.encode())
    seen = []
    for key in scan_prefix(store, prefix, keys_only=True):
        m = rx.search(key)
        if m:
            seen.append(int(m.group(1)))
    seen.sort()
    gaps = []
    for a, b in zip(seen, seen[1:]):
        if b != a and b != a + 1:
            gaps.append((a + 1, b - 1))
    return gaps


def main(argv=None):
    ap = argparse.ArgumentParser(description="cluster state verification")
    ap.add_argument("--ca-pem", default=None, help="TLS: trust this CA")
    ap.add_argument("--token", default=None, help="bearer token")
    ap.add_argument("--target", required=True, help="store addr (host:port)")
    sub = ap.add_subparsers(dest="cmd", required=True)
    sub.add_parser("count-ready")
    g = sub.add_parser("find-gaps")
    g.add_argument("--prefix", default="/registry/minions/")
    args = ap.parse_args(argv)

    from k8s1m_tpu_torch.store.remote import RemoteStore

    store = RemoteStore(args.target, ca_pem=args.ca_pem, token=args.token)
    try:
        if args.cmd == "count-ready":
            print(json.dumps(count_ready(store)))
        else:
            gaps = find_gaps(store, args.prefix.encode())
            for lo, hi in gaps:
                print(f"Gap detected: {lo} to {hi}")
            print(json.dumps({"gaps": len(gaps)}))
            return 1 if gaps else 0
    finally:
        store.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
