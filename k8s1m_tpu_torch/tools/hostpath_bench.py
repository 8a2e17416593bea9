"""Host-path microbenchmark: cached vs uncached pod encoding.

The port's own copy of ``k8s1m_tpu/tools/hostpath_bench.py``.  Its
encode+cycle lane runs the wave on the card unless ``--device cpu`` is
given, with ``--backend auto`` (the default: the kernels on ``cuda``, the
scan path on the CPU) where the JAX tool hard-codes its CPU XLA path.  The
lane's ``PodSpec(query_keys=80)`` runs on the fused kernel's affinity
stage like any other query table (the kernel takes any number of query
keys, as the Pallas kernel does).

The hotfeed tentpole claims the host encode — the last serial stage of
the scheduling cycle — collapses when encoding is cached by structural
shape and filled with vectorized writes (snapshot/hotfeed.py).  This
tool measures that claim, deterministically:

- **encode-only**: wall seconds to encode a seeded pod population
  through the uncached ``PodBatchHost`` vs the cached
  ``HotPodBatchHost`` (cache warmed by one untimed pass — the steady
  state the coordinator lives in).  Every batch of the first timed rep
  is also checked byte-identical between the two paths, so the bench
  doubles as a differential gate.
- **encode+cycle**: the same encodes feeding ``schedule_batch_packed``
  on ``--device`` (bind decision fetched to the host), showing how much
  of the full cycle the host encode was.

The load is the paper-relevant shape: ``--share`` (default 0.9) of
pods draw from ``--shapes`` distinct structural specs (selectors,
tolerations, preferred terms — the "handful of spec shapes" any real
or generated load exhibits), the rest get unique structural specs.
Pods are generated by ``--seed`` only — two runs at one seed encode
identical bytes.

    python -m k8s1m_tpu_torch.tools.hostpath_bench --nodes 1048576 --out report.json
    python -m k8s1m_tpu_torch.tools.hostpath_bench --smoke --device cpu   # tier-1 shape

Exits nonzero if cached-vs-uncached output ever differs, or if the
encode-path speedup falls under the gate (3x full, 2x smoke — the
measured win is typically far higher; the gate guards regressions, not
the headline).
"""

from __future__ import annotations

import argparse
import json
import random
import sys
import time

import numpy as np

from k8s1m_tpu_torch.config import (
    SEL_OP_GT,
    SEL_OP_IN,
    SEL_OP_NOT_IN,
    PodSpec,
    TableSpec,
)
from k8s1m_tpu_torch.obs.metrics import REGISTRY
from k8s1m_tpu_torch.snapshot.hotfeed import EncodeCache, HotPodBatchHost
from k8s1m_tpu_torch.snapshot.node_table import NodeInfo, NodeTableHost, Taint
from k8s1m_tpu_torch.snapshot.pod_encoding import (
    NodeSelectorTerm,
    PodBatchHost,
    PodInfo,
    PreferredSchedulingTerm,
    SelectorRequirement,
    Toleration,
)

GATE_FULL = 3.0
GATE_SMOKE = 2.0


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        description="host encode-path microbenchmark (cached vs uncached)"
    )
    ap.add_argument("--pods", type=int, default=8192)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--nodes", type=int, default=1024,
                    help="nodes interned into the vocab (labels + taints)")
    ap.add_argument("--shapes", type=int, default=8,
                    help="distinct structural shapes the hot pool draws from")
    ap.add_argument("--tail-shapes", type=int, default=256,
                    help="distinct shapes in the cold tail pool (a real "
                    "cluster's tail is other Deployments' templates — "
                    "finite and repeating, not an endless stream of "
                    "never-seen specs)")
    ap.add_argument("--share", type=float, default=0.9,
                    help="fraction of pods drawing from the hot shape pool "
                    "(the rest draw from the tail pool)")
    ap.add_argument("--reps", type=int, default=5,
                    help="timed encode passes over the population")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-cycle", action="store_true",
                    help="skip the encode+cycle mode (encode-only)")
    ap.add_argument("--smoke", action="store_true",
                    help="tier-1 shape: small sizes, relaxed 2x gate")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--backend", choices=("auto", "pallas", "xla"), default="auto",
                    help="the cycle lane's wave: 'auto' = the kernels on cuda, the "
                    "scan path on the CPU")
    ap.add_argument("--out", default=None, metavar="PATH",
                    help="also write the report JSON to PATH")
    args = ap.parse_args(argv)
    if args.smoke:
        args.pods = min(args.pods, 1024)
        args.batch = min(args.batch, 128)
        args.nodes = min(args.nodes, 256)
        args.reps = min(args.reps, 3)
    return args


def build_vocab(nodes: int, seed: int) -> NodeTableHost:
    """A node table rich enough that encodes exercise real interned ids
    (zones, disk classes, numeric generations, and the multi-tenant
    ``dedicated=team*`` taint pools whose distinct-triple count the
    uncached encoder re-evaluates per pod — still "tiny" by the
    snapshot design's standard, but paid on every single encode)."""
    cap = 1 << max(4, (nodes - 1).bit_length())
    spec = TableSpec(max_nodes=cap)
    host = NodeTableHost(spec)
    rng = random.Random(seed ^ 0x5EED)
    # One team per 24 nodes, capped so the team taints and the maintenance
    # taint fit the table's taint vocabulary (id 0 is reserved): the same
    # fleet as the JAX tool's up to 3,047 nodes, above which the JAX tool's
    # vocabulary overflows.
    teams = min(max(8, nodes // 24), spec.max_taint_ids - 2)
    for i in range(nodes):
        labels = {
            "zone": f"z{i % 8}",
            "region": f"r{i % 2}",
            "disk": ("ssd", "hdd", "nvme")[i % 3],
            "gen": str(i % 7),
        }
        taints = []
        if i % 7 == 0:
            taints.append(Taint("dedicated", f"team{i % teams}", 1))
        if i % 193 == 0:
            taints.append(Taint("maintenance", "", 2))
        host.upsert(NodeInfo(
            name=f"bench-node-{i}",
            cpu_milli=16000 + rng.randrange(4) * 1000,
            mem_kib=(32 << 20),
            labels=labels,
            taints=taints,
        ))
    return host


def shared_shape(j: int):
    """One of the shared-pool structural specs, deterministic in j.

    Deliberately production-shaped, not minimal: every real pod carries
    the two kubelet-injected default tolerations (not-ready /
    unreachable), workload pods add dedicated-pool tolerations, a
    node selector, an affinity term or two with multi-value In sets,
    and a preferred term — this is what a Deployment's template looks
    like, and it is exactly the redundancy the shape cache collapses
    (one template per Deployment, thousands of pods each)."""
    def apply(p: PodInfo) -> PodInfo:
        p.tolerations = [
            Toleration(key="node.kubernetes.io/not-ready"),
            Toleration(key="node.kubernetes.io/unreachable"),
            Toleration(key="dedicated", value=f"team{j % 5}"),
        ]
        p.node_selector = {"disk": ("ssd", "hdd", "nvme")[j % 3]}
        p.required_terms = [NodeSelectorTerm([
            SelectorRequirement("gen", SEL_OP_GT, [str(j % 5)]),
            SelectorRequirement(
                "zone", SEL_OP_IN,
                [f"z{(j + d) % 8}" for d in range(2 + j % 3)],
            ),
        ])]
        if j % 2:
            p.required_terms.append(NodeSelectorTerm([
                SelectorRequirement("region", SEL_OP_NOT_IN, [f"r{j % 2}"]),
            ]))
        p.preferred_terms = [PreferredSchedulingTerm(
            1 + j % 100,
            NodeSelectorTerm([SelectorRequirement(
                "disk", SEL_OP_IN, ["ssd", "nvme"]
            )]),
        )]
        return p
    return apply


def make_pods(args, rep: int) -> list[PodInfo]:
    """One rep's pod population.  FRESH PodInfo objects per rep (keyed
    by (seed, rep)) so every timed encode is a first encode of its
    objects — the cached path gets no object-identity shortcuts, only
    the shape cache the tentpole claims.  ``--share`` of pods draw from
    the hot pool of ``--shapes`` specs; the rest draw from a cold tail
    of ``--tail-shapes`` specs (distinct keys so the two pools never
    collide)."""
    rng = random.Random((args.seed << 8) ^ rep)
    pods = []
    for i in range(args.pods):
        p = PodInfo(
            f"bench-{rep}-{i}",
            cpu_milli=10 + rng.randrange(100),
            mem_kib=1024 + rng.randrange(4096),
        )
        if rng.random() < args.share:
            shared_shape(rng.randrange(args.shapes))(p)
        else:
            # Tail pods are one-off submissions: a selector and a
            # preference, no dedicated-pool tolerations — each tail
            # shape is its own fingerprint (distinct selector key),
            # seen ~pods*(1-share)/tail_shapes times per rep.
            j = rng.randrange(args.tail_shapes)
            p.node_selector = {
                f"tail-{j}": f"v{j}",
                "disk": ("ssd", "hdd", "nvme")[j % 3],
            }
            p.preferred_terms = [PreferredSchedulingTerm(
                1 + j % 100,
                NodeSelectorTerm([SelectorRequirement(
                    "gen", SEL_OP_GT, [str(j % 9)]
                )]),
            )]
        pods.append(p)
    return pods


def batches(pods: list[PodInfo], batch: int):
    for off in range(0, len(pods), batch):
        yield pods[off : off + batch]


def assert_identical(a, b, batch_i: int) -> None:
    if a.groups != b.groups:
        raise SystemExit(
            f"batch {batch_i}: groups differ {a.groups} != {b.groups}"
        )
    np.testing.assert_array_equal(a.ints, b.ints, f"batch {batch_i} ints")
    np.testing.assert_array_equal(a.bools, b.bools, f"batch {batch_i} bools")
    for name in a.fields:
        np.testing.assert_array_equal(
            a.fields[name], b.fields[name], f"batch {batch_i} {name}"
        )


def encode_pass(encoder, pods, batch: int) -> float:
    t0 = time.perf_counter()
    for bp in batches(pods, batch):
        encoder.encode_packed(bp)
    return time.perf_counter() - t0


def bench_encode(args, host):
    # Enough qkey slots for the shared keys plus one tail key per tail
    # pod in a batch (the tail draw is ~(1-share) of the batch).
    spec = PodSpec(batch=args.batch, query_keys=max(64, args.batch // 4 + 16))
    # One FRESH population per timed rep (first-encode semantics; the
    # generation cost stays outside the timed window), plus one more
    # for the untimed differential + warm pass.
    populations = [make_pods(args, rep) for rep in range(args.reps + 1)]
    ref = PodBatchHost(spec, host.spec, host.vocab)
    hot = HotPodBatchHost(
        spec, host.spec, host.vocab, cache=EncodeCache()
    )

    # Differential gate + cache warm, outside the timed window.
    for bi, bp in enumerate(batches(populations[-1], args.batch)):
        assert_identical(ref.encode_packed(bp), hot.encode_packed(bp), bi)

    un_s = sum(
        encode_pass(ref, populations[rep], args.batch)
        for rep in range(args.reps)
    )
    hits0 = REGISTRY.get("hotfeed_cache_hits_total").value()
    miss0 = REGISTRY.get("hotfeed_cache_misses_total").value()
    ca_s = sum(
        encode_pass(hot, populations[rep], args.batch)
        for rep in range(args.reps)
    )
    hits = REGISTRY.get("hotfeed_cache_hits_total").value() - hits0
    misses = REGISTRY.get("hotfeed_cache_misses_total").value() - miss0
    return {
        "pods": args.pods,
        "batch": args.batch,
        "reps": args.reps,
        "uncached_s": round(un_s, 4),
        "cached_s": round(ca_s, 4),
        "speedup": round(un_s / ca_s, 2) if ca_s else float("inf"),
        "pods_per_sec_uncached": round(args.pods * args.reps / un_s, 1),
        "pods_per_sec_cached": round(args.pods * args.reps / ca_s, 1),
        "cache_hit_rate": round(hits / (hits + misses), 4)
        if hits + misses else None,
        "distinct_templates": len(hot.cache),
    }, populations[0], ref, hot


def bench_cycle(args, host, pods, ref, hot) -> dict:
    """Encode+cycle: the same host encode feeding the wave on the device,
    bind decision fetched to the host — how much of a full wave the
    encode path was, before and after."""
    from k8s1m_tpu_torch.device import resolve_device
    from k8s1m_tpu_torch.engine.cycle import resolve_backend, schedule_batch_packed
    from k8s1m_tpu_torch.ops.priority import prng_key, prng_split, seed_of
    from k8s1m_tpu_torch.plugins.registry import Profile

    device = resolve_device(args.device)
    backend = resolve_backend(args.backend, device)
    profile = Profile(topology_spread=0, interpod_affinity=0)
    chunk = min(1 << 12, host.spec.max_nodes)
    table = host.to_device(device)
    key = prng_key(args.seed)

    def one_pass(encoder) -> float:
        nonlocal table, key
        t0 = time.perf_counter()
        for bp in batches(pods, args.batch):
            packed = encoder.encode_packed(bp)
            key, sub = prng_split(key)
            table, _, rows_dev = schedule_batch_packed(
                table, packed, seed_of(sub), profile=profile, constraints=None,
                chunk=chunk, k=4, backend=backend,
            )
            rows_dev.cpu()
        return time.perf_counter() - t0

    # One untimed pass first (the kernels' first launch, the caches).
    one_pass(hot)
    un_s = one_pass(ref)
    ca_s = one_pass(hot)
    return {
        "device": str(device),
        "backend": backend,
        "uncached_s": round(un_s, 4),
        "cached_s": round(ca_s, 4),
        "speedup": round(un_s / ca_s, 2) if ca_s else float("inf"),
        "binds_per_sec_uncached": round(args.pods / un_s, 1),
        "binds_per_sec_cached": round(args.pods / ca_s, 1),
    }


def main(argv=None) -> dict:
    args = parse_args(argv)
    host = build_vocab(args.nodes, args.seed)
    encode, pods, ref, hot = bench_encode(args, host)
    cycle = None
    if not args.no_cycle:
        cycle = bench_cycle(args, host, pods, ref, hot)
    gate = GATE_SMOKE if args.smoke else GATE_FULL
    report = {
        "metric": "hostpath_encode_speedup" + ("_smoke" if args.smoke else ""),
        "value": encode["speedup"],
        "unit": "x",
        "vs_baseline": None,
        "detail": {
            "seed": args.seed,
            "share": args.share,
            "shapes": args.shapes,
            "nodes": args.nodes,
            "byte_identical": True,      # assert_identical raised otherwise
            "gate": gate,
            "encode": encode,
            "cycle": cycle,
        },
    }
    print(json.dumps(report), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    if encode["speedup"] < gate:
        print(
            f"FAIL: encode speedup {encode['speedup']}x under the "
            f"{gate}x gate", file=sys.stderr,
        )
        raise SystemExit(1)
    return report


if __name__ == "__main__":
    main()
