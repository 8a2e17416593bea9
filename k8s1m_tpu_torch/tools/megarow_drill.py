"""megarow: the 1,048,576-node cluster, end to end, on the port.

The port's own copy of ``k8s1m_tpu/tools/megarow_drill.py``, the JAX
package's headline run (``pod_binds_per_sec_1048576_nodes``).  It stands
the whole loop up at the headline shape on the port's coordinator, on the
card unless ``--device cpu`` is given:

1. **Bulk registration** — make_nodes-shaped Node objects written
   through the store's put-frame lane, rate reported.
2. **Timed cold build** — ``Coordinator.bootstrap()``: values-only
   relist -> template bulk ingest (snapshot/bulkload.py) -> one packed
   table build and upload, the wall landing in
   ``megarow_cold_build_seconds``.
3. **Comparison lane** — at the 131k shape, the same cold build through
   the per-node ``decode_node`` + ``upsert`` loop vs the bulk lane, on one
   store; the bulk lane must be >= 3x faster end to end (gated).  The
   table upload is timed up to ``torch.cuda.synchronize()`` on the card.
4. **Composed byte-identity differential** — the deltacache+index lane
   (the delta kernel) vs the full-recompute lane (the fused kernel's base
   stage) over identical stores and submission sequences at
   ``--differential-nodes`` rows: every bind must land byte-identically,
   and the index lane must have taken index waves (gated).
5. **Sustained window** — tenant-aware weighted-fair submission through
   ``submit_external``, capacity-only node churn scattering mid-flight, a
   seeded bind-CAS conflict plan, an overload phase that must walk to
   SHEDDING and recover (its degraded waves score a 1% window through the
   fused kernel), depth-3 pipelining, deltacache + the candidate index,
   packed layout.  Gates: zero admitted pods lost, zero structural /
   resync quiesces, SHEDDING seen + HEALTHY recovered, median in-flight
   depth at the configured depth, zero retry give-ups, zero packed
   fallbacks.

Peak host RSS is reported (and gated with ``--rss-budget-mib``).  The
result is one JSON line, also written to ``--out``::

    # the headline shape on the card
    python -m k8s1m_tpu_torch.tools.megarow_drill --out chiprun_out/megarow.json

    # a reduced shape on the CPU (the plain versions of the kernels)
    python -m k8s1m_tpu_torch.tools.megarow_drill --device cpu --nodes 16384 \
        --batch 128 --chunk 1024 --compare-nodes 8192 --differential-nodes 8192
"""

from __future__ import annotations

import argparse
import json
import resource
import time

IDLE_DRAIN_TICKS = 20000


def peak_rss_mib() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        description="the million-node cluster end to end"
    )
    ap.add_argument("--nodes", type=int, default=1 << 20)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--chunk", type=int, default=4096)
    ap.add_argument("--depth", type=int, default=3)
    ap.add_argument("--tenants", type=int, default=4)
    ap.add_argument("--tenant-skew", type=float, default=1.0)
    ap.add_argument("--steady-ticks", type=int, default=24)
    ap.add_argument("--overload-ticks", type=int, default=12)
    ap.add_argument("--recover-ticks", type=int, default=60)
    ap.add_argument("--factor", type=int, default=4)
    ap.add_argument("--churn-per-tick", type=int, default=256,
                    help="capacity-only node updates written per tick "
                    "(scattered mid-flight; structural quiesces stay 0)")
    ap.add_argument("--conflict-every", type=int, default=53,
                    help="faultline: force a bind-CAS conflict on "
                    "average every Nth CAS attempt (seeded probability "
                    "1/N per attempt — NOT a strict period: a periodic "
                    "every_n resonates with the steady wave cadence, "
                    "and a retried pod whose requeue lands back on the "
                    "period eats the injected conflict on every attempt "
                    "until it exhausts max_attempts — a give-up "
                    "manufactured by the injection pattern, not by the "
                    "scheduler the zero-give-up gate exists to judge)")
    ap.add_argument("--sat-ticks", type=int, default=24,
                    help="saturated-throughput phase: steps measured "
                    "with the queue held at ~2x batch via store-put "
                    "intake (no admission involvement, HEALTHY "
                    "throughout) — the headline binds/s is "
                    "scheduler-bound, not producer-bound")
    ap.add_argument("--bulk", type=int, default=8192,
                    help="nodes per BatchKV put-frame during "
                    "registration (the make_nodes --bulk lane)")
    ap.add_argument("--compare-nodes", type=int, default=131072,
                    help="cold-build comparison shape (bulk lane vs "
                    "the pre-megarow per-node loop; 0 skips the lane)")
    ap.add_argument("--rss-budget-mib", type=int, default=0,
                    help="gate peak host RSS at this budget "
                    "(0 = report only; the tier-1 smoke sets it)")
    ap.add_argument("--deltacache", choices=("off", "on"), default="on")
    ap.add_argument(
        "--score-pct", type=int, default=100,
        help="scored-window fraction.  100 (the default since the "
        "candidate index landed) keeps waves on the full-scan shape "
        "the delta cache requires — sampled windows compute different "
        "planes than the cache holds, so any score_pct < 100 disables "
        "the delta/index path entirely (the pre-index drill ran 50)",
    )
    ap.add_argument(
        "--delta-index-k", type=int, default=64,
        help="per-resident-plane top-K candidate index: all-hit waves "
        "derive candidates from the index + dirty set and skip the "
        "O(N) plane scan (0 disables; requires --deltacache on).  64 "
        "spans ~two default-width strata, so the eviction floor cuts "
        "BELOW the whole top class instead of through it",
    )
    ap.add_argument(
        "--stratum-bits", type=int, default=None,
        help="high jitter bits drawn from a wave-invariant per-column "
        "hash stratum: KWOK nodes are homogeneous, so ~every row ties "
        "at one score and an unstratified index floor fails closed "
        "every wave.  Default derives from the shape — "
        "log2(nodes) - 5, i.e. ~32 tied rows per (score, stratum) "
        "class (see stratum_bits_for).  Too coarse and the K-deep "
        "floor cannot cut inside the top class (permanent underflow); "
        "too FINE and the class order becomes a near-total "
        "wave-invariant ranking shared by every pod — each wave then "
        "converges on the same few rows, the per-row pod cap starves "
        "it, and retried pods march to give-up (0 pins the historical "
        "seeded jitter bit-for-bit)",
    )
    ap.add_argument(
        "--differential-nodes", type=int, default=131072,
        help="composed byte-identity differential shape: the "
        "deltacache+index lane vs full recompute over identical "
        "stores/submissions, every bind compared (0 skips the lane)",
    )
    ap.add_argument("--packing", choices=("off", "packed"),
                    default="packed")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--smoke", action="store_true",
                    help="tier-1 shape: 131,072 rows, same gates "
                    "(including the >= 3x cold-build proxy and an RSS "
                    "budget)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.smoke:
        args.nodes = 131072
        args.batch, args.chunk = 128, 1024
        args.steady_ticks, args.overload_ticks = 8, 6
        args.recover_ticks = 40
        args.churn_per_tick = 128
        args.bulk = 4096
        args.sat_ticks = 16
        args.differential_nodes = min(args.differential_nodes, 32768)
        if args.rss_budget_mib == 0:
            args.rss_budget_mib = 4096
    if args.nodes % args.chunk:
        ap.error(f"--nodes {args.nodes} not divisible by --chunk {args.chunk}")
    if args.differential_nodes % args.chunk:
        ap.error(
            f"--differential-nodes {args.differential_nodes} not "
            f"divisible by --chunk {args.chunk}"
        )
    if args.delta_index_k and args.deltacache != "on":
        ap.error("--delta-index-k requires --deltacache on")
    args.stratum_auto = args.stratum_bits is None
    if args.stratum_auto:
        args.stratum_bits = stratum_bits_for(args.nodes)
    return args


def stratum_bits_for(nodes: int) -> int:
    """Stratum width targeting ~2^5 tied rows per (score, stratum)
    class: log2(nodes) - 5, clamped to [1, 18].

    The class width is the placement-diversity budget.  Per-pod jitter
    only varies WITHIN a class (the stratum occupies the high tie-break
    bits so the index floor argument holds), so a wave of B pods
    spreads over roughly one class worth of rows; at ~32 rows x the
    110-pod row cap that is ~3,500 pods of headroom per wave against a
    512-pod batch and depth-3 pipelining.  Widths that leave <= a few
    rows per class collapse every wave onto the same near-full rows —
    the give-up march the zero-lost gate exists to catch."""
    return max(1, min(18, max(nodes, 2).bit_length() - 1 - 5))


def _node_bytes(i: int, gen: int) -> bytes:
    """make_nodes-shaped node; ``gen`` varies capacity only (the churn
    lane must never be structural)."""
    from k8s1m_tpu_torch.control.objects import encode_node
    from k8s1m_tpu_torch.tools.make_nodes import build_node

    node = build_node(i)
    if gen >= 0:
        node.cpu_milli = 32000 + (gen % 16)
    return encode_node(node)


def register_nodes(store, n: int, bulk: int) -> dict:
    """Phase 1: the bulk registration lane (store put-frames)."""
    from k8s1m_tpu_torch.control.objects import node_key
    from k8s1m_tpu_torch.tools.make_nodes import build_node

    from k8s1m_tpu_torch.tools.common import RateReporter

    reporter = RateReporter("nodes registered", quiet=True,
                            milestone=100_000)
    t0 = time.perf_counter()
    batch: list = []
    done = 0
    for i in range(n):
        name = build_node(i).name
        batch.append((node_key(name), _node_bytes(i, -1)))
        if len(batch) >= bulk:
            store.put_batch(batch)
            done += len(batch)
            reporter.add(len(batch))
            batch = []
    if batch:
        store.put_batch(batch)
        done += len(batch)
        reporter.add(len(batch))
    dt = time.perf_counter() - t0
    return {
        "nodes": done,
        "seconds": round(dt, 3),
        "rate_per_sec": round(done / dt, 1) if dt > 0 else 0.0,
        "bulk": bulk,
    }


def cold_build_compare(n: int, packing: str, device="cuda") -> dict:
    """Phase 3: the >= 3x acceptance proxy at the 131k shape — one
    store, both cold-build lanes, identical layouts.  Bulk runs first
    so any process warm-up favors the baseline.  Each lane ends with the
    table on ``device``, timed up to ``torch.cuda.synchronize()`` on the
    card."""
    import numpy as np
    import torch

    from k8s1m_tpu_torch.device import resolve_device

    from k8s1m_tpu_torch.config import TableSpec
    from k8s1m_tpu_torch.control.objects import decode_node, node_key
    from k8s1m_tpu_torch.snapshot.bulkload import BulkNodeLoader
    from k8s1m_tpu_torch.snapshot.node_table import NodeTableHost
    from k8s1m_tpu_torch.snapshot.packing import pack_table_auto
    from k8s1m_tpu_torch.store.native import (
        MemStore,
        list_prefix,
        list_prefix_values,
    )
    dev = resolve_device(device)
    prefix = b"/registry/minions/"
    store = MemStore()
    batch: list = []
    for i in range(n):
        batch.append((node_key(f"kwok-node-{i}"), _node_bytes(i, -1)))
        if len(batch) >= 8192:
            store.put_batch(batch)
            batch = []
    if batch:
        store.put_batch(batch)
    spec = TableSpec(max_nodes=n, max_zones=16, max_regions=8)

    def build(table_host):
        if packing == "packed":
            table = pack_table_auto(table_host, spec, dev)
        else:
            table = table_host.to_device(dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return table

    t0 = time.perf_counter()
    values, _rev = list_prefix_values(store, prefix)
    host_new = NodeTableHost(spec)
    BulkNodeLoader(host_new).ingest(values)
    del values
    build(host_new)
    bulk_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    kvs, _rev = list_prefix(store, prefix)
    host_old = NodeTableHost(spec)
    for kv in kvs:
        host_old.upsert(decode_node(kv.value))
    del kvs
    build(host_old)
    loop_s = time.perf_counter() - t0

    identical = all(
        np.array_equal(getattr(host_old, c), getattr(host_new, c))
        for c in ("valid", "cpu_alloc", "mem_alloc", "pods_alloc",
                  "label_key", "label_val", "label_num",
                  "taint_id", "taint_effect", "zone", "region", "name_id")
    ) and host_old._row_of == host_new._row_of
    store.close()
    return {
        "nodes": n,
        "per_node_loop_seconds": round(loop_s, 3),
        "bulk_lane_seconds": round(bulk_s, 3),
        "speedup": round(loop_s / bulk_s, 2) if bulk_s > 0 else None,
        "byte_identical": bool(identical),
    }


def index_differential(n: int, args) -> dict | None:
    """Phase 4: composed byte-identity differential — the
    deltacache+index lane vs the full-recompute lane over identical
    stores and submission sequences.  Both lanes run the SAME
    stratum_bits (stratified jitter changes tie-breaks, so the
    differential isolates the index, not the algebra); every bound
    pod's stored bytes must match exactly, and the index lane must
    have taken at least one index wave or the comparison is vacuous.

    Both lanes run a ZERO-DELAY retry policy.  The default policy
    parks a CAS-rolled-back pod behind ``perf_counter() + ~10-20ms``
    of jittered backoff, so whether it rejoins the wave after next or
    the one after depends on how the inter-step wall time raced the
    delay — batch composition (and with it every later tie-break)
    becomes a function of host speed.  Pinning the delay to zero makes
    requeued pods eligible at the very next take, and with it this
    lane has NO wall-clock input left to placement: pod/node intake is
    poll-synchronous (MemStore watch queues drain at step start, no
    pump thread), and no breaker, loadshed controller or adaptive
    bucket is configured here — the only other paths that branch on
    elapsed time.  Validated by running each lane twice at the full
    131,072-row shape and comparing every stored pod byte-for-byte:
    identical run to run, and identical across lanes.  A failure here
    is therefore a REAL index bug, never timing — do not reach for a
    backoff explanation before reproducing the divergence with this
    function standalone."""
    if not n:
        return None
    from k8s1m_tpu_torch.config import PodSpec, TableSpec
    from k8s1m_tpu_torch.control.coordinator import Coordinator
    from k8s1m_tpu_torch.control.objects import encode_pod, node_key, pod_key
    from k8s1m_tpu_torch.engine.deltacache import COUNTERS
    from k8s1m_tpu_torch.faultline.policy import RetryPolicy
    from k8s1m_tpu_torch.plugins.registry import Profile
    from k8s1m_tpu_torch.snapshot.pod_encoding import PodInfo
    from k8s1m_tpu_torch.store.native import MemStore
    from k8s1m_tpu_torch.tools.make_nodes import build_node

    b = args.batch
    waves = 6
    # The differential runs at its own (smaller) shape: a stratum width
    # tuned for the main lane's node count would leave <1 row per class
    # here — re-derive unless the caller pinned --stratum-bits.
    stratum = (
        stratum_bits_for(n) if getattr(args, "stratum_auto", False)
        else args.stratum_bits
    )
    no_backoff = RetryPolicy(
        component="coordinator.bind", base_delay_s=0.0, max_delay_s=0.0,
        jitter=0.0,
    )

    def drive(index_on: bool) -> dict[str, bytes | None]:
        store = MemStore()
        batch: list = []
        for i in range(n):
            batch.append((node_key(build_node(i).name), _node_bytes(i, -1)))
            if len(batch) >= args.bulk:
                store.put_batch(batch)
                batch = []
        if batch:
            store.put_batch(batch)
        coord = Coordinator(
            store,
            TableSpec(max_nodes=n, max_zones=16, max_regions=8),
            PodSpec(batch=b),
            Profile(topology_spread=0, interpod_affinity=0),
            chunk=min(args.chunk, n), k=4, with_constraints=False,
            seed=args.seed, score_pct=100, pipeline=True,
            depth=args.depth, packing=args.packing,
            deltacache="on" if index_on else "off",
            delta_index_k=args.delta_index_k if index_on else 0,
            stratum_bits=stratum,
            retry_policy=no_backoff, device=args.device,
        )
        try:
            coord.bootstrap()
            seq = 0
            churned = 0
            for _ in range(waves):
                for _ in range(b):
                    seq += 1
                    pod = PodInfo(f"d{seq:06d}", namespace="diff",
                                  cpu_milli=10, mem_kib=1 << 10)
                    store.put(pod_key("diff", pod.name), encode_pod(pod))
                # Capacity-only churn, identical rows in both lanes.
                for _ in range(64):
                    i = churned % n
                    store.put(
                        node_key(build_node(i).name),
                        _node_bytes(i, churned),
                    )
                    churned += 1
                coord.step()
            coord.run_until_idle()
            binds: dict[str, bytes | None] = {}
            for s in range(1, seq + 1):
                kv = store.get(pod_key("diff", f"d{s:06d}"))
                binds[f"d{s:06d}"] = kv.value if kv else None
            return binds
        finally:
            coord.close()
            store.close()

    iw = COUNTERS["deltasched_index_waves_total"]
    iw0 = iw["index"]
    with_index = drive(True)
    index_waves = int(iw["index"] - iw0)
    full = drive(False)
    bound = sum(1 for v in full.values() if v and b'"nodeName"' in v)
    return {
        "nodes": n,
        "waves": waves,
        "pods": len(full),
        "bound": bound,
        "stratum_bits": stratum,
        "index_waves": index_waves,
        "byte_identical": bool(with_index == full),
    }


def run(args) -> dict:
    from k8s1m_tpu_torch import faultline
    from k8s1m_tpu_torch.cluster.workload import zipf_weights
    from k8s1m_tpu_torch.config import PodSpec, TableSpec
    from k8s1m_tpu_torch.control.coordinator import Coordinator
    from k8s1m_tpu_torch.control.objects import encode_pod, node_key, pod_key
    from k8s1m_tpu_torch.engine.deltacache import COUNTERS
    from k8s1m_tpu_torch.faultline import FaultPlan, FaultSpec, install_plan
    from k8s1m_tpu_torch.loadshed import (
        HEALTHY,
        SHEDDING,
        STATE_NAMES,
        LoadshedConfig,
        Overloaded,
    )
    from k8s1m_tpu_torch.obs.metrics import REGISTRY
    from k8s1m_tpu_torch.plugins.registry import Profile
    from k8s1m_tpu_torch.snapshot.packing import FALLBACK_REASONS
    from k8s1m_tpu_torch.snapshot.pod_encoding import PodInfo
    from k8s1m_tpu_torch.store.native import MemStore
    from k8s1m_tpu_torch.tenancy import TenancyController, TenancyPolicy
    from k8s1m_tpu_torch.tools.make_nodes import build_node

    b = args.batch
    z = zipf_weights(args.tenants, args.tenant_skew)
    weights = {
        f"tenant-{t}": max(1, round(z[t] / z[-1]))
        for t in range(args.tenants)
    }
    tenants = list(weights)
    total_w = sum(weights.values())
    cfg = LoadshedConfig(
        queue_degraded=3 * b, queue_shed=6 * b, queue_cap=64 * b,
        queue_recover=b, recover_cycles=3,
    )
    tn = TenancyController(
        TenancyPolicy(weights=weights), loadshed_config=cfg,
        name="megarow_drill",
    )
    # Seeded probability, not every_n: a strict period resonates with
    # the steady wave cadence (CAS attempts per wave are near-constant,
    # so a requeued pod can land on the period every retry and be
    # marched to give-up by the injector itself — see --conflict-every).
    plan = FaultPlan(
        [FaultSpec("coordinator.bind", "cas", kind="err5xx",
                   probability=1.0 / max(args.conflict_every, 1))],
        seed=args.seed,
    )

    quiesce = REGISTRY.get("pipeline_quiesce_total")
    q0 = {r: quiesce.value(reason=r) for r in ("structural", "resync")}
    giveups = REGISTRY.get("retry_give_ups_total")
    giveup0 = giveups.value(component="coordinator.bind")
    pack_fb = REGISTRY.get("device_packing_fallback_total")
    fb0 = {r: pack_fb.value(reason=r) for r in FALLBACK_REASONS}
    cold_gauge = REGISTRY.get("megarow_cold_build_seconds")
    mirror_gauge = REGISTRY.get("megarow_host_mirror_bytes")

    compare = (
        cold_build_compare(args.compare_nodes, args.packing, args.device)
        if args.compare_nodes else None
    )
    differential = (
        index_differential(args.differential_nodes, args)
        if args.delta_index_k else None
    )

    # Index baselines AFTER the differential lane (which takes its own
    # index waves) so the window accounting below is the window's own.
    idx_waves = COUNTERS["deltasched_index_waves_total"]
    idx_drops = COUNTERS["deltasched_index_drops_total"]
    iw0 = {p: idx_waves[p] for p in ("index", "plane")}
    _DROP_REASONS = ("underflow", "oversized-dirty", "fill",
                     "generation", "resync", "packing",
                     "fill-error", "dispatch-error")
    id0 = {r: idx_drops[r] for r in _DROP_REASONS}

    store = MemStore()
    ingest = register_nodes(store, args.nodes, args.bulk)

    coord = Coordinator(
        store,
        TableSpec(max_nodes=args.nodes, max_zones=16, max_regions=8),
        PodSpec(batch=b), Profile(topology_spread=0, interpod_affinity=0),
        chunk=args.chunk, k=4, with_constraints=False, seed=args.seed,
        score_pct=args.score_pct, pipeline=True, depth=args.depth,
        tenancy=tn, packing=args.packing,
        deltacache=args.deltacache, delta_index_k=args.delta_index_k,
        stratum_bits=args.stratum_bits, device=args.device,
    )

    seq = 0
    churned = 0
    admitted: list[tuple[str, str]] = []
    rejected = 0
    bound_total = 0
    states_seen: set[int] = set()
    depth_samples: list[int] = []
    recovered_at = None

    def submit(n: int) -> None:
        nonlocal seq, rejected
        lanes = []
        for t in tenants:
            share = max(1, round(n * weights[t] / total_w))
            lanes += [(k / share, t) for k in range(share)]
        lanes.sort()
        for _, t in lanes:
            seq += 1
            pod = PodInfo(f"p{seq:07d}", namespace=t,
                          cpu_milli=10, mem_kib=1 << 10)
            obj = json.loads(encode_pod(pod))
            try:
                coord.submit_external(obj)
            except Overloaded:
                rejected += 1
                continue
            store.put(pod_key(t, pod.name), encode_pod(pod))
            admitted.append((t, pod.name))

    def sat_submit(n: int) -> None:
        """Store-put intake (the watch path): no admission draw, so the
        saturation phase measures the scheduler, not the shedder."""
        nonlocal seq
        for _ in range(n):
            seq += 1
            t = tenants[seq % len(tenants)]
            pod = PodInfo(f"p{seq:07d}", namespace=t,
                          cpu_milli=10, mem_kib=1 << 10)
            store.put(pod_key(t, pod.name), encode_pod(pod))
            admitted.append((t, pod.name))

    def churn_tick() -> None:
        nonlocal churned
        for _ in range(args.churn_per_tick):
            i = churned % args.nodes
            store.put(
                node_key(build_node(i).name), _node_bytes(i, churned)
            )
            churned += 1

    def tick(n: int, producing: bool) -> None:
        nonlocal bound_total
        submit(n)
        churn_tick()
        bound_total += coord.step()
        states_seen.add(tn.controller.current_state())
        if producing:
            depth_samples.append(len(coord._inflights))

    try:
        t0 = time.perf_counter()
        coord.bootstrap()
        cold_build_s = time.perf_counter() - t0
        print(
            f"cold build: {cold_build_s:,.1f}s at {args.nodes:,} rows",
            flush=True,
        )
        # Warm the compile caches outside the measured window.
        submit(b)
        coord.run_until_idle()
        bound_warm = len(admitted)
        install_plan(plan)
        t_win = time.perf_counter()
        for _ in range(args.steady_ticks):
            tick(b, True)
        for _ in range(args.overload_ticks):
            tick(args.factor * b, True)
        for t in range(args.recover_ticks):
            tick(b // 2, False)
            if (
                tn.controller.current_state() == HEALTHY
                and recovered_at is None
            ):
                recovered_at = t + 1
        # Saturated-throughput phase: backlog held near 2x batch (below
        # the 3x degraded watermark, so the production mode is what is
        # measured), churn still landing every tick.
        sat_submit(2 * b)
        sat_bound = 0
        t_sat = time.perf_counter()
        for _ in range(args.sat_ticks):
            churn_tick()
            done = coord.step()
            sat_bound += done
            bound_total += done
            states_seen.add(tn.controller.current_state())
            sat_submit(done)
        sat_s = time.perf_counter() - t_sat
        for _ in range(IDLE_DRAIN_TICKS):
            if (
                not coord.queue and not coord._backoff
                and not coord._external_pending() and not coord._inflights
            ):
                break
            bound_total += coord.step()
            w = coord.backoff_wait_s()
            if w:
                time.sleep(min(w, 0.05))
        bound_total += coord.flush()
        window_s = time.perf_counter() - t_win
        install_plan(None)
        lost = 0
        for t, name in admitted:
            kv = store.get(pod_key(t, name))
            if kv is None or b'"nodeName"' not in kv.value:
                lost += 1
        host_mirror_bytes = int(coord.host.mirror_nbytes())
        delta_on = coord.delta_enabled
    finally:
        install_plan(None)
        coord.close()
        store.close()

    import numpy as np

    samples = np.asarray(depth_samples or [0])
    qd = {r: int(quiesce.value(reason=r) - q0[r]) for r in q0}
    give_ups = giveups.value(component="coordinator.bind") - giveup0
    packing_fallbacks = sum(
        int(pack_fb.value(reason=r) - fb0[r]) for r in fb0
    )
    window_bound = len(admitted) - bound_warm - lost
    binds_per_sec = round(window_bound / window_s, 1) if window_s else 0.0
    sat_rate = round(sat_bound / sat_s, 1) if sat_s else 0.0
    rss = round(peak_rss_mib(), 1)
    return {
        "nodes": args.nodes,
        "weights": weights,
        "packing": args.packing,
        "deltacache": "on" if delta_on else "off",
        "score_pct": args.score_pct,
        "delta_index_k": args.delta_index_k,
        "stratum_bits": args.stratum_bits,
        "index_waves": {p: int(idx_waves[p] - iw0[p]) for p in iw0},
        "index_drops": {
            r: int(idx_drops[r] - id0[r]) for r in id0 if idx_drops[r] - id0[r]
        },
        "index_differential": differential,
        "bulk_ingest": ingest,
        "cold_build_seconds": round(cold_build_s, 3),
        "cold_build_metric_seconds": round(cold_gauge.value(), 3),
        "cold_build_compare": compare,
        "host_mirror_bytes": host_mirror_bytes,
        "host_mirror_bytes_metric": int(mirror_gauge.value()),
        "peak_rss_mib": rss,
        "rss_budget_mib": args.rss_budget_mib or None,
        "window_seconds": round(window_s, 3),
        "window_bound": window_bound,
        "binds_per_sec_composed": binds_per_sec,
        "saturated_seconds": round(sat_s, 3),
        "saturated_bound": sat_bound,
        "binds_per_sec": sat_rate,
        "admitted": len(admitted),
        "rejected": rejected,
        "lost": lost,
        "node_churn_events": churned,
        "pipeline_quiesce": qd,
        "sustained_inflight_depth": int(np.median(samples)),
        "max_inflight_depth": int(samples.max()),
        "states_seen": sorted(STATE_NAMES[s] for s in states_seen),
        "recovered_at_tick": recovered_at,
        "retry_give_ups": int(give_ups),
        "packing_fallbacks": packing_fallbacks,
        "passed": bool(
            lost == 0
            and qd["structural"] == 0
            and qd["resync"] == 0
            and int(np.median(samples)) >= args.depth
            and SHEDDING in states_seen
            and recovered_at is not None
            and give_ups == 0
            and (args.packing != "packed" or packing_fallbacks == 0)
            and (
                compare is None
                or (compare["byte_identical"] and compare["speedup"] >= 3.0)
            )
            and (
                differential is None
                or (
                    differential["byte_identical"]
                    and differential["index_waves"] > 0
                    and differential["bound"] > 0
                )
            )
            and (not args.rss_budget_mib or rss <= args.rss_budget_mib)
        ),
    }


def main(argv=None) -> dict:
    args = parse_args(argv)
    evidence = run(args)
    result = {
        "metric": f"pod_binds_per_sec_{args.nodes}_nodes",
        "value": evidence["binds_per_sec"],
        "unit": f"binds/s, saturated phase under sustained churn ({args.device})",
        "vs_baseline": None,
        "passed": evidence["passed"],
        "seed": args.seed,
        "shape": {
            "nodes": args.nodes, "batch": args.batch,
            "chunk": args.chunk, "depth": args.depth,
            "tenants": args.tenants, "factor": args.factor,
            "churn_per_tick": args.churn_per_tick,
            "packing": args.packing, "deltacache": args.deltacache,
            "score_pct": args.score_pct,
            "delta_index_k": args.delta_index_k,
            "stratum_bits": args.stratum_bits,
            "smoke": bool(args.smoke),
        },
        "evidence": evidence,
    }
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=2, sort_keys=True)
            f.write("\n")
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
