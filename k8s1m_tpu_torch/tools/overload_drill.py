"""Deterministic overload drill: shed, degrade, break, recover — by seed.

The port's own copy of ``k8s1m_tpu/tools/overload_drill.py``, on the card
unless ``--device cpu`` is given.  Its coordinators take the port's
default ``backend="auto"``: the kernels on ``cuda``, the scan path on the
CPU (the JAX drill runs the XLA scan path).  The overload evidence as one
reproducible run:
an in-process store + coordinator under a 5x sustained submit burst,
tick-driven on a **virtual clock** (one tick = one scheduling cycle;
every controller and breaker decision is counted in cycles, so the
whole trajectory is a pure function of the submit schedule and the
seed — no wall-clock anywhere in the gates).  ``--tick-s`` > 0 adds a
real sleep per tick for wall-clock observation runs; the wall-clock
shape is ``sched_bench --rate R --overload-at S``, which drives the same
machinery through the paced producer.

Phases:

1. **healthy** — submit at 1x capacity (one batch per tick); baseline
   binds/tick.
2. **overload** — submit at ``--factor`` x capacity: the controller
   must walk HEALTHY -> DEGRADED -> SHEDDING, admission must hold the
   queue under ``queue_cap`` while shedding the lowest-priority pods
   first, and binds/tick must stay >= 50% of the healthy baseline.
3. **recovery** — submit at 0.5x capacity: the controller must walk
   back to HEALTHY (hysteresis) within ``--recover-ticks``, and every
   admitted pod must be bound in the store — the zero-loss ledger.
4. **breaker** (separate fresh store) — injected ``stall`` faults on
   cycle dispatch open the circuit breaker; open-state batches bind
   through the host-side oracle (asserted **byte-identical** to an
   independent replay of the oracle), and the half-open probe closes
   the breaker again.

    python -m k8s1m_tpu_torch.tools.overload_drill --smoke --device cpu
    python -m k8s1m_tpu_torch.tools.overload_drill --out chiprun_out/overload.json

``--smoke`` is the tier-1 shape (seconds on CPU); the default shape is
the same drill at bench scale.  Pass criteria print as one JSON line
(``passed``) and the full evidence lands in ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import time

IDLE_DRAIN_TICKS = 2000


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="deterministic overload drill")
    ap.add_argument("--nodes", type=int, default=1024)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--chunk", type=int, default=256)
    ap.add_argument("--score-pct", type=int, default=50)
    ap.add_argument("--degraded-score-pct", type=int, default=13)
    ap.add_argument("--factor", type=int, default=5,
                    help="overload submit rate, in multiples of one "
                    "batch per tick")
    ap.add_argument("--healthy-ticks", type=int, default=8)
    ap.add_argument("--overload-ticks", type=int, default=10)
    ap.add_argument("--recover-ticks", type=int, default=40,
                    help="budget (ticks) for the walk back to HEALTHY")
    ap.add_argument("--priorities", type=int, default=4,
                    help="pods cycle through spec.priority 0..P-1")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--tick-s", type=float, default=0.0,
                    help="wall sleep per tick (0 = pure virtual clock)")
    ap.add_argument("--smoke", action="store_true",
                    help="tier-1 shape: tiny cluster, same gates")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default=None, help="evidence JSON path")
    args = ap.parse_args(argv)
    if args.smoke:
        args.nodes, args.batch, args.chunk = 64, 32, 16
        args.score_pct, args.degraded_score_pct = 50, 25
        args.healthy_ticks, args.overload_ticks = 6, 6
        args.recover_ticks = 30
    return args


def _mk_cluster(args, *, loadshed=None, breaker=None, tenancy=None,
                ns="default"):
    """Store + coordinator of the drill shape (caller owns both)."""
    from k8s1m_tpu_torch.config import PodSpec, TableSpec
    from k8s1m_tpu_torch.control.coordinator import Coordinator
    from k8s1m_tpu_torch.control.objects import encode_node, node_key
    from k8s1m_tpu_torch.plugins.registry import Profile
    from k8s1m_tpu_torch.snapshot.node_table import NodeInfo
    from k8s1m_tpu_torch.store.native import MemStore

    store = MemStore()
    for i in range(args.nodes):
        store.put(node_key(f"n{i:05d}"), encode_node(NodeInfo(
            name=f"n{i:05d}", cpu_milli=64_000, mem_kib=64 << 20, pods=256,
        )))
    coord = Coordinator(
        store,
        TableSpec(max_nodes=args.nodes, max_zones=16, max_regions=8),
        PodSpec(batch=args.batch),
        Profile(topology_spread=0, interpod_affinity=0),
        chunk=args.chunk, k=4, with_constraints=False, seed=args.seed,
        score_pct=args.score_pct, loadshed=loadshed, breaker=breaker,
        tenancy=tenancy, device=args.device,
    )
    coord.bootstrap()
    return store, coord


def _submit(store, coord, start: int, n: int, priorities: int, accept, reject):
    """Offer ``n`` pods through the admission path (webhook shape:
    submit_external + the apiserver's store write on accept).  Priority
    cycles P-1..0 so every level is offered equally, descending within
    each round: when the hard queue cap cuts a round off mid-way, the
    suffix it rejects is the low-priority end — which is what makes the
    per-level acceptance counts exactly monotone in priority (the gate
    below) instead of monotone-up-to-round-truncation."""
    import json as _json

    from k8s1m_tpu_torch.control.objects import encode_pod, pod_key
    from k8s1m_tpu_torch.loadshed import Overloaded
    from k8s1m_tpu_torch.snapshot.pod_encoding import PodInfo

    for i in range(start, start + n):
        prio = priorities - 1 - (i % priorities)
        pod = PodInfo(f"p{i:07d}", cpu_milli=10, mem_kib=1 << 10)
        obj = _json.loads(encode_pod(pod))
        obj["spec"]["priority"] = prio
        try:
            coord.submit_external(obj)
        except Overloaded:
            reject[prio] += 1
            continue
        accept[prio] += 1
        # The apiserver persists the admitted pod (canonical bytes: the
        # admission-only priority field stays out of the stored object
        # so the native fast lane and the splice path apply).
        store.put(pod_key("default", pod.name), encode_pod(pod))
    return start + n


def run_overload(args) -> dict:
    """Phases 1-3: shed + degrade + recover.  Returns the evidence dict."""
    from k8s1m_tpu_torch.loadshed import (
        HEALTHY,
        SHEDDING,
        STATE_NAMES,
        HealthController,
        LoadshedConfig,
    )

    b = args.batch
    cfg = LoadshedConfig(
        queue_degraded=2 * b, queue_shed=4 * b, queue_cap=6 * b,
        queue_recover=b // 2, recover_cycles=3,
        degraded_score_pct=args.degraded_score_pct,
    )
    ls = HealthController(cfg, name="overload_drill")
    store, coord = _mk_cluster(args, loadshed=ls)
    accept = [0] * args.priorities
    reject = [0] * args.priorities
    o_accept = [0] * args.priorities
    o_reject = [0] * args.priorities
    seq = 0
    max_load = 0
    states_seen = set()
    binds = {"healthy": [], "overload": [], "recovery": []}

    def tick(phase: str, submit_n: int) -> None:
        nonlocal seq, max_load
        before = [accept[i] for i in range(args.priorities)], \
            [reject[i] for i in range(args.priorities)]
        seq = _submit(store, coord, seq, submit_n, args.priorities,
                      accept, reject)
        if phase == "overload":
            for i in range(args.priorities):
                o_accept[i] += accept[i] - before[0][i]
                o_reject[i] += reject[i] - before[1][i]
        binds[phase].append(coord.step())
        states_seen.add(ls.state)
        max_load = max(max_load, len(coord.queue) + len(coord._backoff))
        if args.tick_s:
            time.sleep(args.tick_s)

    try:
        for _ in range(args.healthy_ticks):
            tick("healthy", b)
        for _ in range(args.overload_ticks):
            tick("overload", args.factor * b)
        recovered_at = None
        for t in range(args.recover_ticks):
            tick("recovery", b // 2)
            if ls.state == HEALTHY and recovered_at is None:
                recovered_at = t + 1
        # Drain: every admitted pod must land (the zero-loss ledger).
        for _ in range(IDLE_DRAIN_TICKS):
            if not coord.queue and not coord._backoff and not coord._external:
                break
            binds["recovery"].append(coord.step())
            if coord.backoff_wait_s():
                time.sleep(min(coord.backoff_wait_s(), 0.05))
        coord.flush()

        admitted = sum(accept)
        bound_total = sum(sum(v) for v in binds.values())
        # Ledger settles on the store, not our counters: every admitted
        # pod's object must carry a nodeName.
        import json as _json

        from k8s1m_tpu_torch.control.objects import pod_key

        lost = 0
        for i in range(seq):
            kv = store.get(pod_key("default", f"p{i:07d}"))
            if kv is None:
                continue          # rejected pods were never persisted
            if not _json.loads(kv.value)["spec"].get("nodeName"):
                lost += 1
    finally:
        coord.close()
        store.close()

    def per_tick(xs):
        return round(sum(xs) / max(len(xs), 1), 2)

    healthy_rate = per_tick(binds["healthy"])
    overload_rate = per_tick(binds["overload"])
    # Monotone acceptance: a lower priority never out-admits a higher
    # one during the overload phase (equal offered counts per level).
    monotone = all(
        o_accept[i] <= o_accept[i + 1] for i in range(args.priorities - 1)
    )
    return {
        "queue_cap": cfg.queue_cap,
        "max_load": max_load,
        "states_seen": sorted(STATE_NAMES[s] for s in states_seen),
        "healthy_binds_per_tick": healthy_rate,
        "overload_binds_per_tick": overload_rate,
        "throughput_ratio": round(overload_rate / max(healthy_rate, 1e-9), 3),
        "recovered_at_tick": recovered_at,
        "admitted": admitted,
        "rejected_by_priority": reject,
        "accepted_by_priority": accept,
        "overload_accepted_by_priority": o_accept,
        "overload_rejected_by_priority": o_reject,
        "bound": bound_total,
        "lost": lost,
        "monotone_acceptance": monotone,
        "passed": bool(
            max_load <= cfg.queue_cap
            and SHEDDING in states_seen
            and overload_rate >= 0.5 * healthy_rate
            and sum(o_reject) > 0
            and monotone
            and recovered_at is not None
            and lost == 0
            and bound_total == admitted
        ),
    }


def run_breaker(args) -> dict:
    """Phase 4: stall-open the breaker, bind through the oracle, prove
    the stored bytes byte-identical to an independent oracle replay,
    then close via the half-open probe."""
    import json as _json

    from k8s1m_tpu_torch.control.coordinator import splice_node_name
    from k8s1m_tpu_torch.control.objects import decode_node, encode_pod, pod_key
    from k8s1m_tpu_torch.faultline import FaultPlan, FaultSpec, install_plan
    from k8s1m_tpu_torch.loadshed import (
        CLOSED,
        OPEN,
        BreakerConfig,
        CircuitBreaker,
    )
    from k8s1m_tpu_torch.oracle import oracle_feasible, oracle_score
    from k8s1m_tpu_torch.snapshot.pod_encoding import PodInfo
    from k8s1m_tpu_torch.store.native import list_prefix

    b = min(args.batch, 64)
    threshold = 2
    # cooldown 3: the two open cycles after the trip are the fallback
    # waves A and B; the third allow() is the half-open probe (wave C).
    br = CircuitBreaker(BreakerConfig(
        failure_threshold=threshold, cooldown_cycles=3, fallback_batch=b,
    ), component="overload_drill.cycle")
    plan = FaultPlan(
        [FaultSpec("coordinator.cycle", "dispatch", kind="stall",
                   every_n=1, max_fires=threshold)],
        seed=args.seed,
    )
    install_plan(plan)
    store, coord = _mk_cluster(args, breaker=br)
    opened = fallback_bound = 0
    mismatches = []
    try:
        raws = {}
        fallback_keys: list[str] = []

        def put_wave(tag: str):
            for i in range(b):
                pod = PodInfo(f"{tag}{i:04d}", cpu_milli=10, mem_kib=1 << 10)
                raw = encode_pod(pod)
                raws[pod.key] = raw
                store.put(pod_key("default", pod.name), raw)

        # Wave A trips the breaker (two stalls), then binds via oracle
        # fallback; wave B binds via fallback during cooldown; wave C is
        # the half-open probe (the stall budget is exhausted) and must
        # close the breaker on the device path.
        put_wave("a")
        for _ in range(threshold):
            coord.step()                      # stalls: breaker counts
        opened = int(br.state == OPEN)
        pre = _snapshot_usage(coord)
        n_a = coord.step()                    # fallback wave A
        fallback_keys += [f"default/a{i:04d}" for i in range(b)]
        put_wave("b")
        n_b = coord.step()                    # fallback wave B (cooldown)
        fallback_keys += [f"default/b{i:04d}" for i in range(b)]
        fallback_bound = n_a + n_b
        put_wave("c")
        n_c = 0
        for _ in range(8):
            n_c += coord.step()
            if br.state == CLOSED:
                break
        closed_again = br.state == CLOSED

        # Independent oracle replay over the SAME pre-fallback snapshot:
        # argmax oracle_score over feasible rows, earlier row wins ties,
        # usage updated pod by pod — the exact contract
        # Coordinator._fallback_schedule documents.  The stored bytes
        # must equal splice_node_name(raw, that choice).
        kvs, _ = list_prefix(store, b"/registry/minions/")
        nodes = []
        for kv in kvs:
            nd = decode_node(kv.value)
            nodes.append((coord.host.row_of(nd.name), nd))
        nodes.sort(key=lambda t: t[0])
        weights = (
            coord.profile.least_allocated, coord.profile.balanced_allocation,
            coord.profile.taint_toleration, coord.profile.node_affinity,
        )
        usage = pre
        for key in fallback_keys:
            ns, name = key.split("/", 1)
            pod = PodInfo(name, cpu_milli=10, mem_kib=1 << 10)
            best_row, best_score, best = -1, -1, None
            for row, nd in nodes:
                req = usage[row]
                if not oracle_feasible(nd, pod, req):
                    continue
                s = oracle_score(
                    nd, pod, req,
                    taint_slots=coord.table_spec.taint_slots,
                    weights=weights,
                )
                if s > best_score:
                    best_row, best_score, best = row, s, nd
            if best is None:
                mismatches.append((key, "oracle found no node"))
                continue
            usage[best_row] = (
                usage[best_row][0] + pod.cpu_milli,
                usage[best_row][1] + pod.mem_kib,
                usage[best_row][2] + 1,
            )
            want = splice_node_name(raws[key], best.name)
            got = store.get(pod_key(ns, name))
            if got is None or got.value != want:
                mismatches.append((key, best.name))
    finally:
        install_plan(None)
        coord.close()
        store.close()
    return {
        "stall_plan": _json.loads(plan.to_json()),
        "opened": bool(opened),
        "fallback_binds": fallback_bound,
        "byte_identical": not mismatches,
        "mismatches": mismatches[:5],
        "probe_binds": n_c,
        "closed_again": bool(closed_again),
        "passed": bool(
            opened and fallback_bound == 2 * b and not mismatches
            and closed_again and n_c >= b
        ),
    }


def run_tenant_asym(args) -> dict:
    """Two-tenant asymmetric overload (tenancy/admission.py): equal
    weights, the heavy tenant offering 10x the light tenant's rate, the
    aggregate a sustained overload.  The weighted-fair buckets must hold
    the light tenant's ADMITTED share within 10% of its weight share
    (0.5) for the whole enforcement window — the exact starvation the
    global priority floor could not prevent (both tenants submit at the
    same priority)."""
    import json as _json

    from k8s1m_tpu_torch.control.objects import encode_pod, pod_key
    from k8s1m_tpu_torch.loadshed import HEALTHY, LoadshedConfig, Overloaded
    from k8s1m_tpu_torch.snapshot.pod_encoding import PodInfo
    from k8s1m_tpu_torch.tenancy import TenancyController, TenancyPolicy

    b = args.batch
    cfg = LoadshedConfig(
        queue_degraded=2 * b, queue_shed=4 * b, queue_cap=64 * b,
        queue_recover=b // 2, recover_cycles=3,
        degraded_score_pct=args.degraded_score_pct,
    )
    tn = TenancyController(
        TenancyPolicy(weights={"heavy": 1, "light": 1}),
        loadshed_config=cfg, name="tenant_asym",
    )
    store, coord = _mk_cluster(args, tenancy=tn)
    # Light saturates just past its fair share (0.55 x capacity), heavy
    # offers 10x that: ~6x aggregate overload, every tenant saturating,
    # so admitted throughput should track weight shares exactly.
    light_per_tick = max(1, int(0.55 * b))
    heavy_per_tick = 10 * light_per_tick
    total = light_per_tick + heavy_per_tick
    seq = 0
    enforce_base = None
    enforce_ticks = 0
    try:
        for tick in range(args.healthy_ticks + 6 * args.overload_ticks):
            # Bresenham-interleaved arrivals: light pods spread through
            # the heavy flood (a bursty arrival order would test the
            # queue cap, not the fairness layer).
            acc = 0
            for i in range(total):
                acc += light_per_tick
                tenant = "light" if acc >= total else "heavy"
                if acc >= total:
                    acc -= total
                pod = PodInfo(
                    f"t{tick:03d}-{i:05d}", namespace=tenant,
                    cpu_milli=10, mem_kib=1 << 10,
                )
                obj = _json.loads(encode_pod(pod))
                try:
                    coord.submit_external(obj)
                except Overloaded:
                    continue
                store.put(pod_key(tenant, pod.name), encode_pod(pod))
                seq += 1
            coord.step()
            state = tn.controller.current_state()
            if state != HEALTHY:
                if enforce_base is None:
                    # Enforcement just engaged: measure shares from here
                    # (the pre-pressure ticks legitimately admit all).
                    enforce_base = tn.admission.counters()["admitted"]
                else:
                    enforce_ticks += 1
    finally:
        counters = tn.admission.counters()
        coord.close()
        store.close()
    adm = counters["admitted"]
    base = enforce_base or {}
    adm_l = adm.get("light", 0) - base.get("light", 0)
    adm_h = adm.get("heavy", 0) - base.get("heavy", 0)
    share_l = adm_l / max(adm_l + adm_h, 1)
    weight_share = 0.5
    return {
        "offered_per_tick": {"heavy": heavy_per_tick, "light": light_per_tick},
        "enforce_ticks": enforce_ticks,
        "admitted_under_enforcement": {"light": adm_l, "heavy": adm_h},
        "light_admitted_share": round(share_l, 4),
        "light_weight_share": weight_share,
        "rejected": counters["rejected"],
        "passed": bool(
            enforce_ticks >= 5
            and adm_l > 0
            and abs(share_l - weight_share) <= 0.10 * weight_share
        ),
    }


def _snapshot_usage(coord) -> dict[int, tuple[int, int, int]]:
    """Per-row (cpu, mem, pods) requested usage, copied host-side."""
    h = coord.host
    return {
        row: (int(h.cpu_req[row]), int(h.mem_req[row]), int(h.pods_req[row]))
        for row in h._row_of.values()
    }


def main(argv=None) -> dict:
    args = parse_args(argv)
    overload = run_overload(args)
    breaker = run_breaker(args)
    tenant_asym = run_tenant_asym(args)
    result = {
        "metric": "overload_drill" + ("_smoke" if args.smoke else ""),
        "value": overload["throughput_ratio"],
        "unit": "degraded/healthy binds ratio",
        "vs_baseline": None,
        "passed": bool(
            overload["passed"] and breaker["passed"]
            and tenant_asym["passed"]
        ),
        "seed": args.seed,
        "device": str(args.device),
        "shape": {
            "nodes": args.nodes, "batch": args.batch, "chunk": args.chunk,
            "score_pct": args.score_pct,
            "degraded_score_pct": args.degraded_score_pct,
            "factor": args.factor, "priorities": args.priorities,
        },
        "overload": overload,
        "breaker": breaker,
        "tenant_asym": tenant_asym,
    }
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
