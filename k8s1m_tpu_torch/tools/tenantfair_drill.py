"""Deterministic tenantfair drill: weighted-fair shares, preemption,
gangs — by seed, as one reproducible run in the overload_drill mold.

The port's own copy of ``k8s1m_tpu/tools/tenantfair_drill.py``, on the
card unless ``--device cpu`` is given (coordinators on the port's default
``backend="auto"``: the kernels on ``cuda``, the scan path on the CPU).

Phase 1 — **fairness** (run under ``lint.guards.audit()``): N tenants
with zipf-skewed integer weights submit at a sustained 5x aggregate
overload through ``Coordinator.submit_external`` + the weighted-fair
admission (tenancy/admission.py), tick-driven on a virtual clock.
Gates: every *saturating* tenant's admitted throughput lands within 10%
of its weight share over the enforcement window; the one deliberately
non-saturating tenant gets essentially everything it offered; the queue
stays under the hard cap; after the drain every admitted pod is bound
in the store (zero-loss ledger); zero ``@guarded_by`` violations.

Phase 2 — **preemption + gang** (fresh store): low-priority filler pods
saturate every node's pod slots, then a high-priority GANG (labels
``k8s1m.io/gang``/``gang-size``) arrives.  No feasible row exists, so
each member preempts: victims are selected by the documented order
(lowest priority, other-tenant first, newest bind first), evicted via
the store CAS (stored bytes return EXACTLY to their pre-bind encoding —
the unsplice identity) and requeued; the gang binds all-or-none inside
one wave-epoch window.  Gates: the gang settles ``bound`` (never
partial), every eviction is logged and every victim requeued, zero pods
lost in the ledger, and the whole evict+rebind is **byte-identical to a
replay**: ``select_preemption`` re-run offline on each event's logged
pre-state picks the same node and victims, and the stored bytes equal
``splice_node_name(raw, that node)`` for the preemptor and the original
``raw`` for each still-pending victim.

    python -m k8s1m_tpu_torch.tools.tenantfair_drill --smoke --device cpu
    python -m k8s1m_tpu_torch.tools.tenantfair_drill --out chiprun_out/tenantfair.json

``--smoke`` is the tier-1 shape (seconds on CPU); the default shape is
the same drill bigger.  One JSON line (``passed``) prints; the full
evidence lands in ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os

IDLE_DRAIN_TICKS = 2000


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="deterministic tenantfair drill")
    ap.add_argument("--nodes", type=int, default=256)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--chunk", type=int, default=256)
    ap.add_argument("--tenants", type=int, default=8)
    ap.add_argument("--tenant-skew", type=float, default=1.0)
    ap.add_argument("--factor", type=int, default=5,
                    help="aggregate overload, in multiples of one batch "
                    "per tick")
    ap.add_argument("--warm-ticks", type=int, default=4)
    ap.add_argument("--measure-ticks", type=int, default=40)
    ap.add_argument("--gang-size", type=int, default=4)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--smoke", action="store_true",
                    help="tier-1 shape: tiny cluster, same gates")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.smoke:
        args.nodes, args.batch, args.chunk = 64, 64, 32
        args.tenants = 4
        args.measure_ticks = 24
    return args


def _weights(args) -> dict[str, int]:
    """Zipf-skewed integer weights, tenant-0 heaviest."""
    from k8s1m_tpu_torch.cluster.workload import zipf_weights

    z = zipf_weights(args.tenants, args.tenant_skew)
    return {
        f"tenant-{t}": max(1, round(z[t] / z[-1]))
        for t in range(args.tenants)
    }


def run_fairness(args) -> dict:
    """Phase 1: weighted-fair admission under 5x aggregate overload,
    with the guard audit live for the whole phase."""
    from k8s1m_tpu_torch.config import PodSpec, TableSpec
    from k8s1m_tpu_torch.control.coordinator import Coordinator
    from k8s1m_tpu_torch.control.objects import (
        encode_node,
        encode_pod,
        node_key,
        pod_key,
    )
    from k8s1m_tpu_torch.lint import guards
    from k8s1m_tpu_torch.loadshed import HEALTHY, LoadshedConfig, Overloaded
    from k8s1m_tpu_torch.plugins.registry import Profile
    from k8s1m_tpu_torch.snapshot.node_table import NodeInfo
    from k8s1m_tpu_torch.snapshot.pod_encoding import PodInfo
    from k8s1m_tpu_torch.store.native import MemStore
    from k8s1m_tpu_torch.tenancy import TenancyController, TenancyPolicy

    b = args.batch
    weights = _weights(args)
    total_w = sum(weights.values())
    tenants = sorted(weights, key=lambda t: int(t.split("-")[1]))
    # Offered profile: every tenant floods at `factor` x its weight
    # share — except the LAST (lightest) tenant, deliberately offered
    # under its share: the non-saturating gate (it must get ~everything
    # it asks for while the flooders are clamped to their shares).
    offered = {}
    for t in tenants:
        share = b * weights[t] / total_w
        offered[t] = max(1, int(args.factor * share))
    lightest = tenants[-1]
    offered[lightest] = max(1, int(0.4 * b * weights[lightest] / total_w))

    cfg = LoadshedConfig(
        queue_degraded=2 * b, queue_shed=4 * b, queue_cap=64 * b,
        queue_recover=b // 2, recover_cycles=3,
    )
    tn = TenancyController(
        TenancyPolicy(weights=weights), loadshed_config=cfg,
        name="tenantfair_drill",
    )
    store = MemStore()
    for i in range(args.nodes):
        store.put(node_key(f"n{i:05d}"), encode_node(NodeInfo(
            name=f"n{i:05d}", cpu_milli=1 << 22, mem_kib=1 << 30,
            pods=1 << 20,
        )))
    coord = Coordinator(
        store, TableSpec(max_nodes=args.nodes, max_zones=16, max_regions=8),
        PodSpec(batch=b), Profile(topology_spread=0, interpod_affinity=0),
        chunk=args.chunk, k=4, with_constraints=False, seed=args.seed,
        score_pct=50, tenancy=tn, device=args.device,
    )
    seq = 0
    max_load = 0
    admitted_keys: list[tuple[str, str]] = []
    enforce_base = None
    enforce_offered: dict[str, int] = {t: 0 for t in tenants}

    def submit_tick(tick: int) -> None:
        nonlocal seq
        # Deterministic proportional interleave: tenants emit on evenly
        # spaced phases so arrival order never biases the cap.
        lanes = [
            (k / offered[t], t, k)
            for t in tenants for k in range(offered[t])
        ]
        lanes.sort()
        enforcing = tn.controller.current_state() != HEALTHY
        for _, t, _k in lanes:
            seq += 1
            pod = PodInfo(f"p{seq:07d}", namespace=t,
                          cpu_milli=10, mem_kib=1 << 10)
            obj = json.loads(encode_pod(pod))
            if enforcing:
                enforce_offered[t] += 1
            try:
                coord.submit_external(obj)
            except Overloaded:
                continue
            store.put(pod_key(t, pod.name), encode_pod(pod))
            admitted_keys.append((t, pod.name))

    violations = None
    try:
        coord.bootstrap()
        with guards.audit():
            measured = 0
            for tick in range(args.warm_ticks + 10 * args.measure_ticks):
                submit_tick(tick)
                coord.step()
                max_load = max(
                    max_load, len(coord.queue) + len(coord._backoff)
                )
                if tn.controller.current_state() != HEALTHY:
                    if enforce_base is None:
                        enforce_base = tn.admission.counters()["admitted"]
                        enforce_offered = {t: 0 for t in tenants}
                    else:
                        measured += 1
                        if measured >= args.measure_ticks:
                            break
            counters = tn.admission.counters()
            # Drain: every admitted pod must bind (zero-loss ledger).
            for _ in range(IDLE_DRAIN_TICKS):
                if (
                    not coord.queue and not coord._backoff
                    and not coord._external_pending()
                    and not coord._inflights
                ):
                    break
                coord.step()
            coord.flush()
            lost = 0
            for t, name in admitted_keys:
                kv = store.get(pod_key(t, name))
                if kv is None or b'"nodeName"' not in kv.value:
                    lost += 1
        violations = guards.violations()
    finally:
        coord.close()
        store.close()

    base = enforce_base or {}
    adm = {
        t: counters["admitted"].get(t, 0) - base.get(t, 0) for t in tenants
    }
    total_adm = sum(adm.values()) or 1
    shares = {t: adm[t] / total_adm for t in tenants}
    # Weight shares among the SATURATING tenants only: the lightest
    # tenant's unused entitlement is not redistributed by the buckets,
    # so flooders are judged against the full weight split while the
    # light tenant is judged on offered-vs-admitted.
    per_tenant = {}
    fair_ok = True
    light_ok = True
    for t in tenants:
        w_share = weights[t] / total_w
        sat = offered[t] >= 1.1 * b * w_share
        rec = {
            "weight": weights[t],
            "weight_share": round(w_share, 4),
            "offered_per_tick": offered[t],
            "admitted": adm[t],
            "admitted_share": round(shares[t], 4),
            "saturating": sat,
        }
        if sat:
            ok = abs(shares[t] - w_share) <= 0.10 * w_share
            rec["within_10pct"] = ok
            fair_ok = fair_ok and ok
        else:
            off = enforce_offered.get(t, 0)
            ok = off == 0 or adm[t] >= 0.9 * off
            rec["admitted_vs_offered"] = round(adm[t] / off, 4) if off else None
            rec["non_saturating_ok"] = ok
            light_ok = light_ok and ok
        per_tenant[t] = rec
    return {
        "weights": weights,
        "queue_cap": cfg.queue_cap,
        "max_load": max_load,
        "per_tenant": per_tenant,
        "admitted_total": len(admitted_keys),
        "lost": lost,
        "guard_violations": violations,
        "passed": bool(
            fair_ok and light_ok
            and max_load <= cfg.queue_cap
            and lost == 0
            and not violations
        ),
    }


def run_preempt_gang(args) -> dict:
    """Phase 2: a starved high-priority gang preempts, binds
    all-or-none, victims requeue, and the whole thing replays
    byte-identically."""
    from k8s1m_tpu_torch.config import PodSpec, TableSpec
    from k8s1m_tpu_torch.control.coordinator import Coordinator, splice_node_name
    from k8s1m_tpu_torch.control.objects import (
        decode_node,
        encode_node,
        encode_pod,
        node_key,
        pod_key,
    )
    from k8s1m_tpu_torch.obs.metrics import REGISTRY
    from k8s1m_tpu_torch.plugins.registry import Profile
    from k8s1m_tpu_torch.snapshot.node_table import NodeInfo
    from k8s1m_tpu_torch.snapshot.pod_encoding import PodInfo
    from k8s1m_tpu_torch.store.native import MemStore, list_prefix
    from k8s1m_tpu_torch.tenancy import TenancyController, TenancyPolicy
    from k8s1m_tpu_torch.tenancy.preempt import Victim, select_preemption

    nodes_n = min(args.nodes, 16)
    slots = 60
    fillers = nodes_n * slots
    gang_n = args.gang_size
    ev0 = REGISTRY.get("preemption_evictions_total").value()
    g0 = {
        o: REGISTRY.get("gang_admit_total").value(outcome=o)
        for o in ("bound", "requeued", "parked", "oversize")
    }

    store = MemStore()
    raws: dict[str, bytes] = {}
    for i in range(nodes_n):
        store.put(node_key(f"n{i:03d}"), encode_node(NodeInfo(
            name=f"n{i:03d}", cpu_milli=70_000, mem_kib=1 << 20, pods=slots,
        )))
    tn = TenancyController(TenancyPolicy(log_preemptions=True))
    coord = Coordinator(
        store, TableSpec(max_nodes=32, max_zones=4, max_regions=2),
        PodSpec(batch=args.batch), Profile(topology_spread=0, interpod_affinity=0),
        chunk=32, k=4, with_constraints=False, seed=args.seed, tenancy=tn,
        device=args.device,
    )
    mismatches: list = []
    try:
        coord.bootstrap()
        # Fill every pod slot with low-priority filler (pod-count
        # saturation is deterministic regardless of score spread).
        for i in range(fillers):
            pod = PodInfo(f"f-{i:05d}", namespace="fill",
                          cpu_milli=1000, mem_kib=1 << 10)
            raws[pod.key] = encode_pod(pod)
            store.put(pod_key("fill", pod.name), raws[pod.key])
        filler_bound = coord.run_until_idle()
        # The starved high-priority gang.
        for j in range(gang_n):
            pod = PodInfo(
                f"g-{j}", namespace="tenant-a", cpu_milli=3000,
                mem_kib=1 << 10, priority=10,
                labels={"k8s1m.io/gang": "burst",
                        "k8s1m.io/gang-size": str(gang_n)},
            )
            raws[pod.key] = encode_pod(pod)
            store.put(pod_key("tenant-a", pod.name), raws[pod.key])
        gang_bound = coord.run_until_idle()
        events = list(coord.preempt_log)
        evictions = REGISTRY.get("preemption_evictions_total").value() - ev0
        gangs = {
            o: REGISTRY.get("gang_admit_total").value(outcome=o) - g0[o]
            for o in g0
        }

        # ---- replay: selection identical, bytes identical -----------
        kvs, _ = list_prefix(store, b"/registry/minions/")
        node_infos = {}
        for kv in kvs:
            nd = decode_node(kv.value)
            node_infos[nd.name] = nd
        victim_keys: set[str] = set()
        for e in events:
            nodes_list = sorted(
                (coord.host.row_of(n), nd) for n, nd in node_infos.items()
            )
            usage = {int(r): tuple(u) for r, u in e["usage"].items()}
            victims_by_row = {
                int(r): [Victim(*v) for v in vs]
                for r, vs in e["candidates"].items()
            }
            ns, name = e["pod"].split("/", 1)
            pod = PodInfo(name, namespace=ns, cpu_milli=3000,
                          mem_kib=1 << 10, priority=e["priority"])
            choice = select_preemption(
                pod, e["tenant"], e["priority"], nodes_list, usage,
                victims_by_row,
            )
            if (
                choice is None
                or choice.node != e["node"]
                or [v.key for v in choice.victims] != e["victims"]
            ):
                mismatches.append((e["pod"], "selection replay diverged"))
                continue
            got = store.get(pod_key(ns, name))
            want = splice_node_name(raws[e["pod"]], e["node"])
            if got is None or got.value != want:
                mismatches.append((e["pod"], "preemptor bytes"))
            victim_keys.update(e["victims"])
        # Victims: requeued, and their stored bytes are their EXACT
        # pre-bind encodings while pending (or a valid re-bind).
        victims_pending = victims_rebound = 0
        for vk in victim_keys:
            ns, name = vk.split("/", 1)
            kv = store.get(pod_key(ns, name))
            if kv is None:
                mismatches.append((vk, "victim lost"))
                continue
            if b'"nodeName"' in kv.value:
                victims_rebound += 1
            elif kv.value == raws[vk]:
                victims_pending += 1
            else:
                mismatches.append((vk, "victim bytes"))
        # Ledger: no pod vanished; every stored bind names a live node.
        kvs, _ = list_prefix(store, b"/registry/pods/")
        lost = fillers + gang_n - len(kvs)
        gang_members_bound = sum(
            1 for kv in kvs
            if b"/tenant-a/" in kv.key and b'"nodeName"' in kv.value
        )
    finally:
        coord.close()
        store.close()
    all_or_none = gang_members_bound in (0, gang_n)
    return {
        "nodes": nodes_n,
        "filler_bound": filler_bound,
        "gang_size": gang_n,
        "gang_bound_pods": gang_bound,
        "gang_members_bound_in_store": gang_members_bound,
        "gang_outcomes": gangs,
        "preempt_events": len(events),
        "evictions": evictions,
        "victims": len(victim_keys),
        "victims_pending": victims_pending,
        "victims_rebound": victims_rebound,
        "lost": lost,
        "byte_identical": not mismatches,
        "mismatches": mismatches[:5],
        "passed": bool(
            filler_bound == fillers
            and gang_members_bound == gang_n
            and all_or_none
            and gangs["bound"] >= 1
            and evictions > 0
            and len(events) == gang_n
            and victims_pending + victims_rebound == len(victim_keys)
            and lost == 0
            and not mismatches
        ),
    }


def main(argv=None) -> dict:
    args = parse_args(argv)
    fairness = run_fairness(args)
    preempt = run_preempt_gang(args)
    result = {
        "metric": "tenantfair_drill" + ("_smoke" if args.smoke else ""),
        "value": min(
            (r["admitted_share"] / r["weight_share"]
             for r in fairness["per_tenant"].values() if r["saturating"]),
            default=0.0,
        ),
        "unit": "min saturating admitted/weight share ratio",
        "vs_baseline": None,
        "passed": bool(fairness["passed"] and preempt["passed"]),
        "seed": args.seed,
        "device": str(args.device),
        "shape": {
            "nodes": args.nodes, "batch": args.batch,
            "tenants": args.tenants, "tenant_skew": args.tenant_skew,
            "factor": args.factor, "gang_size": args.gang_size,
        },
        "fairness": fairness,
        "preempt_gang": preempt,
    }
    result["value"] = round(result["value"], 4)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
