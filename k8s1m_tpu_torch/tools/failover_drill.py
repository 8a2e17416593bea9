"""Failover drill: kill-active-mid-wave and paused-leader split-brain,
under tenant load, gated on crash consistency.

The port's own copy of ``k8s1m_tpu/tools/failover_drill.py``, on the card
unless ``--device cpu`` is given; ``--backend auto`` (the default) runs
the kernels on ``cuda`` (every wave here is the fused kernel's base
stage) and the scan path on the CPU.  Nodes register through the store's
put-frames (``put_batch``), in the same order and at the same revisions
as one put each.

Two replicas (``alpha`` the initial leader, ``beta`` the standby) run
the full HA surface over one store — tick-driven with an injected
clock, so every scenario replays deterministically:

**mid_wave_kill** (run twice: warm standby and cold standby) — alpha
pipelines waves at depth N under continuous tenant load (including
4-pod gangs); the faultline ``kill_process`` kind on the
``coordinator.lease`` hook SIGKILLs it mid-wave (no lease release, no
flush; a partially-bound gang is seeded in the store the way a crash
between a wave's bind CASes and its gang settlement leaves one).  Beta
takes over on lease expiry — warm: ``Coordinator.promote`` (drain the
mirror's watch backlog + pinned relist-from-revision diff); cold:
full bootstrap — recovers the half-bound gang all-or-none, and drains
the backlog.

**split_brain** — alpha is SIGSTOP'd (faultline ``pause``) *between its
leadership check and its writes*, with in-flight waves, past lease
expiry; the drill's ``on_pause`` callback advances beta through the
steal deterministically.  When alpha resumes it still believes its
pre-pause election observation and tries to retire its waves: every
bind must be refused by the lease-epoch fence
(``fencing_rejected_total`` > 0) and drain to requeue, never to the
store.

Gates (one JSON line; ``--out`` keeps the document):

- 0 lost pods: every admitted pod is bound in the final store state;
- 0 double-binds: the full store event history (watched from revision
  1) never shows a bind landing on an already-bound pod;
- fencing rejects > 0 in the split-brain scenario (and the deposed
  reign binds nothing);
- takeover <= a few cycles: first bind within ``--takeover-cycles`` of
  lease acquisition;
- byte consistency: the recovered coordinator's host mirror
  (cpu/mem/pods per node, bound-key set) equals an independent
  recomputation from the final store facts, exactly;
- warm < cold: ``failover_recovery_seconds`` for the warm takeover
  beats the cold boot (both reported).

    python -m k8s1m_tpu_torch.tools.failover_drill --smoke --device cpu
    python -m k8s1m_tpu_torch.tools.failover_drill --nodes 1048576 --chunk 4096 \\
        --out chiprun_out/failover.json
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import time

NODE_FRAME = 8192        # nodes per registration put-frame


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="coordinator failover drill")
    ap.add_argument("--nodes", type=int, default=2048)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--chunk", type=int, default=256)
    ap.add_argument("--depth", type=int, default=3)
    ap.add_argument("--tenants", type=int, default=4)
    ap.add_argument("--pods-per-tick", type=int, default=192)
    ap.add_argument("--pre-ticks", type=int, default=12,
                    help="loaded ticks before the kill/pause lands")
    ap.add_argument("--drain-ticks", type=int, default=4000)
    ap.add_argument("--takeover-cycles", type=int, default=2,
                    help="slack cycles past the pipeline ramp: the first "
                    "bind must land within depth + this many cycles of "
                    "lease acquisition (a depth-N pipeline retires its "
                    "first wave on cycle N+1 by design)")
    ap.add_argument("--seed", type=int, default=9)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--backend", default="auto", choices=("auto", "xla", "pallas"),
                    help="auto: the kernels on cuda, the scan path on the CPU")
    ap.add_argument("--smoke", action="store_true",
                    help="tier-1 shape: tiny cluster, same gates")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.smoke:
        args.nodes, args.batch, args.chunk = 256, 64, 64
        args.pods_per_tick = 48
        args.pre_ticks = 6
    return args


@functools.lru_cache(maxsize=1)
def _node_items(nodes: int) -> list:
    """The registration puts of ``nodes`` nodes, encoded once for all
    three scenarios (each registers them into a fresh store)."""
    from k8s1m_tpu_torch.control.objects import encode_node, node_key
    from k8s1m_tpu_torch.snapshot.node_table import NodeInfo

    return [
        (node_key(f"n{i:05d}"),
         encode_node(NodeInfo(f"n{i:05d}", cpu_milli=1 << 22, mem_kib=1 << 30, pods=1 << 20)))
        for i in range(nodes)
    ]


class World:
    """One scenario's cluster: store, nodes, replica pair, producer,
    and the exactly-once bind ledger."""

    def __init__(self, args, *, warm_standby: bool):
        from k8s1m_tpu_torch.config import PodSpec, TableSpec
        from k8s1m_tpu_torch.control.coordinator import (
            PODS_PREFIX,
            Coordinator,
        )
        from k8s1m_tpu_torch.control.leader import HACoordinator, LeaderElector
        from k8s1m_tpu_torch.loadshed import LoadshedConfig
        from k8s1m_tpu_torch.plugins.registry import Profile
        from k8s1m_tpu_torch.store.native import MemStore, prefix_end
        from k8s1m_tpu_torch.tenancy import TenancyController, TenancyPolicy

        self.args = args
        self.store = MemStore()
        self.pods_prefix = PODS_PREFIX
        items = _node_items(args.nodes)
        for i in range(0, len(items), NODE_FRAME):
            self.store.put_batch(items[i:i + NODE_FRAME])
        # Full-history ledger watch BEFORE any pod exists: every pod
        # create/bind/evict event lands here for the double-bind audit.
        self.ledger = self.store.watch(
            PODS_PREFIX, prefix_end(PODS_PREFIX),
            start_revision=1, queue_cap=1 << 21,
        )

        b = args.batch
        weights = {f"tenant-{t}": t + 1 for t in range(args.tenants)}
        self.tenants = list(weights)

        def make_coord():
            tn = TenancyController(
                TenancyPolicy(weights=weights),
                loadshed_config=LoadshedConfig(
                    queue_degraded=64 * b, queue_shed=128 * b,
                    queue_cap=1 << 20, queue_recover=b,
                ),
                name=f"failover-{id(object())}",
            )
            return Coordinator(
                self.store,
                TableSpec(max_nodes=args.nodes, max_zones=16, max_regions=8),
                PodSpec(batch=b),
                Profile(topology_spread=0, interpod_affinity=0),
                chunk=args.chunk, k=4, with_constraints=False,
                seed=args.seed, score_pct=50, pipeline=True,
                depth=args.depth, tenancy=tn, device=args.device,
                backend=args.backend,
            )

        self.alpha = HACoordinator(LeaderElector(self.store, "alpha"),
                                   make_coord)
        self.beta = HACoordinator(
            LeaderElector(self.store, "beta", retry_period_s=1.0),
            make_coord, warm_standby=warm_standby,
        )
        self.seq = 0
        self.admitted: list[str] = []     # "<ns>/<name>" expected bound
        self.now = 0.0

    # ---- load ----------------------------------------------------------

    def produce(self, n: int, *, gang_every: int = 64) -> None:
        """Write n pending pods across tenants; every ``gang_every``th
        seq opens a 4-pod gang (labels force the full decode path)."""
        from k8s1m_tpu_torch.control.objects import encode_pod, pod_key
        from k8s1m_tpu_torch.snapshot.pod_encoding import PodInfo

        i = 0
        while i < n:
            self.seq += 1
            t = self.tenants[self.seq % len(self.tenants)]
            if gang_every and self.seq % gang_every == 0 and n - i >= 4:
                gid = f"g{self.seq:06d}"
                for m in range(4):
                    p = PodInfo(
                        f"{gid}-m{m}", namespace=t, cpu_milli=10,
                        mem_kib=1 << 10,
                        labels={"k8s1m.io/gang": gid,
                                "k8s1m.io/gang-size": "4"},
                    )
                    self.store.put(pod_key(t, p.name), encode_pod(p))
                    self.admitted.append(f"{t}/{p.name}")
                i += 4
                continue
            p = PodInfo(f"p{self.seq:07d}", namespace=t, cpu_milli=10,
                        mem_kib=1 << 10)
            self.store.put(pod_key(t, p.name), encode_pod(p))
            self.admitted.append(f"{t}/{p.name}")
            i += 1

    def seed_partial_gang(self) -> str:
        """The crash artifact recover_gangs exists for: a 4-pod gang
        with 2 members already bound in the store (the predecessor's
        CASes landed) and 2 still pending — written directly, the way
        a death between a wave's binds and its gang settlement leaves
        it.  Returns the gang id."""
        from k8s1m_tpu_torch.control.objects import encode_pod, pod_key
        from k8s1m_tpu_torch.snapshot.pod_encoding import PodInfo

        t = self.tenants[0]
        gid = "crash-gang"
        for m in range(4):
            p = PodInfo(
                f"{gid}-m{m}", namespace=t, cpu_milli=10, mem_kib=1 << 10,
                labels={"k8s1m.io/gang": gid, "k8s1m.io/gang-size": "4"},
                node_name=f"n{m:05d}" if m < 2 else "",
            )
            self.store.put(pod_key(t, p.name), encode_pod(p))
            self.admitted.append(f"{t}/{p.name}")
        return f"{t}/{gid}"

    # ---- settle + audits ----------------------------------------------

    def drain(self, ha) -> int:
        """Tick ``ha`` until the backlog settles; returns binds."""
        total = 0
        c = ha.coord
        for _ in range(self.args.drain_ticks):
            self.now += 1.0
            total += ha.tick(self.now)
            c = ha.coord
            if c is None:
                continue
            if (
                not c.queue and not c._inflights and not c._backoff
                and not c._gang_parked and not c._gang_staging
                and not c._external_pending()
            ):
                break
            w = c.backoff_wait_s()
            if w:
                time.sleep(min(w, 0.05))
        if c is not None:
            total += c.flush()
        return total

    def audit_ledger(self) -> dict:
        """Replay the full pod event history: a PUT carrying a nodeName
        on a pod already in the bound state is a double-bind (an evict
        — PUT without nodeName — legally returns it to pending)."""
        from k8s1m_tpu_torch.store.native import drain_events_light

        bound: set[str] = set()
        double = 0
        binds = 0
        evicts = 0
        for etype, key, value, _mrev in drain_events_light(
            self.ledger, limit=1 << 30
        ):
            k = key[len(self.pods_prefix):].decode()
            if etype == 1:
                bound.discard(k)
                continue
            if b'"nodeName"' in value:
                if k in bound:
                    double += 1
                else:
                    bound.add(k)
                    binds += 1
            else:
                if k in bound:
                    evicts += 1
                bound.discard(k)
        return {"binds": binds, "evictions": evicts,
                "double_binds": double}

    def audit_lost(self) -> int:
        from k8s1m_tpu_torch.control.objects import pod_key

        lost = 0
        for k in self.admitted:
            ns, name = k.split("/", 1)
            kv = self.store.get(pod_key(ns, name))
            if kv is None or b'"nodeName"' not in kv.value:
                lost += 1
        return lost

    def pods_digest(self) -> str:
        """sha256 over every stored pod's key and value bytes, in key
        order: two runs (card and CPU, or two CPU runs) that bound the
        same pods to the same nodes agree on it."""
        import hashlib

        from k8s1m_tpu_torch.store.native import list_prefix

        h = hashlib.sha256()
        kvs, _ = list_prefix(self.store, self.pods_prefix)
        for kv in kvs:
            h.update(len(kv.key).to_bytes(4, "little") + kv.key)
            h.update(len(kv.value).to_bytes(4, "little") + kv.value)
        return h.hexdigest()

    def audit_consistency(self, coord) -> dict:
        """Byte consistency: recompute per-node (cpu, mem, pods) and
        the bound-key set from the final store facts alone and demand
        EXACT equality with the recovered coordinator's host mirror."""
        from k8s1m_tpu_torch.control.objects import decode_pod
        from k8s1m_tpu_torch.store.native import list_prefix

        exp: dict[str, list[int]] = {}
        exp_bound: set[str] = set()
        kvs, _ = list_prefix(self.store, self.pods_prefix)
        for kv in kvs:
            if b'"nodeName"' not in kv.value:
                continue
            pod = decode_pod(kv.value, coord.tracker)
            if not pod.node_name:
                continue
            exp_bound.add(pod.key)
            u = exp.setdefault(pod.node_name, [0, 0, 0])
            u[0] += pod.cpu_milli
            u[1] += pod.mem_kib
            u[2] += 1
        host = coord.host
        mismatches = 0
        for name, row in host._row_of.items():
            want = exp.get(name, [0, 0, 0])
            got = [int(host.cpu_req[row]), int(host.mem_req[row]),
                   int(host.pods_req[row])]
            if got != want:
                mismatches += 1
        extra = set(coord._bound) - exp_bound
        missing = exp_bound - set(coord._bound)
        return {
            "row_mismatches": mismatches,
            "bound_extra": len(extra),
            "bound_missing": len(missing),
            "byte_consistent": not (mismatches or extra or missing),
        }

    def close(self) -> None:
        for ha in (self.alpha, self.beta):
            try:
                ha.stop()
            except Exception:  # graftlint: disable=broad-except (drill teardown must reach store.close)
                pass
        self.ledger.cancel()
        self.store.close()


def run_kill(args, *, warm: bool) -> dict:
    """Kill-active-mid-wave: SIGKILL alpha via faultline, beta takes
    over (warm promote or cold boot), recovers the half-bound gang,
    drains everything."""
    from k8s1m_tpu_torch import faultline
    from k8s1m_tpu_torch.faultline import FaultPlan, FaultSpec, install_plan

    w = World(args, warm_standby=warm)
    try:
        w.produce(args.batch)
        bound = w.alpha.tick(w.now)          # alpha cold-boots, leads
        assert w.alpha.elector.is_leader
        for _ in range(args.pre_ticks):
            w.now += 1.0
            w.produce(args.pods_per_tick)
            bound += w.alpha.tick(w.now)
            w.beta.tick(w.now)               # beta follows (warm) or idles
        inflight_at_kill = len(w.alpha.coord._inflights)
        mirror_queue = (
            len(w.beta._mirror.queue) if w.beta._mirror is not None else 0
        )
        # The SIGKILL, by plan: fires on alpha's NEXT lease tick only.
        install_plan(FaultPlan(
            [FaultSpec("coordinator.lease", "tick/alpha",
                       kind="kill_process", every_n=1, max_fires=1)],
            seed=args.seed,
        ))
        w.now += 1.0
        w.alpha.tick(w.now)
        assert w.alpha._killed
        killed_at = w.now
        gang_key = w.seed_partial_gang()
        # No-leader window: the webhook sink is queue-or-429.
        from k8s1m_tpu_torch.loadshed import Overloaded
        from k8s1m_tpu_torch.control.objects import encode_pod, pod_key
        from k8s1m_tpu_torch.snapshot.pod_encoding import PodInfo

        queued_429 = {"queued": 0, "rejected": 0}
        for i in range(8):
            p = PodInfo(f"noleader-{i}", namespace=w.tenants[0],
                        cpu_milli=10, mem_kib=1 << 10)
            try:
                w.beta.submit_external(json.loads(encode_pod(p)))
                queued_429["queued"] += 1
            except Overloaded as e:
                assert e.reason == "no-leader"
                queued_429["rejected"] += 1
                continue
            w.store.put(pod_key(p.namespace, p.name), encode_pod(p))
            w.admitted.append(f"{p.namespace}/{p.name}")
        # Beta waits out the lease and takes over (the acquiring tick
        # itself already steps the promoted coordinator once).
        got = 0
        while not w.beta.elector.is_leader and w.now < killed_at + 60:
            w.now += 1.0
            got = w.beta.tick(w.now)
        assert w.beta.elector.is_leader
        acquired_at = w.now
        # Takeover promptness: cycles from acquisition to the first
        # bind.  A depth-N pipeline retires its first wave on cycle N+1
        # by design, so the gate is depth + slack.
        cycle_limit = args.depth + args.takeover_cycles
        b_bound = got
        cycles_to_bind = 1 if got else None
        c = 1
        while cycles_to_bind is None and c < cycle_limit:
            c += 1
            w.now += 1.0
            got = w.beta.tick(w.now)
            b_bound += got
            if got:
                cycles_to_bind = c
        b_bound += w.drain(w.beta)
        fired = faultline.active_injector().fire_counts()
        install_plan(None)
        ledger = w.audit_ledger()
        lost = w.audit_lost()
        consistency = w.audit_consistency(w.beta.coord)
        gang_ns = gang_key.split("/")[0]
        gang_ok = all(
            b'"nodeName"' in w.store.get(
                pod_key(gang_ns, f"crash-gang-m{m}")
            ).value
            for m in range(4)
        )
        return {
            "mode": w.beta.takeover_mode,
            "recovery_s": w.beta.last_recovery_s,
            "promote_stats": w.beta.last_promote_stats,
            "admitted": len(w.admitted),
            "leader_bound_before_kill": bound,
            "standby_bound_after": b_bound,
            "inflight_at_kill": inflight_at_kill,
            "standby_mirror_queue_at_kill": mirror_queue,
            "takeover_wait_ticks": acquired_at - killed_at,
            "cycles_to_first_bind": cycles_to_bind,
            "no_leader_sink": queued_429,
            "kill_process_fired": fired.get("kill_process", 0),
            "crash_gang_recovered_bound": gang_ok,
            "ledger": ledger,
            "lost": lost,
            "consistency": consistency,
            "pods_sha256": w.pods_digest(),
            "passed": bool(
                lost == 0
                and ledger["double_binds"] == 0
                and consistency["byte_consistent"]
                and gang_ok
                and cycles_to_bind is not None
                and cycles_to_bind <= cycle_limit
                and inflight_at_kill > 0
            ),
        }
    finally:
        install_plan(None)
        w.close()


def run_split_brain(args) -> dict:
    """Paused-leader split-brain: alpha freezes (SIGSTOP) between its
    leadership check and its writes, past lease expiry; beta steals;
    alpha resumes and tries to retire its in-flight waves — the fence
    must reject every one."""
    from k8s1m_tpu_torch import faultline
    from k8s1m_tpu_torch.faultline import FaultPlan, FaultSpec, install_plan
    from k8s1m_tpu_torch.obs.metrics import REGISTRY

    w = World(args, warm_standby=True)
    fence_rej = REGISTRY.get("fencing_rejected_total")

    def rejects() -> float:
        return sum(
            fence_rej.value(path=p) for p in ("bind", "evict", "preempt")
        )

    try:
        w.produce(args.batch)
        w.alpha.tick(w.now)
        assert w.alpha.elector.is_leader
        for _ in range(args.pre_ticks):
            w.now += 1.0
            w.produce(args.pods_per_tick)
            w.alpha.tick(w.now)
            w.beta.tick(w.now)
        inflight_at_pause = len(w.alpha.coord._inflights)
        lease = w.alpha.elector.lease_duration_s

        stolen = {"at": None}

        def on_pause(_decision):
            # The world moves on while alpha is frozen: beta ticks
            # through lease expiry and takes over (warm promote).
            t = w.now
            for _ in range(int(lease) + 5):
                t += 1.0
                w.produce(args.pods_per_tick // 4)
                w.beta.tick(t)
            assert w.beta.elector.is_leader
            stolen["at"] = t

        w.alpha.on_pause = on_pause
        install_plan(FaultPlan(
            [FaultSpec("coordinator.lease", "tick/alpha", kind="pause",
                       delay_s=lease + 5.0, every_n=1, max_fires=1)],
            seed=args.seed,
        ))
        r0 = rejects()
        # Alpha's paused tick: its elector (frozen clock) still believes
        # leadership; after the freeze it retires in-flight waves — the
        # fence must send every bind to requeue, not the store.
        w.now += 1.0
        deposed_bound = w.alpha.tick(w.now)
        fencing_rejected = rejects() - r0
        # Alpha catches up with real time and steps down.
        w.now = stolen["at"] + 1.0
        deposed_bound += w.alpha.tick(w.now)
        alpha_stepped_down = not w.alpha.elector.is_leader
        fired = faultline.active_injector().fire_counts()
        install_plan(None)
        b_bound = w.drain(w.beta)
        ledger = w.audit_ledger()
        lost = w.audit_lost()
        consistency = w.audit_consistency(w.beta.coord)
        return {
            "mode": w.beta.takeover_mode,
            "recovery_s": w.beta.last_recovery_s,
            "promote_stats": w.beta.last_promote_stats,
            "admitted": len(w.admitted),
            "inflight_at_pause": inflight_at_pause,
            "pause_fired": fired.get("pause", 0),
            "fencing_rejected": fencing_rejected,
            "deposed_leader_bound": deposed_bound,
            "alpha_stepped_down": alpha_stepped_down,
            "standby_bound_after": b_bound,
            "ledger": ledger,
            "lost": lost,
            "consistency": consistency,
            "pods_sha256": w.pods_digest(),
            "passed": bool(
                lost == 0
                and ledger["double_binds"] == 0
                and consistency["byte_consistent"]
                and fencing_rejected > 0
                and deposed_bound == 0
                and alpha_stepped_down
                and inflight_at_pause > 0
            ),
        }
    finally:
        install_plan(None)
        w.close()


def run(args) -> dict:
    kill_cold = run_kill(args, warm=False)
    kill_warm = run_kill(args, warm=True)
    split = run_split_brain(args)
    warm_s = kill_warm["recovery_s"]
    cold_s = kill_cold["recovery_s"]
    return {
        "mid_wave_kill_cold": kill_cold,
        "mid_wave_kill_warm": kill_warm,
        "split_brain": split,
        "recovery_warm_s": warm_s,
        "recovery_cold_s": cold_s,
        "warm_speedup": (cold_s / warm_s) if warm_s else None,
        "passed": bool(
            kill_cold["passed"] and kill_warm["passed"] and split["passed"]
            and warm_s is not None and cold_s is not None
            and warm_s < cold_s
        ),
    }


def main(argv=None) -> dict:
    args = parse_args(argv)
    evidence = run(args)
    result = {
        "metric": "failover_drill" + ("_smoke" if args.smoke else ""),
        "value": evidence["warm_speedup"],
        "unit": "warm-standby takeover speedup vs cold boot (x)",
        "vs_baseline": None,
        "passed": evidence["passed"],
        "seed": args.seed,
        "device": str(args.device),
        "backend": args.backend,
        "shape": {
            "nodes": args.nodes, "batch": args.batch, "depth": args.depth,
            "tenants": args.tenants, "pods_per_tick": args.pods_per_tick,
            "pre_ticks": args.pre_ticks,
            "takeover_cycles_gate": args.takeover_cycles,
        },
        "evidence": evidence,
    }
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
