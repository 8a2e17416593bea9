"""The composed steady-state drill.

The port's own copy of ``k8s1m_tpu/tools/steady_drill.py``, on the card
unless ``--device cpu`` is given (the fused kernel's base stage on
``cuda`` on every wave, the scan path on the CPU).  A missing card raises.

Every subsystem has its own proof — hotfeed's encode overlap
(hostpath_bench), pipedream's quiesce-free churn (churn_pipeline),
loadshed's shed-and-recover (overload_drill), faultline's
injected-fault recovery (soak_faultline), tenancy's weighted-fair
shares (tenantfair_drill).  This drill proves them **together**, at
steady state, in one tick-driven run:

- the coordinator runs the production shape: ``pipeline=True`` depth 3
  with the host feed staging batches behind in-flight waves;
- a **tenant-aware producer** (zipf-skewed tenant namespaces,
  cluster/workload.py) submits through the weighted-fair admission
  chain every tick;
- **capacity-only node churn** lands every tick — the pipeline must
  scatter it mid-flight without a single structural quiesce;
- a **faultline plan** forces bind-CAS conflicts on a deterministic
  cadence — every one must be absorbed by the shared RetryPolicy with
  zero give-ups;
- mid-run the producer steps to ``--factor`` x capacity (the
  **loadshed overload phase**): the controller must walk to SHEDDING,
  per-tenant buckets must shed the flooders, and recovery must walk
  back to HEALTHY once the rate drops.

Gates (one JSON line; full evidence in ``--out``): zero admitted pods
lost, zero structural/resync quiesces, sustained in-flight depth at the
configured 3, SHEDDING seen and HEALTHY recovered, every injected
fault retried with zero give-ups, and the host feed actually staging
(``staged_used`` grew) — the individually-proven subsystems proven
*simultaneously*.

**The mesh lane** (``--mesh DPxSP``): the same composed shape over
the dp x sp sharded cycle — the table's rows shard over ``sp`` devices
and the pod batch over ``dp`` (parallel/sharded_cycle), with the
per-dp-shard host feed staging behind in-flight sharded waves.  The
mesh drill defaults to ``--packing packed``, so the gates
cover the full production composition (packed planes sharded over sp,
donating sharded step/scatter) and additionally assert
``device_packing_fallback_total`` stayed zero over the window::

    python -m k8s1m_tpu_torch.tools.steady_drill --smoke --mesh 2x4 --device cpu
    python -m k8s1m_tpu_torch.tools.steady_drill --smoke --failover --device cpu
    python -m k8s1m_tpu_torch.tools.steady_drill --failover --nodes 1048576 \
        --chunk 4096 --out steady_drill.json

**The failover lane** (``--failover``: the failover drill's kill
scenarios folded into the composed drill): the coordinator runs as an HA pair (alpha leading, beta a
warm standby following the watch stream), the watch-cache TIER runs
over the same store (native wire front, one client watch on the pods
prefix) on a sidecar loop, and the installed fault plan lands BOTH
storm legs mid-drill: a ``kill_process`` SIGKILLs alpha late in the
overload phase (beta must take over on lease expiry and drain
everything — still 0 lost), and an upstream watch break hits the tier
(which must RESUME its client in place: resumes +1, invalidations 0,
zero client cancels).  Composes with ``--mesh``/``--packing``.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import threading
import time

IDLE_DRAIN_TICKS = 4000
NODE_FRAME = 8192        # nodes per registration put-frame


class _WatchTierLane:
    """The composed lane's watch-tier leg: the fan-out tier over the
    SAME store (served through a native wire front), with one client
    watch on the pods prefix counting deliveries, on a private asyncio
    loop in a worker thread.  The installed fault plan breaks its
    upstream stream mid-drill; the lane's gates are a diff-replay
    resume (client kept, ``watchcache_resumes_total`` +1, zero
    invalidations) and zero client cancels."""

    def __init__(self, store):
        self.events = 0
        self.cancels = 0
        self.errors = 0
        self._stop = False
        self._store = store
        self._ready = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="watch-tier-lane", daemon=True
        )
        self._thread.start()
        if not self._ready.wait(timeout=60):
            raise RuntimeError("watch-tier lane failed to come up")

    def _run(self) -> None:
        asyncio.run(self._main())

    async def _main(self) -> None:
        from k8s1m_tpu_torch.control.coordinator import PODS_PREFIX
        from k8s1m_tpu_torch.store.etcd_client import EtcdClient
        from k8s1m_tpu_torch.store.native import WireFront, prefix_end
        from k8s1m_tpu_torch.store.watch_cache import serve_watch_cache

        wf = WireFront(self._store)
        tier = await serve_watch_cache(
            f"127.0.0.1:{wf.port}", [PODS_PREFIX], port=0
        )
        client = EtcdClient(f"127.0.0.1:{tier.port}")
        s = client.watch(PODS_PREFIX, prefix_end(PODS_PREFIX))
        await s.__aenter__()
        self._ready.set()
        try:
            while not self._stop:
                try:
                    b = await s.next(timeout=0.2)
                except TimeoutError:
                    continue
                # Counted, not logged: errors fail the lane's gate.
                except Exception:  # graftlint: disable=broad-except
                    self.errors += 1
                    break
                if b.canceled:
                    # The cancel-everyone hammer reached the client:
                    # exactly what the resume path must prevent.
                    self.cancels += 1
                    break
                self.events += len(b.events)
            await s.cancel()
        finally:
            await client.close()
            await tier.close()
            wf.close()

    def stop(self) -> None:
        self._stop = True
        self._thread.join(timeout=30)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="composed steady-state drill")
    ap.add_argument("--nodes", type=int, default=2048)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--chunk", type=int, default=256)
    ap.add_argument("--depth", type=int, default=3)
    ap.add_argument("--tenants", type=int, default=6)
    ap.add_argument("--tenant-skew", type=float, default=1.0)
    ap.add_argument("--steady-ticks", type=int, default=24)
    ap.add_argument("--overload-ticks", type=int, default=16)
    ap.add_argument("--recover-ticks", type=int, default=60)
    ap.add_argument("--factor", type=int, default=5)
    ap.add_argument("--churn-per-tick", type=int, default=64,
                    help="capacity-only node updates written per tick")
    ap.add_argument("--conflict-every", type=int, default=37,
                    help="faultline: force a bind-CAS conflict every Nth "
                    "CAS attempt")
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--mesh", default=None,
                    help="run the composed drill over the dp x sp "
                    "sharded cycle, e.g. '2x4'; default: single-device.  "
                    "A mesh drill defaults --packing to 'packed' so the "
                    "composed packed x sharded x donated production "
                    "path is what the gates exercise")
    ap.add_argument("--packing", choices=("off", "packed"), default=None,
                    help="device-snapshot layout (snapshot/packing.py); "
                    "default: 'packed' when --mesh is set (the "
                    "production path), else 'off'.  A packed drill "
                    "additionally gates device_packing_fallback_total "
                    "== 0 over the window")
    ap.add_argument("--failover", action="store_true",
                    help="compose the failover-drill kill scenarios "
                    "into this run: HA coordinator pair with a "
                    "mid-overload SIGKILL of the leader (warm standby "
                    "takes over, still 0 lost) plus a watch-cache tier "
                    "sidecar whose upstream stream is broken mid-drill "
                    "(must resume, not relist-storm)")
    ap.add_argument("--trace", type=int, default=0, metavar="N",
                    help="podtrace (obs/podtrace.py): trace 1-in-N "
                    "pods through the composed drill; the stage-"
                    "attribution waterfall lands in the evidence as "
                    "latency_attribution.  0 = off (the null tracer)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="with --trace: write the Chrome/Perfetto "
                    "trace-event export of the drill to PATH")
    ap.add_argument("--smoke", action="store_true",
                    help="tier-1 shape: tiny cluster, same gates")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.smoke:
        args.nodes, args.batch, args.chunk = 128, 64, 64
        args.tenants = 4
        args.steady_ticks, args.overload_ticks = 8, 8
        args.recover_ticks = 40
        args.churn_per_tick = 16
        if args.mesh:
            # Mesh divisibility at smoke scale: rows-per-sp-shard must
            # be a chunk multiple (256/4 = 64, chunk 32).
            args.nodes, args.chunk = 256, 32
    if args.trace_out and not args.trace:
        ap.error("--trace-out requires --trace (the pod tracer)")
    if args.packing is None:
        # Same resolution chain as every other entry point: an explicit
        # K8S1M_PACKING keeps the whole evidence pipeline on one layout
        # (resolve_packing also rejects typo'd values loudly).  Only
        # when the env var is ALSO unset does the mesh drill default to
        # the composed production path — packed x sharded x donated
        # gated together.
        if os.environ.get("K8S1M_PACKING") is not None:
            from k8s1m_tpu_torch.snapshot.packing import resolve_packing

            args.packing = resolve_packing(None)
        else:
            args.packing = "packed" if args.mesh else "off"
    return args


def run(args) -> dict:
    from k8s1m_tpu_torch import faultline
    from k8s1m_tpu_torch.cluster.workload import zipf_weights
    from k8s1m_tpu_torch.config import PodSpec, TableSpec
    from k8s1m_tpu_torch.control.coordinator import Coordinator
    from k8s1m_tpu_torch.control.objects import (
        encode_node,
        encode_pod,
        node_key,
        pod_key,
    )
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
    from k8s1m_tpu_torch.snapshot.node_table import NodeInfo
    from k8s1m_tpu_torch.snapshot.pod_encoding import PodInfo
    from k8s1m_tpu_torch.store.native import MemStore
    from k8s1m_tpu_torch.store import watch_cache as _wc  # noqa: F401  (register watchcache_* metrics for the failover lane's deltas)
    from k8s1m_tpu_torch.tenancy import TenancyController, TenancyPolicy

    t_run = time.perf_counter()
    phase_s: dict[str, float] = {}
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
    controllers: list = []

    def make_tn():
        tn = TenancyController(
            TenancyPolicy(weights=weights), loadshed_config=cfg,
            name=f"steady_drill-{len(controllers)}",
        )
        controllers.append(tn)
        return tn

    specs = [FaultSpec("coordinator.bind", "cas", kind="err5xx",
                       every_n=args.conflict_every)]
    # The failover lane's two storm legs, by schedule: SIGKILL alpha on
    # its lease tick 3/4 into the overload phase (counters start at
    # install, after warmup), and break the tier's upstream stream at
    # its 31st post-install batch.
    kill_tick = args.steady_ticks + (3 * args.overload_ticks) // 4
    if args.failover:
        specs += [
            FaultSpec("coordinator.lease", "tick/alpha",
                      kind="kill_process", after=kill_tick, every_n=1,
                      max_fires=1),
            FaultSpec("watch.tier", "upstream.recv", kind="disconnect",
                      after=30, every_n=1, max_fires=1),
        ]
    plan = FaultPlan(specs, seed=args.seed)

    quiesce = REGISTRY.get("pipeline_quiesce_total")
    q0 = {r: quiesce.value(reason=r) for r in ("structural", "resync")}
    staged0 = REGISTRY.get("hotfeed_staged_used_total").value()
    mesh_scatter = REGISTRY.get("mesh_sharded_scatter_total")
    ms0 = {c: mesh_scatter.value(cols=c) for c in ("full", "cap")}
    giveups = REGISTRY.get("retry_give_ups_total")
    giveup0 = giveups.value(component="coordinator.bind")
    from k8s1m_tpu_torch.snapshot.packing import FALLBACK_REASONS

    pack_fb = REGISTRY.get("device_packing_fallback_total")
    fb0 = {r: pack_fb.value(reason=r) for r in FALLBACK_REASONS}
    wc_resumes = REGISTRY.get("watchcache_resumes_total")
    wc_invals = REGISTRY.get("watchcache_invalidations_total")
    wr0, wi0 = wc_resumes.value(), wc_invals.value()

    store = MemStore()

    def node_bytes(i: int, gen: int) -> bytes:
        # pods stays inside the packed int16 plane (snapshot/packing.py)
        # — the old 1<<20 "never the binding constraint" value would
        # fail-closed every packed drill to unpacked at bootstrap, which
        # is exactly the fallback the packed gate asserts never fires.
        return encode_node(NodeInfo(
            name=f"n{i:05d}", cpu_milli=1 << 22 if gen < 0 else
            (1 << 22) + (gen % 16), mem_kib=1 << 30, pods=(1 << 15) - 1,
        ))

    # Registration in put-frames, at the same revisions as one put per
    # node; every registered node's bytes are the template's with its name.
    head, tail = node_bytes(0, -1).split(b'"n00000"')
    for off in range(0, args.nodes, NODE_FRAME):
        names = [f"n{i:05d}" for i in range(off, min(args.nodes, off + NODE_FRAME))]
        store.put_batch([(node_key(n), b'%s"%s"%s' % (head, n.encode(), tail))
                         for n in names])
    last = f"n{args.nodes - 1:05d}"
    if store.get(node_key(last)).value != encode_node(NodeInfo(
            name=last, cpu_milli=1 << 22, mem_kib=1 << 30, pods=(1 << 15) - 1)):
        raise RuntimeError("node template differs from encode_node")
    phase_s["setup"] = time.perf_counter() - t_run
    tracer = None
    if args.trace:
        from k8s1m_tpu_torch.obs.podtrace import PodTracer

        tracer = PodTracer(sample_n=args.trace)

    def make_coord():
        return Coordinator(
            store,
            TableSpec(max_nodes=args.nodes, max_zones=16, max_regions=8),
            PodSpec(batch=b), Profile(topology_spread=0, interpod_affinity=0),
            chunk=args.chunk, k=4, with_constraints=False, seed=args.seed,
            score_pct=50, pipeline=True, depth=args.depth, tenancy=make_tn(),
            mesh=args.mesh or "none", packing=args.packing, tracer=tracer,
            device=args.device,
        )

    alpha = beta = coord = None
    if args.failover:
        from k8s1m_tpu_torch.control.leader import HACoordinator, LeaderElector

        alpha = HACoordinator(LeaderElector(store, "alpha"), make_coord)
        beta = HACoordinator(
            LeaderElector(store, "beta", retry_period_s=1.0),
            make_coord, warm_standby=True,
        )
    else:
        coord = make_coord()

    now = 0.0

    def active_coord():
        """The live scheduling coordinator (post-kill: the standby's)."""
        if not args.failover:
            return coord
        if alpha.elector.is_leader and not alpha._killed:
            return alpha.coord
        return beta.coord

    def step_once() -> None:
        nonlocal now
        if not args.failover:
            coord.step()
            return
        now += 1.0
        if not alpha._killed:
            alpha.tick(now)
        beta.tick(now)

    seq = 0
    churned = 0
    admitted: list[tuple[str, str]] = []
    rejected = 0
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
                if args.failover:
                    # The live replica's sink (queue-or-429 while no
                    # leader holds the lease).
                    ha = alpha if (
                        alpha.elector.is_leader and not alpha._killed
                    ) else beta
                    ha.submit_external(obj)
                else:
                    coord.submit_external(obj)
            except Overloaded:
                rejected += 1
                continue
            store.put(pod_key(t, pod.name), encode_pod(pod))
            admitted.append((t, pod.name))

    def churn_tick() -> None:
        nonlocal churned
        for j in range(args.churn_per_tick):
            i = churned % args.nodes
            store.put(node_key(f"n{i:05d}"), node_bytes(i, churned))
            churned += 1

    def tick(phase: str, n: int, producing: bool) -> None:
        submit(n)
        churn_tick()
        step_once()
        c = active_coord()
        if c is not None:
            states_seen.add(c.tenancy.controller.current_state())
        if producing:
            depth_samples.append(
                len(c._inflights) if c is not None else 0
            )

    marks = [time.perf_counter()]

    def mark(phase: str) -> None:
        marks.append(time.perf_counter())
        phase_s[phase] = marks[-1] - marks[-2]

    lane = _WatchTierLane(store) if args.failover else None
    try:
        if args.failover:
            now += 1.0
            alpha.tick(now)      # alpha cold-boots and leads
            assert alpha.elector.is_leader
        else:
            coord.bootstrap()
        mark("bootstrap")
        # Warm the compile caches outside the gated window.
        submit(b)
        if args.failover:
            for _ in range(IDLE_DRAIN_TICKS):
                c = active_coord()
                if c is not None and (
                    not c.queue and not c._backoff
                    and not c._external_pending() and not c._inflights
                ):
                    break
                step_once()
                w = c.backoff_wait_s() if c is not None else 0
                if w:
                    time.sleep(min(w, 0.05))
        else:
            coord.run_until_idle()
        install_plan(plan)
        mark("warmup")
        for _ in range(args.steady_ticks):
            tick("steady", b, True)
        mark("steady")
        for _ in range(args.overload_ticks):
            tick("overload", args.factor * b, True)
        mark("overload")
        for t in range(args.recover_ticks):
            tick("recovery", b // 2, False)
            c = active_coord()
            if (
                c is not None
                and c.tenancy.controller.current_state() == HEALTHY
                and recovered_at is None
            ):
                recovered_at = t + 1
        mark("recovery")
        for dt in range(IDLE_DRAIN_TICKS):
            c = active_coord()
            if c is not None and (
                not c.queue and not c._backoff
                and not c._external_pending() and not c._inflights
            ):
                break
            step_once()
            if c is not None:
                # A mid-overload leader kill pushes the takeover
                # backlog past the recovery window; the autonomous
                # walk-back to HEALTHY is still the gate — it just
                # completes during the drain.
                if (
                    args.failover and recovered_at is None
                    and c.tenancy.controller.current_state() == HEALTHY
                ):
                    recovered_at = args.recover_ticks + dt + 1
                w = c.backoff_wait_s()
                if w:
                    time.sleep(min(w, 0.05))
        c = active_coord()
        if c is not None:
            c.flush()
        mark("drain")
        fired = faultline.active_injector().fire_counts()
        install_plan(None)
        # Leadership read BEFORE the finally's stop() releases the
        # lease (a post-stop read is always False).
        beta_led = bool(args.failover and beta.elector.is_leader)
        lost = 0
        for t, name in admitted:
            kv = store.get(pod_key(t, name))
            if kv is None or b'"nodeName"' not in kv.value:
                lost += 1
        counters = {"admitted": {}, "rejected": {}}
        for tn in controllers:
            for side, per in tn.admission.counters().items():
                if side not in counters:
                    continue
                for tenant, v in per.items():
                    counters[side][tenant] = (
                        counters[side].get(tenant, 0) + v
                    )
    finally:
        install_plan(None)
        if lane is not None:
            lane.stop()
        if args.failover:
            for ha in (alpha, beta):
                try:
                    ha.stop()
                except Exception:  # graftlint: disable=broad-except (drill teardown must reach store.close)
                    pass
        else:
            coord.close()
        store.close()

    import numpy as np

    samples = np.asarray(depth_samples or [0])
    qd = {r: int(quiesce.value(reason=r) - q0[r]) for r in q0}
    staged_used = int(
        REGISTRY.get("hotfeed_staged_used_total").value() - staged0
    )
    give_ups = giveups.value(component="coordinator.bind") - giveup0
    faults = sum(fired.values()) if fired else 0
    mesh_scatters = {
        c: int(mesh_scatter.value(cols=c) - ms0[c]) for c in ms0
    }
    packing_fallbacks = sum(
        int(pack_fb.value(reason=r) - fb0[r]) for r in fb0
    )
    from k8s1m_tpu_torch.obs.podtrace import trace_report_detail

    trace_detail = trace_report_detail(tracer, args.trace_out)
    failover_ev = None
    failover_ok = True
    if args.failover:
        resumes_d = int(wc_resumes.value() - wr0)
        invals_d = int(wc_invals.value() - wi0)
        failover_ev = {
            "kill_fired": fired.get("kill_process", 0),
            "kill_after_tick": kill_tick,
            "beta_leader": beta_led,
            "takeover_mode": beta.takeover_mode,
            "recovery_s": beta.last_recovery_s,
            "watch_tier": {
                "events": lane.events,
                "client_cancels": lane.cancels,
                "client_errors": lane.errors,
                "resumes": resumes_d,
                "invalidations": invals_d,
            },
        }
        # The lane's gates: the SIGKILL actually fired and the warm
        # standby leads; the tier's upstream break resolved by resume
        # (client watch kept — zero cancels/invalidations) and the
        # sidecar actually observed traffic.
        failover_ok = bool(
            failover_ev["kill_fired"] == 1
            and failover_ev["beta_leader"]
            and resumes_d >= 1
            and invals_d == 0
            and lane.cancels == 0
            and lane.errors == 0
            and lane.events > 0
        )
    return {
        # Host seconds of each stretch of the run (setup = the store and
        # the node registration); the only keys here besides the failover
        # lane's recovery_s that read the host clock.
        "phase_s": {k: round(v, 3) for k, v in phase_s.items()},
        "weights": weights,
        "mesh": args.mesh,
        "packing": args.packing,
        "failover": failover_ev,
        **trace_detail,
        "packing_fallbacks": packing_fallbacks,
        "mesh_sharded_scatters": mesh_scatters,
        "admitted": len(admitted),
        "rejected": rejected,
        "admitted_by_tenant": counters["admitted"],
        "lost": lost,
        "states_seen": sorted(STATE_NAMES[s] for s in states_seen),
        "recovered_at_tick": recovered_at,
        "node_churn_events": churned,
        "pipeline_quiesce": qd,
        "sustained_inflight_depth": int(np.median(samples)),
        "max_inflight_depth": int(samples.max()),
        "hotfeed_staged_used": staged_used,
        "faults_injected": faults,
        "retry_give_ups": int(give_ups),
        "passed": bool(
            lost == 0
            and qd["structural"] == 0
            and qd["resync"] == 0
            and int(np.median(samples)) >= args.depth
            and SHEDDING in states_seen
            and recovered_at is not None
            and faults > 0
            and give_ups == 0
            and staged_used > 0
            # Mesh lane: the capacity churn must
            # actually have flowed through the sharded mid-flight
            # scatter, not a fallen-back single-device path.
            and (not args.mesh or mesh_scatters["cap"] > 0)
            # Packed lane: the composed window must hold the
            # packed layout end to end — zero fail-closed rebuilds.
            and (args.packing != "packed" or packing_fallbacks == 0)
            # Failover lane: leader SIGKILL absorbed by
            # the warm standby AND the tier's upstream break absorbed
            # by resume, inside the same composed window.
            and failover_ok
        ),
    }


def main(argv=None) -> dict:
    args = parse_args(argv)
    evidence = run(args)
    result = {
        "metric": "steady_state_drill"
        + ("_mesh" if args.mesh else "")
        + ("_failover" if args.failover else "")
        + ("_smoke" if args.smoke else ""),
        "value": evidence["sustained_inflight_depth"],
        "unit": "sustained in-flight depth under composed load",
        "vs_baseline": None,
        "passed": evidence["passed"],
        "seed": args.seed,
        "device": str(args.device),
        "shape": {
            "nodes": args.nodes, "batch": args.batch, "depth": args.depth,
            "tenants": args.tenants, "tenant_skew": args.tenant_skew,
            "factor": args.factor, "churn_per_tick": args.churn_per_tick,
            "conflict_every": args.conflict_every, "mesh": args.mesh,
            "packing": args.packing, "failover": args.failover,
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
