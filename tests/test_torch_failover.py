"""The port's lease-epoch fencing, warm standby and failover drill against
the JAX package's, on the CPU.

Twins of tests/test_failover.py's fencing, warm-standby and no-leader
tests and its ``failover_drill --smoke`` lane.  The deterministic ones run
the same script once per package, each over its own store and driven by
the same injected clock (zero-delay, zero-jitter bind retries where a
retry's timing could differ), and compare every observation, then the
stored pod bytes and the recovered coordinator's host mirror.  The
drill's evidence must equal the JAX drill's apart from its wall-clock
fields.  Added for the port: a fenced coordinator leaves the store
revision unchanged on every write path (the native bind wave, the
per-pod bind CAS, eviction, preemption); a following mirror never
writes; ``warm_compile`` leaves the live table and the wave seed stream
untouched.  Tolerance: exact.
"""

from __future__ import annotations

import _torch_cpu  # noqa: F401  (bounds torch's CPU threads first)

import json

import pytest
import torch

import k8s1m_tpu.faultline as jfault
import k8s1m_tpu.obs.metrics as jmetrics
import k8s1m_tpu_torch.faultline as tfault
import k8s1m_tpu_torch.obs.metrics as tmetrics
from test_torch_leader import PKGS, PORT, host_mirror, make_coord, stored_pods


@pytest.fixture(autouse=True)
def _reset_injectors():
    tfault.install_plan(None)
    jfault.install_plan(None)
    yield
    tfault.install_plan(None)
    jfault.install_plan(None)


def registry(P):
    return (tmetrics if P is PORT else jmetrics).REGISTRY


def fence_rejects(P) -> float:
    m = registry(P).get("fencing_rejected_total")
    return sum(m.value(path=p) for p in ("bind", "evict", "preempt"))


def put_nodes(P, store, n=8):
    for i in range(n):
        node = P.nt.NodeInfo(f"node-{i}", cpu_milli=400000, mem_kib=8 << 20, pods=4096)
        store.put(P.obj.node_key(node.name), P.obj.encode_node(node))


def put_pods(P, store, n, prefix="pod", ns="default"):
    for i in range(n):
        p = P.pe.PodInfo(f"{prefix}-{i}", namespace=ns, cpu_milli=100, mem_kib=1 << 10)
        store.put(P.obj.pod_key(ns, p.name), P.obj.encode_pod(p))


def zero_retry(P) -> dict:
    """Zero-delay, zero-jitter bind retries: a requeued pod's next wave
    does not depend on the clock, so both packages see the same waves."""
    fault = tfault if P is PORT else jfault
    return dict(retry_policy=fault.RetryPolicy(component="coordinator.bind", base_delay_s=0.0,
                                               jitter=0.0))


def unbound(P, store, names) -> bool:
    return all(
        not json.loads(store.get(P.obj.pod_key("default", n)).value)["spec"].get("nodeName")
        for n in names
    )


def run_both(scenario):
    """``scenario(P, store, rec)`` once per package over a fresh store; the
    observations and the stored pods must agree."""
    got = {}
    for P in PKGS:
        store = P.native.MemStore()
        rec: list = []
        try:
            scenario(P, store, rec)
            rec.append(("pods", stored_pods(P, store)))
        finally:
            store.close()
        got[P.name] = rec
    assert got["port"] == got["jax"]
    return got["port"]


# ---- lease-epoch fencing -------------------------------------------------------


def test_fence_rejects_deposed_reigns_binds():
    """A coordinator fenced on a stolen reign's epoch binds nothing: every
    pod drains to the conflict/requeue machinery."""
    def scenario(P, store, rec):
        put_nodes(P, store)
        put_pods(P, store, 6)
        a = P.leader.LeaderElector(store, "a")
        assert a.tick(0.0)
        coord = make_coord(P, store, fence=a.fence())
        coord.bootstrap()
        assert coord.run_until_idle() == 6
        b = P.leader.LeaderElector(store, "b")
        assert b.tick(16.0)
        put_pods(P, store, 4, prefix="late")
        r0 = fence_rejects(P)
        assert coord.run_until_idle(max_cycles=50) == 0
        assert fence_rejects(P) > r0
        assert unbound(P, store, [f"late-{i}" for i in range(4)])
        rec.append(host_mirror(coord))
        coord.close()

    run_both(scenario)


def test_fence_rejects_mid_wave_on_local_expiry():
    """The local half of the fence: a leader whose own injected clock shows
    the lease expired refuses its writes before observing a successor."""
    def scenario(P, store, rec):
        put_nodes(P, store)
        put_pods(P, store, 4)
        a = P.leader.LeaderElector(store, "a")
        assert a.tick(0.0)
        coord = make_coord(P, store, fence=a.fence())
        coord.bootstrap()
        a.last_now = 20.0
        assert a.locally_expired()
        rev = store.current_revision
        assert coord.run_until_idle(max_cycles=50) == 0
        assert store.current_revision == rev
        rec.append(host_mirror(coord))
        coord.close()

    run_both(scenario)


def test_deposed_pipeline_drains_to_requeue_not_store():
    """In-flight pipelined waves of a deposed reign retire through the
    fence: flush() lands zero store writes and the pods re-enter the retry
    machinery."""
    def scenario(P, store, rec):
        put_nodes(P, store)
        put_pods(P, store, 16)
        a = P.leader.LeaderElector(store, "a")
        assert a.tick(0.0)
        coord = make_coord(P, store, fence=a.fence(), pipeline=True, depth=2)
        coord.bootstrap()
        coord.step()
        assert coord._inflights
        b = P.leader.LeaderElector(store, "b")
        assert b.tick(16.0)
        r0 = fence_rejects(P)
        rev = store.current_revision
        assert coord.flush() == 0
        assert fence_rejects(P) > r0
        assert store.current_revision == rev
        assert unbound(P, store, [f"pod-{i}" for i in range(16)])
        assert len(coord._backoff) + len(coord.queue) == 16
        rec.append((len(coord._backoff), len(coord.queue), host_mirror(coord)))
        coord.close()

    run_both(scenario)


# ---- warm standby: follow, promote, reconcile -----------------------------------


def test_warm_standby_promotes_and_drains_backlog():
    def scenario(P, store, rec):
        put_nodes(P, store)
        put_pods(P, store, 12, prefix="early")
        ha_a = P.leader.HACoordinator(P.leader.LeaderElector(store, "a"),
                                      lambda: make_coord(P, store))
        ha_b = P.leader.HACoordinator(P.leader.LeaderElector(store, "b", retry_period_s=1.0),
                                      lambda: make_coord(P, store), warm_standby=True)
        assert ha_a.tick(0.0) == 12
        for t in (0.5, 1.5, 2.5):
            ha_b.tick(t)
        assert ha_b._mirror is not None
        assert len(ha_b._mirror._bound) == 12
        put_pods(P, store, 7, prefix="late")
        t, total = 2.5, 0
        while t < 30.0:
            t += 1.0
            total += ha_b.tick(t)
        assert ha_b.elector.is_leader
        assert ha_b.takeover_mode == "warm"
        assert ha_b.last_promote_stats["resync"] == 0
        assert total == 7
        rec.append((ha_b.last_promote_stats, host_mirror(ha_b.coord)))
        ha_b.stop()
        ha_a.kill()

    run_both(scenario)


def test_promote_purges_stale_queue_entries():
    """A follower queues every pending pod, then learns the leader bound
    them: promote purges the settled records."""
    def scenario(P, store, rec):
        put_nodes(P, store)
        ha_a = P.leader.HACoordinator(P.leader.LeaderElector(store, "a"),
                                      lambda: make_coord(P, store))
        ha_b = P.leader.HACoordinator(P.leader.LeaderElector(store, "b", retry_period_s=1.0),
                                      lambda: make_coord(P, store), warm_standby=True)
        assert ha_a.tick(0.0) == 0
        put_pods(P, store, 10)
        ha_b.tick(0.5)
        assert len(ha_b._mirror.queue) == 10
        assert ha_a.tick(1.0) == 10
        ha_b.tick(1.5)
        t = 1.5
        while not ha_b.elector.is_leader and t < 30.0:
            t += 1.0
            ha_b.tick(t)
        assert ha_b.last_promote_stats["stale_queue_purged"] == 10
        assert not ha_b.coord.queue
        rec.append((t, ha_b.last_promote_stats))
        ha_b.stop()
        ha_a.kill()

    run_both(scenario)


def test_reconcile_at_adopts_missed_bind_and_dedupes():
    """_reconcile_at repairs a bind the watch never delivered (adopted as
    external, counted); the later watch echo of the same bind does not
    double-account it; a deletion the watch missed is dropped."""
    def scenario(P, store, rec):
        put_nodes(P, store)
        coord = make_coord(P, store)
        coord.bootstrap()
        p = P.pe.PodInfo("ghost", cpu_milli=100, mem_kib=1 << 10, node_name="node-0")
        store.put(P.obj.pod_key("default", p.name), P.obj.encode_pod(p))
        rep = coord._reconcile_at(store.current_revision)
        assert rep["binds_adopted"] == 1
        assert "default/ghost" in coord._bound
        row = coord.host.row_of("node-0")
        assert int(coord.host.pods_req[row]) == 1
        coord.drain_watches()
        assert int(coord.host.pods_req[row]) == 1
        # The port's MemStore deletes through put_batch (value None).
        key = P.obj.pod_key("default", "ghost")
        if P is PORT:
            store.put_batch([(key, None)])
        else:
            store.delete(key)
        coord._pods_watch.poll_light(10000)     # discard the delete event (the gap)
        rep2 = coord._reconcile_at(store.current_revision)
        assert rep2["pods_dropped"] == 1
        assert int(coord.host.pods_req[row]) == 0
        rec.append((rep, rep2, host_mirror(coord)))
        coord.close()

    run_both(scenario)


def test_reconcile_at_compacted_pin_falls_back_to_resync():
    """A pin outside the store's window: the pinned diff is impossible and
    ``_reconcile_at`` falls back to a full resync, in both packages."""
    def scenario(P, store, rec):
        put_nodes(P, store)
        coord = make_coord(P, store)
        coord.bootstrap()
        rep = coord._reconcile_at(store.current_revision + 1000)
        assert rep == {"resync": 1}
        put_pods(P, store, 3)
        assert coord.run_until_idle() == 3
        rec.append(host_mirror(coord))
        coord.close()

    run_both(scenario)


def _gang_tenancy(P, name):
    return P.tenancy.TenancyController(
        P.tenancy.TenancyPolicy(weights={"default": 1}),
        loadshed_config=P.ls.LoadshedConfig(queue_cap=1 << 16), name=name,
    )


def _with_tenancy(P):
    import k8s1m_tpu.tenancy as jten
    import k8s1m_tpu_torch.tenancy as tten

    P.tenancy = tten if P is PORT else jten
    return P


def test_recover_gangs_all_or_none():
    """A gang the predecessor left half-bound recovers all-or-none: the
    bound members release, the gang re-stages whole and one wave binds all
    of it."""
    def scenario(P, store, rec):
        P = _with_tenancy(P)
        put_nodes(P, store)
        for m in range(4):
            p = P.pe.PodInfo(f"g-m{m}", cpu_milli=100, mem_kib=1 << 10,
                             labels={"k8s1m.io/gang": "g", "k8s1m.io/gang-size": "4"},
                             node_name="node-0" if m < 2 else "")
            store.put(P.obj.pod_key("default", p.name), P.obj.encode_pod(p))
        coord = make_coord(P, store, tenancy=_gang_tenancy(P, f"recover-gangs-{P.name}"))
        coord.bootstrap()
        assert len(coord._bound) == 2
        assert coord._gang_staging
        assert coord.recover_gangs() == 2
        assert not coord._gang_staging
        coord.run_until_idle()
        for m in range(4):
            obj = json.loads(store.get(P.obj.pod_key("default", f"g-m{m}")).value)
            assert obj["spec"].get("nodeName"), f"g-m{m} unbound"
        rec.append(host_mirror(coord))
        coord.close()

    run_both(scenario)


def test_recover_gangs_released_member_traces_as_failover():
    """The takeover release re-anchors a traced member's span chain with
    ``source="failover"`` (JAX coordinator :2045-2055)."""
    from k8s1m_tpu_torch.obs.podtrace import PodTracer

    P = _with_tenancy(PORT)
    store = P.native.MemStore()
    try:
        put_nodes(P, store)
        for m in range(4):
            p = P.pe.PodInfo(f"g-m{m}", cpu_milli=100, mem_kib=1 << 10,
                             labels={"k8s1m.io/gang": "g", "k8s1m.io/gang-size": "4"},
                             node_name="node-0" if m < 2 else "")
            store.put(P.obj.pod_key("default", p.name), P.obj.encode_pod(p))
        tracer = PodTracer(sample_n=1)
        began = []
        orig = tracer.begin

        def spy(key, t, *a, source=None, **kw):
            began.append((key, source))
            return orig(key, t, *a, source=source, **kw) if source is not None else \
                orig(key, t, *a, **kw)

        tracer.begin = spy
        coord = make_coord(P, store, tenancy=_gang_tenancy(P, "trace-gangs"), tracer=tracer)
        coord.bootstrap()
        assert coord.recover_gangs() == 2
        assert {k for k, src in began if src == "failover"} == {"default/g-m0", "default/g-m1"}
        coord.close()
    finally:
        store.close()


def test_fully_bound_gang_not_released_at_takeover():
    def scenario(P, store, rec):
        P = _with_tenancy(P)
        put_nodes(P, store)
        for m in range(4):
            p = P.pe.PodInfo(f"g-m{m}", cpu_milli=100, mem_kib=1 << 10,
                             labels={"k8s1m.io/gang": "g", "k8s1m.io/gang-size": "4"},
                             node_name="node-1")
            store.put(P.obj.pod_key("default", p.name), P.obj.encode_pod(p))
        coord = make_coord(P, store, tenancy=_gang_tenancy(P, f"honor-gangs-{P.name}"))
        coord.bootstrap()
        rev = store.current_revision
        assert coord.recover_gangs() == 0
        assert store.current_revision == rev
        for m in range(4):
            obj = json.loads(store.get(P.obj.pod_key("default", f"g-m{m}")).value)
            assert obj["spec"]["nodeName"] == "node-1"
        rec.append(host_mirror(coord))
        coord.close()

    run_both(scenario)


# ---- no-leader window: queue-or-429 ---------------------------------------------


def test_no_leader_submit_external_raises_overloaded():
    for P in PKGS:
        store = P.native.MemStore()
        try:
            ha = P.leader.HACoordinator(P.leader.LeaderElector(store, "a"),
                                        lambda P=P, store=store: make_coord(P, store))
            pod = json.loads(P.obj.encode_pod(P.pe.PodInfo("orphan")))
            with pytest.raises(P.ls.Overloaded) as ei:
                ha.submit_external(pod)
            assert ei.value.reason == "no-leader"
            assert ei.value.retry_after_s == 15.0
        finally:
            store.close()


def test_no_leader_queues_into_warm_standby_then_schedules():
    def scenario(P, store, rec):
        put_nodes(P, store)
        ha = P.leader.HACoordinator(P.leader.LeaderElector(store, "b", retry_period_s=1.0),
                                    lambda: make_coord(P, store), warm_standby=True,
                                    standby_queue_cap=2)
        other = P.leader.LeaderElector(store, "other")
        assert other.tick(0.0)
        ha.tick(0.5)
        assert ha._mirror is not None and ha.coord is None
        p = P.pe.PodInfo("staged-while-leaderless", cpu_milli=100, mem_kib=1 << 10)
        ha.submit_external(json.loads(P.obj.encode_pod(p)))
        ha.submit_external(json.loads(P.obj.encode_pod(P.pe.PodInfo("second"))))
        with pytest.raises(P.ls.Overloaded) as ei:
            ha.submit_external(json.loads(P.obj.encode_pod(P.pe.PodInfo("third"))))
        assert ei.value.reason == "no-leader"
        store.put(P.obj.pod_key("default", p.name), P.obj.encode_pod(p))
        t, bound = 0.5, 0
        while t < 30.0:
            t += 1.0
            got = ha.tick(t)
            rec.append(got)
            bound += got
        assert ha.elector.is_leader
        assert bound >= 1
        assert not unbound(P, store, [p.name])
        rec.append(host_mirror(ha.coord))
        ha.stop()

    run_both(scenario)


# ---- the port's own: the fence on every write path, the silent mirror ------------


def _preempt_setup(P, store, fence):
    """One tenancy coordinator, a full node of low-priority pods bound, a
    high-priority pod pending: its wave preempts (evict + bind)."""
    P = _with_tenancy(P)
    node = P.nt.NodeInfo("node-0", cpu_milli=1000, mem_kib=8 << 20, pods=4)
    store.put(P.obj.node_key(node.name), P.obj.encode_node(node))
    tn = P.tenancy.TenancyController(
        P.tenancy.TenancyPolicy(weights={"default": 1}),
        loadshed_config=P.ls.LoadshedConfig(queue_cap=1 << 16), name=f"fence-pre-{P.name}")
    coord = make_coord(P, store, tenancy=tn, fence=fence, **zero_retry(P))
    coord.bootstrap()
    for i in range(4):
        p = P.pe.PodInfo(f"low-{i}", cpu_milli=250, mem_kib=1 << 10)
        store.put(P.obj.pod_key("default", p.name), P.obj.encode_pod(p))
    assert coord.run_until_idle() == 4
    return coord


@pytest.mark.parametrize("path", ["bind_batch", "bind_cas", "bind_webhook", "evict", "preempt"])
def test_fenced_coordinator_writes_nothing(path):
    """Once its reign is deposed, a fenced port coordinator leaves the store
    revision unchanged on each write path: the native bind wave
    (``bind_batch``), the per-pod bind CAS (a pod with labels takes the
    JSON intake), a webhook pod (no intake revision), the gang release
    (``_evict_bound``) and preemption — and every refusal is counted."""
    P = PORT
    store = P.native.MemStore()
    try:
        a = P.leader.LeaderElector(store, "a")
        assert a.tick(0.0)
        fence = a.fence()
        if path == "preempt":
            coord = _preempt_setup(P, store, fence)
        else:
            put_nodes(P, store)
            coord = make_coord(P, store, fence=fence, **zero_retry(P))
            coord.bootstrap()
            if path == "evict":
                put_pods(P, store, 2)
                assert coord.run_until_idle() == 2
        b = P.leader.LeaderElector(store, "b")
        assert b.tick(16.0)                 # the reign is deposed
        rev = store.current_revision
        r0 = registry(P).get("fencing_rejected_total").value(
            path={"evict": "evict", "preempt": "preempt"}.get(path, "bind"))
        if path == "bind_batch":
            put_pods(P, store, 8, prefix="fast")
        elif path == "bind_cas":
            for i in range(4):
                p = P.pe.PodInfo(f"lab-{i}", cpu_milli=100, mem_kib=1 << 10,
                                 labels={"app": "x"})
                store.put(P.obj.pod_key("default", p.name), P.obj.encode_pod(p))
        elif path == "bind_webhook":
            p = P.pe.PodInfo("hooked", cpu_milli=100, mem_kib=1 << 10)
            store.put(P.obj.pod_key("default", p.name), P.obj.encode_pod(p))
            coord.submit_external(json.loads(P.obj.encode_pod(p)))
        elif path == "preempt":
            hi = P.pe.PodInfo("high", cpu_milli=600, mem_kib=1 << 10, priority=100)
            store.put(P.obj.pod_key("default", hi.name), P.obj.encode_pod(hi))
        rev = store.current_revision
        if path == "evict":
            evicted, _rec = coord._evict_bound("default/pod-0", count_eviction=False)
            assert not evicted
        else:
            assert coord.run_until_idle(max_cycles=20) == 0
        assert store.current_revision == rev
        assert registry(P).get("fencing_rejected_total").value(
            path={"evict": "evict", "preempt": "preempt"}.get(path, "bind")) > r0
        coord.close()
    finally:
        store.close()


def test_follower_mirror_never_writes():
    """A following mirror drains the leader's writes and warms its wave but
    never writes: the store revision moves only with the leader's and the
    producer's writes, and a follow() tick alone leaves it still."""
    P = PORT
    store = P.native.MemStore()
    try:
        put_nodes(P, store)
        leader = make_coord(P, store)
        leader.bootstrap()
        mirror = make_coord(P, store)
        mirror._follower = True
        mirror.bootstrap()
        for w in range(3):
            put_pods(P, store, 8, prefix=f"w{w}")
            rev = store.current_revision
            mirror.follow()
            assert store.current_revision == rev
            leader.step()
            rev = store.current_revision
            mirror.follow()
            assert store.current_revision == rev
        assert mirror._warmed and sum(mirror.waves.values()) == 0
        assert sorted(mirror._bound) == sorted(leader._bound)
        assert host_mirror(mirror) == host_mirror(leader)
        leader.close()
        mirror.close()
    finally:
        store.close()


def test_warm_compile_leaves_table_and_seed_stream_untouched():
    """The discarded warm-up wave runs on clones: the live table keeps its
    request columns and storage, the constraint state its counts, and the
    wave seed stream is not advanced — the mirror's next real wave binds
    exactly as a never-warmed coordinator's."""
    P = PORT
    stores, coords = [], []
    try:
        for warm in (True, False):
            store = P.native.MemStore()
            stores.append(store)
            put_nodes(P, store)
            coord = make_coord(P, store, with_constraints=True)
            coord.bootstrap()
            put_pods(P, store, 12)
            coord.drain_watches()
            before = {c: getattr(coord.table, c).clone() for c in
                      ("cpu_req", "mem_req", "pods_req")}
            ptr = coord.table.cpu_req.data_ptr()
            counts = coord.constraints.clone()
            key = coord.key
            if warm:
                assert coord.warm_compile()
                assert not coord.warm_compile()     # latched
            for c, t in before.items():
                assert torch.equal(getattr(coord.table, c), t), c
            assert coord.table.cpu_req.data_ptr() == ptr
            for f in ("spread_node", "tgt_node", "own_node", "spread_zone", "tgt_zone"):
                assert torch.equal(getattr(coord.constraints, f), getattr(counts, f)), f
            assert coord.key is key
            coords.append(coord)
            assert coord.run_until_idle() == 12
        assert stored_pods(P, stores[0]) == stored_pods(P, stores[1])
    finally:
        for c in coords:
            c.close()
        for s in stores:
            s.close()


# ---- the drill ----------------------------------------------------------------------


_CLOCK_KEYS = ("recovery_s", "recovery_warm_s", "recovery_cold_s", "warm_speedup", "value",
               "device", "backend", "pods_sha256")
SCENARIOS = ("mid_wave_kill_cold", "mid_wave_kill_warm", "split_brain")


def _deterministic(doc) -> dict:
    """The drill document without its host-clock parts: the takeover
    seconds and the run-level ``passed`` (it holds warm < cold on the host
    clock); every scenario's own ``passed`` stays."""
    doc = _scrub(doc)
    doc.pop("passed")
    doc["evidence"].pop("passed")
    return doc


def _digest(kvs) -> str:
    import hashlib

    h = hashlib.sha256()
    for kv in kvs:
        h.update(len(kv.key).to_bytes(4, "little") + kv.key)
        h.update(len(kv.value).to_bytes(4, "little") + kv.value)
    return h.hexdigest()


def _scrub(d):
    if isinstance(d, dict):
        return {k: _scrub(v) for k, v in d.items() if k not in _CLOCK_KEYS}
    return d


def test_failover_drill_smoke_passes_and_equals_jax(tmp_path, monkeypatch):
    """The port's drill at its smoke shape passes every gate (0 lost, 0
    double binds, fencing rejects in split-brain, byte-consistent
    recovery, warm < cold); its evidence equals the JAX drill's apart from
    the host-clock parts, and each scenario leaves the same stored pod
    bytes in both packages."""
    import k8s1m_tpu.store.native as jnative
    from k8s1m_tpu.tools import failover_drill as jdrill
    from k8s1m_tpu_torch.tools import failover_drill as tdrill

    jax_digests = []
    close = jdrill.World.close

    def digest_then_close(world):
        jax_digests.append(_digest(jnative.list_prefix(world.store, world.pods_prefix)[0]))
        close(world)

    monkeypatch.setattr(jdrill.World, "close", digest_then_close)

    got = tdrill.main(["--smoke", "--device", "cpu", "--out", str(tmp_path / "t.json")])
    assert got["passed"], got
    ev = got["evidence"]
    assert ev["split_brain"]["fencing_rejected"] > 0
    assert ev["recovery_warm_s"] < ev["recovery_cold_s"]
    for k in SCENARIOS:
        assert ev[k]["lost"] == 0
        assert ev[k]["ledger"]["double_binds"] == 0
        assert ev[k]["consistency"]["byte_consistent"]
    want = jdrill.main(["--smoke", "--out", str(tmp_path / "j.json")])
    assert _deterministic(got) == _deterministic(want)
    assert [ev[k]["pods_sha256"] for k in SCENARIOS] == jax_digests


def test_failover_drill_runs_agree_byte_for_byte(tmp_path):
    """Two port runs of the drill at one seed (tick-driven, injected
    clock) leave the same stored pod bytes in every scenario and the same
    evidence apart from the wall-clock fields — the takeover seconds and
    the run-level ``passed``, which holds warm < cold on the host clock
    (each scenario's own ``passed`` is compared)."""
    from k8s1m_tpu_torch.tools import failover_drill as tdrill

    runs = [tdrill.main(["--smoke", "--device", "cpu", "--out", str(tmp_path / f"{i}.json")])
            for i in range(2)]
    assert [r["evidence"][k]["pods_sha256"] for k in SCENARIOS for r in runs[:1]] == \
        [runs[1]["evidence"][k]["pods_sha256"] for k in SCENARIOS]
    assert all(r["evidence"][k]["passed"] for r in runs for k in SCENARIOS)
    assert _deterministic(runs[0]) == _deterministic(runs[1])


@pytest.mark.parametrize("keys_only", [True, False])
def test_list_prefix_items_is_the_pinned_list(keys_only):
    """``_reconcile_at`` reads its pinned relists through the light parse:
    at a pinned revision it returns exactly ``list_prefix``'s keys (or key
    and value bytes) at that revision across pages, ignores later writes,
    and raises past the store's window."""
    P = PORT
    store = P.native.MemStore()
    try:
        put_nodes(P, store, n=23)
        rev = store.current_revision
        put_nodes(P, store, n=31)                  # 8 more nodes after the pin
        store.put_batch([(P.obj.node_key("node-3"), None)])
        kvs = P.native.list_prefix(store, b"/registry/minions/", keys_only=keys_only,
                                   revision=rev)[0]
        want = [kv.key if keys_only else (kv.key, kv.value) for kv in kvs]
        got = P.native.list_prefix_items(store, b"/registry/minions/", revision=rev,
                                         keys_only=keys_only, page=5)
        assert got == want and len(got) == 23
        now = P.native.list_prefix_items(store, b"/registry/minions/", keys_only=keys_only,
                                         page=4)
        assert len(now) == 30
        assert P.obj.node_key("node-3") not in [x if keys_only else x[0] for x in now]
        with pytest.raises(P.native.FutureRevError):
            P.native.list_prefix_items(store, b"/registry/minions/", keys_only=keys_only,
                                       revision=store.current_revision + 5)
    finally:
        store.close()
