"""The port's tenancy against the JAX package's, on the CPU.

Twin of tests/test_tenancy.py for ``k8s1m_tpu_torch.tenancy``: the tenant
dimension of the workload, FairAdmission (weight shares, reasons, the
starter cushion, idle eviction, the guard audit) driven through the same
admission sequence in both packages, victim selection as a pure
function, and the coordinator integration in lockstep with the JAX
coordinator (zero-delay retries): gang completion, gang partial failure
with byte-exact release, oversize gangs, preemption with its replay, and
an overload walk to SHEDDING and back through ``submit_external``.  After
each, the stored pods, the host mirror and the device table must be
byte-identical, and the controller states and admission counts equal.
The webhook test and the two drill smokes of the JAX file wait for the
port's webhook and drills.  Tolerance: exact equality.
"""

import json

import pytest

import k8s1m_tpu.cluster.workload as jwork
import k8s1m_tpu.loadshed as jls
import k8s1m_tpu.tenancy as jtn
from k8s1m_tpu.obs.metrics import REGISTRY as JREGISTRY
from k8s1m_tpu.tenancy.preempt import Victim as JVictim
from k8s1m_tpu.tenancy.preempt import select_preemption as jselect
from k8s1m_tpu_torch.cluster.workload import (
    tenant_assignments,
    tenant_rate_multipliers,
    zipf_weights,
)
from k8s1m_tpu_torch.config import PodSpec, TableSpec
from k8s1m_tpu_torch.control.coordinator import (
    Coordinator,
    splice_node_name,
    unsplice_node_name,
)
from k8s1m_tpu_torch.control.objects import decode_node, encode_node, encode_pod, node_key, pod_key
from k8s1m_tpu_torch.lint import guards
from k8s1m_tpu_torch.loadshed import (
    HEALTHY,
    SHEDDING,
    STATE_NAMES,
    HealthController,
    LoadshedConfig,
    Overloaded,
    Signals,
)
from k8s1m_tpu_torch.obs.metrics import REGISTRY
from k8s1m_tpu_torch.plugins.registry import Profile
from k8s1m_tpu_torch.snapshot.node_table import NodeInfo
from k8s1m_tpu_torch.snapshot.pod_encoding import PodInfo
from k8s1m_tpu_torch.store.native import MemStore, list_prefix
from k8s1m_tpu_torch.tenancy import (
    FairAdmission,
    TenancyController,
    TenancyPolicy,
    gang_of_labels,
    tenant_of_key,
    tenant_of_obj,
)
from k8s1m_tpu_torch.tenancy.preempt import Victim, select_preemption
from test_torch_loadshed import LockPair

CFG = dict(queue_degraded=10, queue_shed=20, queue_cap=100_000, queue_recover=4,
           recover_cycles=2)


# ---- 1. the tenant dimension --------------------------------------------------


def test_zipf_weights_shape():
    w = zipf_weights(4, 1.0)
    assert len(w) == 4 and abs(sum(w) - 1.0) < 1e-9
    assert w[0] > w[1] > w[2] > w[3]
    assert zipf_weights(3, 0.0) == pytest.approx([1 / 3] * 3)
    assert w == jwork.zipf_weights(4, 1.0)


def test_tenant_assignments_deterministic_and_scheduled():
    a = tenant_assignments(2000, 5, skew=1.0, seed=7)
    assert a == tenant_assignments(2000, 5, skew=1.0, seed=7)
    assert a == jwork.tenant_assignments(2000, 5, skew=1.0, seed=7)
    assert tenant_assignments(2000, 5, skew=1.0, seed=8) != a
    assert set(a) <= set(range(5))
    counts = [a.count(t) for t in range(5)]
    assert counts[0] > counts[-1]
    f = tenant_assignments(5000, 5, skew=0.0, seed=3, schedule="flash")
    assert f == jwork.tenant_assignments(5000, 5, skew=0.0, seed=3, schedule="flash")
    assert f[2000:3000].count(0) / 1000 > 2 * f[:1000].count(0) / 1000
    with pytest.raises(ValueError):
        tenant_rate_multipliers("lunar", 0.5, 3)


def test_tenant_identity_forms():
    assert tenant_of_key("ns-a/pod-1") == "ns-a"
    obj = json.loads(encode_pod(PodInfo("p", namespace="ns-b")))
    assert tenant_of_obj(obj) == "ns-b"
    obj["metadata"]["labels"] = {"k8s1m.io/tenant": "big-co"}
    assert tenant_of_obj(obj) == "big-co" == jtn.tenant_of_obj(obj)


def test_gang_label_parse():
    for labels in ({"k8s1m.io/gang": "g", "k8s1m.io/gang-size": "3"},
                   {"k8s1m.io/gang": "g", "k8s1m.io/gang-size": "x"},
                   {"k8s1m.io/gang": "g", "k8s1m.io/gang-size": "1"}, {}):
        assert gang_of_labels(labels, "ns") == jtn.gang_of_labels(labels, "ns")
    assert gang_of_labels({"k8s1m.io/gang": "g", "k8s1m.io/gang-size": "3"}, "ns") == ("ns/g", 3)


# ---- 2. weighted-fair admission ------------------------------------------------


def _fa(name, weights, cfg=CFG, cap=100):
    return (
        FairAdmission(TenancyPolicy(weights=weights),
                      HealthController(LoadshedConfig(**cfg), name=name), capacity_per_tick=cap),
        jtn.FairAdmission(jtn.TenancyPolicy(weights=weights),
                          jls.HealthController(jls.LoadshedConfig(**cfg), name=name),
                          capacity_per_tick=cap),
    )


def _pressure(fas, depth=50, cap=None):
    fas[0].controller.tick(Signals(queue_depth=depth))
    fas[1].controller.tick(jls.Signals(queue_depth=depth))
    fas[0].tick(capacity=cap)
    fas[1].tick(capacity=cap)


def _try(fas, tenant):
    got = fas[0].try_admit(tenant)
    assert got == fas[1].try_admit(tenant)
    return got


def test_healthy_admits_everything():
    fa = _fa("fa-healthy", {"a": 1, "b": 9})
    for _ in range(500):
        assert _try(fa, "a") is None
    assert fa[0].counters()["rejected"] == {}


def test_enforcement_tracks_weight_shares():
    fa = _fa("fa-shares", {"a": 3, "b": 1})
    _pressure(fa, cap=100)
    for _ in range(25):
        for _ in range(200):
            _try(fa, "a")
            _try(fa, "b")
        _pressure(fa, cap=100)
    adm = fa[0].counters()["admitted"]
    assert abs(adm["a"] / (adm["a"] + adm["b"]) - 0.75) < 0.05
    assert fa[0].counters()["debt"]
    assert fa[0].counters() == fa[1].counters()


def test_reasons_tenant_vs_cap_and_overloaded():
    fa = _fa("fa-reasons", {"a": 1})
    _pressure(fa, cap=4)
    assert {_try(fa, "a") for _ in range(50)} == {None, "tenant"}
    obj = json.loads(encode_pod(PodInfo("p", namespace="a")))
    with pytest.raises(Overloaded) as ei:
        for _ in range(50):
            fa[0].check_admit_obj(obj)
    assert ei.value.reason == "tenant"
    small = FairAdmission(TenancyPolicy(), HealthController(LoadshedConfig(
        queue_degraded=2, queue_shed=3, queue_cap=4, queue_recover=1), name="fa-cap"))
    small.controller.tick(Signals(queue_depth=4))
    small.tick()
    assert small.try_admit("anyone") == "cap"


def test_unseen_tenant_mid_pressure_gets_starter_cushion():
    fa = _fa("fa-starter", {"a": 1})
    _pressure(fa, cap=10)
    assert _try(fa, "new") is None


def test_fair_admission_guarded_under_audit_threads():
    import threading

    fa = FairAdmission(TenancyPolicy(weights={"a": 1, "b": 1}),
                       HealthController(LoadshedConfig(**CFG), name="fa-audit"))
    fa.controller.tick(Signals(queue_depth=50))
    with guards.audit():
        threads = [threading.Thread(target=lambda t=t: [fa.try_admit(t) for _ in range(300)])
                   for t in ("a", "b", "a", "b")]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        fa.tick()
    assert guards.violations() == []


def test_floor_not_prearmed_by_high_first_priority():
    ctrl = HealthController(LoadshedConfig(queue_degraded=10, queue_shed=20, queue_cap=1000,
                                           queue_recover=4), name="prio-prearm")
    ctrl.try_admit(5)
    for _ in range(50):
        ctrl.try_admit(0)
    ctrl.tick(Signals(queue_depth=25))
    assert not ctrl.admit(0)
    assert ctrl.admit(1)
    ctrl.tick(Signals(queue_depth=25))
    assert not ctrl.admit(1)
    assert ctrl.admit(2)


def test_idle_tenants_evicted_from_working_state():
    fa = _fa("fa-evict", {"a": 1})
    _pressure(fa, cap=10)
    _try(fa, "ghost")
    for f in fa:
        f.tick(capacity=10)
    assert "ghost" in fa[0]._buckets
    for _ in range(3 * fa[0]._idle_evict_ticks):
        _try(fa, "a")
        for f in fa:
            f.tick(capacity=10)
    assert "ghost" not in fa[0]._buckets and "ghost" not in fa[0]._debt
    assert "a" in fa[0]._buckets
    assert fa[0].counters()["admitted"]["ghost"] == 1
    assert fa[0].counters() == fa[1].counters()


# ---- 3. victim selection -------------------------------------------------------


def test_victim_order_priority_then_tenant_then_recency():
    nd = NodeInfo(name="n0", cpu_milli=10_000, mem_kib=1 << 20, pods=10)
    usage = {0: (10_000, 0, 10)}
    pod = PodInfo("hi", namespace="me", cpu_milli=1000, priority=5)
    rows = [("x/a", 2, 10, "other"), ("x/b", 0, 5, "other"), ("me/c", 0, 9, "me"),
            ("x/d", 0, 8, "other")]
    victims = [Victim(k, "n0", 0, 1000, 0, p, s, t) for k, p, s, t in rows]
    choice = select_preemption(pod, "me", 5, [(0, nd)], usage, {0: victims})
    assert choice is not None and choice.victims[0].key == "x/d"
    import k8s1m_tpu.snapshot.node_table as jnt
    import k8s1m_tpu.snapshot.pod_encoding as jpe

    jchoice = jselect(
        jpe.PodInfo("hi", namespace="me", cpu_milli=1000, priority=5), "me", 5,
        [(0, jnt.NodeInfo(name="n0", cpu_milli=10_000, mem_kib=1 << 20, pods=10))], usage,
        {0: [JVictim(k, "n0", 0, 1000, 0, p, s, t) for k, p, s, t in rows]})
    assert [v.key for v in choice.victims] == [v.key for v in jchoice.victims]
    assert (choice.row, choice.node) == (jchoice.row, jchoice.node)
    assert select_preemption(pod, "me", 5, [(0, nd)], usage,
                             {0: [Victim("x/e", "n0", 0, 1000, 0, 5, 1, "other")]}) is None
    assert select_preemption(pod, "me", 5, [(0, nd)], {0: (0, 0, 0)}, {0: victims}) is None


# ---- 4. coordinator integration, in lockstep --------------------------------------


def _tenancy_pair(nodes=8, slots=60, batch=32, policy=None, seed=3, **kw):
    policy = policy or dict(log_preemptions=True)
    tn = TenancyController(TenancyPolicy(**policy), **kw)
    jt = jtn.TenancyController(jtn.TenancyPolicy(**policy), **{
        k: (jls.LoadshedConfig(**v.__dict__) if k == "loadshed_config" else v)
        for k, v in kw.items()})
    p = LockPair(max_nodes=16, zones=4, regions=2, batch=batch, chunk=16, seed=seed,
                 tkw=dict(tenancy=tn), jkw=dict(tenancy=jt))
    p.write([(node_key(f"n{i:03d}"), encode_node(NodeInfo(
        name=f"n{i:03d}", cpu_milli=70_000, mem_kib=1 << 20, pods=slots)))
        for i in range(nodes)])
    p.bootstrap()
    return p, tn, jt


def _fill(p, n, cpu=1000, ns="fill"):
    raws = {}
    for i in range(n):
        pod = PodInfo(f"f-{i:05d}", namespace=ns, cpu_milli=cpu, mem_kib=1 << 10)
        raws[pod.key] = encode_pod(pod)
        p.put(pod_key(ns, pod.name), raws[pod.key])
    return raws


def _gang(p, n, cpu=3000, prio=10, name="burst", ns="ten-a", size=None, cpus=None):
    raws = {}
    for j in range(n):
        pod = PodInfo(f"{name}-{j}", namespace=ns, cpu_milli=cpus[j] if cpus else cpu,
                      mem_kib=1 << 10, priority=prio,
                      labels={"k8s1m.io/gang": name, "k8s1m.io/gang-size": str(size or n)})
        raws[pod.key] = encode_pod(pod)
        p.put(pod_key(ns, pod.name), raws[pod.key])
    return raws


def _gang_counts(registry):
    g = registry.get("gang_admit_total")
    return {o: g.value(outcome=o) for o in ("bound", "requeued", "parked", "oversize")}


def test_unsplice_is_exact_inverse():
    raw = encode_pod(PodInfo("x", cpu_milli=10, mem_kib=1024))
    assert unsplice_node_name(splice_node_name(raw, "n-1")) == raw
    assert unsplice_node_name(raw) is None


def test_gang_completion_lockstep():
    """(iv) A gang stages until complete, then binds in one wave."""
    p, _tn, _jt = _tenancy_pair()
    try:
        g0, jg0 = _gang_counts(REGISTRY), _gang_counts(JREGISTRY)
        for j in range(3):
            pod = PodInfo(f"m-{j}", namespace="ten-a", cpu_milli=100, mem_kib=1 << 10,
                          labels={"k8s1m.io/gang": "g3", "k8s1m.io/gang-size": "3"})
            p.put(pod_key("ten-a", pod.name), encode_pod(pod))
            p.run_until_idle()
            if j < 2:
                assert p.bound == 0 and p.t._gang_staged() == j + 1 == p.j._gang_staged()
        assert p.bound == 3
        g1, jg1 = _gang_counts(REGISTRY), _gang_counts(JREGISTRY)
        assert g1["bound"] - g0["bound"] == 1 == jg1["bound"] - jg0["bound"]
        p.check()
    finally:
        p.close()


def test_gang_partial_failure_lockstep():
    """(iv) One member never fits: its mates bind, are released
    all-or-none, retried and finally parked, with every stored object back
    at its exact pre-bind bytes and no capacity held."""
    p, _tn, _jt = _tenancy_pair()
    try:
        g0 = _gang_counts(REGISTRY)
        raws = _gang(p, 3, name="gx", prio=0, cpus=[100, 100, 1 << 20])
        p.run_until_idle()
        assert p.bound == 0
        g1 = _gang_counts(REGISTRY)
        assert g1["requeued"] > g0["requeued"] and g1["parked"] == g0["parked"] + 1
        assert len(p.t.unschedulable) == 3
        kvs = p.check()
        assert len(kvs) == 3
        for kv in kvs:
            assert kv.value == raws[kv.key[len(b"/registry/pods/"):].decode()]
        assert int(p.t.host.pods_req.sum()) == 0
        assert int(p.t.table.pods_req.sum()) == 0
    finally:
        p.close()


def test_gang_oversize_degrades_to_plain():
    p, _tn, _jt = _tenancy_pair(batch=4)
    try:
        over0 = REGISTRY.get("gang_admit_total").value(outcome="oversize")
        _gang(p, 6, cpu=100, name="big")
        p.run_until_idle()
        assert p.bound == 6
        assert REGISTRY.get("gang_admit_total").value(outcome="oversize") == over0 + 1
        p.check()
    finally:
        p.close()


def test_preemption_lockstep_and_replay():
    """(iv) A full cluster, then a high-priority gang: victims evicted to
    their exact pre-bind bytes and requeued, the preemptors bound at the
    logged nodes, the same preemption log as the JAX coordinator, and the
    pure selection replayed on the logged pre-state picks the same."""
    nodes, slots = 8, 60
    p, _tn, _jt = _tenancy_pair(nodes=nodes, slots=slots)
    try:
        raws = _fill(p, nodes * slots)
        p.run_until_idle()
        assert p.bound == nodes * slots
        raws.update(_gang(p, 4))
        ev0 = REGISTRY.get("preemption_evictions_total").value()
        p.run_until_idle()
        assert p.bound == nodes * slots + 4
        assert REGISTRY.get("preemption_evictions_total").value() == ev0 + 4
        assert p.t.preempt_log == p.j.preempt_log and len(p.t.preempt_log) == 4
        kvs, _ = list_prefix(p.tstore, b"/registry/minions/")
        nl = sorted((p.t.host.row_of(decode_node(kv.value).name), decode_node(kv.value))
                    for kv in kvs)
        victim_keys = set()
        for e in p.t.preempt_log:
            ns, name = e["pod"].split("/", 1)
            got = p.tstore.get(pod_key(ns, name)).value
            assert got == splice_node_name(raws[e["pod"]], e["node"])
            choice = select_preemption(
                PodInfo(name, namespace=ns, cpu_milli=3000, mem_kib=1 << 10,
                        priority=e["priority"]),
                e["tenant"], e["priority"], nl,
                {int(r): tuple(u) for r, u in e["usage"].items()},
                {int(r): [Victim(*v) for v in vs] for r, vs in e["candidates"].items()},
            )
            assert choice is not None and choice.node == e["node"]
            assert [v.key for v in choice.victims] == e["victims"]
            victim_keys.update(e["victims"])
        for vk in victim_keys:
            ns, name = vk.split("/", 1)
            assert p.tstore.get(pod_key(ns, name)).value == raws[vk]
        stored = p.check()
        assert len(stored) == nodes * slots + 4
        assert all(v.startswith("fill/") for e in p.t.preempt_log for v in e["victims"])
    finally:
        p.close()


def test_preemption_respects_min_priority_and_same_tenant_last():
    p, _tn, _jt = _tenancy_pair(nodes=1, slots=4)
    try:
        for ns, name in (("other", "o0"), ("other", "o1"), ("mine", "m0"), ("mine", "m1")):
            p.put(pod_key(ns, name), encode_pod(PodInfo(name, namespace=ns, cpu_milli=1000,
                                                        mem_kib=1 << 10)))
        p.run_until_idle()
        assert p.bound == 4
        p.put(pod_key("mine", "pre"), encode_pod(PodInfo(
            "pre", namespace="mine", cpu_milli=1000, mem_kib=1 << 10, priority=3)))
        p.run_until_idle()
        assert p.bound == 5
        [e] = p.t.preempt_log
        assert all(v.startswith("other/") for v in e["victims"])
        p.put(pod_key("mine", "low"), encode_pod(PodInfo(
            "low", namespace="mine", cpu_milli=1000, mem_kib=1 << 10, priority=0)))
        p.run_until_idle()
        assert p.bound == 5 and len(p.t.preempt_log) == 1
        p.check()
    finally:
        p.close()


def test_gang_bound_pods_are_never_preemption_victims():
    p, _tn, _jt = _tenancy_pair(nodes=1, slots=2)
    try:
        _gang(p, 2, cpu=1000, prio=0, name="pair")
        p.run_until_idle()
        assert p.bound == 2
        assert p.t._victims_index() == {} == p.t._victims_index_full()
        p.put(pod_key("x", "pre"), encode_pod(PodInfo("pre", namespace="x", cpu_milli=1000,
                                                      mem_kib=1 << 10, priority=5)))
        p.run_until_idle()
        assert p.bound == 2 and p.t.preempt_log == []
        kvs = p.check()
        assert sum(1 for kv in kvs if b'"nodeName"' in kv.value) == 2
    finally:
        p.close()


def test_deleted_member_leaves_gang_staging():
    p, _tn, _jt = _tenancy_pair()
    try:
        _gang(p, 2, size=3, name="gs")
        p.run_until_idle()
        assert p.t._gang_staged() == 2
        for j in range(2):
            for store in (p.jstore, p.tstore):
                store.put_batch([(pod_key("ten-a", f"gs-{j}"), None)])
            p.t.drain_watches()
            assert p.t._gang_staged() == 1 - j
        assert not p.t._gang_staging
    finally:
        p.close()


def test_victim_tenant_uses_label_override():
    p, _tn, _jt = _tenancy_pair(nodes=1, slots=4)
    try:
        p.put(pod_key("ns-a", "lbl"), encode_pod(PodInfo(
            "lbl", namespace="ns-a", cpu_milli=1000, mem_kib=1 << 10,
            labels={"k8s1m.io/tenant": "big-co"})))
        p.run_until_idle()
        assert p.bound == 1
        [vs] = p.t._victims_index().values()
        assert [v.tenant for v in vs] == ["big-co"]
    finally:
        p.close()


def test_fallback_take_rotates_oversize_gang_instead_of_wedging():
    p, _tn, _jt = _tenancy_pair(batch=8)
    try:
        coord = p.t
        _gang(p, 4, cpu=100, name="gg")
        coord.drain_watches()
        for j in range(2):
            p.put(pod_key("x", f"plain-{j}"), encode_pod(PodInfo(
                f"plain-{j}", namespace="x", cpu_milli=100, mem_kib=1 << 10)))
        coord.drain_watches()
        assert len(coord.queue) == 6
        taken = coord._take_pods(2)
        assert [q.key_str for q in taken] == ["x/plain-0", "x/plain-1"]
        assert [q.key_str for q in coord.queue] == [f"ten-a/gg-{j}" for j in range(4)]
        coord._requeue_front(taken)
        assert coord.run_until_idle() == 6
    finally:
        p.close()


def test_tenancy_with_foreign_loadshed_controller_rejected():
    tn = TenancyController(TenancyPolicy())
    other = HealthController(LoadshedConfig(**CFG), name="foreign")
    with MemStore() as store:
        kw = dict(chunk=8, k=4, with_constraints=False, device="cpu")
        args = (store, TableSpec(max_nodes=16, max_zones=4, max_regions=2), PodSpec(batch=8),
                Profile(topology_spread=0, interpod_affinity=0))
        with pytest.raises(ValueError, match="share one"):
            Coordinator(*args, tenancy=tn, loadshed=other, **kw)
        Coordinator(*args, tenancy=tn, loadshed=tn.controller, **kw).close()


def test_coordinator_tenancy_under_guard_audit():
    with guards.audit():
        p, _tn, _jt = _tenancy_pair(nodes=2, slots=8)
        try:
            _fill(p, 16)
            p.t.run_until_idle()
            _gang(p, 2, cpu=2000)
            p.t.run_until_idle()
            p.t.submit_external(json.loads(encode_pod(PodInfo("w", namespace="web"))))
            p.t.step()
        finally:
            p.close()
    assert guards.violations() == []


def test_overload_walk_lockstep():
    """(i) Tenancy with an overload walk: a weighted submit stream through
    ``submit_external`` (each admitted pod also written to the store)
    drives both controllers HEALTHY -> SHEDDING -> HEALTHY in lockstep:
    the same admissions and rejections, the same state each step, then
    byte-identical stores."""
    cfg = LoadshedConfig(queue_degraded=3 * 16, queue_shed=6 * 16, queue_cap=64 * 16,
                         queue_recover=16, recover_cycles=3)
    weights = {"tenant-0": 4, "tenant-1": 2, "tenant-2": 1}
    p, tn, jt = _tenancy_pair(nodes=8, slots=110, batch=16, seed=7, loadshed_config=cfg,
                              policy=dict(weights=weights))
    seq = [0]
    admitted = rejected = 0
    states = []

    def submit(n):
        nonlocal admitted, rejected
        total_w = sum(weights.values())
        lanes = sorted((k / max(1, round(n * w / total_w)), t) for t, w in weights.items()
                       for k in range(max(1, round(n * w / total_w))))
        for _, t in lanes:
            seq[0] += 1
            pod = PodInfo(f"p{seq[0]:05d}", namespace=t, cpu_milli=10, mem_kib=1 << 10)
            obj = json.loads(encode_pod(pod))
            outs = []
            for coord in (p.t, p.j):
                try:
                    coord.submit_external(obj)
                    outs.append(None)
                except (Overloaded, jls.Overloaded) as e:
                    outs.append(e.reason)
            assert outs[0] == outs[1]
            if outs[0] is not None:
                rejected += 1
                continue
            admitted += 1
            p.put(pod_key(t, pod.name), encode_pod(pod))

    try:
        for n, ticks in ((16, 6), (64, 6), (8, 30)):
            for _ in range(ticks):
                submit(n)
                p.step()
                s = tn.controller.current_state()
                assert s == jt.controller.current_state()
                states.append(s)
        p.run_until_idle()
        assert SHEDDING in states and states[-1] == HEALTHY
        assert rejected > 0 and p.bound == admitted
        assert tn.admission.counters() == jt.admission.counters()
        kvs = p.check()
        assert all(b'"nodeName"' in kv.value for kv in kvs)
        assert [STATE_NAMES[s] for s in sorted(set(states))] == [
            "healthy", "degraded", "shedding"]
    finally:
        p.close()
