"""The port's overload control against the JAX package's, on the CPU.

Twin of tests/test_loadshed.py for ``k8s1m_tpu_torch.loadshed``: the
HealthController state machine and the CircuitBreaker driven through the
same signal and outcome sequences in both packages (same states, same
admissions), the ``stall`` / ``slow_cycle`` fault kinds, ``submit_external``
shedding, and the coordinator integration — degraded knobs, the watch
overflow resync and the breaker-open oracle fallback — run in lockstep
with the JAX coordinator (zero-delay retries): the same bind counts per
step, then byte-identical stored pods, host mirror and device table.
The fallback binds are also replayed against ``oracle_feasible`` /
``oracle_score``.  The webhook test and the ``overload_drill`` smoke of
the JAX file wait for the port's webhook and drill.  Tolerance: exact.
"""

import json

import pytest

import k8s1m_tpu.config as jconfig
import k8s1m_tpu.control.coordinator as jcoord
import k8s1m_tpu.faultline as jfault
import k8s1m_tpu.loadshed as jls
import k8s1m_tpu.plugins.registry as jreg
import k8s1m_tpu.store.native as jnative
from k8s1m_tpu.obs.metrics import REGISTRY as JREGISTRY
from k8s1m_tpu_torch.config import PodSpec, TableSpec
from k8s1m_tpu_torch.control.coordinator import Coordinator, splice_node_name
from k8s1m_tpu_torch.control.objects import encode_node, encode_pod, node_key, pod_key
from k8s1m_tpu_torch.faultline import (
    FaultPlan,
    FaultSpec,
    InjectedFault,
    Injector,
    RetryPolicy,
    install_plan,
)
from k8s1m_tpu_torch.loadshed import (
    CLOSED,
    DEGRADED,
    HALF_OPEN,
    HEALTHY,
    OPEN,
    SHEDDING,
    BreakerConfig,
    CircuitBreaker,
    HealthController,
    LoadshedConfig,
    Overloaded,
    Signals,
)
from k8s1m_tpu_torch.obs.metrics import REGISTRY
from k8s1m_tpu_torch.oracle import oracle_feasible, oracle_score
from k8s1m_tpu_torch.plugins.registry import Profile
from k8s1m_tpu_torch.snapshot.node_table import NodeInfo
from k8s1m_tpu_torch.snapshot.pod_encoding import PodInfo
from k8s1m_tpu_torch.store import native as tnative
from k8s1m_tpu_torch.store.native import MemStore
from test_torch_coordinator import Pair


@pytest.fixture(autouse=True)
def _reset_injectors():
    install_plan(None)
    jfault.install_plan(None)
    yield
    install_plan(None)
    jfault.install_plan(None)


CFG = dict(queue_degraded=10, queue_shed=20, queue_cap=40, queue_recover=4, recover_cycles=2)


def _ctrls(name: str, **cfg):
    """The port's controller and the JAX one, same config."""
    cfg = {**CFG, **cfg}
    return (HealthController(LoadshedConfig(**cfg), name=name),
            jls.HealthController(jls.LoadshedConfig(**cfg), name=name))


def _tick_both(pair, **sig):
    got = pair[0].tick(Signals(**sig))
    assert got == pair[1].tick(jls.Signals(**sig))
    return got


def _admit_both(pair, prio):
    got = pair[0].admit(prio)
    assert got == pair[1].admit(prio)
    return got


# ---- 1. the state machine ---------------------------------------------------


def test_escalation_is_immediate_recovery_is_hysteretic():
    c = _ctrls("sm")
    assert _tick_both(c, queue_depth=3) == HEALTHY
    assert _tick_both(c, queue_depth=12) == DEGRADED
    assert _tick_both(c, queue_depth=25) == SHEDDING
    assert _tick_both(c, queue_depth=1) == SHEDDING
    assert _tick_both(c, queue_depth=1) == DEGRADED
    assert _tick_both(c, queue_depth=1) == DEGRADED
    assert _tick_both(c, queue_depth=1) == HEALTHY
    _tick_both(c, queue_depth=12)
    assert c[0].state == DEGRADED
    _tick_both(c, queue_depth=1)
    _tick_both(c, queue_depth=7)
    _tick_both(c, queue_depth=1)
    assert c[0].state == DEGRADED
    _tick_both(c, queue_depth=1)
    assert c[0].state == HEALTHY


def test_latency_conflicts_and_resyncs_also_degrade():
    cfg = dict(queue_degraded=100, queue_shed=200, queue_cap=400, queue_recover=10,
               recover_cycles=2, cycle_slow_s=0.5, conflicts_degraded=8, latency_window=4)
    c = _ctrls("sig", **cfg)
    assert _tick_both(c, queue_depth=1, cycle_s=0.1) == HEALTHY
    assert _tick_both(c, queue_depth=1, cycle_s=0.9) == DEGRADED
    assert _tick_both(_ctrls("sig2", **cfg), queue_depth=1, conflicts=9) == DEGRADED
    assert _tick_both(_ctrls("sig3", **cfg), queue_depth=1, resyncs=1) == DEGRADED


def test_config_validation():
    for bad in (dict(queue_degraded=10, queue_shed=5), dict(queue_recover=10, queue_degraded=10),
                dict(recover_cycles=0), dict(degraded_score_pct=0)):
        with pytest.raises(ValueError):
            LoadshedConfig(**bad)
        with pytest.raises(ValueError):
            jls.LoadshedConfig(**bad)


def test_shedding_rejects_lowest_priority_first():
    c = _ctrls("floor")
    for p in range(4):
        assert _admit_both(c, p)
    _tick_both(c, queue_depth=25)
    _tick_both(c, queue_depth=25)
    assert not _admit_both(c, 0) and not _admit_both(c, 1)
    assert _admit_both(c, 2) and _admit_both(c, 3)
    for _ in range(4):
        _tick_both(c, queue_depth=1)
    assert c[0].state == HEALTHY
    assert _admit_both(c, 0)


def test_floor_trajectory_matches_jax():
    """A seeded mixed sequence of ticks and admissions: the same state and
    the same admit/reject decisions, step for step."""
    import random

    rng = random.Random(4)
    c = _ctrls("traj", queue_cap=400)
    for _ in range(400):
        if rng.random() < 0.3:
            _tick_both(c, queue_depth=rng.choice((0, 3, 12, 25, 30)))
        else:
            prio = rng.randint(-2, 6)
            assert c[0].try_admit(prio) == c[1].try_admit(prio)


def test_queue_cap_is_hard_even_within_one_tick():
    c = HealthController(LoadshedConfig(**CFG), name="cap")
    c.tick(Signals(queue_depth=38))
    assert c.admit(99) and c.admit(99)
    assert not c.admit(99)
    rej = REGISTRY.get("admission_rejected_total")
    assert rej.value(point="coordinator", reason="cap") >= 1


# ---- 2. the breaker -----------------------------------------------------------


def test_breaker_open_half_open_closed():
    cfg = dict(failure_threshold=2, cooldown_cycles=3)
    b = CircuitBreaker(BreakerConfig(**cfg), component="t.breaker")
    jb = jls.CircuitBreaker(jls.BreakerConfig(**cfg), component="t.breaker")
    script = ["allow", "fail", "succeed", "fail", "fail", "allow", "allow", "allow", "allow",
              "fail", "allow", "allow", "allow", "succeed"]
    states = []
    for op in script:
        for br in (b, jb):
            out = {"allow": br.allow, "fail": br.record_failure,
                   "succeed": br.record_success}[op]()
            states.append((op, out, br.state))
    assert states[0::2] == states[1::2]
    assert b.state == CLOSED
    # The documented walk, on the port's breaker alone.
    b = CircuitBreaker(BreakerConfig(**cfg), component="t.breaker2")
    assert b.allow()
    b.record_failure()
    b.record_success()
    b.record_failure()
    assert b.state == CLOSED
    b.record_failure()
    assert b.state == OPEN
    assert not b.allow() and not b.allow()
    assert b.allow() and b.state == HALF_OPEN
    assert not b.allow()
    b.record_failure()
    assert b.state == OPEN


# ---- 3. the fault kinds -------------------------------------------------------


def test_stall_raises_and_slow_cycle_sleeps():
    inj = Injector(FaultPlan([FaultSpec("coordinator.cycle", "dispatch", kind="stall",
                                        every_n=1, max_fires=1)]))
    with pytest.raises(InjectedFault):
        inj.check("coordinator.cycle", "dispatch")
    slept = []
    inj2 = Injector(FaultPlan([FaultSpec("coordinator.cycle", "dispatch", kind="slow_cycle",
                                         every_n=1, delay_s=0.25)]))
    import k8s1m_tpu_torch.faultline.plan as planmod

    real_sleep = planmod.time.sleep
    planmod.time.sleep = slept.append
    try:
        d = inj2.check("coordinator.cycle", "dispatch")
    finally:
        planmod.time.sleep = real_sleep
    assert d is not None and d.kind == "slow_cycle" and slept == [0.25]


def test_stall_slow_cycle_json_roundtrip():
    plan = FaultPlan(
        [FaultSpec("coordinator.cycle", "*", kind="stall", every_n=3),
         FaultSpec("*", "*", kind="slow_cycle", probability=0.5, delay_s=0.1)], seed=3)
    again = FaultPlan.from_json(plan.to_json())
    assert [f.kind for f in again.faults] == ["stall", "slow_cycle"]
    assert jfault.FaultPlan.from_json(plan.to_json()).to_json() == plan.to_json()


# ---- 4. submit_external ---------------------------------------------------------


SPEC = dict(max_nodes=128, max_zones=16, max_regions=8)
PROFILE = dict(topology_spread=0, interpod_affinity=0)


def _seed_nodes(store, n=64):
    for i in range(n):
        store.put(node_key(f"n{i}"), encode_node(NodeInfo(
            name=f"n{i}", cpu_milli=64000, mem_kib=32 << 20, pods=64)))


def _coord(store, **kw):
    kw.setdefault("chunk", 32)
    kw.setdefault("with_constraints", False)
    return Coordinator(store, TableSpec(**SPEC), PodSpec(batch=32), Profile(**PROFILE), k=4,
                       seed=0, device="cpu", **kw)


def test_submit_external_sheds_and_is_bypassed_by_handshake():
    with MemStore() as store:
        _seed_nodes(store)
        ls = HealthController(LoadshedConfig(**CFG), name="sink")
        coord = _coord(store, loadshed=ls)
        coord.bootstrap()
        try:
            ls.tick(Signals(queue_depth=50))
            obj = json.loads(encode_pod(PodInfo("shed-me")))
            with pytest.raises(Overloaded) as ei:
                coord.submit_external(obj)
            assert ei.value.retry_after_s > 0
            assert ei.value.reason == "cap"
            coord.submit_external(obj, admitted=True)
            assert coord._external == [obj]
            assert "_k8s1m_admitted" not in obj
            # Once the object is in the store, the staged pod binds (the
            # watch echo of the same pod is deduplicated by key).
            store.put(pod_key("default", "shed-me"), encode_pod(PodInfo("shed-me")))
            assert coord.run_until_idle() == 1
        finally:
            coord.close()


# ---- 5. coordinator integration, in lockstep with the JAX coordinator ----------


class LockPair(Pair):
    """Pair with per-package constructor arguments (``tkw`` for the port,
    ``jkw`` for the JAX coordinator), for objects each package owns: the
    loadshed controller, the breaker, the tenancy controller."""

    def __init__(self, *, profile=PROFILE, max_nodes=128, zones=16, regions=8, batch=32,
                 chunk=32, jkw=None, tkw=None, pdims=None, **kw):
        self.jstore, self.tstore = jnative.MemStore(), tnative.MemStore()
        dims = dict(max_nodes=max_nodes, max_zones=zones, max_regions=regions)
        pd = dict(batch=batch, **(pdims or {}))
        pol = dict(component="coordinator.bind", base_delay_s=0.0, jitter=0.0)
        kw.setdefault("with_constraints", False)
        self.j = jcoord.Coordinator(
            self.jstore, jconfig.TableSpec(**dims), jconfig.PodSpec(**pd),
            jreg.Profile(**profile), chunk=chunk, k=4, backend="xla",
            retry_policy=jfault.RetryPolicy(**pol), **kw, **(jkw or {}),
        )
        self.t = Coordinator(
            self.tstore, TableSpec(**dims), PodSpec(**pd), Profile(**profile),
            chunk=chunk, k=4, retry_policy=RetryPolicy(**pol), device="cpu", **kw,
            **(tkw or {}),
        )
        self.bound = 0

    def put(self, key, value):
        for store in (self.jstore, self.tstore):
            store.put(key, value)


@pytest.fixture
def lockpair():
    made = []

    def make(**kw):
        p = LockPair(**kw)
        made.append(p)
        return p

    yield make
    for p in made:
        p.close()


def _nodes(n):
    return [(node_key(f"n{i}"), encode_node(NodeInfo(
        name=f"n{i}", cpu_milli=64000, mem_kib=32 << 20, pods=64))) for i in range(n)]


def test_degraded_knobs_switch_and_recover(lockpair):
    cfg = dict(queue_degraded=16, queue_shed=64, queue_cap=256, queue_recover=8,
               recover_cycles=2, degraded_score_pct=25)
    ls = HealthController(LoadshedConfig(**cfg), name="knobs")
    jl = jls.HealthController(jls.LoadshedConfig(**cfg), name="knobs")
    p = lockpair(score_pct=50, tkw=dict(loadshed=ls), jkw=dict(loadshed=jl))
    p.write(_nodes(128))
    p.bootstrap()
    assert p.t._sample_rows == 64
    assert p.t._sample_rows_degraded == 32 == p.j._sample_rows_degraded
    assert p.t._profile_degraded.topology_spread == 0
    deg = REGISTRY.get("degraded_cycles_total")
    before = deg.value(mode="degraded") + deg.value(mode="shedding")
    p.write([(pod_key("default", f"d{i}"), encode_pod(PodInfo(f"d{i}", cpu_milli=10,
                                                                mem_kib=1 << 10)))
             for i in range(96)])
    p.run_until_idle()
    assert p.bound == 96
    assert deg.value(mode="degraded") + deg.value(mode="shedding") > before
    for _ in range(8):
        p.step()
        assert ls.state == jl.state
    assert ls.state == HEALTHY
    p.check()


def test_watch_overflow_resyncs_and_loses_nothing(lockpair):
    plan = FaultPlan([FaultSpec("coordinator.watch", "poll", kind="disconnect", after=3,
                                every_n=1, max_fires=1)], seed=5)
    resyncs = REGISTRY.get("coordinator_resyncs_total")
    r0 = resyncs.value()
    p = lockpair(watch_queue_cap=64, max_attempts=8)
    p.write(_nodes(64))
    p.bootstrap()
    install_plan(plan)
    jfault.install_plan(jfault.FaultPlan.from_json(plan.to_json()))
    p.write([(pod_key("default", f"o{i}"), encode_pod(PodInfo(f"o{i}", cpu_milli=10,
                                                                mem_kib=1 << 10)))
             for i in range(300)])
    p.run_until_idle()
    assert p.bound == 300
    assert resyncs.value() - r0 >= 2
    kvs = p.check()
    assert all(b'"nodeName"' in kv.value for kv in kvs) and len(kvs) == 300
    assert p.t.unschedulable == {}


@pytest.mark.parametrize("pipeline", [False, True])
def test_breaker_fallback_lockstep_and_oracle_replay(lockpair, pipeline):
    """(iii) A stall plan opens both breakers; the open-state waves bind
    through the host oracle.  Same binds per step as the JAX coordinator,
    byte-identical stores, the fallback binds equal to an oracle replay,
    the breaker walks CLOSED -> OPEN -> HALF_OPEN -> CLOSED, and after the
    probe the device request columns equal the host mirror."""
    plan = FaultPlan([FaultSpec("coordinator.cycle", "dispatch", kind="stall", every_n=1,
                                max_fires=2)], seed=9)
    bcfg = dict(failure_threshold=2, cooldown_cycles=4, fallback_batch=32)
    br = CircuitBreaker(BreakerConfig(**bcfg), component="t.fallback")
    jbr = jls.CircuitBreaker(jls.BreakerConfig(**bcfg), component="t.fallback")
    p = lockpair(profile=PROFILE, pipeline=pipeline, depth=2, tkw=dict(breaker=br),
                 jkw=dict(breaker=jbr))
    p.write(_nodes(64))
    p.bootstrap()
    install_plan(plan)
    jfault.install_plan(jfault.FaultPlan.from_json(plan.to_json()))
    raws = {}
    for i in range(24):
        pod = PodInfo(f"f{i}", cpu_milli=10, mem_kib=1 << 10)
        raws[pod.key] = encode_pod(pod)
        p.put(pod_key("default", pod.name), raws[pod.key])
    trans = REGISTRY.get("breaker_transitions_total")

    def walked(a, b):
        return trans.value(component="t.fallback", **{"from": a, "to": b})

    walk0 = [walked("closed", "open"), walked("open", "half_open"),
             walked("half_open", "closed")]
    p.step()
    p.step()
    assert br.state == jbr.state == OPEN
    fb = REGISTRY.get("breaker_fallback_binds_total")
    jfb = JREGISTRY.get("breaker_fallback_binds_total")
    before, jbefore = fb.value(), jfb.value()
    assert p.step() == 24
    assert fb.value() - before == 24 == jfb.value() - jbefore
    # Replay the oracle contract (argmax oracle_score, earlier row wins,
    # sequential usage) and compare with the canonical splice.
    nodes = sorted((row, name) for name, row in p.t.host._row_of.items())
    usage = {row: (0, 0, 0) for row, _ in nodes}
    for i in range(24):
        pod = PodInfo(f"f{i}", cpu_milli=10, mem_kib=1 << 10)
        best_row, best_score, best = -1, -1, None
        for row, name in nodes:
            nd = NodeInfo(name=name, cpu_milli=64000, mem_kib=32 << 20, pods=64)
            if not oracle_feasible(nd, pod, usage[row]):
                continue
            s = oracle_score(nd, pod, usage[row], taint_slots=TableSpec(**SPEC).taint_slots,
                             weights=(1, 1, 3, 2))
            if s > best_score:
                best_row, best_score, best = row, s, name
        u = usage[best_row]
        usage[best_row] = (u[0] + 10, u[1] + (1 << 10), u[2] + 1)
        want = splice_node_name(raws[pod.key], best)
        assert p.tstore.get(pod_key("default", pod.name)).value == want
    # Cool down into the half-open probe with fresh pods: the probe is a
    # device wave and closes the breaker.
    for w in range(6):
        p.write([(pod_key("default", f"h{w}-{i}"), encode_pod(PodInfo(
            f"h{w}-{i}", cpu_milli=10, mem_kib=1 << 10))) for i in range(8)])
        p.step()
        assert br.state == jbr.state
    p.run_until_idle()
    assert br.state == CLOSED
    walk = [walked("closed", "open"), walked("open", "half_open"),
            walked("half_open", "closed")]
    assert [b - a for a, b in zip(walk0, walk)] == [1, 1, 1]
    p.check()
    host, table = p.t.host, p.t.table
    for c in ("cpu_req", "mem_req", "pods_req"):
        assert (getattr(table, c).numpy() == getattr(host, c)).all()
    assert (host.pods_req <= host.pods_alloc).all()


def test_fallback_nodes_incremental_matches_full_decode():
    def snap(pairs):
        return [(row, nd.name, nd.cpu_milli, nd.mem_kib, nd.pods,
                 sorted(nd.labels.items()) if nd.labels else [])
                for row, nd in pairs]

    with MemStore() as store:
        _seed_nodes(store, 32)
        coord = _coord(store)
        coord.bootstrap()
        try:
            def check():
                got = snap(coord._fallback_nodes())
                want = snap(coord._fallback_nodes_full())
                assert got == want and len(got) > 0
            check()
            store.put(node_key("n3"), encode_node(NodeInfo(
                name="n3", cpu_milli=1234, mem_kib=1 << 21, pods=8)))
            store.put(node_key("zz-new"), encode_node(NodeInfo(
                name="zz-new", cpu_milli=999, mem_kib=1 << 20, pods=4,
                labels={"zone": "z-1"})))
            store.put_batch([(node_key("n7"), None)])
            coord.step()
            check()
            assert len(coord._node_infos) == 32
            store.put(node_key("n5"), encode_node(NodeInfo(
                name="n5", cpu_milli=777, mem_kib=1 << 20, pods=6)))
            coord.resync()
            check()
            got = {nd.name: nd.cpu_milli for _r, nd in coord._fallback_nodes()}
            assert got["n5"] == 777 and got["n3"] == 1234
            assert "n7" not in got and "zz-new" in got
        finally:
            coord.close()
