"""The port's faultline against the JAX package's, on the CPU.

Twin of tests/test_faultline.py for ``k8s1m_tpu_torch.faultline``: the
injector's decision core (the same plan fires the same sequence in both
packages, seed for seed), ``RetryPolicy`` (the same delays, budget and
give-up), and the coordinator smoke drill (disconnects on the watch
drain, forced bind conflicts and delays on a virtual clock) run through
both coordinators with the same seed, which must leave the same stored
pods, fired log and retry totals.  Plus the lockstep CAS-conflict
scenario: both coordinators step together under the same seeded
conflict plan with zero-delay retries.  Tolerance: exact equality.
"""

import _torch_cpu  # noqa: F401  (bounds torch's CPU threads first)

import json

import pytest

import k8s1m_tpu.control.coordinator as jcoordmod
import k8s1m_tpu.faultline as jfault
import k8s1m_tpu.faultline.plan as jplan
from k8s1m_tpu.faultline.policy import policy_for as jpolicy_for
from k8s1m_tpu_torch import faultline
from k8s1m_tpu_torch.config import PodSpec, TableSpec
from k8s1m_tpu_torch.control import coordinator as coordmod
from k8s1m_tpu_torch.control.coordinator import Coordinator
from k8s1m_tpu_torch.control.objects import encode_node, encode_pod, node_key, pod_key
from k8s1m_tpu_torch.faultline import (
    DEFAULT_POLICIES,
    FaultPlan,
    FaultSpec,
    GiveUp,
    InjectedFault,
    Injector,
    RetryPolicy,
    install_plan,
)
from k8s1m_tpu_torch.faultline.policy import default_retryable, policy_for, recovery_stats
from k8s1m_tpu_torch.plugins.registry import Profile
from k8s1m_tpu_torch.snapshot.node_table import NodeInfo
from k8s1m_tpu_torch.snapshot.pod_encoding import PodInfo
from k8s1m_tpu_torch.store.native import CompactedError, MemStore
from test_torch_coordinator import Pair, fleet, pods


@pytest.fixture(autouse=True)
def _reset_injectors():
    """Both packages hold a process-global injector: never leak a plan
    into or out of a test."""
    install_plan(None)
    jfault.install_plan(None)
    yield
    install_plan(None)
    jfault.install_plan(None)


def _twin(plan: FaultPlan):
    """The same plan as a JAX-package FaultPlan (through its JSON)."""
    return jfault.FaultPlan.from_json(plan.to_json())


# ---- 1. deterministic decision core ---------------------------------------


def _drive(injector, ops=400):
    out = []
    for i in range(ops):
        op = ("put", "range", "txn")[i % 3]
        d = injector.decide("store.wire", op)
        if d is not None:
            out.append((op, d.kind, i))
    return out


def test_same_seed_same_fault_sequence():
    plan = FaultPlan(
        [
            FaultSpec("store.wire", "put", kind="disconnect", probability=0.15),
            FaultSpec("store.wire", "*", kind="delay", probability=0.05, delay_s=0.001),
        ],
        seed=1234,
    )
    runs = [_drive(Injector(plan)) for _ in range(3)]
    assert runs[0] == runs[1] == runs[2]
    assert len(runs[0]) > 5
    # The JAX injector draws the same per-spec streams.
    assert _drive(jfault.Injector(_twin(plan))) == runs[0]
    other = FaultPlan.from_json(plan.to_json())
    other.seed = 99
    assert _drive(Injector(other)) != runs[0]


@pytest.mark.parametrize("seed", [0, 7, 33, 1 << 20])
def test_fired_log_matches_jax(seed):
    plan = FaultPlan(
        [FaultSpec("store.wire", "*", kind="err5xx", probability=0.2),
         FaultSpec("coordinator.bind", "cas", kind="stale_revision", probability=1 / 53),
         FaultSpec("store.wire", "put", kind="delay", after=5, every_n=7, max_fires=9)],
        seed=seed,
    )
    i1, i2, ij = Injector(plan), Injector(plan), jfault.Injector(_twin(plan))
    for inj in (i1, i2, ij):
        _drive(inj)
        for _ in range(500):
            inj.decide("coordinator.bind", "cas")
    assert i1.fired_log == i2.fired_log == ij.fired_log
    assert i1.fire_counts() == ij.fire_counts()
    assert i1.fire_report() == ij.fire_report()


def test_schedule_after_every_n_max_fires():
    spec = FaultSpec("c", "op", kind="disconnect", after=3, every_n=2, max_fires=2)
    inj = Injector(FaultPlan([spec]))
    fired = [inj.decide("c", "op") is not None for _ in range(12)]
    assert fired == [False] * 4 + [True, False, True] + [False] * 5


def test_spec_streams_are_independent():
    a = FaultSpec("store.wire", "put", kind="disconnect", probability=0.2)
    b = FaultSpec("watch.tier", "*", kind="drop", probability=0.5)
    solo = Injector(FaultPlan([a], seed=5))
    both = Injector(FaultPlan([a, b], seed=5))
    seq_solo = [solo.decide("store.wire", "put") is not None for _ in range(300)]
    seq_both = []
    for i in range(300):
        if i % 2:
            both.decide("watch.tier", "upstream.recv")
        seq_both.append(both.decide("store.wire", "put") is not None)
    assert seq_solo == seq_both


def test_wildcards_and_json_roundtrip(tmp_path):
    plan = FaultPlan([FaultSpec("*", "*", kind="delay", every_n=1, delay_s=0.5)], seed=3)
    again = FaultPlan.from_json(plan.to_json())
    assert again.seed == 3
    assert again.faults == plan.faults
    assert plan.to_json() == _twin(plan).to_json()
    p = tmp_path / "plan.json"
    p.write_text(plan.to_json())
    assert FaultPlan.from_arg(f"@{p}").faults == plan.faults
    assert Injector(again).decide("anything", "at-all") is not None


def test_named_plan_watchstorm():
    plan = FaultPlan.from_arg("watchstorm")
    assert plan.to_json() == jfault.FaultPlan.from_arg("watchstorm").to_json()
    by_op = {}
    for s in plan.faults:
        assert s.component == "watch.tier"
        by_op.setdefault(s.op, []).append(s)
    assert set(by_op) == {"upstream.recv", "pump.stall", "subscriber.send"}
    assert any(s.kind == "disconnect" for s in by_op["upstream.recv"])
    with pytest.raises(ValueError):
        FaultPlan.from_arg("no-such-storm")


def test_spec_validation_rejects_garbage():
    with pytest.raises(ValueError):
        FaultSpec("c", kind="meteor-strike", probability=0.1)
    with pytest.raises(ValueError):
        FaultSpec("c", kind="drop", probability=1.5)
    with pytest.raises(ValueError):
        FaultSpec("c", kind="drop")
    with pytest.raises(ValueError):
        FaultSpec.from_obj({"component": "c", "probability": 0.1, "tyop": True})


def test_check_raises_on_failure_kinds_and_counts():
    inj = Injector(FaultPlan([FaultSpec("c", "op", kind="disconnect", every_n=1)]))
    with pytest.raises(InjectedFault):
        inj.check("c", "op")
    assert inj.fire_counts() == {"disconnect": 1}


@pytest.mark.parametrize("kind", ["drop", "partial_write", "stale_revision"])
def test_site_specific_kinds_are_returned_not_raised(kind):
    """``check`` hands the site-specific kinds back to the hook site
    (discard / truncate / fail the CAS) in both packages.  The wire
    store's unary hook that raises them where an op cannot express them
    comes with the port's wire store."""
    plan = FaultPlan([FaultSpec("store.wire", "put", kind=kind, every_n=1)])
    d = Injector(plan).check("store.wire", "put")
    dj = jfault.Injector(_twin(plan)).check("store.wire", "put")
    assert d is not None and d.kind == kind == dj.kind


def test_env_plan_inheritance(monkeypatch):
    """Both packages read K8S1M_FAULT_PLAN on first use, each into its own
    injector: the same plan fires the same first decisions in both."""
    import k8s1m_tpu_torch.faultline.plan as planmod

    plan = FaultPlan([FaultSpec("c", "op", kind="drop", probability=0.5)], seed=9)
    monkeypatch.setenv("K8S1M_FAULT_PLAN", plan.to_json())
    for mod in (planmod, jplan):
        monkeypatch.setattr(mod, "_env_loaded", False)
        monkeypatch.setattr(mod, "_active", mod._NOOP)
    got = [faultline.decide("c", "op") is not None for _ in range(64)]
    want = [jfault.decide("c", "op") is not None for _ in range(64)]
    assert got == want and any(got)


# ---- 2. RetryPolicy --------------------------------------------------------


def test_backoff_grows_and_caps():
    pol = RetryPolicy("t", base_delay_s=0.1, max_delay_s=0.4, multiplier=2.0, jitter=0.0)
    delays = [pol.delay_for(a) for a in (1, 2, 3, 4, 5)]
    assert delays == [0.1, 0.2, 0.4, 0.4, 0.4]


def test_default_policies_match_jax():
    import random

    from k8s1m_tpu.faultline.policy import DEFAULT_POLICIES as JDEFAULTS

    assert set(DEFAULT_POLICIES) == set(JDEFAULTS)
    for name in (*DEFAULT_POLICIES, "no-such-component"):
        pol, jpol = policy_for(name), jpolicy_for(name)
        assert pol.component == jpol.component
        r1, r2 = random.Random(5), random.Random(5)
        for attempt in (1, 2, 3, 7, 100):
            assert pol.delay_for(attempt, r1) == jpol.delay_for(attempt, r2)
        assert list(pol._sleeps(random.Random(1))) == list(jpol._sleeps(random.Random(1)))


def test_deadline_budget_bounds_total_sleep():
    pol = RetryPolicy("t", max_attempts=100, base_delay_s=1.0, max_delay_s=1.0, jitter=0.0,
                      deadline_s=2.5)
    slept = []
    with pytest.raises(GiveUp) as ei:
        pol.call(lambda: (_ for _ in ()).throw(ConnectionError("x")), sleep=slept.append)
    assert sum(slept) <= 2.5 + 1e-9
    assert isinstance(ei.value.cause, ConnectionError)


def test_call_retries_then_succeeds_and_records_recovery():
    pol = RetryPolicy("t", max_attempts=5, base_delay_s=0.0, jitter=0.0)
    n = [0]

    def flaky():
        n[0] += 1
        if n[0] < 3:
            raise TimeoutError("blip")
        return "ok"

    assert pol.call(flaky, sleep=lambda s: None) == "ok"
    assert n[0] == 3
    assert recovery_stats()["t"]["count"] >= 1


def test_acall_retries_then_succeeds():
    import asyncio

    pol = RetryPolicy("t-async", max_attempts=5, base_delay_s=0.0, jitter=0.0)
    n = [0]

    async def flaky():
        n[0] += 1
        if n[0] < 2:
            raise ConnectionError("blip")
        return 7

    assert asyncio.run(pol.acall(flaky)) == 7 and n[0] == 2


def test_non_retryable_propagates_immediately():
    pol = RetryPolicy("t", max_attempts=5)
    n = [0]

    def bad():
        n[0] += 1
        raise CompactedError("semantic, not transient")

    with pytest.raises(CompactedError):
        pol.call(bad, sleep=lambda s: None)
    assert n[0] == 1


def test_default_retryable_classification():
    d = faultline.FaultDecision("c", "op", "disconnect", 0.0, 0, 1)
    assert default_retryable(InjectedFault(d))
    assert default_retryable(ConnectionError())
    assert default_retryable(TimeoutError())
    assert not default_retryable(CompactedError("compacted"))
    assert not default_retryable(ValueError("bad request"))


def test_delay_for_never_overflows_at_retry_forever_counts():
    pol = policy_for("watch.tier")
    for attempt in (1, 100, 1025, 10_000_000):
        assert 0.0 <= pol.delay_for(attempt) <= pol.max_delay_s


def test_max_attempts_one_never_retries():
    pol = RetryPolicy("t", max_attempts=1)
    with pytest.raises(GiveUp) as ei:
        pol.call(lambda: (_ for _ in ()).throw(ConnectionError("x")), sleep=lambda s: None)
    assert ei.value.attempts == 1


# ---- 3. the smoke drill, through both coordinators -------------------------


PROFILE = dict(topology_spread=0, interpod_affinity=0)
SPEC = dict(max_nodes=128, max_zones=16, max_regions=8)
N_PODS = 60


def _seed_cluster(store, encode_node, encode_pod, node_key, pod_key, NodeInfo, PodInfo):
    for i in range(8):
        store.put(node_key(f"n{i}"), encode_node(NodeInfo(
            name=f"n{i}", cpu_milli=4000, mem_kib=8 << 20, pods=16,
            labels={"topology.kubernetes.io/zone": f"z{i % 4}"},
        )))
    for i in range(N_PODS):
        store.put(pod_key("default", f"p{i}"), encode_pod(PodInfo(
            name=f"p{i}", namespace="default", cpu_milli=100, mem_kib=200 << 10)))


class _FakeClock:
    """Virtual time: sleeps advance the clock, so backoff schedules replay
    identically run to run."""

    def __init__(self):
        self.t = 1000.0

    def perf_counter(self):
        return self.t

    def monotonic(self):
        return self.t

    def time(self):
        return self.t

    def sleep(self, s):
        self.t += s


def _drill_plan(seed):
    return FaultPlan(
        [
            FaultSpec("coordinator.watch", "poll", kind="disconnect", after=2, every_n=5,
                      max_fires=3),
            FaultSpec("coordinator.watch", "poll", kind="delay", probability=0.2,
                      delay_s=0.0005),
            FaultSpec("coordinator.bind", "cas", kind="stale_revision", probability=0.25),
            FaultSpec("coordinator.bind", "cas", kind="delay", probability=0.1,
                      delay_s=0.0005),
        ],
        seed=seed,
    )


def _run_drill(seed: int, *, jax: bool):
    """store -> watch -> schedule -> bind under the drill plan on a virtual
    clock, through the JAX coordinator or the port's; returns (binds,
    bound nodeName map, unschedulable, injector, retries)."""
    if jax:
        import k8s1m_tpu.config as jc
        import k8s1m_tpu.control.objects as jo
        import k8s1m_tpu.plugins.registry as jr
        import k8s1m_tpu.snapshot.node_table as jn
        import k8s1m_tpu.snapshot.pod_encoding as jp
        import k8s1m_tpu.store.native as js

        fl, mod, store_cls = jfault, jcoordmod, js.MemStore
        objs = (jo.encode_node, jo.encode_pod, jo.node_key, jo.pod_key, jn.NodeInfo,
                jp.PodInfo)
        make = lambda store: mod.Coordinator(  # noqa: E731
            store, jc.TableSpec(**SPEC), jc.PodSpec(batch=32), jr.Profile(**PROFILE),
            chunk=64, k=4, with_constraints=False, max_attempts=50, seed=seed)
    else:
        fl, mod, store_cls = faultline, coordmod, MemStore
        objs = (encode_node, encode_pod, node_key, pod_key, NodeInfo, PodInfo)
        make = lambda store: Coordinator(  # noqa: E731
            store, TableSpec(**SPEC), PodSpec(batch=32), Profile(**PROFILE),
            chunk=64, k=4, with_constraints=False, max_attempts=50, seed=seed, device="cpu")
    inj = fl.install_plan(fl.FaultPlan.from_json(_drill_plan(seed).to_json()))
    retries_before = fl.retry_counts().get("coordinator.bind", 0)
    real_time = mod.time
    mod.time = _FakeClock()
    try:
        with store_cls() as store:
            _seed_cluster(store, *objs)
            coord = make(store)
            coord.bootstrap()
            total = coord.run_until_idle(max_cycles=100000)
            bound = {}
            for i in range(N_PODS):
                kv = store.get(objs[3]("default", f"p{i}"))
                bound[f"p{i}"] = json.loads(kv.value)["spec"].get("nodeName")
            unsched = dict(coord.unschedulable)
            coord.close()
    finally:
        mod.time = real_time
        fl.install_plan(None)
    retries = fl.retry_counts().get("coordinator.bind", 0) - retries_before
    return total, bound, unsched, inj, retries


def test_smoke_zero_event_loss_and_bounded_retries():
    total, bound, unsched, inj, retries = _run_drill(21, jax=False)
    fired = inj.fire_counts()
    assert fired.get("disconnect", 0) >= 1
    assert fired.get("stale_revision", 0) >= 5
    assert unsched == {}
    assert sum(1 for v in bound.values() if v) == N_PODS
    assert total == N_PODS
    assert fired["stale_revision"] <= retries
    assert retries <= fired["stale_revision"] + 2 * N_PODS


@pytest.mark.parametrize("seed", [21, 33])
def test_smoke_equals_jax_drill(seed):
    """The same seed through both coordinators: the same fired sequence,
    the same stored binds and the same retry totals."""
    got = _run_drill(seed, jax=False)
    want = _run_drill(seed, jax=True)
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[2].keys() == want[2].keys()
    assert got[3].fired_log == want[3].fired_log
    assert got[4] == want[4]


def test_smoke_is_deterministic_by_seed():
    r1 = _run_drill(33, jax=False)
    r2 = _run_drill(33, jax=False)
    assert r1[3].fired_log == r2[3].fired_log
    assert r1[3].fire_counts() == r2[3].fire_counts()
    assert r1[1] == r2[1]
    assert r1[4] == r2[4]


# ---- 4. lockstep under a seeded CAS-conflict plan --------------------------


@pytest.mark.parametrize("pipeline", [False, True])
def test_cas_conflict_plan_lockstep(pipeline):
    """(ii) Both coordinators step together under the same seeded
    conflict plan (installed in each package's injector), zero-delay
    retries: the same bind counts each step, then the same store bytes,
    host mirror and device table, and the same fired sequence."""
    plan = FaultPlan([FaultSpec("coordinator.bind", "cas", kind="err5xx", probability=1 / 7)],
                     seed=11)
    p = Pair(batch=128, chunk=512, pipeline=pipeline, depth=2)
    try:
        p.write(fleet(512))
        p.bootstrap()
        inj, jinj = install_plan(plan), jfault.install_plan(_twin(plan))
        for w in range(6):
            p.write(pods(f"c{w}", 96))
            p.step()
        p.run_until_idle()
        assert inj.fired_log == jinj.fired_log and inj.fire_counts()["err5xx"] > 10
        kvs = p.check()
        assert all(b'"nodeName"' in kv.value for kv in kvs)
    finally:
        install_plan(None)
        jfault.install_plan(None)
        p.close()


def test_conflict_rollback_overcommit_is_shared_with_jax():
    """A defect both coordinators share (ROADMAP §C): pipelined at depth
    3, a rolled-back bind re-uploads its whole row while later waves are
    in flight, erasing their assumes until they retire, so a conflict plan
    over-commits pod slots.  At 16 nodes x 110 slots and 14 waves of 128
    pods, the port over-commits exactly the rows the JAX coordinator does,
    by the same counts; without the plan both bind exactly the 1,760
    slots.  The port keeps the defect for byte identity."""
    def drive(plan):
        p = Pair(batch=128, chunk=512, pipeline=True, depth=3)
        try:
            p.write(fleet(16))
            p.bootstrap()
            if plan is not None:
                install_plan(plan)
                jfault.install_plan(_twin(plan))
            for w in range(14):
                p.write(pods(f"c{w}", 128))
                p.step()
            p.run_until_idle()
            p.check()
            over = [h.pods_req.astype(int) - h.pods_alloc.astype(int) for h in (p.t.host, p.j.host)]
            return p.bound, over
        finally:
            install_plan(None)
            jfault.install_plan(None)
            p.close()

    bound, (over, jover) = drive(None)
    assert bound == 16 * 110 and over.max() == jover.max() == 0
    plan = FaultPlan([FaultSpec("coordinator.bind", "cas", kind="err5xx", probability=1 / 7)],
                     seed=11)
    bound, (over, jover) = drive(plan)
    assert (over == jover).all()
    assert bound > 16 * 110 and (over > 0).any()
