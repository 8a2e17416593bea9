"""Deterministic fault plans and the process-wide injector.

The port's own copy of ``k8s1m_tpu/faultline/plan.py``: the same specs
draw the same per-spec seeded streams, so a plan fires the same sequence
in both packages.  A process that imports both holds two injectors;
each reads ``K8S1M_FAULT_PLAN`` on first use.  Of the hook sites below
the port has the coordinator's (``coordinator.bind``/``watch``/
``cycle``); the wire store, watch tier, lease and shardset are not part
of the port yet.

A ``FaultPlan`` is a seed plus a list of ``FaultSpec``s.  Each spec
targets a (component, operation) pair — ``"*"`` wildcards either — and
fires by probability (from the spec's OWN seeded stream, so two specs
never perturb each other's draws) and/or by schedule (``after`` /
``every_n`` / ``max_fires`` over that spec's matching-op counter).  The
whole decision path is pure counting + seeded PRNG: the same plan run
against the same operation sequence fires the same faults, every time —
that is what turns "we survived one kill drill" into "we survive a
specified fault distribution, reproducibly, by seed".

Components instrumented by this framework (see each call site):

====================  =====================================================
component             operations
====================  =====================================================
``store.wire``        ``range`` ``put`` ``delete`` ``txn`` ``put_batch``
                      ``bind_batch`` ``compact`` ``status`` ``watch.recv``
``watch.tier``        ``upstream.recv`` (the cache tier's store-event
                      pump: any failure kind breaks the stream — the
                      tier resumes clients from the relist diff, or
                      invalidates when the diff overflows the window);
                      ``pump.stall`` (a fan-out pump lane stalls for
                      ``delay_s`` — every kind expresses as a bounded
                      stall, the pump never dies); ``subscriber.send``
                      (one subscriber's socket: delay kinds wedge it,
                      failure kinds break it — the tier cancels that
                      watch and the client relists)
``coordinator.bind``  ``cas`` (the bind CAS, native wave and slow path)
``coordinator.watch`` ``poll`` (the intake watch drain)
``coordinator.cycle`` ``dispatch`` (the device-wave launch; ``stall``
                      opens the circuit breaker, ``slow_cycle`` shapes
                      overload latency)
``coordinator.lease`` ``tick/<identity>`` (the HA replica's election+
                      schedule tick, control/leader.HACoordinator:
                      ``kill_process`` SIGKILLs the replica — no lease
                      release, no flush, takeover on expiry;
                      ``pause`` SIGSTOPs it between the leadership
                      check and its writes — the split-brain window
                      lease-epoch fencing exists for)
``shardset.lease``    ``heartbeat/<shard>`` ``rebalance``
====================  =====================================================

Fault kinds and their contract at the hook sites:

- ``drop``           the operation's effect is discarded (a watch batch's
                     events are thrown away and the watcher is flagged
                     dropped; a heartbeat is skipped).  Never silent:
                     every hook that drops also trips the signal its
                     consumer resyncs on.
- ``delay``          sleep ``delay_s`` before the operation.
- ``disconnect``     the stream/RPC fails as a broken connection
                     (retryable ``InjectedFault``).
- ``err5xx``         the RPC fails as a server error (retryable).
- ``partial_write``  a batched write applies a prefix of the batch and
                     then fails (retryable; the batch paths are
                     idempotent-or-CAS-guarded, so the retry is safe).
- ``stale_revision`` the operation observes a stale/compacted revision
                     (a read raises the compacted signal; a bind CAS is
                     forced into conflict) — the consumer's relist /
                     requeue path must absorb it.
- ``stall``          the operation hangs past any useful deadline
                     (raised as a retryable ``InjectedFault``, like a
                     timed-out RPC).  At the cycle-dispatch hook this
                     is what trips the circuit breaker
                     (k8s1m_tpu/loadshed/breaker.py).
- ``slow_cycle``     overload-shaped latency: the operation completes
                     but takes ``delay_s`` longer — feeds the health
                     controller's cycle-p99 signal without failing
                     anything (k8s1m_tpu/loadshed/controller.py).
- ``pause``          SIGSTOP-style freeze for ``delay_s``: the process
                     keeps all its in-memory beliefs (leadership!)
                     while the world moves on.  Only the
                     ``coordinator.lease`` hook applies it; drills may
                     install ``HACoordinator.on_pause`` to advance the
                     other replicas deterministically during the freeze.
- ``kill_process``   SIGKILL-style death of the HA replica at the
                     ``coordinator.lease`` hook: no lease release, no
                     watch teardown beyond what a dead process's
                     connections get, in-flight waves die unretired —
                     the standby takes over on lease expiry.

The injector is process-global (``install_plan`` / ``active_injector``)
so subsystems need no plumbing, and seeded per spec so determinism
survives multi-component interleaving; subprocesses inherit the plan via
the ``K8S1M_FAULT_PLAN`` env var (JSON), read once at first use.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import random
import threading
import time

from k8s1m_tpu_torch.obs.metrics import Counter

log = logging.getLogger("k8s1m.faultline")

FAULT_KINDS = (
    "drop", "delay", "disconnect", "err5xx", "partial_write",
    "stale_revision", "stall", "slow_cycle", "pause", "kill_process",
)

_INJECTED = Counter(
    "faultline_injected_total",
    "Faults injected, by component and kind",
    ("component", "kind"),
)


class InjectedFault(Exception):
    """Raised at a hook site when a failure-kind fault fires.

    Retry layers treat it exactly like the transient wire error it
    simulates (see RetryPolicy.retryable)."""

    def __init__(self, decision: "FaultDecision"):
        super().__init__(
            f"injected {decision.kind} at "
            f"{decision.component}/{decision.op}"
        )
        self.decision = decision


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One fault source: where it hooks, what it does, when it fires."""

    component: str                 # e.g. "store.wire"; "*" = any
    op: str = "*"                  # e.g. "put"; "*" = any
    kind: str = "disconnect"
    probability: float = 0.0       # per matching op, from this spec's stream
    after: int = 0                 # skip the first `after` matching ops
    every_n: int = 0               # then fire every Nth matching op
    max_fires: int = 0             # 0 = unlimited
    delay_s: float = 0.0           # for kind="delay"

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r} (want one of {FAULT_KINDS})"
            )
        if not 0.0 <= self.probability <= 1.0:
            raise ValueError(f"probability {self.probability} not in [0, 1]")
        if self.probability == 0.0 and self.every_n <= 0:
            raise ValueError(
                "spec never fires: set probability > 0 or every_n > 0"
            )

    def matches(self, component: str, op: str) -> bool:
        return (self.component in ("*", component)) and (
            self.op in ("*", op)
        )

    def to_obj(self) -> dict:
        out = {"component": self.component, "op": self.op, "kind": self.kind}
        for f in ("probability", "after", "every_n", "max_fires", "delay_s"):
            v = getattr(self, f)
            if v:
                out[f] = v
        return out

    @classmethod
    def from_obj(cls, obj: dict) -> "FaultSpec":
        known = {f.name for f in dataclasses.fields(cls)}
        extra = set(obj) - known
        if extra:
            raise ValueError(f"unknown FaultSpec fields: {sorted(extra)}")
        return cls(**obj)


@dataclasses.dataclass(frozen=True)
class FaultDecision:
    """What fired: handed to the hook site to apply."""

    component: str
    op: str
    kind: str
    delay_s: float
    spec_index: int
    seq: int                       # this spec's fire count (1-based)


class FaultPlan:
    """A seed plus fault specs; JSON-serializable (the ``--fault-plan``
    payload): ``{"seed": 7, "faults": [{...}, ...]}``."""

    def __init__(self, faults: list[FaultSpec] | None = None, seed: int = 0):
        self.seed = int(seed)
        self.faults = list(faults or [])

    def to_json(self) -> str:
        return json.dumps(
            {"seed": self.seed, "faults": [f.to_obj() for f in self.faults]}
        )

    @classmethod
    def from_json(cls, data: "str | bytes | dict") -> "FaultPlan":
        obj = data if isinstance(data, dict) else json.loads(data)
        return cls(
            [FaultSpec.from_obj(f) for f in obj.get("faults", [])],
            seed=obj.get("seed", 0),
        )

    @classmethod
    def from_arg(cls, arg: str) -> "FaultPlan":
        """CLI form: a named plan (``NAMED_PLANS``), inline JSON, or
        ``@path`` to a JSON file."""
        named = NAMED_PLANS.get(arg)
        if named is not None:
            return named()
        if arg.startswith("@"):
            with open(arg[1:]) as f:
                return cls.from_json(f.read())
        return cls.from_json(arg)


def _watchstorm() -> FaultPlan:
    """The watchplane kill-drill plan (``watch_fanout_ab --fault-plan
    watchstorm``): upstream stream breaks (each must resolve by
    diff-replay resume, not a relist storm), fan-out pump-lane stalls,
    subscriber-socket wedges, and a few outright subscriber breaks —
    composed, deterministic by seed.  Counter units: ``upstream.recv``
    fires per received upstream batch (a coarse counter — writes
    arrive in kilo-event batches, so the break spec draws by
    probability to fire across drill scales), ``pump.stall`` per
    pump-lane wake round, ``subscriber.send`` per delivered frame."""
    return FaultPlan(
        [
            FaultSpec("watch.tier", "upstream.recv", kind="disconnect",
                      after=4, probability=0.25, max_fires=12),
            FaultSpec("watch.tier", "pump.stall", kind="delay",
                      delay_s=0.25, after=20, every_n=97, max_fires=40),
            FaultSpec("watch.tier", "subscriber.send", kind="delay",
                      delay_s=0.01, after=500, every_n=4001, max_fires=200),
            FaultSpec("watch.tier", "subscriber.send", kind="disconnect",
                      after=1000, every_n=25013, max_fires=4),
        ],
        seed=1315,
    )


# Named plans accepted anywhere a --fault-plan flag is parsed
# (FaultPlan.from_arg): drills reference a storm by name instead of
# every driver copy-pasting the same JSON.
NAMED_PLANS = {
    "watchstorm": _watchstorm,
}


class Injector:
    """Evaluates a FaultPlan; one per process (see install_plan).

    Pure-decision core: ``decide`` matches specs in plan order, counts,
    draws, and returns the first firing spec's ``FaultDecision`` (or
    None).  The only side effects are the counters, the metrics, and a
    bounded fired-log kept for determinism assertions.  Applying the
    decision — sleeping, raising, flagging a watcher dropped — is the
    hook site's job (``check`` is the synchronous convenience wrapper;
    async sites apply the decision themselves so delays don't block the
    event loop).
    """

    _LOG_CAP = 4096

    def __init__(self, plan: FaultPlan | None = None):
        self.plan = plan or FaultPlan()
        self._lock = threading.Lock()
        self._seen = [0] * len(self.plan.faults)
        self._fired = [0] * len(self.plan.faults)
        # Per-spec PRNG streams: spec i's draws depend only on (seed, i)
        # and its own matching-op count, never on other specs' traffic.
        self._rng = [
            random.Random((self.plan.seed << 16) ^ (0x9E3779B9 * (i + 1)))
            for i in range(len(self.plan.faults))
        ]
        self.fired_log: list[tuple[str, str, str, int]] = []

    def decide(self, component: str, op: str) -> FaultDecision | None:
        if not self.plan.faults:
            return None
        with self._lock:
            for i, spec in enumerate(self.plan.faults):
                if not spec.matches(component, op):
                    continue
                self._seen[i] += 1
                n = self._seen[i]
                if spec.max_fires and self._fired[i] >= spec.max_fires:
                    continue
                if n <= spec.after:
                    continue
                fire = False
                if spec.every_n > 0 and (n - spec.after) % spec.every_n == 0:
                    fire = True
                if spec.probability > 0.0:
                    # Always draw so the stream position tracks the op
                    # count (determinism does not depend on schedule hits).
                    if self._rng[i].random() < spec.probability:
                        fire = True
                if not fire:
                    continue
                self._fired[i] += 1
                d = FaultDecision(
                    component, op, spec.kind, spec.delay_s, i, self._fired[i]
                )
                if len(self.fired_log) < self._LOG_CAP:
                    self.fired_log.append((component, op, spec.kind, n))
                _INJECTED.inc(component=component, kind=spec.kind)
                log.debug("faultline: %s", d)
                return d
        return None

    def check(self, component: str, op: str) -> FaultDecision | None:
        """Synchronous hook: sleep on delay, raise on failure kinds.

        ``drop``, ``partial_write`` and ``stale_revision`` are returned
        to the caller instead — their meaning is site-specific (discard
        the batch / truncate the write / fail the CAS)."""
        d = self.decide(component, op)
        if d is None:
            return None
        if d.kind in ("delay", "slow_cycle"):
            time.sleep(d.delay_s)
            return d
        if d.kind in ("disconnect", "err5xx", "stall"):
            raise InjectedFault(d)
        return d

    async def acheck(self, component: str, op: str) -> FaultDecision | None:
        """``check`` for asyncio call sites: delays sleep on the event
        loop instead of blocking it."""
        d = self.decide(component, op)
        if d is None:
            return None
        if d.kind in ("delay", "slow_cycle"):
            import asyncio

            await asyncio.sleep(d.delay_s)
            return d
        if d.kind in ("disconnect", "err5xx", "drop", "stall"):
            raise InjectedFault(d)
        return d

    def fire_counts(self) -> dict[str, int]:
        """Total fires by kind (evidence reporting)."""
        with self._lock:
            out: dict[str, int] = {}
            for spec, n in zip(self.plan.faults, self._fired):
                out[spec.kind] = out.get(spec.kind, 0) + n
            return out

    def fire_report(self) -> list[dict]:
        """Per-spec fire counts with their targets — the evidence shape
        drills need when the same kind hooks several operations (the
        watchstorm resume-rate gate divides by UPSTREAM breaks only)."""
        with self._lock:
            return [
                {
                    "component": s.component, "op": s.op, "kind": s.kind,
                    "fires": n,
                }
                for s, n in zip(self.plan.faults, self._fired)
            ]


_NOOP = Injector()
_active: Injector = _NOOP
_env_loaded = False


def install_plan(plan: "FaultPlan | str | dict | None") -> Injector:
    """Install ``plan`` as the process's active injector (None resets
    to the no-op injector).  Returns the installed Injector."""
    global _active, _env_loaded
    _env_loaded = True           # an explicit install overrides the env
    if plan is None:
        _active = _NOOP
    else:
        if not isinstance(plan, FaultPlan):
            plan = FaultPlan.from_json(plan)
        _active = Injector(plan)
        if plan.faults:
            log.info(
                "faultline active: seed=%d, %d fault spec(s)",
                plan.seed, len(plan.faults),
            )
    return _active


def active_injector() -> Injector:
    """The process's injector; loads K8S1M_FAULT_PLAN on first use so
    subprocess topologies (harness tiers, soak benches) inherit the plan
    without each entry point growing a flag."""
    global _env_loaded, _active
    if not _env_loaded:
        _env_loaded = True
        env = os.environ.get("K8S1M_FAULT_PLAN")
        if env:
            try:
                _active = Injector(FaultPlan.from_json(env))
                log.info("faultline: plan loaded from K8S1M_FAULT_PLAN")
            except Exception:
                log.exception("faultline: bad K8S1M_FAULT_PLAN; ignoring")
    return _active


def decide(component: str, op: str) -> FaultDecision | None:
    return active_injector().decide(component, op)


def check(component: str, op: str) -> FaultDecision | None:
    return active_injector().check(component, op)


async def acheck(component: str, op: str) -> FaultDecision | None:
    return await active_injector().acheck(component, op)
