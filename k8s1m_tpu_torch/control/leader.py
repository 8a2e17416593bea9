"""Store-backed leader election + fenced coordinator failover.

The port's own copy of ``k8s1m_tpu/control/leader.py`` (host code only:
the election, the fence and ``HACoordinator`` never touch a tensor; the
coordinators they drive run their waves on the card).

The reference elects a dist-scheduler leader through client-go's Lease
leaderelection (15s lease / 10s renew / 2s retry, reference
cmd/dist-scheduler/leader_activities.go:34-98); the leader runs the
webhook intake, node labeler, and webhook-Endpoints management, and a
replica that loses the lease steps down so a standby takes over.

Here the same contract runs against the native store: the election
object is a Lease under ``/registry/leases/<ns>/<name>`` and every
transition is a Txn CAS on its mod revision, so two candidates can never
both believe they acquired it (the store is the single arbiter exactly
as the apiserver+etcd pair is upstream).  Time is injected (``now``)
rather than read from the clock — elections are tick-driven like the
KWOK simulator, so failover paths are deterministically testable.

``HACoordinator`` pairs an elector with a Coordinator.  Three layers
make a scheduler kill boring:

- **Warm standby** (``warm_standby=True``): while NOT leading, the
  replica keeps a *mirror* coordinator following the node/pod watch
  stream — live host mirror, device table, warmed encode cache, and the
  wave's kernels, CUDA context and allocator blocks warmed by one
  discarded wave (``Coordinator.warm_compile``).  Takeover promotes the
  mirror with a bounded reconcile (``Coordinator.promote``: drain the
  watch backlog, then diff the mirror against the store pinned at the
  lease-acquire revision) instead of the cold list+decode+encode+upload
  boot, and ``failover_recovery_seconds{mode}`` records both paths so
  warm-vs-cold stays measurable.
- **Lease-epoch fencing**: every reign hands its coordinator a
  ``LeaseFence`` carrying the acquisition epoch (``leaseTransitions``).
  The coordinator's bind/evict/preempt store writes all flow through
  fenced helpers that consult the fence; once a standby's acquisition
  bumps the epoch (or the local lease expired), the deposed reign's
  in-flight waves drain to requeue — never to the store
  (``fencing_rejected_total{path}``).  The classic deposed-writer gap
  (SIGSTOP past lease expiry, clock-skewed renewals) is exercised by
  the faultline ``pause`` kind on the ``coordinator.lease`` hook.
- **Crash-consistent recovery**: derived state (queue, bound-pod
  ledger, ``_bind_meta``, gang staging) is reconstructed from store
  facts + watch/intake replay; ``Coordinator.recover_gangs`` settles
  gangs the predecessor left partially bound all-or-none.

Webhook intake during a no-leader window is queue-or-429: with a warm
standby the pod stages into the mirror (bounded) and schedules at
takeover; otherwise ``loadshed.Overloaded(reason="no-leader")`` maps to
HTTP 429 + Retry-After at the webhook.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import threading
import time

from k8s1m_tpu_torch import faultline
from k8s1m_tpu_torch.control.objects import lease_key
from k8s1m_tpu_torch.loadshed import Overloaded
from k8s1m_tpu_torch.obs.metrics import Counter, Gauge, Histogram
from k8s1m_tpu_torch.store.native import MemStore

log = logging.getLogger("k8s1m.leader")

_TRANSITIONS = Counter(
    "leader_transitions_total", "Leadership acquisitions", ("identity",)
)
_IS_LEADER = Gauge("leader_is_leader", "1 if this elector holds the lease",
                   ("identity",))
_TAKEOVERS = Counter(
    "failover_takeovers_total",
    "Coordinator takeovers, by standby mode (warm = promoted mirror, "
    "cold = fresh bootstrap)",
    ("mode",),
)
_RECOVERY = Histogram(
    "failover_recovery_seconds",
    "Lease acquisition to schedulable coordinator, by standby mode",
    ("mode",),
)


@dataclasses.dataclass
class LeaseRecord:
    holder: str
    acquire_time: float
    renew_time: float
    lease_duration_s: float
    transitions: int

    def encode(self) -> bytes:
        return json.dumps(
            {
                "apiVersion": "coordination.k8s.io/v1",
                "kind": "Lease",
                "spec": {
                    "holderIdentity": self.holder,
                    "acquireTime": self.acquire_time,
                    "renewTime": self.renew_time,
                    "leaseDurationSeconds": self.lease_duration_s,
                    "leaseTransitions": self.transitions,
                },
            },
            separators=(",", ":"),
        ).encode()

    @classmethod
    def decode(cls, data: bytes) -> "LeaseRecord":
        spec = json.loads(data)["spec"]
        return cls(
            holder=spec["holderIdentity"],
            acquire_time=spec["acquireTime"],
            renew_time=spec["renewTime"],
            lease_duration_s=spec["leaseDurationSeconds"],
            transitions=spec.get("leaseTransitions", 0),
        )


class LeaderElector:
    """One candidate's view of a named election.

    Call ``tick(now)`` at least every ``retry_period_s``; it returns True
    while this candidate holds the lease.  Semantics mirror client-go:
    - acquire when the lease is absent, expired, or already ours;
    - renew every ``renew_period_s`` via CAS on the observed revision;
    - a failed CAS (someone else wrote) re-reads and backs off;
    - ``release()`` clears holderIdentity for fast handover on clean
      shutdown (leader_activities.go clears the webhook Endpoints the
      same way).

    Every acquisition (including re-acquiring our own lease after a
    restart) bumps ``leaseTransitions``, so the transitions counter is a
    monotone *epoch*: a write fenced on the acquisition epoch can never
    be mistaken for a later reign's (see ``LeaseFence``).
    """

    def __init__(
        self,
        store: MemStore,
        identity: str,
        *,
        name: str = "dist-scheduler-tpu",
        namespace: str = "kube-system",
        lease_duration_s: float = 15.0,
        renew_period_s: float = 10.0,
        retry_period_s: float = 2.0,
    ):
        self.store = store
        self.identity = identity
        self.key = lease_key(namespace, name)
        self.lease_duration_s = lease_duration_s
        self.renew_period_s = renew_period_s
        self.retry_period_s = retry_period_s
        self.is_leader = False
        self._observed_rev = 0
        self._observed: LeaseRecord | None = None
        self._last_attempt = -1e18
        # Injected-clock bookkeeping for the fence: the most recent
        # ``now`` this elector was ticked with (NOT wall time), and the
        # store revision at which the current reign's lease CAS landed.
        self.last_now = -1e18
        self.acquire_revision = 0

    # ---- internals -----------------------------------------------------

    def _observe(self) -> None:
        kv = self.store.get(self.key)
        if kv is None:
            self._observed, self._observed_rev = None, 0
        else:
            self._observed = LeaseRecord.decode(kv.value)
            self._observed_rev = kv.mod_revision

    def _try_write(self, record: LeaseRecord) -> bool:
        if self._observed_rev == 0:
            ok, rev, _ = self.store.cas(
                self.key, record.encode(), required_mod=0
            )
        else:
            ok, rev, _ = self.store.cas(
                self.key, record.encode(), required_mod=self._observed_rev
            )
        if ok:
            self._observed, self._observed_rev = record, rev
        else:
            self._observe()
        return ok

    # ---- public --------------------------------------------------------

    def tick(self, now: float) -> bool:
        """Advance the election; returns current leadership."""
        self.last_now = now
        if self.is_leader:
            if now - self._observed.renew_time >= self.renew_period_s:
                renewed = self._try_write(
                    dataclasses.replace(self._observed, renew_time=now)
                )
                if not renewed:
                    # Someone stole the lease (we must have been expired).
                    log.warning("%s: lost leadership to %s", self.identity,
                                self._observed.holder if self._observed else "?")
                    self.is_leader = False
                    _IS_LEADER.set(0, identity=self.identity)
            return self.is_leader

        if now - self._last_attempt < self.retry_period_s:
            return False
        self._last_attempt = now
        self._observe()
        rec = self._observed
        expired = rec is None or not rec.holder or (
            now - rec.renew_time >= rec.lease_duration_s
        )
        if not expired and rec.holder != self.identity:
            return False
        acquired = self._try_write(
            LeaseRecord(
                holder=self.identity,
                acquire_time=now,
                renew_time=now,
                lease_duration_s=self.lease_duration_s,
                transitions=(rec.transitions + 1) if rec else 0,
            )
        )
        if acquired:
            self.is_leader = True
            self.acquire_revision = self._observed_rev
            _TRANSITIONS.inc(identity=self.identity)
            _IS_LEADER.set(1, identity=self.identity)
            log.info("%s: acquired leadership (epoch %d)", self.identity,
                     self._observed.transitions)
        return self.is_leader

    def release(self) -> None:
        """Voluntarily give up the lease (clean shutdown handover)."""
        if not self.is_leader:
            return
        self.is_leader = False
        _IS_LEADER.set(0, identity=self.identity)
        self._try_write(dataclasses.replace(self._observed, holder=""))

    def step_down(self) -> None:
        """Local-only stepdown: stop believing leadership WITHOUT
        touching the store — the SIGKILL emulation (a dead process
        cannot release; the lease expires on its own and a standby
        takes over on the crash path)."""
        self.is_leader = False
        _IS_LEADER.set(0, identity=self.identity)

    def current_epoch(self) -> int:
        """The reign's fencing epoch (``leaseTransitions`` of our own
        acquisition); -1 while not leading."""
        if not self.is_leader or self._observed is None:
            return -1
        return self._observed.transitions

    def locally_expired(self) -> bool:
        """True when, by this elector's OWN injected clock, the lease
        duration has elapsed since the last observed renewal — the
        fast local half of the fence (a paused replica whose clock
        stopped is caught by the store check instead)."""
        return (
            self._observed is not None
            and self.last_now - self._observed.renew_time
            >= self.lease_duration_s
        )

    def fence(self) -> "LeaseFence":
        """The fencing token for the CURRENT reign (call at takeover)."""
        return LeaseFence(self, self.current_epoch())


class LeaseFence:
    """Lease-epoch fencing token for one reign.

    ``admit()`` gates every bind/evict/preempt store write the
    coordinator retires.  Two checks compose:

    - the LOCAL elector view — refusal is immediate once the elector
      stepped down, a different reign's epoch took over, or the lease
      expired by our own injected clock;
    - the STORE lease record — the single arbiter.  A deposed leader
      whose clock is paused/skewed still believes its local view; the
      store read sees the standby's acquisition (a newer
      ``leaseTransitions``) and refuses the write.  This closes the
      classic fencing-token gap: in-flight waves of a deposed reign
      drain to requeue, never to the store.

    The residual window of any read-then-write fence (an admit that
    races the standby's acquisition CAS) is documented in README
    "Coordinator failover & fencing"; the store-side pod CAS still
    prevents double-binds of a single pod in that window.
    """

    def __init__(self, elector: LeaderElector, epoch: int):
        self.elector = elector
        self.epoch = epoch

    def admit(self) -> bool:
        e = self.elector
        if not e.is_leader or e.current_epoch() != self.epoch:
            return False
        if e.locally_expired():
            return False
        kv = e.store.get(e.key)
        if kv is None:
            return False
        rec = LeaseRecord.decode(kv.value)
        return rec.holder == e.identity and rec.transitions == self.epoch


class HACoordinator:
    """Leader-gated coordinator: standby until elected, step while leading.

    ``make_coord`` builds a fresh Coordinator; with ``warm_standby`` the
    replica keeps one FOLLOWING while not leading (live host mirror,
    warmed caches and kernels — ``Coordinator.follow``) and
    promotes it at takeover; without, takeover cold-boots.  Either way
    the new reign is handed a ``LeaseFence`` so a deposed predecessor's
    writes can never land behind it, and ``recover_gangs`` settles
    crash-split gangs all-or-none.

    Webhook intake goes through ``submit_external`` on *this* object —
    a reign-stable sink.  During a no-leader window it is queue-or-429:
    queue into the standby mirror while it has room, else raise
    ``loadshed.Overloaded(reason="no-leader")`` (the webhook maps it to
    HTTP 429 + Retry-After).

    The ``coordinator.lease`` faultline hook (op ``tick/<identity>``)
    fires at the top of ``tick``: kind ``kill_process`` emulates SIGKILL
    (``kill()`` — no lease release, no flush; takeover happens on lease
    expiry), kind ``pause`` emulates SIGSTOP *between the leadership
    check and the reign's writes* — the fencing gap's worst case.  The
    drill installs ``on_pause`` to advance the rest of the world
    deterministically while this replica is frozen.
    """

    def __init__(
        self,
        elector: LeaderElector,
        make_coord,
        *,
        warm_standby: bool = False,
        standby_queue_cap: int = 100_000,
    ):
        self.elector = elector
        self.make_coord = make_coord
        self.warm_standby = warm_standby
        self.standby_queue_cap = standby_queue_cap
        self.coord = None
        self._mirror = None
        self._killed = False
        # Pods staged into the standby mirror during the current
        # no-leader window (webhook threads increment under the lock;
        # reset when a reign starts or a fresh mirror is built) — the
        # queue-or-429 bound without a cross-thread read of the
        # mirror's cycle-owned queue.
        self._staged_lock = threading.Lock()
        self._standby_staged = 0
        # Drill hook: called instead of time.sleep on an injected pause
        # so single-threaded tick-driven drills can advance the other
        # replicas while this one is "stopped".
        self.on_pause = None
        # Takeover evidence for the drills (failover_drill reads these).
        self.takeover_mode: str | None = None
        self.last_recovery_s: float | None = None
        self.last_promote_stats: dict | None = None

    def submit_external(self, obj: dict, *, admitted: bool = False) -> None:
        """Reign-stable webhook sink; queue-or-429 during no-leader
        windows.  ``admitted`` passes through the webhook's
        already-ran-admission marker (see Coordinator.submit_external)."""
        coord = self.coord
        if coord is not None:
            coord.submit_external(obj, admitted=admitted)
            return
        mirror = self._mirror
        if mirror is not None:
            # Warm standby: stage into the mirror (it schedules the
            # backlog at takeover; the store watch remains the dedup'd
            # fallback intake).  Bounded — a leaderless window must not
            # buffer unbounded demand — and ``admitted`` passes THROUGH:
            # a pod that has not drawn its admission decision draws it
            # from the mirror's tenancy/loadshed chain (follow() keeps
            # the buckets ticking), so an over-share tenant cannot use
            # a failover window to bypass weighted-fair admission.
            with self._staged_lock:
                if self._standby_staged >= self.standby_queue_cap:
                    raise Overloaded(
                        self.elector.retry_period_s, reason="no-leader"
                    )
                self._standby_staged += 1
            try:
                mirror.submit_external(obj, admitted=admitted)
            except BaseException:
                with self._staged_lock:
                    self._standby_staged -= 1
                raise
            return
        raise Overloaded(self.elector.lease_duration_s, reason="no-leader")

    def tick(self, now: float) -> int:
        """Run one election step and (if leading) one scheduling cycle.
        Returns pods bound this tick."""
        if self._killed:
            return 0
        d = faultline.decide(
            "coordinator.lease", "tick/" + self.elector.identity
        )
        if d is not None and d.kind == "kill_process":
            self.kill()
            return 0
        was_leader = self.elector.is_leader
        leading = self.elector.tick(now)
        if d is not None and d.kind in ("pause", "delay"):
            # SIGSTOP-style freeze AFTER the leadership check and BEFORE
            # any scheduling write: the world moves on (a standby can
            # steal the expired lease) while this replica still believes
            # its pre-pause election observation.  The fence is what
            # keeps its writes out of the store when it resumes.
            if self.on_pause is not None:
                self.on_pause(d)
            else:
                time.sleep(d.delay_s)
        if leading and not was_leader:
            self._become_leader()
        elif not leading and was_leader:
            self._depose()
        if not leading:
            if self.warm_standby:
                self._standby_tick()
            return 0
        return self.coord.step()

    # ---- transitions ---------------------------------------------------

    def _become_leader(self) -> None:
        t0 = time.perf_counter()
        fence = self.elector.fence()
        mirror, self._mirror = self._mirror, None
        with self._staged_lock:
            self._standby_staged = 0
        if mirror is not None:
            mode = "warm"
            mirror.fence = fence
            self.last_promote_stats = mirror.promote(
                acquire_revision=self.elector.acquire_revision
            )
            self.coord = mirror
        else:
            mode = "cold"
            coord = self.make_coord()
            coord.fence = fence
            coord.bootstrap()
            coord.recover_gangs()
            self.last_promote_stats = None
            self.coord = coord
        self.last_recovery_s = time.perf_counter() - t0
        self.takeover_mode = mode
        _TAKEOVERS.inc(mode=mode)
        _RECOVERY.observe(self.last_recovery_s, mode=mode)
        log.info(
            "%s: takeover (%s) in %.3fs", self.elector.identity, mode,
            self.last_recovery_s,
        )

    def _depose(self) -> None:
        coord, self.coord = self.coord, None
        if coord is None:
            return
        try:
            # Deposed: retire the pipeline THROUGH the fence — every
            # in-flight wave's binds are refused (fencing_rejected_total)
            # and its pods drain to requeue, never to the store.
            coord.flush()
        finally:
            coord.close()

    def _standby_tick(self) -> None:
        if self._mirror is None:
            m = self.make_coord()
            m._follower = True
            m.bootstrap()
            with self._staged_lock:
                self._standby_staged = 0
            self._mirror = m
        self._mirror.follow()

    # ---- lifecycle -----------------------------------------------------

    def kill(self) -> None:
        """SIGKILL emulation (faultline kind ``kill_process``): the
        lease is NOT released (a dead process cannot), nothing is
        flushed — in-flight waves die with the process and their pods
        stay pending in the store for the next leader.  Watches are
        cancelled the way a dead process's connections are reaped."""
        self._killed = True
        self.elector.step_down()
        for c in (self.coord, self._mirror):
            if c is not None:
                c.close()
        self.coord = self._mirror = None
        log.warning("%s: killed (lease left to expire)",
                    self.elector.identity)

    def stop(self) -> None:
        """Clean shutdown: retire in-flight work while the lease is
        still ours, then release for fast handover."""
        if self.coord is not None:
            self.coord.flush()
        self.elector.release()
        if self.coord is not None:
            self.coord.close()
            self.coord = None
        if self._mirror is not None:
            self._mirror.close()
            self._mirror = None
