"""Watch-cache fan-out tier — the apiserver's watch-amplification role.

The port's copy of ``k8s1m_tpu/store/watch_cache.py``.  The JAX module
serves through ``grpc.aio.server`` and the generated protobuf modules;
this one serves through ``store/wire_server.py`` (HTTP/2 and gRPC on
asyncio, with its TLS port and bearer check in place of
``grpc.ssl_server_credentials`` and the ``_BearerAuth`` interceptor), speaks
the hand codec ``store/proto/codec.py``, and reaches its upstream store
through the port's ``EtcdClient``.  Event for event, and byte for byte on
the shared frames, it answers as the JAX tier does
(``tests/test_torch_watch_cache.py`` holds it).

The reference's hardest apiserver findings live in this tier: every
kubelet+kube-proxy holds ~18 apiserver watches (18M watches at 1M nodes)
and **none of them reach etcd** — the apiserver's watch cache holds one
etcd watch per resource and fans events out to all client watches
(reference README.adoc:410-416).  The cache's storage structure sets the
update ceiling: the 1.31+ B-tree cache capped at ~40K updates/s while the
O(1) hashmap cache sustained 100K+/s, which is why the reference runs a
custom k3s build with ``BtreeWatchCache=false`` (reference
README.adoc:495-499, terraform/k8s-server/server.tf:39).

This module is that tier for our store: ``WatchCache`` primes itself with
a list+watch against the upstream store (ONE store watch per prefix,
regardless of client count) and serves the public etcd Watch wire
protocol downstream, so ``EtcdClient``/``watch_stress`` work against it
unchanged.  ``index="hash"|"btree"`` switches the cached-object storage
to reproduce the ceiling experiment: hash keeps an O(1) dict, btree
additionally maintains the ordered key index on every event (bisect
search + ordered insert), which is also what lets btree-mode Range serve
ordered lists without a per-call sort.

Downstream watch semantics mirror the store server
(k8s1m_tpu/store/etcd_server.py): created:true response, past-events
replay from the bounded history window, live batches, ProgressRequest,
CancelRequest; a start revision older than the window yields a cancel
response with ``compact_revision`` set.

Storm-proofing — the tier degrades instead of
detonating:

- **Resume-from-revision.**  An upstream watch break no longer cancels
  every client for a full relist: ``reprime`` diffs the relisted
  snapshot against the cached objects and replays the NET difference
  (latest value per changed key, deletes stamped at the relist
  revision) through the ordinary fan-out, so clients keep their watches
  across the outage (``watchcache_resumes_total``).  Only when the net
  diff cannot fit the bounded history window does the tier fall back to
  the old cancel-everyone hammer (``watchcache_invalidations_total``).
  Net replay is legal because the tier's consumers are level-triggered
  caches (see MIGRATION "Watch resume & degradation contract").

- **Bounded-lag degradation.**  A slow consumer is coalesced before it
  is canceled: each subscriber buffers FIFO up to the tier's effective
  lag budget, then folds further events latest-only-per-key
  (``watchcache_coalesced_events_total``) — the deepest-backlog (i.e.
  floodiest) watchers degrade first, and the loadshed HealthController
  shrinks the budget tier-wide as total backlog climbs
  (HEALTHY -> full, DEGRADED -> quarter, SHEDDING -> coalesce
  immediately).  Only a subscriber whose coalesce map ALSO overflows
  its hard cap is canceled so it relists.

- **Sharded fan-out pumps.**  Dispatch splits across N pump lanes
  (watcher id hash) with a bounded per-stream output queue, so one
  wedged subscriber socket backpressures its own lane instead of
  head-of-line-blocking every watcher, and a 100K-watch stream costs N
  tasks, not 100K.

- **Shared-frame wire encoding (wiretier).**  Fan-out used
  to re-encode every batch per watch id; the pump sweeps now group
  watchers owing identical batches (equal ``CacheEvent.seq`` tuples),
  fetch each event's chunk bytes once from a tier-level
  ``wiretier.FrameTable``, and ship ONE composed frame per group with
  the extra watch ids riding a trailing extension — encode CPU scales
  with frames, not fan-out degree, and wire bytes drop by the realized
  sharing degree.  A coalesced drain additionally declares its
  compacted [from_rev, to_rev] window on the wire.  Per-watch streams
  stay byte-identical to the unshared encoding (the
  tests/test_watch_cache.py wiretier differentials).

- **Replica warm restart (``--resume-floor``).**  A relaunched fleet
  replica primes at the current revision, catch-up loads
  (floor, prime_rev] into the history window from store history before
  binding its port, and the dead instance's clients re-attach with
  their own start_revision and RESUME (``watchcache_resumes_total``)
  instead of relisting — see ``run_upstream``.

- **Faultline hooks** ``watch.tier/pump.stall`` and
  ``watch.tier/subscriber.send`` (plus the existing ``upstream.recv``)
  make all three failure modes injectable by seed — the watchstorm
  drill (tools/watch_fanout_ab.py) gates delivery-lag p99, zero event
  loss by ledger, and the resume rate under the composed storm.
"""

from __future__ import annotations

import argparse
import asyncio
import bisect
import collections
import contextlib
import dataclasses
import logging
import socket
import subprocess
import sys
import time
import zlib

from k8s1m_tpu_torch import faultline
from k8s1m_tpu_torch.faultline import InjectedFault, policy_for
from k8s1m_tpu_torch.lint import THREAD_OWNER, guarded_by
from k8s1m_tpu_torch.loadshed import HealthController, LoadshedConfig, Signals
from k8s1m_tpu_torch.obs.metrics import Counter, Gauge
from k8s1m_tpu_torch.store import wire_server, wiretier
from k8s1m_tpu_torch.store.etcd_client import EtcdClient
from k8s1m_tpu_torch.store.etcd_server import range_response_bytes
from k8s1m_tpu_torch.store.native import prefix_end
from k8s1m_tpu_torch.store.proto import codec as pb

log = logging.getLogger("k8s1m.watchcache")

_EVENTS_IN = Counter(
    "watchcache_events_in_total", "events received from the store", ()
)
_EVENTS_OUT = Counter(
    "watchcache_events_delivered_total", "events delivered to client watches", ()
)
_WATCHERS = Gauge("watchcache_watchers", "active client watches", ())
_INVALIDATIONS = Counter(
    "watchcache_invalidations_total",
    "upstream watch breaks that canceled every client for relist", ()
)
_REPLAYS = Counter(
    "watchcache_replays_total",
    "follower resume-from-revision requests, by outcome: resumed = the "
    "history window reached the requested revision (warm-standby "
    "follow mode rides this); compact_relist = the window fell short "
    "and the client was told to relist",
    ("outcome",),
)
_RESUMES = Counter(
    "watchcache_resumes_total",
    "upstream watch breaks absorbed by diff-replay resume: clients "
    "kept their watches, the net snapshot difference was replayed "
    "(the split's other half is watchcache_invalidations_total)", ()
)
_COALESCED = Counter(
    "watchcache_coalesced_events_total",
    "events elided by per-subscriber latest-only-per-key coalescing "
    "under the bounded-lag budget", ()
)
_DEGRADED_WATCHERS = Gauge(
    "watchcache_degraded_watchers",
    "client watches currently in coalescing (bounded-lag) delivery", ()
)

_DEFAULT_WINDOW = 65536

# Priming list page size: bounds any single upstream response to a few
# MB regardless of prefix population (client-go chunking equivalent).
_PRIME_PAGE = 10_000
_QUEUE_CAP = 10_000
_WATCH_BATCH = 1000
# Per-subscriber FIFO budget before latest-only coalescing engages
# (the loadshed controller shrinks it tier-wide under backlog).
_LAG_BUDGET = 4096
# Per-stream output queue bound: a wedged subscriber socket
# backpressures its own stream's pump lanes at this depth instead of
# buffering responses without bound.
_OUT_CAP = 1024
# Fan-out pump lanes per Watch stream (watcher id hash).
_PUMP_SHARDS = 8
# Bounded stall applied at the pump.stall hook when the firing spec
# carries no delay of its own.
_STALL_S = 0.05


@dataclasses.dataclass
class CachedObject:
    value: bytes
    create_revision: int
    mod_revision: int
    version: int


class _KV:
    """A cached object with its key, in the attribute shape
    ``etcd_server.range_response_bytes`` reads (no lease: the tier never
    carries one)."""

    __slots__ = ("key", "create_revision", "mod_revision", "version", "value")
    lease = 0

    def __init__(self, key, create_revision, mod_revision, version, value):
        self.key = key
        self.create_revision = create_revision
        self.mod_revision = mod_revision
        self.version = version
        self.value = value


@dataclasses.dataclass
class CacheEvent:
    type: int            # 0 PUT, 1 DELETE
    key: bytes
    value: bytes
    create_revision: int
    mod_revision: int
    version: int
    # Tier-monotone apply sequence (0 = never applied, e.g. test-built
    # events): the shared-frame table's cache key and the pump sweep's
    # batch-identity fingerprint (equal seq tuples = equal bytes owed).
    seq: int = 0


class Downstream:
    """One client watch served from the cache.

    Delivery runs in two regimes: a bounded FIFO queue up to the tier's
    effective lag budget, then latest-only-per-key coalescing — legal
    for the level-triggered caches this tier serves (the net state at
    quiesce is identical to the uncoalesced stream; the differential
    gate in tests/test_watch_cache.py holds it).  Once coalescing
    engages it sticks until the subscriber fully drains, so emission
    stays revision-ordered (everything in the map postdates everything
    in the queue).  Only a coalesce map overflowing ``hard_cap``
    distinct keys cancels the watch (the client relists) — the old
    cancel-at-queue-cap hammer demoted to the last resort.
    """

    def __init__(self, wid: int, key: bytes, end: bytes | None,
                 min_rev: int = 0, hard_cap: int = _QUEUE_CAP):
        self.id = wid
        self.key = key
        self.end = end          # None = single key; b"\0" = to infinity
        self.min_rev = min_rev  # suppress live events below this revision
        self.service_id = wid   # stream-side watch id (service assigns)
        self.hard_cap = hard_cap
        # Explicit bound (bounded-watch-buffer): coalescing engages at
        # the (smaller) effective lag budget, so maxlen is a never-hit
        # backstop, not the working limit.
        self.queue: collections.deque[CacheEvent] = collections.deque(
            maxlen=hard_cap
        )
        self.coalesced: dict[bytes, CacheEvent] = {}
        self.coalescing = False
        # Newest mod_revision handed to this watch — the delivery
        # high-water mark the byte-identity differential asserts
        # against (tests/test_watch_cache.py); not read on any
        # production path.
        self.last_pushed = 0
        # True when the newest pop_batch drained from the coalesce map:
        # that batch is a compacted [from_rev, to_rev] window
        # (latest-per-key), which the wiretier declares on the wire.
        self.last_pop_compacted = False
        self.wakeup = asyncio.Event()
        self.overflowed = False
        self.owner: "WatchCache | None" = None   # set by register()
        self.on_ready = None    # pump-shard callback (service side)
        self._ready = False     # latched onto a shard's ready set

    def matches(self, key: bytes) -> bool:
        if self.end is None:
            return key == self.key
        if key < self.key:
            return False
        if self.end == b"\x00":
            return True
        return key < self.end

    def push(self, ev: CacheEvent, lag_budget: int | None = None) -> None:
        budget = self.hard_cap if lag_budget is None else lag_budget
        if self.coalescing or len(self.queue) >= budget:
            if not self.coalescing:
                self.coalescing = True
                _DEGRADED_WATCHERS.inc()
            if ev.key in self.coalesced:
                # Latest-only elision: the superseded event is the one
                # a level-triggered consumer never needed.
                _COALESCED.inc()
                self.coalesced[ev.key] = ev
            elif len(self.coalesced) >= self.hard_cap:
                # Even latest-per-key cannot keep up (more distinct
                # keys lagging than the hard cap): cancel rather than
                # gap silently — the client relists.
                self.overflowed = True
            else:
                self.coalesced[ev.key] = ev
                if self.owner is not None:
                    self.owner._backlog += 1
        else:
            self.queue.append(ev)
            if self.owner is not None:
                self.owner._backlog += 1
        if ev.mod_revision > self.last_pushed:
            self.last_pushed = ev.mod_revision
        self._notify()

    def pop_batch(self, n: int) -> list[CacheEvent]:
        """Drain up to ``n`` events in revision order: the FIFO first,
        then the coalesce map (all of whose events postdate the
        queue's, since coalescing sticks until fully drained)."""
        out: list[CacheEvent] = []
        q = self.queue
        self.last_pop_compacted = False
        while q and len(out) < n:
            out.append(q.popleft())
        if not q and self.coalesced and len(out) < n:
            self.last_pop_compacted = True
            # seq tiebreak: reprime stamps several events at one wire
            # revision, and peers coalescing the same window must pop
            # identical batches for the sweep to share their frame.
            rest = sorted(
                self.coalesced.values(),
                key=lambda e: (e.mod_revision, e.seq),
            )
            take = rest[: n - len(out)]
            for e in take:
                del self.coalesced[e.key]
            out.extend(take)
            if not self.coalesced:
                self.coalescing = False
                _DEGRADED_WATCHERS.dec()
        if self.owner is not None:
            self.owner._backlog -= len(out)
        return out

    @property
    def backlog(self) -> int:
        return len(self.queue) + len(self.coalesced)

    def _notify(self) -> None:
        self.wakeup.set()
        cb = self.on_ready
        if cb is not None:
            cb(self)


@guarded_by(
    # The cache is event-loop-confined by design: the upstream pump, the
    # downstream reader tasks and every Range all run on one asyncio
    # loop.  THREAD_OWNER makes that a checked invariant — a second
    # event loop (or a bare thread) reaching into the cache is exactly
    # the corruption an async tier makes easy to write and hard to see.
    objects=THREAD_OWNER,
    sorted_keys=THREAD_OWNER,
    history=THREAD_OWNER,
    _exact=THREAD_OWNER,
    _ranges=THREAD_OWNER,
    _backlog=THREAD_OWNER,
    _lag_now=THREAD_OWNER,
    _seq=THREAD_OWNER,
)
class WatchCache:
    """Cached objects + bounded event history + downstream fan-out."""

    def __init__(
        self, index: str = "hash", window: int = _DEFAULT_WINDOW,
        lag_budget: int = _LAG_BUDGET,
        shed: HealthController | None = None,
    ):
        if index not in ("hash", "btree"):
            raise ValueError(f"index must be hash|btree, got {index!r}")
        self.index = index
        self.objects: dict[bytes, CachedObject] = {}
        # btree mode: ordered key index maintained per event — the
        # reference's BtreeWatchCache cost axis.  hash mode sorts only
        # when a Range needs it.
        self.sorted_keys: list[bytes] = []
        self.history: collections.deque[CacheEvent] = collections.deque(
            maxlen=window
        )
        self.last_revision = 0    # newest applied store revision
        self.prime_revision = 0   # revision of the (latest) priming list
        self.events_in = 0
        self.events_out = 0
        # Watcher index: exact-key hashmap + (short) list of range
        # watchers, so per-event dispatch is O(1) + O(range watchers) —
        # the fan-out stays cheap even with 10K+ exact watchers (the
        # 18-watches-per-node shape is mostly exact watches).
        self._exact: dict[bytes, set[Downstream]] = {}
        self._ranges: set[Downstream] = set()
        self._next_id = 1
        # Bounded-lag degradation: the health controller watches total
        # fan-out backlog (every subscriber's queued + coalesced
        # events, maintained incrementally) and derives the effective
        # per-subscriber FIFO budget — degradation is controller-driven
        # and depth-triggered, so under a lease flood the floodiest
        # (deepest-backlog) watchers degrade first.
        self.lag_budget = lag_budget
        self._shed = shed or HealthController(
            LoadshedConfig(
                queue_degraded=16 * lag_budget,
                queue_shed=64 * lag_budget,
                queue_cap=1 << 30,
                queue_recover=4 * lag_budget,
                recover_cycles=2,
            ),
            name="watch.tier",
        )
        self._backlog = 0
        self._lag_now = lag_budget
        # Monotone apply counter: stamps CacheEvent.seq, the shared
        # frame table's encode-once cache key.
        self._seq = 0

    def loadshed_tick(self) -> None:
        """Feed the current fan-out backlog to the tier's health
        controller and refresh the effective lag budget.  Ticked by the
        upstream pump once per applied batch: decisions only matter
        while events are flowing, so a quiet prefix's stale budget is
        harmless until traffic (and with it ticking) resumes."""
        self._shed.tick(Signals(queue_depth=self._backlog))
        self._lag_now = self._shed.lag_budget(self.lag_budget)

    # ---- window bounds -------------------------------------------------

    @property
    def replayable_from(self) -> int:
        """Earliest revision from which event replay is provably
        complete: everything after the priming list is in the history
        window unless the bounded deque has started evicting."""
        if self.history and len(self.history) == self.history.maxlen:
            return self.history[0].mod_revision
        return self.prime_revision + 1

    # ---- upstream apply ------------------------------------------------

    def prime(self, kvs, revision: int) -> None:
        """Load the initial list snapshot (list+watch priming)."""
        for kv in kvs:
            self.objects[kv.key] = CachedObject(
                kv.value, kv.create_revision, kv.mod_revision, kv.version
            )
        if self.index == "btree":
            self.sorted_keys = sorted(self.objects)
        self.last_revision = max(self.last_revision, revision)
        self.prime_revision = max(self.prime_revision, revision)

    def invalidate(self, key: bytes = b"", end: bytes = b"\x00") -> None:
        """The cancel-everyone hammer, now the FALLBACK: an upstream
        outage whose net effect cannot be represented in the bounded
        history window (see ``reprime``) cancels every client watch so
        each one relists — the same contract as a store-watcher
        overflow — and resets state for re-priming.

        ``[key, end)`` scopes the OBJECT clearing to the broken
        stream's prefix: a healthy prefix's objects stay, so its
        cache-served Ranges don't turn confidently empty while only
        another prefix's stream is down.  Watcher cancellation and the
        history window stay global — the ring is shared, and with it
        cleared every replay window resets, so a kept prefix's
        relisting clients converge through compact-cancel + relist."""
        n = sum(len(p) for p in self._exact.values()) + len(self._ranges)
        log.warning(
            "cache invalidated at revision %d: canceling %d client "
            "watches for relist", self.last_revision, n,
        )
        _INVALIDATIONS.inc()
        for peers in self._exact.values():
            for w in peers:
                w.overflowed = True
                w._notify()
        for w in self._ranges:
            w.overflowed = True
            w._notify()
        if not key and end == b"\x00":
            self.objects.clear()
            self.sorted_keys = []
        else:
            for k in [
                k for k in self.objects
                if k >= key and (end == b"\x00" or k < end)
            ]:
                del self.objects[k]
            if self.index == "btree":
                self.sorted_keys = sorted(self.objects)
        self.history.clear()

    def reprime(
        self, kvs, revision: int,
        key: bytes = b"", end: bytes = b"\x00",
    ) -> bool:
        """Resume path after an upstream break: diff the relisted
        snapshot (``kvs`` at ``revision``) against the cached objects
        and replay the NET difference — latest value per changed key,
        one DELETE per vanished key — through the ordinary fan-out, so
        every client watch survives the outage in place.

        ``[key, end)`` scopes the deletion sweep to the prefix the
        broken stream actually covered: the object map is the UNION of
        every watched prefix, and an unscoped diff would read every
        other prefix's keys as deleted (found by the storm drill's
        idle-watch population, which must deliver nothing, ever).

        Deletes lost with the stream have no knowable revision; they
        are stamped at the relist revision (an upper bound).  Keys
        created AND deleted inside the outage are invisible in both
        snapshots and produce nothing.  Both are exactly the latest-
        only elisions coalescing already performs, and legal for the
        same reason: the tier's consumers are level-triggered caches,
        and the net state at quiesce is byte-identical to a full
        relist (the tests/test_watch_cache.py differential).

        Every replayed event goes out ON THE WIRE stamped at the
        relist revision (>= the tier's global header revision by store
        monotonicity): a client whose last-seen revision came from a
        header on ANOTHER prefix's progress re-attaches with a
        start_revision a back-dated event would never clear (the
        delete-stamping rationale applies to the puts too).  The object map keeps the true MVCC revisions so the
        NEXT reprime's diff still compares real facts.

        Returns True when clients were resumed; False when the net
        diff exceeds the bounded history window — appending it would
        evict genuine history under replaying followers' feet — and
        the tier fell back to ``invalidate()`` (counted there)."""
        changed: list[CacheEvent] = []
        new_keys = set()
        for kv in kvs:
            new_keys.add(kv.key)
            old = self.objects.get(kv.key)
            if old is not None and kv.mod_revision < old.mod_revision:
                # Per-key revision ROLLBACK: the store restarted having
                # lost its tail (buffered-WAL crash).  Forward
                # net-replay cannot represent history moving backwards
                # — fail closed to the hammer, the old contract.
                self.invalidate(key, end)
                return False
            if old is None or old.mod_revision != kv.mod_revision:
                changed.append(CacheEvent(
                    0, kv.key, kv.value, kv.create_revision,
                    kv.mod_revision, kv.version,
                ))
        deleted = []
        local_max = 0       # this PREFIX's cached high-water revision
        for k, o in self.objects.items():
            if k < key or not (end == b"\x00" or k < end):
                continue
            if o.mod_revision > local_max:
                local_max = o.mod_revision
            if k not in new_keys:
                deleted.append(k)
        if revision < local_max:
            # The whole-prefix rollback form of the same story: the
            # relist pins a revision BELOW state this prefix already
            # held.  Judged against the PREFIX-LOCAL high-water mark,
            # not the cache's global last_revision — on a multi-prefix
            # tier a healthy prefix's live events advance the global
            # mark past a broken prefix's relist pin as a matter of
            # course, and that must not read as a rollback.
            self.invalidate(key, end)
            return False
        if len(changed) + len(deleted) > (self.history.maxlen or 0):
            self.invalidate(key, end)
            return False
        for k in deleted:
            changed.append(CacheEvent(1, k, b"", 0, revision, 0))
        changed.sort(key=lambda e: e.mod_revision)
        for e in changed:
            self.apply(
                e.type, e.key, e.value, e.create_revision,
                e.mod_revision, e.version, wire_revision=revision,
            )
        self.last_revision = max(self.last_revision, revision)
        _RESUMES.inc()
        self.loadshed_tick()
        log.info(
            "upstream resumed at revision %d: %d net event(s) replayed "
            "to %d client watch(es), no relists",
            revision, len(changed), self.watcher_count,
        )
        return True

    def apply(self, ev_type: int, key: bytes, value: bytes,
              create_revision: int, mod_revision: int, version: int,
              wire_revision: int | None = None,
              catchup: bool = False) -> None:
        """Apply one upstream store event: update the cached object map
        (hash or btree storage), append to the history window, fan out.

        ``wire_revision`` (reprime's resume replay) splits the two
        roles a revision plays: the OBJECT MAP keeps the true MVCC
        ``mod_revision`` — the next reprime's diff compares against it
        — while the history window and the fanned-out event carry the
        stamped wire revision, so the resumed stream stays monotonic
        for clients whose last-seen revision is the tier's GLOBAL
        header revision (a back-dated event would be filtered by their
        re-attach ``start_revision`` and lost forever).

        ``catchup`` (replica warm restart, run_upstream's resume-floor
        path) appends to the history window WITHOUT touching the
        object map: the priming list at the prime revision is already
        the truth for objects, and replaying an old PUT into the map
        could resurrect a key the list shows deleted.  Catch-up exists
        purely so resuming clients can replay (floor, prime_rev] from
        history instead of relisting."""
        if catchup:
            pass
        elif ev_type == 0:
            existed = key in self.objects
            self.objects[key] = CachedObject(
                value, create_revision, mod_revision, version
            )
            if self.index == "btree" and not existed:
                bisect.insort(self.sorted_keys, key)
            elif self.index == "btree":
                # Existing key: the B-tree still pays the ordered-index
                # search on update — the cost the reference's experiment
                # measures (README.adoc:495-499).
                bisect.bisect_left(self.sorted_keys, key)
        else:
            if self.objects.pop(key, None) is not None and self.index == "btree":
                i = bisect.bisect_left(self.sorted_keys, key)
                if i < len(self.sorted_keys) and self.sorted_keys[i] == key:
                    del self.sorted_keys[i]
        wr = mod_revision if wire_revision is None else wire_revision
        self._seq += 1
        ev = CacheEvent(
            ev_type, key, value, create_revision, wr, version,
            seq=self._seq,
        )
        self.history.append(ev)
        self.last_revision = max(self.last_revision, wr)
        self.events_in += 1
        _EVENTS_IN.inc()
        delivered = 0
        lag = self._lag_now
        for w in self._exact.get(key, ()):
            if wr >= w.min_rev:
                w.push(ev, lag)
                delivered += 1
        for w in self._ranges:
            if wr >= w.min_rev and w.matches(key):
                w.push(ev, lag)
                delivered += 1
        self.events_out += delivered
        if delivered:
            _EVENTS_OUT.inc(delivered)

    # ---- downstream registry -------------------------------------------

    def register(
        self, key: bytes, end: bytes | None, min_rev: int = 0
    ) -> Downstream:
        # hard_cap >= lag_budget keeps the deque's maxlen a never-hit
        # backstop: an operator budget past _QUEUE_CAP must raise the
        # cancel threshold with it, or push() would stop engaging
        # coalescing and maxlen would silently evict the oldest event.
        w = Downstream(
            self._next_id, key, end, min_rev,
            hard_cap=max(_QUEUE_CAP, self.lag_budget),
        )
        self._next_id += 1
        w.owner = self
        w.last_pushed = min_rev - 1 if min_rev > 0 else self.last_revision
        if end is None:
            self._exact.setdefault(key, set()).add(w)
        else:
            self._ranges.add(w)
        _WATCHERS.inc()
        return w

    def unregister(self, w: Downstream) -> None:
        if w.end is None:
            peers = self._exact.get(w.key)
            if peers is not None:
                peers.discard(w)
                if not peers:
                    del self._exact[w.key]
        else:
            self._ranges.discard(w)
        if w.owner is self:
            # Undelivered backlog leaves the tier with the watcher.
            self._backlog -= w.backlog
            w.owner = None
        if w.coalescing:
            w.coalescing = False
            _DEGRADED_WATCHERS.dec()
        _WATCHERS.dec()

    @property
    def watcher_count(self) -> int:
        return sum(len(s) for s in self._exact.values()) + len(self._ranges)

    def replay(self, w: Downstream, start_revision: int) -> int | None:
        """Queue historical events >= start_revision for ``w``.  Returns
        the compact revision when the window no longer reaches back far
        enough (the caller sends a compact_revision cancel, mirroring
        etcd; the client relists), else None."""
        if start_revision <= 0:
            return None
        if start_revision < self.replayable_from:
            _REPLAYS.inc(outcome="compact_relist")
            return self.replayable_from
        _REPLAYS.inc(outcome="resumed")
        lag = self._lag_now
        for ev in self.history:
            if ev.mod_revision >= start_revision and w.matches(ev.key):
                w.push(ev, lag)
        return None

    # ---- cache-served Range --------------------------------------------

    def range(self, key: bytes, end: bytes, limit: int = 0):
        """Serve a list from the cache (the apiserver serves lists from
        the watch cache, which is what makes its storage structure the
        throughput-critical one).  Returns (kvs, more, count)."""
        if not end:
            obj = self.objects.get(key)
            return ([(key, obj)] if obj else [], False, 1 if obj else 0)
        if self.index == "btree":
            lo = bisect.bisect_left(self.sorted_keys, key)
            hi = (
                len(self.sorted_keys)
                if end == b"\x00"
                else bisect.bisect_left(self.sorted_keys, end)
            )
            keys = self.sorted_keys[lo:hi]
        else:
            keys = sorted(
                k for k in self.objects
                if k >= key and (end == b"\x00" or k < end)
            )
        total = len(keys)
        if limit > 0:
            keys = keys[:limit]
        return ([(k, self.objects[k]) for k in keys], total > len(keys), total)

    def stats(self) -> dict:
        return {
            "index": self.index,
            "objects": len(self.objects),
            "watchers": self.watcher_count,
            "events_in": self.events_in,
            "events_delivered": self.events_out,
            "last_revision": self.last_revision,
            "window": len(self.history),
            "backlog": self._backlog,
            "lag_budget_now": self._lag_now,
        }


async def run_upstream(
    cache: WatchCache, client: EtcdClient, prefix: bytes,
    *, primed: asyncio.Event | None = None,
    handle: "UpstreamHandle | None" = None,
    resume_floor: int = 0,
) -> None:
    """The tier's single store watch for ``prefix``: list to prime, then
    watch from the list revision, applying every event to the cache.
    Runs until cancelled; on a broken/canceled stream (or a failed
    prime — the list is retried like the stream, so a store hiccup at
    startup can't kill the task before ``primed`` fires) it relists —
    clients keep their watches, the cache absorbs the resync.

    ``handle`` tracks the live session and progress responses for the
    consistent-read gate (event-less batches on a revision-ordered
    stream are progress notifications).

    Relist pacing comes from the shared RetryPolicies (capped
    exponential backoff + jitter, effectively retrying forever — the
    tier's job is to outlive store outages), reset after every
    successful prime: ``watch.tier`` for the cold prime, the snappier
    ``watch.resume`` once primed (a resume relist races client-visible
    delivery lag, not bootstrap).  The event pump is a faultline hook
    (component ``watch.tier``, op ``upstream.recv``): an injected
    failure breaks the stream exactly like a real one — resume or
    invalidate + relist — so cache consistency under upstream loss is
    reproducible by seed.

    An upstream break does NOT cancel the clients up front: the cache
    keeps serving (the consistent-read progress gate fails while the
    stream is down, so rev=0 reads fall through to the store) while the
    relist runs, and ``reprime`` then replays the net difference to the
    live watches (``invalidate`` only when the diff overflows the
    window).

    ``resume_floor`` is the replica warm-restart knob (the fleet's
    reprime-instead-of-relist story): a relaunched replica primes at
    the current store revision as usual, then opens its upstream watch
    from ``resume_floor + 1`` and CATCH-UP applies the history in
    (floor, prime_rev] — history-window-only, no object-map writes (see
    ``WatchCache.apply``) — before signalling ``primed`` (and with it
    the serving port).  ``prime_revision`` is lowered to the floor only
    once catch-up provably completed (a post-events progress barrier at
    >= the prime revision, or any event beyond it), so ``replayable_from``
    never claims history the broken-mid-catch-up case didn't load.
    Clients of the dead replica then re-attach with their own
    ``start_revision`` and resume from the replayed window
    (``watchcache_resumes_total``) instead of relisting; if the store
    has compacted past the floor, the tier falls back to a cold prime
    and resuming clients get the honest compact-cancel."""
    end = prefix_end(prefix)
    policy = policy_for("watch.tier")
    resume_policy = policy_for("watch.resume")
    failures = 0
    primed_once = False
    warm = 0
    while True:
        try:
            # Paginated prime at a pinned revision: one unpaginated list
            # of a six-figure prefix is a single multi-MB response (the
            # 100K-watch scale run measured 6.3MB — over default client
            # message caps), exactly why every other bootstrap in this
            # framework paginates (native.list_prefix).
            page = await client.range(prefix, end, limit=_PRIME_PAGE)
            rev = page.header.revision
            kvs = list(page.kvs)
            while page.more:
                page = await client.range(
                    page.kvs[-1].key + b"\x00", end,
                    limit=_PRIME_PAGE, revision=rev,
                )
                kvs.extend(page.kvs)
            if primed_once:
                # Events were lost between the broken stream and this
                # relist; resume the clients from the snapshot diff
                # (reprime falls back to invalidate when it can't),
                # scoped to THIS stream's prefix.
                if not cache.reprime(kvs, rev, prefix, end):
                    # Fallback invalidated (clients canceled, this
                    # prefix's objects dropped); the relist in hand IS
                    # the fresh snapshot — load it, or the tier would
                    # serve an empty prefix until the next event.
                    cache.prime(kvs, rev)
            else:
                cache.prime(kvs, rev)
            primed_once = True
            failures = 0
            # Warm restart: catch up (floor, rev] from store history
            # before declaring primed; `warm` holds the prime revision
            # the catch-up must reach (0 = cold / already caught up).
            warm = rev if 0 < resume_floor < rev else 0
            if not warm:
                resume_floor = 0
                if primed is not None:
                    primed.set()
            async with client.watch(
                prefix, end,
                start_revision=(resume_floor if warm else rev) + 1,
            ) as session:
                if session.compact_revision:
                    if warm:
                        # Store compacted past the floor: the history
                        # gap is gone for good.  Fall back to a cold
                        # prime so resuming clients get the honest
                        # compact-cancel instead of a silent gap.
                        log.warning(
                            "warm restart floor %d for %r already "
                            "compacted; cold prime", resume_floor, prefix,
                        )
                        resume_floor = 0
                    continue    # relist: our revision already compacted
                if handle is not None:
                    handle.session = session
                    handle.reset_after_reprime()
                if warm:
                    # Catch-up completion probe: the store orders the
                    # progress response AFTER everything it had already
                    # queued for this watch, so a progress barrier at
                    # >= rev proves the (floor, rev] history is in.
                    # Counted as issued so a later confirm() still
                    # demands a response of its own.
                    if handle is not None:
                        handle.requests_sent += 1
                    await session.request_progress()
                try:
                    while True:
                        batch = await session.next()
                        d = faultline.decide("watch.tier", "upstream.recv")
                        if d is not None:
                            if d.kind == "delay":
                                await asyncio.sleep(d.delay_s)
                            else:
                                # Any failure kind = the upstream stream
                                # is gone.  A latest-only cache cannot
                                # "drop" a batch silently — skipping it
                                # would gap the history window — so every
                                # kind takes the honest path: invalidate,
                                # cancel the clients, relist.
                                raise InjectedFault(d)
                        if batch.canceled:
                            log.warning(
                                "upstream watch for %r canceled by store "
                                "(%s); relisting", prefix,
                                batch.cancel_reason or "no reason",
                            )
                            break   # server-side cancel -> relist
                        for ev in batch.events:
                            cache.apply(
                                1 if ev.type == pb.Event.DELETE else 0,
                                ev.kv.key,
                                ev.kv.value,
                                ev.kv.create_revision,
                                ev.kv.mod_revision,
                                ev.kv.version,
                                catchup=bool(
                                    warm and ev.kv.mod_revision <= warm
                                ),
                            )
                        if batch.events:
                            cache.loadshed_tick()
                        elif handle is not None:
                            handle.note_progress()
                        if warm and (
                            (not batch.events and batch.revision >= warm)
                            or (
                                batch.events
                                and batch.events[-1].kv.mod_revision > warm
                            )
                        ):
                            # Catch-up complete: history now provably
                            # covers (floor, prime_rev], so the replay
                            # window may honestly reach back to the
                            # floor — and the port may open.
                            cache.prime_revision = min(
                                cache.prime_revision, resume_floor
                            )
                            _RESUMES.inc()
                            log.info(
                                "warm restart for %r caught up: history "
                                "resumes from revision %d",
                                prefix, resume_floor + 1,
                            )
                            warm = 0
                            resume_floor = 0
                            if primed is not None:
                                primed.set()
                finally:
                    if handle is not None:
                        handle.session = None
        except asyncio.CancelledError:
            raise
        except Exception as e:
            if warm:
                # The stream broke mid-catch-up: partial (floor, rev]
                # history is already appended, and a second catch-up
                # pass would duplicate it out of order.  Degrade to a
                # cold prime — resuming clients relist, which is the
                # honest fallback, never a silent gap.
                warm = 0
                resume_floor = 0
            failures += 1
            delay = (resume_policy if primed_once else policy).delay_for(
                failures
            )
            log.warning(
                "upstream watch for %r broke (%s); relisting in %.2fs",
                prefix, e, delay, exc_info=True,
            )
            await asyncio.sleep(delay)


class UpstreamHandle:
    """Live view of one prefix's upstream watch stream, for the
    consistent-read progress gate."""

    def __init__(self, prefix: bytes = b"") -> None:
        self.prefix = prefix
        self.session = None          # live WatchSession or None
        self.progress_count = 0      # progress responses received
        self.requests_sent = 0       # progress requests issued
        self._waiters: list[tuple[int, asyncio.Event]] = []
        # Serializes request issuance so concurrent confirms coalesce
        # onto one upstream round trip (see confirm()).
        self._confirm_gate = asyncio.Lock()

    def covers(self, key: bytes, end: bytes) -> bool:
        """True if this stream's prefix contains [key, end) (single key
        when end is empty)."""
        p = self.prefix
        if not key.startswith(p):
            return False
        if not end or end == key:
            return True
        if end == b"\x00":
            return False
        return end <= prefix_end(p)

    def note_progress(self) -> None:
        self.progress_count += 1
        still = []
        for c, e in self._waiters:
            if self.progress_count >= c:
                e.set()
            else:
                still.append((c, e))
        self._waiters = still

    def reset_after_reprime(self) -> None:
        """Stream replaced: requests in flight on the old stream will
        never be answered.  The cache was just re-primed from a fresh
        list, whose revision is at least that of any write committed
        before now — so every pending confirm's guarantee already holds;
        complete them and realign the counters."""
        self.progress_count = self.requests_sent
        for _c, e in self._waiters:
            e.set()
        self._waiters = []

    async def confirm(self, timeout: float) -> bool:
        """Request progress and wait for a response to a request issued
        at-or-after this call began; False if the stream is down/slow.

        Responses are FIFO with requests on the stream, and the store
        computes a response's barrier revision when it READS the request
        — so any response beyond the requests already issued when we
        started proves delivery through everything committed before this
        call.  Counting (not bare "a response arrived") is what stops a
        response to an EARLIER caller's request — whose barrier may
        predate our caller's write — from satisfying us.

        Concurrent confirms COALESCE (Kubernetes batches its
        requestWatchProgress calls the same way): callers queue on a
        gate; whoever holds it issues one request, and every caller that
        arrived before that issuance shares its response.  Any counter
        bump observed after a caller's arrival snapshot happened after
        its arrival, so the shared request's store-side read — which is
        later still — post-dates every write that caller must observe.
        """
        s = self.session
        if s is None:
            return False
        arrival = self.requests_sent
        async with self._confirm_gate:
            s = self.session
            if s is None:
                return False
            if self.requests_sent > arrival:
                # A request was issued after we arrived; piggyback on it.
                target = self.requests_sent
            else:
                target = self.requests_sent + 1
                self.requests_sent = target
                try:
                    await s.request_progress()
                # The swallow is the documented counter rollback below.
                except Exception:  # graftlint: disable=broad-except
                    # The request never reached the store; leaving the
                    # counter bumped would make every later confirm wait
                    # for a response that can't come (until the next
                    # reprime realigns).  BUT if the stream was replaced
                    # while we were sending, reset_after_reprime already
                    # realigned progress_count to the bumped counter —
                    # decrementing now would leave progress_count >
                    # requests_sent and let the NEXT confirm pass with no
                    # barrier from the new stream.  Only roll back when
                    # the failure wasn't a replacement.
                    if self.session is s:
                        self.requests_sent -= 1
                    # graftlint: disable=fallback-counts-or-raises (False IS the accounted signal: the caller's unconfirmed-read fallback resyncs, and that path counts via watchcache_resumes/invalidations)
                    return False
        if self.progress_count >= target:
            return True
        e = asyncio.Event()
        self._waiters.append((target, e))
        try:
            await asyncio.wait_for(e.wait(), timeout)
            return True
        except asyncio.TimeoutError:
            # graftlint: disable=fallback-counts-or-raises (timeout -> False is the confirm() API contract; the caller owns the fallback and its accounting)
            return False


def encode_event_batch(header, watch_id: int, events) -> pb.WatchResponse:
    """One event frame as a codec message: the whole response — header,
    watch id, and every (possibly coalesced) event — in one constructor
    call (the reference encoding the composed frames are held to)."""
    return pb.WatchResponse(
        header=header,
        watch_id=watch_id,
        events=[
            pb.Event(
                type=pb.Event.DELETE if e.type else pb.Event.PUT,
                kv=pb.KeyValue(
                    key=e.key,
                    value=e.value,
                    create_revision=e.create_revision,
                    mod_revision=e.mod_revision,
                    version=e.version,
                ),
            )
            for e in events
        ],
    )


class _PumpShard:
    """One fan-out pump lane of a Watch stream: watchers hash onto a
    lane by watch key (peers of one object share a lane, and with it a
    sweep — see ``sweep`` in Watch), and each lane services its
    ready-set sequentially.  The
    lane count bounds the task cost of a 100K-watch stream (N tasks,
    not 100K), and the bounded output queue means a wedged subscriber
    socket backpressures its own lane instead of head-of-line-blocking
    the whole tier."""

    def __init__(self) -> None:
        # Bounded by construction: each watcher latches onto the ready
        # set at most once (the _ready flag), so depth <= the lane's
        # member count.
        self.ready: collections.deque[Downstream] = collections.deque()  # graftlint: disable=bounded-watch-buffer (ready-set: the _ready latch admits each watcher at most once)
        self.event = asyncio.Event()

    def mark_ready(self, w: Downstream) -> None:
        if not w._ready:
            w._ready = True
            self.ready.append(w)
        self.event.set()


class WatchCacheService:
    """etcd wire services served from the cache tier."""

    def __init__(
        self, cache: WatchCache, upstream: EtcdClient,
        handles: list[UpstreamHandle] | None = None,
        n_pumps: int = _PUMP_SHARDS,
    ):
        self.cache = cache
        self.upstream = upstream
        self.handles = handles or []
        self.n_pumps = max(1, n_pumps)
        # Tier-level shared frame table: one encode per applied event
        # (keyed by CacheEvent.seq) no matter how many streams, lanes,
        # or watch ids fan it out.
        self.frames = wiretier.FrameTable()

    async def _confirm_progress(
        self, key: bytes, end: bytes, timeout: float = 5.0
    ) -> bool:
        """Confirm freshness for the ONE stream whose prefix covers the
        requested range (an unrelated prefix's reconnect must not force
        every read to the store); False -> serve from upstream.
        Concurrent confirms coalesce onto a shared progress round trip
        inside UpstreamHandle.confirm (as Kubernetes batches its
        requestWatchProgress calls).
        """
        for h in self.handles:
            if h.covers(key, end):
                return await h.confirm(timeout)
        return False    # range not covered by any watched prefix

    def _header(self) -> pb.ResponseHeader:
        return self._header_at(self.cache.last_revision)

    def _header_at(self, rev: int) -> pb.ResponseHeader:
        return pb.ResponseHeader(
            cluster_id=1, member_id=2, revision=rev, raft_term=1,
        )

    # ---- KV.Range: served from the cache -------------------------------

    async def Range(self, req: pb.RangeRequest, ctx):
        """A RangeResponse: the composed bytes when the cache serves it,
        the upstream's message when the store does."""
        if req.revision > 0:
            # A latest-only cache cannot serve an arbitrary MVCC snapshot
            # — EXCEPT when the pinned revision is exactly the cache's
            # current revision, the common case for pages 2+ of a
            # paginated list that pinned page 1's header revision on a
            # quiet prefix.  After a successful progress confirm, every
            # write committed before this read is in the cache; if
            # last_revision still equals the pin, none of those writes
            # exceeded it, so latest-state IS the state at that revision.
            # Churn (last_revision moved past the pin) falls through to
            # the store, which owns true time travel.
            if (
                req.revision == self.cache.last_revision
                and await self._confirm_progress(req.key, req.range_end)
                and req.revision == self.cache.last_revision
            ):
                return self._range_from_cache(req, req.revision)
            return await self.upstream._range(req)
        # Consistent read from cache: rev=0 on the etcd wire is
        # linearizable, so a client that just wrote through the tier must
        # see its write.  The gate is WATCH PROGRESS, exactly Kubernetes'
        # consistent-watch-cache-reads protocol (and the reason the
        # reference's store must advertise etcd >= 3.5.13,
        # maintenance_service.rs:56): request a progress notification on
        # every upstream watch stream and serve only after each stream
        # has delivered one issued AFTER this read arrived — the streams
        # are revision-ordered, so the cache then holds every write that
        # committed before the read, per watched prefix, without a
        # global-revision comparison (which a prefix-scoped cache could
        # never satisfy).  Falls through to the store if a stream is
        # reconnecting or too far behind.
        if not await self._confirm_progress(req.key, req.range_end):
            return await self.upstream._range(req)
        return self._range_from_cache(req, self.cache.last_revision)

    def _range_from_cache(self, req: pb.RangeRequest, header_rev: int) -> bytes:
        """The RangeResponse's bytes over the cached objects, composed
        without a message per object (a relist through the tier is one row
        per node)."""
        kvs, more, count = self.cache.range(req.key, req.range_end, req.limit)
        return range_response_bytes(
            self._header_at(header_rev),
            [] if req.count_only else [
                _KV(k, o.create_revision, o.mod_revision, o.version,
                    b"" if req.keys_only else o.value)
                for k, o in kvs
            ],
            more, count,
        )

    # ---- Watch: the fan-out --------------------------------------------

    async def Watch(self, request_iterator, ctx):
        cache = self.cache
        watchers: dict[int, Downstream] = {}
        # Bounded output queue: the backpressure point for a wedged
        # subscriber socket (see _PumpShard).
        out: asyncio.Queue = asyncio.Queue(maxsize=_OUT_CAP)
        next_id = 1
        # Delivered-through revisions + barrier tasks: progress responses
        # are ordered after prior events, same contract as the store
        # server (see etcd_server.py Watch).
        cleared: dict[int, int] = {}
        barriers: set = set()
        shards = [_PumpShard() for _ in range(self.n_pumps)]

        async def cancel_watch(w: Downstream, reason: str) -> None:
            wid = w.service_id
            if watchers.get(wid) is not w:
                return      # a cancel_request already unregistered it
            cache.unregister(w)
            watchers.pop(wid, None)
            await out.put(
                pb.WatchResponse(
                    header=self._header(),
                    watch_id=wid,
                    canceled=True,
                    cancel_reason=reason,
                )
            )

        async def sweep(shard: _PumpShard) -> None:
            """One pass over the lane's ready set: pop at most one
            batch per watcher, group watchers owing IDENTICAL batches
            (equal event-seq tuples), then compose each group's frame
            ONCE from the shared frame table and fan the bytes — the
            wiretier's shared-frame encoding.  A batch drained from a
            coalesce map is a compacted [from_rev, to_rev] window and
            says so on the wire (the shared-from extension).  Watchers
            with remainder re-latch onto the ready set, so per-watcher
            delivery order is a property of sweep ordering, not of
            grouping."""
            # group key -> [wids, events, from_rev, emptied (wid, r0)]
            groups: dict[tuple, list] = {}
            cancels: list[Downstream] = []
            for _ in range(len(shard.ready)):
                w = shard.ready.popleft()
                w._ready = False
                wid = w.service_id
                if watchers.get(wid) is not w:
                    continue    # canceled while queued
                if w.overflowed:
                    cancels.append(w)
                    continue
                r0 = cache.last_revision
                if not (w.queue or w.coalesced):
                    # Queue observed empty at r0 (snapshot taken before
                    # the check, no await between) and nothing popped
                    # earlier this sweep is pending for it (a pop
                    # re-latches or empties the queue): delivered
                    # through r0.
                    if cleared.get(wid, 0) < r0:
                        cleared[wid] = r0
                    continue
                evs = w.pop_batch(_WATCH_BATCH)
                compacted = w.last_pop_compacted
                # Subscriber-wedge fault hook: delay kinds stall this
                # lane's delivery; any failure kind means the
                # subscriber's socket is gone — cancel it (the client
                # relists, which covers the popped batch) rather than
                # let one wedged socket hold the lane.
                d = faultline.decide("watch.tier", "subscriber.send")
                if d is not None:
                    if d.kind in ("delay", "slow_cycle"):
                        await asyncio.sleep(d.delay_s)
                    else:
                        w.overflowed = True
                        cancels.append(w)
                        continue
                gk = tuple(e.seq for e in evs)
                if 0 in gk:
                    # Unstamped events (unit-test pushes) have no
                    # identity; never share their frame.
                    gk = (-wid,) + gk
                g = groups.get(gk)
                if g is None:
                    groups[gk] = g = [[wid], evs, 0, []]
                else:
                    g[0].append(wid)
                if compacted:
                    fr = cleared.get(wid, 0) + 1
                    if fr > 1 and (g[2] == 0 or fr < g[2]):
                        g[2] = fr
                if w.queue or w.coalesced:
                    shard.mark_ready(w)
                else:
                    g[3].append((wid, r0))
            # Flush: one composed frame per group.  cleared[] advances
            # only AFTER a group's frame is queued, so a progress
            # barrier can never overtake undelivered events (the
            # progress-after-events contract the consistent-read gate
            # rides).
            if groups:
                hb = wiretier.header_bytes(self._header())
                for wids, evs, from_rev, emptied in groups.values():
                    chunks = [
                        self.frames.bytes_for(e.seq, wiretier.encode_event, e)
                        for e in evs
                    ]
                    await out.put(
                        wiretier.compose_frame(
                            hb, wids, chunks, from_rev=from_rev
                        )
                    )
                    last = evs[-1].mod_revision
                    for wid in wids:
                        if cleared.get(wid, 0) < last:
                            cleared[wid] = last
                    for wid, r0 in emptied:
                        if cleared.get(wid, 0) < r0:
                            cleared[wid] = r0
            # Cancels flush after frames: a watcher popped-then-
            # overflowed this sweep must not see its cancel overtake
            # bytes already owed to its group.
            for w in cancels:
                await cancel_watch(w, "watcher overflowed; events dropped")

        async def pump_shard(shard: _PumpShard):
            try:
                while True:
                    await shard.event.wait()
                    shard.event.clear()
                    # Pump-stall fault hook: every firing kind
                    # expresses as a bounded stall of this lane — the
                    # pump never dies, it lags (and the lag shows up in
                    # the drill's delivery p99, never as loss).
                    d = faultline.decide("watch.tier", "pump.stall")
                    if d is not None:
                        await asyncio.sleep(d.delay_s or _STALL_S)
                    while shard.ready:
                        await sweep(shard)
            except asyncio.CancelledError:
                raise

        pumps = [
            asyncio.create_task(pump_shard(shard)) for shard in shards
        ]

        async def reader():
            nonlocal next_id
            async for req in request_iterator:
                which = req.which_oneof("request_union")
                if which == "create_request":
                    cr = req.create_request
                    wid = cr.watch_id or next_id
                    next_id = max(next_id, wid) + 1
                    if wid in watchers:
                        # Reject like the store server: silently replacing
                        # would leak the old Downstream (still registered
                        # and fed) and leave its pump emitting under the
                        # same id.
                        await out.put(
                            pb.WatchResponse(
                                header=self._header(),
                                watch_id=wid,
                                canceled=True,
                                cancel_reason="duplicate watch_id",
                            )
                        )
                        continue
                    end = cr.range_end if cr.range_end else None
                    w = cache.register(cr.key, end, min_rev=cr.start_revision)
                    compact = cache.replay(w, cr.start_revision)
                    if compact is not None:
                        cache.unregister(w)
                        await out.put(
                            pb.WatchResponse(
                                header=self._header(),
                                watch_id=wid,
                                created=True,
                                canceled=True,
                                compact_revision=compact,
                            )
                        )
                        continue
                    watchers[wid] = w
                    w.service_id = wid
                    # Lanes hash on the WATCH KEY, not the id: peers
                    # watching the same object land in the same sweep,
                    # which is what lets them share one frame (their
                    # owed batches are identical whenever their lag
                    # states are).  Balance is unchanged for the many-
                    # keys population lanes exist to spread.
                    shard = shards[zlib.crc32(w.key) % len(shards)]
                    w.on_ready = shard.mark_ready
                    # Owes nothing below the registration point unless a
                    # replay queued history to deliver first.
                    if not w.backlog:
                        cleared[wid] = cache.last_revision
                    await out.put(
                        pb.WatchResponse(
                            header=self._header(), watch_id=wid, created=True
                        )
                    )
                    if w.backlog or w.overflowed:
                        shard.mark_ready(w)
                elif which == "cancel_request":
                    wid = req.cancel_request.watch_id
                    w = watchers.pop(wid, None)
                    if w is not None:
                        cache.unregister(w)
                        await out.put(
                            pb.WatchResponse(
                                header=self._header(),
                                watch_id=wid,
                                canceled=True,
                            )
                        )
                elif which == "progress_request":
                    rev = cache.last_revision
                    t = asyncio.create_task(
                        progress_barrier(rev, list(watchers))
                    )
                    barriers.add(t)
                    t.add_done_callback(barriers.discard)
            await out.put(None)

        async def progress_barrier(rev: int, wids: list[int]) -> None:
            while True:
                pending = [
                    wid for wid in wids
                    if wid in watchers and cleared.get(wid, 0) < rev
                ]
                if not pending:
                    break
                # Idle watchers sit off the ready sets; nudge them so an
                # event-less watch still advances its delivered-through
                # point at its pump lane.
                for wid in pending:
                    watchers[wid]._notify()
                await asyncio.sleep(0.002)
            await out.put(
                pb.WatchResponse(
                    header=self._header_at(rev), watch_id=-1
                )
            )

        rtask = asyncio.create_task(reader())
        try:
            while True:
                resp = await out.get()
                if resp is None:
                    return
                yield resp
        finally:
            rtask.cancel()
            for task in pumps:
                task.cancel()
            for task in list(barriers):
                task.cancel()
            for w in watchers.values():
                cache.unregister(w)

    # ---- writes: proxied to the store ----------------------------------
    # The apiserver role: reads/watches served from the cache, every
    # mutation forwarded to the datastore (one connection, not one per
    # client).  With these, a client points ONLY at the tier and gets the
    # full wire — which is what lets a whole kwok/coordinator stack sit
    # behind it, the reference's apiserver-in-the-middle topology.

    async def Put(self, req: pb.PutRequest, ctx) -> pb.PutResponse:
        return await self.upstream._put(req)

    async def DeleteRange(
        self, req: pb.DeleteRangeRequest, ctx
    ) -> pb.DeleteRangeResponse:
        return await self.upstream._delete(req)

    async def Txn(self, req: pb.TxnRequest, ctx) -> pb.TxnResponse:
        return await self.upstream._txn(req)

    async def Compact(
        self, req: pb.CompactionRequest, ctx
    ) -> pb.CompactionResponse:
        return await self.upstream._compact(req)

    async def LeaseGrant(
        self, req: pb.LeaseGrantRequest, ctx
    ) -> pb.LeaseGrantResponse:
        return await self.upstream._lease_grant(req)

    async def LeaseRevoke(
        self, req: pb.LeaseRevokeRequest, ctx
    ) -> pb.LeaseRevokeResponse:
        return await self.upstream._lease_revoke(req)

    async def PutFrame(self, req, ctx):
        return await self.upstream._put_frame(req)

    async def BindFrame(self, req, ctx):
        return await self.upstream._bind_frame(req)

    # ---- Maintenance.Status --------------------------------------------

    async def Status(self, req: pb.StatusRequest, ctx):
        return pb.StatusResponse(
            header=self._header(), version="3.5.16", leader=1,
            raftIndex=1, raftTerm=1,
        )


@dataclasses.dataclass
class WatchCacheTier:
    """Handle to a running tier; ``close()`` tears everything down
    including the upstream channel (one watch stream per prefix).
    ``prime_s`` is the seconds from the start of the upstream tasks to
    every prefix primed (and warm catch-up done), before the port bound."""

    server: wire_server.Server
    port: int
    cache: WatchCache
    tasks: list
    upstream: EtcdClient
    svc: "WatchCacheService | None" = None
    prime_s: float = 0.0

    async def close(self) -> None:
        for t in self.tasks:
            t.cancel()
        for t in self.tasks:
            try:
                await t
            # Awaiting a canceled pump; teardown continues regardless.
            except (asyncio.CancelledError, Exception):  # graftlint: disable=broad-except
                pass
        await self.upstream.close()
        await self.server.stop()


# Every response goes out through one serializer: handlers return codec
# messages, and cache-served Ranges and the watch event frames composed
# bytes.
_serialize = wiretier.serialize_frame_or_message


def _unary(fn, req_cls):
    return wire_server.unary_unary_rpc_method_handler(fn, req_cls.decode, _serialize)


async def serve_watch_cache(
    upstream_target: str,
    prefixes: list[bytes],
    port: int = 2381,
    host: str = "127.0.0.1",
    index: str = "hash",
    window: int = _DEFAULT_WINDOW,
    tls=None,
    auth_token: str | None = None,
    lag_budget: int = _LAG_BUDGET,
    pumps: int = _PUMP_SHARDS,
    resume_floor: int = 0,
) -> WatchCacheTier:
    """Start the tier: one upstream watch per prefix, etcd wire served on
    ``port``.

    ``tls`` (a cluster.certs.CertPaths) serves the wire over TLS with
    the rig chain; ``auth_token`` additionally requires a bearer token
    on every RPC — together the client-facing posture of the apiserver
    the tier stands in for (the reference's k3s serves TLS and
    authenticates clients; its plaintext side faces only mem_etcd)."""
    cache = WatchCache(index=index, window=window, lag_budget=lag_budget)
    upstream = EtcdClient(upstream_target)
    handles = [UpstreamHandle(p) for p in prefixes]
    svc = WatchCacheService(cache, upstream, handles, n_pumps=pumps)
    # The receive and send caps and the stream limit are wire_server's
    # constants: the JAX tier's grpc.aio options.
    server = wire_server.Server(bearer_token=auth_token)
    server.add_generic_rpc_handlers((
        ("etcdserverpb.KV", {
            "Range": _unary(svc.Range, pb.RangeRequest),
            "Put": _unary(svc.Put, pb.PutRequest),
            "DeleteRange": _unary(svc.DeleteRange, pb.DeleteRangeRequest),
            "Txn": _unary(svc.Txn, pb.TxnRequest),
            "Compact": _unary(svc.Compact, pb.CompactionRequest),
        }),
        ("etcdserverpb.Lease", {
            "LeaseGrant": _unary(svc.LeaseGrant, pb.LeaseGrantRequest),
            "LeaseRevoke": _unary(svc.LeaseRevoke, pb.LeaseRevokeRequest),
        }),
        ("k8s1m.BatchKV", {
            "PutFrame": _unary(svc.PutFrame, pb.PutFrameRequest),
            "BindFrame": _unary(svc.BindFrame, pb.BindFrameRequest),
        }),
        ("etcdserverpb.Watch", {
            # Event frames leave the pumps pre-composed (wiretier
            # shared-frame bytes); control responses stay messages.
            "Watch": wire_server.stream_stream_rpc_method_handler(
                svc.Watch, pb.WatchRequest.decode, _serialize),
        }),
        ("etcdserverpb.Maintenance", {
            "Status": _unary(svc.Status, pb.StatusRequest),
        }),
    ))
    # Prime BEFORE binding the port: a bound-but-unprimed tier would let
    # early clients read an empty cache (prime() loads objects without
    # dispatching events, so a pre-prime watcher would silently miss all
    # existing state).  Port readiness == cache readiness.
    t0 = time.perf_counter()
    primed_events = [asyncio.Event() for _ in prefixes]
    tasks = [
        asyncio.create_task(run_upstream(
            cache, upstream, p, primed=e, handle=h,
            resume_floor=resume_floor,
        ))
        for p, e, h in zip(prefixes, primed_events, handles)
    ]
    try:
        for e in primed_events:
            await e.wait()
        prime_s = time.perf_counter() - t0
        if tls is not None:
            bound = server.add_secure_port(
                f"{host}:{port}",
                wire_server.server_ssl_context(tls.cert_pem, tls.key_pem),
            )
        else:
            bound = server.add_insecure_port(f"{host}:{port}")
        if bound == 0:
            raise OSError(f"failed to bind {host}:{port}")
        await server.start()
    except BaseException:
        # Don't orphan the live upstream watch streams on a failed bind.
        for t in tasks:
            t.cancel()
        for t in tasks:
            try:
                await t
            # Awaiting a canceled pump; teardown continues regardless.
            except (asyncio.CancelledError, Exception):  # graftlint: disable=broad-except
                pass
        await upstream.close()
        raise
    return WatchCacheTier(server, bound, cache, tasks, upstream, svc, prime_s)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def tier_subprocess(upstream: str, *extra_args: str, stderr=subprocess.DEVNULL,
                    timeout_s: float = 120.0):
    """Run the tier in a child process (``python -m
    k8s1m_tpu_torch.store.watch_cache --upstream <upstream>``) on a free port
    of 127.0.0.1, with ``extra_args`` appended (``"--tls-cert", path``, ...);
    yields ``(process, "127.0.0.1:port")``.  The port binds only once the
    cache is primed, so the first connect that succeeds is the ready
    signal; a tier that is not ready within ``timeout_s`` (priming scales
    with the prefix) or exits first fails the caller.  On every exit path
    the child is terminated (killed if it lingers) and reaped.  ``stderr``
    takes the tier's log (its ready line says how long the prime took)."""
    from k8s1m_tpu_torch.store.server_main import child_env

    root, env = child_env()
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "k8s1m_tpu_torch.store.watch_cache", "--upstream", upstream,
         "--host", "127.0.0.1", "--port", str(port), *extra_args],
        stdout=subprocess.DEVNULL, stderr=stderr, env=env, cwd=root)
    try:
        deadline = time.monotonic() + timeout_s
        while True:
            if proc.poll() is not None:
                raise RuntimeError(f"watch-cache tier exited with code {proc.returncode} "
                                   "before it served")
            try:
                socket.create_connection(("127.0.0.1", port), timeout=1.0).close()
                break
            except OSError:
                if time.monotonic() > deadline:
                    raise RuntimeError(f"watch-cache tier not serving on :{port} "
                                       f"after {timeout_s:.0f} s") from None
                time.sleep(0.05)
        yield proc, f"127.0.0.1:{port}"
    finally:
        if proc.poll() is None:
            proc.terminate()
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="watch-cache fan-out tier")
    ap.add_argument("--upstream", default="127.0.0.1:2379")
    ap.add_argument("--port", type=int, default=2381)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--prefix", action="append", default=None,
                    help="watched prefix (repeatable; default /registry/)")
    ap.add_argument("--index", choices=("hash", "btree"), default="hash",
                    help="cache storage structure (the reference's "
                         "BtreeWatchCache experiment axis)")
    ap.add_argument("--window", type=int, default=_DEFAULT_WINDOW)
    ap.add_argument("--lag-budget", type=int, default=_LAG_BUDGET,
                    help="per-subscriber FIFO depth before latest-only "
                    "coalescing engages (the loadshed controller "
                    "shrinks it under backlog)")
    ap.add_argument("--pumps", type=int, default=_PUMP_SHARDS,
                    help="fan-out pump lanes per Watch stream")
    ap.add_argument("--resume-floor", type=int, default=0,
                    help="replica warm restart: catch the history "
                    "window up from this store revision before serving "
                    "so the dead replica's clients resume from "
                    "revision instead of relisting")
    ap.add_argument("--metrics-port", type=int, default=0)
    ap.add_argument("--tls-cert", default=None,
                    help="serve TLS: path to the server cert PEM")
    ap.add_argument("--tls-key", default=None,
                    help="serve TLS: path to the server key PEM")
    ap.add_argument("--auth-token", default=None,
                    help="require 'authorization: Bearer <token>' on "
                    "every RPC (the apiserver client-auth role)")
    ap.add_argument("--fault-plan", default=None,
                    help="faultline plan: inline JSON or @path "
                    "(k8s1m_tpu_torch/faultline; also honors K8S1M_FAULT_PLAN)")
    args = ap.parse_args(argv)
    if args.fault_plan:
        faultline.install_plan(faultline.FaultPlan.from_arg(args.fault_plan))
    prefixes = [p.encode() for p in (args.prefix or ["/registry/"])]
    tls = None
    if bool(args.tls_cert) != bool(args.tls_key):
        ap.error("--tls-cert and --tls-key must be passed together")
    if args.tls_cert:
        from k8s1m_tpu_torch.cluster.certs import CertPaths

        tls = CertPaths(ca_pem="", cert_pem=args.tls_cert,
                        key_pem=args.tls_key)

    async def run():
        tier = await serve_watch_cache(
            args.upstream, prefixes, port=args.port, host=args.host,
            index=args.index, window=args.window,
            tls=tls, auth_token=args.auth_token,
            lag_budget=args.lag_budget, pumps=args.pumps,
            resume_floor=args.resume_floor,
        )
        if args.metrics_port:
            from k8s1m_tpu_torch.obs.http import start_metrics_server

            start_metrics_server(args.metrics_port)
        logging.basicConfig(level=logging.INFO)
        log.info(
            "watch cache serving on :%d (upstream %s, index=%s, prefixes=%s, "
            "tls=%s, auth=%s): primed %d objects at revision %d in %.3f s",
            tier.port, args.upstream, args.index,
            [p.decode() for p in prefixes], tls is not None,
            args.auth_token is not None, len(tier.cache.objects),
            tier.cache.prime_revision, tier.prime_s,
        )
        try:
            await tier.server.wait_for_termination()
        finally:
            await tier.close()

    asyncio.run(run())


if __name__ == "__main__":
    main()
