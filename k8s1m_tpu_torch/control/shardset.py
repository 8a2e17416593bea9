"""Scheduler shard set: N coordinators splitting the pod stream and the
node space, with leader-driven rebalancing.

The port's own copy of ``k8s1m_tpu/control/shardset.py``: host code only
(numpy and the store), driving the port's coordinators, whose waves run on
the card.

The reference scales host-side by running up to 256 dist-scheduler
replicas: pods are routed to a replica by an FNV-32 hash of ``ns/name``
(reference pkg/schedulerset/schedulerset.go:130-143) and the elected
leader continuously rebalances ``dist-scheduler.dev/scheduler`` node
labels so every replica owns an even slice of the node space, minimizing
moves and patching nodes 1,000 at a time (reference
cmd/dist-scheduler/leader_activities.go:227-343).

The re-expression keeps both partitions but changes their mechanics:

- **Pod intake partition** — each shard's coordinator installs an
  ``intake_filter`` so only pods with ``fnv32(ns/name) % num_shards ==
  shard_idx`` enter its queue.  Other shards' pods are still observed
  (their binds feed external accounting, so constraint counts and node
  usage stay globally correct in every shard).
- **Node-space partition as a mask, not a partition of memory** — every
  shard holds the FULL node table on its device; ownership is a bool[N]
  ``row_mask`` ANDed into candidate selection (``engine/cycle.py::
  mask_rows``).  Nodes hash into ``NUM_GROUPS`` stable groups and the
  shared store holds one small group->shard assignment object; "moving a
  node" is a CAS on that object followed by every member flipping mask
  bits — no 1,000-way node patch storm, no table data movement (the mask
  is one bool tensor the wave reads).
- **Rebalancer** — the leader (``control/leader.py`` election) recomputes
  the assignment from live group populations and member heartbeats:
  groups on dead shards are reassigned first, then groups move from the
  most- to the least-loaded shard while the imbalance shrinks, capped per
  round (move minimization + batching, with a minimum interval between
  rounds like the reference's 30 s).

Under a stable assignment the masks are disjoint, so two shards never
pick the same node for conflicting pods.  Across a rebalance the handoff
is drop-before-claim: a member applies lost groups to its mask the tick
it observes the new version, but defers *gained* groups by one tick — by
then the donor (draining the same watch on its own tick cadence) has
dropped them, so the dual-ownership window collapses to donor-lag, the
same exposure the reference has between a node-label patch and the other
replica's informer observing it (leader_activities.go's merge-patches vs
informer caches).  The CAS bind path still guards pod-object races
either way.  A pod whose feasible nodes all live in another shard's
slice retries and reports unschedulable exactly as in the reference's
design (a replica only sees its own label slice, README.adoc:525-531).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import time

import numpy as np

from k8s1m_tpu_torch import faultline
from k8s1m_tpu_torch.control.coordinator import Coordinator
from k8s1m_tpu_torch.faultline import GiveUp, policy_for
from k8s1m_tpu_torch.lint import THREAD_OWNER, guarded_by
from k8s1m_tpu_torch.obs.metrics import Counter, Gauge
from k8s1m_tpu_torch.store.native import drain_events_light, prefix_end

log = logging.getLogger("k8s1m.shardset")

# Node groups: the unit of ownership transfer.  256 matches the
# reference's replica ceiling (256 shards, README.adoc:730) while keeping
# the assignment object a few KB.
NUM_GROUPS = 256

ASSIGN_KEY = b"/registry/k8s1m/scheduler-set/assignment"
STATUS_PREFIX = b"/registry/k8s1m/scheduler-set/status/"

_REBALANCES = Counter(
    "shardset_rebalances_total", "Assignment rewrites by the leader", ()
)
_GROUP_MOVES = Counter(
    "shardset_group_moves_total", "Node groups moved between shards", ()
)
_MASK_REFRESH = Counter(
    "shardset_mask_refreshes_total", "Ownership mask rebuilds", ("shard",)
)
_OWNED_NODES = Gauge(
    "shardset_owned_nodes", "Nodes owned by this shard", ("shard",)
)


def fnv32(s: str) -> int:
    """FNV-1a 32-bit — the reference's pod->shard hash
    (schedulerset.go:130-143 uses FNV over ``ns/name``)."""
    h = 0x811C9DC5
    for b in s.encode():
        h ^= b
        h = (h * 0x01000193) & 0xFFFFFFFF
    return h


def pod_shard(pod_key: str, num_shards: int) -> int:
    """Shard index for a pod ``ns/name`` key."""
    return fnv32(pod_key) % num_shards


def group_of(node_name: str) -> int:
    """Stable node->group hash (process-independent)."""
    # Salted so a node name and a same-named pod key don't correlate.
    return fnv32("g:" + node_name) % NUM_GROUPS


def groups_of(node_names) -> np.ndarray:
    """``group_of`` of every name, as int32: FNV-1a in numpy, one byte
    column at a time over the names of each length (``uint32`` products
    wrap mod 2**32, as ``fnv32`` masks them).  A member's first mask at
    1,048,576 nodes folds every row; name by name that is seconds of
    Python."""
    encoded = [("g:" + n).encode() for n in node_names]
    lengths = np.fromiter(map(len, encoded), np.int64, len(encoded))
    h = np.full(len(encoded), 0x811C9DC5, np.uint32)
    for n in np.unique(lengths):
        at = np.flatnonzero(lengths == n)
        cols = np.frombuffer(b"".join(encoded[i] for i in at), np.uint8).reshape(len(at), n)
        part = h[at]
        for c in range(n):
            part ^= cols[:, c]
            part *= np.uint32(0x01000193)
        h[at] = part
    return (h % NUM_GROUPS).astype(np.int32)


@dataclasses.dataclass
class Assignment:
    """The group->shard map, one small CAS-guarded store object."""

    version: int
    num_shards: int
    groups: list[int]               # len NUM_GROUPS, values in [0, num_shards)
    mod_revision: int = 0           # store CAS handle (0 = not persisted)

    def encode(self) -> bytes:
        return json.dumps(
            {
                "version": self.version,
                "numShards": self.num_shards,
                "groups": self.groups,
            }
        ).encode()

    @classmethod
    def decode(cls, data: bytes, mod_revision: int = 0) -> "Assignment":
        obj = json.loads(data)
        groups = [int(g) for g in obj["groups"]]
        if len(groups) != NUM_GROUPS:
            raise ValueError(
                f"assignment has {len(groups)} groups, expected {NUM_GROUPS}"
            )
        return cls(
            version=int(obj["version"]),
            num_shards=int(obj["numShards"]),
            groups=groups,
            mod_revision=mod_revision,
        )


def load_assignment(store) -> Assignment | None:
    kv = store.get(ASSIGN_KEY)
    if kv is None:
        return None
    return Assignment.decode(kv.value, kv.mod_revision)


def init_assignment(store, num_shards: int) -> Assignment:
    """Create the round-robin initial assignment if absent (CAS on
    version=0 so concurrent initializers converge on one winner)."""
    cur = load_assignment(store)
    if cur is not None:
        return cur
    a = Assignment(1, num_shards, [g % num_shards for g in range(NUM_GROUPS)])
    ok, _, _ = store.cas(ASSIGN_KEY, a.encode(), required_version=0)
    if not ok:
        return load_assignment(store)
    return load_assignment(store)


def rebalance_groups(
    groups: list[int],
    group_load: np.ndarray,
    alive: set[int],
    max_moves: int = 32,
) -> list[int]:
    """Move-minimizing rebalance (reference leader_activities.go:227-343
    semantics: even split, fewest moves, batched).

    ``group_load[g]`` = nodes currently hashed into group g.  Groups on
    dead shards are reassigned first (failure recovery); then the
    heaviest shard donates its lightest groups to the lightest shard
    while that strictly shrinks the spread.  Returns a NEW groups list
    (possibly identical).
    """
    if not alive:
        return list(groups)
    groups = list(groups)
    load = {s: 0 for s in alive}
    for g, s in enumerate(groups):
        if s in load:
            load[s] += int(group_load[g])
    moves = 0

    # Dead-shard evacuation (unconditional — correctness, not balance).
    for g, s in enumerate(groups):
        if s not in alive:
            tgt = min(load, key=load.get)
            groups[g] = tgt
            load[tgt] += int(group_load[g])
            moves += 1

    while moves < max_moves and len(load) > 1:
        hi = max(load, key=load.get)
        lo = min(load, key=load.get)
        spread = load[hi] - load[lo]
        if spread <= 0:
            break
        # The lightest non-empty group on the heaviest shard that still
        # shrinks the spread when moved.
        best, best_w = -1, None
        for g, s in enumerate(groups):
            if s != hi:
                continue
            w = int(group_load[g])
            if w == 0:
                continue
            if w < spread and (best_w is None or w < best_w):
                best, best_w = g, w
        if best < 0:
            break
        groups[best] = lo
        load[hi] -= best_w
        load[lo] += best_w
        moves += 1
    return groups


@guarded_by(
    # Mask state is tick-thread-confined: the ownership set, the
    # deferred-claim set (drop-before-claim correctness depends on their
    # relative order) and the row->group journal fold all belong to the
    # thread driving tick() — audited, not assumed (lint/guards.py).
    _claimed=THREAD_OWNER,
    _pending_claim=THREAD_OWNER,
    _row_group=THREAD_OWNER,
    assignment=THREAD_OWNER,
)
class ShardMember:
    """One shard: a Coordinator plus intake filter, ownership mask
    upkeep, and a status heartbeat.

    Tick-driven like everything else in the control plane: call
    ``tick(now)`` per cycle; it drains the assignment watch, refreshes
    the mask when the assignment version or the host table's row mapping
    moved, heartbeats, and runs one coordinator step.
    """

    def __init__(
        self,
        store,
        coordinator: Coordinator,
        shard_idx: int,
        num_shards: int,
        *,
        heartbeat_every: float = 2.0,
    ):
        if not 0 <= shard_idx < num_shards:
            raise ValueError(f"shard_idx {shard_idx} not in [0, {num_shards})")
        self.store = store
        self.coordinator = coordinator
        self.shard_idx = shard_idx
        self.num_shards = num_shards
        self.heartbeat_every = heartbeat_every
        coordinator.intake_filter = (
            lambda key: pod_shard(key, num_shards) == shard_idx
        )
        self.assignment: Assignment | None = None
        self._assign_watch = None
        # Incremental mask state: row->group (journal-maintained, -1 =
        # empty row), the set of groups currently claimed, and groups
        # assigned to us whose claim is deferred one tick
        # (drop-before-claim, module doc).
        self._row_group = np.full(
            (coordinator.table_spec.max_nodes,), -1, np.int32
        )
        self._journal = coordinator.host.enable_row_journal()
        # Rows that predate the journal (already-bootstrapped coordinator).
        row_of = coordinator.host._row_of
        self._row_group[np.fromiter(row_of.values(), np.int64, len(row_of))] = groups_of(row_of)
        self._claimed: set[int] = set()
        self._pending_claim: set[int] = set()
        self._mask_version = -1
        self._last_beat = 0.0
        self._status_rev = 0

    # ---- lifecycle -----------------------------------------------------

    def start(self, now: float) -> None:
        """``now`` must come from the same clock every later ``tick``
        uses (simulated or wall — never mixed; the rebalancer compares
        heartbeat times against its own ``now``)."""
        self.coordinator.bootstrap()
        self.assignment = init_assignment(self.store, self.num_shards)
        self._assign_watch = self.store.watch(
            ASSIGN_KEY, start_revision=self.assignment.mod_revision + 1
        )
        # First claim is immediate: a member starting up owns whatever
        # the current assignment says (there is no donor mid-handoff).
        self._claimed = {
            g for g, s in enumerate(self.assignment.groups)
            if s == self.shard_idx
        }
        self._mask_version = self.assignment.version
        self._refresh_mask(force=True)
        self.heartbeat(now)

    def close(self) -> None:
        if self._assign_watch is not None:
            self._assign_watch.cancel()
            self._assign_watch = None
        self.coordinator.close()

    # ---- mask upkeep ---------------------------------------------------

    def _drain_assignment(self) -> None:
        try:
            for etype, _key, value, mrev in drain_events_light(
                self._assign_watch
            ):
                if etype != 0:
                    continue
                try:
                    self.assignment = Assignment.decode(value, mrev)
                except Exception:
                    log.exception(
                        "undecodable shard assignment; keeping current"
                    )
        except Exception:
            # Watch lost (store restart / overflow): re-read + re-watch —
            # the assignment object is tiny, resync is one get.
            log.info("assignment watch lost; resyncing", exc_info=True)
            try:
                self._assign_watch.cancel()
            # Canceling an already-broken watch may itself fail; the
            # rewatch below is the recovery either way.
            except Exception:  # graftlint: disable=broad-except
                pass
            cur = load_assignment(self.store)
            if cur is not None:
                self.assignment = cur
            self._assign_watch = self.store.watch(
                ASSIGN_KEY,
                start_revision=(cur.mod_revision + 1) if cur else 0,
            )

    def _drain_journal(self) -> bool:
        """Fold host row->name changes into _row_group; True if any."""
        journal = self._journal
        if not journal:
            return False
        # In journal order, so a row's last entry wins.
        latest = {row: (name, alive) for name, row, alive in journal}
        rows = np.fromiter(latest, np.int64, len(latest))
        alive = np.fromiter((a for _n, a in latest.values()), bool, len(latest))
        groups = groups_of([n for n, _a in latest.values()])
        self._row_group[rows] = np.where(alive, groups, -1)
        journal.clear()
        return True

    def _refresh_mask(self, force: bool = False) -> None:
        """Apply assignment + row changes to the ownership mask.

        Assignment version moved: lost groups drop from ``_claimed`` now;
        gained groups go to ``_pending_claim`` and are claimed on the
        NEXT call (drop-before-claim, module doc).  Row changes come from
        the host's delta journal, so steady state is O(changes) python +
        one vectorized rebuild, not an O(N) name loop per tick.
        """
        rows_changed = self._drain_journal()
        a = self.assignment
        version_changed = a.version != self._mask_version
        claim_now = bool(self._pending_claim)
        if not (rows_changed or version_changed or claim_now or force):
            return
        if claim_now:
            self._claimed |= self._pending_claim
            self._pending_claim = set()
        if version_changed:
            target = {
                g for g, s in enumerate(a.groups) if s == self.shard_idx
            }
            self._pending_claim = target - self._claimed
            self._claimed &= target          # drops apply immediately
            self._mask_version = a.version
        claim_np = np.zeros((NUM_GROUPS,), bool)
        if self._claimed:
            claim_np[list(self._claimed)] = True
        mask = claim_np[np.clip(self._row_group, 0, NUM_GROUPS - 1)]
        mask &= self._row_group >= 0
        self.coordinator.set_row_mask(mask)
        _MASK_REFRESH.inc(shard=str(self.shard_idx))
        _OWNED_NODES.set(int(mask.sum()), shard=str(self.shard_idx))

    # ---- status heartbeat ----------------------------------------------

    def heartbeat(self, now: float) -> None:
        """Publish liveness + load; the rebalancer reads these.

        Faultline hook (``shardset.lease``, op ``heartbeat/<shard>``):
        a dropped heartbeat is simply skipped — exactly a renewal the
        process never got to send — so the rebalancer's dead-shard
        evacuation fires after ``dead_after``, the same recovery a real
        silent shard gets.  Real write failures retry under the
        shardset.lease policy; give-up also skips (the next tick's
        heartbeat is the retry that matters — liveness is level-based,
        not edge-based)."""
        d = faultline.decide(
            "shardset.lease", f"heartbeat/{self.shard_idx}"
        )
        if d is not None:
            if d.kind == "delay":
                time.sleep(d.delay_s)
            else:
                log.warning(
                    "shard %d heartbeat suppressed (injected %s)",
                    self.shard_idx, d.kind,
                )
                return
        owned = (
            int(self.coordinator._row_mask_np.sum())
            if self.coordinator._row_mask_np is not None
            else 0
        )
        body = json.dumps(
            {
                "shard": self.shard_idx,
                "renewTime": now,
                "queue": len(self.coordinator.queue),
                "ownedNodes": owned,
            }
        ).encode()
        key = STATUS_PREFIX + str(self.shard_idx).encode()
        try:
            self._status_rev = policy_for("shardset.lease").call(
                lambda: self.store.put(key, body), op="heartbeat"
            )
        except GiveUp as e:
            log.warning("shard %d heartbeat failed: %s", self.shard_idx, e)
            return
        self._last_beat = now

    # ---- cycle ---------------------------------------------------------

    def tick(self, now: float) -> int:
        """One cycle: assignment drain -> mask refresh -> heartbeat ->
        coordinator step.  Returns pods bound this tick.

        ``now`` is required and must share a clock with the rebalancer's
        ``run_once`` — heartbeat freshness is a comparison between the
        two, so mixing simulated and wall time silently declares every
        member dead (or immortal)."""
        self._drain_assignment()
        bound = self.coordinator.step()
        # After the step: the coordinator's watch drain may have added
        # nodes this tick; refresh so the NEXT wave sees them owned.
        self._refresh_mask()
        if now - self._last_beat >= self.heartbeat_every:
            self.heartbeat(now)
        return bound


class Rebalancer:
    """Leader activity: keep the assignment balanced over live shards.

    Run by whichever process holds the control-plane lease
    (control/leader.py) — mirrors the reference's single-leader node
    labeler (leader_activities.go:100-343) with a minimum interval
    between rounds and a per-round move cap.
    """

    def __init__(
        self,
        store,
        host,                        # any current NodeTableHost view
        num_shards: int,
        *,
        min_interval: float = 30.0,
        max_moves: int = 32,
        dead_after: float = 15.0,
    ):
        self.store = store
        self.host = host
        self.num_shards = num_shards
        self.min_interval = min_interval
        self.max_moves = max_moves
        self.dead_after = dead_after
        # Starts at 0, not -inf: under a simulated clock (harness ticks
        # from 0) the first round waits out min_interval like every later
        # one; under time.monotonic() "now" dwarfs the interval and the
        # first round runs immediately — both match the reference's
        # min-30s-between-rebalances floor.
        self._last_run = 0.0

    def alive_shards(self, now: float) -> set[int]:
        """Shards whose status heartbeat is fresh."""
        res = self.store.range(STATUS_PREFIX, prefix_end(STATUS_PREFIX))
        alive: set[int] = set()
        for kv in res.kvs:
            try:
                obj = json.loads(kv.value)
                if now - float(obj["renewTime"]) <= self.dead_after:
                    alive.add(int(obj["shard"]))
            except Exception:
                # A malformed heartbeat reads as a dead shard (its groups
                # get evacuated) — keep the parse failure diagnosable
                # without letting one bad record kill the round.
                log.debug("undecodable shard status %r", kv.key,
                          exc_info=True)
                continue
        return {s for s in alive if 0 <= s < self.num_shards}

    def group_loads(self) -> np.ndarray:
        return np.bincount(groups_of(self.host._row_of), minlength=NUM_GROUPS)

    def run_once(self, now: float, *, force: bool = False) -> bool:
        """One rebalance round; returns True if the assignment changed.

        ``now`` must share a clock with the members' ``tick`` (see
        ShardMember.tick).  CAS-guarded: a concurrent leader handover
        can't interleave two writers (the loser's CAS fails and it
        re-reads next round).
        """
        if not force and now - self._last_run < self.min_interval:
            return False
        self._last_run = now
        # Faultline hook (``shardset.lease``, op ``rebalance``): a failed
        # round is skipped whole — the interval timer ran, so the NEXT
        # round is the retry (the reference's leader activity has the
        # same shape: best-effort per round, durable across rounds).
        d = faultline.decide("shardset.lease", "rebalance")
        if d is not None:
            if d.kind == "delay":
                time.sleep(d.delay_s)
            else:
                log.warning("rebalance round skipped (injected %s)", d.kind)
                return False
        cur = init_assignment(self.store, self.num_shards)
        alive = self.alive_shards(now)
        if not alive:
            return False
        new_groups = rebalance_groups(
            cur.groups, self.group_loads(), alive, self.max_moves
        )
        if new_groups == cur.groups:
            return False
        moved = sum(1 for a, b in zip(cur.groups, new_groups) if a != b)
        nxt = Assignment(cur.version + 1, self.num_shards, new_groups)
        ok, _, _ = self.store.cas(
            ASSIGN_KEY, nxt.encode(), required_mod=cur.mod_revision
        )
        if ok:
            _REBALANCES.inc()
            _GROUP_MOVES.inc(float(moved))
            log.info(
                "rebalanced: %d groups moved, alive=%s", moved, sorted(alive)
            )
        return ok
