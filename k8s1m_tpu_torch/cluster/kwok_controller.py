"""KWOK-style node simulator: fake kubelets at cluster scale (the port's
copy of ``k8s1m_tpu/cluster/kwok_controller.py``).

The reference runs a forked KWOK v0.6.0 as a StatefulSet of 10
controllers, each adopting nodes with its ``kwok-group=<ordinal>`` label,
maintaining 40s node leases and driving pod status
(reference kwok/kwok-controller.yaml:9,53,58; SURVEY.md §2.8).  This is
the same component against our store: each controller owns a node group,
renews the group's leases, and moves pods bound to its nodes from
Pending to Running.

Tick-driven (no wall-clock sleeps): the caller advances simulated time,
so tests and the bench can run lease churn at any speed.  The fork's
``kwok_node_lease_delay_percentile`` metric (dashboard.json:7069) is
reproduced as a histogram of (actual - scheduled) renewal delay.
"""

from __future__ import annotations

import json
import logging
import zlib

from k8s1m_tpu_torch.control.objects import lease_key, pod_key
from k8s1m_tpu_torch.obs.metrics import Counter, Histogram
from k8s1m_tpu_torch.store.native import (
    MemStore,
    drain_events,
    list_prefix,
    list_prefix_values,
    prefix_end,
)

log = logging.getLogger("k8s1m.kwok")

NODES_PREFIX = b"/registry/minions/"
PODS_PREFIX = b"/registry/pods/"
# Cap on pods parked waiting for an unseen node, and how long a node may
# stay unseen before its parked pods become evictable (see tick()).
MAX_WAITING_PODS = 10_000
WAITING_GRACE_S = 60.0
LEASE_NS = "kube-node-lease"

_LEASE_RENEWALS = Counter(
    "kwok_lease_renewals_total", "Node lease renewals", ("group",)
)
_PODS_STARTED = Counter(
    "kwok_pods_started_total", "Pods moved to Running", ("group",)
)
_LEASE_DELAY = Histogram(
    "kwok_node_lease_delay_seconds",
    "Delay between scheduled and actual lease renewal",
    ("group",),
)


class KwokController:
    """One controller instance owning one kwok-group of nodes."""

    def __init__(
        self,
        store: MemStore,
        group: int = 0,
        *,
        lease_duration_s: int = 40,
        renew_interval_s: float = 10.0,
    ):
        self.store = store
        self.group = str(group)
        self.lease_duration_s = lease_duration_s
        self.renew_interval_s = renew_interval_s
        self.nodes: set[str] = set()
        self._next_renewal: dict[str, float] = {}
        self._nodes_watch = None
        self._pods_watch = None
        self.running_pods: set[str] = set()
        self._started_total = 0   # monotonic; survives resync resets
        # Pods bound to one of OUR nodes whose adoption event hasn't been
        # applied yet (node and pod watches are separate queues, so a bind
        # can be seen before its node) — parked per node, started on adopt.
        self._waiting: dict[str, dict[str, tuple[bytes, int]]] = {}
        # First tick time each unseen node started parking pods.
        self._waiting_since: dict[str, float] = {}
        # Nodes known to belong to other groups.  The controller already
        # lists+watches ALL nodes (it must, to discover label moves), so
        # ownership is answered locally instead of with a store round trip
        # per bound-pod event (which over gRPC would be (groups-1) x pods
        # extra blocking RPCs on the bind hot path).  ~60 bytes/node of
        # interned strings — the same order as the reference controller's
        # own node cache.
        self._foreign: set[str] = set()

    # ---- membership ----------------------------------------------------

    def _owns(self, node_obj: dict) -> bool:
        labels = node_obj.get("metadata", {}).get("labels", {})
        return labels.get("kwok-group") == self.group

    def bootstrap(self, now: float = 0.0) -> None:
        # Paginated list+watch: an unpaginated 1M-node list is one ~350MB
        # response — over any wire it must chunk.  Only the node objects
        # are read, so the values-only relist (the light parse over the
        # wire) serves it, at the same pinned revision.
        values, rev = list_prefix_values(self.store, NODES_PREFIX)
        for value in values:
            obj = json.loads(value)
            if self._owns(obj):
                self._adopt(obj["metadata"]["name"], now)
            else:
                self._foreign.add(obj["metadata"]["name"])
        self._nodes_watch = self.store.watch(
            NODES_PREFIX, prefix_end(NODES_PREFIX),
            start_revision=rev + 1, queue_cap=1 << 20,
        )
        pod_kvs, pod_rev = list_prefix(self.store, PODS_PREFIX)
        for kv in pod_kvs:
            self._maybe_start_pod(kv.value, kv.mod_revision, now)
        self._pods_watch = self.store.watch(
            PODS_PREFIX, prefix_end(PODS_PREFIX),
            start_revision=pod_rev + 1, queue_cap=1 << 20,
        )

    def _adopt(self, name: str, now: float) -> None:
        self.nodes.add(name)
        # Stagger first renewals across the interval so 1M leases spread
        # evenly instead of arriving in one spike.  crc32, not hash():
        # hash() is salted per process, which would make the renewal
        # schedule (and the delay histogram) nondeterministic across runs.
        offset = (zlib.crc32(name.encode()) % 1000) / 1000.0 * self.renew_interval_s
        self._next_renewal[name] = now + offset
        self._foreign.discard(name)
        self._waiting_since.pop(name, None)
        for data, mod in self._waiting.pop(name, {}).values():
            self._maybe_start_pod(data, mod, now)

    # ---- pod lifecycle -------------------------------------------------

    def _maybe_start_pod(
        self, data: bytes, mod_revision: int, now: float = 0.0
    ) -> None:
        obj = json.loads(data)
        node = obj.get("spec", {}).get("nodeName")
        if not node:
            return
        if obj.get("status", {}).get("phase") != "Pending":
            # Already Running (e.g. a relist after resync): keep it in the
            # running set if it's on one of our nodes.
            if node in self.nodes:
                self.running_pods.add(
                    f"{obj['metadata'].get('namespace', 'default')}/"
                    f"{obj['metadata']['name']}"
                )
            return
        if node in self._foreign:
            return            # another group's node — not ours to start
        if node not in self.nodes:
            # Unknown node: its watch event hasn't been applied yet (node
            # and pod watches are separate streams).  Park the pod; the
            # node's PUT resolves it — _adopt replays if ours, the
            # foreign branch in tick() discards if not.
            pk = (f"{obj['metadata'].get('namespace', 'default')}/"
                  f"{obj['metadata']['name']}")
            self._waiting.setdefault(node, {})[pk] = (data, mod_revision)
            self._waiting_since.setdefault(node, now)
            return
        key = pod_key(obj["metadata"].get("namespace", "default"),
                      obj["metadata"]["name"])
        obj["status"]["phase"] = "Running"
        obj["status"]["conditions"] = [{"type": "Ready", "status": "True"}]
        ok, _, _ = self.store.cas(
            key, json.dumps(obj, separators=(",", ":")).encode(),
            required_mod=mod_revision,
        )
        if ok:
            self.running_pods.add(f"{obj['metadata'].get('namespace', 'default')}/"
                                  f"{obj['metadata']['name']}")
            self._started_total += 1
            _PODS_STARTED.inc(group=self.group)
        # CAS failure: someone updated the pod concurrently; the new
        # revision arrives via the watch and is retried there.

    # ---- tick ----------------------------------------------------------

    def tick(self, now: float) -> dict:
        """Advance the simulator: drain watches, renew due leases, start
        newly bound pods.  Returns per-tick stats."""
        # ``started`` is a monotonic counter delta, NOT a set-size delta:
        # a resync clears and rebuilds running_pods, which would make any
        # length-based delta meaningless for the tick that resyncs.
        started0 = self._started_total
        if (
            self._nodes_watch is None      # earlier resync attempt failed
            or self._pods_watch is None
            or self._nodes_watch.dropped
            or self._pods_watch.dropped
        ):
            # Watch overflow or broken stream (store restart): events were
            # lost — reset soft state and relist, like the coordinator.
            # A failed relist (store still down) leaves the watches None
            # and is retried next tick instead of wedging the controller.
            self.close()
            self.nodes.clear()
            self._next_renewal.clear()
            self._waiting.clear()
            self._waiting_since.clear()
            self._foreign.clear()
            self.running_pods.clear()
            try:
                self.bootstrap(now)
            except Exception:
                log.warning(
                    "resync relist failed; retrying next tick", exc_info=True
                )
                return {"renewed": 0, "started": 0, "nodes": 0}
        renewed = 0
        for ev in drain_events(self._nodes_watch):
            name = ev.kv.key[len(NODES_PREFIX):].decode()
            if ev.type == "PUT":
                obj = json.loads(ev.kv.value)
                if self._owns(obj):
                    if name not in self.nodes:
                        self._adopt(name, now)
                else:
                    if name in self.nodes:
                        self._drop(name)
                    self._foreign.add(name)
                    self._waiting.pop(name, None)
                    self._waiting_since.pop(name, None)
            else:
                self._foreign.discard(name)
                if name in self.nodes:
                    self._drop(name)
        for ev in drain_events(self._pods_watch):
            if ev.type == "PUT":
                self._maybe_start_pod(ev.kv.value, ev.kv.mod_revision, now)
            else:
                key = ev.kv.key[len(PODS_PREFIX):].decode()
                self.running_pods.discard(key)
                for waiting in self._waiting.values():
                    waiting.pop(key, None)
        # Bound the parking lot: pods bound to a node name that never
        # appears (typo'd / external writer) would otherwise be retained
        # forever.  Node and pod watches are separate streams, so a large
        # bind wave can legitimately park >cap pods for a tick or two —
        # eviction therefore requires BOTH pressure (total over the cap)
        # and age (the node stayed unseen past a grace period).
        if sum(len(w) for w in self._waiting.values()) > MAX_WAITING_PODS:
            for node in list(self._waiting):
                since = self._waiting_since.get(node, now)
                if now - since < WAITING_GRACE_S:
                    continue
                dropped = self._waiting.pop(node)
                self._waiting_since.pop(node, None)
                log.warning(
                    "evicting %d pod(s) parked %.0fs on never-seen node %r",
                    len(dropped), now - since, node,
                )

        # Renew every due lease in ONE wave: leases are the dominant
        # 1M-node write load (100K/s in the reference), and per-lease
        # RPCs cap a wire-connected controller at the per-request rate;
        # the BatchKV frame path carries the same wave at ~50x that
        # (store/remote.py put_batch).
        due_items = []
        due_names = []
        delays = []
        for name, due in self._next_renewal.items():
            if due <= now:
                due_items.append(
                    (lease_key(LEASE_NS, name), self._lease_value(name, now))
                )
                due_names.append(name)
                delays.append(now - due)
        if due_items:
            try:
                put_batch = getattr(self.store, "put_batch", None)
                if put_batch is not None:
                    put_batch(due_items)
                else:
                    for k, v in due_items:
                        self.store.put(k, v)
            except Exception:
                # Schedules advance only on success: a failed wave keeps
                # every lease due, so the next tick retries instead of
                # silently slipping them a whole interval (a slip can
                # exceed leaseDurationSeconds — a false node death).
                log.warning(
                    "lease renewal wave failed; %d lease(s) stay due",
                    len(due_items), exc_info=True,
                )
            else:
                for name in due_names:
                    self._next_renewal[name] = now + self.renew_interval_s
                _LEASE_DELAY.observe_many(delays, group=self.group)
                _LEASE_RENEWALS.inc(len(due_items), group=self.group)
                renewed += len(due_items)
        return {
            "renewed": renewed,
            "started": self._started_total - started0,
            "nodes": len(self.nodes),
        }

    def close(self) -> None:
        """Cancel store watches (deregisters native/remote watchers)."""
        for w in (self._nodes_watch, self._pods_watch):
            if w is not None:
                w.cancel()
        self._nodes_watch = self._pods_watch = None

    def _drop(self, name: str) -> None:
        self.nodes.discard(name)
        self._next_renewal.pop(name, None)
        self._waiting.pop(name, None)
        self._waiting_since.pop(name, None)
        self.store.delete(lease_key(LEASE_NS, name))

    def _lease_value(self, name: str, now: float) -> bytes:
        return json.dumps(
            {
                "apiVersion": "coordination.k8s.io/v1",
                "kind": "Lease",
                "metadata": {"name": name, "namespace": LEASE_NS},
                "spec": {
                    "holderIdentity": name,
                    "leaseDurationSeconds": self.lease_duration_s,
                    "renewTime": now,
                },
            },
            separators=(",", ":"),
        ).encode()

