"""Kubelet-faithful node agents: the kubelet-as-pod realism rig.

The reference validates that KWOK load is representative by also running
100K *real* kubelets in containers (k3s agents, one per pod) and
comparing control-plane load shapes (reference README.adoc:789-861,
terraform/kubelet-pod/deployment.tf).  Its finding: apiserver request
rates match, but kubelets add more watches, more Events, and more DB
size than KWOK's minimal emulation.

This module is that experiment's analogue: a ``KubeletPool`` drives
nodes with the write pattern of a real kubelet rather than KWOK's
single status patch —

- node lease renewal every 10s (same as kwok),
- periodic node status heartbeats (nodeStatusUpdateFrequency, default
  10s — a full Node object PUT, the pre-lease-era load kwok skips),
- pod lifecycle in stages: Pending -> ContainerCreating -> Running,
  one status PUT each (kwok: one),
- Events per pod: Scheduled/Pulled/Created/Started (4 PUTs into
  /registry/events/, lease-backed TTL in real clusters — the extra DB
  weight the reference measured),

so ``tools/fidelity_ab.py`` can A/B the two simulators against the same
store and report the load-shape delta the reference reports.

The port's own copy of ``k8s1m_tpu/cluster/kubelet_sim.py``, over the
port's store (``store/native.py``, or a ``RemoteStore`` with the same
calls): the same writes, in the same order, with the same bytes.
"""

from __future__ import annotations

import json
import zlib

from k8s1m_tpu_torch.control.objects import lease_key, node_key, pod_key
from k8s1m_tpu_torch.obs.metrics import Counter
from k8s1m_tpu_torch.store.native import (
    MemStore,
    drain_events,
    list_prefix,
    prefix_end,
)

NODES_PREFIX = b"/registry/minions/"
PODS_PREFIX = b"/registry/pods/"
EVENTS_PREFIX = b"/registry/events/"
LEASE_NS = "kube-node-lease"

_WRITES = Counter(
    "kubelet_sim_writes_total", "Store writes by kind", ("kind",)
)

# Pod startup stages a kubelet reports (each is a status PUT).
_STAGES = ("ContainerCreating", "Running")
_EVENTS = ("Scheduled", "Pulled", "Created", "Started")


def event_key(namespace: str, name: str) -> bytes:
    return EVENTS_PREFIX + f"{namespace}/{name}".encode()


class KubeletPool:
    """One process's worth of simulated kubelets (the reference packs
    ~234 kubelet pods per VM; here one pool drives any node subset)."""

    def __init__(
        self,
        store: MemStore,
        *,
        lease_duration_s: int = 40,
        renew_interval_s: float = 10.0,
        status_interval_s: float = 10.0,
    ):
        self.store = store
        self.lease_duration_s = lease_duration_s
        self.renew_interval_s = renew_interval_s
        self.status_interval_s = status_interval_s
        self.nodes: dict[str, bytes] = {}       # name -> last node object bytes
        self._next_renewal: dict[str, float] = {}
        self._next_status: dict[str, float] = {}
        self._pods_watch = None
        self._nodes_watch = None
        # Pods mid-startup: key -> (stage index, object dict, mod rev).
        self._starting: dict[str, tuple[int, dict, int]] = {}
        self.running_pods: set[str] = set()
        # Last observed mod revision per node — the status heartbeat is a
        # CAS against it so it can never clobber a concurrent external
        # update (e.g. a label move) made after this tick's watch drain.
        self._node_mod: dict[str, int] = {}

    def bootstrap(self, now: float = 0.0) -> None:
        kvs, rev = list_prefix(self.store, NODES_PREFIX)
        for kv in kvs:
            name = kv.key[len(NODES_PREFIX):].decode()
            self.adopt(name, kv.value, now, mod_revision=kv.mod_revision)
        self._nodes_watch = self.store.watch(
            NODES_PREFIX, prefix_end(NODES_PREFIX),
            start_revision=rev + 1, queue_cap=1 << 20,
        )
        pod_kvs, pod_rev = list_prefix(self.store, PODS_PREFIX)
        for kv in pod_kvs:
            self._observe_pod(kv.value, kv.mod_revision)
        self._pods_watch = self.store.watch(
            PODS_PREFIX, prefix_end(PODS_PREFIX),
            start_revision=pod_rev + 1, queue_cap=1 << 20,
        )

    def adopt(
        self, name: str, obj_bytes: bytes, now: float, *, mod_revision: int = 0
    ) -> None:
        self.nodes[name] = obj_bytes
        self._node_mod[name] = mod_revision
        stagger = (zlib.crc32(name.encode()) % 1000) / 1000.0
        self._next_renewal[name] = now + stagger * self.renew_interval_s
        self._next_status[name] = now + stagger * self.status_interval_s

    # ---- pod lifecycle -------------------------------------------------

    def _observe_pod(self, data: bytes, mod_revision: int) -> None:
        obj = json.loads(data)
        node = obj.get("spec", {}).get("nodeName")
        if not node or node not in self.nodes:
            return
        key = (f"{obj['metadata'].get('namespace', 'default')}/"
               f"{obj['metadata']['name']}")
        if obj.get("status", {}).get("phase") != "Pending":
            self.running_pods.add(key)
            return
        if key in self._starting or key in self.running_pods:
            return
        self._starting[key] = (0, obj, mod_revision)
        self._emit_event(obj, "Scheduled")

    def _emit_event(self, pod_obj: dict, reason: str) -> None:
        ns = pod_obj["metadata"].get("namespace", "default")
        name = pod_obj["metadata"]["name"]
        self.store.put(
            event_key(ns, f"{name}.{reason.lower()}"),
            json.dumps(
                {
                    "apiVersion": "v1",
                    "kind": "Event",
                    "metadata": {"name": f"{name}.{reason.lower()}",
                                 "namespace": ns},
                    "reason": reason,
                    "involvedObject": {"kind": "Pod", "name": name,
                                       "namespace": ns},
                },
                separators=(",", ":"),
            ).encode(),
        )
        _WRITES.inc(kind="event")

    def _advance_pod(self, key: str) -> None:
        stage, obj, mod = self._starting[key]
        ns = obj["metadata"].get("namespace", "default")
        name = obj["metadata"]["name"]
        phase = _STAGES[stage]
        status = dict(obj.get("status", {}))
        if phase == "Running":
            status["phase"] = "Running"
            status["conditions"] = [{"type": "Ready", "status": "True"}]
        else:
            status["phase"] = "Pending"
            status["reason"] = phase
        obj = {**obj, "status": status}
        ok, rev, cur = self.store.cas(
            pod_key(ns, name),
            json.dumps(obj, separators=(",", ":")).encode(),
            required_mod=mod,
        )
        _WRITES.inc(kind="pod_status")
        if ok:
            # Events only after the status write lands — a CAS retry must
            # not re-emit them (they inflate exactly the write counts the
            # fidelity A/B measures).
            if phase == "Running":
                self._emit_event(obj, "Created")
                self._emit_event(obj, "Started")
            else:
                self._emit_event(obj, "Pulled")
        if not ok:
            if cur is None:
                del self._starting[key]     # pod deleted
                return
            fresh = json.loads(cur.value)
            if fresh.get("status", {}).get("phase") == "Running":
                del self._starting[key]
                self.running_pods.add(key)
                return
            self._starting[key] = (stage, fresh, cur.mod_revision)
            return
        if phase == "Running":
            del self._starting[key]
            self.running_pods.add(key)
        else:
            self._starting[key] = (stage + 1, obj, rev)

    # ---- tick ----------------------------------------------------------

    def tick(self, now: float) -> dict:
        if self._pods_watch.dropped or self._nodes_watch.dropped:
            # Watch overflow: events were silently lost — reset ALL soft
            # state and relist (the resync contract).  Keeping nodes or
            # running_pods across the reset would resurrect deleted nodes
            # via heartbeats and skip recreated pods.
            self.close()
            self._starting.clear()
            self.nodes.clear()
            self._next_renewal.clear()
            self._next_status.clear()
            self.running_pods.clear()
            self.bootstrap(now)
        for e in drain_events(self._nodes_watch):
            name = e.kv.key[len(NODES_PREFIX):].decode()
            if e.type == "PUT":
                if name in self.nodes:
                    self.nodes[name] = e.kv.value  # track latest object
                    self._node_mod[name] = e.kv.mod_revision
                else:
                    self.adopt(
                        name, e.kv.value, now, mod_revision=e.kv.mod_revision
                    )
            else:
                # Node deleted: stop heartbeating — re-PUTting the
                # stale object would resurrect a removed node.
                self.nodes.pop(name, None)
                self._node_mod.pop(name, None)
                self._next_renewal.pop(name, None)
                self._next_status.pop(name, None)
                self.store.delete(lease_key(LEASE_NS, name))
        for e in drain_events(self._pods_watch):
            if e.type == "PUT":
                self._observe_pod(e.kv.value, e.kv.mod_revision)
            else:
                key = e.kv.key[len(PODS_PREFIX):].decode()
                self._starting.pop(key, None)
                self.running_pods.discard(key)

        renewed = statuses = 0
        for name, due in self._next_renewal.items():
            if due <= now:
                self.store.put(
                    lease_key(LEASE_NS, name),
                    json.dumps(
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
                    ).encode(),
                )
                _WRITES.inc(kind="lease")
                self._next_renewal[name] = now + self.renew_interval_s
                renewed += 1
        for name, due in self._next_status.items():
            if due <= now:
                # Full Node object heartbeat — the write kwok skips.  CAS
                # on the observed revision: a conflict means an external
                # writer updated the node after our last watch drain, so
                # the heartbeat is skipped and the newer object arrives
                # via watch (like _advance_pod's rebase for pod status).
                ok, rev, cur = self.store.cas(
                    node_key(name), self.nodes[name],
                    required_mod=self._node_mod.get(name, 0),
                )
                if ok:
                    self._node_mod[name] = rev
                    _WRITES.inc(kind="node_status")
                    statuses += 1
                else:
                    # Rebase from the conflicting KV the CAS already
                    # returned, so the next heartbeat carries the
                    # external change (no extra read round trip).
                    _WRITES.inc(kind="node_status_conflict")
                    if cur is not None:
                        self.nodes[name] = cur.value
                        self._node_mod[name] = cur.mod_revision
                self._next_status[name] = now + self.status_interval_s

        # Advance every mid-startup pod one stage per tick.
        for key in list(self._starting):
            self._advance_pod(key)

        return {
            "renewed": renewed,
            "node_statuses": statuses,
            "starting": len(self._starting),
            "running": len(self.running_pods),
        }

    def close(self) -> None:
        for w in (self._pods_watch, self._nodes_watch):
            if w is not None:
                w.cancel()
        self._pods_watch = self._nodes_watch = None
