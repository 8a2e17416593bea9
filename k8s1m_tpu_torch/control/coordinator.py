"""The host coordinator: store watches -> snapshot deltas -> wave -> binds.

The port's own copy of ``k8s1m_tpu/control/coordinator.py`` (not a
subclass: the port imports nothing of the JAX package).  One coordinator
drives the whole cluster:

- **Intake** — a store watch on /registry/pods/: every Pending pod with
  schedulerName=dist-scheduler enters the queue (the native columnar
  drain ``poll_pods`` is the fast lane for canonical label-less pods).
- **Node cache** — a watch on /registry/minions/ streams adds, updates
  and removes into ``NodeTableHost`` and scatters compiled rows into the
  device table; bound-pod resource accounting is folded in the same way.
- **Cycle** — pending pods are drained in batches of PodSpec.batch (with
  ``adaptive_batch``, the smallest power-of-two bucket from ``min_batch``
  up that holds the queue), encoded (``snapshot/hotfeed.py``) and run
  through ``engine.cycle.schedule_batch_packed`` or, with the deltacache
  on, ``schedule_batch_delta``, on the ``backend`` the caller picks:
  ``"pallas"`` (the fused and delta kernels), ``"xla"`` (the scan path) or
  ``"auto"`` (the default: the kernels on ``cuda``, the scan path on the
  CPU — where the JAX coordinator defaults to ``"xla"``); winners are
  written back as spec.nodeName under a CAS on the pod's mod revision,
  and a pod whose CAS loses is rolled back and re-queued.
- **Retries** — a pod whose bind CAS fails or that finds no feasible
  node is re-queued under the ``coordinator.bind`` RetryPolicy (capped
  exponential backoff with a seeded jitter stream) and parked as
  unschedulable after ``max_attempts`` tries.

**Quiesce-free pipelining**: with ``pipeline=True`` up to ``depth`` waves
are in flight.  Capacity-only node updates scatter into the live table
between waves, structural adds append fresh rows, and removes tombstone
their row into the wave-epoch quarantine (``snapshot/node_table.py``), so
no in-flight wave can alias a reused row.  Every launch, scatter and
count-table correction runs on the coordinator's thread and the current
CUDA stream, in order; the tables are updated in place.  A wave's bound
rows come back by a non-blocking copy into pinned memory, and the retire
waits on the CUDA event recorded after that copy before it reads them.

With ``adaptive_batch`` a wave of a partial bucket retires at once
(``pipeline_quiesce_total{reason="adaptive"}``): under light load the
queue drains faster than it fills, and holding the wave for the next step
would add a wave time to every pod's latency.

**Overload control** (``loadshed/``, opt-in via ``loadshed=`` /
``breaker=``): a HealthController ticked once per cycle turns queue and
backoff depth, conflict rate, cycle latency and resyncs into HEALTHY /
DEGRADED / SHEDDING.  DEGRADED shrinks the score window to
``degraded_score_pct`` (rounded up to a whole chunk), drops constraint
*scoring* and widens batch windows; SHEDDING also makes
``submit_external`` reject pods (lowest priority first, or per tenant
under ``tenancy=``).  A CircuitBreaker around the wave launch falls back
to the host-side oracle scheduler (``oracle/``) while open: the pipeline
is retired first, and the fallback binds reach the device table only
through the dirty-row sync, never by a direct write.

**Tenancy** (``tenancy/``, ``tenancy=``): weighted-fair per-tenant
admission at ``submit_external``, priority preemption (evict and requeue
lower-priority bound pods through the store CAS and the dirty-row sync)
and all-or-none gangs that ride one wave.

**Fault injection** (``faultline/``): the bind CAS
(``coordinator.bind``/``cas``), the watch drain (``coordinator.watch``/
``poll``) and the wave launch (``coordinator.cycle``/``dispatch``) are
hook sites of the process's injector.  The launch hook runs before any
device work, so a ``stall`` leaves no event, no pinned buffer and no
table update behind.

**Observability** (``obs/``): a ``PodTracer`` (``tracer=``) records a
head-sampled pod's journey as a contiguous span chain (admit, gang
staging, queue wait, encode, dispatch wait, device, bind, requeue); the
``device`` span ends at ``t_sync``, taken right after the retire's wait on
the pinned copy's event, so the card's time is never attributed to
``bind``.  A ``FlightRecorder`` (``flight_recorder=``) records every
retired wave and dumps its ring on a slow cycle or a slow traced pod; a
``SamplingProfiler`` (``profiler=``) is dumped beside a slow cycle.  With
none of them every hook is one ``enabled`` read (the null tracer).

**Mesh** (``parallel/``, ``mesh=``): the node table's rows split over the
``sp`` shards of a dp x sp mesh and each wave's pods over ``dp``; the wave
runs the sharded step (``parallel/sharded_cycle.py``), byte-identical to
the single-device wave at score-pct 100, with percentageOfNodesToScore
windows rotating shard-locally.  Dirty-row scatters and count-table
corrections take each storage once; a feed per dp rank encodes the wave's
slices (``ShardedHostFeed``).  ``mesh`` is a built ``parallel.Mesh``, a
spec string ("2x2", "auto", "none") or None (then ``K8S1M_MESH``).

Entry points run on ``device="cuda"`` unless the caller asks for
``device="cpu"`` (the plain versions of the kernels).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import heapq
import json
import logging
import os
import random
import threading
import time
import weakref

import numpy as np
import torch

from k8s1m_tpu_torch.config import DEFAULT_SCHEDULER, PodSpec, TableSpec
from k8s1m_tpu_torch import faultline
from k8s1m_tpu_torch.control.objects import (
    decode_node,
    decode_pod,
    decode_pod_obj,
    node_key,
    pod_key,
    pod_key_str_of_obj,
)
from k8s1m_tpu_torch.device import resolve_device, to_tensor
from k8s1m_tpu_torch.engine.cycle import (
    Wave,
    adjust_constraints,
    commit_fields_np,
    fill_shape_planes,
    resolve_backend,
    sample_offset_for,
    sample_rows_for,
    schedule_batch_delta,
    schedule_batch_packed,
)
from k8s1m_tpu_torch.engine.deltacache import (
    DeltaPlaneCache,
    note_index_oversized,
    note_index_wave,
    resolve_deltasched,
)
from k8s1m_tpu_torch.faultline import RetryPolicy, note_give_up, note_retry, policy_for
from k8s1m_tpu_torch.lint import THREAD_OWNER, guarded_by, racy_read
from k8s1m_tpu_torch.loadshed import CLOSED as BREAKER_CLOSED
from k8s1m_tpu_torch.loadshed import CircuitBreaker, HealthController, Signals
from k8s1m_tpu_torch.loadshed.breaker import FALLBACK_BINDS
from k8s1m_tpu_torch.obs.metrics import Counter, Gauge, Histogram, LevelTimer
from k8s1m_tpu_torch.obs.podtrace import NULL_TRACER
from k8s1m_tpu_torch.obs.trace import FlightRecorder
from k8s1m_tpu_torch.ops.priority import (
    JITTER_BITS,
    pod_priority_of,
    prng_key,
    prng_split,
    seed_of,
)
from k8s1m_tpu_torch.oracle import oracle_feasible, oracle_score
from k8s1m_tpu_torch.plugins.registry import Profile, degraded_profile
from k8s1m_tpu_torch.snapshot.bulkload import BulkNodeLoader
from k8s1m_tpu_torch.snapshot.constraints import ConstraintTracker, empty_constraints
from k8s1m_tpu_torch.snapshot.hotfeed import (
    PLAIN,
    EncodeCache,
    HostFeed,
    HotPodBatchHost,
    ShardedHostFeed,
    cache_counts,
    encode_batch,
    shape_key,
)
from k8s1m_tpu_torch.snapshot.node_table import (
    ALL_COLUMNS,
    CAP_COLUMNS,
    NodeTableHost,
    RowsExhausted,
    scatter_rows,
)
from k8s1m_tpu_torch.snapshot.packing import (
    PackingOverflow,
    build_packing_spec,
    donation_inplace,
    donation_probe,
    hbm_bytes,
    is_packed,
    pack_row_delta,
    pack_table_host,
    resolve_packing,
)
from k8s1m_tpu_torch.snapshot.pod_encoding import PodInfo
from k8s1m_tpu_torch.tenancy.gang import note_gang
from k8s1m_tpu_torch.tenancy.policy import (
    gang_of_labels,
    tenant_of_key,
    tenant_of_obj,
    tenant_of_pod,
)
from k8s1m_tpu_torch.tenancy.preempt import Victim, note_eviction, select_preemption
from k8s1m_tpu_torch.store.native import (
    BIND_INVALID,
    POD_CANONICAL,
    POD_HAS_NODE,
    POD_SCHED_MATCH,
    CompactedError,
    FutureRevError,
    MemStore,
    Watcher,
    drain_events_light,
    list_prefix,
    list_prefix_items,
    list_prefix_sharded,
    list_prefix_values,
    prefix_end,
)

log = logging.getLogger("k8s1m.coordinator")

NODES_PREFIX = b"/registry/minions/"
# Tick-driven consumers drain once per cycle, so the watch queue must
# absorb a full inter-cycle burst (creates + deletes + bind echoes).
DEEP_WATCH_QUEUE = 1 << 20
PODS_PREFIX = b"/registry/pods/"

_PODS_SCHEDULED = Counter(
    "coordinator_pods_scheduled_total", "Pods bound, by outcome", ("outcome",)
)
_DECODE_ERRORS = Counter(
    "coordinator_decode_errors_total", "Objects that failed to decode", ("kind",)
)
_CYCLE_TIME = Histogram(
    "coordinator_cycle_seconds", "Scheduling cycle latency by stage", ("stage",)
)
_QUEUE_DEPTH = Gauge("coordinator_queue_depth", "Pending pods queued", ())
_BACKOFF_DEPTH = Gauge(
    "coordinator_backoff_depth", "Pods waiting out a retry backoff", (),
)
_RESYNCS = Counter("coordinator_resyncs_total", "Full relist+rewatch recoveries", ())
_NODE_COUNT = Gauge("coordinator_node_count", "Nodes in the snapshot", ())
_COLD_BUILD = Gauge(
    "megarow_cold_build_seconds",
    "Wall seconds of the last store->watch->table cold build (bootstrap's "
    "node relist + bulk ingest + device table build)", (),
)
# All live coordinators in this process; the gauges sum over them.
# Reads of cycle-thread-owned state from a gauge go through racy_read: a
# deliberate torn-snapshot read that the guard audit exempts.  Follower
# mirrors (warm standby, control/leader.py) shadow the leader's whole
# intake — summing them would double every depth, so the aggregates skip
# them; the standby's own health is standby_mirror_lag_rows.
_LIVE: weakref.WeakSet = weakref.WeakSet()


def _live_primaries():
    return (c for c in list(_LIVE) if not racy_read(c, "_follower"))


_NODE_COUNT.set_function(
    lambda: sum(len(racy_read(c.host, "_row_of")) for c in _live_primaries())
)
_QUEUE_DEPTH.set_function(lambda: sum(len(racy_read(c, "queue")) for c in _live_primaries()))
_BACKOFF_DEPTH.set_function(
    lambda: sum(len(racy_read(c, "_backoff")) for c in _live_primaries())
)

_PIPE_QUIESCE = Counter(
    "pipeline_quiesce_total",
    "Forced full pipeline retires, by reason (structural = free-row "
    "quarantine exhausted)", ("reason",),
)
_PIPE_DEPTH = Gauge("pipeline_inflight_depth", "Device waves currently in flight", ())
_PIPE_DEPTH.set_function(
    lambda: sum(len(racy_read(c, "_inflights")) for c in list(_LIVE))
)
_PIPE_OVERLAP = Counter(
    "pipeline_stage_overlap_seconds_total",
    "Host-stage seconds split by whether device waves were in flight",
    ("stage", "inflight"),
)
# Stages instrumented with the overlap split (keep in sync with _stage).
OVERLAP_STAGES = ("drain", "encode", "sync", "sync_out", "bind")

_TABLE_BYTES = Gauge(
    "device_table_bytes", "Device bytes of the node table by layout", ("layout",),
)
_DONATION = Counter(
    "commit_donation_total",
    "Per-wave table commits, split by whether the wave left the table's "
    "planes in their own storage", ("inplace",),
)
_PACKING_FALLBACK = Counter(
    "device_packing_fallback_total",
    "Fail-closed packed-layout rebuilds, by reason (the field that "
    "overflowed its bit budget, or 'taint_slots')", ("reason",),
)
# ---- mesh execution (parallel/): the dp x sp sharded wave ----------------
_MESH_DEVICES = Gauge(
    "mesh_devices",
    "Devices along each mesh axis across live mesh coordinators "
    "(0 = every coordinator runs single-device)",
    ("axis",),
)
for _axis in ("dp", "sp"):
    _MESH_DEVICES.set_function(
        lambda _a=_axis: sum(c.mesh.shape[_a] for c in list(_LIVE) if c.mesh is not None),
        axis=_axis,
    )
_MESH_SCATTER = Counter(
    "mesh_sharded_scatter_total",
    "Dirty-row scatters dispatched against the sp-sharded device table, "
    "by column class (full = host-authoritative row re-upload, cap = "
    "capacity/feature columns only) — each lands mid-flight with no "
    "quiesce, into every storage once",
    ("cols",),
)
_MESH_FEED_DEPTH = Gauge(
    "mesh_feed_staged_depth",
    "Batches staged or encoding across per-dp-shard host feeds "
    "(snapshot/hotfeed.ShardedHostFeed; up to dp per mesh coordinator)",
    (),
)
_MESH_FEED_DEPTH.set_function(
    lambda: sum(
        racy_read(c, "_feed").depth() for c in list(_LIVE)
        if isinstance(racy_read(c, "_feed"), ShardedHostFeed)
    )
)
# ---- failover: fencing and warm-standby evidence -------------------------
_FENCE_REJECTED = Counter(
    "fencing_rejected_total",
    "Store writes refused by the lease-epoch fence, by path — a deposed "
    "or paused reign's in-flight waves draining to requeue instead of "
    "the store (control/leader.LeaseFence)",
    ("path",),
)
_MIRROR_LAG = Gauge(
    "standby_mirror_lag_rows",
    "Watch events the warm-standby mirror had not yet applied at its "
    "last follow tick (0 = the mirror tracks the store tick-for-tick; "
    "bounds the takeover reconcile)",
    (),
)
_RECONCILE_REPAIRS = Counter(
    "failover_reconcile_repairs_total",
    "Mirror-vs-store divergences repaired during takeover reconcile, by "
    "kind (normally 0: the watch stream already carried every fact)",
    ("kind",),
)

_BIND_LATENCY = Histogram(
    "coordinator_schedule_to_bind_seconds",
    "Intake-to-bind latency per pod",
    (),
    buckets=(
        0.005, 0.01, 0.02, 0.03, 0.04, 0.05, 0.06, 0.07, 0.08, 0.09,
        0.1, 0.11, 0.13, 0.165, 0.2, 0.25, 0.33, 0.42, 0.55, 0.7, 0.9,
        1.2, 1.6, 2.1, 2.8, 3.7, 5.0, 8.0, 15.0, 30.0, 60.0,
    ),
)


@dataclasses.dataclass(slots=True)
class PendingPod:
    # None = native-intake fast lane: the pod is canonical and label-less
    # (the store's poll_pods parsed it in C), so the full PodInfo is
    # materialized only if a slow path needs it (ensure_pod).
    pod: PodInfo | None
    mod_revision: int | None
    enqueued_at: float
    # Scheduling-relevant scalars, always populated.
    cpu_milli: int = 0
    mem_kib: int = 0
    key_str: str = ""        # "<ns>/<name>"
    attempts: int = 0
    # Raw stored bytes at intake revision — the bind CAS splices
    # nodeName into them without a JSON round trip.
    raw: bytes | None = None
    key_bytes: bytes = b""
    # Earliest perf_counter() time this pod may re-enter a batch.
    not_before: float = 0.0
    # spec.priority — admission and preemption only (never encoded); 0
    # for fast-lane pods, whose canonical shape carries no priority.
    priority: int = 0
    # Gang membership (tenancy/gang.py): namespace-qualified gang id and
    # declared size; "" / 0 = not a gang pod.
    gang_id: str = ""
    gang_size: int = 0

    def peek_pod(self) -> PodInfo:
        """The PodInfo WITHOUT caching it on the record — the host-feed
        worker's form (the record still belongs to the cycle thread)."""
        if self.pod is not None:
            return self.pod
        ns, name = self.key_str.split("/", 1)
        return PodInfo(
            name=name, namespace=ns,
            cpu_milli=self.cpu_milli, mem_kib=self.mem_kib,
        )

    def ensure_pod(self) -> PodInfo:
        if self.pod is None:
            self.pod = self.peek_pod()
        return self.pod


# Structural splice marker: encode_pod always opens spec with
# schedulerName, and this byte pattern cannot occur inside any JSON
# string literal, so its first occurrence is the real spec object.
_SPEC_MARK = b'"spec":{"schedulerName":'


def splice_node_name(raw: bytes, node_name: str) -> bytes | None:
    """Insert spec.nodeName into encoded pod bytes; None if the object
    isn't in the canonical shape (the caller takes the JSON path)."""
    idx = raw.find(_SPEC_MARK)
    if idx < 0 or b'"nodeName"' in raw:
        return None
    cut = idx + 8  # len(b'"spec":{')
    return b'%s"nodeName":%s,%s' % (
        raw[:cut], json.dumps(node_name).encode(), raw[cut:]
    )


_UNSPLICE_MARK = b'"spec":{"nodeName":"'


def unsplice_node_name(raw: bytes) -> bytes | None:
    """Inverse of ``splice_node_name``: remove the spliced spec.nodeName,
    restoring the pre-bind bytes exactly (the eviction path's byte-
    identity half).  None if the object is not in the spliced canonical
    shape (escaped name, nodeName written elsewhere): the caller takes
    the JSON path."""
    idx = raw.find(_UNSPLICE_MARK)
    if idx < 0:
        return None
    start = idx + 8                    # keep b'"spec":{'
    i = idx + len(_UNSPLICE_MARK)      # first byte of the name
    j = raw.find(b'"', i)
    if j < 0 or raw[j + 1 : j + 2] != b"," or b"\\" in raw[i:j]:
        return None
    return raw[:start] + raw[j + 2:]


class _VictimRows:
    """Row-keyed view over the coordinator's incremental by-node victim
    index: the ``victims_by_row`` mapping ``select_preemption`` consumes,
    built per wave in O(nodes with victims).

    Only the row -> node name resolution is materialized up front
    (victims whose node left the snapshot drop out).  ``get`` reads the
    live per-node dict on every call, so evictions earlier in the same
    wave are visible to later preemptors; rows are patched into the
    returned Victims for the replay log."""

    __slots__ = ("_by_node", "_name_at", "_max_seq")

    def __init__(self, by_node: dict, row_of: dict, max_seq: int) -> None:
        self._by_node = by_node
        self._name_at = {row_of[name]: name for name in by_node if name in row_of}
        # Bind-sequence fence: only pods bound BEFORE this view was built
        # are victims, so a preemptor's own bind in this wave is never
        # evicted by a later preemptor of the same wave.
        self._max_seq = max_seq

    def get(self, row: int, default=()):
        name = self._name_at.get(row)
        if name is None:
            return default
        d = self._by_node.get(name)
        if not d:
            return default
        out = [dataclasses.replace(v, row=row) for v in d.values() if v.seq <= self._max_seq]
        return out or default

    def items(self):
        """Materialized (row, victims) pairs — the replay-log dump."""
        return [(row, self.get(row)) for row in sorted(self._name_at)]

    def values(self):
        return [vs for _row, vs in self.items()]

    def __eq__(self, other):
        # Dict-shaped for consumers that compare with the materialized
        # per-row index.
        if isinstance(other, (dict, _VictimRows)):
            return dict(self.items()) == (
                other if isinstance(other, dict) else dict(other.items())
            )
        return NotImplemented

    __hash__ = None


# Options of the JAX coordinator the port leaves out (none since the mesh).
_NOT_PORTED = ()


@guarded_by(
    # Webhook-style intake threads may touch only the staging list, and
    # only under its lock; everything else belongs to the thread that
    # drives step()/flush().
    _external="_external_lock",
    _inflights=THREAD_OWNER,
    _backoff=THREAD_OWNER,
    queue=THREAD_OWNER,
    _queued_keys=THREAD_OWNER,
    _dirty_rows=THREAD_OWNER,
    _dirty_caps=THREAD_OWNER,
    _midflight_rows=THREAD_OWNER,
    _gang_staging=THREAD_OWNER,
    _gang_parked=THREAD_OWNER,
    _bind_meta=THREAD_OWNER,
    _victims_by_node=THREAD_OWNER,
    _node_infos=THREAD_OWNER,
)
class Coordinator:
    """Single-process scheduling coordinator over an in-process store."""

    def __init__(
        self,
        store: MemStore,
        table_spec: TableSpec,
        pod_spec: PodSpec,
        profile: Profile,
        *,
        chunk: int = 16384,
        k: int = 4,
        with_constraints: bool = True,
        backend: str = "auto",
        max_attempts: int = 5,
        retry_policy: RetryPolicy | None = None,
        scheduler_name: str = DEFAULT_SCHEDULER,
        seed: int = 0,
        flight_recorder: FlightRecorder | None = None,
        # Sampling profiler (obs/profiler.py) dumped beside a slow-cycle
        # flight dump.
        profiler=None,
        # Per-pod lifecycle tracing (obs/podtrace.py): a PodTracer head-
        # samples 1-in-N pods by pod-key hash and records each one's
        # journey as a contiguous span chain.  None installs the null
        # tracer: every emit site is behind one ``enabled`` read.  A traced
        # pod whose schedule-to-bind exceeds the flight recorder's
        # threshold dumps the ring with its span chain attached.
        tracer=None,
        pipeline: bool = False,
        depth: int = 2,
        watch_queue_cap: int = DEEP_WATCH_QUEUE,
        score_pct: int = 100,
        intake_filter=None,
        # Host feed: encode batch N+1 in a worker thread while batch N is
        # in flight; None = follow ``pipeline``.
        hotfeed: bool | None = None,
        # Device-snapshot layout ("off" | "packed"; None defers to
        # K8S1M_PACKING).  Fail-closed: vocab drift past the packed bit
        # budget rebuilds under a wider layout, never truncates.
        packing: str | None = None,
        # Incremental scheduling (engine/deltacache.py): cached per-shape
        # planes, recomputed over dirty rows only; None defers to
        # K8S1M_DELTASCHED.  Engages only for full-scan waves (score_pct
        # 100, no row mask).
        deltacache: str | bool | None = None,
        delta_slots: int = 64,
        delta_index_k: int = 0,
        stratum_bits: int = 0,
        delta_index_dirty_cap: int | None = None,
        device: str | torch.device = "cuda",
        # Power-of-two batch buckets from min_batch up to pod_spec.batch
        # instead of one fixed size (the paced lane's latency mode).
        adaptive_batch: bool = False,
        # Overload control (loadshed/): the HealthController sheds at
        # submit_external and degrades the waves while pressure lasts;
        # the CircuitBreaker guards the wave launch and falls back to the
        # host oracle while open.  None = none of that runs.
        loadshed: HealthController | None = None,
        breaker: CircuitBreaker | None = None,
        # Tenancy (tenancy.TenancyController): weighted-fair admission,
        # preemption and gangs.  Without an explicit ``loadshed`` its
        # HealthController is adopted as the loadshed controller too.
        tenancy=None,
        # Lease-epoch fencing token (control/leader.LeaseFence): when set,
        # every bind/evict/preempt store write flows through the fenced
        # helpers and is refused once the reign is deposed — in-flight
        # waves drain to requeue, never to the store.  None (standalone
        # coordinators, tests) = writes always admitted.
        fence=None,
        # dp x sp mesh (parallel/): a parallel.Mesh, a spec string
        # ("2x2", "auto", "none") or None, which defers to K8S1M_MESH.
        mesh=None,
        **not_ported,
    ):
        for name, value in not_ported.items():
            if name not in _NOT_PORTED:
                raise TypeError(f"unexpected keyword argument {name!r}")
            if value not in (None, False, "none"):
                raise NotImplementedError(
                    f"Coordinator({name}=...) is not part of the port"
                )
        self.device = resolve_device(device)
        self.backend = resolve_backend(backend, self.device)
        self.store = store
        self.table_spec = table_spec
        self.pod_spec = pod_spec
        self.profile = profile
        self.chunk = chunk
        self.k = k
        # max_attempts stays the constructor-level knob, overriding the
        # policy's budget.
        self.retry_policy = dataclasses.replace(
            retry_policy or policy_for("coordinator.bind"),
            max_attempts=max_attempts,
        )
        self.max_attempts = max_attempts
        self.scheduler_name = scheduler_name
        self.flight = flight_recorder
        self.profiler = profiler
        self._tracer = tracer if tracer is not None else NULL_TRACER
        # Pods that spent their retry budget in this wave (kept only while
        # tracing): the retire pass closes their chains after the device
        # and bind spans land.
        self._trace_gaveup: set[str] = set()
        self._profile_dumps = 0
        if not 0 <= stratum_bits <= JITTER_BITS:
            raise ValueError(
                f"stratum_bits must be in [0, {JITTER_BITS}], got {stratum_bits}"
            )
        self.stratum_bits = stratum_bits
        self.pipeline = pipeline
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self.depth = depth
        self.watch_queue_cap = watch_queue_cap
        self._inflights: list[Wave] = []
        # percentageOfNodesToScore: each cycle filters+scores one rotating
        # chunk-aligned window of the table.
        if not 1 <= score_pct <= 100:
            raise ValueError(f"score_pct must be in [1, 100], got {score_pct}")
        # Mesh scale-out: rows split over sp, pods over dp; windows rotate
        # SHARD-LOCALLY (each shard samples its own rows, as each
        # dist-scheduler replica samples the nodes it owns).
        from k8s1m_tpu_torch.parallel.mesh import resolve_mesh

        mesh = resolve_mesh(mesh, batch=pod_spec.batch, max_nodes=table_spec.max_nodes,
                            chunk=chunk, device=self.device)
        self.mesh = mesh
        if mesh is not None:
            dp_size, sp_size = mesh.shape["dp"], mesh.shape["sp"]
            local_rows = table_spec.max_nodes // sp_size
            if local_rows * sp_size != table_spec.max_nodes:
                raise ValueError(
                    f"max_nodes {table_spec.max_nodes} not divisible by sp={sp_size}"
                )
            if local_rows % chunk:
                raise ValueError(
                    f"rows-per-shard {local_rows} not divisible by chunk {chunk}"
                )
            if pod_spec.batch % dp_size:
                raise ValueError(f"batch {pod_spec.batch} not divisible by dp={dp_size}")
            self._window_nodes = local_rows
        else:
            self._window_nodes = table_spec.max_nodes
        self._sample_rows = sample_rows_for(self._window_nodes, score_pct, chunk)
        self._window_i = 0
        # Overload control: the degraded knobs are precomputed, so the
        # mode switch is a swap of arguments.
        self.tenancy = tenancy
        if tenancy is not None:
            if loadshed is None:
                loadshed = tenancy.controller
            elif loadshed is not tenancy.controller:
                # A second controller would never be ticked: its admission
                # count would grow until every admission hit the cap.
                raise ValueError(
                    "tenancy and loadshed must share one HealthController: pass "
                    "loadshed=tenancy.controller or omit loadshed"
                )
        self.loadshed = loadshed
        self.breaker = breaker
        if loadshed is not None:
            # sample_rows_for rounds the window up to a whole chunk: a 1%
            # window of 1,048,576 rows at chunk 4096 scores 12,288 rows.
            self._sample_rows_degraded = sample_rows_for(
                self._window_nodes, min(score_pct, loadshed.config.degraded_score_pct), chunk,
            )
            self._profile_degraded = degraded_profile(profile)
        else:
            self._sample_rows_degraded = self._sample_rows
            self._profile_degraded = profile
        self._last_cycle_s = 0.0
        # Signal baselines for the per-cycle controller tick (the
        # counters are process-global: several live coordinators only
        # ever over-report pressure).
        self._sig_conflicts = _PODS_SCHEDULED.value(outcome="conflict")
        self._sig_resyncs = _RESYNCS.value()
        # Breaker-open oracle fallback: decoded (row, NodeInfo) list keyed
        # on the count of applied node events, over an incremental
        # NodeInfo index kept at the watch-drain decode sites (rows from
        # the bulk ingest are seeded lazily from one store decode).
        self._fallback_cache: tuple[int, list] | None = None
        self._node_gen = 0
        self._node_infos: dict[str, object] = {}

        # The PackingSpec is built at first table upload, so the label-
        # fusion decision sees the bootstrap vocab.
        self._packing_mode = resolve_packing(packing)
        self._packing_spec = None
        self._donation_inplace: bool | None = None
        self._packing_rebuilding = False

        self.host = NodeTableHost(table_spec)
        self._bulk = BulkNodeLoader(self.host)
        self.tracker = ConstraintTracker(table_spec)
        # One shape-keyed template cache shared by every encoder.
        self.encode_cache = EncodeCache()
        self.encoder = HotPodBatchHost(
            pod_spec, table_spec, self.host.vocab, cache=self.encode_cache
        )
        self.adaptive_batch = adaptive_batch
        self.min_batch = min(64, pod_spec.batch)
        self._encoders = {pod_spec.batch: self.encoder}
        if hotfeed is None:
            hotfeed = pipeline
        dp_shards = mesh.shape["dp"] if mesh is not None else 1
        if not hotfeed:
            self._feed = None
        elif dp_shards > 1:
            # One feed per dp rank: dp workers encode the wave's contiguous
            # slices concurrently (sharing the template cache) and claim()
            # merges them byte-identically to the inline encode.
            self._feed = ShardedHostFeed([
                HotPodBatchHost(
                    dataclasses.replace(pod_spec, batch=pod_spec.batch // dp_shards),
                    table_spec, self.host.vocab, cache=self.encode_cache, path="feed",
                )
                for _ in range(dp_shards)
            ])
        else:
            self._feed = HostFeed(HotPodBatchHost(
                pod_spec, table_spec, self.host.vocab,
                cache=self.encode_cache, path="feed",
            ))
        if self._feed is not None:
            # A coordinator dropped without close() must not leak the
            # parked worker thread.
            weakref.finalize(self, self._feed.close)
        # Reusable scratch for _process_adjusts (zeroed per chunk).
        self._adjust_scratch: dict | None = None
        self.table = None           # device table, built at bootstrap
        self.constraints = (
            empty_constraints(table_spec, self.device) if with_constraints else None
        )
        # Dirty-row scatters and count-table corrections, in place; the
        # mesh forms take each storage once.
        self._scatter = scatter_rows
        self._adjust = adjust_constraints
        if mesh is not None:
            from k8s1m_tpu_torch.parallel.mesh import shard_constraints
            from k8s1m_tpu_torch.parallel.sharded_cycle import (
                make_sharded_scatter,
                sharded_adjust,
            )

            if adaptive_batch and self.min_batch % mesh.shape["dp"]:
                raise ValueError(
                    f"adaptive min batch {self.min_batch} not divisible "
                    f"by dp={mesh.shape['dp']}"
                )
            self._scatter = make_sharded_scatter(mesh)
            self._adjust = sharded_adjust
            if self.constraints is not None:
                self.constraints = shard_constraints(self.constraints, mesh)
        self._delta: DeltaPlaneCache | None = None
        self._delta_fill_enc: HotPodBatchHost | None = None
        if resolve_deltasched(deltacache) == "on":
            self._delta = DeltaPlaneCache(
                table_spec.max_nodes, slots=delta_slots,
                index_k=delta_index_k, stratum_bits=stratum_bits,
                index_dirty_cap=delta_index_dirty_cap, device=self.device,
                sharding=mesh,
            )
            self._delta_fill_enc = HotPodBatchHost(
                dataclasses.replace(pod_spec, batch=self._delta.fill_batch),
                table_spec, self.host.vocab, cache=self.encode_cache,
            )
        elif delta_index_k:
            # An index with no delta cache would never engage.
            raise ValueError(
                "delta_index_k requires deltacache='on' (the candidate "
                "index rides the delta-plane cache)"
            )
        # The JAX coordinator's jax.random.key(seed), split once per wave.
        self.key = prng_key(seed)

        self.queue: collections.deque[PendingPod] = collections.deque()
        self._queued_keys: set[str] = set()
        # Retrying pods waiting out their backoff: (not_before, seq, pod)
        # min-heap.  Their keys stay in _queued_keys.
        self._backoff: list[tuple[float, int, PendingPod]] = []
        self._backoff_seq = 0
        # Gang staging: gid -> (declared size, members by key).  Members
        # enter the queue together once all are present.
        self._gang_staging: dict[str, tuple[int, dict[str, PendingPod]]] = {}
        # Gangs waiting out a whole-group backoff: (not_before, seq,
        # members) min-heap, released contiguously.
        self._gang_parked: list[tuple[float, int, list[PendingPod]]] = []
        self._gang_oversize: set[str] = set()
        # Per-bound-pod preemption metadata, parallel to _bound:
        # key -> (priority, bind seq, tenant, gang id).  A nonempty gang
        # id makes the pod unpreemptable.
        self._bind_meta: dict[str, tuple[int, int, str, str]] = {}
        self._bind_seq = 0
        # Incremental preemption-victims index: node name -> {pod key ->
        # Victim}, kept at the same sites as _bound, only when preemption
        # can run; rows resolve at wave time (_VictimRows).
        self._track_victims = bool(tenancy is not None and tenancy.policy.preempt_enabled)
        self._victims_by_node: dict[str, dict[str, Victim]] = {}
        # Replayable preemption evidence (tenancy.policy.log_preemptions;
        # bounded).
        self.preempt_log: list[dict] = []
        # External intake staging (submit_external): appended from any
        # thread under the lock, drained into the queue each cycle.
        self._external: list[dict] = []
        self._external_lock = threading.Lock()
        # Seeded jitter stream: a replayed run replays the same backoff.
        self._retry_rng = random.Random(seed ^ 0xFA017)
        self._sched_bytes = scheduler_name.encode()
        self._name_bytes: list[bytes] = []
        # Per-namespace tracker matches for the EMPTY label set, keyed by
        # the tracker's registration counts.
        self._empty_incs_cache: dict[tuple[int, int, str], tuple] = {}
        # Bound-pod record per pod key: (node, cpu, mem, zone, region, pod?).
        # The PodInfo is kept only for constraint-carrying pods (needed to
        # decrement count tables on deletion).
        self._bound: dict[str, tuple] = {}
        # Constraint-count corrections awaiting a batched device scatter:
        # (pod, node_name, zone, region, sign).
        self._pending_adjusts: list[tuple[PodInfo, str, int, int, int]] = []
        # Bound pods whose node is not in the snapshot yet.
        self._orphan_bound: dict[str, PodInfo] = {}
        # Two dirty classes: _dirty_rows re-uploads the FULL row (host
        # authoritative for the request totals too); _dirty_caps only the
        # capacity/feature columns, leaving the in-flight assumes intact.
        self._dirty_rows: set[int] = set()
        self._dirty_caps: set[int] = set()
        # Rows whose FULL scatter happened while waves were in flight:
        # each retiring wave re-dirties the rows it bound here.
        self._midflight_rows: set[int] = set()
        self.depth_timer = LevelTimer()
        # Waves launched, by path ("full" = the fused kernel's pass,
        # "delta" = the deltasched pass).
        self.waves: collections.Counter = collections.Counter()
        # Binds retired by a flush outside step()'s own accounting.
        self._deferred_binds = 0
        self._stage_excluded = 0.0
        self._nodes_watch: Watcher | None = None
        self._pods_watch: Watcher | None = None
        self._bind_excludes = False
        self.unschedulable: dict[str, PodInfo] = {}
        # Shard hooks: pods whose key fails the intake filter are another
        # shard's; the row mask restricts candidate rows.
        self.intake_filter = intake_filter
        self._row_mask_np: np.ndarray | None = None
        self._row_mask_dev: torch.Tensor | None = None
        # Failover state: the reign's fencing token, the warm-standby
        # follower flag (mirrors never schedule and are excluded from the
        # depth gauges), and the one-shot warm-up latch the standby sets
        # ahead of takeover (warm_compile).
        self.fence = fence
        self._follower = False
        self._warmed = False
        _LIVE.add(self)

    def set_row_mask(self, mask: np.ndarray | None) -> None:
        """Install (or clear) the owned-node mask for sharded scheduling:
        bool[max_nodes], candidate selection only."""
        if self.mesh is not None and mask is not None:
            raise ValueError(
                "row masks (process-level node sharding) and a device "
                "mesh are different scale-out axes; compose them across "
                "processes, not inside one coordinator"
            )
        # The fallback node list bakes the mask in.
        self._fallback_cache = None
        if mask is None:
            self._row_mask_np = None
            self._row_mask_dev = None
            return
        mask = np.ascontiguousarray(np.asarray(mask, bool))
        if mask.shape != (self.table_spec.max_nodes,):
            raise ValueError(
                f"row mask shape {mask.shape} != ({self.table_spec.max_nodes},)"
            )
        self._row_mask_np = mask
        self._row_mask_dev = to_tensor(mask, self.device)

    # ---- bootstrap -----------------------------------------------------

    def _relist_nodes(self) -> tuple[list, int]:
        """Full node relist for bootstrap and resync: ``(values,
        revision)``.  The in-process store takes the values-only light
        parse serially (its page parse holds the GIL: sharding buys
        nothing); a wire store fans the value fetch over 8 key-range
        shards so round trips and decodes overlap
        (``store/native.list_prefix_sharded``)."""
        if isinstance(self.store, MemStore):
            return list_prefix_values(self.store, NODES_PREFIX)
        return list_prefix_sharded(self.store, NODES_PREFIX, shards=8, values_only=True)

    def bootstrap(self) -> None:
        """List+watch: load current state, then stream deltas from there.

        The watch starts at the list revision + 1 (the kube informer
        handoff).  The node relist feeds the bulk ingest lane, and the
        whole store->table build is timed into
        ``megarow_cold_build_seconds``."""
        t_cold = time.perf_counter()
        with _CYCLE_TIME.time(stage="bootstrap"):
            values, rev = self._relist_nodes()
            self._bulk.ingest(values)
            del values
            self._nodes_watch = self.store.watch(
                NODES_PREFIX, prefix_end(NODES_PREFIX),
                start_revision=rev + 1, queue_cap=self.watch_queue_cap,
            )
            pod_kvs, pod_rev = list_prefix(self.store, PODS_PREFIX)
            for kv in pod_kvs:
                self._on_pod_put(kv.value, kv.mod_revision)
            self._pods_watch = self.store.watch(
                PODS_PREFIX, prefix_end(PODS_PREFIX),
                start_revision=pod_rev + 1, queue_cap=self.watch_queue_cap,
            )
            self._bind_excludes = isinstance(self._pods_watch, Watcher)
            self.table = self._table_to_device()
        _COLD_BUILD.set(time.perf_counter() - t_cold)

    # ---- watch delta application --------------------------------------

    @staticmethod
    def _constraintful(pod: PodInfo) -> bool:
        return bool(
            pod.spread_incs
            or pod.ipa_incs
            or any(r.required and r.anti for r in pod.affinity_refs)
        )

    def _victims_note(self, key: str, node_name: str, cpu: int, mem: int,
                      priority: int, seq: int, tenant: str, gang: str) -> None:
        """Insert one bound pod into the incremental victims index (both
        _bound insert sites call this).  Gang members are never victims;
        ``row`` is -1 until _VictimRows resolves it."""
        if not self._track_victims or gang:
            return
        self._victims_by_node.setdefault(node_name, {})[key] = Victim(
            key, node_name, -1, cpu, mem, priority, seq, tenant,
        )

    def _victims_drop(self, key: str, node_name: str) -> None:
        if not self._track_victims:
            return
        d = self._victims_by_node.get(node_name)
        if d is not None and d.pop(key, None) is not None and not d:
            del self._victims_by_node[node_name]

    def _note_bound(self, pod: PodInfo, node_name: str, *, external: bool) -> None:
        row = self.host.row_of(node_name)
        zone, region = int(self.host.zone[row]), int(self.host.region[row])
        keep = pod if self._constraintful(pod) else None
        self._bound[pod.key] = (node_name, pod.cpu_milli, pod.mem_kib, zone, region, keep)
        self._bind_seq += 1
        gang = gang_of_labels(pod.labels, pod.namespace)
        gang_id = gang[0] if gang is not None else ""
        tenant = tenant_of_pod(pod)
        self._bind_meta[pod.key] = (pod.priority, self._bind_seq, tenant, gang_id)
        self._victims_note(pod.key, node_name, pod.cpu_milli, pod.mem_kib,
                           pod.priority, self._bind_seq, tenant, gang_id)
        if external and keep is not None and self.constraints is not None:
            # An externally bound pod contributes to domain counts.
            self._pending_adjusts.append((keep, node_name, zone, region, 1))

    def _on_pod_put(self, data: bytes, mod_revision: int, key: bytes = b"") -> None:
        # Fast path for the watch echo of our own binds: skip the decode.
        if key and b'"nodeName"' in data:
            pod_key_str = key[len(PODS_PREFIX):].decode()
            if pod_key_str in self._bound:
                self._queued_keys.discard(pod_key_str)
                return
        try:
            pod = decode_pod(data, self.tracker)
        except Exception:
            # One malformed object must not poison the event stream.
            _DECODE_ERRORS.inc(kind="pod")
            log.exception("undecodable pod object; skipping")
            return
        if pod.node_name:
            # Someone's bind (ours echoing back, or an external writer).
            if pod.key not in self._bound:
                if pod.node_name in self.host._row_of:
                    self._orphan_bound.pop(pod.key, None)
                    self.host.add_pod(pod.node_name, pod.cpu_milli, pod.mem_kib)
                    self._dirty_rows.add(self.host.row_of(pod.node_name))
                    self._note_bound(pod, pod.node_name, external=True)
                else:
                    # Bound to a node not seen yet; account when it arrives.
                    self._orphan_bound[pod.key] = pod
            self._queued_keys.discard(pod.key)
            return
        if pod.scheduler_name != self.scheduler_name:
            return
        if self.intake_filter is not None and not self.intake_filter(pod.key):
            return
        if pod.key in self._queued_keys or pod.key in self._bound:
            return
        self._queued_keys.add(pod.key)
        self._stage_or_queue(PendingPod(
            pod, mod_revision, time.perf_counter(),
            cpu_milli=pod.cpu_milli, mem_kib=pod.mem_kib,
            key_str=pod.key, raw=data,
            key_bytes=key or pod_key(pod.namespace, pod.name),
            priority=pod.priority,
        ), pod)

    def _on_pod_delete(self, key: bytes) -> None:
        pod_key_str = key[len(PODS_PREFIX):].decode()
        tracer = self._tracer
        if tracer.enabled:
            # A pod deleted while pending closes its chain here (a bound
            # pod's trace closed at bind; this no-ops).
            tracer.finish(pod_key_str, "requeue", outcome="deleted")
        self._queued_keys.discard(pod_key_str)
        self._orphan_bound.pop(pod_key_str, None)
        self._bind_meta.pop(pod_key_str, None)
        if self._gang_staging:
            # A deleted member leaves gang staging too: a leaked record
            # would count as load forever and ride a wave as a dead pod.
            for gid, (_size, members) in list(self._gang_staging.items()):
                if members.pop(pod_key_str, None) is not None:
                    if not members:
                        del self._gang_staging[gid]
                    break
        bound = self._bound.pop(pod_key_str, None)
        if bound is not None:
            node_name, cpu, mem, zone, region, keep = bound
            self._victims_drop(pod_key_str, node_name)
            if node_name in self.host._row_of:
                self.host.remove_pod(node_name, cpu, mem)
                self._dirty_rows.add(self.host.row_of(node_name))
            if keep is not None and self.constraints is not None:
                self._pending_adjusts.append((keep, node_name, zone, region, -1))

    def _adopt_orphans(self, node_name: str) -> None:
        for key, pod in list(self._orphan_bound.items()):
            if pod.node_name == node_name:
                del self._orphan_bound[key]
                self.host.add_pod(node_name, pod.cpu_milli, pod.mem_kib)
                self._dirty_rows.add(self.host.row_of(node_name))
                self._note_bound(pod, node_name, external=True)

    def drain_watches(self, max_events: int = 10000) -> int:
        """Apply pending node/pod deltas; returns the number of events.
        A watcher that overflowed its queue or was canceled server-side
        has lost deltas: relist (``resync``), as a kube reflector does;
        so does an injected watch fault."""
        if self._watch_fault():
            return self.resync()
        if self._nodes_watch.dropped or self._pods_watch.dropped:
            log.warning(
                "watch overflow (nodes dropped=%d pods dropped=%d); resyncing",
                self._nodes_watch.dropped, self._pods_watch.dropped,
            )
            return self.resync()
        if self._nodes_watch.canceled or self._pods_watch.canceled:
            log.warning("watch canceled server-side; resyncing")
            return self.resync()
        n = self._drain_node_events(max_events)
        n += self._drain_pod_events(max_events)
        return n

    @staticmethod
    def _watch_fault() -> bool:
        """Faultline hook on the watch drain (``coordinator.watch``/
        ``poll``): ``delay`` sleeps; any failure kind means the watch is
        gone, and True tells the caller to resync."""
        d = faultline.decide("coordinator.watch", "poll")
        if d is None:
            return False
        if d.kind == "delay":
            time.sleep(d.delay_s)
            return False
        log.warning("injected %s on watch drain; resyncing", d.kind)
        return True

    @contextlib.contextmanager
    def _stage(self, stage: str):
        """Stage timer that also feeds the overlap split (inflight=yes
        time ran while device waves were in flight).  Nested out-of-band
        work (the exhaustion quiesce's flush mid-drain) adds its duration
        to _stage_excluded so no second counts into two stages."""
        inflight = "yes" if self._inflights else "no"
        t0 = time.perf_counter()
        excl0 = self._stage_excluded
        try:
            yield
        finally:
            dt = time.perf_counter() - t0 - (self._stage_excluded - excl0)
            _CYCLE_TIME.observe(dt, stage=stage)
            _PIPE_OVERLAP.inc(dt, stage=stage, inflight=inflight)

    def _upsert_node(self, node) -> int:
        """host.upsert with the one structural quiesce left: a full table
        whose only free rows sit in the quarantine retires the pipeline,
        releases them, and retries."""
        try:
            return self.host.upsert(node)
        except RowsExhausted as e:
            if not e.quarantined:
                raise           # genuinely full; re-bucket TableSpec
            if self._inflights:
                _PIPE_QUIESCE.inc(reason="structural")
                # Plain assignment: flush() already folds prior deferred
                # credit into its return.
                t0 = time.perf_counter()
                self._deferred_binds = self.flush()
                self._stage_excluded += time.perf_counter() - t0
            self.host.release_rows(None)
            return self.host.upsert(node)

    def _drain_node_events(self, max_events: int = 10000) -> int:
        """Apply node deltas — pipeline-safe: an update to a node the
        table holds is capacity-only (_dirty_caps); a new node allocates
        a fresh or released row and a remove tombstones its row into the
        wave-epoch quarantine (both _dirty_rows)."""
        if not self._inflights:
            # Idle pipeline: every quarantined row is past its hazard.
            self.host.release_rows(None)
        n = 0
        row_of = self.host._row_of
        with self._stage("drain"):
            for etype, key, value, _mrev in drain_events_light(
                self._nodes_watch, max_events
            ):
                n += 1
                if etype == 0:
                    try:
                        node = decode_node(value)
                    except Exception:
                        _DECODE_ERRORS.inc(kind="node")
                        log.exception("undecodable node object; skipping")
                        continue
                    if node.name in row_of:
                        self._dirty_caps.add(self._upsert_node(node))
                    else:
                        self._dirty_rows.add(self._upsert_node(node))
                        self._adopt_orphans(node.name)
                    self._node_infos[node.name] = node
                else:
                    name = key[len(NODES_PREFIX):].decode()
                    self._node_infos.pop(name, None)
                    if name in row_of:
                        self._dirty_rows.add(self.host.remove(name))
        self._node_gen += n
        return n

    def _drain_pod_events(self, max_events: int = 10000) -> int:
        """Apply pod deltas (capacity accounting only — safe while waves
        are in flight), draining to momentarily empty through the native
        columnar drain."""
        n = 0
        batch = min(max_events, 10000)
        with self._stage("drain"):
            while True:
                evb = self._pods_watch.poll_pods(batch, self._sched_bytes)
                if evb.n:
                    self._apply_pod_batch(evb)
                    n += evb.n
                if evb.n < batch or n >= 20 * max_events:
                    return n

    def _apply_pod_batch(self, evb) -> None:
        """Apply one columnar poll_pods drain.  CANONICAL means the native
        parser accepted the exact encode_pod shape (label-less);
        everything else takes _on_pod_put's full decode."""
        plen = len(PODS_PREFIX)
        koff = evb.koff.tolist()
        kb = evb.key_blob
        etype = evb.etype
        flags = evb.flags
        fast = POD_CANONICAL | POD_SCHED_MATCH
        fastmask = (etype == 0) & ((flags & (fast | POD_HAS_NODE)) == fast)
        now = time.perf_counter()
        tracer = self._tracer
        tr_on = tracer.enabled
        tr = self.tracker
        has_constraints = bool(tr._spread or tr._affinity)
        if fastmask.all() and not has_constraints:
            # Pure create wave: one batched tolist per column.
            cpu_l = evb.cpu.tolist()
            mem_l = evb.mem.tolist()
            mrev_l = evb.mrev.tolist()
            queued = self._queued_keys
            bound = self._bound
            q = self.queue
            filt = self.intake_filter
            for i in range(evb.n):
                key = kb[koff[i] : koff[i + 1]]
                ks = key[plen:].decode()
                if ks in queued or ks in bound:
                    continue
                if filt is not None and not filt(ks):
                    continue
                queued.add(ks)
                q.append(PendingPod(
                    None, mrev_l[i], now,
                    cpu_milli=cpu_l[i], mem_kib=mem_l[i],
                    key_str=ks, key_bytes=key,
                ))
                if tr_on:
                    tracer.begin(ks, now, source="intake")
            return
        aoff = evb.aoff.tolist()
        ab = evb.aux_blob
        cpu_l = evb.cpu.tolist()
        mem_l = evb.mem.tolist()
        mrev_l = evb.mrev.tolist()
        flags_l = flags.tolist()
        etype_l = etype.tolist()
        for i in range(evb.n):
            key = kb[koff[i] : koff[i + 1]]
            if etype_l[i] == 1:
                self._on_pod_delete(key)
                continue
            f = flags_l[i]
            if not f & POD_CANONICAL:
                self._on_pod_put(ab[aoff[i] : aoff[i + 1]], mrev_l[i], key)
                # decode_pod may have interned a new constraint whose
                # empty selector matches later canonical pods.
                has_constraints = bool(tr._spread or tr._affinity)
                continue
            ks = key[plen:].decode()
            if f & POD_HAS_NODE:
                # A bind: ours echoing back (the slow _bind path echoes),
                # or an external writer's.
                if ks in self._bound:
                    self._queued_keys.discard(ks)
                    continue
                node_name = ab[aoff[i] : aoff[i + 1]].decode()
                ns, name = ks.split("/", 1)
                pod = PodInfo(
                    name=name, namespace=ns,
                    cpu_milli=cpu_l[i], mem_kib=mem_l[i], node_name=node_name,
                )
                if has_constraints:
                    si, ii = self._empty_incs(ns)
                    pod.spread_incs = list(si)
                    pod.ipa_incs = list(ii)
                if node_name in self.host._row_of:
                    self._orphan_bound.pop(ks, None)
                    self.host.add_pod(node_name, pod.cpu_milli, pod.mem_kib)
                    self._dirty_rows.add(self.host.row_of(node_name))
                    self._note_bound(pod, node_name, external=True)
                else:
                    self._orphan_bound[ks] = pod
                self._queued_keys.discard(ks)
                continue
            if not f & POD_SCHED_MATCH:
                continue
            if ks in self._queued_keys or ks in self._bound:
                continue
            if self.intake_filter is not None and not self.intake_filter(ks):
                continue
            pod = None
            if has_constraints:
                ns, name = ks.split("/", 1)
                si, ii = self._empty_incs(ns)
                if si or ii:
                    # Matches an empty-selector constraint: not plain.
                    pod = PodInfo(
                        name=name, namespace=ns,
                        cpu_milli=cpu_l[i], mem_kib=mem_l[i],
                    )
                    pod.spread_incs = list(si)
                    pod.ipa_incs = list(ii)
            self._queued_keys.add(ks)
            self.queue.append(PendingPod(
                pod, mrev_l[i], now,
                cpu_milli=cpu_l[i], mem_kib=mem_l[i],
                key_str=ks, key_bytes=key,
            ))
            if tr_on:
                tracer.begin(ks, now, source="intake")

    def _node_name_bytes(self) -> list:
        """Encoded node names, index-parallel with vocab.node_names."""
        nb = self._name_bytes
        tv = self.host.vocab.node_names._to_val
        while len(nb) < len(tv):
            v = tv[len(nb)]
            nb.append(v.encode() if isinstance(v, str) else b"")
        return nb

    def _empty_incs(self, namespace: str) -> tuple:
        """Cached tracker matches for a label-less pod in ``namespace``."""
        tr = self.tracker
        key = (len(tr._spread), len(tr._affinity), namespace)
        incs = self._empty_incs_cache.get(key)
        if incs is None:
            if len(self._empty_incs_cache) >= 1024:
                self._empty_incs_cache.clear()
            incs = (
                tuple(tr.spread_matches(namespace, {})),
                tuple(tr.affinity_matches(namespace, {})),
            )
            self._empty_incs_cache[key] = incs
        return incs

    def resync(self) -> int:
        """Full relist after a lost watch: reconcile host state against
        the store and restart both watches from the list revisions."""
        _RESYNCS.inc()
        self._node_gen += 1
        # The bulk relist refreshes rows without decoding them: drop the
        # fallback's NodeInfo index; the next fallback call re-seeds it.
        self._node_infos.clear()
        if self._inflights:
            # The relist rebuilds the row mapping, which no wave may
            # straddle.
            self._deferred_binds = self._quiesce("resync")
        self.host.release_rows(None)
        self._midflight_rows.clear()
        if self._delta is not None:
            self._delta.drop_all("resync")
        with _CYCLE_TIME.time(stage="resync"):
            self._nodes_watch.cancel()
            self._pods_watch.cancel()
            values, rev = self._relist_nodes()
            rows = self._bulk.ingest(values)
            del values
            self._dirty_rows.update(rows.tolist())
            # Listed names read back from the ingested rows.
            nv = self.host.vocab.node_names._to_val
            listed = {nv[i] for i in self.host.name_id[rows].tolist()}
            stale = [name for name in self.host._row_of if name not in listed]
            for name in stale:
                self._dirty_rows.add(self.host.remove(name))
            self._nodes_watch = self.store.watch(
                NODES_PREFIX, prefix_end(NODES_PREFIX),
                start_revision=rev + 1, queue_cap=self.watch_queue_cap,
            )
            pod_kvs, pod_rev = list_prefix(self.store, PODS_PREFIX)
            seen = set()
            for kv in pod_kvs:
                seen.add(kv.key[len(PODS_PREFIX):].decode())
                self._on_pod_put(kv.value, kv.mod_revision)
            for key in list(self._bound):
                if key not in seen:
                    ns, name = key.split("/", 1)
                    self._on_pod_delete(pod_key(ns, name))
            self._orphan_bound = {
                k: v for k, v in self._orphan_bound.items() if k in seen
            }
            self._pods_watch = self.store.watch(
                PODS_PREFIX, prefix_end(PODS_PREFIX),
                start_revision=pod_rev + 1, queue_cap=self.watch_queue_cap,
            )
        return len(listed) + len(seen)

    # ---- warm standby: follow / promote / crash-consistent recovery ------
    # (driven by control/leader.HACoordinator)

    def follow(self) -> int:
        """One standby-mirror tick: apply the world's deltas and keep every
        cache warm — never schedule, never write to the store.

        The mirror's derived state (queue, bound-pod ledger,
        ``_bind_meta``, gang staging, host mirror, device table, encode
        templates) is thereby a continuous reconstruction from store facts
        + intake replay — exactly the state ``promote()`` inherits at
        takeover, which is why takeover is a bounded reconcile instead of
        a cold boot.  Returns events applied this tick."""
        lag = 0
        for w in (self._nodes_watch, self._pods_watch):
            p = getattr(w, "pending", None)
            if p:
                lag += int(p)
        _MIRROR_LAG.set(lag)
        self._drain_external()
        n = self.drain_watches()
        self._sync_table()
        self._process_adjusts()
        # Keep the mirror's queue close to the true pending backlog:
        # entries the leader already bound would otherwise accumulate all
        # standby long and poison the load signal below (and promote's
        # first waves).  Thresholded so steady follow ticks stay O(1).
        if len(self.queue) >= 2 * max(
            self.pod_spec.batch, len(self._queued_keys) - len(self._backoff)
        ):
            self._purge_settled_queue()
        # Tick the overload/tenancy chain too: HACoordinator stages
        # no-leader webhook pods into this mirror through admission, so the
        # per-tenant buckets must keep refilling (and the health state must
        # track the real backlog) while standby.
        self._loadshed_tick()
        self.warm_compile()
        return n

    def _purge_settled_queue(self) -> int:
        """Drop queue records whose pods are already settled: a follower
        learns of the leader's binds after queueing the same pods, so its
        queue holds stale records for bound keys (``_queued_keys`` was
        discarded; the deque entry was not).  Returns the number purged."""
        stale = sum(
            1 for p in self.queue
            if p.key_str not in self._queued_keys or p.key_str in self._bound
        )
        if stale:
            self.queue = collections.deque(
                p for p in self.queue
                if p.key_str in self._queued_keys and p.key_str not in self._bound
            )
        return stale

    def warm_compile(self) -> bool:
        """Warm the wave ahead of takeover: run one wave over the live table
        shapes and discard every output — no store write, no host
        accounting, no draw from the coordinator's wave seed stream (the
        seed is ``prng_key(0)``'s, as the JAX standby passes ``key(0)``).

        Eager PyTorch has no step to compile: on a card this loads the
        kernel libraries, creates the CUDA context and leaves the caching
        allocator holding the wave's buffers, so the first wave after
        takeover pays none of that.  The wave commits its binds in place,
        so it runs against CLONES of the table and of the constraint state
        — the live mirror survives it.  It encodes the mirror's own queued
        pods (peeked, never popped), so the warmed stage matches the
        traffic the first post-takeover wave carries; it retries each
        follow tick until such pods exist, then latches."""
        if self._warmed or self.table is None:
            return False
        pods = []
        for p in self.queue:
            pods.append(p.peek_pod())
            if len(pods) >= self.pod_spec.batch:
                break
        if not pods:
            return False
        batch = self.encoder.encode_packed(pods)
        tbl = self.table.clone()
        cons = self.constraints.clone() if self.constraints is not None else None
        _t, _asg, rows_dev = schedule_batch_packed(
            tbl, batch, seed_of(prng_key(0)),
            profile=self.profile, constraints=cons,
            chunk=self.chunk, k=self.k, backend=self.backend,
            sample_rows=self._sample_rows, sample_offset=0,
            row_mask=self._row_mask_dev, mesh=self.mesh,
        )
        if rows_dev.is_cuda:
            torch.cuda.synchronize(rows_dev.device)
        self._warmed = True
        return True

    def promote(self, *, acquire_revision: int = 0) -> dict:
        """Warm-standby takeover: turn a following mirror into the leader
        with a bounded reconcile.

        1. Drain the watch backlog (bounded by the mirror's lag; a
           broken/overflowed watch falls back to a full ``resync`` —
           still warm: vocab, encode templates and the kernels survive).
        2. Diff the mirror against the store pinned at the lease-acquire
           revision (``_reconcile_at``): every divergence is repaired
           through the ordinary intake paths and counted — crash
           consistency does not depend on the watch stream having been
           perfect.
        3. Settle gangs the predecessor left partially bound all-or-none
           (``recover_gangs``).
        4. Push repairs to the device and drop follower status.

        Rows whose accounting changed during the reconcile ride the normal
        dirty-row machinery, and the mirror has no in-flight waves by
        construction — so the wave-epoch quarantine starts the new reign
        empty.

        Returns the evidence dict the drills record (repair counts)."""
        stats: dict = {"resync": 0, "repairs": {}, "gangs_released": 0}
        nw, pw = self._nodes_watch, self._pods_watch
        broken = (
            nw is None or pw is None
            or nw.dropped or pw.dropped
            or getattr(nw, "canceled", False)
            or getattr(pw, "canceled", False)
        )
        if broken:
            self.resync()
            stats["resync"] = 1
        else:
            for _ in range(64):
                n = self.drain_watches()
                if n:
                    continue
                # A watcher that exposes the highest revision buffered off
                # the wire (``seen_revision``) keeps pumping until it covers
                # the acquire revision; the in-process store's watch has
                # none, so one empty drain ends the loop.
                seen = getattr(self._pods_watch, "seen_revision", None)
                if seen is None or seen >= acquire_revision:
                    break
            self._drain_external()
            repairs = self._reconcile_at(acquire_revision)
            stats["resync"] = repairs.pop("resync", 0)
            stats["repairs"] = repairs
        # Purge queue entries the predecessor already settled: dropping them
        # spares the first post-takeover waves a conflict storm of
        # already-bound pods — and keeps recover_gangs from reading a
        # fully-bound gang as still pending.
        stats["stale_queue_purged"] = self._purge_settled_queue()
        stats["gangs_released"] = self.recover_gangs()
        self._sync_table()
        self._process_adjusts()
        self._follower = False
        _MIRROR_LAG.set(0)
        return stats

    def _reconcile_at(self, revision: int) -> dict:
        """Crash-consistency audit: list both prefixes PINNED at the
        lease-acquire revision (``store.native.list_prefix(revision=)``)
        and diff against the mirror.

        The mirror has already drained its watches past the pin, so a
        pin-vs-mirror mismatch is ambiguous on its own: either the watch
        stream missed the fact (repair it) or the mirror legitimately
        advanced beyond the pin (leave it alone).  Every candidate repair
        therefore re-reads the store's CURRENT state before mutating — the
        pin bounds what to audit, the current read decides the repair.
        Repairs go through the ordinary intake handlers (``_on_pod_put`` /
        ``_on_pod_delete`` / ``_upsert_node``) so repair and live intake
        can never disagree, and each is counted in
        ``failover_reconcile_repairs_total``.  A pin outside the store's
        window (``CompactedError``/``FutureRevError``) falls back to a
        full ``resync``."""
        rep = {"nodes_added": 0, "nodes_removed": 0, "pods_replayed": 0,
               "binds_adopted": 0, "pods_dropped": 0}
        try:
            # The light parse (names for the nodes, key and value bytes for
            # the pods) skips a KeyValue object per row: a million of them
            # at 1M nodes.  The JAX coordinator lists whole KVs; the repairs
            # are the same.
            node_keys = list_prefix_items(self.store, NODES_PREFIX, revision=revision,
                                          keys_only=True)
            pod_items = list_prefix_items(self.store, PODS_PREFIX, revision=revision)
        except (CompactedError, FutureRevError):
            self.resync()
            return {"resync": 1}
        pod_items = [(key[len(PODS_PREFIX):].decode(), key, value) for key, value in pod_items]
        row_of = self.host._row_of
        listed = set()
        for key in node_keys:
            name = key[len(NODES_PREFIX):].decode()
            listed.add(name)
            if name in row_of:
                continue
            # In the pin but not the mirror: a missed add — unless the node
            # was deleted after the pin (the mirror is right).
            cur = self.store.get(key)
            if cur is None:
                continue
            try:
                node = decode_node(cur.value)
            except Exception:
                _DECODE_ERRORS.inc(kind="node")
                log.exception("undecodable node in reconcile; skipping")
                continue
            self._dirty_rows.add(self._upsert_node(node))
            self._node_infos[node.name] = node
            self._adopt_orphans(name)
            rep["nodes_added"] += 1
        for name in list(row_of):
            if name in listed:
                continue
            # In the mirror but not the pin: a missed delete — unless the
            # node was created after the pin (the mirror is right).
            if self.store.get(node_key(name)) is not None:
                continue
            self._node_infos.pop(name, None)
            self._dirty_rows.add(self.host.remove(name))
            rep["nodes_removed"] += 1
        seen = set()
        for k, key, value in pod_items:
            seen.add(k)
            pinned_bound = b'"nodeName"' in value
            mirror_bound = k in self._bound
            if pinned_bound == mirror_bound:
                continue
            # Pin and mirror disagree: the CURRENT store state decides
            # whether the watch missed a fact or the mirror advanced.
            cur = self.store.get(key)
            if cur is None:
                continue        # deleted meanwhile: the delete echo or the
                                # _bound sweep below settles it
            cur_bound = b'"nodeName"' in cur.value
            if cur_bound and not mirror_bound:
                # A bind the mirror never saw: adopt it as external.
                self._on_pod_put(cur.value, cur.mod_revision, key)
                rep["binds_adopted"] += 1
            elif not cur_bound and mirror_bound:
                # An eviction echo the mirror never saw: undo the accounting
                # and replay the pending object.
                self._on_pod_delete(key)
                self._on_pod_put(cur.value, cur.mod_revision, key)
                rep["pods_replayed"] += 1
        # Intake the mirror missed entirely (pinned pending, tracked
        # nowhere) — replay only if the pod still exists and is still
        # pending now.
        for k, key, value in pod_items:
            if b'"nodeName"' in value or k in self._queued_keys or k in self._bound:
                continue
            cur = self.store.get(key)
            if cur is None or b'"nodeName"' in cur.value:
                continue
            self._on_pod_put(cur.value, cur.mod_revision, key)
            rep["pods_replayed"] += 1
        for k in list(self._bound):
            if k in seen:
                continue
            ns, name = k.split("/", 1)
            kb = pod_key(ns, name)
            # Absent from the pinned list but maybe newer than the pin
            # (bound after acquisition): only the store's current state
            # decides a drop.
            if self.store.get(kb) is None:
                self._on_pod_delete(kb)
                rep["pods_dropped"] += 1
        for kind, n in rep.items():
            if n:
                _RECONCILE_REPAIRS.inc(n, kind=kind)
        return rep

    def recover_gangs(self) -> int:
        """Crash half of gang all-or-none (takeover): a predecessor that
        died between a wave's bind CASes and its gang settlement leaves a
        gang partially bound in the store.  Any gang with both bound
        members and pending members releases the bound ones (fenced evict
        — we hold the lease now) back through gang staging, so the whole
        gang re-rides one wave; gangs whose every member is bound are
        honored via the store untouched.  Returns binds released."""
        if self.tenancy is None or not self.tenancy.policy.gang_enabled:
            return 0
        bound_gangs: dict[str, list[str]] = {}
        for key, meta in self._bind_meta.items():
            if meta[3] and key in self._bound:
                bound_gangs.setdefault(meta[3], []).append(key)
        if not bound_gangs:
            return 0
        pending_gangs = set(self._gang_staging)
        for p in self.queue:
            # Only genuinely-pending members count: a follower's queue can
            # hold stale records for keys the predecessor already bound
            # (settled gangs must read as fully bound, not split).
            if p.gang_id and p.key_str in self._queued_keys and p.key_str not in self._bound:
                pending_gangs.add(p.gang_id)
        for _, _, members in self._gang_parked:
            for p in members:
                if p.gang_id:
                    pending_gangs.add(p.gang_id)
        released = 0
        for gid, keys in bound_gangs.items():
            if gid not in pending_gangs:
                continue        # fully bound: store facts are honored
            for key in keys:
                evicted, rec = self._evict_bound(key, count_eviction=False, path="evict")
                if not evicted:
                    log.warning(
                        "gang %s member %s could not be released at takeover "
                        "(CAS lost); leaving it bound", gid, key,
                    )
                    continue
                released += 1
                if rec is not None:
                    pod = rec.pod
                    g = gang_of_labels(pod.labels, pod.namespace)
                    if g is not None:
                        rec.gang_id, rec.gang_size = g
                    tracer = self._tracer
                    if tracer.enabled:
                        # Takeover requeue: the released member's chain
                        # re-anchors under the new reign before
                        # _stage_or_queue's generic begin can label it as
                        # ordinary intake.
                        tracer.begin(rec.key_str, rec.enqueued_at, source="failover")
                    self._stage_or_queue(rec, pod)
            note_gang("recovered")
            log.info(
                "takeover released partially-bound gang %s "
                "(%d members back to staging)", gid, len(keys),
            )
        return released

    # ---- device table --------------------------------------------------

    @staticmethod
    def _pad_rows(rows: np.ndarray) -> np.ndarray:
        """Sorted, power-of-two-padded scatter indices.  Sorted first (a
        set's order is arbitrary); padding repeats the last row, which
        ``index_copy_`` tolerates only because the repeated values are
        equal."""
        rows.sort()
        cap = 1 << max(0, int(rows.size - 1).bit_length())
        if cap != rows.size:
            rows = np.concatenate([rows, np.repeat(rows[-1:], cap - rows.size)])
        return rows

    def _sync_table(self) -> None:
        """Scatter dirty host rows into the device table — safe while
        waves are in flight: the scatter is ordered after every launched
        wave on the stream.  Capacity-only rows upload the feature columns
        alone; full rows upload everything (host authoritative) and are
        noted in _midflight_rows so retiring waves repair the assumes the
        upload erased (see _complete)."""
        if self.table is None:
            self.table = self._table_to_device()
            self._dirty_rows.clear()
            self._dirty_caps.clear()
            return
        if self._packing_rebuilding:
            # The wholesale re-upload ending the rebuild subsumes these.
            return
        if not self._dirty_rows and not self._dirty_caps:
            return
        with self._stage("sync"):
            if self._delta is not None:
                # Journal the rows BEFORE the scatters: a delta wave
                # enqueued after this recomputes them from the new table.
                self._delta.note_rows(self._dirty_rows)
                self._delta.note_rows(self._dirty_caps)
            if self._dirty_rows:
                self._dirty_caps -= self._dirty_rows
                rows = self._pad_rows(np.fromiter(self._dirty_rows, np.int32))
                try:
                    delta = self._row_delta(rows, ALL_COLUMNS)
                except PackingOverflow as e:
                    self._packing_rebuild(e)
                    return
                if self._inflights:
                    self._midflight_rows.update(self._dirty_rows)
                self._dirty_rows.clear()
                self._scatter(self.table, rows, delta)
                if self.mesh is not None:
                    _MESH_SCATTER.inc(cols="full")
            if self._dirty_caps:
                rows = self._pad_rows(np.fromiter(self._dirty_caps, np.int32))
                try:
                    delta = self._row_delta(rows, CAP_COLUMNS)
                except PackingOverflow as e:
                    self._packing_rebuild(e)
                    return
                self._dirty_caps.clear()
                self._scatter(self.table, rows, delta)
                if self.mesh is not None:
                    _MESH_SCATTER.inc(cols="cap")

    def _table_to_device(self):
        """Build (or rebuild) the device table under the active layout; on
        a mesh it is built on the host and cut into its sp shards."""
        if self.mesh is None:
            return self._build_table(self.device)
        from k8s1m_tpu_torch.parallel.mesh import shard_table

        table = shard_table(self._build_table(torch.device("cpu")), self.mesh)
        self._note_table_bytes(table)
        return table

    def _build_table(self, device):
        if self._packing_mode == "packed":
            if self._packing_spec is None:
                self._packing_spec = build_packing_spec(self.table_spec, self.host.vocab)
                if self._packing_spec is None:
                    # taint_slots too wide for the meta word.
                    _PACKING_FALLBACK.inc(reason="taint_slots")
                    self._packing_mode = "off"
            if self._packing_spec is not None:
                try:
                    table = pack_table_host(self.host, self._packing_spec, device)
                    self._note_table_bytes(table)
                    return table
                except PackingOverflow as e:
                    self._packing_fallback(e)
                    if self._packing_mode == "packed":
                        # Widened (label words split) — one retry; a second
                        # overflow fails closed to unpacked.
                        try:
                            table = pack_table_host(
                                self.host, self._packing_spec, device
                            )
                            self._note_table_bytes(table)
                            return table
                        except PackingOverflow as e2:
                            self._packing_fallback(e2)
        table = self.host.to_device(device)
        self._note_table_bytes(table)
        return table

    @property
    def donation_inplace(self) -> bool | None:
        """Whether the first wave left the table's hot planes in their own
        storage (None until it ran)."""
        return self._donation_inplace

    @property
    def delta_enabled(self) -> bool:
        return self._delta is not None

    @staticmethod
    def _layout_of(table):
        """A table of the live layout: a mesh table's first storage."""
        parts = getattr(table, "parts", None)
        return table if parts is None else parts[0]

    def _note_table_bytes(self, table) -> None:
        layout = "packed" if is_packed(self._layout_of(table)) else "unpacked"
        other = "unpacked" if layout == "packed" else "packed"
        _TABLE_BYTES.set(hbm_bytes(table), layout=layout)
        _TABLE_BYTES.set(0, layout=other)

    def _row_delta(self, rows, columns) -> dict:
        """Dirty-row scatter payload under the live table's layout; raises
        PackingOverflow when a packed width no longer fits."""
        layout = self._layout_of(self.table)
        if is_packed(layout):
            return pack_row_delta(self.host, rows, layout.spec, columns)
        return {c: getattr(self.host, c)[rows] for c in columns}

    def _packing_fallback(self, e: PackingOverflow) -> None:
        """Fail-closed layout widening: label overflow splits the fused
        words (still packed); anything else drops to the plain layout."""
        _PACKING_FALLBACK.inc(reason=e.field)
        if (
            e.field in ("label_key", "label_val")
            and self._packing_spec is not None
            and self._packing_spec.fuse_labels
        ):
            log.warning("packed snapshot: %s; splitting label words", e)
            self._packing_spec = dataclasses.replace(self._packing_spec, fuse_labels=False)
        else:
            log.warning("packed snapshot: %s; falling back to unpacked", e)
            self._packing_mode = "off"
            self._packing_spec = None

    def _packing_rebuild(self, e: PackingOverflow) -> None:
        """A dirty-row delta no longer fits the packed layout: widen, retire
        the pipeline (the in-flight assumes must land before a wholesale
        re-upload), and rebuild from the host mirror."""
        self._packing_fallback(e)
        self._packing_rebuilding = True
        try:
            self._quiesce("packing")
        finally:
            self._packing_rebuilding = False
        if self.mesh is not None:
            # Cross-shard widening: the decision was made once, here on
            # the host; every shard's queued work settles before the
            # wholesale re-upload replaces them.
            self.mesh.synchronize()
        self._dirty_rows.clear()
        self._dirty_caps.clear()
        if self._delta is not None:
            self._delta.drop_all("packing")
        self.table = self._table_to_device()

    # ---- the cycle -----------------------------------------------------

    def _process_adjusts(self) -> None:
        """Batch-apply queued constraint-count corrections (deletions,
        external binds) through the encode cache, with one reused scratch
        arena.  Every host array is copied onto the device
        (``to_tensor``): the scratch is rewritten for the next chunk."""
        if not self._pending_adjusts or self.constraints is None:
            return
        b = self.pod_spec.batch
        pending, self._pending_adjusts = self._pending_adjusts, []
        scr = self._adjust_scratch
        if scr is None:
            scr = self._adjust_scratch = {
                "node_row": np.zeros(b, np.int32),
                "zone": np.zeros(b, np.int32),
                "region": np.zeros(b, np.int32),
                "mask_node": np.zeros(b, bool),
                "mask_dom": np.zeros(b, bool),
            }
        dev = self.device
        for sign in (1, -1):
            group = [a for a in pending if a[4] == sign]
            for off in range(0, len(group), b):
                chunk = group[off : off + b]
                batch = self.encoder.encode_packed([g[0] for g in chunk])
                fields = commit_fields_np(batch.fields, dev)
                for arr in scr.values():
                    arr[:] = 0
                for i, (_, node_name, z, r, _s) in enumerate(chunk):
                    row = self.host._row_of.get(node_name)
                    if row is not None:
                        scr["node_row"][i] = row
                        scr["mask_node"][i] = True
                    scr["zone"][i], scr["region"][i] = z, r
                    scr["mask_dom"][i] = True
                self._adjust(
                    self.constraints, fields,
                    *(to_tensor(scr[n], dev) for n in (
                        "node_row", "zone", "region", "mask_node", "mask_dom")),
                    sign=sign,
                )

    # ---- external intake -------------------------------------------------

    def submit_external(self, obj: dict, *, admitted: bool = False) -> None:
        """Thread-safe intake sink for pods not yet in the store (the JAX
        package's webhook feeds it): the pod is staged and enters the
        queue at the next cycle; the store watch stays the fallback
        intake, deduplicated by key.

        With a loadshed controller this is an admission point: past the
        overload watermarks it raises ``loadshed.Overloaded`` (lowest
        ``spec.priority`` first, hard ``queue_cap``); with a tenancy
        controller the weighted-fair per-tenant form replaces the
        priority floor.  ``admitted=True`` marks a pod whose admission
        already ran, so no pod draws two decisions.

        This is the webhook's sink: it runs on HTTP threads, touches only
        ``_external`` under its lock and never a tensor."""
        tracer = self._tracer
        t_in = time.perf_counter() if tracer.enabled else 0.0
        if not admitted:
            if self.tenancy is not None:
                self.tenancy.admission.check_admit_obj(obj, point="coordinator")
            elif self.loadshed is not None:
                self.loadshed.check_admit(pod_priority_of(obj), point="coordinator")
        if tracer.enabled:
            # The admit span covers the admission decision; begin() no-ops
            # when the webhook already opened this trace at receipt, and
            # the span closes against whichever anchor is live.
            key = pod_key_str_of_obj(obj)
            tracer.begin(key, t_in, source="external")
            attrs = {"point": "webhook" if admitted else "coordinator"}
            if self.tenancy is not None:
                tenant = tenant_of_obj(obj)
                attrs["tenant"] = tenant
                attrs["bucket"] = self.tenancy.admission.bucket_level(tenant)
            tracer.emit(key, "admit", **attrs)
        with self._external_lock:
            self._external.append(obj)

    def _external_pending(self) -> int:
        """Staged external pods (a locked read)."""
        with self._external_lock:
            return len(self._external)

    def _drain_external(self) -> None:
        with self._external_lock:
            if not self._external:
                return
            staged, self._external = self._external, []
        for obj in staged:
            try:
                pod = decode_pod_obj(obj, self.tracker)
            except Exception:
                _DECODE_ERRORS.inc(kind="pod")
                log.exception("undecodable external pod; skipping")
                continue
            if pod.node_name or pod.scheduler_name != self.scheduler_name:
                continue
            if self.intake_filter is not None and not self.intake_filter(pod.key):
                continue
            if pod.key in self._queued_keys or pod.key in self._bound:
                continue
            self._queued_keys.add(pod.key)
            self._stage_or_queue(PendingPod(
                pod, None, time.perf_counter(),
                cpu_milli=pod.cpu_milli, mem_kib=pod.mem_kib,
                key_str=pod.key, key_bytes=pod_key(pod.namespace, pod.name),
                priority=pod.priority,
            ), pod)

    # ---- tenancy: gang staging, eviction, preemption ----------------------

    def _stage_or_queue(self, rec: PendingPod, pod: PodInfo | None) -> None:
        """Queue a decoded intake pod, through gang staging when it carries
        gang labels and tenancy is on: a gang's members enter the queue
        together once all are present, and hold no capacity before.
        Gangs bigger than one wave are scheduled as plain pods, counted
        once per gang."""
        tracer = self._tracer
        if tracer.enabled:
            # No-op for a webhook pod (its trace opened at admission).
            tracer.begin(rec.key_str, rec.enqueued_at, source="intake")
        tn = self.tenancy
        if tn is not None and tn.policy.gang_enabled and pod is not None:
            g = gang_of_labels(pod.labels, pod.namespace)
            if g is not None:
                gid, size = g
                if size > self.pod_spec.batch:
                    if gid not in self._gang_oversize:
                        if len(self._gang_oversize) >= 1024:
                            self._gang_oversize.clear()
                        self._gang_oversize.add(gid)
                        note_gang("oversize")
                        log.warning(
                            "gang %s size %d exceeds wave batch %d; scheduling its "
                            "pods as plain", gid, size, self.pod_spec.batch,
                        )
                else:
                    rec.gang_id, rec.gang_size = gid, size
                    st = self._gang_staging.get(gid)
                    if st is None:
                        st = self._gang_staging[gid] = (size, {})
                    st[1][rec.key_str] = rec
                    if len(st[1]) >= st[0]:
                        del self._gang_staging[gid]
                        if tracer.enabled:
                            # Staging ends for every member when the last
                            # one completes the gang.
                            for m in st[1].values():
                                tracer.emit(m.key_str, "gang_stage", gang=gid, size=st[0])
                        self.queue.extend(st[1].values())
                    return
        self.queue.append(rec)

    def _gang_staged(self) -> int:
        """Pods parked in gang staging (accepted demand: part of the load
        signal)."""
        return sum(len(st[1]) for st in self._gang_staging.values())

    def _evict_bound(self, key_str: str, *, into: PendingPod | None = None,
                     adjust: bool = True, count_eviction: bool = True, path: str = "evict"):
        """CAS a bound pod's stored object back to pending and undo its
        host-mirror accounting: the eviction half of preemption and of
        the gang all-or-none release.  A spliced object is un-spliced
        (the stored bytes return exactly to their pre-bind encoding);
        anything else takes the JSON path.  The freed row is marked
        dirty, so the device table learns it at the next sync — never by
        a direct write.

        Returns ``(evicted, rec)``: whether the bind was reverted, and the
        requeue-ready PendingPod at the post-eviction revision (``into``
        refreshed in place when given), or None when nothing is left to
        requeue.  ``adjust=False`` is for a wave-local gang release,
        whose caller rolls the count tables back through the wave's own
        failed mask."""
        rec = self._bound.get(key_str)
        if rec is None:
            return False, None
        node_name, cpu, mem, zone, region, keep = rec
        ns, name = key_str.split("/", 1)
        kb = pod_key(ns, name)
        ok = False
        for _attempt in range(3):
            cur = self.store.get(kb)
            if cur is None:
                return False, None
            value = unsplice_node_name(cur.value)
            if value is None:
                try:
                    obj = json.loads(cur.value)
                except Exception:
                    _DECODE_ERRORS.inc(kind="pod")
                    log.exception("undecodable bound pod at eviction; skipping")
                    return False, None
                obj.get("spec", {}).pop("nodeName", None)
                value = json.dumps(obj, separators=(",", ":")).encode()
            ok, _, _ = self._fenced_cas(kb, value, required_mod=cur.mod_revision, path=path)
            if ok:
                break
        if not ok:
            return False, None
        self._bound.pop(key_str, None)
        self._bind_meta.pop(key_str, None)
        self._victims_drop(key_str, node_name)
        if node_name in self.host._row_of:
            self.host.remove_pod(node_name, cpu, mem)
            self._dirty_rows.add(self.host.row_of(node_name))
        if adjust and keep is not None and self.constraints is not None:
            self._pending_adjusts.append((keep, node_name, zone, region, -1))
        if count_eviction:
            note_eviction()
        fresh = self.store.get(kb)
        if fresh is None:
            # Deleted after the CAS: the bind was reverted, nothing to
            # requeue.
            return True, None
        p = into
        if p is None:
            pod = decode_pod(fresh.value, self.tracker)
            p = PendingPod(
                pod, fresh.mod_revision, time.perf_counter(),
                cpu_milli=pod.cpu_milli, mem_kib=pod.mem_kib,
                key_str=key_str, raw=fresh.value, key_bytes=kb,
                priority=pod.priority,
            )
        else:
            p.mod_revision = fresh.mod_revision
            p.raw = fresh.value
        self._queued_keys.add(key_str)
        return True, p

    def _preempt_eligible(self, p: PendingPod) -> bool:
        tn = self.tenancy
        return (
            tn is not None
            and tn.policy.preempt_enabled
            and p.priority >= tn.policy.preempt_min_priority
            and p.attempts + 1 >= tn.policy.preempt_after_attempts
        )

    def _victims_index(self) -> _VictimRows:
        """Per-wave view of every preemptable bound pod by row, from the
        incremental by-node index; fenced at the current bind sequence."""
        return _VictimRows(self._victims_by_node, self.host._row_of, self._bind_seq)

    def _victims_index_full(self) -> dict[int, list[Victim]]:
        """The full ``_bound`` scan the incremental index must equal (the
        differential reference of the tests; never on the wave path)."""
        victims_by_row: dict[int, list[Victim]] = {}
        row_of = self.host._row_of
        for key, rec in self._bound.items():
            meta = self._bind_meta.get(key)
            if meta is None:
                prio, seq, tenant, gang = 0, 0, tenant_of_key(key), ""
            else:
                prio, seq, tenant, gang = meta
            if gang:
                continue
            node_name = rec[0]
            row = row_of.get(node_name)
            if row is None:
                continue
            victims_by_row.setdefault(row, []).append(Victim(
                key, node_name, row, rec[1], rec[2], prio, seq, tenant,
            ))
        return victims_by_row

    def _try_preempt(self, p: PendingPod, victims_by_row: _VictimRows) -> bool:
        """Preemption for a pod the wave found no feasible row for: select
        victims (``tenancy/preempt.py``), evict them through the store CAS
        and the dirty-row sync, bind the preemptor host-side on the
        cleared node (a pure function of the host mirror, so the choice
        replays) and requeue every victim.  True when the preemptor
        bound."""
        tn = self.tenancy
        pod = p.ensure_pod()
        tenant = tenant_of_pod(pod)
        nodes = self._fallback_nodes()
        if not nodes:
            return False
        host = self.host
        usage = {
            row: (int(host.cpu_req[row]), int(host.mem_req[row]), int(host.pods_req[row]))
            for row, _ in nodes
        }
        choice = select_preemption(pod, tenant, p.priority, nodes, usage, victims_by_row)
        if choice is None:
            return False
        if tn.policy.log_preemptions and len(self.preempt_log) < 1024:
            self.preempt_log.append({
                "pod": p.key_str,
                "priority": p.priority,
                "tenant": tenant,
                "node": choice.node,
                "row": choice.row,
                "victims": [v.key for v in choice.victims],
                "usage": {str(r): list(u) for r, u in usage.items()},
                "candidates": {
                    str(r): [dataclasses.astuple(v) for v in vs]
                    for r, vs in victims_by_row.items()
                },
            })
        tracer = self._tracer
        for v in choice.victims:
            evicted, rec = self._evict_bound(v.key, path="preempt")
            if not evicted:
                # A concurrent writer beat the eviction CAS: abort (the
                # capacity already freed stays freed); the preemptor
                # retries through the normal path.
                return False
            if rec is not None:
                if tracer.enabled:
                    # The evicted victim re-enters the lifecycle: a fresh
                    # chain anchored at its requeue time.
                    tracer.begin(rec.key_str, rec.enqueued_at, source="evict")
                self.queue.append(rec)
        if not self._bind(p, choice.node):
            return False
        _BIND_LATENCY.observe(time.perf_counter() - p.enqueued_at)
        if tracer.enabled:
            # A host-side bind: the chain closes here (the retire pass
            # finds no live trace and skips it).
            tracer.finish(p.key_str, "bind", outcome="preempt", victims=len(choice.victims))
        # The device never committed this bind: dirty the row and queue
        # the count correction a device commit would have applied.
        self._dirty_rows.add(choice.row)
        if self.constraints is not None:
            rec = self._bound.get(p.key_str)
            if rec is not None and rec[5] is not None:
                self._pending_adjusts.append((rec[5], rec[0], rec[3], rec[4], 1))
        return True

    def _wave_fail(self, p: PendingPod) -> None:
        """Per-pod wave failure: gang members wait for the gang's
        all-or-none settlement (_resolve_gangs); others retry."""
        if self.tenancy is not None and p.gang_id:
            return
        self._retry(p)

    def _resolve_gangs(self, batch_pods, bound_ok, rows, failed) -> int:
        """All-or-none gang settlement at wave retire: a gang with every
        member bound is admitted; any failure releases every provisional
        bind (store CAS back to pending, host accounting undone, rows
        dirty) and requeues the gang as a unit.  Returns the number of
        reverted binds.

        ``rows`` tells device-committed binds (row >= 0: the wave's count
        commit rolls back through ``failed``) from host-side preemption
        or fallback binds (row < 0: rolled back through the queued
        adjusts)."""
        if self.tenancy is None or not self.tenancy.policy.gang_enabled:
            return 0
        gangs: dict[str, list[int]] = {}
        for i, p in enumerate(batch_pods):
            if p.gang_id:
                gangs.setdefault(p.gang_id, []).append(i)
        reverted = 0
        for idxs in gangs.values():
            if all(bound_ok[i] for i in idxs):
                note_gang("bound")
                continue
            members = []
            for i in idxs:
                p = batch_pods[i]
                if bound_ok[i]:
                    device_committed = bool(rows[i] >= 0)
                    evicted, _rec = self._evict_bound(
                        p.key_str, into=p, adjust=not device_committed,
                        count_eviction=False,
                    )
                    if evicted:
                        reverted += 1
                        bound_ok[i] = False
                        if device_committed:
                            failed[i] = True
                    elif p.key_str in self._bound:
                        # The eviction CAS kept losing: the member stays
                        # bound and out of the requeue.
                        log.warning(
                            "gang member %s could not be released (eviction CAS "
                            "lost); leaving it bound", p.key_str,
                        )
                        continue
                members.append(p)
            self._requeue_gang(members)
        return reverted

    def _requeue_gang(self, members: list[PendingPod]) -> None:
        """Requeue a failed gang as a unit: refresh every member from the
        store (as _retry does), then park the whole gang unschedulable
        (retry budget spent) or heap it for one shared backoff."""
        alive: list[PendingPod] = []
        for p in members:
            p.attempts += 1
            cur = self.store.get(p.key_bytes)
            if cur is None:
                self._queued_keys.discard(p.key_str)
                continue
            fresh = decode_pod(cur.value, self.tracker)
            if fresh.node_name:
                self._queued_keys.discard(p.key_str)
                continue
            p.pod = fresh
            p.cpu_milli = fresh.cpu_milli
            p.mem_kib = fresh.mem_kib
            p.mod_revision = cur.mod_revision
            p.raw = cur.value
            p.priority = fresh.priority
            alive.append(p)
        if not alive:
            return
        pol = self.retry_policy
        worst = max(p.attempts for p in alive)
        if worst >= pol.max_attempts:
            for p in alive:
                if self._tracer.enabled:
                    self._trace_gaveup.add(p.key_str)
                _PODS_SCHEDULED.inc(outcome="unschedulable")
                note_give_up("coordinator.bind")
                self.unschedulable[p.key_str] = p.ensure_pod()
                # Keys stay held: the eviction echo must not resurrect a
                # parked member as a plain pod.
                self._queued_keys.add(p.key_str)
            note_gang("parked")
            return
        for p in alive:
            _PODS_SCHEDULED.inc(outcome="retry")
            note_retry("coordinator.bind")
            self._queued_keys.add(p.key_str)
        self._backoff_seq += 1
        heapq.heappush(self._gang_parked, (
            time.perf_counter() + pol.delay_for(worst, self._retry_rng),
            self._backoff_seq, alive,
        ))
        note_gang("requeued")

    def _release_backoff(self) -> None:
        """Move retrying pods (and whole parked gangs) whose backoff has
        expired into the queue; gang members re-enter together."""
        if not self._backoff and not self._gang_parked:
            return
        now = time.perf_counter()
        while self._backoff and self._backoff[0][0] <= now:
            _, _, p = heapq.heappop(self._backoff)
            self.queue.append(p)
        while self._gang_parked and self._gang_parked[0][0] <= now:
            _, _, members = heapq.heappop(self._gang_parked)
            self.queue.extend(members)

    def backoff_wait_s(self) -> float | None:
        """Seconds until the earliest parked retry (pod or gang) is due
        (None when nothing is backing off)."""
        heads = []
        if self._backoff:
            heads.append(self._backoff[0][0])
        if self._gang_parked:
            heads.append(self._gang_parked[0][0])
        if not heads:
            return None
        return max(0.0, min(heads) - time.perf_counter())

    def _encoder_for(self, n: int) -> HotPodBatchHost:
        """Smallest power-of-two batch bucket from ``min_batch`` holding n
        pods (clamped to pod_spec.batch, which need not be a power of
        two); every bucket's encoder shares the one encode cache."""
        if not self.adaptive_batch:
            return self.encoder
        if self.loadshed is not None and self.loadshed.degraded:
            # Overload widens the batch window: small buckets trade waves
            # per pod for latency, the wrong trade while the queue is the
            # problem.
            return self.encoder
        b = self.min_batch
        while b < n:
            b <<= 1
        if b > self.pod_spec.batch:
            return self.encoder
        enc = self._encoders.get(b)
        if enc is None:
            enc = HotPodBatchHost(
                dataclasses.replace(self.pod_spec, batch=b),
                self.table_spec, self.host.vocab, cache=self.encode_cache,
            )
            self._encoders[b] = enc
        return enc

    def _take_batch(self):
        """Pop and encode up to one batch of pending pods; (None, None)
        when the queue is empty.  A feed-staged batch is claimed first;
        the claim fails closed (queue prefix or vocab moved) and the
        inline cached encode covers it."""
        self._release_backoff()
        if not self.queue:
            return None, None
        batch_pods: list[PendingPod] = []
        cur_gang = ""
        while self.queue and len(batch_pods) < self.pod_spec.batch:
            head = self.queue[0]
            if (
                head.gang_id
                and head.gang_id != cur_gang
                and head.gang_size > self.pod_spec.batch - len(batch_pods)
            ):
                # A gang never splits across a batch: close this one and
                # let the gang open the next wave whole.
                break
            cur_gang = head.gang_id
            batch_pods.append(self.queue.popleft())
        if not batch_pods:
            return None, None
        for p in batch_pods:
            self._queued_keys.discard(p.key_str)
        tracer = self._tracer
        tr_on = tracer.enabled
        if tr_on:
            t_pop = time.perf_counter()
            hits0, miss0 = cache_counts()
        claimed = False
        with self._stage("encode"):
            batch = None
            if self._feed is not None:
                batch = self._feed.claim(batch_pods, self.host.vocab.feed_generation())
                claimed = batch is not None
            if batch is None:
                batch = encode_batch(self._encoder_for(len(batch_pods)), batch_pods)
        if tr_on:
            t_enc = time.perf_counter()
            hits1, miss1 = cache_counts()
            path = "feed" if claimed else "inline"
            dh, dm = hits1 - hits0, miss1 - miss0
            for p in batch_pods:
                tracer.emit(p.key_str, "queue_wait", t=t_pop, attempts=p.attempts)
                tracer.emit(p.key_str, "encode", t=t_enc, path=path,
                            cache_hits=dh, cache_misses=dm)
        return batch_pods, batch

    def _next_window(self, rows: int) -> int:
        i = self._window_i
        self._window_i += 1
        return sample_offset_for(i, self._window_nodes, rows)

    def _active_knobs(self):
        """(profile, sample_rows) of the next wave: the configured pair
        when HEALTHY, the degraded pair while the controller reports
        pressure."""
        if self.loadshed is not None and self.loadshed.degraded:
            self.loadshed.note_degraded_cycle()
            return self._profile_degraded, self._sample_rows_degraded
        return self.profile, self._sample_rows

    # ---- deltasched: plane-cached waves (engine/deltacache.py) ---------

    @staticmethod
    def _delta_key(p: PendingPod):
        """The pod's plane-cache shape key, or None (uncacheable).  Fast-
        lane pods are canonical label-less plain pods by construction."""
        if p.pod is None:
            return (PLAIN, p.cpu_milli, p.mem_kib)
        return shape_key(p.pod)

    def _plan_delta(self, batch_pods, batch):
        """Plan this wave's delta path: shape-key lookups, plane fills for
        recurring cold shapes (issued here, before the wave), and the
        journaled dirty slice.  Returns the WavePlan when the wave may run
        the delta step, None for the ordinary full pass."""
        cache = self._delta
        gen = self.host.vocab.generation()
        cache.check_generation(gen)
        plan = cache.plan([self._delta_key(p) for p in batch_pods], batch.batch)
        if plan.fill_idx:
            try:
                reps = [batch_pods[i].ensure_pod() for i in plan.fill_idx]
                fill_pb = self._delta_fill_enc.encode_packed(reps)
            except ValueError:
                # Representatives overflowed a fill-batch bound: take the
                # full pass — never a partial fill.
                cache.abort_fills(plan)
                return None
            fs = np.full(cache.fill_batch, cache.slots, np.int32)
            fs[: len(plan.fill_slots)] = plan.fill_slots
            try:
                planes = fill_shape_planes(
                    self.table, fill_pb, fs, cache.planes(gen),
                    profile=self.profile, chunk=self.chunk, mesh=self.mesh,
                )
            except Exception:
                # The planes are in an unknown state: drop them and
                # re-raise.
                cache.reset("fill-error")
                raise
            cache.commit(*planes)
            cache.note_fill(plan)
        return plan if plan.slot_ids is not None else None

    def _launch_delta(self, batch, seed: int, plan):
        """Issue the delta wave: filter+score over the dirty slice and the
        in-flight waves' bound rows (their ``rows_dev``, on the stream),
        merged into the cached planes, the delta kernel's top-K, the
        shared greedy/commit epilogue.  Constraint state is untouched:
        delta waves carry constraint-termless pods only.

        Returns (asg, rows_dev, index_flag, attempted, touched)."""
        cache = self._delta
        gen = self.host.vocab.generation()
        planes = cache.planes(gen)
        index = None
        attempted = False
        touched = (0, 0)
        if cache.index_k:
            index = cache.index_state(gen)
            # Mirror the step's dirty-width decision for the metric.
            dirty_w = len(plan.dirty) + sum(
                int(w.rows_dev.shape[0]) for w in self._inflights
            )
            attempted = dirty_w <= cache.index_dirty_cap
            if not attempted:
                note_index_oversized()
            touched = (
                dirty_w + cache.index_k * batch.batch,
                cache.num_rows + dirty_w,
            )
        try:
            out = schedule_batch_delta(
                self.table, batch, seed,
                profile=self.profile,
                slot_ids=plan.slot_ids,
                planes=planes,
                dirty=plan.dirty,
                inflight_rows=tuple(w.rows_dev for w in self._inflights),
                chunk=self.chunk, k=self.k,
                stratum_bits=self.stratum_bits,
                index=index,
                rep_idx=plan.rep_idx if index is not None else None,
                rebuild_slots=plan.rebuild_slots if index is not None else None,
                index_dirty_cap=cache.index_dirty_cap,
                mesh=self.mesh,
                backend=self.backend,
            )
        except Exception:
            # The planes are in an unknown state: drop them and re-raise.
            cache.reset("dispatch-error")
            raise
        flag = None
        if index is not None:
            _table, asg, rows_dev, planes, index, flag = out
            cache.commit(planes[0], planes[1], plan, index=index)
        else:
            _table, asg, rows_dev, planes = out
            cache.commit(planes[0], planes[1], plan)
        return asg, rows_dev, flag, attempted, touched

    def _launch(self, batch_pods, batch) -> Wave:
        """Issue one wave for an encoded batch and start the copy of its
        bind decision to the host (no wait for either).

        The faultline hook ``coordinator.cycle``/``dispatch`` fires first:
        ``delay`` / ``slow_cycle`` lengthen the cycle, every failure kind
        (``stall``) raises before any device work — no wave seed drawn,
        no plane fill, no launch, no pinned copy, no event — so the
        caller's breaker sees a clean dispatch failure with nothing to
        roll back."""
        t_start = time.perf_counter()
        if faultline.active_injector().plan.faults:
            d = faultline.decide("coordinator.cycle", "dispatch")
            if d is not None:
                if d.kind in ("delay", "slow_cycle"):
                    time.sleep(d.delay_s)
                else:
                    raise faultline.InjectedFault(d)
        profile, sample_rows = self._active_knobs()
        self.key, subkey = prng_split(self.key)
        seed = seed_of(subkey)
        delta_plan = None
        if (
            self._delta is not None
            and sample_rows is None
            and self._row_mask_dev is None
            and profile is self.profile
            and self.table is not None
        ):
            # Only the full-scan shape reuses planes: sampled windows,
            # degraded profiles and masked views compute different planes
            # than the cache holds.
            delta_plan = self._plan_delta(batch_pods, batch)
        probe = None
        if self._donation_inplace is None:
            probe = donation_probe(self.table)
        idx_flag = None
        idx_attempted = False
        idx_touched = (0, 0)
        with _CYCLE_TIME.time(stage="device"):
            if delta_plan is not None:
                asg, rows_dev, idx_flag, idx_attempted, idx_touched = (
                    self._launch_delta(batch, seed, delta_plan)
                )
            else:
                _table, asg, rows_dev = schedule_batch_packed(
                    self.table, batch, seed,
                    profile=profile, constraints=self.constraints,
                    chunk=self.chunk, k=self.k, backend=self.backend,
                    sample_rows=sample_rows,
                    sample_offset=self._next_window(sample_rows) if sample_rows else 0,
                    stratum_bits=self.stratum_bits,
                    row_mask=self._row_mask_dev,
                    mesh=self.mesh,
                )
        if probe is not None:
            self._donation_inplace = donation_inplace(self.table, probe)
        _DONATION.inc(inplace="yes" if self._donation_inplace else "no")
        rows_host = copied = None
        if rows_dev.is_cuda:
            # Start the device->host copy of the bind decision now; the
            # retire waits on the event before it reads the bytes.
            rows_host = torch.empty(rows_dev.shape, dtype=rows_dev.dtype, pin_memory=True)
            rows_host.copy_(rows_dev, non_blocking=True)
            # The event belongs to the card holding rows_dev (a mesh's
            # first device), recorded on that card's current stream.
            copied = torch.cuda.Event()
            copied.record(torch.cuda.current_stream(rows_dev.device))
        path = "delta" if delta_plan is not None else "full"
        self.waves[path] += 1
        tracer = self._tracer
        if tracer.enabled:
            # Encode end -> launch: the pipeline-slot wait (in the
            # pipelined cycle it includes retiring the oldest wave).
            for p in batch_pods:
                tracer.emit(p.key_str, "dispatch_wait", t=t_start)
        # begin_wave stamps the epoch AFTER the launch: rows removed from
        # here on quarantine until this wave retires.
        return Wave(
            batch_pods, batch, asg, rows_dev, t_start,
            epoch=self.host.begin_wave(),
            depth=len(self._inflights) + 1,
            path=path,
            index_flag_dev=idx_flag,
            index_attempted=idx_attempted,
            index_touched=idx_touched,
            rows_host=rows_host,
            copied=copied,
        )

    def _loadshed_tick(self) -> None:
        """Feed the health controller one cycle's signals (no-op without
        one): after the intake drains, so the queue depth is current, and
        before the batch is taken, so this wave runs in the state the
        signals imply."""
        ls = self.loadshed
        if ls is None:
            return
        conflicts = _PODS_SCHEDULED.value(outcome="conflict")
        resyncs = _RESYNCS.value()
        ls.tick(Signals(
            # Staged gang members are accepted demand too.
            queue_depth=len(self.queue) + self._external_pending() + self._gang_staged(),
            backoff_depth=len(self._backoff) + sum(len(m) for _, _, m in self._gang_parked),
            conflicts=int(conflicts - self._sig_conflicts),
            resyncs=int(resyncs - self._sig_resyncs),
            cycle_s=self._last_cycle_s,
        ))
        self._sig_conflicts = conflicts
        self._sig_resyncs = resyncs
        if self.tenancy is not None:
            # This cycle's admit budget is one wave of pods, split by
            # weight over the tenants that offered load.
            self.tenancy.admission.tick(capacity=self.pod_spec.batch)

    def _requeue_front(self, batch_pods) -> None:
        """Put an unlaunched batch back at the head of the queue (no
        accounting exists to undo)."""
        for p in reversed(batch_pods):
            self._queued_keys.add(p.key_str)
            self.queue.appendleft(p)

    def _take_pods(self, n: int) -> list[PendingPod]:
        """Pop up to ``n`` pending pods without encoding them: the
        breaker-open fallback never touches the device."""
        self._release_backoff()
        pods: list[PendingPod] = []
        cur_gang = ""
        rotated: set[str] = set()
        while self.queue and len(pods) < n:
            head = self.queue[0]
            if head.gang_id and head.gang_id != cur_gang and head.gang_size > n - len(pods):
                if pods or head.gang_id in rotated:
                    break
                # A gang that can never fit this cap must not wedge the
                # queue while the breaker is open: rotate it to the back
                # intact (once per gang per call) and keep draining.
                rotated.add(head.gang_id)
                moved: list[PendingPod] = []
                while self.queue and self.queue[0].gang_id == head.gang_id:
                    moved.append(self.queue.popleft())
                self.queue.extend(moved)
                continue
            cur_gang = head.gang_id
            p = self.queue.popleft()
            self._queued_keys.discard(p.key_str)
            pods.append(p)
        return pods

    def _fallback_nodes(self) -> list:
        """Decoded ``(row, NodeInfo)`` candidates of the oracle fallback
        and of preemption, ascending row (earlier row wins ties, as on
        the device).  Built from the incremental ``_node_infos`` index;
        rows it has never seen (the bulk-ingest remainder) are seeded
        from one store decode."""
        if self._fallback_cache is not None and self._fallback_cache[0] == self._node_gen:
            return self._fallback_cache[1]
        row_of = self.host._row_of
        infos = self._node_infos
        missing = {name for name in row_of if name not in infos}
        if missing:
            kvs, _ = list_prefix(self.store, NODES_PREFIX)
            for kv in kvs:
                name = kv.key[len(NODES_PREFIX):].decode()
                if name not in missing:
                    continue
                try:
                    infos[name] = decode_node(kv.value)
                except Exception:
                    _DECODE_ERRORS.inc(kind="node")
                    log.exception("undecodable node in fallback seed; skipping")
        out = []
        mask = self._row_mask_np
        for name, row in row_of.items():
            nd = infos.get(name)
            if nd is None:
                continue
            if mask is not None and not mask[row]:
                continue
            out.append((row, nd))
        out.sort(key=lambda t: t[0])
        self._fallback_cache = (self._node_gen, out)
        return out

    def _fallback_nodes_full(self) -> list:
        """The full store decode, uncached: the reference the incremental
        ``_fallback_nodes`` index must equal (the tests' differential)."""
        out = []
        kvs, _ = list_prefix(self.store, NODES_PREFIX)
        mask = self._row_mask_np
        for kv in kvs:
            try:
                nd = decode_node(kv.value)
            except Exception:
                _DECODE_ERRORS.inc(kind="node")
                log.exception("undecodable node in fallback list; skipping")
                continue
            row = self.host._row_of.get(nd.name)
            if row is None:
                continue
            if mask is not None and not mask[row]:
                continue
            out.append((row, nd))
        out.sort(key=lambda t: t[0])
        return out

    def _fallback_schedule(self, batch_pods) -> int:
        """Breaker-open path: bind a small batch through the host oracle
        (``oracle/``), so scheduling never fully stops.  Greedy and
        sequential against the live host usage (argmax ``oracle_score``,
        earlier row wins ties), a pure function of the pod order.  Pods
        past ``fallback_batch`` go back to the queue head.  The device
        never saw these binds: each bound row is marked dirty, so the
        next sync uploads the host truth before any later wave reads the
        table (the caller retired the pipeline first)."""
        cap = self.breaker.config.fallback_batch if self.breaker is not None else len(batch_pods)
        take = batch_pods[:cap]
        self._requeue_front(batch_pods[len(take):])
        nodes = self._fallback_nodes()
        host = self.host
        weights = (
            self.profile.least_allocated, self.profile.balanced_allocation,
            self.profile.taint_toleration, self.profile.node_affinity,
        )
        nbound = 0
        bound_ok = np.zeros(len(take), bool)
        with _CYCLE_TIME.time(stage="fallback"):
            for pi, p in enumerate(take):
                pod = p.ensure_pod()
                best_row, best_score, best_name = -1, -1, None
                for row, nd in nodes:
                    req = (int(host.cpu_req[row]), int(host.mem_req[row]),
                           int(host.pods_req[row]))
                    if not oracle_feasible(nd, pod, req):
                        continue
                    sc = oracle_score(nd, pod, req, taint_slots=self.table_spec.taint_slots,
                                      weights=weights)
                    if sc > best_score:
                        best_row, best_score, best_name = row, sc, nd.name
                if best_name is None or not self._bind(p, best_name):
                    self._wave_fail(p)
                    continue
                nbound += 1
                bound_ok[pi] = True
                FALLBACK_BINDS.inc()
                _BIND_LATENCY.observe(time.perf_counter() - p.enqueued_at)
                if self._tracer.enabled:
                    # No wave launched: the whole journey settles in one
                    # bind span.
                    self._tracer.finish(p.key_str, "bind", outcome="fallback")
                self._dirty_rows.add(best_row)
                if self.constraints is not None:
                    rec = self._bound.get(p.key_str)
                    if rec is not None and rec[5] is not None:
                        self._pending_adjusts.append((rec[5], rec[0], rec[3], rec[4], 1))
            # Fallback binds are host-side: a gang releases through the
            # queued adjusts.
            nbound -= self._resolve_gangs(
                take, bound_ok, np.full(len(take), -1, np.int64), np.zeros(len(take), bool),
            )
            tracer = self._tracer
            if tracer.enabled:
                # No retire pass runs on the breaker path: close the chains
                # of pods that spent their retry budget here.
                for p in take:
                    if p.key_str in self._trace_gaveup:
                        self._trace_gaveup.discard(p.key_str)
                        tracer.finish(p.key_str, "requeue", outcome="unschedulable",
                                      attempts=p.attempts)
        return nbound

    def _complete(self, inflight: Wave) -> int:
        """Bind half: bring the bind decision to the host, CAS the binds
        back, roll back conflicts (CAS losses, rows tombstoned while the
        wave was in flight)."""
        batch_pods, batch, asg = inflight.batch_pods, inflight.batch, inflight.asg
        with self._stage("sync_out"):
            if inflight.copied is not None:
                # The pinned copy was issued at launch; read it only once
                # the card has written it.
                inflight.copied.synchronize()
                node_row = inflight.rows_host.numpy()
            else:
                node_row = inflight.rows_dev.numpy()
        # The card has written the bound rows: the device span ends here,
        # after the copy's event wait (an earlier stamp would move the
        # card's time into the bind span).
        t_sync = time.perf_counter()
        if inflight.index_flag_dev is not None:
            note_index_wave(
                int(inflight.index_flag_dev), inflight.index_attempted,
                *inflight.index_touched,
            )

        nbound = 0
        failed = np.zeros(batch.batch, bool)
        # Per-pod settled outcome (True = the bind stuck), for the gang
        # all-or-none settlement after the bind stage.
        bound_ok = np.zeros(batch.batch, bool)
        host = self.host
        with self._stage("bind"):
            # One native call binds the whole wave (splice + CAS inside
            # the store); pods the native path cannot take fall back to
            # the per-pod _bind.
            nb = len(batch_pods)
            rows = node_row[:nb]
            bound_idx = np.nonzero(rows >= 0)[0]
            if self._delta is not None and bound_idx.size:
                # This wave's assumes are host-visible now: journal its
                # bound rows so later delta waves recompute them.
                self._delta.note_rows(rows[bound_idx])
            # No-feasible-row pods settle AFTER this wave's binds land in
            # the host mirror: preemption's usage must include them.
            nofit = np.nonzero(rows < 0)[0].tolist()
            brows = rows[bound_idx]
            # Rows tombstoned while this wave was in flight: the node is
            # gone (the quarantine guarantees no reuse before this
            # retire) — retry the pod like a CAS conflict; the tombstone
            # scatter already uploaded the zeroed row.
            if bound_idx.size:
                alive = host.valid[brows]
                if not alive.all():
                    for i in bound_idx[~alive].tolist():
                        failed[i] = True
                        self._wave_fail(batch_pods[i])
                    bound_idx = bound_idx[alive]
                    brows = brows[alive]
            nbytes = self._node_name_bytes()
            ids_l = host.name_id[brows].tolist()
            brows_l = brows.tolist()
            zones = host.zone[brows].tolist()
            regions = host.region[brows].tolist()
            bound_l = bound_idx.tolist()

            wave_j: list[int] = []
            entries: list[tuple[bytes, int, bytes]] = []
            # The hot path stays injection-free unless a plan is installed.
            inj_active = bool(faultline.active_injector().plan.faults)
            for j, i in enumerate(bound_l):
                p = batch_pods[i]
                if p.mod_revision is not None:
                    # One fault decision per CAS attempt: the native wave's
                    # records are checked here, slow-path pods in _bind.
                    if inj_active and self._bind_fault():
                        # A forced conflict, accounted like a real one.
                        self._dirty_rows.add(host.row_of(nbytes[ids_l[j]].decode()))
                        failed[i] = True
                        self._wave_fail(p)
                        continue
                    wave_j.append(j)
                    entries.append((p.key_bytes, p.mod_revision, nbytes[ids_l[j]]))
                    continue
                name = nbytes[ids_l[j]].decode()
                if self._bind(p, name):
                    nbound += 1
                    bound_ok[i] = True
                    _BIND_LATENCY.observe(time.perf_counter() - p.enqueued_at)
                    if brows_l[j] in self._midflight_rows:
                        self._dirty_rows.add(brows_l[j])
                    continue
                # CAS conflict: the device assumed this bind but the host
                # mirror never counted it — the dirty row re-uploads host
                # truth; the count tables roll back below.
                self._dirty_rows.add(host.row_of(name))
                failed[i] = True
                self._wave_fail(p)
            if entries:
                results = (
                    self._fenced_bind_batch(entries, self._pods_watch.id)
                    if self._bind_excludes else self._fenced_bind_batch(entries)
                )
                now = time.perf_counter()
                ok_rows: list[int] = []
                ok_cpu: list[int] = []
                ok_mem: list[int] = []
                lats: list[float] = []
                bound_dict = self._bound
                nv = host.vocab.node_names._to_val
                for j, rev in zip(wave_j, results):
                    i = bound_l[j]
                    p = batch_pods[i]
                    if rev > 0:
                        bound_ok[i] = True
                        ok_rows.append(brows_l[j])
                        ok_cpu.append(p.cpu_milli)
                        ok_mem.append(p.mem_kib)
                        lats.append(now - p.enqueued_at)
                        keep = (
                            p.pod
                            if p.pod is not None and self._constraintful(p.pod)
                            else None
                        )
                        node_name = nv[ids_l[j]]
                        bound_dict[p.key_str] = (
                            node_name, p.cpu_milli, p.mem_kib,
                            zones[j], regions[j], keep,
                        )
                        self._bind_seq += 1
                        # A decoded PodInfo gives the label-aware tenant;
                        # a fast-lane pod is label-less, so its namespace
                        # is the tenant.
                        tenant = (
                            tenant_of_pod(p.pod) if p.pod is not None
                            else tenant_of_key(p.key_str)
                        )
                        self._bind_meta[p.key_str] = (
                            p.priority, self._bind_seq, tenant, p.gang_id,
                        )
                        self._victims_note(
                            p.key_str, node_name, p.cpu_milli, p.mem_kib,
                            p.priority, self._bind_seq, tenant, p.gang_id,
                        )
                        continue
                    name = nbytes[ids_l[j]].decode()
                    if rev == BIND_INVALID and self._bind(p, name):
                        nbound += 1
                        bound_ok[i] = True
                        _BIND_LATENCY.observe(now - p.enqueued_at)
                        if brows_l[j] in self._midflight_rows:
                            self._dirty_rows.add(brows_l[j])
                        continue
                    if rev != BIND_INVALID:
                        _PODS_SCHEDULED.inc(outcome="conflict")
                    self._dirty_rows.add(host.row_of(name))
                    failed[i] = True
                    self._wave_fail(p)
                if ok_rows:
                    # Two pods on one node accumulate under np.add.at.
                    r = np.asarray(ok_rows, np.int32)
                    np.add.at(host.cpu_req, r, np.asarray(ok_cpu, host.cpu_req.dtype))
                    np.add.at(host.mem_req, r, np.asarray(ok_mem, host.mem_req.dtype))
                    np.add.at(host.pods_req, r, 1)
                    nbound += len(ok_rows)
                    _PODS_SCHEDULED.inc(len(ok_rows), outcome="bound")
                    _BIND_LATENCY.observe_many(lats)
                    if self._midflight_rows:
                        # Rows a mid-flight full scatter clobbered get the
                        # host truth (with this wave's binds) re-uploaded.
                        self._dirty_rows.update(
                            rr for rr in ok_rows if rr in self._midflight_rows
                        )
            # Preemption pass, after every CAS bind above (the host mirror
            # holds this wave's placements); the victims index is built at
            # most once per wave.
            vindex = None
            for i in nofit:
                p = batch_pods[i]
                if self._preempt_eligible(p):
                    if vindex is None:
                        vindex = self._victims_index()
                    if self._try_preempt(p, vindex):
                        bound_ok[i] = True
                        nbound += 1
                        continue
                self._wave_fail(p)
            # Gang all-or-none settlement before this retire returns; a
            # released device-committed bind rides the rollback below.
            nbound -= self._resolve_gangs(batch_pods, bound_ok, rows, failed)
        if failed.any() and self.constraints is not None:
            # Roll back the wave's optimistic count-table commit for the
            # pods whose bind did not stick.
            m = to_tensor(failed, self.device)
            self._adjust(
                self.constraints, commit_fields_np(batch.fields, self.device),
                asg.node_row, asg.zone, asg.region, m, m, sign=-1,
            )
        if self._tracer.enabled:
            self._trace_retire(inflight, rows, bound_ok, t_sync)
        cycle_s = time.perf_counter() - inflight.t_start
        self._last_cycle_s = cycle_s
        # This wave retired: rows removed at or before the oldest
        # still-in-flight wave's launch are past their aliasing hazard.
        if self._inflights:
            self.host.release_rows(self._inflights[0].epoch)
        else:
            self.host.release_rows(None)
            self._midflight_rows.clear()
        self.depth_timer.set_level(len(self._inflights))
        if self.breaker is not None:
            # Success is a RETIRED wave (the card returned data), not an
            # accepted launch.
            self.breaker.record_success()
        if self.flight is not None:
            self.flight.record(
                "cycle", cycle_s, pods=len(batch_pods), bound=nbound, queue=len(self.queue),
            )
            if (
                self.profiler is not None
                and cycle_s > self.flight.threshold_s
                # The flight recorder's cap: sustained slow cycles must
                # not fill the disk, and a dump lengthens the cycle.
                and self._profile_dumps < self.flight.max_dumps
            ):
                self._profile_dumps += 1
                # The flight dump says what was slow; the profile dump
                # where the window's time went.
                self.profiler.dump(os.path.join(
                    self.flight.dump_dir,
                    # graftlint: disable=no-wall-clock (epoch-ms dump name, correlates with flight dumps)
                    f"profile-slowcycle-{int(time.time() * 1e3)}-{self._profile_dumps}.json",
                ))
        return nbound

    def _trace_retire(self, inflight: Wave, rows, bound_ok, t_sync: float) -> None:
        """Wave-retire pass while tracing: close every sampled pod's
        device span at ``t_sync`` (with the wave's epoch, depth and path)
        and its bind span with the settled outcome, and give a traced pod
        whose schedule-to-bind exceeded the flight threshold a flight dump
        with its span chain attached.  Traced pods only: the dump budget
        is shared with the slow-cycle dumps."""
        tracer = self._tracer
        flight = self.flight
        now = time.perf_counter()
        for i, p in enumerate(inflight.batch_pods):
            done = None
            tracer.emit(p.key_str, "device", t=t_sync, wave_epoch=inflight.epoch,
                        depth=inflight.depth, path=inflight.path)
            if bound_ok[i]:
                done = tracer.finish(p.key_str, "bind", t=now, outcome="bound")
            else:
                tracer.emit(p.key_str, "bind", t=now,
                            outcome="nofit" if rows[i] < 0 else "conflict",
                            attempts=p.attempts)
                if p.key_str in self._trace_gaveup:
                    # Retry budget spent in this wave's settlement: close
                    # the chain after its device and bind spans.
                    self._trace_gaveup.discard(p.key_str)
                    tracer.finish(p.key_str, "requeue", outcome="unschedulable",
                                  attempts=p.attempts)
            if done is not None and flight is not None:
                lat = now - p.enqueued_at
                if lat > flight.threshold_s:
                    flight.dump(
                        reason=f"pod {p.key_str} schedule-to-bind {lat * 1e3:.1f}ms",
                        extra={"pod": p.key_str, "pod_spans": done.doc()["spans"]},
                    )

    def step(self) -> int:
        """One scheduling cycle; returns the number of pods bound.

        With ``pipeline=True`` the count is that of the waves retired this
        step: up to ``depth`` waves stay in flight, the oldest retiring
        BEFORE this step's sync and launch so its bind accounting reaches
        the host mirror ahead of the dirty-row upload the next launch
        reads.  Call ``flush()`` (or ``run_until_idle``) for the tail."""
        if not self.pipeline:
            self._drain_external()
            self.drain_watches()
            self._sync_table()
            self._process_adjusts()
            self._loadshed_tick()
            if self.breaker is not None and self.breaker.state != BREAKER_CLOSED:
                self._release_backoff()
                if not self.queue:
                    return 0
                if not self.breaker.allow():
                    # Open: bind a small slice through the oracle.
                    return self._fallback_schedule(
                        self._take_pods(self.breaker.config.fallback_batch))
                # Half-open probe: a normal device wave.
            batch_pods, batch = self._take_batch()
            if batch_pods is None:
                return 0
            try:
                inflight = self._launch(batch_pods, batch)
            except Exception:
                if self.breaker is None:
                    raise
                log.exception("cycle dispatch failed; breaker accounting")
                self.breaker.record_failure()
                self._requeue_front(batch_pods)
                return 0
            if self._feed is not None:
                # Encode the NEXT batch while the retire below waits.
                self._feed.stage(self.queue, self.pod_spec.batch)
            return self._complete(inflight)
        done = self._deferred_binds
        self._deferred_binds = 0
        if self._nodes_watch.dropped or self._pods_watch.dropped:
            done += self._quiesce("resync")
            log.warning(
                "watch overflow (nodes dropped=%d pods dropped=%d); resyncing",
                self._nodes_watch.dropped, self._pods_watch.dropped,
            )
            self.resync()
        elif self._watch_fault():
            # Injected watch loss: retire the pipeline and relist.
            done += self._quiesce("resync")
            self.resync()
        self._drain_external()
        self._drain_pod_events()
        self._drain_node_events()
        self._loadshed_tick()
        if self.breaker is not None and self.breaker.state != BREAKER_CLOSED:
            # A tripped breaker retires the pipeline: no wave still in
            # flight may land placements computed against the usage the
            # oracle binds below change, and the half-open probe then
            # launches at once.  The sync uploads what the retired waves
            # and earlier fallback binds left dirty.
            done += self._quiesce("breaker")
            self._sync_table()
            self._process_adjusts()
            self._release_backoff()
            if not self.queue:
                return done
            if not self.breaker.allow():
                done += self._fallback_schedule(
                    self._take_pods(self.breaker.config.fallback_batch))
                return done
            # Half-open probe: launched below through the normal path.
        batch_pods, batch = self._take_batch()
        if len(self._inflights) >= (self.depth if batch_pods else 1):
            done += self._complete(self._inflights.pop(0))
        # After the retire, before the launch: the retired wave's bind
        # accounting and rollback rows reach the upload.
        self._sync_table()
        self._process_adjusts()
        if batch_pods is not None:
            try:
                inflight = self._launch(batch_pods, batch)
            except Exception:
                if self.breaker is None:
                    raise
                log.exception("cycle dispatch failed; breaker accounting")
                self.breaker.record_failure()
                self._requeue_front(batch_pods)
                return done
            self._inflights.append(inflight)
            self.depth_timer.set_level(len(self._inflights))
            if self._feed is not None:
                # Peek (never pop) the next full batch for the worker.
                self._feed.stage(self.queue, self.pod_spec.batch)
            if self.adaptive_batch and batch.batch < self.pod_spec.batch:
                # A partial bucket: the queue drains faster than it
                # fills, so retire now rather than add a wave time to
                # every pod's latency; full buckets keep the pipeline.
                done += self._quiesce("adaptive")
        return done

    def flush(self) -> int:
        """Retire every in-flight wave (plus deferred bind credit)."""
        done = self._deferred_binds
        self._deferred_binds = 0
        while self._inflights:
            done += self._complete(self._inflights.pop(0))
        return done

    def _quiesce(self, reason: str) -> int:
        """Retire the whole pipeline for a structural event and count it
        (uncounted no-op when nothing is in flight)."""
        if not self._inflights:
            return 0
        _PIPE_QUIESCE.inc(reason=reason)
        return self.flush()

    # ---- fenced store writes ----------------------------------------------
    #
    # Every store put/CAS reachable from the bind/evict/preempt paths flows
    # through these two funnels: they consult the reign's LeaseFence before
    # touching the store, so a deposed or paused leader's in-flight waves
    # retire into the ordinary conflict/requeue machinery instead of
    # landing writes behind the new leader.

    def _fence_admit(self, path: str) -> bool:
        f = self.fence
        if f is None or f.admit():
            return True
        _FENCE_REJECTED.inc(path=path)
        return False

    def _fenced_cas(self, key: bytes, value: bytes, *, required_mod: int, path: str):
        """The bind/evict/preempt CAS funnel: shaped exactly like
        ``store.cas`` so a fence refusal reads as a CAS conflict — the one
        failure every caller already absorbs (requeue/backoff)."""
        if not self._fence_admit(path):
            return False, 0, None
        return self.store.cas(key, value, required_mod=required_mod)

    def _fenced_bind_batch(self, entries, watch_id=None):
        """The native-wave bind funnel: a fence refusal fails every entry
        as a conflict (rev 0) without touching the store."""
        if not self._fence_admit("bind"):
            return [0] * len(entries)
        if watch_id is not None:
            return self.store.bind_batch(entries, watch_id)
        return self.store.bind_batch(entries)

    def _bind(self, p: PendingPod, node_name: str) -> bool:
        """CAS spec.nodeName into the pod object; False on conflict
        (including a fence refusal: every store write below goes through
        ``_fenced_cas``, so the fence is consulted once per attempt)."""
        if self._bind_fault():
            return False
        key = p.key_bytes
        if p.mod_revision is not None and p.raw is not None:
            # Splice nodeName into the intake-revision bytes; the CAS
            # proves the object has not changed since.
            value = splice_node_name(p.raw, node_name)
            if value is not None:
                ok, _, _ = self._fenced_cas(key, value, required_mod=p.mod_revision,
                                            path="bind")
                if not ok:
                    _PODS_SCHEDULED.inc(outcome="conflict")
                    return False
                self.host.add_pod(node_name, p.cpu_milli, p.mem_kib)
                self._note_bound(p.ensure_pod(), node_name, external=False)
                _PODS_SCHEDULED.inc(outcome="bound")
                return True
        cur = self.store.get(key)
        if cur is None:
            _PODS_SCHEDULED.inc(outcome="conflict")
            return False
        if p.mod_revision is None:
            # No revision observed at intake: bind against the live one,
            # unless someone already bound it.
            obj = json.loads(cur.value)
            if obj.get("spec", {}).get("nodeName"):
                _PODS_SCHEDULED.inc(outcome="conflict")
                return False
            required = cur.mod_revision
        elif cur.mod_revision != p.mod_revision:
            _PODS_SCHEDULED.inc(outcome="conflict")
            return False
        else:
            # Intake revision still live but no raw bytes captured (the
            # fast lane keeps PendingPod compact): splice into the
            # store's current bytes.
            value = splice_node_name(cur.value, node_name)
            if value is not None:
                ok, _, _ = self._fenced_cas(key, value, required_mod=p.mod_revision,
                                            path="bind")
                if not ok:
                    _PODS_SCHEDULED.inc(outcome="conflict")
                    return False
                self.host.add_pod(node_name, p.cpu_milli, p.mem_kib)
                self._note_bound(p.ensure_pod(), node_name, external=False)
                _PODS_SCHEDULED.inc(outcome="bound")
                return True
            obj = json.loads(cur.value)
            required = p.mod_revision
        obj["spec"]["nodeName"] = node_name
        ok, _, _ = self._fenced_cas(
            key, json.dumps(obj, separators=(",", ":")).encode(), required_mod=required,
            path="bind",
        )
        if not ok:
            _PODS_SCHEDULED.inc(outcome="conflict")
            return False
        # The watch echo of our own write is deduped via _bound.
        self.host.add_pod(node_name, p.cpu_milli, p.mem_kib)
        self._note_bound(p.ensure_pod(), node_name, external=False)
        _PODS_SCHEDULED.inc(outcome="bound")
        return True

    @staticmethod
    def _bind_fault() -> bool:
        """Faultline hook on the bind CAS (``coordinator.bind``/``cas``):
        ``delay`` sleeps; every failure kind is a forced CAS conflict,
        driving the pod through the conflict/requeue path.  True when the
        bind must report a conflict."""
        d = faultline.decide("coordinator.bind", "cas")
        if d is None:
            return False
        if d.kind == "delay":
            time.sleep(d.delay_s)
            return False
        _PODS_SCHEDULED.inc(outcome="conflict")
        return True

    def _retry(self, p: PendingPod) -> None:
        p.attempts += 1
        pol = self.retry_policy
        if p.attempts >= pol.max_attempts:
            # Give-up parks the pod as unschedulable, never tight-loops.
            if self._tracer.enabled:
                # The chain closes in the retire pass, after the device and
                # bind spans.
                self._trace_gaveup.add(p.key_str)
            _PODS_SCHEDULED.inc(outcome="unschedulable")
            note_give_up("coordinator.bind")
            self.unschedulable[p.key_str] = p.ensure_pod()
            return
        _PODS_SCHEDULED.inc(outcome="retry")
        note_retry("coordinator.bind")
        # Re-read AND re-decode: an external writer may have bound the
        # pod or changed its spec.
        cur = self.store.get(p.key_bytes)
        if cur is None:
            return
        fresh = decode_pod(cur.value, self.tracker)
        if fresh.node_name:
            return  # bound externally; the watch echo accounts it
        p.pod = fresh
        p.cpu_milli = fresh.cpu_milli
        p.mem_kib = fresh.mem_kib
        p.key_str = fresh.key
        p.priority = fresh.priority
        p.mod_revision = cur.mod_revision
        # Refresh the splice source too: stale bytes at the new revision
        # would CAS the old body back in.
        p.raw = cur.value
        self._queued_keys.add(p.key_str)
        p.not_before = time.perf_counter() + pol.delay_for(p.attempts, self._retry_rng)
        self._backoff_seq += 1
        heapq.heappush(self._backoff, (p.not_before, self._backoff_seq, p))

    def close(self) -> None:
        """Cancel the store watches and stop the host-feed worker."""
        for w in (self._nodes_watch, self._pods_watch):
            if w is not None:
                w.cancel()
        self._nodes_watch = self._pods_watch = None
        if self._feed is not None:
            self._feed.close()

    def run_until_idle(self, max_cycles: int = 10000) -> int:
        """Drive cycles until no pending pods remain; returns total binds."""
        total = 0
        idle = 0
        for _ in range(max_cycles):
            total += self.step()
            if not self.queue and not self._inflights:
                if self._backoff or self._gang_parked:
                    # Retrying pods are on a timer: wait out the earliest.
                    time.sleep(min(self.backoff_wait_s() or 0.0, 0.05))
                    idle = 0
                    continue
                idle += 1
                if idle > 1 and self.drain_watches() == 0 and not self._external_pending():
                    break
            else:
                idle = 0
        total += self.flush()
        return total
