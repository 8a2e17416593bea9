"""The device-resident node table: a struct-of-tensors snapshot of every node.

Port of ``k8s1m_tpu/snapshot/node_table.py``.  ``NodeTableHost`` is the
numpy mirror the feature compiler fills (byte-identical columns to the
JAX package's mirror for the same inputs); ``NodeTable`` is a dataclass
of torch tensors on one device; ``commit_binds`` folds a wave's bind
decisions into the request columns in place, and ``scatter_rows`` /
``apply_delta`` write changed rows into the device table in place.
``RowVersions`` is the host journal of row mutations that the deltasched
plane cache invalidates through.

**Wave epochs & the free-row quarantine** (the coordinator's half).  A
pipelined coordinator keeps several waves in flight; a wave launched
before a node removal may still hold the removed row among its
candidates.  Freeing the row at once would let the next allocation reuse
it, and the in-flight wave's bind would land on the new node.  So
``remove`` tombstones the row (``valid=0``, columns zeroed) and parks it
in a quarantine stamped with ``wave_epoch`` (the count of waves launched,
``begin_wave``); ``release_rows(before_epoch)`` frees it once every wave
launched at or before the removal has retired.  Fresh rows append past
the high-water mark or reuse a released row, so structural adds never
need the pipeline quiesced; only quarantine exhaustion does.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import weakref

import numpy as np
import torch

from k8s1m_tpu_torch.config import EFFECT_NO_SCHEDULE, NONE_ID, TableSpec
from k8s1m_tpu_torch.device import resolve_device, to_tensor
from k8s1m_tpu_torch.obs.metrics import Counter, Gauge
from k8s1m_tpu_torch.snapshot.interning import Vocab, numeric_of

_BULK_ROWS = Counter(
    "megarow_bulk_ingest_rows_total",
    "Node rows ingested through the vectorized bulk lane "
    "(NodeTableHost.bulk_upsert / snapshot.bulkload)", (),
)
_MIRROR_BYTES = Gauge(
    "megarow_host_mirror_bytes",
    "Host-mirror column bytes across live NodeTableHost instances "
    "(the int16/int8 mirror-width rule's budget gauge)", (),
)
_LIVE_HOSTS: weakref.WeakSet = weakref.WeakSet()
# A read of the gauge may run while another thread constructs a
# NodeTableHost; iterating a WeakSet concurrently with add() raises, so
# both sides hold this lock.
_HOSTS_LOCK = threading.Lock()


def _mirror_bytes_total() -> int:
    with _HOSTS_LOCK:
        return sum(h.mirror_nbytes() for h in _LIVE_HOSTS)


_MIRROR_BYTES.set_function(_mirror_bytes_total)


def mirror_dtype(bound: int) -> np.dtype:
    """Host-mirror column width for ids in ``[0, bound)``: the narrowest
    signed dtype that holds the TableSpec bound.  ``to_device`` re-widens
    to the canonical int32."""
    if bound <= 1 << 7:
        return np.dtype(np.int8)
    if bound <= 1 << 15:
        return np.dtype(np.int16)
    return np.dtype(np.int32)


class RowsExhausted(ValueError):
    """No allocatable row: the table is at ``max_nodes`` and the free
    list is empty.  ``quarantined`` says how many rows are parked in the
    wave-epoch quarantine — nonzero means a pipeline quiesce (retire all
    in-flight waves, then ``release_rows(None)``) recovers capacity; zero
    means the table is genuinely full."""

    def __init__(self, msg: str, quarantined: int = 0):
        super().__init__(msg)
        self.quarantined = quarantined


UNSCHEDULABLE_TAINT_KEY = "node.kubernetes.io/unschedulable"
ZONE_LABEL = "topology.kubernetes.io/zone"
REGION_LABEL = "topology.kubernetes.io/region"
HOSTNAME_LABEL = "kubernetes.io/hostname"


@dataclasses.dataclass
class Taint:
    key: str
    value: str = ""
    effect: int = EFFECT_NO_SCHEDULE


@dataclasses.dataclass
class NodeInfo:
    """Host-side description of one node (the parsed KWOK/real Node object)."""

    name: str
    cpu_milli: int = 4000
    mem_kib: int = 8 << 20          # 8 GiB
    pods: int = 110
    labels: dict[str, str] = dataclasses.field(default_factory=dict)
    taints: list[Taint] = dataclasses.field(default_factory=list)
    unschedulable: bool = False


# Every NodeTable column, in field order.
COLUMNS = (
    "valid", "cpu_alloc", "mem_alloc", "pods_alloc",
    "cpu_req", "mem_req", "pods_req",
    "label_key", "label_val", "label_num",
    "taint_id", "taint_effect", "zone", "region", "name_id",
)


@dataclasses.dataclass
class NodeTable:
    """Device-resident snapshot; every tensor has ``max_nodes`` rows."""

    valid: torch.Tensor        # bool[N] — row is a live node
    cpu_alloc: torch.Tensor    # i32[N] milliCPU
    mem_alloc: torch.Tensor    # i32[N] KiB
    pods_alloc: torch.Tensor   # i32[N]
    cpu_req: torch.Tensor      # i32[N] sum of requests of bound pods
    mem_req: torch.Tensor      # i32[N]
    pods_req: torch.Tensor     # i32[N]
    label_key: torch.Tensor    # i32[N, L]
    label_val: torch.Tensor    # i32[N, L]
    label_num: torch.Tensor    # i32[N, L]
    taint_id: torch.Tensor     # i32[N, T] triple id in [0, max_taint_ids)
    taint_effect: torch.Tensor  # i32[N, T]
    zone: torch.Tensor         # i32[N]
    region: torch.Tensor       # i32[N]
    name_id: torch.Tensor      # i32[N]

    @property
    def num_rows(self) -> int:
        return self.valid.shape[0]

    def free(self):
        """(cpu, mem, pods) still unrequested, for Fit and LeastAllocated."""
        return (
            self.cpu_alloc - self.cpu_req,
            self.mem_alloc - self.mem_req,
            self.pods_alloc - self.pods_req,
        )

    def narrow(self, start: int, rows: int):
        """Row window ``[start, start+rows)`` as views (no copy)."""
        return _map_tensors(self, lambda t: t.narrow(0, start, rows))

    def clone(self):
        return _map_tensors(self, torch.clone)


def _map_tensors(table, fn):
    """``table`` with ``fn`` applied to every tensor field (either layout)."""
    return dataclasses.replace(table, **{
        f.name: fn(getattr(table, f.name))
        for f in dataclasses.fields(table)
        if isinstance(getattr(table, f.name), torch.Tensor)
    })


class NodeTableHost:
    """Host-side builder/mirror of the node table (numpy, mutable): the
    only place node strings are parsed and interned."""

    def __init__(self, spec: TableSpec, vocab: Vocab | None = None) -> None:
        self.spec = spec
        self.vocab = vocab or Vocab()
        n, l, t = spec.max_nodes, spec.label_slots, spec.taint_slots
        self.valid = np.zeros((n,), np.bool_)
        self.cpu_alloc = np.zeros((n,), np.int32)
        self.mem_alloc = np.zeros((n,), np.int32)
        self.pods_alloc = np.zeros((n,), np.int32)
        self.cpu_req = np.zeros((n,), np.int32)
        self.mem_req = np.zeros((n,), np.int32)
        self.pods_req = np.zeros((n,), np.int32)
        self.label_key = np.zeros((n, l), np.int32)
        self.label_val = np.zeros((n, l), np.int32)
        self.label_num = np.zeros((n, l), np.int32)
        self.taint_id = np.zeros((n, t), mirror_dtype(spec.max_taint_ids))
        self.taint_effect = np.zeros((n, t), np.int8)
        self.zone = np.zeros((n,), mirror_dtype(spec.max_zones))
        self.region = np.zeros((n,), mirror_dtype(spec.max_regions))
        self.name_id = np.zeros((n,), np.int32)
        self._row_of: dict[str, int] = {}
        self._free_rows: list[int] = []
        self._next_row = 0
        # Pipelined-scheduler wave clock: bumped by begin_wave() at every
        # device dispatch.  0 = no consumer pipelines waves, and removes
        # free their row immediately (standalone/tool users of this
        # class never quarantine).
        self.wave_epoch = 0
        # Removed rows awaiting release: (removal wave_epoch, row),
        # epoch-ordered by construction (the clock is monotone).  A row
        # here is tombstoned (valid=0, columns zeroed) but NOT reusable —
        # a wave launched before the removal may still bind into it.
        self._quarantine: collections.deque[tuple[int, int]] = (
            collections.deque()
        )
        # Bumped on every row->name mapping change (new node, removal,
        # row reuse) — consumers holding derived per-row state (the shard
        # set's ownership mask) refresh when this moves.
        self.epoch = 0
        # Opt-in delta journal of those changes: (name, row, alive)
        # appended in order, so a consumer can update per-row state
        # incrementally instead of re-scanning 1M rows per change.  The
        # consumer owns draining it (enable_row_journal returns the list;
        # clear after consuming).
        self._row_journal: list[tuple[str, int, bool]] | None = None
        with _HOSTS_LOCK:
            _LIVE_HOSTS.add(self)

    def mirror_nbytes(self) -> int:
        """Total bytes held by the mirror's column arrays (the
        ``megarow_host_mirror_bytes`` gauge; excludes the row mapping and
        vocab, which are Python dicts)."""
        return sum(getattr(self, c).nbytes for c in COLUMNS)

    def enable_row_journal(self) -> list[tuple[str, int, bool]]:
        if self._row_journal is None:
            self._row_journal = []
        return self._row_journal

    # ---- row management -------------------------------------------------

    def row_of(self, name: str) -> int:
        return self._row_of[name]

    def _alloc_row(self, name: str) -> int:
        if name in self._row_of:
            return self._row_of[name]
        if self._free_rows:
            row = self._free_rows.pop()
        else:
            row = self._next_row
            if row >= self.spec.max_nodes:
                raise RowsExhausted(
                    f"node table full ({self.spec.max_nodes}); re-bucket "
                    "TableSpec" + (
                        f" ({len(self._quarantine)} rows quarantined; a "
                        "pipeline quiesce releases them)"
                        if self._quarantine else ""
                    ),
                    quarantined=len(self._quarantine),
                )
            self._next_row += 1
        self._row_of[name] = row
        self.epoch += 1
        if self._row_journal is not None:
            self._row_journal.append((name, row, True))
        return row

    def bulk_alloc(self, names) -> np.ndarray:
        """Allocate (or resolve) a row per name, with the capacity
        check front-loaded: either every name gets a row, or
        RowsExhausted raises BEFORE any allocation — a mid-batch raise
        would leave names mapped to rows whose columns were never
        written (the bulk lanes write columns only after every row is
        allocated)."""
        row_of = self._row_of
        fresh = {n for n in names if n not in row_of}
        free = len(self._free_rows) + (self.spec.max_nodes - self._next_row)
        if len(fresh) > free:
            raise RowsExhausted(
                f"bulk ingest needs {len(fresh)} fresh rows but only "
                f"{free} are allocatable (max_nodes="
                f"{self.spec.max_nodes})" + (
                    f" ({len(self._quarantine)} rows quarantined; a "
                    "pipeline quiesce releases them)"
                    if self._quarantine else ""
                ),
                quarantined=len(self._quarantine),
            )
        rows = np.empty((len(names),), np.int64)
        alloc = self._alloc_row
        for i, name in enumerate(names):
            rows[i] = alloc(name)
        return rows

    def alloc_rows(self, names: list[str]) -> np.ndarray:
        """Bulk-allocate contiguous-ish rows for many new nodes.

        Fast path for load generators (the make_nodes equivalent,
        reference kwok/make_nodes/main.go:116-182): callers fill the table
        columns vectorized; per-row python dispatch would dominate at 1M.
        """
        rows = np.empty((len(names),), np.int64)
        for i, name in enumerate(names):
            rows[i] = self._alloc_row(name)
        self.valid[rows] = True
        return rows

    # ---- deltas ---------------------------------------------------------

    def upsert(self, node: NodeInfo) -> int:
        """Add or update a node; returns its row."""
        v = self.vocab
        row = self._alloc_row(node.name)

        labels = dict(node.labels)
        labels.setdefault(HOSTNAME_LABEL, node.name)
        if len(labels) > self.spec.label_slots:
            raise ValueError(
                f"node {node.name}: {len(labels)} labels > "
                f"label_slots={self.spec.label_slots}"
            )
        lk = np.zeros((self.spec.label_slots,), np.int32)
        lv = np.zeros_like(lk)
        ln = np.zeros_like(lk)
        for i, (k, val) in enumerate(sorted(labels.items())):
            lk[i] = v.label_keys.intern(k)
            lv[i] = v.label_values.intern(val)
            ln[i] = numeric_of(val)

        taints = list(node.taints)
        if node.unschedulable:
            taints.append(Taint(UNSCHEDULABLE_TAINT_KEY, "", EFFECT_NO_SCHEDULE))
        if len(taints) > self.spec.taint_slots:
            raise ValueError(
                f"node {node.name}: {len(taints)} taints > "
                f"taint_slots={self.spec.taint_slots}"
            )
        tk = np.zeros((self.spec.taint_slots,), self.taint_id.dtype)
        te = np.zeros((self.spec.taint_slots,), self.taint_effect.dtype)
        for i, taint in enumerate(taints):
            if not 0 <= taint.effect < 4:
                # Same fail-closed contract as pack_meta_np's 2-bit
                # budget: an out-of-range effect must raise here, not
                # truncate into the int8 mirror.
                raise ValueError(
                    f"node {node.name}: taint effect {taint.effect} "
                    "outside the EFFECT_* range [0, 4)"
                )
            tid = v.taints.intern((taint.key, taint.value, taint.effect))
            if tid >= self.spec.max_taint_ids:
                raise ValueError(
                    "distinct taint triples overflow TableSpec.max_taint_ids"
                )
            tk[i] = tid
            te[i] = taint.effect

        zone_id = v.zones.intern(labels.get(ZONE_LABEL)) if ZONE_LABEL in labels else NONE_ID
        region_id = (
            v.regions.intern(labels.get(REGION_LABEL)) if REGION_LABEL in labels else NONE_ID
        )
        if zone_id >= self.spec.max_zones or region_id >= self.spec.max_regions:
            raise ValueError("zone/region id overflow; grow TableSpec.max_zones/max_regions")

        self.valid[row] = True
        self.cpu_alloc[row] = node.cpu_milli
        self.mem_alloc[row] = node.mem_kib
        self.pods_alloc[row] = node.pods
        self.label_key[row], self.label_val[row], self.label_num[row] = lk, lv, ln
        self.taint_id[row], self.taint_effect[row] = tk, te
        self.zone[row] = zone_id
        self.region[row] = region_id
        self.name_id[row] = v.node_names.intern(node.name)
        return row

    def bulk_upsert(self, nodes) -> np.ndarray:
        """Vectorized ``upsert`` over many nodes; returns their rows.

        Byte-identical to ``[self.upsert(n) for n in nodes]`` — same
        column bytes, same row mapping, same vocab contents in the same
        intern order, same row-journal entries — but the per-node numpy
        allocations and scattered row writes collapse into block fills
        and one fancy-indexed write per column, the first wall a 1M-row
        cold build hits.  A name repeated within the batch
        resolves like repeated upserts: the later entry wins (numpy
        fancy assignment applies in order).

        Validation is front-loaded: any per-node error (label/taint
        overflow, id past a TableSpec bound) raises BEFORE any table
        column, row mapping or journal mutation — strictly cleaner than
        the loop's partial application (interned strings from the batch
        may remain; interners are append-only and ids are data).
        """
        spec = self.spec
        v = self.vocab
        b, nslots, tslots = len(nodes), spec.label_slots, spec.taint_slots
        lk = np.zeros((b, nslots), np.int32)
        lv = np.zeros((b, nslots), np.int32)
        ln = np.zeros((b, nslots), np.int32)
        tk = np.zeros((b, tslots), self.taint_id.dtype)
        te = np.zeros((b, tslots), self.taint_effect.dtype)
        zone = np.zeros((b,), np.int32)
        region = np.zeros((b,), np.int32)
        name_id = np.zeros((b,), np.int32)
        cpu = np.zeros((b,), np.int32)
        mem = np.zeros((b,), np.int32)
        pods = np.zeros((b,), np.int32)
        # Interner internals bound once per batch: the per-label
        # ``intern`` method-call overhead is a measured slice of the 1M
        # ingest wall (same-package access, mirrors Interner.intern).
        lk_id, lk_val = v.label_keys._to_id, v.label_keys._to_val
        lv_id, lv_val = v.label_values._to_id, v.label_values._to_val
        # numeric_of memo keyed by interned value id: repeated label
        # values (zones, groups) pay the parse once per distinct value.
        num_of: dict[int, int] = {}
        for i, node in enumerate(nodes):
            labels = dict(node.labels)
            labels.setdefault(HOSTNAME_LABEL, node.name)
            if len(labels) > nslots:
                raise ValueError(
                    f"node {node.name}: {len(labels)} labels > "
                    f"label_slots={nslots}"
                )
            for j, (k, val) in enumerate(sorted(labels.items())):
                ik = lk_id.get(k)
                if ik is None:
                    ik = len(lk_val)
                    lk_id[k] = ik
                    lk_val.append(k)
                if val is None:
                    # Interner.intern's None -> NONE_ID mapping (a JSON
                    # null label value reaches here via decode_node);
                    # the inlined fast path must not intern None as a
                    # fresh id or the bulk lane diverges from upsert.
                    iv, num = NONE_ID, numeric_of(val)
                else:
                    iv = lv_id.get(val)
                    if iv is None:
                        iv = len(lv_val)
                        lv_id[val] = iv
                        lv_val.append(val)
                    num = num_of.get(iv)
                    if num is None:
                        num = numeric_of(val)
                        num_of[iv] = num
                lk[i, j] = ik
                lv[i, j] = iv
                ln[i, j] = num
            taints = list(node.taints)
            if node.unschedulable:
                taints.append(
                    Taint(UNSCHEDULABLE_TAINT_KEY, "", EFFECT_NO_SCHEDULE)
                )
            if len(taints) > tslots:
                raise ValueError(
                    f"node {node.name}: {len(taints)} taints > "
                    f"taint_slots={tslots}"
                )
            for j, taint in enumerate(taints):
                if not 0 <= taint.effect < 4:
                    raise ValueError(
                        f"node {node.name}: taint effect {taint.effect} "
                        "outside the EFFECT_* range [0, 4)"
                    )
                tid = v.taints.intern((taint.key, taint.value, taint.effect))
                if tid >= spec.max_taint_ids:
                    raise ValueError(
                        "distinct taint triples overflow "
                        "TableSpec.max_taint_ids"
                    )
                tk[i, j] = tid
                te[i, j] = taint.effect
            zid = (
                v.zones.intern(labels[ZONE_LABEL])
                if ZONE_LABEL in labels else NONE_ID
            )
            rid = (
                v.regions.intern(labels[REGION_LABEL])
                if REGION_LABEL in labels else NONE_ID
            )
            if zid >= spec.max_zones or rid >= spec.max_regions:
                raise ValueError(
                    "zone/region id overflow; grow "
                    "TableSpec.max_zones/max_regions"
                )
            zone[i] = zid
            region[i] = rid
            name_id[i] = v.node_names.intern(node.name)
            cpu[i] = node.cpu_milli
            mem[i] = node.mem_kib
            pods[i] = node.pods
        # Every node validated: allocate rows (capacity pre-checked;
        # journal + epoch side effects in batch order, exactly like the
        # loop) and land the blocks in one write per column.
        rows = self.bulk_alloc([node.name for node in nodes])
        self.valid[rows] = True
        self.cpu_alloc[rows] = cpu
        self.mem_alloc[rows] = mem
        self.pods_alloc[rows] = pods
        self.label_key[rows] = lk
        self.label_val[rows] = lv
        self.label_num[rows] = ln
        self.taint_id[rows] = tk
        self.taint_effect[rows] = te
        self.zone[rows] = zone
        self.region[rows] = region
        self.name_id[rows] = name_id
        _BULK_ROWS.inc(b)
        return rows

    def remove(self, name: str) -> int:
        row = self._row_of.pop(name)
        self.valid[row] = False
        # Zero the row so stale ids can't match future queries.
        for arr in (
            self.cpu_alloc, self.mem_alloc, self.pods_alloc,
            self.cpu_req, self.mem_req, self.pods_req,
            self.zone, self.region, self.name_id,
        ):
            arr[row] = 0
        for arr in (
            self.label_key, self.label_val, self.label_num,
            self.taint_id, self.taint_effect,
        ):
            arr[row] = 0
        if self.wave_epoch:
            # Two-phase free: the row is tombstoned now (the caller
            # scatters valid=0 immediately) but its id stays quarantined
            # until every wave launched at or before this epoch retires
            # (see release_rows).
            self._quarantine.append((self.wave_epoch, row))
        else:
            self._free_rows.append(row)
        self.epoch += 1
        if self._row_journal is not None:
            self._row_journal.append((name, row, False))
        return row

    # ---- wave epochs ----------------------------------------------------

    def begin_wave(self) -> int:
        """Stamp one device-wave launch; returns the wave's epoch."""
        self.wave_epoch += 1
        return self.wave_epoch

    def release_rows(self, before_epoch: int | None = None) -> int:
        """Return quarantined rows to the free list.

        ``before_epoch`` is the oldest still-in-flight wave's epoch: a
        row removed at epoch E is only referenced by waves launched at
        epoch <= E, so it is safe once ``E < before_epoch``.  ``None``
        (no wave in flight) releases everything.  Returns the count.
        """
        n = 0
        q = self._quarantine
        while q and (before_epoch is None or q[0][0] < before_epoch):
            self._free_rows.append(q.popleft()[1])
            n += 1
        return n

    @property
    def quarantined(self) -> int:
        return len(self._quarantine)

    def add_pod(self, name: str, cpu_milli: int, mem_kib: int) -> None:
        """Account an already-bound pod (host mirror of commit_binds)."""
        row = self._row_of[name]
        self.cpu_req[row] += cpu_milli
        self.mem_req[row] += mem_kib
        self.pods_req[row] += 1

    def remove_pod(self, name: str, cpu_milli: int, mem_kib: int) -> None:
        row = self._row_of[name]
        self.cpu_req[row] -= cpu_milli
        self.mem_req[row] -= mem_kib
        self.pods_req[row] -= 1

    @property
    def num_nodes(self) -> int:
        return len(self._row_of)

    def columns(self) -> dict:
        """Every mirror column by NodeTable name (the arrays themselves)."""
        return {c: getattr(self, c) for c in COLUMNS}

    def to_device(self, device: str | torch.device = "cuda") -> NodeTable:
        """The plain-layout device table; narrow mirror columns widen to
        the canonical int32 (``valid`` stays bool)."""
        dev = resolve_device(device)

        def put(x):
            if x.dtype != np.bool_:
                x = np.asarray(x, np.int32)
            return to_tensor(x, dev)

        return NodeTable(**{c: put(a) for c, a in self.columns().items()})


def commit_binds(
    table,
    node_idx: torch.Tensor,   # i32/i64[B] row each pod bound to (any row if unbound)
    cpu_milli: torch.Tensor,  # i32[B]
    mem_kib: torch.Tensor,    # i32[B]
    bound: torch.Tensor,      # bool[B] — pod actually bound this wave
):
    """Fold this batch's bind decisions into requested-resources, IN PLACE.

    An ``index_add_`` on ``cpu_req``/``mem_req``/``pods_req`` — the port's
    form of the JAX step's buffer donation: the wave commits into the
    table's own storage instead of producing a new table, so no column
    is copied.  Callers that must keep the pre-commit state clone first.
    Works on either layout (the request columns share their names).
    Returns ``table`` for call-chaining.
    """
    zero = torch.zeros((), dtype=torch.int32, device=cpu_milli.device)
    idx = node_idx.to(torch.int64)
    table.cpu_req.index_add_(0, idx, torch.where(bound, cpu_milli, zero))
    table.mem_req.index_add_(0, idx, torch.where(bound, mem_kib, zero))
    table.pods_req.index_add_(0, idx, bound.to(torch.int32))
    return table


class RowVersions:
    """Monotone per-row mutation journal: the dirty bookkeeping that
    feeds the delta-plane cache's invalidation (engine/deltacache.py).

    Every batch of device-table row mutations is noted with one version
    stamp; a consumer holding per-row derived state (a cached
    feasibility/score plane) records the version it was computed at and
    asks ``rows_since(v)`` for exactly the rows that moved afterwards.
    The journal is bounded: past ``cap`` entries the oldest compact away
    and ``floor`` rises — a consumer stamped below ``floor`` cannot
    enumerate its delta and must treat its state as wholly stale.
    Compaction can only force extra recompute, never hide a moved row.
    """

    def __init__(self, cap: int = 1 << 16) -> None:
        self.cap = cap
        self.ver = 0
        # Versions below this are compacted out of the journal.
        self.floor = 0
        self._journal: collections.deque[tuple[int, int]] = collections.deque()

    def note(self, rows) -> int:
        """Stamp one mutation batch; returns the new version."""
        self.ver += 1
        v = self.ver
        self._journal.extend((v, int(r)) for r in rows)
        if len(self._journal) > self.cap:
            self.compact(keep=self.cap // 2)
        return v

    def compact(self, keep: int) -> None:
        """Drop the oldest entries down to ``keep``, raising ``floor``
        to the newest dropped version (consumers below it go stale)."""
        q = self._journal
        while len(q) > keep:
            v, _ = q.popleft()
            self.floor = max(self.floor, v)

    def release(self, before_ver: int) -> None:
        """Drop entries at versions < ``before_ver`` WITHOUT staling
        consumers at or past it (the caller proved every live consumer
        is stamped >= before_ver)."""
        q = self._journal
        while q and q[0][0] < before_ver:
            q.popleft()
        self.floor = max(self.floor, before_ver - 1)

    def rows_since(self, ver: int) -> set | None:
        """Rows mutated at versions > ``ver``; None when ``ver`` is below
        the compaction floor (the delta is unenumerable)."""
        if ver < self.floor:
            return None
        out: set[int] = set()
        for v, r in reversed(self._journal):
            if v <= ver:
                break
            out.add(r)
        return out

    def __len__(self) -> int:
        return len(self._journal)


# Column split for the coordinator's dirty-row scatters: capacity/feature
# columns carry what the node object says (the host is authoritative);
# the request columns carry bind accounting, which in a pipelined
# coordinator includes in-flight assumes the host mirror does not know
# yet.  A capacity-only node update scatters CAP_COLUMNS alone.
CAP_COLUMNS = (
    "valid", "cpu_alloc", "mem_alloc", "pods_alloc",
    "label_key", "label_val", "label_num",
    "taint_id", "taint_effect", "zone", "region", "name_id",
)
REQ_COLUMNS = ("cpu_req", "mem_req", "pods_req")
ALL_COLUMNS = CAP_COLUMNS + REQ_COLUMNS


def _row_index(rows, device) -> torch.Tensor:
    return torch.as_tensor(rows, device=device).to(torch.int64)


def scatter_rows(table, rows, delta: dict):
    """Write per-column values into ``rows`` of the device table, IN PLACE
    (``index_copy_`` on each named column; the keys of ``delta`` select the
    columns — see CAP_COLUMNS).  Values may be numpy arrays or tensors;
    they are cast to the column's dtype.  ``rows`` must lie in
    ``[0, num_rows)``.  Works on either layout for the columns they share
    (the request columns).  Returns ``table``."""
    for name, arr in delta.items():
        col = getattr(table, name)
        idx = _row_index(rows, col.device)
        col.index_copy_(0, idx, torch.as_tensor(arr, dtype=col.dtype, device=col.device))
    return table


def apply_delta(table, rows, delta):
    """Scatter D freshly compiled rows (``delta``, a table of the same
    layout with D rows) into ``rows`` of the device table, every column,
    IN PLACE.  Returns ``table``."""
    for f in dataclasses.fields(table):
        col = getattr(table, f.name)
        if isinstance(col, torch.Tensor):
            col.index_copy_(0, _row_index(rows, col.device), getattr(delta, f.name))
    return table
