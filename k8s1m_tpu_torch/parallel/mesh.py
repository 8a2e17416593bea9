"""The dp x sp device mesh and the sharded state that lives on it.

Port of ``k8s1m_tpu/parallel/mesh.py``.  Two mesh axes replace the
reference's two distribution mechanisms (reference SURVEY.md §2.5):

- ``sp`` (shard parallel) — the node table's row axis is split over sp,
  the counterpart of the ``dist-scheduler.dev/scheduler`` node label that
  partitions 1M nodes across 256 Go replicas; rows belong to a shard by
  position, so rebalancing moves no data;
- ``dp`` (data parallel) — the pending-pod batch axis: each dp rank scores
  a contiguous block of the wave's pods against every sp shard.

Node tables split over ``sp`` and replicate over ``dp``; pod batches split
over ``dp`` and replicate over ``sp``.  Where JAX names these layouts with
``PartitionSpec``s (``table_specs``, ``constraint_specs``,
``batch_specs``), the port moves the data itself: ``shard_table`` cuts a
table into its sp row blocks, ``shard_constraints`` cuts the hostname
count tables on their node axis (axis 1) and keeps the zone/region tables
whole, ``shard_planes`` cuts the delta planes on their row axis, and
``slice_batch`` takes one dp rank's pod block.

Placement: ``make_mesh`` puts the dp x sp cells round-robin over the
visible cards, so a mesh may hold several cells on one card (a JAX mesh
needs a device per cell).  Cells of one sp index that land on the same
device SHARE one copy of that shard — a "storage" — and every device keeps
one copy of the zone/region count tables, shared by all its storages.  The
sharded step commits each wave, and each dirty-row scatter, into every
distinct storage exactly once (``Mesh.storages``), so a shard that two dp
ranks alias is never written twice.  Shards on one card run one after
another on its current stream; nothing here is concurrent across cells.

Under ``multihost`` the mesh spans processes: process ``p`` holds dp row
``p`` (all sp cells of it) and the cells of other rows are ``None`` here.
"""

from __future__ import annotations

import dataclasses
import logging
import os

import torch

from k8s1m_tpu_torch.device import resolve_device
from k8s1m_tpu_torch.snapshot.constraints import FIELDS as CONSTRAINT_FIELDS
from k8s1m_tpu_torch.snapshot.constraints import NODE_FIELDS, ConstraintState
from k8s1m_tpu_torch.snapshot.node_table import _map_tensors
from k8s1m_tpu_torch.snapshot.packing import is_packed

log = logging.getLogger("k8s1m.mesh")

# Production mesh selection: "DPxSP" (also "DP,SP"), "auto" (largest
# valid dp x sp over the visible cards), or "none"/"" (single device).
# Read by Coordinator when no explicit mesh is passed, and inherited by
# every tool that builds one.
MESH_ENV = "K8S1M_MESH"


class Mesh:
    """A dp x sp grid of ``torch.device``s (``shape = {"dp", "sp"}``).

    ``devices[d][s]`` is the device of cell (d, s), ``None`` for a cell
    another process holds (``multihost``).  ``storages`` lists the
    distinct (sp index, device) pairs of this process's cells, sp-major:
    each is one copy of that sp shard, shared by every dp rank placed on
    that device.  ``domain_owner[i]`` marks the first storage on each
    device, the one whose wave commit also updates the device's shared
    zone/region count tables.  ``first_device`` is where the candidate
    gather and the greedy scan run (the device of this process's first
    cell)."""

    def __init__(self, devices, *, rank: int = 0, processes: int = 1):
        rows = [[None if d is None else torch.device(d) for d in row] for row in devices]
        if not rows or not rows[0] or any(len(r) != len(rows[0]) for r in rows):
            raise ValueError("mesh devices must be a non-empty dp x sp grid")
        self.devices = tuple(tuple(r) for r in rows)
        self.shape = {"dp": len(rows), "sp": len(rows[0])}
        self.rank = rank
        self.processes = processes
        self.local_dp = tuple(d for d, r in enumerate(rows) if r[0] is not None)
        if not self.local_dp or any(
            (c is None) != (rows[d][0] is None) for d, r in enumerate(rows) for c in r
        ):
            raise ValueError("a process must hold whole dp rows of the mesh")
        storages, index = [], {}
        for s in range(self.shape["sp"]):
            for d in self.local_dp:
                key = (s, rows[d][s])
                if key not in index:
                    index[key] = len(storages)
                    storages.append(key)
        self.storages = tuple(storages)
        self._storage_of = {
            (d, s): index[(s, rows[d][s])]
            for d in self.local_dp for s in range(self.shape["sp"])
        }
        seen = set()
        owner = []
        for _s, dev in storages:
            owner.append(dev not in seen)
            seen.add(dev)
        self.domain_owner = tuple(owner)
        self.first_device = rows[self.local_dp[0]][0]

    def device(self, d: int, s: int) -> torch.device:
        return self.devices[d][s]

    def storage_index(self, d: int, s: int) -> int:
        return self._storage_of[(d, s)]

    def cells(self) -> list[tuple[int, int]]:
        """This process's (dp, sp) cells in launch order (dp-major)."""
        return [(d, s) for d in self.local_dp for s in range(self.shape["sp"])]

    def local_devices(self) -> list[torch.device]:
        """Distinct devices of this process's cells, in first-use order."""
        out = []
        for _s, dev in self.storages:
            if dev not in out:
                out.append(dev)
        return out

    def synchronize(self) -> None:
        """Block until every card of the mesh has finished its queued work."""
        for dev in self.local_devices():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    def _key(self):
        return (self.devices, self.rank, self.processes)

    def __eq__(self, other):
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    def __repr__(self):
        return (f"Mesh(dp={self.shape['dp']}, sp={self.shape['sp']}, "
                f"devices={[str(d) for d in self.local_devices()]}, "
                f"rank={self.rank}/{self.processes})")


def visible_devices(device: str | torch.device = "cuda") -> list[torch.device]:
    """The devices a mesh may use: every visible card for ``cuda`` (raises
    without one), the one host device for ``cpu``."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is not None:
            return [dev]
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [dev]


def make_mesh(dp: int, sp: int, devices=None, *, device: str | torch.device = "cuda") -> Mesh:
    """A dp x sp mesh whose cells go round-robin over ``devices``
    (default: ``visible_devices(device)``), dp-major: cell (d, s) takes
    device ``(d * sp + s) % len(devices)``.  Unlike JAX's, it takes more
    cells than devices (several shards share a card)."""
    if dp < 1 or sp < 1:
        raise ValueError(f"mesh axes must be >= 1, got {dp}x{sp}")
    if devices is None:
        devices = visible_devices(device)
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError(f"mesh {dp}x{sp} needs {dp*sp} devices, have 0")
    flat = [devices[i % len(devices)] for i in range(dp * sp)]
    return Mesh([flat[d * sp:(d + 1) * sp] for d in range(dp)])


def parse_mesh(s: str | None):
    """"DPxSP"/"DP,SP" -> (dp, sp); "auto" -> "auto"; "none"/""/None -> None."""
    if s is None:
        return None
    s = s.strip().lower()
    if s in ("", "none", "0", "off"):
        return None
    if s == "auto":
        return "auto"
    for sep in ("x", ","):
        if sep in s:
            dp_s, sp_s = s.split(sep, 1)
            dp, sp = int(dp_s), int(sp_s)
            if dp < 1 or sp < 1:
                raise ValueError(f"mesh axes must be >= 1, got {s!r}")
            return dp, sp
    raise ValueError(f"mesh spec {s!r} is not DPxSP, DP,SP, auto, or none")


def auto_mesh_shape(
    n_devices: int, *, batch: int, max_nodes: int, chunk: int
) -> tuple[int, int] | None:
    """Largest valid (dp, sp) split of ``n_devices`` for this workload.

    Validity is the coordinator's divisibility contract: rows split evenly
    over sp in chunk-aligned blocks (max_nodes % sp == 0 and
    rows-per-shard % chunk == 0) and the pod batch splits evenly over dp.
    Preference: use every device, and give ``sp`` the larger axis.
    Returns None when no split beats single-device."""
    for total in range(n_devices, 1, -1):
        for sp in range(total, 0, -1):
            if total % sp:
                continue
            dp = total // sp
            if max_nodes % sp or (max_nodes // sp) % chunk or batch % dp:
                continue
            return dp, sp
    return None


def resolve_mesh(mesh, *, batch: int, max_nodes: int, chunk: int, env=None,
                 device: str | torch.device = "cuda"):
    """The coordinator's mesh-selection funnel.

    ``mesh`` may be a built Mesh (returned as-is), a spec string ("DPxSP",
    "auto", "none"), or None — then the ``K8S1M_MESH`` env var decides
    (unset = single device).  "auto" counts the visible cards of
    ``device`` (not shards: one card gives no split) and falls back to a
    single device, with a log line saying why, when none fits."""
    if mesh is None or isinstance(mesh, str):
        spec = mesh if isinstance(mesh, str) else (
            (env if env is not None else os.environ).get(MESH_ENV)
        )
        shape = parse_mesh(spec)
        if shape is None:
            return None
        if shape == "auto":
            n = len(visible_devices(device))
            shape = auto_mesh_shape(n, batch=batch, max_nodes=max_nodes, chunk=chunk)
            if shape is None:
                log.info(
                    "mesh auto: no dp x sp split of %d devices fits "
                    "batch=%d max_nodes=%d chunk=%d; running single-device",
                    n, batch, max_nodes, chunk,
                )
                return None
        mesh = make_mesh(*shape, device=device)
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parallel.Mesh, a spec string or None, got {mesh!r}")
    return mesh


# ---- sharded state -----------------------------------------------------------


def _copy_to(x: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """A new contiguous tensor on ``dev`` holding ``x`` (never an alias)."""
    out = torch.empty(tuple(x.shape), dtype=x.dtype, device=dev)
    out.copy_(x)
    return out


def _split_rows(total: int, mesh: Mesh, what: str) -> int:
    sp = mesh.shape["sp"]
    if total % sp:
        raise ValueError(f"{what} rows {total} not divisible by sp={sp}")
    return total // sp


class _Sharded:
    """Parts aligned with ``mesh.storages``; ``part(d, s)`` is the copy
    cell (d, s) reads and commits into."""

    def __init__(self, mesh: Mesh, parts: list):
        if len(parts) != len(mesh.storages):
            raise ValueError(f"{len(parts)} parts for {len(mesh.storages)} storages")
        self.mesh = mesh
        self.parts = list(parts)

    def part(self, d: int, s: int):
        return self.parts[self.mesh.storage_index(d, s)]

    def shard(self, s: int):
        """Shard ``s`` as this process's first dp rank holds it."""
        return self.part(self.mesh.local_dp[0], s)


class ShardedTable(_Sharded):
    """A NodeTable or PackedNodeTable split into sp row blocks of
    ``rows_per_shard`` rows; ``num_rows`` is the global row count."""

    @property
    def rows_per_shard(self) -> int:
        return self.parts[0].num_rows

    @property
    def num_rows(self) -> int:
        return self.rows_per_shard * self.mesh.shape["sp"]

    @property
    def packed(self) -> bool:
        return is_packed(self.parts[0])

    @property
    def spec(self):
        return self.parts[0].spec

    def clone(self) -> "ShardedTable":
        return ShardedTable(self.mesh, [p.clone() for p in self.parts])

    def gather(self, device: str | torch.device = "cpu"):
        """The whole table on ``device``, rows in global order."""
        dev = torch.device(device)
        first = self.shard(0)
        return dataclasses.replace(first, **{
            f.name: torch.cat([getattr(self.shard(s), f.name).to(dev)
                               for s in range(self.mesh.shape["sp"])])
            for f in dataclasses.fields(first)
            if isinstance(getattr(first, f.name), torch.Tensor)
        })


class ShardedConstraints(_Sharded):
    """ConstraintState per storage: the hostname tables' node columns of
    its sp shard, and the zone/region tables of its device (one tensor per
    device, shared by every storage there)."""

    def clone(self) -> "ShardedConstraints":
        dom: dict[int, torch.Tensor] = {}
        parts = []
        for p in self.parts:
            kw = {}
            for f in CONSTRAINT_FIELDS:
                t = getattr(p, f)
                if f in NODE_FIELDS:
                    kw[f] = t.clone()
                else:
                    kw[f] = dom.setdefault(id(t), t.clone())
            parts.append(ConstraintState(**kw))
        return ShardedConstraints(self.mesh, parts)

    def gather(self, device: str | torch.device = "cpu") -> ConstraintState:
        dev = torch.device(device)
        sp = self.mesh.shape["sp"]
        return ConstraintState(**{
            f: (torch.cat([getattr(self.shard(s), f).to(dev) for s in range(sp)], dim=1)
                if f in NODE_FIELDS else getattr(self.shard(0), f).to(dev))
            for f in CONSTRAINT_FIELDS
        })


class ShardedTensor(_Sharded):
    """A tensor split over sp on ``axis`` (the delta planes: [S, N/sp])."""

    def __init__(self, mesh: Mesh, parts: list, axis: int = 1):
        super().__init__(mesh, parts)
        self.axis = axis

    def clone(self) -> "ShardedTensor":
        return ShardedTensor(self.mesh, [p.clone() for p in self.parts], self.axis)

    def gather(self, device: str | torch.device = "cpu") -> torch.Tensor:
        dev = torch.device(device)
        return torch.cat([self.shard(s).to(dev) for s in range(self.mesh.shape["sp"])],
                         dim=self.axis)


def shard_table(table, mesh: Mesh) -> ShardedTable:
    """Cut a whole table (either layout, any device) into the mesh's sp row
    blocks, one copy per storage.  A ShardedTable passes through."""
    if isinstance(table, ShardedTable):
        return table
    rows = _split_rows(table.num_rows, mesh, "table")
    return ShardedTable(mesh, [
        _map_tensors(table.narrow(s * rows, rows), lambda t, dev=dev: _copy_to(t, dev))
        for s, dev in mesh.storages
    ])


def shard_constraints(cons: ConstraintState, mesh: Mesh) -> ShardedConstraints:
    """Cut the hostname count tables on their node axis over sp; copy the
    zone/region tables once per device."""
    if isinstance(cons, ShardedConstraints):
        return cons
    rows = _split_rows(cons.spread_node.shape[1], mesh, "constraint")
    dom: dict[torch.device, dict] = {}
    parts = []
    for s, dev in mesh.storages:
        whole = dom.setdefault(dev, {
            f: _copy_to(getattr(cons, f), dev)
            for f in CONSTRAINT_FIELDS if f not in NODE_FIELDS
        })
        parts.append(ConstraintState(**whole, **{
            f: _copy_to(getattr(cons, f).narrow(1, s * rows, rows), dev)
            for f in NODE_FIELDS
        }))
    return ShardedConstraints(mesh, parts)


def shard_planes(x: torch.Tensor, mesh: Mesh, axis: int = 1) -> ShardedTensor:
    """Cut a plane (or any tensor) on its row ``axis`` over sp."""
    if isinstance(x, ShardedTensor):
        return x
    rows = _split_rows(x.shape[axis], mesh, "plane")
    return ShardedTensor(mesh, [
        _copy_to(x.narrow(axis, s * rows, rows), dev) for s, dev in mesh.storages
    ], axis)


def zeros_planes(mesh: Mesh, slots: int, rows: int, dtype) -> ShardedTensor:
    """A [slots, rows] plane of zeros, split over sp, built on each device."""
    local = _split_rows(rows, mesh, "plane")
    return ShardedTensor(mesh, [
        torch.zeros((slots, local), dtype=dtype, device=dev) for _s, dev in mesh.storages
    ])


def slice_batch(batch, d: int, b_local: int):
    """dp rank ``d``'s contiguous pod block of a PodBatch (views): every
    pod-leading field is cut to ``[d*b_local, (d+1)*b_local)``; the query
    key table ``qkey`` stays whole."""
    b = batch.batch
    return dataclasses.replace(batch, **{
        f.name: getattr(batch, f.name).narrow(0, d * b_local, b_local)
        for f in dataclasses.fields(batch)
        if f.name != "qkey" and getattr(batch, f.name).dim() >= 1
        and getattr(batch, f.name).shape[0] == b
    })
