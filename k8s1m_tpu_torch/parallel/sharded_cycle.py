"""The multi-device scheduling wave over the (dp, sp) mesh.

Port of ``k8s1m_tpu/parallel/sharded_cycle.py``.  Dataflow per wave:

1. each (dp, sp) cell runs filter+score+top-K over its [B/dp, N/sp] block
   — the fused kernel (``ops/fused_topk.py``) or the delta-tail kernel
   (``ops/delta_topk.py``) at the cell's offsets, or their plain versions
   on CPU tensors;
2. the candidates of each dp rank are gathered over ``sp`` shard-major
   onto the mesh's first device and the top-K is kept again, with the
   lower index first on ties (``chunk_topk``, ``lax.top_k``'s rule);
3. the dp ranks' lists are concatenated in batch order (across processes
   by ``torch.distributed.all_gather`` under ``multihost``);
4. the greedy conflict scan runs once, on the first device (under
   ``multihost`` once per process, on identical inputs);
5. every distinct storage commits the binds that land in its row range,
   and the first storage on each device also commits the zone/region
   count updates into that device's shared tables.

Byte-identity contract (JAX module doc): every cell uses the SAME per-wave
seed and hashes tie-break jitter over GLOBAL (pod row, node row)
coordinates (``mesh_offsets``: ``pod_offset = d * B/dp``, ``row_offset =
s * N/sp``, plus the window's offset), each cell's list keeps ties in
ascending global row order, and the sp/dp gathers concatenate shard-major
— so the merged lists, the scan and the bound rows are the single-device
wave's, byte for byte.  Sampled windows are the one exception: each shard
scores ``[offset, offset + sample_rows)`` of its OWN rows, so a sampled
mesh wave equals the JAX mesh of the same shape, not a single device.

One stage per wave: every cell launches the stage the whole wave needs
(``AFFINITY_GROUPS`` of the packed batch decide ``aff`` once; constraint
state decides ``cons``), as the JAX step decides ``aff`` once per wave.

Donation is in-place update, as on a single device: the table, count
tables and planes are written in their own storage.  The ``donate=False``
factories commit into clones instead (the JAX replay variants).

There is no ``shard_map_compat``: the port has no JAX API skew to hide;
the cells are a Python loop over the mesh.  On one card they run one after
another on the current stream; across cards each device's current stream
runs its cells, and every hop to the first device is a ``.to()`` copy,
which orders itself after the source stream's work.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from k8s1m_tpu_torch.device import to_tensor
from k8s1m_tpu_torch.engine.assign import greedy_assign
from k8s1m_tpu_torch.engine.cycle import (
    AFFINITY_GROUPS,
    Assignment,
    Candidates,
    _check_backend,
    _wave_candidates,
    chunk_topk,
    commit_constraints_for_batch,
    commit_fields_of,
    resolve_backend,
)
from k8s1m_tpu_torch.parallel.mesh import (
    Mesh,
    ShardedConstraints,
    ShardedTable,
    ShardedTensor,
    shard_constraints,
    shard_table,
    slice_batch,
)
from k8s1m_tpu_torch.plugins import topology
from k8s1m_tpu_torch.plugins.registry import Profile
from k8s1m_tpu_torch.snapshot.constraints import slice_constraints
from k8s1m_tpu_torch.snapshot.node_table import commit_binds, scatter_rows
from k8s1m_tpu_torch.snapshot.packing import is_packed
from k8s1m_tpu_torch.snapshot.pod_encoding import unpack_pod_batch


def _no_timer(_name):
    return contextlib.nullcontext()


class SpAxis:
    """The sp axis of a mesh as the prologue's reductions see it: each
    takes the per-shard tensors and returns the reduced one on
    ``device`` (the mesh's first device) — the port's ``lax.pmin``,
    ``lax.pmax`` and ``lax.psum`` over ``"sp"``."""

    def __init__(self, device: torch.device):
        self.device = device

    def _stack(self, parts):
        return torch.stack([p.to(self.device) for p in parts])

    def pmin(self, parts):
        return self._stack(parts).amin(dim=0)

    def pmax(self, parts):
        return self._stack(parts).amax(dim=0)

    def psum(self, parts):
        return self._stack(parts).sum(dim=0, dtype=parts[0].dtype)


def mesh_offsets(d: int, s: int, rows: int, b_local: int) -> tuple[int, int]:
    """(pod_offset, row_offset) of cell (d, s): the tie-break hash is a
    pure function of (seed, global pod row, global node row), so a dp
    rank passes its batch-block offset and an sp shard its row offset,
    and every cell's priorities are the slice a single device computes."""
    return d * b_local, s * rows


def sharded_prologue(table: ShardedTable, constraints: ShardedConstraints):
    """``topology.prologue`` across the sp shards (a packed shard decodes
    its DomainView, shard-locally), on the mesh's first device."""
    mesh = table.mesh
    sp = mesh.shape["sp"]
    views = []
    for s in range(sp):
        t = table.shard(s)
        views.append(t.domain_view() if is_packed(t) else t)
    return topology.prologue(views, [constraints.shard(s) for s in range(sp)],
                             axis=SpAxis(mesh.first_device))


def _on(x, dev, cache: dict):
    """``x`` (a dataclass of tensors) on ``dev``, copied once per device."""
    if x is None:
        return None
    got = cache.get(dev)
    if got is None:
        got = cache[dev] = dataclasses.replace(x, **{
            f.name: getattr(x, f.name).to(dev) for f in dataclasses.fields(x)
            if isinstance(getattr(x, f.name), torch.Tensor)
        })
    return got


def _take(cand: Candidates, sel) -> Candidates:
    at = sel.to(torch.int64)
    return Candidates(**{
        f.name: getattr(cand, f.name).gather(-1, at) for f in dataclasses.fields(Candidates)
    })


def _dp_all_gather(cand: Candidates, mesh: Mesh) -> Candidates:
    """Concatenate every process's dp rows in rank order (multihost)."""
    import torch.distributed as dist

    names = [f.name for f in dataclasses.fields(Candidates)]
    mine = torch.stack([getattr(cand, n) for n in names]).contiguous()
    got = [torch.empty_like(mine) for _ in range(mesh.processes)]
    dist.all_gather(got, mine)
    both = torch.cat(got, dim=1)
    return Candidates(**{n: both[i] for i, n in enumerate(names)})


def merge_shards(parts: list, k: int, device) -> Candidates:
    """One dp rank's sp gather: the shards' [b, k] lists concatenated
    shard-major on ``device`` ([b, sp*k], shard 0 first) and the top ``k``
    kept with ``lax.top_k``'s rule — priorities descending, the lower
    position first on ties, so a tie between shards goes to the lower
    shard and within a shard to the lower row (``torch.topk`` promises no
    order among ties; ``chunk_topk`` ranks distinct composite keys)."""
    names = [f.name for f in dataclasses.fields(Candidates)]
    cat = Candidates(**{
        n: torch.cat([getattr(p, n).to(device) for p in parts], dim=1) for n in names
    })
    top, sel = chunk_topk(cat.prio, k)
    return dataclasses.replace(_take(cat, sel), prio=top)


def gather_and_finalize(table: ShardedTable, cand_grid: dict, fields, constraints, *,
                        k: int, timer=_no_timer):
    """The sharded epilogue: the sp gather (shard-major) and top-K per dp
    rank, the dp gather, the greedy scan on the first device, and each
    storage's commit of the binds in its row range (the zone/region
    update once per device).  ``cand_grid`` maps each cell (d, s) to its
    Candidates; ``fields`` are the FULL batch's CommitFields.

    Returns (table, constraints, Assignment), the Assignment on the
    mesh's first device."""
    mesh = table.mesh
    dev0 = mesh.first_device
    sp = mesh.shape["sp"]
    names = [f.name for f in dataclasses.fields(Candidates)]
    with timer("gather"):
        ranks = [merge_shards([cand_grid[(d, s)] for s in range(sp)], k, dev0)
                 for d in mesh.local_dp]
        cand = Candidates(**{n: torch.cat([getattr(r, n) for r in ranks]) for n in names})
        if mesh.processes > 1:
            cand = _dp_all_gather(cand, mesh)
        fields = _on(fields, dev0, {})
    with timer("greedy"):
        node_row, bound, score, chosen_k = greedy_assign(
            cand.idx, cand.prio, cand.cpu, cand.mem, cand.pods,
            fields.cpu, fields.mem, fields.valid,
        )
        at = chosen_k[:, None].to(torch.int64)
        zero = torch.zeros_like(node_row)
        asg = Assignment(
            node_row=node_row, bound=bound, score=score,
            zone=torch.where(bound, cand.zone.gather(1, at)[:, 0], zero),
            region=torch.where(bound, cand.region.gather(1, at)[:, 0], zero),
        )
    with timer("commit"):
        commit_sharded(table, constraints, fields, asg)
    return table, constraints, asg


def commit_sharded(table: ShardedTable, constraints, fields, asg: Assignment) -> None:
    """Fold a wave's binds into every storage once: the capacity and
    hostname-count commit of the rows in its range, and — on the first
    storage of each device — the zone/region counts."""
    mesh = table.mesh
    rows = table.rows_per_shard
    fcache: dict = {}
    acache: dict = {}
    for i, (s, dev) in enumerate(mesh.storages):
        a = _on(asg, dev, acache)
        f = _on(fields, dev, fcache)
        lo = s * rows
        local = a.bound & (a.node_row >= lo) & (a.node_row < lo + rows)
        local_row = torch.where(local, a.node_row - lo, torch.zeros_like(a.node_row))
        commit_binds(table.parts[i], local_row, f.cpu, f.mem, local)
        if constraints is not None:
            domain = a.bound if mesh.domain_owner[i] else torch.zeros_like(a.bound)
            commit_constraints_for_batch(constraints.parts[i], f, a, local_row, local, domain)


def _full_batches(mesh: Mesh, packed) -> dict:
    """The wave's whole PodBatch, unpacked once on each device."""
    return {
        dev: unpack_pod_batch(packed.ints, packed.bools, packed.spec, packed.table_spec,
                              packed.groups, device=dev)
        for dev in mesh.local_devices()
    }


def _require_sharded(mesh: Mesh, table, constraints):
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parallel.Mesh, got {mesh!r}")
    if not isinstance(table, ShardedTable) or table.mesh != mesh:
        raise TypeError("mesh= needs the table placed on that mesh (parallel.shard_table)")
    if constraints is not None and (
        not isinstance(constraints, ShardedConstraints) or constraints.mesh != mesh
    ):
        raise TypeError("mesh= needs the constraint state placed on that mesh "
                        "(parallel.shard_constraints)")


def _b_local(mesh: Mesh, b_full: int) -> int:
    dp = mesh.shape["dp"]
    if b_full % dp:
        raise ValueError(f"batch {b_full} not divisible by dp={dp}")
    return b_full // dp


def sharded_wave(mesh: Mesh, table: ShardedTable, batches: dict, seed: int,
                 profile: Profile, *, chunk: int, k: int, constraints=None,
                 backend: str = "pallas", sample_rows: int | None = None,
                 sample_offset: int = 0, stratum_bits: int = 0, with_affinity: bool = True,
                 groups=None, reference: bool = False, timer=_no_timer):
    """One full wave over the mesh, IN PLACE: per-cell candidates from
    ``backend`` at the cell's global offsets (over the shard-local window
    when ``sample_rows`` is set), then ``gather_and_finalize``.
    ``batches`` holds the whole PodBatch per device.  Returns (table,
    constraints, Assignment, rows i32[B])."""
    rows = table.rows_per_shard
    b_local = _b_local(mesh, next(iter(batches.values())).batch)
    if sample_rows is not None and not 0 <= sample_offset <= rows - sample_rows:
        raise ValueError(f"window [{sample_offset}, {sample_offset + sample_rows}) "
                         f"outside the shard's {rows} rows")
    stats_on: dict = {}
    if constraints is not None:
        with timer("prologue"):
            stats = sharded_prologue(table, constraints)
    grid = {}
    for d, s in mesh.cells():
        dev = mesh.device(d, s)
        pod_off, row_off = mesh_offsets(d, s, rows, b_local)
        part = table.part(d, s)
        cons = None if constraints is None else constraints.part(d, s)
        if sample_rows is not None:
            part = part.narrow(sample_offset, sample_rows)
            cons = None if cons is None else slice_constraints(cons, sample_offset, sample_rows)
            row_off += sample_offset
        with timer(f"kernel:{d}x{s}"):
            grid[(d, s)] = _wave_candidates(
                backend, part, slice_batch(batches[dev], d, b_local), seed, profile,
                chunk=chunk, k=k, constraints=cons,
                stats=None if constraints is None else _on(stats, dev, stats_on),
                stratum_bits=stratum_bits, with_affinity=with_affinity, groups=groups,
                reference=reference, row_offset=row_off, pod_offset=pod_off,
            )
    full = batches[mesh.first_device] if mesh.first_device in batches else next(
        iter(batches.values()))
    table, constraints, asg = gather_and_finalize(
        table, grid, commit_fields_of(full), constraints, k=k, timer=timer)
    rows_out = torch.where(asg.bound, asg.node_row, torch.full_like(asg.node_row, -1))
    return table, constraints, asg, rows_out


def sharded_packed_wave(mesh: Mesh, table, packed, seed: int, profile: Profile, *,
                        chunk: int, k: int, constraints=None, backend: str = "pallas",
                        sample_rows: int | None = None, sample_offset: int = 0,
                        stratum_bits: int = 0, reference: bool = False, timer=_no_timer):
    """``engine.cycle.schedule_batch_packed`` over a mesh, IN PLACE on the
    sharded table (and count tables).  Returns (table, constraints,
    Assignment, rows)."""
    _require_sharded(mesh, table, constraints)
    backend = _check_backend(backend, mesh.first_device, profile, constraints)
    with timer("unpack"):
        batches = _full_batches(mesh, packed)
    return sharded_wave(
        mesh, table, batches, seed, profile, chunk=chunk, k=k, constraints=constraints,
        backend=backend, sample_rows=sample_rows, sample_offset=sample_offset,
        stratum_bits=stratum_bits, with_affinity=bool(packed.groups & AFFINITY_GROUPS),
        groups=packed.groups, reference=reference, timer=timer,
    )


def make_sharded_step(mesh: Mesh, profile: Profile, *, chunk: int, k: int,
                      backend: str = "pallas"):
    """The replay surface over an unpacked PodBatch: step(table, batch,
    seed[, constraints]) -> (ShardedTable, ShardedConstraints|None,
    Assignment).  Whole tables are cut onto the mesh (a copy); a
    ShardedTable is cloned first, so the caller's input is never written
    (the JAX step is not donating either)."""

    def step(table, batch, seed: int, constraints=None):
        # A whole table is cut into new shards; a sharded one is cloned.
        table = (table.clone() if isinstance(table, ShardedTable)
                 else shard_table(table, mesh))
        if constraints is not None:
            constraints = (constraints.clone() if isinstance(constraints, ShardedConstraints)
                           else shard_constraints(constraints, mesh))
        be = _check_backend(backend, mesh.first_device, profile, constraints)
        batches = {dev: _on(batch, dev, {}) for dev in mesh.local_devices()}
        t, c, asg, _rows = sharded_wave(
            mesh, table, batches, seed, profile, chunk=chunk, k=k, constraints=constraints,
            backend=be)
        return t, c, asg

    return step


def make_sharded_packed_step(mesh: Mesh, profile: Profile, *, chunk: int, k: int, pod_spec,
                             table_spec, groups: frozenset, sample_rows: int | None = None,
                             backend: str = "pallas", donate: bool = False,
                             stratum_bits: int = 0):
    """The coordinator's production step over the mesh: step(table, ints,
    bools, seed, offset[, constraints]) -> (table, constraints|None,
    Assignment, rows i32[B]).  ``donate=True`` commits in place (the
    caller's table and count tables ARE the returned ones);
    ``donate=False`` commits into clones."""
    from k8s1m_tpu_torch.snapshot.pod_encoding import PackedPodBatch

    _b_local(mesh, pod_spec.batch)

    def step(table, ints, bools, seed: int, offset: int, constraints=None):
        if not donate:
            table = table.clone()
            constraints = None if constraints is None else constraints.clone()
        packed = PackedPodBatch(np.asarray(ints), np.asarray(bools), pod_spec, table_spec,
                                groups)
        return sharded_packed_wave(
            mesh, table, packed, seed, profile, chunk=chunk, k=k, constraints=constraints,
            backend=backend, sample_rows=sample_rows, sample_offset=int(offset),
            stratum_bits=stratum_bits)

    return step


def make_sharded_scatter(mesh: Mesh):
    """The dirty-row scatter over a ShardedTable — the mesh form of
    ``snapshot.node_table.scatter_rows``, IN PLACE: each storage takes
    the rows of its range, once.  Safe while waves are in flight: it is
    queued after them on each device's stream."""

    def scatter(table: ShardedTable, rows, delta: dict) -> ShardedTable:
        return sharded_scatter(table, rows, delta)

    return scatter


def sharded_scatter(table: ShardedTable, rows, delta: dict) -> ShardedTable:
    """``scatter_rows`` over a ShardedTable (global ``rows``; numpy or
    tensor values)."""
    rows_np = np.asarray(rows.cpu() if isinstance(rows, torch.Tensor) else rows)
    n = table.rows_per_shard
    for i, (s, _dev) in enumerate(table.mesh.storages):
        sel = (rows_np >= s * n) & (rows_np < (s + 1) * n)
        if not sel.any():
            continue
        sub = {}
        for name, arr in delta.items():
            if isinstance(arr, torch.Tensor):
                sub[name] = arr[torch.from_numpy(np.nonzero(sel)[0]).to(arr.device)]
            else:
                sub[name] = np.asarray(arr)[sel]
        scatter_rows(table.parts[i], rows_np[sel] - s * n, sub)
    return table


def sharded_adjust(constraints: ShardedConstraints, fields, node_row, zone, region,
                   mask_node, mask_domain, sign: int = -1) -> ShardedConstraints:
    """``engine.cycle.adjust_constraints`` over sharded count tables, IN
    PLACE: each storage takes the node-domain corrections of its row
    range, and the first storage of each device the zone/region ones."""
    from k8s1m_tpu_torch.engine.cycle import adjust_constraints_impl

    mesh = constraints.mesh
    rows = constraints.parts[0].spread_node.shape[1]
    for i, (s, dev) in enumerate(mesh.storages):
        f = _on(fields, dev, {})
        nr, mn, md = node_row.to(dev), mask_node.to(dev), mask_domain.to(dev)
        lo = s * rows
        local = mn & (nr >= lo) & (nr < lo + rows)
        adjust_constraints_impl(
            constraints.parts[i], f, torch.where(local, nr - lo, torch.zeros_like(nr)),
            zone.to(dev), region.to(dev), local,
            md if mesh.domain_owner[i] else torch.zeros_like(md), sign=sign,
        )
    return constraints


# ---- deltasched: the sharded plane-cached wave (engine/deltacache.py) -------


def sharded_delta_wave(mesh: Mesh, table: ShardedTable, packed, seed: int, profile: Profile,
                       *, slot_ids, planes, dirty, inflight_rows=(), chunk: int, k: int,
                       backend: str = "pallas", stratum_bits: int = 0, timer=_no_timer):
    """The mesh twin of ``engine.cycle.schedule_batch_delta``, IN PLACE on
    the table and the sharded planes: each storage merges the dirty rows
    of its range (the whole batch's recompute — cheap, and it keeps every
    storage's planes the single device's columns), each cell takes the
    plane tail's top-K at its offsets and the payload from its shard, then
    the shared epilogue.  Constraint state is not threaded (delta waves
    carry constraint-termless pods).  Returns (table, Assignment, rows,
    (pmask, pscore))."""
    from k8s1m_tpu_torch.engine import deltacache as dc
    from k8s1m_tpu_torch.ops.delta_topk import delta_plane_topk

    _require_sharded(mesh, table, None)
    pmask, pscore = planes
    if not (isinstance(pmask, ShardedTensor) and isinstance(pscore, ShardedTensor)):
        raise TypeError("mesh= needs the delta planes sharded over sp (DeltaPlaneCache(sharding=mesh))")
    backend = resolve_backend(backend, mesh.first_device)
    tail = dc.plane_topk if backend == "xla" else delta_plane_topk
    with timer("unpack"):
        batches = _full_batches(mesh, packed)
    b_local = _b_local(mesh, packed.spec.batch)
    n_local = table.rows_per_shard
    dev0 = mesh.first_device
    ids = {dev: (slot_ids.to(dev, torch.int32) if isinstance(slot_ids, torch.Tensor)
                 else to_tensor(np.asarray(slot_ids, np.int32), dev))
           for dev in mesh.local_devices()}
    dirty_t = (dirty.to(dev0, torch.int32) if isinstance(dirty, torch.Tensor)
               else to_tensor(np.asarray(dirty, np.int32), dev0))
    rows = dc.combine_dirty(dirty_t, [r.to(dev0) for r in inflight_rows], table.num_rows)
    with timer("merge"):
        for i, (s, dev) in enumerate(mesh.storages):
            local = rows.to(dev) - s * n_local
            local = torch.where((local >= 0) & (local < n_local), local,
                                torch.full_like(local, n_local))
            dc.merge_dirty_planes(table.parts[i], batches[dev], profile, ids[dev],
                                  pmask.parts[i], pscore.parts[i], local, packed.groups)
    grid = {}
    for d, s in mesh.cells():
        dev = mesh.device(d, s)
        pod_off, row_off = mesh_offsets(d, s, n_local, b_local)
        with timer(f"kernel:{d}x{s}"):
            cand = tail(pmask.part(d, s), pscore.part(d, s),
                        ids[dev].narrow(0, d * b_local, b_local), seed, chunk=chunk, k=k,
                        row_offset=row_off, pod_offset=pod_off, stratum_bits=stratum_bits)
            grid[(d, s)] = dc.attach_payload(table.part(d, s), cand, row_offset=row_off)
    table, _cons, asg = gather_and_finalize(
        table, grid, commit_fields_of(batches[dev0]), None, k=k, timer=timer)
    rows_out = torch.where(asg.bound, asg.node_row, torch.full_like(asg.node_row, -1))
    return table, asg, rows_out, (pmask, pscore)


def make_sharded_delta_step(mesh: Mesh, profile: Profile, *, chunk: int, k: int, pod_spec,
                            table_spec, groups: frozenset, n_inflight: int = 0,
                            donate: bool = False, backend: str = "pallas",
                            stratum_bits: int = 0):
    """step(table, ints, bools, seed, slot_ids, pmask, pscore, dirty,
    *inflight) -> (table, Assignment, rows, pmask, pscore); ``donate``
    as in ``make_sharded_packed_step``."""
    from k8s1m_tpu_torch.snapshot.pod_encoding import PackedPodBatch

    def step(table, ints, bools, seed, slot_ids, pmask, pscore, dirty, *inflight):
        if len(inflight) != n_inflight:
            raise ValueError(f"expected {n_inflight} in-flight row vectors, got {len(inflight)}")
        if not donate:
            table, pmask, pscore = table.clone(), pmask.clone(), pscore.clone()
        packed = PackedPodBatch(np.asarray(ints), np.asarray(bools), pod_spec, table_spec,
                                groups)
        t, asg, rows, (m, sc) = sharded_delta_wave(
            mesh, table, packed, seed, profile, slot_ids=slot_ids, planes=(pmask, pscore),
            dirty=dirty, inflight_rows=inflight, chunk=chunk, k=k, backend=backend,
            stratum_bits=stratum_bits)
        return t, asg, rows, m, sc

    return step


def sharded_plane_fill(mesh: Mesh, table: ShardedTable, packed, fill_slots, planes, *,
                       profile: Profile, chunk: int):
    """The mesh twin of ``engine.cycle.fill_shape_planes``: each storage
    fills its plane slices from its own rows (a per-row map: no traffic
    between shards).  The table is read only.  Returns the planes."""
    from k8s1m_tpu_torch.engine.deltacache import fill_planes_scan

    _require_sharded(mesh, table, None)
    pmask, pscore = planes
    batches = _full_batches(mesh, packed)
    for i, (_s, dev) in enumerate(mesh.storages):
        fs = (fill_slots.to(dev, torch.int32) if isinstance(fill_slots, torch.Tensor)
              else to_tensor(np.asarray(fill_slots, np.int32), dev))
        fill_planes_scan(table.parts[i], batches[dev], profile, fs, pmask.parts[i],
                         pscore.parts[i], chunk=chunk, groups=packed.groups)
    return pmask, pscore


def make_sharded_plane_fill(mesh: Mesh, profile: Profile, *, chunk: int, pod_spec,
                            table_spec, groups: frozenset):
    """fill(table, ints, bools, fill_slots, pmask, pscore) -> (pmask,
    pscore), written in place (the JAX fill donates its planes)."""
    from k8s1m_tpu_torch.snapshot.pod_encoding import PackedPodBatch

    def fill(table, ints, bools, fill_slots, pmask, pscore):
        packed = PackedPodBatch(np.asarray(ints), np.asarray(bools), pod_spec, table_spec,
                                groups)
        return sharded_plane_fill(mesh, table, packed, fill_slots, (pmask, pscore),
                                  profile=profile, chunk=chunk)

    return fill
