"""The scheduling wave: filter -> score -> top-K -> assign -> commit.

Port of ``k8s1m_tpu/engine/cycle.py``: the packed production step
``schedule_batch_packed`` and the unpacked ``schedule_batch``.  One call
schedules a whole batch of pods against the node table (or a rotating
percentageOfNodesToScore window of it) and folds the binds into the table
— and, with constraint state, into the count tables — in place.

Two backends compute the candidates, as in the JAX package, and give the
same bytes:

- ``"pallas"`` — the hand-written CUDA kernels (``ops/fused_topk.py``,
  ``ops/delta_topk.py``); on CPU tensors their plain versions.  Every
  plugin stage of the fused kernel runs: the NodeAffinity stage for waves
  whose pods carry ``sel``/``req``/``pref`` groups, the constraint stage
  when ``constraints=`` is given.
- ``"xla"`` — the chunked scan ``filter_score_topk`` (``score_and_filter``
  -> ``pack_hashed`` -> top-K per chunk -> ``merge_topk``) in torch ops,
  and ``deltacache.plane_topk`` for the delta wave's tail.

``"auto"`` picks the kernels on a ``cuda`` table and the scan on the CPU,
as the JAX ``sched_bench`` picks Pallas only on a TPU.  The wave entry
points default to ``"pallas"``.

The deltasched wave ``schedule_batch_delta`` (with ``fill_shape_planes``)
is the steady-state twin: filter+score over the dirty rows only, merged
into cached per-shape planes, candidates from the delta-tail kernel
(``ops/delta_topk.py``) or the candidate index (``engine/deltacache.py``).
``chunk_topk``/``merge_topk``/``empty_candidates``/``_slice_table`` are the
XLA scan path's helpers it runs on.

The coordinator's side (``control/coordinator.py``): ``Wave`` is one
in-flight wave, ``mask_rows`` the ownership view ``row_mask=`` selects
candidates from, ``commit_fields_np`` and ``adjust_constraints`` the
signed count-table correction of CAS rollbacks and pod deletions.

``mesh=`` (a ``parallel.Mesh``) routes each wave through the dp x sp
sharded wave (``parallel/sharded_cycle.py``) over a ShardedTable, as the
JAX package routes it through ``make_sharded_packed_step``.  ``mesh`` and
``row_mask`` are exclusive, and the candidate index stays single-device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from k8s1m_tpu_torch.device import to_tensor
from k8s1m_tpu_torch.engine.assign import greedy_assign
from k8s1m_tpu_torch.ops.fused_topk import candidates, supports
from k8s1m_tpu_torch.ops.priority import pack_hashed
from k8s1m_tpu_torch.plugins import topology
from k8s1m_tpu_torch.plugins.registry import Profile, score_and_filter
from k8s1m_tpu_torch.snapshot.constraints import (
    ConstraintState,
    commit_constraint_binds,
    slice_constraints,
)
from k8s1m_tpu_torch.snapshot.node_table import commit_binds
from k8s1m_tpu_torch.snapshot.packing import is_packed, mask_rows_packed, unpack_chunk
from k8s1m_tpu_torch.snapshot.pod_encoding import PodBatch, unpack_pod_batch

# Pod field groups that need the NodeAffinity stage of the kernel.
AFFINITY_GROUPS = frozenset({"sel", "req", "pref"})
_M32 = 0xFFFFFFFF
BACKENDS = ("auto", "xla", "pallas")


def resolve_backend(backend: str, device) -> str:
    """``"xla"`` or ``"pallas"``: ``"auto"`` is the kernels on a ``cuda``
    device and the scan path elsewhere."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if backend == "auto":
        return "pallas" if torch.device(device).type == "cuda" else "xla"
    return backend


@dataclasses.dataclass
class Wave:
    """One in-flight pipelined wave: everything the coordinator needs to
    retire it later (CAS the binds back, roll back conflicts).

    ``epoch`` is the snapshot wave-epoch stamped at launch
    (``NodeTableHost.begin_wave``): a row removed at epoch E stays
    quarantined until every wave with ``epoch <= E`` has retired.
    ``asg`` and ``rows_dev`` are tensors no later wave writes into (a
    rollback reads them one or more waves later).  On a card,
    ``rows_host`` is the pinned host buffer ``rows_dev`` is copied into
    without blocking, and ``copied`` the CUDA event recorded after that
    copy: the retire waits on it before it reads a byte."""

    batch_pods: list
    batch: object            # PackedPodBatch as dispatched
    asg: "Assignment"
    rows_dev: torch.Tensor   # i32[B] bound row per pod (-1 = unbound)
    t_start: float
    epoch: int
    depth: int = 1           # in-flight depth including this wave
    path: str = "full"       # "full" or the deltacache "delta" pass
    # Candidate-index outcome of deltasched index waves: the i32 flag
    # tensor (1 = candidates from the index), whether the index update
    # was attempted, and the (index-path, plane-path) touched-row pair.
    index_flag_dev: object | None = None
    index_attempted: bool = False
    index_touched: tuple = (0, 0)
    rows_host: torch.Tensor | None = None
    copied: object | None = None


@dataclasses.dataclass
class Candidates:
    """Top-K bind candidates per pod, with payload gathered at score time."""

    idx: torch.Tensor     # i32[B, K] global node rows (-1 = none)
    prio: torch.Tensor    # i32[B, K] packed priorities, descending (-1 = infeasible)
    cpu: torch.Tensor     # i32[B, K] candidate free cpu at batch start
    mem: torch.Tensor     # i32[B, K]
    pods: torch.Tensor    # i32[B, K]
    zone: torch.Tensor    # i32[B, K] candidate's topology domains
    region: torch.Tensor  # i32[B, K]


@dataclasses.dataclass
class Assignment:
    node_row: torch.Tensor  # i32[B] (-1 = unbound, retry next batch)
    bound: torch.Tensor     # bool[B]
    score: torch.Tensor     # i32[B] integer plugin score of the chosen node
    zone: torch.Tensor      # i32[B] domain of the chosen node
    region: torch.Tensor    # i32[B]


@dataclasses.dataclass
class CommitFields:
    """The slice of a PodBatch the post-candidate epilogue needs."""

    cpu: torch.Tensor            # i32[B]
    mem: torch.Tensor            # i32[B]
    valid: torch.Tensor          # bool[B]
    sinc_valid: torch.Tensor     # spread-constraint commit increments
    sinc_cid: torch.Tensor
    sinc_topo: torch.Tensor
    iinc_valid: torch.Tensor     # affinity-term commit increments
    iinc_tid: torch.Tensor
    iinc_topo: torch.Tensor
    ipa_own_valid: torch.Tensor  # pod's own required anti-affinity terms
    ipa_tid: torch.Tensor
    ipa_topo: torch.Tensor


def commit_fields_np(fields: dict, device) -> CommitFields:
    """CommitFields on ``device`` from a PackedPodBatch's host field dict
    (the CAS-rollback and adjust paths); every array is copied."""
    t = {k: to_tensor(fields[k], device) for k in (
        "cpu", "mem", "valid", "sinc_valid", "sinc_cid", "sinc_topo",
        "iinc_valid", "iinc_tid", "iinc_topo", "ipa_tid", "ipa_topo",
    )}
    own = fields["ipa_valid"] & fields["ipa_required"] & fields["ipa_anti"]
    return CommitFields(ipa_own_valid=to_tensor(own, device), **t)


def commit_fields_of(batch: PodBatch) -> CommitFields:
    return CommitFields(
        cpu=batch.cpu,
        mem=batch.mem,
        valid=batch.valid,
        sinc_valid=batch.sinc_valid,
        sinc_cid=batch.sinc_cid,
        sinc_topo=batch.sinc_topo,
        iinc_valid=batch.iinc_valid,
        iinc_tid=batch.iinc_tid,
        iinc_topo=batch.iinc_topo,
        ipa_own_valid=batch.ipa_valid & batch.ipa_required & batch.ipa_anti,
        ipa_tid=batch.ipa_tid,
        ipa_topo=batch.ipa_topo,
    )


def _slice_table(table, start: int, chunk: int):
    """Rows ``[start, start+chunk)`` as views; a packed table decodes here
    into the plain layout the plugins read."""
    sliced = table.narrow(start, chunk)
    return unpack_chunk(sliced) if is_packed(sliced) else sliced


def topk_by_argmax(prio, k: int):
    """``lax.top_k`` semantics (values descending, the earlier index wins
    a tie) as ``k`` argmax knock-out passes over the last axis: (top
    [..., k], idx i32[..., k]).  ``torch.argmax`` returns the first
    maximal index; each pass knocks its winner out with the dtype's
    lowest value, and values are read from the original array, so the
    input must not hold that value (``pack_hashed`` emits -1 or >= 0)."""
    width = prio.shape[-1]
    if not 1 <= k <= width:
        raise ValueError(f"k must be in [1, {width}], got {k}")
    lowest = (float("-inf") if prio.is_floating_point()
              else torch.iinfo(prio.dtype).min)
    p = prio.clone()
    vals, idxs = [], []
    for _ in range(k):
        i = torch.argmax(p, dim=-1, keepdim=True)
        vals.append(prio.gather(-1, i))
        idxs.append(i)
        p.scatter_(-1, i, lowest)
    return torch.cat(vals, dim=-1), torch.cat(idxs, dim=-1).to(torch.int32)


def chunk_topk(prio, k: int):
    """``lax.top_k`` over the last axis with its tie rule — values
    descending, the earlier index first — as (top i32[..., k], idx
    i32[..., k]).  ``torch.topk`` promises no tie order, so it ranks a
    composite int64 key: the priority in the high word, (2^32-1 - index)
    in the low word; every key is distinct."""
    width = prio.shape[-1]
    if not 1 <= k <= width:
        raise ValueError(f"k must be in [1, {width}], got {k}")
    pos = torch.arange(width, device=prio.device, dtype=torch.int64)
    key = (prio.to(torch.int64) << 32) + (_M32 - pos)
    top = torch.topk(key, k, dim=-1).values
    return (top >> 32).to(torch.int32), (_M32 - (top & _M32)).to(torch.int32)


def merge_topk(a: Candidates, b: Candidates, k: int) -> Candidates:
    """Merge two candidate sets, keeping the k highest priorities (ties:
    ``a``'s entries first, then by position)."""
    top, sel = chunk_topk(torch.cat([a.prio, b.prio], dim=-1), k)
    at = sel.to(torch.int64)

    def take(name):
        both = torch.cat([getattr(a, name), getattr(b, name)], dim=-1)
        return both.gather(-1, at)

    return Candidates(prio=top, **{
        f.name: take(f.name) for f in dataclasses.fields(Candidates) if f.name != "prio"
    })


def empty_candidates(b: int, k: int, device="cuda") -> Candidates:
    dev = torch.device(device)
    zeros = torch.zeros((b, k), dtype=torch.int32, device=dev)
    return Candidates(
        idx=torch.full((b, k), -1, dtype=torch.int32, device=dev),
        prio=torch.full((b, k), -1, dtype=torch.int32, device=dev),
        cpu=zeros, mem=zeros.clone(), pods=zeros.clone(), zone=zeros.clone(),
        region=zeros.clone(),
    )


def filter_score_topk(table, batch, seed: int, profile: Profile, *, chunk: int, k: int,
                      constraints: ConstraintState | None = None, stats=None,
                      row_offset: int = 0, pod_offset: int = 0, stratum_bits: int = 0,
                      groups=None) -> Candidates:
    """The scan path: stream the table in ``chunk``-row pieces, keeping
    each pod's top-k candidates with their payload (free capacity and
    domains gathered in the chunk).

    Per chunk: ``score_and_filter`` (with the chunk's columns of
    ``constraints`` and the batch prologue ``stats``, built from the whole
    ``table`` when not given), ``pack_hashed`` over (pod row +
    ``pod_offset``, node row + ``row_offset``), the chunk's top-k, then
    ``merge_topk`` with the running set (earlier chunks win ties).  Rows
    whose priority is < 0 come back as ``idx = -1``.  ``groups`` are the
    packed batch's field groups: an absent group's plugin is skipped,
    which gives the same mask and score."""
    n = table.num_rows
    if n % chunk:
        raise ValueError(f"table rows {n} not divisible by chunk {chunk}")
    if constraints is not None and stats is None:
        stats = _prologue_stats(table, constraints)
    b = batch.batch
    dev = table.cpu_req.device
    i32, i64 = torch.int32, torch.int64
    pod_rows = torch.arange(b, device=dev, dtype=i64)[:, None] + pod_offset
    cand = empty_candidates(b, k, dev)
    for start in range(0, n, chunk):
        tchunk = _slice_table(table, start, chunk)
        cchunk = (None if constraints is None
                  else slice_constraints(constraints, start, chunk))
        mask, score = score_and_filter(tchunk, batch, profile, cchunk, stats, groups)
        cols = torch.arange(start, start + chunk, device=dev, dtype=i64)[None] + row_offset
        prio = pack_hashed(score, seed, mask, pod_rows, cols, stratum_bits)
        top, idx = chunk_topk(prio, k)
        at = idx.to(i64)
        free_cpu, free_mem, free_pods = tchunk.free()
        local = Candidates(
            idx=(idx + (start + row_offset)).to(i32), prio=top,
            cpu=free_cpu.to(i32)[at], mem=free_mem.to(i32)[at],
            pods=free_pods.to(i32)[at],
            zone=tchunk.zone.to(i32)[at], region=tchunk.region.to(i32)[at],
        )
        cand = merge_topk(cand, local, k)
    cand.idx = torch.where(cand.prio >= 0, cand.idx, torch.full_like(cand.idx, -1))
    return cand


def _prologue_stats(table, constraints: ConstraintState):
    """``topology.prologue`` over either layout: a packed table decodes
    its full valid/zone/region columns once per wave (``domain_view``)."""
    view = table.domain_view() if is_packed(table) else table
    return topology.prologue(view, constraints)


def commit_constraints_for_batch(
    constraints: ConstraintState,
    fields: CommitFields,
    asg: Assignment,
    node_row,       # i32[B] rows to scatter node-domain counts into
    bound_node,     # bool[B] gate for node-domain tables
    bound_domain,   # bool[B] gate for zone/region tables
) -> ConstraintState:
    return commit_constraint_binds(
        constraints,
        bound_node, bound_domain, node_row, asg.zone, asg.region,
        fields.sinc_valid, fields.sinc_cid, fields.sinc_topo,
        fields.iinc_valid, fields.iinc_tid, fields.iinc_topo,
        fields.ipa_own_valid, fields.ipa_tid, fields.ipa_topo,
    )


def finalize_batch(table, constraints: ConstraintState | None, cand: Candidates,
                   fields: CommitFields):
    """Greedy conflict resolution + capacity and constraint commit, all in
    place (``commit_binds``, ``commit_constraint_binds``).  Returns
    (table, constraints, Assignment)."""
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
    local_row = torch.where(bound, node_row, zero)
    commit_binds(table, local_row, fields.cpu, fields.mem, bound)
    if constraints is not None:
        commit_constraints_for_batch(constraints, fields, asg, local_row, bound, bound)
    return table, constraints, asg


def adjust_constraints_impl(
    constraints: ConstraintState,
    fields: CommitFields,
    node_row,      # i32[B] (any valid row where mask_node is off)
    zone,          # i32[B]
    region,        # i32[B]
    mask_node,     # bool[B] gate for node-domain tables
    mask_domain,   # bool[B] gate for zone/region tables
    sign: int = -1,
) -> ConstraintState:
    """Signed count-table correction outside the scheduling wave, IN
    PLACE: bind-CAS conflicts (sign=-1 rolls back the wave's optimistic
    commit for pods whose store write lost), pod deletions (sign=-1 at
    the recorded placement; ``mask_node`` is off when the node has since
    been removed, while the zone/region decrement still applies) and
    externally bound pods (sign=+1).  Returns ``constraints``."""
    zero = torch.zeros_like(node_row)
    return commit_constraint_binds(
        constraints,
        mask_node, mask_domain, torch.where(mask_node, node_row, zero), zone, region,
        fields.sinc_valid, fields.sinc_cid, fields.sinc_topo,
        fields.iinc_valid, fields.iinc_tid, fields.iinc_topo,
        fields.ipa_own_valid, fields.ipa_tid, fields.ipa_topo,
        sign=sign,
    )


# The JAX package jits the correction path under this name; here the
# one body already updates in place.
adjust_constraints = adjust_constraints_impl


def mask_rows(table, row_mask: torch.Tensor):
    """A candidate-selection view where rows outside ``row_mask`` (bool[N]
    on the table's device) are infeasible: ``valid`` cleared for the plain
    plugins and ``pods_alloc == 0``, the fused kernel's row-validity rule.
    The request columns are shared with ``table``, untouched — binds
    commit into the unmasked table."""
    if not (isinstance(row_mask, torch.Tensor) and row_mask.dtype == torch.bool
            and tuple(row_mask.shape) == (table.num_rows,)):
        raise TypeError(f"row_mask must be a bool tensor of {table.num_rows} rows")
    if is_packed(table):
        return mask_rows_packed(table, row_mask)
    return dataclasses.replace(
        table,
        valid=table.valid & row_mask,
        pods_alloc=torch.where(row_mask, table.pods_alloc,
                               torch.zeros_like(table.pods_alloc)),
    )


def sample_rows_for(nodes: int, score_pct: int, chunk: int) -> int | None:
    """percentageOfNodesToScore -> chunk-aligned window rows (None = the
    rounded window covers the whole table, i.e. scan everything)."""
    if score_pct >= 100:
        return None
    rows = -(-nodes * score_pct // 100)          # ceil
    rows = -(-rows // chunk) * chunk             # round up to chunk
    return None if rows >= nodes else rows


def sample_offset_for(i: int, nodes: int, rows: int) -> int:
    """Rotating window offset covering every row over ceil(N/S) steps
    (the tail window is anchored at N-S)."""
    w = nodes // rows
    total = w + (1 if nodes % rows else 0)
    i %= total
    return nodes - rows if i == w else i * rows


def _wave_candidates(backend: str, src, batch, seed: int, profile: Profile, *, chunk: int,
                     k: int, constraints, stats, stratum_bits: int, with_affinity: bool,
                     groups, reference: bool, row_offset: int = 0,
                     pod_offset: int = 0) -> Candidates:
    """Candidates from one backend over ``src`` (the table or a window
    view); ``constraints`` cover the same rows, ``stats`` the whole
    table.  ``row_offset``/``pod_offset`` globalize the hash coordinates
    and the emitted rows (a mesh cell's offsets)."""
    if backend == "xla":
        return filter_score_topk(src, batch, seed, profile, chunk=chunk, k=k,
                                 constraints=constraints, stats=stats,
                                 stratum_bits=stratum_bits, groups=groups,
                                 row_offset=row_offset, pod_offset=pod_offset)
    return candidates(src, batch, seed, profile, chunk=chunk, k=k, constraints=constraints,
                      stats=stats, stratum_bits=stratum_bits, with_affinity=with_affinity,
                      reference=reference, row_offset=row_offset, pod_offset=pod_offset)


def _check_backend(backend: str, device, profile: Profile, constraints) -> str:
    backend = resolve_backend(backend, device)
    if backend == "pallas" and constraints is None and not supports(profile):
        raise ValueError(
            "profile enables constraint plugins but no constraint state "
            "was passed (see ops/fused_topk.py)"
        )
    return backend


def _schedule_batch_impl(table, batch, seed: int, constraints: ConstraintState | None,
                         profile: Profile, chunk: int, k: int, backend: str = "xla",
                         with_affinity: bool = True, src=None, stratum_bits: int = 0,
                         groups=None, reference: bool = False):
    """One wave over the whole table: candidates from ``src`` (default:
    ``table``; a ``mask_rows`` view narrows them), greedy assignment and
    the commit into ``table`` and ``constraints``, in place.  The domain
    statistics come from ``table``, never the view."""
    src = table if src is None else src
    stats = None if constraints is None else _prologue_stats(table, constraints)
    cand = _wave_candidates(backend, src, batch, seed, profile, chunk=chunk, k=k,
                            constraints=constraints, stats=stats, stratum_bits=stratum_bits,
                            with_affinity=with_affinity, groups=groups, reference=reference)
    return finalize_batch(table, constraints, cand, commit_fields_of(batch))


def schedule_batch(
    table,
    batch: PodBatch,
    seed: int,
    *,
    profile: Profile,
    constraints: ConstraintState | None = None,
    chunk: int = 16384,
    k: int = 4,
    backend: str = "pallas",
    with_affinity: bool = True,
    stratum_bits: int = 0,
):
    """Schedule one unpacked pod batch (``PodBatchHost.encode``) against
    the whole table on the table's device — the replay and comparison
    entry point; the coordinator runs ``schedule_batch_packed``.

    ``backend`` is ``"pallas"`` (the kernels; the port's default, where
    the JAX package defaults to ``"xla"``), ``"xla"`` (the scan path) or
    ``"auto"``.  ``with_affinity=False`` runs the kernel without its
    NodeAffinity stage: pass it only when no pod carries selectors (the
    scan path ignores it).  The binds commit IN PLACE.

    Returns (table, constraints, Assignment)."""
    backend = _check_backend(backend, table.cpu_req.device, profile, constraints)
    return _schedule_batch_impl(table, batch, seed, constraints, profile, chunk, k, backend,
                                with_affinity=with_affinity, stratum_bits=stratum_bits)


def schedule_batch_packed(
    table,
    packed,
    seed: int,
    *,
    profile: Profile,
    constraints: ConstraintState | None = None,
    chunk: int = 16384,
    k: int = 4,
    backend: str = "pallas",
    sample_rows: int | None = None,
    sample_offset: int = 0,
    stratum_bits: int = 0,
    row_mask=None,
    mesh=None,
    reference: bool = False,
):
    """Schedule one packed pod batch on the table's device.

    ``table`` is a NodeTable or PackedNodeTable; ``packed`` a
    PackedPodBatch; ``seed`` the wave's i32 seed (the JAX step derives it
    from its key with ``seed_of``).  ``backend``: ``"pallas"`` (default),
    ``"xla"`` or ``"auto"`` (module doc).  ``sample_rows``/``sample_offset``
    restrict filter+score to rows ``[offset, offset+sample_rows)``; the
    hash's node coordinate is window-local and emitted rows are shifted
    back to global.  ``constraints`` (a ConstraintState) turns on the
    constraint stage: the domain statistics come from the FULL table and
    count tables, and only the node count columns follow the window.
    The binds commit into ``table`` — and the constraint counts into
    ``constraints`` — IN PLACE.  ``row_mask`` (bool[N] on the table's
    device) restricts candidate selection to the owned rows
    (``mask_rows``); the domain statistics stay global and the binds
    commit into the unmasked table.  ``reference=True`` runs the kernel's
    top-K through its plain version (the comparison path).

    ``mesh`` (a ``parallel.Mesh``) runs the wave over the dp x sp mesh
    (``parallel.sharded_cycle.sharded_packed_wave``): ``table`` must be a
    ShardedTable on that mesh (and ``constraints`` ShardedConstraints),
    and ``sample_rows``/``sample_offset`` become SHARD-LOCAL (each shard
    scores a window of its own rows).  Exclusive with ``row_mask``.

    Returns (table, Assignment, rows i32[B] — bound row per pod, -1 unbound).
    """
    if mesh is not None:
        if row_mask is not None:
            raise ValueError("mesh and row_mask are mutually exclusive")
        from k8s1m_tpu_torch.parallel.sharded_cycle import sharded_packed_wave

        table, _cons, asg, rows = sharded_packed_wave(
            mesh, table, packed, seed, profile, chunk=chunk, k=k, constraints=constraints,
            backend=backend, sample_rows=sample_rows, sample_offset=sample_offset,
            stratum_bits=stratum_bits, reference=reference,
        )
        return table, asg, rows
    device = table.cpu_req.device
    backend = _check_backend(backend, device, profile, constraints)
    batch = unpack_pod_batch(
        packed.ints, packed.bools, packed.spec, packed.table_spec,
        packed.groups, device=device,
    )
    # Waves whose pods carry no selectors skip the affinity stage; the
    # packed field groups already say so.
    kw = dict(chunk=chunk, k=k, stratum_bits=stratum_bits, reference=reference,
              with_affinity=bool(packed.groups & AFFINITY_GROUPS), groups=packed.groups)
    src = table if row_mask is None else mask_rows(table, row_mask)
    if sample_rows is None:
        table, _cons, asg = _schedule_batch_impl(table, batch, seed, constraints, profile,
                                                 backend=backend, src=src, **kw)
    else:
        # Domain statistics are global: the full, unmasked table.
        stats = None if constraints is None else _prologue_stats(table, constraints)
        view = src.narrow(sample_offset, sample_rows)
        view_cons = (None if constraints is None
                     else slice_constraints(constraints, sample_offset, sample_rows))
        cand = _wave_candidates(backend, view, batch, seed, profile, constraints=view_cons,
                                stats=stats, **kw)
        cand.idx = torch.where(
            cand.idx >= 0, cand.idx + sample_offset, torch.full_like(cand.idx, -1)
        )
        table, _cons, asg = finalize_batch(table, constraints, cand, commit_fields_of(batch))
    rows = torch.where(asg.bound, asg.node_row, torch.full_like(asg.node_row, -1))
    return table, asg, rows


# ---- deltasched: the plane-cached wave (engine/deltacache.py) --------------


def _i32_on(x, device) -> torch.Tensor:
    """``x`` (a tensor, numpy array or sequence) as an i32 tensor on
    ``device``; host values are copied."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int32)
    return to_tensor(np.asarray(x, np.int32), device)


def schedule_batch_delta(
    table,
    packed,
    seed: int,
    *,
    profile: Profile,
    slot_ids,
    planes,
    dirty,
    inflight_rows=(),
    chunk: int = 16384,
    k: int = 4,
    stratum_bits: int = 0,
    index=None,
    rep_idx=None,
    rebuild_slots=None,
    index_dirty_cap: int = 0,
    mesh=None,
    backend: str = "pallas",
):
    """``schedule_batch_packed``'s delta-wave twin (deltasched): every
    pod's feasibility/score plane is cached, so the wave runs filter+score
    only over ``dirty`` and the in-flight waves' bound rows, merges those
    columns into the planes and takes the candidates from the merged
    planes.

    ``planes`` is the (mask bool[S, N], score i32[S, N]) pair from
    ``DeltaPlaneCache.planes``; ``slot_ids`` maps each batch position to
    its slot (sentinel S for padding); ``dirty`` the sentinel-padded
    journaled rows; ``inflight_rows`` the unretired waves' bound-row
    tensors (-1 unbound).  With ``backend="pallas"`` the plane tail runs
    on the hand-written kernel (``ops/delta_topk.py``); ``"xla"`` runs its
    plain version ``deltacache.plane_topk`` instead — the scan path and the
    comparison path (the two differ on padding pods only, which never
    bind).

    ``index`` is the (idx_row, idx_class, idx_floor) triple of
    ``DeltaPlaneCache.index_state`` (with ``rep_idx``/``rebuild_slots``
    from the WavePlan): a combined dirty vector of at most
    ``index_dirty_cap`` rows updates the index first, and the wave takes
    its candidates from the index when ``index_usable`` says so — read on
    the host, one read per wave, where the JAX step decides on the device
    — else from the plane tail, which then rebuilds the used slots'
    indexes.  The plane tail never runs speculatively.

    The table, both planes and the index buffers are updated IN PLACE.
    Returns (table, Assignment, rows, (pmask, pscore)), plus ((idx_row,
    idx_class, idx_floor), flag) with ``index`` — ``flag`` an i32 scalar
    tensor, 1 when the index tail ran.

    Under ``mesh`` the table is a ShardedTable and the planes are sharded
    over sp (``DeltaPlaneCache(sharding=mesh)``); the dirty gather stays
    shard-local and the candidate index is refused (plane tail only)."""
    from k8s1m_tpu_torch.engine import deltacache as dc
    from k8s1m_tpu_torch.ops.delta_topk import delta_plane_topk

    if mesh is not None:
        if index is not None:
            raise ValueError("the candidate index does not compose with mesh sharding")
        from k8s1m_tpu_torch.parallel.sharded_cycle import sharded_delta_wave

        return sharded_delta_wave(
            mesh, table, packed, seed, profile, slot_ids=slot_ids, planes=planes,
            dirty=dirty, inflight_rows=inflight_rows, chunk=chunk, k=k, backend=backend,
            stratum_bits=stratum_bits,
        )
    pmask, pscore = planes
    device = table.cpu_req.device
    backend = resolve_backend(backend, device)
    batch = unpack_pod_batch(
        packed.ints, packed.bools, packed.spec, packed.table_spec,
        packed.groups, device=device,
    )
    n = pmask.shape[1]
    slot_ids = _i32_on(slot_ids, device)
    rows = dc.combine_dirty(_i32_on(dirty, device), inflight_rows, n)
    pmask, pscore, mask_d, score_d = dc.merge_dirty_planes(
        table, batch, profile, slot_ids, pmask, pscore, rows, packed.groups
    )
    tail = dc.plane_topk if backend == "xla" else delta_plane_topk

    def plane_tail():
        return tail(pmask, pscore, slot_ids, seed, chunk=chunk, k=k,
                    stratum_bits=stratum_bits)

    flag = 0
    if index is None:
        cand = plane_tail()
    else:
        idx_row, idx_class, idx_floor = index
        rep = _i32_on(rep_idx, device)
        rebuild = _i32_on(rebuild_slots, device)
        state = (idx_row, idx_class, idx_floor)
        kw = dict(chunk=chunk, stratum_bits=stratum_bits, batch_b=slot_ids.shape[0])
        if rows.shape[0] <= index_dirty_cap:
            state = dc.update_index(*state, rep, dc.dedup_rows(rows, n), mask_d, score_d, n,
                                    stratum_bits=stratum_bits)
            flag = int(bool(dc.index_usable(state[1], state[2], slot_ids, k)))
        if flag:
            cand = dc.index_topk(state[0], state[1], slot_ids, seed, k=k,
                                 stratum_bits=stratum_bits)
        else:
            state = dc.rebuild_index(pmask, pscore, rebuild, rep, *state, **kw)
            cand = plane_tail()
        for buf, new in zip((idx_row, idx_class, idx_floor), state):
            buf.copy_(new)
    cand = dc.attach_payload(table, cand)
    table, _cons, asg = finalize_batch(table, None, cand, commit_fields_of(batch))
    rows_out = torch.where(asg.bound, asg.node_row, torch.full_like(asg.node_row, -1))
    if index is None:
        return table, asg, rows_out, (pmask, pscore)
    return (table, asg, rows_out, (pmask, pscore), index,
            torch.tensor(flag, dtype=torch.int32, device=device))


def fill_shape_planes(table, packed, fill_slots, planes, *, profile: Profile,
                      chunk: int = 16384, mesh=None):
    """Populate the plane slots in ``fill_slots`` (sentinel >= S: skip)
    from a full filter+score pass for the representative pods in
    ``packed`` (the cold-shape / refresh path of deltasched).  The planes
    are written IN PLACE and returned; the table is read only.  Under
    ``mesh`` each shard fills its own plane slices from its own rows."""
    from k8s1m_tpu_torch.engine.deltacache import fill_planes_scan

    if mesh is not None:
        from k8s1m_tpu_torch.parallel.sharded_cycle import sharded_plane_fill

        return sharded_plane_fill(mesh, table, packed, fill_slots, planes, profile=profile,
                                  chunk=chunk)
    pmask, pscore = planes
    device = table.cpu_req.device
    batch = unpack_pod_batch(
        packed.ints, packed.bools, packed.spec, packed.table_spec,
        packed.groups, device=device,
    )
    return fill_planes_scan(table, batch, profile, _i32_on(fill_slots, device), pmask,
                            pscore, chunk=chunk, groups=packed.groups)
