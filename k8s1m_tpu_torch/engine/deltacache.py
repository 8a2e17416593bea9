"""deltasched: incremental filter+score via shape-keyed plane reuse.

Port of ``k8s1m_tpu/engine/deltacache.py``.  Per pod *shape*
(``snapshot/hotfeed.shape_key``) the cache keeps a device-resident
feasibility plane ``bool[S, N]`` and score plane ``i32[S, N]`` — what
``plugins/registry.score_and_filter`` computes for that shape over the
whole table — and a wave whose every pod hits the cache:

1. recomputes filter+score over the dirty rows only (the host-journaled
   rows since the stalest used slot's fill, plus every in-flight wave's
   bound rows), ``merge_dirty_planes``;
2. scatter-merges them into the planes, in place;
3. runs the per-pod hashed top-K over the merged planes — the plane tail,
   on the card the hand-written kernel ``ops/delta_topk.py`` (the
   counterpart of the Pallas ``_delta_kernel``), here ``plane_topk`` as its
   plain version — or, with the candidate index, over the index entries.

The binds are byte-identical to full recompute whenever the planes equal
a full recompute of the rows that did not move: that is the contract the
host half (``DeltaPlaneCache``) keeps by journaling every row mutation
(``snapshot/node_table.RowVersions``) and dropping the cache wholesale on
events no row set can bound.

Three parts, as in the JAX module: the device functions (torch, on the
planes' device), the score-stratified candidate index, and the host
controller.  Where the JAX code scatters with ``mode="drop"`` (sentinel
rows ``N``, padding slots ``S``), the port writes only the in-range
targets: a clamped sentinel would write over row ``N-1`` or slot ``S-1``.
The port has no metrics registry yet; the counters live in ``COUNTERS``
under the JAX metric names and label values.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import os
import weakref

import numpy as np
import torch

from k8s1m_tpu_torch.device import resolve_device
from k8s1m_tpu_torch.engine.cycle import Candidates, _slice_table, chunk_topk
from k8s1m_tpu_torch.ops.priority import JITTER_BITS, class_key, hash_jitter, pack_hashed
from k8s1m_tpu_torch.plugins.registry import Profile, score_and_filter
from k8s1m_tpu_torch.snapshot.node_table import RowVersions, _map_tensors
from k8s1m_tpu_torch.snapshot.packing import is_packed, unpack_chunk

log = logging.getLogger("k8s1m.deltasched")

_M32 = 0xFFFFFFFF
_I32_MIN = -(1 << 31)

# Counters under the JAX package's metric names; the key within each is
# the label value ("" for an unlabeled counter).
COUNTER_NAMES = (
    "deltasched_waves_total",               # label: path (delta | full)
    "deltasched_shape_hits_total",
    "deltasched_shape_misses_total",
    "deltasched_evictions_total",
    "deltasched_fills_total",
    "deltasched_dirty_rows_total",
    "deltasched_index_waves_total",         # label: path (index | plane)
    "deltasched_index_drops_total",         # label: reason
    "deltasched_index_touched_rows_total",  # label: path
)
COUNTERS: dict[str, collections.Counter] = {n: collections.Counter() for n in COUNTER_NAMES}
_LIVE_CACHES: weakref.WeakSet = weakref.WeakSet()


def _inc(name: str, amount: int = 1, label: str = "") -> None:
    COUNTERS[name][label] += amount


def reset_counters() -> None:
    for c in COUNTERS.values():
        c.clear()


def planes_resident() -> int:
    """The ``deltasched_planes_resident`` gauge: shape planes resident
    across live caches."""
    return sum(len(c._slot_of) for c in _LIVE_CACHES)


def resolve_deltasched(arg: str | bool | None = None) -> str:
    """Delta-cache mode from an explicit arg or the K8S1M_DELTASCHED env
    var: "off" or "on"; unknown values raise."""
    if isinstance(arg, bool):
        return "on" if arg else "off"
    mode = arg if arg is not None else os.environ.get("K8S1M_DELTASCHED", "off")
    if mode not in ("off", "on"):
        raise ValueError(f"K8S1M_DELTASCHED/deltacache must be off|on, got {mode!r}")
    return mode


# ---- device-side plane ops --------------------------------------------------


def combine_dirty(host_dirty, inflight_rows, sentinel: int):
    """One dirty-row vector: the host-journaled rows (sentinel-padded)
    plus every in-flight wave's bound rows, whose -1 unbound markers
    become the out-of-range sentinel so the merge skips them."""
    parts = [host_dirty.to(torch.int32)]
    for r in inflight_rows:
        parts.append(torch.where(r >= 0, r, sentinel).to(torch.int32))
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def gather_rows(table, idx):
    """A decoded plain-layout mini-table of the rows at ``idx`` (clipped
    to ``[0, N)``; callers skip out-of-range entries when they write)."""
    n = table.num_rows
    safe = idx.clamp(0, n - 1).to(torch.int64)
    sub = _map_tensors(table, lambda t: t[safe])
    return unpack_chunk(sub) if is_packed(sub) else sub


def merge_dirty_planes(table, batch, profile: Profile, slot_ids, pmask, pscore, rows,
                       groups=None):
    """Recompute filter+score for ``rows`` against the CURRENT table and
    write the columns into the planes at each pod's slot, IN PLACE.

    ``rows`` carry the sentinel ``N`` for padding, ``slot_ids`` the
    sentinel ``S`` for padding pods; only pairs with slot in ``[0, S)``
    and row in ``[0, N)`` are written (one host sync: the pair list).
    Duplicate (slot, row) targets carry identical values — pods share a
    slot only when they share the shape key — so the write is
    deterministic.  Returns (pmask, pscore, mask_d, score_d), the
    recomputed columns [B, D] too (the index update keys on them)."""
    mask_d, score_d = score_and_filter(gather_rows(table, rows), batch, profile, None, None,
                                       groups)
    s, n = pmask.shape
    ok = ((slot_ids >= 0) & (slot_ids < s))[:, None] & ((rows >= 0) & (rows < n))[None, :]
    pi, ri = torch.nonzero(ok, as_tuple=True)
    at = (slot_ids[pi].to(torch.int64), rows[ri].to(torch.int64))
    pmask.index_put_(at, mask_d[pi, ri])
    pscore.index_put_(at, score_d[pi, ri])
    return pmask, pscore, mask_d, score_d


def _take_slots(plane, slots, fill):
    """``jnp.take(plane, slots, 0)`` in its default mode over [S, C]: a
    slot in [-S, 0) wraps, one outside [-S, S) reads ``fill``."""
    s = plane.shape[0]
    sl = slots.to(torch.int64)
    inside = (sl >= -s) & (sl < s)
    got = plane[torch.where(sl < 0, sl + s, sl).clamp(0, s - 1)]
    return torch.where(inside[:, None], got, torch.full((), fill, dtype=plane.dtype,
                                                         device=plane.device))


def without_payload(idx, prio) -> Candidates:
    """Candidates with the payload columns zeroed (``attach_payload``
    fills them)."""
    zeros = torch.zeros_like(prio)
    return Candidates(idx=idx, prio=prio, cpu=zeros, mem=zeros.clone(), pods=zeros.clone(),
                      zone=zeros.clone(), region=zeros.clone())


def plane_topk(pmask, pscore, slot_ids, seed, *, chunk: int, k: int,
               row_offset: int = 0, pod_offset: int = 0, stratum_bits: int = 0):
    """Per-pod hashed top-K over the merged planes: the plain version of
    the plane-tail kernel (``ops/delta_topk.py``).

    Each pod reads its slot's row of the planes (``jnp.take`` semantics:
    a padding slot ``S`` reads mask True and score int32-min, which clips
    to 0 — where the kernel, like the Pallas one, clips the slot to
    ``S-1`` instead; the two differ on padding pods only), packs
    ``clip(score, 0, 2047) << 20 | hash_jitter(seed, pod + pod_offset,
    col + row_offset)`` where the mask holds, and keeps the top ``k`` by
    (priority descending, earlier column first) in ``chunk``-column
    pieces with a running merge.  Payload columns come back zeroed;
    ``attach_payload`` gathers them."""
    s, n = pmask.shape
    if n % chunk:
        raise ValueError(f"plane rows {n} not divisible by chunk {chunk}")
    if not 1 <= k <= chunk:
        raise ValueError(f"k must be in [1, chunk={chunk}], got {k}")
    b = slot_ids.shape[0]
    dev = pmask.device
    pod_rows = torch.arange(b, device=dev, dtype=torch.int64)[:, None] + pod_offset
    run_key = torch.full((b, k), -(1 << 32), dtype=torch.int64, device=dev)
    for c0 in range(0, n, chunk):
        m = _take_slots(pmask[:, c0:c0 + chunk], slot_ids, True)
        sc = _take_slots(pscore[:, c0:c0 + chunk], slot_ids, _I32_MIN)
        cols = torch.arange(c0, c0 + chunk, device=dev, dtype=torch.int64) + row_offset
        prio = pack_hashed(sc, seed, m, pod_rows, cols[None, :], stratum_bits)
        # Priority in the high word, (2^32-1 - column) in the low word.
        key = (prio.to(torch.int64) << 32) + (_M32 - cols)[None, :]
        run_key = torch.topk(torch.cat([run_key, key], dim=1), k, dim=1).values
    prio = (run_key >> 32).to(torch.int32)
    idx = (_M32 - (run_key & _M32)).to(torch.int32)
    return without_payload(torch.where(prio >= 0, idx, torch.full_like(idx, -1)), prio)


# ---- score-stratified candidate index (device half) -------------------------
#
# Per resident slot: ``idx_row i32[S, K]`` (rows, stored ascending — the
# earlier-row-wins tie rule), ``idx_class i32[S, K]`` (ops/priority.
# class_key; -1 = empty entry, row = sentinel N) and ``idx_floor i32[S]``.
# Invariant: every feasible row NOT in a slot's index has class_key <=
# floor.  floor == -1: the index is exhaustive; INDEX_FLOOR_UNBUILT: no
# index yet (fails closed).  A wave derives candidates from the index iff
# every used slot has >= k entries strictly above its floor or is
# exhaustive; anything else takes the plane tail.

INDEX_FLOOR_UNBUILT = int(np.iinfo(np.int32).max)


def dedup_rows(rows, n: int):
    """First-occurrence filter over the combined dirty vector: a row that
    repeats an earlier entry becomes the sentinel ``n``."""
    d = rows.shape[0]
    iota = torch.arange(d, device=rows.device, dtype=torch.int32)
    at = rows.to(torch.int64)
    first = torch.full((n + 1,), d, dtype=torch.int32, device=rows.device)
    first.scatter_reduce_(0, at, iota, reduce="amin", include_self=True)
    keep = (rows < n) & (first[at] == iota)
    return torch.where(keep, rows, torch.full_like(rows, n))


def _sort_desc_class(cls, row, keep: int):
    """Sort entries by (class descending, row ascending), keep the first
    ``keep`` re-sorted to ascending-row storage order, and return the
    class of the first discarded entry (the floor raise).  Rows are
    non-negative and below 2^31."""
    key = ((-cls).to(torch.int64) << 32) + row.to(torch.int64)
    sk = torch.sort(key, dim=1).values
    neg = sk >> 32
    kept_cls, kept_row = -neg[:, :keep], sk[:, :keep] & _M32
    spill = -neg[:, keep]
    order = torch.argsort(kept_row, dim=1, stable=True)
    return (kept_row.gather(1, order).to(torch.int32),
            kept_cls.gather(1, order).to(torch.int32), spill.to(torch.int32))


def update_index(idx_row, idx_class, idx_floor, rep_idx, rows, mask_d, score_d, n: int,
                 *, stratum_bits: int):
    """Apply one wave's dirty slice to the candidate index (new tensors).

    ``rows`` is the deduped dirty vector (sentinel ``n``); ``mask_d`` /
    ``score_d`` the recomputed columns [B, D]; ``rep_idx i32[S]`` one batch
    position per slot used this wave (sentinel = batch size).  Per used
    slot: drop entries whose row went dirty, insert dirty rows feasible
    and strictly above the floor, keep the top K by (class desc, row
    asc), raise the floor to the best evicted class.  Unused slots are
    untouched."""
    b = mask_d.shape[0]
    rep = rep_idx.clamp(0, b - 1).to(torch.int64)
    valid_rep = rep_idx < b
    m = mask_d[rep]                                   # [S, D]
    sc = score_d[rep]
    cls_d = class_key(sc, rows[None, :], stratum_bits)
    qualify = m & (rows < n)[None, :] & (cls_d > idx_floor[:, None])
    cand_cls = torch.where(qualify, cls_d, torch.full_like(cls_d, -1))
    cand_row = torch.where(qualify, rows[None, :].expand_as(cls_d), torch.full_like(cls_d, n))

    flag = torch.zeros((n + 1,), dtype=torch.bool, device=rows.device)
    flag[rows.to(torch.int64)] = True
    inv = flag[idx_row.to(torch.int64)]
    old_cls = torch.where(inv, torch.full_like(idx_class, -1), idx_class)
    old_row = torch.where(inv, torch.full_like(idx_row, n), idx_row)

    k_idx = idx_row.shape[1]
    new_row, new_cls, spill = _sort_desc_class(
        torch.cat([old_cls, cand_cls], dim=1), torch.cat([old_row, cand_row], dim=1), k_idx
    )
    new_floor = torch.maximum(idx_floor, spill)
    vr = valid_rep[:, None]
    return (
        torch.where(vr, new_row, idx_row),
        torch.where(vr, new_cls, idx_class),
        torch.where(valid_rep, new_floor, idx_floor),
    )


def index_usable(idx_class, idx_floor, slot_ids, k: int):
    """bool scalar tensor: may this wave derive its candidates from the
    index?  Per used slot: >= k entries strictly above the floor, or
    exhaustive (floor -1); the padding slot (sentinel S) always may."""
    above = (idx_class > idx_floor[:, None]).sum(dim=1)
    ok = (above >= k) | (idx_floor == -1)
    ok = torch.cat([ok, torch.ones((1,), dtype=torch.bool, device=ok.device)])
    return ok[slot_ids.to(torch.int64)].all()


def index_topk(idx_row, idx_class, slot_ids, seed, *, k: int, stratum_bits: int):
    """``plane_topk``'s sublinear twin: per-pod hashed top-K over the K
    index entries.  Priorities rebuild as ``(class << low) | (jitter &
    (2^low - 1))`` — bit-identical to ``pack_hashed`` over the planes by
    the class_key decomposition — and the ascending-row storage makes
    ``chunk_topk``'s earlier-position rule the full scan's earlier-row
    rule.  Padding pods read slot S-1, like the JAX clip."""
    b = slot_ids.shape[0]
    s = idx_row.shape[0]
    sl = slot_ids.clamp(0, s - 1).to(torch.int64)
    rows = idx_row[sl]                                # [B, K] (sentinel = N)
    cls = idx_class[sl]
    pod_rows = torch.arange(b, device=rows.device, dtype=torch.int64)[:, None]
    low = JITTER_BITS - stratum_bits
    j = hash_jitter(seed, pod_rows, rows)
    prio = torch.where(cls >= 0, (cls << low) | (j & ((1 << low) - 1)),
                       torch.full_like(cls, -1))
    top_prio, sel = chunk_topk(prio, k)
    idx = rows.gather(1, sel.to(torch.int64))
    return without_payload(torch.where(top_prio >= 0, idx, torch.full_like(idx, -1)), top_prio)


def rebuild_index(pmask, pscore, rebuild_slots, rep_idx, idx_row, idx_class, idx_floor,
                  *, chunk: int, stratum_bits: int, batch_b: int):
    """The plane tail's index maintenance (new tensors): rebuild the index
    of ``rebuild_slots`` from the merged planes (chunked running top-K by
    (class desc, row asc), the floor = best discarded class), and fail
    every OTHER slot used this wave closed (floor = INDEX_FLOOR_UNBUILT).
    Sentinel entries (slot >= S) are skipped."""
    s, n = pmask.shape
    k_idx = idx_row.shape[1]
    r = rebuild_slots.shape[0]
    dev = pmask.device
    rs = rebuild_slots.clamp(0, s - 1).to(torch.int64)
    crow = torch.full((r, k_idx), n, dtype=torch.int32, device=dev)
    ccls = torch.full((r, k_idx), -1, dtype=torch.int32, device=dev)
    cfloor = torch.full((r,), -1, dtype=torch.int32, device=dev)
    for c0 in range(0, n, chunk):
        pm = pmask[:, c0:c0 + chunk][rs]
        sc = pscore[:, c0:c0 + chunk][rs]
        cols = torch.arange(c0, c0 + pm.shape[1], device=dev, dtype=torch.int32)[None, :]
        cls = torch.where(pm, class_key(sc, cols, stratum_bits), torch.full_like(sc, -1))
        rows = torch.where(pm, cols.expand(r, -1), torch.full_like(sc, n))
        crow, ccls, spill = _sort_desc_class(
            torch.cat([ccls, cls], dim=1), torch.cat([crow, rows], dim=1), k_idx
        )
        cfloor = torch.maximum(cfloor, spill)

    used = rep_idx < batch_b
    rebuilt = torch.zeros((s + 1,), dtype=torch.bool, device=dev)
    rebuilt[rebuild_slots.clamp(0, s).to(torch.int64)] = True
    unbuilt = torch.full_like(idx_floor, INDEX_FLOOR_UNBUILT)
    idx_floor = torch.where(used & ~rebuilt[:s], unbuilt, idx_floor)
    idx_row, idx_class = idx_row.clone(), idx_class.clone()
    real = (rebuild_slots >= 0) & (rebuild_slots < s)
    at = rebuild_slots[real].to(torch.int64)
    idx_row[at] = crow[real]
    idx_class[at] = ccls[real]
    idx_floor[at] = cfloor[real]
    return idx_row, idx_class, idx_floor


def note_index_oversized() -> None:
    """Host stamp for an index-enabled wave whose dirty slice exceeded
    ``index_dirty_cap``: the in-step index update did not run."""
    _inc("deltasched_index_drops_total", label="oversized-dirty")


def note_index_wave(flag: int, attempted: bool, touched_index: int,
                    touched_plane: int) -> None:
    """Host stamp for one index-enabled delta wave: ``flag`` 1 = the
    candidates came from the index, 0 = the plane tail; an attempted wave
    that still ran the plane tail is an eviction-floor underflow."""
    if flag:
        _inc("deltasched_index_waves_total", label="index")
        _inc("deltasched_index_touched_rows_total", touched_index, label="index")
    else:
        _inc("deltasched_index_waves_total", label="plane")
        _inc("deltasched_index_touched_rows_total", touched_plane, label="plane")
        if attempted:
            _inc("deltasched_index_drops_total", label="underflow")


def attach_payload(table, cand: Candidates, row_offset: int = 0) -> Candidates:
    """Gather the candidate payload (free capacity at batch start,
    topology domains) from the live table at the top-K rows.  The table
    does not change within a wave, so this equals the full pass's
    per-chunk gather wherever the candidate is feasible (infeasible
    candidates' payload is never read)."""
    local = cand.idx - row_offset
    sub = gather_rows(table, local.reshape(-1))
    free_cpu, free_mem, free_pods = sub.free()
    shape = cand.idx.shape
    return dataclasses.replace(
        cand,
        cpu=free_cpu.reshape(shape), mem=free_mem.reshape(shape),
        pods=free_pods.reshape(shape),
        zone=sub.zone.to(torch.int32).reshape(shape),
        region=sub.region.to(torch.int32).reshape(shape),
    )


def fill_planes_scan(table, batch, profile: Profile, fill_slots, pmask, pscore, *,
                     chunk: int, groups=None):
    """Populate plane rows for a batch of shape representatives, IN PLACE:
    one chunked filter+score pass over the table, each chunk's columns
    written into the representatives' slots.  Representatives whose slot
    is the sentinel (>= S) are skipped."""
    s, n = pmask.shape
    if n % chunk:
        raise ValueError(f"plane rows {n} not divisible by chunk {chunk}")
    real = torch.nonzero((fill_slots >= 0) & (fill_slots < s)).flatten()
    slots = fill_slots[real].to(torch.int64)
    for c0 in range(0, n, chunk):
        mask, score = score_and_filter(_slice_table(table, c0, chunk), batch, profile,
                                       None, None, groups)
        pmask[slots, c0:c0 + chunk] = mask[real]
        pscore[slots, c0:c0 + chunk] = score[real]
    return pmask, pscore


# ---- host-side cache controller ---------------------------------------------


@dataclasses.dataclass
class WavePlan:
    """One wave's delta decision (``DeltaPlaneCache.plan``).

    ``fill_idx``/``fill_slots`` name the batch positions whose shapes must
    be plane-filled BEFORE the wave (promotions, stale refreshes).
    ``slot_ids`` is None for a full wave; otherwise the wave runs the
    delta step with ``dirty`` (sorted, sentinel-padded rows) and the
    stamps in ``stamp_slots`` applied at commit.  With an index,
    ``rep_idx`` names one batch position per used slot (sentinel = batch
    size) and ``rebuild_slots`` the slots the plane tail rebuilds."""

    fill_idx: list[int]
    fill_slots: list[int]
    slot_ids: np.ndarray | None = None
    dirty: np.ndarray | None = None
    stamp_slots: tuple[int, ...] = ()
    stamp_ver: int = 0
    rep_idx: np.ndarray | None = None
    rebuild_slots: np.ndarray | None = None


class DeltaPlaneCache:
    """Host controller of the device-resident per-shape plane cache.

    Owns the plane buffers (``bool[S, N]`` mask + ``i32[S, N]`` score on
    ``device``), the shape key -> slot map with LRU eviction, the per-slot
    freshness stamps and the row-version journal.  ``planes(gen)`` and
    ``index_state(gen)`` are the only read paths, checked against the
    vocab generation the planes were computed at.  ``sharding=`` (a
    ``parallel.Mesh``) splits the planes over its sp axis, [S, N/sp] per
    shard (the JAX ``PLANE_SPEC``); the candidate index is single-device
    and refused there."""

    def __init__(
        self,
        num_rows: int,
        *,
        slots: int = 64,
        fill_batch: int = 16,
        journal_cap: int | None = None,
        seen_cap: int = 1 << 16,
        dirty_cap: int | None = None,
        sharding=None,
        index_k: int = 0,
        stratum_bits: int = 0,
        index_dirty_cap: int | None = None,
        device: str | torch.device = "cuda",
    ) -> None:
        if index_k and sharding is not None:
            # Under a mesh the delta wave always runs the shard-local plane
            # tail; an index flag there would report waves that never ran.
            raise ValueError(
                "the candidate index does not compose with sharded "
                "planes; run index_k=0 under a mesh"
            )
        if sharding is not None:
            from k8s1m_tpu_torch.parallel.mesh import Mesh

            if not isinstance(sharding, Mesh):
                raise TypeError(f"sharding must be a parallel.Mesh, got {sharding!r}")
        self._sharding = sharding
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        if index_k < 0:
            raise ValueError(f"index_k must be >= 0, got {index_k}")
        self.device = resolve_device(device)
        self.num_rows = num_rows
        self.slots = slots
        self.fill_batch = fill_batch
        # stratum_bits must match every pack_hashed call of the system,
        # or the index's class algebra diverges from the real priorities.
        self.index_k = index_k
        self.stratum_bits = stratum_bits
        # Past this many combined dirty rows the wave skips the in-step
        # index update (a shape cut-off: the dirty vector is pow2-padded).
        self.index_dirty_cap = (
            index_dirty_cap if index_dirty_cap is not None else max(index_k, 1 << 12)
        )
        self._rebuild_rot = 0
        # Past this many dirty rows the plan refreshes the used slots
        # wholesale instead (a fill is one F-pod pass).
        self.dirty_cap = dirty_cap if dirty_cap is not None else max(num_rows // 4, 1)
        if journal_cap is None:
            # The journal bound tracks the table size (half the rows).
            journal_cap = max(1 << 16, num_rows // 2)
        self.versions = RowVersions(cap=journal_cap)
        self._mask = None           # bool[S, N]
        self._score = None          # i32[S, N]
        self._idx_row = None        # i32[S, K] candidate rows (ascending)
        self._idx_class = None      # i32[S, K] candidate class keys
        self._idx_floor = None      # i32[S] eviction floors
        self._slot_of: collections.OrderedDict = collections.OrderedDict()
        self._free: list[int] = list(range(slots - 1, -1, -1))
        self._fresh: dict[int, int] = {}     # slot -> version stamp
        self._gen = -1                       # vocab generation of the planes
        # Shapes seen once (a shape fills only on its SECOND sighting).
        self._seen: set = set()
        self._seen_cap = seen_cap
        _LIVE_CACHES.add(self)

    # -- device buffers ---------------------------------------------------

    def ensure_device(self) -> None:
        if self._mask is not None:
            return
        s, n, dev = self.slots, self.num_rows, self.device
        if self._sharding is not None:
            from k8s1m_tpu_torch.parallel.mesh import zeros_planes

            self._mask = zeros_planes(self._sharding, s, n, torch.bool)
            self._score = zeros_planes(self._sharding, s, n, torch.int32)
            return
        self._mask = torch.zeros((s, n), dtype=torch.bool, device=dev)
        self._score = torch.zeros((s, n), dtype=torch.int32, device=dev)
        if self.index_k:
            # Fresh index buffers fail closed: every floor starts unbuilt.
            self._idx_row = torch.full((s, self.index_k), n, dtype=torch.int32, device=dev)
            self._idx_class = torch.full((s, self.index_k), -1, dtype=torch.int32, device=dev)
            self._idx_floor = torch.full((s,), INDEX_FLOOR_UNBUILT, dtype=torch.int32,
                                         device=dev)

    def planes(self, gen: int):
        """THE epoch-checked plane accessor: the buffers only against the
        generation they were computed at."""
        if gen != self._gen:
            raise RuntimeError(
                f"delta plane access at generation {gen} but planes are "
                f"stamped {self._gen}; call check_generation first"
            )
        self.ensure_device()
        return self._mask, self._score

    def index_state(self, gen: int):
        """The candidate-index twin of ``planes``: (idx_row, idx_class,
        idx_floor), epoch-checked."""
        if not self.index_k:
            raise RuntimeError("index_state on a cache built with index_k=0")
        if gen != self._gen:
            raise RuntimeError(
                f"candidate-index access at generation {gen} but planes "
                f"are stamped {self._gen}; call check_generation first"
            )
        self.ensure_device()
        return self._idx_row, self._idx_class, self._idx_floor

    def commit(self, mask, score, plan: WavePlan | None = None, index=None) -> None:
        """Store the plane (and index) buffers back and apply the plan's
        freshness stamps, after the wave that updated them was issued."""
        self._mask, self._score = mask, score
        if index is not None:
            self._idx_row, self._idx_class, self._idx_floor = index
        if plan is not None:
            for s in plan.stamp_slots:
                self._fresh[s] = plan.stamp_ver

    # -- invalidation -----------------------------------------------------

    def note_rows(self, rows) -> None:
        """Journal one batch of device-table row mutations (when the
        mutating write is issued, so stream order makes later delta waves
        recompute from the new values)."""
        if self._slot_of or self._seen:
            self.versions.note(rows)

    def check_generation(self, gen: int) -> None:
        """Drop everything when the vocab generation moved."""
        if gen != self._gen:
            if self._slot_of:
                self.drop_all("generation")
            self._gen = gen

    def drop_all(self, reason: str) -> None:
        """Wholesale invalidation; the buffers stay allocated, only the
        host keying drops, so the next fills overwrite."""
        if self._slot_of:
            log.info("deltasched: dropping %d cached shape planes (%s)",
                     len(self._slot_of), reason)
        self._free = list(range(self.slots - 1, -1, -1))
        self._slot_of.clear()
        self._fresh.clear()
        self._seen.clear()
        if self.index_k:
            _inc("deltasched_index_drops_total", label=reason)
        self.versions.release(self.versions.ver + 1)

    def reset(self, reason: str) -> None:
        """drop_all PLUS discard the buffers (reallocated as zeros)."""
        self.drop_all(reason)
        self._mask = self._score = None
        self._idx_row = self._idx_class = self._idx_floor = None

    # -- wave planning ----------------------------------------------------

    def _note_seen(self, key) -> None:
        if len(self._seen) >= self._seen_cap:
            self._seen.clear()
        self._seen.add(key)

    def _alloc_slot(self, key, busy) -> int | None:
        """A slot for ``key``: a free one, else LRU-evict — never a slot in
        ``busy`` (assigned to a pod of the current wave).  None when every
        resident slot is busy (the wave takes the full pass)."""
        if self._free:
            slot = self._free.pop()
        else:
            victim = next(((k, s) for k, s in self._slot_of.items() if s not in busy), None)
            if victim is None:
                return None
            del self._slot_of[victim[0]]
            slot = victim[1]
            self._fresh.pop(slot, None)
            _inc("deltasched_evictions_total")
        self._slot_of[key] = slot
        return slot

    def plan(self, keys, batch_b: int) -> WavePlan:
        """Decide this wave's path from the pods' shape keys (one per real
        pod, None = uncacheable); ``batch_b`` is the encoded batch size."""
        fills_idx: list[int] = []
        fills_slot: list[int] = []
        if any(k is None for k in keys):
            _inc("deltasched_shape_misses_total", len(keys))
            _inc("deltasched_waves_total", label="full")
            return WavePlan([], [])
        slot_ids = np.full(batch_b, self.slots, np.int32)
        hits = misses = 0
        missing = False
        filled_keys: dict = {}
        busy: set[int] = set()
        for i, key in enumerate(keys):
            slot = self._slot_of.get(key)
            if slot is not None:
                self._slot_of.move_to_end(key)
                slot_ids[i] = slot
                busy.add(slot)
                hits += 1
                continue
            misses += 1
            prior = filled_keys.get(key)
            if prior is not None:
                slot_ids[i] = prior
                continue
            if key in self._seen and len(fills_idx) < self.fill_batch:
                slot = self._alloc_slot(key, busy)
                if slot is None:
                    missing = True
                    continue
                fills_idx.append(i)
                fills_slot.append(slot)
                filled_keys[key] = slot
                slot_ids[i] = slot
                busy.add(slot)
            else:
                self._note_seen(key)
                missing = True
        _inc("deltasched_shape_hits_total", hits)
        if misses:
            _inc("deltasched_shape_misses_total", misses)
        if missing:
            _inc("deltasched_waves_total", label="full")
            return WavePlan(fills_idx, fills_slot)

        # Dirty slice: rows mutated since the stalest used slot's fill.
        used = sorted({int(s) for s in slot_ids if s < self.slots})
        fresh_fills = set(fills_slot)
        stale = [s for s in used if s not in fresh_fills
                 and self._fresh.get(s, -1) < self.versions.floor]
        dirty: set[int] | None = set()
        live = [s for s in used if s not in fresh_fills and s not in stale]
        if live:
            vmin = min(self._fresh[s] for s in live)
            dirty = self.versions.rows_since(vmin)
        if dirty is None or len(dirty) > self.dirty_cap or stale:
            # Unenumerable or oversized delta: refresh every used slot
            # wholesale and run delta over the in-flight rows alone.
            refresh = [s for s in used if s not in fresh_fills]
            if len(fills_idx) + len(refresh) > self.fill_batch:
                _inc("deltasched_waves_total", label="full")
                return WavePlan(fills_idx, fills_slot)
            slot_at = {int(s): i for i, s in enumerate(slot_ids) if s < self.slots}
            for s in refresh:
                fills_idx.append(slot_at[s])
                fills_slot.append(s)
            dirty = set()
        _inc("deltasched_waves_total", label="delta")
        _inc("deltasched_dirty_rows_total", len(dirty))
        rep_idx = rebuild = None
        if self.index_k:
            rep_idx = np.full(self.slots, batch_b, np.int32)
            for i, s in enumerate(slot_ids.tolist()):
                if s < self.slots and rep_idx[s] == batch_b:
                    rep_idx[s] = i
            # Rebuild list: fresh fills first, then the other used slots
            # rotated so more than fill_batch slots converge over waves.
            others = [s for s in used if s not in fresh_fills]
            if others:
                r = self._rebuild_rot % len(others)
                self._rebuild_rot += 1
                others = others[r:] + others[:r]
            order = list(fills_slot) + others
            rebuild = np.full(self.fill_batch, self.slots, np.int32)
            take = order[: self.fill_batch]
            rebuild[: len(take)] = take
        return WavePlan(
            fills_idx, fills_slot,
            slot_ids=slot_ids,
            dirty=self._pad_dirty(dirty),
            stamp_slots=tuple(used),
            stamp_ver=self.versions.ver,
            rep_idx=rep_idx,
            rebuild_slots=rebuild,
        )

    def _pad_dirty(self, rows: set) -> np.ndarray:
        """Sorted, power-of-two-padded dirty rows, padded with the
        sentinel (= num_rows)."""
        arr = np.fromiter(rows, np.int32, len(rows))
        arr.sort()
        cap = 1 << max(0, int(max(arr.size, 1) - 1).bit_length())
        out = np.full(cap, self.num_rows, np.int32)
        out[: arr.size] = arr
        return out

    def note_fill(self, plan: WavePlan) -> None:
        """Stamp freshly filled slots at the journal version their fill
        observed (right after the fill is issued)."""
        _inc("deltasched_fills_total", len(plan.fill_slots))
        if self.index_k and plan.fill_slots:
            # A refilled slot's plane is new, its index is not: fail it
            # closed so the first wave that uses it rebuilds.
            self.ensure_device()
            at = torch.as_tensor(plan.fill_slots, dtype=torch.int64, device=self.device)
            self._idx_floor[at] = INDEX_FLOOR_UNBUILT
            _inc("deltasched_index_drops_total", len(plan.fill_slots), label="fill")
        for s in plan.fill_slots:
            self._fresh[s] = self.versions.ver

    def abort_fills(self, plan: WavePlan) -> None:
        """Un-allocate the plan's fill slots (the representative encode
        failed): the keys drop back to seen-once, the wave goes full."""
        for s in plan.fill_slots:
            self._fresh.pop(s, None)
            self._free.append(s)
        dropped = set(plan.fill_slots)
        for key, slot in list(self._slot_of.items()):
            if slot in dropped:
                del self._slot_of[key]
        plan.fill_idx.clear()
        plan.fill_slots.clear()

    @property
    def resident(self) -> int:
        return len(self._slot_of)
