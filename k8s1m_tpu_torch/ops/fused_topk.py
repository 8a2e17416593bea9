"""Fused filter + score + hashed priority + top-K over the node table.

Port of ``k8s1m_tpu/ops/pallas_topk.py`` (``fused_topk`` /
``pallas_candidates``), all three stages of its kernel ``_kernel``:

- base: row validity, NodeResourcesFit, NodeName, TaintToleration (hard
  filter + soft score), LeastAllocated and BalancedAllocation;
- ``with_affinity``: NodeAffinity — nodeSelector, required terms, the
  weighted preferred-term score;
- ``constraints``/``stats``: PodTopologySpread and InterPodAffinity from
  the count tables (``snapshot/constraints.py``) and the prologue stats
  (``plugins/topology.py``);

then ``clip(score, 0, 2047) << 20 | hash_jitter`` and each pod's top K by
(priority descending, earlier row first), for both table layouts.

- ``fused_topk`` is the wrapper.  On CUDA tensors it launches the
  hand-written kernel ``csrc/fused_topk.cuh`` and counts the launch in
  ``fused_topk.launches`` and ``fused_topk.launches_by_stage[stage]``
  (stage ``base``, ``aff``, ``cons`` or ``aff+cons``); on CPU tensors it
  runs the plain version.  There is no other path: anything the kernel
  does not take raises.
- ``fused_topk_reference`` is the plain PyTorch version: the same math in
  the Pallas kernel's f32 order, chunked over the node axis with a
  running merge so it also runs at 1M rows on the card, ranking by a
  composite int64 key (priority, -row) because ``torch.topk`` promises no
  tie order.
- ``candidates`` is the counterpart of ``pallas_candidates``: the top K
  plus the free-capacity/topology payload gathered at the candidate rows.
- ``group_key`` / ``group_order`` are what the kernel's pod groups rest
  on: one i32 key row per pod holding exactly the per-pod inputs the
  launched stages read, and the pods sorted by a hash of it.  The kernel
  compares key rows exactly, so the hash only decides how pods line up.
"""

from __future__ import annotations

import ctypes
import functools
import operator

import numpy as np
import torch

from k8s1m_tpu_torch.config import (
    EFFECT_NO_EXECUTE,
    EFFECT_NO_SCHEDULE,
    EFFECT_PREFER_NO_SCHEDULE,
    NONE_ID,
    SPREAD_DO_NOT_SCHEDULE,
)
from k8s1m_tpu_torch.ops import _build
from k8s1m_tpu_torch.ops.label_match import resolve_query_keys
from k8s1m_tpu_torch.ops.priority import JITTER_BITS, pack_hashed
from k8s1m_tpu_torch.plugins import topology
from k8s1m_tpu_torch.plugins.filters import node_affinity
from k8s1m_tpu_torch.plugins.registry import Profile
from k8s1m_tpu_torch.plugins.scores import node_affinity_score
from k8s1m_tpu_torch.snapshot.constraints import NODE_FIELDS, slice_constraints
from k8s1m_tpu_torch.snapshot.packing import DomainView, is_packed

MAX_K = 128            # the Pallas running list is 128 wide
POD_TILE = 128         # pods per CUDA block
_M32 = 0xFFFFFFFF

STAGES = ("base", "aff", "cons", "aff+cons")

# Kernel arguments, in the order of csrc/fused_topk.cu's Ptr and Int enums.
_PTRS = (
    "cpu_alloc", "mem_alloc", "pods_alloc", "cpu_req", "mem_req", "pods_req", "name_id",
    "taint_id", "taint_eff", "meta",
    "p_cpu", "p_mem", "p_valid", "p_nnid", "tolerated",
    "part_idx", "part_prio", "out_idx", "out_prio",
    "label_key", "label_val", "label_num", "qkey",
    "sel_valid", "sel_qidx", "sel_val",
    "req_tv", "req_ev", "req_qidx", "req_op", "req_num", "req_vals",
    "pref_tv", "pref_w", "pref_ev", "pref_qidx", "pref_op", "pref_num", "pref_vals",
    "zone", "region", "spread_node", "tgt_node", "own_node",
    "spread_zone", "spread_region", "tgt_zone", "tgt_region", "own_zone", "own_region",
    "sp", "ia", "ii", "cs",
    "gkey", "order",
)
_INTS = (
    "packed", "n", "ts", "taint_bytes", "b", "m", "seed", "row_base", "col_base", "stratum_bits",
    "w_la", "w_ba", "w_tt", "k", "splits",
    "with_aff", "l", "fused", "key_bits", "q", "s", "t", "e", "v", "p", "w_na",
    "with_cons", "zone_bytes", "region_bytes", "ld", "ss", "as", "zd", "rd", "sr", "ar", "ai",
    "w_ts", "w_ipa",
    "kw",
)


def supports(profile: Profile) -> bool:
    """True if the kernel computes this profile without constraint state
    (constraint plugins need ``constraints=`` and ``stats=``)."""
    return profile.topology_spread == 0 and profile.interpod_affinity == 0


def stage_of(with_affinity: bool, with_cons: bool) -> str:
    return STAGES[int(bool(with_affinity)) + 2 * int(bool(with_cons))]


def _check_common(profile: Profile, k: int, stratum_bits: int, constraints, stats) -> None:
    if constraints is not None and stats is None:
        raise ValueError("constraints require stats=topology.prologue(table, constraints)")
    if constraints is None and not supports(profile):
        raise ValueError(
            "profile has constraint plugins enabled; pass constraints= "
            f"and stats= to run them fused (got {profile})"
        )
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k must be in [1, {MAX_K}], got {k}")
    if not 0 <= stratum_bits <= JITTER_BITS:
        raise ValueError(f"stratum_bits must be in [0, {JITTER_BITS}], got {stratum_bits}")


def fused_topk(table, batch, seed, profile: Profile, *, k: int,
               row_base: int = 0, col_base: int = 0, stratum_bits: int = 0,
               with_affinity: bool = False, constraints=None, stats=None):
    """(idx i32[B, K], prio i32[B, K]) — view-local rows, -1 = none.

    ``seed`` is the wave's i32 seed (a Python int; negative values enter
    as their uint32 pattern).  ``row_base``/``col_base`` bias the hash's
    pod/node coordinates, as in the JAX wrapper.  ``table`` may be a
    ``narrow()`` window of a larger table: the kernel takes base pointers
    and a row count, so a window costs no copy.

    ``with_affinity`` runs the NodeAffinity stage (the JAX wrapper's
    default is True; here the caller says so, as the wave does from the
    batch's field groups).  ``constraints`` (a ConstraintState whose node
    tables cover the same rows as ``table``, e.g. ``slice_constraints``
    of the full state) with ``stats`` (``topology.prologue`` of the FULL
    table) runs the constraint stage.
    """
    _check_common(profile, k, stratum_bits, constraints, stats)
    seed = operator.index(seed)
    kw = dict(k=k, row_base=row_base, col_base=col_base, stratum_bits=stratum_bits,
              with_affinity=with_affinity, constraints=constraints, stats=stats)
    dev = table.cpu_req.device
    if dev.type == "cpu":
        return fused_topk_reference(table, batch, seed, profile, **kw)
    if dev.type != "cuda":
        raise ValueError(f"fused_topk runs on cuda or cpu tensors, got {dev}")
    return _launch(table, batch, seed, profile, **kw)


fused_topk.launches = 0
fused_topk.launches_by_stage = dict.fromkeys(STAGES, 0)


def reset_launches() -> None:
    """Set every launch count of ``fused_topk`` to 0."""
    fused_topk.launches = 0
    fused_topk.launches_by_stage = dict.fromkeys(STAGES, 0)


def _require(t: torch.Tensor, name: str, dtype, dev, shape, *, contiguous: bool = True) -> None:
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, table on {dev}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _cons_pod_inputs(batch, stats) -> dict:
    """The per-pod inputs of the constraint stage, built exactly as the
    JAX wrapper builds them (pallas_topk.py:904-939), laid out for the
    kernel as i32[fields, refs, B] records (pod index fastest)."""
    i32 = torch.int32
    sp_min = topology._stat_for(stats.spread_min, batch.spread_cid, batch.spread_topo)
    sp_max = topology._stat_for(stats.spread_max, batch.spread_cid, batch.spread_topo)
    sp_hard = batch.spread_valid & (batch.spread_mode == SPREAD_DO_NOT_SCHEDULE)
    total = topology.take_fill(stats.tgt_total, batch.ipa_tid)
    boot = (total == 0) & batch.ipa_self
    reqaff = batch.ipa_valid & batch.ipa_required & ~batch.ipa_anti
    reqanti = batch.ipa_valid & batch.ipa_required & batch.ipa_anti
    pref = batch.ipa_valid & ~batch.ipa_required
    sign = torch.where(batch.ipa_anti, -1, 1).to(i32) * batch.ipa_weight
    prefsign = torch.where(pref, sign, torch.zeros_like(sign))
    bound = (
        torch.abs(batch.ipa_weight) * topology.take_fill(stats.tgt_max, batch.ipa_tid)
        * pref.to(i32)
    ).sum(dim=1, dtype=i32)

    def records(*fields):    # each [B, R] -> i32[F, R, B]
        return torch.stack([f.to(i32) for f in fields]).transpose(1, 2).contiguous()

    return {
        "sp": records(batch.spread_cid, batch.spread_topo, batch.spread_max_skew, sp_hard,
                      batch.spread_valid, batch.spread_self, sp_min, sp_max),
        "ia": records(batch.ipa_tid, batch.ipa_topo, reqaff, reqanti, boot, prefsign),
        "ii": records(batch.iinc_tid, batch.iinc_topo, batch.iinc_valid),
        "cs": torch.stack([
            torch.clamp(bound, min=1),
            pref.any(dim=1).to(i32),
            torch.clamp(batch.spread_valid.sum(dim=1, dtype=i32), min=1),
        ]).contiguous(),
    }


_AFF_FIELDS = (
    "sel_valid", "sel_qidx", "sel_val", "req_term_valid", "req_expr_valid", "req_qidx",
    "req_op", "req_num", "req_vals", "pref_term_valid", "pref_weight", "pref_expr_valid",
    "pref_qidx", "pref_op", "pref_num", "pref_vals",
)


def group_key(batch, *, with_affinity: bool = False, cons_inputs=None) -> torch.Tensor:
    """i32[B, W]: per pod, exactly the per-pod inputs the kernel reads for
    the launched stages — valid, cpu, mem, nodeName id and the tolerated
    row (as bytes, four to a word); with affinity every ``sel_*``/``req_*``/
    ``pref_*`` field; with constraints the ``sp``/``ia``/``ii`` record
    columns and ``cs`` (``cons_inputs``, laid out as ``_cons_pod_inputs``
    gives them).  Pods with equal rows get equal results up to their own
    row hash."""
    i32 = torch.int32
    b = batch.batch
    tol = batch.tolerated.view(torch.uint8)
    if tol.shape[1] % 4:
        tol = torch.nn.functional.pad(tol, (0, 4 - tol.shape[1] % 4))
    parts = [
        torch.stack([batch.valid.to(i32), batch.cpu, batch.mem, batch.node_name_id], dim=1),
        tol.contiguous().view(i32),
    ]
    if with_affinity:
        parts += [getattr(batch, f).reshape(b, -1).to(i32) for f in _AFF_FIELDS]
    if cons_inputs is not None:
        parts += [cons_inputs[f].permute(2, 0, 1).reshape(b, -1) for f in ("sp", "ia", "ii")]
        parts.append(cons_inputs["cs"].t())
    return torch.cat(parts, dim=1).contiguous()


@functools.lru_cache(maxsize=32)
def _hash_weights(width: int, device: torch.device) -> torch.Tensor:
    # Below 2^20 for rows of up to 2^11 words, and below 2^(31 -
    # ceil(log2 width)) for wider ones, so the int64 sum of `width` words
    # of |x| < 2^31 never wraps; fixed, so the order is a function of the
    # batch alone.
    bits = min(20, 31 - max(0, (width - 1).bit_length()))
    w = np.random.default_rng(width).integers(1, 1 << max(bits, 1), width)
    return torch.from_numpy(w).to(device)


def group_order(key: torch.Tensor) -> torch.Tensor:
    """i32[B]: the pods sorted (stably) by a hash of their key rows, so
    pods with equal rows sit next to each other — unless another row
    collides with their hash, which only splits their group."""
    h = (key.to(torch.int64) * _hash_weights(key.shape[1], key.device)).sum(dim=1)
    return torch.argsort(h, stable=True).to(torch.int32)


def splits_for(b: int, n: int, sms: int, per_sm: int) -> int:
    """Node splits per pod tile: one wave of ``per_sm`` resident blocks on
    each of ``sms`` SMs (a second, partial wave would run on a few SMs
    alone), no split shorter than one 128-row tile."""
    pod_tiles = -(-b // POD_TILE)
    return max(1, min(per_sm * sms // pod_tiles, -(-n // POD_TILE)))


def _launch(table, batch, seed, profile, **kw):
    run, out = prepare_launch(table, batch, seed, profile, **kw)
    run()
    return out


def prepare_launch(table, batch, seed, profile, *, k, row_base=0, col_base=0,
                   stratum_bits=0, with_affinity=False, constraints=None, stats=None):
    """``(run, (idx, prio))``: the checks, the group key and order and the
    argument arrays of one launch on CUDA tensors, built once; each
    ``run()`` launches the kernel and the split merge into ``idx``/``prio``
    and counts the launch.  ``fused_topk`` is prepare-and-run; calling
    ``run`` again times the device work without the preparation."""
    _check_common(profile, k, stratum_bits, constraints, stats)
    seed = operator.index(seed)
    dev = table.cpu_req.device
    packed = is_packed(table)
    n = table.num_rows
    ts = table.taint_id.shape[1]
    b = batch.batch
    m = batch.tolerated.shape[1]
    # Any number of taint slots and taint ids (the kernel reads the slots
    # and tolerated bytes it does not stage from global memory).
    if ts < 1:
        raise ValueError(f"taint slots must be >= 1, got {ts}")
    if m < 1:
        raise ValueError(f"max_taint_ids must be >= 1, got {m}")
    i32, i16, u8 = torch.int32, torch.int16, torch.bool
    narrow_t = i16 if packed else i32
    for name in ("cpu_alloc", "mem_alloc", "cpu_req", "mem_req", "pods_req", "name_id"):
        _require(getattr(table, name), name, i32, dev, (n,))
    _require(table.pods_alloc, "pods_alloc", narrow_t, dev, (n,))
    # Packed taint ids are i16, or i32 past 2^15 ids (snapshot/packing.py).
    taint_t = i32 if packed and table.taint_id.dtype == i32 else narrow_t
    _require(table.taint_id, "taint_id", taint_t, dev, (n, ts))
    ptrs = {
        "cpu_alloc": table.cpu_alloc, "mem_alloc": table.mem_alloc,
        "pods_alloc": table.pods_alloc, "cpu_req": table.cpu_req, "mem_req": table.mem_req,
        "pods_req": table.pods_req, "name_id": table.name_id, "taint_id": table.taint_id,
    }
    if packed:
        if table.spec.taint_slots != ts:
            raise ValueError("packing spec taint_slots disagrees with taint_id")
        _require(table.meta, "meta", i32, dev, (n,))
        ptrs["meta"] = table.meta
    else:
        _require(table.taint_effect, "taint_effect", i32, dev, (n, ts))
        ptrs["taint_eff"] = table.taint_effect
    for name in ("cpu", "mem", "node_name_id"):
        _require(getattr(batch, name), name, i32, dev, (b,))
    _require(batch.valid, "valid", u8, dev, (b,))
    _require(batch.tolerated, "tolerated", u8, dev, (b, m))
    ptrs.update(p_cpu=batch.cpu, p_mem=batch.mem, p_valid=batch.valid,
                p_nnid=batch.node_name_id, tolerated=batch.tolerated)
    ints = dict(
        packed=int(packed), n=n, ts=ts, taint_bytes=table.taint_id.element_size(), b=b, m=m,
        seed=seed & _M32,
        row_base=int(row_base), col_base=int(col_base), stratum_bits=stratum_bits,
        w_la=profile.least_allocated, w_ba=profile.balanced_allocation,
        w_tt=profile.taint_toleration, k=k,
    )
    if with_affinity:
        ptrs_aff, ints_aff = _affinity_args(table, batch, dev, packed)
        ptrs.update(ptrs_aff)
        ints.update(ints_aff, with_aff=1, w_na=profile.node_affinity)
    if constraints is not None:
        ptrs_cons, ints_cons = _constraint_args(table, batch, constraints, stats, dev, packed)
        ptrs.update(ptrs_cons)
        ints.update(ints_cons, with_cons=1, w_ts=profile.topology_spread,
                    w_ipa=profile.interpod_affinity)

    gkey = group_key(batch, with_affinity=with_affinity,
                     cons_inputs=ptrs if constraints is not None else None)
    ptrs["gkey"] = gkey
    ptrs["order"] = group_order(gkey)
    ints["kw"] = gkey.shape[1]
    stage = stage_of(with_affinity, constraints is not None)
    splits = splits_for(b, n, torch.cuda.get_device_properties(dev).multi_processor_count,
                        _resident_blocks(stage, packed, k, dev))
    ints["splits"] = splits
    ptrs["part_idx"] = torch.empty((splits, b, k), dtype=i32, device=dev)
    ptrs["part_prio"] = torch.empty((splits, b, k), dtype=i32, device=dev)
    out_idx = ptrs["out_idx"] = torch.empty((b, k), dtype=i32, device=dev)
    out_prio = ptrs["out_prio"] = torch.empty((b, k), dtype=i32, device=dev)

    p_arr = (ctypes.c_longlong * len(_PTRS))(*(
        ptrs[name].data_ptr() if name in ptrs else 0 for name in _PTRS
    ))
    i_arr = (ctypes.c_longlong * len(_INTS))(*(int(ints.get(name, 0)) for name in _INTS))
    fn = _kernel_entry()

    def run(_tensors=ptrs):            # holds the tensors the pointers point into
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = fn(p_arr, len(_PTRS), i_arr, len(_INTS), ctypes.c_void_p(stream))
        if err != 0:
            raise RuntimeError(f"fused_topk kernel launch failed: cudaError {err}")
        fused_topk.launches += 1
        fused_topk.launches_by_stage[stage] += 1

    return run, (out_idx, out_prio)


def _affinity_args(table, batch, dev, packed):
    i32, u8 = torch.int32, torch.bool
    n, b = table.num_rows, batch.batch
    lk = table.label_key
    slots = lk.shape[1]
    fused = bool(packed and table.spec.fuse_labels)
    _require(lk, "label_key", i32, dev, (n, slots))
    _require(table.label_num, "label_num", i32, dev, (n, slots))
    ptrs = {"label_key": lk, "label_num": table.label_num}
    if not fused:
        _require(table.label_val, "label_val", i32, dev, (n, slots))
        ptrs["label_val"] = table.label_val
    q = batch.qkey.shape[0]
    s = batch.sel_valid.shape[1]
    t, e = batch.req_expr_valid.shape[1:]
    v = batch.req_vals.shape[3]
    p = batch.pref_term_valid.shape[1]
    # Any Q, V and P, as the Pallas kernel (csrc/fused_topk.cuh resolves
    # keys past its shared table, values past its registers and preferred
    # terms past its masks from global memory).
    _require(batch.qkey, "qkey", i32, dev, (q,))
    for name, dtype, shape in (
        ("sel_valid", u8, (b, s)), ("sel_qidx", i32, (b, s)), ("sel_val", i32, (b, s)),
        ("req_term_valid", u8, (b, t)), ("req_expr_valid", u8, (b, t, e)),
        ("req_qidx", i32, (b, t, e)), ("req_op", i32, (b, t, e)),
        ("req_num", i32, (b, t, e)), ("req_vals", i32, (b, t, e, v)),
        ("pref_term_valid", u8, (b, p)), ("pref_weight", i32, (b, p)),
        ("pref_expr_valid", u8, (b, p, e)), ("pref_qidx", i32, (b, p, e)),
        ("pref_op", i32, (b, p, e)), ("pref_num", i32, (b, p, e)),
        ("pref_vals", i32, (b, p, e, v)),
    ):
        _require(getattr(batch, name), name, dtype, dev, shape)
    ptrs.update(
        qkey=batch.qkey, sel_valid=batch.sel_valid, sel_qidx=batch.sel_qidx,
        sel_val=batch.sel_val, req_tv=batch.req_term_valid, req_ev=batch.req_expr_valid,
        req_qidx=batch.req_qidx, req_op=batch.req_op, req_num=batch.req_num,
        req_vals=batch.req_vals, pref_tv=batch.pref_term_valid, pref_w=batch.pref_weight,
        pref_ev=batch.pref_expr_valid, pref_qidx=batch.pref_qidx, pref_op=batch.pref_op,
        pref_num=batch.pref_num, pref_vals=batch.pref_vals,
    )
    ints = dict(l=slots, fused=int(fused), key_bits=table.spec.key_bits if fused else 1,
                q=q, s=s, t=t, e=e, v=v, p=p)
    return ptrs, ints


def _constraint_args(table, batch, cons, stats, dev, packed):
    i32 = torch.int32
    n = table.num_rows
    ok_dtypes = (torch.int8, torch.int16, torch.int32)
    for name in ("zone", "region"):
        col = getattr(table, name)
        if col.dtype not in ok_dtypes or (not packed and col.dtype != i32):
            raise ValueError(f"{name} must be int32 (packed: int8/16/32), got {col.dtype}")
        _require(col, name, col.dtype, dev, (n,))
    ss, zd = cons.spread_zone.shape
    a_s = cons.tgt_zone.shape[0]
    rd = cons.spread_region.shape[1]
    # The node tables are column views of the full tables: unit column
    # stride, one shared row stride (the full table width), no copy.
    ld = cons.spread_node.stride(0)
    for name in NODE_FIELDS:
        tab = getattr(cons, name)
        slots = ss if name == "spread_node" else a_s
        _require(tab, name, i32, dev, (slots, n), contiguous=False)
        if tab.stride(1) != 1 or (slots > 1 and tab.stride(0) != ld) or ld < n:
            raise ValueError(
                f"{name} must be a column view with unit column stride and row "
                f"stride {ld} >= {n}, got strides {tab.stride()}"
            )
    for name, slots, width in (
        ("spread_zone", ss, zd), ("spread_region", ss, rd), ("tgt_zone", a_s, zd),
        ("tgt_region", a_s, rd), ("own_zone", a_s, zd), ("own_region", a_s, rd),
    ):
        _require(getattr(cons, name), name, i32, dev, (slots, width))
    pod = _cons_pod_inputs(batch, stats)
    ptrs = {
        "zone": table.zone, "region": table.region,
        **{f: getattr(cons, f) for f in (
            "spread_node", "tgt_node", "own_node", "spread_zone", "spread_region",
            "tgt_zone", "tgt_region", "own_zone", "own_region")},
        **pod,
    }
    ints = dict(
        zone_bytes=table.zone.element_size(), region_bytes=table.region.element_size(),
        ld=ld, ss=ss, **{"as": a_s}, zd=zd, rd=rd,
        sr=pod["sp"].shape[1], ar=pod["ia"].shape[1], ai=pod["ii"].shape[1],
    )
    return ptrs, ints


def blocks_per_sm(stage: str, *, packed: bool, k: int) -> int:
    """Resident blocks per SM of the kernel instantiation a launch of
    ``stage`` (one of STAGES) on this layout with this ``k`` uses (CUDA's
    occupancy calculator; needs the card)."""
    fn = _build.load("fused_topk").k8s_fused_blocks_per_sm
    fn.argtypes = (ctypes.c_int,) * 4
    fn.restype = ctypes.c_int
    n = fn(int("aff" in stage), int("cons" in stage), int(packed), k)
    if n < 0:
        raise RuntimeError(f"occupancy query failed: cudaError {-n}")
    return n


@functools.lru_cache(maxsize=64)
def _resident_blocks(stage: str, packed: bool, k: int, device: torch.device) -> int:
    with torch.cuda.device(device):
        return blocks_per_sm(stage, packed=packed, k=k)


def _kernel_entry():
    lib = _build.load("fused_topk")
    fn = lib.k8s_fused_topk
    if fn.argtypes is None:
        arr = ctypes.POINTER(ctypes.c_longlong)
        fn.argtypes = (arr, ctypes.c_int, arr, ctypes.c_int, ctypes.c_void_p)
        fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=16)
def _f32_scalar(value: float, device: torch.device) -> torch.Tensor:
    # A device tensor, not a Python scalar: PyTorch may turn division by a
    # CPU scalar into multiplication by its reciprocal, which is not IEEE
    # division for a divisor that is not a power of two.
    return torch.tensor(value, dtype=torch.float32, device=device)


def mask_and_score(table, batch, profile: Profile, c0: int, c1: int, *,
                   with_affinity: bool = False, constraints=None, stats=None):
    """(feasible bool[B, C], score i32[B, C]) of every pod at rows
    [c0, c1) of ``table``: the plain version's filters and f32 scores in
    the Pallas kernel's order, before the hash."""
    packed = is_packed(table)
    dev = table.cpu_req.device
    m = batch.tolerated.shape[1]
    ts = table.taint_id.shape[1]
    i32, i64, f32 = torch.int32, torch.int64, torch.float32
    p_cpu = batch.cpu[:, None]
    p_mem = batch.mem[:, None]
    p_nnid = batch.node_name_id[:, None]
    cpu_alloc = table.cpu_alloc[c0:c1]
    mem_alloc = table.mem_alloc[c0:c1]
    cpu_req = table.cpu_req[c0:c1]
    mem_req = table.mem_req[c0:c1]
    pods_free = table.pods_alloc[c0:c1].to(i32) - table.pods_req[c0:c1]
    tid = table.taint_id[c0:c1].to(i64)                        # [C, TS]
    if packed:
        meta = table.meta[c0:c1]
        teff = torch.stack(
            [(meta >> (1 + 2 * t)) & 3 for t in range(ts)], dim=1
        )
        row_ok = (pods_free >= 1) & ((meta & 1) != 0)
    else:
        teff = table.taint_effect[c0:c1]
        row_ok = pods_free >= 1

    fits = (
        (p_cpu <= (cpu_alloc - cpu_req)[None])
        & (p_mem <= (mem_alloc - mem_req)[None])
        & row_ok[None]
    )
    nn_ok = (p_nnid == NONE_ID) | (p_nnid == table.name_id[c0:c1][None])
    # Taint slots count where the id is live and inside [0, M): the
    # Pallas one-hot gather counts nothing for an id outside it.
    counted = (tid != NONE_ID) & (tid >= 0) & (tid < m)
    hard = counted & ((teff == EFFECT_NO_SCHEDULE) | (teff == EFFECT_NO_EXECUTE))
    soft = counted & (teff == EFFECT_PREFER_NO_SCHEDULE)
    untol = ~batch.tolerated[:, tid.clamp(0, m - 1)]             # [B, C, TS]
    hard_cnt = (untol & hard[None]).sum(-1)
    soft_cnt = (untol & soft[None]).sum(-1)
    mask = fits & nn_ok & (hard_cnt == 0) & batch.valid[:, None]

    score = torch.zeros(mask.shape, dtype=i32, device=dev)
    cpu_after = (cpu_req[None] + p_cpu).to(f32)                # [B, C]
    mem_after = (mem_req[None] + p_mem).to(f32)
    alloc_cpu = cpu_alloc.clamp(min=1).to(f32)[None]           # [1, C]
    alloc_mem = mem_alloc.clamp(min=1).to(f32)[None]
    if profile.least_allocated:
        la = 50.0 * (
            ((alloc_cpu - cpu_after) / alloc_cpu).clamp(min=0.0)
            + ((alloc_mem - mem_after) / alloc_mem).clamp(min=0.0)
        )
        score += torch.floor(la).to(i32) * profile.least_allocated
    if profile.balanced_allocation:
        f_cpu = (cpu_after / alloc_cpu).clamp(0.0, 1.0)
        f_mem = (mem_after / alloc_mem).clamp(0.0, 1.0)
        ba = 100.0 * (1.0 - torch.abs(f_cpu - f_mem) / 2.0)
        score += torch.floor(ba).to(i32) * profile.balanced_allocation
    if profile.taint_toleration:
        tt = 100.0 * (1.0 - soft_cnt.to(f32) / _f32_scalar(float(ts), dev))
        score += torch.floor(tt).to(i32) * profile.taint_toleration

    if with_affinity:
        lk = table.label_key[c0:c1]
        if packed and table.spec.fuse_labels:
            lv = lk >> table.spec.key_bits
            lk = lk & ((1 << table.spec.key_bits) - 1)
        else:
            lv = table.label_val[c0:c1]
        resolved = resolve_query_keys(lk, lv, table.label_num[c0:c1], batch.qkey)
        mask &= node_affinity(batch, resolved)
        if profile.node_affinity:
            na = node_affinity_score(batch, resolved)
            score += torch.floor(na).to(i32) * profile.node_affinity
    if constraints is not None:
        dom = DomainView(
            valid=row_ok, zone=table.zone[c0:c1].to(i32), region=table.region[c0:c1].to(i32)
        )
        cmask, cscore = topology.filter_and_score(
            dom, batch, slice_constraints(constraints, c0, c1 - c0), stats,
            profile.topology_spread, profile.interpod_affinity,
        )
        mask &= cmask
        score += cscore

    return mask, score


def fused_topk_reference(table, batch, seed, profile: Profile, *, k: int,
                         row_base: int = 0, col_base: int = 0,
                         stratum_bits: int = 0, with_affinity: bool = False,
                         constraints=None, stats=None, chunk: int = 4096):
    """The plain PyTorch version of the kernel, on the tensors' device.

    Same filters, f32 scores, hash and tie rule; the node axis runs in
    ``chunk``-row pieces with a running top-K merge (the result does not
    depend on ``chunk``).  The affinity stage is ``plugins.filters.
    node_affinity`` and ``plugins.scores.node_affinity_score``, the
    constraint stage ``plugins.topology.filter_and_score`` on the chunk's
    columns of ``constraints``."""
    _check_common(profile, k, stratum_bits, constraints, stats)
    seed = operator.index(seed)
    n = table.num_rows
    b = batch.batch
    dev = table.cpu_req.device
    i32, i64 = torch.int32, torch.int64
    chunk = max(1, min(chunk, n))
    pod_rows = torch.arange(b, device=dev, dtype=i64)[:, None] + row_base

    run_key = torch.full((b, k), -(1 << 32), dtype=i64, device=dev)
    for c0 in range(0, n, chunk):
        c1 = min(c0 + chunk, n)
        mask, score = mask_and_score(table, batch, profile, c0, c1,
                                     with_affinity=with_affinity, constraints=constraints,
                                     stats=stats)
        local = torch.arange(c0, c1, device=dev, dtype=i64)
        prio = pack_hashed(
            score, seed, mask, pod_rows, (local + col_base)[None], stratum_bits
        )
        # Composite key: priority in the high word, (2^32-1 - row) in the
        # low word, so one descending topk ranks by priority and then by
        # the earlier row; every key is distinct.
        key = (prio.to(i64) << 32) + (_M32 - local)[None]
        run_key = torch.topk(torch.cat([run_key, key], dim=1), k, dim=1).values

    prio = (run_key >> 32).to(i32)
    row = (_M32 - (run_key & _M32)).to(i32)
    idx = torch.where(prio >= 0, row, torch.full_like(row, -1))
    return idx, prio


def candidates(table, batch, seed, profile: Profile, *, chunk: int, k: int,
               row_offset: int = 0, pod_offset: int = 0, stratum_bits: int = 0,
               with_affinity: bool = False, constraints=None, stats=None,
               reference: bool = False):
    """Counterpart of ``pallas_candidates``: ``engine.cycle.Candidates``
    with the payload (free capacity, zone, region) gathered at the
    candidate rows of ``table``.  ``row_offset``/``pod_offset`` globalize
    the emitted rows and the hash coordinates.  ``reference=True`` runs
    the plain version on the tensors' device instead of the kernel — the
    comparison path, never a fallback."""
    from k8s1m_tpu_torch.engine.cycle import Candidates

    n = table.num_rows
    if n % chunk:
        raise ValueError(f"table rows {n} not divisible by chunk {chunk}")
    kw = dict(k=k, row_base=pod_offset, col_base=row_offset, stratum_bits=stratum_bits,
              with_affinity=with_affinity, constraints=constraints, stats=stats)
    if reference:
        idx, prio = fused_topk_reference(table, batch, seed, profile, chunk=chunk, **kw)
    else:
        idx, prio = fused_topk(table, batch, seed, profile, **kw)
    safe = idx.clamp(min=0).to(torch.int64)
    feasible = prio >= 0
    return Candidates(
        idx=torch.where(feasible, idx + row_offset, torch.full_like(idx, -1)),
        prio=prio,
        cpu=table.cpu_alloc[safe] - table.cpu_req[safe],
        mem=table.mem_alloc[safe] - table.mem_req[safe],
        pods=table.pods_alloc[safe].to(torch.int32) - table.pods_req[safe],
        zone=table.zone[safe].to(torch.int32),
        region=table.region[safe].to(torch.int32),
    )
