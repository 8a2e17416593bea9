"""PodTopologySpread + InterPodAffinity as count-table functions.

Port of ``k8s1m_tpu/plugins/topology.py`` (semantics and their documented
divergences from upstream are the JAX module's):

- spread filter (DoNotSchedule): ``count(d) + self - min <= maxSkew``,
  nodes missing the topology key fail; the min is over domains holding
  at least one schedulable node;
- spread score: least crowded domain 100, most crowded 0, averaged over
  the pod's constraints;
- affinity required (with the self-match bootstrap), anti-affinity
  required, the symmetry rule from ``own`` counts;
- affinity score: preferred weight x matching-pod count, rescaled to
  [0, 100] by the batch-static bound.

``prologue`` takes the batch-global reductions once per wave (from the
FULL table and count tables, whatever window is scored).
``filter_and_score`` is the plain per-chunk evaluation; its f32 sums run
ref by ref, the Pallas kernel's order (pallas_topk.py:495-554), which the
CUDA kernel follows too.  An index outside its table (a slot or a domain
id) counts 0, as the Pallas one-hot selection counts nothing for it.
"""

from __future__ import annotations

import dataclasses

import torch

from k8s1m_tpu_torch.config import SPREAD_DO_NOT_SCHEDULE, TOPO_HOSTNAME, TOPO_ZONE
from k8s1m_tpu_torch.snapshot.constraints import ConstraintState

_BIG = 1 << 30
_I32_MIN = -(1 << 31)


@dataclasses.dataclass
class TopoStats:
    """Batch-global reductions over the count tables (the prologue)."""

    spread_min: torch.Tensor   # i32[3, C] min count per topo granularity
    spread_max: torch.Tensor   # i32[3, C]
    tgt_max: torch.Tensor      # i32[A] max count over the term's domains
    tgt_total: torch.Tensor    # i32[A] total matching pods cluster-wide


def _domain_presence(valid, size: int, ids):
    """i32[size]: 1 where some valid node sits in the domain; domain 0
    ("label missing") is never a domain."""
    present = torch.zeros((size,), dtype=torch.int32, device=ids.device)
    present.scatter_reduce_(0, ids.to(torch.int64), valid.to(torch.int32), "amax")
    present[0] = 0
    return present


def _masked_min(tab, present):  # tab [C, D], present [D]
    m = torch.where(present[None, :] > 0, tab, _BIG).amin(dim=1)
    return torch.where(m == _BIG, 0, m)


def _masked_max(tab, present):
    return torch.where(present[None, :] > 0, tab, 0).amax(dim=1)


class _OneShard:
    """The reductions of a single device: one part, nothing to cross."""

    def __init__(self, device):
        self.device = device

    @staticmethod
    def pmin(parts):
        return parts[0]

    pmax = psum = pmin


def prologue(table, cons: ConstraintState, *, axis=None) -> TopoStats:
    """Global reductions before the chunk scan.  ``table`` is a NodeTable
    or a DomainView (``valid``, ``zone``, ``region`` as full columns).

    ``axis`` is a mesh's sp axis (``parallel.sharded_cycle.SpAxis``) where
    the JAX prologue takes ``axis_name="sp"``: ``table`` and ``cons`` are
    then the per-shard lists, each shard reduces its own node columns, and
    the axis's ``pmax`` (domain presence, maxima), ``pmin`` (spread minima)
    and ``psum`` (matching-pod totals) cross the shards; the stats land on
    ``axis.device``."""
    if axis is None:
        table, cons, axis = [table], [cons], _OneShard(table.valid.device)
    i32 = torch.int32
    views, parts = list(table), list(cons)
    first = parts[0]

    def node_min(name):
        m = axis.pmin([torch.where(v.valid[None, :], getattr(c, name), _BIG).amin(dim=1)
                       for v, c in zip(views, parts)])
        return torch.where(m == _BIG, 0, m)

    def node_max(name):
        return axis.pmax([torch.where(v.valid[None, :], getattr(c, name), 0).amax(dim=1)
                          for v, c in zip(views, parts)])

    def presence(field, size):
        return axis.pmax([_domain_presence(v.valid, size, getattr(v, field).to(i32))
                          for v in views])

    zone_present = presence("zone", first.spread_zone.shape[1])
    region_present = presence("region", first.spread_region.shape[1])
    whole = {f: getattr(first, f).to(axis.device) for f in (
        "spread_zone", "spread_region", "tgt_zone", "tgt_region")}
    spread_min = torch.stack([
        node_min("spread_node"),
        _masked_min(whole["spread_zone"], zone_present),
        _masked_min(whole["spread_region"], region_present),
    ])
    spread_max = torch.stack([
        node_max("spread_node"),
        _masked_max(whole["spread_zone"], zone_present),
        _masked_max(whole["spread_region"], region_present),
    ])
    tgt_max = torch.maximum(
        node_max("tgt_node"),
        torch.maximum(
            _masked_max(whole["tgt_zone"], zone_present),
            _masked_max(whole["tgt_region"], region_present),
        ),
    )
    tgt_total = (
        axis.psum([c.tgt_node.sum(dim=1, dtype=i32) for c in parts])
        + whole["tgt_zone"].sum(dim=1, dtype=i32)
        + whole["tgt_region"].sum(dim=1, dtype=i32)
    )
    return TopoStats(
        spread_min=spread_min.to(i32), spread_max=spread_max.to(i32),
        tgt_max=tgt_max.to(i32), tgt_total=tgt_total,
    )


def take_fill(vec, idx):
    """``jnp.take(vec, idx)`` over i32[C] (its default "fill" mode: an
    index outside [0, C) gives the most negative i32)."""
    c = vec.shape[0]
    ok = (idx >= 0) & (idx < c)
    got = vec[idx.clamp(0, c - 1).to(torch.int64)]
    return torch.where(ok, got, torch.full_like(got, _I32_MIN))


def _gather_rows(tab, slot):
    """tab[slot] for slot [B, S] over tab [C, D] -> [B, S, D]; a slot
    outside [0, C) gives zeros."""
    c = tab.shape[0]
    ok = (slot >= 0) & (slot < c)
    got = tab[slot.clamp(0, c - 1).to(torch.int64)]
    return got * ok[..., None].to(got.dtype)


def _counts_for(node_tab, zone_tab, region_tab, slot, topo, table):
    """Per-node domain counts for [B, S] (slot, topo) refs -> (cnt
    i32[B, S, N], domain_ok bool[B, S, N]).  ``table.zone``/``region``
    are the chunk's i32 domain ids."""
    zone = table.zone.to(torch.int32)
    region = table.region.to(torch.int32)

    def by_domain(tab, ids):
        d = tab.shape[1]
        ok = (ids >= 0) & (ids < d)
        rows = _gather_rows(tab, slot)                            # [B, S, D]
        got = rows[..., ids.clamp(0, d - 1).to(torch.int64)]      # [B, S, N]
        return got * ok.to(got.dtype)

    cnt_node = _gather_rows(node_tab, slot)
    cnt_zone = by_domain(zone_tab, zone)
    cnt_region = by_domain(region_tab, region)
    t = topo[:, :, None]
    cnt = torch.where(
        t == TOPO_HOSTNAME, cnt_node, torch.where(t == TOPO_ZONE, cnt_zone, cnt_region)
    )
    domain_ok = torch.where(
        t == TOPO_HOSTNAME, torch.ones_like(t, dtype=torch.bool),
        torch.where(t == TOPO_ZONE, (zone != 0)[None, None, :], (region != 0)[None, None, :]),
    )
    return cnt, domain_ok


def _stat_for(stat, slot, topo):
    """Select a [3, C] per-topo stat for [B, S] refs -> i32[B, S] (an
    out-of-range slot gives the most negative i32, as ``jnp.take``)."""
    c = stat.shape[1]
    ok = (slot >= 0) & (slot < c)
    by_topo = stat[:, slot.clamp(0, c - 1).to(torch.int64)]      # [3, B, S]
    sel = torch.where(
        topo == TOPO_HOSTNAME, by_topo[0], torch.where(topo == TOPO_ZONE, by_topo[1], by_topo[2])
    )
    return torch.where(ok, sel, torch.full_like(sel, _I32_MIN))


def filter_and_score(table, batch, cons: ConstraintState, stats: TopoStats,
                     spread_weight: int, ipa_weight: int):
    """(mask bool[B, N], score i32[B, N]) over one node chunk.

    A zero weight skips that plugin's scoring; the hard constraints
    (spread maxSkew, required [anti-]affinity, symmetry) always filter."""
    f32, i32 = torch.float32, torch.int32
    b, n = batch.batch, table.zone.shape[0]
    dev = table.zone.device

    # ---- topology spread ----
    cnt, dok = _counts_for(
        cons.spread_node, cons.spread_zone, cons.spread_region,
        batch.spread_cid, batch.spread_topo, table,
    )                                                             # [B, S, N]
    min_c = _stat_for(stats.spread_min, batch.spread_cid, batch.spread_topo)
    skew_ok = (cnt + batch.spread_self.to(i32)[:, :, None] - min_c[:, :, None]) <= (
        batch.spread_max_skew[:, :, None]
    )
    hard = batch.spread_valid & (batch.spread_mode == SPREAD_DO_NOT_SCHEDULE)
    mask = (~hard[:, :, None] | (dok & skew_ok)).all(dim=1)
    score = torch.zeros((b, n), dtype=i32, device=dev)
    if spread_weight:
        max_c = _stat_for(stats.spread_max, batch.spread_cid, batch.spread_topo)
        denom = torch.clamp(max_c - min_c, min=1).to(f32)
        live = batch.spread_valid.to(f32)
        acc = torch.zeros((b, n), dtype=f32, device=dev)
        for j in range(cnt.shape[1]):
            s_ref = 100.0 * (max_c[:, j, None] - cnt[:, j]).to(f32) / denom[:, j, None]
            s_ref = torch.clamp(s_ref, 0.0, 100.0) * dok[:, j].to(f32)
            acc = acc + s_ref * live[:, j, None]
        nrefs = torch.clamp(batch.spread_valid.sum(dim=1, dtype=i32), min=1).to(f32)
        score += torch.floor(acc / nrefs[:, None]).to(i32) * int(spread_weight)

    # ---- inter-pod affinity: the pod's own terms ----
    tcnt, tdok = _counts_for(
        cons.tgt_node, cons.tgt_zone, cons.tgt_region,
        batch.ipa_tid, batch.ipa_topo, table,
    )                                                             # [B, A, N]
    total = take_fill(stats.tgt_total, batch.ipa_tid)             # [B, A]
    boot = (total == 0) & batch.ipa_self
    live_req = batch.ipa_valid & batch.ipa_required
    reqaff = live_req & ~batch.ipa_anti
    reqanti = live_req & batch.ipa_anti
    aff_ok = (tdok & ((tcnt > 0) | boot[:, :, None])) | ~reqaff[:, :, None]
    anti_ok = ~tdok | (tcnt == 0) | ~reqanti[:, :, None]
    mask &= (aff_ok & anti_ok).all(dim=1)

    # symmetry: existing pods' required anti-affinity blocks their domains
    # for pods their selector matches.
    ocnt, odok = _counts_for(
        cons.own_node, cons.own_zone, cons.own_region,
        batch.iinc_tid, batch.iinc_topo, table,
    )
    mask &= (~batch.iinc_valid[:, :, None] | ~odok | (ocnt == 0)).all(dim=1)

    if ipa_weight:
        pref = batch.ipa_valid & ~batch.ipa_required
        sign = torch.where(batch.ipa_anti, -1, 1).to(i32) * batch.ipa_weight
        prefsign = torch.where(pref, sign, 0).to(f32)             # [B, A]
        raw = torch.zeros((b, n), dtype=f32, device=dev)
        for j in range(tcnt.shape[1]):
            raw = raw + (tcnt[:, j] * tdok[:, j].to(i32)).to(f32) * prefsign[:, j, None]
        bound = (
            torch.abs(batch.ipa_weight) * take_fill(stats.tgt_max, batch.ipa_tid)
            * pref.to(i32)
        ).sum(dim=1, dtype=i32)
        bound_f = torch.clamp(bound, min=1).to(f32)
        ipa = torch.clamp(50.0 + 50.0 * raw / bound_f[:, None], 0.0, 100.0)
        ipa = torch.where(pref.any(dim=1)[:, None], ipa, torch.zeros((), dtype=f32, device=dev))
        score += torch.floor(ipa).to(i32) * int(ipa_weight)
    return mask, score
