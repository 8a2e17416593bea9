"""Score plugins as tensor functions over (pod batch x node chunk).

Port of ``k8s1m_tpu/plugins/scores.py``; each score is f32 in [0, 100] and
is floored before weighting (``plugins/registry.py::score_and_filter``).

These follow the JAX package's XLA expression order, which differs from
the fused kernel's (its plain version ``ops/fused_topk.py::
fused_topk_reference`` follows the Pallas order): LeastAllocated subtracts
in int32 and converts the difference to f32; the kernel converts first
and subtracts in f32.  The two agree where the values are exact in f32
(below 2^24) and may differ beyond.  Every division is by a tensor: PyTorch
may turn division by a Python scalar into multiplication by its
reciprocal, which is not IEEE division.
"""

from __future__ import annotations

import torch

from k8s1m_tpu_torch.config import EFFECT_PREFER_NO_SCHEDULE, NONE_ID
from k8s1m_tpu_torch.ops.label_match import ResolvedKeys, match_expressions, used_slots
from k8s1m_tpu_torch.plugins.filters import take_tolerated

_F32 = torch.float32


def _allocatable(table):
    """(cpu, mem) allocatable clamped to >= 1, i32 [1, N]."""
    return (torch.clamp(table.cpu_alloc, min=1)[None, :],
            torch.clamp(table.mem_alloc, min=1)[None, :])


def least_allocated(table, batch):
    """NodeResourcesFit LeastAllocated: mean over {cpu, mem} of free/alloc,
    as ``(alloc - after)`` in int32, then f32 over f32(alloc)."""
    cpu_after = table.cpu_req[None, :] + batch.cpu[:, None]
    mem_after = table.mem_req[None, :] + batch.mem[:, None]
    alloc_cpu, alloc_mem = _allocatable(table)
    cpu_score = (alloc_cpu - cpu_after).to(_F32) / alloc_cpu.to(_F32)
    mem_score = (alloc_mem - mem_after).to(_F32) / alloc_mem.to(_F32)
    return 50.0 * (torch.clamp(cpu_score, min=0.0) + torch.clamp(mem_score, min=0.0))


def balanced_allocation(table, batch):
    """NodeResourcesBalancedAllocation: 100 * (1 - |f_cpu - f_mem| / 2)."""
    alloc_cpu, alloc_mem = _allocatable(table)
    f_cpu = torch.clamp(
        (table.cpu_req[None, :] + batch.cpu[:, None]).to(_F32) / alloc_cpu.to(_F32), 0.0, 1.0)
    f_mem = torch.clamp(
        (table.mem_req[None, :] + batch.mem[:, None]).to(_F32) / alloc_mem.to(_F32), 0.0, 1.0)
    two = torch.tensor(2.0, dtype=_F32, device=f_cpu.device)
    return 100.0 * (1.0 - torch.abs(f_cpu - f_mem) / two)


def taint_toleration(table, batch):
    """TaintToleration score: fewer untolerated PreferNoSchedule taints is
    better, over the static bound ``taint_slots``."""
    ts = table.taint_id.shape[1]
    soft = (table.taint_id != NONE_ID) & (table.taint_effect == EFFECT_PREFER_NO_SCHEDULE)
    tol = take_tolerated(batch.tolerated, table.taint_id)          # [B, N, TS]
    count = (soft[None] & ~tol).sum(dim=-1, dtype=torch.int32)
    ts_f = torch.tensor(float(ts), dtype=_F32, device=count.device)
    return 100.0 * (1.0 - count.to(_F32) / ts_f)


def node_affinity_score(batch, resolved: ResolvedKeys):
    """NodeAffinity preferred terms: matched term weights over the pod's
    total preferred weight (a static bound, as in the JAX package).

    f32 in the Pallas kernel's order: the weights of matched terms summed
    in f32 term by term, then ``100 * sum / max(total, 1)``.  Every
    partial sum is an integer below 2^24, so the XLA path's integer sum
    gives the same float."""
    # Terms past the last one any pod uses weigh 0 everywhere: cut.
    t = used_slots(batch.pref_term_valid)
    term_match, has_expr = match_expressions(
        resolved, batch.pref_expr_valid[:, :t], batch.pref_qidx[:, :t], batch.pref_op[:, :t],
        batch.pref_vals[:, :t], batch.pref_num[:, :t],
    )                                                            # [B, P, N]
    b, p_slots, n = term_match.shape
    live = batch.pref_term_valid[:, :t] & has_expr
    w = (live.to(torch.int32) * batch.pref_weight[:, :t]).to(_F32)  # [B, P]
    acc = torch.zeros((b, n), dtype=_F32, device=w.device)
    wtot = torch.zeros((b, 1), dtype=_F32, device=w.device)
    for p in range(p_slots):
        hit = (term_match[:, p] & live[:, p, None]).to(_F32)
        acc = acc + hit * w[:, p, None]
        wtot = wtot + w[:, p, None]
    return 100.0 * acc / torch.clamp(wtot, min=1.0)
