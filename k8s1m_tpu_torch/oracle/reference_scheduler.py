"""Pure-Python reference scheduler: the differential-correctness oracle.

The port's own copy of ``k8s1m_tpu/oracle/reference_scheduler.py``
(numpy only); the coordinator's breaker-open fallback binds through it.

Evaluates filter and score semantics directly on host objects (NodeInfo /
PodInfo, strings and dicts) with none of the interning, encoding, or
tensor machinery — an independent implementation of the same upstream
plugin semantics the kernels implement.  The differential harness feeds
identical snapshots to both and compares bit-for-bit (masks) and
value-for-value (integer scores).

This is the test the reference never had: its correctness story for the
scheduling path was "trust the upstream fork" (reference RUNNING.adoc:207
admits the code is messy and not well-tested).  SURVEY.md §7 calls this
harness non-negotiable.

Arithmetic note: score formulas are computed in float32 like the kernels,
so floor() boundaries agree; the *semantics* (what matches, what counts)
share no code with the device path except semantics.py, which is the
single definition of toleration matching by design.
"""

from __future__ import annotations

import numpy as np

from k8s1m_tpu_torch.config import (
    EFFECT_NO_EXECUTE,
    EFFECT_NO_SCHEDULE,
    EFFECT_PREFER_NO_SCHEDULE,
    SEL_OP_DOES_NOT_EXIST,
    SEL_OP_EXISTS,
    SEL_OP_GT,
    SEL_OP_IN,
    SEL_OP_LT,
    SEL_OP_NOT_IN,
)
from k8s1m_tpu_torch.semantics import pod_tolerates_taint
from k8s1m_tpu_torch.snapshot.node_table import (
    HOSTNAME_LABEL,
    UNSCHEDULABLE_TAINT_KEY,
    NodeInfo,
    Taint,
)
from k8s1m_tpu_torch.snapshot.pod_encoding import PodInfo


def _effective_labels(node: NodeInfo) -> dict[str, str]:
    labels = dict(node.labels)
    labels.setdefault(HOSTNAME_LABEL, node.name)
    return labels


def _effective_taints(node: NodeInfo) -> list[Taint]:
    taints = list(node.taints)
    if node.unschedulable:
        taints.append(Taint(UNSCHEDULABLE_TAINT_KEY, "", EFFECT_NO_SCHEDULE))
    return taints


def _match_expr(labels: dict[str, str], req) -> bool:
    present = req.key in labels
    val = labels.get(req.key)
    if req.op == SEL_OP_IN:
        return present and val in req.values
    if req.op == SEL_OP_NOT_IN:
        return not (present and val in req.values)
    if req.op == SEL_OP_EXISTS:
        return present
    if req.op == SEL_OP_DOES_NOT_EXIST:
        return not present
    if req.op in (SEL_OP_GT, SEL_OP_LT):
        if not present or not req.values:
            return False
        try:
            node_num = int(val, 10)
            operand = int(req.values[0], 10)
        except (ValueError, TypeError):
            return False
        return node_num > operand if req.op == SEL_OP_GT else node_num < operand
    return False


def _match_term(labels: dict[str, str], term) -> bool:
    if not term.match_expressions:
        return False  # upstream: an empty term matches nothing
    return all(_match_expr(labels, e) for e in term.match_expressions)


def oracle_feasible(
    node: NodeInfo,
    pod: PodInfo,
    requested: tuple[int, int, int] = (0, 0, 0),
) -> bool:
    """All filter plugins, host-side. requested = (cpu, mem, pods) in use."""
    rc, rm, rp = requested
    if pod.cpu_milli > node.cpu_milli - rc:
        return False
    if pod.mem_kib > node.mem_kib - rm:
        return False
    if node.pods - rp < 1:
        return False
    if pod.node_name is not None and pod.node_name != node.name:
        return False
    for taint in _effective_taints(node):
        if taint.effect in (EFFECT_NO_SCHEDULE, EFFECT_NO_EXECUTE):
            if not pod_tolerates_taint(pod.tolerations, taint):
                return False
    labels = _effective_labels(node)
    for k, v in pod.node_selector.items():
        if labels.get(k) != v:
            return False
    if pod.required_terms:
        if not any(_match_term(labels, t) for t in pod.required_terms):
            return False
    return True


def oracle_score(
    node: NodeInfo,
    pod: PodInfo,
    requested: tuple[int, int, int] = (0, 0, 0),
    *,
    taint_slots: int = 8,
    weights=(1, 1, 3, 2),
) -> int:
    """Weighted integer score; weights = (least_allocated,
    balanced_allocation, taint_toleration, node_affinity)."""
    f32 = np.float32
    rc, rm, _ = requested
    w_la, w_ba, w_tt, w_na = weights

    cpu_after = f32(rc + pod.cpu_milli)
    mem_after = f32(rm + pod.mem_kib)
    alloc_cpu = f32(max(node.cpu_milli, 1))
    alloc_mem = f32(max(node.mem_kib, 1))

    la = f32(50.0) * (
        np.clip((alloc_cpu - cpu_after) / alloc_cpu, f32(0), None)
        + np.clip((alloc_mem - mem_after) / alloc_mem, f32(0), None)
    )

    f_cpu = np.clip(cpu_after / alloc_cpu, f32(0), f32(1))
    f_mem = np.clip(mem_after / alloc_mem, f32(0), f32(1))
    ba = f32(100.0) * (f32(1.0) - np.abs(f_cpu - f_mem) / f32(2.0))

    soft_untol = sum(
        1
        for t in _effective_taints(node)
        if t.effect == EFFECT_PREFER_NO_SCHEDULE
        and not pod_tolerates_taint(pod.tolerations, t)
    )
    tt = f32(100.0) * (f32(1.0) - f32(soft_untol) / f32(taint_slots))

    labels = _effective_labels(node)
    total_w = max(sum(p.weight for p in pod.preferred_terms), 1)
    matched_w = sum(
        p.weight for p in pod.preferred_terms if _match_term(labels, p.term)
    )
    na = f32(100.0) * f32(matched_w) / f32(total_w)

    return (
        int(np.floor(la)) * w_la
        + int(np.floor(ba)) * w_ba
        + int(np.floor(tt)) * w_tt
        + int(np.floor(na)) * w_na
    )
