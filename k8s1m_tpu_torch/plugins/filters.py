"""Filter plugins as tensor functions over (pod batch x node chunk).

Port of ``k8s1m_tpu/plugins/filters.py``: each function returns a bool
mask [B, N] (True = node passes for pod), and ``feasible_mask`` ANDs them
with row validity — the XLA path of the JAX package, which the deltasched
planes are computed with (``plugins/registry.py::score_and_filter``).

- fits_resources   <- NodeResourcesFit (cpu, memory, pod count)
- node_name        <- NodeName
- tolerates_taints <- TaintToleration
- node_affinity    <- NodeAffinity required terms + spec.nodeSelector

The JAX module's ``_statically_empty`` skip (a field group the packed
batch leaves out is a host constant of zeros, so its plugin is a no-op)
becomes the ``groups`` argument: the packed batch's field groups, None
for all present.  Skipping an absent group gives the same mask.
"""

from __future__ import annotations

import torch

from k8s1m_tpu_torch.config import EFFECT_NO_EXECUTE, EFFECT_NO_SCHEDULE, NONE_ID
from k8s1m_tpu_torch.ops.label_match import (
    ResolvedKeys,
    match_expressions,
    resolve_query_keys,
    take_planes,
    used_slots,
)


def absent(groups, group: str) -> bool:
    """True when the packed field groups say ``group`` is left out."""
    return groups is not None and group not in groups


def fits_resources(table, batch):
    """NodeResourcesFit: requests fit in allocatable-minus-requested."""
    free_cpu, free_mem, free_pods = table.free()
    return (
        (batch.cpu[:, None] <= free_cpu[None, :])
        & (batch.mem[:, None] <= free_mem[None, :])
        & (free_pods[None, :] >= 1)
    )


def node_name(table, batch):
    """NodeName: spec.nodeName, when set, must equal the node's name."""
    unset = batch.node_name_id == NONE_ID
    return unset[:, None] | (batch.node_name_id[:, None] == table.name_id[None, :])


def take_tolerated(tolerated, taint_id):
    """``jnp.take(tolerated, taint_id, axis=1)`` in its default mode:
    ``tolerated`` bool[B, M], ``taint_id`` [N, TS] -> bool[B, N, TS]; an id
    in [-M, 0) wraps, an id outside [-M, M) reads True (the fill value
    for bool)."""
    m = tolerated.shape[1]
    ids = taint_id.to(torch.int64)
    ok = (ids >= -m) & (ids < m)
    idx = torch.where(ids < 0, ids + m, ids).clamp(0, m - 1)
    return tolerated[:, idx] | ~ok[None]


def tolerates_taints(table, batch, groups=None):
    """TaintToleration: every hard taint on the node must be tolerated
    (the host evaluated each taint triple per pod into ``tolerated``)."""
    hard = (table.taint_id != NONE_ID) & (
        (table.taint_effect == EFFECT_NO_SCHEDULE)
        | (table.taint_effect == EFFECT_NO_EXECUTE)
    )
    if absent(groups, "tol"):
        # No pod tolerates anything: a node passes iff it has no hard taint.
        return (~hard.any(dim=-1))[None, :].expand(batch.batch, -1)
    tol = take_tolerated(batch.tolerated, table.taint_id)
    return ~(hard[None] & ~tol).any(dim=-1)


def node_affinity(batch, resolved: ResolvedKeys):
    """NodeAffinity required terms (OR of ANDed terms) + spec.nodeSelector.

    ``batch`` is a PodBatch; ``resolved`` the chunk's query-key planes."""
    # nodeSelector: ANDed exact matches; inactive slots pass (and slots
    # past the last one any pod uses are cut).
    s = used_slots(batch.sel_valid)
    f = take_planes(resolved.found, batch.sel_qidx[:, :s])             # [B, S, N]
    v = take_planes(resolved.val, batch.sel_qidx[:, :s])
    sel_ok = f & (v == batch.sel_val[:, :s, None])
    sel_pass = (sel_ok | ~batch.sel_valid[:, :s, None]).all(dim=1)

    # Required affinity: OR over live terms; an empty term matches
    # nothing, and a pod with no term passes everywhere.  Terms past the
    # last one any pod uses are not live anywhere and are cut.
    t = used_slots(batch.req_term_valid)
    term_match, has_expr = match_expressions(
        resolved, batch.req_expr_valid[:, :t], batch.req_qidx[:, :t], batch.req_op[:, :t],
        batch.req_vals[:, :t], batch.req_num[:, :t],
    )                                                            # [B, T, N]
    live = batch.req_term_valid[:, :t] & has_expr
    any_term = (term_match & live[:, :, None]).any(dim=1)
    has_terms = batch.req_term_valid.any(dim=1)
    aff_pass = torch.where(has_terms[:, None], any_term, torch.ones_like(any_term))
    return sel_pass & aff_pass


def feasible_mask(table, batch, resolved: ResolvedKeys | None = None, groups=None):
    """AND of all filter plugins, plus row and pod validity: bool[B, N]."""
    mask = table.valid[None, :]
    mask = mask & fits_resources(table, batch)
    mask = mask & node_name(table, batch)
    mask = mask & tolerates_taints(table, batch, groups)
    if not (absent(groups, "sel") and absent(groups, "req")):
        if resolved is None:
            resolved = resolve_query_keys(
                table.label_key, table.label_val, table.label_num, batch.qkey
            )
        mask = mask & node_affinity(batch, resolved)
    return mask & batch.valid[:, None]
