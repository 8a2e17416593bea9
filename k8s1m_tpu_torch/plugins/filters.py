"""Filter plugins as tensor functions over (pod batch x node chunk).

Port of the NodeAffinity part of ``k8s1m_tpu/plugins/filters.py``: each
function returns a bool mask [B, N] (True = node passes for pod).  The
base filters (NodeResourcesFit, NodeName, TaintToleration) live in the
plain version of the fused kernel (``ops/fused_topk.py``).

The JAX module's ``_statically_empty`` skip is a trace-time shortcut for
absent field groups; here an absent group is a zero tensor, which the
same arithmetic already treats as pass-through.
"""

from __future__ import annotations

import torch

from k8s1m_tpu_torch.ops.label_match import ResolvedKeys, match_expressions, take_planes


def node_affinity(batch, resolved: ResolvedKeys):
    """NodeAffinity required terms (OR of ANDed terms) + spec.nodeSelector.

    ``batch`` is a PodBatch; ``resolved`` the chunk's query-key planes."""
    # nodeSelector: ANDed exact matches; inactive slots pass.
    f = take_planes(resolved.found, batch.sel_qidx)                    # [B, S, N]
    v = take_planes(resolved.val, batch.sel_qidx)
    sel_ok = f & (v == batch.sel_val[:, :, None])
    sel_pass = (sel_ok | ~batch.sel_valid[:, :, None]).all(dim=1)

    # Required affinity: OR over live terms; an empty term matches
    # nothing, and a pod with no term passes everywhere.
    term_match, has_expr = match_expressions(
        resolved, batch.req_expr_valid, batch.req_qidx, batch.req_op,
        batch.req_vals, batch.req_num,
    )                                                            # [B, T, N]
    live = batch.req_term_valid & has_expr
    any_term = (term_match & live[:, :, None]).any(dim=1)
    has_terms = batch.req_term_valid.any(dim=1)
    aff_pass = torch.where(has_terms[:, None], any_term, torch.ones_like(any_term))
    return sel_pass & aff_pass
