"""Score plugins as tensor functions over (pod batch x node chunk).

Port of the NodeAffinity score of ``k8s1m_tpu/plugins/scores.py``; each
score is f32 in [0, 100] and is floored before weighting.  The resource
and taint scores live in the plain version of the fused kernel
(``ops/fused_topk.py``).
"""

from __future__ import annotations

import torch

from k8s1m_tpu_torch.ops.label_match import ResolvedKeys, match_expressions


def node_affinity_score(batch, resolved: ResolvedKeys):
    """NodeAffinity preferred terms: matched term weights over the pod's
    total preferred weight (a static bound, as in the JAX package).

    f32 in the Pallas kernel's order: the weights of matched terms summed
    in f32 term by term, then ``100 * sum / max(total, 1)``.  Every
    partial sum is an integer below 2^24, so the XLA path's integer sum
    gives the same float."""
    term_match, has_expr = match_expressions(
        resolved, batch.pref_expr_valid, batch.pref_qidx, batch.pref_op,
        batch.pref_vals, batch.pref_num,
    )                                                            # [B, P, N]
    f32 = torch.float32
    b, p_slots, n = term_match.shape
    live = batch.pref_term_valid & has_expr
    w = (live.to(torch.int32) * batch.pref_weight).to(f32)       # [B, P]
    acc = torch.zeros((b, n), dtype=f32, device=w.device)
    wtot = torch.zeros((b, 1), dtype=f32, device=w.device)
    for p in range(p_slots):
        hit = (term_match[:, p] & live[:, p, None]).to(f32)
        acc = acc + hit * w[:, p, None]
        wtot = wtot + w[:, p, None]
    # Divide by a tensor, never a Python scalar: PyTorch may turn a scalar
    # division into a multiplication by the reciprocal.
    return 100.0 * acc / torch.clamp(wtot, min=1.0)
