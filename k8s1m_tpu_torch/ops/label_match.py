"""Label lookup and NodeSelector expression matching over node chunks.

Port of ``k8s1m_tpu/ops/label_match.py``.  ``resolve_query_keys`` turns
a chunk's [N, L] label slots into dense [Q, N] lookups for the batch's Q
query keys; ``match_expressions`` evaluates selector expressions as
gathers into those planes.

Semantics mirror upstream nodeaffinity.NodeSelector.Match:
- In:           label present and value in set
- NotIn:        label absent, or value not in set
- Exists:       label present
- DoesNotExist: label absent
- Gt/Lt:        label present, parses as int, compares; non-integers never match

One choice the JAX module leaves open is fixed here: when several label
slots of a node carry the same key, the LAST one wins (the Pallas
kernel's rule, pallas_topk.py:300-317; the XLA path sums).  The host
keeps keys unique per node, so both agree on every table it builds.
A query index outside ``[0, Q)`` resolves to not-found, as the Pallas
one-hot selection does.
"""

from __future__ import annotations

import dataclasses

import torch

from k8s1m_tpu_torch.config import (
    NO_NUMERIC,
    NONE_ID,
    SEL_OP_DOES_NOT_EXIST,
    SEL_OP_EXISTS,
    SEL_OP_GT,
    SEL_OP_IN,
    SEL_OP_LT,
    SEL_OP_NOT_IN,
)


@dataclasses.dataclass
class ResolvedKeys:
    """Per-node resolution of the batch's query keys."""

    found: torch.Tensor  # bool[Q, N] node has the key
    val: torch.Tensor    # i32[Q, N] label value id (0 when not found)
    num: torch.Tensor    # i32[Q, N] parsed numeric value (0 when not found)


def resolve_query_keys(label_key, label_val, label_num, qkey) -> ResolvedKeys:
    """label_key/val/num: i32[N, L]; qkey: i32[Q] -> ResolvedKeys over [Q, N].

    qkey slot 0 is the reserved NONE key and resolves to found=False
    everywhere (NONE label slots are padding and never match)."""
    q, n = qkey.shape[0], label_key.shape[0]
    dev = label_key.device
    found = torch.zeros((q, n), dtype=torch.bool, device=dev)
    val = torch.zeros((q, n), dtype=torch.int32, device=dev)
    num = torch.zeros((q, n), dtype=torch.int32, device=dev)
    for slot in range(label_key.shape[1]):
        lk = label_key[:, slot][None, :]
        eq = (qkey[:, None] == lk) & (lk != NONE_ID)               # [Q, N]
        found = found | eq
        val = torch.where(eq, label_val[:, slot][None, :], val)
        num = torch.where(eq, label_num[:, slot][None, :], num)
    return ResolvedKeys(found=found, val=val, num=num)


def take_planes(plane, qidx):
    """``plane[qidx]`` over [Q, N] for any-shaped qidx -> [..., N]; an
    index outside [0, Q) gives zeros."""
    q = plane.shape[0]
    ok = (qidx >= 0) & (qidx < q)
    got = plane[qidx.clamp(0, q - 1).to(torch.int64)]
    return torch.where(ok[..., None], got, torch.zeros((), dtype=plane.dtype, device=plane.device))


def used_slots(mask) -> int:
    """1 + the last index of the last axis where any entry of ``mask`` is
    set, 0 when none is."""
    hit = torch.nonzero(mask.reshape(-1, mask.shape[-1]).any(dim=0))
    return int(hit[-1]) + 1 if hit.numel() else 0


def match_expressions(
    resolved: ResolvedKeys,
    expr_valid,  # bool[..., E]
    qidx,        # i32[..., E] index into the batch's query-key table
    op,          # i32[..., E] SEL_OP_*
    vals,        # i32[..., E, V] value-id set (NONE_ID padded)
    num,         # i32[..., E] operand for Gt/Lt
):
    """Evaluate selector expressions against every node.

    Returns (term_match: bool[..., N], has_expr: bool[...]): the AND over
    valid expressions; a term with no valid expression matches nothing,
    which the caller enforces with has_expr.

    Trailing expression slots no pod uses and trailing value slots that
    hold NONE_ID for every expression are cut first: an invalid
    expression passes the AND, and a NONE_ID value can equal ``v`` only
    where the key is absent, which ``found`` gates — so the result is the
    same (one host read of each cut)."""
    e = used_slots(expr_valid)
    expr_valid, qidx, op, num = (t[..., :e] for t in (expr_valid, qidx, op, num))
    vals = vals[..., :e, :used_slots(vals != NONE_ID)]
    f = take_planes(resolved.found, qidx)                              # [..., E, N]
    v = take_planes(resolved.val, qidx)
    x = take_planes(resolved.num, qidx)
    # Padded NONE_ID values can match only where the key is absent (v is
    # 0 there), and `found` gates every op that reads the set.
    in_set = (v[..., None] == vals[..., None, :]).any(dim=-1)
    operand = num[..., None]
    numeric_ok = f & (x != NO_NUMERIC) & (operand != NO_NUMERIC)
    o = op[..., None]
    hit = f & in_set
    result = torch.where(
        o == SEL_OP_IN, hit,
        torch.where(
            o == SEL_OP_NOT_IN, ~hit,
            torch.where(
                o == SEL_OP_EXISTS, f,
                torch.where(
                    o == SEL_OP_DOES_NOT_EXIST, ~f,
                    torch.where(
                        o == SEL_OP_GT, numeric_ok & (x > operand),
                        (o == SEL_OP_LT) & numeric_ok & (x < operand),
                    ),
                ),
            ),
        ),
    )
    term_match = (result | ~expr_valid[..., None]).all(dim=-2)
    has_expr = expr_valid.any(dim=-1)
    return term_match, has_expr
