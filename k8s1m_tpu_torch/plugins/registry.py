"""Plugin profile and the plain filter+score pass.

Port of ``k8s1m_tpu/plugins/registry.py``: ``Profile`` (upstream default
weights; 0 disables a plugin), ``default_profile``, ``degraded_profile``
(the overload mode's plugin set) and ``score_and_filter``, the JAX
package's XLA-path filter+score over one node chunk — what the deltasched
planes hold (``engine/deltacache.py``).
"""

from __future__ import annotations

import dataclasses

import torch

from k8s1m_tpu_torch.ops.label_match import resolve_query_keys
from k8s1m_tpu_torch.plugins import filters, scores, topology


@dataclasses.dataclass(frozen=True)
class Profile:
    """Score weights (upstream defaults); integers like upstream's plugin
    weights, since fractions would truncate in the int32 score sum."""

    least_allocated: int = 1
    balanced_allocation: int = 1
    taint_toleration: int = 3
    node_affinity: int = 2
    topology_spread: int = 2
    interpod_affinity: int = 2

    def __post_init__(self):
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if not isinstance(v, int) or v < 0:
                raise ValueError(
                    f"Profile.{f.name} must be a non-negative int, got {v!r}"
                )


def default_profile() -> Profile:
    return Profile()


def degraded_profile(profile: Profile) -> Profile:
    """``profile`` with the constraint *scoring* dropped: PodTopologySpread
    and InterPodAffinity become filter-only (their hard constraints still
    mask).  The overload degraded mode's plugin set (``loadshed/``):
    placement quality is traded for cycle time, feasibility never is."""
    return dataclasses.replace(profile, topology_spread=0, interpod_affinity=0)


def score_and_filter(table, batch, profile: Profile, constraints=None, stats=None,
                     groups=None):
    """One pass over a plain-layout node chunk: (mask bool[B, N], score
    i32[B, N]).

    ``constraints`` is the ConstraintState chunk for topology spread and
    inter-pod affinity (with ``stats`` the batch prologue); None disables
    those plugins.  ``groups`` are the packed batch's field groups (None:
    all present); an absent group's plugin is skipped, which gives the
    same mask and score."""
    resolved = resolve_query_keys(
        table.label_key, table.label_val, table.label_num, batch.qkey
    )
    mask = filters.feasible_mask(table, batch, resolved, groups)

    # Each plugin emits [0, 100], floored to an integer before weighting.
    def w(weight, s):
        return torch.floor(s).to(torch.int32) * int(weight)

    score = torch.zeros(mask.shape, dtype=torch.int32, device=mask.device)
    if profile.least_allocated:
        score += w(profile.least_allocated, scores.least_allocated(table, batch))
    if profile.balanced_allocation:
        score += w(profile.balanced_allocation, scores.balanced_allocation(table, batch))
    if profile.taint_toleration:
        score += w(profile.taint_toleration, scores.taint_toleration(table, batch))
    if profile.node_affinity and not filters.absent(groups, "pref"):
        score += w(profile.node_affinity, scores.node_affinity_score(batch, resolved))
    if constraints is not None:
        tmask, tscore = topology.filter_and_score(
            table, batch, constraints, stats,
            profile.topology_spread, profile.interpod_affinity,
        )
        mask = mask & tmask
        score += tscore
    return mask, score
