"""The coordinator's retry/backoff policy (``policy.py``)."""

from k8s1m_tpu_torch.faultline.policy import (
    RetryPolicy,
    note_give_up,
    note_retry,
    policy_for,
)

__all__ = [
    "RetryPolicy",
    "note_give_up",
    "note_retry",
    "policy_for",
]
