from k8s1m_tpu_torch.oracle.reference_scheduler import oracle_feasible, oracle_score

__all__ = ["oracle_feasible", "oracle_score"]
