"""Metrics, tracing and profiling of the port (a registry of its own)."""

from k8s1m_tpu_torch.obs.metrics import (  # noqa: F401
    REGISTRY,
    AlertingHistogram,
    CallbackMetric,
    Counter,
    Gauge,
    Histogram,
    Registry,
)
