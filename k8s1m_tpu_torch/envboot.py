"""Interpreter tuning for the port's long-running processes.

The port's own copy of ``tune_gc`` from ``k8s1m_tpu/envboot.py``.  The JAX
module's other helper, ``cleaned_cpu_env``, builds a JAX CPU-mesh
environment for a child interpreter; the port has no use for one.
"""

from __future__ import annotations

import gc


def tune_gc(gen0: int = 50_000, gen1: int = 50, gen2: int = 50) -> None:
    """Relax the cyclic-GC cadence for a serving hot loop.

    The reference deploys its Go scheduler fleet with GOGC≈700-1000 and a
    GOMEMLIMIT because collector pressure was a measured tail-latency and
    throughput cost at 14K pods/s (reference README.adoc:672-677,
    terraform/kubernetes/dist-scheduler.tf:220-228).  The CPython analogue:
    the coordinator's intake loop allocates hundreds of thousands of
    small, acyclic objects per second (event tuples, byte slices,
    PendingPods) while holding large long-lived dicts (_bound), so the
    default gen0 threshold of 700 fires the collector thousands of times
    a second and every gen2 pass rescans the bound-pod table.
    Refcounting reclaims the acyclic garbage either way; raising the
    thresholds keeps cycle collection for what actually needs it.

    Objects that survived startup never become garbage in steady state:
    freeze them out of the young generations entirely.
    """
    gc.collect()
    gc.freeze()
    gc.set_threshold(gen0, gen1, gen2)
