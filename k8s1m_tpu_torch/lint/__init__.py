"""Runtime lock discipline for the port's shared state.

The port's own copy of the runtime half of ``k8s1m_tpu/lint``
(``lint/guards.py``): ``@guarded_by`` annotations on the overload
controller, the tenancy admission buckets and the coordinator, audited
under a test-only instrumentation mode that raises on any access without
the named lock held (or off the owning thread).  The static passes of
the JAX package's linter are not part of the port.
"""

from k8s1m_tpu_torch.lint.guards import (  # noqa: F401
    THREAD_OWNER,
    GuardViolation,
    audit,
    audit_enabled,
    disown,
    guarded_by,
    racy_read,
    set_owner,
    violations,
)
