"""tenancy — multi-tenant fairness, preemption, gangs.

The port's own copy of ``k8s1m_tpu/tenancy``.

The admission→schedule→evict chain for thousands of tenants (ROADMAP
item 2): weighted-fair admission (tenancy/admission.py), priority
preemption with pure replayable victim selection (tenancy/preempt.py),
and minimal all-or-none gang scheduling (tenancy/gang.py), all wired
through ``Coordinator(tenancy=...)`` and the admission webhook.

``TenancyController`` is the one object call sites construct: it owns
the policy, the (possibly shared) loadshed HealthController, and the
FairAdmission bucket state.
"""

from __future__ import annotations

from k8s1m_tpu_torch.loadshed import HealthController, LoadshedConfig
from k8s1m_tpu_torch.tenancy.admission import FairAdmission
from k8s1m_tpu_torch.tenancy.policy import (
    GANG_LABEL,
    GANG_SIZE_LABEL,
    TENANT_LABEL,
    TenancyPolicy,
    gang_of_labels,
    tenant_of_key,
    tenant_of_namespace,
    tenant_of_obj,
    tenant_of_pod,
)
from k8s1m_tpu_torch.tenancy.preempt import (
    PreemptionChoice,
    Victim,
    select_preemption,
    victim_sort_key,
)

__all__ = [
    "FairAdmission",
    "GANG_LABEL",
    "GANG_SIZE_LABEL",
    "PreemptionChoice",
    "TENANT_LABEL",
    "TenancyController",
    "TenancyPolicy",
    "Victim",
    "gang_of_labels",
    "select_preemption",
    "tenant_of_key",
    "tenant_of_namespace",
    "tenant_of_obj",
    "tenant_of_pod",
    "victim_sort_key",
]


class TenancyController:
    """The tenancy subsystem as one constructor argument.

    ``Coordinator(tenancy=TenancyController(policy))`` is the whole
    opt-in.  When no HealthController is passed, one is built from
    ``loadshed_config`` and the coordinator adopts it as its loadshed
    controller too — one state machine drives both the degraded
    scheduling knobs and the per-tenant admission gates.
    """

    def __init__(
        self,
        policy: TenancyPolicy | None = None,
        controller: HealthController | None = None,
        *,
        loadshed_config: LoadshedConfig | None = None,
        capacity_per_tick: int = 256,
        name: str = "coordinator",
    ):
        self.policy = policy or TenancyPolicy()
        self.controller = controller or HealthController(
            loadshed_config, name=name
        )
        self.admission = FairAdmission(
            self.policy, self.controller, capacity_per_tick=capacity_per_tick
        )
