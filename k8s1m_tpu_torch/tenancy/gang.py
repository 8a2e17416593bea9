"""Minimal gang scheduling: all-or-none pod groups riding one wave.

The port's own copy of ``k8s1m_tpu/tenancy/gang.py``.

A multi-pod job that binds half its pods and then waits holds capacity
hostage — two half-placed jobs can deadlock a full cluster forever.
The gang contract here is deliberately minimal and rides the existing
wave/epoch machinery instead of adding a second scheduler:

- A pod declares its gang with labels ``k8s1m.io/gang=<name>`` and
  ``k8s1m.io/gang-size=<N>`` (namespace-qualified id, so tenants never
  collide).  Gang pods carry labels, so they always take the full
  decode path — the label-less native fast lane is untouched.
- Members **stage** until all N are present, then enter the queue
  contiguously; ``_take_batch`` never splits a gang across a batch
  boundary, so the whole gang rides ONE device wave (N must fit the
  wave: oversize gangs degrade to plain scheduling, counted).
- At wave retire the gang settles **all-or-none inside the wave-epoch
  window**: every member bound -> admitted; any member failed (CAS
  conflict, no feasible row, tombstoned row) -> every provisional bind
  is evicted through the same CAS + dirty-row machinery preemption
  uses, and the gang requeues as a unit — partial capacity is never
  held across a quiesce, because settlement happens before the wave's
  retire returns.

State lives on the coordinator (cycle-thread-owned, ``THREAD_OWNER``
annotated); this module holds the shared helpers and the evidence
counter.
"""

from __future__ import annotations

from k8s1m_tpu_torch.obs.metrics import Counter
from k8s1m_tpu_torch.tenancy.policy import gang_of_labels  # noqa: F401  (re-export)

_GANGS = Counter(
    "gang_admit_total",
    "All-or-none pod-group settlements, by outcome: bound = every "
    "member bound in one wave; requeued = partial/failed wave, every "
    "provisional bind released and the gang re-staged; parked = retry "
    "budget exhausted, all members unschedulable; oversize = gang "
    "larger than a wave, degraded to plain scheduling",
    ("outcome",),
)


def note_gang(outcome: str) -> None:
    _GANGS.inc(outcome=outcome)
