"""Multi-process deployment of the sharded scheduling wave.

Port of ``k8s1m_tpu/parallel/multihost.py``.  The reference scales by
adding scheduler VMs — 289 replicas coordinated through gRPC relay trees
and EndpointSlices (reference SURVEY.md §2.5-2.6).  Here each host process
drives its local cards, ``torch.distributed`` links the processes, and the
mesh IS the membership, fixed at initialization.

Axis placement (the JAX module's recipe): ``dp`` (pod batch) goes across
processes and ``sp`` (node-table rows) over each process's local shards,
so the node table — the only large resident — never crosses hosts: every
process holds all sp shards of its own dp row.  Per wave the only traffic
between processes is one all-gather of the dp ranks' candidate lists,
O(batch x k) records; every process then runs the greedy scan on the same
inputs and commits into its own shards.

Usage, one process per host:

    from k8s1m_tpu_torch.parallel import multihost
    multihost.initialize("10.0.0.1:29500", num_processes, process_id)
    mesh = multihost.make_global_mesh()          # dp=processes, sp=local shards
    table = multihost.shard_table_to_mesh(host, mesh)
    step = make_sharded_step(mesh, profile, chunk=..., k=...)

Nothing on a host tells a program of its cluster: the launcher passes the
address, the world size and the rank.  ``graft_entry.dryrun_multichip``
runs the single-process shape of this path in process.
"""

from __future__ import annotations

import logging

import torch

from k8s1m_tpu_torch.device import resolve_device
from k8s1m_tpu_torch.parallel.mesh import Mesh, shard_table, visible_devices

log = logging.getLogger("k8s1m.multihost")


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    device: str | torch.device = "cuda",
) -> None:
    """``torch.distributed`` bootstrap: NCCL for ``cuda``, gloo for
    ``cpu``, over ``tcp://<coordinator_address>``.  Every process calls
    this before its first wave.  Only an explicit ``num_processes=1``
    skips it (single-process rigs and tests); silently skipping on
    missing arguments would leave each host running an independent
    scheduler over its own table copy, so they raise instead."""
    if num_processes == 1:
        log.info("single-process: skipping torch.distributed")
        return
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError(
            "multihost.initialize needs coordinator_address, num_processes and "
            "process_id (nothing on the host names its cluster)"
        )
    import torch.distributed as dist

    backend = "nccl" if resolve_device(device).type == "cuda" else "gloo"
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
    )


def _world() -> tuple[int, int]:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def make_global_mesh(dp: int | None = None, sp: int | None = None, *,
                     local_shards: int | None = None,
                     device: str | torch.device = "cuda") -> Mesh:
    """The mesh over every process: by default ``dp`` = processes and
    ``sp`` = ``local_shards`` (default: this process's visible cards), so
    only the O(batch) candidate gather crosses processes.  This process
    holds dp row ``rank``, its sp cells round-robin over its cards.  With
    one process, an explicit ``dp`` (or ``sp``) reshapes the
    ``local_shards`` cells; across processes each must hold one whole dp
    row, so ``dp`` must equal the process count."""
    processes, rank = _world()
    devices = visible_devices(device)
    local = local_shards if local_shards is not None else len(devices)
    total = processes * local
    if dp is None and sp is None:
        dp, sp = processes, local
    elif sp is None:
        sp = total // dp
    elif dp is None:
        dp = total // sp
    if dp * sp != total:
        raise ValueError(f"mesh {dp}x{sp} != {total} global shards")
    if processes > 1 and dp != processes:
        raise ValueError(
            f"across {processes} processes the mesh needs dp={processes} "
            f"(one dp row per process), got {dp}x{sp}"
        )
    cells = [devices[i % len(devices)] for i in range(dp * sp)]
    if processes == 1:
        return Mesh([cells[d * sp:(d + 1) * sp] for d in range(dp)])
    rows = [[None] * sp for _ in range(dp)]
    rows[rank] = cells[:sp]
    return Mesh(rows, rank=rank, processes=processes)


def shard_table_to_mesh(host, mesh: Mesh):
    """A NodeTableHost's plain-layout table with rows split over sp: each
    process builds only its own storages' shards."""
    return shard_table(host.to_device("cpu"), mesh)
