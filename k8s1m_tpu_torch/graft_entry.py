"""Entry points of the port: one constrained step, and the multi-shard dry run.

The port's twin of the repository's root ``__graft_entry__.py`` (which
stays the JAX package's).  ``entry()`` returns ``(fn, args)``: one
scheduling wave of the FULL default profile with live constraint state at
the JAX entry's shapes (16,384 nodes, 256 pods: half carry a zone spread
constraint, half a required hostname anti-affinity), run by calling
``fn(*args)``.  ``dryrun_multichip(n)`` runs the sharded wave over an
n-shard mesh at tiny shapes, in process: a base step, a constrained step
over sharded count tables, then the coordinator's loop (store -> watch ->
sharded wave -> CAS bind -> delete -> sharded dirty-row scatter).  Both
run on the card unless the caller passes ``device="cpu"``; several shards
may share one card.

    python -m k8s1m_tpu_torch.graft_entry [--device cpu] [--shards 4]
"""

from __future__ import annotations

import argparse
import json

import torch

from k8s1m_tpu_torch.cluster import (
    affinity_deployment,
    populate_kwok_nodes,
    spread_deployment,
    uniform_pods,
)
from k8s1m_tpu_torch.config import PodSpec, TableSpec
from k8s1m_tpu_torch.device import resolve_device
from k8s1m_tpu_torch.engine.cycle import schedule_batch
from k8s1m_tpu_torch.ops.priority import prng_key, seed_of
from k8s1m_tpu_torch.parallel import make_mesh, make_sharded_step
from k8s1m_tpu_torch.plugins.registry import Profile
from k8s1m_tpu_torch.snapshot.constraints import ConstraintTracker, empty_constraints
from k8s1m_tpu_torch.snapshot.node_table import NodeTableHost
from k8s1m_tpu_torch.snapshot.pod_encoding import PodBatchHost

_PROFILE = Profile(topology_spread=0, interpod_affinity=0)


def entry(device: str | torch.device = "cuda"):
    """(fn, args): one constrained wave on ``device``; ``fn(*args)``
    returns (table, constraints, Assignment) and commits in place."""
    dev = resolve_device(device)
    spec = TableSpec(max_nodes=1 << 14, max_zones=16, max_regions=8)
    host = NodeTableHost(spec)
    populate_kwok_nodes(host, 1 << 14, zones=8, regions=4)
    tracker = ConstraintTracker(spec)
    pods = (spread_deployment(tracker, "entry-spread", 128, topo=1)
            + affinity_deployment(tracker, "entry-anti", 128, anti=True))
    batch = PodBatchHost(PodSpec(batch=256), spec, host.vocab).encode(pods, device=dev)
    profile = Profile()     # the full default plugin set

    def fn(table, batch, constraints, seed):
        return schedule_batch(table, batch, seed, profile=profile, constraints=constraints,
                              chunk=1 << 12, k=4)

    return fn, (host.to_device(dev), batch, empty_constraints(spec, dev),
                seed_of(prng_key(0)))


def dryrun_multichip(n_devices: int, device: str | torch.device = "cuda") -> dict:
    """One sharded wave over an ``n_devices``-shard mesh (dp = 2 when
    ``n_devices`` is even) at tiny shapes, then the constrained wave and
    the coordinator's loop over the same mesh.  Returns a summary; raises
    when a check fails."""
    from k8s1m_tpu_torch.control.coordinator import Coordinator
    from k8s1m_tpu_torch.control.objects import encode_node, encode_pod, node_key, pod_key
    from k8s1m_tpu_torch.snapshot.records import NodeInfo, PodInfo
    from k8s1m_tpu_torch.store.native import MemStore

    dev = resolve_device(device)
    dp = 2 if n_devices % 2 == 0 else 1
    sp = n_devices // dp
    chunk = 8
    num_nodes = sp * 2 * chunk
    batch = 4 * dp
    spec = TableSpec(max_nodes=num_nodes, max_zones=16, max_regions=8)
    host = NodeTableHost(spec)
    populate_kwok_nodes(host, num_nodes, zones=8, regions=4)
    enc = PodBatchHost(PodSpec(batch=batch), spec, host.vocab)
    mesh = make_mesh(dp, sp, device=dev)

    table, _, asg = make_sharded_step(mesh, _PROFILE, chunk=chunk, k=2)(
        host.to_device(dev), enc.encode(uniform_pods(batch), device=dev), seed_of(prng_key(0)))
    bound = int(asg.bound.sum())
    if bound != batch or int(table.gather().pods_req.sum()) != batch:
        raise RuntimeError(f"base step bound {bound}/{batch}")

    tracker = ConstraintTracker(spec)
    cpods = (spread_deployment(tracker, "dry-spread", batch // 2, topo=1)
             + affinity_deployment(tracker, "dry-anti", batch - batch // 2, anti=True))
    table, cons, asg2 = make_sharded_step(mesh, Profile(), chunk=chunk, k=2)(
        table, enc.encode(cpods, device=dev), seed_of(prng_key(1)), empty_constraints(spec, dev))
    cbound = int(asg2.bound.sum())
    full = cons.gather()
    if cbound != batch or int(full.spread_node.sum()) + int(full.spread_zone.sum()) == 0:
        raise RuntimeError(f"constrained step bound {cbound}/{batch}")

    with MemStore() as store:
        for i in range(num_nodes):
            store.put(node_key(f"n{i}"), encode_node(NodeInfo(
                name=f"n{i}", cpu_milli=4000, mem_kib=8 << 20, pods=16,
                labels={"topology.kubernetes.io/zone": f"z{i % 4}"})))
        n_pods = 3 * batch + 1      # several waves, one ragged
        for i in range(n_pods):
            store.put(pod_key("default", f"e2e-{i}"), encode_pod(
                PodInfo(f"e2e-{i}", namespace="default", cpu_milli=10, mem_kib=1024)))
        coord = Coordinator(store, spec, PodSpec(batch=batch), _PROFILE, chunk=chunk, k=2,
                            with_constraints=True, mesh=mesh, score_pct=50, pipeline=True,
                            device=dev)
        try:
            coord.bootstrap()
            e2e = coord.run_until_idle()
            if e2e != n_pods:
                raise RuntimeError(f"e2e mesh loop bound {e2e}/{n_pods}")
            if not json.loads(store.get(pod_key("default", "e2e-0")).value)["spec"].get(
                    "nodeName"):
                raise RuntimeError("bind did not reach the store")
            store.delete(pod_key("default", "e2e-0"))
            coord.run_until_idle()      # delete -> sharded dirty-row scatter
            if int(coord.host.pods_req.sum()) != n_pods - 1:
                raise RuntimeError("the delete did not free its row")
        finally:
            coord.close()
    return {"dp": dp, "sp": sp, "nodes": num_nodes, "base_bound": bound,
            "constrained_bound": cbound, "e2e_bound": e2e, "device": str(dev)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--shards", type=int, default=4)
    args = ap.parse_args(argv)
    fn, fargs = entry(args.device)
    _t, _c, asg = fn(*fargs)
    print(json.dumps({"entry_bound": int(asg.bound.sum()),
                      "dryrun": dryrun_multichip(args.shards, args.device)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
