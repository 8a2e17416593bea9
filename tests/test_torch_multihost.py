"""The port's multi-process mesh: two gloo processes of four shards each
against one process (twin of tests/test_multihost.py:100), and the
single-process helpers (twins of tests/test_obs_multihost.py:40,65).

Each child runs this file as a script: it joins a ``torch.distributed``
gloo group over ``tcp://127.0.0.1:<free port>`` (``multihost.initialize``),
builds the global dp=2 x sp=4 mesh (it holds dp row ``rank``), runs one
sharded step over a 64-node table and prints the digest of the bound flags
and rows.  The cross-process candidate gather is the only traffic; both
children must print the digest of the single-process 2x4 step — the port's
and the JAX package's alike.  The children import neither JAX nor the JAX
package.  Tolerance: exact equality (sha256 of the bytes).
"""

from __future__ import annotations

import _torch_cpu  # noqa: F401  (bounds torch's CPU threads first)

import argparse
import hashlib
import json
import os
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHUNK, NODES, BATCH = 8, 4 * 2 * 8, 8


def _port_world():
    """The port's host state of the JAX reference (same generator)."""
    from k8s1m_tpu_torch.cluster import populate_kwok_nodes, uniform_pods
    from k8s1m_tpu_torch.config import PodSpec, TableSpec
    from k8s1m_tpu_torch.snapshot.node_table import NodeTableHost
    from k8s1m_tpu_torch.snapshot.pod_encoding import PodBatchHost

    spec = TableSpec(max_nodes=NODES, max_zones=16, max_regions=8)
    host = NodeTableHost(spec)
    populate_kwok_nodes(host, NODES, zones=8, regions=4)
    batch = PodBatchHost(PodSpec(batch=BATCH), spec, host.vocab).encode(
        uniform_pods(BATCH), device="cpu")
    return host, batch


def _port_step(mesh):
    from k8s1m_tpu_torch.ops.priority import prng_key, seed_of
    from k8s1m_tpu_torch.parallel import make_sharded_step, multihost
    from k8s1m_tpu_torch.plugins.registry import Profile

    host, batch = _port_world()
    table = multihost.shard_table_to_mesh(host, mesh)
    step = make_sharded_step(mesh, Profile(topology_spread=0, interpod_affinity=0),
                             chunk=CHUNK, k=2)
    table, _, asg = step(table, batch, seed_of(prng_key(0)))
    digest = hashlib.sha256(asg.bound.numpy().tobytes() + asg.node_row.numpy().tobytes())
    return {"digest": digest.hexdigest(), "bound": int(asg.bound.sum()),
            "pods_req": table.gather().pods_req.tolist()}


def _child(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--addr", required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    from k8s1m_tpu_torch.parallel import multihost

    multihost.initialize(args.addr, args.num_processes, args.process_id, device="cpu")
    mesh = multihost.make_global_mesh(local_shards=4, device="cpu")
    out = _port_step(mesh)
    out.update(dp=mesh.shape["dp"], sp=mesh.shape["sp"], rank=mesh.rank,
               local=len(mesh.cells()),
               jax_loaded=any(m == "jax" or m.startswith(("jax.", "k8s1m_tpu."))
                              for m in sys.modules))
    import torch.distributed as dist

    dist.destroy_process_group()
    print(json.dumps(out))
    return 0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jax_reference_digest():
    import jax
    import numpy as np

    from k8s1m_tpu.cluster import populate_kwok_nodes, uniform_pods
    from k8s1m_tpu.config import PodSpec, TableSpec
    from k8s1m_tpu.parallel import make_mesh, make_sharded_step
    from k8s1m_tpu.plugins.registry import Profile
    from k8s1m_tpu.snapshot import NodeTableHost, PodBatchHost

    spec = TableSpec(max_nodes=NODES, max_zones=16, max_regions=8)
    host = NodeTableHost(spec)
    populate_kwok_nodes(host, NODES, zones=8, regions=4)
    pods = PodBatchHost(PodSpec(batch=BATCH), spec, host.vocab).encode(uniform_pods(BATCH))
    step = make_sharded_step(make_mesh(dp=2, sp=4),
                             Profile(topology_spread=0, interpod_affinity=0), chunk=CHUNK, k=2)
    _t, _, asg = step(host.to_device(), pods, jax.random.key(0))
    return hashlib.sha256(np.asarray(asg.bound).tobytes()
                          + np.asarray(asg.node_row).tobytes()).hexdigest()


def test_two_process_gloo_step_matches_single_process():
    from k8s1m_tpu_torch.parallel import make_mesh

    single = _port_step(make_mesh(2, 4, device="cpu"))
    assert single["bound"] == BATCH
    assert single["digest"] == _jax_reference_digest()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = REPO + (":" + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    addr = f"127.0.0.1:{_free_port()}"
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--addr", addr,
             "--num-processes", "2", "--process-id", str(i)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO)
        for i in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=240)
            assert p.returncode == 0, f"child failed:\n{err[-4000:]}"
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, doc in enumerate(outs):
        assert (doc["dp"], doc["sp"], doc["rank"], doc["local"]) == (2, 4, rank, 4), doc
        assert not doc["jax_loaded"]
        assert doc["digest"] == single["digest"], doc
        # Each process holds every sp shard of its dp row: the whole table.
        assert doc["pods_req"] == single["pods_req"]


def test_multihost_single_process_mesh_and_step():
    """Twin of tests/test_obs_multihost.py:40."""
    from k8s1m_tpu_torch.parallel import multihost

    multihost.initialize(num_processes=1, device="cpu")     # explicit: no group
    mesh = multihost.make_global_mesh(local_shards=8, device="cpu")
    assert mesh.shape == {"dp": 1, "sp": 8} and mesh.processes == 1
    out = _port_step(mesh)
    assert out["bound"] == BATCH


def test_global_mesh_explicit_shape():
    """Twin of tests/test_obs_multihost.py:65."""
    import pytest

    from k8s1m_tpu_torch.parallel import multihost

    mesh = multihost.make_global_mesh(dp=2, local_shards=8, device="cpu")
    assert mesh.shape == {"dp": 2, "sp": 4}
    assert multihost.make_global_mesh(sp=2, local_shards=8, device="cpu").shape == {
        "dp": 4, "sp": 2}
    with pytest.raises(ValueError):
        multihost.make_global_mesh(dp=3, local_shards=8, device="cpu")
    with pytest.raises(ValueError):
        multihost.initialize(num_processes=2, device="cpu")


if __name__ == "__main__":
    raise SystemExit(_child(sys.argv[1:]))
