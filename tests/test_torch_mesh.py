"""The port's mesh selection, placement and metrics, against the JAX
package's on the CPU (twins of tests/test_mesh_differential.py:399-464),
and the port's entry points ``graft_entry.entry``/``dryrun_multichip``.

Mesh selection (``parse_mesh``, ``auto_mesh_shape``, ``K8S1M_MESH``,
``resolve_mesh``) gives the JAX answers on the same inputs.  Where they
differ by design: the port's ``make_mesh`` takes more cells than devices
(round-robin, several shards per card), and ``auto`` counts the visible
cards of the requested device — one host device on the CPU, so it falls
back to a single device where the JAX test's 8 virtual devices split.
Tolerance: exact equality.
"""

import _torch_cpu  # noqa: F401  (bounds torch's CPU threads first)

import logging

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as jax_entry
from k8s1m_tpu.parallel import auto_mesh_shape as jax_auto
from k8s1m_tpu.parallel import parse_mesh as jax_parse
from k8s1m_tpu.parallel import resolve_mesh as jax_resolve
from k8s1m_tpu_torch import graft_entry
from k8s1m_tpu_torch import parallel as tpar
from k8s1m_tpu_torch.config import PodSpec, TableSpec
from k8s1m_tpu_torch.control.coordinator import Coordinator
from k8s1m_tpu_torch.obs.metrics import REGISTRY
from k8s1m_tpu_torch.plugins.registry import Profile
from k8s1m_tpu_torch.snapshot.constraints import FIELDS as CONS_FIELDS
from k8s1m_tpu_torch.store.native import MemStore

from test_torch_mesh_coordinator import fleet

PROFILE = Profile(topology_spread=0, interpod_affinity=0)
SMALL = TableSpec(max_nodes=128, max_zones=16, max_regions=8)
SMALL_PODS = PodSpec(batch=32)


@pytest.mark.parametrize("spec", [None, "none", "", "off", "0", "auto", "2x4", "2,4", "1X8",
                                  " 4x2 "])
def test_parse_mesh_forms(spec):
    assert tpar.parse_mesh(spec) == jax_parse(spec)


@pytest.mark.parametrize("bad", ["8", "0x4", "2x0", "ax4"])
def test_parse_mesh_rejects(bad):
    with pytest.raises(ValueError) as got:
        tpar.parse_mesh(bad)
    with pytest.raises(ValueError) as want:
        jax_parse(bad)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("n,batch,nodes,chunk", [
    (8, 64, 4096, 512), (8, 64, 4096, 1024), (8, 63, 4096, 512), (8, 63, 4095, 512),
    (1, 64, 4096, 512), (4, 4096, 1 << 20, 4096), (6, 96, 6144, 256),
])
def test_auto_mesh_shape_matches_jax(n, batch, nodes, chunk):
    got = tpar.auto_mesh_shape(n, batch=batch, max_nodes=nodes, chunk=chunk)
    assert got == jax_auto(n, batch=batch, max_nodes=nodes, chunk=chunk)


def test_resolve_mesh_auto_falls_back_single_device(caplog):
    """One host device gives no split, as the JAX auto does on one device;
    the fallback says why in the JAX log line."""
    with caplog.at_level(logging.INFO, logger="k8s1m.mesh"):
        assert tpar.resolve_mesh("auto", batch=64, max_nodes=4096, chunk=512,
                                 device="cpu") is None
    assert "running single-device" in caplog.text
    assert jax_resolve("auto", batch=64, max_nodes=4095, chunk=512) is None
    assert tpar.resolve_mesh("auto", batch=64, max_nodes=4095, chunk=512,
                             device="cpu") is None
    assert tpar.resolve_mesh(None, batch=64, max_nodes=4096, chunk=512, env={},
                             device="cpu") is None
    m = tpar.resolve_mesh(None, batch=64, max_nodes=4096, chunk=512,
                          env={"K8S1M_MESH": "2x2"}, device="cpu")
    assert m.shape == {"dp": 2, "sp": 2}
    assert tpar.resolve_mesh(m, batch=64, max_nodes=4096, chunk=512) is m
    with pytest.raises(TypeError):
        tpar.resolve_mesh(object(), batch=64, max_nodes=4096, chunk=512)


def test_coordinator_mesh_from_env(monkeypatch):
    monkeypatch.setenv("K8S1M_MESH", "2x4")
    with MemStore() as store:
        c = Coordinator(store, SMALL, SMALL_PODS, PROFILE, chunk=16, k=4,
                        with_constraints=False, device="cpu")
        assert c.mesh is not None and c.mesh.shape == {"dp": 2, "sp": 4}
        c.close()
    monkeypatch.setenv("K8S1M_MESH", "none")
    with MemStore() as store:
        c = Coordinator(store, SMALL, SMALL_PODS, PROFILE, chunk=16, k=4,
                        with_constraints=False, device="cpu")
        assert c.mesh is None
        c.close()


def test_coordinator_mesh_auto_string_on_one_device():
    with MemStore() as store:
        c = Coordinator(store, SMALL, SMALL_PODS, PROFILE, chunk=16, k=4,
                        with_constraints=False, mesh="auto", device="cpu")
        assert c.mesh is None
        c.close()


def test_several_shards_on_one_device():
    """A 2x4 mesh over one device: 8 cells, 4 storages (one per sp shard,
    shared by both dp ranks), one zone/region owner; over two devices the
    cells alternate and every (shard, device) pair is its own storage."""
    m = tpar.make_mesh(2, 4, device="cpu")
    assert m.shape == {"dp": 2, "sp": 4} and len(m.cells()) == 8
    assert [s for s, _ in m.storages] == [0, 1, 2, 3]
    assert m.domain_owner == (True, False, False, False)
    assert m.storage_index(0, 2) == m.storage_index(1, 2) == 2
    two = tpar.make_mesh(2, 2, devices=["cpu", "meta"])
    assert [str(two.device(d, s)) for d in range(2) for s in range(2)] == [
        "cpu", "meta", "cpu", "meta"]
    assert len(two.storages) == 2                 # shard 0 on cpu, shard 1 on meta
    three = tpar.make_mesh(1, 3, devices=["cpu", "meta"])
    assert three.storages == ((0, torch.device("cpu")), (1, torch.device("meta")),
                              (2, torch.device("cpu")))
    assert three.domain_owner == (True, True, False)
    with pytest.raises(ValueError):
        tpar.make_mesh(0, 4, device="cpu")
    # A table and its count tables cut onto the mesh and gathered back.
    from k8s1m_tpu_torch.cluster import populate_kwok_nodes
    from k8s1m_tpu_torch.snapshot.constraints import empty_constraints
    from k8s1m_tpu_torch.snapshot.node_table import NodeTableHost

    host = NodeTableHost(SMALL)
    populate_kwok_nodes(host, 100, zones=8, regions=4)
    full = host.to_device("cpu")
    st = tpar.shard_table(full, m)
    assert st.num_rows == 128 and st.rows_per_shard == 32 and st.part(1, 3) is st.part(0, 3)
    back = st.gather()
    for f in ("valid", "cpu_alloc", "label_key", "zone", "name_id"):
        assert torch.equal(getattr(back, f), getattr(full, f))
    assert st.parts[0].cpu_alloc.data_ptr() != full.cpu_alloc.data_ptr()
    cons = empty_constraints(SMALL, "cpu")
    cons.spread_node[:, 40] = 3
    cons.tgt_zone[:, 2] = 5
    sc = tpar.shard_constraints(cons, m)
    g = sc.gather()
    for f in CONS_FIELDS:
        assert torch.equal(getattr(g, f), getattr(cons, f)), f
    clone = sc.clone()
    assert clone.parts[0].tgt_zone is clone.parts[3].tgt_zone
    assert clone.parts[0].tgt_zone is not sc.parts[0].tgt_zone


def test_mesh_metrics_registered_and_live():
    """Twin of test_mesh_differential.py:446."""
    with MemStore() as store:
        c = Coordinator(store, SMALL, SMALL_PODS, PROFILE, chunk=16, k=4,
                        with_constraints=False, mesh=tpar.make_mesh(2, 4, device="cpu"),
                        device="cpu")
        g = REGISTRY.get("mesh_devices")
        assert g.value(axis="dp") >= 2 and g.value(axis="sp") >= 4
        c.bootstrap()
        store.put_batch(fleet(1))
        c.step()                                   # node add -> full scatter
        assert REGISTRY.get("mesh_sharded_scatter_total").value(cols="full") >= 1
        assert REGISTRY.get("mesh_feed_staged_depth").value() >= 0
        text = REGISTRY.render()
        for name in ("mesh_devices", "mesh_sharded_scatter_total", "mesh_feed_staged_depth"):
            assert text.count(f"# TYPE {name} ") == 1, name
        c.close()


# ---- the entry points -----------------------------------------------------------


def test_entry_matches_jax_entry():
    """``graft_entry.entry`` on the CPU: the JAX root entry's wave (16,384
    nodes, 256 constrained pods, the full profile) byte for byte."""
    fn, args = graft_entry.entry(device="cpu")
    table, cons, asg = fn(*args)
    jfn, jargs = jax_entry.entry()
    jt, jc, jasg = jax.jit(jfn)(*jargs)
    assert int(asg.bound.sum()) == int(np.asarray(jasg.bound).sum()) > 0
    for f in ("node_row", "bound", "score"):
        np.testing.assert_array_equal(getattr(asg, f).numpy(), np.asarray(getattr(jasg, f)))
    np.testing.assert_array_equal(table.pods_req.numpy(), np.asarray(jt.pods_req))
    for f in CONS_FIELDS:
        np.testing.assert_array_equal(getattr(cons, f).numpy(), np.asarray(getattr(jc, f)))


@pytest.mark.parametrize("shards", [4, 3])
def test_dryrun_multichip_on_cpu(shards):
    out = graft_entry.dryrun_multichip(shards, device="cpu")
    dp = 2 if shards % 2 == 0 else 1
    assert (out["dp"], out["sp"]) == (dp, shards // dp)
    assert out["base_bound"] == out["constrained_bound"] == 4 * dp
    assert out["e2e_bound"] == 3 * 4 * dp + 1
