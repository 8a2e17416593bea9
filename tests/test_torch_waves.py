"""Whole scheduling waves of the port vs the JAX package, with the
NodeAffinity and constraint stages.

Three consecutive ``schedule_batch_packed`` waves over a rotating sample
window, against ``k8s1m_tpu.engine.cycle.schedule_batch_packed`` on the
Pallas path (interpret mode) and the XLA path, both table layouts, for
- an affinity wave (``node_affinity_pods``: required In/NotIn terms and a
  preferred term, BASELINE config 2's shape),
- a constrained wave (zone spread + required hostname anti-affinity,
  configs 3-4), the count tables carried from wave to wave,
- a mixed wave (spread, affinity, anti-affinity and preferred terms, plus
  NodeAffinity terms on the same pods: both kernel stages at once).
Bound rows, ``Assignment``, the request columns and all nine count tables
must be identical.  The port takes the i32 seed the JAX step derives from
its key (``seed_of``).  Tolerance: exact equality.
"""

import _torch_cpu  # noqa: F401  (bounds torch's CPU threads first)

import dataclasses

import jax
import numpy as np
import pytest
import torch

from k8s1m_tpu.cluster import populate_kwok_nodes as jax_populate
from k8s1m_tpu.cluster.workload import affinity_deployment, node_affinity_pods, spread_deployment
from k8s1m_tpu.config import TOPO_ZONE, PodSpec, TableSpec
from k8s1m_tpu.engine.cycle import schedule_batch_packed as jax_schedule
from k8s1m_tpu.ops.priority import seed_of
from k8s1m_tpu.plugins.registry import Profile as JaxProfile
from k8s1m_tpu.snapshot import constraints as jcons
from k8s1m_tpu.snapshot import node_table as jnt
from k8s1m_tpu.snapshot import packing as jpk
from k8s1m_tpu.snapshot import pod_encoding as jpe
from k8s1m_tpu_torch import interop
from k8s1m_tpu_torch.cluster.testbeds import constraint_pods
from k8s1m_tpu_torch.config import TableSpec as PortTableSpec
from k8s1m_tpu_torch.engine.cycle import (
    sample_offset_for,
    sample_rows_for,
    schedule_batch_packed,
)
from k8s1m_tpu_torch.plugins.registry import Profile
from k8s1m_tpu_torch.snapshot import constraints as tcons
from k8s1m_tpu_torch.snapshot.constraints import FIELDS

WAVE_N = 512
WAVE_CHUNK = 64
WAVE_B = 48
ZONES, REGIONS = 8, 3


def _to_jax(x):
    """A port PodInfo (and its nested terms) rebuilt with the JAX classes."""
    if isinstance(x, list):
        return [_to_jax(y) for y in x]
    if isinstance(x, tuple):
        return tuple(_to_jax(y) for y in x)
    if dataclasses.is_dataclass(x):
        cls = getattr(jpe, type(x).__name__)
        return cls(**{f.name: _to_jax(getattr(x, f.name)) for f in dataclasses.fields(x)})
    return x


def _state(kind, layout):
    """JAX-package state: a KWOK fleet tight enough that pods collide, the
    wave's pod batch, its profiles and (constrained kinds) empty counts."""
    spec = TableSpec(max_nodes=WAVE_N, max_zones=16, max_regions=8, spread_slots=8,
                     affinity_slots=8)
    host = jnt.NodeTableHost(spec)
    jax_populate(host, WAVE_N - 16, zones=ZONES, regions=REGIONS, seed=3)
    rng = np.random.default_rng(1)
    host.cpu_alloc[:] = np.where(host.valid, rng.integers(250, 1000, WAVE_N), 0)
    host.pods_alloc[:] = np.where(host.valid, rng.integers(1, 4, WAVE_N), 0)
    if kind == "affinity":
        pods = node_affinity_pods(WAVE_B - 4, zones=ZONES, regions=REGIONS, cpu_milli=200)
        dims = dict(aff_terms=1, aff_exprs=2, aff_values=2, pref_terms=1)
        profiles = (JaxProfile(topology_spread=0, interpod_affinity=0),
                    Profile(topology_spread=0, interpod_affinity=0))
    elif kind == "constrained":
        tracker = jcons.ConstraintTracker(spec)
        half = WAVE_B // 2
        pods = (spread_deployment(tracker, "bench-spread", half, topo=TOPO_ZONE, cpu_milli=200)
                + affinity_deployment(tracker, "bench-anti", WAVE_B - half - 4, anti=True,
                                      cpu_milli=200))
        dims = dict(spread_refs=1, affinity_refs=1, spread_incs=1, ipa_incs=1)
        profiles = JaxProfile(), Profile()
    else:
        tracker = tcons.ConstraintTracker(PortTableSpec(**dataclasses.asdict(spec)))
        pods = _to_jax(constraint_pods(tracker, WAVE_B - 3, seed=5, with_selectors=True))
        dims = dict(aff_terms=1, aff_exprs=2, aff_values=2, pref_terms=1)
        profiles = JaxProfile(), Profile()
    pb = jpe.PodBatchHost(PodSpec(batch=WAVE_B, **dims), spec, host.vocab).encode_packed(pods)
    jt = (host.to_device() if layout == "plain"
          else jpk.pack_table_host(host, jpk.build_packing_spec(spec, host.vocab)))
    jc = None if kind == "affinity" else jcons.empty_constraints(spec)
    return jt, pb, jc, profiles


@pytest.mark.parametrize("kind", ["affinity", "constrained", "mixed"])
@pytest.mark.parametrize("layout", ["plain", "packed"])
@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_wave_matches_jax(kind, layout, backend):
    jt, pb, jc, (jprof, prof) = _state(kind, layout)
    assert bool(pb.groups & {"sel", "req", "pref"}) == (kind != "constrained")
    cols = {f.name: np.asarray(getattr(jt, f.name)) for f in dataclasses.fields(jt)
            if f.name != "spec"}
    table = interop.node_table_from_numpy(cols, getattr(jt, "spec", None), "cpu")
    packed = interop.packed_pod_batch(pb.ints, pb.bools, pb.spec, pb.table_spec, pb.groups)
    cons = None if jc is None else interop.constraints_from_numpy(
        {f: np.asarray(getattr(jc, f)) for f in FIELDS}, "cpu")
    rows_s = sample_rows_for(WAVE_N, 25, WAVE_CHUNK)
    keys = jax.random.split(jax.random.key(7), 3)
    packed_valid = torch.from_numpy(pb.bools[:WAVE_B].copy())   # PodBatch.valid comes first
    unbound = 0
    for i in range(3):
        off = sample_offset_for(i, WAVE_N, rows_s)
        jt, jc, jasg, jrows = jax_schedule(
            jt, pb, keys[i], profile=jprof, constraints=jc, chunk=WAVE_CHUNK, k=4,
            backend=backend, sample_rows=rows_s, sample_offset=off,
        )
        table, asg, rows = schedule_batch_packed(
            table, packed, int(np.asarray(seed_of(keys[i]))), profile=prof, constraints=cons,
            chunk=WAVE_CHUNK, k=4, sample_rows=rows_s, sample_offset=off,
        )
        np.testing.assert_array_equal(rows.numpy(), np.asarray(jrows), err_msg=f"wave {i}")
        for f in ("node_row", "bound", "score", "zone", "region"):
            np.testing.assert_array_equal(getattr(asg, f).numpy(), np.asarray(getattr(jasg, f)),
                                          err_msg=f"{f} wave {i}")
        for c in ("cpu_req", "mem_req", "pods_req"):
            np.testing.assert_array_equal(getattr(table, c).numpy(), np.asarray(getattr(jt, c)),
                                          err_msg=f"{c} wave {i}")
        if cons is not None:
            for f in FIELDS:
                np.testing.assert_array_equal(getattr(cons, f).numpy(),
                                              np.asarray(getattr(jc, f)), err_msg=f"{f} wave {i}")
        assert int((rows >= 0).sum()) > 0
        unbound += int((~asg.bound & packed_valid).sum())
    # Pods collide on the tight fleet: some lose their candidates.
    assert unbound > 0
    if cons is not None:
        assert int(cons.tgt_node.sum()) > 0 or int(cons.spread_zone.sum()) > 0
