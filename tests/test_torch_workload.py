"""The port's workload generators vs the JAX package's: the same PodInfos
field for field, and the same packed pod buffers under the same vocab,
for the NodeAffinity pods of BASELINE config 2 and the spread / (anti-)
affinity deployments of configs 3-4 (``bench.py --affinity`` and
``--constraints``)."""

import _torch_cpu  # noqa: F401  (bounds torch's CPU threads first)

import dataclasses

import numpy as np
import pytest

from k8s1m_tpu.cluster import populate_kwok_nodes as jax_populate
from k8s1m_tpu.cluster import workload as jwl
from k8s1m_tpu.config import TOPO_HOSTNAME, TOPO_REGION, TOPO_ZONE
from k8s1m_tpu.config import PodSpec as JaxPodSpec
from k8s1m_tpu.config import TableSpec as JaxTableSpec
from k8s1m_tpu.snapshot import constraints as jcons
from k8s1m_tpu.snapshot import node_table as jnt
from k8s1m_tpu.snapshot import pod_encoding as jpe
from k8s1m_tpu_torch.cluster import (
    affinity_deployment,
    node_affinity_pods,
    populate_kwok_nodes,
    spread_deployment,
)
from k8s1m_tpu_torch.config import PodSpec, TableSpec
from k8s1m_tpu_torch.snapshot import constraints as tcons
from k8s1m_tpu_torch.snapshot import node_table as tnt
from k8s1m_tpu_torch.snapshot import pod_encoding as tpe

SPEC = dict(max_nodes=256, max_zones=16, max_regions=8, spread_slots=4, affinity_slots=4)


def _as_dicts(pods):
    return [dataclasses.asdict(p) for p in pods]


def _workloads(mod_wl, tracker):
    return (
        mod_wl.node_affinity_pods(20, zones=8, regions=3)
        + mod_wl.spread_deployment(tracker, "sp", 5, topo=TOPO_ZONE)
        + mod_wl.spread_deployment(tracker, "sp-r", 3, topo=TOPO_REGION, max_skew=2, start=4)
        + mod_wl.affinity_deployment(tracker, "anti", 5, anti=True)
        + mod_wl.affinity_deployment(tracker, "pref", 3, required=False, weight=7,
                                     target={"app": "sp"}, topo=TOPO_ZONE)
        + mod_wl.affinity_deployment(tracker, "aff", 2, topo=TOPO_HOSTNAME)
    )


class _PortWorkload:
    node_affinity_pods = staticmethod(node_affinity_pods)
    spread_deployment = staticmethod(spread_deployment)
    affinity_deployment = staticmethod(affinity_deployment)


def test_generators_make_the_same_pods():
    jpods = _workloads(jwl, jcons.ConstraintTracker(JaxTableSpec(**SPEC)))
    tpods = _workloads(_PortWorkload, tcons.ConstraintTracker(TableSpec(**SPEC)))
    assert _as_dicts(tpods) == _as_dicts(jpods)
    assert any(p.ipa_incs for p in tpods) and any(p.spread_incs for p in tpods)


@pytest.mark.parametrize("dims", [
    dict(aff_terms=1, aff_exprs=2, aff_values=2, pref_terms=1),
    dict(spread_refs=1, affinity_refs=1, spread_incs=1, ipa_incs=1),
    {},
])
def test_generators_pack_the_same_buffers(dims):
    jh = jnt.NodeTableHost(JaxTableSpec(**SPEC))
    th = tnt.NodeTableHost(TableSpec(**SPEC))
    jax_populate(jh, 200, zones=8, regions=3)
    populate_kwok_nodes(th, 200, zones=8, regions=3)
    jpods = _workloads(jwl, jcons.ConstraintTracker(jh.spec))
    tpods = _workloads(_PortWorkload, tcons.ConstraintTracker(th.spec))
    if dims.get("spread_refs") == 1:
        jpods, tpods = jpods[20:], tpods[20:]        # constraint pods only
    elif dims:
        jpods, tpods = jpods[:20], tpods[:20]        # affinity pods only
    jp = jpe.PodBatchHost(JaxPodSpec(batch=48, **dims), jh.spec, jh.vocab).encode_packed(jpods)
    tp = tpe.PodBatchHost(PodSpec(batch=48, **dims), th.spec, th.vocab).encode_packed(tpods)
    assert jp.groups == tp.groups
    np.testing.assert_array_equal(jp.ints, tp.ints)
    np.testing.assert_array_equal(jp.bools, tp.bools)


# ---- the tenant stream of sched_bench --tenants ----------------------------------


@pytest.mark.parametrize("tenants,skew", [(1, 1.0), (5, 0.0), (7, 1.0), (40, 1.7)])
def test_zipf_weights_match(tenants, skew):
    from k8s1m_tpu_torch.cluster.workload import zipf_weights

    assert zipf_weights(tenants, skew) == jwl.zipf_weights(tenants, skew)
    with pytest.raises(ValueError):
        zipf_weights(0)


@pytest.mark.parametrize("schedule", ["steady", "diurnal", "flash"])
@pytest.mark.parametrize("seed,skew", [(0, 1.0), (3, 0.0), (11, 2.0)])
def test_tenant_assignments_match(schedule, seed, skew):
    from k8s1m_tpu_torch.cluster import workload as twl

    for count, tenants in ((1000, 6), (257, 3), (3000, 32)):
        got = twl.tenant_assignments(count, tenants, skew=skew, seed=seed, schedule=schedule)
        assert got == jwl.tenant_assignments(count, tenants, skew=skew, seed=seed,
                                             schedule=schedule)
        assert len(got) == count and set(got) <= set(range(tenants))
    for frac in (0.0, 0.45, 0.7):
        assert (twl.tenant_rate_multipliers(schedule, frac, 5)
                == jwl.tenant_rate_multipliers(schedule, frac, 5))
    with pytest.raises(ValueError):
        twl.tenant_rate_multipliers("weekly", 0.1, 3)
