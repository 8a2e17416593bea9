"""The port's Coordinator against the JAX package's, on the CPU.

Both coordinators get the same store writes, each to its own
``MemStore``, and are stepped in lockstep (the port with
``device="cpu"``: the plain versions of the kernels; the JAX one on its
XLA path, which the JAX package holds byte-identical to its Pallas
kernel).  Backoff is made deterministic with a ``RetryPolicy`` of zero
delay and zero jitter.  After every step the returned bind counts must
agree; at the end every stored pod value must be byte-identical, as must
the host mirror, the device table (the JAX table carried over through
``interop``) and, with constraints, all nine count tables.  The wave
seeds agree because the port draws them from its threefry twin
(``ops/priority.py``).  Tolerance: exact equality.
"""

import dataclasses

import numpy as np
import pytest
import torch

import k8s1m_tpu.config as jconfig
import k8s1m_tpu.control.coordinator as jcoord
import k8s1m_tpu.control.objects as jobj
import k8s1m_tpu.faultline as jfault
import k8s1m_tpu.plugins.registry as jreg
import k8s1m_tpu.snapshot.node_table as jnt
import k8s1m_tpu.snapshot.pod_encoding as jpe
import k8s1m_tpu.store.native as jnative
from k8s1m_tpu.tools.make_nodes import build_node
from k8s1m_tpu_torch import interop
from k8s1m_tpu_torch.config import PodSpec, TableSpec
from k8s1m_tpu_torch.control.coordinator import Coordinator
from k8s1m_tpu_torch.engine import deltacache
from k8s1m_tpu_torch.faultline import RetryPolicy
from k8s1m_tpu_torch.plugins.registry import Profile
from k8s1m_tpu_torch.snapshot.constraints import FIELDS as CONSTRAINT_FIELDS
from k8s1m_tpu_torch.snapshot.packing import is_packed
from k8s1m_tpu_torch.store import native as tnative

N = 4096
BASE = dict(node_affinity=0, topology_spread=0, interpod_affinity=0)
SPREAD = [{
    "topologyKey": "topology.kubernetes.io/zone", "maxSkew": 1,
    "whenUnsatisfiable": "DoNotSchedule", "labelSelector": {"matchLabels": {"app": "web"}},
}]
ANTI = {"podAntiAffinity": {"requiredDuringSchedulingIgnoredDuringExecution": [{
    "topologyKey": "kubernetes.io/hostname", "labelSelector": {"matchLabels": {"app": "db"}},
}]}}


def node_item(i, **kw):
    node = dataclasses.replace(build_node(i), **kw)
    return jobj.node_key(node.name), jobj.encode_node(node)


def pod_item(name, ns="default", cpu=10, mem=1024, **kw):
    raw = {k: kw.pop(k) for k in ("raw_spread", "raw_affinity") if k in kw}
    pod = jpe.PodInfo(name, namespace=ns, cpu_milli=cpu, mem_kib=mem, **kw)
    return jobj.pod_key(ns, name), jobj.encode_pod(pod, **raw)


def fleet(n=N, **kw):
    return [node_item(i, **kw) for i in range(n)]


def pods(prefix, count, **kw):
    return [pod_item(f"{prefix}-{i}", cpu=10 + i % 3, **kw) for i in range(count)]


class Pair:
    """A JAX and a port coordinator over their own stores, one script."""

    def __init__(self, *, profile=BASE, max_nodes=N, batch=128, chunk=512, port_kw=None,
                 **kw):
        self.jstore, self.tstore = jnative.MemStore(), tnative.MemStore()
        dims = dict(max_nodes=max_nodes, max_zones=16, max_regions=8)
        pdims = dict(batch=batch, spread_refs=1, affinity_refs=1, spread_incs=1, ipa_incs=1)
        pol = dict(component="coordinator.bind", base_delay_s=0.0, jitter=0.0)
        kw.setdefault("with_constraints", False)
        self.j = jcoord.Coordinator(
            self.jstore, jconfig.TableSpec(**dims), jconfig.PodSpec(**pdims),
            jreg.Profile(**profile), chunk=chunk, k=4, backend="xla",
            retry_policy=jfault.RetryPolicy(**pol), **kw,
        )
        self.t = Coordinator(
            self.tstore, TableSpec(**dims), PodSpec(**pdims), Profile(**profile),
            chunk=chunk, k=4, retry_policy=RetryPolicy(**pol), device="cpu", **kw,
            **(port_kw or {}),
        )
        self.bound = 0

    def write(self, items):
        for store in (self.jstore, self.tstore):
            store.put_batch(items)

    def bootstrap(self):
        self.j.bootstrap()
        self.t.bootstrap()

    def step(self):
        got, want = self.t.step(), self.j.step()
        assert got == want
        self.bound += got
        return got

    def run_until_idle(self):
        got, want = self.t.run_until_idle(), self.j.run_until_idle()
        assert got == want
        self.bound += got

    def rewrite(self, key):
        """Bump a stored pod's revision (same bytes): its bind CAS loses."""
        for store in (self.jstore, self.tstore):
            store.put(key, store.get(key).value)

    def check(self):
        jkv, _ = jnative.list_prefix(self.jstore, b"/registry/pods/")
        tkv, _ = tnative.list_prefix(self.tstore, b"/registry/pods/")
        assert [(kv.key, kv.value) for kv in tkv] == [(kv.key, kv.value) for kv in jkv]
        jh, th = self.j.host, self.t.host
        assert th._row_of == jh._row_of
        for c in ("valid", "cpu_alloc", "mem_alloc", "pods_alloc", "cpu_req", "mem_req",
                  "pods_req", "label_key", "label_val", "zone", "region", "name_id"):
            np.testing.assert_array_equal(getattr(th, c), getattr(jh, c), err_msg=c)
        jt, tt = self.j.table, self.t.table
        assert is_packed(tt) == (type(jt).__name__ == "PackedNodeTable")
        names = [f.name for f in dataclasses.fields(tt) if f.name != "spec"]
        carried = interop.node_table_from_numpy(
            {f: np.asarray(getattr(jt, f)) for f in names},
            packing=jt.spec if is_packed(tt) else None, device="cpu")
        for f in names:
            assert torch.equal(getattr(tt, f), getattr(carried, f)), f
        # The device request columns equal the host mirror once idle.
        if not self.t._inflights:
            for c in ("cpu_req", "mem_req", "pods_req"):
                np.testing.assert_array_equal(getattr(tt, c).numpy(), getattr(th, c),
                                              err_msg=c)
        if self.t.constraints is not None:
            carried = interop.constraints_from_numpy(
                {f: np.asarray(getattr(self.j.constraints, f)) for f in CONSTRAINT_FIELDS},
                device="cpu")
            for f in CONSTRAINT_FIELDS:
                assert torch.equal(getattr(self.t.constraints, f), getattr(carried, f)), f
        assert self.t.unschedulable.keys() == self.j.unschedulable.keys()
        return tkv

    def close(self):
        self.t.close()
        self.j.close()
        self.tstore.close()
        self.jstore.close()


@pytest.fixture
def pair_factory():
    made = []

    def make(**kw):
        p = Pair(**kw)
        made.append(p)
        return p

    yield make
    for p in made:
        p.close()


def _all_bound(kvs):
    return all(b'"nodeName"' in kv.value for kv in kvs)


@pytest.mark.parametrize("packing", ["off", "packed"])
@pytest.mark.parametrize("pipeline", [False, True])
def test_uniform_waves(pair_factory, packing, pipeline):
    p = pair_factory(pipeline=pipeline, depth=2, packing=packing)
    p.write(fleet())
    p.bootstrap()
    for w in range(4):
        p.write(pods(f"w{w}", 150))
        p.step()
    p.run_until_idle()
    kvs = p.check()
    assert len(kvs) == 600 and _all_bound(kvs) and p.bound == 600


def test_sampled_window(pair_factory):
    p = pair_factory(pipeline=True, depth=2, packing="packed", score_pct=5, chunk=256)
    assert p.t._sample_rows == 256
    p.write(fleet())
    p.bootstrap()
    for w in range(5):
        p.write(pods(f"w{w}", 128))
        p.step()
    p.run_until_idle()
    kvs = p.check()
    assert _all_bound(kvs) and p.t._window_i == p.j._window_i == 5


@pytest.mark.parametrize("pipeline", [False, True])
def test_constraints_with_cas_conflict_rollback(pair_factory, pipeline):
    p = pair_factory(profile={}, pipeline=pipeline, depth=2, with_constraints=True,
                     packing="packed", max_nodes=1024)
    p.write(fleet(1024, pods=4))
    p.bootstrap()
    spread = pods("web", 40, labels={"app": "web"}, raw_spread=SPREAD)
    anti = pods("db", 40, labels={"app": "db"}, raw_affinity=ANTI)
    p.write(spread[:20] + anti[:20])
    # Intake, then a writer rewrites three pods before the wave binds:
    # their CAS loses and the wave's count-table commit rolls back.
    for c in (p.t, p.j):
        c.drain_watches()
    for key, _ in (spread[3], anti[5], anti[11]):
        p.rewrite(key)
    p.step()
    p.write(spread[20:] + anti[20:])
    p.step()
    p.run_until_idle()
    kvs = p.check()
    assert _all_bound(kvs) and p.bound == 80
    # The rolled-back pods retried and bound; the counts equal the binds.
    cons = p.t.constraints
    assert int(cons.spread_zone.sum()) == 40
    assert int(cons.own_node.sum()) == 40


def test_pod_deletion_frees_capacity(pair_factory):
    p = pair_factory(pipeline=True, depth=2, max_nodes=1024, max_attempts=3)
    p.write(fleet(8, pods=3))
    p.bootstrap()
    p.write(pods("a", 24))
    p.run_until_idle()
    p.write(pods("b", 8))            # no room: they go unschedulable
    p.run_until_idle()
    assert len(p.t.unschedulable) == 8
    p.write([(k, None) for k, _ in pods("a", 24)[:10]])
    p.write(pods("c", 10))
    p.run_until_idle()
    kvs = p.check()
    assert sum(b'"nodeName"' in kv.value for kv in kvs) == 24
    assert int(p.t.host.pods_req.sum()) == 24


def test_node_churn_mid_pipeline(pair_factory):
    p = pair_factory(pipeline=True, depth=3, max_nodes=1024, packing="packed")
    p.write(fleet(64, pods=8))
    p.bootstrap()
    for w in range(8):
        p.write(pods(f"w{w}", 48))
        # Capacity-only updates of rows the table holds.
        p.write([node_item((w + j) % 64, pods=8, cpu_milli=32000 + 100 * w) for j in range(3)])
        if w == 2:
            p.write([node_item(100), node_item(101)])          # structural adds
        if w == 3:
            p.write([(jobj.node_key("kwok-node-5"), None)])    # remove
        if w == 4:
            # Remove and re-add under one name in one drain.
            p.write([(jobj.node_key("kwok-node-7"), None), node_item(7, pods=8)])
        if w == 5:
            p.write([(jobj.node_key("kwok-node-100"), None), node_item(102)])
        p.step()
    assert p.t.host.quarantined == p.j.host.quarantined
    p.run_until_idle()
    kvs = p.check()
    assert len(kvs) == 8 * 48


@pytest.mark.parametrize("index_k", [0, 32])
def test_deltacache(pair_factory, index_k):
    deltacache.reset_counters()
    p = pair_factory(pipeline=True, depth=2, packing="packed", deltacache="on",
                     delta_index_k=index_k, stratum_bits=7 if index_k else 0)
    p.write(fleet())
    p.bootstrap()
    for w in range(6):
        p.write(pods(f"w{w}", 128))
        if w == 3:
            p.write([node_item(j, cpu_milli=16000) for j in range(0, 40, 4)])
        p.step()
    p.run_until_idle()
    kvs = p.check()
    assert _all_bound(kvs)
    assert p.t.waves["delta"] > 0
    if index_k:
        assert deltacache.COUNTERS["deltasched_index_waves_total"]["index"] > 0


@pytest.mark.parametrize("pipeline", [False, True])
def test_row_mask_half(pair_factory, pipeline):
    p = pair_factory(pipeline=pipeline, depth=2, packing="packed")
    p.write(fleet())
    p.bootstrap()
    mask = np.zeros(N, bool)
    mask[: N // 2] = True
    p.t.set_row_mask(mask)
    p.j.set_row_mask(mask)
    for w in range(3):
        p.write(pods(f"w{w}", 128))
        p.step()
    p.run_until_idle()
    kvs = p.check()
    rows = [p.t.host.row_of(n) for n in p.t.host._row_of if p.t.host.pods_req[p.t.host.row_of(n)]]
    assert _all_bound(kvs) and max(rows) < N // 2


def test_unported_options_raise():
    with tnative.MemStore() as store:
        for kw in (dict(mesh="2x4"), dict(tracer=object()), dict(fence=object())):
            with pytest.raises(NotImplementedError):
                Coordinator(store, TableSpec(max_nodes=N), PodSpec(batch=64),
                            Profile(**BASE), chunk=512, device="cpu", **kw)
        with pytest.raises(ValueError):
            Coordinator(store, TableSpec(max_nodes=N), PodSpec(batch=64), Profile(**BASE),
                        chunk=512, device="cpu", delta_index_k=8)


# ---- backends, adaptive buckets, template pods, node churn -------------------

AFFINITY = dict(topology_spread=0, interpod_affinity=0)


def _quiesce(registry):
    q = registry.get("pipeline_quiesce_total")
    return {r: q.value(reason=r) for r in ("structural", "resync", "adaptive")}


class QuiesceDelta:
    """Quiesce counts of both packages' registries since construction."""

    def __init__(self):
        from k8s1m_tpu.obs.metrics import REGISTRY as JREG
        from k8s1m_tpu_torch.obs.metrics import REGISTRY as TREG

        self.regs = (JREG, TREG)
        self.base = [_quiesce(r) for r in self.regs]

    def deltas(self):
        return [{k: now[k] - b[k] for k in now}
                for now, b in zip((_quiesce(r) for r in self.regs), self.base)]


def shape_pool_pods(prefix, count, pool=4, share=0.9, seed=3):
    """``sched_bench --shape-pool``'s pods: NodeAffinity templates
    (``node_affinity_pods(5 * pool, zones=8, regions=4)``, ``cpu_milli =
    10 + j``) drawn per pod from ``random.Random((seed << 20) | i)``."""
    import random

    from k8s1m_tpu.cluster.workload import node_affinity_pods

    templates = node_affinity_pods(5 * pool, zones=8, regions=4)
    out = []
    for i in range(count):
        rng = random.Random((seed << 20) | i)
        j = (rng.randrange(pool) if rng.random() < share
             else pool + rng.randrange(4 * pool))
        t = templates[j]
        out.append(pod_item(f"{prefix}-{i}", cpu=10 + j, required_terms=t.required_terms,
                            preferred_terms=t.preferred_terms))
    return out


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_backend_shape_pool_lockstep(pair_factory, backend):
    """Template-shaped NodeAffinity pods through the port's scan path and
    through the kernel's plain version, against the JAX coordinator's XLA
    path, sampled window, packed."""
    p = pair_factory(profile=AFFINITY, pipeline=True, depth=2, packing="packed", score_pct=25,
                     port_kw=dict(backend=backend))
    assert p.t.backend == backend
    p.write(fleet())
    p.bootstrap()
    for w in range(4):
        p.write(shape_pool_pods(f"w{w}", 128))
        p.step()
    p.run_until_idle()
    kvs = p.check()
    assert _all_bound(kvs) and p.bound == 512


def test_adaptive_batch_buckets_lockstep(pair_factory):
    """Queue depths 5, 100, 200, 600 and then 88 + 40 take the 64, 128,
    256, 512 and 128 buckets; every partial bucket retires at once,
    counted as an adaptive quiesce in both packages."""
    q = QuiesceDelta()
    p = pair_factory(pipeline=True, depth=2, packing="packed", batch=512, adaptive_batch=True)
    assert p.t.min_batch == 64
    p.write(fleet())
    p.bootstrap()
    sizes = []
    for w, n in enumerate((5, 100, 200, 600, 40)):
        p.write(pods(f"w{w}", n))
        for c in (p.t, p.j):
            c.drain_watches()
        sizes.append(p.t._encoder_for(len(p.t.queue)).spec.batch)
        p.step()
    p.run_until_idle()
    kvs = p.check()
    assert _all_bound(kvs) and p.bound == 945
    assert sizes == [64, 128, 256, 512, 128]
    assert sorted(p.t._encoders) == sorted(p.j._encoders) == [64, 128, 256, 512]
    jq, tq = q.deltas()
    assert tq == jq and tq["adaptive"] > 0 and tq["structural"] == 0


def test_node_churn_lockstep(pair_factory):
    """Each package's ``sched_bench._NodeChurn`` writes capacity-only
    updates into its own store at 4,000 updates/s of synthetic elapsed
    time (never the wall clock) while pods arrive; the pipeline never
    quiesces and both coordinators stay byte-identical."""
    from k8s1m_tpu.tools.sched_bench import _NodeChurn as JChurn
    from k8s1m_tpu_torch.tools.sched_bench import _NodeChurn as TChurn

    q = QuiesceDelta()
    p = pair_factory(pipeline=True, depth=3, packing="packed", max_nodes=1024)
    p.write(fleet(256))
    p.bootstrap()
    churns = (JChurn(p.jstore, 256, 4000.0), TChurn(p.tstore, 256, 4000.0))
    for w in range(8):
        p.write(pods(f"w{w}", 96))
        for c in churns:
            c.advance(0.05 * (w + 1))
        p.step()
    p.run_until_idle()
    kvs = p.check()
    assert _all_bound(kvs) and p.bound == 8 * 96
    assert churns[0].emitted == churns[1].emitted == 1600
    jq, tq = q.deltas()
    assert tq == jq and tq["structural"] == tq["resync"] == 0
