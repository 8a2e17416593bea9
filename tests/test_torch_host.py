"""The port's host half of the coordinator against the JAX package's.

Byte-equality on the same inputs, module by module: the object codec
(``control/objects.py``), the bulk cold-build lane (``bulkload``), the
node table's host mirror with its wave-epoch quarantine, the cached pod
encoder (``HotPodBatchHost``), the packed dirty-row delta
(``pack_row_delta``), the ownership views (``mask_rows``,
``mask_rows_packed``) and the signed count-table correction
(``adjust_constraints_impl``).  The two packages' native stores load two
separate ``libmemstore.so`` files and keep two metric registries.
Tolerance: exact equality throughout.
"""

import _torch_cpu  # noqa: F401  (bounds torch's CPU threads first)

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import k8s1m_tpu.control.objects as jobj
import k8s1m_tpu.engine.cycle as jcycle
import k8s1m_tpu.snapshot.bulkload as jbulk
import k8s1m_tpu.snapshot.constraints as jcons
import k8s1m_tpu.snapshot.hotfeed as jhot
import k8s1m_tpu.snapshot.node_table as jnt
import k8s1m_tpu.snapshot.packing as jpk
import k8s1m_tpu.snapshot.pod_encoding as jpe
import k8s1m_tpu.store.native as jnative
from k8s1m_tpu.config import PodSpec as JPodSpec
from k8s1m_tpu.config import TableSpec as JTableSpec
from k8s1m_tpu_torch import interop
from k8s1m_tpu_torch.config import PodSpec, TableSpec
from k8s1m_tpu_torch.control import objects as tobj
from k8s1m_tpu_torch.engine import cycle as tcycle
from k8s1m_tpu_torch.snapshot import bulkload as tbulk
from k8s1m_tpu_torch.snapshot import constraints as tcons
from k8s1m_tpu_torch.snapshot import hotfeed as thot
from k8s1m_tpu_torch.snapshot import node_table as tnt
from k8s1m_tpu_torch.snapshot import packing as tpk
from k8s1m_tpu_torch.snapshot import pod_encoding as tpe
from k8s1m_tpu_torch.store import native as tnative

SPREAD = [{
    "topologyKey": "topology.kubernetes.io/zone", "maxSkew": 1,
    "whenUnsatisfiable": "DoNotSchedule", "labelSelector": {"matchLabels": {"app": "web"}},
}]
ANTI = {"podAntiAffinity": {"requiredDuringSchedulingIgnoredDuringExecution": [{
    "topologyKey": "kubernetes.io/hostname", "labelSelector": {"matchLabels": {"app": "db"}},
}]}}


def _nodes(mod, n=24):
    """Nodes in every codec shape: canonical KWOK, tainted, unschedulable,
    an extra label, a numeric label."""
    out = []
    for i in range(n):
        labels = {"topology.kubernetes.io/zone": f"z{i % 3}",
                  "topology.kubernetes.io/region": f"r{i % 2}", "type": "kwok"}
        kw = {}
        if i % 7 == 3:
            kw["taints"] = [mod.Taint("dedicated", "gpu", 1)]
        if i % 11 == 5:
            kw["unschedulable"] = True
        if i % 5 == 1:
            labels["disk"] = "ssd"
            labels["gen"] = str(100 + i)
        out.append(mod.NodeInfo(name=f"n{i}", cpu_milli=4000 + 10 * i, mem_kib=(8 << 20) + i,
                                pods=16 + i % 4, labels=labels, **kw))
    return out


def _pods(pe):
    """Pods in every codec shape: plain, labeled, selector, toleration,
    required/preferred node affinity, priority, bound."""
    sel = pe.SelectorRequirement
    term = pe.NodeSelectorTerm([sel("topology.kubernetes.io/zone", 0, ["z1", "z2"])])
    return [
        pe.PodInfo("plain", cpu_milli=100, mem_kib=2048),
        pe.PodInfo("lab", namespace="ns1", labels={"app": "web"}, cpu_milli=250),
        pe.PodInfo("sel", node_selector={"disk": "ssd"}, cpu_milli=10),
        pe.PodInfo("tol", tolerations=[pe.Toleration(key="dedicated")]),
        pe.PodInfo("aff", required_terms=[term],
                   preferred_terms=[pe.PreferredSchedulingTerm(3, term)]),
        pe.PodInfo("prio", priority=7),
        pe.PodInfo("bound", node_name="n3", cpu_milli=5),
    ]


def test_object_codec_bytes_and_decodes_match():
    for jn, tn in zip(_nodes(jnt), _nodes(tnt)):
        raw = jobj.encode_node(jn)
        assert tobj.encode_node(tn) == raw
        assert dataclasses.asdict(tobj.decode_node(raw)) == dataclasses.asdict(
            jobj.decode_node(raw))
    # A heartbeat-churned status still decodes on the fast path in both.
    raw = json.loads(jobj.encode_node(_nodes(jnt)[0]))
    raw["status"]["conditions"].append({"type": "MemoryPressure", "status": "False"})
    raw = json.dumps(raw, separators=(",", ":")).encode()
    assert dataclasses.asdict(tobj.decode_node(raw)) == dataclasses.asdict(
        jobj.decode_node(raw))
    jt, tt = jcons.ConstraintTracker(JTableSpec()), tcons.ConstraintTracker(TableSpec())
    for jp, tp in zip(_pods(jpe), _pods(tpe)):
        for kw in ({}, {"raw_spread": SPREAD}, {"raw_affinity": ANTI}):
            raw = jobj.encode_pod(jp, **kw)
            assert tobj.encode_pod(tp, **kw) == raw
            assert dataclasses.asdict(tobj.decode_pod(raw, tt)) == dataclasses.asdict(
                jobj.decode_pod(raw, jt))
            obj = json.loads(raw)
            assert dataclasses.asdict(tobj.decode_pod_obj(obj)) == dataclasses.asdict(
                jobj.decode_pod_obj(obj))
    assert tobj.node_key("a") == jobj.node_key("a")
    assert tobj.pod_key("ns", "p") == jobj.pod_key("ns", "p")


@pytest.mark.parametrize("q", ["2", "500m", "1.5", 3, 0.25])
def test_cpu_quantity_matches(q):
    assert tobj.parse_cpu(q) == jobj.parse_cpu(q)


@pytest.mark.parametrize("q", ["8Gi", "512Mi", "1000k", "1G", "4096", 1 << 20])
def test_mem_quantity_matches(q):
    assert tobj.parse_mem(q) == jobj.parse_mem(q)


def _assert_hosts_equal(th, jh):
    for c in tnt.COLUMNS:
        np.testing.assert_array_equal(getattr(th, c), getattr(jh, c), err_msg=c)
        assert getattr(th, c).dtype == getattr(jh, c).dtype, c
    assert th._row_of == jh._row_of
    for ns in ("label_keys", "label_values", "taints", "node_names", "zones", "regions"):
        assert getattr(th.vocab, ns)._to_val == getattr(jh.vocab, ns)._to_val, ns
    assert th.epoch == jh.epoch


@pytest.mark.parametrize("chunk", [5, 64])
def test_bulk_ingest_matches(chunk):
    values = [jobj.encode_node(n) for n in _nodes(jnt, 40)]
    jh, th = jnt.NodeTableHost(JTableSpec(max_nodes=64)), tnt.NodeTableHost(TableSpec(max_nodes=64))
    jrows = jbulk.BulkNodeLoader(jh, chunk=chunk).ingest(values)
    trows = tbulk.BulkNodeLoader(th, chunk=chunk).ingest(values)
    np.testing.assert_array_equal(trows, jrows)
    _assert_hosts_equal(th, jh)
    # A resync relist of changed values reuses rows the same way.
    values2 = [jobj.encode_node(dataclasses.replace(n, cpu_milli=n.cpu_milli + 1))
               for n in _nodes(jnt, 44)]
    np.testing.assert_array_equal(tbulk.bulk_ingest(th, values2), jbulk.bulk_ingest(jh, values2))
    _assert_hosts_equal(th, jh)


def test_host_mirror_quarantine_matches():
    jh, th = jnt.NodeTableHost(JTableSpec(max_nodes=32)), tnt.NodeTableHost(TableSpec(max_nodes=32))
    for h, mod in ((jh, jnt), (th, tnt)):
        h.enable_row_journal()
        h.bulk_upsert(_nodes(mod, 20))
        h.add_pod("n2", 100, 200)
        h.remove("n4")                      # no wave yet: freed at once
        h.begin_wave()
        h.remove("n5")                      # quarantined behind wave 1
        h.upsert(mod.NodeInfo("fresh-a"))   # reuses n4's row
        h.begin_wave()
        h.remove_pod("n2", 100, 200)
        h.release_rows(2)                   # wave 1 retired: n5's row frees
        h.upsert(mod.NodeInfo("fresh-b"))
    _assert_hosts_equal(th, jh)
    assert th._row_journal == jh._row_journal
    assert (th.quarantined, th.num_nodes, th.mirror_nbytes()) == (
        jh.quarantined, jh.num_nodes, jh.mirror_nbytes())
    assert tnt.CAP_COLUMNS == jnt.CAP_COLUMNS and tnt.ALL_COLUMNS == jnt.ALL_COLUMNS


def test_rows_exhausted_reports_quarantine():
    th = tnt.NodeTableHost(TableSpec(max_nodes=1024))
    th.bulk_upsert(_nodes(tnt, 1024))
    th.begin_wave()
    th.remove("n0")
    with pytest.raises(tnt.RowsExhausted) as e:
        th.upsert(tnt.NodeInfo("extra"))
    assert e.value.quarantined == 1


def _encode_batch(mod_pe, mod_hot, host, pods, spec):
    return mod_hot.HotPodBatchHost(spec, host.spec, host.vocab).encode_packed(pods)


def test_hot_encoder_matches_jax_and_uncached():
    jh, th = jnt.NodeTableHost(JTableSpec(max_nodes=64)), tnt.NodeTableHost(TableSpec(max_nodes=64))
    jh.bulk_upsert(_nodes(jnt, 30))
    th.bulk_upsert(_nodes(tnt, 30))
    # >= TEMPLATE_MIN pods per shape, so the template path runs.
    jp = [dataclasses.replace(p, name=f"{p.name}-{i}") for i in range(5) for p in _pods(jpe)]
    tp = [dataclasses.replace(p, name=f"{p.name}-{i}") for i in range(5) for p in _pods(tpe)]
    jspec, tspec = JPodSpec(batch=48), PodSpec(batch=48)
    enc = thot.HotPodBatchHost(tspec, th.spec, th.vocab)
    for _ in range(2):                      # cold, then warm templates
        got = enc.encode_packed(tp)
        want = jhot.HotPodBatchHost(jspec, jh.spec, jh.vocab).encode_packed(jp)
        assert got.groups == want.groups
        np.testing.assert_array_equal(got.ints, want.ints)
        np.testing.assert_array_equal(got.bools, want.bools)
        for name, arr in want.fields.items():
            np.testing.assert_array_equal(got.fields[name], arr, err_msg=name)
        assert got.vocab_gen == th.vocab.feed_generation()
    plain = tpe.PodBatchHost(tspec, th.spec, th.vocab).encode_packed(tp)
    np.testing.assert_array_equal(plain.ints, got.ints)
    np.testing.assert_array_equal(plain.bools, got.bools)


@pytest.mark.parametrize("fuse", [True, False])
@pytest.mark.parametrize("columns", ["cap", "all"])
def test_pack_row_delta_matches(fuse, columns):
    jh, th = jnt.NodeTableHost(JTableSpec(max_nodes=64)), tnt.NodeTableHost(TableSpec(max_nodes=64))
    jh.bulk_upsert(_nodes(jnt, 30))
    th.bulk_upsert(_nodes(tnt, 30))
    jspec = dataclasses.replace(jpk.build_packing_spec(jh.spec, jh.vocab), fuse_labels=fuse)
    tspec = dataclasses.replace(tpk.build_packing_spec(th.spec, th.vocab), fuse_labels=fuse)
    rows = np.array([0, 3, 7, 7, 29], np.int32)
    cols = tnt.CAP_COLUMNS if columns == "cap" else tnt.ALL_COLUMNS
    got = tpk.pack_row_delta(th, rows, tspec, cols)
    want = jpk.pack_row_delta(jh, rows, jspec, cols)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got[k].dtype == want[k].dtype, k


def test_resolve_packing_fails_loudly():
    assert tpk.resolve_packing("packed") == "packed"
    with pytest.raises(ValueError):
        tpk.resolve_packing("bogus")


@pytest.mark.parametrize("layout", ["plain", "packed"])
def test_mask_rows_matches(layout):
    jh, th = jnt.NodeTableHost(JTableSpec(max_nodes=64)), tnt.NodeTableHost(TableSpec(max_nodes=64))
    jh.bulk_upsert(_nodes(jnt, 30))
    th.bulk_upsert(_nodes(tnt, 30))
    mask = np.random.default_rng(3).random(64) < 0.5
    if layout == "plain":
        jt, tt = jh.to_device(), th.to_device("cpu")
    else:
        jt = jpk.pack_table_host(jh, jpk.build_packing_spec(jh.spec, jh.vocab))
        tt = tpk.pack_table_host(th, tpk.build_packing_spec(th.spec, th.vocab), "cpu")
    got = tcycle.mask_rows(tt, torch.from_numpy(mask))
    want = jcycle.mask_rows(jt, mask)
    for f in dataclasses.fields(got):
        if f.name == "spec":
            continue
        np.testing.assert_array_equal(getattr(got, f.name).numpy(),
                                      np.asarray(getattr(want, f.name)), err_msg=f.name)
    # The commit state is the table's own: a commit through the view
    # lands in the unmasked table.
    assert got.cpu_req.data_ptr() == tt.cpu_req.data_ptr()


@pytest.mark.parametrize("sign", [1, -1])
def test_adjust_constraints_matches(sign):
    jspec = JTableSpec(max_nodes=64, max_zones=8, max_regions=4, spread_slots=4,
                       affinity_slots=4)
    tspec = TableSpec(max_nodes=64, max_zones=8, max_regions=4, spread_slots=4,
                      affinity_slots=4)
    jt, tt = jcons.ConstraintTracker(jspec), tcons.ConstraintTracker(tspec)
    jp = [jobj.decode_pod(jobj.encode_pod(jpe.PodInfo(f"p{i}", labels={"app": "web" if i % 2 else "db"}),
                                          raw_spread=SPREAD, raw_affinity=ANTI), jt)
          for i in range(12)]
    tp = [tobj.decode_pod(jobj.encode_pod(jpe.PodInfo(f"p{i}", labels={"app": "web" if i % 2 else "db"}),
                                          raw_spread=SPREAD, raw_affinity=ANTI), tt)
          for i in range(12)]
    jb = jhot.HotPodBatchHost(JPodSpec(batch=16, spread_refs=2, affinity_refs=2), jspec,
                              jnt.NodeTableHost(jspec).vocab).encode_packed(jp)
    tb = thot.HotPodBatchHost(PodSpec(batch=16, spread_refs=2, affinity_refs=2), tspec,
                              tnt.NodeTableHost(tspec).vocab).encode_packed(tp)
    rng = np.random.default_rng(5)
    node_row = rng.integers(0, 64, 16).astype(np.int32)
    zone = rng.integers(0, 8, 16).astype(np.int32)
    region = rng.integers(0, 4, 16).astype(np.int32)
    mnode = rng.random(16) < 0.7
    mdom = rng.random(16) < 0.9
    base = {f: rng.integers(0, 5, getattr(jcons.empty_constraints(jspec), f).shape).astype(np.int32)
            for f in tcons.FIELDS}
    want = jcycle.adjust_constraints_impl(
        jcons.ConstraintState(**{f: jnp.asarray(a) for f, a in base.items()}),
        jcycle.commit_fields_np(jb.fields),
        node_row, zone, region, mnode, mdom, sign=sign)
    state = interop.constraints_from_numpy(base, device="cpu")
    got = tcycle.adjust_constraints_impl(
        state, tcycle.commit_fields_np(tb.fields, torch.device("cpu")),
        *(torch.from_numpy(a) for a in (node_row, zone, region, mnode, mdom)), sign=sign)
    assert got is state                     # in place
    for f in tcons.FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)


def test_two_memstore_libraries_stay_apart():
    tlib, jlib = tnative._lib(), jnative._lib()
    assert tlib._name != jlib._name
    assert tlib._name.endswith("k8s1m_tpu_torch/build/libmemstore.so")
    assert (ctypes_addr(tlib.ms_open) != ctypes_addr(jlib.ms_open))
    with tnative.MemStore() as ts, jnative.MemStore() as js:
        ts.put(b"/registry/pods/a/b", b"port")
        js.put(b"/registry/pods/a/c", b"jax")
        assert [kv.value for kv in tnative.list_prefix(ts, b"/registry/pods/")[0]] == [b"port"]
        assert [kv.value for kv in jnative.list_prefix(js, b"/registry/pods/")[0]] == [b"jax"]
        # The native bind splice agrees byte for byte.
        raw = jobj.encode_pod(jpe.PodInfo("b", namespace="a"))
        ts.put(b"/registry/pods/a/b", raw)
        js.put(b"/registry/pods/a/b", raw)
        tr = ts.get(b"/registry/pods/a/b")
        jr = js.get(b"/registry/pods/a/b")
        ts.bind_batch([(b"/registry/pods/a/b", tr.mod_revision, b"n1")])
        js.bind_batch([(b"/registry/pods/a/b", jr.mod_revision, b"n1")])
        assert ts.get(b"/registry/pods/a/b").value == js.get(b"/registry/pods/a/b").value


def ctypes_addr(fn) -> int:
    import ctypes

    return ctypes.cast(fn, ctypes.c_void_p).value


def test_two_metric_registries():
    import k8s1m_tpu.control.coordinator  # noqa: F401  (registers the JAX metrics)
    import k8s1m_tpu_torch.control.coordinator  # noqa: F401
    from k8s1m_tpu.obs.metrics import REGISTRY as JREG
    from k8s1m_tpu_torch.obs.metrics import REGISTRY as TREG

    assert TREG is not JREG
    for name in ("coordinator_cycle_seconds", "coordinator_schedule_to_bind_seconds",
                 "retry_attempts_total", "hotfeed_cache_hits_total"):
        assert TREG.get(name) is not None and JREG.get(name) is not None
        assert TREG.get(name) is not JREG.get(name)
