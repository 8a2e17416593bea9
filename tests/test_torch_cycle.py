"""The port's packed scheduling wave vs the JAX package's, end to end.

- Host state: the port's ``populate_kwok_nodes``, ``pack_columns_np``,
  ``encode_packed`` fill arrays identical to the JAX package's, and
  ``unpack_pod_batch`` gives the same fields.
- The wave: three consecutive ``schedule_batch_packed`` waves over a
  rotating sample window, against ``k8s1m_tpu.engine.cycle.
  schedule_batch_packed`` on the Pallas path (interpret mode) and the XLA
  path, both table layouts: identical bound rows, Assignment and
  post-commit request columns.  The port takes the i32 seed the JAX step
  derives from its key (``seed_of``).
- ``greedy_assign`` on batches built to collide on candidates.
- Waves the port cannot compute raise; CUDA without a card raises.

Tolerance everywhere: exact equality (integer outputs).
"""

import _torch_cpu  # noqa: F401  (bounds torch's CPU threads first)

import dataclasses

import jax
import numpy as np
import pytest
import torch

from k8s1m_tpu.cluster import populate_kwok_nodes as jax_populate
from k8s1m_tpu.config import (
    EFFECT_NO_SCHEDULE,
    EFFECT_PREFER_NO_SCHEDULE,
    SEL_OP_IN,
    PodSpec as JaxPodSpec,
    TableSpec as JaxTableSpec,
)
from k8s1m_tpu.engine.assign import greedy_assign as jax_greedy
from k8s1m_tpu.engine.cycle import schedule_batch_packed as jax_schedule
from k8s1m_tpu.ops.priority import seed_of
from k8s1m_tpu.plugins.registry import Profile as JaxProfile
from k8s1m_tpu.snapshot import node_table as jnt
from k8s1m_tpu.snapshot import packing as jpk
from k8s1m_tpu.snapshot import pod_encoding as jpe
from k8s1m_tpu_torch import interop
from k8s1m_tpu_torch.cluster import populate_kwok_nodes
from k8s1m_tpu_torch.config import PodSpec, TableSpec
from k8s1m_tpu_torch.device import resolve_device
from k8s1m_tpu_torch.engine.assign import greedy_assign
from k8s1m_tpu_torch.engine.cycle import (
    sample_offset_for,
    sample_rows_for,
    schedule_batch_packed,
)
from k8s1m_tpu_torch.plugins.registry import Profile
from k8s1m_tpu_torch.snapshot import node_table as tnt
from k8s1m_tpu_torch.snapshot import packing as tpk
from k8s1m_tpu_torch.snapshot import pod_encoding as tpe

JAX_BASE = JaxProfile(node_affinity=0, topology_spread=0, interpod_affinity=0)
BASE = Profile(node_affinity=0, topology_spread=0, interpod_affinity=0)
HOST_COLUMNS = tnt.COLUMNS


# ---- host state -------------------------------------------------------------


def _hosts(n=300, **kw):
    jh = jnt.NodeTableHost(JaxTableSpec(max_nodes=n + 20))
    th = tnt.NodeTableHost(TableSpec(max_nodes=n + 20))
    jax_populate(jh, n, **kw)
    populate_kwok_nodes(th, n, **kw)
    return jh, th


@pytest.mark.parametrize("kw", [{}, {"tainted_fraction": 0.3, "seed": 9}])
def test_populate_kwok_matches(kw):
    jh, th = _hosts(**kw)
    for c in HOST_COLUMNS:
        a, b = getattr(jh, c), getattr(th, c)
        assert a.dtype == b.dtype, c
        np.testing.assert_array_equal(a, b, err_msg=c)
    assert list(jh.vocab.label_values.items()) == list(th.vocab.label_values.items())
    assert list(jh.vocab.taints.items()) == list(th.vocab.taints.items())


def test_upsert_matches():
    jh = jnt.NodeTableHost(JaxTableSpec(max_nodes=16, max_taint_ids=8))
    th = tnt.NodeTableHost(TableSpec(max_nodes=16, max_taint_ids=8))
    for i in range(10):
        for host, mod in ((jh, jnt), (th, tnt)):
            host.upsert(mod.NodeInfo(
                f"n{i}", cpu_milli=1000 + i, labels={"zone-x": f"z{i % 3}"},
                taints=[mod.Taint("t", str(i % 2), EFFECT_PREFER_NO_SCHEDULE)],
                unschedulable=i % 4 == 0,
            ))
    for c in HOST_COLUMNS:
        np.testing.assert_array_equal(getattr(jh, c), getattr(th, c), err_msg=c)


def test_pack_columns_matches():
    jh, th = _hosts(tainted_fraction=0.2, seed=4)
    jspec = jpk.build_packing_spec(jh.spec, jh.vocab)
    tspec = tpk.build_packing_spec(th.spec, th.vocab)
    assert dataclasses.asdict(jspec) == dataclasses.asdict(tspec)
    want = jpk.pack_columns_np({c: getattr(jh, c) for c in HOST_COLUMNS}, jspec)
    got = tpk.pack_columns_np(th.columns(), tspec)
    assert want.keys() == got.keys()
    for c in want:
        assert want[c].dtype == got[c].dtype, c
        np.testing.assert_array_equal(want[c], got[c], err_msg=c)
    # The device tables carry the same bytes.
    jt, tt = jpk.pack_table_host(jh, jspec), tpk.pack_table_host(th, tspec, "cpu")
    for c in got:
        np.testing.assert_array_equal(np.asarray(getattr(jt, c)), getattr(tt, c).numpy())
    pt = th.to_device("cpu")
    for c in HOST_COLUMNS:
        np.testing.assert_array_equal(
            np.asarray(getattr(jh.to_device(), c)), getattr(pt, c).numpy(), err_msg=c
        )


def _pods(mod, n, selector=False):
    out = []
    for i in range(n):
        out.append(mod.PodInfo(
            f"p{i}", cpu_milli=100 + i, mem_kib=(200 + i) << 10,
            node_name="kwok-node-3" if i == 2 else None,
            tolerations=[mod.Toleration(key="dedicated")] if i % 3 == 0 else [],
            node_selector={"topology.kubernetes.io/zone": "zone-1"} if selector and i == 1 else {},
            required_terms=[mod.NodeSelectorTerm([mod.SelectorRequirement(
                "topology.kubernetes.io/zone", SEL_OP_IN, ["zone-2"])])]
            if selector and i == 4 else [],
        ))
    return out


@pytest.mark.parametrize("selector", [False, True])
def test_encode_packed_matches(selector):
    jh, th = _hosts(tainted_fraction=0.2, seed=4)
    jenc = jpe.PodBatchHost(JaxPodSpec(batch=16), jh.spec, jh.vocab)
    tenc = tpe.PodBatchHost(PodSpec(batch=16), th.spec, th.vocab)
    jp = jenc.encode_packed(_pods(jpe, 12, selector))
    tp = tenc.encode_packed(_pods(tpe, 12, selector))
    assert jp.groups == tp.groups
    np.testing.assert_array_equal(jp.ints, tp.ints)
    np.testing.assert_array_equal(jp.bools, tp.bools)
    # unpack_pod_batch: every field, same values.
    jb = jpe.unpack_pod_batch(jp.ints, jp.bools, jp.spec, jp.table_spec, jp.groups)
    tb = tpe.unpack_pod_batch(tp.ints, tp.bools, tp.spec, tp.table_spec, tp.groups, "cpu")
    for f in dataclasses.fields(tb):
        np.testing.assert_array_equal(
            np.asarray(getattr(jb, f.name)), getattr(tb, f.name).numpy(), err_msg=f.name
        )


def test_encode_packed_plain_matches():
    jh, th = _hosts()
    cpu = np.arange(10, dtype=np.int32) + 100
    mem = np.arange(10, dtype=np.int32) + 2000
    jp = jpe.PodBatchHost(JaxPodSpec(batch=16), jh.spec, jh.vocab).encode_packed_plain(cpu, mem)
    tp = tpe.PodBatchHost(PodSpec(batch=16), th.spec, th.vocab).encode_packed_plain(cpu, mem)
    np.testing.assert_array_equal(jp.ints, tp.ints)
    np.testing.assert_array_equal(jp.bools, tp.bools)
    assert jp.groups == tp.groups == frozenset()


# ---- the whole wave ---------------------------------------------------------

WAVE_N = 512
WAVE_CHUNK = 64
WAVE_B = 64


def _wave_state(layout):
    """JAX-package state for the wave differential: a tainted KWOK fleet
    tight enough that pods collide, and a batch with tolerations."""
    spec = JaxTableSpec(max_nodes=WAVE_N)
    host = jnt.NodeTableHost(spec)
    jax_populate(host, WAVE_N - 16, tainted_fraction=0.2, seed=3)
    rng = np.random.default_rng(1)
    live = host.valid
    host.cpu_alloc[:] = np.where(live, rng.integers(300, 1200, WAVE_N), 0)
    host.pods_alloc[:] = np.where(live, rng.integers(1, 4, WAVE_N), 0)
    host.taint_effect[::9, 1] = EFFECT_PREFER_NO_SCHEDULE
    host.taint_id[::9, 1] = host.vocab.taints.intern(("soft", "", EFFECT_PREFER_NO_SCHEDULE))
    host.taint_effect[::13, 2] = EFFECT_NO_SCHEDULE
    host.taint_id[::13, 2] = host.vocab.taints.intern(("hard", "", EFFECT_NO_SCHEDULE))
    enc = jpe.PodBatchHost(JaxPodSpec(batch=WAVE_B), spec, host.vocab)
    pods = [
        jpe.PodInfo(
            f"p{i}", cpu_milli=250 + 10 * (i % 5), mem_kib=200 << 10,
            tolerations=[jpe.Toleration(key="dedicated")] if i % 3 == 0 else [],
        )
        for i in range(WAVE_B - 4)
    ]
    pb = enc.encode_packed(pods)
    if layout == "plain":
        jt = host.to_device()
    else:
        jt = jpk.pack_table_host(host, jpk.build_packing_spec(spec, host.vocab))
    return jt, pb


def _port(jt, pb):
    cols = {
        f.name: np.asarray(getattr(jt, f.name))
        for f in dataclasses.fields(jt) if f.name != "spec"
    }
    table = interop.node_table_from_numpy(cols, getattr(jt, "spec", None), "cpu")
    packed = interop.packed_pod_batch(
        pb.ints, pb.bools, pb.spec, pb.table_spec, pb.groups
    )
    return table, packed


@pytest.mark.parametrize("layout", ["plain", "packed"])
@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_wave_matches_jax(layout, backend):
    jt, pb = _wave_state(layout)
    table, packed = _port(jt, pb)
    rows_s = sample_rows_for(WAVE_N, 25, WAVE_CHUNK)
    assert rows_s == 128
    keys = jax.random.split(jax.random.key(3), 3)
    bound = 0
    for i in range(3):
        off = sample_offset_for(i, WAVE_N, rows_s)
        jt, _c, jasg, jrows = jax_schedule(
            jt, pb, keys[i], profile=JAX_BASE, chunk=WAVE_CHUNK, k=4,
            backend=backend, sample_rows=rows_s, sample_offset=off,
        )
        seed = int(np.asarray(seed_of(keys[i])))
        table, asg, rows = schedule_batch_packed(
            table, packed, seed, profile=BASE, chunk=WAVE_CHUNK, k=4,
            sample_rows=rows_s, sample_offset=off,
        )
        np.testing.assert_array_equal(rows.numpy(), np.asarray(jrows), err_msg=f"wave {i}")
        for f in ("node_row", "bound", "score", "zone", "region"):
            np.testing.assert_array_equal(
                getattr(asg, f).numpy(), np.asarray(getattr(jasg, f)), err_msg=f"{f} wave {i}"
            )
        for c in ("cpu_req", "mem_req", "pods_req"):
            np.testing.assert_array_equal(
                getattr(table, c).numpy(), np.asarray(getattr(jt, c)), err_msg=f"{c} wave {i}"
            )
        bound += int((rows >= 0).sum())
        # Some pods lose their candidates to earlier pods of the batch.
        assert 0 < int((rows >= 0).sum()) < WAVE_B - 4
    assert bound > 0


@pytest.mark.parametrize("layout", ["plain", "packed"])
def test_full_window_wave_matches_jax(layout):
    jt, pb = _wave_state(layout)
    table, packed = _port(jt, pb)
    key = jax.random.key(8)
    jt, _c, jasg, jrows = jax_schedule(
        jt, pb, key, profile=JAX_BASE, chunk=WAVE_CHUNK, k=4, backend="xla",
    )
    table, asg, rows = schedule_batch_packed(
        table, packed, int(np.asarray(seed_of(key))), profile=BASE,
        chunk=WAVE_CHUNK, k=4,
    )
    np.testing.assert_array_equal(rows.numpy(), np.asarray(jrows))
    for c in ("cpu_req", "mem_req", "pods_req"):
        np.testing.assert_array_equal(getattr(table, c).numpy(), np.asarray(getattr(jt, c)))


def test_reference_wave_is_the_same_wave():
    """``reference=True`` (the on-card comparison path) computes the same
    wave as the default path."""
    jt, pb = _wave_state("packed")
    t1, packed = _port(jt, pb)
    t2 = t1.clone()
    _, a1, r1 = schedule_batch_packed(t1, packed, 77, profile=BASE, chunk=WAVE_CHUNK,
                                      sample_rows=128, sample_offset=384)
    _, a2, r2 = schedule_batch_packed(t2, packed, 77, profile=BASE, chunk=WAVE_CHUNK,
                                      sample_rows=128, sample_offset=384, reference=True)
    assert torch.equal(r1, r2) and torch.equal(t1.pods_req, t2.pods_req)


def test_sample_window_helpers():
    assert sample_rows_for(1 << 20, 5, 4096) == 53248
    assert sample_rows_for(1000, 100, 10) is None
    rows = 53248
    offs = [sample_offset_for(i, 1 << 20, rows) for i in range(21)]
    assert offs[:2] == [0, rows] and offs[19] == (1 << 20) - rows and offs[20] == 0


# ---- greedy assign ----------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_greedy_assign_matches_jax_on_collisions(seed):
    """Candidates drawn from a pool of 12 rows, tight capacities: many
    pods compete for the same nodes."""
    rng = np.random.default_rng(seed)
    b, k = 48, 4
    idx = np.stack([rng.permutation(12)[:k] for _ in range(b)]).astype(np.int32)
    prio = np.sort(rng.integers(-1, 1 << 30, size=(b, k)), axis=1)[:, ::-1].astype(np.int32)
    idx = np.where(prio >= 0, idx, -1).astype(np.int32)
    idx[5, 1] = -1                      # a dropped candidate with a live prio
    free_cpu = rng.integers(0, 900, 12)
    free_mem = rng.integers(0, 4000, 12)
    free_pods = rng.integers(0, 4, 12)
    safe = np.clip(idx, 0, None)
    args = [
        idx, prio, free_cpu[safe].astype(np.int32), free_mem[safe].astype(np.int32),
        free_pods[safe].astype(np.int32),
        rng.integers(50, 400, b).astype(np.int32),
        rng.integers(100, 1500, b).astype(np.int32),
        rng.random(b) < 0.9,
    ]
    want = jax_greedy(*[jax.numpy.asarray(a) for a in args])
    got = greedy_assign(*[torch.from_numpy(np.ascontiguousarray(a)) for a in args])
    for name, g, w in zip(("node_row", "bound", "score", "chosen_k"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    bound = got[1].numpy()
    assert bound.any() and not bound.all()


# ---- loud failures ----------------------------------------------------------


def _packed_for(selector):
    jh, th = _hosts()
    enc = tpe.PodBatchHost(PodSpec(batch=16), th.spec, th.vocab)
    return th, enc.encode_packed(_pods(tpe, 8, selector))


@pytest.mark.parametrize("bad, exc", [
    # Row masks and the mesh are ported; a mask that is not a bool[N]
    # tensor, or a mesh that is not a parallel.Mesh, raises.
    pytest.param("row_mask", TypeError, id="row_mask"),
    pytest.param("mesh", TypeError, id="mesh"),
])
def test_unsupported_waves_raise(bad, exc):
    th, packed = _packed_for(True)
    table = th.to_device("cpu")
    with pytest.raises(exc):
        schedule_batch_packed(table, packed, 1, profile=BASE, chunk=32, **{bad: object()})


def test_constraint_profile_raises():
    th, packed = _packed_for(False)
    with pytest.raises(ValueError):
        schedule_batch_packed(th.to_device("cpu"), packed, 1, profile=Profile(), chunk=32)


def test_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    th, packed = _packed_for(False)
    with pytest.raises(RuntimeError):
        th.to_device()
    with pytest.raises(RuntimeError):
        tpe.unpack_pod_batch(packed.ints, packed.bools, packed.spec,
                             packed.table_spec, packed.groups)
