"""The port's CUDA kernel against its plain PyTorch version, on the card.

Every test here is marked ``gpu`` and skips where
``torch.cuda.is_available()`` is False (the decision is taken inside the
``cuda`` fixture, never at import).  The file imports no JAX, so it runs
on a machine that has only PyTorch and the CUDA toolkit:

    python -m pytest tests/test_torch_gpu.py -q

Tolerance: exact equality — every output is an integer.
"""

import _torch_cpu  # noqa: F401  (bounds torch's CPU threads first)

import dataclasses

import numpy as np
import pytest
import torch

from k8s1m_tpu_torch.cluster import populate_kwok_nodes, uniform_pods
from k8s1m_tpu_torch.cluster.testbeds import (
    WIDE_SWEEP,
    affinity_pods,
    constraint_fleet,
    constraint_pods,
    labeled_fleet,
    wide_fleet,
    wide_pods,
)
from k8s1m_tpu_torch.config import (
    EFFECT_NO_EXECUTE,
    EFFECT_PREFER_NO_SCHEDULE,
    PodSpec,
    TableSpec,
)
from k8s1m_tpu_torch.engine.cycle import _prologue_stats, schedule_batch_packed
from k8s1m_tpu_torch.ops.fused_topk import fused_topk, fused_topk_reference
from k8s1m_tpu_torch.plugins.registry import Profile
from k8s1m_tpu_torch.snapshot.constraints import FIELDS as CONSTRAINT_FIELDS
from k8s1m_tpu_torch.snapshot.constraints import (
    ConstraintTracker,
    empty_constraints,
    slice_constraints,
)
from k8s1m_tpu_torch.snapshot.node_table import NodeTableHost
from k8s1m_tpu_torch.snapshot.packing import build_packing_spec, pack_table_host
from k8s1m_tpu_torch.snapshot.pod_encoding import (
    PodBatchHost,
    PodInfo,
    Toleration,
    unpack_pod_batch,
)

BASE = Profile(node_affinity=0, topology_spread=0, interpod_affinity=0)
N = 4096
B = 300          # not a multiple of the kernel's 128-pod tile


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernel runs only on a card")
    return torch.device("cuda")


def _state(near_full=False):
    spec = TableSpec(max_nodes=N)
    host = NodeTableHost(spec)
    live = N - 100
    populate_kwok_nodes(host, live, tainted_fraction=0.2, seed=5)
    host.taint_id[:live:6, 1] = host.vocab.taints.intern(("soft", "", EFFECT_PREFER_NO_SCHEDULE))
    host.taint_effect[:live:6, 1] = EFFECT_PREFER_NO_SCHEDULE
    host.taint_id[:live:17, 2] = host.vocab.taints.intern(("evict", "", EFFECT_NO_EXECUTE))
    host.taint_effect[:live:17, 2] = EFFECT_NO_EXECUTE
    rng = np.random.default_rng(0)
    host.cpu_req[:live] = rng.integers(0, 4000, live)
    if near_full:
        full = np.arange(live)[np.arange(live) % 1500 != 3]  # three rows keep room
        host.pods_req[full] = host.pods_alloc[full]
    pods = [
        PodInfo(f"p{i}", cpu_milli=100 + 13 * (i % 50), mem_kib=(64 + i) << 10,
                tolerations=[Toleration(key="dedicated")] if i % 2 else
                [Toleration(key="soft")] if i % 3 == 0 else [],
                node_name="kwok-node-9" if i == 4 else None)
        for i in range(B - 5)
    ]
    pb = PodBatchHost(PodSpec(batch=B), spec, host.vocab).encode_packed(pods)
    return spec, host, pb


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["plain", "packed"])
@pytest.mark.parametrize("near_full", [False, True])
@pytest.mark.parametrize("k,stratum_bits,row_base,col_base", [
    (4, 0, 0, 0), (4, 11, 3, 512), (1, 20, 0, 9), (7, 0, 0, 0), (128, 5, 0, 0),
])
def test_kernel_matches_plain_version(cuda, layout, near_full, k, stratum_bits,
                                      row_base, col_base):
    spec, host, pb = _state(near_full)
    table = (host.to_device(cuda) if layout == "plain" else
             pack_table_host(host, build_packing_spec(spec, host.vocab), cuda))
    batch = unpack_pod_batch(pb.ints, pb.bools, pb.spec, pb.table_spec, pb.groups, cuda)
    view = table.narrow(1000, 2048)       # a window: base pointer + row count
    kw = dict(k=k, row_base=row_base, col_base=col_base, stratum_bits=stratum_bits)
    for t in (table, view):
        before = fused_topk.launches
        idx, prio = fused_topk(t, batch, -123457, BASE, **kw)
        torch.cuda.synchronize()
        assert fused_topk.launches == before + 1
        ridx, rprio = fused_topk_reference(t, batch, -123457, BASE, **kw)
        assert torch.equal(prio, rprio)
        assert torch.equal(idx, ridx)
        assert (rprio >= 0).any()


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["plain", "packed"])
def test_wave_matches_plain_version(cuda, layout):
    spec = TableSpec(max_nodes=N)
    host = NodeTableHost(spec)
    populate_kwok_nodes(host, N - 64)
    host.cpu_alloc[:] = np.where(host.valid, 700, 0)        # pods collide
    table = (host.to_device(cuda) if layout == "plain" else
             pack_table_host(host, build_packing_spec(spec, host.vocab), cuda))
    pb = PodBatchHost(PodSpec(batch=512), spec, host.vocab).encode_packed(
        uniform_pods(500, cpu_milli=300))
    ref = table.clone()
    for i, off in enumerate((0, 1024, 3072)):
        table, asg, rows = schedule_batch_packed(
            table, pb, 1000 + i, profile=BASE, chunk=256, sample_rows=1024,
            sample_offset=off)
        ref, rasg, rrows = schedule_batch_packed(
            ref, pb, 1000 + i, profile=BASE, chunk=256, sample_rows=1024,
            sample_offset=off, reference=True)
        assert torch.equal(rows, rrows)
        for c in ("cpu_req", "mem_req", "pods_req"):
            assert torch.equal(getattr(table, c), getattr(ref, c))
        assert 0 < int((rows >= 0).sum()) < 500


AFF = Profile(topology_spread=0, interpod_affinity=0)
AN = 2048        # affinity and constraint fleets
AB = 300


def _aff_tables(cuda):
    spec, host = labeled_fleet(AN, seed=3)
    pb = PodBatchHost(PodSpec(batch=AB), spec, host.vocab).encode_packed(affinity_pods(AB - 7, AN))
    assert {"sel", "req", "pref", "qkey"} <= pb.groups
    tables = {
        "plain": host.to_device(cuda),
        "packed": pack_table_host(host, build_packing_spec(spec, host.vocab), cuda),
        "packed-unfused": pack_table_host(
            host, build_packing_spec(spec, host.vocab, fuse_labels=False), cuda),
    }
    assert tables["packed"].spec.fuse_labels and not tables["packed-unfused"].spec.fuse_labels
    batch = unpack_pod_batch(pb.ints, pb.bools, pb.spec, pb.table_spec, pb.groups, cuda)
    return tables, batch


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["plain", "packed", "packed-unfused"])
@pytest.mark.parametrize("k,stratum_bits,row_base,col_base", [
    (4, 0, 0, 0), (4, 11, 5, 300), (9, 3, 0, 0),
])
def test_affinity_stage_matches_plain_version(cuda, layout, k, stratum_bits, row_base,
                                              col_base):
    tables, batch = _aff_tables(cuda)
    table = tables[layout]
    kw = dict(k=k, row_base=row_base, col_base=col_base, stratum_bits=stratum_bits,
              with_affinity=True)
    for t in (table, table.narrow(700, 1024)):
        before = dict(fused_topk.launches_by_stage)
        idx, prio = fused_topk(t, batch, 424242, AFF, **kw)
        torch.cuda.synchronize()
        assert fused_topk.launches_by_stage["aff"] == before["aff"] + 1
        ridx, rprio = fused_topk_reference(t, batch, 424242, AFF, **kw)
        assert torch.equal(prio, rprio)
        assert torch.equal(idx, ridx)
        assert (rprio >= 0).any() and (rprio < 0).any()


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["plain", "packed", "packed-unfused"])
def test_affinity_stage_last_matching_slot_wins(cuda, layout):
    """A node whose label slots repeat a key (the host never writes one):
    the kernel and the plain version both take the last matching slot."""
    tables, batch = _aff_tables(cuda)
    t = tables[layout]
    rows = torch.arange(0, AN - 8, 2, device=cuda)        # "disk" sits in slot 0
    if layout == "packed":
        kb = t.spec.key_bits
        key = t.label_key[rows, 0] & ((1 << kb) - 1)
        t.label_key[rows, -1] = ((t.label_key[rows, 1] >> kb) << kb) | key
    else:
        t.label_key[rows, -1] = t.label_key[rows, 0]
        t.label_val[rows, -1] = t.label_val[rows, 1]
    t.label_num[rows, -1] = 5
    kw = dict(k=4, with_affinity=True)
    idx, prio = fused_topk(t, batch, 99, AFF, **kw)
    ridx, rprio = fused_topk_reference(t, batch, 99, AFF, **kw)
    assert torch.equal(prio, rprio) and torch.equal(idx, ridx)


def _wide_state(cuda, shape):
    """The tables (plain, and packed where the taint slots fit its meta
    word) and batch of one WIDE_SWEEP point at AN rows x AB pods."""
    q, v, p, ts, m = shape
    spec = TableSpec(max_nodes=AN, taint_slots=ts, max_taint_ids=m)
    host = wide_fleet(NodeTableHost(spec), seed=ts + m)
    pods = wide_pods(AB - 5, query_keys=q, values=v, pref_terms=p, max_taint_ids=m, seed=q)
    pb = PodBatchHost(PodSpec(batch=AB, query_keys=q, aff_values=v, pref_terms=p), spec,
                      host.vocab).encode_packed(pods)
    tables = {"plain": host.to_device(cuda)}
    if 1 + 2 * ts <= 31:
        packed = pack_table_host(host, build_packing_spec(spec, host.vocab), cuda)
        tables["packed"] = packed
        # The packed layout's i32 taint ids (past 2^15 ids) at this shape.
        tables["packed-i32-taints"] = dataclasses.replace(
            packed, taint_id=packed.taint_id.to(torch.int32))
    batch = unpack_pod_batch(pb.ints, pb.bools, pb.spec, pb.table_spec, pb.groups, cuda)
    return tables, batch


@pytest.mark.gpu
@pytest.mark.parametrize("shape", WIDE_SWEEP, ids=lambda s: "q{}-v{}-p{}-ts{}-m{}".format(*s))
def test_wide_shapes_match_plain_version(cuda, shape):
    """Every WIDE_SWEEP point — query keys, In/NotIn values, preferred
    terms, taint slots and taint ids past the kernel's fast paths — on
    the base and affinity stages, whole table and a window: the kernel
    equals the plain version."""
    tables, batch = _wide_state(cuda, shape)
    for layout, table in tables.items():
        for t in (table, table.narrow(300, 1024)):
            for with_aff, profile in ((False, BASE), (True, AFF)):
                kw = dict(k=4, stratum_bits=7, row_base=3, with_affinity=with_aff)
                idx, prio = fused_topk(t, batch, 31337, profile, **kw)
                torch.cuda.synchronize()
                ridx, rprio = fused_topk_reference(t, batch, 31337, profile, **kw)
                assert torch.equal(prio, rprio), (layout, with_aff)
                assert torch.equal(idx, ridx), (layout, with_aff)
                assert (rprio >= 0).any() and (rprio < 0).any()


def _cons_state(cuda, layout, with_selectors):
    spec, host = constraint_fleet(AN)
    tracker = ConstraintTracker(spec)
    pods = constraint_pods(tracker, 3 * AB, seed=1, with_selectors=with_selectors)
    enc = PodBatchHost(PodSpec(batch=AB), spec, host.vocab)
    table = (host.to_device(cuda) if layout == "plain" else
             pack_table_host(host, build_packing_spec(spec, host.vocab), cuda))
    cons = empty_constraints(spec, cuda)
    for w in range(2):          # two earlier waves populate the count tables
        schedule_batch_packed(table, enc.encode_packed(pods[w * AB:(w + 1) * AB]), 77 + w,
                              profile=Profile(), constraints=cons, chunk=256,
                              reference=True)
    pb = enc.encode_packed(pods[2 * AB:])
    batch = unpack_pod_batch(pb.ints, pb.bools, pb.spec, pb.table_spec, pb.groups, cuda)
    assert int(cons.tgt_node.sum()) > 0 and int(cons.spread_zone.sum()) > 0
    return table, cons, batch, bool(pb.groups & {"sel", "req", "pref"})


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["plain", "packed"])
@pytest.mark.parametrize("with_selectors", [False, True])
def test_constraint_stage_matches_plain_version(cuda, layout, with_selectors):
    table, cons, batch, aff = _cons_state(cuda, layout, with_selectors)
    assert aff == with_selectors
    stats = _prologue_stats(table, cons)
    stage = "aff+cons" if aff else "cons"
    for off, rows in ((0, AN), (512, 1024)):   # whole table, then a window view
        view = table.narrow(off, rows)
        vcons = slice_constraints(cons, off, rows)
        assert rows == AN or not vcons.tgt_node.is_contiguous()
        kw = dict(k=4, with_affinity=aff, constraints=vcons, stats=stats, stratum_bits=7)
        before = dict(fused_topk.launches_by_stage)
        idx, prio = fused_topk(view, batch, -5, Profile(), **kw)
        torch.cuda.synchronize()
        assert fused_topk.launches_by_stage[stage] == before[stage] + 1
        ridx, rprio = fused_topk_reference(view, batch, -5, Profile(), **kw)
        assert torch.equal(prio, rprio)
        assert torch.equal(idx, ridx)
        assert (rprio >= 0).any()


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["plain", "packed"])
def test_constrained_wave_matches_plain_version(cuda, layout):
    table, cons, batch, _ = _cons_state(cuda, layout, True)
    spec, host = constraint_fleet(AN)
    tracker = ConstraintTracker(spec)
    pods = constraint_pods(tracker, AB, seed=4, with_selectors=True)
    pb = PodBatchHost(PodSpec(batch=AB), spec, host.vocab).encode_packed(pods)
    ref, rcons = table.clone(), cons.clone()
    for i, off in enumerate((0, 1024)):
        kw = dict(profile=Profile(), chunk=256, sample_rows=1024, sample_offset=off)
        table, asg, rows = schedule_batch_packed(table, pb, 31 + i, constraints=cons, **kw)
        ref, rasg, rrows = schedule_batch_packed(ref, pb, 31 + i, constraints=rcons,
                                                 reference=True, **kw)
        assert torch.equal(rows, rrows)
        for c in ("cpu_req", "mem_req", "pods_req"):
            assert torch.equal(getattr(table, c), getattr(ref, c))
        for f in CONSTRAINT_FIELDS:
            assert torch.equal(getattr(cons, f), getattr(rcons, f))
        assert int((rows >= 0).sum()) > 0


@pytest.mark.gpu
def test_wrapper_rejects_wrong_dtype(cuda):
    spec, host, pb = _state()
    table = host.to_device(cuda)
    batch = unpack_pod_batch(pb.ints, pb.bools, pb.spec, pb.table_spec, pb.groups, cuda)
    table.cpu_req = table.cpu_req.to(torch.int64)
    with pytest.raises(ValueError):
        fused_topk(table, batch, 1, BASE, k=4)


# ---- the deltasched plane tail (csrc/delta_topk.cu) ------------------------


def _delta_planes(cuda, s, n, b, seed):
    """Random planes (scores outside [0, 2047], negatives included), padding
    pods at slot S and, for S >= 2, a slot with no feasible column."""
    rng = np.random.default_rng(seed)
    mask = rng.random((s, n)) < 0.6
    score = rng.integers(-3000, 5000, (s, n)).astype(np.int32)
    dead = max(s - 2, 0)
    if s >= 2:
        mask[dead] = False
    slot = np.concatenate([rng.integers(0, s, b - 5), [dead, s - 1, s, s, s]]).astype(np.int32)
    return tuple(torch.from_numpy(a).to(cuda) for a in (mask, score, slot, slot < s))


@pytest.mark.gpu
@pytest.mark.parametrize("s,n,b,k,stratum_bits,row_offset,pod_offset", [
    (1, 4096, 300, 4, 0, 0, 0), (8, 8192, 300, 4, 11, 4096, 7), (64, 4096, 520, 4, 0, 0, 0),
    (64, 2048, 200, 128, 11, 3, 129), (130, 2048, 260, 9, 5, 0, 0), (8, 1000 * 4, 33, 1, 20, 0, 0),
])
def test_delta_kernel_matches_plain_version(cuda, s, n, b, k, stratum_bits, row_offset,
                                            pod_offset):
    from k8s1m_tpu_torch.engine.deltacache import plane_topk
    from k8s1m_tpu_torch.ops.delta_topk import delta_plane_topk

    pm, ps, slot, real = _delta_planes(cuda, s, n, b, s + k)
    kw = dict(chunk=1000 if n == 4000 else 512, k=k, stratum_bits=stratum_bits,
              row_offset=row_offset, pod_offset=pod_offset)
    for seed in (0, -98765, 2 ** 31 - 1):
        before = delta_plane_topk.launches
        got = delta_plane_topk(pm, ps, slot, seed, **kw)
        torch.cuda.synchronize()
        assert delta_plane_topk.launches == before + 1
        ref = plane_topk(pm, ps, slot, seed, **kw)
        assert torch.equal(got.idx[real], ref.idx[real])
        assert torch.equal(got.prio[real], ref.prio[real])
        assert bool((ref.prio[real] >= 0).any())
        assert bool((ref.prio[real] < 0).any()) == (s >= 2)


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["plain", "packed"])
def test_delta_wave_matches_plain_version(cuda, layout):
    """Three churned delta waves with the kernel and with the plain tail
    (``backend="xla"``) from clones: identical rows, table and planes;
    and each equals the full wave from the same table."""
    from k8s1m_tpu_torch.cluster.workload import node_affinity_pods
    from k8s1m_tpu_torch.engine.cycle import fill_shape_planes, schedule_batch_delta
    from k8s1m_tpu_torch.ops.delta_topk import delta_plane_topk
    from k8s1m_tpu_torch.snapshot.hotfeed import shape_key
    from k8s1m_tpu_torch.snapshot.node_table import scatter_rows

    spec = TableSpec(max_nodes=N)
    host = NodeTableHost(spec)
    populate_kwok_nodes(host, N - 64, zones=8, regions=3)
    host.cpu_alloc[:] = np.where(host.valid, 900, 0)         # pods collide
    table = (host.to_device(cuda) if layout == "plain" else
             pack_table_host(host, build_packing_spec(spec, host.vocab), cuda))
    pods = node_affinity_pods(400, zones=8, regions=3, cpu_milli=300)
    pspec = PodSpec(batch=400, aff_terms=1, aff_exprs=2, aff_values=2, pref_terms=1)
    pb = PodBatchHost(pspec, spec, host.vocab).encode_packed(pods)
    keys = [shape_key(p) for p in pods]
    shapes = list(dict.fromkeys(keys))
    slot = np.array([shapes.index(x) for x in keys], np.int32)
    reps = PodBatchHost(PodSpec(batch=len(shapes), aff_terms=1, aff_exprs=2, aff_values=2,
                                pref_terms=1), spec, host.vocab).encode_packed(
        [pods[keys.index(x)] for x in shapes])
    s = len(shapes)
    planes = (torch.zeros((s, N), dtype=torch.bool, device=cuda),
              torch.zeros((s, N), dtype=torch.int32, device=cuda))
    fill_shape_planes(table, reps, np.arange(s, dtype=np.int32), planes, profile=AFF,
                      chunk=512)
    rng = np.random.default_rng(4)
    prev = None
    for w in range(3):
        churn = np.sort(rng.choice(N - 64, 8, replace=False)).astype(np.int32)
        scatter_rows(table, churn, {"cpu_req": rng.integers(0, 600, 8)})
        ref_t, ref_p = table.clone(), (planes[0].clone(), planes[1].clone())
        full_t, _fa, full_rows = schedule_batch_packed(table.clone(), pb, 50 + w, profile=AFF,
                                                       chunk=512)
        kw = dict(profile=AFF, slot_ids=slot, dirty=churn,
                  inflight_rows=() if prev is None else (prev,), chunk=512, k=4)
        before = delta_plane_topk.launches
        table, _a, rows, planes = schedule_batch_delta(table, pb, 50 + w, planes=planes, **kw)
        torch.cuda.synchronize()
        assert delta_plane_topk.launches == before + 1
        ref_t, _ra, ref_rows, ref_p = schedule_batch_delta(ref_t, pb, 50 + w, planes=ref_p,
                                                           backend="xla", **kw)
        assert torch.equal(rows, ref_rows) and torch.equal(rows, full_rows)
        for c in ("cpu_req", "mem_req", "pods_req"):
            assert torch.equal(getattr(table, c), getattr(ref_t, c))
            assert torch.equal(getattr(table, c), getattr(full_t, c))
        assert torch.equal(planes[0], ref_p[0]) and torch.equal(planes[1], ref_p[1])
        assert int((rows >= 0).sum()) > 0
        prev = rows


# ---- pod groups, tiles and ties of the redesigned kernels -------------------


def _regroup(batch, src, cpu=None):
    """The batch with pod i replaced by pod src[i] in every per-pod field
    (and, if given, cpu requests ``cpu``): sets which pods share a group."""
    import dataclasses

    idx = torch.as_tensor(src, device=batch.cpu.device).long()
    fields = {f.name: getattr(batch, f.name) for f in dataclasses.fields(batch)}
    out = {name: t if name == "qkey" else t[idx].contiguous() for name, t in fields.items()}
    if cpu is not None:
        out["cpu"] = torch.as_tensor(cpu, dtype=torch.int32, device=batch.cpu.device)
    return type(batch)(**out)


def _stage_state(cuda, stage, layout):
    """(table, batch, kw, profile) of one stage configuration at N rows."""
    if stage == "base":
        spec, host, pb = _state()
        table = (host.to_device(cuda) if layout == "plain" else
                 pack_table_host(host, build_packing_spec(spec, host.vocab), cuda))
        batch = unpack_pod_batch(pb.ints, pb.bools, pb.spec, pb.table_spec, pb.groups, cuda)
        return table, batch, {}, BASE
    if stage == "aff":
        tables, batch = _aff_tables(cuda)
        return tables[layout], batch, dict(with_affinity=True), AFF
    table, cons, batch, aff = _cons_state(cuda, layout, stage == "aff+cons")
    return table, batch, dict(with_affinity=aff, constraints=cons,
                              stats=_prologue_stats(table, cons)), Profile()


GROUP_CASES = ("distinct", "forty", "scattered", "unaligned")


@pytest.mark.gpu
@pytest.mark.parametrize("stage", ["base", "aff", "cons", "aff+cons"])
@pytest.mark.parametrize("layout", ["plain", "packed"])
@pytest.mark.parametrize("k", [4, 128])
@pytest.mark.parametrize("case", GROUP_CASES)
def test_kernel_pod_groups_match_plain_version(cuda, stage, layout, k, case):
    """Blocks of 128 distinct pods (32-row tiles), of ~40 groups (64-row
    tiles, more than one 128-row staging pass takes), one group scattered
    over the batch, and a window whose i16/i8 packed columns start off any
    4-byte boundary: bit-equal to the plain version."""
    table, batch, kw, profile = _stage_state(cuda, stage, layout)
    b = batch.batch
    i = np.arange(b)
    if case == "distinct":
        batch = _regroup(batch, i, cpu=60 + i)
    elif case == "forty":
        batch = _regroup(batch, i % 40)
    elif case == "scattered":
        batch = _regroup(batch, np.where(i % 7 == 3, 1, i))
    rows = table.num_rows
    off, n = (1001, rows - 1003) if case == "unaligned" else (0, rows)
    view = table.narrow(off, n)
    if "constraints" in kw:
        kw = dict(kw, constraints=slice_constraints(kw["constraints"], off, n))
    kw = dict(kw, k=k, stratum_bits=7, row_base=3, col_base=off)
    idx, prio = fused_topk(view, batch, -2024, profile, **kw)
    torch.cuda.synchronize()
    ridx, rprio = fused_topk_reference(view, batch, -2024, profile, **kw)
    assert torch.equal(prio, rprio)
    assert torch.equal(idx, ridx)
    assert (rprio >= 0).any()


def _np_mix32(h):
    h = h ^ (h >> 16)
    h = (h * 0x7FEB352D) & 0xFFFFFFFF
    h = h ^ (h >> 15)
    h = (h * 0x846CA68B) & 0xFFFFFFFF
    return h ^ (h >> 16)


def _tied_columns(seed, near: bool):
    """Two global columns c1 < c2 whose 20 hash bits are equal for every
    pod (stratum bits 0: (col hash ^ row hash) & m ties when the column
    hashes tie in their low 20 bits); ``near``: under 64 apart, else 300
    to 3000 apart."""
    cols = np.arange(1 << 22, dtype=np.uint64)
    ch = _np_mix32((seed & 0xFFFFFFFF) ^ ((cols * 0x85EBCA6B) & 0xFFFFFFFF)) & 0xFFFFF
    order = np.argsort(ch, kind="stable")
    same = ch[order[1:]] == ch[order[:-1]]
    for a, b in zip(order[:-1][same], order[1:][same]):
        c1, c2 = sorted((int(a), int(b)))
        if (c2 - c1 < 64) if near else (300 <= c2 - c1 <= 3000):
            return c1, c2
    raise AssertionError("no tied columns found")


@pytest.mark.gpu
@pytest.mark.parametrize("near", [True, False])
@pytest.mark.parametrize("k", [4, 128])
def test_kernel_tie_goes_to_the_earlier_row(cuda, near, k):
    """Only two rows feasible, equal scores, equal hash bits: the earlier
    row ranks first, inside one tile (near) and across splits (far)."""
    seed = 777
    c1, c2 = _tied_columns(seed, near)
    spec = TableSpec(max_nodes=N)
    host = NodeTableHost(spec)
    populate_kwok_nodes(host, N, tainted_fraction=0.0)
    host.pods_req[:] = host.pods_alloc                 # every row full ...
    lo = 10
    for r in (lo, lo + c2 - c1):                       # ... but two
        host.pods_req[r] = 0
        host.cpu_req[r] = 0
        host.mem_req[r] = 0
        host.cpu_alloc[r] = 4000
        host.mem_alloc[r] = 8 << 20
    pb = PodBatchHost(PodSpec(batch=B), spec, host.vocab).encode_packed(uniform_pods(B - 3))
    batch = unpack_pod_batch(pb.ints, pb.bools, pb.spec, pb.table_spec, pb.groups, cuda)
    for table in (host.to_device(cuda),
                  pack_table_host(host, build_packing_spec(spec, host.vocab), cuda)):
        kw = dict(k=k, col_base=c1 - lo)
        idx, prio = fused_topk(table, batch, seed, BASE, **kw)
        torch.cuda.synchronize()
        ridx, rprio = fused_topk_reference(table, batch, seed, BASE, **kw)
        assert torch.equal(prio, rprio) and torch.equal(idx, ridx)
        real = batch.valid
        assert bool((prio[real, 0] == prio[real, 1]).all() & (prio[real, 0] >= 0).all())
        assert bool((idx[real, 0] == lo).all() & (idx[real, 1] == lo + c2 - c1).all())


@pytest.mark.gpu
@pytest.mark.parametrize("near", [True, False])
@pytest.mark.parametrize("k", [1, 4, 16, 128])
def test_delta_kernel_tie_goes_to_the_earlier_column(cuda, near, k):
    from k8s1m_tpu_torch.engine.deltacache import plane_topk
    from k8s1m_tpu_torch.ops.delta_topk import delta_plane_topk

    seed = -4242
    c1, c2 = _tied_columns(seed, near)
    n, lo = 4096, 10
    mask = np.zeros((2, n), bool)
    mask[0, [lo, lo + c2 - c1]] = True
    mask[1] = np.random.default_rng(1).random(n) < 0.5
    score = np.full((2, n), 900, np.int32)
    slot = np.array([0] * 100 + [1] * 50 + [0] * 30, np.int32)
    pm, ps, st = (torch.from_numpy(a).to(cuda) for a in (mask, score, slot))
    kw = dict(chunk=512, k=k, row_offset=c1 - lo, pod_offset=5)
    got = delta_plane_topk(pm, ps, st, seed, **kw)
    torch.cuda.synchronize()
    ref = plane_topk(pm, ps, st, seed, **kw)
    assert torch.equal(got.idx, ref.idx) and torch.equal(got.prio, ref.prio)
    tied = st == 0
    if k >= 2:
        assert bool((got.idx[tied, 0] == c1).all() & (got.idx[tied, 1] == c2).all())
        assert bool((got.prio[tied, 0] == got.prio[tied, 1]).all())
    else:
        assert bool((got.idx[tied, 0] == c1).all())


# ---- the coordinator on the card --------------------------------------------


def _bench_stored(device, batch, **over):
    """``tools/sched_bench.run`` at 16,384 nodes, pipelined at depth 3,
    with a zero-delay, zero-jitter retry policy (a retried pod's next wave
    does not depend on the clock): (stored pod values, host request
    columns, device request columns, report)."""
    from k8s1m_tpu_torch.faultline import RetryPolicy
    from k8s1m_tpu_torch.store.native import list_prefix
    from k8s1m_tpu_torch.tools import sched_bench

    args = sched_bench.parse_args([
        "--nodes", "16384", "--pods", "8192", "--batch", str(batch), "--chunk", "1024",
        "--depth", "3", "--packing", "packed", "--device", device,
    ])
    for k, v in over.items():
        setattr(args, k, v)
    report, coord, store = sched_bench.run(
        args, retry_policy=RetryPolicy("coordinator.bind", base_delay_s=0.0, jitter=0.0))
    try:
        coord.flush()
        kvs, _rev = list_prefix(store, b"/registry/pods/")
        req = {c: getattr(coord.host, c).copy() for c in ("cpu_req", "mem_req", "pods_req")}
        dev = {c: getattr(coord.table, c).cpu().numpy() for c in req}
        return {kv.key: kv.value for kv in kvs}, req, dev, report
    finally:
        coord.close()
        store.close()


@pytest.fixture
def slow_card(monkeypatch):
    """Keep the card busy for ~20 ms after every wave, before the
    coordinator queues the copy of its bound rows: on an idle card the
    copy lands within microseconds, and a retire that forgot to wait for
    it would still read the right bytes."""
    from k8s1m_tpu_torch.control import coordinator

    def slowed(fn):
        def wave(table, *args, **kw):
            out = fn(table, *args, **kw)
            if table.cpu_req.is_cuda:
                torch.cuda._sleep(40_000_000)
            return out
        return wave

    for name in ("schedule_batch_packed", "schedule_batch_delta"):
        monkeypatch.setattr(coordinator, name, slowed(getattr(coordinator, name)))


def _spread_anti_waves(waves: int, per: int):
    """``waves`` lists of (key, value): ``per`` zone-spread (maxSkew 1) and
    ``per`` hostname anti-affinity pods each, from the port's
    ``spread_deployment``/``affinity_deployment`` with their raw specs."""
    from k8s1m_tpu_torch.cluster.workload import affinity_deployment, spread_deployment
    from k8s1m_tpu_torch.control.objects import encode_pod, pod_key
    from k8s1m_tpu_torch.snapshot.constraints import ConstraintTracker

    spread = [{"topologyKey": "topology.kubernetes.io/zone", "maxSkew": 1,
               "whenUnsatisfiable": "DoNotSchedule",
               "labelSelector": {"matchLabels": {"app": "sp"}}}]
    anti = {"podAntiAffinity": {"requiredDuringSchedulingIgnoredDuringExecution": [{
        "topologyKey": "kubernetes.io/hostname",
        "labelSelector": {"matchLabels": {"app": "anti"}}}]}}
    tracker = ConstraintTracker(TableSpec(max_nodes=16))
    out = []
    for w in range(waves):
        items = [(pod_key(p.namespace, p.name), encode_pod(p, raw_spread=spread))
                 for p in spread_deployment(tracker, "sp", per, start=w * per, cpu_milli=10)]
        items += [(pod_key(p.namespace, p.name), encode_pod(p, raw_affinity=anti))
                  for p in affinity_deployment(tracker, "anti", per, anti=True,
                                               start=w * per, cpu_milli=10)]
        out.append(items)
    return out


def _drive_stored(device, case):
    """A coordinator built here (not through sched_bench) over 16,384 KWOK
    nodes, pipelined at depth 3, packed, zero-delay retries: ``constraints``
    runs the full Profile with count tables over 4 waves of 512 spread +
    512 anti pods; ``adaptive`` writes waves of 5, 100, 300 and 1500 pods
    into 1024-pod adaptive buckets.  Returns (stored pod values, the count
    tables or None, the fused kernel's launches by stage)."""
    from k8s1m_tpu_torch.control.coordinator import Coordinator
    from k8s1m_tpu_torch.control.objects import encode_node, encode_pod, node_key, pod_key
    from k8s1m_tpu_torch.faultline import RetryPolicy
    from k8s1m_tpu_torch.ops import fused_topk as ft
    from k8s1m_tpu_torch.store.native import MemStore, list_prefix
    from k8s1m_tpu_torch.tools.make_nodes import build_node

    store = MemStore()
    store.put_batch([(node_key(f"kwok-node-{i}"), encode_node(build_node(i)))
                     for i in range(16384)])
    kw = dict(chunk=1024, pipeline=True, depth=3, packing="packed", score_pct=25,
              retry_policy=RetryPolicy("coordinator.bind", base_delay_s=0.0, jitter=0.0),
              device=device)
    if case == "constraints":
        coord = Coordinator(store, TableSpec(max_nodes=16384, max_zones=128, max_regions=16),
                            PodSpec(batch=1024, spread_refs=1, affinity_refs=1,
                                    spread_incs=1, ipa_incs=1),
                            Profile(), with_constraints=True, **kw)
        waves = _spread_anti_waves(4, 512)
    else:
        coord = Coordinator(store, TableSpec(max_nodes=16384), PodSpec(batch=1024), BASE,
                            with_constraints=False, adaptive_batch=True, **kw)
        waves, off = [], 0
        for n in (5, 100, 300, 1500):
            waves.append([(pod_key("default", f"a-{off + i}"),
                           encode_pod(PodInfo(f"a-{off + i}", cpu_milli=10, mem_kib=1024)))
                          for i in range(n)])
            off += n
    try:
        coord.bootstrap()
        ft.reset_launches()
        for items in waves:
            store.put_batch(items)
            coord.step()
        coord.run_until_idle()
        coord.flush()
        kvs, _rev = list_prefix(store, b"/registry/pods/")
        cons = None
        if coord.constraints is not None:
            cons = {f: getattr(coord.constraints, f).cpu() for f in CONSTRAINT_FIELDS}
        return ({kv.key: kv.value for kv in kvs}, cons,
                dict(ft.fused_topk.launches_by_stage))
    finally:
        coord.close()
        store.close()


@pytest.mark.gpu
@pytest.mark.parametrize("path", ["fused", "fused-serial", "delta", "xla", "shape-pool",
                                  "constraints", "adaptive"])
def test_coordinator_on_card_equals_cpu(cuda, slow_card, path):
    """The coordinator on the card leaves the same bytes in the store as
    with device='cpu', pipelined at depth 3 and (``-serial``) unpipelined.
    Its retire reads each wave's bound rows from a pinned buffer filled by
    a non-blocking copy; reading before the copy's event completes binds
    from stale bytes, which only a card shows — unpipelined, the retire
    follows the launch at once, and ``slow_card`` holds the copy back.
    The delta case runs the candidate index with 9 stratum bits (~32 tied
    rows per class at 16,384 nodes, the megarow sizing), and pods retry.
    ``xla`` runs the scan path on the card; ``shape-pool`` NodeAffinity
    template pods (the kernel's ``aff`` stage); ``constraints`` the count
    tables (``cons`` stage), which must also agree; ``adaptive`` the
    adaptive batch buckets."""
    if path in ("constraints", "adaptive"):
        got, cons, stages = _drive_stored("cuda", path)
        want, want_cons, _stages = _drive_stored("cpu", path)
        assert got == want
        assert all(b'"nodeName"' in v for v in got.values())
        if path == "constraints":
            assert stages["cons"] > 0
            for f in CONSTRAINT_FIELDS:
                assert torch.equal(cons[f], want_cons[f]), f
        else:
            assert stages["base"] > 0
        return
    if path == "fused":
        batch, over = 1024, dict(score_pct=25)
    elif path == "fused-serial":
        batch, over = 1024, dict(score_pct=25, no_pipeline=True)
    elif path == "xla":
        batch, over = 1024, dict(score_pct=25, backend="xla")
    elif path == "shape-pool":
        batch, over = 1024, dict(score_pct=25, shape_pool=8, shape_share=0.9, seed=3)
    else:
        batch, over = 512, dict(score_pct=100, deltacache="on", delta_index_k=64,
                                stratum_bits=9)
    got, req, dev, report = _bench_stored("cuda", batch, **over)
    want, want_req, _dev, _report = _bench_stored("cpu", batch, **over)
    assert got == want
    assert all(b'"nodeName"' in v for v in got.values())
    for c in req:
        np.testing.assert_array_equal(req[c], want_req[c])
        np.testing.assert_array_equal(dev[c], req[c])
    launches = report["detail"]["launches"]
    if path == "xla":
        assert launches["fused_topk"] == launches["delta_plane_topk"] == 0
    elif path == "shape-pool":
        assert launches["fused_topk_by_stage"]["aff"] > 0
    else:
        assert launches["delta_plane_topk" if path == "delta" else "fused_topk"] > 0


def _breaker_stored(device):
    """A pipelined coordinator (depth 3, packed, zero-delay retries) over
    4,096 KWOK nodes with a ``CircuitBreaker``; a ``stall`` plan fails two
    launches, the open-state wave binds 16 pods through the host oracle,
    the half-open probe closes it.  Returns (stored pod values, host and
    device request columns, fallback binds, fused launches by stage)."""
    from k8s1m_tpu_torch.control.coordinator import Coordinator
    from k8s1m_tpu_torch.control.objects import encode_node, encode_pod, node_key, pod_key
    from k8s1m_tpu_torch.faultline import FaultPlan, FaultSpec, RetryPolicy, install_plan
    from k8s1m_tpu_torch.loadshed import CLOSED, BreakerConfig, CircuitBreaker
    from k8s1m_tpu_torch.obs.metrics import REGISTRY
    from k8s1m_tpu_torch.ops import fused_topk as ft
    from k8s1m_tpu_torch.store.native import MemStore, list_prefix
    from k8s1m_tpu_torch.tools.make_nodes import build_node

    store = MemStore()
    store.put_batch([(node_key(f"kwok-node-{i}"), encode_node(build_node(i)))
                     for i in range(4096)])
    br = CircuitBreaker(BreakerConfig(failure_threshold=2, cooldown_cycles=2,
                                      fallback_batch=16), component=f"gpu-test-{device}")
    coord = Coordinator(store, TableSpec(max_nodes=4096), PodSpec(batch=256), BASE,
                        chunk=1024, with_constraints=False, pipeline=True, depth=3,
                        packing="packed", breaker=br, device=device,
                        retry_policy=RetryPolicy("coordinator.bind", base_delay_s=0.0,
                                                 jitter=0.0))
    fb = REGISTRY.get("breaker_fallback_binds_total")
    try:
        coord.bootstrap()
        ft.reset_launches()
        fb0 = fb.value()
        for w in range(6):
            store.put_batch([(pod_key("default", f"b{w}-{i}"),
                              encode_pod(PodInfo(f"b{w}-{i}", cpu_milli=50 + i % 5,
                                                 mem_kib=1 << 12)))
                             for i in range(256)])
            if w == 1:
                install_plan(FaultPlan([FaultSpec("coordinator.cycle", "dispatch",
                                                  kind="stall", every_n=1, max_fires=2)]))
            coord.step()
        install_plan(None)
        while br.state != CLOSED:
            coord.step()
        coord.run_until_idle()
        coord.flush()
        kvs, _rev = list_prefix(store, b"/registry/pods/")
        req = {c: getattr(coord.host, c).copy() for c in ("cpu_req", "mem_req", "pods_req")}
        dev = {c: getattr(coord.table, c).cpu().numpy() for c in req}
        return ({kv.key: kv.value for kv in kvs}, req, dev, fb.value() - fb0,
                dict(ft.fused_topk.launches_by_stage))
    finally:
        install_plan(None)
        coord.close()
        store.close()


@pytest.mark.gpu
def test_breaker_fallback_on_card_equals_cpu(cuda, slow_card):
    """The breaker-open oracle fallback between device waves: the pipeline
    is retired before the oracle binds and the fallback rows reach the
    card only through the dirty-row sync, so the card run leaves the same
    stored pods as the CPU run, and its device request columns equal the
    host mirror (a wave still in flight, or a fallback bind that skipped
    the sync, would double-book a row on the card only)."""
    got, req, dev, fallback, stages = _breaker_stored("cuda")
    want, want_req, _dev, want_fallback, _stages = _breaker_stored("cpu")
    assert fallback == want_fallback == 16
    assert got == want and len(got) == 6 * 256
    assert all(b'"nodeName"' in v for v in got.values())
    for c in req:
        np.testing.assert_array_equal(req[c], want_req[c])
        np.testing.assert_array_equal(dev[c], req[c])
    assert stages["base"] > 0


# ---- tracing and the webhook on the card -------------------------------------


def _chains(tracer) -> dict:
    return {t.key: [s[0] for s in t.spans] for t in tracer.completed()}


@pytest.mark.gpu
def test_traced_coordinator_on_card_equals_cpu(cuda, slow_card):
    """Tracing does not move placement on the card: ``sched_bench --trace 4``
    leaves the same stored pods on the card as on the CPU, and traces the
    same pods through the same stages in the same order."""
    got, _req, _dev, report = _bench_stored("cuda", 1024, score_pct=25, trace=4)
    want, _wreq, _wdev, want_report = _bench_stored("cpu", 1024, score_pct=25, trace=4)
    assert got == want
    att, want_att = (r["detail"]["latency_attribution"] for r in (report, want_report))
    assert att["pods"] == want_att["pods"] > 0
    assert att["stages"].keys() == want_att["stages"].keys()
    assert att["coverage"] == 1.0
    # The traced run binds what the untraced run binds.
    untraced, *_ = _bench_stored("cuda", 1024, score_pct=25)
    assert got == untraced


@pytest.mark.gpu
def test_traced_device_span_holds_the_card_time(cuda, slow_card):
    """The ``device`` span ends at ``t_sync``, after the retire waited on
    the pinned copy's event.  ``slow_card`` holds every wave on the card
    for one ``torch.cuda._sleep`` before the copy is queued, so every
    traced pod's device span covers at least that held time; a ``t_sync``
    taken before the wait would leave it in the bind span.  The held time
    is measured with CUDA events first (0.9 of it is required, for clock
    changes between the two measurements)."""
    from k8s1m_tpu_torch.control.coordinator import Coordinator
    from k8s1m_tpu_torch.control.objects import encode_node, encode_pod, node_key, pod_key
    from k8s1m_tpu_torch.obs.podtrace import PodTracer
    from k8s1m_tpu_torch.store.native import MemStore
    from k8s1m_tpu_torch.tools.make_nodes import build_node

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(40_000_000)
    end.record()
    end.synchronize()
    held_s = start.elapsed_time(end) / 1e3
    tracer = PodTracer(sample_n=1)
    store = MemStore()
    store.put_batch([(node_key(f"kwok-node-{i}"), encode_node(build_node(i)))
                     for i in range(4096)])
    coord = Coordinator(store, TableSpec(max_nodes=4096), PodSpec(batch=256), BASE,
                        chunk=1024, with_constraints=False, device="cuda", tracer=tracer)
    try:
        coord.bootstrap()
        for w in range(4):
            store.put_batch([(pod_key("default", f"d{w}-{i}"),
                              encode_pod(PodInfo(f"d{w}-{i}", cpu_milli=10, mem_kib=1024)))
                             for i in range(256)])
            coord.step()
        coord.run_until_idle()
    finally:
        coord.close()
        store.close()
    device = [t1 - t0 for t in tracer.completed() for s, t0, t1, _ in t.spans if s == "device"]
    assert len(device) == 1024
    assert min(device) >= 0.9 * held_s, (min(device), held_s)


def _webhook_stored(device):
    """A coordinator over 4,096 KWOK nodes (pipelined at depth 2, zero-delay
    retries) fed by a ``WebhookServer``: 8 waves of 128 POSTed pods, each
    stored after its admission (the apiserver's write) and then a step.
    Returns the stored pod values."""
    import json
    import threading
    import urllib.request

    from k8s1m_tpu_torch.control.coordinator import Coordinator
    from k8s1m_tpu_torch.control.objects import encode_node, encode_pod, node_key, pod_key
    from k8s1m_tpu_torch.control.webhook import WebhookServer
    from k8s1m_tpu_torch.faultline import RetryPolicy
    from k8s1m_tpu_torch.store.native import MemStore, list_prefix
    from k8s1m_tpu_torch.tools.make_nodes import build_node

    store = MemStore()
    store.put_batch([(node_key(f"kwok-node-{i}"), encode_node(build_node(i)))
                     for i in range(4096)])
    coord = Coordinator(store, TableSpec(max_nodes=4096), PodSpec(batch=128), BASE,
                        chunk=1024, with_constraints=False, pipeline=True, depth=2,
                        device=device, retry_policy=RetryPolicy(
                            "coordinator.bind", base_delay_s=0.0, jitter=0.0))
    sunk = threading.Semaphore(0)

    def sink(obj):
        coord.submit_external(obj)
        sunk.release()

    srv = WebhookServer(sink).start()
    try:
        coord.bootstrap()
        for w in range(8):
            items = []
            for i in range(128):
                pod = PodInfo(f"h{w}-{i}", cpu_milli=10 + i % 7, mem_kib=1024)
                body = json.dumps({"apiVersion": "admission.k8s.io/v1",
                                   "kind": "AdmissionReview",
                                   "request": {"uid": f"u{w}-{i}",
                                               "object": json.loads(encode_pod(pod))}})
                req = urllib.request.Request(
                    f"http://127.0.0.1:{srv.port}/validate", data=body.encode(),
                    headers={"Content-Type": "application/json"}, method="POST")
                with urllib.request.urlopen(req, timeout=5) as resp:
                    assert json.loads(resp.read())["response"]["allowed"]
                assert sunk.acquire(timeout=5)
                items.append((pod_key("default", pod.name), encode_pod(pod)))
            store.put_batch(items)
            coord.step()
        coord.run_until_idle()
        coord.flush()
        kvs, _rev = list_prefix(store, b"/registry/pods/")
        return {kv.key: kv.value for kv in kvs}
    finally:
        srv.stop()
        coord.close()
        store.close()


@pytest.mark.gpu
def test_webhook_fed_coordinator_on_card_equals_cpu(cuda, slow_card):
    got, want = _webhook_stored("cuda"), _webhook_stored("cpu")
    assert got == want and len(got) == 8 * 128
    assert all(b'"nodeName"' in v for v in got.values())


# ---- lease election, fencing and warm-standby failover ----------------------


@pytest.mark.gpu
def test_warm_takeover_on_card_equals_cpu(cuda, slow_card):
    """``failover_drill`` (mid-wave kill with a cold and a warm standby, the
    paused leader's split brain) on the card leaves the same stored pods in
    every scenario as with ``--device cpu``, with the same evidence apart
    from the takeover seconds, and passes every gate on both; the warm
    standby's discarded wave runs the card's kernel on clones."""
    from k8s1m_tpu_torch.ops.fused_topk import fused_topk as ft
    from k8s1m_tpu_torch.tools import failover_drill

    clock = ("recovery_s", "recovery_warm_s", "recovery_cold_s", "warm_speedup", "value",
             "device")

    def scrub(d):
        return ({k: scrub(v) for k, v in d.items() if k not in clock}
                if isinstance(d, dict) else d)

    shape = ["--nodes", "1024", "--batch", "128", "--chunk", "256", "--pods-per-tick", "96",
             "--pre-ticks", "6"]
    before = ft.launches_by_stage["base"]
    card = failover_drill.main(shape)
    assert ft.launches_by_stage["base"] > before
    cpu = failover_drill.main(shape + ["--device", "cpu"])
    assert card["passed"] and cpu["passed"]
    assert card["device"] == "cuda" and cpu["device"] == "cpu"
    for k in ("mid_wave_kill_cold", "mid_wave_kill_warm", "split_brain"):
        assert card["evidence"][k]["pods_sha256"] == cpu["evidence"][k]["pods_sha256"], k
    assert scrub(card) == scrub(cpu)


# ---- the store over the wire ---------------------------------------------------


@pytest.mark.gpu
def test_sched_bench_over_the_wire_on_card(cuda):
    """``sched_bench --target`` against the port's store server in a child
    process: the nodes, the relist, every watch event and every bind cross
    the wire, the fused kernel launches in the measured window, every pod
    binds, and the server process is gone afterwards."""
    from k8s1m_tpu_torch.store.native import list_prefix
    from k8s1m_tpu_torch.store.server_main import serve_subprocess
    from k8s1m_tpu_torch.tools import sched_bench

    with serve_subprocess() as (proc, target):
        args = sched_bench.parse_args(["--target", target, "--nodes", "16384", "--pods",
                                       "4096", "--batch", "512", "--score-pct", "25",
                                       "--packing", "packed"])
        report, coord, store = sched_bench.run(args)
        try:
            coord.flush()
            kvs, _ = list_prefix(store, b"/registry/pods/")
        finally:
            coord.close()
            store.close()
    assert proc.returncode is not None
    d = report["detail"]
    assert d["device"] == "cuda" and d["launches"]["fused_topk"] > 0
    assert d["bound"] == 4095 and len(kvs) == 4096
    assert all(b'"nodeName"' in kv.value for kv in kvs)


@pytest.mark.gpu
def test_sched_bench_through_the_secured_tier_on_card(cuda, tmp_path, monkeypatch):
    """The watch-cache tier in a child (``python -m
    k8s1m_tpu_torch.store.watch_cache``) in front of the store server in
    another, serving TLS from a chain the ``openssl`` command made
    (``cryptography`` blocked) and requiring a bearer token; ``sched_bench
    --target <tier> --ca-pem --token`` on the card through it: every pod
    binds, the fused kernel launches; a wrong token is refused
    ``UNAUTHENTICATED``; both children reaped."""
    import sys

    from k8s1m_tpu_torch.cluster.certs import provision
    from k8s1m_tpu_torch.store.proto import codec
    from k8s1m_tpu_torch.store.native import list_prefix
    from k8s1m_tpu_torch.store.server_main import serve_subprocess
    from k8s1m_tpu_torch.store.watch_cache import tier_subprocess
    from k8s1m_tpu_torch.store.wire import Channel, StatusCode, WireError
    from k8s1m_tpu_torch.tools import sched_bench

    monkeypatch.setitem(sys.modules, "cryptography", None)
    certs = provision(str(tmp_path / "certs"))
    monkeypatch.delitem(sys.modules, "cryptography")
    token = "card-token"
    with serve_subprocess() as (sproc, upstream), tier_subprocess(
            upstream, "--prefix", "/registry/", "--tls-cert", certs.cert_pem, "--tls-key",
            certs.key_pem, "--auth-token", token) as (tproc, target):
        args = sched_bench.parse_args(["--target", target, "--ca-pem", certs.ca_pem,
                                       "--token", token, "--nodes", "16384", "--pods", "4096",
                                       "--batch", "512", "--score-pct", "25",
                                       "--packing", "packed"])
        report, coord, store = sched_bench.run(args)
        try:
            coord.flush()
            kvs, _ = list_prefix(store, b"/registry/pods/")
        finally:
            coord.close()
            store.close()
        ch = Channel(target, ca_pem=certs.ca_pem, token="wrong")
        try:
            with pytest.raises(WireError) as ei:
                ch.unary("/etcdserverpb.KV/Range",
                         codec.RangeRequest(key=b"/registry/pods/").encode())
        finally:
            ch.close()
        assert ei.value.code == StatusCode.UNAUTHENTICATED
    assert sproc.returncode is not None and tproc.returncode is not None
    d = report["detail"]
    assert d["device"] == "cuda" and d["launches"]["fused_topk"] > 0
    assert d["bound"] == 4095 and len(kvs) == 4096
    assert all(b'"nodeName"' in kv.value for kv in kvs)


# ---- the shard set -------------------------------------------------------------


@pytest.mark.gpu
def test_shard_bench_two_workers_on_card(cuda):
    """``shard_bench`` with two worker processes, each opening the card,
    against the port's store server: every pod bound once, each worker binds
    its FNV share and exits 0, each launched the fused kernel, and every bound
    pod's node belongs to a group its shard owns."""
    import json

    from k8s1m_tpu_torch.control.shardset import group_of, load_assignment, pod_shard
    from k8s1m_tpu_torch.store.native import list_prefix
    from k8s1m_tpu_torch.store.remote import RemoteStore
    from k8s1m_tpu_torch.store.server_main import serve_subprocess
    from k8s1m_tpu_torch.tools import shard_bench

    with serve_subprocess() as (proc, target):
        out = shard_bench.main(["--target", target, "--nodes", "16384", "--pods", "4096",
                                "--shards", "2", "--batch", "512", "--score-pct", "25"])
        with RemoteStore(target) as store:
            kvs, _ = list_prefix(store, b"/registry/pods/")
            asg = load_assignment(store)
    assert proc.returncode is not None
    workers = out["per_worker"]
    assert out["worker_rcs"] == [0, 0] and all(w["done"] for w in workers)
    assert [w["bound"] for w in workers] == out["pod_share"] and sum(out["pod_share"]) == 4096
    assert all(w["device"] == "cuda" and w["launches"]["fused_topk"] > 0 for w in workers)
    assert all(w["peak_card_mb"] > 0 for w in workers)
    assert len(kvs) == 4096 + 2                   # and one warm-up pod per worker
    for kv in kvs:
        pod = json.loads(kv.value)
        node = pod["spec"]["nodeName"]
        key = f"{pod['metadata']['namespace']}/{pod['metadata']['name']}"
        assert asg.groups[group_of(node)] == pod_shard(key, 2)


# ---- the reference's experiment through the load tools ---------------------------


def _tools_flow(device: str, nodes: int = 64, pods: int = 96) -> list:
    """make_nodes -> 10 KWOK controllers -> make_pods -> a coordinator on
    ``device`` -> two ticks -> delete_pods, all over the wire against the
    port's ``WireFront`` with one client at a time (revisions comparable);
    the stored pods and leases after each step."""
    import asyncio

    from k8s1m_tpu_torch.cluster.kwok_controller import KwokController
    from k8s1m_tpu_torch.control.coordinator import Coordinator
    from k8s1m_tpu_torch.ops import fused_topk as ft
    from k8s1m_tpu_torch.store.native import MemStore, WireFront, prefix_end
    from k8s1m_tpu_torch.store.remote import RemoteStore
    from k8s1m_tpu_torch.tools import delete_pods, make_nodes, make_pods

    def dump():
        out = []
        for p in (b"/registry/pods/", b"/registry/leases/kube-node-lease/"):
            out.append([(kv.key, kv.value, kv.mod_revision)
                        for kv in local.range(p, prefix_end(p)).kvs])
        return out

    snaps = []
    with MemStore() as local, WireFront(local) as wf:
        target = f"127.0.0.1:{wf.port}"
        base = ["--target", target, "--quiet", "--concurrency", "1", "--clients", "1"]

        def tool(mod, argv):
            out = asyncio.run(mod.amain(mod.parse_args(base + argv)))
            assert out["errors"] == 0
            snaps.append((mod.__name__, out["count"], dump()))

        with RemoteStore(target) as store:
            tool(make_nodes, ["--count", str(nodes), "--bulk", "16"])
            controllers = [KwokController(store, g) for g in range(10)]
            for c in controllers:
                c.bootstrap(now=0.0)
            tool(make_pods, ["--count", str(pods)])
            coord = Coordinator(store, TableSpec(max_nodes=nodes), PodSpec(batch=32), BASE,
                                chunk=32, k=4, with_constraints=False, packing="packed",
                                device=device)
            ft.reset_launches()
            coord.bootstrap()
            snaps.append(("bound", coord.run_until_idle(), dump()))
            if device == "cuda":
                assert ft.fused_topk.launches_by_stage["base"] > 0
            for t in (10.0, 20.0):
                for c in controllers:
                    c._pods_watch.progress()
                    c.tick(now=t)
                snaps.append((f"tick {t}", sum(len(c.running_pods) for c in controllers),
                              dump()))
            coord.close()
            for c in controllers:
                c.close()
            tool(delete_pods, ["--prefix", "bench-pod"])
    return snaps


@pytest.mark.gpu
def test_tools_flow_on_card_equals_cpu(cuda):
    """The reference's experiment in miniature with the coordinator on the
    card: every pod bound and Running, every node's lease written, and the
    stored pods and leases after every step equal to the CPU run's, bytes
    and revisions."""
    card, cpu = _tools_flow("cuda"), _tools_flow("cpu")
    assert card == cpu
    by = {s[0]: s for s in card}
    assert by["bound"][1] == 96 and by["tick 20.0"][1] == 96
    assert len(by["tick 20.0"][2][1]) == 64
    assert by["k8s1m_tpu_torch.tools.delete_pods"][2][0] == []


# ---- the dp x sp mesh on the card ---------------------------------------------

MESH_N, MESH_B, MESH_CHUNK = 8192, 256, 512


def _mesh_stage_state(stage):
    """(spec, host, packed batch, profile) of one stage at MESH_N x MESH_B."""
    from k8s1m_tpu_torch.cluster import (
        affinity_deployment,
        node_affinity_pods,
        spread_deployment,
    )
    from k8s1m_tpu_torch.config import TOPO_ZONE

    if stage == "cons":
        spec = TableSpec(max_nodes=MESH_N, max_zones=128, max_regions=16)
        tracker = ConstraintTracker(spec)
        half = MESH_B // 2
        pods = (spread_deployment(tracker, "sp", half, topo=TOPO_ZONE)
                + affinity_deployment(tracker, "anti", MESH_B - half, anti=True))
        pod_spec = PodSpec(batch=MESH_B, spread_refs=1, affinity_refs=1, spread_incs=1,
                           ipa_incs=1)
        profile = Profile()
    elif stage == "aff":
        spec = TableSpec(max_nodes=MESH_N)
        pods = node_affinity_pods(MESH_B)
        pod_spec = PodSpec(batch=MESH_B, aff_terms=1, aff_exprs=2, aff_values=2,
                           pref_terms=1)
        profile = Profile(topology_spread=0, interpod_affinity=0)
    else:
        spec = TableSpec(max_nodes=MESH_N)
        pods = uniform_pods(MESH_B)
        pod_spec = PodSpec(batch=MESH_B)
        profile = BASE
    host = NodeTableHost(spec)
    populate_kwok_nodes(host, MESH_N - 64)
    return spec, host, PodBatchHost(pod_spec, spec, host.vocab).encode_packed(pods), profile


def _mesh_waves(device, stage, waves=2):
    """``waves`` waves of ``stage`` over a 2x2 mesh on ``device``: each
    wave's rows, then the whole table, count tables and planes on the
    CPU, and the launches of the path's kernel per wave."""
    from k8s1m_tpu_torch import parallel as par
    from k8s1m_tpu_torch.engine.cycle import fill_shape_planes, schedule_batch_delta
    from k8s1m_tpu_torch.ops import delta_topk
    from k8s1m_tpu_torch.ops import fused_topk as ft
    from k8s1m_tpu_torch.parallel.sharded_cycle import sharded_scatter

    spec, host, packed, profile = _mesh_stage_state(stage)
    mesh = par.make_mesh(2, 2, device=device)
    pspec = build_packing_spec(spec, host.vocab)
    table = par.shard_table(pack_table_host(host, pspec, "cpu"), mesh)
    cons = (par.shard_constraints(empty_constraints(spec, "cpu"), mesh)
            if stage == "cons" else None)
    planes = None
    slot_ids = np.zeros(MESH_B, np.int32)
    if stage == "delta":
        planes = (par.mesh.zeros_planes(mesh, 1, MESH_N, torch.bool),
                  par.mesh.zeros_planes(mesh, 1, MESH_N, torch.int32))
        fill = PodBatchHost(dataclasses.replace(packed.spec, batch=4), spec,
                            host.vocab).encode_packed(uniform_pods(1))
        fill_shape_planes(table, fill, np.array([0, 1, 1, 1], np.int32), planes,
                          profile=profile, chunk=MESH_CHUNK, mesh=mesh)
    rng = np.random.default_rng(7)
    rows_out, launches, prev = [], [], None
    for i in range(waves):
        seed = int(rng.integers(-(1 << 31), 1 << 31))
        before = ft.fused_topk.launches + delta_topk.delta_plane_topk.launches
        if stage == "delta":
            dirty = np.sort(rng.choice(MESH_N - 64, 32, replace=False)).astype(np.int32)
            sharded_scatter(table, dirty, {"cpu_req": rng.integers(0, 500, 32).astype(np.int32)})
            table, _asg, rows, planes = schedule_batch_delta(
                table, packed, seed, profile=profile, slot_ids=slot_ids, planes=planes,
                dirty=dirty, inflight_rows=() if prev is None else (prev,), chunk=MESH_CHUNK,
                k=4, mesh=mesh)
        else:
            table, _asg, rows = schedule_batch_packed(
                table, packed, seed, profile=profile, constraints=cons, chunk=MESH_CHUNK,
                k=4, mesh=mesh)
        launches.append(ft.fused_topk.launches + delta_topk.delta_plane_topk.launches - before)
        rows_out.append(rows.cpu())
        prev = rows
    full = table.gather()
    state = {f.name: getattr(full, f.name) for f in dataclasses.fields(full)
             if f.name != "spec"}
    if cons is not None:
        g = cons.gather()
        state.update({f: getattr(g, f) for f in CONSTRAINT_FIELDS})
    if planes is not None:
        state.update(pmask=planes[0].gather(), pscore=planes[1].gather())
    return rows_out, state, launches


@pytest.mark.gpu
@pytest.mark.parametrize("stage", ["base", "aff", "cons", "delta"])
def test_sharded_waves_on_card_equal_cpu(cuda, stage):
    """The 2x2 mesh on the card (all four cells on it) against the port's
    CPU run of the same waves: bound rows, every table column, the count
    tables and the planes; four launches of the stage's kernel per wave."""
    rows_c, state_c, launches = _mesh_waves(cuda, stage)
    rows_h, state_h, _ = _mesh_waves(torch.device("cpu"), stage)
    assert launches == [4, 4]
    for i, (a, b) in enumerate(zip(rows_c, rows_h)):
        assert torch.equal(a, b), f"wave {i}"
        assert bool((a >= 0).any())
    assert state_c.keys() == state_h.keys()
    for name in state_c:
        assert torch.equal(state_c[name], state_h[name]), name


@pytest.mark.gpu
@pytest.mark.parametrize("stage", ["base", "aff", "cons", "delta"])
def test_mesh_cells_match_plain_version_at_offsets(cuda, stage):
    """Each 2x2 cell's kernel against its plain version at the cell's pod
    and row offsets (the cons stage with the cross-shard prologue)."""
    from k8s1m_tpu_torch import parallel as par
    from k8s1m_tpu_torch.engine.deltacache import plane_topk
    from k8s1m_tpu_torch.ops.delta_topk import delta_plane_topk
    from k8s1m_tpu_torch.parallel import sharded_cycle as sc

    spec, host, packed, profile = _mesh_stage_state(stage)
    mesh = par.make_mesh(2, 2, device=cuda)
    table = par.shard_table(pack_table_host(host, build_packing_spec(spec, host.vocab), "cpu"),
                            mesh)
    cons = (par.shard_constraints(empty_constraints(spec, "cpu"), mesh)
            if stage == "cons" else None)
    stats = sc.sharded_prologue(table, cons) if cons is not None else None
    batches = sc._full_batches(mesh, packed)
    rng = np.random.default_rng(3)
    b_local = MESH_B // 2
    for d, s in mesh.cells():
        pod_off, row_off = sc.mesh_offsets(d, s, table.rows_per_shard, b_local)
        assert (pod_off, row_off) == (d * b_local, s * (MESH_N // 2))
        seed = int(rng.integers(-(1 << 31), 1 << 31))
        if stage == "delta":
            pm = torch.rand((3, MESH_N // 2), generator=torch.Generator().manual_seed(d * 2 + s))
            pmask = (pm < 0.7).to(cuda)
            pscore = (pm * 3000 - 400).to(torch.int32).to(cuda)
            ids = torch.tensor(rng.integers(0, 3, b_local), dtype=torch.int32, device=cuda)
            kw = dict(chunk=MESH_CHUNK, k=4, row_offset=row_off, pod_offset=pod_off)
            got = delta_plane_topk(pmask, pscore, ids, seed, **kw)
            want = plane_topk(pmask, pscore, ids, seed, **kw)
            assert torch.equal(got.idx, want.idx) and torch.equal(got.prio, want.prio)
            continue
        batch = par.slice_batch(batches[mesh.device(d, s)], d, b_local)
        kw = dict(k=4, row_base=pod_off, col_base=row_off, stratum_bits=0,
                  with_affinity=stage == "aff", stats=stats,
                  constraints=None if cons is None else cons.part(d, s))
        idx, prio = fused_topk(table.part(d, s), batch, seed, profile, **kw)
        ridx, rprio = fused_topk_reference(table.part(d, s), batch, seed, profile,
                                           chunk=MESH_CHUNK, **kw)
        assert torch.equal(idx, ridx) and torch.equal(prio, rprio), (d, s)
        assert bool((prio >= 0).any())
