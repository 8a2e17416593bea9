"""The port's CUDA kernel against its plain PyTorch version, on the card.

Every test here is marked ``gpu`` and skips where
``torch.cuda.is_available()`` is False (the decision is taken inside the
``cuda`` fixture, never at import).  The file imports no JAX, so it runs
on a machine that has only PyTorch and the CUDA toolkit:

    python -m pytest tests/test_torch_gpu.py -q

Tolerance: exact equality — every output is an integer.
"""

import numpy as np
import pytest
import torch

from k8s1m_tpu_torch.cluster import populate_kwok_nodes, uniform_pods
from k8s1m_tpu_torch.cluster.testbeds import (
    affinity_pods,
    constraint_fleet,
    constraint_pods,
    labeled_fleet,
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
