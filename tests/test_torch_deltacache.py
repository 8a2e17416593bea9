"""The port's deltasched device functions, candidate index and host
controller vs the JAX package (``k8s1m_tpu/engine/deltacache.py`` and
``ops/pallas_topk.py::delta_plane_topk``).

- ``plane_topk`` against JAX ``plane_topk`` (every pod) and against the
  Pallas ``delta_plane_topk`` in interpret mode (real pods: the kernel
  clips a padding slot where ``jnp.take`` fills it), over the cases the
  on-card comparison runs at full size: S=8 and S=64, padding pods,
  stratum bits 0 and 11, nonzero row/pod offsets, scores outside
  [0, 2047], a slot with no feasible column, k=4 and k=128;
- ``combine_dirty`` with in-flight -1 markers and ``merge_dirty_planes``
  with the sentinel trap (row N-1 and the sentinel N in one dirty vector,
  padding pods at slot S);
- ``dedup_rows``, ``update_index``, ``index_usable``, ``index_topk`` and
  ``rebuild_index`` step by step against JAX on random planes and dirty
  batches, and on the floor edge cases;
- ``shape_key`` over the workload generators' pods, ``resolve_deltasched``
  and ``DeltaPlaneCache.plan`` over key sequences (promotion, hits, LRU
  eviction, busy slots, oversized dirty sets, the index plumbing), each
  ``WavePlan`` compared field by field.
Inputs come from numpy with a seed.  Tolerance: exact equality.
"""

import _torch_cpu  # noqa: F401  (bounds torch's CPU threads first)

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s1m_tpu.cluster import populate_kwok_nodes as jax_populate
from k8s1m_tpu.cluster import workload as jwl
from k8s1m_tpu.config import PodSpec, TableSpec
from k8s1m_tpu.engine import deltacache as jdc
from k8s1m_tpu.ops.pallas_topk import delta_plane_topk as jax_delta_plane_topk
from k8s1m_tpu.plugins.registry import Profile as JaxProfile
from k8s1m_tpu.snapshot import hotfeed as jhf
from k8s1m_tpu.snapshot.node_table import NodeTableHost
from k8s1m_tpu.snapshot.pod_encoding import PodBatchHost, PodInfo, unpack_pod_batch
from k8s1m_tpu_torch import interop
from k8s1m_tpu_torch.cluster import workload as twl
from k8s1m_tpu_torch.engine import deltacache as dc
from k8s1m_tpu_torch.ops.delta_topk import delta_plane_topk
from k8s1m_tpu_torch.plugins.registry import Profile
from k8s1m_tpu_torch.snapshot import hotfeed as thf
from k8s1m_tpu_torch.snapshot import pod_encoding as tpe

I32 = np.int32


def _t(x, dtype=None):
    return torch.from_numpy(np.array(x, dtype=dtype))


def _eq(port, ref, what):
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref), err_msg=what)


def _planes(rng, s, n, *, dead_slot=None):
    """Random planes: ~60% feasible, scores across [-3000, 5000] (negatives
    and > 2047 included); ``dead_slot`` has no feasible column."""
    mask = rng.random((s, n)) < 0.6
    score = rng.integers(-3000, 5000, (s, n)).astype(I32)
    if dead_slot is not None:
        mask[dead_slot] = False
    return mask, score


# ---- plane_topk: the plain version of the plane-tail kernel ----------------

TAIL_CASES = [
    # (s, n, b, chunk, k, stratum_bits, seed, row_offset, pod_offset)
    (8, 512, 40, 128, 4, 0, 4242, 0, 0),
    (8, 512, 40, 128, 4, 11, -77, 4096, 13),
    (64, 512, 136, 128, 4, 0, 12345, 0, 0),
    (64, 256, 136, 128, 128, 11, -(1 << 31), 7, 300),
    (8, 256, 24, 256, 128, 0, 99, 0, 5),
]


@pytest.mark.parametrize("case", TAIL_CASES)
def test_plane_topk_matches_jax(case):
    s, n, b, chunk, k, sb, seed, row_off, pod_off = case
    rng = np.random.default_rng(s * 1000 + k + sb)
    mask, score = _planes(rng, s, n, dead_slot=s - 2)
    slot = np.concatenate([rng.integers(0, s, b - 6), [s - 2, s - 2, s - 1, s, s, s]])
    slot = slot.astype(I32)
    real = slot < s
    kw = dict(chunk=chunk, k=k, stratum_bits=sb, row_offset=row_off, pod_offset=pod_off)
    pm, ps = interop.planes_from_numpy(mask, score, "cpu")
    got = dc.plane_topk(pm, ps, _t(slot), seed, **kw)
    via_wrapper = delta_plane_topk(pm, ps, _t(slot), seed, **kw)
    jm, js, jsl = jnp.asarray(mask), jnp.asarray(score), jnp.asarray(slot)
    ref = jdc.plane_topk(jm, js, jsl, jnp.int32(seed), **kw)
    kern = jax_delta_plane_topk(jm, js, jsl, jnp.int32(seed), interpret=True, **kw)
    for f in ("idx", "prio"):
        _eq(getattr(got, f), getattr(ref, f), f"plane_topk {f}")
        _eq(getattr(via_wrapper, f), getattr(ref, f), f"wrapper on cpu {f}")
        np.testing.assert_array_equal(getattr(got, f).numpy()[real],
                                      np.asarray(getattr(kern, f))[real],
                                      err_msg=f"vs Pallas kernel {f}")
    for f in ("cpu", "mem", "pods", "zone", "region"):
        assert not bool(getattr(got, f).any())
    # The dead slot's pods have no candidate; the others are full.
    assert bool((got.prio[_t(slot == s - 2)] == -1).all())
    assert bool((got.prio[_t(slot < s - 2)] >= 0).any())


def test_delta_plane_topk_refuses_bad_arguments():
    pm, ps = interop.planes_from_numpy(np.ones((2, 64), bool), np.zeros((2, 64), I32), "cpu")
    slot = _t([0, 1], I32)
    with pytest.raises(ValueError, match="divisible"):
        delta_plane_topk(pm, ps, slot, 1, chunk=48, k=4)
    with pytest.raises(ValueError, match="k must be"):
        delta_plane_topk(pm, ps, slot, 1, chunk=64, k=129)
    with pytest.raises(ValueError, match="stratum_bits"):
        delta_plane_topk(pm, ps, slot, 1, chunk=64, k=4, stratum_bits=21)


@pytest.mark.parametrize("width,k", [(7, 3), (40, 4), (16, 16)])
def test_chunk_topk_merge_topk_empty_candidates_match_jax(width, k):
    """The XLA scan path's helpers: descending, earlier index first on
    ties (many ties here), over priorities including -1."""
    from k8s1m_tpu.engine import cycle as jcycle
    from k8s1m_tpu_torch.engine import cycle as tcycle

    rng = np.random.default_rng(width)
    prio = rng.integers(-1, 4, (5, width)).astype(I32)
    top, idx = tcycle.chunk_topk(_t(prio), k)
    jtop, jidx = jcycle.chunk_topk(jnp.asarray(prio), k)
    _eq(top, jtop, "chunk_topk values")
    _eq(idx, jidx, "chunk_topk index")
    fields = ("idx", "prio", "cpu", "mem", "pods", "zone", "region")
    cols = {f: rng.integers(-1, 9, (5, 2, k)).astype(I32) for f in fields}
    cols["prio"] = rng.integers(-1, 3, (5, 2, k)).astype(I32)
    ta, tb = (tcycle.Candidates(**{f: _t(cols[f][:, h]) for f in fields}) for h in (0, 1))
    ja, jb = (jcycle.Candidates(**{f: jnp.asarray(cols[f][:, h]) for f in fields})
              for h in (0, 1))
    got, ref = tcycle.merge_topk(ta, tb, k), jcycle.merge_topk(ja, jb, k)
    for f in fields:
        _eq(getattr(got, f), getattr(ref, f), f"merge_topk {f}")
    empty, jempty = tcycle.empty_candidates(5, k, "cpu"), jcycle.empty_candidates(5, k)
    for f in fields:
        _eq(getattr(empty, f), getattr(jempty, f), f"empty_candidates {f}")


# ---- the dirty merge ---------------------------------------------------------


def _kwok_state(n=256, b=12, seed=4, affinity=True):
    spec = TableSpec(max_nodes=n)
    host = NodeTableHost(spec)
    jax_populate(host, n - 8, seed=seed)
    rng = np.random.default_rng(seed)
    host.cpu_req[: n - 8] = rng.integers(0, 30000, n - 8)
    pods = (jwl.node_affinity_pods(b - 2, cpu_milli=700) if affinity
            else jwl.uniform_pods(b - 2, cpu_milli=700))
    pb = PodBatchHost(PodSpec(batch=b, aff_terms=1, aff_exprs=2, aff_values=2, pref_terms=1),
                      spec, host.vocab).encode_packed(pods)
    return spec, host, pb


def test_combine_dirty_maps_inflight_markers():
    host = _t([3, 9, 64, 64], I32)
    infl = [_t([5, -1, 2], I32), _t([-1, -1], I32)]
    got = dc.combine_dirty(host, infl, 64)
    ref = jdc.combine_dirty(jnp.asarray(host.numpy()), [jnp.asarray(r.numpy()) for r in infl],
                            64)
    _eq(got, ref, "combine_dirty")
    assert got.tolist() == [3, 9, 64, 64, 5, 64, 2, 64, 64]


def test_merge_dirty_planes_sentinel_trap():
    """Row N-1 and the sentinel N in one dirty vector, padding pods at slot
    S: clamped, a padding pod's recompute (infeasible everywhere) would
    land on slot S-1, and the sentinel's on row N-1 — on the same cell
    (S-1, N-1) as a real pod's feasible value.  Only in-range pairs may be
    written."""
    n, s = 256, 4
    spec, host, pb = _kwok_state(n, affinity=False)
    host.valid[n - 1] = True
    host.cpu_alloc[n - 1] = 64000        # row N-1 has room for every pod
    host.mem_alloc[n - 1] = 64 << 20
    host.cpu_req[n - 1] = 0
    host.pods_alloc[n - 1] = 110
    jt = host.to_device()
    table = interop.node_table_from_numpy(
        {f.name: np.asarray(getattr(jt, f.name)) for f in dataclasses.fields(jt)}, None, "cpu")
    jb = unpack_pod_batch(pb.ints, pb.bools, pb.spec, pb.table_spec, pb.groups)
    tb = interop.pod_batch_from_packed(pb.ints, pb.bools, pb.spec, pb.table_spec, pb.groups,
                                       "cpu")
    b = pb.spec.batch
    real = b - 2                          # the last two positions are padding pods
    slot = np.array([i % s for i in range(real)] + [s] * (b - real), I32)
    rows = np.array([n - 1, 17, 40, n, n, n, n, n], I32)
    rng = np.random.default_rng(9)
    mask0 = rng.random((s, n)) < 0.5
    score0 = rng.integers(0, 300, (s, n)).astype(I32)
    mask0[s - 1, n - 1] = False
    jprof, tprof = JaxProfile(topology_spread=0, interpod_affinity=0), Profile(
        topology_spread=0, interpod_affinity=0)
    jm, js, jmd, jsd = jdc.merge_dirty_planes(jt, jb, jprof, jnp.asarray(slot),
                                              jnp.asarray(mask0), jnp.asarray(score0),
                                              jnp.asarray(rows))
    pm, ps = interop.planes_from_numpy(mask0, score0, "cpu")
    out = dc.merge_dirty_planes(table, tb, tprof, _t(slot), pm, ps, _t(rows), pb.groups)
    assert out[0] is pm and out[1] is ps            # in place
    for got, ref, what in zip(out, (jm, js, jmd, jsd), ("pmask", "pscore", "mask_d", "score_d")):
        _eq(got, ref, what)
    mask_d = out[2]
    # The trap is live: at (S-1, N-1) a real pod writes True while a
    # clamped padding pod or a clamped sentinel entry would write False.
    pod_s1 = s - 1
    assert bool(mask_d[pod_s1, 0]) and not bool(mask_d[real:, 0].any())
    assert bool(pm[s - 1, n - 1])
    untouched = np.setdiff1d(np.arange(n), rows)
    _eq(pm[:, untouched], mask0[:, untouched], "columns not dirty stay")
    _eq(ps[:, untouched], score0[:, untouched], "columns not dirty stay")


def test_gather_rows_and_attach_payload_match_jax():
    spec, host, _pb = _kwok_state()
    from k8s1m_tpu.engine.cycle import empty_candidates as jax_empty
    from k8s1m_tpu.snapshot.packing import build_packing_spec, pack_table_host

    jt = pack_table_host(host, build_packing_spec(spec, host.vocab))
    table = interop.node_table_from_numpy(
        {f.name: np.asarray(getattr(jt, f.name)) for f in dataclasses.fields(jt)
         if f.name != "spec"}, jt.spec, "cpu")
    idx = np.array([[0, 5, -1], [255, 3, 7]], I32)
    cand = dc.without_payload(_t(idx), _t(np.ones_like(idx)))
    got = dc.attach_payload(table, cand)
    ref = jdc.attach_payload(jt, jax_empty(2, 3).replace(idx=jnp.asarray(idx)))
    for f in ("cpu", "mem", "pods", "zone", "region"):
        _eq(getattr(got, f), getattr(ref, f), f)


# ---- the candidate index ----------------------------------------------------


def test_dedup_rows_matches_jax():
    rows = np.array([5, 3, 5, 7, 3, 16, 16, 0], I32)
    got = dc.dedup_rows(_t(rows), 16)
    _eq(got, jdc.dedup_rows(jnp.asarray(rows), 16), "dedup_rows")
    assert got.tolist() == [5, 3, 16, 7, 16, 16, 16, 0]


def _rebuild_both(pm, ps, k_idx, hb, chunk):
    s, n = pm.shape
    args = (np.arange(s, dtype=I32), np.zeros(s, I32), np.full((s, k_idx), n, I32),
            np.full((s, k_idx), -1, I32), np.full(s, dc.INDEX_FLOOR_UNBUILT, I32))
    kw = dict(chunk=chunk, stratum_bits=hb, batch_b=1)
    ref = jdc.rebuild_index(jnp.asarray(pm), jnp.asarray(ps), *map(jnp.asarray, args), **kw)
    got = dc.rebuild_index(_t(pm), _t(ps), *map(_t, args), **kw)
    for g, r, what in zip(got, ref, ("idx_row", "idx_class", "idx_floor")):
        _eq(g, r, f"rebuild {what}")
    return got, ref


def _topk_both(pm, ps, state, jstate, slot_ids, hb, k=4):
    usable = dc.index_usable(state[1], state[2], _t(slot_ids), k)
    assert bool(usable) == bool(jdc.index_usable(jstate[1], jstate[2],
                                                 jnp.asarray(slot_ids), k))
    for seed in (0, 12345, -7):
        got = dc.index_topk(state[0], state[1], _t(slot_ids), seed, k=k, stratum_bits=hb)
        ref = jdc.index_topk(jstate[0], jstate[1], jnp.asarray(slot_ids), jnp.int32(seed),
                             k=k, stratum_bits=hb)
        _eq(got.idx, ref.idx, "index_topk idx")
        _eq(got.prio, ref.prio, "index_topk prio")
        if bool(usable) and (slot_ids < pm.shape[0]).all():
            plane = dc.plane_topk(_t(pm), _t(ps), _t(slot_ids), seed, chunk=pm.shape[1], k=k,
                                  stratum_bits=hb)
            _eq(got.idx, plane.idx.numpy(), "index vs plane idx")
            _eq(got.prio, plane.prio.numpy(), "index vs plane prio")
    return bool(usable)


@pytest.mark.parametrize("hb", [0, 10])
def test_index_randomized_update_matches_jax(hb):
    """Random planes, random dirty batches folded through update_index:
    every index triple equals JAX's, and whenever the index is usable its
    candidates equal the plane scan's."""
    rng = np.random.default_rng(18 + hb)
    n, k_idx, s = 64, 8, 3
    pm = rng.random((s, n)) < 0.7
    ps = rng.integers(0, 6, (s, n)).astype(I32)
    state, jstate = _rebuild_both(pm, ps, k_idx, hb, chunk=16)
    used = 0
    for _step in range(6):
        d = 8
        drows = np.concatenate([rng.choice(n, size=d - 2, replace=False),
                                rng.choice(n, 1), [n]]).astype(I32)
        dm = rng.random((s, d)) < 0.7
        dsc = rng.integers(0, 6, (s, d)).astype(I32)
        rows = dc.dedup_rows(_t(drows), n)
        jrows = jdc.dedup_rows(jnp.asarray(drows), n)
        rep = np.arange(s, dtype=I32)
        if _step % 3 == 2:
            rep[1] = s                      # slot 1 unused this wave
        state = dc.update_index(*state, _t(rep), rows, _t(dm), _t(dsc), n, stratum_bits=hb)
        jstate = jdc.update_index(*jstate, jnp.asarray(rep), jrows, jnp.asarray(dm),
                                  jnp.asarray(dsc), n, stratum_bits=hb)
        for g, r, what in zip(state, jstate, ("idx_row", "idx_class", "idx_floor")):
            _eq(g, r, f"update {what}")
        keep = dc.dedup_rows(_t(drows), n).numpy() < n
        for si in range(s):
            if rep[si] < s:
                pm[si, drows[keep]] = dm[si, keep]
                ps[si, drows[keep]] = dsc[si, keep]
        slot_ids = rng.integers(0, s, 8).astype(I32)
        used += _topk_both(pm, ps, state, jstate, slot_ids, hb)
    # Stratified, the index engages (unstratified ties keep it closed).
    assert used > 0 or hb == 0


def test_index_floor_cases_match_jax():
    """The edge cases of the floor: a tied tier wider than K (unusable
    unstratified, usable stratified), exactly K feasible rows (exhaustive),
    a dirty row evicting the floor candidate, the index shrinking below
    k, and the padding slot never blocking."""
    n, k_idx = 64, 8
    tied = (np.full((1, n), 7, I32), np.ones((1, n), bool))
    for hb, want in ((0, False), (12, True)):
        state, jstate = _rebuild_both(tied[1], tied[0], k_idx, hb, chunk=n)
        assert _topk_both(tied[1], tied[0], state, jstate, np.zeros(3, I32), hb) == want

    n, k_idx = 32, 4
    mask = np.zeros((2, n), bool)
    mask[0, [3, 9, 17, 30]] = True
    mask[1, [5, 6]] = True
    score = np.array([[7] * n, [9] * n], I32)
    state, jstate = _rebuild_both(mask, score, k_idx, 0, chunk=n)
    _eq(state[2], [-1, -1], "exhaustive floors")
    assert _topk_both(mask, score, state, jstate, np.array([0, 1, 1, 0], I32), 0)

    n, k_idx = 16, 4
    score = np.arange(n, dtype=I32)[None, :].copy()
    mask = np.ones((1, n), bool)
    state, jstate = _rebuild_both(mask, score, k_idx, 0, chunk=n)
    rows = np.array([0, 2, 3, n], I32)
    upd = dict(stratum_bits=0)
    state = dc.update_index(*state, _t([0], I32), dc.dedup_rows(_t(rows), n),
                            _t([[True, False, False, False]]), _t([[100, 0, 0, 0]], I32), n,
                            **upd)
    jstate = jdc.update_index(*jstate, jnp.zeros(1, jnp.int32),
                              jdc.dedup_rows(jnp.asarray(rows), n),
                              jnp.asarray([[True, False, False, False]]),
                              jnp.asarray([[100, 0, 0, 0]], jnp.int32), n, **upd)
    for g, r in zip(state, jstate):
        _eq(g, r, "evict floor candidate")
    assert int(state[2][0]) == n - k_idx
    score[0, [0, 2, 3]] = (100, 0, 0)
    mask[0, [2, 3]] = False
    assert _topk_both(mask, score, state, jstate, np.zeros(2, I32), 0)

    rows = np.array([n - 1, n - 2], I32)
    state = dc.update_index(*state, _t([0], I32), dc.dedup_rows(_t(rows), n),
                            _t([[False, False]]), _t([[0, 0]], I32), n, **upd)
    jstate = jdc.update_index(*jstate, jnp.zeros(1, jnp.int32),
                              jdc.dedup_rows(jnp.asarray(rows), n),
                              jnp.asarray([[False, False]]), jnp.zeros((1, 2), jnp.int32), n,
                              **upd)
    for g, r in zip(state, jstate):
        _eq(g, r, "shrink below k")
    assert not bool(dc.index_usable(state[1], state[2], _t([0], I32), 4))
    assert bool(dc.index_usable(state[1], state[2], _t([1, 1, 1], I32), 4))


def test_rebuild_index_fails_other_used_slots_closed():
    rng = np.random.default_rng(2)
    s, n, k_idx = 4, 48, 4
    pm = rng.random((s, n)) < 0.5
    ps = rng.integers(0, 9, (s, n)).astype(I32)
    ir = np.full((s, k_idx), n, I32)
    ic = np.full((s, k_idx), -1, I32)
    fl = np.array([-1, 3, -1, 5], I32)
    rebuild = np.array([2, s, 0, s], I32)
    rep = np.array([0, 1, 6, 6], I32)              # slots 0, 1 used (batch 6)
    kw = dict(chunk=16, stratum_bits=3, batch_b=6)
    got = dc.rebuild_index(_t(pm), _t(ps), _t(rebuild), _t(rep), _t(ir), _t(ic), _t(fl), **kw)
    ref = jdc.rebuild_index(jnp.asarray(pm), jnp.asarray(ps), jnp.asarray(rebuild),
                            jnp.asarray(rep), jnp.asarray(ir), jnp.asarray(ic),
                            jnp.asarray(fl), **kw)
    for g, r in zip(got, ref):
        _eq(g, r, "rebuild_index")
    assert int(got[2][1]) == dc.INDEX_FLOOR_UNBUILT and int(got[2][3]) == 5


# ---- shape keys and the host controller -------------------------------------


def _jax_key_form(key):
    """A shape key with the module's sentinels named, so the two packages'
    keys compare."""
    if key is None:
        return None
    fp, cpu, mem = key
    if fp is jhf.PLAIN:
        return ("PLAIN", cpu, mem)
    return (tuple("SEP" if x is jhf._SEP else x for x in fp), cpu, mem)


def _port_key_form(key):
    if key is None:
        return None
    fp, cpu, mem = key
    if fp is thf.PLAIN:
        return ("PLAIN", cpu, mem)
    return (tuple("SEP" if x is thf._SEP else x for x in fp), cpu, mem)


def test_shape_key_matches_jax():
    from k8s1m_tpu.snapshot.constraints import ConstraintTracker as JTracker
    from k8s1m_tpu_torch.config import TableSpec as TTableSpec
    from k8s1m_tpu_torch.snapshot.constraints import ConstraintTracker as TTracker

    jtr, ttr = JTracker(TableSpec()), TTracker(TTableSpec())
    pairs = [
        (jwl.uniform_pods(6), twl.uniform_pods(6)),
        (jwl.node_affinity_pods(130), twl.node_affinity_pods(130)),
        (jwl.spread_deployment(jtr, "s", 4), twl.spread_deployment(ttr, "s", 4)),
        (jwl.affinity_deployment(jtr, "a", 4, anti=True),
         twl.affinity_deployment(ttr, "a", 4, anti=True)),
        ([PodInfo("x", node_name="n1"), PodInfo("y", cpu_milli=7)],
         [tpe.PodInfo("x", node_name="n1"), tpe.PodInfo("y", cpu_milli=7)]),
    ]
    for jpods, tpods in pairs:
        jk = [_jax_key_form(jhf.shape_key(p)) for p in jpods]
        tk = [_port_key_form(thf.shape_key(p)) for p in tpods]
        assert jk == tk
    aff = [thf.shape_key(p) for p in twl.node_affinity_pods(130)]
    assert len(set(aff)) == 64 and aff[0] == aff[64] != aff[1]


def test_resolve_deltasched_and_epoch_checked_accessors(monkeypatch):
    assert dc.resolve_deltasched(True) == "on" and dc.resolve_deltasched(False) == "off"
    monkeypatch.delenv("K8S1M_DELTASCHED", raising=False)
    assert dc.resolve_deltasched(None) == "off"
    monkeypatch.setenv("K8S1M_DELTASCHED", "on")
    assert dc.resolve_deltasched(None) == "on"
    monkeypatch.setenv("K8S1M_DELTASCHED", "yes")
    with pytest.raises(ValueError):
        dc.resolve_deltasched(None)
    cache = dc.DeltaPlaneCache(16, slots=2, index_k=4, device="cpu")
    cache.check_generation(7)
    mask, score = cache.planes(7)
    assert mask.shape == (2, 16) and mask.dtype == torch.bool and score.dtype == torch.int32
    ir, ic, fl = cache.index_state(7)
    assert ir.shape == (2, 4) and bool((fl == dc.INDEX_FLOOR_UNBUILT).all())
    with pytest.raises(RuntimeError, match="generation"):
        cache.planes(8)
    with pytest.raises(RuntimeError, match="index_k=0"):
        dc.DeltaPlaneCache(16, device="cpu").index_state(-1)
    # Sharded planes are a parallel.Mesh's (tests/test_torch_mesh_delta.py).
    with pytest.raises(TypeError):
        dc.DeltaPlaneCache(16, sharding=object(), device="cpu")


def _same_plan(tp, jp, what):
    for f in dataclasses.fields(jp):
        a, b = getattr(tp, f.name), getattr(jp, f.name)
        if isinstance(b, np.ndarray) or isinstance(a, np.ndarray):
            assert (a is None) == (b is None), (what, f.name)
            if b is not None:
                np.testing.assert_array_equal(a, b, err_msg=f"{what} {f.name}")
        else:
            assert a == b, (what, f.name, a, b)


def _drive(script, **kw):
    """Run one script of (op, arg) steps through a JAX and a port cache."""
    jc = jdc.DeltaPlaneCache(64, **kw)
    tc = dc.DeltaPlaneCache(64, device="cpu", **kw)
    plans = 0
    for i, (op, arg) in enumerate(script):
        if op == "plan":
            keys, b = arg
            jp, tp = jc.plan(keys, b), tc.plan(keys, b)
            _same_plan(tp, jp, f"step {i}")
            plans += 1
            if jp.fill_slots and jp.slot_ids is not None:
                jc.note_fill(jp)
                tc.note_fill(tp)
                _eq(tc._idx_floor if kw.get("index_k") else torch.zeros(0),
                    jc._idx_floor if kw.get("index_k") else np.zeros(0), "floors")
            if jp.slot_ids is not None:
                jc.commit(*jc.planes(jc._gen), jp)
                tc.commit(*tc.planes(tc._gen), tp)
        elif op == "rows":
            jc.note_rows(arg)
            tc.note_rows(arg)
        elif op == "gen":
            jc.check_generation(arg)
            tc.check_generation(arg)
        elif op == "abort":
            jp, tp = jc.plan(*arg), tc.plan(*arg)
            _same_plan(tp, jp, f"step {i}")
            jc.abort_fills(jp)
            tc.abort_fills(tp)
        assert jc.resident == tc.resident, i
        assert (jc.versions.ver, jc.versions.floor) == (tc.versions.ver, tc.versions.floor)
        assert dict(jc._slot_of) == dict(tc._slot_of) and jc._fresh == tc._fresh, i
    return plans


A, Bk, C, D = (("a", 1, 1), ("b", 1, 1), ("c", 1, 1), ("d", 2, 2))

PLAN_SCRIPTS = {
    "promote-then-hit": [("gen", 0), ("plan", ([A], 8)), ("plan", ([A, A], 8)),
                         ("rows", [17, 3]), ("plan", ([A, A], 8))],
    "uncacheable": [("gen", 0), ("plan", ([A], 8)), ("plan", ([A, None], 8))],
    "lru-eviction": [("gen", 0)] + [("plan", ([k], 8)) for k in (A, Bk, C)]
    + [("plan", ([k], 8)) for k in (A, Bk, C)],
    "oversized-dirty": [("gen", 0), ("plan", ([A], 8)), ("plan", ([A], 8)),
                        ("rows", list(range(10))), ("plan", ([A], 8))],
    "busy-slots": [("gen", 0)] + [("plan", ([k], 8)) for k in (A, Bk, C)]
    + [("plan", ([A], 8)), ("plan", ([Bk], 8)), ("plan", ([A, Bk, C], 8)),
       ("plan", ([Bk, C], 8)), ("plan", ([A], 8))],
    "generation-and-abort": [("gen", 0), ("plan", ([A, Bk], 8)), ("plan", ([A, Bk], 8)),
                             ("gen", 1), ("plan", ([A], 8)), ("abort", ([A, D], 8)),
                             ("plan", ([A, D], 8)), ("rows", [1, 2]),
                             ("plan", ([D, A, A, D], 8))],
}


@pytest.mark.parametrize("name", sorted(PLAN_SCRIPTS))
@pytest.mark.parametrize("index_k", [0, 8])
def test_plan_sequences_match_jax(name, index_k):
    kw = dict(slots=2, dirty_cap=4, fill_batch=2)
    if name == "promote-then-hit":
        kw = dict(slots=4)
    if index_k:
        kw.update(index_k=index_k, stratum_bits=3)
    assert _drive(PLAN_SCRIPTS[name], **kw) > 0


def test_plan_random_sequence_matches_jax():
    """A long random script: keys from a pool larger than the slots, row
    churn past the journal cap, generation bumps; every plan equal."""
    rng = np.random.default_rng(21)
    pool = [(f"s{i}", i % 3, 1) for i in range(7)]
    script = [("gen", 0)]
    for _ in range(120):
        r = rng.random()
        if r < 0.6:
            keys = [pool[j] for j in rng.integers(0, len(pool), rng.integers(1, 6))]
            if rng.random() < 0.05:
                keys.append(None)
            script.append(("plan", (keys, 8)))
        elif r < 0.95:
            script.append(("rows", rng.integers(0, 64, rng.integers(1, 12)).tolist()))
        else:
            script.append(("gen", int(rng.integers(0, 3))))
    assert _drive(script, slots=4, fill_batch=3, dirty_cap=20, journal_cap=40,
                  index_k=6, stratum_bits=2) > 50


def test_delta_kernel_marshalling(monkeypatch):
    """The wrapper's ctypes call, without a card: the argument arrays carry
    each tensor's pointer and each integer in the order of the C enums, the
    pods arrive sorted by clipped slot, the launch is counted, and a
    non-zero return raises."""
    import types

    from k8s1m_tpu_torch.ops import delta_topk as dt

    s, n, b, k = 5, 1024, 300, 4
    pm = torch.zeros((s, n), dtype=torch.bool)
    ps = torch.zeros((s, n), dtype=torch.int32)
    slot = torch.from_numpy(np.random.default_rng(0).integers(0, s + 1, b).astype(I32))
    seen = {}

    def fake(p_arr, n_ptrs, i_arr, n_ints, stream):
        seen.update(ptrs=list(p_arr[:n_ptrs]), ints=list(i_arr[:n_ints]), stream=stream.value)
        return seen.get("rc", 0)

    monkeypatch.setattr(dt, "_kernel_entry", lambda: fake)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: types.SimpleNamespace(multi_processor_count=132))
    monkeypatch.setattr(torch.cuda, "device", lambda dev: __import__("contextlib").nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=1234))
    before = dt.delta_plane_topk.launches
    out_idx, out_prio = dt._launch(pm, ps, slot, -5, k=k, stratum_bits=11, row_base=7,
                                   col_base=4096)
    assert dt.delta_plane_topk.launches == before + 1
    assert len(seen["ptrs"]) == len(dt._PTRS) and len(seen["ints"]) == len(dt._INTS)
    ints = dict(zip(dt._INTS, seen["ints"]))
    splits = dt.splits_for(b, n, 132)
    assert ints == dict(s=s, n=n, b=b, k=k, seed=(-5) & 0xFFFFFFFF, row_base=7, col_base=4096,
                        stratum_bits=11, splits=splits)
    ptrs = dict(zip(dt._PTRS, seen["ptrs"]))
    assert (ptrs["pmask"], ptrs["pscore"], ptrs["slot"]) == (pm.data_ptr(), ps.data_ptr(),
                                                             slot.data_ptr())
    assert (ptrs["out_idx"], ptrs["out_prio"]) == (out_idx.data_ptr(), out_prio.data_ptr())
    assert seen["stream"] == 1234 and out_idx.shape == (b, k)
    assert splits == n // dt.TILE and dt.splits_for(4096, 1 << 20, 132) == 33
    seen["rc"] = 700
    with pytest.raises(RuntimeError, match="cudaError 700"):
        dt._launch(pm, ps, slot, 1, k=k, stratum_bits=0, row_base=0, col_base=0)
    with pytest.raises(ValueError, match="pscore must be"):
        dt._launch(pm, ps.to(torch.int64), slot, 1, k=k, stratum_bits=0, row_base=0,
                   col_base=0)
