#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``k8s1m_tpu_torch``).

Drives the port's main paths on one CUDA card at 1,048,576 KWOK nodes,
k=4, chunk 4096, on the plain and the packed table layout: the packed
scheduling wave ``engine.cycle.schedule_batch_packed`` over a rotating 5%
percentageOfNodesToScore window — the uniform wave ``bench.py`` runs by
default (base stage of the fused kernel), the NodeAffinity wave of
``bench.py --affinity`` (path A, BASELINE config 2) and the constrained
wave of ``bench.py --constraints`` (path B, configs 3-4) — and the
deltasched wave ``engine.cycle.schedule_batch_delta`` over cached
per-shape planes covering the whole table (path C: ``bench.py
--deltacache``, C1, and ``bench.py --affinity --deltacache``, C2) — and
then the host coordinator (store -> watch -> wave -> CAS bind) through its
entry point ``tools/sched_bench.py`` (phase 8: the closed loop, template
pods under node churn, constraints, a paced offered load),
``tools/kernel_probe.py`` (phase 9) and ``tools/megarow_drill.py``, the
headline run with overload control, fault injection and tenancy (phase 10).

Phases (each raises on failure; the script then exits non-zero):
  1. device  — the card's name, and its name and power limit as
               ``nvidia-smi --query-gpu=name,power.limit`` reports them;
  2. build   — ``nvcc`` builds every kernel of the paths from ``csrc/``
               (one process per translation unit of both libraries, all
               at once);
  3. kernel vs plain — ``fused_topk`` (CUDA) against
               ``fused_topk_reference`` (plain PyTorch) on the card,
               bit-equal idx and prio: N=65,536, B=512, k=4, both layouts,
               a tainted fleet with tolerating pods, stratum bits 0 and 11,
               and a near-full fleet where pods have fewer than K nodes;
  3b. affinity stage vs plain — a labeled fleet (numeric label > 2^24),
               nodeSelector, all six ops, OR of terms, preferred weights,
               an unsatisfiable selector, plain pods; plain, packed and
               packed-unfused layouts; stratum bits 0 and 11, hash bases;
  3c. constraint stage vs plain — count tables from two earlier waves,
               missing zone/region labels, spread (zone and region),
               required affinity with bootstrap, anti-affinity, preferred
               terms, symmetric own counts, a wave with selectors as well
               (both stages in one launch); both layouts, whole table and
               a window view;
  3d. delta kernel vs plain — ``delta_plane_topk`` (CUDA) against
               ``plane_topk``, bit-equal idx and prio for real pods:
               N=65,536, S=8 and 64, B=512 with padding pods, stratum bits
               0 and 11, hash offsets, scores outside [0, 2047], a slot
               with no feasible column, k=4 and k=128;
  3e. all-distinct worst case — every pod its own group (128 groups per
               block of the fused kernel, 32-row tiles) at N=65,536 x B=512,
               each stage configuration, packed: bit-equal to the plain
               version and timed (``--worst-case-only`` runs just this and
               times the kernel of the tree it is run from);
  4. main path — uniform pods, 4 timed waves per layout with seeds from
               ``numpy.random.default_rng(0)``; one launch of the base stage
               per wave (launch counts reset just before, read just after);
               one wave re-run through the plain version from a clone of the
               table must give identical rows and request columns; both
               layouts must bind identically; no node over-committed;
               binds > 0.  Prints binds/s, p50 wave ms, kernel ms/wave
               (and its group key and order), greedy-assign ms/wave and
               table MB per layout, the batch's distinct pod groups
               (``torch.unique`` over the key rows), the mean and maximum
               groups per block, the grouped bound and the per-pair bound
               (``bound_per_pair_ms``) with the kernel's share of each;
  5. path A  — ``node_affinity_pods(4096)``, Profile without constraint
               plugins; 3 timed waves per layout, one ``aff`` launch per
               wave; the plain-version re-run and layout checks of phase 4;
               every bound pod sits in one of its two zones and outside its
               excluded region;
  6. path B  — 2048 ``bench-spread`` (zone spread) + 2048 ``bench-anti``
               (required hostname anti-affinity) pods, the full Profile,
               constraint state carried across waves; one ``cons`` launch
               per wave; the re-run also compares the nine count tables;
               every anti pod lands on a node whose matching count was 0 at
               the start of its wave; count totals equal the binds.
               Also prints prologue and constraint-commit ms/wave;
  7. path C  — C1 (``uniform_pods(4096)``, one shape) and C2
               (``node_affinity_pods(4096)``, 64 shapes): planes filled in
               16-shape groups, then 2 + 2 delta waves per layout, each
               after ``scatter_rows`` rewrote ``cpu_req`` of 128 journaled
               rows (its dirty vector) with the previous wave's rows in
               flight; exactly one delta-kernel and no fused-kernel launch
               per wave (counts reset just before, read just after); for
               one wave the full recompute, the plain-tail re-run and a
               fresh fill of the planes must all agree with it; both
               layouts bind identically; no node over-committed; binds > 0.
               Prints binds/s, p50 wave ms, delta kernel ms/wave, merge,
               greedy-assign and fill ms, plane and table MB.
  8a. coordinator parity — three groups at 65,536 nodes x 16,384 pods
               (5% window, packed, depth 2, chunk 4096, zero-delay
               retries), each leaving byte-identical stored pod values:
               ``tools/sched_bench.py`` with uniform pods on the card's
               kernels, on the card's scan path (``--backend xla``) and on
               the CPU; with template pods (``--shape-pool 8 --shape-share
               0.9 --seed 3``) on the card and the CPU; and D4's constraint
               construction on the card and the CPU;
  8. coordinator — at 1,048,576 nodes, packed: D1 (``sched_bench --batch
               4096 --depth 2 --score-pct 5``, 65,536 pods, the fused kernel
               on every wave, with ``--encode-profile --delta-profile
               --stats --kernel-profile`` and the knock-out variants over the
               live table on both backends), D2 (the megarow shape:
               ``--batch 512 --depth 3 --score-pct 100 --deltacache on
               --delta-index-k 64 --stratum-bits 15``, the delta kernel on
               the delta waves), D3 (D1 with ``--shape-pool 8 --shape-share
               0.9 --seed 3 --node-churn 4000``: the ``aff`` stage, the sync
               stage, no structural or resync quiesce), D4 (path B through a
               ``Coordinator(with_constraints=True)``: 8 waves of 2048 spread
               + 2048 anti pods, the ``cons`` stage, no node holding anti
               pods of two waves, the count tables equal to a host recount
               from the stored binds) and D5 (D1 at ``--rate 2000``, 32,768 pods:
               p50/p95/p99 schedule-to-bind, adaptive quiesces).  Each pod
               is bound exactly once in the store, the device request
               columns (D3: and allocatable columns) equal the host mirror
               after ``flush``, no node exceeds its allocatable.  Prints
               binds/s, schedule-to-bind quantiles, node write and cold
               build seconds, stage means, quiesces and the device stage's
               share;
  9. kernel_probe — ``tools/kernel_probe.py`` at its default shape
               (53,248 rows x 8192 pods, packed) on the fused kernel and on
               the scan path: ms per batch of every knock-out variant;
  10. megarow — ``megarow_drill.run(parse_args([]))`` on the card at its
               default shape (1,048,576 nodes, batch 512, chunk 4096, depth
               3, 4 tenants, deltacache on, index K 64, automatic stratum
               bits, comparison lane and differential at 131,072): the
               drill's ``passed`` with every gate, fused base-stage and
               delta-kernel launches counted in the run (counts set to 0
               just before it).  Prints saturated and composed binds/s,
               cold build, the compare speedup, the states seen and the
               recovery tick, lost and give-ups, index waves, peak RSS and
               the launches per kernel;
  10a. composed parity — the drill's tick sequence (steady, overload,
               recover) through ``Coordinator(tenancy=..., pipeline=True,
               depth=3)`` at 65,536 nodes with the drill's seeded bind-CAS
               conflict plan and zero-delay retries, on the card and on the
               CPU (chunk 4096 both): byte-identical stored pods, the same
               admitted/rejected counts and the same controller state after
               every tick, through SHEDDING and back to HEALTHY;
  10b. breaker — at 65,536 nodes a ``stall`` plan on the wave launch opens
               a ``CircuitBreaker``; the fallback binds equal the oracle's
               argmax over the host mirror, the breaker walks CLOSED -> OPEN
               -> HALF_OPEN -> CLOSED, and after ``flush`` the device request
               columns equal the host mirror, no node over its allocatable.
Phases 5 and 6 print the same group and bound figures as phase 4.  The
next-to-last line is ``{"kernels": [...]}`` (one entry per fused-kernel
stage configuration and one for the delta kernel: times, bound, launches;
the fused entries add ``bound_per_pair_ms``, ``groups`` and
``all_distinct_ms``; ``launches`` includes the coordinator's of phases 8
and 10, which ``coordinator_launches`` also gives alone, per fused stage);
the last is ``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py [--steps 4] [--path-steps 3] [--delta-steps 2] [--warmup 2]
                          [--out results.json] [--worst-case-only]

Needs one CUDA card; without one it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

NODES = 1 << 20
BATCH = 4096
K = 4
CHUNK = 4096
SCORE_PCT = 5

# H100 SXM published peaks (NVIDIA data sheet, 700 W): scalar f32 outside
# the tensor cores, and HBM3 bandwidth.
PEAK_SCALAR_OPS = 67e12
PEAK_BYTES = 3.35e12
# Scalar operations the base stage needs: per (pod, node) pair for the
# filters (cpu, mem, row-usable and node-name tests), and per FEASIBLE pair
# for scoring and ranking (int->f32 conversions, the four IEEE divisions,
# LeastAllocated/BalancedAllocation/TaintToleration arithmetic and floors,
# weights, clip/shift/xor/mask of the hashed priority, the top-K compare).
FILTER_OPS_PER_PAIR = 5
SCORE_OPS_PER_FEASIBLE_PAIR = 40
# The fused kernel runs that chain once per (pod group, row) — pods with
# equal per-pod inputs share it — and per pair only scans: the shared
# load of the group's staged word, the xor of the pod's row-hash bits and
# the compare with its K-th best.  Per row it hashes the column (two
# murmur3 finalizers and the stratum, ~12 ops each).  `_grouped_bound`
# counts that; the per-pair count above stays as `bound_per_pair_ms`.
SCAN_OPS_PER_PAIR = 3
COLUMN_HASH_OPS = 36


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn`` on the card (CUDA events, after one
    warm-up call)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


# ---- phase 1 -------------------------------------------------------------


def phase_device() -> dict:
    import torch

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda}; {name}")
    log(smi)
    return {"kind": name, "count": torch.cuda.device_count(), "nvidia_smi": smi}


# ---- phase 2 -------------------------------------------------------------


def phase_build() -> dict:
    from k8s1m_tpu_torch.ops import _build

    t0 = time.perf_counter()
    reports = _build.build_all(_build.LIBRARIES)
    for name in _build.LIBRARIES:
        _build.load(name)
    secs = time.perf_counter() - t0
    kernel, frame = "", ""
    registers = {}
    for line in "\n".join(reports.values()).splitlines():
        if "Compiling entry function" in line:
            kernel = line.split("'")[1]
        elif "stack frame" in line:
            frame = line.strip()
        elif "registers" in line:
            registers[kernel] = line.split(":", 1)[-1].strip()
            log(f"[build] {kernel[:72]}: {registers[kernel]}; {frame}")
    log(f"[build] csrc/fused_topk*.cu and csrc/delta_topk.cu built (every unit in parallel) "
        f"and loaded in {secs:.1f}s")
    from k8s1m_tpu_torch.ops import delta_topk, fused_topk

    if not hasattr(fused_topk, "blocks_per_sm"):     # a tree from before the query
        return {"build_s": secs, "registers": registers}
    occupancy = {f"fused_topk[{stage}] {layout}": fused_topk.blocks_per_sm(
        stage, packed=layout == "packed", k=K)
        for stage in fused_topk.STAGES for layout in ("plain", "packed")}
    occupancy["delta_plane_topk"] = delta_topk.blocks_per_sm(K)
    log(f"[build] resident 128-thread blocks per SM at k={K}: "
        + ", ".join(f"{name} {n}" for name, n in occupancy.items()))
    return {"build_s": secs, "registers": registers, "blocks_per_sm": occupancy}


# ---- phase 3 -------------------------------------------------------------


def _fleet(n: int, *, near_full: bool):
    """A KWOK fleet of ``n`` rows (the last 512 rows invalid) with a
    hard-taint group, soft taints and existing requests."""
    from k8s1m_tpu_torch.cluster import populate_kwok_nodes
    from k8s1m_tpu_torch.config import EFFECT_PREFER_NO_SCHEDULE, TableSpec
    from k8s1m_tpu_torch.snapshot.node_table import NodeTableHost

    spec = TableSpec(max_nodes=n)
    host = NodeTableHost(spec)
    live = n - 512
    populate_kwok_nodes(host, live, tainted_fraction=0.1, seed=1)
    rng = np.random.default_rng(2)
    soft = host.vocab.taints.intern(("flaky", "", EFFECT_PREFER_NO_SCHEDULE))
    host.taint_id[:live:7, 1] = soft
    host.taint_effect[:live:7, 1] = EFFECT_PREFER_NO_SCHEDULE
    host.cpu_req[:live:3] = rng.integers(0, 3000, len(range(0, live, 3)))
    host.mem_req[:live:3] = rng.integers(0, 8 << 20, len(range(0, live, 3)))
    if near_full:
        rows = np.arange(live)
        full = rows[rows % 25000 != 5]              # three rows keep room
        host.pods_req[full] = host.pods_alloc[full]
    return spec, host


def _tolerating_batch(spec, host, b: int, device):
    from k8s1m_tpu_torch.snapshot.pod_encoding import (
        PodBatchHost,
        PodInfo,
        Toleration,
        unpack_pod_batch,
    )
    from k8s1m_tpu_torch.config import PodSpec

    pods = []
    for i in range(b - 3):
        tol = []
        if i % 2:
            tol.append(Toleration(key="dedicated"))
        if i % 3 == 0:
            tol.append(Toleration(key="flaky"))
        pods.append(PodInfo(
            f"pod-{i}", cpu_milli=100 + 37 * (i % 29), mem_kib=(100 + 11 * (i % 13)) << 10,
            tolerations=tol, node_name="kwok-node-17" if i == 5 else None,
        ))
    pb = PodBatchHost(PodSpec(batch=b), spec, host.vocab).encode_packed(pods)
    return unpack_pod_batch(pb.ints, pb.bools, pb.spec, pb.table_spec, pb.groups, device)


def phase_kernel_vs_plain(device, n: int = 65536, b: int = 512) -> float:
    import torch

    from k8s1m_tpu_torch.ops.fused_topk import fused_topk, fused_topk_reference
    from k8s1m_tpu_torch.plugins.registry import Profile
    from k8s1m_tpu_torch.snapshot.packing import build_packing_spec, pack_table_host

    profile = Profile(node_affinity=0, topology_spread=0, interpod_affinity=0)
    worst = 0
    for fleet in ("tainted", "near_full"):
        spec, host = _fleet(n, near_full=fleet == "near_full")
        batch = _tolerating_batch(spec, host, b, device)
        tables = {
            "plain": host.to_device(device),
            "packed": pack_table_host(host, build_packing_spec(spec, host.vocab), device),
        }
        for layout, table in tables.items():
            for sb, seed, rb, cb in ((0, 12345, 0, 0), (11, -98765, 7, 4096)):
                kw = dict(k=K, row_base=rb, col_base=cb, stratum_bits=sb)
                idx, prio = fused_topk(table, batch, seed, profile, **kw)
                torch.cuda.synchronize()
                ridx, rprio = fused_topk_reference(table, batch, seed, profile, **kw)
                err = max(
                    int((idx.long() - ridx.long()).abs().max()),
                    int((prio.long() - rprio.long()).abs().max()),
                )
                worst = max(worst, err)
                feasible = int((rprio >= 0).sum())
                short = int(((rprio < 0).sum(1) > 0).sum())
                log(f"[kernel-vs-plain] {fleet:9s} {layout:6s} stratum={sb:2d}: "
                    f"max_abs_err={err} feasible_slots={feasible} "
                    f"pods_short_of_k={short}")
                check(err == 0, f"kernel disagrees with plain version ({fleet}, {layout}, {sb})")
                check(feasible > 0, "no feasible candidate at all")
                if fleet == "near_full":
                    check(short > b // 2, "near-full fleet left most pods with K nodes")
    return float(worst)


# ---- phase 3d: the delta kernel vs plain ----------------------------------


def _delta_inputs(device, s: int, n: int, b: int, seed: int):
    """Random planes — scores outside [0, 2047], negatives included — with
    one slot that has no feasible column, and ``b`` pods, five of them
    padding (slot = S)."""
    import torch

    rng = np.random.default_rng(seed)
    mask = rng.random((s, n)) < 0.6
    mask[s - 2] = False
    score = rng.integers(-3000, 5000, (s, n)).astype(np.int32)
    slot = np.concatenate([rng.integers(0, s, b - 9), [s - 2] * 3, [s - 1], [s] * 5])
    slot = slot.astype(np.int32)
    return (torch.from_numpy(mask).to(device), torch.from_numpy(score).to(device),
            torch.from_numpy(slot).to(device), torch.from_numpy(slot < s).to(device))


def phase_delta_vs_plain(device, n: int = 65536, b: int = 512) -> float:
    """``delta_plane_topk`` (CUDA) against ``plane_topk`` (plain PyTorch),
    bit-equal idx and prio for real pods: S=8 and S=64, padding pods,
    stratum bits 0 and 11, nonzero hash offsets, k=4 and k=128."""
    import torch

    from k8s1m_tpu_torch.engine.deltacache import plane_topk
    from k8s1m_tpu_torch.ops.delta_topk import delta_plane_topk

    worst = 0
    for s in (8, 64):
        pm, ps, slot, real = _delta_inputs(device, s, n, b, seed=s)
        for k, sb, seed, roff, poff in ((4, 0, 4242, 0, 0), (4, 11, -77, 4096, 13),
                                        (128, 11, -(1 << 31), 7, 300)):
            kw = dict(chunk=CHUNK, k=k, stratum_bits=sb, row_offset=roff, pod_offset=poff)
            got = delta_plane_topk(pm, ps, slot, seed, **kw)
            torch.cuda.synchronize()
            ref = plane_topk(pm, ps, slot, seed, **kw)
            err = _compare(got.idx[real], got.prio[real], ref.idx[real], ref.prio[real])
            worst = max(worst, err)
            short = int(((ref.prio[real] < 0).sum(1) > 0).sum())
            log(f"[delta-vs-plain] S={s:2d} k={k:3d} stratum={sb:2d}: max_abs_err={err} "
                f"feasible_slots={int((ref.prio[real] >= 0).sum())} pods_short_of_k={short}")
            check(err == 0, f"delta kernel disagrees with plain version (S={s}, k={k}, {sb})")
            check(short > 0 and bool((ref.prio[real] >= 0).any()),
                  "delta inputs lack a short or a feasible pod")
    return float(worst)


# ---- phase 3e: the all-distinct worst case of the fused kernel -------------


def _stage_inputs(device, stage: str, n: int, b: int):
    """(packed table, batch, kwargs, profile) of one stage configuration at
    n rows: the fleets and pods of phases 3, 3b and 3c."""
    from k8s1m_tpu_torch.cluster.testbeds import (
        affinity_pods,
        constraint_fleet,
        constraint_pods,
        labeled_fleet,
    )
    from k8s1m_tpu_torch.config import PodSpec
    from k8s1m_tpu_torch.engine.cycle import _prologue_stats, schedule_batch_packed
    from k8s1m_tpu_torch.plugins.registry import Profile
    from k8s1m_tpu_torch.snapshot.constraints import ConstraintTracker, empty_constraints
    from k8s1m_tpu_torch.snapshot.packing import build_packing_spec, pack_table_host
    from k8s1m_tpu_torch.snapshot.pod_encoding import PodBatchHost, unpack_pod_batch

    def packed_table(spec, host):
        return pack_table_host(host, build_packing_spec(spec, host.vocab), device)

    def unpack(pb):
        return unpack_pod_batch(pb.ints, pb.bools, pb.spec, pb.table_spec, pb.groups, device)

    if stage == "base":
        spec, host = _fleet(n, near_full=False)
        return (packed_table(spec, host), _tolerating_batch(spec, host, b, device), {},
                Profile(node_affinity=0, topology_spread=0, interpod_affinity=0))
    if stage == "aff":
        spec, host = labeled_fleet(n, seed=7)
        pb = PodBatchHost(PodSpec(batch=b), spec, host.vocab).encode_packed(
            affinity_pods(b - 5, n))
        return (packed_table(spec, host), unpack(pb), dict(with_affinity=True),
                Profile(topology_spread=0, interpod_affinity=0))
    spec, host = constraint_fleet(n)
    tracker = ConstraintTracker(spec)
    pods = constraint_pods(tracker, 3 * b, seed=1, with_selectors=stage == "aff+cons")
    enc = PodBatchHost(PodSpec(batch=b), spec, host.vocab)
    table = packed_table(spec, host)
    cons = empty_constraints(spec, device)
    for w in range(2):      # two earlier waves populate the count tables
        schedule_batch_packed(table, enc.encode_packed(pods[w * b:(w + 1) * b]), 100 + w,
                              profile=Profile(), constraints=cons, chunk=CHUNK, reference=True)
    pb = enc.encode_packed(pods[2 * b:])
    return (table, unpack(pb), dict(with_affinity=stage == "aff+cons", constraints=cons,
                                    stats=_prologue_stats(table, cons)), Profile())


def phase_worst_case(device, n: int = 65536, b: int = 512) -> dict:
    """Every pod its own group (distinct cpu requests: 128 groups per block,
    32-row tiles) at N=65,536 x B=512, each stage configuration on the
    packed layout: bit-equal to the plain version, and timed.  Uses only
    what the port has had since its second slice, so the same function
    also times an earlier tree's kernel."""
    import torch

    from k8s1m_tpu_torch.ops.fused_topk import fused_topk, fused_topk_reference

    out = {}
    for stage in ("base", "aff", "cons", "aff+cons"):
        table, batch, kw, profile = _stage_inputs(device, stage, n, b)
        batch = _take_pods(batch, np.arange(b), cpu=60 + np.arange(b))
        kw = dict(kw, k=K, stratum_bits=7, row_base=3)
        idx, prio = fused_topk(table, batch, 4711, profile, **kw)
        torch.cuda.synchronize()
        ridx, rprio = fused_topk_reference(table, batch, 4711, profile, **kw)
        err = _compare(idx, prio, ridx, rprio)
        check(err == 0, f"all-distinct {stage}: kernel disagrees with the plain version")
        check(bool((rprio >= 0).any()), f"all-distinct {stage}: no feasible candidate")
        ms = cuda_ms(lambda: fused_topk(table, batch, 4711, profile, **kw), 20)
        out[stage] = {"kernel_ms": ms, "max_abs_err": err}
        log(f"[worst-case] {stage:8s} {b} distinct pods x {n} rows (packed): "
            f"kernel_ms={ms:.4f} max_abs_err={err}")
    return out


# ---- phase 4 -------------------------------------------------------------


def _feasible_pairs(view, batch) -> int:
    """(pod, node) pairs of this wave's window that pass the filters — the
    data-dependent part of the bound.  Exact for batches that tolerate no
    taint and pin no node (the main path's uniform pods)."""
    import torch

    from k8s1m_tpu_torch.config import EFFECT_NO_EXECUTE, EFFECT_NO_SCHEDULE
    from k8s1m_tpu_torch.snapshot.packing import is_packed, unpack_chunk

    check(not bool(batch.tolerated.any()) and not bool((batch.node_name_id != 0).any()),
          "feasible-pair count assumes plain pods")
    t = unpack_chunk(view) if is_packed(view) else view
    hard = ((t.taint_id != 0) & ((t.taint_effect == EFFECT_NO_SCHEDULE)
                                 | (t.taint_effect == EFFECT_NO_EXECUTE))).any(1)
    row_ok = (t.pods_alloc - t.pods_req >= 1) & ~hard
    if is_packed(view):
        row_ok &= t.valid
    free_cpu = (t.cpu_alloc - t.cpu_req)[row_ok]
    free_mem = (t.mem_alloc - t.mem_req)[row_ok]
    total = 0
    for i in torch.nonzero(batch.valid).flatten().tolist():
        total += int(((batch.cpu[i] <= free_cpu) & (batch.mem[i] <= free_mem)).sum())
    return total


def _bound(view, batch, k: int) -> tuple[float, str, dict]:
    pairs = int(batch.valid.sum()) * view.num_rows
    feasible = _feasible_pairs(view, batch)
    ops = FILTER_OPS_PER_PAIR * pairs + SCORE_OPS_PER_FEASIBLE_PAIR * feasible
    cols = ("cpu_alloc", "mem_alloc", "pods_alloc", "cpu_req", "mem_req", "pods_req",
            "name_id", "taint_id", "meta" if hasattr(view, "meta") else "taint_effect")
    nbytes = sum(getattr(view, c).numel() * getattr(view, c).element_size() for c in cols)
    nbytes += sum(getattr(batch, f).numel() * getattr(batch, f).element_size()
                  for f in ("cpu", "mem", "valid", "node_name_id", "tolerated"))
    nbytes += 2 * batch.batch * k * 4
    t_ops, t_bytes = ops / PEAK_SCALAR_OPS, nbytes / PEAK_BYTES
    detail = {"pairs": pairs, "feasible_pairs": feasible, "ops": ops, "bytes": nbytes}
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes", detail


def _take_pods(batch, idx, cpu=None):
    """The batch of pods ``idx`` (every per-pod field gathered; ``qkey`` is
    the batch's), with cpu requests ``cpu`` if given."""
    import torch

    idx = torch.as_tensor(idx, device=batch.cpu.device).long()
    out = {f.name: getattr(batch, f.name) for f in dataclasses.fields(batch)}
    out = {name: t if name == "qkey" else t[idx].contiguous() for name, t in out.items()}
    if cpu is not None:
        out["cpu"] = torch.as_tensor(cpu, dtype=torch.int32, device=batch.cpu.device)
    return type(batch)(**out)


def _group_stats(batch, *, with_affinity=False, cons_inputs=None) -> dict:
    """The batch's distinct pod groups, counted independently of the
    kernel with ``torch.unique`` over the key rows (with one representative
    pod each), and the groups in each 128-pod block of the kernel's order."""
    import torch

    from k8s1m_tpu_torch.ops.fused_topk import POD_TILE, group_key, group_order

    key = group_key(batch, with_affinity=with_affinity, cons_inputs=cons_inputs)
    _uniq, inverse = torch.unique(key, dim=0, return_inverse=True)
    groups = int(inverse.max()) + 1
    pos = torch.arange(key.shape[0], device=key.device)
    reps = torch.full((groups,), key.shape[0], dtype=torch.int64, device=key.device)
    reps = reps.scatter_reduce(0, inverse, pos, "amin")
    sk = key[group_order(key).long()]
    starts = torch.ones(key.shape[0], dtype=torch.bool, device=key.device)
    starts[1:] = (sk[1:] != sk[:-1]).any(1)
    starts[::POD_TILE] = True
    per_block = [int(x.sum()) for x in starts.split(POD_TILE)]
    return {"groups": groups, "reps": reps, "groups_per_block_mean": float(np.mean(per_block)),
            "groups_per_block_max": max(per_block)}


def _grouped_bound(per_pair, view, batch, k, reps, **kw) -> tuple[float, str, dict]:
    """The least time for the fused kernel's function as the redesign
    counts it: the scan per pair, the per-pair bound's filter, score and
    stage operations once per (distinct pod group, row) — ``per_pair``
    applied to one representative per group, feasible pairs counted on
    them — and the column hash per row; bytes as the per-pair bound."""
    pair_ms, _by, pair = per_pair(view, batch, k, **kw)
    _ms, _by, rep = per_pair(view, _take_pods(batch, reps), k, **kw)
    ops = SCAN_OPS_PER_PAIR * pair["pairs"] + rep["ops"] + COLUMN_HASH_OPS * view.num_rows
    t_ops, t_bytes = ops / PEAK_SCALAR_OPS, pair["bytes"] / PEAK_BYTES
    detail = {"pairs": pair["pairs"], "group_rows": rep["pairs"],
              "feasible_group_rows": rep["feasible_pairs"], "ops": ops, "bytes": pair["bytes"],
              "bound_per_pair_ms": pair_ms, "per_pair_ops": pair["ops"]}
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes", detail


def _kernel_fields(kernel_ms, plain_ms, prep_ms, bound_ms, bound_by, detail, gs, err) -> dict:
    return {
        "kernel_ms_per_wave": kernel_ms,
        "group_prep_ms_per_wave": prep_ms,
        "plain_ms_per_wave": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "bound_per_pair_ms": detail["bound_per_pair_ms"],
        "share_of_bound": bound_ms / kernel_ms,
        "share_of_bound_per_pair": detail["bound_per_pair_ms"] / kernel_ms,
        "bound_detail": detail,
        "groups": gs["groups"],
        "groups_per_block_mean": gs["groups_per_block_mean"],
        "groups_per_block_max": gs["groups_per_block_max"],
        "max_abs_err": err,
    }


def _kernel_line(res) -> str:
    return (f"kernel_ms/wave={res['kernel_ms_per_wave']:.4f} (group key and order "
            f"{res['group_prep_ms_per_wave']:.4f}; kernel and merge alone "
            f"{res['kernel_device_ms_per_wave']:.4f}) plain_ms/wave={res['plain_ms_per_wave']:.3f} "
            f"groups={res['groups']} per_block_mean={res['groups_per_block_mean']:.2f} "
            f"per_block_max={res['groups_per_block_max']} bound_ms={res['bound_ms']:.5f} "
            f"({res['bound_by']}, share {100 * res['share_of_bound']:.1f}%) "
            f"bound_per_pair_ms={res['bound_per_pair_ms']:.5f} "
            f"(share {100 * res['share_of_bound_per_pair']:.1f}%)")


def phase_main_path(device, *, steps: int, warmup: int) -> dict:
    import torch

    from k8s1m_tpu_torch.cluster import populate_kwok_nodes, uniform_pods
    from k8s1m_tpu_torch.config import PodSpec, TableSpec
    from k8s1m_tpu_torch.engine.assign import greedy_assign
    from k8s1m_tpu_torch.engine.cycle import (
        sample_offset_for,
        sample_rows_for,
        schedule_batch_packed,
    )
    from k8s1m_tpu_torch.ops.fused_topk import (
        candidates,
        fused_topk,
        fused_topk_reference,
        group_key,
        group_order,
        prepare_launch,
        reset_launches,
    )
    from k8s1m_tpu_torch.plugins.registry import Profile
    from k8s1m_tpu_torch.snapshot.node_table import NodeTableHost
    from k8s1m_tpu_torch.snapshot.packing import (
        build_packing_spec,
        is_packed,
        pack_table_host,
        table_bytes,
    )
    from k8s1m_tpu_torch.snapshot.pod_encoding import PodBatchHost, unpack_pod_batch

    profile = Profile(node_affinity=0, topology_spread=0, interpod_affinity=0)
    spec = TableSpec()                                  # 1,048,576 rows
    host = NodeTableHost(spec)
    t0 = time.perf_counter()
    populate_kwok_nodes(host, NODES)
    log(f"[main] populated {NODES} KWOK nodes in {time.perf_counter() - t0:.1f}s")
    packed = PodBatchHost(PodSpec(batch=BATCH), spec, host.vocab).encode_packed(
        uniform_pods(BATCH)
    )
    rows_s = sample_rows_for(NODES, SCORE_PCT, CHUNK)
    seeds = [int(s) for s in np.random.default_rng(0).integers(
        -(1 << 31), 1 << 31, size=warmup + steps)]
    ref_wave = warmup - 1 if warmup else 0

    layouts = {
        "plain": lambda: host.to_device(device),
        "packed": lambda: pack_table_host(host, build_packing_spec(spec, host.vocab), device),
    }
    results: dict = {}
    tables: dict = {}
    first_rows: list = []
    reset_launches()                   # the main path's launch counts start here
    for layout, make in layouts.items():
        table = make()
        check(is_packed(table) == (layout == "packed"), f"{layout} layout not built")
        wave_ms, binds = [], torch.zeros((), dtype=torch.int64, device=device)
        for i in range(warmup + steps):
            off = sample_offset_for(i, NODES, rows_s)
            ref = table.clone() if i == ref_wave else None
            before = fused_topk.launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            table, _asg, rows = schedule_batch_packed(
                table, packed, seeds[i], profile=profile, chunk=CHUNK, k=K,
                sample_rows=rows_s, sample_offset=off,
            )
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            check(fused_topk.launches == before + 1,
                  f"wave {i} launched the kernel {fused_topk.launches - before} times")
            bound_rows = rows[rows >= 0]
            check(bool(((bound_rows >= off) & (bound_rows < off + rows_s)).all()),
                  f"wave {i} bound outside its window")
            if layout == "plain":
                first_rows.append(rows.clone())
            else:
                check(torch.equal(rows, first_rows[i]), f"packed wave {i} differs from plain")
            if ref is not None:
                ref, _ra, ref_rows = schedule_batch_packed(
                    ref, packed, seeds[i], profile=profile, chunk=CHUNK, k=K,
                    sample_rows=rows_s, sample_offset=off, reference=True,
                )
                same = torch.equal(ref_rows, rows) and all(
                    torch.equal(getattr(ref, c), getattr(table, c))
                    for c in ("cpu_req", "mem_req", "pods_req")
                )
                check(same, f"{layout} wave {i}: kernel wave != plain-version wave")
                log(f"[main] {layout}: wave {i} identical to its plain-version re-run")
                del ref
            if i >= warmup:
                wave_ms.append(1e3 * dt)
                binds += (rows >= 0).sum()
        free_cpu, free_mem, free_pods = table.free()
        check(bool((free_cpu >= 0).all() & (free_mem >= 0).all() & (free_pods >= 0).all()),
              f"{layout}: a node is over-committed")
        n_binds = int(binds)
        check(n_binds > 0, f"{layout}: no pod bound")
        tables[layout] = table
        results[layout] = {
            "binds_per_s": n_binds / (sum(wave_ms) / 1e3),
            "binds": n_binds,
            "waves": steps,
            "p50_wave_ms": float(np.percentile(wave_ms, 50)),
            "wave_ms": wave_ms,
            "table_mb": table_bytes(table) / 2**20,
        }
    launches = fused_topk.launches     # read just after the main path
    by_stage = dict(fused_topk.launches_by_stage)
    check(launches == 2 * (warmup + steps) == by_stage["base"],
          f"main path launched the kernel {launches} times for {2 * (warmup + steps)} "
          f"waves (by stage {by_stage})")
    results["launches"] = launches

    # Per-layer times at the main-path shape (launches here are not counted).
    batch = unpack_pod_batch(packed.ints, packed.bools, packed.spec,
                             packed.table_spec, packed.groups, device)
    seed = seeds[-1]
    off = sample_offset_for(warmup + steps, NODES, rows_s)
    kw = dict(k=K, stratum_bits=0)
    for layout, table in tables.items():
        view = table.narrow(off, rows_s)
        idx, prio = fused_topk(view, batch, seed, profile, **kw)
        ridx, rprio = fused_topk_reference(view, batch, seed, profile, chunk=CHUNK, **kw)
        err = max(int((idx.long() - ridx.long()).abs().max()),
                  int((prio.long() - rprio.long()).abs().max()))
        check(err == 0, f"{layout}: kernel != plain version at the main-path shape")
        kernel_ms = cuda_ms(lambda: fused_topk(view, batch, seed, profile, **kw), 50)
        device_ms = cuda_ms(prepare_launch(view, batch, seed, profile, **kw)[0], 50)
        plain_ms = cuda_ms(
            lambda: fused_topk_reference(view, batch, seed, profile, chunk=CHUNK, **kw), 3)
        cand = candidates(view, batch, seed, profile, chunk=CHUNK, k=K)
        greedy_ms = cuda_ms(lambda: greedy_assign(
            cand.idx, cand.prio, cand.cpu, cand.mem, cand.pods,
            batch.cpu, batch.mem, batch.valid), 3)
        gs = _group_stats(batch)
        prep_ms = cuda_ms(lambda: group_order(group_key(batch)), 20)
        bound_ms, bound_by, bound_detail = _grouped_bound(_bound, view, batch, K, gs["reps"])
        res = results[layout]
        res.update(_kernel_fields(kernel_ms, plain_ms, prep_ms, bound_ms, bound_by,
                                  bound_detail, gs, err), greedy_assign_ms_per_wave=greedy_ms,
                   kernel_device_ms_per_wave=device_ms)
        log(f"[main] {layout}: binds/s={res['binds_per_s']:.1f} "
            f"p50_wave_ms={res['p50_wave_ms']:.3f} greedy_assign_ms/wave={greedy_ms:.3f} "
            f"(plain torch) table_MB={res['table_mb']:.1f} " + _kernel_line(res))
    return results


# ---- phases 3b / 3c: the affinity and constraint stages vs plain ----------


def _compare(idx, prio, ridx, rprio) -> int:
    return max(int((idx.long() - ridx.long()).abs().max()),
               int((prio.long() - rprio.long()).abs().max()))


def phase_affinity_vs_plain(device, n: int = 65536, b: int = 512) -> float:
    """The kernel's NodeAffinity stage against the plain version: a labeled
    fleet (a numeric label beyond 2^24), every selector shape, the default
    PodSpec (36 selector slots, V=8), plain / packed / packed-unfused."""
    import torch

    from k8s1m_tpu_torch.cluster.testbeds import affinity_pods, labeled_fleet
    from k8s1m_tpu_torch.config import PodSpec
    from k8s1m_tpu_torch.ops.fused_topk import fused_topk, fused_topk_reference
    from k8s1m_tpu_torch.plugins.registry import Profile
    from k8s1m_tpu_torch.snapshot.packing import build_packing_spec, pack_table_host
    from k8s1m_tpu_torch.snapshot.pod_encoding import PodBatchHost, unpack_pod_batch

    profile = Profile(topology_spread=0, interpod_affinity=0)
    spec, host = labeled_fleet(n, seed=7)
    pb = PodBatchHost(PodSpec(batch=b), spec, host.vocab).encode_packed(affinity_pods(b - 5, n))
    check({"sel", "req", "pref"} <= pb.groups, "affinity batch lacks selector groups")
    batch = unpack_pod_batch(pb.ints, pb.bools, pb.spec, pb.table_spec, pb.groups, device)
    tables = {
        "plain": host.to_device(device),
        "packed": pack_table_host(host, build_packing_spec(spec, host.vocab), device),
        "packed-unfused": pack_table_host(
            host, build_packing_spec(spec, host.vocab, fuse_labels=False), device),
    }
    check(tables["packed"].spec.fuse_labels and not tables["packed-unfused"].spec.fuse_labels,
          "packed layouts do not cover fused and unfused labels")
    worst = 0
    for layout, table in tables.items():
        for sb, seed, rb, cb in ((0, 2024, 0, 0), (11, -31337, 9, 4096)):
            kw = dict(k=K, row_base=rb, col_base=cb, stratum_bits=sb, with_affinity=True)
            idx, prio = fused_topk(table, batch, seed, profile, **kw)
            torch.cuda.synchronize()
            ridx, rprio = fused_topk_reference(table, batch, seed, profile, **kw)
            err = _compare(idx, prio, ridx, rprio)
            worst = max(worst, err)
            feasible = int((rprio >= 0).sum())
            short = int(((rprio < 0).sum(1) > 0).sum())
            log(f"[aff-vs-plain] {layout:14s} stratum={sb:2d}: max_abs_err={err} "
                f"feasible_slots={feasible} pods_short_of_k={short}")
            check(err == 0, f"affinity stage disagrees with plain version ({layout}, {sb})")
            check(feasible > 0 and short > 0, "affinity batch is all-feasible or all-infeasible")
    return float(worst)


def phase_constraints_vs_plain(device, n: int = 65536, b: int = 512) -> float:
    """The kernel's constraint stage against the plain version: count
    tables populated by two earlier waves, a fleet with missing zone and
    region labels, spread / affinity (bootstrap) / anti / preferred refs
    with symmetric own counts, a wave that also carries NodeAffinity
    terms (both stages in one launch), both layouts, whole table and a
    window view (row stride != width)."""
    import torch

    from k8s1m_tpu_torch.cluster.testbeds import constraint_fleet, constraint_pods
    from k8s1m_tpu_torch.config import PodSpec
    from k8s1m_tpu_torch.engine.cycle import (
        AFFINITY_GROUPS,
        _prologue_stats,
        schedule_batch_packed,
    )
    from k8s1m_tpu_torch.ops.fused_topk import fused_topk, fused_topk_reference
    from k8s1m_tpu_torch.plugins.registry import Profile
    from k8s1m_tpu_torch.snapshot.constraints import (
        ConstraintTracker,
        empty_constraints,
        slice_constraints,
    )
    from k8s1m_tpu_torch.snapshot.packing import build_packing_spec, pack_table_host
    from k8s1m_tpu_torch.snapshot.pod_encoding import PodBatchHost, unpack_pod_batch

    spec, host = constraint_fleet(n)
    tracker = ConstraintTracker(spec)
    pods = constraint_pods(tracker, 3 * b, seed=1)
    mixed = constraint_pods(tracker, b, seed=2, with_selectors=True)
    enc = PodBatchHost(PodSpec(batch=b), spec, host.vocab)
    waves = {"cons": enc.encode_packed(pods[2 * b:]), "aff+cons": enc.encode_packed(mixed)}
    check(not waves["cons"].groups & AFFINITY_GROUPS and waves["aff+cons"].groups & AFFINITY_GROUPS,
          "constraint waves do not cover both stage configurations")
    worst = 0
    for layout in ("plain", "packed"):
        table = (host.to_device(device) if layout == "plain" else
                 pack_table_host(host, build_packing_spec(spec, host.vocab), device))
        cons = empty_constraints(spec, device)
        for w in range(2):      # two earlier waves populate the count tables
            schedule_batch_packed(table, enc.encode_packed(pods[w * b:(w + 1) * b]), 100 + w,
                                  profile=Profile(), constraints=cons, chunk=CHUNK,
                                  reference=True)
        check(int(cons.tgt_node.sum()) > 0 and int(cons.own_node.sum()) > 0
              and int(cons.spread_zone.sum()) > 0 and int(cons.spread_region.sum()) > 0,
              "earlier waves left a count table empty")
        stats = _prologue_stats(table, cons)
        for stage, pb in waves.items():
            batch = unpack_pod_batch(pb.ints, pb.bools, pb.spec, pb.table_spec, pb.groups,
                                     device)
            for off, rows in ((0, n), (n // 16, n // 2)):
                view = table.narrow(off, rows)
                vcons = slice_constraints(cons, off, rows)
                check(rows == n or not vcons.tgt_node.is_contiguous(), "window view is a copy")
                kw = dict(k=K, with_affinity=stage == "aff+cons", constraints=vcons,
                          stats=stats, stratum_bits=11 if off else 0, row_base=3 if off else 0,
                          col_base=off)
                idx, prio = fused_topk(view, batch, -777 - off, Profile(), **kw)
                torch.cuda.synchronize()
                ridx, rprio = fused_topk_reference(view, batch, -777 - off, Profile(), **kw)
                err = _compare(idx, prio, ridx, rprio)
                worst = max(worst, err)
                log(f"[cons-vs-plain] {layout:6s} {stage:8s} rows={rows:6d} offset={off:5d}: "
                    f"max_abs_err={err} feasible_slots={int((rprio >= 0).sum())}")
                check(err == 0, f"constraint stage disagrees with plain version "
                                f"({layout}, {stage}, offset {off})")
                check(bool((rprio >= 0).any()), "no feasible candidate at all")
    return float(worst)


# ---- phases 5 / 6: paths A (NodeAffinity) and B (constraints) at 1M nodes --


# Operations the added stages need, counted like the base stage's:
# - affinity, per pair and live selector expression: three shared loads,
#   the op dispatch, V value compares, the AND/OR into the term masks and
#   the bit extract (10 + V); per row and 128-pod tile, the resolve of
#   every query key against every label slot (L x Q compares);
# - constraints, per pair and live ref: the record loads, the slot/domain
#   checks, the count load, the skew or (anti-)affinity test (~15);
# - per feasible pair, each added score: conversion, multiply, IEEE
#   division, clip, floor and weight (~10).
AFF_OPS_PER_EXPR_PAIR = 10
CONS_OPS_PER_REF_PAIR = 15
STAGE_SCORE_OPS_PER_FEASIBLE_PAIR = 10


def _stage_bound(view, batch, k: int, *, vcons=None, stats=None) -> tuple[float, str, dict]:
    """The least time the card needs for one launch at this wave's data:
    the larger of bytes over HBM bandwidth and operations over the scalar
    peak.  Feasible pairs are counted with the plain filters."""
    import torch

    from k8s1m_tpu_torch.config import EFFECT_NO_EXECUTE, EFFECT_NO_SCHEDULE
    from k8s1m_tpu_torch.ops.fused_topk import POD_TILE
    from k8s1m_tpu_torch.ops.label_match import resolve_query_keys
    from k8s1m_tpu_torch.plugins import topology
    from k8s1m_tpu_torch.plugins.filters import node_affinity
    from k8s1m_tpu_torch.snapshot.constraints import slice_constraints
    from k8s1m_tpu_torch.snapshot.packing import DomainView, is_packed, unpack_chunk

    check(not bool(batch.tolerated.any()) and not bool((batch.node_name_id != 0).any()),
          "feasible-pair count assumes pods without tolerations or nodeName")
    with_aff = vcons is None
    t = unpack_chunk(view) if is_packed(view) else view
    n, b = view.num_rows, batch.batch
    hard = ((t.taint_id != 0) & ((t.taint_effect == EFFECT_NO_SCHEDULE)
                                 | (t.taint_effect == EFFECT_NO_EXECUTE))).any(1)
    row_ok = (t.pods_alloc - t.pods_req >= 1) & ~hard & t.valid
    feasible = 0
    for c0 in range(0, n, CHUNK):
        c1 = min(c0 + CHUNK, n)
        ok = ((batch.cpu[:, None] <= (t.cpu_alloc - t.cpu_req)[None, c0:c1])
              & (batch.mem[:, None] <= (t.mem_alloc - t.mem_req)[None, c0:c1])
              & row_ok[None, c0:c1] & batch.valid[:, None])
        if with_aff:
            ok &= node_affinity(batch, resolve_query_keys(
                t.label_key[c0:c1], t.label_val[c0:c1], t.label_num[c0:c1], batch.qkey))
        else:
            dom = DomainView(valid=row_ok[c0:c1], zone=t.zone[c0:c1], region=t.region[c0:c1])
            ok &= topology.filter_and_score(dom, batch, slice_constraints(vcons, c0, c1 - c0),
                                            stats, 0, 0)[0]
        feasible += int(ok.sum())
    valid = batch.valid[:, None]
    pairs = int(batch.valid.sum()) * n
    if with_aff:
        v = batch.req_vals.shape[-1]
        live_exprs = int((batch.req_expr_valid & batch.req_term_valid[:, :, None]
                          & valid[:, :, None]).sum()
                         + (batch.pref_expr_valid & batch.pref_term_valid[:, :, None]
                            & valid[:, :, None]).sum())
        stage_ops = (AFF_OPS_PER_EXPR_PAIR + v) * live_exprs * n
        stage_ops += view.label_key.shape[1] * batch.qkey.shape[0] * n * -(-b // POD_TILE)
        cols = ("label_key", "label_val", "label_num")
    else:
        live_refs = int((batch.spread_valid & valid).sum()
                        + ((batch.ipa_valid & (batch.ipa_required | (batch.ipa_weight != 0)))
                           & valid).sum()
                        + (batch.iinc_valid & valid).sum())
        stage_ops = CONS_OPS_PER_REF_PAIR * live_refs * n
        cols = ("zone", "region")
    ops = (FILTER_OPS_PER_PAIR * pairs + stage_ops
           + (SCORE_OPS_PER_FEASIBLE_PAIR + STAGE_SCORE_OPS_PER_FEASIBLE_PAIR) * feasible)
    base_cols = ("cpu_alloc", "mem_alloc", "pods_alloc", "cpu_req", "mem_req", "pods_req",
                 "name_id", "taint_id", "meta" if is_packed(view) else "taint_effect")
    tensors = [getattr(view, c) for c in base_cols + cols]
    tensors += [f for f in vars(batch).values() if isinstance(f, torch.Tensor)]
    if vcons is not None:
        tensors += [getattr(vcons, f) for f in vars(vcons)]
    nbytes = sum(x.numel() * x.element_size() for x in tensors) + 2 * b * k * 4
    t_ops, t_bytes = ops / PEAK_SCALAR_OPS, nbytes / PEAK_BYTES
    detail = {"pairs": pairs, "feasible_pairs": feasible, "stage_ops": stage_ops,
              "ops": ops, "bytes": nbytes}
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes", detail


def phase_path(device, path: str, *, steps: int, warmup: int) -> dict:
    """Path A (``bench.py --affinity``, BASELINE config 2) or path B
    (``bench.py --constraints``, configs 3-4) at 1,048,576 KWOK nodes,
    both layouts, through ``schedule_batch_packed``."""
    import torch

    from k8s1m_tpu_torch.cluster import (
        affinity_deployment,
        node_affinity_pods,
        populate_kwok_nodes,
        spread_deployment,
    )
    from k8s1m_tpu_torch.config import (
        TOPO_HOSTNAME,
        TOPO_ZONE,
        PodSpec,
        TableSpec,
    )
    from k8s1m_tpu_torch.engine.assign import greedy_assign
    from k8s1m_tpu_torch.engine.cycle import (
        _prologue_stats,
        commit_constraints_for_batch,
        commit_fields_of,
        finalize_batch,
        sample_offset_for,
        sample_rows_for,
        schedule_batch_packed,
    )
    from k8s1m_tpu_torch.ops.fused_topk import (
        _cons_pod_inputs,
        candidates,
        fused_topk,
        fused_topk_reference,
        group_key,
        group_order,
        prepare_launch,
        reset_launches,
    )
    from k8s1m_tpu_torch.plugins.registry import Profile
    from k8s1m_tpu_torch.snapshot.constraints import (
        FIELDS,
        ConstraintTracker,
        empty_constraints,
        slice_constraints,
    )
    from k8s1m_tpu_torch.snapshot.node_table import NodeTableHost
    from k8s1m_tpu_torch.snapshot.packing import build_packing_spec, pack_table_host, table_bytes
    from k8s1m_tpu_torch.snapshot.pod_encoding import PodBatchHost, unpack_pod_batch

    tag = f"path-{path}"
    half = BATCH // 2
    if path == "A":
        stage = "aff"
        spec = TableSpec()
        profile = Profile(topology_spread=0, interpod_affinity=0)
        pods = node_affinity_pods(BATCH)
        pod_spec = PodSpec(batch=BATCH, aff_terms=1, aff_exprs=2, aff_values=2, pref_terms=1)
    else:
        stage = "cons"
        spec = TableSpec(max_nodes=NODES, max_zones=128, max_regions=16)
        profile = Profile()
        tracker = ConstraintTracker(spec)
        pods = (spread_deployment(tracker, "bench-spread", half, topo=TOPO_ZONE)
                + affinity_deployment(tracker, "bench-anti", BATCH - half, anti=True))
        anti_tid = tracker.affinity_slot("default", {"app": "bench-anti"}, TOPO_HOSTNAME)
        pod_spec = PodSpec(batch=BATCH, spread_refs=1, affinity_refs=1, spread_incs=1,
                           ipa_incs=1)
    host = NodeTableHost(spec)
    t0 = time.perf_counter()
    populate_kwok_nodes(host, NODES)
    log(f"[{tag}] populated {NODES} KWOK nodes in {time.perf_counter() - t0:.1f}s")
    packed = PodBatchHost(pod_spec, spec, host.vocab).encode_packed(pods)
    check(bool(packed.groups & {"sel", "req", "pref"}) == (path == "A"),
          f"{tag}: wrong selector groups {sorted(packed.groups)}")
    if path == "A":
        # Each pod requires zone z1 or z2 and excludes one region.
        zid = [host.vocab.zones.lookup(f"zone-{z}") for z in range(64)]
        rid = [host.vocab.regions.lookup(f"region-{r}") for r in range(8)]
        allowed = torch.tensor([[zid[i % 64], zid[(i + 32) % 64]] for i in range(BATCH)],
                               dtype=torch.int32, device=device)
        excluded = torch.tensor([rid[(i + 1) % 8] for i in range(BATCH)], dtype=torch.int32,
                                device=device)
    rows_s = sample_rows_for(NODES, SCORE_PCT, CHUNK)
    seeds = [int(s) for s in np.random.default_rng(1 if path == "A" else 2).integers(
        -(1 << 31), 1 << 31, size=warmup + steps)]
    ref_wave = warmup - 1
    layouts = {
        "plain": lambda: host.to_device(device),
        "packed": lambda: pack_table_host(host, build_packing_spec(spec, host.vocab), device),
    }
    results: dict = {}
    states: dict = {}
    first_rows: list = []
    reset_launches()                   # this path's launch counts start here
    for layout, make in layouts.items():
        table = make()
        cons = empty_constraints(spec, device) if path == "B" else None
        wave_ms, binds = [], torch.zeros((), dtype=torch.int64, device=device)
        kind_binds = torch.zeros(2, dtype=torch.int64, device=device)  # spread, anti
        for i in range(warmup + steps):
            off = sample_offset_for(i, NODES, rows_s)
            ref = None
            if i == ref_wave:
                ref = (table.clone(), cons.clone() if cons is not None else None)
            start_tgt = cons.tgt_node[anti_tid].clone() if cons is not None else None
            before = fused_topk.launches_by_stage[stage]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            table, _asg, rows = schedule_batch_packed(
                table, packed, seeds[i], profile=profile, constraints=cons, chunk=CHUNK, k=K,
                sample_rows=rows_s, sample_offset=off,
            )
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            check(fused_topk.launches_by_stage[stage] == before + 1,
                  f"{tag} wave {i} did not launch the {stage} stage once")
            bound = rows >= 0
            bound_rows = rows[bound].long()
            check(bool(((bound_rows >= off) & (bound_rows < off + rows_s)).all()),
                  f"{tag} wave {i} bound outside its window")
            if path == "A":
                zone = table.zone[rows.clamp(min=0).long()].to(torch.int32)
                region = table.region[rows.clamp(min=0).long()].to(torch.int32)
                ok = ((zone[:, None] == allowed).any(1) & (region != excluded)) | ~bound
                check(bool(ok.all()), f"{tag} wave {i}: a pod bound outside its affinity")
            else:
                anti = bound.clone()
                anti[:half] = False
                check(bool((start_tgt[rows[anti].long()] == 0).all()),
                      f"{tag} wave {i}: an anti-affinity pod bound next to a matching pod")
                kind_binds[0] += bound[:half].sum()
                kind_binds[1] += anti.sum()
            if layout == "plain":
                first_rows.append(rows.clone())
            else:
                check(torch.equal(rows, first_rows[i]), f"{tag} packed wave {i} differs from plain")
            if ref is not None:
                rtable, rcons = ref
                rtable, _ra, ref_rows = schedule_batch_packed(
                    rtable, packed, seeds[i], profile=profile, constraints=rcons, chunk=CHUNK,
                    k=K, sample_rows=rows_s, sample_offset=off, reference=True,
                )
                same = torch.equal(ref_rows, rows) and all(
                    torch.equal(getattr(rtable, c), getattr(table, c))
                    for c in ("cpu_req", "mem_req", "pods_req")
                ) and (cons is None or all(
                    torch.equal(getattr(rcons, f), getattr(cons, f)) for f in FIELDS))
                check(same, f"{tag} {layout} wave {i}: kernel wave != plain-version wave")
                log(f"[{tag}] {layout}: wave {i} identical to its plain-version re-run"
                    + (" (rows, request columns, 9 count tables)" if cons is not None else ""))
                del ref, rtable, rcons
            if i >= warmup:
                wave_ms.append(1e3 * dt)
                binds += bound.sum()
        free_cpu, free_mem, free_pods = table.free()
        check(bool((free_cpu >= 0).all() & (free_mem >= 0).all() & (free_pods >= 0).all()),
              f"{tag} {layout}: a node is over-committed")
        n_binds = int(binds)
        check(n_binds > 0, f"{tag} {layout}: no pod bound")
        res = {
            "binds_per_s": n_binds / (sum(wave_ms) / 1e3),
            "binds": n_binds,
            "waves": steps,
            "p50_wave_ms": float(np.percentile(wave_ms, 50)),
            "wave_ms": wave_ms,
            "table_mb": table_bytes(table) / 2**20,
        }
        if cons is not None:
            spread_b, anti_b = (int(x) for x in kind_binds)
            totals = {f: int(getattr(cons, f).sum()) for f in FIELDS}
            want = dict.fromkeys(FIELDS, 0)
            want.update(spread_zone=spread_b, tgt_node=anti_b, own_node=anti_b)
            check(totals == want, f"{tag} {layout}: count totals {totals} != binds {want}")
            res.update(spread_binds=spread_b, anti_binds=anti_b, count_totals=totals,
                       constraint_mb=sum(getattr(cons, f).numel() * 4 for f in FIELDS) / 2**20)
        results[layout] = res
        states[layout] = (table, cons)
    by_stage = dict(fused_topk.launches_by_stage)     # read just after the path
    check(by_stage[stage] == 2 * (warmup + steps) == sum(by_stage.values()),
          f"{tag} launched {by_stage} for {2 * (warmup + steps)} waves")
    results["launches"] = by_stage[stage]

    # Per-layer times at the path's shape (launches here are not counted).
    batch = unpack_pod_batch(packed.ints, packed.bools, packed.spec,
                             packed.table_spec, packed.groups, device)
    seed = seeds[-1]
    off = sample_offset_for(warmup + steps, NODES, rows_s)
    for layout, (table, cons) in states.items():
        view = table.narrow(off, rows_s)
        stats = vcons = None
        if cons is not None:
            stats = _prologue_stats(table, cons)
            vcons = slice_constraints(cons, off, rows_s)
        kw = dict(k=K, with_affinity=path == "A", constraints=vcons, stats=stats)
        idx, prio = fused_topk(view, batch, seed, profile, **kw)
        ridx, rprio = fused_topk_reference(view, batch, seed, profile, chunk=CHUNK, **kw)
        err = _compare(idx, prio, ridx, rprio)
        check(err == 0, f"{tag} {layout}: kernel != plain version at the path's shape")
        kernel_ms = cuda_ms(lambda: fused_topk(view, batch, seed, profile, **kw), 50)
        device_ms = cuda_ms(prepare_launch(view, batch, seed, profile, **kw)[0], 50)
        plain_ms = cuda_ms(
            lambda: fused_topk_reference(view, batch, seed, profile, chunk=CHUNK, **kw), 3)
        cand = candidates(view, batch, seed, profile, chunk=CHUNK, **kw)
        greedy_ms = cuda_ms(lambda: greedy_assign(
            cand.idx, cand.prio, cand.cpu, cand.mem, cand.pods,
            batch.cpu, batch.mem, batch.valid), 3)
        cons_in = _cons_pod_inputs(batch, stats) if cons is not None else None
        gkw = dict(with_affinity=path == "A", cons_inputs=cons_in)
        gs = _group_stats(batch, **gkw)
        prep_ms = cuda_ms(lambda: group_order(group_key(batch, **gkw)), 20)
        bound_ms, bound_by, bound_detail = _grouped_bound(
            _stage_bound, view, batch, K, gs["reps"], vcons=vcons, stats=stats)
        res = results[layout]
        res.update(_kernel_fields(kernel_ms, plain_ms, prep_ms, bound_ms, bound_by,
                                  bound_detail, gs, err), greedy_assign_ms_per_wave=greedy_ms,
                   kernel_device_ms_per_wave=device_ms)
        line = (f"[{tag}] {layout}: binds/s={res['binds_per_s']:.1f} "
                f"p50_wave_ms={res['p50_wave_ms']:.3f} greedy_assign_ms/wave={greedy_ms:.3f} "
                f"table_MB={res['table_mb']:.1f} " + _kernel_line(res))
        if cons is not None:
            prologue_ms = cuda_ms(lambda: _prologue_stats(table, cons), 3)
            scratch = cons.clone()
            fields = commit_fields_of(batch)
            _t, _c, asg = finalize_batch(table.clone(), None, cand, fields)
            local = torch.where(asg.bound, asg.node_row, torch.zeros_like(asg.node_row))
            commit_ms = cuda_ms(lambda: commit_constraints_for_batch(
                scratch, fields, asg, local, asg.bound, asg.bound), 3)
            res.update(prologue_ms_per_wave=prologue_ms, commit_ms_per_wave=commit_ms)
            line += (f" prologue_ms/wave={prologue_ms:.3f} constraint_commit_ms/wave="
                     f"{commit_ms:.3f} constraint_MB={res['constraint_mb']:.1f} "
                     f"binds spread/anti={res['spread_binds']}/{res['anti_binds']}")
        log(line)
    return results


# ---- phase 7: path C, the deltasched waves at 1M nodes --------------------


DELTA_DIRTY = 128       # journaled dirty rows per wave (bench.py --delta-dirty)
FILL_BATCH = 16         # plane-fill representatives per group (bench.py:473-485)
# Operations the plane tail needs (csrc/delta_topk.cu): per (pod, column)
# pair the load of its slot's staged word, the xor of the pod's hash bits,
# the feasibility test and the compare against the K-th best entry; per
# (slot, column) the staging (mask and score loads, clip, shift, or,
# select, store); per column its hash (two murmur3 finalizers and the
# stratum, ~12 ops each).  Clip, shift and or are work per (slot, column),
# not per pair: the pods of a slot share them.
DELTA_OPS_PER_PAIR = 4
DELTA_OPS_PER_STAGED = 8
DELTA_OPS_PER_COLUMN = 36


def _delta_bound(s: int, n: int, b: int, k: int) -> tuple[float, str, dict]:
    """The least time the card needs for one plane tail: the larger of the
    bytes (each plane entry, slot and output read or written once) over
    HBM bandwidth and the operations over the scalar peak."""
    ops = DELTA_OPS_PER_PAIR * b * n + DELTA_OPS_PER_STAGED * s * n + DELTA_OPS_PER_COLUMN * n
    nbytes = 5 * s * n + 4 * b + 2 * b * k * 4
    t_ops, t_bytes = ops / PEAK_SCALAR_OPS, nbytes / PEAK_BYTES
    detail = {"pairs": b * n, "ops": ops, "bytes": nbytes}
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes", detail


def phase_delta_path(device, config: str, *, steps: int, warmup: int) -> dict:
    """Path C: the deltasched wave of ``bench.py --deltacache`` (C1, uniform
    pods, one shape) or ``bench.py --affinity --deltacache`` (C2,
    ``node_affinity_pods``, 64 shapes) at 1,048,576 KWOK nodes, both
    layouts, through ``fill_shape_planes`` and ``schedule_batch_delta``.
    Each wave first rewrites ``cpu_req`` of 128 journaled rows through
    ``scatter_rows`` (its dirty vector) and passes the previous wave's bound
    rows in flight."""
    import dataclasses

    import torch

    from k8s1m_tpu_torch.cluster import node_affinity_pods, populate_kwok_nodes, uniform_pods
    from k8s1m_tpu_torch.config import PodSpec, TableSpec
    from k8s1m_tpu_torch.engine import deltacache as dc
    from k8s1m_tpu_torch.engine.assign import greedy_assign
    from k8s1m_tpu_torch.engine.cycle import fill_shape_planes, schedule_batch_delta
    from k8s1m_tpu_torch.ops import delta_topk
    from k8s1m_tpu_torch.ops import fused_topk as ft
    from k8s1m_tpu_torch.plugins.registry import Profile
    from k8s1m_tpu_torch.snapshot.hotfeed import shape_key
    from k8s1m_tpu_torch.snapshot.node_table import NodeTableHost, scatter_rows
    from k8s1m_tpu_torch.snapshot.packing import build_packing_spec, pack_table_host, table_bytes
    from k8s1m_tpu_torch.snapshot.pod_encoding import PodBatchHost, unpack_pod_batch

    tag = f"path-{config}"
    spec = TableSpec(max_nodes=NODES)
    if config == "C1":
        pods = uniform_pods(BATCH)
        pod_spec = PodSpec(batch=BATCH)
        profile = Profile(node_affinity=0, topology_spread=0, interpod_affinity=0)
    else:
        pods = node_affinity_pods(BATCH)
        pod_spec = PodSpec(batch=BATCH, aff_terms=1, aff_exprs=2, aff_values=2, pref_terms=1)
        profile = Profile(topology_spread=0, interpod_affinity=0)
    host = NodeTableHost(spec)
    t0 = time.perf_counter()
    populate_kwok_nodes(host, NODES)
    log(f"[{tag}] populated {NODES} KWOK nodes in {time.perf_counter() - t0:.1f}s")
    packed = PodBatchHost(pod_spec, spec, host.vocab).encode_packed(pods)
    keys = [shape_key(p) for p in pods]
    check(None not in keys, f"{tag}: uncacheable pods")
    slot_of = {key: i for i, key in enumerate(dict.fromkeys(keys))}
    nslots = len(slot_of)
    check(nslots == (1 if config == "C1" else 64), f"{tag}: {nslots} shapes")
    slot_ids = np.array([slot_of[key] for key in keys], np.int32)
    rep_of = {key: pods[keys.index(key)] for key in slot_of}
    fill_enc = PodBatchHost(dataclasses.replace(pod_spec, batch=FILL_BATCH), spec, host.vocab)
    fills = []
    shapes = list(slot_of)
    for off in range(0, nslots, FILL_BATCH):
        group = shapes[off:off + FILL_BATCH]
        fs = np.full(FILL_BATCH, nslots, np.int32)
        fs[: len(group)] = range(off, off + len(group))
        fills.append((fill_enc.encode_packed([rep_of[key] for key in group]), fs))
    total = warmup + steps
    rng = np.random.default_rng(0)
    dirtys = [np.sort(rng.choice(NODES, DELTA_DIRTY, replace=False)).astype(np.int32)
              for _ in range(total)]
    churn = [rng.integers(0, host.cpu_alloc[d] // 2).astype(np.int32) for d in dirtys]
    seeds = [int(x) for x in np.random.default_rng(3 if config == "C1" else 4).integers(
        -(1 << 31), 1 << 31, size=total)]
    ref_wave = warmup - 1
    layouts = {
        "plain": lambda: host.to_device(device),
        "packed": lambda: pack_table_host(host, build_packing_spec(spec, host.vocab), device),
    }
    kw = dict(profile=profile, slot_ids=slot_ids, chunk=CHUNK, k=K)

    def fill(table, planes):
        times = []
        for fpb, fs in fills:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fill_shape_planes(table, fpb, fs, planes, profile=profile, chunk=CHUNK)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        return times

    def new_planes():
        return (torch.zeros((nslots, NODES), dtype=torch.bool, device=device),
                torch.zeros((nslots, NODES), dtype=torch.int32, device=device))

    results: dict = {}
    first_rows: list = []
    launches = 0
    for layout, make in layouts.items():
        table = make()
        planes = new_planes()
        fill_ms = fill(table, planes)
        prev = None
        wave_ms, binds = [], torch.zeros((), dtype=torch.int64, device=device)
        for i in range(total):
            scatter_rows(table, dirtys[i], {"cpu_req": churn[i]})
            inflight = () if prev is None else (prev,)
            pre = None
            if i == ref_wave:
                pre = (table.clone(), planes[0].clone(), planes[1].clone())
            ft.reset_launches()                # this wave's launch counts start here
            delta_topk.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            table, _asg, rows, planes = schedule_batch_delta(
                table, packed, seeds[i], planes=planes, dirty=dirtys[i],
                inflight_rows=inflight, **kw)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            n_delta, n_fused = delta_topk.delta_plane_topk.launches, ft.fused_topk.launches
            check(n_delta == 1 and n_fused == 0,
                  f"{tag} wave {i}: {n_delta} delta and {n_fused} fused launches")
            launches += n_delta
            if layout == "plain":
                first_rows.append(rows.clone())
            else:
                check(torch.equal(rows, first_rows[i]), f"{tag} packed wave {i} differs from plain")
            if pre is not None:
                _delta_wave_checks(tag, layout, i, pre, table, _asg, rows, planes, packed,
                                   seeds[i], dirtys[i], inflight, fills, kw, new_planes)
                del pre
            if i >= warmup:
                wave_ms.append(1e3 * dt)
                binds += (rows >= 0).sum()
            prev = rows
        free_cpu, free_mem, free_pods = table.free()
        check(bool((free_cpu >= 0).all() & (free_mem >= 0).all() & (free_pods >= 0).all()),
              f"{tag} {layout}: a node is over-committed")
        n_binds = int(binds)
        check(n_binds > 0, f"{tag} {layout}: no pod bound")

        # Per-layer times at the path's shape (launches here are not counted).
        slot_t = torch.from_numpy(slot_ids).to(device)
        tail_kw = dict(chunk=CHUNK, k=K)
        seed = seeds[-1]
        got = delta_topk.delta_plane_topk(planes[0], planes[1], slot_t, seed, **tail_kw)
        ref = dc.plane_topk(planes[0], planes[1], slot_t, seed, **tail_kw)
        err = _compare(got.idx, got.prio, ref.idx, ref.prio)
        check(err == 0, f"{tag} {layout}: delta kernel != plain version at the path's shape")
        kernel_ms = cuda_ms(lambda: delta_topk.delta_plane_topk(
            planes[0], planes[1], slot_t, seed, **tail_kw), 50)
        plain_ms = cuda_ms(lambda: dc.plane_topk(planes[0], planes[1], slot_t, seed,
                                                 **tail_kw), 1)
        batch = unpack_pod_batch(packed.ints, packed.bools, packed.spec, packed.table_spec,
                                 packed.groups, device)
        dirty_t = torch.from_numpy(dirtys[-1]).to(device)
        merge_ms = cuda_ms(lambda: dc.merge_dirty_planes(
            table, batch, profile, slot_t, planes[0], planes[1],
            dc.combine_dirty(dirty_t, (prev,), NODES), packed.groups), 3)
        cand = dc.attach_payload(table, got)
        greedy_ms = cuda_ms(lambda: greedy_assign(
            cand.idx, cand.prio, cand.cpu, cand.mem, cand.pods,
            batch.cpu, batch.mem, batch.valid), 3)
        bound_ms, bound_by, bound_detail = _delta_bound(nslots, NODES, int(batch.valid.sum()), K)
        res = results[layout] = {
            "binds_per_s": n_binds / (sum(wave_ms) / 1e3),
            "binds": n_binds,
            "waves": steps,
            "p50_wave_ms": float(np.percentile(wave_ms, 50)),
            "wave_ms": wave_ms,
            "kernel_ms_per_wave": kernel_ms,
            "plain_ms_per_wave": plain_ms,
            "merge_ms_per_wave": merge_ms,
            "greedy_assign_ms_per_wave": greedy_ms,
            "fill_ms_per_group": fill_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "bound_detail": bound_detail,
            "max_abs_err": err,
            "plane_mb": nslots * NODES * 5 / 2**20,
            "table_mb": table_bytes(table) / 2**20,
            "shapes": nslots,
        }
        log(f"[{tag}] {layout}: binds/s={res['binds_per_s']:.1f} "
            f"p50_wave_ms={res['p50_wave_ms']:.3f} delta_kernel_ms/wave={kernel_ms:.4f} "
            f"bound_ms={bound_ms:.5f} ({bound_by}, share {100 * bound_ms / kernel_ms:.1f}%) "
            f"plain_ms/wave={plain_ms:.3f} merge_ms/wave={merge_ms:.3f} greedy_assign_ms/wave={greedy_ms:.3f} "
            f"fill_ms/group={'/'.join(f'{x:.1f}' for x in fill_ms)} "
            f"plane_MB={res['plane_mb']:.1f} table_MB={res['table_mb']:.1f}")
        del planes, table
    results["launches"] = launches
    check(launches == 2 * total, f"{tag}: {launches} delta launches for {2 * total} waves")
    return results


def _delta_wave_checks(tag, layout, i, pre, table, asg, rows, planes, packed, seed, dirty,
                       inflight, fills, kw, new_planes) -> None:
    """One wave of path C held to the deltasched contract, from clones of
    the pre-wave state: (a) the full recompute (``schedule_batch_packed``
    over the whole table, on the fused kernel) binds identically, (b) the
    plain-tail re-run (``backend="xla"``) gives the same rows and planes,
    (c) the merged planes equal a fresh fill over the pre-wave table."""
    import torch

    from k8s1m_tpu_torch.engine.cycle import (
        fill_shape_planes,
        schedule_batch_delta,
        schedule_batch_packed,
    )

    pre_table, pre_mask, pre_score = pre
    full_t, full_asg, full_rows = schedule_batch_packed(
        pre_table.clone(), packed, seed, profile=kw["profile"], chunk=kw["chunk"], k=kw["k"])
    same = torch.equal(full_rows, rows) and all(
        torch.equal(getattr(full_asg, f), getattr(asg, f))
        for f in ("node_row", "bound", "score", "zone", "region")
    ) and all(torch.equal(getattr(full_t, c), getattr(table, c))
              for c in ("cpu_req", "mem_req", "pods_req"))
    check(same, f"{tag} {layout} wave {i}: delta wave != full recompute")
    del full_t
    ref_t, _ra, ref_rows, ref_planes = schedule_batch_delta(
        pre_table.clone(), packed, seed, planes=(pre_mask.clone(), pre_score.clone()),
        dirty=dirty, inflight_rows=inflight, backend="xla", **kw)
    check(torch.equal(ref_rows, rows) and torch.equal(ref_planes[0], planes[0])
          and torch.equal(ref_planes[1], planes[1]),
          f"{tag} {layout} wave {i}: kernel wave != plain-tail wave")
    del ref_t, ref_planes
    fresh = new_planes()
    for fpb, fs in fills:
        fill_shape_planes(pre_table, fpb, fs, fresh, profile=kw["profile"], chunk=kw["chunk"])
    check(torch.equal(fresh[0], planes[0]) and torch.equal(fresh[1], planes[1]),
          f"{tag} {layout} wave {i}: merged planes != fresh fill of the pre-wave table")
    log(f"[{tag}] {layout}: wave {i} identical to the full recompute (rows, Assignment, "
        f"request columns), to its plain-tail re-run (rows, planes), and its merged planes "
        f"to a fresh fill")


# ---- phase 8: the coordinator (store -> watch -> wave -> CAS bind) -----------

COORD_PODS = 65536
PARITY_NODES, PARITY_PODS = 65536, 16384
D4_WAVES, D4_PER = 8, 2048          # 8 waves of 2048 spread + 2048 anti pods
D5_RATE, D5_PODS = 2000, 32768
SHAPE_POOL = dict(shape_pool=8, shape_share=0.9, seed=3)
# Zero-delay, zero-jitter retries: a retried pod's next wave does not
# depend on the clock, so a card run and a CPU run see the same waves.
_ZERO_DELAY = dict(component="coordinator.bind", base_delay_s=0.0, jitter=0.0)


def _bench_args(**over):
    """``tools/sched_bench.py`` arguments: the tool's defaults with
    ``over`` applied (names as the flags, dashes as underscores)."""
    from k8s1m_tpu_torch.tools import sched_bench

    args = sched_bench.parse_args([])
    for k, v in over.items():
        check(hasattr(args, k), f"sched_bench has no --{k}")
        setattr(args, k, v)
    return args


def _stored_pods(store) -> dict:
    from k8s1m_tpu_torch.store.native import list_prefix

    kvs, _rev = list_prefix(store, b"/registry/pods/")
    return {kv.key: kv.value for kv in kvs}


def _coordinator_checks(tag: str, report: dict, coord, store, pods: int, *, warm: int = 0,
                        alloc: bool = False) -> dict:
    """``_store_checks`` over the run's ``pods`` and ``warm`` bucket warm-up
    pods, and the report's bind count; returns the stored pod values."""
    d = report["detail"]
    check(d["bound"] + 1 == pods, f"[{tag}] {d['bound']} binds + 1 warm-up != {pods} pods")
    return _store_checks(tag, coord, store, pods + warm, alloc=alloc)


def _store_checks(tag: str, coord, store, total: int, *, alloc: bool = False,
                  capacity: bool = True) -> dict:
    """After ``flush``: ``total`` pods in the store, each bound exactly once
    and counted on its node by the host mirror, the device request columns
    — and with ``alloc`` (node churn rewrites them) the allocatable columns
    — equal to the host mirror, and (``capacity``) no node over its
    allocatable; returns the stored pod values."""
    coord.flush()
    stored = _stored_pods(store)
    check(len(stored) == total, f"[{tag}] {len(stored)} pods stored, want {total}")
    per_node: dict = {}
    for v in stored.values():
        name = json.loads(v)["spec"].get("nodeName")
        check(name is not None, f"[{tag}] a pod was left unbound")
        per_node[name] = per_node.get(name, 0) + 1
    host = coord.host
    check(int(host.pods_req.sum()) == total,
          f"[{tag}] host mirror counts {int(host.pods_req.sum())} bound pods, want {total}")
    rows = {name: host.row_of(name) for name in per_node}
    check(all(int(host.pods_req[rows[n]]) == c for n, c in per_node.items()),
          f"[{tag}] the store's binds per node disagree with the host mirror")
    cols = ["cpu_req", "mem_req", "pods_req"]
    if alloc:
        cols += ["cpu_alloc", "mem_alloc", "pods_alloc"]
    for col in cols:
        dev = getattr(coord.table, col).cpu().numpy()
        check(np.array_equal(dev, getattr(host, col)),
              f"[{tag}] device {col} != host mirror after flush")
    for req, cap in (("cpu_req", "cpu_alloc"), ("mem_req", "mem_alloc"),
                     ("pods_req", "pods_alloc")):
        check(not capacity or bool((getattr(host, req) <= getattr(host, cap)).all()),
              f"[{tag}] a node exceeds its {cap}")
    return stored


def _constraint_waves(waves: int, per: int):
    """Path B's pods as store objects: per wave ``per`` ``bench-spread``
    (zone spread, maxSkew 1, DoNotSchedule) and ``per`` ``bench-anti``
    (required hostname anti-affinity) pods from ``spread_deployment`` /
    ``affinity_deployment``, with the raw specs the coordinator decodes
    back into the same constraint refs; plus one warm-up spread pod."""
    from k8s1m_tpu_torch.cluster import affinity_deployment, spread_deployment
    from k8s1m_tpu_torch.config import TOPO_ZONE, TableSpec
    from k8s1m_tpu_torch.control.objects import encode_pod, pod_key
    from k8s1m_tpu_torch.snapshot.constraints import ConstraintTracker

    spread = [{"topologyKey": "topology.kubernetes.io/zone", "maxSkew": 1,
               "whenUnsatisfiable": "DoNotSchedule",
               "labelSelector": {"matchLabels": {"app": "bench-spread"}}}]
    anti = {"podAntiAffinity": {"requiredDuringSchedulingIgnoredDuringExecution": [{
        "topologyKey": "kubernetes.io/hostname",
        "labelSelector": {"matchLabels": {"app": "bench-anti"}}}]}}
    tracker = ConstraintTracker(TableSpec(max_nodes=16))

    def spreads(n, start):
        return [(pod_key(p.namespace, p.name), encode_pod(p, raw_spread=spread))
                for p in spread_deployment(tracker, "bench-spread", n, topo=TOPO_ZONE,
                                           start=start)]

    out = []
    for w in range(waves):
        out.append(spreads(per, w * per) + [
            (pod_key(p.namespace, p.name), encode_pod(p, raw_affinity=anti))
            for p in affinity_deployment(tracker, "bench-anti", per, anti=True, start=w * per)
        ])
    return spreads(1, waves * per), out


def _recount_constraints(coord, stored) -> None:
    """The nine count tables recounted on the host from the stored binds
    (each pod decoded with the coordinator's tracker: its spread and
    affinity increments and its own required anti-affinity terms at its
    node's row, zone and region) must equal the device tables."""
    from k8s1m_tpu_torch.config import TOPO_HOSTNAME, TOPO_REGION, TOPO_ZONE
    from k8s1m_tpu_torch.control.objects import decode_pod
    from k8s1m_tpu_torch.snapshot.constraints import FIELDS

    cons = coord.constraints
    want = {f: np.zeros(tuple(getattr(cons, f).shape), np.int64) for f in FIELDS}
    host = coord.host
    suffix = {TOPO_HOSTNAME: "node", TOPO_ZONE: "zone", TOPO_REGION: "region"}
    for v in stored.values():
        pod = decode_pod(v, coord.tracker)
        row = host.row_of(pod.node_name)
        dom = {TOPO_HOSTNAME: row, TOPO_ZONE: int(host.zone[row]),
               TOPO_REGION: int(host.region[row])}
        for cid, topo in pod.spread_incs:
            want[f"spread_{suffix[topo]}"][cid, dom[topo]] += 1
        for tid, topo in pod.ipa_incs:
            want[f"tgt_{suffix[topo]}"][tid, dom[topo]] += 1
        for ref in pod.affinity_refs:
            if ref.required and ref.anti:
                want[f"own_{suffix[ref.topo]}"][ref.tid, dom[ref.topo]] += 1
    for f in FIELDS:
        check(np.array_equal(getattr(cons, f).cpu().numpy(), want[f]),
              f"device count table {f} != the host recount from the stored binds")


def _constraint_run(device: str, *, nodes: int, waves: int, per: int, **coord_kw):
    """D4's construction (``sched_bench`` always builds its coordinator
    without constraints): path B / BASELINE configs 3-4 through the
    coordinator — ``Coordinator(with_constraints=True)``, the full
    ``Profile()``, ``PodSpec(batch=2*per, spread_refs=1, affinity_refs=1,
    spread_incs=1, ipa_incs=1)``, path B's TableSpec, a 5% window, packed,
    depth 2 — over ``build_node`` nodes written by sched_bench's
    ``write_nodes``.
    One warm-up spread pod, then ``waves`` waves of ``per`` + ``per`` pods
    with a ``step()`` after each and ``run_until_idle`` for the tail.
    Returns (report, coordinator, store), both left open."""
    from k8s1m_tpu_torch.config import PodSpec, TableSpec
    from k8s1m_tpu_torch.control.coordinator import Coordinator
    from k8s1m_tpu_torch.obs.metrics import REGISTRY, quantile_report_ms
    from k8s1m_tpu_torch.ops import fused_topk
    from k8s1m_tpu_torch.plugins.registry import Profile
    from k8s1m_tpu_torch.store.native import MemStore
    from k8s1m_tpu_torch.tools.sched_bench import _stage_means_ms, write_nodes

    store = MemStore()
    t0 = time.perf_counter()
    write_nodes(store, nodes)
    nodes_s = time.perf_counter() - t0
    cap = 1 << max(10, (nodes - 1).bit_length())
    coord = Coordinator(
        store, TableSpec(max_nodes=cap, max_zones=128, max_regions=16),
        PodSpec(batch=2 * per, spread_refs=1, affinity_refs=1, spread_incs=1, ipa_incs=1),
        Profile(), chunk=CHUNK, with_constraints=True, pipeline=True, depth=2,
        score_pct=SCORE_PCT, packing="packed", device=device, **coord_kw,
    )
    coord.bootstrap()
    warm, items = _constraint_waves(waves, per)
    store.put_batch(warm)
    while coord.run_until_idle() == 0:
        pass
    for name in ("coordinator_schedule_to_bind_seconds", "coordinator_cycle_seconds"):
        REGISTRY.get(name).reset()
    coord.waves.clear()
    fused_topk.reset_launches()
    bound = 0
    t0 = time.perf_counter()
    for wave in items:
        store.put_batch(wave)
        bound += coord.step()
    bound += coord.run_until_idle()
    sched_s = time.perf_counter() - t0
    lat = REGISTRY.get("coordinator_schedule_to_bind_seconds")
    report = {"value": round(bound / sched_s, 1), "detail": {
        "bound": bound, "schedule_s": round(sched_s, 3), "node_create_s": round(nodes_s, 3),
        "cold_build_s": round(REGISTRY.get("megarow_cold_build_seconds").value(), 3),
        "device_share": round(REGISTRY.get("coordinator_cycle_seconds").sum(stage="device")
                              / sched_s, 4),
        **quantile_report_ms(lat, (0.5, 0.99)),
        "stage_means_ms": _stage_means_ms(),
        "waves": dict(coord.waves),
        "launches": {"fused_topk": fused_topk.fused_topk.launches,
                     "fused_topk_by_stage": dict(fused_topk.fused_topk.launches_by_stage)},
    }}
    return report, coord, store


def phase_coordinator_parity() -> dict:
    """8a: three groups of the same run, each at 65,536 nodes x 16,384
    pods, 5% window, packed, chunk 4096, zero-delay retries — uniform pods
    on the card's kernels, on the card's scan path (``backend="xla"``) and
    on the CPU; template pods (``--shape-pool 8 --shape-share 0.9 --seed
    3``) on the card and the CPU; D4's constraint construction on the card
    and the CPU.  Each group must leave byte-identical pod values."""
    from k8s1m_tpu_torch.faultline import RetryPolicy
    from k8s1m_tpu_torch.tools import sched_bench

    policy = RetryPolicy(**_ZERO_DELAY)
    groups = {
        "uniform": [("cuda", {}), ("cuda", {"backend": "xla"}), ("cpu", {})],
        "shape-pool": [("cuda", SHAPE_POOL), ("cpu", SHAPE_POOL)],
        "constraints": [("cuda", None), ("cpu", None)],
    }
    out = {}
    for group, members in groups.items():
        runs = []
        for dev, over in members:
            t0 = time.perf_counter()
            if over is None:
                report, coord, store = _constraint_run(
                    dev, nodes=PARITY_NODES, waves=PARITY_PODS // 4096, per=2048,
                    retry_policy=policy)
                pods = PARITY_PODS + 1
            else:
                # chunk 4096 on both devices: the window rounds up to a
                # whole chunk, so the CPU's scan-path default (16384)
                # would score a different window.
                report, coord, store = sched_bench.run(_bench_args(
                    nodes=PARITY_NODES, pods=PARITY_PODS, score_pct=SCORE_PCT,
                    packing="packed", chunk=CHUNK, device=dev, **over), retry_policy=policy)
                pods = PARITY_PODS
            tag = f"8a {group} {dev} {coord.backend}"
            stored = _coordinator_checks(tag, report, coord, store, pods)
            if over is None:
                _recount_constraints(coord, stored)
            coord.close()
            store.close()
            runs.append((tag, stored, report, time.perf_counter() - t0))
        for tag, stored, _r, _t in runs[1:]:
            check(stored == runs[0][1], f"[{tag}] stored pod values differ from [{runs[0][0]}]")
        log(f"[8a] {group}: " + ", ".join(f"{t} ({s:.1f}s)" for t, _st, _r, s in runs)
            + f" left byte-identical pod values ({len(runs[0][1])} pods)")
        out[group] = {tag: rep for tag, _st, rep, _s in runs}
    return out


def _log_report(config: str, report: dict, t0: float) -> None:
    d = report["detail"]
    log(f"[{config}] {report['value']} {report.get('unit', 'binds/s')}: binds/s "
        f"{d.get('binds_per_sec', report['value'])}, schedule-to-bind p50 {d['p50_ms']} ms "
        f"p95 {d.get('p95_ms')} ms p99 {d['p99_ms']} ms, node write "
        f"{d.get('node_create_s')} s, cold build {d.get('cold_build_s')} s, waves "
        f"{d['waves']}, launches {d['launches']}, device share {d.get('device_share')}, "
        f"inflight depth {d.get('sustained_inflight_depth')} (max "
        f"{d.get('max_inflight_depth')}), quiesces {d.get('pipeline_quiesce')}, "
        f"node churn events {d.get('node_churn_events')}")
    log(f"[{config}] stage means ms: {d['stage_means_ms']}  "
        f"({time.perf_counter() - t0:.1f}s for the phase)")


def phase_coordinator(config: str) -> dict:
    """8: D1 (BASELINE config 1 through the coordinator: 4096-pod waves
    over a 5% window at depth 2, the fused kernel on every wave, with the
    encode, delta and kernel profiles), D2 (the megarow shape of
    ``artifacts/megarow_cpu.json``: 512-pod waves at depth 3, full scan,
    deltacache with a 64-deep candidate index and 15 stratum bits, the
    delta kernel on the delta waves), D3 (D1 with template pods under
    4,000 capacity-only node updates/s: the ``aff`` stage and the sync
    stage) or D5 (D1 at an offered 2,000 pods/s: adaptive buckets);
    1,048,576 nodes, packed, pipelined.  D4 is ``phase_constraints``."""
    from k8s1m_tpu_torch.tools import sched_bench
    from k8s1m_tpu_torch.tools.kernel_probe import profile_stages

    over = dict(nodes=NODES, pods=COORD_PODS, packing="packed")
    d1 = dict(batch=BATCH, depth=2, score_pct=SCORE_PCT)
    if config == "D1":
        over.update(d1, encode_profile=True, delta_profile=True, stats=True,
                    kernel_profile=True)
    elif config == "D2":
        # 15 stratum bits leave ~32 tied rows per class, ~3,500 pods of
        # room per wave: the megarow drill's 512-pod batch fits it, a
        # 4096-pod batch would park pods as unschedulable.
        over.update(batch=512, depth=3, score_pct=100, deltacache="on",
                    delta_index_k=64, stratum_bits=15, encode_profile=True,
                    delta_profile=True, stats=True)
    elif config == "D3":
        over.update(d1, node_churn=4000.0, **SHAPE_POOL)
    else:
        over.update(d1, rate=D5_RATE, pods=D5_PODS)
    t0 = time.perf_counter()
    report, coord, store = sched_bench.run(_bench_args(**over))
    d = report["detail"]
    warm = sum(1 for k in coord._bound if k.startswith("warm2/"))
    _coordinator_checks(config, report, coord, store, over["pods"], warm=warm,
                        alloc=config == "D3")
    launches = d["launches"]
    if config in ("D1", "D5"):
        check(launches["fused_topk"] > 0, f"[{config}] no fused-kernel launch in the window")
    elif config == "D2":
        check(launches["delta_plane_topk"] > 0, "[D2] no delta-kernel launch in the window")
    if config == "D3":
        check(launches["fused_topk_by_stage"]["aff"] > 0, "[D3] no aff-stage launch")
        check(d["node_churn_events"] > 0, "[D3] no node churn was written")
        check("sync" in d["stage_means_ms"], "[D3] the sync stage never ran")
    if config in ("D3", "D5"):
        q = d["pipeline_quiesce"]
        check(q["structural"] == 0 and q["resync"] == 0,
              f"[{config}] structural or resync quiesces: {q}")
    if config == "D5":
        check(d["pipeline_quiesce"]["adaptive"] > 0, "[D5] no adaptive quiesce")
        check(d["unbound"] == 0, f"[D5] {d['unbound']} pods left unbound")
    _log_report(config, report, t0)
    for lane in ("encode_profile", "delta_profile"):
        if lane in d:
            log(f"[{config}] {lane}: {json.dumps(d[lane])}")
    if config == "D1":
        # The knock-out variants over the live table on both backends
        # (sched_bench's --kernel-profile ran the kernels; one block of
        # one call per variant on the scan path).
        prof = {"pallas": d["kernel_profile"],
                "xla": profile_stages(coord.table, coord.encoder, chunk=CHUNK, k=coord.k,
                                      steps=1, repeats=1, backend="xla")}
        for backend, res in prof.items():
            log(f"[D1] kernel profile over the live table, {backend} (repeats "
                f"{res['repeats']}): ms per batch {res['ms_per_batch']}, stages {res['stages']}")
        report["kernel_profile"] = prof
    coord.close()
    store.close()
    return report


def phase_constraints() -> dict:
    """8, D4: path B through the coordinator at 1,048,576 nodes, 8 waves
    of 2048 spread + 2048 anti pods: the ``cons`` stage launched, no node
    holding anti pods of two waves, and the device count tables equal to
    the host recount from the stored binds."""
    t0 = time.perf_counter()
    report, coord, store = _constraint_run("cuda", nodes=NODES, waves=D4_WAVES, per=D4_PER)
    pods = D4_WAVES * 2 * D4_PER + 1
    stored = _coordinator_checks("D4", report, coord, store, pods)
    d = report["detail"]
    check(d["launches"]["fused_topk_by_stage"]["cons"] > 0, "[D4] no cons-stage launch")
    # Anti pods of one wave may share a node: the greedy scan re-checks
    # capacity within a wave, not topology (k8s1m_tpu/engine/cycle.py's
    # module doc; the reference binds its shards the same way).  Across
    # waves the count tables forbid it.
    waves_on: dict = {}
    for v in stored.values():
        obj = json.loads(v)
        name = obj["metadata"]["name"]
        if name.startswith("bench-anti-"):
            wave = int(name.rsplit("-", 1)[1]) // D4_PER
            waves_on.setdefault(obj["spec"]["nodeName"], []).append(wave)
    shared = sum(1 for w in waves_on.values() if len(w) > 1)
    check(sum(len(w) for w in waves_on.values()) == D4_WAVES * D4_PER,
          "[D4] anti pods missing from the store")
    check(all(len(set(w)) == 1 for w in waves_on.values()),
          "[D4] anti-affinity pods of two waves share a node")
    d["anti_nodes_shared_within_a_wave"] = shared
    log(f"[D4] {D4_WAVES * D4_PER} anti pods on {len(waves_on)} nodes; {shared} nodes hold "
        f"two or more, each time from one wave")
    _recount_constraints(coord, stored)
    log("[D4] the nine device count tables equal the host recount from the stored binds")
    _log_report("D4", report, t0)
    coord.close()
    store.close()
    return report


# ---- phase 9: kernel_probe -----------------------------------------------------


def phase_probe() -> dict:
    """9: ``tools/kernel_probe.py`` at its default shape (53,248 rows, the
    1M table's 5% window; 8192 pods; chunk 4096), packed, on the fused
    kernel (its default 3 blocks of 10 calls) and on the scan path (2
    blocks of 2 calls: ~0.1-0.2 s a call)."""
    import contextlib
    import io

    from k8s1m_tpu_torch.tools import kernel_probe

    out = {}
    for backend in ("pallas", "xla"):
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            reps = [] if backend == "pallas" else ["--steps", "2", "--repeats", "2"]
            lines = kernel_probe.main(["--backend", backend, "--packing", "packed", *reps])
        out[backend] = {ln["variant"]: ln["ms_per_batch"] for ln in lines}
        check(all(ms > 0 for ms in out[backend].values()), f"[9] {backend}: a zero time")
        log(f"[9] kernel_probe {backend}, packed, 53248 rows x 8192 pods: ms per batch "
            f"{out[backend]} ({time.perf_counter() - t0:.1f}s)")
    return out


# ---- phase 10: the megarow drill, composed parity, breaker ---------------------

COMPOSED_NODES = 65536
# 10a runs the drill's tick sequence (steady, overload, recover) at the
# drill's batch; 10b's oracle fallback costs ~60 us per (pod, node) on the
# host, so its open-state wave takes 2 pods.
BREAKER_NODES, BREAKER_FALLBACK = 65536, 2


def phase_megarow() -> dict:
    """10: ``megarow_drill.run(parse_args([]))`` on the card at its default
    shape — 1,048,576 nodes, batch 512, chunk 4096, depth 3, 4 tenants,
    deltacache on, index K 64, automatic stratum bits, the comparison lane
    and the differential at 131,072 — with every gate of the drill.  The
    launch counts are set to 0 just before the run and read just after."""
    from k8s1m_tpu_torch.ops import delta_topk, fused_topk
    from k8s1m_tpu_torch.tools import megarow_drill

    args = megarow_drill.parse_args([])
    check(args.device == "cuda" and args.nodes == NODES, "[10] the drill's default shape moved")
    fused_topk.reset_launches()
    delta_topk.reset_launches()
    t0 = time.perf_counter()
    ev = megarow_drill.run(args)
    secs = time.perf_counter() - t0
    launches = {"fused_topk": fused_topk.fused_topk.launches,
                "delta_plane_topk": delta_topk.delta_plane_topk.launches,
                "fused_topk_by_stage": dict(fused_topk.fused_topk.launches_by_stage)}
    check(ev["passed"], f"[10] the drill failed its gates: {json.dumps(ev)}")
    check(launches["fused_topk_by_stage"]["base"] > 0, "[10] no fused base-stage launch")
    check(launches["delta_plane_topk"] > 0, "[10] no delta-kernel launch")
    cmp_ = ev["cold_build_compare"]
    log(f"[10] megarow drill, {args.nodes:,} nodes on the card: saturated "
        f"{ev['binds_per_sec']} binds/s, composed {ev['binds_per_sec_composed']} binds/s "
        f"({ev['window_bound']} binds in {ev['window_seconds']} s), cold build "
        f"{ev['cold_build_seconds']} s, registration {ev['bulk_ingest']['rate_per_sec']} "
        f"nodes/s, compare speedup {cmp_['speedup']} (bulk {cmp_['bulk_lane_seconds']} s vs "
        f"loop {cmp_['per_node_loop_seconds']} s), states {ev['states_seen']}, recovered at "
        f"tick {ev['recovered_at_tick']}, admitted {ev['admitted']} rejected "
        f"{ev['rejected']}, lost {ev['lost']}, give-ups {ev['retry_give_ups']}, index waves "
        f"{ev['index_waves']} drops {ev['index_drops']}, differential "
        f"{ev['index_differential']}, inflight depth {ev['sustained_inflight_depth']}, "
        f"peak RSS {ev['peak_rss_mib']} MiB, launches {launches} ({secs:.1f}s)")
    return {"evidence": ev, "launches": launches, "seconds": round(secs, 3)}


def _composed_run(device: str) -> dict:
    """10a's construction: the drill's sustained window — tenant-weighted
    ``submit_external`` intake, 256 capacity-only node updates per tick,
    its seeded bind-CAS conflict plan, steady / overload / recover ticks —
    through ``Coordinator(tenancy=..., pipeline=True, depth=3)`` at
    ``COMPOSED_NODES`` nodes, chunk 4096, packed, deltacache with the
    candidate index, and a zero-delay, zero-jitter retry policy (no wall
    clock reaches placement: ``cycle_slow_s`` stays ``inf``).  Returns the
    stored pods, the admitted/rejected counts and the controller state
    after every tick."""
    from k8s1m_tpu_torch.cluster.workload import zipf_weights
    from k8s1m_tpu_torch.config import PodSpec, TableSpec
    from k8s1m_tpu_torch.control.coordinator import Coordinator
    from k8s1m_tpu_torch.control.objects import encode_pod, node_key, pod_key
    from k8s1m_tpu_torch.faultline import FaultPlan, FaultSpec, RetryPolicy, install_plan
    from k8s1m_tpu_torch.loadshed import LoadshedConfig, Overloaded
    from k8s1m_tpu_torch.ops import delta_topk, fused_topk
    from k8s1m_tpu_torch.plugins.registry import Profile
    from k8s1m_tpu_torch.snapshot.pod_encoding import PodInfo
    from k8s1m_tpu_torch.store.native import MemStore
    from k8s1m_tpu_torch.tenancy import TenancyController, TenancyPolicy
    from k8s1m_tpu_torch.tools import megarow_drill as md
    from k8s1m_tpu_torch.tools.make_nodes import build_node

    args = md.parse_args(["--nodes", str(COMPOSED_NODES)])
    b, n = args.batch, args.nodes
    z = zipf_weights(args.tenants, args.tenant_skew)
    weights = {f"tenant-{t}": max(1, round(z[t] / z[-1])) for t in range(args.tenants)}
    tenants, total_w = list(weights), sum(weights.values())
    cfg = LoadshedConfig(queue_degraded=3 * b, queue_shed=6 * b, queue_cap=64 * b,
                         queue_recover=b, recover_cycles=3)
    tn = TenancyController(TenancyPolicy(weights=weights), loadshed_config=cfg,
                           name="composed_parity")
    plan = FaultPlan([FaultSpec("coordinator.bind", "cas", kind="err5xx",
                                probability=1.0 / args.conflict_every)], seed=args.seed)
    store = MemStore()
    md.register_nodes(store, n, args.bulk)
    coord = Coordinator(
        store, TableSpec(max_nodes=n, max_zones=16, max_regions=8), PodSpec(batch=b),
        Profile(topology_spread=0, interpod_affinity=0), chunk=args.chunk, k=4,
        with_constraints=False, seed=args.seed, pipeline=True, depth=args.depth, tenancy=tn,
        packing="packed", deltacache="on", delta_index_k=args.delta_index_k,
        stratum_bits=args.stratum_bits, device=device,
        retry_policy=RetryPolicy("coordinator.bind", base_delay_s=0.0, jitter=0.0),
    )
    seq = churned = admitted = rejected = 0
    states = []

    def submit(count):
        nonlocal seq, admitted, rejected
        lanes = []
        for t in tenants:
            share = max(1, round(count * weights[t] / total_w))
            lanes += [(k / share, t) for k in range(share)]
        lanes.sort()
        for _, t in lanes:
            seq += 1
            pod = PodInfo(f"p{seq:07d}", namespace=t, cpu_milli=10, mem_kib=1 << 10)
            try:
                coord.submit_external(json.loads(encode_pod(pod)))
            except Overloaded:
                rejected += 1
                continue
            store.put(pod_key(t, pod.name), encode_pod(pod))
            admitted += 1

    try:
        coord.bootstrap()
        submit(b)
        coord.run_until_idle()
        install_plan(plan)
        fused_topk.reset_launches()
        delta_topk.reset_launches()
        t0 = time.perf_counter()
        for count, ticks in ((b, args.steady_ticks), (args.factor * b, args.overload_ticks),
                             (b // 2, args.recover_ticks)):
            for _ in range(ticks):
                submit(count)
                for _ in range(args.churn_per_tick):
                    i = churned % n
                    store.put(node_key(build_node(i).name), md._node_bytes(i, churned))
                    churned += 1
                coord.step()
                states.append(tn.controller.current_state())
        coord.run_until_idle()
        secs = time.perf_counter() - t0
        install_plan(None)
        # The conflict plan's rollbacks re-upload whole rows while waves
        # are in flight, which erases those waves' assumes until they
        # retire: the JAX coordinator over-commits the same nodes by the
        # same counts (ROADMAP §C), so the over-commit is reported and
        # compared, not gated.
        stored = _store_checks(f"10a {device}", coord, store, admitted, capacity=False)
        host = coord.host
        excess = host.pods_req.astype(np.int64) - host.pods_alloc
        return {"stored": stored, "admitted": admitted, "rejected": rejected,
                "overcommitted_nodes": int((excess > 0).sum()),
                "max_pods_over": int(max(0, excess.max())),
                "states": states, "counters": tn.admission.counters(), "seconds": secs,
                "launches": {"fused_topk_by_stage": dict(fused_topk.fused_topk.launches_by_stage),
                             "delta_plane_topk": delta_topk.delta_plane_topk.launches}}
    finally:
        install_plan(None)
        coord.close()
        store.close()


def phase_composed_parity() -> dict:
    """10a: ``_composed_run`` on the card and on the CPU must leave
    byte-identical stored pods, the same admitted / rejected counts and
    per-tenant ledger, and the same controller state after every tick,
    walking through SHEDDING and back to HEALTHY."""
    from k8s1m_tpu_torch.loadshed import HEALTHY, SHEDDING, STATE_NAMES

    runs = {dev: _composed_run(dev) for dev in ("cuda", "cpu")}
    card, cpu = runs["cuda"], runs["cpu"]
    check(card["stored"] == cpu["stored"], "[10a] card and CPU stored pod values differ")
    for key in ("admitted", "rejected", "states", "counters", "overcommitted_nodes",
                "max_pods_over"):
        check(card[key] == cpu[key], f"[10a] card and CPU {key} differ")
    check(SHEDDING in card["states"] and card["states"][-1] == HEALTHY,
          "[10a] the controller did not walk through SHEDDING back to HEALTHY")
    walk = [STATE_NAMES[s] for i, s in enumerate(card["states"])
            if i == 0 or s != card["states"][i - 1]]
    log(f"[10a] composed parity at {COMPOSED_NODES:,} nodes: card ({card['seconds']:.1f}s) and "
        f"CPU ({cpu['seconds']:.1f}s) byte-identical over {len(card['stored'])} pods; admitted "
        f"{card['admitted']} rejected {card['rejected']}; states {' -> '.join(walk)}; nodes "
        f"over their pod allocatable {card['overcommitted_nodes']} (at most "
        f"{card['max_pods_over']} pods over); card launches {card['launches']}")
    return {dev: {k: v for k, v in r.items() if k != "stored"} for dev, r in runs.items()}


def phase_breaker(device: str = "cuda") -> dict:
    """10b: at ``BREAKER_NODES`` nodes on the card (or ``device``), a ``stall`` plan on
    ``coordinator.cycle``/``dispatch`` fails two launches and opens a
    ``CircuitBreaker`` (threshold 2, cooldown 2, fallback batch
    ``BREAKER_FALLBACK``); the open-state wave binds through the host
    oracle, the half-open probe is a device wave and closes it.  Every
    fallback bind must be the argmax of ``oracle_score`` over the
    ``oracle_feasible`` rows of the host mirror (earlier row wins ties);
    after ``flush`` the device request columns equal the host mirror and no
    node exceeds its allocatable."""
    from k8s1m_tpu_torch.config import PodSpec, TableSpec
    from k8s1m_tpu_torch.control.coordinator import Coordinator
    from k8s1m_tpu_torch.control.objects import encode_pod, pod_key
    from k8s1m_tpu_torch.faultline import FaultPlan, FaultSpec, RetryPolicy, install_plan
    from k8s1m_tpu_torch.loadshed import CLOSED, OPEN, BreakerConfig, CircuitBreaker
    from k8s1m_tpu_torch.obs.metrics import REGISTRY
    from k8s1m_tpu_torch.ops import fused_topk
    from k8s1m_tpu_torch.oracle import oracle_feasible, oracle_score
    from k8s1m_tpu_torch.plugins.registry import Profile
    from k8s1m_tpu_torch.snapshot.pod_encoding import PodInfo
    from k8s1m_tpu_torch.store.native import MemStore
    from k8s1m_tpu_torch.tools.sched_bench import write_nodes

    t0 = time.perf_counter()
    br = CircuitBreaker(BreakerConfig(failure_threshold=2, cooldown_cycles=2,
                                      fallback_batch=BREAKER_FALLBACK), component="chip_smoke")
    trans = REGISTRY.get("breaker_transitions_total")

    def walked(a, b):
        return trans.value(component="chip_smoke", **{"from": a, "to": b})

    walk0 = [walked("closed", "open"), walked("open", "half_open"), walked("half_open", "closed")]
    store = MemStore()
    write_nodes(store, BREAKER_NODES)
    profile = Profile(node_affinity=0, topology_spread=0, interpod_affinity=0)
    coord = Coordinator(
        store, TableSpec(max_nodes=BREAKER_NODES), PodSpec(batch=512), profile, chunk=CHUNK,
        with_constraints=False, pipeline=True, depth=2, packing="packed", breaker=br,
        retry_policy=RetryPolicy("coordinator.bind", base_delay_s=0.0, jitter=0.0),
        device=device,
    )
    fallback = []
    try:
        coord.bootstrap()

        def wave(tag, count):
            items = [(pod_key("default", f"{tag}-{i}"),
                      encode_pod(PodInfo(f"{tag}-{i}", cpu_milli=100 + i % 7, mem_kib=1 << 12)))
                     for i in range(count)]
            store.put_batch(items)

        wave("w0", 512)
        coord.step()                               # a device wave in flight
        install_plan(FaultPlan([FaultSpec("coordinator.cycle", "dispatch", kind="stall",
                                          every_n=1, max_fires=2)], seed=1))
        wave("w1", 512)
        coord.step()
        coord.step()                               # two stalled launches: OPEN
        check(br.state == OPEN, f"[10b] breaker {br.state} after two stalls, want OPEN")
        # The open-state step retires the pipeline, syncs, and hands the
        # queue head to the oracle: record the pods it takes and the host
        # mirror's usage as the fallback starts, then replay.
        seen = {}
        orig = coord._fallback_schedule

        def spy(batch_pods):
            host = coord.host
            seen["keys"] = [p.key_str for p in batch_pods[:BREAKER_FALLBACK]]
            seen["nodes"] = coord._fallback_nodes()
            seen["usage"] = {row: [int(host.cpu_req[row]), int(host.mem_req[row]),
                                   int(host.pods_req[row])] for row, _ in seen["nodes"]}
            return orig(batch_pods)

        coord._fallback_schedule = spy
        fb0 = REGISTRY.get("breaker_fallback_binds_total").value()
        got = coord.step()
        del coord._fallback_schedule
        # The step retires the first wave (512 binds), then the fallback.
        fb = REGISTRY.get("breaker_fallback_binds_total").value() - fb0
        check(got == 512 + BREAKER_FALLBACK and fb == BREAKER_FALLBACK,
              f"[10b] {got} binds, {fb} through the fallback; want 512 + {BREAKER_FALLBACK}")
        heads, nodes, usage = seen["keys"], seen["nodes"], seen["usage"]
        weights = (profile.least_allocated, profile.balanced_allocation,
                   profile.taint_toleration, profile.node_affinity)
        for key in heads:
            ns, name = key.split("/", 1)
            i = int(name.rsplit("-", 1)[1])
            pod = PodInfo(name, namespace=ns, cpu_milli=100 + i % 7, mem_kib=1 << 12)
            best_row, best_score, best = -1, -1, None
            for row, nd in nodes:
                if not oracle_feasible(nd, pod, tuple(usage[row])):
                    continue
                s = oracle_score(nd, pod, tuple(usage[row]),
                                 taint_slots=coord.table_spec.taint_slots, weights=weights)
                if s > best_score:
                    best_row, best_score, best = row, s, nd.name
            usage[best_row][0] += pod.cpu_milli
            usage[best_row][1] += pod.mem_kib
            usage[best_row][2] += 1
            bound = json.loads(store.get(pod_key(ns, name)).value)["spec"].get("nodeName")
            check(bound == best, f"[10b] fallback bound {key} to {bound}, the oracle says {best}")
            fallback.append((key, bound, best_row))
        install_plan(None)
        fused_topk.reset_launches()
        while br.state != CLOSED:
            coord.step()                           # cooldown, then the half-open probe
        wave("w2", 512)
        coord.run_until_idle()
        probe_launches = dict(fused_topk.fused_topk.launches_by_stage)
        check(device != "cuda" or probe_launches["base"] > 0,
              "[10b] no fused-kernel launch after the breaker")
        walk = [walked("closed", "open"), walked("open", "half_open"),
                walked("half_open", "closed")]
        check([b - a for a, b in zip(walk0, walk)] == [1, 1, 1],
              f"[10b] the breaker did not walk CLOSED -> OPEN -> HALF_OPEN -> CLOSED once: "
              f"{walk0} -> {walk}")
        stored = _store_checks("10b", coord, store, 3 * 512)
    finally:
        install_plan(None)
        coord.close()
        store.close()
    log(f"[10b] breaker at {BREAKER_NODES:,} nodes: CLOSED -> OPEN -> HALF_OPEN -> CLOSED; "
        f"fallback binds {fallback} equal the oracle's argmax over the host mirror; "
        f"{len(stored)} pods bound, device request columns equal the host mirror "
        f"({time.perf_counter() - t0:.1f}s)")
    return {"fallback": fallback, "pods": len(stored), "launches_after": probe_launches,
            "seconds": round(time.perf_counter() - t0, 3)}



def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=4, help="timed waves per layout (phase 4)")
    ap.add_argument("--path-steps", type=int, default=3,
                    help="timed waves per layout of paths A and B (phases 5, 6)")
    ap.add_argument("--delta-steps", type=int, default=2,
                    help="timed delta waves per layout of path C (phase 7)")
    ap.add_argument("--warmup", type=int, default=2, help="warm-up waves per layout")
    ap.add_argument("--out", default=None, help="also write the full results as JSON here")
    ap.add_argument("--worst-case-only", action="store_true",
                    help="run only the device, build and all-distinct phases (3e) and print "
                         "their times; run from another tree's root it times that tree's kernel")
    args = ap.parse_args(argv)
    if min(args.steps, args.path_steps, args.delta_steps, args.warmup) < 1:
        ap.error("--steps, --path-steps, --delta-steps and --warmup must be >= 1")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    import k8s1m_tpu_torch  # noqa: F401  (fails here, before any output, outside the repo)

    t_start = time.perf_counter()
    device = torch.device("cuda")
    dev = phase_device()
    build = phase_build()
    if args.worst_case_only:
        print(json.dumps({"worst_case": phase_worst_case(device)}), flush=True)
        return 0
    err3 = phase_kernel_vs_plain(device)
    err3b = phase_affinity_vs_plain(device)
    err3c = phase_constraints_vs_plain(device)
    err3d = phase_delta_vs_plain(device)
    worst = phase_worst_case(device)
    main_res = phase_main_path(device, steps=args.steps, warmup=args.warmup)
    path_a = phase_path(device, "A", steps=args.path_steps, warmup=args.warmup)
    path_b = phase_path(device, "B", steps=args.path_steps, warmup=args.warmup)
    path_c = {c: phase_delta_path(device, c, steps=args.delta_steps, warmup=args.warmup)
              for c in ("C1", "C2")}
    parity = phase_coordinator_parity()
    coord = {c: phase_coordinator(c) for c in ("D1", "D2", "D3")}
    coord["D4"] = phase_constraints()
    coord["D5"] = phase_coordinator("D5")
    probe = phase_probe()
    megarow = phase_megarow()
    composed = phase_composed_parity()
    breaker = phase_breaker()
    log(f"[run] {time.perf_counter() - t_start:.1f}s in all, build included")

    # Launches of the coordinator's paths (phases 8 and 10, counts set to 0
    # just before each measured run and read just after it), per fused stage.
    runs = [r["detail"]["launches"] for r in coord.values()] + [megarow["launches"]]
    coord_launches = {
        stage: sum(r["fused_topk_by_stage"][stage] for r in runs)
        for stage in ("base", "aff", "cons")
    }
    coord_launches["delta_plane_topk"] = sum(r.get("delta_plane_topk", 0) for r in runs)

    def entry(stage, replaces, res, err):
        prod = res["packed"]
        extra = coord_launches[stage]
        return {
            "name": f"fused_topk[{stage}]",
            "route": "cuda",
            "source": "k8s1m_tpu_torch/csrc/fused_topk.cuh",
            "replaces": replaces,
            "launches": res["launches"] + extra,
            "coordinator_launches": extra,
            "max_abs_err": max(err, float(res["plain"]["max_abs_err"]),
                               float(prod["max_abs_err"])),
            "ms": prod["kernel_ms_per_wave"],
            "plain_ms": prod["plain_ms_per_wave"],
            "bound_ms": prod["bound_ms"],
            "bound_by": prod["bound_by"],
            "library_ms": None,
            "bound_per_pair_ms": prod["bound_per_pair_ms"],
            "groups": prod["groups"],
            "all_distinct_ms": worst[stage]["kernel_ms"],
        }

    c2 = path_c["C2"]["packed"]
    kernels = {"kernels": [
        entry("base", "k8s1m_tpu/ops/pallas_topk.py:139", main_res, err3),
        entry("aff", "k8s1m_tpu/ops/pallas_topk.py:285", path_a, err3b),
        entry("cons", "k8s1m_tpu/ops/pallas_topk.py:448", path_b, err3c),
        {
            "name": "delta_plane_topk",
            "route": "cuda",
            "source": "k8s1m_tpu_torch/csrc/delta_topk.cu",
            "replaces": "k8s1m_tpu/ops/pallas_topk.py:1041",
            "launches": sum(r["launches"] for r in path_c.values())
                        + coord_launches["delta_plane_topk"],
            "coordinator_launches": coord_launches["delta_plane_topk"],
            "max_abs_err": max([err3d] + [float(r[lay]["max_abs_err"])
                                          for r in path_c.values()
                                          for lay in ("plain", "packed")]),
            "ms": c2["kernel_ms_per_wave"],
            "plain_ms": c2["plain_ms_per_wave"],
            "bound_ms": c2["bound_ms"],
            "bound_by": c2["bound_by"],
            "library_ms": None,
        },
    ]}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"device": dev, "build": build, "kernel_vs_plain_max_abs_err": err3,
                       "affinity_vs_plain_max_abs_err": err3b,
                       "constraints_vs_plain_max_abs_err": err3c,
                       "delta_vs_plain_max_abs_err": err3d, "worst_case": worst,
                       "main_path": main_res, "path_a": path_a, "path_b": path_b,
                       "path_c": path_c, "coordinator_parity": parity,
                       "coordinator": coord, "kernel_probe": probe,
                       "megarow": megarow, "composed_parity": composed,
                       "breaker": breaker, **kernels}, f, indent=1, default=str)
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
