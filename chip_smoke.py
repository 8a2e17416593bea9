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
``tools/kernel_probe.py`` (phase 9), ``tools/megarow_drill.py``, the
headline run with overload control, fault injection and tenancy (phase
10), per-pod tracing with the flight recorder and the profiler (11), the
admission webhook (12), the overload and tenantfair drills (13),
``tools/hostpath_bench.py`` (14), ``tools/latency_curve.py`` (15) and
``tools/failover_drill.py``, lease election, fencing and warm-standby
takeover (16, 16a), and the deployed topology, where the scheduler is a
client of the store over the etcd wire: ``sched_bench --target`` against
the port's store server (17, and BASELINE config 5 under 100 stress
watchers, 17b) and the coordinator over the wire vs in-process (17a) —
and the shard set: ``tools/shard_bench.py`` with 1, 2 and 4 worker
processes sharing the card (18) and three ``ShardMember``s with the
``Rebalancer`` in one process, card vs CPU (18a) — and the reference's own
experiment through the load tools over the wire: make_nodes, make_pods, a
coordinator, KWOK controllers, the lease flood and store stress,
verify_cluster, /metrics and delete_pods (19), card vs CPU (19a) — and the
dp x sp mesh (``parallel/``): the sharded waves against the single device
(20), ``Coordinator(mesh=)`` card vs CPU (20a) and ``sched_bench --mesh``
(20b) — the composed steady drill (21, 21a) — and the cluster harness
``cluster/harness.py`` with a leader and a standby coordinator (22), card
vs CPU behind the secured tier (22a), and ``tools/fidelity_ab.py`` (22b).

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
  3f. wide shapes — ``cluster.testbeds.WIDE_SWEEP`` at N=65,536 x B=512:
               query keys 1, 16, 17, 80 and 1,024, In/NotIn sets of 8, 9
               and 32 values, 4, 5 and 16 preferred terms, 16, 17 and 32
               taint slots, 128, 129 and 1,024 taint ids, and all at once
               (the fused kernel's fast paths and their spills), base and
               affinity stage, plain and (where the slots fit) packed,
               whole table and a window: bit-equal to the plain version;
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
               plugins, on the packed layout (phases 5-7; the plain layout
               is held to it in phase 4); 3 timed waves, one ``aff`` launch
               per wave; the plain-version re-run of phase 4;
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
               16-shape groups, then 1 warm-up + 2 timed delta waves, each
               after ``scatter_rows`` rewrote ``cpu_req`` of 128 journaled
               rows (its dirty vector) with the previous wave's rows in
               flight; exactly one delta-kernel and no fused-kernel launch
               per wave (counts reset just before, read just after); for
               one wave the full recompute, the plain-tail re-run and a
               fresh fill of the planes must all agree with it; no node
               over-committed; binds > 0.
               Prints binds/s, p50 wave ms, delta kernel ms/wave, merge,
               greedy-assign and fill ms, plane and table MB.
  8a. coordinator parity — three groups at 65,536 nodes x 8,192 pods
               (5% window, packed, depth 2, chunk 4096, zero-delay
               retries), each leaving byte-identical stored pod values:
               ``tools/sched_bench.py`` with uniform pods on the card's
               kernels, on the card's scan path (``--backend xla``) and on
               the CPU; with template pods (``--shape-pool 8 --shape-share
               0.9 --seed 3``) on the card and the CPU; and D4's constraint
               construction on the card and the CPU;
  8. coordinator — packed, D1 at 1,048,576 nodes and D2-D5 at 262,144:
               D1 (``sched_bench --batch 4096 --depth 2 --score-pct 5``,
               32,768 pods, the fused kernel on every wave, with
               ``--encode-profile --delta-profile --stats --kernel-profile``
               and the knock-out variants over the live table on both
               backends), D2 (8,192 pods at the megarow shape:
               ``--batch 512 --depth 3 --score-pct 100 --deltacache on
               --delta-index-k 64 --stratum-bits 13``, the delta kernel on
               the delta waves), D3 (D1 with ``--shape-pool 8 --shape-share
               0.9 --seed 3 --node-churn 4000``, 8,192 pods: the ``aff`` stage, the sync
               stage, no structural or resync quiesce), D4 (path B through a
               ``Coordinator(with_constraints=True)``: 4 waves of 2048 spread
               + 2048 anti pods, the ``cons`` stage, no node holding anti
               pods of two waves, the count tables equal to a host recount
               from the stored binds) and D5 (D1 at ``--rate 2000``, 8,192 pods:
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
  10. megarow — ``megarow_drill.run(parse_args(["--sat-ticks", "12"]))``
               on the card at its default shape otherwise (1,048,576 nodes,
               batch 512, chunk 4096, depth 3, 4 tenants, deltacache on,
               index K 64, automatic stratum bits, comparison lane and
               differential at 131,072; 12 saturated ticks, not 24): the
               drill's ``passed`` with every gate, fused base-stage and
               delta-kernel launches counted in the run (counts set to 0
               just before it).  Prints saturated and composed binds/s,
               cold build, the compare speedup, the states seen and the
               recovery tick, lost and give-ups, index waves, peak RSS and
               the launches per kernel;
  10a. composed parity — the drill's tick sequence (steady, overload,
               recover) through ``Coordinator(tenancy=..., pipeline=True,
               depth=3)`` at 32,768 nodes with the drill's seeded bind-CAS
               conflict plan and zero-delay retries, on the card and on the
               CPU (chunk 4096 both): byte-identical stored pods, the same
               admitted/rejected counts and the same controller state after
               every tick, through SHEDDING and back to HEALTHY;
  10b. breaker — at 65,536 nodes a ``stall`` plan on the wave launch opens
               a ``CircuitBreaker``; the fallback binds equal the oracle's
               argmax over the host mirror, the breaker walks CLOSED -> OPEN
               -> HALF_OPEN -> CLOSED, and after ``flush`` the device request
               columns equal the host mirror, no node over its allocatable;
  11. tracing — ``sched_bench`` at D1's shape (262,144 nodes) with 16,384 pods, ``--trace
               16 --trace-out chiprun_out/trace_d1.json --profile
               chiprun_out/profile_d1.json`` and a ``FlightRecorder`` below
               one cycle: the Perfetto export validates, attribution covers
               >= 95% of schedule-to-bind, the stages include queue_wait,
               encode, dispatch_wait, device and bind, every pod bound once,
               8 flight dumps (``max_dumps``) written and the rest
               suppressed, 1-8 slow-cycle profile dumps; prints per-stage
               p50/p99 and shares and the profiler's top 10 host frames (not
               gated);
  11a. tracing does not move placement — 8a's uniform card run again with
               ``--trace 1``: stored pod values byte-identical;
  12. webhook intake — a ``Coordinator`` at D1's shape (262,144 nodes) behind
               ``WebhookServer(coord.submit_external)``: one client thread
               POSTs 4,096 AdmissionReviews in waves of 4,096, storing each
               wave after its admission; every answer 200 and allowed, every
               pod bound exactly once, no second bind from the watch intake.
               Prints POSTs/s, binds/s, schedule-to-bind p50/p99;
  12a. webhook parity — at 65,536 nodes a ``HealthController`` as the
               server's controller and the coordinator's loadshed, a burst
               that drives it to SHEDDING, on the card and the CPU: the same
               status sequence, the same Retry-After values, byte-identical
               stored pods, no shed pod bound;
  13. drills — ``overload_drill`` and ``tenantfair_drill`` at their default
               shapes on the card (tenantfair's in a child beside
               overload's) and with ``--device cpu``: both pass, and
               the evidence is equal without the ``device`` key (no key of
               either drill holds a host timing);
  14. hostpath — ``hostpath_bench --nodes 131072``: the encode gate
               (>= 3x), byte-identical encodes, and the encode+cycle lane on
               the card's fused kernel with the tool's 80-key query table
               (one launch per wave, counted);
  15. latency curve — ``latency_curve --nodes 131072 --rates
               2000,8000 --seconds 2 --min-pods 8192``: a row per point,
               the 2,000/s point (below D1's knee) within 5% of its offered
               rate;
  16. failover — ``failover_drill --nodes 131072 --chunk 4096``: the
               mid-wave kill with a cold and a warm standby and the paused
               leader's split brain, every gate (0 lost, 0 double binds in
               the full-history ledger, fencing rejects > 0 and no deposed
               bind, takeover within depth + 2 cycles, the host mirror equal
               to a recount from the store, warm < cold); prints warm and
               cold recovery seconds, fencing rejects, the takeover cycle,
               promote's repair counts and the base-stage launches;
  16a. failover parity — the drill at its default shape (2,048 nodes,
               chunk 256) on the card and with ``--device cpu``: both pass,
               equal evidence without the wall-clock keys, byte-identical
               stored pods per scenario;
  17. D1 over the wire — ``python -m k8s1m_tpu_torch.store.server_main
               --port 0`` in a fresh child process and ``sched_bench --target``
               at D1's exact shape (1,048,576 nodes, 32,768 pods, batch 4096,
               depth 2, 5%, packed, ``--stats --encode-profile``): every pod
               bound exactly once, the checks of phase 8, the base stage
               launched in the window, the server reaped.  Prints binds/s,
               schedule-to-bind p50/p99, node write, cold build and relist
               seconds, the stage means and the base launches (phase 8's D1,
               in-process, is the comparison; it now prints its relist too);
  17a. wire parity — 8a's uniform shape (65,536 nodes x 8,192 pods, 5%,
               packed, chunk 4096, zero-delay retries) through a
               ``Coordinator`` over a ``RemoteStore``, a watch progress
               barrier before every ``step()``: on the card over the wire, on
               the card in-process and on the CPU over the wire, each with a
               fresh server; byte-identical stored pods (the card's wire
               run also takes 17c's probes of the native wire);
  17c. the asyncio server — 17a's card run against ``server_main --wire
               asyncio`` (``store/etcd_server.py`` on ``store/wire_server.py``,
               gRPC in Python, no grpcio) in a fresh child: stored pod values
               byte-identical to 17a's card run over the native wire (not
               run again), every pod bound once, a base launch, the child
               reaped.  Prints its seconds, and for each wire the relist
               seconds, the p50/p99 of 2,000 sequential single Puts and the
               rate of 5,000 pipelined Puts from the native stress client,
               with the card's name and power limit;
  17d. the secured watch-cache tier — 17a's card run through ``python -m
               k8s1m_tpu_torch.store.watch_cache --prefix /registry/
               --tls-cert --tls-key --auth-token --metrics-port`` in a child
               in front of ``server_main`` in another, 100 watches on the pods
               prefix from ``watch_stress --writes 0`` in a third, at
               ``--lag-budget 65536`` (the deployed default 4,096 and its
               latest-only coalescing are not run on the card): stored pods
               byte-identical to 17a's native-wire run, the tier's
               ``/metrics`` counting each store event once in and once per
               watch out, every stress watch seeing every pod event, a wrong
               token ``UNAUTHENTICATED``, a client without the CA refused at
               its handshake, every child reaped.  Prints the prime s, the
               relist through the tier beside 17a's, put p50 through the
               tier, binds/s and the base launches;
  17b. BASELINE config 5 — 17's shape at 262,144 nodes with ``--churn
               --stress-watchers 100 --stress-write-concurrency 1``
               (``tools/watch_stress.py`` as a
               child process for the window): every pod bound, every pod not
               deleted stored and bound, the stressor's report with no failed
               stream and every write delivered to every watcher, server and
               stressor reaped.  Prints 17's numbers and the stressor's;
  18. shard set at scale — ``shard_bench --nodes 65536 --pods 8192
               --batch 4096 --score-pct 5`` with ``--shards`` 1, 2 and 4, each
               against a fresh ``server_main``, every worker on ``cuda``:
               the workers' binds sum to the pods and each worker binds its
               FNV share, every worker done and exited 0, each launched the
               base stage, every stored pod (warm-up pods too) on a node whose
               group its shard owns in the final assignment, server and
               workers reaped.  Prints binds/s, window s and the ratio to one
               worker, populate and worker-ready s, per worker p50/p99
               schedule-to-bind, conflicts, waves and stage means, peak card
               memory and host RSS, ``mask_rows`` ms and new bytes, and the
               host's core count;
  18a. shard-set parity — at 65,536 nodes three ``ShardMember``s over one
               in-process ``MemStore`` (5%, chunk 4096, zero-delay retries),
               4,096 pods in four rounds over a skewed start, the
               ``Rebalancer`` evening it out after round 2, on the card and
               the CPU: after every tick the masks are disjoint and every
               pod the tick bound sits on a row its member owned at launch;
               byte-identical stored pods;
  19. experiment — the reference's 1M-node procedure at 65,536 nodes
               against a fresh
               ``server_main --metrics-port`` child, each tool a CLI child
               (``python -m k8s1m_tpu_torch.tools.<tool>``, its JSON line
               read, a non-zero exit fails the phase): ``make_nodes --count
               65536 --bulk 1024`` (count, 0 errors, ``find_gaps`` none),
               ``make_pods --count 8192`` (per-put RPCs at the tools'
               defaults), a ``Coordinator`` on the card over a
               ``RemoteStore`` at D1's shape (every pod bound once, base
               launches), group 0's ``KwokController`` (bootstrap, ticks at
               10 and 20: its tenth of the nodes adopted, every pod bound to them
               started, every lease renewed on each tick and stored, the
               lease-delay histogram rendered), ``lease_flood --nodes
               65536 --rounds 1 --batch 1024``, ``store_stress
               --native-client --puts 200000`` and the Python lane at 5,000
               puts and 500 ranges (0 errors), ``count_ready`` (nodes sum
               to 65,536, Running = started, none unbound), one ``GET
               /metrics`` (200), ``delete_pods --prefix bench-pod`` (8,192
               deleted, the prefix empty).  Prints every tool's rate and
               each step's seconds;
  19a. experiment parity — 19's flow at 32,768 nodes x 2,048 pods with all
               ten KWOK groups and ``--concurrency 1 --clients 1`` (the
               tools in-process, a fresh server child per pass), the
               coordinator on the card and, concurrently in a child process,
               on the CPU: every check of 19 in both, and the stored pods
               after binding and after the ticks and the lease values
               byte-identical, revisions included (equal sha256 digests);
  20. mesh   — the sharded waves (``parallel/sharded_cycle.py``) at
               1,048,576 nodes, B=4096, k=4, chunk 4096, score-pct 100,
               packed, every cell on the card: the uniform wave (base
               stage) on the meshes 1x4 and 2x2, path B (cons stage,
               cross-shard prologue) and C1 (delta planes sharded over sp)
               on 2x2,
               1 warm-up + 2 timed waves each: every wave's bound rows, the
               request columns, the nine count tables and the planes
               byte-identical to the single-device waves on the same
               inputs; before the first wave of each path each 2x2 cell's
               kernel equal to its plain version at the cell's offsets (max
               |err| 0); dp x sp
               launches of the path's kernel per wave.  Prints wave ms and
               within it per-cell kernel, gather, greedy and commit ms (CUDA
               events), launches per wave and card MB;
  20a. mesh coordinator parity — 8a's shape over a 2x2 mesh (two host-feed
               workers): the uniform group and D4's construction on the card
               and, concurrently in a child process, the CPU, byte-identical
               per group; on the card also the uniform group at score-pct
               100 over the mesh and on one device, byte-identical;
  20b. ``sched_bench --mesh 1x4`` at 262,144 nodes x 8,192 pods, ``--batch
               4096 --depth 2 --score-pct 5 --stats --kernel-profile``: every
               pod bound once (phase 8's checks), 4 base launches per wave,
               ``mesh_exec`` and the shard-local kernel profile.  Prints
               binds/s, p50/p99, the device stage's share and ``mesh_exec``;
  21. steady drill — ``steady_drill --failover --nodes 262144 --chunk
               4096`` on the card (1,048,576 nodes cut to 262,144 to fit the
               limit), every other flag at the JAX defaults: the
               pipelined coordinator with tenancy, loadshed, a bind-CAS
               fault plan and node churn, as an HA pair whose leader is
               SIGKILLed mid-overload, and the watch-cache tier over the same
               store with one client watch on the pods prefix and an injected
               upstream break: the drill's gates, 0 lost, the tier resumed
               once with 0 invalidations and 0 client cancels, base launches
               counted in the run.  Prints the recovery s, admitted pods, the
               drill's wall s and its phase times;
  21a. steady drill parity — ``steady_drill --smoke --failover`` on the card
               and with ``--device cpu``, each in a fresh process beside 21:
               both pass 21's gates, and the reports are equal without the
               host-clock keys and the device;
  22. harness — ``cluster/harness.py`` as ``cluster.up`` drives it:
               ``ClusterSpec(nodes=131072, table 1,048,576 rows,
               kwok_groups=2, coordinators=2, device="cuda",
               backend="pallas")`` (waves of 256 pods, the JAX default),
               the nodes in PutFrames, one tick, ``run_pods(16384)``
               alone on the host: every pod bound once and Running,
               no node over its slots, one leader and a standby without a
               coordinator, fused base launches.  Prints binds/s, ticks and
               the ticks' host seconds by coordinator, KWOK and compaction;
  22a. harness parity — 512 nodes, 1,024 pods, KWOK behind the secured
               watch-cache tier (TLS, bearer token), a watch barrier before
               every tick, on the card and on the CPU, each in a child
               beside 20a: the stored pods byte-identical, the binds per tick and the
               leader equal, base launches on the card;
  22b. fidelity A/B — ``fidelity_ab`` at its defaults (2,000 nodes x
               2,000 pods, 60 simulated seconds) on the card, and on the CPU
               in a child: the reports equal, both arms bind
               every pod, base launches on the card.
Phases 5 and 6 print the same group and bound figures as phase 4.  The
parity phases 8a, 10a, 12a, 18a, 19a and 20a run their CPU half in a child
process beside the card's half; 8a's CPU halves start beside phase 3,
10a's and 12a's beside phase 9 (10a and 12a then run before phase 10);
18a runs after 19a (the longer card half first), so that the CPU halves
of each pair run together, and 20a's CPU half runs beside phase 20; 22a's
card and CPU halves run in children beside 20a, so that 22 runs alone.  The
next-to-last line is ``{"kernels": [...]}`` (one entry per fused-kernel
stage configuration and one for the delta kernel: times, bound, launches;
the fused entries add ``bound_per_pair_ms``, ``groups`` and
``all_distinct_ms``; ``launches`` includes the coordinator's of phases 8,
10-16a, 17-17d, 18 (each worker's window), 18a, 19, 19a, 20a (card), 20b,
21, 21a (card) and 22-22b (card), which ``coordinator_launches`` also gives alone, per fused stage, and
phase 20's mesh waves, which ``mesh_launches`` gives alone);
the last is ``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py [--steps 4] [--path-steps 3] [--delta-steps 2] [--warmup 1]
                          [--out results.json] [--worst-case-only] [--mesh-only]
                          [--wire-asyncio-only] [--tier-only] [--harness-only]

Needs one CUDA card; without one it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import dataclasses
import io
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
# Timed calls of the host-bound greedy scan (~0.6 s each at 1M nodes) in
# each per-layer timing, after the warm-up call.
GREEDY_REPS = 1


_T0 = time.perf_counter()


def log(msg: str) -> None:
    """One line of the run's log, after the seconds since the script started
    (the gaps between phases' lines are their times)."""
    print(f"[{time.perf_counter() - _T0:7.1f}s] {msg}", flush=True)


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


def _smi_stamp() -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()


def phase_device() -> dict:
    import torch

    name = torch.cuda.get_device_name(0)
    smi = _smi_stamp()
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda}; {name}")
    print(smi, flush=True)       # the line as nvidia-smi gives it, with no prefix
    return {"kind": name, "count": torch.cuda.device_count(), "nvidia_smi": smi}


# ---- phase 2 -------------------------------------------------------------


def phase_build() -> dict:
    from k8s1m_tpu_torch.ops import _build

    from k8s1m_tpu_torch.store import build as store_build

    t0 = time.perf_counter()
    # The store's g++ build (needed from phase 8 on) runs beside the nvcc units.
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        store_lib = pool.submit(store_build.ensure_built)
        reports = _build.build_all(_build.LIBRARIES)
        for name in _build.LIBRARIES:
            _build.load(name)
        secs = time.perf_counter() - t0
        store_lib.result()
    store_s = time.perf_counter() - t0
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
        f"and loaded in {secs:.1f}s; the store's library beside them, done at {store_s:.1f}s")
    from k8s1m_tpu_torch.ops import delta_topk, fused_topk

    if not hasattr(fused_topk, "blocks_per_sm"):     # a tree from before the query
        return {"build_s": secs, "store_build_s": store_s, "registers": registers}
    occupancy = {f"fused_topk[{stage}] {layout}": fused_topk.blocks_per_sm(
        stage, packed=layout == "packed", k=K)
        for stage in fused_topk.STAGES for layout in ("plain", "packed")}
    occupancy["delta_plane_topk"] = delta_topk.blocks_per_sm(K)
    log(f"[build] resident 128-thread blocks per SM at k={K}: "
        + ", ".join(f"{name} {n}" for name, n in occupancy.items()))
    return {"build_s": secs, "store_build_s": store_s, "registers": registers,
            "blocks_per_sm": occupancy}


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
            batch.cpu, batch.mem, batch.valid), GREEDY_REPS)
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


def phase_wide_vs_plain(device, n: int = 65536, b: int = 512) -> dict:
    """3f: every ``WIDE_SWEEP`` point (query keys 1, 16, 17, 80, 1024; In/NotIn
    values 8, 9, 32; preferred terms 4, 5, 16; taint slots 16, 17, 32;
    taint ids 128, 129, 1024; and all of them at once) on the base and the
    affinity stage, plain layout and packed where the taint slots fit its
    meta word, whole table and a window: kernel and plain version
    bit-equal, each with feasible and infeasible slots."""
    import torch

    from k8s1m_tpu_torch.cluster.testbeds import WIDE_SWEEP, wide_fleet, wide_pods
    from k8s1m_tpu_torch.config import PodSpec, TableSpec
    from k8s1m_tpu_torch.ops.fused_topk import fused_topk, fused_topk_reference
    from k8s1m_tpu_torch.plugins.registry import Profile
    from k8s1m_tpu_torch.snapshot.node_table import NodeTableHost
    from k8s1m_tpu_torch.snapshot.packing import build_packing_spec, pack_table_host
    from k8s1m_tpu_torch.snapshot.pod_encoding import PodBatchHost, unpack_pod_batch

    base = Profile(node_affinity=0, topology_spread=0, interpod_affinity=0)
    aff = Profile(topology_spread=0, interpod_affinity=0)
    t0 = time.perf_counter()
    worst = {"base": 0, "aff": 0}
    points = []
    for q, v, p, ts, m in WIDE_SWEEP:
        spec = TableSpec(max_nodes=n, taint_slots=ts, max_taint_ids=m)
        host = wide_fleet(NodeTableHost(spec), seed=ts + m)
        pods = wide_pods(b - 5, query_keys=q, values=v, pref_terms=p, max_taint_ids=m, seed=q)
        pb = PodBatchHost(PodSpec(batch=b, query_keys=q, aff_values=v, pref_terms=p), spec,
                          host.vocab).encode_packed(pods)
        batch = unpack_pod_batch(pb.ints, pb.bools, pb.spec, pb.table_spec, pb.groups, device)
        tables = {"plain": host.to_device(device)}
        if 1 + 2 * ts <= 31:
            tables["packed"] = pack_table_host(host, build_packing_spec(spec, host.vocab), device)
        errs = {}
        for layout, table in tables.items():
            for view in (table, table.narrow(n // 16, n // 2)):
                for stage, profile in (("base", base), ("aff", aff)):
                    kw = dict(k=K, stratum_bits=11, row_base=7, col_base=4096,
                              with_affinity=stage == "aff")
                    idx, prio = fused_topk(view, batch, -2024, profile, **kw)
                    torch.cuda.synchronize()
                    ridx, rprio = fused_topk_reference(view, batch, -2024, profile, **kw)
                    err = _compare(idx, prio, ridx, rprio)
                    worst[stage] = max(worst[stage], err)
                    errs[f"{layout}/{stage}"] = max(errs.get(f"{layout}/{stage}", 0), err)
                    check(err == 0, f"[3f] q={q} v={v} p={p} ts={ts} m={m} {layout} {stage}: "
                          "kernel disagrees with the plain version")
                    check(bool((rprio >= 0).any()) and bool((rprio < 0).any()),
                          f"[3f] q={q} v={v} p={p} ts={ts} m={m} {layout} {stage}: "
                          "no feasible or no infeasible slot")
        points.append({"query_keys": q, "aff_values": v, "pref_terms": p, "taint_slots": ts,
                       "max_taint_ids": m, "max_abs_err": errs})
        log(f"[3f] q={q:4d} v={v:2d} p={p:2d} ts={ts:2d} m={m:4d} at {n:,} x {b}: "
            f"max_abs_err {errs}")
    log(f"[3f] {len(WIDE_SWEEP)} wide points bit-equal ({time.perf_counter() - t0:.1f}s)")
    return {"points": points, "max_abs_err": worst,
            "seconds": round(time.perf_counter() - t0, 3)}


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
    packed, through ``schedule_batch_packed``."""
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
    # The packed layout only (the coordinator's), for the 1,200 s limit: phase
    # 4 holds the plain layout to it at 1M, phase 3 each stage's plain layout
    # to its plain version.
    layouts = {
        "packed": lambda: pack_table_host(host, build_packing_spec(spec, host.vocab), device),
    }
    results: dict = {}
    states: dict = {}
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
    waves = len(layouts) * (warmup + steps)
    check(by_stage[stage] == waves == sum(by_stage.values()),
          f"{tag} launched {by_stage} for {waves} waves")
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
            batch.cpu, batch.mem, batch.valid), GREEDY_REPS)
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
    ``node_affinity_pods``, 64 shapes) at 1,048,576 KWOK nodes, packed,
    through ``fill_shape_planes`` and ``schedule_batch_delta``.
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
    # The packed layout only (the coordinator's), for the 1,200 s limit: phase
    # 4 holds the plain layout to it at 1M, phase 3 each stage's plain layout
    # to its plain version.
    layouts = {
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
            batch.cpu, batch.mem, batch.valid), GREEDY_REPS)
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
    check(launches == len(layouts) * total,
          f"{tag}: {launches} delta launches for {len(layouts) * total} waves")
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

# Cut to make room for phases 11-15: D1 from 65,536 pods to 32,768, D2
# and D3 to 16,384, D4 from 8 waves to 4, D5 from 32,768 pods to 16,384;
# for phases 17-17b, D5 to 8,192; for phases 18-18a, D2 and D3 to 8,192 and
# the parity runs of 8a, 11a and 17a from 16,384 pods to 8,192.
COORD_PODS = {"D1": 32768, "D2": 8192, "D3": 8192}
# D1 keeps the full fleet; D2-D5 run at a quarter of it (the script's
# 1,200 s limit; each paid ~16 s of node write and cold build at 1M).
COORD_NODES = {"D1": NODES, "D2": NODES // 4, "D3": NODES // 4, "D4": NODES // 4,
               "D5": NODES // 4}
D2_STRATUM_BITS = 13                # ~32 tied rows per class at 262,144 nodes
PARITY_NODES, PARITY_PODS = 65536, 8192
D4_WAVES, D4_PER = 4, 2048          # 4 waves of 2048 spread + 2048 anti pods
D5_RATE, D5_PODS = 2000, 8192
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
    table = coord.table.gather() if coord.mesh is not None else coord.table
    for col in cols:
        dev = getattr(table, col).cpu().numpy()
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

    cons = coord.constraints.gather() if coord.mesh is not None else coord.constraints
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


# 8a's members, per group: (device, sched_bench overrides; None = D4's
# constraint construction).  The first member of each group is the reference.
PARITY_GROUPS = {
    "uniform": [("cuda", {}), ("cuda", {"backend": "xla"}), ("cpu", {})],
    "shape-pool": [("cuda", SHAPE_POOL), ("cpu", SHAPE_POOL)],
    "constraints": [("cuda", None), ("cpu", None)],
}


def _parity_members(device: str, groups=tuple(PARITY_GROUPS)) -> dict:
    """8a's members of ``groups`` on ``device``, in group order: each one's
    report and seconds under ``runs[tag]``, its stored pod values under
    ``stored <tag>``."""
    from k8s1m_tpu_torch.faultline import RetryPolicy
    from k8s1m_tpu_torch.tools import sched_bench

    policy = RetryPolicy(**_ZERO_DELAY)
    out: dict = {"runs": {}}
    for group in groups:
        for dev, over in PARITY_GROUPS[group]:
            if dev != device:
                continue
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
            out["runs"][tag] = {"group": group, "report": report,
                                "seconds": round(time.perf_counter() - t0, 3)}
            out[f"stored {tag}"] = stored
    return out


def phase_coordinator_parity(cpu_half=None) -> tuple[dict, dict]:
    """8a: three groups of the same run, each at 65,536 nodes x 8,192
    pods, 5% window, packed, chunk 4096, zero-delay retries — uniform pods
    on the card's kernels, on the card's scan path (``backend="xla"``) and
    on the CPU; template pods (``--shape-pool 8 --shape-share 0.9 --seed
    3``) on the card and the CPU; D4's constraint construction on the card
    and the CPU (each group's CPU member in a child process of its own,
    ``cpu_half`` when started ahead, while the card's run here).  Each group
    must leave byte-identical pod values.  Returns the reports and the
    uniform card run's stored pod values as their digest (11a's untraced
    run)."""
    card, cpu = _card_and_cpu("8a", "_parity_members",
                              cpu_calls=[((group,),) for group in PARITY_GROUPS],
                              children=cpu_half)
    out = {}
    for group in PARITY_GROUPS:
        runs = [(tag, res[f"stored {tag}"], r) for res in (card, cpu)
                for tag, r in res["runs"].items() if r["group"] == group]
        for tag, stored, _r in runs[1:]:
            _same_stored(tag, f"stored pod values of [{tag}] and [{runs[0][0]}]", stored,
                         runs[0][1])
        log(f"[8a] {group}: " + ", ".join(f"{t} ({r['seconds']:.1f}s)" for t, _st, r in runs)
            + f" left byte-identical pod values ({runs[0][1]['entries']} pods; CPU members "
            "concurrently)")
        out[group] = {tag: r["report"] for tag, _st, r in runs}
        if group == "uniform":
            untraced = runs[0][1]
    return out, untraced


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
    deltacache with a 64-deep candidate index and ~32 rows per stratum
    class, the delta kernel on the delta waves), D3 (D1 with template pods
    under 4,000 capacity-only node updates/s: the ``aff`` stage and the sync
    stage) or D5 (D1 at an offered 2,000 pods/s: adaptive buckets);
    ``COORD_NODES`` nodes (D1 1,048,576, the others 262,144), packed,
    pipelined.  D4 is ``phase_constraints``."""
    from k8s1m_tpu_torch.tools import sched_bench
    from k8s1m_tpu_torch.tools.kernel_probe import profile_stages

    over = dict(nodes=COORD_NODES[config], pods=COORD_PODS.get(config), packing="packed")
    d1 = dict(batch=BATCH, depth=2, score_pct=SCORE_PCT)
    if config == "D1":
        over.update(d1, encode_profile=True, delta_profile=True, stats=True,
                    kernel_profile=True)
    elif config == "D2":
        # ~32 tied rows per stratum class (15 bits at 1M nodes, 13 at
        # 262,144) leave room for the megarow drill's 512-pod batch; a
        # 4096-pod batch would park pods as unschedulable.
        over.update(batch=512, depth=3, score_pct=100, deltacache="on",
                    delta_index_k=64, stratum_bits=D2_STRATUM_BITS, encode_profile=True,
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
        report["relist_s"] = _time_relist(store, NODES)
        log(f"[D1] relist of {NODES:,} nodes in-process: {report['relist_s']:.3f} s")
        # The knock-out variants over the live table on both backends
        # (sched_bench's --kernel-profile ran the kernels; one block of
        # one call per variant on the scan path: the full profile and the
        # filter-only floor, to keep the script inside its 1,200 s limit).
        prof = {"pallas": d["kernel_profile"],
                "xla": profile_stages(coord.table, coord.encoder, chunk=CHUNK, k=coord.k,
                                      steps=1, repeats=1, backend="xla",
                                      only={"full", "filter-only"})}
        for backend, res in prof.items():
            log(f"[D1] kernel profile over the live table, {backend} (repeats "
                f"{res['repeats']}): ms per batch {res['ms_per_batch']}, stages {res['stages']}")
        report["kernel_profile"] = prof
    coord.close()
    store.close()
    return report


def phase_constraints() -> dict:
    """8, D4: path B through the coordinator at 262,144 nodes, 4 waves
    of 2048 spread + 2048 anti pods: the ``cons`` stage launched, no node
    holding anti pods of two waves, and the device count tables equal to
    the host recount from the stored binds."""
    t0 = time.perf_counter()
    report, coord, store = _constraint_run("cuda", nodes=COORD_NODES["D4"], waves=D4_WAVES,
                                           per=D4_PER)
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


# ---- the CPU halves of the parity phases --------------------------------------

# Result keys that hold stored bytes ({key: value} or {key: (value, mod_revision)}),
# besides any key "stored <tag>": a child process hands them back in their
# ``_stored_form``.
STORED_KEYS = ("stored", "bound_pods", "ticked_pods", "leases")


def _digest(stored: dict) -> str:
    """sha256 over ``stored``'s entries in key order, every bytes field
    length-prefixed and every revision as 8 bytes: equal digests are equal
    bytes."""
    import hashlib

    h = hashlib.sha256()
    for key in sorted(stored):
        v = stored[key]
        for field in (key, *(v if isinstance(v, tuple) else (v,))):
            if isinstance(field, bytes):
                h.update(len(field).to_bytes(4, "big") + field)
            else:
                h.update(int(field).to_bytes(8, "big", signed=True))
    return h.hexdigest()


def _stored_form(stored: dict) -> dict:
    """Stored bytes as a child process hands them back: the entry count, the
    sha256 over every entry and each entry's own digest by key, so that a
    mismatch names the keys that differ (``_same_stored``)."""
    return {"entries": len(stored), "sha256": _digest(stored),
            "keys": {k.decode() if isinstance(k, bytes) else str(k): _digest({k: v})[:16]
                     for k, v in stored.items()}}


def _same_stored(tag: str, what: str, a: dict, b: dict) -> None:
    """Fails unless two ``_stored_form``s are equal; the message names the
    first keys whose entries differ or are missing on one side."""
    if a == b:
        return
    ka, kb = a["keys"], b["keys"]
    diff = sorted(k for k in ka.keys() | kb.keys() if ka.get(k) != kb.get(k))
    check(False, f"[{tag}] {what} differ: {len(diff)} keys of {a['entries']} / "
          f"{b['entries']}, first {diff[:3]}")


def _without_keys(run: dict) -> dict:
    """``run`` with each stored form cut to its count and sha256 (for --out)."""
    return {k: {f: x for f, x in v.items() if f != "keys"}
            if isinstance(v, dict) and "keys" in v else v for k, v in run.items()}


def _portable(run: dict) -> dict:
    """``run`` as a child process hands it back over JSON: stored bytes in
    their ``_stored_form``, tuples as lists."""
    out = {k: _stored_form(v) if k in STORED_KEYS or k.startswith("stored ") else v
           for k, v in run.items()}
    return json.loads(json.dumps(out, default=str))


# The CPU halves of the parity phases, in the order ``main`` starts them:
# 8a's three groups each in a child of its own (two torch threads each), then
# 10a, 12a, 18a and 19a (four threads).  ``main`` starts the children a
# parity phase ahead, so that their import of torch and the port (8-10 s on
# the card's host) overlaps the phases between; each then waits on stdin for
# its call.  10a and 12a run side by side, and so do 18a and 19a: both CPU
# halves of a pair are handed their calls before the first card half runs.
# A card half run in a child (22a's) is the same script on "cuda".
_CHILD = ("import json, sys, chip_smoke as cs, k8s1m_tpu_torch.tools.sched_bench; "
          "func, args = json.loads(sys.stdin.readline()); "
          "print(json.dumps(cs._portable(getattr(cs, func)(sys.argv[1], *args))), flush=True)")
_CPU_THREADS = [2, 2, 2, 4, 4, 4, 4, 4]
_WARM: list = []
_HANDED: list = []      # children given their work; reaped by _card_and_cpu or at exit


def _child(device: str, **env) -> subprocess.Popen:
    """A fresh ``_CHILD`` on ``device``, waiting on stdin for its call."""
    root, env = _child_env(**env)
    return subprocess.Popen([sys.executable, "-c", _CHILD, device], stdin=subprocess.PIPE,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env=env, cwd=root)


def _warm_cpu_children(n: int) -> None:
    """Start the next ``n`` CPU children of ``_CPU_THREADS``."""
    for _ in range(n):
        threads = _CPU_THREADS.pop(0) if _CPU_THREADS else 2
        _WARM.append(_child("cpu", OMP_NUM_THREADS=str(threads)))


def _hand(children: list, func: str, calls) -> list:
    """Hands ``func(device, *args)`` for each ``args`` of ``calls`` to
    ``children``; returns them."""
    _HANDED.extend(children)
    for child, args in zip(children, calls):
        child.stdin.write(json.dumps([func, list(args)]) + "\n")
        child.stdin.close()
        child.stdin = None  # so that communicate() writes nothing
    return children


def _stop_cpu_children() -> None:
    while _WARM:
        child = _WARM.pop()
        child.kill()
        child.communicate()
    while _HANDED:
        child = _HANDED.pop()
        if child.poll() is None:
            child.kill()
            child.wait()


def _start_cpu_half(func: str, cpu_calls=((),)) -> list:
    """Hands ``func("cpu", *args)`` for each ``args`` of ``cpu_calls`` to a
    warm CPU child; returns the children."""
    if len(_WARM) < len(cpu_calls):
        _warm_cpu_children(len(cpu_calls) - len(_WARM))
    return _hand([_WARM.pop(0) for _ in cpu_calls], func, cpu_calls)


def _start_card_half(func: str) -> list:
    """Hands ``func("cuda")`` to a fresh child (its own launch counts);
    returns it."""
    return _hand([_child("cuda")], func, [()])


def _collect(tag: str, children: list, half: str = "CPU") -> dict:
    """The results of ``children`` once each has exited 0 (killed past 900
    s): their log lines forwarded, their results merged (``runs`` joined,
    other keys by name)."""
    try:
        outs = [child.communicate(timeout=900) for child in children]
    finally:
        for child in children:
            if child.poll() is None:
                child.kill()
                child.communicate()
    merged: dict = {}
    for child, (stdout, stderr) in zip(children, outs):
        lines = stdout.strip().splitlines()
        for line in lines[:-1]:
            print(f"({half.lower()} child) {line}", flush=True)
        check(child.returncode == 0 and lines,
              f"[{tag}] the {half} half exited {child.returncode}: {stderr[-2000:]}")
        part = json.loads(lines[-1])
        merged.setdefault("runs", {}).update(part.pop("runs", {}))
        merged.update(part)
    if not merged["runs"]:
        del merged["runs"]
    return merged


def _card_and_cpu(tag: str, func: str, cpu_calls=((),), children=None) -> tuple[dict, dict]:
    """``func("cuda")`` in this process while ``func("cpu", *args)`` runs in a
    warm CPU child for each ``args`` of ``cpu_calls`` (or in ``children``,
    from ``_start_cpu_half``): ``_collect``'s merge of the children; both
    results in their ``_portable`` form.  Every child must exit 0."""
    children = children or _start_cpu_half(func, cpu_calls)
    try:
        card = _portable(globals()[func]("cuda"))
    except BaseException:
        for child in children:
            child.kill()
        raise
    return card, _collect(tag, children)


# ---- phase 10: the megarow drill, composed parity, breaker ---------------------

COMPOSED_NODES = 32768
# 10a runs the drill's tick sequence (steady, overload, recover) at the
# drill's batch, at 32,768 nodes for the 1,200 s limit (the same load-shed
# walk as at 65,536); 10b's oracle fallback costs ~60 us per (pod, node) on
# the host, so its open-state wave takes 2 pods.
BREAKER_NODES, BREAKER_FALLBACK = 65536, 2


# 10's saturated phase cut from 24 ticks to 12 for phases 17d and 21-21a
# (PERF.md section 4 gives each cut's saving).
MEGAROW_SAT_TICKS = 12


def phase_megarow() -> dict:
    """10: ``megarow_drill.run(parse_args(["--sat-ticks", "12"]))`` on the card,
    otherwise at its default shape — 1,048,576 nodes, batch 512, chunk 4096,
    depth 3, 4 tenants, deltacache on, index K 64, automatic stratum bits,
    the comparison lane and the differential at 131,072 — with every gate of
    the drill (the saturated phase cut from 24 ticks to 12).  The
    launch counts are set to 0 just before the run and read just after."""
    from k8s1m_tpu_torch.ops import delta_topk, fused_topk
    from k8s1m_tpu_torch.tools import megarow_drill

    args = megarow_drill.parse_args(["--sat-ticks", str(MEGAROW_SAT_TICKS)])
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


def phase_composed_parity(cpu_half=None) -> dict:
    """10a: ``_composed_run`` on the card and, concurrently in a child
    process (``cpu_half``, from ``_start_cpu_half``), on the CPU must leave
    byte-identical stored pods, the same admitted / rejected counts and
    per-tenant ledger, and the same controller state after every tick,
    walking through SHEDDING and back to HEALTHY."""
    from k8s1m_tpu_torch.loadshed import HEALTHY, SHEDDING, STATE_NAMES

    card, cpu = _card_and_cpu("10a", "_composed_run", children=cpu_half)
    runs = {"cuda": card, "cpu": cpu}
    _same_stored("10a", "card and CPU stored pod values", card["stored"], cpu["stored"])
    for key in ("admitted", "rejected", "states", "counters", "overcommitted_nodes",
                "max_pods_over"):
        check(card[key] == cpu[key], f"[10a] card and CPU {key} differ")
    check(SHEDDING in card["states"] and card["states"][-1] == HEALTHY,
          "[10a] the controller did not walk through SHEDDING back to HEALTHY")
    walk = [STATE_NAMES[s] for i, s in enumerate(card["states"])
            if i == 0 or s != card["states"][i - 1]]
    log(f"[10a] composed parity at {COMPOSED_NODES:,} nodes: card ({card['seconds']:.1f}s) and "
        f"CPU ({cpu['seconds']:.1f}s, concurrently) byte-identical over "
        f"{card['stored']['entries']} pods; admitted "
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


# ---- phases 11-15: tracing, the webhook, the drills, hostpath, the curve ------

OUT_DIR = "chiprun_out"
TRACE_PODS, TRACE_SAMPLE = 16384, 16
# Below one D1 cycle (hundreds of ms): every cycle dumps until the budget
# is spent.
FLIGHT_THRESHOLD_S, FLIGHT_MAX_DUMPS = 0.001, 8
TRACE_STAGES = {"queue_wait", "encode", "dispatch_wait", "device", "bind"}
# Phase 12 from 16,384 POSTs to 8,192 and phase 15's window from 4 s to 2 s
# to make room for phases 17-17b; for phases 18-18a, phase 12 to 4,096 POSTs,
# phase 15 without its 4,000/s point, and phases 14, 15 and 16 at 262,144
# nodes (D5 keeps the paced lane at 1,048,576); for phases 19-19a, phases 11
# and 12 at 262,144 nodes (D1 keeps their coordinator shape at 1,048,576) and
# 14, 15 and 16 at 131,072.
WEBHOOK_PODS, WEBHOOK_WAVE = 4096, 4096
TRACE_NODES = WEBHOOK_NODES = 1 << 18
HOSTPATH_NODES = FAILOVER_NODES = CURVE_NODES = 1 << 17
# 12a: 256-pod waves; 3 rounds of 768 POSTs drive the controller to
# SHEDDING (from the second round), then 2 rounds of 64.
HOOK_PARITY_BATCH = 256
HOOK_PARITY_ROUNDS = (768,) * 3 + (64,) * 2
# D1 saturated near 5,700 binds/s on the H100 (PERF.md): 2,000 sits below
# the knee (the gated point), 8,000 above it.
CURVE_RATES, CURVE_SECONDS, CURVE_MIN_PODS = (2000, 8000), 2.0, 8192
CURVE_BELOW_KNEE = (2000,)
# Keys of the drills' evidence that differ between the card and the CPU by
# design; no key of either drill holds a host timing (both run on a
# virtual clock of scheduling ticks).
DRILL_DEVICE_KEYS = ("device",)


def _launch_counts() -> dict:
    from k8s1m_tpu_torch.ops import delta_topk, fused_topk

    return {"fused_topk": fused_topk.fused_topk.launches,
            "delta_plane_topk": delta_topk.delta_plane_topk.launches,
            "fused_topk_by_stage": dict(fused_topk.fused_topk.launches_by_stage)}


def _reset_launches() -> None:
    from k8s1m_tpu_torch.ops import delta_topk, fused_topk

    fused_topk.reset_launches()
    delta_topk.reset_launches()


def _d1_over(**extra) -> dict:
    return {**dict(nodes=NODES, packing="packed", batch=BATCH, depth=2, score_pct=SCORE_PCT),
            **extra}


def phase_trace() -> dict:
    """11: ``sched_bench.run`` at D1's shape at 262,144 nodes with 16,384 pods, ``--trace 16
    --trace-out --profile`` and a ``FlightRecorder`` whose threshold is
    below one cycle: the Perfetto export validates, attribution covers >=
    95% of schedule-to-bind, the stages include queue_wait, encode,
    dispatch_wait, device and bind, every pod is bound once; the flight
    dumps (slow cycles and slow traced pods) and the slow-cycle profile
    dumps stop at ``max_dumps``, the rest counted as suppressed; the
    profiler's top host functions are printed (not gated)."""
    from k8s1m_tpu_torch.obs.metrics import REGISTRY
    from k8s1m_tpu_torch.obs.podtrace import validate_trace
    from k8s1m_tpu_torch.obs.trace import FlightRecorder
    from k8s1m_tpu_torch.tools import sched_bench

    os.makedirs(OUT_DIR, exist_ok=True)
    trace_out = os.path.join(OUT_DIR, "trace_d1.json")
    prof_out = os.path.join(OUT_DIR, "profile_d1.json")
    flight_dir = os.path.join(OUT_DIR, "flight_d1")
    os.makedirs(flight_dir, exist_ok=True)
    for name in os.listdir(flight_dir):
        os.remove(os.path.join(flight_dir, name))
    dumps = REGISTRY.get("flight_dumps_total")
    base = {o: dumps.value(outcome=o) for o in ("written", "suppressed", "error")}
    flight = FlightRecorder(threshold_s=FLIGHT_THRESHOLD_S, dump_dir=flight_dir,
                            max_dumps=FLIGHT_MAX_DUMPS)
    t0 = time.perf_counter()
    report, coord, store = sched_bench.run(_bench_args(**_d1_over(
        nodes=TRACE_NODES, pods=TRACE_PODS, trace=TRACE_SAMPLE, trace_out=trace_out,
        profile=prof_out)),
        flight_recorder=flight)
    d = report["detail"]
    _coordinator_checks("11", report, coord, store, TRACE_PODS)
    coord.close()
    store.close()
    check(d["launches"]["fused_topk_by_stage"]["base"] > 0, "[11] no fused base-stage launch")
    att = d["latency_attribution"]
    with open(trace_out) as f:
        errs = validate_trace(json.load(f))
    check(errs == [], f"[11] the Perfetto export does not validate: {errs[:5]}")
    check(att["coverage"] >= 0.95, f"[11] attribution covers {att['coverage']} < 0.95")
    check(TRACE_STAGES <= set(att["stages"]), f"[11] stages {sorted(att['stages'])}")
    _log_report("11", report, t0)
    log(f"[11] traced {att['pods']} pods (1 in {att['sample_n']}), coverage "
        f"{att['coverage']}, end to end p50 {att['end_to_end']['p50_ms']} ms p99 "
        f"{att['end_to_end']['p99_ms']} ms; per stage p50 / p99 ms, share: " + "; ".join(
            f"{s} {v['p50_ms']} / {v['p99_ms']}, {v['share']}"
            for s, v in att["stages"].items()))
    with open(prof_out) as f:
        prof = json.load(f)
    log(f"[11] profiler: {prof['thread_samples']} thread samples over {prof['wall_s']} s; "
        f"top 10 self-time frames (% of thread samples): " + "; ".join(
            f"{r['frame']} {r['pct']}" for r in prof["top_self"][:10]))
    files = os.listdir(flight_dir)
    flights = [f for f in files if f.startswith("flight-")]
    profiles = [f for f in files if f.startswith("profile-slowcycle-")]
    out = {o: dumps.value(outcome=o) - base[o] for o in base}
    check(len(flights) == out["written"] == FLIGHT_MAX_DUMPS,
          f"[11] {len(flights)} flight dumps, {out['written']} written, budget "
          f"{FLIGHT_MAX_DUMPS}")
    check(out["suppressed"] > 0 and out["error"] == 0, f"[11] flight dump outcomes {out}")
    check(1 <= len(profiles) <= FLIGHT_MAX_DUMPS,
          f"[11] {len(profiles)} slow-cycle profile dumps, budget {FLIGHT_MAX_DUMPS}")
    slow_pods = 0
    for name in flights:
        with open(os.path.join(flight_dir, name)) as f:
            doc = json.load(f)
        if "pod" in doc:
            slow_pods += 1
            check("device" in [s["stage"] for s in doc["pod_spans"]],
                  f"[11] slow-pod dump {name} has no device span")
    log(f"[11] flight recorder below one cycle ({FLIGHT_THRESHOLD_S * 1e3} ms): "
        f"{len(flights)} dumps written ({slow_pods} slow-pod dumps with span chains), "
        f"{int(out['suppressed'])} suppressed past max_dumps={FLIGHT_MAX_DUMPS}, "
        f"{len(profiles)} slow-cycle profile dumps ({time.perf_counter() - t0:.1f}s)")
    return {"report": report, "flight": {"written": len(flights), "slow_pod_dumps": slow_pods,
                                         "suppressed": out["suppressed"],
                                         "profile_dumps": len(profiles)},
            "profile_top": prof["top_self"][:10], "launches": d["launches"],
            "seconds": round(time.perf_counter() - t0, 3)}


def _sum_launches(*runs) -> dict:
    return {
        "fused_topk": sum(r["fused_topk"] for r in runs),
        "delta_plane_topk": sum(r.get("delta_plane_topk", 0) for r in runs),
        "fused_topk_by_stage": {
            s: sum(r["fused_topk_by_stage"][s] for r in runs)
            for s in runs[0]["fused_topk_by_stage"]},
    }


def phase_trace_parity(untraced: dict) -> dict:
    """11a: 8a's uniform card run (65,536 nodes x 8,192 pods, chunk 4096,
    zero-delay retries, no tracer) again with ``--trace 1``: the stored pod
    values must equal the untraced run's byte for byte."""
    from k8s1m_tpu_torch.faultline import RetryPolicy
    from k8s1m_tpu_torch.tools import sched_bench

    t0 = time.perf_counter()
    report, coord, store = sched_bench.run(_bench_args(
        nodes=PARITY_NODES, pods=PARITY_PODS, score_pct=SCORE_PCT, packing="packed",
        chunk=CHUNK, trace=1), retry_policy=RetryPolicy(**_ZERO_DELAY))
    stored = _coordinator_checks("11a", report, coord, store, PARITY_PODS)
    coord.close()
    store.close()
    d = report["detail"]
    _same_stored("11a", "tracing moved placement: stored pod values and 8a's untraced card "
                 "run's", _stored_form(stored), untraced)
    att = d["latency_attribution"]
    check(att["coverage"] >= 0.95, f"[11a] coverage {att['coverage']}")
    log(f"[11a] {PARITY_NODES:,} nodes x {PARITY_PODS:,} pods with --trace 1 on the card: "
        f"stored pods byte-identical to 8a's untraced card run; {att['pods']} traced, "
        f"coverage {att['coverage']}, binds/s {report['value']} "
        f"({time.perf_counter() - t0:.1f}s)")
    return {"report": report, "launches": d["launches"],
            "seconds": round(time.perf_counter() - t0, 3)}


def _post_review(port: int, obj: dict, uid: str):
    """(status, Retry-After or None, body) of one AdmissionReview POST."""
    import http.client

    body = json.dumps({"apiVersion": "admission.k8s.io/v1", "kind": "AdmissionReview",
                       "request": {"uid": uid, "object": obj}}).encode()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("POST", "/validate", body=body,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.getheader("Retry-After"), resp.read()
    finally:
        conn.close()


def _hook_pod(name: str, cpu_milli: int = 10):
    from k8s1m_tpu_torch.snapshot.pod_encoding import PodInfo

    return PodInfo(name, cpu_milli=cpu_milli, mem_kib=1024)


def phase_webhook() -> dict:
    """12: a ``Coordinator`` at D1's shape (262,144 nodes, batch 4096, 5%,
    depth 2, packed) behind ``WebhookServer(coord.submit_external)`` on
    localhost.  One client thread POSTs 4,096 AdmissionReviews in waves of
    4,096 and stores each wave after its admission (the apiserver's write);
    the main thread steps the coordinator once per stored wave.  Every
    response is 200 and allowed, every pod is bound exactly once, and the
    store-watch intake binds no pod a second time."""
    import queue
    import threading

    from k8s1m_tpu_torch.config import PodSpec, TableSpec
    from k8s1m_tpu_torch.control.coordinator import Coordinator
    from k8s1m_tpu_torch.control.objects import encode_pod, pod_key
    from k8s1m_tpu_torch.control.webhook import WebhookServer
    from k8s1m_tpu_torch.obs.metrics import REGISTRY, quantile_report_ms
    from k8s1m_tpu_torch.plugins.registry import Profile
    from k8s1m_tpu_torch.store.native import MemStore
    from k8s1m_tpu_torch.tools.sched_bench import _stage_means_ms, write_nodes

    t0 = time.perf_counter()
    store = MemStore()
    write_nodes(store, WEBHOOK_NODES)
    coord = Coordinator(
        store, TableSpec(max_nodes=WEBHOOK_NODES), PodSpec(batch=BATCH),
        Profile(node_affinity=0, topology_spread=0, interpod_affinity=0), chunk=CHUNK,
        with_constraints=False, pipeline=True, depth=2, score_pct=SCORE_PCT,
        packing="packed", device="cuda")
    coord.bootstrap()
    srv = WebhookServer(coord.submit_external).start()
    scheduled = REGISTRY.get("coordinator_pods_scheduled_total")
    try:
        # One warm-up pod through the whole path, outside the window.
        warm = _hook_pod("hook-warm")
        status, _ra, _b = _post_review(srv.port, json.loads(encode_pod(warm)), "warm")
        check(status == 200, f"[12] warm-up POST answered {status}")
        store.put(pod_key("default", warm.name), encode_pod(warm))
        while coord.run_until_idle() == 0:
            pass
        for name in ("coordinator_schedule_to_bind_seconds", "coordinator_cycle_seconds"):
            REGISTRY.get(name).reset()
        _reset_launches()
        bound0 = scheduled.value(outcome="bound")
        waves: queue.Queue = queue.Queue()
        answers: list = []
        post_s = [0.0]

        def client():
            try:
                for w in range(WEBHOOK_PODS // WEBHOOK_WAVE):
                    items = []
                    t = time.perf_counter()
                    for i in range(WEBHOOK_WAVE):
                        pod = _hook_pod(f"hook-{w}-{i}")
                        raw = encode_pod(pod)
                        status, _ra, body = _post_review(srv.port, json.loads(raw), f"{w}-{i}")
                        answers.append((status, body))
                        items.append((pod_key("default", pod.name), raw))
                    post_s[0] += time.perf_counter() - t
                    store.put_batch(items)
                    waves.put(w)
            finally:
                waves.put(None)

        th = threading.Thread(target=client, name="webhook-client")
        bound = 0
        t1 = time.perf_counter()
        th.start()
        while waves.get(timeout=600) is not None:
            bound += coord.step()
        th.join(timeout=600)
        check(not th.is_alive(), "[12] the client thread did not finish")
        bound += coord.run_until_idle()
        window_s = time.perf_counter() - t1
        launches = _launch_counts()
        check(len(answers) == WEBHOOK_PODS, f"[12] {len(answers)} answers")
        check(all(s == 200 and json.loads(b)["response"]["allowed"] for s, b in answers),
              "[12] a POST was not answered 200 and allowed")
        check(bound == WEBHOOK_PODS, f"[12] {bound} binds in the window, want {WEBHOOK_PODS}")
        check(scheduled.value(outcome="bound") - bound0 == WEBHOOK_PODS,
              "[12] the store-watch intake bound a pod a second time")
        _store_checks("12", coord, store, WEBHOOK_PODS + 1)
        check(launches["fused_topk_by_stage"]["base"] > 0, "[12] no fused base-stage launch")
        q = quantile_report_ms(REGISTRY.get("coordinator_schedule_to_bind_seconds"),
                               (0.5, 0.99))
        res = {"posts_per_sec": round(WEBHOOK_PODS / post_s[0], 1),
               "binds_per_sec": round(bound / window_s, 1), **q,
               "window_s": round(window_s, 3), "post_s": round(post_s[0], 3),
               "stage_means_ms": _stage_means_ms(), "waves": dict(coord.waves),
               "launches": launches}
    finally:
        srv.stop()
        coord.close()
        store.close()
    log(f"[12] webhook intake at {WEBHOOK_NODES:,} nodes: {WEBHOOK_PODS} POSTs from one client "
        f"thread at {res['posts_per_sec']} POSTs/s, {res['binds_per_sec']} binds/s over "
        f"{res['window_s']} s, schedule-to-bind p50 {res['p50_ms']} ms p99 {res['p99_ms']} "
        f"ms, every pod bound once; stage means ms {res['stage_means_ms']}, waves "
        f"{res['waves']}, launches {launches} ({time.perf_counter() - t0:.1f}s)")
    res["seconds"] = round(time.perf_counter() - t0, 3)
    return res


def _webhook_parity_run(device: str) -> dict:
    """12a's construction: 65,536 nodes, 256-pod waves, 5%, chunk 4096,
    zero-delay retries, a ``HealthController`` as the server's
    ``controller=`` and the coordinator's ``loadshed=``; rounds of POSTs
    (priorities 3..0) from this thread, each admitted pod stored once its
    sink call ran, one step per round, then the drain."""
    import threading

    from k8s1m_tpu_torch.config import PodSpec, TableSpec
    from k8s1m_tpu_torch.control.coordinator import Coordinator
    from k8s1m_tpu_torch.control.objects import encode_pod, pod_key
    from k8s1m_tpu_torch.control.webhook import WebhookServer
    from k8s1m_tpu_torch.faultline import RetryPolicy
    from k8s1m_tpu_torch.loadshed import STATE_NAMES, HealthController, LoadshedConfig
    from k8s1m_tpu_torch.plugins.registry import Profile
    from k8s1m_tpu_torch.store.native import MemStore
    from k8s1m_tpu_torch.tools.sched_bench import write_nodes

    b = HOOK_PARITY_BATCH
    t0 = time.perf_counter()
    store = MemStore()
    write_nodes(store, PARITY_NODES)
    ls = HealthController(LoadshedConfig(
        queue_degraded=2 * b, queue_shed=4 * b, queue_cap=8 * b, queue_recover=b // 2,
        recover_cycles=2), name=f"12a-{device}")
    coord = Coordinator(
        store, TableSpec(max_nodes=PARITY_NODES), PodSpec(batch=b),
        Profile(node_affinity=0, topology_spread=0, interpod_affinity=0), chunk=CHUNK,
        with_constraints=False, pipeline=True, depth=2, score_pct=SCORE_PCT,
        packing="packed", device=device, loadshed=ls,
        retry_policy=RetryPolicy(**_ZERO_DELAY))
    sunk = threading.Semaphore(0)

    def sink(obj, admitted=False):
        coord.submit_external(obj, admitted=admitted)
        sunk.release()

    coord.bootstrap()
    _reset_launches()
    srv = WebhookServer(sink, controller=ls).start()
    answers, shed, states = [], [], []
    try:
        seq = 0
        for n in HOOK_PARITY_ROUNDS:
            items = []
            for _ in range(n):
                pod = _hook_pod(f"p{seq:06d}", cpu_milli=10 + seq % 7)
                obj = json.loads(encode_pod(pod))
                obj["spec"]["priority"] = 3 - seq % 4
                status, retry_after, _body = _post_review(srv.port, obj, f"u{seq}")
                answers.append((status, retry_after))
                if status == 200:
                    check(sunk.acquire(timeout=30), "[12a] the sink never ran")
                    items.append((pod_key("default", pod.name), encode_pod(pod)))
                else:
                    shed.append(pod.name)
                seq += 1
            store.put_batch(items)
            coord.step()
            states.append(STATE_NAMES[ls.state])
        coord.run_until_idle()
        admitted = sum(1 for s, _ in answers if s == 200)
        stored = _store_checks(f"12a {device}", coord, store, admitted)
        launches = _launch_counts()
    finally:
        srv.stop()
        coord.close()
        store.close()
    names = {k.rsplit(b"/", 1)[1].decode() for k in stored}
    check(not names & set(shed), f"[12a {device}] a shed pod was stored and bound")
    return {"answers": answers, "stored": stored, "states": states, "shed": len(shed),
            "launches": launches, "seconds": time.perf_counter() - t0}


def phase_webhook_parity(cpu_half=None) -> dict:
    """12a: ``_webhook_parity_run`` on the card and, concurrently in a child
    process, the CPU: the same status
    sequence (200 or 429), the same ``Retry-After`` values, byte-identical
    stored pods; the controller reached SHEDDING; no shed pod bound."""
    card, cpu = _card_and_cpu("12a", "_webhook_parity_run", children=cpu_half)
    runs = {"cuda": card, "cpu": cpu}
    check(card["answers"] == cpu["answers"],
          "[12a] card and CPU answered the POST sequence differently")
    _same_stored("12a", "card and CPU stored pod values", card["stored"], cpu["stored"])
    check(card["states"] == cpu["states"], "[12a] card and CPU controller states differ")
    check("shedding" in card["states"] and card["shed"] > 0,
          f"[12a] the burst never drove the controller to SHEDDING: {card['states']}")
    retry = sorted({ra for s, ra in card["answers"] if s == 429})
    log(f"[12a] webhook parity at {PARITY_NODES:,} nodes: card ({card['seconds']:.1f}s) and "
        f"CPU ({cpu['seconds']:.1f}s, concurrently) gave the same {len(card['answers'])} "
        f"answers ({card['shed']} x 429, Retry-After {retry}) and byte-identical stored pods "
        f"({card['stored']['entries']}); states {card['states']}; card launches "
        f"{card['launches']}")
    return {dev: {"shed": r["shed"], "stored": r["stored"]["entries"], "states": r["states"],
                  "launches": r["launches"], "seconds": round(r["seconds"], 3)}
            for dev, r in runs.items()}


# A tool's card half in a fresh process: ``python -c _CARD_TOOL <tool> <args>``
# runs ``k8s1m_tpu_torch.tools.<tool>.main(args)`` with the launch counts set
# to 0 just before it, and prints its report and the counts as one JSON line.
_CARD_TOOL = "\n".join((
    "import contextlib, importlib, json, sys",
    "import chip_smoke as cs",
    "tool = importlib.import_module('k8s1m_tpu_torch.tools.' + sys.argv[1])",
    "cs._reset_launches()",
    "with contextlib.redirect_stdout(sys.stderr):",
    "    report = tool.main(sys.argv[2:])",
    "print(json.dumps({'report': report, 'launches': cs._launch_counts()}), flush=True)",
))


def _child_env(**extra) -> tuple[str, dict]:
    root = os.path.dirname(os.path.abspath(__file__))
    return root, dict(os.environ, **extra, PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p))


def phase_drills() -> dict:
    """13: ``overload_drill`` and ``tenantfair_drill`` at their default
    shapes on the card (overload's in this process, tenantfair's in a child
    beside it; launches counted in each) and with ``--device cpu`` (in
    parallel subprocesses, one torch thread each): every run ``passed``, and
    each drill's two evidence documents are equal once ``DRILL_DEVICE_KEYS``
    are removed."""
    import contextlib
    import io

    from k8s1m_tpu_torch.tools import overload_drill

    os.makedirs(OUT_DIR, exist_ok=True)
    t0 = time.perf_counter()
    root, env = _child_env()
    procs = {}
    for mod in ("overload_drill", "tenantfair_drill"):
        with open(os.path.join(OUT_DIR, f"{mod}_cpu.log"), "w") as err:
            procs[mod, "cpu"] = subprocess.Popen(
                [sys.executable, "-m", f"k8s1m_tpu_torch.tools.{mod}", "--device", "cpu",
                 "--out", os.path.join(OUT_DIR, f"{mod}_cpu.json")],
                stdout=subprocess.PIPE, stderr=err, text=True,
                env={**env, "OMP_NUM_THREADS": "1"}, cwd=root)
    with open(os.path.join(OUT_DIR, "tenantfair_drill_cuda.log"), "w") as err:
        procs["tenantfair_drill", "cuda"] = subprocess.Popen(
            [sys.executable, "-c", _CARD_TOOL, "tenantfair_drill", "--out",
             os.path.join(OUT_DIR, "tenantfair_drill_cuda.json")],
            stdout=subprocess.PIPE, stderr=err, text=True, env=env, cwd=root)

    def finish(mod, dev):
        proc = procs[mod, dev]
        stdout, _ = proc.communicate(timeout=600)
        check(proc.returncode == 0 and stdout.strip(),
              f"[13] {mod} on {dev} exited {proc.returncode} ({mod}_{dev}.log)")
        return json.loads(stdout.strip().splitlines()[-1])

    out = {}
    try:
        for mod in ("overload_drill", "tenantfair_drill"):
            t1 = time.perf_counter()
            if mod == "overload_drill":
                _reset_launches()
                with contextlib.redirect_stdout(io.StringIO()):
                    card = overload_drill.main(
                        ["--out", os.path.join(OUT_DIR, f"{mod}_cuda.json")])
                launches = _launch_counts()
                where = f"in this process, {time.perf_counter() - t1:.1f}s"
            else:
                child = finish(mod, "cuda")
                card, launches = child["report"], child["launches"]
                where = (f"in a child beside overload_drill's, done "
                         f"{time.perf_counter() - t1:.1f}s after it")
            card_s = time.perf_counter() - t1  # running the card half, or waiting on its child
            cpu = finish(mod, "cpu")
            check(card["passed"] and cpu["passed"],
                  f"[13] {mod} did not pass (card {card['passed']}, cpu {cpu['passed']})")
            check(card["device"] == "cuda" and cpu["device"] == "cpu", f"[13] {mod} devices")
            a = {k: v for k, v in card.items() if k not in DRILL_DEVICE_KEYS}
            b = {k: v for k, v in cpu.items() if k not in DRILL_DEVICE_KEYS}
            check(a == b, f"[13] {mod}: card and CPU evidence differ")
            check(launches["fused_topk"] > 0, f"[13] {mod}: no fused-kernel launch")
            log(f"[13] {mod} at its default shape {json.dumps(card['shape'])}: passed on the "
                f"card ({where}) and the CPU, evidence equal without "
                f"{list(DRILL_DEVICE_KEYS)}; value {card['value']} ({card['unit']}); "
                f"launches {launches}")
            out[mod] = {"evidence": card, "launches": launches, "card_s": round(card_s, 3)}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    log(f"[13] drills ({time.perf_counter() - t0:.1f}s)")
    out["seconds"] = round(time.perf_counter() - t0, 3)
    return out


def phase_hostpath() -> dict:
    """14: ``hostpath_bench --nodes 262144`` (otherwise its defaults): the
    encode gate (>= 3x) passes, cached and uncached encodes are
    byte-identical (the tool exits otherwise), and the encode+cycle lane
    runs its three passes on the fused kernel's affinity stage with the
    tool's 80-key query table (``PodSpec(query_keys=80)``): launches
    counted, every wave answered."""
    import contextlib
    import io

    from k8s1m_tpu_torch.tools import hostpath_bench

    t0 = time.perf_counter()
    _reset_launches()
    with contextlib.redirect_stdout(io.StringIO()):
        rep = hostpath_bench.main(["--nodes", str(HOSTPATH_NODES),
                                   "--out", os.path.join(OUT_DIR, "hostpath_bench.json")])
    launches = _launch_counts()
    d = rep["detail"]
    check(d["byte_identical"] and d["gate"] == hostpath_bench.GATE_FULL, "[14] gate or bytes")
    check(rep["value"] >= hostpath_bench.GATE_FULL, f"[14] encode speedup {rep['value']}")
    cyc = d["cycle"]
    enc = d["encode"]
    waves = 3 * -(-enc["pods"] // enc["batch"])      # an untimed pass and two timed ones
    check(cyc is not None and cyc["backend"] == "pallas" and cyc["device"].startswith("cuda"),
          f"[14] the cycle lane did not run the kernels on the card: {cyc}")
    check(launches["fused_topk_by_stage"]["aff"] > 0,
          f"[14] the cycle lane launched no affinity-stage kernel: {launches}")
    check(launches["fused_topk"] == waves,
          f"[14] {launches['fused_topk']} fused launches for {waves} waves")
    log(f"[14] hostpath_bench at {HOSTPATH_NODES:,} nodes: encode speedup {rep['value']}x (uncached "
        f"{enc['uncached_s']} s, cached {enc['cached_s']} s; {enc['pods_per_sec_uncached']} "
        f"vs {enc['pods_per_sec_cached']} pods/s, hit rate {enc['cache_hit_rate']}), "
        f"byte-identical; encode+cycle on the fused aff stage (80 query keys): uncached "
        f"{cyc['uncached_s']} s, cached {cyc['cached_s']} s ({cyc['binds_per_sec_uncached']} "
        f"vs {cyc['binds_per_sec_cached']} pods/s, {cyc['speedup']}x); launches {launches} "
        f"({time.perf_counter() - t0:.1f}s)")
    return {"report": rep, "launches": launches,
            "seconds": round(time.perf_counter() - t0, 3)}


def phase_curve() -> dict:
    """15: ``latency_curve --nodes 262144 --rates 2000,8000 --seconds 2
    --min-pods 8192`` (one ``sched_bench --rate R`` subprocess per point,
    through ``tools/with_deadline.py``): every point returns a row, and
    below the knee (``CURVE_BELOW_KNEE``) achieved binds/s is within 5% of
    the offered rate."""
    import contextlib
    import io

    from k8s1m_tpu_torch.tools import latency_curve

    t0 = time.perf_counter()
    out = os.path.join(OUT_DIR, "latency_curve.jsonl")
    reports = os.path.join(OUT_DIR, "latency_curve_reports.jsonl")
    if os.path.exists(reports):
        os.remove(reports)
    rates = ",".join(str(r) for r in CURVE_RATES)
    with contextlib.redirect_stdout(io.StringIO()):
        rows = latency_curve.main([
            "--nodes", str(CURVE_NODES), "--rates", rates, "--seconds", str(CURVE_SECONDS),
            "--min-pods", str(CURVE_MIN_PODS), "--timeout", "300", "--out", out,
            "--reports", reports])
    check([r["rate"] for r in rows] == list(CURVE_RATES), f"[15] rows {rows}")
    with open(reports) as f:
        docs = [json.loads(line) for line in f]
    launches = _sum_launches(*(doc["detail"]["launches"] for doc in docs))
    check(launches["fused_topk"] > 0, "[15] no fused-kernel launch in the points")
    for r in rows:
        check(r["bound"] == r["pods"] - 1, f"[15] rate {r['rate']}: {r['bound']} bound")
    for r in rows:
        if r["rate"] not in CURVE_BELOW_KNEE:
            continue
        check(abs(r["binds_per_sec"] - r["rate"]) <= 0.05 * r["rate"],
              f"[15] below the knee: rate {r['rate']} achieved {r['binds_per_sec']} binds/s")
    log(f"[15] latency curve at {CURVE_NODES:,} nodes: " + "; ".join(
        f"offered {r['rate']}/s -> {r['binds_per_sec']} binds/s, p50 {r['p50_ms']} ms p95 "
        f"{r['p95_ms']} ms p99 {r['p99_ms']} ms ({r['point_wall_s']} s)" for r in rows)
        + f"; launches {launches}")
    # with_deadline's watchdog polls its parent every 5 s and leaves on its
    # own once the point exited: wait it out, so no process outlives the run.
    time.sleep(6)
    log(f"[15] ({time.perf_counter() - t0:.1f}s)")
    return {"rows": rows, "launches": launches, "seconds": round(time.perf_counter() - t0, 3)}


# ---- phases 16 / 16a: lease election, fencing and warm-standby failover -------

# Keys of the failover drill's evidence that hold host wall-clock seconds
# (the takeover times); everything else runs on the drill's injected clock.
FAILOVER_CLOCK_KEYS = ("recovery_s", "recovery_warm_s", "recovery_cold_s", "warm_speedup",
                       "value")
FAILOVER_SCENARIOS = ("mid_wave_kill_cold", "mid_wave_kill_warm", "split_brain")


def _failover_gates(tag: str, rep: dict) -> None:
    ev = rep["evidence"]
    check(rep["passed"], f"[{tag}] failover_drill did not pass")
    for k in FAILOVER_SCENARIOS:
        s = ev[k]
        check(s["passed"] and s["lost"] == 0 and s["ledger"]["double_binds"] == 0
              and s["consistency"]["byte_consistent"], f"[{tag}] {k}: a gate failed")
    check(ev["split_brain"]["fencing_rejected"] > 0
          and ev["split_brain"]["deposed_leader_bound"] == 0, f"[{tag}] fencing")
    check(ev["mid_wave_kill_warm"]["mode"] == "warm"
          and ev["mid_wave_kill_cold"]["mode"] == "cold", f"[{tag}] takeover modes")
    check(ev["recovery_warm_s"] < ev["recovery_cold_s"], f"[{tag}] warm >= cold")


def _scrub_clock(d):
    if isinstance(d, dict):
        return {k: _scrub_clock(v) for k, v in d.items()
                if k not in FAILOVER_CLOCK_KEYS + DRILL_DEVICE_KEYS}
    return d


def phase_failover() -> dict:
    """16: ``failover_drill --nodes 262144 --chunk 4096`` on the card
    (otherwise the drill's defaults: batch 256, depth 3, 4 tenants, 192
    pods per tick, 12 loaded ticks before the kill or the pause): every
    gate of all three scenarios, fused base-stage launches counted in the
    run (counts set to 0 just before it)."""
    import contextlib
    import io

    from k8s1m_tpu_torch.tools import failover_drill

    t0 = time.perf_counter()
    _reset_launches()
    with contextlib.redirect_stdout(io.StringIO()):
        rep = failover_drill.main(["--nodes", str(FAILOVER_NODES), "--chunk", str(CHUNK),
                                   "--out", os.path.join(OUT_DIR, "failover_drill.json")])
    launches = _launch_counts()
    _failover_gates("16", rep)
    check(launches["fused_topk_by_stage"]["base"] > 0,
          f"[16] no fused base-stage launch: {launches}")
    ev = rep["evidence"]
    warm, cold = ev["mid_wave_kill_warm"], ev["mid_wave_kill_cold"]
    log(f"[16] failover_drill at {FAILOVER_NODES:,} nodes (chunk {CHUNK}): passed; recovery warm "
        f"{ev['recovery_warm_s']:.4f} s, cold {ev['recovery_cold_s']:.4f} s, cold/warm "
        f"{ev['warm_speedup']:.2f}x; split-brain fencing rejects "
        f"{ev['split_brain']['fencing_rejected']}, deposed binds "
        f"{ev['split_brain']['deposed_leader_bound']}; first bind after takeover at cycle "
        f"{warm['cycles_to_first_bind']} (warm) / {cold['cycles_to_first_bind']} (cold); "
        f"promote stats {json.dumps(warm['promote_stats'])}; lost 0, double binds 0, "
        f"byte-consistent; launches {launches} ({time.perf_counter() - t0:.1f}s)")
    return {"evidence": rep, "launches": launches,
            "seconds": round(time.perf_counter() - t0, 3)}


# 16a's card half: the drill's CLI entry in a fresh process, as the CPU half
# runs, its launch counts set to 0 just before and read just after; its last
# stdout line is {"report": ..., "launches": ...}.
_CARD_DRILL = "\n".join((
    "import contextlib, json, sys",
    "import chip_smoke as cs",
    "from k8s1m_tpu_torch.tools import failover_drill",
    "cs._reset_launches()",
    "with contextlib.redirect_stdout(sys.stderr):",
    "    report = failover_drill.main(sys.argv[1:])",
    "print(json.dumps({'report': report, 'launches': cs._launch_counts()}), flush=True)",
))


def phase_failover_parity() -> dict:
    """16a: ``failover_drill`` at its default shape (2,048 nodes, chunk 256)
    on the card and with ``--device cpu``, each in a fresh process of its own
    (its ``warm < cold`` gate compares a few milliseconds of host clock, which
    the long-lived smoke process's heap and state can swing), at the same time: both
    pass every gate, the evidence is equal once the wall-clock and device
    keys are removed, and each scenario leaves the same stored pod bytes
    (``pods_sha256``).  The card's launches are counted in its process."""
    t0 = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p))
    procs = {}
    for dev, cmd, threads in (
        ("cuda", ["-c", _CARD_DRILL], {}),
        ("cpu", ["-m", "k8s1m_tpu_torch.tools.failover_drill", "--device", "cpu"],
         {"OMP_NUM_THREADS": "1"}),
    ):
        with open(os.path.join(OUT_DIR, f"failover_drill_{dev}.log"), "w") as err:
            procs[dev] = subprocess.Popen(
                [sys.executable, *cmd, "--out",
                 os.path.join(OUT_DIR, f"failover_drill_{dev}.json")],
                stdout=subprocess.PIPE, stderr=err, text=True, env={**env, **threads}, cwd=root)
    try:
        outs = {dev: proc.communicate(timeout=600)[0] for dev, proc in procs.items()}
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for dev, proc in procs.items():
        check(proc.returncode == 0 and outs[dev].strip(),
              f"[16a] failover_drill on {dev} exited {proc.returncode} (failover_drill_{dev}.log)")
    card_out = json.loads(outs["cuda"].strip().splitlines()[-1])
    card, launches = card_out["report"], card_out["launches"]
    cpu = json.loads(outs["cpu"].strip().splitlines()[-1])
    _failover_gates("16a card", card)
    _failover_gates("16a cpu", cpu)
    check(card["device"] == "cuda" and cpu["device"] == "cpu", "[16a] devices")
    check(launches["fused_topk_by_stage"]["base"] > 0, f"[16a] no base launch: {launches}")
    digests = {k: (card["evidence"][k]["pods_sha256"], cpu["evidence"][k]["pods_sha256"])
               for k in FAILOVER_SCENARIOS}
    check(all(a == b for a, b in digests.values()),
          f"[16a] stored pod bytes differ between card and CPU: {digests}")
    check(_scrub_clock(card) == _scrub_clock(cpu), "[16a] card and CPU evidence differ")
    log(f"[16a] failover_drill at its default shape on the card and the CPU: both pass, "
        f"evidence equal without {list(FAILOVER_CLOCK_KEYS + DRILL_DEVICE_KEYS)}, stored "
        f"pods byte-identical per scenario; recovery warm/cold card "
        f"{card['evidence']['recovery_warm_s']:.4f}/{card['evidence']['recovery_cold_s']:.4f} s, "
        f"cpu {cpu['evidence']['recovery_warm_s']:.4f}/"
        f"{cpu['evidence']['recovery_cold_s']:.4f} s; launches {launches} "
        f"({time.perf_counter() - t0:.1f}s)")
    return {"cuda": {"evidence": card, "launches": launches}, "cpu": cpu,
            "seconds": round(time.perf_counter() - t0, 3)}


WIRE_STRESS_WATCHERS, WIRE_STRESS_WRITERS = 100, 1
# 17b at 262,144 nodes (1,048,576 before phases 19-19a, which needed the
# room): 17 keeps D1 over the wire at 1,048,576.
WIRE_CONFIG5_NODES = 1 << 18


def _time_relist(store, nodes: int) -> float:
    """Seconds for the coordinator's node relist of the whole fleet of
    ``nodes`` from ``store`` (``Coordinator._relist_nodes``: the values-only
    light parse in-process; over the wire ``list_prefix_sharded``, 8
    key-range shards fetched at once)."""
    from types import SimpleNamespace

    from k8s1m_tpu_torch.control.coordinator import Coordinator

    t0 = time.perf_counter()
    values, _rev = Coordinator._relist_nodes(SimpleNamespace(store=store))
    seconds = time.perf_counter() - t0
    check(len(values) == nodes, f"relist returned {len(values)} nodes, want {nodes}")
    return round(seconds, 3)


def phase_wire(config: str) -> dict:
    """17 (D1 over the wire) / 17b (BASELINE config 5): ``sched_bench --target``
    against ``python -m k8s1m_tpu_torch.store.server_main --port 0`` in a
    fresh child process, at D1's exact shape (1,048,576 nodes, 32,768 pods,
    batch 4096, depth 2, 5%, packed, ``--stats --encode-profile``); 17b adds
    ``--churn --stress-watchers 100 --stress-write-concurrency 1`` at
    262,144 nodes.  Every
    pod bound once (17b: every pod not deleted), the base stage launched in
    the window, the stressor's report read back with no failed stream and
    every write delivered to every watcher, and the server and the stressor
    gone afterwards."""
    from k8s1m_tpu_torch.store.server_main import serve_subprocess
    from k8s1m_tpu_torch.tools import sched_bench

    over = _d1_over(pods=COORD_PODS["D1"], stats=True, encode_profile=True)
    if config == "17b":
        over.update(nodes=WIRE_CONFIG5_NODES, churn=True, stress_watchers=WIRE_STRESS_WATCHERS,
                    stress_write_concurrency=WIRE_STRESS_WRITERS)
    t0 = time.perf_counter()
    with serve_subprocess() as (proc, target):
        report, coord, store = sched_bench.run(_bench_args(target=target, **over))
        try:
            d = report["detail"]
            pods = over["pods"]
            if config == "17b":
                check(d["bound"] + 1 == pods, f"[17b] {d['bound']} binds + 1 warm-up != {pods}")
                check(d["deleted"] > 0, "[17b] churn deleted no pod")
                # The last deletes' events reach the mirror, and the rows
                # they freed the device table, before the checks.
                sched_bench._settle(coord)
                coord.run_until_idle()
                _store_checks(config, coord, store, pods - d["deleted"])
            else:
                _coordinator_checks(config, report, coord, store, pods)
            report["relist_s"] = _time_relist(store, over["nodes"])
        finally:
            coord.close()
            store.close()
    check(proc.returncode is not None, f"[{config}] the store server is still running")
    launches = d["launches"]
    check(launches["fused_topk_by_stage"]["base"] > 0,
          f"[{config}] no fused base-stage launch in the window: {launches}")
    _log_report(config, report, t0)
    log(f"[{config}] over the wire: node write {d['node_create_s']} s, cold build "
        f"{d['cold_build_s']} s (bootstrap {d['bootstrap_s']} s), relist "
        f"{report['relist_s']} s, fused base launches {launches['fused_topk_by_stage']['base']}")
    log(f"[{config}] encode_profile: {json.dumps(d.get('encode_profile'))}")
    if config == "17b":
        ws = d.get("watch_stress")
        check(ws is not None and d["watch_stress_rc"] is not None,
              f"[17b] no report from the stressor: {ws}")
        check(ws["watchers"] == WIRE_STRESS_WATCHERS and ws["stream_errors"] == 0,
              f"[17b] stressor streams failed: {ws}")
        check(ws["writes"] > 0 and ws["events_delivered"] == ws["watchers"] * ws["writes"],
              f"[17b] not every write reached every watcher: {ws}")
        log(f"[17b] watch stress: {json.dumps(ws)} (exit code {d['watch_stress_rc']})")
    return report


# 17c: the per-RPC path of each server: sequential single Puts from the
# Python client, timed one by one, and pipelined Puts from the native stress
# client (64 in flight on one connection).
WIRE_PROBE_PUTS, WIRE_STRESS_PUTS = 2000, 5000


def _put_probe(store, target: str, pipelined: bool = True) -> dict:
    """``WIRE_PROBE_PUTS`` sequential single ``Put``s of a 256-byte value
    through ``store`` (a ``RemoteStore``), each timed on the host clock (p50
    and p99 in ms), then (``pipelined``) ``WIRE_STRESS_PUTS`` pipelined ones
    from ``wire_stress_put`` (puts/s; the native client speaks plaintext)."""
    from k8s1m_tpu_torch.store.native import wire_stress_put

    lat = []
    value = b"v" * 256
    for i in range(WIRE_PROBE_PUTS):
        t0 = time.perf_counter()
        store.put(b"/registry/leases/probe/%06d" % i, value)
        lat.append(time.perf_counter() - t0)
    lat = np.asarray(lat) * 1e3
    out = {"put_p50_ms": round(float(np.percentile(lat, 50)), 4),
           "put_p99_ms": round(float(np.percentile(lat, 99)), 4)}
    if not pipelined:
        return out
    host, _, port = target.rpartition(":")
    n, elapsed = wire_stress_put(host, int(port), WIRE_STRESS_PUTS, concurrency=64,
                                 prefix="/registry/leases/stress/", key_count=1000,
                                 val_len=256)
    check(n == WIRE_STRESS_PUTS, f"the stress client completed {n} of {WIRE_STRESS_PUTS} puts")
    return {**out, "stress_puts_per_s": round(n / elapsed, 1)}


def _range_encode_probe(store) -> dict:
    """The asyncio server's answer to a relist of the whole fleet as one
    RangeResponse, encoded both ways on this host from the same KVs:
    ``etcd_server.range_response_bytes`` (what Range sends: no message per
    KV) and the codec's messages (``RangeResponse(kvs=[KeyValue(...)])``);
    the bytes must be equal.  Seconds of each, best of 2."""
    from k8s1m_tpu_torch.control.coordinator import NODES_PREFIX
    from k8s1m_tpu_torch.store import etcd_server
    from k8s1m_tpu_torch.store.native import list_prefix
    from k8s1m_tpu_torch.store.proto import codec as pb

    kvs, rev = list_prefix(store, NODES_PREFIX)
    check(len(kvs) == PARITY_NODES, f"[17c] listed {len(kvs)} nodes, want {PARITY_NODES}")
    header = pb.ResponseHeader(cluster_id=1, member_id=1, revision=rev, raft_term=1)
    ways = {
        "composed": lambda: etcd_server.range_response_bytes(header, kvs, False, 0),
        "messages": lambda: pb.RangeResponse(
            header=header, kvs=[etcd_server._kv_to_pb(kv) for kv in kvs]).encode(),
    }
    got, seconds = {}, {}
    for name, encode in ways.items():
        seconds[name] = float("inf")
        for _ in range(2):
            t0 = time.perf_counter()
            got[name] = encode()
            seconds[name] = min(seconds[name], time.perf_counter() - t0)
    check(got["composed"] == got["messages"],
          "[17c] the composed RangeResponse differs from the codec's messages")
    return {"range_encode_composed_s": round(seconds["composed"], 4),
            "range_encode_messages_s": round(seconds["messages"], 4),
            "range_encode_bytes": len(got["composed"])}


def _wire_parity_run(device: str, wire: bool, server: str = "native", probe: bool = False
                     ) -> tuple[dict, float, dict, dict]:
    """17a / 17c member: a ``Coordinator`` driven directly over a
    ``RemoteStore`` to a fresh ``server_main --wire <server>`` child process
    (``wire``) or over the in-process store, at 8a's uniform shape; pods
    written one batch at a time, and before every ``step()`` a watch
    progress barrier (over the wire) puts every event up to the store's
    revision in the coordinator's queue.  Returns the stored pod values, the
    seconds, the launches and (``probe``, over the wire) the probes: the
    relist seconds and ``_put_probe``'s figures, and over the asyncio server
    ``_range_encode_probe``'s."""
    from k8s1m_tpu_torch.faultline import RetryPolicy
    from k8s1m_tpu_torch.config import PodSpec, TableSpec
    from k8s1m_tpu_torch.control.coordinator import Coordinator
    from k8s1m_tpu_torch.plugins.registry import Profile
    from k8s1m_tpu_torch.store.native import MemStore
    from k8s1m_tpu_torch.store.remote import RemoteStore
    from k8s1m_tpu_torch.store.server_main import serve_subprocess
    from k8s1m_tpu_torch.tools import sched_bench

    tag = (f"17c {device} asyncio wire" if server == "asyncio"
           else f"17a {device} {'wire' if wire else 'in-process'}")
    t0 = time.perf_counter()
    probes: dict = {}
    child = (serve_subprocess("--wire", server) if wire
             else contextlib.nullcontext((None, None)))
    with child as (proc, target):
        store = RemoteStore(target) if wire else MemStore()
        try:
            sched_bench.write_nodes(store, PARITY_NODES)
            coord = Coordinator(
                store, TableSpec(max_nodes=PARITY_NODES), PodSpec(batch=BATCH),
                Profile(node_affinity=0, topology_spread=0, interpod_affinity=0),
                chunk=CHUNK, with_constraints=False, pipeline=True, depth=2,
                score_pct=SCORE_PCT, packing="packed", device=device,
                retry_policy=RetryPolicy(**_ZERO_DELAY))
            coord.bootstrap()
            values, keys, _strs = sched_bench._pod_values(_bench_args(pods=PARITY_PODS))
            _reset_launches()

            def step() -> int:
                sched_bench._settle(coord)
                return coord.step()

            for off in range(0, PARITY_PODS, BATCH):
                store.put_batch(list(zip(keys[off:off + BATCH], values[off:off + BATCH])))
                step()
            idle = 0
            for _ in range(1000):
                step()
                idle = 0 if coord.queue or coord._inflights or coord._backoff else idle + 1
                if idle > 1:
                    break
            launches = _launch_counts()
            stored = _store_checks(tag, coord, store, PARITY_PODS)
            coord.close()
            seconds = time.perf_counter() - t0
            if probe and wire:
                probes = {"relist_s": _time_relist(store, PARITY_NODES),
                          **_put_probe(store, target)}
                if server == "asyncio":
                    probes.update(_range_encode_probe(store))
        finally:
            store.close()
    check(proc is None or proc.returncode is not None, f"[{tag}] the store server is running")
    return stored, seconds, launches, probes


def phase_wire_parity() -> dict:
    """17a: 8a's uniform shape (65,536 nodes x 8,192 pods, 5%, packed,
    chunk 4096, zero-delay retries) through a ``Coordinator`` stepped with a
    barrier before every step, on the card over the wire, on the card
    in-process and on the CPU over the wire: byte-identical stored pods."""
    runs = []
    for device, wire in (("cuda", True), ("cuda", False), ("cpu", True)):
        stored, seconds, launches, probes = _wire_parity_run(
            device, wire, probe=device == "cuda")
        runs.append((f"{device} {'wire' if wire else 'in-process'}", stored, seconds, launches,
                     probes))
    for tag, stored, _s, _l, _p in runs[1:]:
        check(stored == runs[0][1], f"[17a] {tag} stored pod values differ from {runs[0][0]}")
    check(runs[0][3]["fused_topk_by_stage"]["base"] > 0, f"[17a] no base launch: {runs[0][3]}")
    log("[17a] " + ", ".join(f"{t} ({s:.1f}s)" for t, _st, s, _l, _p in runs)
        + f" left byte-identical pod values ({len(runs[0][1])} pods); card launches "
        f"wire {runs[0][3]['fused_topk_by_stage']['base']}, in-process "
        f"{runs[1][3]['fused_topk_by_stage']['base']}")
    out = {tag: {"seconds": round(s, 3), "launches": launches, **probes}
           for tag, _st, s, launches, probes in runs}
    return out, runs[0][1]


def phase_wire_asyncio(native_stored: dict) -> dict:
    """17c: 17a's card run over the port's asyncio etcd server
    (``server_main --wire asyncio``, gRPC in Python, no grpcio) in a fresh
    child: the stored pod values byte-identical to 17a's card run over the
    native wire (``native_stored``, not run again), every pod bound once, at
    least one base launch, the child gone after close.  Prints the run's
    seconds, the relist seconds, ``_put_probe``'s and
    ``_range_encode_probe``'s figures over the asyncio server
    (``_log_wire_probes`` sets the first two beside the native wire's)."""
    t0 = time.perf_counter()
    stored, seconds, launches, probes = _wire_parity_run("cuda", True, "asyncio", probe=True)
    check(stored == native_stored,
          "[17c] stored pod values over the asyncio server differ from 17a's native wire")
    check(launches["fused_topk_by_stage"]["base"] > 0, f"[17c] no base launch: {launches}")
    log(f"[17c] coordinator on the card over the asyncio server: {seconds:.1f}s, "
        f"{len(stored)} pods byte-identical to the native wire's, base launches "
        f"{launches['fused_topk_by_stage']['base']}; relist {probes['relist_s']} s, "
        f"put p50/p99 {probes['put_p50_ms']}/{probes['put_p99_ms']} ms, pipelined "
        f"{probes['stress_puts_per_s']} puts/s; the relist's RangeResponse "
        f"({probes['range_encode_bytes']} bytes) encoded composed in "
        f"{probes['range_encode_composed_s']} s, as messages in "
        f"{probes['range_encode_messages_s']} s ({time.perf_counter() - t0:.1f}s)")
    return {"seconds": round(seconds, 3), "launches": launches, **probes}


def _log_wire_probes(runs: dict) -> None:
    """The per-RPC figures of 17a's native-wire and 17c's asyncio runs side
    by side, with the card's name and power limit."""
    native, asy = runs["17a cuda wire"], runs["17c"]
    log(f"[17c] per-RPC over the wire on this host ({_smi_stamp()}): put p50 native "
        f"{native['put_p50_ms']} ms, asyncio {asy['put_p50_ms']} ms "
        f"({asy['put_p50_ms'] / native['put_p50_ms']:.2f}x); pipelined native "
        f"{native['stress_puts_per_s']} puts/s, asyncio {asy['stress_puts_per_s']} puts/s "
        f"({native['stress_puts_per_s'] / asy['stress_puts_per_s']:.1f}x); relist of "
        f"{PARITY_NODES} nodes native {native['relist_s']} s, asyncio {asy['relist_s']} s")


# ---- phase 17d: the coordinator behind the secured watch-cache tier -----------

# 17d: 100 client watches on the pods prefix through the tier (as 17b's
# stressor), counting every pod event; the tier's lag budget sized so that
# 101 watchers' full backlog of 8a's pod events stays FIFO (no latest-only
# coalescing: the gate counts every event at every watch).  This departs
# from the deployed tier, which the JAX harness starts at the default of
# 4,096: the card never runs that setting's latest-only coalescing and its
# HealthController shedding, which tests/test_torch_watch_cache.py holds
# against the JAX tier on the CPU.
TIER_WATCHERS = 100
TIER_LAG_BUDGET = 1 << 16


def _tier_metrics(port: int) -> dict:
    """The tier's ``watchcache_*`` samples from its ``/metrics``."""
    import urllib.request

    text = urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=30).read()
    out = {}
    for line in text.decode().splitlines():
        if line.startswith("watchcache_") and " " in line:
            name, value = line.rsplit(" ", 1)
            out[name] = float(value)
    return out


def _tier_settle(coord, upstream) -> None:
    """A watch progress barrier at the store's revision: each of the
    coordinator's watches (through the tier) answers progress until the
    tier's cache has reached every write the store has taken."""
    rev = upstream.current_revision
    for w in (coord._nodes_watch, coord._pods_watch):
        for _ in range(10000):
            got = w.progress()
            check(got is not None, "[17d] a coordinator watch through the tier ended")
            if got >= rev:
                break
            time.sleep(0.001)
        else:
            raise AssertionError(f"[17d] the tier never reached revision {rev}")


def _tier_auth_checks(target: str, certs, token: str) -> list:
    """A call with a wrong token ends UNAUTHENTICATED with the tier's
    message; a client trusting another CA, and a plaintext client, fail
    before any call."""
    import tempfile

    from k8s1m_tpu_torch.cluster.certs import provision
    from k8s1m_tpu_torch.store.proto import codec as pb
    from k8s1m_tpu_torch.store.wire import Channel, StatusCode, WireError

    rng = pb.RangeRequest(key=b"/registry/pods/", range_end=b"/registry/pods0",
                          count_only=True)
    seen = []
    with tempfile.TemporaryDirectory() as other_dir:
        for what, kw, want in (
                ("wrong token", dict(ca_pem=certs.ca_pem, token=token + "x"),
                 StatusCode.UNAUTHENTICATED),
                ("another CA", dict(ca_pem=provision(other_dir).ca_pem, token=token),
                 StatusCode.UNAVAILABLE),
                ("plaintext", dict(token=token), StatusCode.UNAVAILABLE)):
            ch = Channel(target, **kw)
            try:
                ch.unary("/etcdserverpb.KV/Range", rng.encode())
                raise AssertionError(f"[17d] a call with {what} went through")
            except WireError as e:
                check(e.code == want, f"[17d] {what}: {e}, want {want.name}")
                if what == "wrong token":
                    check(e.details == "invalid or missing bearer token", f"[17d] {e}")
                if what == "another CA":
                    check("CERTIFICATE_VERIFY_FAILED" in str(e), f"[17d] {what}: {e}")
                seen.append(f"{what}: {e}")
            finally:
                ch.close()
    return seen


def phase_tier(native_stored: dict, native_relist_s: float, device: str = "cuda") -> dict:
    """17d: D1's deployed topology behind the secured watch-cache tier.
    ``server_main`` (native wire) in a child; 8a's 65,536 nodes written to
    it; then ``python -m k8s1m_tpu_torch.store.watch_cache --prefix
    /registry/ --tls-cert --tls-key --auth-token --metrics-port`` in a
    second child (it primes the whole ``/registry/`` before its port binds),
    as the JAX harness deploys it but for ``--lag-budget TIER_LAG_BUDGET``
    in place of the deployed default (so the deployed latest-only
    coalescing is not run here); ``TIER_WATCHERS`` watches on
    ``/registry/pods/`` from ``watch_stress --writes 0 --ca-pem --token`` in
    a third; and 17a's card run through ``RemoteStore(ca_pem=, token=)`` to
    the tier, a progress barrier at the store's revision before every step.
    Gates: stored pods byte-identical to 17a's native-wire run
    (``native_stored``); the tier takes each store event once
    (``watchcache_events_in_total`` == the store's revisions in the window)
    and hands it to every watch (``watchcache_events_delivered_total`` ==
    events x the stressor's watches + the coordinator's pod watch); every
    stress watch saw every pod event, 0 stream errors; a wrong token gets
    ``UNAUTHENTICATED`` and a client without the CA fails its handshake;
    every child reaped.  Prints the prime s, the relist through the tier
    against 17a's, put p50 through the tier, binds/s and base launches."""
    import re
    import secrets
    import signal
    import tempfile

    from k8s1m_tpu_torch.cluster.certs import provision
    from k8s1m_tpu_torch.config import PodSpec, TableSpec
    from k8s1m_tpu_torch.control.coordinator import Coordinator
    from k8s1m_tpu_torch.faultline import RetryPolicy
    from k8s1m_tpu_torch.plugins.registry import Profile
    from k8s1m_tpu_torch.store.remote import RemoteStore
    from k8s1m_tpu_torch.store.server_main import child_env, serve_subprocess
    from k8s1m_tpu_torch.store.watch_cache import _LAG_BUDGET as deployed_lag_budget
    from k8s1m_tpu_torch.store.watch_cache import tier_subprocess
    from k8s1m_tpu_torch.tools import sched_bench

    t0 = time.perf_counter()
    token = secrets.token_hex(16)
    mport = _free_port()
    root, env = child_env()
    log_path = os.path.join(OUT_DIR, "tier_17d.log")
    stress = None
    with tempfile.TemporaryDirectory() as cert_dir, serve_subprocess() as (sproc, upstream):
        certs = provision(cert_dir)
        up = RemoteStore(upstream)
        try:
            sched_bench.write_nodes(up, PARITY_NODES)
            with open(log_path, "w") as tier_log, tier_subprocess(
                    upstream, "--prefix", "/registry/", "--tls-cert", certs.cert_pem,
                    "--tls-key", certs.key_pem, "--auth-token", token, "--metrics-port",
                    str(mport), "--lag-budget", str(TIER_LAG_BUDGET), stderr=tier_log,
                    timeout_s=30.0 + PARITY_NODES / 5000.0) as (tproc, target):
                # The tier logs its ready line just after its port binds.
                for _ in range(3000):
                    with open(log_path) as f:
                        ready = f.read()
                    m = re.search(r"primed (\d+) objects at revision (\d+) in ([0-9.]+) s",
                                  ready)
                    if m is not None:
                        break
                    time.sleep(0.01)
                check(m is not None and int(m.group(1)) >= PARITY_NODES,
                      f"[17d] the tier's ready line: {ready[-500:]!r}")
                prime_s = float(m.group(3))
                with open(os.path.join(OUT_DIR, "tier_17d_stress.log"), "w") as err:
                    stress = subprocess.Popen(
                        [sys.executable, "-m", "k8s1m_tpu_torch.tools.watch_stress", "--target",
                         target, "--watchers", str(TIER_WATCHERS), "--writes", "0", "--prefix",
                         "/registry/pods/", "--expect-events", str(2 * PARITY_PODS),
                         "--ca-pem", certs.ca_pem, "--token", token],
                        stdout=subprocess.PIPE, stderr=err, text=True, env=env, cwd=root)
                for _ in range(6000):
                    if _tier_metrics(mport).get("watchcache_watchers", 0) >= TIER_WATCHERS:
                        break
                    check(stress.poll() is None, "[17d] the stressor exited early")
                    time.sleep(0.01)
                store = RemoteStore(target, ca_pem=certs.ca_pem, token=token)
                try:
                    coord = Coordinator(
                        store, TableSpec(max_nodes=PARITY_NODES), PodSpec(batch=BATCH),
                        Profile(node_affinity=0, topology_spread=0, interpod_affinity=0),
                        chunk=CHUNK, with_constraints=False, pipeline=True, depth=2,
                        score_pct=SCORE_PCT, packing="packed", device=device,
                        retry_policy=RetryPolicy(**_ZERO_DELAY))
                    coord.bootstrap()
                    values, keys, _strs = sched_bench._pod_values(_bench_args(pods=PARITY_PODS))
                    _tier_settle(coord, up)
                    m0, rev0 = _tier_metrics(mport), up.current_revision
                    _reset_launches()
                    t_run = time.perf_counter()
                    for off in range(0, PARITY_PODS, BATCH):
                        store.put_batch(list(zip(keys[off:off + BATCH], values[off:off + BATCH])))
                        _tier_settle(coord, up)
                        coord.step()
                    idle = 0
                    for _ in range(1000):
                        _tier_settle(coord, up)
                        coord.step()
                        idle = 0 if coord.queue or coord._inflights or coord._backoff else idle + 1
                        if idle > 1:
                            break
                    run_s = time.perf_counter() - t_run
                    launches = _launch_counts()
                    _tier_settle(coord, up)
                    m1, rev1 = _tier_metrics(mport), up.current_revision
                    stored = _store_checks("17d", coord, store, PARITY_PODS)
                    coord.close()
                    stress.send_signal(signal.SIGTERM)
                    out, _ = stress.communicate(timeout=120)
                    ws = json.loads(out.strip().splitlines()[-1])
                    relist_s = _time_relist(store, PARITY_NODES)
                    probe = _put_probe(store, target, pipelined=False)
                finally:
                    store.close()
                auth = _tier_auth_checks(target, certs, token)
        finally:
            up.close()
            if stress is not None and stress.poll() is None:
                stress.kill()
                stress.wait()
    check(sproc.returncode is not None and tproc.returncode is not None
          and stress.returncode is not None, "[17d] a child is still running")
    check(stored == native_stored,
          "[17d] stored pod values through the tier differ from 17a's native wire")
    check(launches["fused_topk_by_stage"]["base"] > 0, f"[17d] no base launch: {launches}")
    # A counter renders no sample until its first increment.
    events_in = (m1.get("watchcache_events_in_total", 0.0)
                 - m0.get("watchcache_events_in_total", 0.0))
    delivered = (m1.get("watchcache_events_delivered_total", 0.0)
                 - m0.get("watchcache_events_delivered_total", 0.0))
    check(events_in == rev1 - rev0 == 2 * PARITY_PODS,
          f"[17d] events in {events_in}, store revisions {rev1 - rev0}, "
          f"want {2 * PARITY_PODS} (each pod's create and bind, once)")
    check(delivered == events_in * (TIER_WATCHERS + 1),
          f"[17d] delivered {delivered}, want {events_in} x {TIER_WATCHERS + 1} watches")
    check(m1.get("watchcache_coalesced_events_total", 0) == 0
          and m1.get("watchcache_invalidations_total", 0) == 0,
          f"[17d] coalesced or invalidated: {m1}")
    check(ws["watchers"] == TIER_WATCHERS and ws["stream_errors"] == 0
          and ws["per_watcher_min"] == ws["per_watcher_max"] == events_in,
          f"[17d] not every stress watch saw every pod event: {ws}")
    binds_per_s = PARITY_PODS / run_s
    log(f"[17d] coordinator on the card behind the secured tier (TLS + bearer, "
        f"{TIER_WATCHERS} watches from watch_stress, --lag-budget {TIER_LAG_BUDGET}: the "
        f"deployed default {deployed_lag_budget} and its latest-only coalescing not run on "
        f"the card): {len(stored)} pods byte-identical to 17a's "
        f"native wire, {binds_per_s:.1f} binds/s over {run_s:.2f} s, base launches "
        f"{launches['fused_topk_by_stage']['base']}; tier prime {prime_s:.3f} s "
        f"({m.group(1)} objects), relist through the tier {relist_s} s (17a native "
        f"{native_relist_s} s), put p50/p99 through the tier {probe['put_p50_ms']}/"
        f"{probe['put_p99_ms']} ms; events in {events_in:.0f} (one upstream stream), "
        f"delivered {delivered:.0f}, each stress watch {ws['per_watcher_min']}; "
        f"{'; '.join(auth)} ({time.perf_counter() - t0:.1f}s)")
    return {"seconds": round(time.perf_counter() - t0, 3), "launches": launches,
            "prime_s": prime_s, "relist_s": relist_s, "binds_per_s": round(binds_per_s, 1),
            "run_s": round(run_s, 3), **probe, "events_in": events_in,
            "events_delivered": delivered, "watch_stress": ws}


# ---- phases 18, 18a: the shard set --------------------------------------------

# 18: shard_bench with 1, 2 and 4 worker processes, each on the card
# (BASELINE config 1's shape: D1's batch and 5% window), at 65,536 nodes
# x 8,192 pods: cut from 1,048,576 x 32,768, then from 262,144 nodes, then
# (for phases 17d and 21-21a) from 131,072 x 16,384, to keep the script
# well inside its 1,200 s limit.
SHARD_NODES, SHARD_PODS, SHARD_COUNTS = NODES // 16, 8192, (1, 2, 4)
# 18a: three ShardMembers on one in-process store at 8a's node count; 4,096
# pods in 4 rounds of 1,024, the Rebalancer run after round 2 over a skewed
# start (groups by g % 8: 0-4 on shard 0, 5-6 on shard 1, 7 on shard 2).
SHARD_PARITY_MEMBERS, SHARD_PARITY_ROUNDS, SHARD_PARITY_PER = 3, 4, 1024


def _shard_ownership(tag: str, kvs, asg, shards: int) -> int:
    """Every stored pod bound, on a node whose group ``asg`` gives to the
    pod's FNV shard; returns the pods read."""
    from k8s1m_tpu_torch.control.shardset import group_of, pod_shard

    for kv in kvs:
        pod = json.loads(kv.value)
        node = pod["spec"].get("nodeName")
        key = f"{pod['metadata']['namespace']}/{pod['metadata']['name']}"
        check(node is not None, f"[{tag}] {key} was left unbound")
        check(asg.groups[group_of(node)] == pod_shard(key, shards),
              f"[{tag}] {key} bound to {node}, group {group_of(node)} of shard "
              f"{asg.groups[group_of(node)]}, not of its shard {pod_shard(key, shards)}")
    return len(kvs)


def phase_shards() -> dict:
    """18: ``tools/shard_bench.py --nodes 262144 --pods 16384 --batch 4096
    --score-pct 5`` with 1, 2 and 4 worker processes, each on ``cuda``, each
    count against a fresh ``python -m k8s1m_tpu_torch.store.server_main``.
    Every pod bound exactly once (the workers' binds sum to the pods, each
    worker binds its FNV share), every worker done and exited 0, every stored
    pod on a node its shard owns in the final assignment, server and workers
    reaped."""
    from k8s1m_tpu_torch.control.shardset import load_assignment
    from k8s1m_tpu_torch.store.native import list_prefix
    from k8s1m_tpu_torch.store.remote import RemoteStore
    from k8s1m_tpu_torch.store.server_main import serve_subprocess
    from k8s1m_tpu_torch.tools import shard_bench

    runs = {}
    for shards in SHARD_COUNTS:
        tag = f"18 x{shards}"
        t0 = time.perf_counter()
        with serve_subprocess() as (proc, target):
            out = shard_bench.main([
                "--target", target, "--nodes", str(SHARD_NODES), "--pods", str(SHARD_PODS),
                "--shards", str(shards), "--batch", str(BATCH),
                "--score-pct", str(SCORE_PCT), "--device", "cuda"])
            t_read = time.perf_counter()
            with RemoteStore(target) as store:
                kvs, _rev = list_prefix(store, b"/registry/pods/")
                asg = load_assignment(store)
            read_s = time.perf_counter() - t_read
        check(proc.returncode is not None, f"[{tag}] the store server is still running")
        workers = out["per_worker"]
        check(all(w is not None and w["done"] for w in workers),
              f"[{tag}] a worker did not finish: {workers}")
        check(out["worker_rcs"] == [0] * shards, f"[{tag}] worker exit codes {out['worker_rcs']}")
        check(sum(w["bound"] for w in workers) == SHARD_PODS == sum(out["pod_share"]),
              f"[{tag}] {sum(w['bound'] for w in workers)} binds for {SHARD_PODS} pods")
        check([w["bound"] for w in workers] == out["pod_share"],
              f"[{tag}] binds per worker {[w['bound'] for w in workers]} != shares "
              f"{out['pod_share']}")
        check(all(w["device"] == "cuda" for w in workers), f"[{tag}] a worker off the card")
        check(all(w["launches"]["fused_topk_by_stage"]["base"] > 0 for w in workers),
              f"[{tag}] a worker launched no base stage: {[w['launches'] for w in workers]}")
        # The warm-up pod of each worker is stored and bound too.
        read = _shard_ownership(tag, kvs, asg, shards)
        check(read == SHARD_PODS + shards, f"[{tag}] {read} pods stored, want "
              f"{SHARD_PODS} + {shards} warm-up")
        out["readback_s"] = round(read_s, 3)
        out["seconds"] = round(time.perf_counter() - t0, 3)
        runs[shards] = out
        log(f"[{tag}] {out['value']} binds/s over {out['window_s']} s "
            f"(x{out['value'] / runs[SHARD_COUNTS[0]]['value']:.3f} of 1 worker), populate "
            f"{out['populate_s']} s, workers ready {out['ready_s']} s, read back {read_s:.1f} s, "
            f"cores {out['cpu_count']} "
            f"(affinity {out['affinity_cpus']}), {out['seconds']} s in all")
        for w in workers:
            log(f"[{tag}] worker {w['worker']}: bound {w['bound']}, p50/p99 {w['p50_ms']}/"
                f"{w['p99_ms']} ms, conflicts {w['conflicts']}, waves {w['waves']}, stage "
                f"means {w['stage_means_ms']} ms, peak card "
                f"{w['peak_card_mb']} MB, peak RSS {w['peak_rss_mb']} MB, mask_rows "
                f"{w['mask_rows_ms']} ms / {w['mask_rows_bytes'] / 2**20:.2f} MB new, "
                f"launches {w['launches']['fused_topk_by_stage']}")
    return runs


def _shard_parity_run(device: str) -> dict:
    """18a member: three ``ShardMember``s over one in-process ``MemStore`` at
    65,536 nodes (5%, chunk 4096, zero-delay retries), pods written in rounds
    and every member ticked once per round on a virtual clock, the
    ``Rebalancer`` evening out a skewed assignment after round 2; after every
    tick the masks are disjoint and every pod the tick bound sits on a row its
    member owned when the wave launched.  Returns the stored pods, seconds,
    launches and the rebalance's counts."""
    from k8s1m_tpu_torch.config import PodSpec, TableSpec
    from k8s1m_tpu_torch.control.coordinator import Coordinator
    from k8s1m_tpu_torch.control.shardset import (
        ASSIGN_KEY, NUM_GROUPS, Assignment, Rebalancer, ShardMember, load_assignment,
        pod_shard)
    from k8s1m_tpu_torch.faultline import RetryPolicy
    from k8s1m_tpu_torch.plugins.registry import Profile
    from k8s1m_tpu_torch.store.native import MemStore
    from k8s1m_tpu_torch.tools import sched_bench

    tag, n = f"18a {device}", SHARD_PARITY_MEMBERS
    t0 = time.perf_counter()
    store = MemStore()
    members = []
    try:
        sched_bench.write_nodes(store, PARITY_NODES)
        skew = [0 if g % 8 < 5 else 1 if g % 8 < 7 else 2 for g in range(NUM_GROUPS)]
        store.cas(ASSIGN_KEY, Assignment(1, n, skew).encode(), required_version=0)
        for i in range(n):
            coord = Coordinator(
                store, TableSpec(max_nodes=PARITY_NODES), PodSpec(batch=BATCH),
                Profile(node_affinity=0, topology_spread=0, interpod_affinity=0),
                chunk=CHUNK, with_constraints=False, score_pct=SCORE_PCT, device=device,
                retry_policy=RetryPolicy(**_ZERO_DELAY))
            members.append(ShardMember(store, coord, i, n))
        for m in members:
            m.start(now=0.0)
        owned0 = [int(m.coordinator._row_mask_np.sum()) for m in members]
        reb = Rebalancer(store, members[0].coordinator.host, n, min_interval=0.0,
                         max_moves=NUM_GROUPS, dead_after=60.0)
        values, keys, _strs = sched_bench._pod_values(
            _bench_args(pods=SHARD_PARITY_ROUNDS * SHARD_PARITY_PER))
        _reset_launches()
        now, binds = 0.0, 0

        def tick_all() -> int:
            nonlocal now
            now += 1.0
            bound = 0
            for i, m in enumerate(members):
                coord = m.coordinator
                mask = coord._row_mask_np.copy()
                before = set(coord._bound)
                bound += m.tick(now)
                for key in coord._bound.keys() - before:
                    if pod_shard(key, n) != i:
                        continue                  # another shard's bind, observed
                    row = coord.host.row_of(coord._bound[key][0])
                    check(mask[row], f"[{tag}] member {i} bound {key} on row {row} it "
                          "did not own at launch")
            masks = [m.coordinator._row_mask_np for m in members]
            for a in range(n):
                for b in range(a + 1, n):
                    check(not (masks[a] & masks[b]).any(), f"[{tag}] masks {a}, {b} overlap")
            return bound

        for r in range(SHARD_PARITY_ROUNDS):
            off = r * SHARD_PARITY_PER
            store.put_batch(list(zip(keys[off:off + SHARD_PARITY_PER],
                                     values[off:off + SHARD_PARITY_PER])))
            binds += tick_all()
            if r == SHARD_PARITY_ROUNDS // 2 - 1:
                check(reb.run_once(now=now, force=True), f"[{tag}] the rebalancer moved nothing")
        for _ in range(200):
            got = tick_all()
            binds += got
            if got == 0 and all(not m.coordinator.queue and not m.coordinator._inflights
                                and not m.coordinator._backoff for m in members):
                break
        launches = _launch_counts()
        asg = load_assignment(store)
        owned = [int(m.coordinator._row_mask_np.sum()) for m in members]
        stored = _stored_pods(store)
    finally:
        for m in members:
            m.close()
        store.close()
    total = SHARD_PARITY_ROUNDS * SHARD_PARITY_PER
    check(binds == total, f"[{tag}] {binds} binds for {total} pods")
    check(len(stored) == total and all(b'"nodeName"' in v for v in stored.values()),
          f"[{tag}] {len(stored)} pods stored, not all bound")
    check(asg.version == 2 and sum(owned) == PARITY_NODES, f"[{tag}] assignment "
          f"v{asg.version}, owned {owned}")
    check(max(owned) - min(owned) < min(owned0), f"[{tag}] not evened out: {owned0} -> {owned}")
    return {"stored": stored, "seconds": time.perf_counter() - t0, "launches": launches,
            "owned_before": owned0, "owned_after": owned}


def phase_shard_parity(cpu_half=None) -> dict:
    """18a: ``_shard_parity_run`` on the card and, concurrently in a child
    process (``cpu_half``, from ``_start_cpu_half``, or a new one), on the
    CPU: both pass their checks, and the stored pods are byte-identical."""
    card, cpu = _card_and_cpu("18a", "_shard_parity_run", children=cpu_half)
    _same_stored("18a", "card and CPU stored pod values", card["stored"], cpu["stored"])
    check(card["launches"]["fused_topk_by_stage"]["base"] > 0,
          f"[18a] no base launch: {card['launches']}")
    log(f"[18a] 3 members at {PARITY_NODES:,} nodes, {card['stored']['entries']} pods, owned "
        f"nodes {card['owned_before']} -> {card['owned_after']} after the rebalance: card "
        f"({card['seconds']:.1f}s) and CPU ({cpu['seconds']:.1f}s, concurrently) "
        f"byte-identical; card "
        f"launches {card['launches']['fused_topk_by_stage']}")
    return {dev: {"seconds": round(r["seconds"], 3), "launches": r["launches"],
                  "owned_before": r["owned_before"], "owned_after": r["owned_after"]}
            for dev, r in (("cuda", card), ("cpu", cpu))}


# ---- phases 19, 19a: the reference's experiment through the load tools -------

# 19: the reference's 1M-node experiment (SURVEY §3.5; reference README's
# make_nodes / make_pods procedure) over the wire, cut to 262,144 nodes for
# the 1,200 s limit, then to 131,072 (and the Python store-stress lane from
# 10,000 puts and 1,000 ranges to 5,000 and 500) for phases 17d and 21-21a,
# then to 65,536 for phases 22-22b:
# make_nodes in 1,024-node PutFrames, make_pods at 8,192
# per-put RPCs (cut from D1's 32,768 for the same limit; the tools' defaults,
# --concurrency 100 --clients 4), a coordinator at D1's batch and window
# binding them, the KWOK controller of group 0, the lease flood and the store
# stress (native and Python lanes), count-ready, a /metrics scrape and
# delete_pods.  19a: the same flow at 32,768 nodes with 2,048 pods, all
# ten KWOK groups and one client at a time, coordinator on the card and on
# the CPU.
EXP_NODES, EXP_PODS, EXP_BULK = NODES // 16, COORD_PODS["D1"] // 4, 1024
EXP_NATIVE_PUTS, EXP_PY_PUTS, EXP_PY_RANGES = 200_000, 5_000, 500
EXP_PARITY_NODES, EXP_PARITY_PODS = PARITY_NODES // 2, 2048
EXP_TICKS = (10.0, 20.0)
EXP_LEASES = b"/registry/leases/kube-node-lease/"


def _tool_child(tag: str, name: str, argv: list) -> dict:
    """``python -m k8s1m_tpu_torch.tools.<name> argv`` in a child process from
    the repository root: it must exit 0; returns its last stdout line (JSON)
    with the child's own seconds, start-up included, as ``child_s``."""
    from k8s1m_tpu_torch.store.server_main import child_env

    root, env = child_env()
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", f"k8s1m_tpu_torch.tools.{name}", *argv],
                          capture_output=True, text=True, env=env, cwd=root, timeout=900)
    check(proc.returncode == 0,
          f"[{tag}] {name} exited {proc.returncode}: {proc.stderr[-2000:]}{proc.stdout[-500:]}")
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    out["child_s"] = round(time.perf_counter() - t0, 3)
    return out


def _tool_inproc(tag: str, name: str, argv: list) -> dict:
    """The tool's own entry (``amain(parse_args(argv))``) in this process."""
    import asyncio
    import importlib

    mod = importlib.import_module(f"k8s1m_tpu_torch.tools.{name}")
    t0 = time.perf_counter()
    out = asyncio.run(mod.amain(mod.parse_args(argv)))
    out["child_s"] = round(time.perf_counter() - t0, 3)
    return out


def _prefix_count(store, prefix: bytes) -> int:
    from k8s1m_tpu_torch.store.native import prefix_end

    return store.range(prefix, prefix_end(prefix), count_only=True).count


def _prefix_dump(store, prefix: bytes) -> dict:
    from k8s1m_tpu_torch.store.native import list_prefix

    kvs, _rev = list_prefix(store, prefix)
    return {kv.key: (kv.value, kv.mod_revision) for kv in kvs}


def _experiment(tag: str, device: str, target: str, *, nodes: int, pods: int, groups,
                load: list, run_tool, metrics_port: int = 0, parity: bool = False) -> dict:
    """One pass of the reference's experiment against the server at
    ``target``; ``load`` holds the tools' load flags.  Every step checked and
    timed; with ``parity`` the stored pods after binding and after the ticks
    and the lease values are returned for comparison."""
    from k8s1m_tpu_torch.cluster.kwok_controller import KwokController
    from k8s1m_tpu_torch.config import PodSpec, TableSpec
    from k8s1m_tpu_torch.control.coordinator import Coordinator
    from k8s1m_tpu_torch.faultline import RetryPolicy
    from k8s1m_tpu_torch.obs.metrics import REGISTRY
    from k8s1m_tpu_torch.plugins.registry import Profile
    from k8s1m_tpu_torch.store.remote import RemoteStore
    from k8s1m_tpu_torch.tools import verify_cluster

    res: dict = {"device": device, "nodes": nodes, "pods": pods, "steps_s": {}}
    base = ["--target", target, "--quiet", *load]

    def step(name, t0):
        res["steps_s"][name] = round(time.perf_counter() - t0, 3)

    def tool(name, argv):
        out = run_tool(tag, name, argv)
        log(f"[{tag}] {name}: {json.dumps(out)}")
        return out

    t0 = time.perf_counter()
    out = res["make_nodes"] = tool("make_nodes", base + ["--count", str(nodes),
                                                         "--bulk", str(EXP_BULK)])
    check(out["count"] == nodes and out["errors"] == 0, f"[{tag}] make_nodes: {out}")
    step("make_nodes", t0)
    store = RemoteStore(target)
    kstore = RemoteStore(target)
    try:
        t0 = time.perf_counter()
        gaps = verify_cluster.find_gaps(store)
        check(gaps == [], f"[{tag}] find-gaps: {gaps[:5]}")
        step("find_gaps", t0)
        t0 = time.perf_counter()
        out = res["make_pods"] = tool("make_pods", base + ["--count", str(pods)])
        check(out["count"] == pods and out["errors"] == 0, f"[{tag}] make_pods: {out}")
        step("make_pods", t0)

        t0 = time.perf_counter()
        coord = Coordinator(
            store, TableSpec(max_nodes=nodes), PodSpec(batch=BATCH),
            Profile(node_affinity=0, topology_spread=0, interpod_affinity=0),
            chunk=CHUNK, with_constraints=False, pipeline=True, depth=2,
            score_pct=SCORE_PCT, packing="packed", device=device,
            retry_policy=RetryPolicy(**_ZERO_DELAY))
        try:
            _reset_launches()
            coord.bootstrap()
            res["cold_build_s"] = round(time.perf_counter() - t0, 3)
            t1 = time.perf_counter()
            bound = coord.run_until_idle()
            bind_s = time.perf_counter() - t1
            res["launches"] = _launch_counts()
            check(bound == pods, f"[{tag}] {bound} binds, want {pods}")
            res["binds_per_sec"] = round(bound / bind_s, 1)
            stored = _store_checks(tag, coord, store, pods)
        finally:
            coord.close()
        step("schedule", t0)
        if device == "cuda":
            check(res["launches"]["fused_topk_by_stage"]["base"] > 0,
                  f"[{tag}] no fused base launch: {res['launches']}")
        if parity:
            res["bound_pods"] = _prefix_dump(store, b"/registry/pods/")
        owners = {}
        for v in stored.values():
            node = json.loads(v)["spec"]["nodeName"]
            g = int(node.rsplit("-", 1)[1]) % 10
            owners[g] = owners.get(g, 0) + 1
        want_started = sum(owners.get(g, 0) for g in groups)
        want_nodes = sum(1 for i in range(nodes) if i % 10 in groups)

        t0 = time.perf_counter()
        controllers = [KwokController(kstore, g) for g in groups]
        try:
            for c in controllers:
                c.bootstrap(now=0.0)
            step("kwok_bootstrap", t0)
            adopted = sum(len(c.nodes) for c in controllers)
            check(adopted == want_nodes, f"[{tag}] kwok adopted {adopted}, want {want_nodes}")
            t1 = time.perf_counter()
            renewed = []
            for now in EXP_TICKS:
                total = 0
                for c in controllers:
                    c._nodes_watch.progress()
                    c._pods_watch.progress()
                    total += c.tick(now=now)["renewed"]
                renewed.append(total)
            step("kwok_ticks", t1)
            started = sum(c._started_total for c in controllers)
        finally:
            for c in controllers:
                c.close()
        check(started == want_started,
              f"[{tag}] kwok started {started}, want the {want_started} pods on its nodes")
        check(renewed == [want_nodes] * len(EXP_TICKS), f"[{tag}] leases renewed {renewed}")
        leases = _prefix_count(store, EXP_LEASES)
        check(leases == want_nodes, f"[{tag}] {leases} leases stored, want {want_nodes}")
        check("kwok_node_lease_delay_seconds" in REGISTRY.render(),
              f"[{tag}] kwok_node_lease_delay_seconds not rendered")
        res["kwok"] = {"groups": len(groups), "adopted": adopted, "started": started,
                       "renewed_per_tick": renewed}
        if parity:
            res["ticked_pods"] = _prefix_dump(store, b"/registry/pods/")
            res["leases"] = _prefix_dump(store, EXP_LEASES)

        if not parity:
            t0 = time.perf_counter()
            out = res["lease_flood"] = tool("lease_flood", base + [
                "--nodes", str(nodes), "--rounds", "1", "--batch", str(EXP_BULK)])
            check(out["count"] == nodes and out["errors"] == 0, f"[{tag}] lease_flood: {out}")
            out = res["store_stress_native"] = tool("store_stress", base + [
                "--native-client", "--puts", str(EXP_NATIVE_PUTS)])
            check(out["puts"] == EXP_NATIVE_PUTS, f"[{tag}] native store_stress: {out}")
            out = res["store_stress"] = tool("store_stress", base + [
                "--puts", str(EXP_PY_PUTS), "--ranges", str(EXP_PY_RANGES)])
            check(out["put_errors"] == 0 and out["range_errors"] == 0,
                  f"[{tag}] store_stress: {out}")
            step("load", t0)

        t0 = time.perf_counter()
        counts = res["count_ready"] = verify_cluster.count_ready(store)
        check(sum(counts["nodes"].values()) == nodes, f"[{tag}] count-ready nodes {counts}")
        check(counts["pods"].get("Running", 0) == started
              and not any("(unbound)" in k for k in counts["pods"])
              and sum(counts["pods"].values()) == pods, f"[{tag}] count-ready pods {counts}")
        step("count_ready", t0)
        if metrics_port:
            import urllib.request

            with urllib.request.urlopen(f"http://127.0.0.1:{metrics_port}/metrics",
                                        timeout=30) as resp:
                check(resp.status == 200, f"[{tag}] GET /metrics: {resp.status}")
                res["metrics_bytes"] = len(resp.read())
        t0 = time.perf_counter()
        out = res["delete_pods"] = tool("delete_pods", base + ["--prefix", "bench-pod"])
        check(out["count"] == pods and out["errors"] == 0, f"[{tag}] delete_pods: {out}")
        left = _prefix_count(store, b"/registry/pods/")
        check(left == 0, f"[{tag}] {left} pods left after delete_pods")
        step("delete_pods", t0)
    finally:
        kstore.close()
        store.close()
    return res


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_experiment() -> dict:
    """19: the reference's experiment at 65,536 nodes: a fresh
    ``server_main --metrics-port`` child; every tool a CLI child whose JSON
    line is read (a non-zero exit fails the phase); group 0's controller;
    the server reaped."""
    from k8s1m_tpu_torch.store.server_main import serve_subprocess

    mport = _free_port()
    t0 = time.perf_counter()
    with serve_subprocess("--metrics-port", str(mport)) as (proc, target):
        res = _experiment("19", "cuda", target, nodes=EXP_NODES, pods=EXP_PODS, groups=(0,),
                          load=[], run_tool=_tool_child, metrics_port=mport)
    check(proc.returncode is not None, "[19] the store server is still running")
    res["seconds"] = round(time.perf_counter() - t0, 3)
    r = res
    log(f"[19] {EXP_NODES:,} nodes: node write {r['make_nodes']['seconds']} s "
        f"({r['make_nodes']['rate']}/s), pods {r['make_pods']['rate']}/s per-put, cold build "
        f"{r['cold_build_s']} s, {r['binds_per_sec']} binds/s, kwok {json.dumps(r['kwok'])}, "
        f"lease puts {r['lease_flood']['puts_per_sec']}/s, native puts "
        f"{r['store_stress_native']['puts_per_sec']}/s, Python puts "
        f"{r['store_stress']['puts_per_sec']}/s ranges {r['store_stress']['ranges_per_sec']}/s, "
        f"count-ready {r['steps_s']['count_ready']} s, steps {json.dumps(r['steps_s'])}, "
        f"base launches {r['launches']['fused_topk_by_stage']['base']}")
    return res


def _parity_pass(device: str) -> dict:
    """One 19a pass against a fresh server child, the tools in this process."""
    from k8s1m_tpu_torch.store.server_main import serve_subprocess

    t0 = time.perf_counter()
    with serve_subprocess() as (proc, target):
        res = _experiment(
            f"19a {device}", device, target, nodes=EXP_PARITY_NODES, pods=EXP_PARITY_PODS,
            groups=tuple(range(10)), load=["--concurrency", "1", "--clients", "1"],
            run_tool=_tool_inproc, parity=True)
    check(proc.returncode is not None, f"[19a {device}] the store server is still running")
    res["seconds"] = round(time.perf_counter() - t0, 3)
    return res


def phase_experiment_parity(cpu_half=None) -> dict:
    """19a: the experiment at 32,768 nodes x 2,048 pods, all ten KWOK groups,
    one client at a time (``--concurrency 1 --clients 1``), each pass against
    a fresh server child with the tools in its own process: the coordinator
    on the card here and, at the same time, on the CPU in a child process
    (two torch threads).  Both pass every check, and the stored pods after
    binding and after the ticks and the lease values are byte-identical,
    revisions included (equal sha256 over every entry, ``_digest``)."""
    card, cpu = _card_and_cpu("19a", "_parity_pass", children=cpu_half)
    for key in ("bound_pods", "ticked_pods", "leases"):
        _same_stored("19a", f"card and CPU {key}", card[key], cpu[key])
    log(f"[19a] {EXP_PARITY_NODES:,} nodes x {EXP_PARITY_PODS:,} pods, 10 KWOK groups: card "
        f"({card['seconds']:.1f}s) and CPU ({cpu['seconds']:.1f}s, concurrently) "
        f"byte-identical ({card['ticked_pods']['entries']} pods, "
        f"{card['leases']['entries']} leases); card launches "
        f"{card['launches']['fused_topk_by_stage']}")
    return {"cuda": _without_keys(card), "cpu": _without_keys(cpu)}


# ---- phases 20-20b: the dp x sp mesh ----------------------------------------------

# 20: sharded waves at 1,048,576 nodes (JAX parallel/sharded_cycle.py:1-21: the
# table's rows over sp, the wave's pods over dp; the reference splits its 1M
# nodes over 256 scheduler shards, SURVEY §1), every cell on the one card:
# the uniform wave (base stage) on the meshes 1x4 and 2x2, path B (cons stage
# and the cross-shard prologue) and C1 (delta planes sharded over sp) on 2x2,
# at score-pct 100 against the single-device wave on the same inputs.  20a:
# 8a's coordinator shape over a 2x2 mesh (two host-feed workers), card vs
# CPU.  20b: D1's batch and window through ``sched_bench --mesh 1x4`` at
# 262,144 nodes x 8,192 pods (JAX multihost.py:1-27: sp over the local
# cards; 16,384 pods cut to 8,192 for the 1,200 s limit).
# The uniform path on both meshes; B and C1 on 2x2 only (the 1,200 s limit).
MESH_SHAPES = {"uniform": ((1, 4), (2, 2)), "B": ((2, 2),), "C1": ((2, 2),)}
MESH_CELL_CHECK = (2, 2)
MESH_PATHS = ("uniform", "B", "C1")
MESH_PARITY = "2x2"
MESH_BENCH, MESH_BENCH_NODES, MESH_BENCH_PODS = "1x4", 1 << 18, 8192
CONS_FIELDS = ("spread_node", "spread_zone", "spread_region", "tgt_node", "tgt_zone",
               "tgt_region", "own_node", "own_zone", "own_region")


class _EventTimer:
    """The sharded wave's ``timer=``: a CUDA event pair around each named
    stage on the current stream; ``ms()`` sums them by name once the wave
    has synced, and starts over."""

    def __init__(self):
        self.spans: list = []

    @contextlib.contextmanager
    def __call__(self, name):
        import torch

        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        try:
            yield
        finally:
            end.record()
            self.spans.append((name, start, end))

    def ms(self) -> dict:
        out: dict = {}
        for name, start, end in self.spans:
            out[name] = out.get(name, 0.0) + start.elapsed_time(end)
        self.spans.clear()
        return out


def _mesh_world(path: str, cache: dict) -> dict:
    """Phase 20's inputs at 1,048,576 nodes: phase 4's fleet and uniform
    batch (shared by the uniform path and C1), or path B's TableSpec,
    fleet and spread + anti batch; and a fill batch of one representative
    (C1's one shape)."""
    from k8s1m_tpu_torch.cluster import (
        affinity_deployment,
        populate_kwok_nodes,
        spread_deployment,
        uniform_pods,
    )
    from k8s1m_tpu_torch.config import TOPO_ZONE, PodSpec, TableSpec
    from k8s1m_tpu_torch.plugins.registry import Profile
    from k8s1m_tpu_torch.snapshot.constraints import ConstraintTracker
    from k8s1m_tpu_torch.snapshot.node_table import NodeTableHost
    from k8s1m_tpu_torch.snapshot.pod_encoding import PodBatchHost

    key = "B" if path == "B" else "uniform"
    if key in cache:
        return cache[key]
    t0 = time.perf_counter()
    if key == "B":
        spec = TableSpec(max_nodes=NODES, max_zones=128, max_regions=16)
        tracker = ConstraintTracker(spec)
        half = BATCH // 2
        pods = (spread_deployment(tracker, "bench-spread", half, topo=TOPO_ZONE)
                + affinity_deployment(tracker, "bench-anti", BATCH - half, anti=True))
        pod_spec = PodSpec(batch=BATCH, spread_refs=1, affinity_refs=1, spread_incs=1,
                           ipa_incs=1)
        profile = Profile()
    else:
        spec = TableSpec(max_nodes=NODES)
        pods = uniform_pods(BATCH)
        pod_spec = PodSpec(batch=BATCH)
        profile = Profile(node_affinity=0, topology_spread=0, interpod_affinity=0)
    host = NodeTableHost(spec)
    populate_kwok_nodes(host, NODES)
    fill = PodBatchHost(dataclasses.replace(pod_spec, batch=FILL_BATCH), spec, host.vocab)
    cache[key] = {"spec": spec, "host": host, "profile": profile,
                  "packed": PodBatchHost(pod_spec, spec, host.vocab).encode_packed(pods),
                  "fill": fill.encode_packed(pods[:1])}
    log(f"[20] {key}: populated {NODES} KWOK nodes in {time.perf_counter() - t0:.1f}s")
    return cache[key]


def _mesh_cells_vs_plain(mesh, path: str, world: dict, table, cons, planes, seed) -> int:
    """Each cell's kernel against its plain version at the cell's offsets
    on the state before the first wave: ``fused_topk`` vs
    ``fused_topk_reference`` (the cons stage with the cross-shard
    prologue's stats) or ``delta_plane_topk`` vs ``plane_topk``; the
    largest |difference| of idx and prio over every cell."""
    import torch

    from k8s1m_tpu_torch import parallel as par
    from k8s1m_tpu_torch.engine.deltacache import plane_topk
    from k8s1m_tpu_torch.ops.delta_topk import delta_plane_topk
    from k8s1m_tpu_torch.ops.fused_topk import fused_topk, fused_topk_reference
    from k8s1m_tpu_torch.parallel import sharded_cycle as sc

    b_local = BATCH // mesh.shape["dp"]
    rows = table.rows_per_shard
    batches = sc._full_batches(mesh, world["packed"])
    stats = sc.sharded_prologue(table, cons) if cons is not None else None
    err = 0
    for d, s in mesh.cells():
        dev = mesh.device(d, s)
        pod_off, row_off = sc.mesh_offsets(d, s, rows, b_local)
        if path == "C1":
            ids = torch.zeros(b_local, dtype=torch.int32, device=dev)
            kw = dict(chunk=CHUNK, k=K, row_offset=row_off, pod_offset=pod_off)
            got = delta_plane_topk(planes[0].part(d, s), planes[1].part(d, s), ids, seed, **kw)
            want = plane_topk(planes[0].part(d, s), planes[1].part(d, s), ids, seed, **kw)
            e = _compare(got.idx, got.prio, want.idx, want.prio)
        else:
            batch = par.slice_batch(batches[dev], d, b_local)
            kw = dict(k=K, row_base=pod_off, col_base=row_off, stratum_bits=0,
                      with_affinity=False, stats=stats,
                      constraints=None if cons is None else cons.part(d, s))
            idx, prio = fused_topk(table.part(d, s), batch, seed, world["profile"], **kw)
            ridx, rprio = fused_topk_reference(table.part(d, s), batch, seed,
                                               world["profile"], chunk=CHUNK, **kw)
            e = _compare(idx, prio, ridx, rprio)
        err = max(err, e)
    return err


def _mesh_run(device, path: str, world: dict, seeds, mesh=None, *, dirtys=None, churn=None,
              timer=None, cells: bool = False) -> dict:
    """``len(seeds)`` waves of ``path`` over a fresh packed table, on one
    device (``mesh`` None) or over ``mesh``: each wave's bound rows,
    seconds, stage ms (``timer``) and launches, and the final request
    columns, count tables and planes on the CPU.  With ``cells``, first each
    cell's kernel against its plain version (``cells_err``)."""
    import torch

    from k8s1m_tpu_torch import parallel as par
    from k8s1m_tpu_torch.engine.cycle import (
        fill_shape_planes,
        schedule_batch_delta,
        schedule_batch_packed,
    )
    from k8s1m_tpu_torch.ops import delta_topk, fused_topk
    from k8s1m_tpu_torch.parallel import sharded_cycle as sc
    from k8s1m_tpu_torch.snapshot.constraints import empty_constraints
    from k8s1m_tpu_torch.snapshot.node_table import scatter_rows
    from k8s1m_tpu_torch.snapshot.packing import build_packing_spec, pack_table_host, table_bytes

    spec, host, packed, profile = world["spec"], world["host"], world["packed"], world["profile"]
    pspec = build_packing_spec(spec, host.vocab)
    if mesh is None:
        table = pack_table_host(host, pspec, device)
        cons = empty_constraints(spec, device) if path == "B" else None
    else:
        table = par.shard_table(pack_table_host(host, pspec, "cpu"), mesh)
        cons = (par.shard_constraints(empty_constraints(spec, "cpu"), mesh)
                if path == "B" else None)
    planes = None
    slot_ids = np.zeros(BATCH, np.int32)
    if path == "C1":
        fs = np.full(FILL_BATCH, 1, np.int32)
        fs[0] = 0
        planes = ((torch.zeros((1, NODES), dtype=torch.bool, device=device),
                   torch.zeros((1, NODES), dtype=torch.int32, device=device)) if mesh is None
                  else (par.mesh.zeros_planes(mesh, 1, NODES, torch.bool),
                        par.mesh.zeros_planes(mesh, 1, NODES, torch.int32)))
        fill_shape_planes(table, world["fill"], fs, planes, profile=profile, chunk=CHUNK,
                          mesh=mesh)
    out: dict = {"rows": [], "wave_ms": [], "stage_ms": [], "launches": []}
    if cells:
        out["cells_err"] = _mesh_cells_vs_plain(mesh, path, world, table, cons, planes,
                                                seeds[0])
    prev = None
    for i, seed in enumerate(seeds):
        if path == "C1":
            if mesh is None:
                scatter_rows(table, dirtys[i], {"cpu_req": churn[i]})
            else:
                sc.sharded_scatter(table, dirtys[i], {"cpu_req": churn[i]})
        ft, dt = fused_topk.fused_topk, delta_topk.delta_plane_topk
        before = (ft.launches, dt.launches, dict(ft.launches_by_stage))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        inflight = () if prev is None else (prev,)
        if path == "C1" and mesh is None:
            table, _asg, rows, planes = schedule_batch_delta(
                table, packed, seed, profile=profile, slot_ids=slot_ids, planes=planes,
                dirty=dirtys[i], inflight_rows=inflight, chunk=CHUNK, k=K)
        elif path == "C1":
            table, _asg, rows, planes = sc.sharded_delta_wave(
                mesh, table, packed, seed, profile, slot_ids=slot_ids, planes=planes,
                dirty=dirtys[i], inflight_rows=inflight, chunk=CHUNK, k=K, timer=timer)
        elif mesh is None:
            table, _asg, rows = schedule_batch_packed(table, packed, seed, profile=profile,
                                                      constraints=cons, chunk=CHUNK, k=K)
        else:
            table, cons, _asg, rows = sc.sharded_packed_wave(
                mesh, table, packed, seed, profile, chunk=CHUNK, k=K, constraints=cons,
                timer=timer)
        torch.cuda.synchronize()
        out["wave_ms"].append(1e3 * (time.perf_counter() - t0))
        if timer is not None:
            out["stage_ms"].append(timer.ms())
        out["launches"].append({
            "fused_topk": ft.launches - before[0], "delta_plane_topk": dt.launches - before[1],
            **{st: ft.launches_by_stage[st] - before[2].get(st, 0) for st in ("base", "cons")},
        })
        out["rows"].append(rows.cpu())
        prev = rows
    out["table_mb"] = table_bytes(table) / 2**20
    out["card_mb"] = torch.cuda.memory_allocated() / 2**20
    full = table.gather() if mesh is not None else table
    out["req"] = {c: getattr(full, c).cpu() for c in ("cpu_req", "mem_req", "pods_req")}
    if cons is not None:
        g = cons.gather() if mesh is not None else cons
        out["cons"] = {f: getattr(g, f).cpu() for f in CONS_FIELDS}
    if planes is not None:
        out["planes"] = [p.gather() if mesh is not None else p.cpu() for p in planes]
    return out


def _mean(xs) -> float:
    return float(sum(xs) / len(xs)) if xs else 0.0


def phase_mesh(device, *, steps: int, warmup: int) -> dict:
    """20: the sharded waves at 1,048,576 nodes, B=4096, k=4, chunk 4096,
    score-pct 100, packed, ``warmup`` + ``steps`` waves per mesh and path:
    the bound rows of every wave, the request columns, the nine count
    tables (B) and the planes (C1) byte-identical to the single-device
    waves on the same inputs; each 2x2 cell's kernel equal to its plain
    version at its offsets before the path's first wave; dp x sp launches of the path's
    kernel per wave.  Prints wave ms and within it the per-cell kernel,
    gather, greedy and commit ms (CUDA events), launches per wave and card
    MB.  Returns the results and the launches of every mesh wave."""
    import torch

    from k8s1m_tpu_torch import parallel as par

    cache: dict = {}
    total = warmup + steps
    results: dict = {}
    launches = {"base": 0, "cons": 0, "delta_plane_topk": 0}
    for pi, path in enumerate(MESH_PATHS):
        world = _mesh_world(path, cache)
        seeds = [int(s) for s in np.random.default_rng(20 + pi).integers(
            -(1 << 31), 1 << 31, size=total)]
        dirtys = churn = None
        if path == "C1":
            rng = np.random.default_rng(0)
            dirtys = [np.sort(rng.choice(NODES, DELTA_DIRTY, replace=False)).astype(np.int32)
                      for _ in range(total)]
            churn = [rng.integers(0, world["host"].cpu_alloc[d] // 2).astype(np.int32)
                     for d in dirtys]
        kw = dict(dirtys=dirtys, churn=churn)
        single = _mesh_run(device, path, world, seeds, **kw)
        single_ms = single["wave_ms"][warmup:]
        results[path] = {"single_wave_ms": single_ms}
        for dp, sp in MESH_SHAPES[path]:
            tag = f"20 {path} {dp}x{sp}"
            mesh = par.make_mesh(dp, sp, device=device)
            # The cells against their plain versions once per path, on the
            # 2x2 mesh (every cell but (0, 0) at a nonzero pod or row offset).
            cells = (dp, sp) == MESH_CELL_CHECK
            run = _mesh_run(device, path, world, seeds, mesh, timer=_EventTimer(),
                            cells=cells, **kw)
            check(not cells or run["cells_err"] == 0,
                  f"[{tag}] a cell's kernel != its plain version (max |err| {run.get('cells_err')})")
            for i in range(total):
                check(torch.equal(run["rows"][i], single["rows"][i]),
                      f"[{tag}] wave {i}: bound rows differ from the single device")
            for c, col in run["req"].items():
                check(torch.equal(col, single["req"][c]), f"[{tag}] {c} differs after commit")
            for f, tab in run.get("cons", {}).items():
                check(torch.equal(tab, single["cons"][f]), f"[{tag}] count table {f} differs")
            for j, pl in enumerate(run.get("planes", ())):
                check(torch.equal(pl, single["planes"][j]), f"[{tag}] plane {j} differs")
            kernel = "delta_plane_topk" if path == "C1" else "fused_topk"
            stage = {"uniform": "base", "B": "cons", "C1": None}[path]
            for i, n in enumerate(run["launches"]):
                check(n[kernel] == dp * sp, f"[{tag}] wave {i} launched {kernel} {n} times")
                if stage:
                    check(n[stage] == dp * sp and n["delta_plane_topk"] == 0,
                          f"[{tag}] wave {i}: launches {n}")
                else:
                    check(n["fused_topk"] == 0, f"[{tag}] wave {i}: launches {n}")
            launches[stage or "delta_plane_topk"] += sum(n[kernel] for n in run["launches"])
            timed = run["stage_ms"][warmup:]
            cells = {f"{d}x{s}": _mean([t[f"kernel:{d}x{s}"] for t in timed])
                     for d in range(dp) for s in range(sp)}
            res = {
                "wave_ms": run["wave_ms"][warmup:],
                "p50_wave_ms": float(np.percentile(run["wave_ms"][warmup:], 50)),
                "cell_kernel_ms": cells,
                **{f"{st}_ms": _mean([t.get(st, 0.0) for t in timed])
                   for st in ("gather", "greedy", "commit", "prologue", "merge", "unpack")},
                "launches_per_wave": dp * sp,
                "launches": sum(n[kernel] for n in run["launches"]),
                "binds": int(sum(int((r >= 0).sum()) for r in run["rows"][warmup:])),
                "table_mb": run["table_mb"], "card_mb": run["card_mb"],
                "cells_max_abs_err": run.get("cells_err"),
            }
            results[path][f"{dp}x{sp}"] = res
            log(f"[{tag}] byte-identical to the single device over {total} waves; "
                f"wave ms {res['p50_wave_ms']:.1f} (single {np.percentile(single_ms, 50):.1f}): "
                f"kernel/cell ms {', '.join(f'{k} {v:.3f}' for k, v in cells.items())}, "
                f"gather {res['gather_ms']:.3f}, greedy {res['greedy_ms']:.3f}, commit "
                f"{res['commit_ms']:.3f}, prologue {res['prologue_ms']:.3f}, merge "
                f"{res['merge_ms']:.3f}; {dp * sp} {kernel} launches/wave; "
                + ("cells vs plain max |err| 0; " if cells else "")
                + f"table {res['table_mb']:.1f} MB, card {res['card_mb']:.0f} MB")
            del run
        del single
        torch.cuda.empty_cache()
    results["launches"] = launches
    return results


def _mesh_parity_members(device: str) -> dict:
    """20a's members on ``device``: 8a's uniform ``sched_bench`` run and
    D4's constraint construction at 65,536 nodes x 8,192 pods, 5%, chunk
    4096, zero-delay retries, over a 2x2 mesh (two host-feed workers); on
    the card also the uniform run at score-pct 100 over the mesh and on one
    device.  Each passes ``_coordinator_checks`` (and the count-table
    recount); its stored pod values under ``stored <tag>``."""
    from k8s1m_tpu_torch.faultline import RetryPolicy
    from k8s1m_tpu_torch.snapshot.hotfeed import ShardedHostFeed
    from k8s1m_tpu_torch.tools import sched_bench

    policy = RetryPolicy(**_ZERO_DELAY)
    out: dict = {"runs": {}}
    members = [("uniform", MESH_PARITY, SCORE_PCT), ("constraints", MESH_PARITY, SCORE_PCT)]
    if device == "cuda":
        members += [("pct100", MESH_PARITY, 100), ("pct100", "none", 100)]
    for group, mesh, pct in members:
        t0 = time.perf_counter()
        if group == "constraints":
            report, coord, store = _constraint_run(
                device, nodes=PARITY_NODES, waves=PARITY_PODS // 4096, per=2048,
                retry_policy=policy, mesh=mesh)
            pods = PARITY_PODS + 1
        else:
            report, coord, store = sched_bench.run(_bench_args(
                nodes=PARITY_NODES, pods=PARITY_PODS, score_pct=pct, packing="packed",
                chunk=CHUNK, device=device, mesh=mesh), retry_policy=policy)
            pods = PARITY_PODS
        tag = f"20a {group} {mesh} {device}"
        if mesh != "none":
            check(coord.mesh is not None and coord.mesh.shape == {"dp": 2, "sp": 2},
                  f"[{tag}] mesh {coord.mesh}")
            check(isinstance(coord._feed, ShardedHostFeed) and len(coord._feed.feeds) == 2,
                  f"[{tag}] no feed per dp rank")
        stored = _coordinator_checks(tag, report, coord, store, pods)
        if group == "constraints":
            _recount_constraints(coord, stored)
        coord.close()
        store.close()
        out["runs"][tag] = {"group": group, "report": report,
                            "seconds": round(time.perf_counter() - t0, 3)}
        out[f"stored {tag}"] = stored
    return out


def phase_mesh_parity(children=None) -> dict:
    """20a: ``_mesh_parity_members`` on the card and, concurrently in a
    child process, on the CPU: the uniform and the constraint group leave
    byte-identical stored pod values on both, and on the card the mesh at
    score-pct 100 leaves those of the single device."""
    card, cpu = _card_and_cpu("20a", "_mesh_parity_members", children=children)
    for group in ("uniform", "constraints"):
        a = f"20a {group} {MESH_PARITY} cuda"
        b = f"20a {group} {MESH_PARITY} cpu"
        _same_stored("20a", f"stored pod values of [{a}] and [{b}]", card[f"stored {a}"],
                     cpu[f"stored {b}"])
    a, b = f"20a pct100 {MESH_PARITY} cuda", "20a pct100 none cuda"
    _same_stored("20a", f"stored pod values of [{a}] and [{b}]", card[f"stored {a}"],
                 card[f"stored {b}"])
    runs = {**card["runs"], **cpu["runs"]}
    log("[20a] mesh 2x2 at 65,536 nodes x 8,192 pods: " + ", ".join(
        f"{t} ({r['seconds']:.1f}s, {r['report']['value']} binds/s)" for t, r in runs.items())
        + "; byte-identical card/CPU per group, and mesh/single at score-pct 100")
    return {"runs": {t: {"seconds": r["seconds"], "report": r["report"]}
                     for t, r in runs.items()}}


def phase_mesh_bench() -> dict:
    """20b: ``sched_bench --mesh 1x4`` at 262,144 nodes x 8,192 pods,
    ``--batch 4096 --depth 2 --score-pct 5 --stats --kernel-profile``,
    packed: every pod bound once (phase 8's checks), 4 base launches per
    wave, the report's ``mesh_exec`` and the shard-local kernel profile."""
    from k8s1m_tpu_torch.tools import sched_bench

    t0 = time.perf_counter()
    report, coord, store = sched_bench.run(_bench_args(
        nodes=MESH_BENCH_NODES, pods=MESH_BENCH_PODS, batch=BATCH, depth=2,
        score_pct=SCORE_PCT, packing="packed", stats=True, kernel_profile=True,
        mesh=MESH_BENCH))
    try:
        _coordinator_checks("20b", report, coord, store, MESH_BENCH_PODS)
    finally:
        coord.close()
        store.close()
    d = report["detail"]
    me = d["mesh_exec"]
    check((me["dp"], me["sp"]) == (1, 4), f"[20b] mesh_exec {me}")
    n = d["launches"]["fused_topk_by_stage"]["base"]
    check(n == 4 * d["waves"]["full"] and n > 0, f"[20b] {n} base launches for "
          f"{d['waves']['full']} waves")
    check(d["kernel_profile"]["mesh"] == {"dp": 1, "sp": 4,
                                          "rows_per_shard": MESH_BENCH_NODES // 4},
          f"[20b] kernel_profile.mesh {d['kernel_profile'].get('mesh')}")
    log(f"[20b] sched_bench --mesh {MESH_BENCH} at {MESH_BENCH_NODES:,} nodes x "
        f"{MESH_BENCH_PODS:,} pods: {report['value']} binds/s, p50/p99 "
        f"{d['p50_ms']}/{d['p99_ms']} ms, device share {d['device_share']}, stage means "
        f"{d['stage_means_ms']}, mesh_exec {me}, base launches {n}, shard-local kernel "
        f"ms/batch {d['kernel_profile']['ms_per_batch'].get('full')} "
        f"({time.perf_counter() - t0:.1f}s)")
    return report


# ---- phases 21, 21a: the composed steady drill with its failover lane ----------

# 21 at 262,144 nodes: the JAX drill's 1,048,576 cut to fit the script's
# limit beside phases 17d and 21a (PERF.md section 4).
STEADY_NODES = NODES // 4
# The drill's report keys that read the host clock (the warm takeover's
# seconds, the run's stretches); every other key is the same on the card
# and the CPU, as between two CPU runs of the JAX drill at one seed.
STEADY_CLOCK_KEYS = ("recovery_s", "phase_s")


def _scrub_steady(d):
    if isinstance(d, dict):
        return {k: _scrub_steady(v) for k, v in d.items()
                if k not in STEADY_CLOCK_KEYS + DRILL_DEVICE_KEYS}
    return d


def _steady_gates(tag: str, rep: dict) -> None:
    ev = rep["evidence"]
    fo = ev["failover"]
    tier = fo["watch_tier"]
    check(rep["passed"], f"[{tag}] steady_drill did not pass: {json.dumps(ev)[:2000]}")
    check(ev["lost"] == 0 and fo["kill_fired"] == 1 and fo["beta_leader"]
          and fo["takeover_mode"] == "warm", f"[{tag}] failover lane: {fo}")
    check(tier["resumes"] == 1 and tier["invalidations"] == 0 and tier["client_cancels"] == 0
          and tier["client_errors"] == 0 and tier["events"] > 0,
          f"[{tag}] the watch tier's lane: {tier}")


# 21a's card half: the drill's CLI entry in a fresh process, its launch
# counts set to 0 just before and read just after; its last stdout line is
# {"report": ..., "launches": ...}.

def _start_steady_parity() -> dict:
    """21a's two halves, started now: ``steady_drill --smoke --failover`` on
    the card and with ``--device cpu``, each in a fresh process."""
    root, env = _child_env()
    procs = {}
    for dev, cmd, threads in (
        ("cuda", ["-c", _CARD_TOOL, "steady_drill"], {}),
        ("cpu", ["-m", "k8s1m_tpu_torch.tools.steady_drill", "--device", "cpu"],
         {"OMP_NUM_THREADS": "1"}),
    ):
        with open(os.path.join(OUT_DIR, f"steady_drill_smoke_{dev}.log"), "w") as err:
            procs[dev] = subprocess.Popen(
                [sys.executable, *cmd, "--smoke", "--failover", "--out",
                 os.path.join(OUT_DIR, f"steady_drill_smoke_{dev}.json")],
                stdout=subprocess.PIPE, stderr=err, text=True, env={**env, **threads}, cwd=root)
    return {"procs": procs, "t0": time.perf_counter()}


def phase_steady(device: str = "cuda") -> dict:
    """21: ``steady_drill --failover --nodes 262144 --chunk 4096`` on the
    card (``STEADY_NODES``), every other flag at the JAX defaults (batch 256, depth 3, 6 zipf
    tenants at skew 1.0, 24/16/60 steady/overload/recovery ticks at factor
    5, 64 churned nodes a tick, a bind-CAS conflict every 37th, seed 5):
    the HA pair with a mid-overload SIGKILL of the leader, and the
    watch-cache tier over the same store with one client watch on the pods
    prefix and an injected upstream break.  Gates: the drill's own
    (``passed``), 0 lost, the warm standby leading, the tier resumed once
    with 0 invalidations and 0 client cancels, fused base launches in the
    run (counts set to 0 just before it)."""
    from k8s1m_tpu_torch.tools import steady_drill

    t0 = time.perf_counter()
    _reset_launches()
    with contextlib.redirect_stdout(io.StringIO()):
        rep = steady_drill.main(["--failover", "--nodes", str(STEADY_NODES), "--chunk",
                                 str(CHUNK), "--device", device,
                                 "--out", os.path.join(OUT_DIR, "steady_drill.json")])
    launches = _launch_counts()
    _steady_gates("21", rep)
    check(rep["device"] == device, "[21] device")
    check(launches["fused_topk_by_stage"]["base"] > 0, f"[21] no fused base launch: {launches}")
    ev = rep["evidence"]
    wall = time.perf_counter() - t0
    log(f"[21] steady_drill --failover at {STEADY_NODES:,} nodes (chunk {CHUNK}): passed; "
        f"admitted {ev['admitted']} (rejected {ev['rejected']}), lost 0, states "
        f"{ev['states_seen']}, recovered at tick {ev['recovered_at_tick']}, in-flight depth "
        f"{ev['sustained_inflight_depth']}, faults {ev['faults_injected']}; failover recovery "
        f"{ev['failover']['recovery_s']:.4f} s ({ev['failover']['takeover_mode']}), tier "
        f"{json.dumps(ev['failover']['watch_tier'])}; phases {json.dumps(ev['phase_s'])}; "
        f"launches {launches} ({wall:.1f}s)")
    return {"evidence": rep, "launches": launches, "seconds": round(wall, 3)}


def phase_steady_parity(started: dict) -> dict:
    """21a: ``steady_drill --smoke --failover`` on the card and with
    ``--device cpu`` (started by ``_start_steady_parity``): both pass every
    gate of 21 and their reports are equal once the host-clock keys
    (``STEADY_CLOCK_KEYS``) and the device are removed."""
    procs = started["procs"]
    try:
        outs = {dev: proc.communicate(timeout=600)[0] for dev, proc in procs.items()}
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for dev, proc in procs.items():
        check(proc.returncode == 0 and outs[dev].strip(),
              f"[21a] steady_drill on {dev} exited {proc.returncode} "
              f"(steady_drill_smoke_{dev}.log)")
    card_out = json.loads(outs["cuda"].strip().splitlines()[-1])
    card, launches = card_out["report"], card_out["launches"]
    cpu = json.loads(outs["cpu"].strip().splitlines()[-1])
    _steady_gates("21a card", card)
    _steady_gates("21a cpu", cpu)
    check(card["device"] == "cuda" and cpu["device"] == "cpu", "[21a] devices")
    check(launches["fused_topk_by_stage"]["base"] > 0, f"[21a] no base launch: {launches}")
    check(_scrub_steady(card) == _scrub_steady(cpu), "[21a] card and CPU reports differ")
    log(f"[21a] steady_drill --smoke --failover on the card and the CPU: both pass, reports "
        f"equal without {list(STEADY_CLOCK_KEYS + DRILL_DEVICE_KEYS)} (admitted "
        f"{card['evidence']['admitted']}, tier events "
        f"{card['evidence']['failover']['watch_tier']['events']}); recovery card "
        f"{card['evidence']['failover']['recovery_s']:.4f} s, cpu "
        f"{cpu['evidence']['failover']['recovery_s']:.4f} s; launches {launches} "
        f"({time.perf_counter() - started['t0']:.1f}s since both started)")
    return {"cuda": {"evidence": card, "launches": launches}, "cpu": cpu}


# ---- phase 22: the cluster harness, leader and standby on the card -------------

# 22's live fleet: 262,144 nodes (phase 21's depth) cut to 131,072 to keep
# the script inside its limit (PERF.md section 4); the table keeps its
# 1,048,576 rows.
HARNESS_NODES = NODES // 8
HARNESS_PODS = 16384
# 22a's smoke shape (card and CPU behind the secured tier).
HARNESS_SMOKE = dict(nodes=512, kwok_groups=2, coordinators=2, pod_batch=256, chunk=256,
                     wal_mode="none", watch_cache=True, tier_tls=True, backend="pallas")
HARNESS_SMOKE_PODS = 1024
PODS_PREFIX = b"/registry/pods/"
NODES_PREFIX = b"/registry/minions/"


def _put_nodes_in_frames(cluster) -> None:
    """``Cluster.make_nodes``'s nodes, the same bytes under the same keys in
    the same order, in PutFrames of ``CHUNK`` nodes (one revision per node)
    where it makes one put per node: 22's registration, bulk as 19's
    ``make_nodes --bulk``."""
    from k8s1m_tpu_torch.control.objects import encode_node, node_key
    from k8s1m_tpu_torch.tools.make_nodes import build_node

    spec = cluster.spec
    for lo in range(0, spec.nodes, CHUNK):
        items = []
        for i in range(lo, min(lo + CHUNK, spec.nodes)):
            node = build_node(i, zones=spec.zones, regions=spec.regions)
            node.labels["kwok-group"] = str(i % spec.kwok_groups)
            items.append((node_key(node.name), encode_node(node)))
        cluster._clients[0].put_batch(items)


def phase_harness() -> dict:
    """22: ``cluster/harness.py`` as ``cluster.up`` runs it: the port's store
    child, two ``HACoordinator``s (leader and standby) and two KWOK
    controllers over the wire, the webhook, ``ClusterSpec(nodes=131072,
    table=TableSpec(max_nodes=1048576), kwok_groups=2, coordinators=2,
    device="cuda", backend="pallas")`` and the JAX defaults otherwise
    (waves of 256 pods, chunk 1024, buffered WAL); the nodes (in PutFrames,
    ``_put_nodes_in_frames``), the first tick, then ``run_pods(16384)``
    (one put per pod).  The live fleet cut from 262,144 (PERF.md §4).  It
    runs alone on the host.  Gates: every pod bound once and Running, one
    leader, the standby holds no coordinator, no node over its pod slots,
    fused base launches (counts set to 0 just before the nodes' writes)."""
    import tempfile

    from k8s1m_tpu_torch.cluster.harness import Cluster, ClusterSpec
    from k8s1m_tpu_torch.config import TableSpec
    from k8s1m_tpu_torch.store.native import prefix_end

    t0 = time.perf_counter()
    res: dict = {"nodes": HARNESS_NODES, "pods": HARNESS_PODS, "steps_s": {}}
    spec = ClusterSpec(nodes=HARNESS_NODES, table=TableSpec(max_nodes=NODES, max_zones=16,
                                                            max_regions=8),
                       kwok_groups=2, coordinators=2, device="cuda", backend="pallas")
    with tempfile.TemporaryDirectory() as wal, Cluster(spec, wal_dir=wal) as cluster:
        res["steps_s"]["start"] = round(time.perf_counter() - t0, 3)
        _reset_launches()
        t1 = time.perf_counter()
        _put_nodes_in_frames(cluster)
        res["steps_s"]["nodes"] = round(time.perf_counter() - t1, 3)
        t1 = time.perf_counter()
        cluster.tick(0.0)  # elect a leader, bootstrap KWOK and the snapshot
        res["steps_s"]["first_tick"] = round(time.perf_counter() - t1, 3)
        split0 = dict(cluster.tick_seconds)
        now0 = cluster.now
        stats = cluster.run_pods(HARNESS_PODS)
        launches = _launch_counts()
        res["run_pods"] = stats
        res["ticks"] = int(round(cluster.now - now0))
        res["tick_seconds"] = {k: round(v - split0[k], 3) for k, v in cluster.tick_seconds.items()}
        leaders = [ha for ha in cluster.coordinators if ha.elector.is_leader]
        standby = [ha for ha in cluster.coordinators if not ha.elector.is_leader]
        objs = [json.loads(kv.value) for kv in cluster._clients[0].range(
            PODS_PREFIX, prefix_end(PODS_PREFIX)).kvs]
    check(stats["bound"] == HARNESS_PODS and stats["running"] == HARNESS_PODS,
          f"[22] run_pods: {stats}")
    check(len(objs) == HARNESS_PODS and all(o["spec"].get("nodeName")
                                            and o["status"]["phase"] == "Running"
                                            for o in objs),
          "[22] a stored pod is unbound or not Running")
    per_node: dict = {}
    for o in objs:
        per_node[o["spec"]["nodeName"]] = per_node.get(o["spec"]["nodeName"], 0) + 1
    check(max(per_node.values()) <= 110, "[22] a node holds more pods than its slots")
    check(len(leaders) == 1 and len(standby) == 1 and standby[0].coord is None,
          "[22] one leader and a standby without a coordinator")
    check(launches["fused_topk_by_stage"]["base"] > 0, f"[22] no fused base launch: {launches}")
    res["launches"] = launches
    res["leader"] = leaders[0].elector.identity
    res["seconds"] = round(time.perf_counter() - t0, 3)
    log(f"[22] harness at {HARNESS_NODES:,} nodes (table {NODES:,} rows), leader "
        f"{res['leader']} + standby, 2 KWOK groups: {stats['bound']:,} pods bound once and "
        f"Running in {res['ticks']} ticks, {stats['binds_per_sec']} binds/s (created "
        f"{stats['created_s']} s, total {stats['total_s']} s); tick seconds "
        f"{res['tick_seconds']}; steps {res['steps_s']}; launches {launches} "
        f"({res['seconds']:.1f}s)")
    return res


def _harness_smoke_run(device: str) -> dict:
    """22a's script on ``device``: the cluster of ``HARNESS_SMOKE`` (KWOK
    behind the secured watch-cache tier), ``make_nodes``, the first tick,
    ``HARNESS_SMOKE_PODS`` pods in one put each, then ticks, each behind a
    barrier that waits until every component's watch has seen every event
    of its prefix, until all are bound and Running.  Returns the stored
    pods, the binds per tick, the leader and the launches."""
    from k8s1m_tpu_torch.cluster.harness import Cluster, ClusterSpec
    from k8s1m_tpu_torch.control.objects import encode_pod, pod_key
    from k8s1m_tpu_torch.snapshot.pod_encoding import PodInfo
    from k8s1m_tpu_torch.store.native import prefix_end

    t0 = time.perf_counter()
    _reset_launches()
    with Cluster(ClusterSpec(**HARNESS_SMOKE, device=device)) as cluster:
        for client in cluster._clients:
            def watch(*a, _orig=client.watch, **kw):
                w = _orig(*a, **kw)
                w.barrier_start = kw.get("start_revision", 0)
                return w
            client.watch = watch
        store = cluster._clients[0]

        def barrier():
            want = {p: max((kv.mod_revision for kv in store.range(p, prefix_end(p)).kvs),
                           default=0) for p in (NODES_PREFIX, PODS_PREFIX)}
            watched = []
            for k in cluster.kwoks:
                watched += [(k._nodes_watch, NODES_PREFIX), (k._pods_watch, PODS_PREFIX)]
            for ha in cluster.coordinators:
                if ha.coord is not None:
                    watched += [(ha.coord._nodes_watch, NODES_PREFIX),
                                (ha.coord._pods_watch, PODS_PREFIX)]
            deadline = time.monotonic() + 60
            for w, p in watched:
                while w is not None and w.seen_revision < want[p] and w.barrier_start <= want[p]:
                    check(time.monotonic() < deadline, "[22a] a watch never caught up")
                    time.sleep(0.002)

        cluster.make_nodes()
        cluster.tick(0.0)
        for i in range(HARNESS_SMOKE_PODS):
            store.put(pod_key("default", f"smoke-{i}"),
                      encode_pod(PodInfo(f"smoke-{i}", cpu_milli=100, mem_kib=200 << 10)))
        per_tick = []
        for _ in range(200):
            barrier()
            per_tick.append(cluster.tick()["bound"])
            if sum(per_tick) >= HARNESS_SMOKE_PODS and all(
                    json.loads(kv.value)["status"]["phase"] == "Running"
                    for kv in store.range(PODS_PREFIX, prefix_end(PODS_PREFIX)).kvs):
                break
        barrier()
        while per_tick and per_tick[-1] == 0:  # ticks that only waited for KWOK
            per_tick.pop()
        leaders = [ha.elector.identity for ha in cluster.coordinators if ha.elector.is_leader]
        stored = {kv.key: kv.value for kv in store.range(PODS_PREFIX, prefix_end(PODS_PREFIX)).kvs}
    phases = {json.loads(v)["status"]["phase"] for v in stored.values()}
    check(sum(per_tick) == HARNESS_SMOKE_PODS and len(stored) == HARNESS_SMOKE_PODS
          and phases == {"Running"} and len(leaders) == 1,
          f"[22a {device}] binds {sum(per_tick)}, stored {len(stored)}, phases {phases}, "
          f"leaders {leaders}")
    return {"device": device, "stored": stored, "per_tick": per_tick, "leaders": leaders,
            "launches": _launch_counts(), "seconds": round(time.perf_counter() - t0, 3)}


def _start_harness_parity() -> dict:
    """22a's two halves, started now: ``_harness_smoke_run`` on the card in
    a fresh child and on the CPU in a warm one."""
    return {"cuda": _start_card_half("_harness_smoke_run"),
            "cpu": _start_cpu_half("_harness_smoke_run")}


def phase_harness_parity(started: dict) -> dict:
    """22a: ``_harness_smoke_run`` on the card and on the CPU, each in a
    child (``_start_harness_parity``): the stored pods' bytes, the binds per
    tick and the leader are equal; the card's run launched the fused base
    stage (its counts set to 0 and read in its own process)."""
    card = _collect("22a", started["cuda"], half="card")
    cpu = _collect("22a", started["cpu"])
    check(card["launches"]["fused_topk_by_stage"]["base"] > 0,
          f"[22a] no base launch on the card: {card['launches']}")
    _same_stored("22a", "card and CPU stored pods", card["stored"], cpu["stored"])
    check(card["per_tick"] == cpu["per_tick"] and card["leaders"] == cpu["leaders"],
          f"[22a] binds per tick {card['per_tick']} vs {cpu['per_tick']}")
    log(f"[22a] harness smoke ({HARNESS_SMOKE['nodes']} nodes, {HARNESS_SMOKE_PODS} pods, KWOK "
        f"behind the secured tier): card == CPU, {card['stored']['entries']} pods sha256 "
        f"{card['stored']['sha256'][:16]}, {len(card['per_tick'])} binding ticks; card "
        f"{card['seconds']:.1f}s, CPU {cpu['seconds']:.1f}s; launches {card['launches']}")
    return {"cuda": _without_keys(card), "cpu": _without_keys(cpu),
            "launches": card["launches"]}


def _fidelity_run(device: str) -> dict:
    """22b's run on ``device``: ``fidelity_ab --device <device>`` at its
    defaults, its launch counts set to 0 just before and read just after."""
    from k8s1m_tpu_torch.tools import fidelity_ab

    t0 = time.perf_counter()
    _reset_launches()
    with contextlib.redirect_stdout(io.StringIO()):
        report = fidelity_ab.main(["--device", device])
    return {"report": report, "launches": _launch_counts(),
            "seconds": round(time.perf_counter() - t0, 3)}


def phase_fidelity(cpu_half) -> dict:
    """22b: ``tools/fidelity_ab.py`` at its defaults (2,000 nodes x 2,000
    pods, 60 simulated seconds) on the card in this process and on the CPU
    in a warm child (``cpu_half``): the reports, which hold no clock, are
    equal, and the card's run launched the fused base stage."""
    card, cpu = _card_and_cpu("22b", "_fidelity_run", children=cpu_half)
    launches, rep = card["launches"], card["report"]
    check(launches["fused_topk_by_stage"]["base"] > 0, f"[22b] no base launch: {launches}")
    check(rep == cpu["report"], f"[22b] card and CPU reports differ: {rep} vs {cpu['report']}")
    for arm in ("kwok", "kubelet_sim"):
        check(rep[arm]["bound"] == 2000, f"[22b] {arm} bound {rep[arm]['bound']}")
    log(f"[22b] fidelity_ab (2,000 x 2,000, 60 s) card == CPU: ratios {rep['ratios']}, "
        f"kwok writes {rep['kwok']['writes_total']}, kubelet_sim writes "
        f"{rep['kubelet_sim']['writes_total']}; card {card['seconds']:.1f}s, CPU "
        f"{cpu['seconds']:.1f}s; launches {launches}")
    return {"report": rep, "launches": launches, "seconds": card["seconds"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=4, help="timed waves per layout (phase 4)")
    ap.add_argument("--path-steps", type=int, default=3,
                    help="timed waves per layout of paths A and B (phases 5, 6)")
    ap.add_argument("--delta-steps", type=int, default=2,
                    help="timed delta waves per layout of path C (phase 7)")
    ap.add_argument("--warmup", type=int, default=1, help="warm-up waves per layout")
    ap.add_argument("--out", default=None, help="also write the full results as JSON here")
    ap.add_argument("--worst-case-only", action="store_true",
                    help="run only the device, build and all-distinct phases (3e) and print "
                         "their times; run from another tree's root it times that tree's kernel")
    ap.add_argument("--mesh-only", action="store_true",
                    help="run only the device, build and mesh phases (20-20b) and print "
                         "their results")
    ap.add_argument("--wire-asyncio-only", action="store_true",
                    help="run only the device and build phases, 17a's card run over the "
                         "native wire and phase 17c, and print their results")
    ap.add_argument("--tier-only", action="store_true",
                    help="run only the device and build phases, 17a's card run over the "
                         "native wire, phase 17d (the secured watch-cache tier) and phases "
                         "21-21a (the composed steady drill), and print their results")
    ap.add_argument("--harness-only", action="store_true",
                    help="run only the device and build phases and phases 22-22b (the "
                         "cluster harness, its card-vs-CPU smoke and fidelity_ab), and "
                         "print their results")
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
    if args.wire_asyncio_only:
        stored, seconds, launches, probes = _wire_parity_run("cuda", True, probe=True)
        out = {"17a cuda wire": {"seconds": round(seconds, 3), "launches": launches,
                                 **probes},
               "17c": phase_wire_asyncio(stored)}
        _log_wire_probes(out)
        log(f"[run] {time.perf_counter() - t_start:.1f}s in all, build included")
        print(json.dumps(out, default=str), flush=True)
        return 0
    if args.tier_only:
        stored, seconds, launches, probes = _wire_parity_run("cuda", True, probe=True)
        out = {"17a cuda wire": {"seconds": round(seconds, 3), "launches": launches, **probes},
               "17d": phase_tier(stored, probes["relist_s"])}
        steady_parity = _start_steady_parity()  # 21a's halves, beside 21 (as in the full run)
        out["21"] = phase_steady()
        out["21a"] = phase_steady_parity(steady_parity)
        log(f"[run] {time.perf_counter() - t_start:.1f}s in all, build included")
        print(json.dumps(out, default=str), flush=True)
        return 0
    if args.harness_only:
        out = {"22": phase_harness()}
        harness_started = _start_harness_parity()  # 22a's halves and 22b's
        fidelity_cpu = _start_cpu_half("_fidelity_run")  # CPU half, after 22
        out["22a"] = phase_harness_parity(harness_started)
        out["22b"] = phase_fidelity(fidelity_cpu)
        log(f"[run] {time.perf_counter() - t_start:.1f}s in all, build included")
        print(json.dumps(out, default=str), flush=True)
        return 0
    if args.mesh_only:
        mesh_cpu = _start_cpu_half("_mesh_parity_members")
        mesh = phase_mesh(device, steps=args.delta_steps, warmup=args.warmup)
        out = {"mesh": mesh, "mesh_parity": phase_mesh_parity(mesh_cpu),
               "mesh_bench": phase_mesh_bench()}
        log(f"[run] {time.perf_counter() - t_start:.1f}s in all, build included")
        print(json.dumps(out, default=str), flush=True)
        return 0
    # 8a's CPU halves run beside phase 3 (timed with CUDA events).
    parity_cpu = _start_cpu_half("_parity_members",
                                 cpu_calls=[((group,),) for group in PARITY_GROUPS])
    err3 = phase_kernel_vs_plain(device)
    err3b = phase_affinity_vs_plain(device)
    wide = phase_wide_vs_plain(device)
    err3c = phase_constraints_vs_plain(device)
    err3d = phase_delta_vs_plain(device)
    worst = phase_worst_case(device)
    main_res = phase_main_path(device, steps=args.steps, warmup=args.warmup)
    path_a = phase_path(device, "A", steps=args.path_steps, warmup=args.warmup)
    path_b = phase_path(device, "B", steps=args.path_steps, warmup=args.warmup)
    path_c = {c: phase_delta_path(device, c, steps=args.delta_steps, warmup=args.warmup)
              for c in ("C1", "C2")}
    parity, untraced = phase_coordinator_parity(parity_cpu)
    _warm_cpu_children(2)  # 10a's and 12a's CPU halves
    coord = {c: phase_coordinator(c) for c in ("D1", "D2", "D3")}
    coord["D4"] = phase_constraints()
    coord["D5"] = phase_coordinator("D5")
    # 10a's and 12a's CPU halves start beside phase 9; phase 10 runs after
    # both, on a quiet host (the drill's gates read its clock).
    composed_cpu = _start_cpu_half("_composed_run")
    webhook_cpu = _start_cpu_half("_webhook_parity_run")
    probe = phase_probe()
    composed = phase_composed_parity(composed_cpu)
    webhook_parity = phase_webhook_parity(webhook_cpu)
    megarow = phase_megarow()
    _warm_cpu_children(2)  # 18a's and 19a's CPU halves
    breaker = phase_breaker()
    trace = phase_trace()
    trace_parity = phase_trace_parity(untraced)
    del untraced
    webhook = phase_webhook()
    drills = phase_drills()
    hostpath = phase_hostpath()
    curve = phase_curve()
    failover = phase_failover()
    failover_parity = phase_failover_parity()
    wire = {"17": phase_wire("17")}
    wire_parity, wire_stored = phase_wire_parity()
    wire_parity["17c"] = phase_wire_asyncio(wire_stored)
    tier = phase_tier(wire_stored, wire_parity["cuda wire"]["relist_s"])
    del wire_stored
    _log_wire_probes({"17a cuda wire": wire_parity["cuda wire"], "17c": wire_parity["17c"]})
    wire["17b"] = phase_wire("17b")
    shards = phase_shards()
    experiment = phase_experiment()
    # 19a's and 18a's CPU halves both start now; 19a's longer card half runs
    # first, so 18a's card half does not wait on a CPU half.
    experiment_cpu = _start_cpu_half("_parity_pass")
    shard_cpu = _start_cpu_half("_shard_parity_run")
    experiment_parity = phase_experiment_parity(experiment_cpu)
    shard_parity = phase_shard_parity(shard_cpu)
    mesh_cpu = _start_cpu_half("_mesh_parity_members")  # 20a's, beside 20
    mesh = phase_mesh(device, steps=args.delta_steps, warmup=args.warmup)
    # 22a's halves run beside 20a (a parity phase with no clock gate), so that
    # 22 runs alone on the host; 22b's CPU child starts its imports with them.
    harness_started = _start_harness_parity()
    _warm_cpu_children(1)
    mesh_parity = phase_mesh_parity(mesh_cpu)
    mesh_bench = phase_mesh_bench()
    steady_parity_started = _start_steady_parity()  # 21a's halves, beside 21
    steady = phase_steady()
    steady_parity = phase_steady_parity(steady_parity_started)
    harness = phase_harness()  # alone on the host: its binds/s and tick split
    harness_parity = phase_harness_parity(harness_started)
    fidelity = phase_fidelity(_start_cpu_half("_fidelity_run"))
    log(f"[run] {time.perf_counter() - t_start:.1f}s in all, build included")

    # Launches of the coordinator's paths (phases 8, 10-16a, 17-17d, 18a, 19,
    # 19a, 20a, 20b, 21-21a and 22-22b, counts set to 0 just before each measured run and read just
    # after it; 18's workers set theirs to 0 after their warm-up pod and
    # report them with their final status), per fused stage.
    runs = ([r["detail"]["launches"] for r in coord.values()]
            + [megarow["launches"], trace["launches"], trace_parity["launches"],
               webhook["launches"], webhook_parity["cuda"]["launches"],
               drills["overload_drill"]["launches"], drills["tenantfair_drill"]["launches"],
               hostpath["launches"], curve["launches"], failover["launches"],
               failover_parity["cuda"]["launches"]]
            + [r["detail"]["launches"] for r in wire.values()]
            + [wire_parity[tag]["launches"] for tag in ("cuda wire", "cuda in-process", "17c")]
            + [w["launches"] for r in shards.values() for w in r["per_worker"]]
            + [shard_parity["cuda"]["launches"], experiment["launches"],
               experiment_parity["cuda"]["launches"]]
            + [r["report"]["detail"]["launches"] for t, r in mesh_parity["runs"].items()
               if t.endswith(" cuda")]
            + [mesh_bench["detail"]["launches"], tier["launches"], steady["launches"],
               steady_parity["cuda"]["launches"], harness["launches"],
               harness_parity["launches"], fidelity["launches"]])
    coord_launches = {
        stage: sum(r["fused_topk_by_stage"][stage] for r in runs)
        for stage in ("base", "aff", "cons")
    }
    coord_launches["delta_plane_topk"] = sum(r.get("delta_plane_topk", 0) for r in runs)

    mesh_launches = mesh["launches"]

    def entry(stage, replaces, res, err):
        prod = res["packed"]
        extra = coord_launches[stage]
        return {
            "name": f"fused_topk[{stage}]",
            "route": "cuda",
            "source": "k8s1m_tpu_torch/csrc/fused_topk.cuh",
            "replaces": replaces,
            "launches": res["launches"] + extra + mesh_launches.get(stage, 0),
            "coordinator_launches": extra,
            "mesh_launches": mesh_launches.get(stage, 0),
            "max_abs_err": max([err] + [float(res[lay]["max_abs_err"])
                                        for lay in ("plain", "packed") if lay in res]),
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
        entry("base", "k8s1m_tpu/ops/pallas_topk.py:139", main_res,
              max(err3, float(wide["max_abs_err"]["base"]))),
        entry("aff", "k8s1m_tpu/ops/pallas_topk.py:285", path_a,
              max(err3b, float(wide["max_abs_err"]["aff"]))),
        entry("cons", "k8s1m_tpu/ops/pallas_topk.py:448", path_b, err3c),
        {
            "name": "delta_plane_topk",
            "route": "cuda",
            "source": "k8s1m_tpu_torch/csrc/delta_topk.cu",
            "replaces": "k8s1m_tpu/ops/pallas_topk.py:1041",
            "launches": sum(r["launches"] for r in path_c.values())
                        + coord_launches["delta_plane_topk"]
                        + mesh_launches["delta_plane_topk"],
            "coordinator_launches": coord_launches["delta_plane_topk"],
            "mesh_launches": mesh_launches["delta_plane_topk"],
            "max_abs_err": max([err3d] + [float(r[lay]["max_abs_err"])
                                          for r in path_c.values()
                                          for lay in ("plain", "packed") if lay in r]),
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
                       "affinity_vs_plain_max_abs_err": err3b, "wide_vs_plain": wide,
                       "constraints_vs_plain_max_abs_err": err3c,
                       "delta_vs_plain_max_abs_err": err3d, "worst_case": worst,
                       "main_path": main_res, "path_a": path_a, "path_b": path_b,
                       "path_c": path_c, "coordinator_parity": parity,
                       "coordinator": coord, "kernel_probe": probe,
                       "megarow": megarow, "composed_parity": composed,
                       "breaker": breaker, "trace": trace, "trace_parity": trace_parity,
                       "webhook": webhook, "webhook_parity": webhook_parity,
                       "drills": drills, "hostpath": hostpath, "latency_curve": curve,
                       "failover": failover, "failover_parity": failover_parity,
                       "wire": wire, "wire_parity": wire_parity, "shards": shards,
                       "shard_parity": shard_parity, "experiment": experiment,
                       "experiment_parity": experiment_parity, "mesh": mesh,
                       "mesh_parity": mesh_parity, "mesh_bench": mesh_bench, "tier": tier,
                       "steady": steady, "steady_parity": steady_parity,
                       "harness": harness, "harness_parity": harness_parity,
                       "fidelity": fidelity, **kernels},
                      f, indent=1, default=str)
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    finally:
        _stop_cpu_children()
