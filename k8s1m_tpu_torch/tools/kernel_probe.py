"""Component-cost probe of the candidate step, by plugin knock-out.

The port's counterpart of ``k8s1m_tpu/tools/kernel_probe.py``.  Times the
candidate step (filter + score + hashed priority + top-K, no assignment)
over a table with individual score plugins zeroed: ``full - no-X`` is
plugin X's cost and ``filter-only`` the filter + top-K floor.

    python -m k8s1m_tpu_torch.tools.kernel_probe --nodes 53248 --batch 8192
    python -m k8s1m_tpu_torch.tools.kernel_probe --backend xla --packing packed

``--backend pallas`` times the hand-written fused kernel
(``ops/fused_topk.py``), ``--backend xla`` the torch-op scan path
(``engine/cycle.py::filter_score_topk``).  The default shape is the 1M-node
table's 5% window (13 x 4096 rows).  Prints one JSON line per variant.

One difference from the JAX tool: there a zeroed weight is a static
argument and the plugin is dead-code eliminated from the compiled
program.  On the CUDA kernel a zeroed weight is a runtime branch
(``csrc/fused_topk.cuh``, the score block), and the kernel scores once per
(pod group, row): the probe's uniform pods form one group, so the
knock-out deltas on ``pallas`` come out near zero — the score is a small
share of a scan that runs per pair.  They are reported raw, as the JAX
tool reports them.  On ``xla`` each plugin runs per (pod, row) pair and
the deltas mean what they mean in JAX.  Each variant is the minimum over
``repeats`` blocks of ``steps`` calls, every block closed by
``torch.cuda.synchronize()`` on a card.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from k8s1m_tpu_torch.cluster import populate_kwok_nodes, uniform_pods
from k8s1m_tpu_torch.config import PodSpec, TableSpec
from k8s1m_tpu_torch.plugins.registry import Profile
from k8s1m_tpu_torch.snapshot.node_table import NodeTableHost
from k8s1m_tpu_torch.snapshot.pod_encoding import PodBatchHost


def variants() -> dict[str, Profile]:
    base = dict(node_affinity=0, topology_spread=0, interpod_affinity=0)
    return {
        "full": Profile(**base),
        "no-least-allocated": Profile(least_allocated=0, **base),
        "no-balanced-allocation": Profile(balanced_allocation=0, **base),
        "no-taint-toleration": Profile(taint_toleration=0, **base),
        "filter-only": Profile(
            least_allocated=0, balanced_allocation=0, taint_toleration=0, **base,
        ),
    }


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def profile_stages(table, enc, *, chunk: int, k: int = 4, steps: int = 3,
                   repeats: int = 3, backend: str = "xla",
                   only: set[str] | None = None) -> dict:
    """Per-stage ms per batch by plugin knock-out over ``table`` (either
    layout; a packed table decodes in the step, so the probe times the
    production decode too).  ``enc`` is a PodBatchHost sharing the table's
    vocab; the batch is ``enc.spec.batch`` uniform pods.  Seeds 0..steps
    drive the hash (the first call settles, then ``repeats`` blocks).

    Returns {"backend", "repeats", "ms_per_batch": {variant: ms},
    "stages": {plugin: full - knocked-out ms, "filter_topk_floor": ms}}."""
    from k8s1m_tpu_torch.engine.cycle import filter_score_topk
    from k8s1m_tpu_torch.ops.fused_topk import fused_topk
    from k8s1m_tpu_torch.snapshot.pod_encoding import unpack_pod_batch

    if repeats < 1:
        raise ValueError(f"repeats must be >= 1, got {repeats}")
    if backend not in ("pallas", "xla"):
        raise ValueError(f"backend must be 'pallas' or 'xla', got {backend!r}")
    device = table.cpu_req.device
    pods = uniform_pods(enc.spec.batch)
    picked = variants()
    if only:
        picked = {n: p for n, p in picked.items() if n in only}

    if backend == "pallas":
        batch = enc.encode(pods, device=device)

        def run(prof, i):
            return fused_topk(table, batch, i, prof, k=k, with_affinity=False)[0]
    else:
        packed = enc.encode_packed(pods)
        batch = unpack_pod_batch(packed.ints, packed.bools, packed.spec,
                                 packed.table_spec, packed.groups, device=device)

        def run(prof, i):
            return filter_score_topk(table, batch, i, prof, chunk=chunk, k=k,
                                     groups=packed.groups).idx

    ms: dict[str, float] = {}
    for name, prof in picked.items():
        run(prof, 0)
        _sync(device)
        best = None
        for _ in range(repeats):
            t0 = time.perf_counter()
            for i in range(steps):
                run(prof, i + 1)
            _sync(device)
            dt = (time.perf_counter() - t0) / steps * 1e3
            best = dt if best is None else min(best, dt)
        ms[name] = round(best, 3)

    stages: dict[str, float] = {}
    if "full" in ms:
        for knock, label in (
            ("no-least-allocated", "least_allocated"),
            ("no-balanced-allocation", "balanced_allocation"),
            ("no-taint-toleration", "taint_toleration"),
        ):
            if knock in ms:
                stages[label] = round(ms["full"] - ms[knock], 3)
        if "filter-only" in ms:
            stages["filter_topk_floor"] = ms["filter-only"]
    return {"backend": backend, "repeats": repeats, "ms_per_batch": ms, "stages": stages}


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description="candidate-step component probe (port)")
    ap.add_argument("--nodes", type=int, default=13 * 4096,
                    help="table rows (default: the 1M-node table's 5%% window)")
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--chunk", type=int, default=1 << 12)
    ap.add_argument("--k", type=int, default=4)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--repeats", type=int, default=3,
                    help="timing blocks per variant; the minimum is reported")
    ap.add_argument("--only", default=None,
                    help="comma-separated variant names (default: all)")
    ap.add_argument("--backend", choices=("pallas", "xla"), default="pallas",
                    help="pallas times the fused CUDA kernel, xla the scan path's "
                    "filter_score_topk")
    ap.add_argument("--packing", choices=("off", "packed"), default=None,
                    help="table layout; unset defers to K8S1M_PACKING")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    from k8s1m_tpu_torch.device import resolve_device
    from k8s1m_tpu_torch.snapshot.packing import is_packed, pack_table_auto, resolve_packing

    device = resolve_device(args.device)
    packing = resolve_packing(args.packing)
    spec = TableSpec(max_nodes=args.nodes)
    host = NodeTableHost(spec)
    populate_kwok_nodes(host, args.nodes)
    if packing == "packed":
        table = pack_table_auto(host, spec, device)
    else:
        table = host.to_device(device)
    enc = PodBatchHost(PodSpec(batch=args.batch), spec, host.vocab)
    only = {n.strip() for n in args.only.split(",")} if args.only else None
    lines = []
    for name in variants():
        if only and name not in only:
            continue
        res = profile_stages(table, enc, chunk=args.chunk, k=args.k, steps=args.steps,
                             repeats=args.repeats, backend=args.backend, only={name})
        dt_ms = res["ms_per_batch"][name]
        line = {
            "variant": name,
            "backend": args.backend,
            "repeats": args.repeats,
            # The layout in effect: pack_table_auto falls back to the plain
            # layout when the taint slots outgrow the meta word.
            "packing": "packed" if is_packed(table) else "off",
            "ms_per_batch": dt_ms,
            "binds_per_sec_equiv": round(args.batch / (dt_ms / 1e3), 1) if dt_ms else None,
            "nodes": args.nodes,
            "batch": args.batch,
            "device": str(device),
        }
        print(json.dumps(line), flush=True)
        lines.append(line)
    return lines


if __name__ == "__main__":
    main()
