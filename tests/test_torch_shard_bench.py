"""The port's ``shard_bench`` (``k8s1m_tpu_torch/tools/shard_bench.py``) on
the CPU, against the JAX tool.

Twin of tests/test_scale_tools.py::test_shard_bench_smoke_two_workers_disjoint_and_done:
real subprocesses (the port's store server and two worker processes, each a
``ShardMember``), the real wire, the machine-readable result line.  The port
runs with ``--device cpu`` from a directory outside the repository, the
repository on ``PYTHONPATH`` only for the parent; its report must carry
every key of the JAX tool's report at the same arguments, top level and per
worker.  A paced case (``--rate``), a worker that cannot open the card, and
the JAX-only ``--tpu-worker`` flag complete it.
"""

import _torch_cpu  # noqa: F401  (bounds torch's CPU threads first)

import json
import os
import subprocess
import sys

import pytest

from k8s1m_tpu_torch.tools import shard_bench

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = ["--nodes", "1024", "--pods", "300", "--shards", "2", "--batch", "64",
         "--score-pct", "100", "--json"]


def _run(cmd, cwd, env_over, timeout=420):
    env = {**os.environ, **env_over}
    return subprocess.run(cmd, cwd=cwd, env=env, timeout=timeout,
                          stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _result(proc):
    assert proc.returncode == 0, proc.stderr[-2000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _port(tmp_path, *extra):
    return _result(_run([sys.executable, "-m", "k8s1m_tpu_torch.tools.shard_bench", *SMOKE,
                         "--device", "cpu", *extra], tmp_path, {"PYTHONPATH": REPO}))


@pytest.fixture(scope="module")
def jax_report():
    return _result(_run([sys.executable, "-m", "k8s1m_tpu.tools.shard_bench", *SMOKE], REPO,
                        {"PYTHONPATH": "", "JAX_PLATFORMS": "cpu"}))


def _keys(report):
    top = set(report)
    workers = set().union(*(set(w) for w in report["per_worker"]))
    return top, workers


def _smoke_checks(out):
    assert out["metric"] == "shard_e2e_binds_per_sec"
    assert out["value"] > 0
    assert sum(out["pod_share"]) == out["pods"] == 300
    workers = out["per_worker"]
    assert len(workers) == 2 and all(w is not None for w in workers)
    assert all(w["done"] for w in workers)
    assert [w["bound"] for w in workers] == out["pod_share"]
    assert out["worker_rcs"] == [0, 0]
    assert out["device"] == "cpu" and out["backend"] == "xla"
    assert all(w["device"] == "cpu" and w["peak_card_mb"] is None for w in workers)
    # mask_rows' view at 1,024 rows: a new bool valid column and i32 pods_alloc.
    assert all(w["mask_rows_bytes"] == 1024 * (1 + 4) for w in workers)


def test_shard_bench_smoke_two_workers_disjoint_and_done(tmp_path, jax_report):
    out = _port(tmp_path)
    _smoke_checks(out)
    got, want = _keys(out), _keys(jax_report)
    assert want[0] <= got[0] and want[1] <= got[1]
    # The FNV split is the JAX tool's.
    assert out["pod_share"] == jax_report["pod_share"]
    assert [w["bound"] for w in jax_report["per_worker"]] == out["pod_share"]


def test_shard_bench_paced(tmp_path, jax_report):
    rate = 600
    out = _port(tmp_path, "--rate", str(rate))
    _smoke_checks(out)
    assert out["rate"] == rate
    # The producer emits pod i at i / rate seconds: the last bind comes after.
    assert out["window_s"] >= (out["pods"] - 1) / rate - 0.01
    got, want = _keys(out), _keys(jax_report)
    assert want[0] <= got[0] and want[1] <= got[1]


def test_worker_without_a_card_fails_the_run(tmp_path):
    """``--device cuda`` where ``torch.cuda.is_available()`` is False: each
    worker exits non-zero, the parent raises and prints no result."""
    proc = _run([sys.executable, "-m", "k8s1m_tpu_torch.tools.shard_bench", "--nodes", "64",
                 "--pods", "8", "--shards", "1", "--batch", "8", "--device", "cuda"],
                tmp_path, {"PYTHONPATH": REPO})
    assert proc.returncode != 0
    assert "worker failed to start" in proc.stderr
    assert "torch.cuda.is_available() is False" in proc.stderr
    assert "shard_e2e_binds_per_sec" not in proc.stdout


def test_tpu_worker_flag_is_not_ported():
    with pytest.raises(SystemExit):
        shard_bench.parse_args(["--tpu-worker", "0"])
    args = shard_bench.parse_args([])
    assert (args.device, args.backend, args.chunk) == ("cuda", "auto", None)
