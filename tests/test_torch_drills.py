"""The port's drills and host-path tools against the JAX package's, on the CPU.

- ``overload_drill --smoke`` and ``tenantfair_drill --smoke`` in both
  packages: both pass, and their evidence documents are equal once the
  port's ``device`` key is removed (no key of either drill holds a host
  timing: both run on a virtual clock of scheduling ticks).
- ``hostpath_bench --smoke --device cpu`` passes its gates, and its
  encoded batches equal the JAX tool's, array for array, at the same seed.
- ``latency_curve`` with two points at 1,024 nodes on the CPU writes two
  rows carrying the JAX tool's row keys.

Tolerance: exact, apart from the wall-clock fields of hostpath_bench and
latency_curve, which are only checked for presence.
"""

import _torch_cpu  # noqa: F401  (bounds torch's CPU threads first)

import contextlib
import io
import json

import numpy as np
import pytest

# Keys of the port's evidence that the JAX drills do not have.
PORT_ONLY_KEYS = ("device",)


def _quiet(fn, *args):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args)


@pytest.mark.parametrize("drill", ["overload_drill", "tenantfair_drill"])
def test_drill_smoke_evidence_equals_jax(drill):
    import importlib

    port = importlib.import_module(f"k8s1m_tpu_torch.tools.{drill}")
    jax_tool = importlib.import_module(f"k8s1m_tpu.tools.{drill}")
    got = _quiet(port.main, ["--smoke", "--device", "cpu"])
    want = _quiet(jax_tool.main, ["--smoke"])
    assert got["device"] == "cpu"
    assert got["passed"] and want["passed"]
    for key in PORT_ONLY_KEYS:
        got.pop(key)
    assert got == want


def test_hostpath_bench_smoke_and_encode_equal_jax():
    from k8s1m_tpu.tools import hostpath_bench as jhb
    from k8s1m_tpu_torch.tools import hostpath_bench as hb

    report = _quiet(hb.main, ["--smoke", "--device", "cpu"])
    d = report["detail"]
    assert d["byte_identical"] and report["value"] >= d["gate"] == hb.GATE_SMOKE
    assert d["cycle"]["device"] == "cpu" and d["cycle"]["backend"] == "xla"
    assert d["encode"]["cache_hit_rate"] == 1.0

    args, jargs = hb.parse_args(["--smoke"]), jhb.parse_args(["--smoke"])
    host, jhost = hb.build_vocab(args.nodes, args.seed), jhb.build_vocab(jargs.nodes, jargs.seed)
    assert host._row_of == jhost._row_of
    spec = hb.PodSpec(batch=args.batch, query_keys=max(64, args.batch // 4 + 16))
    jspec = jhb.PodSpec(batch=args.batch, query_keys=max(64, args.batch // 4 + 16))
    encoders = [
        (hb.PodBatchHost(spec, host.spec, host.vocab),
         jhb.PodBatchHost(jspec, jhost.spec, jhost.vocab)),
        (hb.HotPodBatchHost(spec, host.spec, host.vocab, cache=hb.EncodeCache()),
         jhb.HotPodBatchHost(jspec, jhost.spec, jhost.vocab, cache=jhb.EncodeCache())),
    ]
    pods, jpods = hb.make_pods(args, 0), jhb.make_pods(jargs, 0)
    n = 0
    for bp, jbp in zip(hb.batches(pods, args.batch), jhb.batches(jpods, args.batch)):
        for enc, jenc in encoders:
            a, b = enc.encode_packed(bp), jenc.encode_packed(jbp)
            assert a.groups == b.groups
            np.testing.assert_array_equal(a.ints, b.ints)
            np.testing.assert_array_equal(a.bools, b.bools)
            assert a.fields.keys() == b.fields.keys()
            for name in a.fields:
                np.testing.assert_array_equal(a.fields[name], b.fields[name], err_msg=name)
        n += 1
    assert n == args.pods // args.batch


def test_hostpath_bench_team_pool_fits_the_taint_vocabulary():
    """Above 3,047 nodes the JAX tool's team taints overflow the default
    taint vocabulary; the port caps the pool there and is the JAX fleet
    below it."""
    from k8s1m_tpu.tools import hostpath_bench as jhb
    from k8s1m_tpu_torch.tools import hostpath_bench as hb

    with pytest.raises(ValueError, match="max_taint_ids"):
        jhb.build_vocab(3072, 0)
    host = hb.build_vocab(3072, 0)
    assert len(host._row_of) == 3072
    small, jsmall = hb.build_vocab(3047, 1), jhb.build_vocab(3047, 1)
    np.testing.assert_array_equal(small.taint_id, jsmall.taint_id)


def test_latency_curve_two_points_on_cpu(tmp_path, monkeypatch):
    from k8s1m_tpu.tools import latency_curve as jlc
    from k8s1m_tpu_torch.tools import latency_curve as lc

    out = tmp_path / "curve.jsonl"
    rows = _quiet(lc.main, ["--device", "cpu", "--nodes", "1024", "--rates", "500,1000",
                            "--seconds", "0.25", "--min-pods", "128", "--batch", "64",
                            "--out", str(out)])
    disk = [json.loads(line) for line in out.read_text().splitlines()]
    assert disk == rows and [r["rate"] for r in rows] == [500, 1000]
    # The JAX tool's row keys: its run_point over a stand-in subprocess
    # that prints a sched_bench report.
    detail = {"binds_per_sec": 1.0, "p50_ms": 1.0, "p95_ms": 1.0, "p99_ms": 1.0,
              "bound": 1}

    class Done:
        returncode = 0
        stdout = json.dumps({"detail": detail}) + "\n"

    monkeypatch.setattr(jlc.subprocess, "run", lambda *a, **k: Done())
    want = set(jlc.run_point(jlc.parse_args([]), 500))
    for r in rows:
        assert set(r) == want
        assert r["bound"] == r["pods"] - 1
        assert r["p50_ms"] <= r["p95_ms"] <= r["p99_ms"]
