"""The port's ``tools/kernel_probe.py`` on the CPU.

The JAX tool's smoke (tests/test_tools.py) on the port: one variant per
backend prints a JSON line with a positive time; ``profile_stages``
returns the JAX tool's keys and variant names (the times are this
host's, not compared).
"""

import _torch_cpu  # noqa: F401  (bounds torch's CPU threads first)

import json

import pytest

from k8s1m_tpu.cluster import populate_kwok_nodes as jax_populate
from k8s1m_tpu.config import PodSpec as JPodSpec
from k8s1m_tpu.config import TableSpec as JTableSpec
from k8s1m_tpu.snapshot import NodeTableHost as JNodeTableHost
from k8s1m_tpu.snapshot import PodBatchHost as JPodBatchHost
from k8s1m_tpu.tools import kernel_probe as jprobe
from k8s1m_tpu_torch.cluster import populate_kwok_nodes
from k8s1m_tpu_torch.config import PodSpec, TableSpec
from k8s1m_tpu_torch.snapshot.node_table import NodeTableHost
from k8s1m_tpu_torch.snapshot.pod_encoding import PodBatchHost
from k8s1m_tpu_torch.tools import kernel_probe


@pytest.mark.parametrize("backend,variant", [("pallas", "filter-only"), ("xla", "full")])
def test_kernel_probe_runs(capsys, backend, variant):
    kernel_probe.main(["--nodes", "256", "--batch", "32", "--chunk", "128", "--steps", "1",
                       "--only", variant, "--backend", backend, "--device", "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["variant"] == variant and out["backend"] == backend
    assert out["ms_per_batch"] > 0 and out["device"] == "cpu"


def test_profile_stages_keys_match_jax():
    spec = JTableSpec(max_nodes=256)
    jhost = JNodeTableHost(spec)
    jax_populate(jhost, 256)
    want = jprobe.profile_stages(jhost.to_device(), JPodBatchHost(JPodSpec(batch=32), spec,
                                                                   jhost.vocab),
                                 chunk=128, steps=1, repeats=1, backend="xla")
    host = NodeTableHost(TableSpec(max_nodes=256))
    populate_kwok_nodes(host, 256)
    enc = PodBatchHost(PodSpec(batch=32), host.spec, host.vocab)
    for backend in ("xla", "pallas"):
        got = kernel_probe.profile_stages(host.to_device("cpu"), enc, chunk=128, steps=1,
                                          repeats=2, backend=backend)
        assert got.keys() == want.keys() and got["backend"] == backend
        assert got["ms_per_batch"].keys() == want["ms_per_batch"].keys()
        assert got["stages"].keys() == want["stages"].keys()
        assert got["repeats"] == 2 and min(got["ms_per_batch"].values()) > 0
    with pytest.raises(ValueError):
        kernel_probe.profile_stages(host.to_device("cpu"), enc, chunk=128, repeats=0)
    assert list(kernel_probe.variants()) == list(jprobe.variants())
