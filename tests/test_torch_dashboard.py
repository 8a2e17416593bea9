"""The port's dashboard generator (``obs/dashboard.py``), its
``Registry.metrics()`` and its log shipper (``obs/logship.py``) on the CPU,
against the JAX package's.

The twin of ``tests/test_obs_multihost.py::
test_dashboard_covers_registered_metrics`` over the port's registry; the
port's panels for the metrics both packages declare equal the JAX
generator's; every metric the port declares lands in a row.  The shipper
funnels two children's lines into one JSONL in both packages alike.

Tolerance: exact equality.
"""

import _torch_cpu  # noqa: F401  (bounds torch's CPU threads first)

import json
import subprocess
import sys

import k8s1m_tpu.cluster.kwok_controller  # noqa: F401  (JAX metrics register)
import k8s1m_tpu.control.coordinator  # noqa: F401
import k8s1m_tpu.store.etcd_server  # noqa: F401
import k8s1m_tpu_torch.cluster.kubelet_sim  # noqa: F401  (port metrics register)
import k8s1m_tpu_torch.cluster.kwok_controller  # noqa: F401
import k8s1m_tpu_torch.control.coordinator  # noqa: F401
import k8s1m_tpu_torch.store.etcd_server  # noqa: F401
from k8s1m_tpu.obs import dashboard as jdashboard
from k8s1m_tpu.obs import logship as jlogship
from k8s1m_tpu.obs.metrics import REGISTRY as JREGISTRY
from k8s1m_tpu_torch.obs import dashboard, logship
from k8s1m_tpu_torch.obs.metrics import REGISTRY, Counter, Registry


def test_dashboard_covers_registered_metrics():
    d = dashboard.build_dashboard()
    json.dumps(d)  # must be serializable
    rows = [p for p in d["panels"] if p["type"] == "row"]
    panels = [p for p in d["panels"] if p["type"] != "row"]
    assert {"Scheduler", "Store (mem-etcd)", "KWOK nodes"} <= {r["title"] for r in rows}
    # Every panel's expr references a registered metric.
    names = {m.name for m in REGISTRY.metrics()}
    for p in panels:
        for t in p["targets"]:
            assert any(n in t["expr"] for n in names), t["expr"]
    # No two panels occupy the same grid position.
    positions = [(p["gridPos"]["x"], p["gridPos"]["y"]) for p in d["panels"]]
    assert len(positions) == len(set(positions))


def test_every_port_metric_lands_in_a_row():
    prefixes = [p for _, ps in dashboard.ROWS for p in ps]
    assert dashboard.ROWS == jdashboard.ROWS
    for m in REGISTRY.metrics():
        assert any(m.name.startswith(p) for p in prefixes), m.name


def test_panels_equal_jax_for_shared_metrics():
    """Over two registries holding the same metrics, the generators emit
    the same dashboard."""
    shared = {m.name for m in REGISTRY.metrics()} & {m.name for m in JREGISTRY.metrics()}
    assert {"coordinator_queue_depth", "kwok_node_lease_delay_seconds"} <= shared
    regs = []
    for reg in (REGISTRY, JREGISTRY):
        sub = Registry()
        for m in reg.metrics():
            if m.name in shared:
                sub._metrics[m.name] = m
        regs.append(sub)
    assert dashboard.build_dashboard(regs[0]) == jdashboard.build_dashboard(regs[1])


def test_registry_metrics_in_registration_order():
    reg = Registry()
    made = [Counter(f"t_{i}_total", "help", registry=reg) for i in range(3)]
    assert reg.metrics() == made


def _ship(mod, tmp_path) -> list:
    ship = mod.LogShipper(str(tmp_path), name="run.jsonl")
    for src in ("a", "b"):
        proc = subprocess.Popen([sys.executable, "-c", f"import sys; sys.stderr.write('{src}1\\n{src}2\\n')"],
                                stderr=ship.pipe(src))
        proc.wait()
    ship.close()
    with open(ship.path) as f:
        recs = [json.loads(line) for line in f]
    return sorted((r["src"], r["line"]) for r in recs)


def test_logship_one_jsonl_equals_jax(tmp_path):
    port = _ship(logship, tmp_path / "port")
    assert port == [("a", "a1"), ("a", "a2"), ("b", "b1"), ("b", "b2")]
    assert port == _ship(jlogship, tmp_path / "jax")
