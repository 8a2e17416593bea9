"""The port's /metrics endpoint (``k8s1m_tpu_torch/obs/http.py``) on the CPU:
twins of ``tests/test_metrics_http.py`` (plain scrape, TLS with basic
auth, the histogram's q=0 edge), each held to the JAX endpoint's answer on
the same request, and ``server_main --metrics-port`` serving a scrape.

Tolerance: exact equality (status codes, scrape counters, quantiles).
"""

import _torch_cpu  # noqa: F401  (bounds torch's CPU threads first)

import base64
import os
import socket
import subprocess
import sys
import urllib.error
import urllib.request

from k8s1m_tpu.cluster.certs import provision
from k8s1m_tpu.obs import http as jhttp
from k8s1m_tpu.obs.metrics import Histogram as JaxHistogram
from k8s1m_tpu.obs.metrics import Registry as JaxRegistry
from k8s1m_tpu_torch.obs import http as thttp
from k8s1m_tpu_torch.obs.metrics import Histogram, Registry
from k8s1m_tpu_torch.store.server_main import child_env

AUTH = "Basic " + base64.b64encode(b"scraper:s3cret").decode()


def _get(url, ctx=None, headers=None):
    req = urllib.request.Request(url, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=5, context=ctx) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, b""


def _serve_both(**kw):
    return [mod.start_metrics_server(0, **kw) for mod in (thttp, jhttp)]


def _stop(servers):
    for s in servers:
        s.shutdown()
        s.server_close()


def test_plain_metrics_roundtrip():
    servers = _serve_both()
    try:
        seen = []
        for s in servers:
            status, body = _get(f"http://127.0.0.1:{s.server_port}/metrics")
            missing, _ = _get(f"http://127.0.0.1:{s.server_port}/nope")
            seen.append((status, isinstance(body, bytes), missing, s.scrape_stats.snapshot()))
        assert seen[0] == seen[1]
        assert seen[0] == (200, True, 404, {"scrapes": 1, "denied": 0, "not_found": 1})
    finally:
        _stop(servers)


def test_tls_basic_auth_metrics(tmp_path):
    certs = provision(str(tmp_path))
    servers = _serve_both(ssl_context=certs.server_context(), basic_auth=("scraper", "s3cret"))
    ctx = certs.client_context()
    try:
        seen = []
        for s in servers:
            url = f"https://127.0.0.1:{s.server_port}/metrics"
            denied, _ = _get(url, ctx=ctx)
            ok, _ = _get(url, ctx=ctx, headers={"Authorization": AUTH})
            seen.append((denied, ok, s.scrape_stats.snapshot()))
        assert seen[0] == seen[1]
        assert seen[0] == (401, 200, {"scrapes": 1, "denied": 1, "not_found": 0})
    finally:
        _stop(servers)


def test_histogram_quantile_zero_reports_lower_edge():
    """q=0 reports the distribution's lower edge, not the first bucket's
    upper bound when that bucket is empty; q=1 the top bucket's bound."""
    got = []
    for hist, reg in ((Histogram, Registry), (JaxHistogram, JaxRegistry)):
        h = hist("q0_pin", "t", (), buckets=(0.1, 1.0, 10.0), registry=reg())
        h.observe(5.0)
        got.append((h.quantile(0.0), h.quantile(0.5), h.quantile(1.0)))
    assert got[0] == got[1]
    assert got[0][0] == 0.0 and got[0][2] == 10.0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_server_main_metrics_port_serves_a_scrape():
    """``python -m k8s1m_tpu_torch.store.server_main --metrics-port P`` keeps
    running and answers ``GET /metrics`` with the port's registry."""
    root, env = child_env()
    mport = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "k8s1m_tpu_torch.store.server_main", "--port", "0",
         "--host", "127.0.0.1", "--wal-default", "none", "--metrics-port", str(mport)],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True, env=env, cwd=root)
    try:
        line = proc.stdout.readline().strip()
        assert line.isdigit(), (line, proc.poll())
        status, body = _get(f"http://127.0.0.1:{mport}/metrics")
        assert status == 200
        assert b"memstore_relist_compacted_retries_total" in body
        assert proc.poll() is None
    finally:
        proc.terminate()
        proc.wait(timeout=10)
        proc.stdout.close()
    assert proc.returncode is not None
    assert os.path.isdir(root)



def test_registry_render_equals_jax():
    """The port's text exposition (``Registry.render``: counters, gauges
    with a callback, labelled histograms) is byte-equal to the JAX
    registry's for the same metrics and samples."""
    from k8s1m_tpu.obs import metrics as jm
    from k8s1m_tpu_torch.obs import metrics as tm

    texts = []
    for m in (tm, jm):
        reg = m.Registry()
        c = m.Counter("t_total", "a counter", ("group",), registry=reg)
        g = m.Gauge("t_gauge", "a gauge", ("kind",), registry=reg)
        h = m.Histogram("t_seconds", "a histogram", ("group",), buckets=(0.1, 1.0, 10.0),
                        registry=reg)
        c.inc(3, group="0")
        c.inc(group="1")
        g.set(2.5, kind="set")
        g.set_function(lambda: 7, kind="fn")
        h.observe_many([0.05, 0.5, 5.0, 50.0], group="0")
        h.observe(0.2, group="1")
        texts.append(reg.render())
    assert texts[0] == texts[1]
    assert 't_seconds_bucket{group="0",le="+Inf"} 4' in texts[0]
