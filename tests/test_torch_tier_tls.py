"""The port's secured watch-cache tier (TLS + bearer auth on
``store/wire_server.py``, the chain from ``cluster/certs.py``) against the
JAX package's, on the CPU.

Every case of ``tests/test_tier_tls.py`` runs on the JAX stack (JAX store
server, JAX tier on grpcio, JAX clients) and on the port's (the port's
asyncio store server, tier, clients and load tools), and records what the
clients saw: revisions, values, the watch's events, the status code and
message of a call without the right token, a plaintext client's refusal,
the load generator's report.  The records must be equal.  Besides:

- the JAX grpcio ``EtcdClient`` over ``secure_channel_for`` with the token
  records the same against the port's tier as against the JAX tier, and is
  refused the same without it;
- ``provision`` with ``cryptography`` blocked takes its ``openssl`` path
  (the one a machine without ``cryptography`` takes), and the port's tier
  serves that chain to a client that trusts its CA, while a client that
  trusts another CA fails its handshake.

Tolerance: exact equality.
"""

import _torch_cpu  # noqa: F401  (bounds torch's CPU threads first)

import asyncio
import contextlib
import dataclasses
import io
import re
import ssl
import sys
import time
import urllib.request

import grpc
import pytest

from k8s1m_tpu.cluster.certs import provision as jax_provision
from k8s1m_tpu.store import watch_cache as jax_wc
from k8s1m_tpu.store.etcd_client import EtcdClient as JaxClient
from k8s1m_tpu.store.etcd_client import secure_channel_for as jax_secure_channel_for
from k8s1m_tpu.store.etcd_server import serve as jax_serve
from k8s1m_tpu.store.native import MemStore as JaxMemStore
from k8s1m_tpu.store.remote import RemoteStore as JaxRemoteStore
from k8s1m_tpu.tools import make_nodes as jax_make_nodes
from k8s1m_tpu_torch.cluster import certs as port_certs
from k8s1m_tpu_torch.store import etcd_server as port_etcd_server
from k8s1m_tpu_torch.store import watch_cache as port_wc
from k8s1m_tpu_torch.store.etcd_client import EtcdClient as PortClient
from k8s1m_tpu_torch.store.native import MemStore as PortMemStore
from k8s1m_tpu_torch.store.native import prefix_end
from k8s1m_tpu_torch.store.remote import RemoteStore as PortRemoteStore
from k8s1m_tpu_torch.store.server_main import serve_subprocess
from k8s1m_tpu_torch.store.wire import WireError
from k8s1m_tpu_torch.tools import make_nodes as port_make_nodes

PFX = b"/registry/pods/tlsns/"
TOKEN = "rig-scrape-token"


@dataclasses.dataclass(frozen=True)
class Pkg:
    name: str
    MemStore: type
    serve: object
    stop: object
    wc: object
    Client: type
    RemoteStore: type
    make_nodes: object
    provision: object


async def _jax_serve(store):
    return await jax_serve(store, port=0)


async def _port_serve(store):
    return await port_etcd_server.serve(store, port=0)


JAX = Pkg("jax", JaxMemStore, _jax_serve, lambda s: s.stop(None), jax_wc, JaxClient,
          JaxRemoteStore, jax_make_nodes, jax_provision)
PORT = Pkg("port", PortMemStore, _port_serve, lambda s: s.stop(), port_wc, PortClient,
           PortRemoteStore, port_make_nodes, port_certs.provision)
PKGS = {"jax": JAX, "port": PORT}


def _status(e: Exception) -> tuple:
    """(code name, details) of a failed call from either client."""
    if isinstance(e, grpc.RpcError):
        return e.code().name, e.details()
    assert isinstance(e, WireError), e
    return e.code.name, e.details


def _run_secured(pkg: Pkg, tmp_path, scenario):
    """``scenario(pkg, certs, tier)`` on a fresh loop against ``pkg``'s tier
    (TLS + ``TOKEN``) over ``pkg``'s store server."""

    async def go():
        certs = pkg.provision(str(tmp_path / pkg.name))
        store = pkg.MemStore()
        server, port = await pkg.serve(store)
        sclient = pkg.Client(f"127.0.0.1:{port}")
        await sclient.put(PFX + b"seed", b"s0")
        tier = await pkg.wc.serve_watch_cache(f"127.0.0.1:{port}", [PFX], port=0, tls=certs,
                                              auth_token=TOKEN)
        try:
            return await scenario(pkg, certs, tier)
        finally:
            await sclient.close()
            await tier.close()
            await pkg.stop(server)
            await asyncio.get_running_loop().shutdown_default_executor()
            store.close()

    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(go())
    finally:
        loop.close()


async def s_tls_bearer_roundtrip_and_watch(pkg, certs, tier, client=None):
    c = client or pkg.Client(f"127.0.0.1:{tier.port}", ca_pem=certs.ca_pem, token=TOKEN)
    rev = await c.put(PFX + b"a", b"v1")
    assert rev > 0
    r = await c.range(PFX + b"a")
    assert r.kvs[0].value == b"v1"
    async with c.watch(PFX + b"a") as w:
        await c.put(PFX + b"a", b"v2")
        batch = await w.next(timeout=10)
        assert batch.events and batch.events[0].kv.value == b"v2"
    await c.close()
    return rev, [(kv.key, kv.value, kv.mod_revision) for kv in r.kvs], [
        (e.kv.key, e.kv.value, e.kv.mod_revision) for e in batch.events]


async def s_missing_or_wrong_token_unauthenticated(pkg, certs, tier):
    out = []
    for token, call in ((None, lambda c: c.range(PFX + b"seed")),
                        ("nope", lambda c: c.put(PFX + b"x", b"v")),
                        ("nope", lambda c: c.watch(PFX).__aenter__())):
        c = pkg.Client(f"127.0.0.1:{tier.port}", ca_pem=certs.ca_pem, token=token)
        with pytest.raises((grpc.RpcError, WireError)) as ei:
            await call(c)
        code, details = _status(ei.value)
        assert code == "UNAUTHENTICATED" and details == "invalid or missing bearer token"
        out.append((code, details))
        await c.close()
    return out


async def s_plaintext_client_rejected(pkg, certs, tier):
    plain = pkg.Client(f"127.0.0.1:{tier.port}")
    with pytest.raises((grpc.RpcError, WireError)):
        await asyncio.wait_for(plain.range(PFX + b"seed"), timeout=10)
    await plain.close()
    return "rejected"


async def s_load_generator_against_secured_tier(pkg, certs, tier):
    args = pkg.make_nodes.parse_args([
        "--target", f"127.0.0.1:{tier.port}", "--count", "8", "--quiet",
        "--concurrency", "4", "--clients", "1", "--ca-pem", certs.ca_pem, "--token", TOKEN,
    ])
    out = await pkg.make_nodes.amain(args)
    assert out["count"] == 8 and out["errors"] == 0
    resp = await _secured_prefix(pkg, certs, tier, b"/registry/minions/")
    return out["count"], out["errors"], resp


async def _secured_prefix(pkg, certs, tier, prefix: bytes):
    c = pkg.Client(f"127.0.0.1:{tier.port}", ca_pem=certs.ca_pem, token=TOKEN)
    try:
        resp = await c.prefix(prefix, keys_only=True)
        return [kv.key for kv in resp.kvs]
    finally:
        await c.close()


async def s_sync_remote_store_over_tls(pkg, certs, tier):
    def sync_calls():
        rs = pkg.RemoteStore(f"127.0.0.1:{tier.port}", ca_pem=certs.ca_pem, token=TOKEN)
        try:
            rev = rs.put(PFX + b"sync", b"v")
            assert rev > 0
            kv = rs.get(PFX + b"sync")
            assert kv.value == b"v"
            return rev, kv.value, kv.mod_revision
        finally:
            rs.close()

    return await asyncio.wait_for(asyncio.to_thread(sync_calls), timeout=30)


SCENARIOS = {f.__name__[2:]: f for f in (
    s_tls_bearer_roundtrip_and_watch, s_missing_or_wrong_token_unauthenticated,
    s_plaintext_client_rejected, s_load_generator_against_secured_tier,
    s_sync_remote_store_over_tls,
)}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_secured_tier_equals_jax(name, tmp_path):
    recs = {k: _run_secured(pkg, tmp_path, SCENARIOS[name]) for k, pkg in PKGS.items()}
    assert recs["port"] == recs["jax"]


async def s_grpcio_client(pkg, certs, tier):
    """The JAX grpcio client over ``secure_channel_for`` with the token:
    the round trip and watch, then a call without the token."""
    target = f"127.0.0.1:{tier.port}"
    c = JaxClient(target, channel=jax_secure_channel_for(target, certs.ca_pem, TOKEN))
    got = await s_tls_bearer_roundtrip_and_watch(pkg, certs, tier, client=c)
    bare = JaxClient(target, channel=jax_secure_channel_for(target, certs.ca_pem))
    with pytest.raises(grpc.RpcError) as ei:
        await bare.range(PFX + b"seed")
    await bare.close()
    return got, _status(ei.value)


def test_grpcio_client_against_the_port_tier(tmp_path):
    recs = {k: _run_secured(pkg, tmp_path, s_grpcio_client) for k, pkg in PKGS.items()}
    assert recs["port"] == recs["jax"]
    assert recs["port"][1] == ("UNAUTHENTICATED", "invalid or missing bearer token")


def test_provision_without_cryptography_uses_openssl(tmp_path, monkeypatch):
    """With ``cryptography`` blocked the chain comes from the ``openssl``
    command: the port's tier serves it, a client trusting the CA reads
    through it, one trusting another CA fails, and no CA key is left."""
    monkeypatch.setitem(sys.modules, "cryptography", None)
    with pytest.raises(ImportError):
        import cryptography  # noqa: F401
    certs = port_certs.provision(str(tmp_path / "openssl"))
    assert sorted(p.name for p in (tmp_path / "openssl").iterdir()) == [
        "ca.pem", "cert.pem", "key.pem"]
    ctx = certs.client_context()
    assert ctx.verify_mode == ssl.CERT_REQUIRED
    monkeypatch.delitem(sys.modules, "cryptography")
    other = port_certs.provision(str(tmp_path / "other"))

    async def scenario(pkg, _certs, tier):
        got = await s_tls_bearer_roundtrip_and_watch(pkg, certs, tier)
        stranger = PortClient(f"127.0.0.1:{tier.port}", ca_pem=other.ca_pem, token=TOKEN)
        with pytest.raises(WireError) as ei:
            await stranger.range(PFX + b"seed")
        await stranger.close()
        assert ei.value.code.name == "UNAVAILABLE" and "CERTIFICATE_VERIFY_FAILED" in str(
            ei.value)
        return got

    port = dataclasses.replace(PORT, provision=lambda _d: certs)
    got = _run_secured(port, tmp_path, scenario)
    assert got[1][0][1] == b"v1" and got[2][0][1] == b"v2"


def test_watch_through_the_secured_tier_sees_every_event(tmp_path):
    """A range watch over TLS with the token delivers every write made
    through the tier, in order, on both tiers alike."""

    async def scenario(pkg, certs, tier):
        c = pkg.Client(f"127.0.0.1:{tier.port}", ca_pem=certs.ca_pem, token=TOKEN)
        try:
            got = []
            async with c.watch(PFX, prefix_end(PFX)) as w:
                revs = [await c.put(PFX + b"k%02d" % i, b"v%d" % i) for i in range(40)]
                while len(got) < 40:
                    b = await w.next(timeout=10)
                    got += [(e.kv.key, e.kv.value, e.kv.mod_revision) for e in b.events]
            return revs, got
        finally:
            await c.close()

    recs = {k: _run_secured(pkg, tmp_path, scenario) for k, pkg in PKGS.items()}
    assert recs["port"] == recs["jax"]


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _flags(main) -> set:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), pytest.raises(SystemExit):
        main(["--help"])
    return set(re.findall(r"--[a-z][a-z-]*", buf.getvalue()))


def test_main_takes_every_flag_of_the_jax_tier():
    assert _flags(port_wc.main) == _flags(jax_wc.main)


def test_tier_child_process_serves_tls_token_and_metrics(tmp_path):
    """``python -m k8s1m_tpu_torch.store.watch_cache`` in a child, in front
    of the port's store server in another, with TLS, the token, ``btree``,
    its own window, lag budget, pumps and ``--metrics-port``: a write and a
    read through it, and its ``watchcache_*`` counters on ``/metrics``;
    both children reaped."""
    certs = port_certs.provision(str(tmp_path / "certs"))
    mport = _free_port()
    with serve_subprocess() as (sproc, upstream):
        with port_wc.tier_subprocess(
                upstream, "--prefix", "/registry/", "--index", "btree", "--window", "4096",
                "--lag-budget", "256", "--pumps", "2", "--metrics-port", str(mport),
                "--tls-cert", certs.cert_pem, "--tls-key", certs.key_pem,
                "--auth-token", TOKEN) as (tproc, target):
            rs = PortRemoteStore(target, ca_pem=certs.ca_pem, token=TOKEN)
            try:
                rev = rs.put(PFX + b"child", b"v")
                kv = rs.get(PFX + b"child")
                assert kv.value == b"v" and kv.mod_revision == rev
            finally:
                rs.close()
            for _ in range(200):
                text = urllib.request.urlopen(f"http://127.0.0.1:{mport}/metrics",
                                              timeout=10).read().decode()
                if "watchcache_events_in_total 1" in text:
                    break
                time.sleep(0.02)
            assert "watchcache_events_in_total 1" in text
    assert sproc.returncode is not None and tproc.returncode is not None
