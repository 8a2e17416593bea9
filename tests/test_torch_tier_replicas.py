"""Replicated watch-cache tiers over one store, the port's against the JAX
package's, on the CPU: the twins of the two cases of
``tests/test_tier_replicas.py`` that need no cluster harness.

Three tiers over one store server each hold ONE upstream watch; writes
through any replica reach every replica's watchers; a client of a replica
that dies resumes on a survivor from its last delivered revision with
nothing lost.  Each case runs on the JAX stack and on the port's, and the
records (revisions, values, the store's watch count) must be equal.

Tolerance: exact equality.
"""

import _torch_cpu  # noqa: F401  (bounds torch's CPU threads first)

import asyncio

import pytest

from k8s1m_tpu.store import watch_cache as jax_wc
from k8s1m_tpu.store.etcd_client import EtcdClient as JaxClient
from k8s1m_tpu.store.etcd_server import serve as jax_serve
from k8s1m_tpu.store.native import MemStore as JaxMemStore
from k8s1m_tpu_torch.store import etcd_server as port_etcd_server
from k8s1m_tpu_torch.store import watch_cache as port_wc
from k8s1m_tpu_torch.store.etcd_client import EtcdClient as PortClient
from k8s1m_tpu_torch.store.native import MemStore as PortMemStore
from k8s1m_tpu_torch.store.native import prefix_end

PFX = b"/registry/pods/repl/"


async def _jax_serve(store):
    server, port = await jax_serve(store, port=0)
    return server, port, lambda: server.stop(None)


async def _port_serve(store):
    server, port = await port_etcd_server.serve(store, port=0)
    return server, port, server.stop


PKGS = {
    "jax": (JaxMemStore, _jax_serve, jax_wc, JaxClient),
    "port": (PortMemStore, _port_serve, port_wc, PortClient),
}


def _run(name: str, scenario):
    MemStore, serve, wc, Client = PKGS[name]

    async def go():
        store = MemStore()
        _server, port, stop = await serve(store)
        sclient = Client(f"127.0.0.1:{port}")
        await sclient.put(PFX + b"seed", b"s0")
        tiers = [await wc.serve_watch_cache(f"127.0.0.1:{port}", [PFX], port=0)
                 for _ in range(3)]
        try:
            return await scenario(store, sclient, tiers, Client)
        finally:
            await sclient.close()
            for t in tiers:
                try:
                    await t.close()
                # Teardown ladder: close the rest even if one tier is gone.
                except Exception:  # graftlint: disable=broad-except
                    pass
            await stop()
            await asyncio.get_running_loop().shutdown_default_executor()
            store.close()

    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(go())
    finally:
        loop.close()


async def s_replicas_share_one_store_watch_and_all_deliver(store, sclient, tiers, Client):
    for _ in range(100):
        if store.stats()["watchers"] >= 3:
            break
        await asyncio.sleep(0.05)
    assert store.stats()["watchers"] == 3
    clients = [Client(f"127.0.0.1:{t.port}") for t in tiers]
    got = []
    async with clients[0].watch(PFX, prefix_end(PFX)) as w0, \
            clients[1].watch(PFX, prefix_end(PFX)) as w1, \
            clients[2].watch(PFX, prefix_end(PFX)) as w2:
        rev = await clients[1].put(PFX + b"a", b"v1")
        for w in (w0, w1, w2):
            batch = await w.next(timeout=10)
            assert batch.events[0].kv.value == b"v1"
            got.append([(e.kv.key, e.kv.value, e.kv.mod_revision) for e in batch.events])
    for c in clients:
        await c.close()
    return store.stats()["watchers"], rev, got


async def s_kill_one_replica_client_resumes_on_survivor(store, sclient, tiers, Client):
    victim = Client(f"127.0.0.1:{tiers[2].port}")
    seen = []
    w = await victim.watch(PFX, prefix_end(PFX)).__aenter__()
    await sclient.put(PFX + b"k0", b"before")
    batch = await w.next(timeout=10)
    seen.extend(e.kv.value for e in batch.events)
    last_rev = batch.events[-1].kv.mod_revision
    await tiers[2].close()
    await sclient.put(PFX + b"k1", b"during-1")
    await sclient.put(PFX + b"k2", b"during-2")
    with pytest.raises(Exception):
        while True:
            batch = await w.next(timeout=5)
            seen.extend(e.kv.value for e in batch.events)
    survivor = Client(f"127.0.0.1:{tiers[0].port}")
    async with survivor.watch(PFX, prefix_end(PFX), start_revision=last_rev + 1) as w2:
        await sclient.put(PFX + b"k3", b"after")
        got = []
        while len(got) < 3:
            batch = await w2.next(timeout=10)
            got.extend((e.kv.value, e.kv.mod_revision) for e in batch.events)
    assert [v for v, _ in got] == [b"during-1", b"during-2", b"after"]
    await survivor.close()
    await victim.close()
    return seen, last_rev, got


@pytest.mark.parametrize("scenario", [s_replicas_share_one_store_watch_and_all_deliver,
                                      s_kill_one_replica_client_resumes_on_survivor],
                         ids=lambda f: f.__name__[2:])
def test_replicas_equal_jax(scenario):
    assert _run("port", scenario) == _run("jax", scenario)
