"""The port's watch-cache tier (``k8s1m_tpu_torch/store/watch_cache.py``)
against the JAX package's, on the CPU.

Every case of ``tests/test_watch_cache.py`` but the fan-out A/B profile
(which needs ``tools/watch_fanout_ab.py``) runs twice on the same script:
once on the JAX stack (JAX store server, JAX tier, JAX grpcio client) and
once on the port's (the port's asyncio store server, the port's tier on
``store/wire_server.py``, the port's client).  Each run keeps the JAX
test's own assertions and records what it saw — event keys, values,
revisions and types, cancels, compact revisions, the ``watchcache_*``
metric deltas — and the two records must be equal.  The shared-frame
cases read both tiers through the same JAX grpcio raw-bytes mux and
compare the frames' bytes (the shared watch ids compared as a set, since
the primary id of a shared frame is the sweep's set order).  The unit
cases run on both ``index="hash"`` and ``index="btree"``.  And on the
port's tier alone, through its server half's flow control: a subscriber
that never opens its stream window holds at that window while another
client's watch on the same prefix gets every event, and a reset of the
stalled stream unregisters its watcher.

Tolerance: exact equality everywhere.
"""

import _torch_cpu  # noqa: F401  (bounds torch's CPU threads first)

import asyncio
import dataclasses
import threading
import time

import pytest

from k8s1m_tpu import faultline as jax_faultline
from k8s1m_tpu import loadshed as jax_loadshed
from k8s1m_tpu.obs.metrics import REGISTRY as JAX_REGISTRY
from k8s1m_tpu.store import watch_cache as jax_wc
from k8s1m_tpu.store import wiretier as jax_wiretier
from k8s1m_tpu.store.etcd_client import EtcdClient as JaxClient
from k8s1m_tpu.store.etcd_server import serve as jax_serve
from k8s1m_tpu.store.native import KeyValue as JaxKV
from k8s1m_tpu.store.native import MemStore as JaxMemStore
from k8s1m_tpu.store.native import WireFront as JaxWireFront
from k8s1m_tpu.store.native import decode_shared_tail as jax_decode_shared_tail
from k8s1m_tpu.store.proto import rpc_pb2
from k8s1m_tpu.store.remote import RemoteStore as JaxRemoteStore
from k8s1m_tpu_torch import faultline as port_faultline
from k8s1m_tpu_torch import loadshed as port_loadshed
from k8s1m_tpu_torch.obs.metrics import REGISTRY as PORT_REGISTRY
from k8s1m_tpu_torch.store import etcd_server as port_etcd_server
from k8s1m_tpu_torch.store import watch_cache as port_wc
from k8s1m_tpu_torch.store import wiretier as port_wiretier
from k8s1m_tpu_torch.store.etcd_client import EtcdClient as PortClient
from k8s1m_tpu_torch.store.native import KeyValue as PortKV
from k8s1m_tpu_torch.store.native import MemStore as PortMemStore
from k8s1m_tpu_torch.store.native import WireFront as PortWireFront
from k8s1m_tpu_torch.store.native import decode_shared_tail as port_decode_shared_tail
from k8s1m_tpu_torch.store.native import prefix_end
from k8s1m_tpu_torch.store.proto import codec
from k8s1m_tpu_torch.store.remote import RemoteStore as PortRemoteStore
from k8s1m_tpu_torch.store.wire import RST_STREAM, _frame

PFX = b"/registry/leases/ns/"
_RST_CANCEL_1 = _frame(4, RST_STREAM, 0, 1) + (0x8).to_bytes(4, "big")
INDEXES = ("hash", "btree")
# The tier's counters and gauge whose deltas each run records.
METRICS = (
    "watchcache_events_in_total", "watchcache_events_delivered_total",
    "watchcache_invalidations_total", "watchcache_resumes_total",
    "watchcache_coalesced_events_total", "watchcache_degraded_watchers",
    "watchcache_watchers",
)


class _PortRawCall:
    """A raw Watch stream through the port's transport: ``write`` a codec
    request, ``read`` the next decoded response."""

    def __init__(self, stream, queue):
        self._stream, self._queue = stream, queue

    @classmethod
    async def open(cls, client):
        loop = asyncio.get_running_loop()
        queue: asyncio.Queue = asyncio.Queue()
        stream = await client.channel.stream_async(
            "/etcdserverpb.Watch/Watch",
            lambda raw: loop.call_soon_threadsafe(queue.put_nowait, raw),
            lambda *_: None)
        return cls(stream, queue)

    async def write(self, req) -> None:
        self._stream.send(req.encode())

    async def read(self):
        return codec.WatchResponse.decode(await self._queue.get())

    def cancel(self) -> None:
        self._stream.cancel()


async def _jax_raw_call(client):
    return client._watch_stream()


@dataclasses.dataclass(frozen=True)
class Pkg:
    name: str
    MemStore: type
    KV: type
    wc: object
    wiretier: object
    Client: type
    RemoteStore: type
    WireFront: type
    registry: object
    faultline: object
    loadshed: object
    pb: object                 # WatchRequest & co: rpc_pb2 or the codec
    decode_shared_tail: object
    serve: object              # async (store) -> (server, port)
    stop: object               # async (server) -> None
    raw_call: object           # async (client) -> raw Watch call
    parse_watch: object        # raw bytes -> WatchResponse
    serialize: object          # message -> bytes

    def metric(self, name: str, **labels) -> float:
        return self.registry.get(name).value(**labels)

    def metrics(self) -> dict:
        out = {m: self.metric(m) for m in METRICS}
        for outcome in ("resumed", "compact_relist"):
            out[f"replays/{outcome}"] = self.metric("watchcache_replays_total", outcome=outcome)
        return out


async def _jax_serve(store):
    return await jax_serve(store, port=0)


async def _port_serve(store):
    return await port_etcd_server.serve(store, port=0)


JAX = Pkg("jax", JaxMemStore, JaxKV, jax_wc, jax_wiretier, JaxClient, JaxRemoteStore,
          JaxWireFront, JAX_REGISTRY, jax_faultline, jax_loadshed, rpc_pb2,
          jax_decode_shared_tail, _jax_serve, lambda s: s.stop(None), _jax_raw_call,
          rpc_pb2.WatchResponse.FromString, lambda m: m.SerializeToString())
PORT = Pkg("port", PortMemStore, PortKV, port_wc, port_wiretier, PortClient, PortRemoteStore,
           PortWireFront, PORT_REGISTRY, port_faultline, port_loadshed, codec,
           port_decode_shared_tail, _port_serve, lambda s: s.stop(), _PortRawCall.open,
           codec.WatchResponse.decode, lambda m: m.encode())
PKGS = (JAX, PORT)


def _deltas(pkg: Pkg, before: dict) -> dict:
    return {k: v - before[k] for k, v in pkg.metrics().items()}


def _evs(evs) -> list:
    """CacheEvents as comparable tuples."""
    return [(e.type, e.key, e.value, e.create_revision, e.mod_revision, e.version, e.seq)
            for e in evs]


def _wire_evs(batch) -> list:
    """A client WatchBatch's events as comparable tuples."""
    return [(int(e.type), e.kv.key, e.kv.value, e.kv.create_revision, e.kv.mod_revision,
             e.kv.version) for e in batch.events]


def _run_loop(coro_fn, *args):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro_fn(*args))
    finally:
        loop.run_until_complete(loop.shutdown_default_executor())
        loop.close()


def _both(fn, *args, metrics=None) -> dict:
    """``fn(pkg, *args)`` (a coroutine function runs on a fresh loop) for
    each package; the records, and the deltas of ``metrics`` (default: all
    of ``Pkg.metrics``), must be equal."""
    recs = {}
    for pkg in PKGS:
        before = pkg.metrics()
        if asyncio.iscoroutinefunction(fn):
            rec = _run_loop(fn, pkg, *args)
        else:
            rec = fn(pkg, *args)
        deltas = _deltas(pkg, before)
        if metrics is not None:
            deltas = {k: deltas[k] for k in metrics}
        recs[pkg.name] = {"rec": rec, "metrics": deltas}
    assert recs["port"] == recs["jax"]
    return recs["port"]


# ---- the tier over a store server ------------------------------------------------


@dataclasses.dataclass
class Env:
    pkg: Pkg
    store: object
    server: object
    sclient: object
    tier: object
    cclient: object
    cache: object


async def _env_up(pkg: Pkg, index: str = "hash", seed: bool = True, **tier_kw) -> Env:
    store = pkg.MemStore()
    server, port = await pkg.serve(store)
    sclient = pkg.Client(f"127.0.0.1:{port}")
    if seed:
        await sclient.put(PFX + b"seed", b"s0")   # pre-tier state
    tier = await pkg.wc.serve_watch_cache(f"127.0.0.1:{port}", [PFX], port=0, index=index,
                                          **tier_kw)
    cclient = pkg.Client(f"127.0.0.1:{tier.port}")
    return Env(pkg, store, server, sclient, tier, cclient, tier.cache)


async def _env_down(env: Env) -> None:
    await env.cclient.close()
    await env.sclient.close()
    await env.tier.close()
    await env.pkg.stop(env.server)
    await asyncio.get_running_loop().shutdown_default_executor()
    env.store.close()


def _with_env(scenario, **env_kw):
    async def run(pkg, index):
        env = await _env_up(pkg, index, **env_kw)
        try:
            return await scenario(env)
        finally:
            await _env_down(env)
    return run


async def _wait(cond, tries: int = 200) -> None:
    for _ in range(tries):
        if cond():
            return
        await asyncio.sleep(0.01)


async def s_fanout_one_store_watch_many_clients(env: Env):
    sessions, rec = [], []
    for i in range(10):
        s = env.cclient.watch(PFX + b"n%d" % (i % 5))       # exact-key watches
        await s.__aenter__()
        sessions.append(s)
    pw = env.cclient.watch(PFX, prefix_end(PFX))            # one range watch
    await pw.__aenter__()
    # The tier holds exactly ONE store watch regardless of clients.
    assert env.store.stats()["watchers"] == 1
    assert env.cache.watcher_count == 11
    for i in range(5):
        await env.sclient.put(PFX + b"n%d" % i, b"v%d" % i)
    for i, s in enumerate(sessions):
        batch = await s.next(timeout=5)
        assert len(batch.events) == 1
        assert batch.events[0].kv.key == PFX + b"n%d" % (i % 5)
        rec.append(_wire_evs(batch))
    got = []
    while len(got) < 5:
        got += _wire_evs(await pw.next(timeout=5))
    rec.append(got)
    st = env.cache.stats()
    assert st["events_in"] == 5 and st["events_delivered"] == 15
    rec.append(st)
    for s in sessions:
        await s.cancel()
    await pw.cancel()
    return rec


async def s_replay_from_revision_and_compaction(env: Env):
    r1 = await env.sclient.put(PFX + b"a", b"1")
    await env.sclient.put(PFX + b"a", b"2")
    await _wait(lambda: env.cache.last_revision >= r1 + 1)
    rec = []
    async with env.cclient.watch(PFX + b"a", start_revision=r1) as s:
        evs = []
        while len(evs) < 2:
            evs += _wire_evs(await s.next(timeout=5))
        assert [e[2] for e in evs] == [b"1", b"2"]
        rec.append(evs)
    async with env.cclient.watch(PFX + b"seed", start_revision=1) as s2:
        assert s2.compact_revision >= 1 and s2.canceled
        rec.append((s2.compact_revision, s2.canceled))
    return rec


async def s_range_served_from_cache(env: Env):
    for i in (3, 1, 2):
        await env.sclient.put(PFX + b"k%d" % i, b"v%d" % i)
    await _wait(lambda: len(env.cache.objects) >= 4)
    resp = await env.cclient.prefix(PFX)
    keys = [kv.key for kv in resp.kvs]
    assert keys == sorted(keys) and PFX + b"k1" in keys
    rec = [[(kv.key, kv.value, kv.mod_revision) for kv in resp.kvs], resp.header.revision]
    await env.sclient.delete(PFX + b"k2")
    await _wait(lambda: len(env.cache.objects) == 3)
    resp = await env.cclient.prefix(PFX)
    assert PFX + b"k2" not in [kv.key for kv in resp.kvs]
    rec.append([(kv.key, kv.value, kv.mod_revision) for kv in resp.kvs])
    return rec


async def s_live_events_after_replay_not_duplicated(env: Env):
    r1 = await env.sclient.put(PFX + b"x", b"old")
    await _wait(lambda: env.cache.last_revision >= r1)
    async with env.cclient.watch(PFX + b"x", start_revision=r1) as s:
        await env.sclient.put(PFX + b"x", b"new")
        evs = []
        while len(evs) < 2:
            evs += _wire_evs(await s.next(timeout=5))
        assert [e[2] for e in evs] == [b"old", b"new"]
        with pytest.raises(TimeoutError):
            await s.next(timeout=0.3)
    return evs


async def s_duplicate_watch_id_rejected(env: Env):
    pb = env.pkg.pb
    call = await env.pkg.raw_call(env.cclient)
    req = pb.WatchRequest(create_request=pb.WatchCreateRequest(key=PFX + b"a", watch_id=7))
    await call.write(req)
    first = await call.read()
    assert first.created and first.watch_id == 7
    await call.write(req)
    second = await call.read()
    assert second.canceled and second.cancel_reason == "duplicate watch_id"
    assert env.cache.watcher_count == 1
    call.cancel()
    return [(r.watch_id, r.created, r.canceled, r.cancel_reason, r.header.revision)
            for r in (first, second)]


async def s_upstream_break_cancels_clients_for_relist(env: Env):
    s = env.cclient.watch(PFX + b"a")
    await s.__aenter__()
    assert env.cache.watcher_count == 1
    env.cache.invalidate()
    batch = await s.next(timeout=5)
    assert batch.canceled
    await _wait(lambda: env.cache.watcher_count == 0)
    assert env.cache.watcher_count == 0
    await s.cancel()
    return (batch.canceled, batch.cancel_reason, batch.revision)


async def s_tier_serves_full_wire_with_write_passthrough(env: Env):
    c, rec = env.cclient, []
    async with c.watch(PFX, prefix_end(PFX)) as w:
        rev = await c.put(PFX + b"wp", b"v1")
        batch = await w.next(timeout=5)
        assert batch.events[0].kv.key == PFX + b"wp"
        rec.append((rev, _wire_evs(batch)))
        r = await c.txn_cas(PFX + b"wp", b"v2", required_mod=rev)
        assert r.succeeded
        r2 = await c.txn_cas(PFX + b"wp", b"v3", required_mod=rev)
        assert not r2.succeeded
        rec.append(env.pkg.serialize(r2))
        rec.append(await c.put_batch([(PFX + b"bk%d" % i, b"x") for i in range(5)]))
        lid = await c.lease_grant(30)
        assert lid > 0
        assert await c.delete(PFX + b"wp") == 1
        rec.append(lid)
        # The delete's event reaches the tier while the watch is still open.
        await _wait(lambda: env.cache.last_revision >= env.store.current_revision)
    resp = await c.prefix(PFX)
    keys = {kv.key for kv in resp.kvs}
    assert PFX + b"bk0" in keys and PFX + b"wp" not in keys
    assert env.store.stats()["watchers"] == 1
    rec.append(([(kv.key, kv.value, kv.mod_revision) for kv in resp.kvs], resp.header.revision))
    return rec


async def s_tier_read_your_writes_immediately(env: Env):
    rec = []
    for i in range(20):
        rev = await env.cclient.put(PFX + b"ryw%d" % i, b"v")
        resp = await env.cclient.prefix(PFX + b"ryw")
        keys = {kv.key for kv in resp.kvs}
        assert PFX + b"ryw%d" % i in keys, i
        assert resp.header.revision >= rev
        rec.append((rev, sorted(keys)))
    return rec


async def s_range_outside_watched_prefixes_goes_upstream(env: Env):
    other = b"/registry/configmaps/ns/cm1"
    await env.sclient.put(other, b"data")
    kv = await env.cclient.get(other)
    assert kv is not None and kv.value == b"data"
    resp = await env.cclient.prefix(b"/registry/configmaps/")
    assert len(resp.kvs) == 1
    return env.pkg.serialize(resp)


async def s_upstream_break_resumes_clients_over_wire(env: Env):
    fl = env.pkg.faultline
    s = env.cclient.watch(PFX + b"x")
    await s.__aenter__()
    fl.install_plan(fl.FaultPlan(
        [fl.FaultSpec("watch.tier", "upstream.recv", kind="disconnect",
                      after=1, every_n=1, max_fires=1)], seed=3))
    try:
        seen, states = b"", {}
        for i in range(30):
            await env.sclient.put(PFX + b"x", b"v%02d" % i)
            await asyncio.sleep(0.01)
        deadline = 200
        while seen != b"v29" and deadline:
            deadline -= 1
            try:
                batch = await s.next(timeout=0.1)
            except TimeoutError:
                continue
            assert not batch.canceled
            for e in batch.events:
                states[e.kv.key] = e.kv.value
            if batch.events:
                seen = batch.events[-1].kv.value
        assert seen == b"v29"
        fired = fl.active_injector().fire_counts()
    finally:
        fl.install_plan(None)
        await s.cancel()
    return seen, states, fired


ENV_SCENARIOS = {f.__name__[2:]: f for f in (
    s_fanout_one_store_watch_many_clients, s_replay_from_revision_and_compaction,
    s_range_served_from_cache, s_live_events_after_replay_not_duplicated,
    s_duplicate_watch_id_rejected, s_upstream_break_cancels_clients_for_relist,
    s_tier_serves_full_wire_with_write_passthrough, s_tier_read_your_writes_immediately,
    s_range_outside_watched_prefixes_goes_upstream, s_upstream_break_resumes_clients_over_wire,
)}


# How many events the tier takes in, and hands out, around an injected
# upstream break depends on when the relist lands; its resume is what both
# tiers must count alike.
_BREAK_METRICS = ("watchcache_resumes_total", "watchcache_invalidations_total")


@pytest.mark.parametrize("index", INDEXES)
@pytest.mark.parametrize("name", sorted(ENV_SCENARIOS))
def test_tier_scenario_equals_jax(name, index):
    brk = name == "upstream_break_resumes_clients_over_wire"
    res = _both(_with_env(ENV_SCENARIOS[name]), index, metrics=_BREAK_METRICS if brk else None)
    if brk:
        assert res["metrics"]["watchcache_resumes_total"] >= 1
        assert res["metrics"]["watchcache_invalidations_total"] == 0


async def _pinned_revision_pages(pkg: Pkg):
    env = await _env_up(pkg, seed=False)
    try:
        for i in range(6):
            await env.sclient.put(PFX + b"p%d" % i, b"v%d" % i)
        # The tier primed before these writes: wait for the live stream.
        await _wait(lambda: len(env.cache.objects) == 6)
        svc = env.tier.svc
        await _wait(lambda: svc.handles[0].session is not None)
        calls = {"upstream": 0}
        real = svc.upstream._range

        async def counting(req):
            calls["upstream"] += 1
            return await real(req)

        svc.upstream._range = counting
        c = env.cclient
        p1 = await c.range(PFX, prefix_end(PFX), limit=3)
        pin = p1.header.revision
        assert p1.more and len(p1.kvs) == 3
        last = p1.kvs[-1].key
        p2 = await c.range(last + b"\x00", prefix_end(PFX), limit=3, revision=pin)
        assert [kv.value for kv in p2.kvs] == [b"v3", b"v4", b"v5"]
        assert p2.header.revision == pin and calls["upstream"] == 0
        await env.sclient.put(PFX + b"p9", b"late")
        await _wait(lambda: env.cache.last_revision > pin)
        p3 = await c.range(last + b"\x00", prefix_end(PFX), limit=3, revision=pin)
        assert calls["upstream"] == 1
        assert [kv.value for kv in p3.kvs] == [b"v3", b"v4", b"v5"]
        return [pkg.serialize(p) for p in (p1, p2, p3)], calls
    finally:
        await _env_down(env)


def test_pinned_revision_pages_served_from_cache():
    _both(_pinned_revision_pages)


async def _confirm_coalescing(pkg: Pkg):
    class FakeSession:
        def __init__(self, h):
            self.h, self.sent = h, 0

        async def request_progress(self):
            self.sent += 1
            await asyncio.sleep(0.02)
            asyncio.get_running_loop().call_later(0.005, self.h.note_progress)

    h = pkg.wc.UpstreamHandle(PFX)
    s = FakeSession(h)
    h.session = s
    oks = await asyncio.gather(*(h.confirm(5.0) for _ in range(32)))
    assert all(oks) and s.sent == 2, s.sent
    assert await h.confirm(5.0)
    assert await h.confirm(5.0)
    assert s.sent == 4, s.sent
    return s.sent, h.requests_sent, h.progress_count


def test_confirm_coalescing_one_round_trip_per_burst():
    _both(_confirm_coalescing)


async def _prime_paginates(pkg: Pkg):
    store = pkg.MemStore()
    server, port = await pkg.serve(store)
    sclient = pkg.Client(f"127.0.0.1:{port}")
    n = pkg.wc._PRIME_PAGE * 2 + 7   # forces 3 pages
    for off in range(0, n, 8192):
        await sclient.put_batch([(PFX + b"pg-%06d" % i, b"v") for i in range(off, min(n, off + 8192))])
    tier = await pkg.wc.serve_watch_cache(f"127.0.0.1:{port}", [PFX], port=0)
    cclient = pkg.Client(f"127.0.0.1:{tier.port}")
    try:
        assert len(tier.cache.objects) == n
        resp = await cclient.prefix(PFX, count_only=True)
        assert resp.count == n
        kv = await cclient.get(PFX + b"pg-%06d" % (n - 1))
        assert kv is not None and kv.value == b"v"
        async with cclient.watch(PFX + b"pg-000000") as s:
            await sclient.put(PFX + b"pg-000000", b"v2")
            b = await s.next(timeout=5)
            assert b.events[0].kv.value == b"v2"
        # Whether the count came from the cache or the store depends on
        # whether the upstream stream was up yet: its answer, not its header.
        return (resp.count, resp.header.revision), _wire_evs(b), tier.cache.prime_revision
    finally:
        await cclient.close()
        await sclient.close()
        await tier.close()
        await pkg.stop(server)
        await asyncio.get_running_loop().shutdown_default_executor()
        store.close()


def test_prime_paginates_large_prefixes():
    _both(_prime_paginates)


# ---- shared frames, read through the JAX grpcio raw-bytes mux ----------------------


class _RawWatch:
    """The JAX package's raw-bytes watch mux (grpcio): one bidi stream,
    responses kept as bytes so frames are compared before any parse."""

    def __init__(self, target: str):
        from grpc import aio

        self._chan = aio.insecure_channel(target)
        self._call = self._chan.stream_stream(
            "/etcdserverpb.Watch/Watch",
            request_serializer=rpc_pb2.WatchRequest.SerializeToString,
            response_deserializer=lambda b: b,
        )()
        self.created: set[int] = set()
        self.frames: asyncio.Queue = asyncio.Queue()
        self._reader = asyncio.create_task(self._read())

    async def create(self, wid: int, key: bytes, end: bytes = b"",
                     start_revision: int = 0) -> None:
        await self._call.write(rpc_pb2.WatchRequest(create_request=rpc_pb2.WatchCreateRequest(
            key=key, range_end=end, watch_id=wid, start_revision=start_revision)))
        for _ in range(500):
            if wid in self.created:
                return
            await asyncio.sleep(0.01)
        raise TimeoutError(f"watch {wid} never acked")

    async def _read(self) -> None:
        try:
            async for raw in self._call:
                resp = rpc_pb2.WatchResponse.FromString(raw)
                if resp.created:
                    self.created.add(resp.watch_id)
                elif resp.events:
                    await self.frames.put(raw)
        except (asyncio.CancelledError, Exception):  # graftlint: disable=broad-except (reader teardown: the test closes the channel)
            pass

    async def next_frame(self, timeout: float = 5.0) -> bytes:
        return await asyncio.wait_for(self.frames.get(), timeout)

    async def close(self) -> None:
        self._reader.cancel()
        try:
            await self._reader
        except (asyncio.CancelledError, Exception):  # graftlint: disable=broad-except (close path)
            pass
        await self._chan.close()


def _frame_form(pkg: Pkg, raw: bytes) -> tuple:
    """A composed frame checked and made comparable: its core slice must
    equal ``pkg``'s unshared encoding for the primary watch id; returned as
    (header bytes, the set of watch ids, event chunk bytes, from_rev)."""
    extra, from_rev, core = pkg.decode_shared_tail(raw)
    resp = pkg.parse_watch(raw)
    events = [pkg.wc.CacheEvent(1 if e.type else 0, e.kv.key, e.kv.value, e.kv.create_revision,
                                e.kv.mod_revision, e.kv.version) for e in resp.events]
    assert raw[:core] == pkg.serialize(pkg.wc.encode_event_batch(resp.header, resp.watch_id,
                                                                 events))
    n, p = 0, 1
    shift = 0
    while True:                          # the header chunk's length varint
        b = raw[p]
        n |= (b & 0x7F) << shift
        p += 1
        shift += 7
        if not b & 0x80:
            break
    hdr_end = p + n
    q = hdr_end
    if raw[q] == 0x10:                   # the primary watch id
        q += 1
        while raw[q] & 0x80:
            q += 1
        q += 1
    return raw[:hdr_end], sorted([resp.watch_id, *extra]), raw[q:core], from_rev


async def _shared_multi_wid(pkg: Pkg):
    env = await _env_up(pkg)
    mux = _RawWatch(f"127.0.0.1:{env.tier.port}")
    try:
        await mux.create(1, PFX + b"hot")
        await mux.create(2, PFX + b"hot")
        await env.sclient.put(PFX + b"hot", b"v1")
        form = _frame_form(pkg, await mux.next_frame())
        assert form[1] == [1, 2] and form[3] == 0
        with pytest.raises(TimeoutError):
            await mux.next_frame(timeout=0.3)
        assert env.cache.stats()["events_delivered"] == 2
        return form
    finally:
        await mux.close()
        await _env_down(env)


def test_shared_frame_multi_wid_on_the_wire():
    _both(_shared_multi_wid)


async def _shared_resume_point(pkg: Pkg):
    env = await _env_up(pkg)
    encodes = lambda: pkg.metric("watchcache_frame_encodes_total")  # noqa: E731
    hits = lambda: pkg.metric("watchcache_frame_hits_total")  # noqa: E731
    revs = [await env.sclient.put(PFX + b"k%d" % i, b"v%d" % i) for i in range(4)]
    await _wait(lambda: env.cache.last_revision >= revs[-1])
    mux = _RawWatch(f"127.0.0.1:{env.tier.port}")

    async def drain(wid, n):
        forms, got = [], []
        while len(got) < n:
            raw = await mux.next_frame()
            f = _frame_form(pkg, raw)
            assert wid in f[1]
            forms.append(f)
            got += [(e.kv.value, e.kv.mod_revision) for e in pkg.parse_watch(raw).events]
        return forms, got

    try:
        e0, h0 = encodes(), hits()
        await mux.create(1, PFX, prefix_end(PFX), start_revision=revs[0])
        a, got = await drain(1, 4)
        assert got == [(b"v%d" % i, revs[i]) for i in range(4)]
        assert encodes() - e0 == 4 and hits() - h0 == 0
        await mux.create(2, PFX, prefix_end(PFX), start_revision=revs[2])
        b, got = await drain(2, 2)
        assert got == [(b"v2", revs[2]), (b"v3", revs[3])]
        assert encodes() - e0 == 4 and hits() - h0 == 2
        await env.sclient.put(PFX + b"k9", b"live")
        live = _frame_form(pkg, await mux.next_frame())
        assert live[1] == [1, 2]
        assert encodes() - e0 == 6
        return a, b, live
    finally:
        await mux.close()
        await _env_down(env)


def test_shared_frame_respects_per_watch_resume_point():
    _both(_shared_resume_point)


async def _warm_restart(pkg: Pkg):
    store = pkg.MemStore()
    server, port = await pkg.serve(store)
    sclient = pkg.Client(f"127.0.0.1:{port}")
    revs = [await sclient.put(PFX + b"w%d" % i, b"v%d" % i) for i in range(5)]
    r0, i0 = pkg.metric("watchcache_resumes_total"), pkg.metric("watchcache_invalidations_total")
    tier = await pkg.wc.serve_watch_cache(f"127.0.0.1:{port}", [PFX], port=0,
                                          resume_floor=revs[1])
    cclient = pkg.Client(f"127.0.0.1:{tier.port}")
    try:
        assert pkg.metric("watchcache_resumes_total") - r0 == 1
        assert pkg.metric("watchcache_invalidations_total") - i0 == 0
        async with cclient.watch(PFX, prefix_end(PFX), start_revision=revs[1] + 1) as s:
            vals = []
            while len(vals) < 3:
                vals += _wire_evs(await s.next(timeout=5))
            assert [v[2] for v in vals] == [b"v2", b"v3", b"v4"]
            assert not s.canceled
        return revs, vals, tier.cache.prime_revision
    finally:
        await cclient.close()
        await tier.close()
        await sclient.close()
        await pkg.stop(server)
        await asyncio.get_running_loop().shutdown_default_executor()
        store.close()


def test_tier_warm_restart_resumes_from_floor():
    _both(_warm_restart)


# ---- the cache itself, on both storage structures ---------------------------------


def _kv(pkg: Pkg, key: bytes, value: bytes, rev: int, version: int = 1):
    return pkg.KV(key=key, value=value, create_revision=rev, mod_revision=rev, version=version)


def _drain_state(w, state: dict) -> list:
    seen, last = [], 0
    while w.queue or w.coalesced:
        for ev in w.pop_batch(1000):
            assert ev.mod_revision >= last
            last = ev.mod_revision
            seen.append(ev)
            if ev.type:
                state.pop(ev.key, None)
            else:
                state[ev.key] = ev.value
    return _evs(seen)


def u_window_eviction_forces_relist(pkg, index):
    cache = pkg.wc.WatchCache(index=index, window=4)
    cache.prime([], revision=10)
    assert cache.replayable_from == 11
    for i in range(6):
        cache.apply(0, b"k", b"v", 11, 11 + i, i + 1)
    assert cache.replayable_from == 13
    w = cache.register(b"k", None)
    assert cache.replay(w, 12) == 13 and cache.replay(w, 13) is None
    return _evs(w.queue), cache.stats()


def u_reprime_resumes_clients_with_net_diff(pkg, index):
    cache = pkg.wc.WatchCache(index=index)
    cache.prime([_kv(pkg, PFX + b"a", b"1", 5), _kv(pkg, PFX + b"b", b"1", 6),
                 _kv(pkg, PFX + b"c", b"1", 7)], revision=7)
    w = cache.register(PFX, b"\x00")
    assert cache.reprime([_kv(pkg, PFX + b"a", b"3", 12), _kv(pkg, PFX + b"c", b"1", 7),
                          _kv(pkg, PFX + b"d", b"1", 11)], revision=12)
    assert not w.overflowed
    evs = _evs(w.pop_batch(100))
    assert [(e[0], e[1], e[2], e[4]) for e in evs] == [
        (0, PFX + b"d", b"1", 12), (0, PFX + b"a", b"3", 12), (1, PFX + b"b", b"", 12)]
    assert cache.objects[PFX + b"d"].mod_revision == 11
    return evs, cache.stats(), {k: dataclasses.astuple(o) for k, o in cache.objects.items()}


def u_resume_events_clear_a_reattach_start_revision(pkg, index):
    other = b"/registry/configmaps/ns/"
    cache = pkg.wc.WatchCache(index=index)
    cache.prime([_kv(pkg, PFX + b"y", b"1", 8)], revision=8)
    cache.apply(0, other + b"cm", b"v", 6, 24, 2)
    w = cache.register(PFX + b"y", None, min_rev=25)
    assert cache.reprime([_kv(pkg, PFX + b"y", b"2", 9)], revision=30, key=PFX,
                         end=prefix_end(PFX))
    evs = _evs(w.pop_batch(10))
    assert [(e[2], e[4]) for e in evs] == [(b"2", 30)]
    assert cache.objects[PFX + b"y"].mod_revision == 9
    return evs


def u_reprime_scopes_deletes_to_prefix(pkg, index):
    other = b"/registry/configmaps/ns/"
    cache = pkg.wc.WatchCache(index=index)
    cache.prime([_kv(pkg, PFX + b"a", b"1", 5), _kv(pkg, other + b"cm", b"1", 6)], revision=6)
    idle = cache.register(other + b"cm", None)
    assert cache.reprime([_kv(pkg, PFX + b"a", b"2", 9)], revision=9, key=PFX,
                         end=prefix_end(PFX))
    assert idle.backlog == 0 and other + b"cm" in cache.objects
    return sorted(cache.objects), cache.stats()


def u_reprime_window_overflow_falls_back_to_invalidate(pkg, index):
    cache = pkg.wc.WatchCache(index=index, window=4)
    cache.prime([_kv(pkg, PFX + b"k%d" % i, b"1", 2 + i) for i in range(3)], revision=5)
    w = cache.register(PFX, b"\x00")
    relist = [_kv(pkg, PFX + b"k%d" % i, b"2", 10 + i) for i in range(6)]
    assert not cache.reprime(relist, revision=16)
    assert w.overflowed
    cache.prime(relist, revision=16)
    assert len(cache.objects) == 6 and cache.last_revision == 16
    return cache.stats(), cache.range(PFX, prefix_end(PFX))[2]


def u_reprime_not_fooled_by_other_prefixes_progress(pkg, index):
    other = b"/registry/configmaps/ns/"
    cache = pkg.wc.WatchCache(index=index)
    cache.prime([_kv(pkg, PFX + b"a", b"1", 5), _kv(pkg, other + b"cm", b"1", 6)], revision=6)
    w = cache.register(PFX + b"a", None)
    for i in range(5):
        cache.apply(0, other + b"cm", b"v%d" % i, 6, 20 + i, 2 + i)
    assert cache.last_revision == 24
    assert cache.reprime([_kv(pkg, PFX + b"a", b"2", 9)], revision=10, key=PFX,
                         end=prefix_end(PFX))
    assert not w.overflowed
    evs = _evs(w.pop_batch(10))
    assert not cache.reprime([_kv(pkg, PFX + b"a", b"0", 3)], revision=30, key=PFX,
                             end=prefix_end(PFX))
    return evs, w.overflowed, cache.stats()


def u_lag_budget_past_queue_cap_raises_hard_cap_with_it(pkg, index):
    cache = pkg.wc.WatchCache(index=index, lag_budget=pkg.wc._QUEUE_CAP * 2)
    w = cache.register(PFX + b"a", None)
    assert w.hard_cap == pkg.wc._QUEUE_CAP * 2 and w.queue.maxlen == pkg.wc._QUEUE_CAP * 2
    return w.hard_cap


def u_invalidate_scoped_keeps_other_prefixes_objects(pkg, index):
    other = b"/registry/configmaps/ns/"
    cache = pkg.wc.WatchCache(index=index)
    cache.prime([_kv(pkg, PFX + b"a", b"1", 5), _kv(pkg, other + b"cm", b"1", 6)], revision=6)
    cache.invalidate(PFX, prefix_end(PFX))
    assert PFX + b"a" not in cache.objects and other + b"cm" in cache.objects
    kvs, more, count = cache.range(other, prefix_end(other))
    assert count == 1 and kvs[0][0] == other + b"cm"
    return [(k, dataclasses.astuple(o)) for k, o in kvs], more, count


def u_resume_exactly_at_window_start_and_one_before(pkg, index):
    cache = pkg.wc.WatchCache(index=index, window=4)
    cache.prime([], revision=10)
    for i in range(6):
        cache.apply(0, b"k", b"v", 11, 11 + i, i + 1)
    start = cache.replayable_from
    assert start == 13
    w = cache.register(b"k", None)
    assert cache.replay(w, start) is None
    evs = _evs(w.pop_batch(10))
    assert [e[4] for e in evs] == [13, 14, 15, 16]
    w2 = cache.register(b"k", None)
    assert cache.replay(w2, start - 1) == start and w2.backlog == 0
    return evs


def u_invalidation_during_replay_cancels_cleanly(pkg, index):
    cache = pkg.wc.WatchCache(index=index)
    cache.prime([], revision=1)
    for i in range(8):
        cache.apply(0, b"k", b"v%d" % i, 2, 2 + i, i + 1)
    w = cache.register(b"k", None)
    assert cache.replay(w, 2) is None and w.backlog == 8
    cache.invalidate()
    assert w.overflowed and cache._backlog >= 0
    return cache.stats()


def u_coalescing_latest_only_then_recovery(pkg, index):
    cache = pkg.wc.WatchCache(index=index, lag_budget=4)
    cache.prime([], revision=1)
    w = cache.register(PFX, b"\x00")
    for i in range(20):
        cache.apply(0, PFX + b"hot", b"%d" % i, 2, 2 + i, i + 1)
    assert len(w.queue) == 4 and w.coalescing and list(w.coalesced) == [PFX + b"hot"]
    evs = _evs(w.pop_batch(100))
    assert [e[2] for e in evs] == [b"0", b"1", b"2", b"3", b"19"]
    assert not w.coalescing
    w2 = cache.register(PFX, b"\x00")
    w2.hard_cap = 8
    for i in range(20):
        cache.apply(0, PFX + b"k%d" % i, b"x", 30, 30 + i, 1)
    assert w2.overflowed
    return evs, w.last_pop_compacted, cache.stats()


def u_loadshed_controller_shrinks_lag_budget(pkg, index):
    cache = pkg.wc.WatchCache(index=index, lag_budget=4)
    cache.prime([], revision=1)
    for i in range(300):
        cache.register(PFX + b"k%d" % i, None)
    for i in range(300):
        cache.apply(0, PFX + b"k%d" % i, b"x", 2, 2 + i, 1)
    cache.loadshed_tick()
    assert cache._shed.current_state() == pkg.loadshed.SHEDDING
    assert cache._lag_now == 0 and cache.stats()["lag_budget_now"] == 0
    return cache.stats()


def u_resume_and_coalesce_stream_equals_full_relist_at_quiesce(pkg, index):
    cache = pkg.wc.WatchCache(index=index, lag_budget=3)
    seed = [_kv(pkg, PFX + b"k%02d" % i, b"s", 2 + i) for i in range(8)]
    cache.prime(seed, revision=9)
    fast = cache.register(PFX, b"\x00")
    slow = cache.register(PFX, b"\x00")
    fast_state = {kv.key: kv.value for kv in seed}
    slow_state = dict(fast_state)
    rev = 10
    fast_seen = []

    def put(k, v):
        nonlocal rev
        cache.apply(0, PFX + k, v, 2, rev, 2)
        rev += 1

    def delete(k):
        nonlocal rev
        cache.apply(1, PFX + k, b"", 0, rev, 0)
        rev += 1

    for r in range(6):
        for i in range(8):
            put(b"k%02d" % i, b"r%d-%d" % (r, i))
        delete(b"k%02d" % (r % 4))
        put(b"k%02d" % (r % 4), b"back-%d" % r)
        fast_seen += _drain_state(fast, fast_state)
    assert cache.reprime(
        [_kv(pkg, k, o.value, o.mod_revision, o.version)
         for k, o in cache.objects.items() if k != PFX + b"k07"]
        + [_kv(pkg, PFX + b"k07", b"post-outage", rev + 3)]
        + [_kv(pkg, PFX + b"new", b"born", rev + 4)],
        revision=rev + 5,
    )
    rev += 6
    for r in range(3):
        put(b"k00", b"tail-%d" % r)
    fast_seen += _drain_state(fast, fast_state)
    slow_seen = _drain_state(slow, slow_state)
    relist = {k: o.value for k, o in cache.objects.items()}
    assert fast_state == relist and slow_state == relist
    assert slow.last_pushed == cache.last_revision
    return fast_seen, slow_seen, sorted(relist.items())


UNIT = {f.__name__[2:]: f for f in (
    u_window_eviction_forces_relist, u_reprime_resumes_clients_with_net_diff,
    u_resume_events_clear_a_reattach_start_revision, u_reprime_scopes_deletes_to_prefix,
    u_reprime_window_overflow_falls_back_to_invalidate,
    u_reprime_not_fooled_by_other_prefixes_progress,
    u_lag_budget_past_queue_cap_raises_hard_cap_with_it,
    u_invalidate_scoped_keeps_other_prefixes_objects,
    u_resume_exactly_at_window_start_and_one_before,
    u_invalidation_during_replay_cancels_cleanly, u_coalescing_latest_only_then_recovery,
    u_loadshed_controller_shrinks_lag_budget,
    u_resume_and_coalesce_stream_equals_full_relist_at_quiesce,
)}


@pytest.mark.parametrize("index", INDEXES)
@pytest.mark.parametrize("name", sorted(UNIT))
def test_cache_unit_equals_jax(name, index):
    res = _both(UNIT[name], index)
    m = res["metrics"]
    if name == "reprime_resumes_clients_with_net_diff":
        assert (m["watchcache_resumes_total"], m["watchcache_invalidations_total"]) == (1, 0)
    if name == "reprime_window_overflow_falls_back_to_invalidate":
        assert (m["watchcache_resumes_total"], m["watchcache_invalidations_total"]) == (0, 1)
    if name == "reprime_not_fooled_by_other_prefixes_progress":
        assert (m["watchcache_resumes_total"], m["watchcache_invalidations_total"]) == (1, 1)


def test_compose_frame_byte_identity_and_extension_tail():
    """The port's ``encode_event_batch`` and composed frames against the JAX
    tier's constructor path: the same bytes for 1-byte and multi-byte watch
    ids, and the shared tail read back by both packages' decoders."""
    header = rpc_pb2.ResponseHeader(cluster_id=1, member_id=2, revision=777, raft_term=1)
    pheader = codec.ResponseHeader(cluster_id=1, member_id=2, revision=777, raft_term=1)
    spec = [(0, PFX + b"a", b"v1", 7, 9, 2), (1, PFX + b"b", b"", 5, 10, 3),
            (0, PFX + b"big", b"x" * 3000, 11, 300000, 41)]
    jevs = [jax_wc.CacheEvent(*e) for e in spec]
    pevs = [port_wc.CacheEvent(*e) for e in spec]
    hb = port_wiretier.header_bytes(pheader)
    chunks = [port_wiretier.encode_event(e) for e in pevs]
    for wid in (1, 7, 300000):
        want = jax_wc.encode_event_batch(header, wid, jevs).SerializeToString()
        assert port_wc.encode_event_batch(pheader, wid, pevs).encode() == want
        assert port_wiretier.compose_frame(hb, [wid], chunks) == want
    shared = port_wiretier.compose_frame(hb, [7, 9, 123456], chunks, from_rev=777)
    for decode in (port_decode_shared_tail, jax_decode_shared_tail):
        extra, from_rev, core = decode(shared)
        assert (extra, from_rev) == ([9, 123456], 777)
        assert shared[:core] == jax_wc.encode_event_batch(header, 7, jevs).SerializeToString()


def _remote_coalesce(pkg: Pkg):
    pfx = b"/registry/coal/"
    store = pkg.MemStore()
    wf = pkg.WireFront(store)
    rs = pkg.RemoteStore(f"127.0.0.1:{wf.port}")
    w = None
    try:
        store.put(pfx + b"a", b"seed")
        for i in range(100):
            store.put(pfx + b"hot", b"%03d" % i)
        store.put(pfx + b"b", b"last")
        w = rs.watch(pfx, prefix_end(pfx), start_revision=1, queue_cap=8, coalesce=True)
        state: dict = {}
        last_rev: dict = {}
        for _ in range(1000):
            for ev in w.poll(max_events=16):
                assert ev.kv.mod_revision >= last_rev.get(ev.kv.key, 0)
                last_rev[ev.kv.key] = ev.kv.mod_revision
                state[ev.kv.key] = ev.kv.value
            if state.get(pfx + b"hot") == b"099" and pfx + b"b" in state:
                break
            time.sleep(0.02)
        assert state == {pfx + b"a": b"seed", pfx + b"hot": b"099", pfx + b"b": b"last"}
        assert w.dropped == 0
        return state, last_rev
    finally:
        if w is not None:
            w.cancel()
        rs.close()
        wf.close()
        store.close()


def test_remote_watcher_coalesce_latest_only_no_drops():
    """The wire client's bounded-lag mirror (``store/remote.py``): the final
    state and each key's last revision equal the JAX client's."""
    recs = {pkg.name: _remote_coalesce(pkg) for pkg in PKGS}
    assert recs["port"] == recs["jax"]


# ---- backpressure: a stalled subscriber holds only its own stream ----------------


class _TierThread:
    """The port's store server and tier on an event loop in a thread, so a
    blocking raw HTTP/2 socket can drive the tier from the test thread."""

    def __init__(self):
        self.store = PortMemStore()
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()

        async def up():
            server, port = await port_etcd_server.serve(self.store, port=0)
            tier = await port_wc.serve_watch_cache(f"127.0.0.1:{port}", [PFX], port=0)
            return server, tier

        self.server, self.tier = self.run(up())

    def run(self, coro, timeout: float = 30.0):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(timeout)

    def close(self) -> None:
        self.run(self.tier.close())
        self.run(self.server.stop())
        self.run(self.loop.shutdown_default_executor())
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(timeout=10)
        assert not self.thread.is_alive()
        self.loop.close()
        self.store.close()


def test_stalled_subscriber_backpressures_only_its_own_stream():
    """A raw HTTP/2 client that grants a 4,096-byte stream window and never
    reads past it: the tier's writes to that watch stop at the window, while
    a second client's watch on the same prefix gets every event; resetting
    the stalled stream unregisters its watcher."""
    from test_torch_etcd_server import _RawH2, _data_bytes, _whole_message

    srv = _TierThread()
    raw = _RawH2(srv.tier.port, 4096)
    fast = PortRemoteStore(f"127.0.0.1:{srv.tier.port}")
    w = None
    try:
        create = codec.WatchRequest(create_request=codec.WatchCreateRequest(
            key=PFX, range_end=prefix_end(PFX))).encode()
        raw.open(1, b"/etcdserverpb.Watch/Watch", [create], end_stream=False)
        created = raw.frames(lambda fs: _whole_message(fs, 1), quiet=None)
        assert codec.WatchResponse.decode(_data_bytes(created, 1)[5:]).created
        w = fast.watch(PFX, prefix_end(PFX))
        for _ in range(500):
            if srv.tier.cache.watcher_count == 2:
                break
            time.sleep(0.01)
        assert srv.tier.cache.watcher_count == 2
        n = 2000
        srv.store.put_batch([(PFX + b"%05d" % i, b"v" * 200) for i in range(n)])
        got = []
        for _ in range(1000):
            got += w.poll(max_events=1000)
            if len(got) >= n:
                break
            time.sleep(0.01)
        assert [ev.kv.key for ev in got] == [PFX + b"%05d" % i for i in range(n)]
        before = len(_data_bytes(created, 1))
        stalled = raw.frames(lambda fs: before + len(_data_bytes(fs, 1)) >= 4096, quiet=0.3)
        assert before + len(_data_bytes(stalled, 1)) == 4096   # held at the stream window
        raw.send(_RST_CANCEL_1)
        for _ in range(500):
            if srv.tier.cache.watcher_count == 1:
                break
            time.sleep(0.01)
        assert srv.tier.cache.watcher_count == 1
    finally:
        if w is not None:
            w.cancel()
        fast.close()
        raw.close()
        srv.close()
