"""The port's async ``EtcdClient`` against the JAX package's, on the CPU.

The corpus of ``tests/test_etcd_server.py`` (put/get revisions, limit and
count, keys-only, the Txn CAS shapes and the rejected ones, compaction and
future-revision errors, delete ranges, the watch protocol with a past
batch, live events and ``prev_kv``, a compacted start, progress and its
barrier, the fake leases, an unimplemented service, the BatchKV frames)
runs once through each client, each against a fresh server of the same
kind: the JAX asyncio ``etcd_server`` (grpcio underneath) or the port's
native ``WireFront``.  Every result is recorded (header revisions, KVs,
status codes and details, watch batches) and the two records must be
equal; so must the two stores' contents afterwards.  Besides: a quiet watch
that times out still delivers the next event, the Lease messages match
``rpc_pb2`` byte for byte, 3,000 calls in flight on one loop resolve once
each, and the native stress client's twin of
``tests/test_wirefront.py::test_stress_client_roundtrip_and_throughput_floor``.

Tolerance: exact equality everywhere.
"""

import _torch_cpu  # noqa: F401  (bounds torch's CPU threads first)

import asyncio
import json
import types

import grpc
import numpy as np
import pytest

from k8s1m_tpu.control.objects import encode_pod, pod_key
from k8s1m_tpu.snapshot.pod_encoding import PodInfo
from k8s1m_tpu.store import etcd_client as jclient
from k8s1m_tpu.store.proto import batch_pb2, rpc_pb2
from k8s1m_tpu_torch.store import etcd_client as tclient
from k8s1m_tpu_torch.store.native import MemStore, WireFront, prefix_end, wire_stress_put
from k8s1m_tpu_torch.store.proto import codec
from k8s1m_tpu_torch.store.wire import WireError
from test_torch_wire import AsyncioServer, NativeServer

SERVERS = {"asyncio": AsyncioServer, "native": NativeServer}
JAX_PB = types.SimpleNamespace(**{n: getattr(m, n) for m in (rpc_pb2, batch_pb2)
                                  for n in dir(m) if not n.startswith("_")})


class Side:
    """One client package: its client class, its messages and its errors."""

    def __init__(self, name):
        self.name = name
        self.jax = name == "jax"
        self.pb = JAX_PB if self.jax else codec
        self.client_cls = jclient.EtcdClient if self.jax else tclient.EtcdClient
        self.errors = (grpc.aio.AioRpcError,) if self.jax else (WireError,)

    def wire(self, msg) -> bytes:
        return msg.SerializeToString() if self.jax else msg.encode()

    def error(self, e) -> tuple:
        if self.jax:
            return ("error", e.code().name, e.details())
        return ("error", e.code.name, e.details)

    async def raw(self, client, path: str, req) -> bytes:
        """A unary call by path, request and response as bytes."""
        if self.jax:
            call = client.channel.unary_unary(
                path, request_serializer=lambda b: b, response_deserializer=lambda b: b)
            return await call(req)
        return await client.channel.unary_async(path, req)


class Recorder:
    def __init__(self, side: Side):
        self.side = side
        self.rows: list = []

    def __call__(self, x):
        """Record ``x`` (a message as its wire bytes) and return it."""
        self.rows.append(self.norm(x))
        return x

    def norm(self, x):
        if isinstance(x, (jclient.WatchBatch, tclient.WatchBatch)):
            return ("batch", x.revision, x.compact_revision, x.created, x.canceled,
                    x.cancel_reason, [self.norm(e) for e in x.events])
        if isinstance(x, (list, tuple)):
            return [self.norm(v) for v in x]
        if hasattr(x, "SerializeToString") or isinstance(x, codec.Message):
            return (type(x).__name__, self.side.wire(x))
        return x

    async def expect_error(self, coro) -> tuple:
        try:
            await coro
        except self.side.errors as e:
            err = self.side.error(e)
            self.rows.append(err)
            return err
        raise AssertionError("the call did not fail")


# ---- the scenarios (tests/test_etcd_server.py), one body for both clients -------


async def s_status(c, rec, side, store):
    status = rec(await c.status())
    assert status.header.revision == 1
    assert status.version == "3.5.16"


async def s_put_get(c, rec, side, store):
    r1 = rec(await c.put(b"/registry/pods/default/a", b"v1"))
    r2 = rec(await c.put(b"/registry/pods/default/a", b"v2"))
    assert r2 == r1 + 1
    kv = rec(await c.get(b"/registry/pods/default/a"))
    assert kv.value == b"v2" and kv.mod_revision == r2
    assert kv.create_revision == r1 and kv.version == 2


async def s_range(c, rec, side, store):
    for i in range(10):
        rec(await c.put(b"/registry/pods/ns/p%03d" % i, b"x" * 10))
    resp = rec(await c.prefix(b"/registry/pods/", limit=3))
    assert len(resp.kvs) == 3 and resp.more and resp.count == 4
    assert resp.kvs[0].key == b"/registry/pods/ns/p000"
    ko = rec(await c.prefix(b"/registry/pods/", keys_only=True))
    assert all(kv.value == b"" for kv in ko.kvs) and len(ko.kvs) == 10
    co = rec(await c.prefix(b"/registry/pods/", count_only=True))
    assert co.count == 10 and not co.kvs


async def s_txn(c, rec, side, store):
    resp = rec(await c.txn_cas(b"/registry/pods/ns/p", b"v1", required_mod=0))
    assert resp.succeeded
    rev1 = resp.header.revision
    resp = rec(await c.txn_cas(b"/registry/pods/ns/p", b"v2", required_mod=0))
    assert not resp.succeeded
    assert resp.responses[0].response_range.kvs[0].value == b"v1"
    assert resp.responses[0].response_range.kvs[0].mod_revision == rev1
    assert rec(await c.txn_cas(b"/registry/pods/ns/p", b"v2", required_mod=rev1)).succeeded
    assert rec(await c.txn_cas(b"/registry/pods/ns/p", None, required_version=2)).succeeded
    assert rec(await c.get(b"/registry/pods/ns/p")) is None


async def s_txn_rejects(c, rec, side, store):
    pb = side.pb
    req = pb.TxnRequest(
        compare=[pb.Compare(result=pb.Compare.EQUAL, target=pb.Compare.MOD, key=b"k",
                            mod_revision=0)],
        success=[pb.RequestOp(request_put=pb.PutRequest(key=b"k")),
                 pb.RequestOp(request_put=pb.PutRequest(key=b"k"))])
    err = await rec.expect_error(c._txn(req))
    assert err[1] == "INVALID_ARGUMENT"


async def s_compaction(c, rec, side, store):
    for i in range(5):
        rec(await c.put(b"/registry/x", b"%d" % i))
    await c.compact(4)
    err = await rec.expect_error(c.range(b"/registry/x", revision=2))
    assert err[1] == "OUT_OF_RANGE" and "compacted" in err[2]
    err = await rec.expect_error(c.range(b"/registry/x", revision=10**9))
    assert "future" in err[2]


async def s_delete(c, rec, side, store):
    for i in range(4):
        rec(await c.put(b"/registry/leases/ns/l%d" % i, b"x"))
    assert rec(await c.delete(b"/registry/leases/", prefix_end(b"/registry/leases/"))) == 4
    assert rec(await c.prefix(b"/registry/leases/")).count == 0


async def s_watch_protocol(c, rec, side, store):
    rev0 = rec(await c.put(b"/registry/pods/ns/before", b"old"))
    async with c.watch(b"/registry/pods/", prefix_end(b"/registry/pods/"),
                       start_revision=rev0, prev_kv=True) as w:
        rec((w.watch_id, w.compact_revision))
        batch = rec(await w.next(timeout=5))
        assert [e.kv.key for e in batch.events] == [b"/registry/pods/ns/before"]
        rec(await c.put(b"/registry/pods/ns/a", b"v1"))
        rec(await c.put(b"/registry/pods/ns/a", b"v2"))
        rec(await c.delete(b"/registry/pods/ns/a"))
        got = []
        while len(got) < 3:
            got.extend((await w.next(timeout=5)).events)
        rec(got)
        assert [e.type for e in got] == [0, 0, 1]       # PUT, PUT, DELETE
        assert got[1].prev_kv.value == b"v1"
        revs = [e.kv.mod_revision for e in got]
        assert revs == sorted(revs)


async def s_watch_compacted(c, rec, side, store):
    for i in range(5):
        rec(await c.put(b"/registry/x", b"%d" % i))
    await c.compact(5)
    async with c.watch(b"/registry/x", start_revision=2) as w:
        assert rec(w.compact_revision) == 5


async def s_watch_progress(c, rec, side, store):
    async with c.watch(b"/registry/pods/") as w:
        rev = rec(await c.put(b"/registry/other", b"x"))
        await w.request_progress()
        batch = rec(await w.next(timeout=5))
        assert not batch.events and batch.revision >= rev


async def s_watch_barrier(c, rec, side, store):
    async with c.watch(b"/registry/pods/", prefix_end(b"/registry/pods/")) as w:
        last = 0
        for i in range(100):
            last = rec(await c.put(b"/registry/pods/ns/p%03d" % i, b"x"))
        await w.request_progress()
        seen = 0
        while True:
            batch = await w.next(timeout=5)
            if not batch.events:
                rec(batch)
                assert batch.revision >= last and seen == 100, (seen, batch.revision)
                break
            seen += len(batch.events)


async def s_lease(c, rec, side, store):
    l1 = rec(await c.lease_grant(10))
    l2 = rec(await c.lease_grant(10))
    assert l2 == l1 + 1
    rec(await c.put(b"/registry/events/ns/e1", b"x", lease=l1))
    assert rec(await c.get(b"/registry/events/ns/e1")).lease == l1
    await c.lease_revoke(l1)
    assert rec(await c.get(b"/registry/events/ns/e1")) is not None


async def s_unimplemented(c, rec, side, store):
    err = await rec.expect_error(side.raw(c, "/etcdserverpb.Maintenance/Hash", b""))
    assert err[1] == "UNIMPLEMENTED"


async def s_put_frame(c, rec, side, store):
    pb = side.pb
    rec(await c.put(b"/registry/leases/ns/doomed", b"x"))
    w = store.watch(b"/registry/leases/", prefix_end(b"/registry/leases/"))
    items = [(b"/registry/leases/ns/l%03d" % i, b"v%d" % i) for i in range(50)]
    items.append((b"/registry/leases/ns/doomed", None))
    rev = rec(await c.put_batch(items))
    assert rev == store.current_revision
    assert rec(await c.get(b"/registry/leases/ns/l049")).value == b"v49"
    assert rec(await c.get(b"/registry/leases/ns/doomed")) is None
    evs = w.poll(1000)
    rec([(e.type, e.kv.key, e.kv.value, e.kv.mod_revision) for e in evs])
    assert [e.type for e in evs] == ["PUT"] * 50 + ["DELETE"]
    rev_before = store.current_revision
    err = await rec.expect_error(c._put_frame(pb.PutFrameRequest(
        frame=b"\x01\x00\x00\x00\x01\x00\x00\x00kv", count=3)))
    assert err[1] == "INVALID_ARGUMENT"
    assert rec(await c.get(b"k")) is None
    assert store.current_revision == rev_before
    err = await rec.expect_error(c._put_frame(pb.PutFrameRequest(frame=b"", count=2**31)))
    assert err[1] == "INVALID_ARGUMENT"
    assert rec(await c.get(b"/registry/leases/ns/l000")).value == b"v0"


async def s_bind_frame(c, rec, side, store):
    k1, k2 = pod_key("default", "p1"), pod_key("default", "p2")
    r1 = rec(await c.put(k1, encode_pod(PodInfo("p1"))))
    r2 = rec(await c.put(k2, encode_pod(PodInfo("p2"))))
    k3 = b"/registry/pods/default/notjson"
    r3 = rec(await c.put(k3, b"not a pod object"))
    revs = rec(await c.bind_batch([(k1, r1, b"node-a"), (k2, r2 - 1, b"node-b"),
                                   (k3, r3, b"node-c")]))
    assert revs[0] > r3 and revs[1] == -1 and revs[2] == -5
    assert json.loads(rec(await c.get(k1)).value)["spec"]["nodeName"] == "node-a"
    assert "nodeName" not in json.loads(rec(await c.get(k2)).value)["spec"]


async def s_quiet_watch_times_out_then_delivers(c, rec, side, store):
    """A wait that times out leaves the watch open: the next event still
    arrives on the same session, twice over."""
    async with c.watch(b"/registry/pods/", prefix_end(b"/registry/pods/")) as w:
        for i in range(2):
            with pytest.raises(asyncio.TimeoutError):
                await w.next(timeout=0.2)
            rev = rec(await c.put(b"/registry/pods/ns/late%d" % i, b"v"))
            batch = rec(await w.next(timeout=5))
            assert [e.kv.mod_revision for e in batch.events] == [rev]


SCENARIOS = {
    "status": s_status, "put_get": s_put_get, "range": s_range, "txn": s_txn,
    "txn_rejects": s_txn_rejects, "compaction": s_compaction, "delete": s_delete,
    "watch_protocol": s_watch_protocol, "watch_compacted": s_watch_compacted,
    "watch_progress": s_watch_progress, "watch_barrier": s_watch_barrier,
    "lease": s_lease, "unimplemented": s_unimplemented, "put_frame": s_put_frame,
    "bind_frame": s_bind_frame, "quiet_watch": s_quiet_watch_times_out_then_delivers,
}


def _run_side(side: Side, server_kind: str, scenario) -> tuple[list, list]:
    """The scenario through ``side``'s client against a fresh server; the
    record and the store's contents afterwards."""
    srv = SERVERS[server_kind]()
    try:
        rec = Recorder(side)

        async def go():
            c = side.client_cls(f"127.0.0.1:{srv.port}")
            try:
                await scenario(c, rec, side, srv.store)
            finally:
                await c.close()

        asyncio.run(go())
        res = srv.store.range(b"\x00", b"\x00")
        dump = [(kv.key, kv.value, kv.create_revision, kv.mod_revision, kv.version, kv.lease)
                for kv in res.kvs]
        return rec.rows, dump
    finally:
        srv.close()


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
@pytest.mark.parametrize("server_kind", sorted(SERVERS))
def test_port_client_equals_jax_client(server_kind, scenario):
    fn = SCENARIOS[scenario]
    port_rows, port_dump = _run_side(Side("port"), server_kind, fn)
    jax_rows, jax_dump = _run_side(Side("jax"), server_kind, fn)
    assert port_rows == jax_rows
    assert port_dump == jax_dump


@pytest.mark.parametrize("name", ["LeaseGrantRequest", "LeaseGrantResponse",
                                  "LeaseRevokeRequest", "LeaseRevokeResponse"])
def test_lease_messages_match_rpc_pb2(name):
    cls, ref_cls = getattr(codec, name), getattr(rpc_pb2, name)
    rng = np.random.default_rng(sum(name.encode()))
    for _ in range(20):
        kw = {}
        for f in cls.FIELDS:
            if rng.random() < 0.3:
                continue
            if f.kind == "msg":
                kw[f.name] = dict(revision=int(rng.integers(1 << 40)),
                                  cluster_id=int(rng.integers(1 << 20)))
            elif f.kind == "string":
                kw[f.name] = "".join(chr(int(c)) for c in rng.integers(32, 127, 5))
            else:
                kw[f.name] = int(rng.integers(-(1 << 62), 1 << 62))
        mine = cls(**{k: codec.ResponseHeader(**v) if isinstance(v, dict) else v
                      for k, v in kw.items()})
        ref = ref_cls(**{k: rpc_pb2.ResponseHeader(**v) if isinstance(v, dict) else v
                         for k, v in kw.items()})
        assert mine.encode() == ref.SerializeToString()
        assert cls.decode(ref.SerializeToString()) == mine


def test_stress_client_roundtrip_and_throughput_floor():
    """``wire_stress_put`` against the port's ``WireFront``: every put lands
    (1,000 distinct keys, each at version 20), and the native pair clears
    the same 20,000 puts/s floor as the JAX package's test."""
    with MemStore() as store, WireFront(store) as wf:
        n, elapsed = wire_stress_put("127.0.0.1", wf.port, 20_000, concurrency=128,
                                     key_count=1_000, val_len=128)
        assert n == 20_000
        rate = n / elapsed
        assert rate > 20_000, f"only {rate:,.0f} puts/s"
        prefix = b"/registry/leases/stress/"
        assert store.range(prefix, prefix_end(prefix), count_only=True).count == 1_000
        kv = store.get(b"/registry/leases/stress/00000042")
        assert kv is not None and kv.version == 20


def test_many_calls_in_flight_on_one_loop():
    """Stress of the reader-thread-to-loop hand-off: 3,000 puts at once on
    one loop over two connections (far more calls in flight than cores),
    with a short thread switch interval: every call resolves exactly once
    with its own revision, and every key lands."""
    import sys

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with MemStore() as store, WireFront(store) as wf:
            async def go():
                clients = [tclient.EtcdClient(f"127.0.0.1:{wf.port}") for _ in range(2)]
                try:
                    return await asyncio.wait_for(asyncio.gather(*(
                        clients[i % 2].put(b"/stress/k%05d" % i, b"v%d" % i)
                        for i in range(3000))), 60)
                finally:
                    for c in clients:
                        await c.close()

            revs = asyncio.run(go())
            assert len(set(revs)) == 3000 and min(revs) == 2 and max(revs) == 3001
            res = store.range(b"/stress/", prefix_end(b"/stress/"))
            assert [kv.key for kv in res.kvs] == [b"/stress/k%05d" % i for i in range(3000)]
            assert all(kv.value == b"v%d" % i for i, kv in enumerate(res.kvs))
    finally:
        sys.setswitchinterval(old)
