"""The port's asyncio etcd server (``store/etcd_server.py`` on
``store/wire_server.py``, no grpcio) against the JAX package's, on the CPU.

- The corpus of ``tests/test_etcd_server.py`` (the scenarios of
  ``tests/test_torch_etcd_client.py``) through the port's client against
  both of the port's wires, the asyncio server and the native
  ``WireFront``.
- One request script (Range with limit, count and keys-only, Txn success,
  failure and the refused shapes, Compact errors, a watch with past and
  live events, progress, a compacted start, a duplicate id and cancels,
  leases with keep-alive, the Maintenance stubs, PutFrame and BindFrame
  good and malformed, an unknown method) sent raw to the JAX ``serve()``
  and to the port's, each over a fresh ``MemStore``: the response bytes,
  status codes and messages must be equal, and so must the stores.
- The JAX ``EtcdClient`` (grpcio: Huffman-coded, indexed headers, BDP
  pings, its own windows) runs the corpus against the port's server and
  records exactly what it records against the JAX server.
- Flow control, on a raw HTTP/2 socket: a Range response over 1 MiB never
  passes the client's connection and stream windows nor 16 KB frames, the
  server answers request DATA with WINDOW_UPDATEs, and a request of several
  MB in 16 KB frames is stored whole; a watch whose
  reader stalls holds the server at the stream window, and a reset ends
  its pump and frees the native watcher.
- ``store/wiretier.py``: composed frames byte-identical to the JAX
  package's constructor path, the shared-frame tail round trip through
  ``decode_shared_tail``, ``FrameTable`` and ``SubscriptionMap`` equal to
  the JAX copies.
- ``server_main --metrics-port`` renders the same store metric families on
  either wire as the JAX ``server_main``.

Tolerance: exact equality everywhere.
"""

import _torch_cpu  # noqa: F401  (bounds torch's CPU threads first)

import asyncio
import collections
import os
import queue
import socket
import subprocess
import sys
import threading
import urllib.request

import numpy as np
import pytest

from k8s1m_tpu.control.objects import encode_pod as jax_encode_pod
from k8s1m_tpu.snapshot.pod_encoding import PodInfo
from k8s1m_tpu.store import wiretier as jax_wiretier
from k8s1m_tpu.store.native import decode_shared_tail as jax_decode_shared_tail
from k8s1m_tpu.store.proto import rpc_pb2
from k8s1m_tpu.store.watch_cache import CacheEvent, encode_event_batch
from k8s1m_tpu_torch.store import wiretier
from k8s1m_tpu_torch.store.native import (
    decode_shared_tail,
    pack_bind_frame,
    pack_put_frame,
    prefix_end,
    read_varint,
)
from k8s1m_tpu_torch.store.proto import codec as pb
from k8s1m_tpu_torch.store.wire import (
    DATA,
    END_HEADERS,
    END_STREAM,
    HEADERS,
    PREFACE,
    RST_STREAM,
    S_INITIAL_WINDOW_SIZE,
    SETTINGS,
    WINDOW_UPDATE,
    Channel,
    HpackDecoder,
    WireError,
    _frame,
    encode_headers,
)
from test_torch_etcd_client import SCENARIOS, Recorder, Side
from test_torch_wire import AsyncioServer, NativeServer, PortAsyncioServer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIRES = {"asyncio": PortAsyncioServer, "native": NativeServer}


def _run(server_cls, side: Side, scenario) -> tuple[list, list]:
    """``scenario`` through ``side``'s client against a fresh server; the
    record and the store's contents afterwards."""
    srv = server_cls()
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
        return rec.rows, [(kv.key, kv.value, kv.create_revision, kv.mod_revision, kv.version,
                           kv.lease) for kv in res.kvs]
    finally:
        srv.close()


# ---- the corpus on both of the port's wires ------------------------------------


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
@pytest.mark.parametrize("wire", sorted(WIRES))
def test_corpus_on_both_wires(wire, scenario):
    rows, _dump = _run(WIRES[wire], Side("port"), SCENARIOS[scenario])
    assert rows


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_grpcio_client_against_the_port_server(scenario):
    """The JAX ``EtcdClient`` (grpcio) records the same results, and leaves
    the same store, against the port's server as against the JAX one."""
    port_rows, port_dump = _run(PortAsyncioServer, Side("jax"), SCENARIOS[scenario])
    jax_rows, jax_dump = _run(AsyncioServer, Side("jax"), SCENARIOS[scenario])
    assert port_rows == jax_rows
    assert port_dump == jax_dump


# ---- one raw request script against both servers -------------------------------

_KV, _WATCH, _LEASE, _MAINT = ("/etcdserverpb.KV/", "/etcdserverpb.Watch/Watch",
                               "/etcdserverpb.Lease/", "/etcdserverpb.Maintenance/")
_BATCH = "/k8s1m.BatchKV/"
PODS = b"/registry/pods/"


class _Script:
    """Raw calls through the port's transport; every answer recorded as
    (what, status name, details, response bytes)."""

    def __init__(self, port: int):
        self.ch = Channel(f"127.0.0.1:{port}")
        self.rows: list = []

    def call(self, path: str, req) -> bytes | None:
        raw = req if isinstance(req, bytes) else req.encode()
        try:
            out = self.ch.unary(path, raw)
        except WireError as e:
            self.rows.append((path, e.code.name, e.details, None))
            return None
        self.rows.append((path, "OK", "", out))
        return out

    def stream(self, path: str):
        frames: queue.Queue = queue.Queue()
        s = self.ch.stream(path, frames.put, lambda code, d: frames.put((code.name, d)))
        return s, frames

    def take(self, frames: queue.Queue, n: int, what: str) -> None:
        for _ in range(n):
            self.rows.append((what, frames.get(timeout=10)))


def _compare(a: pb.Compare, *ops, failure=()) -> pb.TxnRequest:
    return pb.TxnRequest(compare=[a], success=list(ops), failure=list(failure))


def _request_script(port: int) -> list:
    s = _Script(port)
    kv, lease, maint = _KV, _LEASE, _MAINT
    try:
        s.call(maint + "Status", pb.StatusRequest())
        for i in range(10):
            s.call(kv + "Put", pb.PutRequest(key=PODS + b"ns/p%03d" % i, value=b"x" * (i + 1)))
        s.call(kv + "Put", pb.PutRequest(key=PODS + b"ns/p000", value=b"new", prev_kv=True))
        s.call(kv + "Put", pb.PutRequest(key=b"/registry/events/e", value=b"e", lease=7))
        s.call(kv + "Put", pb.PutRequest(key=b"/k", value=b"v", ignore_value=True))
        end = prefix_end(PODS)
        for req in (pb.RangeRequest(key=PODS + b"ns/p003"),
                    pb.RangeRequest(key=PODS, range_end=end, limit=3),
                    pb.RangeRequest(key=PODS, range_end=end, count_only=True),
                    pb.RangeRequest(key=PODS, range_end=end, keys_only=True),
                    pb.RangeRequest(key=PODS, range_end=end, revision=4),
                    pb.RangeRequest(key=b"\x00", range_end=b"\x00"),
                    pb.RangeRequest(key=PODS, revision=10 ** 9)):
            s.call(kv + "Range", req)
        k = PODS + b"ns/t"
        mod0 = pb.Compare(result=pb.Compare.EQUAL, target=pb.Compare.MOD, key=k, mod_revision=0)
        put = pb.RequestOp(request_put=pb.PutRequest(key=k, value=b"t1"))
        rng = pb.RequestOp(request_range=pb.RangeRequest(key=k))
        s.call(kv + "Txn", _compare(mod0, put, failure=[rng]))
        s.call(kv + "Txn", _compare(mod0, put, failure=[rng]))
        s.call(kv + "Txn", _compare(mod0, put))
        ver1 = pb.Compare(result=pb.Compare.EQUAL, target=pb.Compare.VERSION, key=k, version=1)
        s.call(kv + "Txn", _compare(ver1, pb.RequestOp(
            request_delete_range=pb.DeleteRangeRequest(key=k))))
        for bad in (_compare(mod0, put, put),
                    _compare(pb.Compare(result=pb.Compare.GREATER, target=pb.Compare.MOD,
                                        key=k, mod_revision=0), put),
                    _compare(pb.Compare(result=pb.Compare.EQUAL, target=pb.Compare.CREATE,
                                        key=k, create_revision=0), put),
                    _compare(mod0, pb.RequestOp(request_put=pb.PutRequest(key=b"/other"))),
                    _compare(mod0, pb.RequestOp(request_delete_range=pb.DeleteRangeRequest(
                        key=k, range_end=b"\x00"))),
                    _compare(mod0, rng),
                    _compare(mod0, put, failure=[put]),
                    pb.TxnRequest()):
            s.call(kv + "Txn", bad)
        s.call(kv + "DeleteRange", pb.DeleteRangeRequest(key=PODS + b"ns/p009", prev_kv=True))
        s.call(kv + "DeleteRange", pb.DeleteRangeRequest(key=PODS + b"ns/p007",
                                                         range_end=PODS + b"ns/p009",
                                                         prev_kv=True))
        s.call(kv + "DeleteRange", pb.DeleteRangeRequest(key=b"/none"))
        s.call(kv + "Compact", pb.CompactionRequest(revision=10 ** 9))
        s.call(kv + "Compact", pb.CompactionRequest(revision=5))
        s.call(kv + "Compact", pb.CompactionRequest(revision=3))
        s.call(kv + "Range", pb.RangeRequest(key=PODS, range_end=end, revision=2))

        w, frames = s.stream(_WATCH)

        def wsend(**kw):
            w.send(pb.WatchRequest(**kw).encode())

        wsend(create_request=pb.WatchCreateRequest(key=PODS, range_end=end, start_revision=6,
                                                   prev_kv=True))
        s.take(frames, 2, "created, past batch")
        s.call(kv + "Put", pb.PutRequest(key=PODS + b"ns/live", value=b"l"))
        s.take(frames, 1, "live")
        wsend(progress_request=pb.WatchProgressRequest())
        s.take(frames, 1, "progress")
        wsend(create_request=pb.WatchCreateRequest(key=PODS, start_revision=2))
        s.take(frames, 1, "compacted start")
        wsend(create_request=pb.WatchCreateRequest(key=PODS, watch_id=1))
        s.take(frames, 1, "duplicate id")
        wsend(create_request=pb.WatchCreateRequest(key=b"/registry/events/", watch_id=50))
        s.take(frames, 1, "created 50")
        wsend(cancel_request=pb.WatchCancelRequest(watch_id=50))
        s.take(frames, 1, "canceled 50")
        w.send(pb.WatchRequest(cancel_request=pb.WatchCancelRequest(watch_id=1)).encode(),
               end_stream=True)
        s.take(frames, 2, "canceled 1, end")

        s.call(lease + "LeaseGrant", pb.LeaseGrantRequest(TTL=10))
        s.call(lease + "LeaseGrant", pb.LeaseGrantRequest(TTL=30, ID=100))
        for lid in (1, 999):
            s.call(lease + "LeaseTimeToLive", pb.LeaseTimeToLiveRequest(ID=lid))
        s.call(lease + "LeaseLeases", pb.LeaseLeasesRequest())
        ka, kframes = s.stream(lease + "LeaseKeepAlive")
        ka.send(pb.LeaseKeepAliveRequest(ID=1).encode())
        s.take(kframes, 1, "keepalive 1")
        ka.send(pb.LeaseKeepAliveRequest(ID=5).encode(), end_stream=True)
        s.take(kframes, 2, "keepalive 5, end")
        s.call(lease + "LeaseRevoke", pb.LeaseRevokeRequest(ID=1))
        s.call(lease + "LeaseLeases", pb.LeaseLeasesRequest())

        s.call(maint + "Alarm", pb.AlarmRequest())
        s.call(maint + "Defragment", pb.DefragmentRequest())
        s.call(maint + "Hash", pb.HashRequest())
        s.call(maint + "MoveLeader", pb.MoveLeaderRequest(targetID=2))
        s.call(maint + "Snapshot", pb.SnapshotRequest())
        s.call(maint + "Status", pb.StatusRequest())

        items = [(b"/registry/leases/l%d" % i, b"v%d" % i) for i in range(3)]
        items.append((PODS + b"ns/p001", None))
        s.call(_BATCH + "PutFrame", pb.PutFrameRequest(frame=pack_put_frame(items), count=4))
        s.call(_BATCH + "PutFrame", pb.PutFrameRequest(frame=b"", count=2 ** 31))
        s.call(_BATCH + "PutFrame", pb.PutFrameRequest(
            frame=b"\x01\x00\x00\x00\x01\x00\x00\x00kv", count=1))
        revs = []
        for name in ("b1", "b2"):
            out = s.call(kv + "Put", pb.PutRequest(key=PODS + b"default/" + name.encode(),
                                                   value=jax_encode_pod(PodInfo(name))))
            revs.append(pb.PutResponse.decode(out).header.revision)
        binds = [(PODS + b"default/b1", revs[0], b"node-a"),
                 (PODS + b"default/b2", revs[1] - 1, b"node-b"),
                 (PODS + b"ns/p002", 0, b"node-c")]
        s.call(_BATCH + "BindFrame", pb.BindFrameRequest(frame=pack_bind_frame(binds), count=3))
        s.call(_BATCH + "BindFrame", pb.BindFrameRequest(frame=b"x" * 16, count=2))
        s.call(_BATCH + "BindFrame", pb.BindFrameRequest(frame=b"\xff" * 16, count=1))
        s.call("/etcdserverpb.KV/NoSuchMethod", b"")
        s.call(kv + "Range", pb.RangeRequest(key=b"\x00", range_end=b"\x00"))
    finally:
        s.ch.close()
    return s.rows


def test_raw_script_byte_identical_to_the_jax_server():
    rows = {}
    dumps = {}
    for name, cls in (("port", PortAsyncioServer), ("jax", AsyncioServer)):
        srv = cls()
        try:
            rows[name] = _request_script(srv.port)
            res = srv.store.range(b"\x00", b"\x00")
            dumps[name] = [(kv.key, kv.value, kv.mod_revision, kv.version, kv.lease)
                           for kv in res.kvs]
        finally:
            srv.close()
    assert len(rows["port"]) == len(rows["jax"]) > 70
    for i, (mine, ref) in enumerate(zip(rows["port"], rows["jax"])):
        assert mine == ref, (i, mine, ref)
    assert dumps["port"] == dumps["jax"]
    # The script reached every status the servers give.
    statuses = {r[1] for r in rows["port"] if len(r) == 4}
    assert {"OK", "INVALID_ARGUMENT", "OUT_OF_RANGE", "UNIMPLEMENTED"} <= statuses


# ---- flow control on a raw HTTP/2 socket ---------------------------------------


class _RawH2:
    """A bare HTTP/2 client that grants ``window`` bytes per stream and
    never tops a window up unless told to."""

    def __init__(self, port: int, window: int):
        self.sock = socket.create_connection(("127.0.0.1", port), timeout=10)
        settings = S_INITIAL_WINDOW_SIZE.to_bytes(2, "big") + window.to_bytes(4, "big")
        self.sock.sendall(PREFACE + _frame(6, SETTINGS, 0, 0) + settings)
        self.buf = bytearray()
        self.hpack = HpackDecoder()

    def open(self, sid: int, path: bytes, msgs, end_stream: bool, extra=()) -> None:
        block = encode_headers([(b":method", b"POST"), (b":scheme", b"http"),
                                (b":path", path), (b":authority", b"x"),
                                (b"content-type", b"application/grpc"), (b"te", b"trailers"),
                                *extra])
        out = _frame(len(block), HEADERS, END_HEADERS, sid) + block
        data = b"".join(b"\x00" + len(m).to_bytes(4, "big") + m for m in msgs)
        for off in range(0, max(len(data), 1), 16384):
            chunk = data[off:off + 16384]
            last = off + 16384 >= len(data)
            out += _frame(len(chunk), DATA, END_STREAM if last and end_stream else 0, sid) + chunk
        self.sock.sendall(out)

    def send(self, data: bytes) -> None:
        self.sock.sendall(data)

    def frames(self, until, quiet: float | None = 0.2) -> list:
        """The frames that arrive until ``until(frames)`` holds (a server
        that never gets there fails on the socket's 10 s timeout), then any
        more that arrive before ``quiet`` s pass with nothing.  The gap only
        bounds the check that nothing more comes: a slow host can make it
        miss a late frame, never fail a correct server."""
        out: list = []
        self.sock.settimeout(10)
        while not until(out):
            assert self._read(out), f"connection closed before the condition held: {out}"
        if quiet is not None:
            self.sock.settimeout(quiet)
            try:
                while self._read(out):
                    pass
            except TimeoutError:
                pass
        return out

    def _read(self, out: list) -> bool:
        """One ``recv``; its whole frames go to ``out``.  False at EOF."""
        chunk = self.sock.recv(1 << 20)
        if not chunk:
            return False
        self.buf += chunk
        buf, pos = self.buf, 0
        while len(buf) - pos >= 9:
            n = int.from_bytes(buf[pos:pos + 3], "big")
            if len(buf) - pos < 9 + n:
                break
            ftype, flags = buf[pos + 3], buf[pos + 4]
            sid = int.from_bytes(buf[pos + 5:pos + 9], "big") & 0x7FFFFFFF
            payload = bytes(buf[pos + 9:pos + 9 + n])
            pos += 9 + n
            if ftype == HEADERS:
                payload = self.hpack.decode(payload)
            out.append((ftype, flags, sid, payload))
        del buf[:pos]
        return True

    def close(self) -> None:
        self.sock.close()


def _data_bytes(frames, sid: int) -> bytes:
    return b"".join(p for t, _f, s, p in frames if t == DATA and s == sid)


def _trailers(frames, sid: int) -> list:
    """The header lists that ended stream ``sid``."""
    return [dict(p) for t, f, s, p in frames if t == HEADERS and s == sid and f & END_STREAM]


def _whole_message(frames, sid: int) -> bool:
    data = _data_bytes(frames, sid)
    return len(data) >= 5 and len(data) >= 5 + int.from_bytes(data[1:5], "big")


def test_flow_control_large_range_and_request_window_updates():
    srv = PortAsyncioServer()
    raw = _RawH2(srv.port, 65535)
    try:
        # Request side: a PutFrame of ~1.2 MB in 16 KB DATA frames is
        # answered with WINDOW_UPDATEs covering every byte sent.
        items = [(b"/registry/big/%05d" % i, bytes([i % 251]) * 1000) for i in range(1200)]
        req = pb.PutFrameRequest(frame=pack_put_frame(items), count=len(items)).encode()
        raw.open(1, b"/k8s1m.BatchKV/PutFrame", [req], end_stream=True)
        frames = raw.frames(lambda fs: _trailers(fs, 1))
        conn_updates = sum(int.from_bytes(p, "big") for t, _f, s, p in frames
                           if t == WINDOW_UPDATE and s == 0)
        assert conn_updates >= len(req) + 5
        assert _trailers(frames, 1)[-1][b"grpc-status"] == b"0"
        # A request of ~6.5 MB in 400 frames of 16 KB is reassembled whole
        # (appended in place, never copied again per frame) and stored.
        huge = [(b"/registry/huge/%05d" % i, bytes([i % 241]) * 1600) for i in range(4000)]
        hreq = pb.PutFrameRequest(frame=pack_put_frame(huge), count=len(huge)).encode()
        assert len(hreq) > 6 << 20
        raw.open(3, b"/k8s1m.BatchKV/PutFrame", [hreq], end_stream=True)
        hframes = raw.frames(lambda fs: _trailers(fs, 3))
        assert _trailers(hframes, 3)[-1][b"grpc-status"] == b"0"
        res = srv.store.range(b"/registry/huge/", prefix_end(b"/registry/huge/"))
        assert [(kv.key, kv.value) for kv in res.kvs] == huge
        # Response side: a Range of ~1.2 MB stops at the connection's
        # 65,535-byte window (less the PutFrames' answers), in frames of at
        # most 16 KB, until the client grants more.
        window = 65535 - len(_data_bytes(frames, 1)) - len(_data_bytes(hframes, 3))
        rreq = pb.RangeRequest(key=b"/registry/big/", range_end=prefix_end(b"/registry/big/"))
        raw.open(5, b"/etcdserverpb.KV/Range", [rreq.encode()], end_stream=True)
        first = raw.frames(lambda fs: len(_data_bytes(fs, 5)) >= window, quiet=0.3)
        assert len(_data_bytes(first, 5)) == window
        assert all(len(p) <= 16384 for t, _f, _s, p in first if t == DATA)
        assert not _trailers(first, 5)
        grant = (1 << 30).to_bytes(4, "big")
        raw.send(_frame(4, WINDOW_UPDATE, 0, 0) + grant + _frame(4, WINDOW_UPDATE, 0, 5) + grant)
        rest = raw.frames(lambda fs: _trailers(fs, 5), quiet=None)
        body = _data_bytes(first, 5) + _data_bytes(rest, 5)
        assert len(body) > 1 << 20
        assert int.from_bytes(body[1:5], "big") == len(body) - 5
        _rev, more, count, got, _last = pb.parse_range(body[5:], keys=True, values=True)
        assert got == items and count == 1200 and not more
        assert _trailers(rest, 5)[-1][b"grpc-status"] == b"0"
    finally:
        raw.close()
        srv.close()


def test_stalled_watch_holds_at_the_window_and_a_reset_frees_it():
    srv = PortAsyncioServer()
    raw = _RawH2(srv.port, 4096)
    try:
        create = pb.WatchRequest(create_request=pb.WatchCreateRequest(
            key=b"/registry/w/", range_end=prefix_end(b"/registry/w/"))).encode()
        raw.open(1, b"/etcdserverpb.Watch/Watch", [create], end_stream=False)
        created = raw.frames(lambda fs: _whole_message(fs, 1), quiet=None)
        assert pb.WatchResponse.decode(_data_bytes(created, 1)[5:]).created
        assert srv.store.stats()["watchers"] == 1
        srv.store.put_batch([(b"/registry/w/%05d" % i, b"v" * 500) for i in range(3000)])
        before = len(_data_bytes(created, 1))
        stalled = raw.frames(lambda fs: before + len(_data_bytes(fs, 1)) >= 4096, quiet=0.3)
        sent = before + len(_data_bytes(stalled, 1))
        assert sent == 4096       # held at the stream window; the reader never read
        raw.send(_frame(4, RST_STREAM, 0, 1) + (0x8).to_bytes(4, "big"))
        gone = threading.Event()
        for _ in range(500):
            if srv.store.stats()["watchers"] == 0:
                break
            gone.wait(0.02)
        assert srv.store.stats()["watchers"] == 0
        # The connection still serves.
        raw.open(3, b"/etcdserverpb.KV/Range",
                 [pb.RangeRequest(key=b"/registry/w/00007").encode()], end_stream=True)
        done = raw.frames(lambda fs: _trailers(fs, 3), quiet=None)
        resp = pb.RangeResponse.decode(_data_bytes(done, 3)[5:])
        assert [kv.value for kv in resp.kvs] == [b"v" * 500]
    finally:
        raw.close()
        srv.close()


def test_deadline_stream_limit_and_protocol_errors():
    """``grpc-timeout`` ends a call as DEADLINE_EXCEEDED (the watch pump
    freed), a stream past the 100-stream limit is refused, and a bad
    preface gets GOAWAY(PROTOCOL_ERROR) and a closed socket."""
    srv = PortAsyncioServer()
    raw = _RawH2(srv.port, 1 << 20)
    try:
        create = pb.WatchRequest(create_request=pb.WatchCreateRequest(key=b"/d")).encode()
        raw.open(1, b"/etcdserverpb.Watch/Watch", [create], end_stream=False,
                 extra=[(b"grpc-timeout", b"200m")])
        trailers = _trailers(raw.frames(lambda fs: _trailers(fs, 1), quiet=None), 1)
        assert trailers[0][b"grpc-status"] == b"4"
        assert trailers[0][b"grpc-message"] == b"Deadline Exceeded"
        assert srv.store.stats()["watchers"] == 0
        sids = range(3, 3 + 2 * 101, 2)
        for sid in sids:        # 101 watch streams left open
            raw.open(sid, b"/etcdserverpb.Watch/Watch", [], end_stream=False)

        def resets(fs):
            return [(s, int.from_bytes(p, "big")) for t, _f, s, p in fs
                    if t == RST_STREAM and s in sids]
        assert resets(raw.frames(resets, quiet=0.3)) == [(sids[-1], 0x7)]   # REFUSED_STREAM
    finally:
        raw.close()
    bad = socket.create_connection(("127.0.0.1", srv.port), timeout=10)
    try:
        bad.sendall(b"GET / HTTP/1.1\r\nHost: x\r\n\r\n")
        data = b""
        while True:
            chunk = bad.recv(65536)
            if not chunk:
                break
            data += chunk
        goaway = data.rfind(bytes((7, 0)) + bytes(4))           # type GOAWAY on stream 0
        assert goaway >= 3 and data[goaway + 10:goaway + 14] == (0x1).to_bytes(4, "big")
    finally:
        bad.close()
        srv.close()


# ---- wiretier --------------------------------------------------------------------

_Ev = collections.namedtuple("_Ev", "type key value create_revision mod_revision version")


def test_compose_frame_byte_identity_and_extension_tail():
    """Twin of tests/test_watch_cache.py::
    test_compose_frame_byte_identity_and_extension_tail on the port's
    wiretier and ``decode_shared_tail``."""
    header = pb.ResponseHeader(cluster_id=1, member_id=2, revision=777, raft_term=1)
    jheader = rpc_pb2.ResponseHeader(cluster_id=1, member_id=2, revision=777, raft_term=1)
    events = [_Ev(0, PODS + b"a", b"v1", 7, 9, 2), _Ev(1, PODS + b"b", b"", 5, 10, 3),
              _Ev(0, PODS + b"big", b"x" * 3000, 11, 300000, 41)]
    jevents = [CacheEvent(*e) for e in events]
    hb = wiretier.header_bytes(header)
    assert hb == jax_wiretier.header_bytes(jheader)
    chunks = [wiretier.encode_event(e) for e in events]
    assert chunks == [jax_wiretier.encode_event(e) for e in jevents]
    for wid in (1, 7, 300000):
        composed = wiretier.compose_frame(hb, [wid], chunks)
        assert composed == encode_event_batch(jheader, wid, jevents).SerializeToString()
        assert decode_shared_tail(composed) == ([], 0, len(composed))
    shared = wiretier.compose_frame(hb, [7, 9, 123456], chunks, from_rev=777)
    assert shared == jax_wiretier.compose_frame(hb, [7, 9, 123456], chunks, from_rev=777)
    extra, from_rev, core = decode_shared_tail(shared)
    assert (extra, from_rev) == ([9, 123456], 777)
    assert jax_decode_shared_tail(shared) == (extra, from_rev, core)
    assert shared[:core] == encode_event_batch(jheader, 7, jevents).SerializeToString()
    resp = rpc_pb2.WatchResponse.FromString(shared)
    assert resp.watch_id == 7 and len(resp.events) == 3
    assert resp.events[2].kv.mod_revision == 300000
    assert pb.WatchResponse.decode(shared).watch_id == 7
    ctl = pb.WatchResponse(header=header, watch_id=-1)
    assert wiretier.serialize_frame_or_message(ctl) == rpc_pb2.WatchResponse(
        header=jheader, watch_id=-1).SerializeToString()
    assert wiretier.serialize_frame_or_message(shared) is shared


@pytest.mark.parametrize("seed", range(3))
def test_varints_and_shared_tails_round_trip(seed):
    rng = np.random.default_rng(seed)
    for _ in range(200):
        n = int(rng.integers(0, 1 << int(rng.integers(1, 63))))
        v = wiretier.varint(n)
        assert v == jax_wiretier.varint(n)
        assert read_varint(b"\x00" + v, 1) == (n, len(v) + 1)
    hb = wiretier.header_bytes(pb.ResponseHeader(revision=int(rng.integers(1 << 40))))
    evs = [_Ev(int(rng.integers(2)), b"/k%d" % i, bytes(int(rng.integers(0, 300))),
               i + 1, i + 2, 1) for i in range(20)]
    chunks = [wiretier.encode_event(e) for e in evs]
    wids = [int(x) for x in rng.integers(1, 1 << 40, int(rng.integers(1, 6)))]
    from_rev = int(rng.integers(0, 1 << 30))
    frame = wiretier.compose_frame(hb, wids, chunks, from_rev=from_rev)
    extra, got_from, core = decode_shared_tail(frame)
    assert (extra, got_from) == (wids[1:], from_rev)
    assert (extra, got_from, core) == jax_decode_shared_tail(frame)
    assert frame[:core] == wiretier.compose_frame(hb, wids[:1], chunks)


def test_frame_table_and_subscription_map_equal_jax():
    mine, ref = wiretier.FrameTable(cap=3), jax_wiretier.FrameTable(cap=3)
    calls = []

    def enc(x):
        calls.append(x)
        return b"%d" % x

    for key in (1, 2, 1, 3, 4, 1, 0, 0, 2):
        assert mine.bytes_for(key, enc, key) == ref.bytes_for(key, enc, key)
        assert len(mine) == len(ref)
    assert calls == [1, 1, 2, 2, 3, 3, 4, 4, 1, 1, 0, 0, 0, 0, 2, 2]
    keys = [b"/registry/pods/ns/p%d" % i for i in range(500)]
    smap, jmap = wiretier.SubscriptionMap(range(5)), jax_wiretier.SubscriptionMap(range(5))
    assert [smap.replica_for(k) for k in keys] == [jmap.replica_for(k) for k in keys]
    less, jless = smap.without(2), jmap.without(2)
    assert [less.replica_for(k) for k in keys] == [jless.replica_for(k) for k in keys]
    with pytest.raises(ValueError):
        wiretier.SubscriptionMap([])


# ---- server_main --------------------------------------------------------------


def _metric_families(module: str, *args: str) -> set:
    """The ``memstore_*`` families that ``python -m <module> --port 0
    --metrics-port P`` renders, P a free port."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        mport = s.getsockname()[1]
    proc = subprocess.Popen(
        [sys.executable, "-m", module, "--port", "0", "--host", "127.0.0.1",
         "--wal-default", "none", "--metrics-port", str(mport), *args],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT), stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL)
    try:
        stop = threading.Event()
        body = ""
        for _ in range(300):
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{mport}/metrics", timeout=5) as r:
                    body = r.read().decode()
                break
            except OSError:
                assert proc.poll() is None, f"{module} exited with {proc.returncode}"
                stop.wait(0.05)
        return {line.split()[2] for line in body.splitlines()
                if line.startswith("# TYPE memstore_")}
    finally:
        proc.terminate()
        proc.wait(timeout=30)


def test_server_main_renders_the_jax_store_families_on_both_wires():
    ref = _metric_families("k8s1m_tpu.store.server_main")
    assert "memstore_store" in ref and "memstore_requests_total" in ref
    for wire in ("native", "asyncio"):
        assert _metric_families("k8s1m_tpu_torch.store.server_main", "--wire", wire) == ref


def test_server_main_asyncio_prints_its_port_and_serves():
    from k8s1m_tpu_torch.store.remote import RemoteStore
    from k8s1m_tpu_torch.store.server_main import serve_subprocess

    with serve_subprocess("--wire", "asyncio") as (proc, target):
        rs = RemoteStore(target)
        try:
            rev = rs.put(b"/registry/a", b"v")
            assert rs.get(b"/registry/a").value == b"v" and rev == 2
            status = pb.StatusResponse.decode(
                rs.channel.unary("/etcdserverpb.Maintenance/Status", b""))
            assert status.version == "3.5.16"
        finally:
            rs.close()
    assert proc.returncode == 0
