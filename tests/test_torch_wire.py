"""The port's etcd wire below ``RemoteStore``, on the CPU: the hand protobuf
codec (``store/proto/codec.py``), HPACK and the HTTP/2 + gRPC transport
(``store/wire.py``).

- The codec against the JAX package's generated ``*_pb2`` modules, byte
  for byte both ways, on messages drawn from ``numpy.random.default_rng``
  (every message the client speaks, empty ones and a 64 MiB-class value),
  and the light parsers against the full decode.
- HPACK against RFC 7541's Appendix C vectors (static and dynamic table,
  size-bounded eviction, Huffman strings).
- The transport against three servers: the native front-end
  (``WireFront``: 1 GiB windows, literal headers), grpcio's C-core under
  the JAX package's asyncio ``etcd_server`` (small starting windows raised
  later, Huffman-coded and indexed headers, trailers-only errors) and the
  port's own asyncio ``etcd_server`` on ``store/wire_server.py`` — a
  client window smaller than one response, a request larger than the
  server's starting window, the receive cap, and a stream reset.
- No module of the port, and not ``chip_smoke.py``, imports ``grpc``,
  ``google.protobuf``, ``jax`` or ``k8s1m_tpu``; with those blocked, the
  port's asyncio server starts and answers a Range.

Tolerance: byte identity everywhere.
"""

import _torch_cpu  # noqa: F401  (bounds torch's CPU threads first)

import asyncio
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

from k8s1m_tpu.store.etcd_server import serve
from k8s1m_tpu.store.native import MemStore as JaxMemStore
from k8s1m_tpu.store.proto import batch_pb2, mvcc_pb2, rpc_pb2
from k8s1m_tpu_torch.store import etcd_server as port_etcd_server
from k8s1m_tpu_torch.store.native import MemStore, WireFront, prefix_end
from k8s1m_tpu_torch.store.proto import codec
from k8s1m_tpu_torch.store.wire import (
    Channel,
    H2Error,
    HpackDecoder,
    StatusCode,
    WireError,
    encode_headers,
    huffman_decode,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# ---- servers -------------------------------------------------------------------


class AsyncioServer:
    """The JAX package's asyncio etcd server (grpcio's C-core underneath)
    over a JAX MemStore, on an event loop in a background thread."""

    def __init__(self):
        self.store = JaxMemStore()
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()
        self.server, self.port = self.run(serve(self.store, port=0))

    def run(self, coro, timeout: float = 30.0):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(timeout)

    def stop_server(self) -> None:
        self.run(self.server.stop(None))

    def close(self) -> None:
        """Stop the server, then drain the loop's default executor before
        the store closes: the server's watch pumps poll the store there,
        and ``loop.close()`` alone does not wait for a poll in flight."""
        self.stop_server()
        self.run(self.loop.shutdown_default_executor())
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(timeout=10)
        assert not self.thread.is_alive()
        self.loop.close()
        self.store.close()


class NativeServer:
    """The port's ``WireFront`` over the port's MemStore."""

    def __init__(self):
        self.store = MemStore()
        self.wf = WireFront(self.store)
        self.port = self.wf.port

    def close(self) -> None:
        self.wf.close()
        self.store.close()


class PortAsyncioServer(AsyncioServer):
    """The port's asyncio etcd server (``store/wire_server.py``, no grpcio)
    over the port's MemStore, on an event loop in a background thread."""

    def __init__(self):
        self.store = MemStore()
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()
        self.server, self.port = self.run(port_etcd_server.serve(self.store, port=0))

    def stop_server(self) -> None:
        self.run(self.server.stop())


SERVERS = {"native": NativeServer, "asyncio": AsyncioServer, "port_asyncio": PortAsyncioServer}


@pytest.fixture(params=sorted(SERVERS))
def server(request):
    srv = SERVERS[request.param]()
    try:
        yield srv
    finally:
        srv.close()


# ---- codec vs the generated modules --------------------------------------------

PB2 = {name: getattr(mod, name) for mod in (rpc_pb2, mvcc_pb2, batch_pb2)
       for name in dir(mod) if not name.startswith("_")}
MESSAGES = sorted(name for name, v in vars(codec).items()
                  if isinstance(v, type) and issubclass(v, codec.Message) and v is not codec.Message)

_INTS = {
    "int64": [0, 1, -1, 300, (1 << 63) - 1, -(1 << 63)],
    "uint64": [0, 1, 300, (1 << 64) - 1],
    "int32": [0, 1, -1, (1 << 31) - 1, -(1 << 31)],
    "uint32": [0, 1, 300, (1 << 32) - 1],
    "enum": [0, 1, 2, 3],
}


def _value(rng, f, depth):
    if f.kind == "msg":
        return _message(rng, f.sub, depth + 1)
    if f.kind == "bool":
        return bool(rng.integers(2))
    if f.kind in ("bytes", "string"):
        n = int(rng.choice([0, 1, 7, 300, 70_000]))
        raw = rng.integers(32 if f.kind == "string" else 0, 127 if f.kind == "string" else 256,
                           n, dtype=np.uint8).tobytes()
        return raw.decode() if f.kind == "string" else raw
    vals = _INTS[f.kind]
    if rng.random() < 0.5:
        return vals[int(rng.integers(len(vals)))]
    lo = -(1 << 31) if f.kind in ("int64", "int32") else 0
    return int(rng.integers(lo, 1 << 31))


def _message(rng, cls, depth=0):
    """(port message, pb2 message) with the same random fields set."""
    kw, pkw = {}, {}
    groups = set()
    for f in cls.FIELDS:
        if rng.random() < 0.3 or (f.kind == "msg" and depth > 2) or f.oneof in groups:
            continue
        if f.oneof:
            groups.add(f.oneof)             # at most one member of a oneof
        if f.repeated:
            vals = [_value(rng, f, depth) for _ in range(int(rng.integers(4)))]
            kw[f.name] = [v[0] if f.kind == "msg" else v for v in vals]
            pkw[f.name] = [v[1] if f.kind == "msg" else v for v in vals]
        else:
            v = _value(rng, f, depth)
            kw[f.name], pkw[f.name] = (v if f.kind == "msg" else (v, v))
    return cls(**kw), PB2[cls.__name__](**pkw)


@pytest.mark.parametrize("name", MESSAGES)
def test_codec_matches_pb2_byte_for_byte(name):
    cls = getattr(codec, name)
    rng = np.random.default_rng(sum(name.encode()))
    for _ in range(40):
        mine, ref = _message(rng, cls)
        want = ref.SerializeToString()
        assert mine.encode() == want
        assert cls.decode(want) == mine
        assert type(ref).FromString(mine.encode()) == ref
    empty = cls()
    assert empty.encode() == PB2[name]().SerializeToString() == b""
    assert cls.decode(b"") == empty


def test_codec_oneof_zero_and_empty_messages_are_sent():
    """A oneof member at zero (Compare.mod_revision = 0, the create CAS)
    and an empty submessage (a progress request) are present on the wire."""
    cases = [
        (codec.Compare(target=codec.Compare.MOD, key=b"k", mod_revision=0),
         rpc_pb2.Compare(target=rpc_pb2.Compare.MOD, key=b"k", mod_revision=0)),
        (codec.WatchRequest(progress_request=codec.WatchProgressRequest()),
         rpc_pb2.WatchRequest(progress_request=rpc_pb2.WatchProgressRequest())),
        (codec.RequestOp(request_range=codec.RangeRequest()),
         rpc_pb2.RequestOp(request_range=rpc_pb2.RangeRequest())),
        (codec.Event(kv=codec.KeyValue(), prev_kv=codec.KeyValue()),
         mvcc_pb2.Event(kv=mvcc_pb2.KeyValue(), prev_kv=mvcc_pb2.KeyValue())),
    ]
    for mine, ref in cases:
        assert mine.encode() == ref.SerializeToString() != b""
        assert type(mine).decode(ref.SerializeToString()) == mine


def test_codec_64mib_class_value():
    value = np.random.default_rng(7).integers(0, 256, (64 << 20) - 4096, np.uint8).tobytes()
    mine = codec.PutRequest(key=b"/registry/big", value=value, lease=3)
    ref = rpc_pb2.PutRequest(key=b"/registry/big", value=value, lease=3)
    data = ref.SerializeToString()
    assert mine.encode() == data
    assert codec.PutRequest.decode(data) == mine


def test_codec_skips_unknown_fields_and_rejects_truncation():
    # RequestOp.request_txn (4) is not in the port's subset: skipped.
    op = rpc_pb2.RequestOp()
    op.request_txn.compare.add(key=b"k")
    assert codec.RequestOp.decode(op.SerializeToString()) == codec.RequestOp()
    # Unknown fields of every wire type inside a KeyValue.
    extra = bytes([0x38, 0x96, 0x01, 0x41]) + bytes(8) + bytes([0x4A, 2, 1, 2, 0x55]) + bytes(4)
    kv = mvcc_pb2.KeyValue(key=b"a", value=b"b", mod_revision=9).SerializeToString() + extra
    assert codec.KeyValue.decode(kv) == codec.KeyValue(key=b"a", value=b"b", mod_revision=9)
    assert codec._kv_tuple(kv, 0, len(kv)) == (b"a", b"b", 0, 9, 0, 0)
    with pytest.raises(codec.DecodeError):
        codec.KeyValue.decode(kv[:2])
    # Unpacked repeated varints decode like packed ones.
    assert codec.BindFrameResponse.decode(bytes([0x08, 5, 0x08, 7])).revisions == [5, 7]


@pytest.mark.parametrize("seed", range(4))
def test_light_parsers_agree_with_the_full_decode(seed):
    rng = np.random.default_rng(seed)
    kvs = [mvcc_pb2.KeyValue(
        key=rng.integers(0, 256, int(rng.integers(0, 40)), np.uint8).tobytes(),
        value=rng.integers(0, 256, int(rng.choice([0, 5, 200, 300])), np.uint8).tobytes(),
        create_revision=int(rng.integers(1 << 40)), mod_revision=int(rng.integers(1 << 40)),
        version=int(rng.integers(5)), lease=int(rng.integers(2)) * 7) for _ in range(300)]
    resp = rpc_pb2.RangeResponse(header=rpc_pb2.ResponseHeader(revision=77, raft_term=3),
                                 kvs=kvs, more=bool(seed % 2), count=301).SerializeToString()
    full = codec.RangeResponse.decode(resp)
    items = [(kv.key, kv.value) for kv in full.kvs]
    assert codec.parse_range(resp, keys=True, values=True) == (
        77, bool(seed % 2), 301, items, items[-1][0])
    assert codec.parse_range(resp, keys=True, values=False)[3] == [k for k, _ in items]
    assert codec.parse_range(resp, keys=False, values=True)[3] == [v for _, v in items]
    events = [mvcc_pb2.Event(type=i % 2, kv=kvs[i], prev_kv=kvs[i - 1] if i % 3 else None)
              for i in range(1, 50)]
    wr = rpc_pb2.WatchResponse(header=rpc_pb2.ResponseHeader(revision=5), watch_id=-1,
                               created=True, compact_revision=4, cancel_reason="r",
                               events=events).SerializeToString()
    b = codec.parse_watch_response(wr)
    w = codec.WatchResponse.decode(wr)
    assert (b.revision, b.watch_id, b.created, b.canceled, b.compact_revision,
            b.cancel_reason) == (5, -1, True, False, 4, "r")

    def tup(kv):
        return (kv.key, kv.value, kv.create_revision, kv.mod_revision, kv.version, kv.lease)

    assert b.events == [(e.type, tup(e.kv), tup(e.prev_kv) if e.prev_kv is not None else None)
                        for e in w.events]
    assert codec.count_watch_events(wr) == 49


# ---- HPACK (RFC 7541 Appendix C) -----------------------------------------------


def _hex(s: str) -> bytes:
    return bytes.fromhex("".join(s.split()))


_REQ = [[(b":method", b"GET"), (b":scheme", b"http"), (b":path", b"/"),
         (b":authority", b"www.example.com")],
        [(b":method", b"GET"), (b":scheme", b"http"), (b":path", b"/"),
         (b":authority", b"www.example.com"), (b"cache-control", b"no-cache")],
        [(b":method", b"GET"), (b":scheme", b"https"), (b":path", b"/index.html"),
         (b":authority", b"www.example.com"), (b"custom-key", b"custom-value")]]
_LOC = (b"location", b"https://www.example.com")
_RESP = [[(b":status", b"302"), (b"cache-control", b"private"),
          (b"date", b"Mon, 21 Oct 2013 20:13:21 GMT"), _LOC],
         [(b":status", b"307"), (b"cache-control", b"private"),
          (b"date", b"Mon, 21 Oct 2013 20:13:21 GMT"), _LOC],
         [(b":status", b"200"), (b"cache-control", b"private"),
          (b"date", b"Mon, 21 Oct 2013 20:13:22 GMT"), _LOC,
          (b"content-encoding", b"gzip"),
          (b"set-cookie", b"foo=ASDJKHQKBZXOQWEOPIUAXQWEOIU; max-age=3600; version=1")]]
# (table size limit, [(block, headers, table size after)]) per appendix section.
RFC7541_C = {
    "C.2.1": (4096, [("400a 6375 7374 6f6d 2d6b 6579 0d63 7573 746f 6d2d 6865 6164 6572",
                      [(b"custom-key", b"custom-header")], 55)]),
    "C.2.2": (4096, [("040c 2f73 616d 706c 652f 7061 7468", [(b":path", b"/sample/path")], 0)]),
    "C.2.3": (4096, [("1008 7061 7373 776f 7264 0673 6563 7265 74",
                      [(b"password", b"secret")], 0)]),
    "C.2.4": (4096, [("82", [(b":method", b"GET")], 0)]),
    "C.3": (4096, [
        ("8286 8441 0f77 7777 2e65 7861 6d70 6c65 2e63 6f6d", _REQ[0], 57),
        ("8286 84be 5808 6e6f 2d63 6163 6865", _REQ[1], 110),
        ("8287 85bf 400a 6375 7374 6f6d 2d6b 6579 0c63 7573 746f 6d2d 7661 6c75 65",
         _REQ[2], 164)]),
    "C.4": (4096, [
        ("8286 8441 8cf1 e3c2 e5f2 3a6b a0ab 90f4 ff", _REQ[0], 57),
        ("8286 84be 5886 a8eb 1064 9cbf", _REQ[1], 110),
        ("8287 85bf 4088 25a8 49e9 5ba9 7d7f 8925 a849 e95b b8e8 b4bf", _REQ[2], 164)]),
    "C.5": (256, [
        ("4803 3330 3258 0770 7269 7661 7465 611d 4d6f 6e2c 2032 3120 4f63 7420 3230 3133"
         " 2032 303a 3133 3a32 3120 474d 546e 1768 7474 7073 3a2f 2f77 7777 2e65 7861 6d70"
         " 6c65 2e63 6f6d", _RESP[0], 222),
        ("4803 3330 37c1 c0bf", _RESP[1], 222),
        ("88c1 611d 4d6f 6e2c 2032 3120 4f63 7420 3230 3133 2032 303a 3133 3a32 3220 474d"
         " 54c0 5a04 677a 6970 7738 666f 6f3d 4153 444a 4b48 514b 425a 584f 5157 454f 5049"
         " 5541 5851 5745 4f49 553b 206d 6178 2d61 6765 3d33 3630 303b 2076 6572 7369 6f6e"
         " 3d31", _RESP[2], 215)]),
    "C.6": (256, [
        ("4882 6402 5885 aec3 771a 4b61 96d0 7abe 9410 54d4 44a8 2005 9504 0b81 66e0 82a6"
         " 2d1b ff6e 919d 29ad 1718 63c7 8f0b 97c8 e9ae 82ae 43d3", _RESP[0], 222),
        ("4883 640e ffc1 c0bf", _RESP[1], 222),
        ("88c1 6196 d07a be94 1054 d444 a820 0595 040b 8166 e084 a62d 1bff c05a 839b d9ab"
         " 77ad 94e7 821d d7f2 e6c7 b335 dfdf cd5b 3960 d5af 2708 7f36 72c1 ab27 0fb5 291f"
         " 9587 3160 65c0 03ed 4ee5 b106 3d50 07", _RESP[2], 215)]),
}


@pytest.mark.parametrize("section", sorted(RFC7541_C))
def test_hpack_rfc7541_appendix_c(section):
    limit, blocks = RFC7541_C[section]
    dec = HpackDecoder(limit)
    for block, headers, size in blocks:
        assert dec.decode(_hex(block)) == headers
        assert dec.size == size
    if section == "C.5":
        # 222 + 54 > 256 evicted the oldest entries: the table of C.5.3.
        assert list(dec.table) == [_RESP[2][5], _RESP[2][4], _RESP[2][2]]


def test_hpack_size_update_encoder_and_bad_input():
    dec = HpackDecoder()
    dec.decode(_hex("400a 6375 7374 6f6d 2d6b 6579 0d63 7573 746f 6d2d 6865 6164 6572"))
    dec.decode(bytes([0x20]))                          # size update to 0 empties the table
    assert dec.size == 0 and not dec.table
    with pytest.raises(H2Error):
        dec.decode(bytes([0x3F, 0xE2, 0x1F]))         # 4097: past the SETTINGS limit
    with pytest.raises(H2Error):
        dec.decode(bytes([0xBE]))                     # dynamic index into an empty table
    headers = [(b":path", b"/etcdserverpb.KV/Range"), (b"x" * 200, b"y" * 300)]
    assert HpackDecoder().decode(encode_headers(headers)) == headers
    assert huffman_decode(_hex("f1e3 c2e5 f23a 6ba0 ab90 f4ff")) == b"www.example.com"
    for bad in (_hex("f1e3 c2e5 f23a 6ba0 ab90 f4ff ff"), _hex("00")):
        with pytest.raises(H2Error):
            huffman_decode(bad)                       # padding of 8+ bits, or not all ones


# ---- the transport against both servers ----------------------------------------

RANGE = "/etcdserverpb.KV/Range"
PUT_FRAME = "/k8s1m.BatchKV/PutFrame"


def _put_frame(items) -> bytes:
    from k8s1m_tpu_torch.store.native import pack_put_frame

    return codec.PutFrameRequest(frame=pack_put_frame(items), count=len(items)).encode()


def test_windows_both_ways(server):
    """A client whose windows (65,535 bytes) are far below one response,
    and a request far above the server's starting windows: the client tops
    its receive windows up and waits on the server's."""
    ch = Channel(f"127.0.0.1:{server.port}", window=65535)
    try:
        items = [(b"/registry/w/%05d" % i, bytes([i % 251]) * 1000) for i in range(8192)]
        rev = codec.PutFrameResponse.decode(ch.unary(PUT_FRAME, _put_frame(items))).revision
        assert rev > 8192
        req = codec.RangeRequest(key=b"/registry/w/", range_end=prefix_end(b"/registry/w/"))
        for _ in range(2):
            resp = ch.unary(RANGE, req.encode())
            assert len(resp) > 8 << 20
            _rev, more, count, got, _last = codec.parse_range(resp, keys=True, values=True)
            assert got == items and count == 8192 and not more
        conn = ch.connection()
        assert conn._conn_unacked < 65535
    finally:
        ch.close()


def test_errors_cap_and_reset(server):
    ch = Channel(f"127.0.0.1:{server.port}", max_receive=1 << 20)
    try:
        # Trailers-only error responses.
        with pytest.raises(WireError) as ei:
            ch.unary("/etcdserverpb.Maintenance/Hash", b"")
        assert ei.value.code == StatusCode.UNIMPLEMENTED
        with pytest.raises(WireError) as ei:
            ch.unary(RANGE, codec.RangeRequest(key=b"/a", revision=10**9).encode())
        assert ei.value.code == StatusCode.OUT_OF_RANGE and "future" in ei.value.details
        # A response over the receive cap fails that call only.
        ch.unary(PUT_FRAME, _put_frame([(b"/big", b"v" * (2 << 20))]))
        with pytest.raises(WireError) as ei:
            ch.unary(RANGE, codec.RangeRequest(key=b"/big").encode())
        assert ei.value.code == StatusCode.RESOURCE_EXHAUSTED
        conn = ch.connection()
        resp = codec.RangeResponse.decode(
            ch.unary(RANGE, codec.RangeRequest(key=b"/big", keys_only=True).encode()))
        assert [kv.key for kv in resp.kvs] == [b"/big"] and ch.connection() is conn
        # A watch stream reset by the client ends as CANCELLED, once.
        closed = []
        s = ch.stream("/etcdserverpb.Watch/Watch", lambda m: None,
                      lambda code, d: closed.append(code))
        s.send(codec.WatchRequest(create_request=codec.WatchCreateRequest(key=b"/w")).encode())
        s.cancel()
        s.cancel()
        assert s.done.wait(10) and closed == [StatusCode.CANCELLED]
        assert ch.unary(RANGE, codec.RangeRequest(key=b"/none").encode()) is not None
    finally:
        ch.close()
    with pytest.raises(WireError) as ei:
        ch.unary(RANGE, b"")
    assert ei.value.code == StatusCode.CANCELLED


def test_dead_server_is_unavailable():
    srv = NativeServer()
    port = srv.port
    srv.close()
    ch = Channel(f"127.0.0.1:{port}")
    with pytest.raises(WireError) as ei:
        ch.unary(RANGE, b"")
    assert ei.value.code == StatusCode.UNAVAILABLE
    ch.close()


# ---- the port imports no gRPC, protobuf or JAX ---------------------------------

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
for name in ("grpc", "google.protobuf", "jax", "k8s1m_tpu"):
    sys.modules[name] = None
import k8s1m_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(k8s1m_tpu_torch.__path__, "k8s1m_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
sys.path.insert(0, ".")
import chip_smoke
print(" ".join(mods))
print(len(mods))
"""


def test_port_imports_no_grpc_protobuf_or_jax():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    assert int(out.stdout.split()[-1]) > 60
    mods = set(out.stdout.split("\n")[-3].split())
    assert {f"k8s1m_tpu_torch.store.{m}" for m in ("wire_server", "etcd_server",
                                                   "wiretier")} <= mods
    assert {"k8s1m_tpu_torch.store.watch_cache", "k8s1m_tpu_torch.cluster.certs",
            "k8s1m_tpu_torch.tools.steady_drill"} <= mods
    assert {f"k8s1m_tpu_torch.{m}" for m in (
        "cluster.harness", "cluster.up", "cluster.kubelet_sim", "obs.logship",
        "obs.dashboard", "obs.metrics", "tools.fidelity_ab")} <= mods


_SERVE_BLOCKED = r"""
import asyncio, sys
for name in ("grpc", "google.protobuf", "jax", "k8s1m_tpu"):
    sys.modules[name] = None
from k8s1m_tpu_torch.store import etcd_server
from k8s1m_tpu_torch.store.etcd_client import EtcdClient
from k8s1m_tpu_torch.store.native import MemStore

async def main():
    store = MemStore()
    server, port = await etcd_server.serve(store, port=0)
    client = EtcdClient(f"127.0.0.1:{port}")
    try:
        await client.put(b"/registry/a", b"v")
        resp = await client.prefix(b"/registry/")
        print([(kv.key, kv.value) for kv in resp.kvs], resp.header.revision)
    finally:
        await client.close()
        await server.stop()
        await asyncio.get_running_loop().shutdown_default_executor()
        store.close()

asyncio.run(main())
"""


def test_blocked_child_serves_one_range():
    """With grpc, protobuf, JAX and the JAX package blocked, the port's
    asyncio server starts in a child and answers one Range."""
    out = subprocess.run([sys.executable, "-c", _SERVE_BLOCKED], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split("\n")[0] == "[(b'/registry/a', b'v')] 2"


_TIER_BLOCKED = r"""
import asyncio, sys, tempfile
for name in ("grpc", "google.protobuf", "jax", "k8s1m_tpu", "cryptography"):
    sys.modules[name] = None
from k8s1m_tpu_torch.cluster.certs import provision
from k8s1m_tpu_torch.store import etcd_server
from k8s1m_tpu_torch.store.etcd_client import EtcdClient
from k8s1m_tpu_torch.store.native import MemStore
from k8s1m_tpu_torch.store.watch_cache import serve_watch_cache

async def main():
    certs = provision(tempfile.mkdtemp())
    store = MemStore()
    server, port = await etcd_server.serve(store, port=0)
    tier = await serve_watch_cache(f"127.0.0.1:{port}", [b"/registry/"], port=0,
                                   tls=certs, auth_token="t")
    client = EtcdClient(f"127.0.0.1:{tier.port}", ca_pem=certs.ca_pem, token="t")
    try:
        await client.put(b"/registry/a", b"v")
        resp = await client.prefix(b"/registry/")
        print([(kv.key, kv.value) for kv in resp.kvs], resp.header.revision)
    finally:
        await client.close()
        await tier.close()
        await server.stop()
        await asyncio.get_running_loop().shutdown_default_executor()
        store.close()

asyncio.run(main())
"""


def test_blocked_child_serves_the_secured_tier():
    """With grpc, protobuf, JAX, the JAX package and ``cryptography``
    blocked (the card's machine has no ``cryptography``), the port's tier
    serves TLS with a bearer token from an ``openssl``-made chain in a
    child, and a put and a read-your-write list go through it."""
    out = subprocess.run([sys.executable, "-c", _TIER_BLOCKED], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split("\n")[0] == "[(b'/registry/a', b'v')] 2"
