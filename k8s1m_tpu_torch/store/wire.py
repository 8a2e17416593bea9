"""gRPC over HTTP/2, client side, in the standard library only.

The port speaks the etcd v3 wire where no ``grpcio`` is installed, so this
module carries what ``grpc.insecure_channel``/``grpc.secure_channel`` give
the JAX package's ``store/remote.py``:

- **HTTP/2** (RFC 9113): the connection preface and SETTINGS (a large
  ``INITIAL_WINDOW_SIZE``, ``MAX_FRAME_SIZE`` of 16 MiB, push disabled), the
  peer's SETTINGS applied and acknowledged, PING answered, ``GOAWAY`` and
  ``RST_STREAM`` honoured.  One reader thread per connection demultiplexes
  frames to streams.
- **Flow control both ways**: a sender blocks on the peer's stream and
  connection windows (``WINDOW_UPDATE`` and a changed initial window wake
  it); the receive windows of the connection and of each stream are
  topped up as the reader consumes DATA.
- **HPACK** (RFC 7541): requests go out as literals without indexing or
  Huffman coding; the decoder is complete (static table, dynamic table
  with size updates, Huffman code from ``hpack_tables.py``).
- **gRPC framing**: ``POST`` with ``content-type: application/grpc`` and
  ``te: trailers``, the 5-byte length prefix, a 64 MiB receive cap, the
  status from the trailers or from a trailers-only response, and errors as
  one ``WireError(code, details)`` with gRPC's status numbers.
- **Calls**: unary, blocking (``unary``) or awaited on an asyncio loop
  (``unary_async``: the reader thread resolves the call's future through
  ``loop.call_soon_threadsafe``, so one loop keeps any number of calls in
  flight with no thread per call), and bidirectional streams (each its own
  HTTP/2 stream on the shared connection; ``cancel`` sends
  ``RST_STREAM(CANCEL)``).
- **TLS** through ``ssl`` (a context trusting ``ca_pem``, ALPN ``h2``) and
  ``authorization: Bearer <token>`` on every call.

``Channel(target)`` is the entry point: it opens a connection at first
use and a new one once the old is dead or going away, as a gRPC channel
reconnects.  A connection is safe to share between threads.
"""

from __future__ import annotations

import asyncio
import collections
import enum
import logging
import socket
import ssl
import threading
import urllib.parse

from k8s1m_tpu_torch.store.hpack_tables import HUFFMAN, STATIC_TABLE

PREFACE = b"PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n"
# Frame types and flags (RFC 9113 §6).
DATA, HEADERS, PRIORITY, RST_STREAM, SETTINGS, PUSH_PROMISE, PING, GOAWAY, \
    WINDOW_UPDATE, CONTINUATION = range(10)
END_STREAM = ACK = 0x1
END_HEADERS = 0x4
PADDED = 0x8
PRIORITY_FLAG = 0x20
# SETTINGS identifiers.
S_HEADER_TABLE_SIZE, S_ENABLE_PUSH, S_MAX_CONCURRENT_STREAMS, \
    S_INITIAL_WINDOW_SIZE, S_MAX_FRAME_SIZE = 1, 2, 3, 4, 5
DEFAULT_WINDOW = 1 << 24         # receive window we grant per stream and connection
MAX_FRAME = (1 << 24) - 1        # the largest frame we accept
MAX_RECEIVE = 64 << 20           # gRPC receive cap (remote.py's, the servers')
CONNECT_TIMEOUT_S = 10.0
CANCEL_CODE = 0x8

log = logging.getLogger("k8s1m.wire")


class StatusCode(enum.IntEnum):
    """gRPC status codes (grpc/doc/statuscodes.md)."""

    OK = 0
    CANCELLED = 1
    UNKNOWN = 2
    INVALID_ARGUMENT = 3
    DEADLINE_EXCEEDED = 4
    NOT_FOUND = 5
    ALREADY_EXISTS = 6
    PERMISSION_DENIED = 7
    RESOURCE_EXHAUSTED = 8
    FAILED_PRECONDITION = 9
    ABORTED = 10
    OUT_OF_RANGE = 11
    UNIMPLEMENTED = 12
    INTERNAL = 13
    UNAVAILABLE = 14
    DATA_LOSS = 15
    UNAUTHENTICATED = 16


# HTTP status of a response without grpc-status (gRPC's http-grpc-status
# mapping) and RST_STREAM error codes, as gRPC statuses.
_HTTP_STATUS = {b"400": StatusCode.INTERNAL, b"401": StatusCode.UNAUTHENTICATED,
                b"403": StatusCode.PERMISSION_DENIED, b"404": StatusCode.UNIMPLEMENTED,
                b"429": StatusCode.UNAVAILABLE, b"502": StatusCode.UNAVAILABLE,
                b"503": StatusCode.UNAVAILABLE, b"504": StatusCode.UNAVAILABLE}
_RST_STATUS = {0x7: StatusCode.UNAVAILABLE, 0x8: StatusCode.CANCELLED,
               0xB: StatusCode.RESOURCE_EXHAUSTED, 0xC: StatusCode.PERMISSION_DENIED}


class WireError(Exception):
    """A call that ended with a gRPC status other than OK (also a broken
    connection: ``UNAVAILABLE``)."""

    def __init__(self, code: int, details: str = ""):
        self.code = StatusCode(code)
        self.details = details
        super().__init__(f"{self.code.name}: {details}")


class H2Error(Exception):
    """The peer broke the HTTP/2 or HPACK protocol: the connection dies."""


# ---- HPACK ---------------------------------------------------------------------

_HUFF_DECODE = {(length, code): sym for sym, (code, length) in enumerate(HUFFMAN)}


def huffman_decode(data: bytes) -> bytes:
    out = bytearray()
    cur = n = 0
    get = _HUFF_DECODE.get
    for byte in data:
        for shift in range(7, -1, -1):
            cur = (cur << 1) | ((byte >> shift) & 1)
            n += 1
            sym = get((n, cur))
            if sym is not None:
                if sym == 256:
                    raise H2Error("HPACK: EOS in a Huffman string")
                out.append(sym)
                cur = n = 0
            elif n > 30:
                raise H2Error("HPACK: bad Huffman code")
    # Padding: fewer than 8 bits, all ones (a prefix of EOS).
    if n >= 8 or cur != (1 << n) - 1:
        raise H2Error("HPACK: bad Huffman padding")
    return bytes(out)


def _hpack_int(buf, pos: int, prefix: int) -> tuple[int, int]:
    mask = (1 << prefix) - 1
    if pos >= len(buf):
        raise H2Error("HPACK: truncated integer")
    v = buf[pos] & mask
    pos += 1
    if v < mask:
        return v, pos
    shift = 0
    while True:
        if pos >= len(buf) or shift > 56:
            raise H2Error("HPACK: bad integer")
        b = buf[pos]
        pos += 1
        v += (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return v, pos


def _put_hpack_int(out: bytearray, prefix: int, v: int) -> None:
    mask = (1 << prefix) - 1
    if v < mask:
        out.append(v)
        return
    out.append(mask)
    v -= mask
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)


class HpackDecoder:
    """The receiving half of one connection's HPACK context."""

    def __init__(self, max_size: int = 4096):
        self.table: collections.deque = collections.deque()   # newest first
        self.size = 0
        self.max_size = max_size
        self.settings_max = max_size

    def _evict(self) -> None:
        while self.size > self.max_size and self.table:
            name, value = self.table.pop()
            self.size -= len(name) + len(value) + 32

    def _lookup(self, idx: int) -> tuple[bytes, bytes]:
        if 1 <= idx <= len(STATIC_TABLE):
            return STATIC_TABLE[idx - 1]
        idx -= len(STATIC_TABLE) + 1
        if idx < 0 or idx >= len(self.table):
            raise H2Error(f"HPACK: index {idx} out of the table")
        return self.table[idx]

    def _string(self, buf, pos: int) -> tuple[bytes, int]:
        if pos >= len(buf):
            raise H2Error("HPACK: truncated string")
        huff = buf[pos] & 0x80
        n, pos = _hpack_int(buf, pos, 7)
        if pos + n > len(buf):
            raise H2Error("HPACK: truncated string")
        raw = bytes(buf[pos:pos + n])
        return (huffman_decode(raw) if huff else raw), pos + n

    def decode(self, block) -> list[tuple[bytes, bytes]]:
        out = []
        pos = 0
        while pos < len(block):
            b = block[pos]
            if b & 0x80:                         # indexed field
                idx, pos = _hpack_int(block, pos, 7)
                out.append(self._lookup(idx))
            elif b & 0x40 or not b & 0x20:       # literal (indexed or not)
                prefix = 6 if b & 0x40 else 4
                idx, pos = _hpack_int(block, pos, prefix)
                if idx:
                    name = self._lookup(idx)[0]
                else:
                    name, pos = self._string(block, pos)
                value, pos = self._string(block, pos)
                out.append((name, value))
                if b & 0x40:
                    self.table.appendleft((name, value))
                    self.size += len(name) + len(value) + 32
                    self._evict()
            else:                                # dynamic table size update
                size, pos = _hpack_int(block, pos, 5)
                if size > self.settings_max:
                    raise H2Error("HPACK: table size over the SETTINGS limit")
                self.max_size = size
                self._evict()
        return out


def encode_headers(headers) -> bytes:
    """Literal fields without indexing, names and values raw (no Huffman)."""
    out = bytearray()
    for name, value in headers:
        out.append(0)
        _put_hpack_int(out, 7, len(name))
        out += name
        _put_hpack_int(out, 7, len(value))
        out += value
    return bytes(out)


# ---- transports ----------------------------------------------------------------


def _frame(length: int, ftype: int, flags: int, sid: int) -> bytes:
    return (length.to_bytes(3, "big") + bytes((ftype, flags))
            + (sid & 0x7FFFFFFF).to_bytes(4, "big"))


class _Plain:
    def __init__(self, sock: socket.socket):
        self.sock = sock

    def recv(self) -> bytes:
        return self.sock.recv(1 << 20)

    def send(self, data) -> None:
        self.sock.sendall(data)


class _Tls:
    """TLS over memory BIOs: the reader thread and the senders never touch
    one ``SSLObject`` at the same time (``_obj_lock``), and TLS records
    leave in the order they were made (``_send_lock``)."""

    def __init__(self, sock: socket.socket, ctx: ssl.SSLContext, hostname: str):
        self.sock = sock
        self._in, self._out = ssl.MemoryBIO(), ssl.MemoryBIO()
        self._obj = ctx.wrap_bio(self._in, self._out, server_hostname=hostname)
        self._obj_lock = threading.Lock()
        self._send_lock = threading.Lock()
        while True:
            try:
                self._obj.do_handshake()
                break
            except ssl.SSLWantReadError:
                self._flush()
                data = sock.recv(1 << 16)
                if not data:
                    raise ConnectionError("TLS handshake: connection closed") from None
                self._in.write(data)
        self._flush()
        if self._obj.selected_alpn_protocol() != "h2":
            raise ConnectionError("TLS: the server did not negotiate ALPN h2")

    def _flush(self) -> None:
        with self._send_lock:
            with self._obj_lock:
                data = self._out.read()
            if data:
                self.sock.sendall(data)

    def recv(self) -> bytes:
        while True:
            with self._obj_lock:
                try:
                    return self._obj.read(1 << 20)
                except ssl.SSLWantReadError:
                    pending = self._out.pending
                except ssl.SSLZeroReturnError:
                    return b""
            if pending:
                self._flush()
            data = self.sock.recv(1 << 20)
            if not data:
                return b""
            with self._obj_lock:
                self._in.write(data)

    def send(self, data) -> None:
        with self._send_lock:
            with self._obj_lock:
                self._obj.write(data)
                out = self._out.read()
            self.sock.sendall(out)


# ---- streams and connections ---------------------------------------------------


class Stream:
    """One gRPC call's HTTP/2 stream.  Unary calls collect ``messages``;
    streaming calls hand each message to ``on_message`` (on the reader
    thread).  ``status``/``details`` are set once the call has ended;
    ``on_close(status, details)`` runs then, once."""

    def __init__(self, conn: "H2Connection", sid: int, send_window: int,
                 on_message=None, on_close=None):
        self.conn = conn
        self.id = sid
        self.send_window = send_window
        self.recv_unacked = 0
        self.buf = bytearray()
        self.messages: list = []
        self.on_message = on_message
        self.on_close = on_close
        self.got_headers = False
        self.status: StatusCode | None = None
        self.details = ""
        self.done = threading.Event()

    def send(self, msg: bytes, end_stream: bool = False) -> None:
        """Send one gRPC message (blocks on flow control)."""
        data = b"\x00" + len(msg).to_bytes(4, "big") + msg
        self.conn.send_data(self, data, end_stream)

    def cancel(self) -> None:
        """Reset the stream (RST_STREAM CANCEL); ends the call as CANCELLED."""
        self.conn.reset(self)


class H2Connection:
    """One HTTP/2 connection and its reader thread."""

    def __init__(self, host: str, port: int, *, ssl_context: ssl.SSLContext | None = None,
                 window: int = DEFAULT_WINDOW, max_receive: int = MAX_RECEIVE):
        sock = socket.create_connection((host, port), timeout=CONNECT_TIMEOUT_S)
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._t = (_Tls(sock, ssl_context, host) if ssl_context is not None
                       else _Plain(sock))
            sock.settimeout(None)
        except BaseException:
            sock.close()
            raise
        self._sock = sock
        self.scheme = b"https" if ssl_context is not None else b"http"
        self.authority = f"{host}:{port}".encode()
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._send_lock = threading.Lock()
        self._streams: dict[int, Stream] = {}
        self._next_id = 1
        self._max_receive = max_receive
        self._topup = max(1, window // 2)
        self._conn_unacked = 0
        self._conn_send_window = 65535
        self._peer_initial_window = 65535
        self._peer_max_frame = 16384
        self._hpack = HpackDecoder()
        self._cont: tuple | None = None          # (sid, flags, block) awaiting CONTINUATION
        self.dead: WireError | None = None
        self.going_away = False
        settings = b"".join(k.to_bytes(2, "big") + v.to_bytes(4, "big") for k, v in (
            (S_ENABLE_PUSH, 0), (S_INITIAL_WINDOW_SIZE, window),
            (S_MAX_FRAME_SIZE, MAX_FRAME)))
        hello = PREFACE + _frame(len(settings), SETTINGS, 0, 0) + settings
        if window > 65535:
            hello += _frame(4, WINDOW_UPDATE, 0, 0) + (window - 65535).to_bytes(4, "big")
        self._send(hello)
        self._reader = threading.Thread(target=self._read_loop, name="h2-reader", daemon=True)
        self._reader.start()

    @property
    def usable(self) -> bool:
        return self.dead is None and not self.going_away

    # ---- sending ---------------------------------------------------------------

    def _send(self, data) -> None:
        try:
            with self._send_lock:
                self._t.send(data)
        except OSError as e:
            err = WireError(StatusCode.UNAVAILABLE, f"send failed: {e}")
            self._die(err)
            raise err from None

    def open_stream(self, path: bytes, metadata=(), on_message=None, on_close=None) -> Stream:
        headers = [(b":method", b"POST"), (b":scheme", self.scheme), (b":path", path),
                   (b":authority", self.authority), (b"content-type", b"application/grpc"),
                   (b"te", b"trailers"), (b"user-agent", b"k8s1m-tpu-torch-wire"),
                   *metadata]
        block = encode_headers(headers)
        if len(block) > 16384:
            raise WireError(StatusCode.INTERNAL, "request headers over one frame")
        # Stream ids must reach the wire in increasing order.
        with self._send_lock:
            with self._lock:
                if self.dead is not None:
                    raise WireError(self.dead.code, self.dead.details)
                if self.going_away:
                    raise WireError(StatusCode.UNAVAILABLE, "connection is going away")
                sid = self._next_id
                self._next_id += 2
                s = Stream(self, sid, self._peer_initial_window, on_message, on_close)
                self._streams[sid] = s
            try:
                self._t.send(_frame(len(block), HEADERS, END_HEADERS, sid) + block)
            except OSError as e:
                err = WireError(StatusCode.UNAVAILABLE, f"send failed: {e}")
                self._die(err)
                raise err from None
        return s

    def send_data(self, s: Stream, data: bytes, end_stream: bool) -> None:
        mv = memoryview(data)
        n = len(data)
        off = 0
        while off < n:
            with self._cond:
                while True:
                    if self.dead is not None:
                        raise WireError(self.dead.code, self.dead.details)
                    if s.status is not None:        # ended (set under this lock)
                        raise WireError(s.status, s.details)
                    allow = min(n - off, self._conn_send_window, s.send_window)
                    if allow > 0:
                        break
                    self._cond.wait()
                self._conn_send_window -= allow
                s.send_window -= allow
                max_frame = self._peer_max_frame
            stop = off + allow
            parts = []
            while off < stop:
                m = min(stop - off, max_frame)
                flags = END_STREAM if end_stream and off + m == n else 0
                parts.append(_frame(m, DATA, flags, s.id))
                parts.append(mv[off:off + m])
                off += m
            self._send(b"".join(parts))

    def reset(self, s: Stream, code: int = StatusCode.CANCELLED,
              details: str = "cancelled by the client") -> None:
        """RST_STREAM(CANCEL) to the server; the call ends with ``code``."""
        if s.done.is_set():
            return
        try:
            self._send(_frame(4, RST_STREAM, 0, s.id) + CANCEL_CODE.to_bytes(4, "big"))
        except WireError:
            pass                    # the connection is gone: the stream ends below anyway
        self._finish(s, code, details)

    def unary(self, path: bytes, request: bytes, metadata=()) -> bytes:
        """One request, one response (no deadline, as the JAX client's
        calls): the call ends when the server answers or the connection
        dies."""
        s = self.open_stream(path, metadata)
        try:
            s.send(request, end_stream=True)
        except WireError:
            if s.status is None:
                raise
            # The server answered (an error) before the request was sent.
        s.done.wait()
        return _unary_result(s)

    async def unary_async(self, path: bytes, request: bytes, metadata=()) -> bytes:
        """``unary`` awaited on the running event loop: the loop is free
        while the server answers, and the reader thread wakes the caller
        through ``call_soon_threadsafe``.  Cancelling the caller resets the
        stream."""
        loop = asyncio.get_running_loop()
        done = loop.create_future()

        def wake() -> None:
            if not done.done():
                done.set_result(None)

        def on_close(_code, _details) -> None:
            try:
                loop.call_soon_threadsafe(wake)
            except RuntimeError:
                pass        # the loop is closed: no caller waits any more

        s = self.open_stream(path, metadata, on_close=on_close)
        try:
            s.send(request, end_stream=True)
        except WireError:
            if s.status is None:
                raise
        try:
            await done
        except asyncio.CancelledError:
            s.cancel()
            raise
        return _unary_result(s)

    # ---- receiving -------------------------------------------------------------

    def _read_loop(self) -> None:
        buf = bytearray()
        try:
            while True:
                chunk = self._t.recv()
                if not chunk:
                    raise ConnectionError("connection closed by the peer")
                buf += chunk
                off = 0
                avail = len(buf)
                while avail - off >= 9:
                    flen = int.from_bytes(buf[off:off + 3], "big")
                    if flen > MAX_FRAME:
                        raise H2Error(f"frame of {flen} bytes over our MAX_FRAME_SIZE")
                    if avail - off < 9 + flen:
                        break
                    ftype, flags = buf[off + 3], buf[off + 4]
                    sid = int.from_bytes(buf[off + 5:off + 9], "big") & 0x7FFFFFFF
                    payload = bytes(buf[off + 9:off + 9 + flen])
                    off += 9 + flen
                    self._on_frame(ftype, flags, sid, payload)
                if off:
                    del buf[:off]
        except WireError as e:
            self._die(e)
        except (OSError, H2Error, ValueError) as e:
            self._die(WireError(StatusCode.UNAVAILABLE, str(e) or type(e).__name__))
        # The reader must never die silently: a fault in a stream's callback
        # ends the connection, with its traceback in the log.
        except Exception as e:  # graftlint: disable=broad-except (reader thread boundary)
            log.exception("h2 reader: %s", e)
            self._die(WireError(StatusCode.INTERNAL, f"reader failed: {e!r}"))

    def _on_frame(self, ftype: int, flags: int, sid: int, payload: bytes) -> None:
        if self._cont is not None and (ftype != CONTINUATION or sid != self._cont[0]):
            raise H2Error("expected CONTINUATION")
        if ftype == DATA:
            self._on_data(flags, sid, payload)
        elif ftype == HEADERS:
            p = 0
            end = len(payload)
            if flags & PADDED:
                end -= payload[0]
                p = 1
            if flags & PRIORITY_FLAG:
                p += 5
            if p > end:
                raise H2Error("bad HEADERS padding")
            if flags & END_HEADERS:
                self._on_headers(sid, flags, payload[p:end])
            else:
                self._cont = (sid, flags, bytearray(payload[p:end]))
        elif ftype == CONTINUATION:
            if self._cont is None:
                raise H2Error("CONTINUATION without HEADERS")
            self._cont[2].extend(payload)
            if flags & END_HEADERS:
                csid, cflags, block = self._cont
                self._cont = None
                self._on_headers(csid, cflags, bytes(block))
        elif ftype == SETTINGS:
            if not flags & ACK:
                self._on_settings(payload)
        elif ftype == WINDOW_UPDATE:
            inc = int.from_bytes(payload[:4], "big") & 0x7FFFFFFF
            with self._cond:
                if sid == 0:
                    self._conn_send_window += inc
                elif sid in self._streams:
                    self._streams[sid].send_window += inc
                self._cond.notify_all()
        elif ftype == PING:
            if not flags & ACK:
                self._send(_frame(8, PING, ACK, 0) + payload[:8])
        elif ftype == RST_STREAM:
            code = int.from_bytes(payload[:4], "big")
            s = self._streams.get(sid)
            if s is not None:
                self._finish(s, _RST_STATUS.get(code, StatusCode.INTERNAL),
                             f"stream reset by the server (HTTP/2 error {code:#x})")
        elif ftype == GOAWAY:
            last = int.from_bytes(payload[:4], "big") & 0x7FFFFFFF
            code = int.from_bytes(payload[4:8], "big")
            with self._lock:
                self.going_away = True
                refused = [s for k, s in self._streams.items() if k > last]
            for s in refused:
                self._finish(s, StatusCode.UNAVAILABLE, f"GOAWAY (HTTP/2 error {code:#x})")
        elif ftype == PUSH_PROMISE:
            raise H2Error("PUSH_PROMISE with push disabled")
        # PRIORITY and unknown frame types are ignored.

    def _on_settings(self, payload: bytes) -> None:
        with self._cond:
            for off in range(0, len(payload) - 5, 6):
                ident = int.from_bytes(payload[off:off + 2], "big")
                value = int.from_bytes(payload[off + 2:off + 6], "big")
                if ident == S_INITIAL_WINDOW_SIZE:
                    delta = value - self._peer_initial_window
                    self._peer_initial_window = value
                    for s in self._streams.values():
                        s.send_window += delta
                elif ident == S_MAX_FRAME_SIZE and 16384 <= value <= MAX_FRAME:
                    self._peer_max_frame = value
            self._cond.notify_all()
        # HEADER_TABLE_SIZE bounds the encoder's table, which never indexes.
        self._send(_frame(0, SETTINGS, ACK, 0))

    def _on_data(self, flags: int, sid: int, payload: bytes) -> None:
        flen = len(payload)
        if flags & PADDED:
            payload = payload[1:flen - payload[0]]
        self._conn_unacked += flen
        updates = b""
        if self._conn_unacked >= self._topup:
            updates += _frame(4, WINDOW_UPDATE, 0, 0) + self._conn_unacked.to_bytes(4, "big")
            self._conn_unacked = 0
        s = self._streams.get(sid)
        if s is not None:
            s.recv_unacked += flen
            if not flags & END_STREAM and s.recv_unacked >= self._topup:
                updates += _frame(4, WINDOW_UPDATE, 0, sid) + s.recv_unacked.to_bytes(4, "big")
                s.recv_unacked = 0
        if updates:
            self._send(updates)
        if s is None:
            return
        if payload:
            self._take_messages(s, payload)
        if flags & END_STREAM and not s.done.is_set():
            self._finish(s, StatusCode.INTERNAL, "stream ended without trailers")

    def _take_messages(self, s: Stream, data: bytes) -> None:
        if s.buf:
            s.buf += data
            data = s.buf
        pos = 0
        end = len(data)
        msgs = []
        while end - pos >= 5:
            if data[pos] & 1:
                self.reset(s, StatusCode.INTERNAL, "compressed message not supported")
                return
            n = int.from_bytes(data[pos + 1:pos + 5], "big")
            if n > self._max_receive:
                self.reset(s, StatusCode.RESOURCE_EXHAUSTED,
                           f"received message larger than max ({n} vs. {self._max_receive})")
                return
            if end - pos - 5 < n:
                break
            msgs.append(bytes(data[pos + 5:pos + 5 + n]))
            pos += 5 + n
        s.buf = bytearray(data[pos:]) if pos < end else bytearray()
        for m in msgs:
            if s.on_message is not None:
                s.on_message(m)
            else:
                s.messages.append(m)

    def _on_headers(self, sid: int, flags: int, block: bytes) -> None:
        headers = self._hpack.decode(block)      # always, to keep the table in step
        s = self._streams.get(sid)
        if s is None:
            return
        if not s.got_headers:
            s.got_headers = True
            if not flags & END_STREAM:
                status = dict(headers).get(b":status")
                if status is not None and status != b"200":
                    self.reset(s, _HTTP_STATUS.get(status, StatusCode.UNKNOWN),
                               f"HTTP status {status.decode()}")
                return
        if flags & END_STREAM:
            self._finish(s, *_grpc_status(headers))

    def _finish(self, s: Stream, code: int, details: str) -> None:
        with self._cond:
            if s.status is not None:
                return
            s.status = StatusCode(code)
            s.details = details
            self._streams.pop(s.id, None)
            self._cond.notify_all()
        if s.on_close is not None:
            s.on_close(s.status, details)
        s.done.set()

    def _die(self, err: WireError) -> None:
        with self._cond:
            if self.dead is not None:
                return
            self.dead = err
            streams = list(self._streams.values())
            self._cond.notify_all()
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        for s in streams:
            self._finish(s, err.code, err.details)

    def close(self) -> None:
        self._die(WireError(StatusCode.UNAVAILABLE, "connection closed by the client"))
        if threading.current_thread() is not self._reader:
            self._reader.join(timeout=10)
        self._sock.close()


def _unary_result(s: Stream) -> bytes:
    if s.status != StatusCode.OK:
        raise WireError(s.status, s.details)
    if len(s.messages) != 1:
        raise WireError(StatusCode.INTERNAL, f"unary response held {len(s.messages)} messages")
    return s.messages[0]


def _grpc_status(headers) -> tuple[StatusCode, str]:
    d = dict(headers)
    gs = d.get(b"grpc-status")
    if gs is None:
        http = d.get(b":status", b"200")
        if http != b"200":
            return _HTTP_STATUS.get(http, StatusCode.UNKNOWN), f"HTTP status {http.decode()}"
        return StatusCode.UNKNOWN, "response without grpc-status"
    try:
        code = StatusCode(int(gs))
    except ValueError:
        code = StatusCode.UNKNOWN
    return code, urllib.parse.unquote(d.get(b"grpc-message", b"").decode("latin-1"))


def _split_target(target: str) -> tuple[str, int]:
    host, _, port = target.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"target {target!r} is not host:port")
    return host.strip("[]"), int(port)


class Channel:
    """A gRPC channel to ``target`` (``host:port``): one shared connection,
    opened at first use and again once it is dead or going away.  With
    ``ca_pem`` it speaks TLS trusting that CA only; ``token`` rides every
    call as ``authorization: Bearer <token>``."""

    def __init__(self, target: str, *, ca_pem: str | None = None, token: str | None = None,
                 window: int = DEFAULT_WINDOW, max_receive: int = MAX_RECEIVE):
        self.target = target
        self._host, self._port = _split_target(target)
        self._ssl = None
        if ca_pem is not None:
            self._ssl = ssl.create_default_context(cafile=ca_pem)
            self._ssl.set_alpn_protocols(["h2"])
        self.metadata = ((b"authorization", b"Bearer " + token.encode()),) if token else ()
        self._window = window
        self._max_receive = max_receive
        self._lock = threading.Lock()
        self._conn: H2Connection | None = None
        self._closed = False

    def connection(self) -> H2Connection:
        with self._lock:
            if self._closed:
                raise WireError(StatusCode.CANCELLED, "channel closed")
            c = self._conn
            if c is None or not c.usable:
                if c is not None:
                    c.close()
                self._conn = None
                try:
                    c = H2Connection(self._host, self._port, ssl_context=self._ssl,
                                     window=self._window, max_receive=self._max_receive)
                except (OSError, ConnectionError, ssl.SSLError) as e:
                    raise WireError(StatusCode.UNAVAILABLE,
                                    f"connect to {self.target}: {e}") from None
                self._conn = c
            return c

    async def connection_async(self) -> H2Connection:
        """``connection()`` for a coroutine: a new connection (its connect
        and TLS handshake) is made on a worker thread, so the loop goes on
        running meanwhile, a server on the same loop included."""
        c = self._conn
        if c is not None and c.usable and not self._closed:
            return c
        return await asyncio.to_thread(self.connection)

    def unary(self, path: str, request: bytes) -> bytes:
        return self.connection().unary(path.encode(), request, self.metadata)

    async def unary_async(self, path: str, request: bytes) -> bytes:
        conn = await self.connection_async()
        return await conn.unary_async(path.encode(), request, self.metadata)

    def stream(self, path: str, on_message, on_close) -> Stream:
        return self.connection().open_stream(path.encode(), self.metadata, on_message,
                                             on_close)

    async def stream_async(self, path: str, on_message, on_close) -> Stream:
        conn = await self.connection_async()
        return conn.open_stream(path.encode(), self.metadata, on_message, on_close)

    def close(self) -> None:
        with self._lock:
            self._closed = True
            c, self._conn = self._conn, None
        if c is not None:
            c.close()
