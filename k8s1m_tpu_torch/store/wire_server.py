"""gRPC over HTTP/2, server side, on asyncio and the standard library only.

The server half of ``store/wire.py``: what ``grpc.aio.server`` gives the JAX
package's ``store/etcd_server.py``, for a machine with no ``grpcio``.  It
reuses the client's HPACK decoder and encoder, its frame header and its
``StatusCode``.

- **HTTP/2** (RFC 9113): the client preface, our SETTINGS
  (``MAX_CONCURRENT_STREAMS``, a 16 MiB ``INITIAL_WINDOW_SIZE`` and
  ``MAX_FRAME_SIZE``) and the ACK of the peer's, PING answered, GOAWAY on
  ``stop()`` and on a protocol error, HEADERS with CONTINUATION (padding
  and priority skipped), RST_STREAM from the client cancelling the
  handler, a stream over the concurrency limit refused.
- **Flow control both ways**: a response never exceeds the peer's
  connection and stream windows (its WINDOW_UPDATEs and a changed initial
  window wake the writer) nor its ``MAX_FRAME_SIZE`` (16 KB DATA frames
  unless it raises it), and waits while the transport's buffer is full;
  every batch of DATA read is answered with WINDOW_UPDATEs for the
  connection and each open stream.
- **gRPC**: dispatch on ``:path`` to the handlers registered by service and
  method name; the 5-byte message prefix; the receive and send caps;
  ``grpc-timeout``; response headers with identity encoding, then the
  trailers with ``grpc-status`` and a percent-encoded ``grpc-message`` (or a
  trailers-only response when nothing was sent); unary-unary,
  unary-stream and stream-stream handlers; ``context.abort(code,
  details)``.

- **TLS** (what ``grpc.ssl_server_credentials`` gives the JAX watch-cache
  tier): ``add_secure_port`` serves a port through ``ssl`` with a context
  from ``server_ssl_context`` (the PEM pair, ALPN ``h2``); a plaintext
  client or one that does not trust the chain fails its handshake.
- **Bearer auth** (the JAX tier's ``_BearerAuth`` interceptor):
  ``Server(bearer_token=...)`` compares every call's ``authorization``
  header with ``Bearer <token>`` (``hmac.compare_digest``); a call without
  it never reaches its handler and ends trailers-only with
  ``UNAUTHENTICATED``, unary and streaming alike.

``Server`` mirrors the ``grpc.aio.Server`` calls the JAX servers make:
``add_generic_rpc_handlers`` takes ``(service, {method: handler})`` pairs,
``add_insecure_port``/``add_secure_port`` bind (port 0 picks a free one) and
return the port, then ``start()``, ``stop()`` and
``wait_for_termination()``.  Every coroutine runs on the loop that called
``start()``.
"""

from __future__ import annotations

import asyncio
import contextlib
import hmac
import logging
import socket
import ssl

from k8s1m_tpu_torch.store.wire import (
    ACK,
    CONTINUATION,
    DATA,
    END_HEADERS,
    END_STREAM,
    GOAWAY,
    HEADERS,
    MAX_FRAME,
    PADDED,
    PING,
    PREFACE,
    PRIORITY_FLAG,
    PUSH_PROMISE,
    RST_STREAM,
    S_INITIAL_WINDOW_SIZE,
    S_MAX_CONCURRENT_STREAMS,
    S_MAX_FRAME_SIZE,
    SETTINGS,
    WINDOW_UPDATE,
    H2Error,
    HpackDecoder,
    StatusCode,
    _frame,
    encode_headers,
)

log = logging.getLogger("k8s1m.wire_server")

# The JAX ``etcd_server.serve``'s grpc.aio options: the reference's HTTP/2
# tuning (main.rs:145-147).
MAX_CONCURRENT_STREAMS = 100
MAX_MESSAGE = 64 << 20           # receive and send caps
RECV_WINDOW = 1 << 24            # the window we grant per stream and for the connection
# HTTP/2 error codes (RFC 9113 §7).
NO_ERROR, PROTOCOL_ERROR, FLOW_CONTROL_ERROR, FRAME_SIZE_ERROR, REFUSED_STREAM = \
    0x0, 0x1, 0x3, 0x6, 0x7
_DEFAULT_MAX_FRAME = 16384
_TIMEOUT_UNITS = {b"H": 3600.0, b"M": 60.0, b"S": 1.0, b"m": 1e-3, b"u": 1e-6, b"n": 1e-9}


class RpcMethodHandler:
    """One method: its coroutine (or async generator, for a streamed
    response), the request decoder and the response encoder."""

    __slots__ = ("fn", "request_streaming", "response_streaming", "request_deserializer",
                 "response_serializer")

    def __init__(self, fn, request_streaming, response_streaming, request_deserializer,
                 response_serializer):
        self.fn = fn
        self.request_streaming = request_streaming
        self.response_streaming = response_streaming
        self.request_deserializer = request_deserializer
        self.response_serializer = response_serializer


def unary_unary_rpc_method_handler(fn, request_deserializer, response_serializer):
    return RpcMethodHandler(fn, False, False, request_deserializer, response_serializer)


def unary_stream_rpc_method_handler(fn, request_deserializer, response_serializer):
    return RpcMethodHandler(fn, False, True, request_deserializer, response_serializer)


def stream_stream_rpc_method_handler(fn, request_deserializer, response_serializer):
    return RpcMethodHandler(fn, True, True, request_deserializer, response_serializer)


class AbortError(Exception):
    """Raised by ``ServicerContext.abort``: ends the call with its status."""

    def __init__(self, code: StatusCode, details: str):
        super().__init__(f"{StatusCode(code).name}: {details}")
        self.code = StatusCode(code)
        self.details = details


class ServicerContext:
    """The handler's view of its call: ``abort`` ends it with a status."""

    async def abort(self, code, details: str = "") -> None:
        raise AbortError(code, details)


UNAUTHENTICATED_DETAILS = "invalid or missing bearer token"


def server_ssl_context(cert_pem: str, key_pem: str) -> ssl.SSLContext:
    """A TLS server context from the PEM pair, offering ALPN ``h2`` only."""
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(cert_pem, key_pem)
    ctx.set_alpn_protocols(["h2"])
    return ctx


def _percent_encode(details: str) -> bytes:
    """``grpc-message``: bytes outside 0x20-0x7E, and ``%``, as ``%XX``."""
    return b"".join(bytes((b,)) if 0x20 <= b <= 0x7E and b != 0x25 else b"%%%02X" % b
                    for b in details.encode("utf-8"))


def _parse_timeout(value: bytes) -> float | None:
    unit = _TIMEOUT_UNITS.get(value[-1:])
    if unit is None or not value[:-1].isdigit():
        return None
    return int(value[:-1]) * unit


class _Stream:
    __slots__ = ("id", "headers", "send_window", "recv_unacked", "buf", "inbox", "remote_done",
                 "headers_sent", "local_done", "reset", "error", "task", "deadline")

    def __init__(self, sid: int, headers: list, send_window: int):
        self.id = sid
        self.headers = headers
        self.send_window = send_window
        self.recv_unacked = 0
        self.buf = bytearray()
        self.inbox: asyncio.Queue = asyncio.Queue()    # raw messages, None at END_STREAM
        self.remote_done = False
        self.headers_sent = False
        self.local_done = False
        self.reset = False          # RST_STREAM received (or the connection died)
        self.error: tuple | None = None   # (code, details) the call ends with when cancelled
        self.task: asyncio.Task | None = None
        self.deadline: asyncio.TimerHandle | None = None


class _Connection(asyncio.Protocol):
    """One client connection: the frame reader (``data_received``) and the
    writers (one handler task per stream)."""

    def __init__(self, server: "Server"):
        self.server = server
        self.transport: asyncio.Transport | None = None
        self._buf = bytearray()
        self._preface_seen = False
        self._streams: dict[int, _Stream] = {}
        self._last_id = 0
        self._hpack = HpackDecoder()
        self._cont: tuple | None = None            # (sid, flags, block) awaiting CONTINUATION
        self._send_window = 65535
        self._peer_initial_window = 65535
        self._peer_max_frame = _DEFAULT_MAX_FRAME
        self._conn_unacked = 0
        self._waiters: list[asyncio.Future] = []  # writers blocked on a window
        self._drain: asyncio.Future | None = None  # set while the transport is paused
        self._closed = False

    # ---- asyncio.Protocol ------------------------------------------------------

    def connection_made(self, transport) -> None:
        self.transport = transport
        sock = transport.get_extra_info("socket")
        if sock is not None:
            with contextlib.suppress(OSError):
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        settings = b"".join(k.to_bytes(2, "big") + v.to_bytes(4, "big") for k, v in (
            (S_MAX_CONCURRENT_STREAMS, MAX_CONCURRENT_STREAMS),
            (S_INITIAL_WINDOW_SIZE, RECV_WINDOW), (S_MAX_FRAME_SIZE, MAX_FRAME)))
        transport.write(_frame(len(settings), SETTINGS, 0, 0) + settings
                        + _frame(4, WINDOW_UPDATE, 0, 0)
                        + (RECV_WINDOW - 65535).to_bytes(4, "big"))
        self.server._connections.add(self)

    def connection_lost(self, exc) -> None:
        self._closed = True
        self.server._connections.discard(self)
        for st in list(self._streams.values()):
            self._cancel(st, reset=True)
        self._streams.clear()
        self._wake()
        if self._drain is not None and not self._drain.done():
            self._drain.set_result(None)

    def pause_writing(self) -> None:
        if self._drain is None or self._drain.done():
            self._drain = asyncio.get_running_loop().create_future()

    def resume_writing(self) -> None:
        if self._drain is not None and not self._drain.done():
            self._drain.set_result(None)

    def data_received(self, data: bytes) -> None:
        self._buf += data
        buf = self._buf
        off = 0
        try:
            if not self._preface_seen:
                if len(buf) < len(PREFACE):
                    if not PREFACE.startswith(bytes(buf)):
                        raise H2Error("bad connection preface")
                    return
                if bytes(buf[:len(PREFACE)]) != PREFACE:
                    raise H2Error("bad connection preface")
                self._preface_seen = True
                off = len(PREFACE)
            end = len(buf)
            while end - off >= 9:
                flen = int.from_bytes(buf[off:off + 3], "big")
                if flen > MAX_FRAME:
                    raise H2Error(f"frame of {flen} bytes over our MAX_FRAME_SIZE",
                                  FRAME_SIZE_ERROR)
                if end - off < 9 + flen:
                    break
                ftype, flags = buf[off + 3], buf[off + 4]
                sid = int.from_bytes(buf[off + 5:off + 9], "big") & 0x7FFFFFFF
                payload = bytes(buf[off + 9:off + 9 + flen])
                off += 9 + flen
                self._on_frame(ftype, flags, sid, payload)
                if self._closed:
                    return
        except H2Error as e:
            self._fail(e.args[1] if len(e.args) > 1 else PROTOCOL_ERROR, str(e.args[0]))
            return
        finally:
            if off:
                del buf[:off]
        self._flush_window_updates()

    # ---- frames in ---------------------------------------------------------------

    def _on_frame(self, ftype: int, flags: int, sid: int, payload: bytes) -> None:
        if self._cont is not None and (ftype != CONTINUATION or sid != self._cont[0]):
            raise H2Error("expected CONTINUATION")
        if ftype == DATA:
            self._on_data(flags, sid, payload)
        elif ftype == HEADERS:
            if sid == 0 or not sid & 1:
                raise H2Error("HEADERS on a stream id the client may not open")
            p, end = 0, len(payload)
            if flags & PADDED:
                if not payload:
                    raise H2Error("bad HEADERS padding")
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
            if sid != 0:
                raise H2Error("SETTINGS on a stream")
            if not flags & ACK:
                self._on_settings(payload)
        elif ftype == WINDOW_UPDATE:
            if len(payload) != 4:
                raise H2Error("WINDOW_UPDATE of the wrong size", FRAME_SIZE_ERROR)
            inc = int.from_bytes(payload, "big") & 0x7FFFFFFF
            if sid == 0:
                self._send_window += inc
            else:
                st = self._streams.get(sid)
                if st is not None:
                    st.send_window += inc
            self._wake()
        elif ftype == PING:
            if len(payload) != 8:
                raise H2Error("PING of the wrong size", FRAME_SIZE_ERROR)
            if not flags & ACK:
                self._write(_frame(8, PING, ACK, 0) + payload)
        elif ftype == RST_STREAM:
            st = self._streams.pop(sid, None)
            if st is not None:
                self._cancel(st, reset=True)
        elif ftype == GOAWAY:
            pass            # the client closes its side; calls in flight finish
        elif ftype == PUSH_PROMISE:
            raise H2Error("PUSH_PROMISE from a client")
        # PRIORITY and unknown frame types are ignored.

    def _on_settings(self, payload: bytes) -> None:
        if len(payload) % 6:
            raise H2Error("SETTINGS of the wrong size", FRAME_SIZE_ERROR)
        for off in range(0, len(payload), 6):
            ident = int.from_bytes(payload[off:off + 2], "big")
            value = int.from_bytes(payload[off + 2:off + 6], "big")
            if ident == S_INITIAL_WINDOW_SIZE:
                if value > 0x7FFFFFFF:
                    raise H2Error("INITIAL_WINDOW_SIZE over 2^31-1", FLOW_CONTROL_ERROR)
                delta = value - self._peer_initial_window
                self._peer_initial_window = value
                for st in self._streams.values():
                    st.send_window += delta
            elif ident == S_MAX_FRAME_SIZE:
                if not _DEFAULT_MAX_FRAME <= value <= MAX_FRAME:
                    raise H2Error("MAX_FRAME_SIZE out of range")
                self._peer_max_frame = value
            # HEADER_TABLE_SIZE bounds the encoder's table, which never indexes.
        self._write(_frame(0, SETTINGS, ACK, 0))
        self._wake()

    def _on_data(self, flags: int, sid: int, payload: bytes) -> None:
        flen = len(payload)
        if flags & PADDED:
            if not payload or payload[0] >= flen:
                raise H2Error("bad DATA padding")
            payload = payload[1:flen - payload[0]]
        self._conn_unacked += flen
        st = self._streams.get(sid)
        if st is None or st.remote_done:
            return          # a stream reset or ended: its bytes still count for the connection
        if not flags & END_STREAM:
            st.recv_unacked += flen
        if payload and st.error is None:     # an aborted call's later bytes are dropped
            self._take_messages(st, payload)
        if flags & END_STREAM and not st.remote_done:
            st.remote_done = True
            if st.buf and st.error is None:
                self._abort_stream(st, StatusCode.INTERNAL, "stream ended mid-message")
            st.inbox.put_nowait(None)

    def _take_messages(self, st: _Stream, data: bytes) -> None:
        """Queue every whole message of ``st.buf`` + ``data``; the partial
        tail stays in ``st.buf``, which only grows at its end and shrinks at
        its front, so reassembling a message from k frames is linear in its
        bytes, not in k times them."""
        buf = st.buf
        if buf:
            buf += data
            data = buf
        pos, end = 0, len(data)
        while end - pos >= 5:
            if data[pos] & 1:
                self._abort_stream(st, StatusCode.UNIMPLEMENTED,
                                   "compressed messages are not supported (identity only)")
                return
            n = int.from_bytes(data[pos + 1:pos + 5], "big")
            if n > MAX_MESSAGE:
                self._abort_stream(st, StatusCode.RESOURCE_EXHAUSTED,
                                   f"Received message larger than max ({n} vs. {MAX_MESSAGE})")
                return
            if end - pos - 5 < n:
                break
            st.inbox.put_nowait(bytes(data[pos + 5:pos + 5 + n]))
            pos += 5 + n
        if data is buf:
            del buf[:pos]
        else:
            buf += data[pos:]

    def _on_headers(self, sid: int, flags: int, block: bytes) -> None:
        headers = self._hpack.decode(block)          # always, to keep the table in step
        st = self._streams.get(sid)
        if st is not None:                           # trailers from the client
            if flags & END_STREAM and not st.remote_done:
                st.remote_done = True
                st.inbox.put_nowait(None)
            return
        if sid <= self._last_id:
            return          # a stream already closed (reset, or answered)
        self._last_id = sid
        if len(self._streams) >= MAX_CONCURRENT_STREAMS:
            self._write(_frame(4, RST_STREAM, 0, sid) + REFUSED_STREAM.to_bytes(4, "big"))
            return
        st = _Stream(sid, headers, self._peer_initial_window)
        self._streams[sid] = st
        if flags & END_STREAM:
            st.remote_done = True
            st.inbox.put_nowait(None)
        h = dict(headers)
        path = h.get(b":path", b"").decode("latin-1")
        handler = self.server._handlers.get(path)
        if h.get(b":method") != b"POST" or not h.get(b"content-type", b"").startswith(
                b"application/grpc"):
            st.error = (StatusCode.INTERNAL, "not a gRPC request")
            handler = None
        elif handler is None:
            st.error = (StatusCode.UNIMPLEMENTED, "Method not found!")
        elif self.server._bearer is not None and not hmac.compare_digest(
                h.get(b"authorization", b""), self.server._bearer):
            st.error = (StatusCode.UNAUTHENTICATED, UNAUTHENTICATED_DETAILS)
            handler = None
        timeout = h.get(b"grpc-timeout")
        st.task = asyncio.get_running_loop().create_task(self._run(st, handler))
        self.server._tasks.add(st.task)
        st.task.add_done_callback(self.server._tasks.discard)
        if timeout is not None:
            seconds = _parse_timeout(timeout)
            if seconds is not None:
                st.deadline = asyncio.get_running_loop().call_later(
                    seconds, self._abort_stream, st, StatusCode.DEADLINE_EXCEEDED,
                    "Deadline Exceeded")

    # ---- streams -----------------------------------------------------------------

    def _abort_stream(self, st: _Stream, code: StatusCode, details: str) -> None:
        """End the call with ``code`` (its handler is cancelled; the
        trailers go out from its task)."""
        if st.error is None and not st.local_done:
            st.error = (code, details)
            if st.task is not None:
                st.task.cancel()

    def _cancel(self, st: _Stream, *, reset: bool) -> None:
        st.reset = st.reset or reset
        if st.deadline is not None:
            st.deadline.cancel()
        if st.task is not None and not st.task.done():
            st.task.cancel()

    async def _requests(self, st: _Stream, decode):
        while True:
            raw = await st.inbox.get()
            if raw is None:
                return
            yield decode(raw)

    async def _one_request(self, st: _Stream):
        raw = await st.inbox.get()
        if raw is None:
            raise AbortError(StatusCode.INTERNAL, "unary call without a request message")
        if await st.inbox.get() is not None:
            raise AbortError(StatusCode.INTERNAL, "unary call with more than one request")
        return raw

    async def _run(self, st: _Stream, handler: RpcMethodHandler | None) -> None:
        code, details = StatusCode.OK, ""
        try:
            if handler is None:
                code, details = st.error
            else:
                ctx = ServicerContext()
                if handler.request_streaming:
                    req = self._requests(st, handler.request_deserializer)
                else:
                    raw = await self._one_request(st)
                    try:
                        req = handler.request_deserializer(raw)
                    except ValueError as e:
                        raise AbortError(StatusCode.INTERNAL,
                                         f"Exception deserializing request: {e}") from None
                if handler.response_streaming:
                    gen = handler.fn(req, ctx)
                    try:
                        async for resp in gen:
                            await self._send_message(st, handler.response_serializer(resp))
                    finally:
                        await gen.aclose()
                else:
                    resp = await handler.fn(req, ctx)
                    await self._send_message(st, handler.response_serializer(resp))
        except AbortError as e:
            code, details = e.code, e.details
        except asyncio.CancelledError:
            if st.error is None:
                raise           # a client reset, a lost connection or the server stopping
            code, details = st.error
        except Exception as e:  # graftlint: disable=broad-except (a failing handler ends its call, not the server)
            log.exception("handler for %s failed", dict(st.headers).get(b":path"))
            code, details = StatusCode.UNKNOWN, f"Unexpected {type(e)}: {e}"
        if st.reset or self._closed:
            return
        try:
            await self._send_trailers(st, code, details)
        except asyncio.CancelledError:
            if not (st.reset or self._closed):
                raise

    async def _wait_window(self, st: _Stream) -> None:
        while (self._send_window <= 0 or st.send_window <= 0) and not (st.reset or self._closed):
            fut = asyncio.get_running_loop().create_future()
            self._waiters.append(fut)
            await fut

    def _wake(self) -> None:
        waiters, self._waiters = self._waiters, []
        for fut in waiters:
            if not fut.done():
                fut.set_result(None)

    async def _send_message(self, st: _Stream, msg) -> None:
        n = len(msg)
        if n > MAX_MESSAGE:
            raise AbortError(StatusCode.RESOURCE_EXHAUSTED,
                             f"Sent message larger than max ({n} vs. {MAX_MESSAGE})")
        if not st.headers_sent:
            st.headers_sent = True
            self._write_headers(st.id, ((b":status", b"200"),
                                        (b"content-type", b"application/grpc"),
                                        (b"grpc-accept-encoding", b"identity")), 0)
        data = memoryview(b"\x00" + n.to_bytes(4, "big") + msg)
        off, total = 0, len(data)
        while off < total:
            await self._wait_window(st)
            if st.reset or self._closed:
                raise asyncio.CancelledError()
            allow = min(total - off, self._send_window, st.send_window)
            self._send_window -= allow
            st.send_window -= allow
            stop = off + allow
            parts = []
            while off < stop:
                m = min(stop - off, self._peer_max_frame)
                parts.append(_frame(m, DATA, 0, st.id))
                parts.append(data[off:off + m])
                off += m
            self.transport.writelines(parts)
            if self._drain is not None and not self._drain.done():
                await self._drain

    async def _send_trailers(self, st: _Stream, code: StatusCode, details: str) -> None:
        trailers = [(b"grpc-status", b"%d" % int(code))]
        if details:
            trailers.append((b"grpc-message", _percent_encode(details)))
        if not st.headers_sent:         # trailers-only
            st.headers_sent = True
            trailers = [(b":status", b"200"), (b"content-type", b"application/grpc"),
                        *trailers]
        st.local_done = True
        if st.deadline is not None:
            st.deadline.cancel()
        self._write_headers(st.id, trailers, END_STREAM)
        self._streams.pop(st.id, None)
        if not st.remote_done:
            # The call is over; the client need send no more (RFC 9113 §8.1).
            self._write(_frame(4, RST_STREAM, 0, st.id) + NO_ERROR.to_bytes(4, "big"))
        if self._drain is not None and not self._drain.done():
            await self._drain

    def _write_headers(self, sid: int, headers, flags: int) -> None:
        block = encode_headers(headers)
        step = self._peer_max_frame
        first, rest = block[:step], block[step:]
        out = [_frame(len(first), HEADERS, flags | (0 if rest else END_HEADERS), sid), first]
        while rest:
            chunk, rest = rest[:step], rest[step:]
            out += [_frame(len(chunk), CONTINUATION, 0 if rest else END_HEADERS, sid), chunk]
        self._write(b"".join(out))

    def _flush_window_updates(self) -> None:
        updates = []
        if self._conn_unacked:
            updates.append(_frame(4, WINDOW_UPDATE, 0, 0) + self._conn_unacked.to_bytes(4, "big"))
            self._conn_unacked = 0
        for st in self._streams.values():
            if st.recv_unacked and not st.remote_done:
                updates.append(_frame(4, WINDOW_UPDATE, 0, st.id)
                               + st.recv_unacked.to_bytes(4, "big"))
            st.recv_unacked = 0
        if updates:
            self._write(b"".join(updates))

    def _write(self, data: bytes) -> None:
        if not self._closed:
            self.transport.write(data)

    def _fail(self, code: int, reason: str) -> None:
        log.warning("h2 connection from %s: %s",
                    self.transport.get_extra_info("peername"), reason)
        self.goaway(code, reason.encode()[:256])
        self.transport.close()

    def goaway(self, code: int = NO_ERROR, debug: bytes = b"") -> None:
        self._write(_frame(8 + len(debug), GOAWAY, 0, 0) + self._last_id.to_bytes(4, "big")
                    + code.to_bytes(4, "big") + debug)

    def abort(self) -> None:
        self._closed = True
        self.transport.abort()


class Server:
    """An asyncio gRPC server (see the module doc)."""

    def __init__(self, bearer_token: str | None = None):
        self._handlers: dict[str, RpcMethodHandler] = {}
        self._bearer = None if bearer_token is None else b"Bearer " + bearer_token.encode()
        self._socks: list[tuple[socket.socket, ssl.SSLContext | None]] = []
        self._servers: list = []
        self._connections: set[_Connection] = set()
        self._tasks: set[asyncio.Task] = set()
        self._stopped: asyncio.Event | None = None

    def add_generic_rpc_handlers(self, services) -> None:
        """``services``: ``(service_name, {method: RpcMethodHandler})`` pairs;
        each method is served at ``/<service_name>/<method>``."""
        for name, handlers in services:
            for method, h in handlers.items():
                self._handlers[f"/{name}/{method}"] = h

    def add_insecure_port(self, address: str) -> int:
        """Bind ``host:port`` now (port 0 picks a free one); returns the
        port, or 0 if the address cannot be bound, as grpcio does."""
        return self._bind(address, None)

    def add_secure_port(self, address: str, ssl_context: ssl.SSLContext) -> int:
        """``add_insecure_port`` for a port served through TLS with
        ``ssl_context`` (``server_ssl_context``)."""
        return self._bind(address, ssl_context)

    def _bind(self, address: str, ssl_context: ssl.SSLContext | None) -> int:
        host, _, port = address.rpartition(":")
        host = host.strip("[]") or "0.0.0.0"
        try:
            infos = socket.getaddrinfo(host, int(port), type=socket.SOCK_STREAM,
                                       flags=socket.AI_PASSIVE)
            family, stype, proto, _canon, addr = infos[0]
            sock = socket.socket(family, stype, proto)
        except (OSError, ValueError):
            return 0
        try:
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            sock.bind(addr)
            sock.listen(1024)
            sock.setblocking(False)
        except OSError:
            sock.close()
            return 0
        self._socks.append((sock, ssl_context))
        return sock.getsockname()[1]

    async def start(self) -> None:
        loop = asyncio.get_running_loop()
        self._stopped = asyncio.Event()
        for sock, ctx in self._socks:
            self._servers.append(await loop.create_server(lambda: _Connection(self), sock=sock,
                                                          ssl=ctx))

    async def wait_for_termination(self) -> None:
        """Return once ``stop()`` has run."""
        await self._stopped.wait()

    async def stop(self) -> None:
        """Stop listening, send GOAWAY on every connection, cancel the calls
        in flight and close the connections (``grpc.aio``'s ``stop(None)``)."""
        for srv in self._servers:
            srv.close()
        for conn in list(self._connections):
            conn.goaway()
        tasks = [t for t in self._tasks if not t.done()]
        for t in tasks:
            t.cancel()
        if tasks:
            await asyncio.gather(*tasks, return_exceptions=True)
        for conn in list(self._connections):
            conn.abort()
        for srv in self._servers:
            await srv.wait_closed()
        self._servers.clear()
        self._socks.clear()
        if self._stopped is not None:
            self._stopped.set()
