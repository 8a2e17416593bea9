"""Async etcd v3 client over the port's own gRPC transport.

The port's copy of ``k8s1m_tpu/store/etcd_client.py``: the same coroutine
surface for the load tools (``tools/``) and tests, on ``store/wire.py``
(HTTP/2 and gRPC in the standard library) and ``store/proto/codec.py``
where the JAX client runs on ``grpc.aio`` and the generated protobuf
modules.  It works against any etcd v3 server: the wire format is the
public one (the ``put_batch``/``bind_batch`` frames are the private
``k8s1m.BatchKV`` extension of this repository's servers).

Every unary call is ``Channel.unary_async``: the request goes out from the
loop, and the connection's reader thread resolves the call's future, so
one event loop keeps every worker's request in flight at once.  Each
``EtcdClient`` owns its ``Channel``, hence its own connection, which is
what spreads the tools' ``--clients`` over separate HTTP/2 connections.
Results are the codec's messages, with the attribute names of the
generated ones (``resp.header.revision``, ``resp.kvs[0].value``); a call
that ends with a gRPC status other than OK raises ``WireError`` (``.code``,
``.details``).
"""

from __future__ import annotations

import asyncio
import dataclasses

from k8s1m_tpu_torch.store.native import pack_bind_frame, pack_put_frame, prefix_end
from k8s1m_tpu_torch.store.proto import codec as pb
from k8s1m_tpu_torch.store.wire import Channel, StatusCode, WireError

_M = "/etcdserverpb"
_RANGE = f"{_M}.KV/Range"
_PUT = f"{_M}.KV/Put"
_DELETE = f"{_M}.KV/DeleteRange"
_TXN = f"{_M}.KV/Txn"
_COMPACT = f"{_M}.KV/Compact"
_LEASE_GRANT = f"{_M}.Lease/LeaseGrant"
_LEASE_REVOKE = f"{_M}.Lease/LeaseRevoke"
_STATUS = f"{_M}.Maintenance/Status"
_WATCH = f"{_M}.Watch/Watch"
_PUT_FRAME = "/k8s1m.BatchKV/PutFrame"
_BIND_FRAME = "/k8s1m.BatchKV/BindFrame"


@dataclasses.dataclass
class WatchBatch:
    events: list          # list[codec.Event]
    revision: int         # header revision of the response
    compact_revision: int = 0
    created: bool = False
    canceled: bool = False
    cancel_reason: str = ""


def secure_channel_for(target: str, ca_pem: str, token: str | None = None) -> Channel:
    """A TLS channel trusting only ``ca_pem`` (ALPN h2), with
    ``authorization: Bearer <token>`` on every call when ``token`` is set:
    the client half of the tier's apiserver-style TLS and bearer auth."""
    return Channel(target, ca_pem=ca_pem, token=token)


def _revision(resp) -> int:
    return resp.header.revision if resp.header is not None else 0


class EtcdClient:
    def __init__(self, target: str, channel: Channel | None = None, *,
                 ca_pem: str | None = None, token: str | None = None):
        if channel is None:
            channel = (secure_channel_for(target, ca_pem, token) if ca_pem is not None
                       else Channel(target, token=token))
        self.channel = channel

    async def close(self) -> None:
        self.channel.close()

    async def _call(self, path: str, req, resp_cls):
        return resp_cls.decode(await self.channel.unary_async(path, req.encode()))

    # The raw calls, request message in and response message out (the JAX
    # client's multicallables): every public call goes through one, and the
    # watch-cache tier forwards its clients' requests upstream with them.
    async def _range(self, req: pb.RangeRequest) -> pb.RangeResponse:
        return await self._call(_RANGE, req, pb.RangeResponse)

    async def _put(self, req: pb.PutRequest) -> pb.PutResponse:
        return await self._call(_PUT, req, pb.PutResponse)

    async def _delete(self, req: pb.DeleteRangeRequest) -> pb.DeleteRangeResponse:
        return await self._call(_DELETE, req, pb.DeleteRangeResponse)

    async def _txn(self, req: pb.TxnRequest) -> pb.TxnResponse:
        return await self._call(_TXN, req, pb.TxnResponse)

    async def _compact(self, req: pb.CompactionRequest) -> pb.CompactionResponse:
        return await self._call(_COMPACT, req, pb.CompactionResponse)

    async def _lease_grant(self, req: pb.LeaseGrantRequest) -> pb.LeaseGrantResponse:
        return await self._call(_LEASE_GRANT, req, pb.LeaseGrantResponse)

    async def _lease_revoke(self, req: pb.LeaseRevokeRequest) -> pb.LeaseRevokeResponse:
        return await self._call(_LEASE_REVOKE, req, pb.LeaseRevokeResponse)

    async def _status(self, req: pb.StatusRequest) -> pb.StatusResponse:
        return await self._call(_STATUS, req, pb.StatusResponse)

    async def _put_frame(self, req: pb.PutFrameRequest) -> pb.PutFrameResponse:
        return await self._call(_PUT_FRAME, req, pb.PutFrameResponse)

    async def _bind_frame(self, req: pb.BindFrameRequest) -> pb.BindFrameResponse:
        return await self._call(_BIND_FRAME, req, pb.BindFrameResponse)

    # ---- KV ------------------------------------------------------------

    async def put(self, key: bytes, value: bytes, lease: int = 0) -> int:
        resp = await self._put(pb.PutRequest(key=key, value=value, lease=lease))
        return _revision(resp)

    async def get(self, key: bytes):
        resp = await self._range(pb.RangeRequest(key=key))
        return resp.kvs[0] if resp.kvs else None

    async def range(self, key: bytes, range_end: bytes = b"", *, limit: int = 0,
                    revision: int = 0, count_only: bool = False,
                    keys_only: bool = False) -> pb.RangeResponse:
        return await self._range(pb.RangeRequest(
            key=key, range_end=range_end, limit=limit, revision=revision,
            count_only=count_only, keys_only=keys_only))

    async def prefix(self, prefix: bytes, **kwargs) -> pb.RangeResponse:
        return await self.range(prefix, prefix_end(prefix), **kwargs)

    async def delete(self, key: bytes, range_end: bytes = b"") -> int:
        resp = await self._delete(pb.DeleteRangeRequest(key=key, range_end=range_end))
        return resp.deleted

    async def txn_cas(self, key: bytes, value: bytes | None, *,
                      required_mod: int | None = None, required_version: int | None = None,
                      lease: int = 0, want_current_on_failure: bool = True) -> pb.TxnResponse:
        """The Kubernetes Txn shape: compare mod/version, put-or-delete."""
        if (required_mod is None) == (required_version is None):
            raise ValueError("exactly one of required_mod/required_version")
        if required_mod is not None:
            cmp = pb.Compare(result=pb.Compare.EQUAL, target=pb.Compare.MOD, key=key,
                             mod_revision=required_mod)
        else:
            cmp = pb.Compare(result=pb.Compare.EQUAL, target=pb.Compare.VERSION, key=key,
                             version=required_version)
        if value is None:
            op = pb.RequestOp(request_delete_range=pb.DeleteRangeRequest(key=key))
        else:
            op = pb.RequestOp(request_put=pb.PutRequest(key=key, value=value, lease=lease))
        req = pb.TxnRequest(compare=[cmp], success=[op])
        if want_current_on_failure:
            req.failure.append(pb.RequestOp(request_range=pb.RangeRequest(key=key)))
        return await self._txn(req)

    async def put_batch(self, items: list[tuple[bytes, bytes | None]], lease: int = 0) -> int:
        """A write wave in one RPC over the private BatchKV extension (this
        repository's servers only); value None deletes.  Returns the store
        revision after the wave."""
        resp = await self._put_frame(pb.PutFrameRequest(
            frame=pack_put_frame(items), count=len(items), lease=lease))
        return resp.revision

    async def bind_batch(self, binds: list[tuple[bytes, int, bytes]]) -> list[int]:
        """Bind wave (key, required_mod, node_name) -> per-record revision,
        or -1 (CAS conflict) / -5 (not spliceable).  BatchKV extension."""
        resp = await self._bind_frame(pb.BindFrameRequest(
            frame=pack_bind_frame(binds), count=len(binds)))
        return list(resp.revisions)

    async def compact(self, revision: int) -> None:
        await self._compact(pb.CompactionRequest(revision=revision))

    # ---- Lease / Maintenance ------------------------------------------

    async def lease_grant(self, ttl: int) -> int:
        resp = await self._lease_grant(pb.LeaseGrantRequest(TTL=ttl))
        return resp.ID

    async def lease_revoke(self, lease_id: int) -> None:
        await self._lease_revoke(pb.LeaseRevokeRequest(ID=lease_id))

    async def status(self) -> pb.StatusResponse:
        return await self._status(pb.StatusRequest())

    # ---- Watch ---------------------------------------------------------

    def watch(self, key: bytes, range_end: bytes = b"", *, start_revision: int = 0,
              prev_kv: bool = False) -> "WatchSession":
        return WatchSession(self, key, range_end, start_revision, prev_kv)


class WatchSession:
    """One watch on its own bidirectional stream (``async with``).

    The connection's reader thread hands every response, and the stream's
    end, to an ``asyncio.Queue`` on the session's loop.  ``next(timeout)``
    waits on that queue: a wait that times out takes nothing from it, so a
    quiet watch stays open and its next event still arrives (the JAX client
    parks its stream read on a shielded task for the same reason)."""

    def __init__(self, client: EtcdClient, key, range_end, start_revision, prev_kv):
        self._client = client
        self._req = pb.WatchRequest(create_request=pb.WatchCreateRequest(
            key=key, range_end=range_end, start_revision=start_revision, prev_kv=prev_kv))
        self._stream = None
        self._queue: asyncio.Queue | None = None
        self._ended: WireError | None = None
        self.watch_id = None
        self.compact_revision = 0
        self.canceled = False

    async def __aenter__(self):
        loop = asyncio.get_running_loop()
        queue: asyncio.Queue = asyncio.Queue()

        def hand(item) -> None:
            try:
                loop.call_soon_threadsafe(queue.put_nowait, item)
            except RuntimeError:
                pass        # the loop is closed: nobody reads the watch any more

        def on_close(code, details) -> None:
            hand(WireError(code, details or "watch stream ended"))

        self._queue = queue
        self._stream = await self._client.channel.stream_async(_WATCH, hand, on_close)
        try:
            self._stream.send(self._req.encode())
            first = await self._read(None)
        except BaseException:
            await self.cancel()         # __aexit__ does not run when __aenter__ raises
            raise
        self.watch_id = first.watch_id
        self.compact_revision = first.compact_revision
        self.canceled = first.canceled
        return self

    async def __aexit__(self, *exc):
        await self.cancel()

    async def cancel(self) -> None:
        stream, self._stream = self._stream, None
        if stream is None:
            return
        try:
            stream.send(pb.WatchRequest(cancel_request=pb.WatchCancelRequest(
                watch_id=self.watch_id or 0)).encode(), end_stream=True)
        except WireError:
            pass            # the stream already ended: the reset below is a no-op
        stream.cancel()

    def _live(self):
        if self._stream is None:
            raise RuntimeError("watch session is closed")
        return self._stream

    async def request_progress(self) -> None:
        self._live().send(pb.WatchRequest(progress_request=pb.WatchProgressRequest()).encode())

    async def _read(self, timeout: float | None) -> pb.WatchResponse:
        if self._ended is not None:
            raise self._ended
        self._live()
        item = await asyncio.wait_for(self._queue.get(), timeout)
        if isinstance(item, WireError):
            self._ended = (item if item.code != StatusCode.OK
                           else WireError(StatusCode.CANCELLED, item.details))
            raise self._ended
        return pb.WatchResponse.decode(item)

    async def next(self, timeout: float | None = None) -> WatchBatch:
        resp = await self._read(timeout)
        return WatchBatch(
            events=list(resp.events), revision=_revision(resp),
            compact_revision=resp.compact_revision, created=resp.created,
            canceled=resp.canceled, cancel_reason=resp.cancel_reason)
