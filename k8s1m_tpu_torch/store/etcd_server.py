"""etcd v3 gRPC wire layer over the native memstore, on asyncio (the port's
copy of ``k8s1m_tpu/store/etcd_server.py``).

The JAX module serves through ``grpc.aio.server`` and the generated
protobuf modules; the port runs where neither ``grpcio`` nor ``protobuf``
is installed, so it serves through ``store/wire_server.py`` (HTTP/2 and
gRPC on asyncio) and speaks the hand codec ``store/proto/codec.py``.  For
every request it answers with the same message bytes, the same
``grpc-status`` and the same status message as the JAX server over the
same store state (``tests/test_torch_etcd_server.py`` holds it).

This is the serving surface of the mem_etcd equivalent: the four services
the reference registers (reference mem_etcd/src/main.rs:106-109 — KV,
Watch, Lease, Maintenance) speaking the public etcd wire protocol, backed
by the C++ store (native/memstore), plus the private ``k8s1m.BatchKV``
frames.  Service semantics mirror the reference component-for-component:

- **Txn supports exactly the one shape Kubernetes emits** — a single
  compare on MOD revision or VERSION, a single success Put-or-DeleteRange
  on the same key, an optional failure Range of the same key; anything
  else is InvalidArgument (reference mem_etcd/src/kv_service.rs:126-337).
- **Watch**: create -> ``created:true`` response, then past-changes batch,
  then a live loop delivering events in revision order, batched up to
  1000 per response (reference watch_service.rs:119-146); CancelRequest
  and ProgressRequest are handled, with the progress revision computed as
  max(store progress revision, last delivered) to close the same race the
  reference closes (watch_service.rs:172-176); a compacted start revision
  yields a response with ``compact_revision`` set (watch_service.rs:63-75).
  Event frames are composed from a per-stream shared chunk table
  (store/wiretier.py): an event fanning to several watches on one
  stream is encoded once, and the composed bytes are byte-identical to
  the constructor path.
- **Lease is deliberately fake**: LeaseGrant returns an incrementing id
  and TTLs never expire — Kubernetes only uses etcd leases for Event TTLs
  (reference lease_service.rs:33-137, README.adoc:266-311).
- **Maintenance.Status** reports version "3.5.16" (>=3.5.13 so Kubernetes
  enables watch-progress support) and db size (reference
  maintenance_service.rs:29-117); Alarm/Defragment are stubs;
  Hash/Snapshot/MoveLeader are unimplemented, as in the reference.

The server writes a dummy key ``~`` on a fresh store so revisions start
at 1 exactly like etcd (reference main.rs:103-104).
"""

from __future__ import annotations

import asyncio
import logging
import time
import weakref

from k8s1m_tpu_torch.obs.metrics import CallbackMetric, Counter, Gauge, Histogram
from k8s1m_tpu_torch.store import wire_server, wiretier
from k8s1m_tpu_torch.store.native import (
    CompactedError,
    FutureRevError,
    KeyValue,
    MemStore,
    WatchEvent,
    Watcher,
)
from k8s1m_tpu_torch.store.proto import codec as pb
from k8s1m_tpu_torch.store.proto.codec import put_varint
from k8s1m_tpu_torch.store.wire import StatusCode

log = logging.getLogger("k8s1m.etcd")

ERR_COMPACTED = "etcdserver: mvcc: required revision has been compacted"
ERR_FUTURE_REV = "etcdserver: mvcc: required revision is a future revision"

_WATCH_BATCH = 1000          # events per WatchResponse (reference recv_many cap)
_WATCH_POLL_S = 0.005        # live-loop poll interval when idle

_REQ_COUNT = Counter(
    "memstore_requests_total", "gRPC requests by method", ("method",)
)
_REQ_LATENCY = Histogram(
    "memstore_request_seconds", "gRPC request latency by method", ("method",)
)
_STORE_GAUGE = Gauge("memstore_store", "Store-level gauges by stat", ("stat",))
_WATCH_COMPACT_CANCELS = Counter(
    "memstore_watch_compact_cancels_total",
    "watch creations canceled because start_revision predates the "
    "compaction window (client must relist, reflector-on-410)", ()
)
# Stores served with metrics enabled; the gauge aggregates over the live
# ones so a closed store neither pins memory nor clobbers stats.
_SERVED_STORES: weakref.WeakSet = weakref.WeakSet()
for _stat in ("num_keys", "db_size", "current_revision", "compact_revision"):
    _STORE_GAUGE.set_function(
        (lambda stat: lambda: sum(getattr(s, stat) for s in _SERVED_STORES))(_stat),
        stat=_stat.replace("current_", ""),
    )


# One scrape renders five callback metrics; without a snapshot each would
# re-serialize the full native stats JSON (taking the store read lock and
# inflating its own M_STATS counters five-fold).  A short TTL shares one
# snapshot across the metrics of a scrape without ever serving stale data
# to a real scrape interval (seconds).
_STATS_TTL_S = 0.25
_stats_snapshots: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _stats_of(s) -> dict:
    now = time.monotonic()
    ent = _stats_snapshots.get(s)
    if ent is not None and now - ent[0] < _STATS_TTL_S:
        return ent[1]
    st = s.stats()
    _stats_snapshots[s] = (now, st)
    return st


def _lock_samples(field: str, scale: float = 1.0):
    """Aggregate the native store's (method, structure, rw) lock cells
    across served stores (reference mem_etcd_lock_seconds/lock_count,
    metrics.rs:78-94)."""
    agg: dict[tuple, float] = {}
    for s in list(_SERVED_STORES):
        for cell in _stats_of(s).get("locks", ()):
            key = (cell["method"], cell["structure"], cell["rw"])
            agg[key] = agg.get(key, 0.0) + cell[field] * scale
    return [
        ({"method": m, "structure": st, "rw": rw}, v)
        for (m, st, rw), v in sorted(agg.items())
    ]


def _watch_samples(stat: str, agg=sum):
    vals = [
        _stats_of(s)["watch_pressure"][stat] for s in list(_SERVED_STORES)
    ]
    return [({}, agg(vals))] if vals else []


CallbackMetric(
    "memstore_lock_count_total",
    "store lock acquisitions by (method, structure, rw)",
    lambda: _lock_samples("count"), kind="counter",
)
CallbackMetric(
    "memstore_lock_wait_seconds_total",
    "time spent waiting on contended store locks",
    lambda: _lock_samples("wait_ns", 1e-9), kind="counter",
)
CallbackMetric(
    "memstore_watch_enqueued_total",
    "events enqueued to watcher queues",
    lambda: _watch_samples("enqueued"), kind="counter",
)
CallbackMetric(
    "memstore_watch_dropped_total",
    "events dropped at watcher queue caps (consumer must resync)",
    lambda: _watch_samples("dropped"), kind="counter",
)
CallbackMetric(
    "memstore_watch_queue_hwm",
    "high-water watcher queue depth",
    lambda: _watch_samples("queue_hwm", agg=max), kind="gauge",
)


def _kv_to_pb(kv: KeyValue) -> pb.KeyValue:
    return pb.KeyValue(
        key=kv.key,
        value=kv.value,
        create_revision=kv.create_revision,
        mod_revision=kv.mod_revision,
        version=kv.version,
        lease=kv.lease,
    )


def range_response_bytes(header: pb.ResponseHeader, kvs, more: bool, count: int) -> bytes:
    """``pb.RangeResponse(header=header, kvs=[_kv_to_pb(kv) for kv in kvs],
    more=more, count=count).encode()``, composed without a message per KV
    (a relist's hot loop; chip_smoke.py's phase 17c times both ways)."""
    out = bytearray(wiretier.header_bytes(header))
    body = bytearray()
    for kv in kvs:
        body.clear()
        pb.put_key_value(body, kv)
        out.append(0x12)            # RangeResponse.kvs, field 2
        put_varint(out, len(body))
        out += body
    if more:
        out += b"\x18\x01"
    if count:
        out.append(0x20)
        put_varint(out, count)
    return bytes(out)


def _encode_watch_event(ev: WatchEvent) -> bytes:
    """One native watch event as WatchResponse.events chunk bytes."""
    return wiretier.event_chunk(pb.Event(
        type=pb.Event.DELETE if ev.type == "DELETE" else pb.Event.PUT,
        kv=_kv_to_pb(ev.kv),
        prev_kv=_kv_to_pb(ev.prev_kv) if ev.prev_kv is not None else None,
    ).encode())


class EtcdService:
    """All four etcd services and BatchKV over one MemStore."""

    def __init__(self, store: MemStore):
        self.store = store
        self._lease_id = 0
        self._lease_lock = asyncio.Lock()
        self._leases: dict[int, int] = {}  # id -> granted TTL (never expires)
        if store.current_revision == 0:
            # Fresh store: revisions must start at 1 like etcd.
            store.put(b"~", b"0")

    # ---- helpers -------------------------------------------------------

    def _header(self, revision: int | None = None) -> pb.ResponseHeader:
        return pb.ResponseHeader(
            cluster_id=1,
            member_id=1,
            revision=self.store.current_revision if revision is None else revision,
            raft_term=1,
        )

    @staticmethod
    def _end_of(req_end: bytes) -> bytes | None:
        return req_end if req_end else None

    # ---- KV ------------------------------------------------------------

    async def Range(self, req: pb.RangeRequest, ctx) -> bytes:
        """The RangeResponse's bytes (``range_response_bytes``)."""
        _REQ_COUNT.inc(method="Range")
        with _REQ_LATENCY.time(method="Range"):
            try:
                res = self.store.range(
                    req.key,
                    self._end_of(req.range_end),
                    revision=req.revision,
                    limit=req.limit,
                    count_only=req.count_only,
                    keys_only=req.keys_only,
                )
            except CompactedError:
                await ctx.abort(StatusCode.OUT_OF_RANGE, ERR_COMPACTED)
            except FutureRevError:
                await ctx.abort(StatusCode.OUT_OF_RANGE, ERR_FUTURE_REV)
            return range_response_bytes(self._header(res.revision), res.kvs, res.more,
                                        res.count)

    async def Put(self, req: pb.PutRequest, ctx) -> pb.PutResponse:
        _REQ_COUNT.inc(method="Put")
        with _REQ_LATENCY.time(method="Put"):
            if req.ignore_value or req.ignore_lease:
                await ctx.abort(
                    StatusCode.INVALID_ARGUMENT,
                    "ignore_value/ignore_lease not supported",
                )
            prev = self.store.get(req.key) if req.prev_kv else None
            rev = self.store.put(req.key, req.value, lease=req.lease)
            resp = pb.PutResponse(header=self._header(rev))
            if prev is not None:
                resp.prev_kv = _kv_to_pb(prev)
            return resp

    async def DeleteRange(
        self, req: pb.DeleteRangeRequest, ctx
    ) -> pb.DeleteRangeResponse:
        _REQ_COUNT.inc(method="DeleteRange")
        with _REQ_LATENCY.time(method="DeleteRange"):
            # NB: a multi-key range delete takes one revision per key (the
            # native store's set API is single-key, like the reference's
            # store.set — reference store.rs:189-382).  etcd proper uses a
            # single revision; Kubernetes never issues multi-key deletes on
            # its hot paths, so this divergence is accepted.
            prev_kvs = []
            if req.range_end:
                victims = self.store.range(
                    req.key, req.range_end, keys_only=not req.prev_kv
                ).kvs
                keys = [kv.key for kv in victims]
                if req.prev_kv:
                    prev_kvs = victims
            else:
                keys = [req.key]
                if req.prev_kv:
                    kv = self.store.get(req.key)
                    prev_kvs = [kv] if kv else []
            deleted = 0
            rev = self.store.current_revision
            for key in keys:
                r, ok = self.store.delete(key)
                if ok:
                    deleted += 1
                    rev = r
            return pb.DeleteRangeResponse(
                header=self._header(rev),
                deleted=deleted,
                prev_kvs=[_kv_to_pb(kv) for kv in prev_kvs],
            )

    async def Txn(self, req: pb.TxnRequest, ctx) -> pb.TxnResponse:
        """The single Kubernetes Txn shape (reference kv_service.rs:126-337)."""
        _REQ_COUNT.inc(method="Txn")
        with _REQ_LATENCY.time(method="Txn"):
            if len(req.compare) != 1 or len(req.success) != 1 or len(req.failure) > 1:
                await ctx.abort(
                    StatusCode.INVALID_ARGUMENT,
                    "unsupported txn shape: want 1 compare, 1 success op, <=1 failure op",
                )
            cmp = req.compare[0]
            if cmp.result != pb.Compare.EQUAL:
                await ctx.abort(
                    StatusCode.INVALID_ARGUMENT, "only EQUAL compares supported"
                )
            key = cmp.key
            # An unset oneof member reads as None in the codec, 0 in protobuf.
            if cmp.target == pb.Compare.MOD:
                required_mod, required_version = cmp.mod_revision or 0, None
            elif cmp.target == pb.Compare.VERSION:
                required_mod, required_version = None, cmp.version or 0
            else:
                await ctx.abort(
                    StatusCode.INVALID_ARGUMENT,
                    "only MOD/VERSION compare targets supported",
                )

            op = req.success[0]
            which = op.which_oneof("request")
            if which == "request_put":
                if op.request_put.key != key:
                    await ctx.abort(
                        StatusCode.INVALID_ARGUMENT,
                        "txn success op must target the compared key",
                    )
                value, lease = op.request_put.value, op.request_put.lease
            elif which == "request_delete_range":
                if op.request_delete_range.key != key or op.request_delete_range.range_end:
                    await ctx.abort(
                        StatusCode.INVALID_ARGUMENT,
                        "txn delete must be single-key on the compared key",
                    )
                value, lease = None, 0
            else:
                await ctx.abort(
                    StatusCode.INVALID_ARGUMENT,
                    "txn success op must be Put or DeleteRange",
                )
            if req.failure:
                fail_op = req.failure[0]
                if (
                    fail_op.which_oneof("request") != "request_range"
                    or fail_op.request_range.key != key
                ):
                    await ctx.abort(
                        StatusCode.INVALID_ARGUMENT,
                        "txn failure op must be a Range of the compared key",
                    )

            ok, rev, cur = self.store.cas(
                key,
                value,
                required_mod=required_mod,
                required_version=required_version,
                lease=lease,
            )
            resp = pb.TxnResponse(header=self._header(rev if ok else None), succeeded=ok)
            if ok:
                if which == "request_put":
                    rop = pb.ResponseOp(response_put=pb.PutResponse(header=self._header(rev)))
                else:
                    rop = pb.ResponseOp(response_delete_range=pb.DeleteRangeResponse(
                        header=self._header(rev), deleted=1))
                resp.responses.append(rop)
            elif req.failure:
                rr = pb.RangeResponse(header=self._header())
                if cur is not None:
                    rr.kvs.append(_kv_to_pb(cur))
                    rr.count = 1
                resp.responses.append(pb.ResponseOp(response_range=rr))
            return resp

    async def Compact(
        self, req: pb.CompactionRequest, ctx
    ) -> pb.CompactionResponse:
        _REQ_COUNT.inc(method="Compact")
        try:
            self.store.compact(req.revision)
        except CompactedError:
            await ctx.abort(StatusCode.OUT_OF_RANGE, ERR_COMPACTED)
        except FutureRevError:
            await ctx.abort(StatusCode.OUT_OF_RANGE, ERR_FUTURE_REV)
        return pb.CompactionResponse(header=self._header())

    # ---- BatchKV (private pipelined-write extension, proto/batch.proto)

    async def PutFrame(
        self, req: pb.PutFrameRequest, ctx
    ) -> pb.PutFrameResponse:
        """A whole write wave as one native-format frame -> one FFI call.

        The asyncio interpreter cost per RPC amortizes over the wave instead
        of repeating per put — the wire-side equivalent of the reference's
        per-core tonic workers (reference README.adoc:343-353).
        """
        _REQ_COUNT.inc(method="PutFrame")
        with _REQ_LATENCY.time(method="PutFrame"):
            # A record is >=8 bytes, so count must fit the frame; this
            # also keeps the client-controlled uint32 inside the FFI's
            # c_int before ctypes ever sees it.
            if req.count > len(req.frame) // 8:
                await ctx.abort(
                    StatusCode.INVALID_ARGUMENT,
                    "count exceeds frame capacity",
                )
            rev = self.store.put_frame(req.frame, req.count, req.lease)
            if rev < 0:
                await ctx.abort(
                    StatusCode.INVALID_ARGUMENT,
                    f"malformed put frame (rc={rev})",
                )
            return pb.PutFrameResponse(revision=rev)

    async def BindFrame(
        self, req: pb.BindFrameRequest, ctx
    ) -> pb.BindFrameResponse:
        _REQ_COUNT.inc(method="BindFrame")
        with _REQ_LATENCY.time(method="BindFrame"):
            # A bind record is >=16 bytes (see PutFrame's count check).
            if req.count > len(req.frame) // 16:
                await ctx.abort(
                    StatusCode.INVALID_ARGUMENT,
                    "count exceeds frame capacity",
                )
            bound, revisions = self.store.bind_frame(req.frame, req.count)
            if bound < 0:
                await ctx.abort(
                    StatusCode.INVALID_ARGUMENT,
                    f"malformed bind frame (rc={bound})",
                )
            return pb.BindFrameResponse(revisions=revisions, bound=bound)

    # ---- Watch ---------------------------------------------------------

    async def Watch(self, request_iterator, ctx):
        """Bidi watch stream: multiplexes many watches over one stream."""
        _REQ_COUNT.inc(method="Watch")
        watchers: dict[int, Watcher] = {}
        pumps: dict[int, asyncio.Task] = {}
        next_id = 1
        # Bounded reply queue (bounded-watch-buffer): a wedged client
        # socket backpressures this stream's pumps at the bound — the
        # server's write waits on the client's flow-control window — while
        # their native Watcher queues are themselves capped and cancel on
        # overflow, instead of buffering responses without limit.
        out: asyncio.Queue = asyncio.Queue(maxsize=1024)
        last_delivered = 0
        # Per-watch "delivered through" revision: every event <= cleared[wid]
        # matching the watch has been written to the stream.  Advances on
        # delivered events, and — for watches with nothing to say — on an
        # empty poll, using a revision snapshot taken BEFORE the poll (the
        # native queue is filled inside the store's write lock, so an empty
        # queue proves delivery through any revision committed before the
        # poll began).  This is what makes progress responses a true
        # barrier (etcd semantics: a progress notification promises the
        # client has seen everything at or below its revision).
        cleared: dict[int, int] = {}
        barriers: set = set()
        # Per-stream shared frame table (wiretier): an event fanning to
        # several watches on this stream is encoded once, keyed by its
        # identity (prev_kv requests encode differently).
        ftable = wiretier.FrameTable(cap=4096)

        async def pump(wid: int, w: Watcher):
            nonlocal last_delivered
            loop = asyncio.get_running_loop()
            while True:
                r0 = self.store.progress_revision
                events = await loop.run_in_executor(None, w.poll, _WATCH_BATCH, 0)
                if w.dropped:
                    # Queue overflow lost events; a silently gapped
                    # stream would corrupt client caches — cancel, as
                    # the store contract requires, so the client
                    # re-establishes from its last good revision.
                    w.cancel()
                    watchers.pop(wid, None)
                    await out.put(
                        pb.WatchResponse(
                            header=self._header(),
                            watch_id=wid,
                            canceled=True,
                            cancel_reason="watcher overflowed; events dropped",
                        )
                    )
                    return
                if w.canceled and not events:
                    await out.put(
                        pb.WatchResponse(header=self._header(), watch_id=wid, canceled=True)
                    )
                    return
                if not events:
                    if cleared.get(wid, 0) < r0:
                        cleared[wid] = r0
                    await asyncio.sleep(_WATCH_POLL_S)
                    continue
                chunks = [
                    ftable.bytes_for(
                        (ev.kv.mod_revision, ev.kv.key, ev.type, ev.prev_kv is not None),
                        _encode_watch_event, ev,
                    )
                    for ev in events
                ]
                for ev in events:
                    last_delivered = max(last_delivered, ev.kv.mod_revision)
                await out.put(
                    wiretier.compose_frame(
                        wiretier.header_bytes(self._header()), [wid], chunks,
                    )
                )
                if cleared.get(wid, 0) < events[-1].kv.mod_revision:
                    cleared[wid] = events[-1].kv.mod_revision

        async def reader():
            nonlocal next_id
            async for req in request_iterator:
                which = req.which_oneof("request_union")
                if which == "create_request":
                    cr = req.create_request
                    wid = cr.watch_id or next_id
                    next_id = max(next_id, wid) + 1
                    if wid in watchers:
                        # etcd rejects duplicate watch ids with a cancel
                        # response; silently replacing would orphan the old
                        # pump and leak its native event buffer.
                        await out.put(
                            pb.WatchResponse(
                                header=self._header(),
                                watch_id=wid,
                                canceled=True,
                                cancel_reason="duplicate watch_id",
                            )
                        )
                        continue
                    try:
                        w = self.store.watch(
                            cr.key,
                            self._end_of(cr.range_end),
                            start_revision=cr.start_revision,
                            prev_kv=cr.prev_kv,
                        )
                    except CompactedError as e:
                        _WATCH_COMPACT_CANCELS.inc()
                        await out.put(
                            pb.WatchResponse(
                                header=self._header(),
                                watch_id=wid,
                                created=True,
                                canceled=True,
                                compact_revision=e.compact_revision,
                            )
                        )
                        continue
                    watchers[wid] = w
                    await out.put(
                        pb.WatchResponse(header=self._header(), watch_id=wid, created=True)
                    )
                    pumps[wid] = asyncio.create_task(pump(wid, w))
                elif which == "cancel_request":
                    wid = req.cancel_request.watch_id
                    w = watchers.pop(wid, None)
                    if w is not None:
                        w.cancel()
                        task = pumps.pop(wid, None)
                        if task:
                            task.cancel()
                        await out.put(
                            pb.WatchResponse(header=self._header(), watch_id=wid, canceled=True)
                        )
                elif which == "progress_request":
                    # Progress must never regress below delivered events
                    # (reference watch_service.rs:172-176), and must not
                    # OVERTAKE them either: the response is a barrier —
                    # it goes out only after every watch on this stream
                    # has delivered through the progress revision (real
                    # etcd orders progress after prior events; the
                    # consistent-read-from-cache protocol depends on it).
                    rev = max(self.store.progress_revision, last_delivered)
                    t = asyncio.create_task(progress_barrier(rev, list(watchers)))
                    barriers.add(t)
                    t.add_done_callback(barriers.discard)
            await out.put(None)

        async def progress_barrier(rev: int, wids: list[int]) -> None:
            while not all(
                wid not in watchers or cleared.get(wid, 0) >= rev for wid in wids
            ):
                await asyncio.sleep(_WATCH_POLL_S)
            await out.put(pb.WatchResponse(header=self._header(rev), watch_id=-1))

        rtask = asyncio.create_task(reader())
        try:
            while True:
                resp = await out.get()
                if resp is None:
                    return
                yield resp
        finally:
            rtask.cancel()
            for task in pumps.values():
                task.cancel()
            for task in list(barriers):
                task.cancel()
            for w in watchers.values():
                w.cancel()

    # ---- Lease (deliberately fake, reference lease_service.rs) ---------

    async def LeaseGrant(self, req: pb.LeaseGrantRequest, ctx):
        _REQ_COUNT.inc(method="LeaseGrant")
        async with self._lease_lock:
            self._lease_id += 1
            lid = req.ID or self._lease_id
            self._leases[lid] = req.TTL
        return pb.LeaseGrantResponse(header=self._header(), ID=lid, TTL=req.TTL)

    async def LeaseRevoke(self, req: pb.LeaseRevokeRequest, ctx):
        _REQ_COUNT.inc(method="LeaseRevoke")
        self._leases.pop(req.ID, None)
        return pb.LeaseRevokeResponse(header=self._header())

    async def LeaseKeepAlive(self, request_iterator, ctx):
        async for req in request_iterator:
            yield pb.LeaseKeepAliveResponse(
                header=self._header(), ID=req.ID, TTL=self._leases.get(req.ID, 0)
            )

    async def LeaseTimeToLive(self, req: pb.LeaseTimeToLiveRequest, ctx):
        ttl = self._leases.get(req.ID)
        if ttl is None:
            return pb.LeaseTimeToLiveResponse(header=self._header(), ID=req.ID, TTL=-1)
        return pb.LeaseTimeToLiveResponse(
            header=self._header(), ID=req.ID, TTL=ttl, grantedTTL=ttl
        )

    async def LeaseLeases(self, req: pb.LeaseLeasesRequest, ctx):
        return pb.LeaseLeasesResponse(
            header=self._header(),
            leases=[pb.LeaseStatus(ID=lid) for lid in self._leases],
        )

    # ---- Maintenance ---------------------------------------------------

    async def Status(self, req: pb.StatusRequest, ctx):
        return pb.StatusResponse(
            header=self._header(),
            version="3.5.16",
            dbSize=self.store.db_size,
            dbSizeInUse=self.store.db_size,
            leader=1,
            raftIndex=1,
            raftTerm=1,
        )

    async def Alarm(self, req: pb.AlarmRequest, ctx):
        return pb.AlarmResponse(header=self._header())

    async def Defragment(self, req: pb.DefragmentRequest, ctx):
        return pb.DefragmentResponse(header=self._header())

    async def Hash(self, req, ctx):
        await ctx.abort(StatusCode.UNIMPLEMENTED, "Hash not implemented")

    async def Snapshot(self, req, ctx):
        await ctx.abort(StatusCode.UNIMPLEMENTED, "Snapshot not implemented")
        yield  # pragma: no cover — makes this an async generator

    async def MoveLeader(self, req, ctx):
        await ctx.abort(StatusCode.UNIMPLEMENTED, "MoveLeader not implemented")


# Every response goes out through one serializer: handlers return codec
# messages, and Range and the watch event frames return composed bytes.
_serialize = wiretier.serialize_frame_or_message


def _unary(fn, req_cls):
    return wire_server.unary_unary_rpc_method_handler(fn, req_cls.decode, _serialize)


def _stream_stream(fn, req_cls):
    return wire_server.stream_stream_rpc_method_handler(fn, req_cls.decode, _serialize)


def _unary_stream(fn, req_cls):
    return wire_server.unary_stream_rpc_method_handler(fn, req_cls.decode, _serialize)


def add_services(server: wire_server.Server, svc: EtcdService) -> None:
    kv = {
        "Range": _unary(svc.Range, pb.RangeRequest),
        "Put": _unary(svc.Put, pb.PutRequest),
        "DeleteRange": _unary(svc.DeleteRange, pb.DeleteRangeRequest),
        "Txn": _unary(svc.Txn, pb.TxnRequest),
        "Compact": _unary(svc.Compact, pb.CompactionRequest),
    }
    watch = {"Watch": _stream_stream(svc.Watch, pb.WatchRequest)}
    lease = {
        "LeaseGrant": _unary(svc.LeaseGrant, pb.LeaseGrantRequest),
        "LeaseRevoke": _unary(svc.LeaseRevoke, pb.LeaseRevokeRequest),
        "LeaseKeepAlive": _stream_stream(svc.LeaseKeepAlive, pb.LeaseKeepAliveRequest),
        "LeaseTimeToLive": _unary(svc.LeaseTimeToLive, pb.LeaseTimeToLiveRequest),
        "LeaseLeases": _unary(svc.LeaseLeases, pb.LeaseLeasesRequest),
    }
    maint = {
        "Alarm": _unary(svc.Alarm, pb.AlarmRequest),
        "Status": _unary(svc.Status, pb.StatusRequest),
        "Defragment": _unary(svc.Defragment, pb.DefragmentRequest),
        "Hash": _unary(svc.Hash, pb.HashRequest),
        "Snapshot": _unary_stream(svc.Snapshot, pb.SnapshotRequest),
        "MoveLeader": _unary(svc.MoveLeader, pb.MoveLeaderRequest),
    }
    batch = {
        "PutFrame": _unary(svc.PutFrame, pb.PutFrameRequest),
        "BindFrame": _unary(svc.BindFrame, pb.BindFrameRequest),
    }
    server.add_generic_rpc_handlers((
        ("etcdserverpb.KV", kv),
        ("etcdserverpb.Watch", watch),
        ("etcdserverpb.Lease", lease),
        ("etcdserverpb.Maintenance", maint),
        ("k8s1m.BatchKV", batch),
    ))


async def serve(
    store: MemStore,
    port: int = 2379,
    host: str = "127.0.0.1",
    metrics_port: int = 0,
) -> tuple[wire_server.Server, int]:
    """Start the etcd-compatible server on the running loop; returns
    (server, bound_port)."""
    server = wire_server.Server()
    add_services(server, EtcdService(store))
    bound = server.add_insecure_port(f"{host}:{port}")
    if bound == 0:
        raise OSError(f"failed to bind {host}:{port} (port in use?)")
    await server.start()
    if metrics_port:
        from k8s1m_tpu_torch.obs.http import start_metrics_server

        _SERVED_STORES.add(store)
        start_metrics_server(metrics_port)
    return server, bound
