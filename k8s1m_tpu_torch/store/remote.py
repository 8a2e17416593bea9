"""Synchronous etcd-wire store client with the in-process MemStore surface.

The port's copy of ``k8s1m_tpu/store/remote.py`` on the port's own
transport (``store/wire.py``: HTTP/2 and gRPC in the standard library) and
codec (``store/proto/codec.py``), so it runs where no ``grpcio`` or
``protobuf`` is installed.  The coordinator, written against the MemStore
read/write/watch API, runs unchanged against any etcd v3 server through
it: ours (``store/server_main.py``, the native front-end) or the JAX
package's asyncio server, or a real etcd (without the BatchKV frames).

Watch mapping: the wire protocol has no overflow signal, so ``dropped``
goes positive when the stream errors or the server cancels (compaction) —
the coordinator answers with a relist and a new watch, its response to an
in-process overflow too, which also covers whatever events the broken
stream lost.  Each watch is its own HTTP/2 stream on the store's shared
connection, and that connection's one reader thread pushes every watch's
events straight into the watcher's bounded queue.

Resilience: every unary call runs under the ``store.wire`` RetryPolicy
(``faultline/policy.py``: capped exponential backoff with jitter under a
deadline budget; transient wire errors and injected faults retry, semantic
errors like CompactedError propagate), and every call site is a faultline
injection hook (component ``store.wire``).

The light relist (``range_values``/``range_items``) walks a RangeResponse's
``kvs`` and slices out keys and values without a KeyValue per entry, so
``list_prefix_values``/``list_prefix_items`` take the light path over the
wire as they do in-process.
"""

from __future__ import annotations

import collections
import logging
import threading
import time

from k8s1m_tpu_torch import faultline
from k8s1m_tpu_torch.faultline import InjectedFault, RetryPolicy, policy_for
from k8s1m_tpu_torch.obs.metrics import Counter
from k8s1m_tpu_torch.store.native import (
    CompactedError,
    FutureRevError,
    KeyValue,
    RangeResult,
    WatchEvent,
    pack_bind_frame,
    pack_put_frame,
    parse_pod_events,
)
from k8s1m_tpu_torch.store.proto import codec as pb
from k8s1m_tpu_torch.store.wire import Channel, WireError

log = logging.getLogger("k8s1m.remote_store")

_M = "/etcdserverpb"
_RANGE = f"{_M}.KV/Range"
_PUT = f"{_M}.KV/Put"
_DELETE = f"{_M}.KV/DeleteRange"
_TXN = f"{_M}.KV/Txn"
_COMPACT = f"{_M}.KV/Compact"
_STATUS = f"{_M}.Maintenance/Status"
_WATCH = f"{_M}.Watch/Watch"
_PUT_FRAME = "/k8s1m.BatchKV/PutFrame"
_BIND_FRAME = "/k8s1m.BatchKV/BindFrame"

_CLIENT_COALESCED = Counter(
    "watchcache_client_coalesced_total",
    "wire-watch events elided client-side by the opt-in latest-only "
    "overflow coalescing (RemoteWatcher coalesce=True)", ()
)


def _check_unary(op: str, expressible: tuple = ()):
    """Faultline hook for a unary RPC.  ``delay`` was already applied;
    kinds in ``expressible`` are returned for the call site to apply
    (range's stale_revision, the batch writes' partial_write).  Every
    OTHER kind fails like a dropped request on the wire, so a counted
    injection is never a silent no-op."""
    d = faultline.check("store.wire", op)
    if d is None or d.kind == "delay" or d.kind in expressible:
        return d
    raise InjectedFault(d)


def _kv(t: tuple) -> KeyValue:
    key, value, crev, mrev, ver, lease = t
    return KeyValue(key=key, value=value, create_revision=crev, mod_revision=mrev,
                    version=ver, lease=lease)


def _pb_kv(m) -> KeyValue:
    return KeyValue(key=m.key, value=m.value, create_revision=m.create_revision,
                    mod_revision=m.mod_revision, version=m.version, lease=m.lease)


class RemoteWatcher:
    """MemStore-Watcher-shaped handle over a Watch stream.

    The connection's reader thread decodes each WatchResponse into this
    watcher's locked, bounded queue; ``poll``/``poll_light``/``poll_pods``
    are non-blocking like the native watcher's.  Past ``queue_cap`` events
    count as ``dropped`` (the owner relists), unless ``coalesce=True``:
    then events past the FIFO cap fold latest-only per key into a bounded
    map, legal for level-triggered consumers, and only a map past
    ``queue_cap`` distinct keys starts dropping.  ``seen_revision`` is the
    highest mod_revision buffered.  ``progress()`` is a barrier: the
    server answers a progress request only after every event at or below
    its revision went out on this stream.
    """

    def __init__(self, store: "RemoteStore", key, end, start_revision, prev_kv,
                 queue_cap: int = 0, coalesce: bool = False):
        self._queue_cap = queue_cap if queue_cap > 0 else 10_000
        # maxlen is the backstop; the manual cap below is the working
        # limit (overflow must COUNT, never silently evict).
        self._events: collections.deque = collections.deque(maxlen=self._queue_cap)
        self._lock = threading.Lock()
        self._progressed = threading.Condition(self._lock)
        self._coalesce = coalesce
        # key -> (etype, kv, prev): the latest-only overflow regime.
        self._coalesced: dict[bytes, tuple] = {}
        self._dropped = 0
        self.canceled = False
        self.seen_revision = 0
        self._progress_count = 0
        self._progress_revision = 0
        self._call = None
        create = pb.WatchRequest(create_request=pb.WatchCreateRequest(
            key=key, range_end=end or b"", start_revision=start_revision, prev_kv=prev_kv))
        try:
            self._call = store.channel.stream(_WATCH, self._on_message, self._on_close)
            self._call.send(create.encode())
        except WireError as e:
            # A stream that cannot start is a broken stream: the owner
            # resyncs, as it would after one that broke later.
            self._on_close(e.code, e.details)

    # ---- the reader thread's side ----------------------------------------------

    def _end(self) -> None:
        """End the stream from this side (RST_STREAM); not counted again."""
        self.canceled = True
        if self._call is not None:
            self._call.cancel()

    def _on_message(self, data: bytes) -> None:
        d = faultline.decide("store.wire", "watch.recv")
        if d is not None:
            if d.kind == "delay":
                time.sleep(d.delay_s)
            elif d.kind == "drop":
                # This batch's events are thrown away — never silently:
                # dropped goes positive and the owner relists.
                with self._lock:
                    self._dropped += 1
                return
            else:
                # disconnect / err5xx / stale_revision: the stream is dead
                # from the consumer's side, as a broken stream is.
                log.warning("watch stream: injected %s", d.kind)
                with self._lock:
                    self._dropped += 1
                self._end()
                return
        if self.canceled:
            return
        b = pb.parse_watch_response(data)
        if b.compact_revision:
            with self._lock:
                self._dropped += 1
            self._end()
            return
        if b.canceled:
            if not self.canceled:
                # Server-initiated cancel (overflow, compaction): events
                # were lost, the owner must resync.
                log.warning("watch canceled by server: %s", b.cancel_reason)
                with self._lock:
                    self._dropped += 1
            self._end()
            return
        if not b.events:
            if b.watch_id == -1 and not b.created:
                with self._lock:
                    self._progress_count += 1
                    self._progress_revision = b.revision
                    self._progressed.notify_all()
            return
        with self._lock:
            for ev in b.events:
                etype, kv, prev = ev
                if kv[3] > self.seen_revision:
                    self.seen_revision = kv[3]
                if len(self._events) >= self._queue_cap or self._coalesced:
                    if not self._coalesce:
                        self._dropped += 1
                        continue
                    # Latest-only per key (sticky until drained, so
                    # emission stays revision-ordered); past the key cap
                    # the drop-and-resync contract resumes.
                    key = kv[0]
                    if key in self._coalesced:
                        _CLIENT_COALESCED.inc()
                    elif len(self._coalesced) >= self._queue_cap:
                        self._dropped += 1
                        continue
                    self._coalesced[key] = ev
                    continue
                self._events.append(ev)

    def _on_close(self, code, details: str) -> None:
        with self._lock:
            if not self.canceled:
                # A broken stream, or one the server ended without a
                # cancel response: events after this point are lost.
                log.warning("watch stream ended: %s %s", getattr(code, "name", code), details)
                self._dropped += 1
            self.canceled = True
            self._progressed.notify_all()

    # ---- the consumer's side ---------------------------------------------------

    def _drain_raw(self, max_events: int) -> list:
        out = []
        with self._lock:
            while self._events and len(out) < max_events:
                out.append(self._events.popleft())
            if not self._events and self._coalesced and len(out) < max_events:
                # One revision-ordered merge of the coalesced frame behind
                # the FIFO (everything in the map postdates the queue).
                rest = sorted(self._coalesced.values(), key=lambda t: t[1][3])
                take = rest[: max_events - len(out)]
                for t in take:
                    del self._coalesced[t[1][0]]
                out.extend(take)
        return out

    def poll(self, max_events: int = 1000, timeout_ms: int = 0) -> list[WatchEvent]:
        return [
            WatchEvent("DELETE" if etype else "PUT", _kv(kv),
                       _kv(prev) if prev is not None else None)
            for etype, kv, prev in self._drain_raw(max_events)
        ]

    def poll_light(self, max_events: int = 1000, timeout_ms: int = 0
                   ) -> list[tuple[int, bytes, bytes, int]]:
        """``(type, key, value, mod_revision)`` tuples (type 0=PUT,
        1=DELETE), the native watcher's ``poll_light``."""
        return [(etype, kv[0], kv[1], kv[3]) for etype, kv, _prev in self._drain_raw(max_events)]

    def poll_pods(self, max_events: int = 10000, scheduler_name: bytes = b""):
        """Drain buffered wire events through the native canonical-pod
        parser (``parse_pod_events``): one columnar frame, as the
        in-process watcher's ``poll_pods`` gives."""
        return parse_pod_events(
            ((etype, kv[0], kv[1], kv[3]) for etype, kv, _prev in self._drain_raw(max_events)),
            scheduler_name,
        )

    def progress(self, timeout: float = 60.0) -> int | None:
        """Ask the server for a progress notification and wait for it.  When
        it returns, every event at or below the returned revision is in
        this watcher's queue.  ``None`` if the stream ended first."""
        with self._lock:
            if self.canceled:
                return None
            seen = self._progress_count
        try:
            self._call.send(pb.WatchRequest(progress_request=pb.WatchProgressRequest()).encode())
        except WireError:
            return None
        with self._lock:
            if not self._progressed.wait_for(
                    lambda: self._progress_count > seen or self.canceled, timeout):
                raise TimeoutError(f"watch progress: no answer in {timeout} s")
            return None if self._progress_count == seen else self._progress_revision

    @property
    def pending(self) -> int:
        with self._lock:
            return len(self._events) + len(self._coalesced)

    @property
    def dropped(self) -> int:
        return self._dropped

    def cancel(self) -> None:
        if not self.canceled:
            self._end()


class RemoteStore:
    """Blocking etcd v3 client exposing the MemStore surface."""

    def __init__(self, target: str, channel: Channel | None = None, *,
                 ca_pem: str | None = None, token: str | None = None,
                 retry_policy: RetryPolicy | None = None):
        self.target = target
        self.retry_policy = retry_policy or policy_for("store.wire")
        self.channel = channel or Channel(target, ca_pem=ca_pem, token=token)

    def close(self) -> None:
        self.channel.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _invoke(self, op: str, fn):
        """One wire attempt (injection hook + RPC) under the store.wire
        RetryPolicy.  ``fn`` must be safe to repeat: every op here is a
        read, an idempotent put, or a CAS whose retry can only observe its
        own prior success as a conflict."""
        return self.retry_policy.call(fn, op=op)

    def _unary(self, path: str, req, resp_cls):
        return resp_cls.decode(self.channel.unary(path, req.encode()))

    # ---- writes --------------------------------------------------------------

    def put(self, key: bytes, value: bytes, lease: int = 0) -> int:
        def once():
            _check_unary("put")
            return self._unary(_PUT, pb.PutRequest(key=key, value=value, lease=lease),
                               pb.PutResponse)
        return self._invoke("put", once).header.revision

    def delete(self, key: bytes) -> tuple[int, bool]:
        def once():
            _check_unary("delete")
            return self._unary(_DELETE, pb.DeleteRangeRequest(key=key), pb.DeleteRangeResponse)
        resp = self._invoke("delete", once)
        if resp.deleted:
            return resp.header.revision, True
        return 0, False

    def _put_frame(self, items, lease: int) -> int:
        req = pb.PutFrameRequest(frame=pack_put_frame(items), count=len(items), lease=lease)
        return self._unary(_PUT_FRAME, req, pb.PutFrameResponse).revision

    def put_batch(self, items: list[tuple[bytes, bytes | None]], lease: int = 0) -> int:
        """A whole write wave as one BatchKV.PutFrame RPC (value None =
        delete) — the wire form of MemStore.put_batch.  Only our servers
        serve it; a real etcd answers UNIMPLEMENTED."""
        def once():
            d = _check_unary("put_batch", ("partial_write",))
            if d is not None and d.kind == "partial_write":
                if len(items) <= 1:
                    # A 1-item batch has no expressible prefix.
                    raise InjectedFault(d)
                # A prefix of the batch lands, then the connection dies.
                # Retrying the WHOLE batch is safe: puts are idempotent.
                self._put_frame(items[: len(items) // 2], lease)
                raise InjectedFault(d)
            return self._put_frame(items, lease)
        return self._invoke("put_batch", once)

    def _bind_frame(self, binds) -> list[int]:
        req = pb.BindFrameRequest(frame=pack_bind_frame(binds), count=len(binds))
        return list(self._unary(_BIND_FRAME, req, pb.BindFrameResponse).revisions)

    def bind_batch(self, binds: list[tuple[bytes, int, bytes]]) -> list[int]:
        """A bind wave over one BatchKV.BindFrame RPC — the wire form of
        MemStore.bind_batch (the same per-record result codes)."""
        def once():
            d = _check_unary("bind_batch", ("partial_write",))
            if d is not None and d.kind == "partial_write":
                if len(binds) <= 1:
                    raise InjectedFault(d)
                # A prefix binds, then the stream dies.  The retried full
                # wave is CAS-guarded: the bound prefix comes back as
                # conflicts, which the coordinator re-reads.
                self._bind_frame(binds[: len(binds) // 2])
                raise InjectedFault(d)
            return self._bind_frame(binds)
        return self._invoke("bind_batch", once)

    def cas(self, key: bytes, value: bytes | None, *, required_mod: int | None = None,
            required_version: int | None = None, lease: int = 0
            ) -> tuple[bool, int, KeyValue | None]:
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
        fail = pb.RequestOp(request_range=pb.RangeRequest(key=key))
        req = pb.TxnRequest(compare=[cmp], success=[op], failure=[fail])

        def once():
            _check_unary("txn")
            return self._unary(_TXN, req, pb.TxnResponse)
        resp = self._invoke("txn", once)
        if resp.succeeded:
            return True, resp.header.revision, None
        cur = None
        for r in resp.responses:
            kvs = r.response_range.kvs if r.response_range is not None else []
            if kvs:
                cur = _pb_kv(kvs[0])
        return False, resp.header.revision, cur

    # ---- reads ---------------------------------------------------------------

    def _range_bytes(self, req: "pb.RangeRequest") -> bytes:
        def once():
            d = _check_unary("range", ("stale_revision",))
            if d is not None and d.kind == "stale_revision":
                # The read observes a compacted snapshot: the signal
                # consumers already recover from.
                raise CompactedError("injected stale revision")
            try:
                return self.channel.unary(_RANGE, req.encode())
            except WireError as e:
                if "compacted" in e.details:
                    raise CompactedError(e.details) from None
                if "future revision" in e.details or "required revision" in e.details:
                    raise FutureRevError(e.details) from None
                raise
        return self._invoke("range", once)

    def range(self, start: bytes, end: bytes | None = None, *, revision: int = 0,
              limit: int = 0, count_only: bool = False, keys_only: bool = False
              ) -> RangeResult:
        resp = pb.RangeResponse.decode(self._range_bytes(pb.RangeRequest(
            key=start, range_end=end or b"", revision=revision, limit=limit,
            count_only=count_only, keys_only=keys_only)))
        return RangeResult(
            revision=resp.header.revision if resp.header is not None else 0,
            count=resp.count, more=resp.more, kvs=[_pb_kv(kv) for kv in resp.kvs])

    def range_values(self, start: bytes, end: bytes | None = None, *, revision: int = 0,
                     limit: int = 0) -> tuple[int, bool, list, bytes | None]:
        """``range`` minus everything but the value bytes: ``(revision,
        more, values, last_key)``, ``last_key`` the pagination cursor —
        MemStore.range_values over the wire."""
        data = self._range_bytes(pb.RangeRequest(
            key=start, range_end=end or b"", revision=revision, limit=limit))
        rev, more, _count, values, last = pb.parse_range(data, keys=False, values=True)
        return rev, more, values, last

    def range_items(self, start: bytes, end: bytes | None = None, *, revision: int = 0,
                    limit: int = 0, keys_only: bool = False) -> tuple[int, bool, list]:
        """``range`` minus the KeyValue construction: ``(revision, more,
        items)`` with ``(key, value)`` pairs, or bare keys with
        ``keys_only`` — MemStore.range_items over the wire."""
        data = self._range_bytes(pb.RangeRequest(
            key=start, range_end=end or b"", revision=revision, limit=limit,
            keys_only=keys_only))
        rev, more, _count, items, _last = pb.parse_range(data, keys=True,
                                                         values=not keys_only)
        return rev, more, items

    def get(self, key: bytes, revision: int = 0) -> KeyValue | None:
        res = self.range(key, revision=revision)
        return res.kvs[0] if res.kvs else None

    # ---- watch ---------------------------------------------------------------

    def watch(self, start: bytes, end: bytes | None = None, *, start_revision: int = 0,
              prev_kv: bool = False, queue_cap: int = 0, coalesce: bool = False
              ) -> RemoteWatcher:
        """``queue_cap`` bounds the CLIENT-side buffer (default 10K like the
        native watcher): the server drains continuously into the stream,
        so overflow protection lives where the backlog accumulates.  On
        overflow ``dropped`` goes positive and the owner resyncs — unless
        ``coalesce=True`` (see RemoteWatcher)."""
        return RemoteWatcher(self, start, end, start_revision, prev_kv, queue_cap, coalesce)

    # ---- maintenance ---------------------------------------------------------

    def compact(self, revision: int) -> None:
        def once():
            _check_unary("compact")
            return self._unary(_COMPACT, pb.CompactionRequest(revision=revision),
                               pb.CompactionResponse)
        self._invoke("compact", once)

    @property
    def current_revision(self) -> int:
        def once():
            _check_unary("status")
            return self._unary(_STATUS, pb.StatusRequest(), pb.StatusResponse)
        return self._invoke("status", once).header.revision
