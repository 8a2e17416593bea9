"""ctypes bindings for the native in-process store (etcd semantics).

The port's own copy of the parts of ``k8s1m_tpu/store/native.py`` the
coordinator and ``tools/sched_bench.py`` call: ``MemStore`` (put, batched
put, CAS, range, watch, the native bind wave ``bind_batch``; a write-ahead
log with ``wal_dir=``), ``Watcher`` (``poll_light``, the columnar pod drain
``poll_pods``, the full ``poll``), ``parse_pod_events`` (the same columnar
parse over events received off the wire), ``WireFront`` (the native
etcd-wire server over a ``MemStore``) and ``wire_stress_put`` (its
pipelined native Put client), the paginated relists
``list_prefix``/``list_prefix_values`` and the unpinned ``scan_prefix``,
``drain_events``/``drain_events_light``, ``prefix_end``, the errors and the
``POD_*`` flags; for the asyncio server, ``MemStore.compact``/``wal_sync``/
``stats`` and the ``progress_revision``/``num_keys``/``db_size`` readings,
and for the watch tier's frames ``read_varint``/``decode_shared_tail``.
It loads the port's own ``libmemstore.so`` (``store/build.py``), built
from the C++ sources under ``native/``; binary result layouts are defined
in ``native/memstore/memstore.h``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import struct

from k8s1m_tpu_torch.obs.metrics import Counter
from k8s1m_tpu_torch.store.build import ensure_built

_RELIST_COMPACTED = Counter(
    "memstore_relist_compacted_retries_total",
    "pinned relist restarts after the snapshot revision fell out of the "
    "compaction window mid-scan (the reflector-on-410 rule)", ()
)

_WAL_MODES = {"none": 0, "buffered": 1, "fsync": 2}   # memstore.h MS_WAL_*

_ERR_CAS = -1
_ERR_COMPACTED = -2
_ERR_FUTURE_REV = -3
_ERR_NOT_FOUND = -4
# Public: bind_batch result for "object not spliceable, use the slow path".
BIND_INVALID = -5

# etcd convention: range end of a single zero byte means "to infinity".
INFINITY = b"\x00"


class CompactedError(Exception):
    def __init__(self, compact_revision: int = 0):
        super().__init__(f"revision compacted (compact_revision={compact_revision})")
        self.compact_revision = compact_revision


class FutureRevError(Exception):
    pass


def prefix_end(prefix: bytes) -> bytes:
    """etcd's prefix-range end: prefix with its last byte incremented
    (the /a/b/c/ -> /a/b/c0 idiom, reference store.rs:536-588)."""
    p = bytearray(prefix)
    for i in reversed(range(len(p))):
        if p[i] < 0xFF:
            p[i] += 1
            return bytes(p[: i + 1])
    return INFINITY


@dataclasses.dataclass(frozen=True)
class KeyValue:
    key: bytes
    value: bytes
    create_revision: int
    mod_revision: int
    version: int
    lease: int = 0


@dataclasses.dataclass(frozen=True)
class WatchEvent:
    type: str           # "PUT" | "DELETE"
    kv: KeyValue
    prev_kv: KeyValue | None = None


@dataclasses.dataclass(frozen=True)
class RangeResult:
    revision: int       # store revision at read time
    # Total matches when limit=0 (or count_only); with limit>0 the scan
    # stops one element past the limit, so count is approximate (at most
    # limit+1 — proof of `more`, not a total).  etcd permits this and
    # Kubernetes tolerates it (reference README.adoc:326-328).
    count: int
    more: bool
    kvs: list[KeyValue]


# ms_watch_poll_pods flag bits (memstore.h MS_POD_*).
POD_CANONICAL = 1
POD_HAS_NODE = 2
POD_SCHED_MATCH = 4


@dataclasses.dataclass
class PodEventBatch:
    """Columnar view of one ms_watch_poll_pods drain (zero-copy numpy
    views into the single result buffer; layout in memstore.h)."""

    n: int
    canceled: bool
    etype: "object"     # u8[n]   0 PUT, 1 DELETE
    flags: "object"     # u8[n]   POD_* bits
    mrev: "object"      # i64[n]
    cpu: "object"       # i32[n]
    mem: "object"       # i32[n]
    koff: "object"      # u32[n+1] offsets into key_blob
    aoff: "object"      # u32[n+1] offsets into aux_blob
    key_blob: bytes
    aux_blob: bytes

    @staticmethod
    def empty() -> "PodEventBatch":
        import numpy as np

        z = np.zeros(0, np.uint8)
        o = np.zeros(1, np.uint32)
        return PodEventBatch(
            0, False, z, z, np.zeros(0, np.int64), np.zeros(0, np.int32),
            np.zeros(0, np.int32), o, o, b"", b"",
        )

    @staticmethod
    def parse(data: bytes) -> "PodEventBatch":
        import numpy as np

        (n,) = _U32.unpack_from(data, 0)
        canceled = bool(data[4])
        off = 8
        etype = np.frombuffer(data, np.uint8, n, off); off += n
        flags = np.frombuffer(data, np.uint8, n, off); off += n
        off += (8 - off % 8) % 8
        mrev = np.frombuffer(data, np.int64, n, off); off += 8 * n
        cpu = np.frombuffer(data, np.int32, n, off); off += 4 * n
        mem = np.frombuffer(data, np.int32, n, off); off += 4 * n
        koff = np.frombuffer(data, np.uint32, n + 1, off); off += 4 * (n + 1)
        aoff = np.frombuffer(data, np.uint32, n + 1, off); off += 4 * (n + 1)
        klen = int(koff[-1])
        key_blob = data[off : off + klen]; off += klen
        aux_blob = data[off : off + int(aoff[-1])]
        return PodEventBatch(
            int(n), canceled, etype, flags, mrev, cpu, mem, koff, aoff,
            key_blob, aux_blob,
        )


_KV_FIXED = struct.Struct("<IIqqqq")  # klen, vlen, create, mod, version, lease
_U32 = struct.Struct("<I")
_U32X2 = struct.Struct("<II")
_PUT_REC = struct.Struct("<II")       # klen, vlen (0xFFFFFFFF = delete)
_BIND_REC = struct.Struct("<qII")     # required_mod, klen, nlen
_DELETE_MARKER = 0xFFFFFFFF


def pack_put_frame(items: list[tuple[bytes, bytes | None]]) -> bytes:
    """Pack puts/deletes (value None = delete) into the ms_put_batch frame
    format — also the wire form of BatchKV.PutFrame (proto/batch.proto)."""
    parts = []
    pack = _PUT_REC.pack
    for key, value in items:
        if value is None:
            parts.append(pack(len(key), _DELETE_MARKER))
            parts.append(key)
        else:
            parts.append(pack(len(key), len(value)))
            parts.append(key)
            parts.append(value)
    return b"".join(parts)


def pack_bind_frame(binds: list[tuple[bytes, int, bytes]]) -> bytes:
    """Pack (key, required_mod, node_name) bind records into the
    ms_bind_batch frame format — also the wire form of BatchKV.BindFrame."""
    parts = []
    pack = _BIND_REC.pack
    for key, required_mod, name in binds:
        parts.append(pack(required_mod, len(key), len(name)))
        parts.append(key)
        parts.append(name)
    return b"".join(parts)


def _parse_kv(buf: memoryview, off: int) -> tuple[KeyValue, int]:
    klen, vlen, crev, mrev, ver, lease = _KV_FIXED.unpack_from(buf, off)
    off += _KV_FIXED.size
    key = bytes(buf[off : off + klen]); off += klen
    val = bytes(buf[off : off + vlen]); off += vlen
    return KeyValue(key, val, crev, mrev, ver, lease), off


def read_varint(buf: bytes, off: int) -> tuple[int, int]:
    """(value, next_offset) of the protobuf varint at ``off``."""
    val = 0
    shift = 0
    while True:
        b = buf[off]
        off += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, off
        shift += 7


def decode_shared_tail(data: bytes) -> tuple[list[int], int, int]:
    """Decode the wiretier shared-frame extension of one serialized
    WatchResponse (``store/wiretier.py``): trailing private fields 100
    (repeated varint: the EXTRA watch ids sharing this frame's bytes) and
    101 (varint: a compacted frame's window lower bound).

    Returns ``(extra_wids, from_rev, core_len)``, where ``core_len`` is the
    byte length of the frame up to the first extension field: the exact
    unshared single-watch response the primary id would have received.  A
    frame without the extension returns ``([], 0, len(data))``, so callers
    can run this unconditionally.  A top-level field scan, not a parse:
    every other field is skipped by its length."""
    wids: list[int] = []
    from_rev = 0
    core = len(data)
    off = 0
    n = len(data)
    while off < n:
        at = off
        key, off = read_varint(data, off)
        field, wt = key >> 3, key & 7
        if wt == 0:
            val, off = read_varint(data, off)
        elif wt == 2:
            ln, off = read_varint(data, off)
            off += ln
            val = 0
        elif wt == 5:
            off += 4
            val = 0
        elif wt == 1:
            off += 8
            val = 0
        else:
            break   # start/end-group or junk: nothing of ours follows
        if wt == 0 and field == 100:
            wids.append(val)
            core = min(core, at)
        elif wt == 0 and field == 101:
            from_rev = val
            core = min(core, at)
    return wids, from_rev, core


def _load_lib():
    lib = ctypes.CDLL(ensure_built())
    c = ctypes
    P8 = c.POINTER(c.c_uint8)
    lib.ms_open.restype = c.c_void_p
    lib.ms_open.argtypes = [c.c_char_p, c.c_int, c.c_char_p]
    lib.ms_close.argtypes = [c.c_void_p]
    lib.ms_free.argtypes = [c.c_void_p]
    lib.ms_set.restype = c.c_int64
    lib.ms_set.argtypes = [
        c.c_void_p, c.c_char_p, c.c_size_t, c.c_char_p, c.c_size_t,
        c.c_int, c.c_int, c.c_int64, c.c_int64,
        c.POINTER(c.c_int64), c.POINTER(P8), c.POINTER(c.c_size_t),
    ]
    lib.ms_range.restype = c.c_int
    lib.ms_range.argtypes = [
        c.c_void_p, c.c_char_p, c.c_size_t, c.c_char_p, c.c_size_t,
        c.c_int64, c.c_int64, c.c_int, c.c_int,
        c.POINTER(P8), c.POINTER(c.c_size_t),
    ]
    for name in ("ms_current_revision", "ms_compact_revision",
                 "ms_progress_revision", "ms_num_keys", "ms_db_size"):
        fn = getattr(lib, name)
        fn.restype = c.c_int64
        fn.argtypes = [c.c_void_p]
    lib.ms_compact.restype = c.c_int
    lib.ms_compact.argtypes = [c.c_void_p, c.c_int64]
    lib.ms_watch_create.restype = c.c_int64
    lib.ms_watch_create.argtypes = [
        c.c_void_p, c.c_char_p, c.c_size_t, c.c_char_p, c.c_size_t,
        c.c_int64, c.c_int, c.c_int64, c.POINTER(c.c_int64),
    ]
    lib.ms_watch_cancel.restype = c.c_int
    lib.ms_watch_cancel.argtypes = [c.c_void_p, c.c_int64]
    lib.ms_watch_poll.restype = c.c_int
    lib.ms_watch_poll.argtypes = [
        c.c_void_p, c.c_int64, c.c_int, c.c_int,
        c.POINTER(P8), c.POINTER(c.c_size_t),
    ]
    lib.ms_watch_dropped.restype = c.c_int64
    lib.ms_watch_dropped.argtypes = [c.c_void_p, c.c_int64]
    lib.ms_watch_pending.restype = c.c_int64
    lib.ms_watch_pending.argtypes = [c.c_void_p, c.c_int64]
    lib.ms_put_batch.restype = c.c_int64
    lib.ms_put_batch.argtypes = [
        c.c_void_p, c.c_char_p, c.c_size_t, c.c_int, c.c_int64,
    ]
    lib.ms_bind_batch.restype = c.c_int
    lib.ms_bind_batch.argtypes = [
        c.c_void_p, c.c_char_p, c.c_size_t, c.c_int, c.c_int64,
        c.POINTER(c.POINTER(c.c_int64)),
    ]
    lib.ms_watch_poll_pods.restype = c.c_int
    lib.ms_watch_poll_pods.argtypes = [
        c.c_void_p, c.c_int64, c.c_int, c.c_char_p, c.c_size_t,
        c.POINTER(P8), c.POINTER(c.c_size_t),
    ]
    lib.ms_parse_pod_events.restype = c.c_int
    lib.ms_parse_pod_events.argtypes = [
        c.c_char_p, c.c_size_t, c.c_int, c.c_char_p, c.c_size_t,
        c.POINTER(P8), c.POINTER(c.c_size_t),
    ]
    lib.ms_stats_json.restype = c.c_int
    lib.ms_stats_json.argtypes = [c.c_void_p, c.POINTER(P8), c.POINTER(c.c_size_t)]
    lib.ms_wal_sync.restype = c.c_int
    lib.ms_wal_sync.argtypes = [c.c_void_p]
    lib.wf_start.restype = c.c_void_p
    lib.wf_start.argtypes = [c.c_void_p, c.c_char_p, c.c_int, c.c_int]
    lib.wf_port.restype = c.c_int
    lib.wf_port.argtypes = [c.c_void_p]
    lib.wf_stop.argtypes = [c.c_void_p]
    lib.wf_stress_put.restype = c.c_int64
    lib.wf_stress_put.argtypes = [
        c.c_char_p, c.c_int, c.c_int64, c.c_int, c.c_char_p, c.c_int64,
        c.c_int, c.POINTER(c.c_double),
    ]
    return lib


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        _LIB = _load_lib()
    return _LIB


def _take_buf(lib, pp, plen) -> bytes:
    if not pp:
        return b""
    data = ctypes.string_at(pp, plen.value)
    lib.ms_free(pp)
    return data


class Watcher:
    """Handle to one store watcher; poll() returns revision-ordered events."""

    def __init__(self, store: "MemStore", wid: int):
        self._store = store
        self.id = wid
        self.canceled = False

    def poll(self, max_events: int = 1000, timeout_ms: int = 0) -> list[WatchEvent]:
        lib = _lib()
        out = ctypes.POINTER(ctypes.c_uint8)()
        out_len = ctypes.c_size_t()
        n = lib.ms_watch_poll(
            self._store._h, self.id, max_events, timeout_ms,
            ctypes.byref(out), ctypes.byref(out_len),
        )
        if n == _ERR_NOT_FOUND:
            self.canceled = True
            return []
        buf = memoryview(_take_buf(lib, out, out_len))
        (n_events,) = _U32.unpack_from(buf, 0)
        if buf[4]:
            self.canceled = True
        off = 5
        events = []
        for _ in range(n_events):
            etype, has_prev = buf[off], buf[off + 1]
            off += 2
            kv, off = _parse_kv(buf, off)
            prev = None
            if has_prev:
                prev, off = _parse_kv(buf, off)
            events.append(WatchEvent("DELETE" if etype else "PUT", kv, prev))
        return events

    def poll_light(
        self, max_events: int = 1000, timeout_ms: int = 0
    ) -> list[tuple[int, bytes, bytes, int]]:
        """Like poll(), but returns ``(type, key, value, mod_revision)``
        tuples (type 0=PUT, 1=DELETE) and skips prev-kv parsing — the
        coordinator's firehose path, where per-event dataclass
        construction is measurable at 100K events/s."""
        lib = _lib()
        out = ctypes.POINTER(ctypes.c_uint8)()
        out_len = ctypes.c_size_t()
        n = lib.ms_watch_poll(
            self._store._h, self.id, max_events, timeout_ms,
            ctypes.byref(out), ctypes.byref(out_len),
        )
        if n == _ERR_NOT_FOUND:
            self.canceled = True
            return []
        data = _take_buf(lib, out, out_len)
        if data[4]:
            self.canceled = True
        (n_events,) = _U32.unpack_from(data, 0)
        off = 5
        events = []
        unpack = _KV_FIXED.unpack_from
        size = _KV_FIXED.size
        for _ in range(n_events):
            etype, has_prev = data[off], data[off + 1]
            off += 2
            klen, vlen, _crev, mrev, _ver, _lease = unpack(data, off)
            off += size
            key = data[off : off + klen]; off += klen
            val = data[off : off + vlen]; off += vlen
            if has_prev:
                pklen, pvlen = _U32X2.unpack_from(data, off)
                off += size + pklen + pvlen
            events.append((etype, key, val, mrev))
        return events

    def poll_pods(
        self, max_events: int = 10000, scheduler_name: bytes = b""
    ) -> "PodEventBatch":
        """Native drain + canonical-pod parse (ms_watch_poll_pods): the
        coordinator's intake firehose comes back as columnar numpy arrays
        instead of per-event Python objects — ~6x less host time per
        event than poll_light + decode_pod_fast."""
        lib = _lib()
        out = ctypes.POINTER(ctypes.c_uint8)()
        out_len = ctypes.c_size_t()
        rc = lib.ms_watch_poll_pods(
            self._store._h, self.id, max_events,
            scheduler_name, len(scheduler_name),
            ctypes.byref(out), ctypes.byref(out_len),
        )
        if rc == _ERR_NOT_FOUND:
            self.canceled = True
            return PodEventBatch.empty()
        data = _take_buf(lib, out, out_len)
        evb = PodEventBatch.parse(data)
        if evb.canceled:
            self.canceled = True
        return evb

    @property
    def dropped(self) -> int:
        return _lib().ms_watch_dropped(self._store._h, self.id)

    @property
    def pending(self) -> int:
        """Queued-event count, without consuming anything."""
        return max(0, _lib().ms_watch_pending(self._store._h, self.id))

    def cancel(self) -> None:
        if not self.canceled:
            _lib().ms_watch_cancel(self._store._h, self.id)
            self.canceled = True


_POD_EV_REC = struct.Struct("<bqII")    # etype, mod_revision, klen, vlen


def parse_pod_events(events, scheduler_name: bytes = b"") -> PodEventBatch:
    """Run the native canonical-pod parser over already-received events
    (``(etype, key, value, mod_revision)`` tuples, e.g. a RemoteWatcher's
    buffered wire events) — the store-independent half of ``poll_pods``,
    so the wire topology gets the same columnar lane as the in-process
    store."""
    lib = _lib()
    parts = []
    pack = _POD_EV_REC.pack
    n = 0
    for etype, key, value, mrev in events:
        v = value or b""
        parts.append(pack(etype, mrev, len(key), len(v)))
        parts.append(key)
        parts.append(v)
        n += 1
    frame = b"".join(parts)
    out = ctypes.POINTER(ctypes.c_uint8)()
    out_len = ctypes.c_size_t()
    rc = lib.ms_parse_pod_events(
        frame, len(frame), n, scheduler_name, len(scheduler_name),
        ctypes.byref(out), ctypes.byref(out_len),
    )
    if rc < 0:
        raise ValueError(f"ms_parse_pod_events rc={rc}")
    return PodEventBatch.parse(_take_buf(lib, out, out_len))


def list_prefix(
    store, prefix: bytes, *, page: int = 5000, keys_only: bool = False,
    revision: int = 0,
):
    """Consistent paginated list of a prefix: (kvs, revision).

    The first page pins the snapshot revision and every later page reads
    at it (etcd's paginated-list contract; kube reflectors depend on it
    for the list+watch handoff).  Unpaginated lists break the WIRE
    topology outright: a gRPC response carrying 1M nodes is ~350MB,
    far over any sane message cap — the reference's controllers never
    list unpaginated either (client-go chunks at 500).
    Restarts the scan from the current revision if the pinned revision
    is compacted mid-scan (the reflector-on-410-Gone rule), up to 3
    attempts.

    ``revision`` > 0 pins the whole list at a caller-chosen revision; a
    pinned list that hits compaction raises instead of restarting.
    """
    for _ in range(3):
        start, end = prefix, prefix_end(prefix)
        out: list = []
        rev = revision
        try:
            while True:
                res = store.range(
                    start, end, limit=page, keys_only=keys_only, revision=rev
                )
                if rev == 0:
                    rev = res.revision
                out.extend(res.kvs)
                if not res.more or not res.kvs:
                    return out, rev
                start = res.kvs[-1].key + b"\x00"
        except CompactedError:
            if revision:
                raise
            _RELIST_COMPACTED.inc()
            continue
    raise CompactedError()


def list_prefix_values(store, prefix: bytes, *, page: int = 5000):
    """Values-only ``list_prefix``: ``(values, revision)`` with the
    same pinned-snapshot pagination contract, skipping per-KV object
    construction entirely (``MemStore.range_values``).  The megarow
    cold relist reads a million stored Nodes whose names live in the
    objects — building a million KeyValue dataclasses plus key bytes
    just to drop them was a measured slice of the cold-build wall.
    Falls back to ``list_prefix`` for stores without the light parse
    (remote wire clients)."""
    rv = getattr(store, "range_values", None)
    if rv is None:
        kvs, rev = list_prefix(store, prefix, page=page)
        return [kv.value for kv in kvs], rev
    for _ in range(3):
        start, end = prefix, prefix_end(prefix)
        out: list = []
        rev = 0
        try:
            while True:
                r, more, vals, last = rv(
                    start, end, limit=page, revision=rev
                )
                if rev == 0:
                    rev = r
                out.extend(vals)
                if not more or not vals:
                    return out, rev
                start = last + b"\x00"
        except CompactedError:
            _RELIST_COMPACTED.inc()
            continue
    raise CompactedError()


def list_prefix_sharded(store, prefix: bytes, *, shards: int = 8, page: int = 5000,
                        values_only: bool = False):
    """``list_prefix`` with the value fetch fanned out over key-range
    shards: one keys-only paginated pass pins the snapshot revision and
    yields the shard bounds, then ``shards`` concurrent range scans pull
    the values at that revision.  Returns ``(kvs, revision)`` with the kvs
    in key order — byte-identical to ``list_prefix`` — or, with
    ``values_only``, ``(values, revision)`` through the store's light
    parse (``range_items``/``range_values``: no KeyValue per entry, which
    over the wire at 1M objects is most of a relist).

    The cold-relist shape for WIRE stores, where the per-page round trip
    and the decode overlap across shards.  For the in-process MemStore the
    parse holds the GIL and sharding buys nothing: the coordinator picks
    per store type (``Coordinator._relist_nodes``).  A pin that falls out
    of the store's window mid-fetch re-pins and restarts (the
    reflector-on-410 rule), up to 3 attempts."""
    if shards <= 1:
        if values_only:
            return list_prefix_values(store, prefix, page=page)
        return list_prefix(store, prefix, page=page)
    from concurrent.futures import ThreadPoolExecutor

    def page_of(start, end, rev):
        """One page of the shard [start, end): (entries, more, next start)."""
        if values_only:
            _r, more, vals, last = store.range_values(start, end, limit=page, revision=rev)
            return vals, more, (last or b"") + b"\x00"
        res = store.range(start, end, limit=page, revision=rev)
        return res.kvs, res.more, (res.kvs[-1].key if res.kvs else b"") + b"\x00"

    for _ in range(3):
        try:
            if values_only:
                rev = store.range_items(prefix, prefix_end(prefix), limit=1, keys_only=True)[0]
                keys = list_prefix_items(store, prefix, revision=rev, keys_only=True, page=page)
            else:
                kvs, rev = list_prefix(store, prefix, page=page, keys_only=True)
                keys = [kv.key for kv in kvs]
        except CompactedError:
            _RELIST_COMPACTED.inc()
            continue
        n = len(keys)
        if n == 0:
            return [], rev
        nshards = min(shards, n)
        bounds = [keys[i * n // nshards] for i in range(nshards)] + [prefix_end(prefix)]

        def fetch(i: int) -> list:
            out: list = []
            start = bounds[i]
            while True:
                got, more, start = page_of(start, bounds[i + 1], rev)
                out.extend(got)
                if not more or not got:
                    return out

        try:
            with ThreadPoolExecutor(nshards) as ex:
                parts = list(ex.map(fetch, range(nshards)))
        except CompactedError:
            _RELIST_COMPACTED.inc()
            continue
        return [x for part in parts for x in part], rev
    raise CompactedError()


def list_prefix_items(store, prefix: bytes, *, revision: int = 0, keys_only: bool = False,
                      page: int = 5000) -> list:
    """A prefix's ``(key, value)`` pairs (bare keys with ``keys_only``),
    every page read at one revision (``revision``, or the first page's when
    0) — ``list_prefix`` without the per-KV objects
    (``MemStore.range_items``).  A pinned revision outside the store's
    window raises ``CompactedError``/``FutureRevError``.  Falls back to
    ``list_prefix`` for stores without the light parse."""
    ri = getattr(store, "range_items", None)
    if ri is None:
        kvs, _ = list_prefix(store, prefix, page=page, keys_only=keys_only, revision=revision)
        return [kv.key if keys_only else (kv.key, kv.value) for kv in kvs]
    start, end = prefix, prefix_end(prefix)
    out: list = []
    rev = revision
    while True:
        r, more, items = ri(start, end, limit=page, revision=rev, keys_only=keys_only)
        rev = rev or r
        out.extend(items)
        if not more or not items:
            return out
        start = (items[-1] if keys_only else items[-1][0]) + b"\x00"


def scan_prefix(store, prefix: bytes, *, page: int = 5000, keys_only: bool = False):
    """Streaming paginated scan of a prefix, yielding ``(key, value)`` pairs
    (bare keys with ``keys_only``) through the store's light parse
    (``range_items``: no KeyValue per entry, which at 1M objects over the
    wire is most of the scan).  Deliberately UNPINNED: each page reads the
    latest revision, so a long scan over a live cluster sees a moving
    snapshot but never hits ``CompactedError`` midway (a generator cannot
    restart after it has yielded).  The verification tools want such a
    scan; the list+watch handoff wants ``list_prefix``'s pinned one."""
    start, end = prefix, prefix_end(prefix)
    while True:
        _rev, more, items = store.range_items(start, end, limit=page, keys_only=keys_only)
        yield from items
        if not more or not items:
            return
        start = (items[-1] if keys_only else items[-1][0]) + b"\x00"


def drain_events(watcher, batch: int = 10000, limit: int = 200_000):
    """Yield ``WatchEvent``s from a watcher (in-process or remote) until its
    queue momentarily empties or ``limit`` events have been yielded (a
    liveness bound for tick-driven consumers: the remainder stays queued
    for the next tick)."""
    seen = 0
    while True:
        evs = watcher.poll(batch)
        yield from evs
        seen += len(evs)
        if len(evs) < batch or seen >= limit:
            return


def drain_events_light(watcher, batch: int = 10000, limit: int = 200_000):
    """Yield ``(type, key, value, mod_revision)`` tuples (type 0=PUT,
    1=DELETE) from a watcher until its queue momentarily empties or
    ``limit`` events have been yielded (a liveness bound: the remainder
    stays queued for the next cycle)."""
    poll = watcher.poll_light
    seen = 0
    while True:
        evs = poll(batch)
        yield from evs
        seen += len(evs)
        if len(evs) < batch or seen >= limit:
            return


class MemStore:
    """In-process native store with etcd semantics.

    ``wal_dir=None`` disables the write-ahead log (the coordinator's own
    store lives and dies with its process); ``wal_mode`` in {none,
    buffered, fsync} mirrors the reference's ``--wal-default`` (reference
    main.rs:60-81); ``no_write_prefixes`` skips the log for hot
    non-durable prefixes like ``/registry/leases/`` (reference
    ``--wal-no-write-prefix``)."""

    def __init__(
        self,
        wal_dir: str | None = None,
        wal_mode: str = "buffered",
        no_write_prefixes: tuple[str, ...] = (),
    ):
        nwp = "\n".join(no_write_prefixes).encode()
        self._h = _lib().ms_open(
            wal_dir.encode() if wal_dir else None, _WAL_MODES[wal_mode], nwp
        )
        if not self._h:
            raise RuntimeError("ms_open failed")

    def close(self) -> None:
        if self._h:
            _lib().ms_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ---- writes --------------------------------------------------------

    def _set(
        self,
        key: bytes,
        value: bytes | None,
        has_req: bool,
        req_is_version: bool,
        req_val: int,
        lease: int,
    ):
        lib = _lib()
        latest = ctypes.c_int64()
        cur = ctypes.POINTER(ctypes.c_uint8)()
        cur_len = ctypes.c_size_t()
        rev = lib.ms_set(
            self._h, key, len(key),
            value, 0 if value is None else len(value),
            1 if has_req else 0, 1 if req_is_version else 0, req_val, lease,
            ctypes.byref(latest), ctypes.byref(cur), ctypes.byref(cur_len),
        )
        if rev == _ERR_CAS:
            cur_kv = None
            if cur:
                data = _take_buf(lib, cur, cur_len)
                cur_kv, _ = _parse_kv(memoryview(data), 0)
            return False, latest.value, cur_kv
        return True, rev, None

    def put(self, key: bytes, value: bytes, lease: int = 0) -> int:
        ok, rev, _ = self._set(key, value, False, False, 0, lease)
        assert ok
        return rev

    def delete(self, key: bytes) -> tuple[int, bool]:
        """Returns (revision, deleted); the revision is 0 when nothing existed."""
        _ok, rev, _ = self._set(key, None, False, False, 0, 0)
        return rev, rev > 0

    def put_batch(
        self,
        items: list[tuple[bytes, bytes | None]],
        lease: int = 0,
    ) -> int:
        """Apply a wave of puts/deletes (value None = delete) in one native
        call under one lock acquisition; returns the last revision."""
        rev = self.put_frame(pack_put_frame(items), len(items), lease)
        if rev < 0:
            raise ValueError(f"ms_put_batch rc={rev}")
        return rev

    def put_frame(self, frame: bytes, count: int, lease: int = 0) -> int:
        """put_batch over a pre-packed frame (see pack_put_frame) — the
        wire batch path hands a client-packed frame straight through so
        the serving core does zero per-item Python.  Returns the last
        revision, or a negative MS_ERR_* code for a malformed frame (the
        native side bounds-checks every record)."""
        return _lib().ms_put_batch(self._h, frame, len(frame), count, lease)

    def bind_batch(
        self, binds: list[tuple[bytes, int, bytes]],
        exclude_watcher: int = -1,
    ) -> list[int]:
        """Splice spec.nodeName into stored pods under mod-revision CAS —
        the whole bind wave in one native call.  ``binds`` entries are
        (key, required_mod, node_name); returns per-entry new revision,
        or _ERR_CAS / _ERR_INVALID (caller falls back to the slow path).
        ``exclude_watcher`` suppresses the bind events on that one watcher
        (the issuing coordinator's own intake — see memstore.h)."""
        rc, results = self.bind_frame(
            pack_bind_frame(binds), len(binds), exclude_watcher
        )
        if rc < 0:
            raise ValueError(f"ms_bind_batch rc={rc}")
        return results

    def bind_frame(
        self, frame: bytes, count: int, exclude_watcher: int = -1
    ) -> tuple[int, list[int]]:
        """bind_batch over a pre-packed frame (see pack_bind_frame).
        Returns (bound_count_or_negative_error, per_record_revisions)."""
        lib = _lib()
        out = ctypes.POINTER(ctypes.c_int64)()
        rc = lib.ms_bind_batch(
            self._h, frame, len(frame), count, exclude_watcher,
            ctypes.byref(out)
        )
        if rc < 0:
            return rc, []
        results = out[:count]
        lib.ms_free(out)
        return rc, results

    def cas(
        self,
        key: bytes,
        value: bytes | None,
        *,
        required_mod: int | None = None,
        required_version: int | None = None,
        lease: int = 0,
    ) -> tuple[bool, int, KeyValue | None]:
        """Txn-style compare-and-set: exactly the one Txn shape Kubernetes
        emits (reference kv_service.rs:126-337).  value=None deletes.
        Returns (ok, revision, current_kv_on_failure)."""
        if (required_mod is None) == (required_version is None):
            raise ValueError("exactly one of required_mod/required_version")
        is_ver = required_version is not None
        req = required_version if is_ver else required_mod
        return self._set(key, value, True, is_ver, req, lease)

    # ---- reads ---------------------------------------------------------

    def range(
        self,
        start: bytes,
        end: bytes | None = None,
        *,
        revision: int = 0,
        limit: int = 0,
        count_only: bool = False,
        keys_only: bool = False,
    ) -> RangeResult:
        lib = _lib()
        out = ctypes.POINTER(ctypes.c_uint8)()
        out_len = ctypes.c_size_t()
        rc = lib.ms_range(
            self._h, start, len(start),
            end, 0 if end is None else len(end),
            revision, limit, 1 if count_only else 0, 1 if keys_only else 0,
            ctypes.byref(out), ctypes.byref(out_len),
        )
        if rc == _ERR_COMPACTED:
            raise CompactedError(self.compact_revision)
        if rc == _ERR_FUTURE_REV:
            raise FutureRevError(f"revision {revision} > current")
        data = _take_buf(lib, out, out_len)
        buf = memoryview(data)
        rev, count, n, more = struct.unpack_from("<qqIB", buf, 0)
        off = 21
        kvs = []
        for _ in range(n):
            kv, off = _parse_kv(buf, off)
            kvs.append(kv)
        return RangeResult(rev, count, bool(more), kvs)

    def range_values(
        self,
        start: bytes,
        end: bytes | None = None,
        *,
        revision: int = 0,
        limit: int = 0,
    ) -> tuple[int, bool, list, bytes | None]:
        """``range`` minus everything but the value bytes: returns
        ``(revision, more, values, last_key)`` (``last_key`` feeds the
        pagination cursor).  Same wire frame, light parse — the per-KV
        KeyValue/key-bytes construction that dominates a million-row
        relist in Python is skipped (the range_light counterpart of
        poll_light)."""
        lib = _lib()
        out = ctypes.POINTER(ctypes.c_uint8)()
        out_len = ctypes.c_size_t()
        rc = lib.ms_range(
            self._h, start, len(start),
            end, 0 if end is None else len(end),
            revision, limit, 0, 0,
            ctypes.byref(out), ctypes.byref(out_len),
        )
        if rc == _ERR_COMPACTED:
            raise CompactedError(self.compact_revision)
        if rc == _ERR_FUTURE_REV:
            raise FutureRevError(f"revision {revision} > current")
        data = _take_buf(lib, out, out_len)
        buf = memoryview(data)
        rev, _count, n, more = struct.unpack_from("<qqIB", buf, 0)
        off = 21
        values: list = []
        unpack = _KV_FIXED.unpack_from
        fixed = _KV_FIXED.size
        kend = klen = 0
        for _ in range(n):
            klen, vlen = unpack(buf, off)[:2]
            kend = off + fixed + klen
            off = kend + vlen
            values.append(bytes(buf[kend:off]))
        last_key = bytes(buf[kend - klen:kend]) if n else None
        return rev, bool(more), values, last_key

    def range_items(
        self,
        start: bytes,
        end: bytes | None = None,
        *,
        revision: int = 0,
        limit: int = 0,
        keys_only: bool = False,
    ) -> tuple[int, bool, list]:
        """``range`` minus the KeyValue construction: returns ``(revision,
        more, items)`` with ``(key, value)`` pairs, or bare keys with
        ``keys_only`` — the light parse for audits that read only names
        and bytes."""
        lib = _lib()
        out = ctypes.POINTER(ctypes.c_uint8)()
        out_len = ctypes.c_size_t()
        rc = lib.ms_range(
            self._h, start, len(start),
            end, 0 if end is None else len(end),
            revision, limit, 0, 1 if keys_only else 0,
            ctypes.byref(out), ctypes.byref(out_len),
        )
        if rc == _ERR_COMPACTED:
            raise CompactedError(self.compact_revision)
        if rc == _ERR_FUTURE_REV:
            raise FutureRevError(f"revision {revision} > current")
        data = _take_buf(lib, out, out_len)
        buf = memoryview(data)
        rev, _count, n, more = struct.unpack_from("<qqIB", buf, 0)
        off = 21
        items: list = []
        unpack = _KV_FIXED.unpack_from
        fixed = _KV_FIXED.size
        for _ in range(n):
            klen, vlen = unpack(buf, off)[:2]
            kend = off + fixed + klen
            off = kend + vlen
            key = bytes(buf[kend - klen:kend])
            items.append(key if keys_only else (key, bytes(buf[kend:off])))
        return rev, bool(more), items

    def get(self, key: bytes, revision: int = 0) -> KeyValue | None:
        res = self.range(key, revision=revision)
        return res.kvs[0] if res.kvs else None

    # ---- watch ---------------------------------------------------------

    def watch(
        self,
        start: bytes,
        end: bytes | None = None,
        *,
        start_revision: int = 0,
        prev_kv: bool = False,
        queue_cap: int = 0,
    ) -> Watcher:
        """``queue_cap=0`` keeps the reference's 10K default (store.rs:27);
        tick-driven consumers that drain per cycle rather than
        continuously pass a deep cap so bursty churn between cycles
        doesn't overflow into a forced resync."""
        lib = _lib()
        compact = ctypes.c_int64()
        wid = lib.ms_watch_create(
            self._h, start, len(start),
            end, 0 if end is None else len(end),
            start_revision, 1 if prev_kv else 0, queue_cap,
            ctypes.byref(compact),
        )
        if wid == _ERR_COMPACTED:
            raise CompactedError(compact.value)
        return Watcher(self, wid)

    # ---- maintenance ---------------------------------------------------

    def compact(self, revision: int) -> None:
        rc = _lib().ms_compact(self._h, revision)
        if rc == _ERR_COMPACTED:
            raise CompactedError(self.compact_revision)
        if rc == _ERR_FUTURE_REV:
            raise FutureRevError(f"compact {revision} > current")

    def wal_sync(self) -> None:
        if _lib().ms_wal_sync(self._h) != 0:
            raise OSError("WAL sync failed")

    def stats(self) -> dict:
        """The native store's counters (``ms_stats_json``: lock cells by
        method, structure and rw; watch pressure; sizes)."""
        lib = _lib()
        out = ctypes.POINTER(ctypes.c_uint8)()
        out_len = ctypes.c_size_t()
        lib.ms_stats_json(self._h, ctypes.byref(out), ctypes.byref(out_len))
        return json.loads(_take_buf(lib, out, out_len))

    @property
    def current_revision(self) -> int:
        return _lib().ms_current_revision(self._h)

    @property
    def compact_revision(self) -> int:
        return _lib().ms_compact_revision(self._h)

    @property
    def progress_revision(self) -> int:
        """The revision through which every watcher queue has been filled
        (the watch stream's progress barrier reads it)."""
        return _lib().ms_progress_revision(self._h)

    @property
    def num_keys(self) -> int:
        return _lib().ms_num_keys(self._h)

    @property
    def db_size(self) -> int:
        return _lib().ms_db_size(self._h)


class WireFront:
    """The native etcd-wire server over an in-process ``MemStore``:
    hand-rolled HTTP/2 + HPACK + the etcd protobuf subset in C++
    (``native/wirefront/wirefront.cc``), dispatching straight into the
    store on its event-loop threads.  Serves KV, Watch, Lease,
    Maintenance.Status and the k8s1m.BatchKV extension.  ``port=0`` binds
    a free port; ``self.port`` is the one bound."""

    def __init__(self, store: MemStore, host: str = "127.0.0.1",
                 port: int = 0, threads: int = 1):
        self._h = _lib().wf_start(store._h, host.encode(), port, threads)
        if not self._h:
            raise RuntimeError(f"wf_start failed for {host}:{port}")
        self.port = _lib().wf_port(self._h)

    def close(self) -> None:
        if self._h:
            _lib().wf_stop(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def wire_stress_put(host: str, port: int, count: int, concurrency: int = 64,
                    prefix: str = "/registry/leases/stress/", key_count: int = 10000,
                    val_len: int = 256) -> tuple[int, float]:
    """Pipelined per-RPC Put load from the native client
    (``wf_stress_put``, ``native/wirefront``) over the standard etcd wire:
    ``concurrency`` requests in flight on one connection, keys cycled over
    ``key_count``.  Returns (completed puts, elapsed seconds).  The client
    is C++ because a Python client saturates one core long before the
    server does."""
    elapsed = ctypes.c_double()
    n = _lib().wf_stress_put(
        host.encode(), port, count, concurrency, prefix.encode(), key_count,
        val_len, ctypes.byref(elapsed),
    )
    if n < 0:
        raise RuntimeError(f"wf_stress_put failed rc={n}")
    return int(n), float(elapsed.value)
