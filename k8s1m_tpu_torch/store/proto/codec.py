"""Hand codec for the etcd v3 protobuf subset the port's wire speaks.

The schema of record is the ``.proto`` files beside this module (copies of
the JAX package's ``k8s1m_tpu/store/proto/``).  The port runs where no
``protobuf`` package is installed, so each message the client or the
asyncio server (``store/etcd_server.py``) sends or reads is declared here by
its field numbers and encoded and decoded by hand, with protobuf's proto3
rules:

- fields go out in field-number order; a scalar at its zero value (0,
  ``b""``, ``""``, ``False``) is omitted, while a member of a ``oneof`` and
  a message field are sent whenever they are set (not ``None``), empty or
  zero alike;
- repeated varint fields are packed, and the decoder takes them packed or
  not;
- unknown fields are skipped by wire type, as protobuf does.

Messages are small classes with one attribute per field, named as in the
``.proto`` files.  ``encode()`` returns the wire bytes, ``Cls.decode(b)``
parses them.  Two light parsers serve the hot paths without building a
message per entry: ``parse_range`` (a relist page's keys and values) and
``parse_watch_response`` (a watch batch's events as tuples).
"""

from __future__ import annotations

import collections

_MASK64 = (1 << 64) - 1
_VARINT_KINDS = frozenset(("int64", "uint64", "int32", "uint32", "bool", "enum"))
_DEFAULTS = {"bytes": b"", "string": "", "bool": False}


class DecodeError(ValueError):
    """Malformed protobuf bytes (truncated field, bad wire type)."""


# ---- varints -------------------------------------------------------------------


def put_varint(out: bytearray, v: int) -> None:
    """Append ``v`` as a base-128 varint (negative numbers as their 64-bit
    two's complement, ten bytes, as protobuf sends int32 and int64)."""
    v &= _MASK64
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)


def get_varint(buf, pos: int) -> tuple[int, int]:
    """(value, next position) of the varint at ``pos``."""
    try:
        b = buf[pos]
        if b < 0x80:
            return b, pos + 1
        result = b & 0x7F
        shift = 7
        pos += 1
        while True:
            b = buf[pos]
            result |= (b & 0x7F) << shift
            pos += 1
            if b < 0x80:
                return result, pos
            shift += 7
            if shift >= 70:
                raise DecodeError("varint longer than 10 bytes")
    except IndexError:
        raise DecodeError("truncated varint") from None


def _signed(kind: str, v: int) -> int:
    if kind == "int64" or kind == "enum":
        return v - (1 << 64) if v >= 1 << 63 else v
    if kind == "int32":
        v &= 0xFFFFFFFF
        return v - (1 << 32) if v >= 1 << 31 else v
    if kind == "uint32":
        return v & 0xFFFFFFFF
    if kind == "bool":
        return v != 0
    return v


def _put_len(out: bytearray, num: int, body) -> None:
    put_varint(out, (num << 3) | 2)
    put_varint(out, len(body))
    out += body


def _skip(buf, pos: int, wt: int, end: int) -> int:
    if wt == 0:
        return get_varint(buf, pos)[1]
    if wt == 2:
        n, pos = get_varint(buf, pos)
        pos += n
    elif wt == 1:
        pos += 8
    elif wt == 5:
        pos += 4
    else:
        raise DecodeError(f"unsupported wire type {wt}")
    if pos > end:
        raise DecodeError("truncated field")
    return pos


# ---- messages ------------------------------------------------------------------

Field = collections.namedtuple("Field", "num name kind sub repeated presence oneof")


def _f(num, name, kind, sub=None, *, repeated=False, oneof=None) -> Field:
    """A field; ``oneof`` names its oneof group (members have presence)."""
    return Field(num, name, kind, sub, repeated, bool(oneof) or kind == "msg", oneof)


class Message:
    """A protobuf message: one attribute per field (see the module doc)."""

    __slots__ = ()
    FIELDS: tuple = ()
    _BY_NUM: dict = {}
    _BY_NAME: dict = {}

    def __init__(self, **kw):
        for f in self.FIELDS:
            if f.repeated:
                v = []
            elif f.presence:
                v = None
            else:
                v = _DEFAULTS.get(f.kind, 0)
            object.__setattr__(self, f.name, v)
        for k, v in kw.items():
            if k not in self._BY_NAME:
                raise TypeError(f"{type(self).__name__} has no field {k!r}")
            setattr(self, k, list(v) if self._BY_NAME[k].repeated else v)

    def __eq__(self, other):
        return type(self) is type(other) and all(
            getattr(self, f.name) == getattr(other, f.name) for f in self.FIELDS)

    def __repr__(self):
        set_ = ", ".join(f"{f.name}={getattr(self, f.name)!r}" for f in self.FIELDS
                         if getattr(self, f.name) not in (None, [], 0, b"", "", False))
        return f"{type(self).__name__}({set_})"

    def which_oneof(self, group: str) -> str | None:
        """The name of the member of oneof ``group`` that is set, or None
        (the generated modules' ``WhichOneof``)."""
        for f in self.FIELDS:
            if f.oneof == group and getattr(self, f.name) is not None:
                return f.name
        return None

    def encode(self) -> bytes:
        out = bytearray()
        self._encode_into(out)
        return bytes(out)

    def _encode_into(self, out: bytearray) -> None:
        for f in self.FIELDS:
            v = getattr(self, f.name)
            if f.repeated:
                if not v:
                    continue
                if f.kind == "msg":
                    for m in v:
                        _put_len(out, f.num, m.encode())
                elif f.kind in ("bytes", "string"):
                    for x in v:
                        _put_len(out, f.num, x.encode() if f.kind == "string" else x)
                else:
                    body = bytearray()
                    for x in v:
                        put_varint(body, int(x))
                    _put_len(out, f.num, body)
                continue
            if v is None or (not f.presence and not v):
                continue
            if f.kind == "msg":
                _put_len(out, f.num, v.encode())
            elif f.kind == "bytes":
                _put_len(out, f.num, v)
            elif f.kind == "string":
                _put_len(out, f.num, v.encode())
            else:
                put_varint(out, f.num << 3)
                put_varint(out, int(v))

    @classmethod
    def decode(cls, data) -> "Message":
        return cls._decode(data, 0, len(data))

    @classmethod
    def _decode(cls, buf, pos: int, end: int) -> "Message":
        self = cls()
        by_num = cls._BY_NUM
        while pos < end:
            tag, pos = get_varint(buf, pos)
            num, wt = tag >> 3, tag & 7
            f = by_num.get(num)
            if f is None:
                pos = _skip(buf, pos, wt, end)
                continue
            if wt == 0 and f.kind in _VARINT_KINDS:
                v, pos = get_varint(buf, pos)
                v = _signed(f.kind, v)
            elif wt == 2 and f.kind not in _VARINT_KINDS:
                n, pos = get_varint(buf, pos)
                start, pos = pos, pos + n
                if pos > end:
                    raise DecodeError(f"{cls.__name__}.{f.name}: truncated")
                if f.kind == "msg":
                    v = f.sub._decode(buf, start, pos)
                elif f.kind == "bytes":
                    v = bytes(buf[start:pos])
                else:
                    v = bytes(buf[start:pos]).decode("utf-8")
            elif wt == 2 and f.repeated:
                # A packed run of varints.
                n, pos = get_varint(buf, pos)
                p, pos = pos, pos + n
                if pos > end:
                    raise DecodeError(f"{cls.__name__}.{f.name}: truncated")
                vals = getattr(self, f.name)
                while p < pos:
                    x, p = get_varint(buf, p)
                    vals.append(_signed(f.kind, x))
                continue
            else:
                pos = _skip(buf, pos, wt, end)
                continue
            if f.repeated:
                getattr(self, f.name).append(v)
            else:
                if f.oneof:
                    # The last member of a oneof on the wire wins.
                    for g in cls.FIELDS:
                        if g.oneof == f.oneof:
                            object.__setattr__(self, g.name, None)
                object.__setattr__(self, f.name, v)
        if pos != end:
            raise DecodeError(f"{cls.__name__}: field runs past its message")
        return self


def _message(name: str, *fields: Field, **consts) -> type:
    cls = type(name, (Message,), {
        "__slots__": tuple(f.name for f in fields),
        "FIELDS": tuple(sorted(fields, key=lambda f: f.num)),
        "_BY_NUM": {f.num: f for f in fields},
        "_BY_NAME": {f.name: f for f in fields},
        "__module__": __name__,
        **consts,
    })
    return cls


# mvcc.proto
KeyValue = _message(
    "KeyValue", _f(1, "key", "bytes"), _f(2, "create_revision", "int64"),
    _f(3, "mod_revision", "int64"), _f(4, "version", "int64"), _f(5, "value", "bytes"),
    _f(6, "lease", "int64"))


def put_key_value(out: bytearray, kv) -> None:
    """Append the KeyValue message bytes of ``kv``: a ``KeyValue`` or
    anything with its six attributes (the store's own KeyValue).  The one
    encoder of its layout, written out by hand because a relist's
    RangeResponse holds one per node; ``KeyValue.encode`` goes through it."""
    if kv.key:
        out.append(0x0A)
        put_varint(out, len(kv.key))
        out += kv.key
    for tag, v in ((0x10, kv.create_revision), (0x18, kv.mod_revision), (0x20, kv.version)):
        if v:
            out.append(tag)
            put_varint(out, v)
    if kv.value:
        out.append(0x2A)
        put_varint(out, len(kv.value))
        out += kv.value
    if kv.lease:
        out.append(0x30)
        put_varint(out, kv.lease)


KeyValue._encode_into = lambda self, out: put_key_value(out, self)
Event = _message(
    "Event", _f(1, "type", "enum"), _f(2, "kv", "msg", KeyValue),
    _f(3, "prev_kv", "msg", KeyValue), PUT=0, DELETE=1)

# rpc.proto
ResponseHeader = _message(
    "ResponseHeader", _f(1, "cluster_id", "uint64"), _f(2, "member_id", "uint64"),
    _f(3, "revision", "int64"), _f(4, "raft_term", "uint64"))
RangeRequest = _message(
    "RangeRequest", _f(1, "key", "bytes"), _f(2, "range_end", "bytes"),
    _f(3, "limit", "int64"), _f(4, "revision", "int64"), _f(5, "sort_order", "enum"),
    _f(6, "sort_target", "enum"), _f(7, "serializable", "bool"),
    _f(8, "keys_only", "bool"), _f(9, "count_only", "bool"),
    _f(10, "min_mod_revision", "int64"), _f(11, "max_mod_revision", "int64"),
    _f(12, "min_create_revision", "int64"), _f(13, "max_create_revision", "int64"))
RangeResponse = _message(
    "RangeResponse", _f(1, "header", "msg", ResponseHeader),
    _f(2, "kvs", "msg", KeyValue, repeated=True), _f(3, "more", "bool"),
    _f(4, "count", "int64"))
PutRequest = _message(
    "PutRequest", _f(1, "key", "bytes"), _f(2, "value", "bytes"), _f(3, "lease", "int64"),
    _f(4, "prev_kv", "bool"), _f(5, "ignore_value", "bool"), _f(6, "ignore_lease", "bool"))
PutResponse = _message(
    "PutResponse", _f(1, "header", "msg", ResponseHeader), _f(2, "prev_kv", "msg", KeyValue))
DeleteRangeRequest = _message(
    "DeleteRangeRequest", _f(1, "key", "bytes"), _f(2, "range_end", "bytes"),
    _f(3, "prev_kv", "bool"))
DeleteRangeResponse = _message(
    "DeleteRangeResponse", _f(1, "header", "msg", ResponseHeader),
    _f(2, "deleted", "int64"), _f(3, "prev_kvs", "msg", KeyValue, repeated=True))
# RequestOp/ResponseOp: the oneof members the client uses (a nested Txn,
# field 4, is skipped like any unknown field).
RequestOp = _message(
    "RequestOp", _f(1, "request_range", "msg", RangeRequest, oneof="request"),
    _f(2, "request_put", "msg", PutRequest, oneof="request"),
    _f(3, "request_delete_range", "msg", DeleteRangeRequest, oneof="request"))
ResponseOp = _message(
    "ResponseOp", _f(1, "response_range", "msg", RangeResponse, oneof="response"),
    _f(2, "response_put", "msg", PutResponse, oneof="response"),
    _f(3, "response_delete_range", "msg", DeleteRangeResponse, oneof="response"))
Compare = _message(
    "Compare", _f(1, "result", "enum"), _f(2, "target", "enum"), _f(3, "key", "bytes"),
    _f(4, "version", "int64", oneof="target_union"),
    _f(5, "create_revision", "int64", oneof="target_union"),
    _f(6, "mod_revision", "int64", oneof="target_union"),
    _f(7, "value", "bytes", oneof="target_union"),
    _f(8, "lease", "int64", oneof="target_union"), _f(64, "range_end", "bytes"),
    EQUAL=0, GREATER=1, LESS=2, NOT_EQUAL=3,
    VERSION=0, CREATE=1, MOD=2, VALUE=3, LEASE=4)
TxnRequest = _message(
    "TxnRequest", _f(1, "compare", "msg", Compare, repeated=True),
    _f(2, "success", "msg", RequestOp, repeated=True),
    _f(3, "failure", "msg", RequestOp, repeated=True))
TxnResponse = _message(
    "TxnResponse", _f(1, "header", "msg", ResponseHeader), _f(2, "succeeded", "bool"),
    _f(3, "responses", "msg", ResponseOp, repeated=True))
CompactionRequest = _message(
    "CompactionRequest", _f(1, "revision", "int64"), _f(2, "physical", "bool"))
CompactionResponse = _message("CompactionResponse", _f(1, "header", "msg", ResponseHeader))
LeaseGrantRequest = _message(
    "LeaseGrantRequest", _f(1, "TTL", "int64"), _f(2, "ID", "int64"))
LeaseGrantResponse = _message(
    "LeaseGrantResponse", _f(1, "header", "msg", ResponseHeader), _f(2, "ID", "int64"),
    _f(3, "TTL", "int64"), _f(4, "error", "string"))
LeaseRevokeRequest = _message("LeaseRevokeRequest", _f(1, "ID", "int64"))
LeaseRevokeResponse = _message("LeaseRevokeResponse", _f(1, "header", "msg", ResponseHeader))
LeaseKeepAliveRequest = _message("LeaseKeepAliveRequest", _f(1, "ID", "int64"))
LeaseKeepAliveResponse = _message(
    "LeaseKeepAliveResponse", _f(1, "header", "msg", ResponseHeader), _f(2, "ID", "int64"),
    _f(3, "TTL", "int64"))
LeaseTimeToLiveRequest = _message(
    "LeaseTimeToLiveRequest", _f(1, "ID", "int64"), _f(2, "keys", "bool"))
LeaseTimeToLiveResponse = _message(
    "LeaseTimeToLiveResponse", _f(1, "header", "msg", ResponseHeader), _f(2, "ID", "int64"),
    _f(3, "TTL", "int64"), _f(4, "grantedTTL", "int64"),
    _f(5, "keys", "bytes", repeated=True))
LeaseLeasesRequest = _message("LeaseLeasesRequest")
LeaseStatus = _message("LeaseStatus", _f(1, "ID", "int64"))
LeaseLeasesResponse = _message(
    "LeaseLeasesResponse", _f(1, "header", "msg", ResponseHeader),
    _f(2, "leases", "msg", LeaseStatus, repeated=True))
AlarmRequest = _message(
    "AlarmRequest", _f(1, "action", "enum"), _f(2, "memberID", "uint64"),
    _f(3, "alarm", "enum"), GET=0, ACTIVATE=1, DEACTIVATE=2)
AlarmMember = _message("AlarmMember", _f(1, "memberID", "uint64"), _f(2, "alarm", "enum"))
AlarmResponse = _message(
    "AlarmResponse", _f(1, "header", "msg", ResponseHeader),
    _f(2, "alarms", "msg", AlarmMember, repeated=True))
DefragmentRequest = _message("DefragmentRequest")
DefragmentResponse = _message("DefragmentResponse", _f(1, "header", "msg", ResponseHeader))
HashRequest = _message("HashRequest")
HashResponse = _message(
    "HashResponse", _f(1, "header", "msg", ResponseHeader), _f(2, "hash", "uint32"))
SnapshotRequest = _message("SnapshotRequest")
SnapshotResponse = _message(
    "SnapshotResponse", _f(1, "header", "msg", ResponseHeader),
    _f(2, "remaining_bytes", "uint64"), _f(3, "blob", "bytes"))
MoveLeaderRequest = _message("MoveLeaderRequest", _f(1, "targetID", "uint64"))
MoveLeaderResponse = _message("MoveLeaderResponse", _f(1, "header", "msg", ResponseHeader))
StatusRequest = _message("StatusRequest")
StatusResponse = _message(
    "StatusResponse", _f(1, "header", "msg", ResponseHeader), _f(2, "version", "string"),
    _f(3, "dbSize", "int64"), _f(4, "leader", "uint64"), _f(5, "raftIndex", "uint64"),
    _f(6, "raftTerm", "uint64"), _f(7, "raftAppliedIndex", "uint64"),
    _f(8, "errors", "string", repeated=True), _f(9, "dbSizeInUse", "int64"),
    _f(10, "isLearner", "bool"))
WatchCreateRequest = _message(
    "WatchCreateRequest", _f(1, "key", "bytes"), _f(2, "range_end", "bytes"),
    _f(3, "start_revision", "int64"), _f(4, "progress_notify", "bool"),
    _f(5, "filters", "enum", repeated=True), _f(6, "prev_kv", "bool"),
    _f(7, "watch_id", "int64"), _f(8, "fragment", "bool"))
WatchCancelRequest = _message("WatchCancelRequest", _f(1, "watch_id", "int64"))
WatchProgressRequest = _message("WatchProgressRequest")
WatchRequest = _message(
    "WatchRequest", _f(1, "create_request", "msg", WatchCreateRequest, oneof="request_union"),
    _f(2, "cancel_request", "msg", WatchCancelRequest, oneof="request_union"),
    _f(3, "progress_request", "msg", WatchProgressRequest, oneof="request_union"))
WatchResponse = _message(
    "WatchResponse", _f(1, "header", "msg", ResponseHeader), _f(2, "watch_id", "int64"),
    _f(3, "created", "bool"), _f(4, "canceled", "bool"), _f(5, "compact_revision", "int64"),
    _f(6, "cancel_reason", "string"), _f(7, "fragment", "bool"),
    _f(11, "events", "msg", Event, repeated=True))

# batch.proto (k8s1m.BatchKV)
PutFrameRequest = _message(
    "PutFrameRequest", _f(1, "frame", "bytes"), _f(2, "count", "uint32"),
    _f(3, "lease", "int64"))
PutFrameResponse = _message("PutFrameResponse", _f(1, "revision", "int64"))
BindFrameRequest = _message(
    "BindFrameRequest", _f(1, "frame", "bytes"), _f(2, "count", "uint32"))
BindFrameResponse = _message(
    "BindFrameResponse", _f(1, "revisions", "int64", repeated=True), _f(2, "bound", "int32"))


# ---- light parsers -------------------------------------------------------------


def _kv_tuple(buf, pos: int, end: int) -> tuple:
    """A KeyValue's fields as ``(key, value, create_revision, mod_revision,
    version, lease)`` without building a message."""
    key = value = b""
    crev = mrev = ver = lease = 0
    while pos < end:
        tag = buf[pos]
        pos += 1
        if tag == 0x0A or tag == 0x2A:          # key (1), value (5)
            n = buf[pos]
            if n < 0x80:
                pos += 1
            else:
                n, pos = get_varint(buf, pos)
            s, pos = pos, pos + n
            if tag == 0x0A:
                key = bytes(buf[s:pos])
            else:
                value = bytes(buf[s:pos])
        elif tag in (0x10, 0x18, 0x20, 0x30):   # create, mod, version, lease
            v, pos = get_varint(buf, pos)
            if v >= 1 << 63:
                v -= 1 << 64
            if tag == 0x18:
                mrev = v
            elif tag == 0x10:
                crev = v
            elif tag == 0x20:
                ver = v
            else:
                lease = v
        else:
            if tag >= 0x80:
                tag, pos = get_varint(buf, pos - 1)
            pos = _skip(buf, pos, tag & 7, end)
    if pos != end:
        raise DecodeError("KeyValue: field runs past its message")
    return key, value, crev, mrev, ver, lease


def _header_revision(buf, pos: int, end: int) -> int:
    rev = 0
    while pos < end:
        tag, pos = get_varint(buf, pos)
        if tag == 0x18:
            rev, pos = get_varint(buf, pos)
            if rev >= 1 << 63:
                rev -= 1 << 64
        else:
            pos = _skip(buf, pos, tag & 7, end)
    return rev


def parse_range(data, *, keys: bool, values: bool) -> tuple[int, bool, int, list, bytes | None]:
    """A RangeResponse as ``(revision, more, count, entries, last_key)``
    without a KeyValue per entry: ``entries`` holds ``(key, value)`` pairs,
    or bare keys (``values=False``) or bare values (``keys=False``), each
    sliced straight out of ``data``; ``last_key`` is the last entry's key
    (``None`` for no entry), the pagination cursor."""
    buf = data
    end = len(buf)
    pos = 0
    rev = count = 0
    more = False
    out: list = []
    append = out.append
    kpos = klen = -1
    while pos < end:
        tag, pos = get_varint(buf, pos)
        if tag == 0x12:                          # kvs (2)
            n, pos = get_varint(buf, pos)
            p, kend = pos, pos + n
            pos = kend
            kpos = klen = vpos = 0
            vlen = 0
            # The KeyValue's key (1) and value (5): everything else skipped.
            while p < kend:
                t = buf[p]
                p += 1
                if t == 0x0A or t == 0x2A:
                    m = buf[p]
                    if m < 0x80:
                        p += 1
                    else:
                        m, p = get_varint(buf, p)
                    if t == 0x0A:
                        kpos, klen = p, m
                    else:
                        vpos, vlen = p, m
                    p += m
                elif t < 0x80 and t & 7 == 0:
                    while buf[p] >= 0x80:
                        p += 1
                    p += 1
                else:
                    if t >= 0x80:
                        t, p = get_varint(buf, p - 1)
                    p = _skip(buf, p, t & 7, kend)
            if p != kend:
                raise DecodeError("KeyValue: field runs past its message")
            if keys and values:
                append((buf[kpos:kpos + klen], buf[vpos:vpos + vlen]))
            elif keys:
                append(buf[kpos:kpos + klen])
            else:
                append(buf[vpos:vpos + vlen])
        elif tag == 0x0A:                        # header (1)
            n, pos = get_varint(buf, pos)
            rev = _header_revision(buf, pos, pos + n)
            pos += n
        elif tag == 0x18:                        # more (3)
            v, pos = get_varint(buf, pos)
            more = v != 0
        elif tag == 0x20:                        # count (4)
            count, pos = get_varint(buf, pos)
        else:
            pos = _skip(buf, pos, tag & 7, end)
    if pos != end:
        raise DecodeError("RangeResponse: field runs past its message")
    last_key = None if klen < 0 else bytes(buf[kpos:kpos + klen])
    return rev, more, count, out, last_key


class WatchBatch(collections.namedtuple(
        "WatchBatch", "revision watch_id created canceled compact_revision cancel_reason "
        "events")):
    """One WatchResponse.  ``events`` holds ``(etype, kv, prev_kv)`` with
    ``etype`` 0 PUT / 1 DELETE and each KeyValue a ``_kv_tuple`` (``prev_kv``
    ``None`` when the event carries none)."""


def parse_watch_response(data) -> WatchBatch:
    buf = data
    end = len(buf)
    pos = 0
    rev = wid = crev = 0
    created = canceled = False
    reason = ""
    events = []
    while pos < end:
        tag, pos = get_varint(buf, pos)
        if tag == 0x5A:                          # events (11)
            n, pos = get_varint(buf, pos)
            p, eend = pos, pos + n
            pos = eend
            etype, kv, prev = 0, None, None
            while p < eend:
                t, p = get_varint(buf, p)
                if t == 0x08:
                    etype, p = get_varint(buf, p)
                elif t == 0x12 or t == 0x1A:
                    m, p = get_varint(buf, p)
                    tup = _kv_tuple(buf, p, p + m)
                    p += m
                    if t == 0x12:
                        kv = tup
                    else:
                        prev = tup
                else:
                    p = _skip(buf, p, t & 7, eend)
            if kv is None:
                kv = (b"", b"", 0, 0, 0, 0)
            events.append((etype, kv, prev))
        elif tag == 0x0A:
            n, pos = get_varint(buf, pos)
            rev = _header_revision(buf, pos, pos + n)
            pos += n
        elif tag in (0x10, 0x18, 0x20, 0x28):
            v, pos = get_varint(buf, pos)
            if tag == 0x10:
                wid = v - (1 << 64) if v >= 1 << 63 else v
            elif tag == 0x18:
                created = v != 0
            elif tag == 0x20:
                canceled = v != 0
            else:
                crev = v
        elif tag == 0x32:
            n, pos = get_varint(buf, pos)
            reason = bytes(buf[pos:pos + n]).decode("utf-8", "replace")
            pos += n
        else:
            pos = _skip(buf, pos, tag & 7, end)
    if pos != end:
        raise DecodeError("WatchResponse: field runs past its message")
    return WatchBatch(rev, wid, created, canceled, crev, reason, events)


def count_watch_events(data) -> int:
    """The number of events (field 11) in a WatchResponse, nothing decoded."""
    end = len(data)
    pos = n = 0
    while pos < end:
        tag, pos = get_varint(data, pos)
        if tag == 0x5A:
            n += 1
        pos = _skip(data, pos, tag & 7, end)
    return n
