"""wiretier — shared-frame watch encoding + wire delta compaction (the
port's copy of ``k8s1m_tpu/store/wiretier.py``, on the hand codec
``store/proto/codec.py`` where the JAX module builds ``mvcc_pb2`` messages).

The watch tier's storm lane was encode-bound: every event batch was
proto-encoded once PER WATCH ID inside the fan-out pumps, so encode CPU
scaled with fan-out degree and the 100K-watch drill saturated one core
at ~4K delivered events/s.  The reference's mem_etcd wire discipline
(PAPER.md, state-store layer) encodes a frame once and fans the bytes
out — per-watch cost must scale with FRAMES, not with fan-out degree.

Three pieces, all byte-level:

- **Hand-composed WatchResponse framing** (``header_bytes`` /
  ``event_chunk`` / ``compose_frame``): protobuf serializes known
  fields in tag order, so a WatchResponse is exactly
  ``header-chunk + watch_id-varint + event-chunks`` — concatenating
  independently encoded parts is byte-identical to
  ``encode_event_batch(...).SerializeToString()``.  The differential in
  tests/test_torch_etcd_server.py holds that identity; it is the license
  for every sharing trick below (clients can't tell composed frames from
  constructor-built ones).

- **The shared-frame extension**: when several watch ids on one stream
  owe the SAME batch, the tier ships ONE frame addressed to the first
  id and rides the remaining ids in trailing private fields
  (``SHARED_WIDS_FIELD``/``SHARED_FROM_REV_FIELD`` — high-numbered, so
  stock etcd clients parse them as unknown fields and see a normal
  single-watch response).  Our mux clients expand the tail with
  ``native.decode_shared_tail`` — index selection over shared bytes,
  never a re-encode.  ``SHARED_FROM_REV_FIELD`` declares a compacted
  frame's window lower bound (latest-per-key over [from_rev, to_rev]);
  to_rev is the last event's mod_revision.

- **``FrameTable``**: a bounded encode-once cache of per-event chunk
  bytes, keyed by the event's monotone ``seq`` (watch-cache tier) or an
  identity tuple (store server), so an event crossing N streams/lanes
  still costs ONE proto encode tier-wide.  Chunks are immutable after
  encode — see MIGRATION "Shared-frame wire contract" for what a new
  event field must do to stay shareable.

``SubscriptionMap`` is the replica fleet's consistent-hash key→replica
subscription map (tools/watch_scale.py): vnodes smooth the arcs, a dead
replica moves only its own arc, and survivors' subscriptions never
reshuffle — the property that makes replica warm-restart (resume from
revision via --resume-floor) a local event instead of a 100K-client
relist.
"""

from __future__ import annotations

import bisect
import collections
import hashlib

from k8s1m_tpu_torch.obs.metrics import Counter
from k8s1m_tpu_torch.store.proto import codec

_FRAME_ENCODES = Counter(
    "watchcache_frame_encodes_total",
    "event payloads proto-encoded into a shared frame table (each "
    "store event costs at most one encode tier-wide; fan-out reuses "
    "the bytes)", ()
)
_FRAME_HITS = Counter(
    "watchcache_frame_hits_total",
    "event chunk requests served from already-encoded shared-frame "
    "bytes — the encode CPU the wiretier elides; hits/(hits+encodes) "
    "is the table's share ratio", ()
)
_WIRE_BYTES = Counter(
    "watchcache_wire_bytes_total",
    "bytes of composed watch event frames put on the wire (a shared "
    "frame counts once regardless of how many watch ids ride it)", ()
)

# WatchResponse known-field tags (field number << 3 | wire type).
_TAG_HEADER = b"\x0a"      # field 1 (header), LEN
_TAG_WATCH_ID = b"\x10"    # field 2 (watch_id), varint
_TAG_EVENT = b"\x5a"       # field 11 (events), LEN
# The shared-frame extension: private trailing fields, high-numbered so
# they can never collide with WatchResponse's real fields and parse as
# preserved-but-ignored unknown fields in any stock protobuf client.
SHARED_WIDS_FIELD = 100    # repeated varint: extra watch ids sharing the frame
SHARED_FROM_REV_FIELD = 101  # varint: compaction window lower bound
_TAG_SHARED_WID = b"\xa0\x06"    # field 100, varint
_TAG_SHARED_FROM = b"\xa8\x06"   # field 101, varint


def varint(n: int) -> bytes:
    """Protobuf varint (unsigned LEB128).  Callers never pass negatives:
    the one negative watch id on the wire (-1 progress) stays on the
    ordinary proto-object path."""
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def header_bytes(header) -> bytes:
    """The response's leading header chunk (field 1)."""
    hb = header.encode()
    return _TAG_HEADER + varint(len(hb)) + hb


def event_chunk(payload: bytes) -> bytes:
    """Frame one serialized mvcc Event as a WatchResponse.events chunk."""
    return _TAG_EVENT + varint(len(payload)) + payload


def encode_event(ev) -> bytes:
    """One cache event's chunk bytes (duck-typed on CacheEvent's
    fields).  Byte-identical to what ``encode_event_batch`` would embed
    for the same event — the identity the wiretier differential gates."""
    return event_chunk(
        codec.Event(
            type=codec.Event.DELETE if ev.type else codec.Event.PUT,
            kv=codec.KeyValue(
                key=ev.key,
                value=ev.value,
                create_revision=ev.create_revision,
                mod_revision=ev.mod_revision,
                version=ev.version,
            ),
        ).encode()
    )


def compose_frame(hdr: bytes, wids, chunks, from_rev: int = 0) -> bytes:
    """One wire WatchResponse from pre-encoded parts.

    ``wids[0]`` is the frame's primary watch id (the known field);
    every further id rides the trailing shared-wid extension.  With a
    single wid and no ``from_rev`` the result is byte-identical to the
    constructor path — protobuf's canonical tag-order serialization is
    exactly this concatenation.  Frames are immutable once composed:
    sharing is index selection on the client, never a rewrite.
    """
    parts = [hdr]
    if wids[0]:
        parts.append(_TAG_WATCH_ID + varint(wids[0]))
    parts.extend(chunks)
    for wid in wids[1:]:
        parts.append(_TAG_SHARED_WID + varint(wid))
    if from_rev:
        parts.append(_TAG_SHARED_FROM + varint(from_rev))
    data = b"".join(parts)
    _WIRE_BYTES.inc(len(data))
    return data


def serialize_frame_or_message(m):
    """Response serializer for Watch streams that mix composed
    frames (already bytes) with ordinary proto control responses
    (created/canceled/progress), the codec's messages."""
    if isinstance(m, (bytes, bytearray, memoryview)):
        return m
    return m.encode()


class FrameTable:
    """Bounded encode-once cache of event chunk bytes.

    Keys are caller-chosen event identities (the watch-cache tier uses
    the event's monotone ``seq``; the store server an identity tuple);
    a falsy key opts out of caching (unit-test events without a seq).
    Eviction is FIFO by insertion, which tracks drain order closely
    enough that evicted entries are the already-fanned-out ones; a
    re-encode after eviction costs CPU, never correctness.
    """

    def __init__(self, cap: int = 8192):
        self.cap = max(1, cap)
        self._bytes: dict = {}
        # maxlen is a backstop only: the explicit eviction below keeps
        # the deque and dict exactly in sync before it could engage.
        self._order: collections.deque = collections.deque(maxlen=self.cap)

    def bytes_for(self, key, encode, *args) -> bytes:
        if key:
            b = self._bytes.get(key)
            if b is not None:
                _FRAME_HITS.inc()
                return b
        b = encode(*args)
        _FRAME_ENCODES.inc()
        if key:
            if len(self._order) >= self.cap:
                self._bytes.pop(self._order.popleft(), None)
            self._order.append(key)
            self._bytes[key] = b
        return b

    def __len__(self) -> int:
        return len(self._bytes)


class SubscriptionMap:
    """Consistent-hash key→replica subscription map for the watch
    fleet.

    Replicas are opaque ids (tools use tier indices).  Each replica
    plants ``vnodes`` points on a 64-bit blake2b ring; a key subscribes
    to the first replica point at-or-after its own hash.  Removing a
    replica (``without``) moves ONLY that replica's arcs to their ring
    successors: every surviving subscription is provably unchanged,
    which is what keeps a replica crash from reshuffling — and
    relisting — the whole fleet's watch population.

    Pure data structure: no locks, no I/O; safe to rebuild per topology
    change (the fleet is small, the key population is not).
    """

    def __init__(self, replicas, vnodes: int = 64):
        replicas = list(replicas)
        if not replicas:
            raise ValueError("SubscriptionMap needs at least one replica")
        self.replicas = tuple(replicas)
        self.vnodes = vnodes
        ring = []
        for r in replicas:
            for v in range(vnodes):
                ring.append((self._point(b"%d#%d" % (r, v)), r))
        ring.sort()
        self._ring = ring
        self._points = [p for p, _ in ring]

    @staticmethod
    def _point(b: bytes) -> int:
        return int.from_bytes(
            hashlib.blake2b(b, digest_size=8).digest(), "big"
        )

    def replica_for(self, key: bytes) -> int:
        i = bisect.bisect_right(self._points, self._point(key))
        return self._ring[i % len(self._ring)][1]

    def without(self, replica: int) -> "SubscriptionMap":
        return SubscriptionMap(
            [r for r in self.replicas if r != replica], self.vnodes
        )
