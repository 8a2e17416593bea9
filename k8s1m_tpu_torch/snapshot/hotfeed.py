"""hotfeed: cached + vectorized pod encoding, an overlapped host feed,
and the pod shape keys.

Port of ``k8s1m_tpu/snapshot/hotfeed.py`` (host-only numpy; the sharded
feed of the mesh is not part of the port):

1. **Pods share shapes.**  ``EncodeCache`` fingerprints a pod's
   structural parts (selectors, tolerations, affinity terms,
   spread/affinity refs) and caches the encoded template rows; a batch
   fill becomes one vectorized column write per scalar plus one
   fancy-indexed row broadcast per distinct shape.
2. **Encode need not sit on the critical path.**  ``HostFeed`` runs one
   worker thread that encodes the NEXT wave's batch while the current
   wave is in flight; the coordinator claims the pre-staged
   ``PackedPodBatch`` at dispatch time.  The worker does numpy only —
   every tensor op stays on the coordinator's thread and stream.

Contracts, as in the JAX package: a cached encode is byte-identical to
the uncached ``PodBatchHost`` encode of the same pods against the same
vocab (templates are built by the same ``_fill_pod`` body, and the
per-batch query-key table is replayed through each shape's ``key_seq``);
templates are keyed on ``Vocab.generation()``; a feed-staged batch is
stamped with the generation it encoded against and discarded at claim
time if the vocab or the queue prefix moved.

``PLAIN``, ``fingerprint`` and ``shape_key`` are the structural
fingerprint and the deltasched plane key (``engine/deltacache.py``): two
pods share a key in the port exactly when they share one in the JAX
package (the sentinels are this module's own objects).
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
import math
import threading
import time
import weakref

import numpy as np

from k8s1m_tpu_torch.config import NONE_ID
from k8s1m_tpu_torch.obs.metrics import Counter, Gauge
from k8s1m_tpu_torch.snapshot.pod_encoding import (
    _GROUP_OF,
    _GROUP_SENTINEL,
    PackedPodBatch,
    PodBatchHost,
    PodInfo,
    batch_field_specs,
)

log = logging.getLogger("k8s1m.hotfeed")

_ENCODE_SECONDS = Counter(
    "hotfeed_encode_seconds_total",
    "Host pod-encode seconds, by path (inline = on the cycle thread, "
    "feed = hidden in the worker while a wave is in flight)",
    ("path",),
)
_CACHE_HITS = Counter(
    "hotfeed_cache_hits_total",
    "Template-path pods (shape groups of >= TEMPLATE_MIN in a batch) "
    "served from the encode template cache.  Plain pods and small "
    "groups bypass the cache by design and count in neither series",
    (),
)
_CACHE_MISSES = Counter(
    "hotfeed_cache_misses_total",
    "Template-path pods whose structural shape had to be built fresh "
    "(first sight, or a vocab-generation invalidation)", (),
)
_STAGED_USED = Counter(
    "hotfeed_staged_used_total",
    "Waves dispatched from a feed-pre-staged batch (encode off the "
    "critical path)", (),
)
_STALE = Counter(
    "hotfeed_stale_batches_total",
    "Pre-staged batches discarded at claim time, by reason (vocab = "
    "interning moved between staging and dispatch; reordered = the "
    "queue prefix changed; error = the worker encode raised; merge = "
    "dp-shard sub-batches could not merge, e.g. a query-key overflow)",
    ("reason",),
)
_STAGED_DEPTH = Gauge(
    "hotfeed_staged_depth",
    "Batches currently staged or encoding in host feeds (0..1 per feed)",
    (),
)
_LIVE_FEEDS: weakref.WeakSet = weakref.WeakSet()
# Registration and scrape-time snapshot share a lock: WeakSet iteration
# races a concurrent add() from another thread's HostFeed construction
# (RuntimeError: set changed size during iteration).
_FEEDS_LOCK = threading.Lock()


def _feeds_depth() -> int:
    with _FEEDS_LOCK:
        feeds = list(_LIVE_FEEDS)
    return sum(f.depth() for f in feeds)


_STAGED_DEPTH.set_function(_feeds_depth)


def cache_counts() -> tuple[int, int]:
    """(hits, misses) of the shape-template cache so far — podtrace
    reads a delta around one batch's encode so the encode span carries
    the cache-hit/template-path evidence as attributes (process-wide
    counters: with several live coordinators the delta mixes their
    traffic, which only blurs the attrs, never the span timings)."""
    return int(_CACHE_HITS.value()), int(_CACHE_MISSES.value())


# Shared sentinel for the all-zero structural template: a plain pod
# (the 1M-KWOK steady state) writes scalars only, no template at all.
PLAIN = object()

# Pods of one shape in a batch before the template apply beats encoding
# them directly: each template field is its own fancy write (~2us of
# numpy overhead regardless of row count), so a singleton shape pays
# ~17 writes where the direct body pays one encode — measured
# break-even sits around 2-3 pods; 4 keeps a margin.  Both paths are
# byte-identical, this is purely a cost fork.
TEMPLATE_MIN = 4

# Per-pod scalar columns — always filled vectorized, never cached in a
# template (node_name_id is vocab-live by design, see Vocab.generation).
_SCALAR_FIELDS = frozenset({"valid", "cpu", "mem", "node_name_id"})
# Template fields holding *local* query-key indices that must be
# translated through the per-batch qkey permutation at fill time.
_QIDX_FIELDS = frozenset({"sel_qidx", "req_qidx", "pref_qidx"})


# Section separators for the flat fingerprint: variable-length sections
# back to back would be ambiguous ("ab"+"c" vs "a"+"bc"); a singleton
# object between them restores unambiguity at ~zero cost.  Flat tuples
# beat nested ones: one allocation and a C-speed hash instead of ~15
# interior tuples per pod — fingerprinting runs once per pod in the hot
# fill, so its constant factor is the cache's floor.
_SEP = object()


def fingerprint(pod: PodInfo):
    """Hashable key over a pod's structural (template-cacheable) parts.

    Everything that flows into non-scalar encode output is included;
    scalars (cpu, mem, name, nodeName) are deliberately NOT — they are
    patched per pod.  Returns the shared ``PLAIN`` sentinel for the
    all-default shape so the common case costs one tuple of falsy
    checks, not a tuple build.
    """
    if not (
        pod.node_selector or pod.tolerations or pod.required_terms
        or pod.preferred_terms or pod.spread_refs or pod.affinity_refs
        or pod.spread_incs or pod.ipa_incs
    ):
        return PLAIN
    parts: list = [pod.scheduler_name]
    app = parts.append
    if pod.node_selector:
        for kv in sorted(pod.node_selector.items()):
            app(kv)
    app(_SEP)
    for t in pod.tolerations:
        app(t.key); app(t.op); app(t.value); app(t.effect)
    app(_SEP)
    for term in pod.required_terms:
        for e in term.match_expressions:
            app(e.key); app(e.op); app(tuple(e.values))
        app(_SEP)
    app(_SEP)
    for pt in pod.preferred_terms:
        app(pt.weight)
        for e in pt.term.match_expressions:
            app(e.key); app(e.op); app(tuple(e.values))
        app(_SEP)
    app(_SEP)
    for r in pod.spread_refs:
        app(r.cid); app(r.topo); app(r.max_skew); app(r.mode)
        app(r.self_match)
    app(_SEP)
    for r in pod.affinity_refs:
        app(r.tid); app(r.topo); app(r.required); app(r.anti)
        app(r.weight); app(r.self_match)
    app(_SEP)
    parts.extend(pod.spread_incs)
    app(_SEP)
    parts.extend(pod.ipa_incs)
    return tuple(parts)


def shape_key(pod: PodInfo):
    """Delta-plane cache key of a pod's filter+score plane, or None when
    the pod's plane is not cacheable (engine/deltacache.py).

    The plane a pod computes over the node table is a pure function of
    its structural ``fingerprint`` *plus* its request scalars — Fit and
    the allocation scores read cpu/mem — so the key extends the encode
    cache's fingerprint with exactly those.  Not cacheable (None):

    - constraint-coupled pods (spread/affinity refs or incs): their
      mask/score reads the live count tables, which move with every
      constraintful bind ANYWHERE in a domain — row-level dirty
      tracking cannot bound that;
    - ``spec.nodeName`` pods: the baked ``node_name_id`` lookup can
      resolve differently after the name interns (queued pods never
      carry one — the coordinator settles them as bound — so this is a
      guard, not a hot case).
    """
    if (
        pod.spread_refs or pod.affinity_refs
        or pod.spread_incs or pod.ipa_incs
        or pod.node_name is not None
    ):
        return None
    return (fingerprint(pod), pod.cpu_milli, pod.mem_kib)


@dataclasses.dataclass
class _Template:
    """One shape's encoded rows.  ``direct`` rows broadcast verbatim;
    ``qidx`` rows hold pod-local query-key indices (1..K in the pod's
    own first-encounter order; 0 = padding) that the fill translates
    through the batch-level permutation.  All-zero rows are dropped —
    the arena is pre-zeroed, so writing nothing is identical to writing
    zeros.  Row shapes carry no batch dimension: one cache serves every
    power-of-two batch bucket (equal non-batch spec bounds required)."""

    key_seq: tuple[str, ...]
    direct: dict[str, np.ndarray]
    qidx: dict[str, np.ndarray]


# Structural fields written per pod attribute — mirrors the branches of
# PodBatchHost._fill_pod exactly (a field is in a template iff its
# attribute is set; rows that end up all-zero anyway are harmless — the
# fill arena is pre-zeroed, so re-writing zeros is byte-identical).
# Scanning all ~36 fields with .any() per template build was the
# dominant miss cost; this map replaces the scan with attribute checks.
_FIELDS_BY_ATTR: tuple[tuple[str, tuple[str, ...]], ...] = (
    ("tolerations", ("tolerated",)),
    ("node_selector", ("sel_valid", "sel_qidx", "sel_val")),
    ("required_terms", ("req_term_valid", "req_expr_valid", "req_qidx",
                        "req_op", "req_vals", "req_num")),
    ("preferred_terms", ("pref_term_valid", "pref_weight",
                         "pref_expr_valid", "pref_qidx", "pref_op",
                         "pref_vals", "pref_num")),
    ("spread_refs", ("spread_valid", "spread_cid", "spread_topo",
                     "spread_max_skew", "spread_mode", "spread_self")),
    ("affinity_refs", ("ipa_valid", "ipa_tid", "ipa_topo", "ipa_required",
                       "ipa_anti", "ipa_weight", "ipa_self")),
    ("spread_incs", ("sinc_valid", "sinc_cid", "sinc_topo")),
    ("ipa_incs", ("iinc_valid", "iinc_tid", "iinc_topo")),
)


def _build_template(
    encoder: PodBatchHost, pod: PodInfo, tmp: dict
) -> _Template:
    """Encode one pod's structural features through the SAME `_fill_pod`
    body the uncached path runs, against the caller's zeroed batch-1
    scratch (returned dirty in exactly the fields this returns; the
    cache re-zeroes those rows)."""
    key_seq: list[str] = []
    local: dict[str, int] = {}

    def local_qidx(key: str) -> int:
        li = local.get(key)
        if li is None:
            li = len(local) + 1
            if li >= encoder.spec.query_keys:
                # One pod alone overflowing the table fails identically
                # to the uncached batch-level check.
                raise ValueError(
                    f"batch references >{encoder.spec.query_keys - 1} "
                    "distinct selector keys; grow PodSpec.query_keys"
                )
            local[key] = li
            key_seq.append(key)
        return li

    taints = list(encoder.vocab.taints.items())
    encoder._fill_pod(tmp, 0, pod, local_qidx, taints)
    direct: dict[str, np.ndarray] = {}
    qidx: dict[str, np.ndarray] = {}
    for attr, names in _FIELDS_BY_ATTR:
        if not getattr(pod, attr):
            continue
        if attr == "tolerations" and not taints:
            continue    # no taint triples -> the tolerated row is zero
        for name in names:
            # Copy: the row must outlive the shared scratch.
            row = tmp[name][0].copy()
            (qidx if name in _QIDX_FIELDS else direct)[name] = row
    return _Template(tuple(key_seq), direct, qidx)


class EncodeCache:
    """Shape-keyed template cache, cleared when Vocab.generation moves.

    Shared by every encoder of one coordinator (inline buckets, the
    feed's worker encoder, the adjust path) — templates carry no batch
    dimension.  Sharing requires equal non-batch PodSpec bounds and one
    TableSpec; the coordinator's buckets satisfy this by construction.
    Lock-guarded because the feed worker and the cycle thread both
    consult it (the claim/stage protocol keeps their *arena* use
    disjoint, but cache lookups can genuinely overlap).
    """

    def __init__(self, max_shapes: int = 4096) -> None:
        self._lock = threading.Lock()
        self._templates: dict = {}
        self._gen = -1
        self.max_shapes = max_shapes

    def get_or_build(
        self, encoder: "HotPodBatchHost", pod: PodInfo, fp, gen: int
    ) -> tuple[_Template, bool]:
        """(template, was_cached).  Builds under the lock — template
        builds are one-pod encodes, and serializing them keeps a torn
        build from ever being observed half-written (and makes each
        encoder's build scratch safe to reuse)."""
        with self._lock:
            if gen != self._gen:
                self._templates.clear()
                self._gen = gen
            tpl = self._templates.get(fp)
            if tpl is not None:
                return tpl, True
            tmp = encoder._template_scratch()
            clean = False
            try:
                tpl = _build_template(encoder, pod, tmp)
                # Re-zero exactly the rows the build wrote (the kept
                # field set IS the written set, _FIELDS_BY_ATTR).
                for name in tpl.direct:
                    tmp[name][0] = 0
                for name in tpl.qidx:
                    tmp[name][0] = 0
                clean = True
            finally:
                if not clean:
                    # A build that raised mid-fill left unknown rows
                    # dirty; full memset before anyone reuses it.
                    for arr in tmp.values():
                        arr[:] = 0
            if len(self._templates) >= self.max_shapes:
                # Shape storm (adversarial or genuinely unique specs):
                # bound memory by starting over rather than evicting in
                # some order a replay couldn't reproduce.
                self._templates.clear()
            self._templates[fp] = tpl
            return tpl, False

    def __len__(self) -> int:
        with self._lock:
            return len(self._templates)


class HotPodBatchHost(PodBatchHost):
    """Drop-in ``PodBatchHost`` whose fill is shape-cached + vectorized
    and whose packed encode reuses a pre-allocated arena.

    ``encode_packed()`` output is byte-identical to the parent's.  The packed
    result's ``fields`` are views into the freshly-concatenated
    ints/bools buffers (excluded groups share read-only zeros), so a
    retiring wave can still read its batch's commit fields after later
    encodes have recycled the arena.
    """

    def __init__(
        self, spec, table_spec, vocab, *,
        cache: EncodeCache | None = None, path: str = "inline",
    ) -> None:
        super().__init__(spec, table_spec, vocab)
        self.cache = cache if cache is not None else EncodeCache()
        self._path = path
        self._arena: dict | None = None
        # What the last _fill wrote (fields, rows, qkey slots) — copied
        # into _arena_dirty by encode_packed once the fill completed (a
        # fill that raises drops the arena instead).
        self._fill_dirty: tuple[set[str], int, int] = (set(), 0, 0)
        self._arena_dirty: tuple[set[str], int, int] = (set(), 0, 0)
        self._last_gen = -1
        self._zero_views: dict[str, np.ndarray] = {}
        self._tpl_scratch: dict | None = None

    def _template_scratch(self) -> dict:
        """Reusable batch-1 build scratch (only ever touched under the
        EncodeCache lock, which serializes template builds)."""
        if self._tpl_scratch is None:
            s1 = dataclasses.replace(self.spec, batch=1)
            self._tpl_scratch = {
                name: np.zeros(shape, np.bool_ if is_bool else np.int32)
                for name, is_bool, shape in batch_field_specs(
                    s1, self.table_spec
                )
                if name not in _SCALAR_FIELDS and name != "qkey"
            }
        return self._tpl_scratch

    # ---- arena ---------------------------------------------------------

    def _arena_take(self, specs) -> dict:
        """The reusable output dict, with only the regions the PREVIOUS
        packed fill wrote zeroed (rows past the previous pod count were
        never touched; fields no template used stayed zero)."""
        if self._arena is None:
            self._arena = {
                name: np.zeros(shape, np.bool_ if is_bool else np.int32)
                for name, is_bool, shape in specs
            }
        else:
            fields, n, q = self._arena_dirty
            arena = self._arena
            for name in fields:
                arena[name][:n] = 0
            if q:
                arena["qkey"][:q] = 0
        self._arena_dirty = (set(), 0, 0)
        return self._arena

    # ---- cached fill ---------------------------------------------------

    def _fill(self, out: dict, pods: list[PodInfo]) -> None:
        s = self.spec
        b = s.batch
        if len(pods) > b:
            raise ValueError(f"{len(pods)} pods > batch {b}")
        v = self.vocab
        # The batch stamp includes node_names (scalar node_name_id
        # lookups below bake it); the template cache key (gen) must not.
        # Stamp FIRST: an intern landing between the two reads then
        # makes the stamp strictly older than the live feed_generation,
        # so claim() discards — reading gen first would let a batch
        # built from pre-intern templates carry a passing stamp.
        self._last_gen = v.feed_generation()
        gen = v.generation()
        n = len(pods)
        out["valid"][:n] = True
        out["cpu"][:n] = np.fromiter((p.cpu_milli for p in pods), np.int32, n)
        out["mem"][:n] = np.fromiter((p.mem_kib for p in pods), np.int32, n)
        dirty = {"valid", "cpu", "mem"}

        # Per-batch query-key table, replayed in pod order so the slot
        # assignment is byte-identical to the uncached first-encounter
        # walk (a shape's key_seq is its distinct keys in request order;
        # duplicate requests assign nothing, so replaying the distinct
        # sequence reproduces the batch table exactly).
        qidx_of: dict[str, int] = {}

        def qidx(key: str) -> int:
            i = qidx_of.get(key)
            if i is None:
                i = len(qidx_of) + 1
                if i >= s.query_keys:
                    raise ValueError(
                        f"batch references >{s.query_keys - 1} distinct "
                        "selector keys; grow PodSpec.query_keys"
                    )
                qidx_of[key] = i
                out["qkey"][i] = v.label_keys.lookup(key)
            return i

        cache = self.cache
        groups: dict = {}
        taints = None
        # Phase 1 — per-pod: scalar nodeName + fingerprint + grouping,
        # O(shape) dict/tuple work per pod; every field write happens in
        # phase 2, per shape.
      
        for i, pod in enumerate(pods):
            if pod.node_name is not None:
                nid = v.node_names.lookup(pod.node_name)
                out["node_name_id"][i] = nid if nid != NONE_ID else -1
                dirty.add("node_name_id")
            fp = fingerprint(pod)
            if fp is PLAIN:
                continue
            members = groups.get(fp)
            if members is None:
                groups[fp] = [(i, pod)]
            else:
                members.append((i, pod))

        # Phase 2 — per shape, in first-encounter (insertion) order.
        # qkey byte-identity holds because a key's first reference in
        # pod order always happens at the first pod of the first shape
        # referencing it — the same position this order replays.
        # Small groups bypass the template machinery entirely: below
        # TEMPLATE_MIN pods, the per-field write overhead plus the
        # cache round trip costs more than the direct uncached body
        # (measured on-host; both paths are byte-identical, this is
        # purely a cost fork).  Big groups pay one fancy write per
        # template field, amortized across the group.
        hits = misses = 0
        for fp, members in groups.items():
            if len(members) < TEMPLATE_MIN:
                if taints is None:
                    taints = list(v.taints.items())
                for i, pod in members:
                    self._fill_pod(out, i, pod, qidx, taints)
                    for attr, names in _FIELDS_BY_ATTR:
                        if getattr(pod, attr):
                            dirty.update(names)
                continue
            tpl, was_cached = cache.get_or_build(
                self, members[0][1], fp, gen
            )
            if was_cached:
                hits += len(members)
            else:
                misses += 1
                hits += len(members) - 1
            dirty.update(tpl.direct)
            dirty.update(tpl.qidx)
            idx = np.asarray([i for i, _ in members], np.intp)
            for name, row in tpl.direct.items():
                out[name][idx] = row
            if tpl.key_seq or tpl.qidx:
                perm = np.empty(len(tpl.key_seq) + 1, np.int32)
                perm[0] = 0
                for li, key in enumerate(tpl.key_seq):
                    perm[li + 1] = qidx(key)
                for name, row in tpl.qidx.items():
                    out[name][idx] = perm[row]

        self._fill_dirty = (dirty, n, len(qidx_of) + 1)
        if hits:
            _CACHE_HITS.inc(hits)
        if misses:
            _CACHE_MISSES.inc(misses)

    def encode_packed_plain(self, cpu, mem) -> PackedPodBatch:
        t0 = time.perf_counter()
        packed = super().encode_packed_plain(cpu, mem)
        _ENCODE_SECONDS.inc(time.perf_counter() - t0, path=self._path)
        return packed

    # ---- packed encode over the arena ----------------------------------

    def _zero_view(self, name, is_bool, shape) -> np.ndarray:
        z = self._zero_views.get(name)
        if z is None:
            z = np.zeros(shape, np.bool_ if is_bool else np.int32)
            z.flags.writeable = False
            self._zero_views[name] = z
        return z

    def encode_packed(self, pods: list[PodInfo]) -> PackedPodBatch:
        t0 = time.perf_counter()
        specs = batch_field_specs(self.spec, self.table_spec)
        out = self._arena_take(specs)
        try:
            self._fill(out, pods)
        except BaseException:
            # A mid-fill error (oversized pod) leaves unknown regions
            # written with the dirty bookkeeping lost; drop the arena so
            # the next encode starts from fresh zeros.
            self._arena = None
            raise
        self._arena_dirty = self._fill_dirty
        # Group detection from the fill's own bookkeeping instead of 8
        # full sentinel scans: for every group but "tol", the sentinel
        # holds a True iff the attribute was nonempty iff the fill wrote
        # it (dirty).  "tolerated" alone can be written all-False (a pod
        # whose tolerations match no live taint triple — uncached
        # excludes the group then), so it keeps one real scan.
        dirty_fields = self._fill_dirty[0]
        groups = {
            g for f, g in _GROUP_OF.items()
            if g in _GROUP_SENTINEL and f == _GROUP_SENTINEL[g]
            and f != "tolerated" and f in dirty_fields
        }
        if (
            "tolerated" in dirty_fields
            and out["tolerated"][: self._fill_dirty[1]].any()
        ):
            groups.add("tol")
        if groups & {"sel", "req", "pref"}:
            groups.add("qkey")
        groups = frozenset(groups)
        # fields as views into the packed buffers: valid after the arena
        # is recycled by the next encode (CAS rollback reads them a wave
        # or more later), at zero copy cost — the buffers are fresh.
        ints, bools, fields = _pack_buffers(
            specs, groups, out, self._zero_view
        )
        _ENCODE_SECONDS.inc(time.perf_counter() - t0, path=self._path)
        return PackedPodBatch(
            ints, bools, self.spec, self.table_spec, groups,
            fields=fields, vocab_gen=self._last_gen,
        )


def _pack_buffers(specs, groups: frozenset, out: dict, zero_view):
    """Flatten included-group field arrays into the two packed buffers
    and rebuild the field dict as views into them — the one packing body
    shared by the arena encode and the dp-shard merge."""
    int_parts, bool_parts = [], []
    for name, is_bool, _shape in specs:
        g = _GROUP_OF.get(name)
        if g is not None and g not in groups:
            continue
        (bool_parts if is_bool else int_parts).append(out[name].ravel())
    ints = (
        np.concatenate(int_parts) if int_parts else np.zeros(0, np.int32)
    )
    bools = (
        np.concatenate(bool_parts) if bool_parts else np.zeros(0, np.bool_)
    )
    fields: dict[str, np.ndarray] = {}
    io = bo = 0
    for name, is_bool, shape in specs:
        g = _GROUP_OF.get(name)
        if g is not None and g not in groups:
            fields[name] = zero_view(name, is_bool, shape)
            continue
        size = math.prod(shape)
        if is_bool:
            fields[name] = bools[bo : bo + size].reshape(shape)
            bo += size
        else:
            fields[name] = ints[io : io + size].reshape(shape)
            io += size
    return ints, bools, fields


# Read-only zeros for merge_packed's excluded groups (the standalone
# counterpart of HotPodBatchHost._zero_view; shapes are spec-derived so
# the cache stays tiny).
_MERGE_ZEROS: dict = {}


def _merge_zero_view(name, is_bool, shape) -> np.ndarray:
    z = _MERGE_ZEROS.get((name, shape))
    if z is None:
        z = np.zeros(shape, np.bool_ if is_bool else np.int32)
        z.flags.writeable = False
        _MERGE_ZEROS[(name, shape)] = z
    return z


def merge_packed(parts: list[PackedPodBatch]) -> PackedPodBatch | None:
    """Concatenate dp contiguous sub-batches into one full-batch
    ``PackedPodBatch``, or None when they cannot merge (merged query
    keys overflow ``PodSpec.query_keys``, or the parts were encoded
    against different vocab generations).

    Byte-identity: each sub-batch's per-batch query-key table lists its
    distinct selector keys in first-encounter order, and a key's first
    reference across the FULL batch always happens in the earliest
    sub-batch referencing it — so replaying the sub-tables in dp order
    rebuilds exactly the slot assignment a single full-batch encode
    produces, and the merged buffers are byte-identical to encoding the
    concatenated pod list inline.
    The one exception: a never-interned selector key encodes as NONE_ID,
    which two sub-batches cannot distinguish from each other's unknown
    keys — those slots merge by id, which the device cannot tell apart
    either (both query an id no node carries).
    """
    first = parts[0]
    b_total = sum(p.spec.batch for p in parts)
    mspec = dataclasses.replace(first.spec, batch=b_total)
    for p in parts[1:]:
        if (
            dataclasses.replace(p.spec, batch=0)
            != dataclasses.replace(first.spec, batch=0)
            or p.table_spec != first.table_spec
        ):
            raise ValueError("merge_packed parts disagree on specs")
    gens = {p.vocab_gen for p in parts if p.vocab_gen is not None}
    if len(gens) > 1:
        return None
    groups = frozenset().union(*(p.groups for p in parts))

    # Merged query-key table + per-part slot permutations (slot 0 stays
    # the reserved NONE slot everywhere).
    qkey = np.zeros((mspec.query_keys,), np.int32)
    slot_of: dict[int, int] = {}
    next_slot = 1
    perms = []
    for p in parts:
        used = 0
        for name in _QIDX_FIELDS:
            if _GROUP_OF[name] in p.groups:
                used = max(used, int(p.fields[name].max()))
        perm = np.zeros((used + 1,), np.int32)
        tbl = p.fields["qkey"]
        for local in range(1, used + 1):
            kid = int(tbl[local])
            slot = slot_of.get(kid) if kid != 0 else None
            if slot is None:
                if next_slot >= mspec.query_keys:
                    return None      # caller falls back to inline encode
                slot = next_slot
                next_slot += 1
                qkey[slot] = kid
                if kid != 0:
                    slot_of[kid] = slot
            perm[local] = slot
        perms.append(perm)

    specs = batch_field_specs(mspec, first.table_spec)
    merged: dict[str, np.ndarray] = {}
    for name, is_bool, shape in specs:
        g = _GROUP_OF.get(name)
        if g is not None and g not in groups:
            continue
        if name == "qkey":
            merged[name] = qkey
        elif name in _QIDX_FIELDS:
            merged[name] = np.concatenate(
                [perm[p.fields[name]] for perm, p in zip(perms, parts)]
            )
        else:
            merged[name] = np.concatenate([p.fields[name] for p in parts])
    ints, bools, fields = _pack_buffers(
        specs, groups, merged, _merge_zero_view
    )
    return PackedPodBatch(
        ints, bools, mspec, first.table_spec, groups,
        fields=fields, vocab_gen=gens.pop() if gens else None,
    )


def encode_batch(enc: PodBatchHost, batch_pods, *, mutate: bool = True):
    """Encode popped/peeked PendingPods with ``enc`` — the ONE encode
    body both the inline path (Coordinator._take_batch) and the feed
    worker run, so staged and inline encodes of the same pods can never
    drift.  ``mutate=False`` (the worker) materializes missing PodInfos
    without assigning ``p.pod`` — the peeked objects still belong to
    the cycle thread's queue."""
  
    if all(p.pod is None for p in batch_pods):
        # Native-intake fast lane: a wave of plain pods encodes from
        # two int columns, no per-pod Python (vocab-independent, so the
        # stamp stays None and claim() skips the generation check).
        return enc.encode_packed_plain(
            [p.cpu_milli for p in batch_pods],
            [p.mem_kib for p in batch_pods],
        )
    if mutate:
      
        return enc.encode_packed([p.ensure_pod() for p in batch_pods])
  
    return enc.encode_packed([p.peek_pod() for p in batch_pods])


class HostFeed:
    """Double-buffered host feed: one worker thread encodes the next
    wave's batch while the current wave is in flight.

    Protocol (cycle thread):

    - ``stage(queue, batch)`` after a dispatch: PEEKS (never pops) the
      first ``batch`` pods and hands the list to the worker.  Only full
      batches stage — partial waves are the light-load latency path,
      where adaptive buckets pick the encoder and inline encode is
      already cheap; staging them would freeze a too-small batch while
      the queue refills behind it.
    - ``claim(batch_pods, generation)`` at the next dispatch: waits out
      any in-progress encode (always shorter than encoding inline —
      the work is part-done), then returns the staged PackedPodBatch
      iff (a) the popped pods are exactly the peeked prefix, same
      objects in the same order, and (b) the vocab generation has not
      moved since the encode.  Anything else returns None and the
      caller encodes inline; `hotfeed_stale_batches_total{reason}`
      counts why.

    The worker owns a dedicated encoder (its arena never races the
    cycle thread's inline/adjust encoders); claim()'s wait guarantees
    the worker is idle before the next stage().  A worker that raises
    stages ``None`` — the inline fallback then reproduces any real
    encode error on the cycle thread, where it can propagate.
    """

    def __init__(self, encoder: HotPodBatchHost, name: str = "hotfeed"):
        self.encoder = encoder
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._req: list | None = None
        self._staged: tuple | None = None
        self._closed = False
        self._thread = threading.Thread(
            target=self._run, name=name, daemon=True
        )
        self._thread.start()
        with _FEEDS_LOCK:
            _LIVE_FEEDS.add(self)

    def depth(self) -> int:
        with self._lock:
            return (self._req is not None) + (self._staged is not None)

    def ready(self) -> bool:
        """A staged batch is waiting (the worker finished encoding)."""
        with self._lock:
            return self._staged is not None

    def stage(self, queue, batch: int) -> bool:
        """Peek the first ``batch`` pods off ``queue`` (a deque the
        caller owns) and submit them for background encode.  No-op
        unless a full batch is available and the feed is idle."""
        if len(queue) < batch:
            return False
        return self.stage_pods(list(itertools.islice(queue, batch)))

    def stage_pods(self, pods: list) -> bool:
        """Submit an already-peeked pod list (``ShardedHostFeed`` hands
        each dp rank's slice this way); no-op unless the feed is idle."""
        with self._lock:
            if (
                self._closed
                or self._req is not None or self._staged is not None
            ):
                return False
            self._req = pods
            self._cond.notify_all()
        return True

    def claim(self, batch_pods: list, generation: int):
        """The staged PackedPodBatch for exactly ``batch_pods`` at
        ``generation``, or None (caller encodes inline)."""
        deadline = time.monotonic() + 60.0
        with self._lock:
            while self._req is not None:
                # The worker always finishes (pure numpy, no I/O); the
                # deadline is a liveness backstop — a wedged worker
                # degrades to inline encodes (its eventual stale result
                # is discarded by the prefix check on a later claim).
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    log.error("hotfeed worker unresponsive; encoding inline")
                    return None
                self._cond.wait(timeout=remaining)
            staged, self._staged = self._staged, None
        if staged is None:
            return None
        pods, packed = staged
        if packed is None:
            _STALE.inc(reason="error")
            return None
      
        if len(pods) != len(batch_pods) or any(
            a is not b for a, b in zip(pods, batch_pods)
        ):
            # The queue prefix changed between peek and pop (requeue,
            # breaker pops, resync churn): the staged bytes describe
            # pods this wave is not carrying.
            _STALE.inc(reason="reordered")
            return None
        if packed.vocab_gen is not None and packed.vocab_gen != generation:
            # Interning moved between staging and dispatch — the cached
            # template ids may predate taints/labels this wave must see.
            _STALE.inc(reason="vocab")
            return None
        _STAGED_USED.inc()
        return packed

    def _run(self) -> None:
        while True:
            with self._lock:
                while self._req is None and not self._closed:
                    self._cond.wait()
                if self._closed:
                    return
                pods = self._req
            try:
                # mutate=False: the peeked PendingPods are still owned
                # by the cycle thread's queue; the worker must not
                # assign p.pod (the one write ensure_pod would do).
                packed = encode_batch(self.encoder, pods, mutate=False)
            # Broad on purpose (log.exception satisfies the lint): the
            # worker must stage None so the inline fallback reproduces
            # the error on the cycle thread, where it can propagate.
            except Exception:
                log.exception("hotfeed worker encode failed; staging None")
                packed = None
            with self._lock:
                self._staged = (pods, packed)
                self._req = None
                self._cond.notify_all()

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._cond.notify_all()
        self._thread.join(timeout=5.0)


class ShardedHostFeed:
    """One ``HostFeed`` per dp rank: the mesh coordinator's overlapped
    encode, split the way the device work is.

    It peeks the same full-batch queue prefix a single feed would, splits
    it into dp contiguous slices, and dp workers (each with its own arena,
    all sharing the coordinator's EncodeCache) encode them concurrently.
    ``claim`` checks every slice exactly as the single feed does (prefix
    identity, vocab generation; fail closed) and merges the sub-batches
    into one full-batch PackedPodBatch byte-identical to the inline encode
    (``merge_packed``).  A merge that cannot be trusted — query keys
    overflowing across slices, mixed generations — counts
    ``hotfeed_stale_batches_total{reason="merge"}`` and the caller encodes
    inline.  No locked state of its own: the sub-feeds carry the lock
    discipline, and this wrapper runs only on the cycle thread."""

    def __init__(self, encoders: list, name: str = "hotfeed"):
        if not encoders:
            raise ValueError("ShardedHostFeed needs >= 1 encoder")
        self._b_local = encoders[0].spec.batch
        self.feeds = [HostFeed(enc, name=f"{name}-dp{i}") for i, enc in enumerate(encoders)]

    def depth(self) -> int:
        return sum(f.depth() for f in self.feeds)

    def depths(self) -> list[int]:
        """Per-dp-rank staged depth (sched_bench's mesh report)."""
        return [f.depth() for f in self.feeds]

    def ready(self) -> bool:
        return all(f.ready() for f in self.feeds)

    def stage(self, queue, batch: int) -> bool:
        if batch != self._b_local * len(self.feeds) or len(queue) < batch:
            return False
        if any(f.depth() for f in self.feeds):
            return False
        peeked = list(itertools.islice(queue, batch))
        b = self._b_local
        for i, f in enumerate(self.feeds):
            f.stage_pods(peeked[i * b:(i + 1) * b])
        return True

    def claim(self, batch_pods: list, generation: int):
        """The merged staged batch for exactly ``batch_pods``, or None.
        Every sub-feed is claimed regardless (staged state must drain even
        when one slice went stale, or the feeds would wedge)."""
        b = self._b_local
        parts = [f.claim(batch_pods[i * b:(i + 1) * b], generation)
                 for i, f in enumerate(self.feeds)]
        if any(p is None for p in parts):
            return None
        merged = merge_packed(parts)
        if merged is None:
            _STALE.inc(reason="merge")
            return None
        return merged

    def close(self) -> None:
        for f in self.feeds:
            f.close()
