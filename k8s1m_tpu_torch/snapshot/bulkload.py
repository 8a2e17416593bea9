"""Bulk ingest: stored node bytes -> host mirror off the per-node axis.

The port's own copy of ``k8s1m_tpu/snapshot/bulkload.py``, the lane the
coordinator's bootstrap and resync relists feed through.  A 1M-row cold
build would otherwise decode a million stored Node objects and fold them
into the mirror one ``upsert`` at a time.

- **Canonical grammar, not a parser.**  Values written by ``encode_node``
  are FULLMATCHED against ``objects.CANONICAL_NODE_RE``, whose captures
  parse byte-identically to ``json.loads`` by construction; any other
  shape drops the chunk to the exact ``decode_node`` +
  ``NodeTableHost.bulk_upsert`` path.
- **Label blobs are templates.**  A fleet's label sets repeat; each
  distinct blob is parsed, sorted and interned once into a row template,
  and per node only the hostname value and the node name intern.

Byte-identity is the contract: ``BulkNodeLoader.ingest`` produces the
same column bytes, row mapping, vocab contents in the same intern order,
epoch count and row-journal entries as the equivalent
``host.upsert(decode_node(v))`` loop.
"""

from __future__ import annotations

import numpy as np

from k8s1m_tpu_torch.config import NONE_ID
from k8s1m_tpu_torch.control.objects import (
    CANONICAL_LABEL_RE,
    CANONICAL_NODE_RE,
    decode_node,
)
from k8s1m_tpu_torch.snapshot.interning import numeric_of
from k8s1m_tpu_torch.snapshot.node_table import (
    _BULK_ROWS,
    HOSTNAME_LABEL,
    REGION_LABEL,
    ZONE_LABEL,
    NodeTableHost,
)

# A chunk is the ingest transaction unit: one non-canonical value drops
# its whole chunk to the exact NodeInfo path (all-or-nothing keeps the
# intern-order proof simple), and the transient per-chunk Python lists
# stay bounded at 1M+ rows.
DEFAULT_CHUNK = 65536


class _Template:
    """One distinct label blob, pre-compiled to column rows."""

    __slots__ = ("lk", "lv", "ln", "hpos", "zid", "rid")

    def __init__(self, lk, lv, ln, hpos, zid, rid):
        self.lk, self.lv, self.ln = lk, lv, ln
        self.hpos = hpos
        self.zid, self.rid = zid, rid


class BulkNodeLoader:
    """Stateful bulk lane over one ``NodeTableHost`` (templates and the
    bytes->str memo persist across ``ingest`` calls, so a resync pays
    the blob parse only for blobs it has never seen)."""

    def __init__(
        self,
        host: NodeTableHost,
        *,
        template_cap: int = 4096,
        chunk: int = DEFAULT_CHUNK,
    ) -> None:
        self.host = host
        self.template_cap = template_cap
        self.chunk = chunk
        # blob bytes -> _Template, or None for "parse per node" blobs
        # (explicit hostname label, label overflow): those vary per
        # node or must raise with upsert's exact message.
        self._templates: dict[bytes, _Template | None] = {}
        # Stacked template columns, rebuilt lazily when templates grow.
        self._stack: tuple | None = None
        self._tlist: list[_Template] = []
        # bytes -> decoded str memo for label keys/values (shared str
        # objects also hash once across every later intern lookup).
        self._str: dict[bytes, str] = {}

    # -- template compilation -------------------------------------------

    def _decode_str(self, b: bytes) -> str:
        s = self._str.get(b)
        if s is None:
            s = b.decode()
            if len(self._str) < 1 << 16:
                self._str[b] = s
        return s

    def _compile(self, blob: bytes, first_name: str) -> _Template | None:
        """Intern and row-compile one new blob, in exactly the order
        ``upsert`` would for its first node (``first_name`` supplies
        the hostname default interned mid-pass)."""
        host = self.host
        spec = host.spec
        labels: dict[str, str] = {}
        for kb, vb in CANONICAL_LABEL_RE.findall(blob):
            labels[self._decode_str(kb)] = self._decode_str(vb)
        if HOSTNAME_LABEL in labels or len(labels) + 1 > spec.label_slots:
            # Hostname-carrying blobs differ per node (no reuse, and an
            # unbounded cache); oversized ones must raise with upsert's
            # own message.  Both take the exact path, every time.
            self._templates[blob] = None
            return None
        v = host.vocab
        slots = spec.label_slots
        lk = np.zeros((slots,), np.int32)
        lv = np.zeros((slots,), np.int32)
        ln = np.zeros((slots,), np.int32)
        hpos = 0
        full = sorted(labels.items())
        full.append((HOSTNAME_LABEL, None))
        full.sort(key=lambda kv: kv[0])
        for j, (k, val) in enumerate(full):
            lk[j] = v.label_keys.intern(k)
            if val is None:
                hpos = j
                # The first node's hostname value interns here — in the
                # upsert order — and is overwritten per node below.
                lv[j] = v.label_values.intern(first_name)
            else:
                lv[j] = v.label_values.intern(val)
                ln[j] = numeric_of(val)
        zid = (
            v.zones.intern(labels[ZONE_LABEL])
            if ZONE_LABEL in labels else NONE_ID
        )
        rid = (
            v.regions.intern(labels[REGION_LABEL])
            if REGION_LABEL in labels else NONE_ID
        )
        if zid >= spec.max_zones or rid >= spec.max_regions:
            raise ValueError(
                "zone/region id overflow; grow "
                "TableSpec.max_zones/max_regions"
            )
        t = _Template(lk, lv, ln, hpos, zid, rid)
        self._templates[blob] = t
        self._tlist.append(t)
        self._stack = None
        return t

    def _stacked(self) -> tuple:
        if self._stack is None:
            tl = self._tlist
            self._stack = (
                np.stack([t.lk for t in tl]),
                np.stack([t.lv for t in tl]),
                np.stack([t.ln for t in tl]),
                np.asarray([t.hpos for t in tl], np.int64),
                np.asarray([t.zid for t in tl], np.int32),
                np.asarray([t.rid for t in tl], np.int32),
            )
        return self._stack

    # -- ingest ----------------------------------------------------------

    def ingest(self, values) -> np.ndarray:
        """Upsert every encoded Node value (store bytes) into the host
        mirror; returns their rows in input order.  Byte-identical to
        ``[host.upsert(decode_node(v)) for v in values]``."""
        out = []
        for off in range(0, len(values), self.chunk):
            out.append(self._ingest_chunk(values[off:off + self.chunk]))
        if not out:
            return np.empty((0,), np.int64)
        return out[0] if len(out) == 1 else np.concatenate(out)

    def _ingest_chunk(self, values) -> np.ndarray:
        host = self.host
        v = host.vocab
        lv_id, lv_val = v.label_values._to_id, v.label_values._to_val
        nn_id, nn_val = v.node_names._to_id, v.node_names._to_val
        templates = self._templates
        fullmatch = CANONICAL_NODE_RE.fullmatch
        names: list[str] = []
        tmpl_idx: list[int] = []
        cpu: list[int] = []
        mem: list[int] = []
        pods: list[int] = []
        hid: list[int] = []
        nid: list[int] = []
        hnum: list[int] = []
        index_of = {id(t): i for i, t in enumerate(self._tlist)}
        for val in values:
            m = fullmatch(val)
            t = None
            if m is not None:
                blob = m.group(2)
                t = templates.get(blob)
                if t is None and blob not in templates:
                    if len(templates) >= self.template_cap:
                        t = None
                    else:
                        t = self._compile(blob, m.group(1).decode())
                        if t is not None:
                            index_of[id(t)] = len(self._tlist) - 1
            if t is None:
                # Non-canonical value / per-node blob / cache full: the
                # whole chunk takes the exact decode + bulk_upsert path
                # (prefix interning above matches the loop's order, so
                # re-interning below hits the same ids).
                return host.bulk_upsert([decode_node(x) for x in values])
            name = m.group(1).decode()
            names.append(name)
            tmpl_idx.append(index_of[id(t)])
            cpu.append(int(m.group(3)))
            mem.append(int(m.group(4)))
            pods.append(int(m.group(5)))
            # Hostname value and node name intern NOW, at this node's
            # position in the stream (intern-order identity).
            i = lv_id.get(name)
            if i is None:
                i = len(lv_val)
                lv_id[name] = i
                lv_val.append(name)
            hid.append(i)
            hnum.append(numeric_of(name))
            i = nn_id.get(name)
            if i is None:
                i = len(nn_val)
                nn_id[name] = i
                nn_val.append(name)
            nid.append(i)
        b = len(names)
        if not b:
            return np.empty((0,), np.int64)
        tlk, tlv, tln, thpos, tzid, trid = self._stacked()
        tidx = np.asarray(tmpl_idx, np.int64)
        ar = np.arange(b)
        lk_b = tlk[tidx]
        lv_b = tlv[tidx]
        ln_b = tln[tidx]
        hpos_b = thpos[tidx]
        lv_b[ar, hpos_b] = np.asarray(hid, np.int32)
        ln_b[ar, hpos_b] = np.asarray(hnum, np.int32)
        rows = host.bulk_alloc(names)
        host.valid[rows] = True
        host.cpu_alloc[rows] = np.asarray(cpu, np.int32)
        host.mem_alloc[rows] = np.asarray(mem, np.int32)
        host.pods_alloc[rows] = np.asarray(pods, np.int32)
        host.label_key[rows] = lk_b
        host.label_val[rows] = lv_b
        host.label_num[rows] = ln_b
        # Canonical nodes carry no taints; a re-upserted row must still
        # clear whatever a prior tainted generation wrote.
        host.taint_id[rows] = 0
        host.taint_effect[rows] = 0
        host.zone[rows] = tzid[tidx].astype(host.zone.dtype)
        host.region[rows] = trid[tidx].astype(host.region.dtype)
        host.name_id[rows] = np.asarray(nid, np.int32)
        _BULK_ROWS.inc(b)
        return rows


def bulk_ingest(host: NodeTableHost, values) -> np.ndarray:
    """One-shot convenience over ``BulkNodeLoader`` (tools, tests)."""
    return BulkNodeLoader(host).ingest(values)
