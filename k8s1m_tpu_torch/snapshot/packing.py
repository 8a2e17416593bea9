"""Packed device snapshot: bit/byte-packed cold node-table columns.

Port of ``k8s1m_tpu/snapshot/packing.py``, the production layout:

- ``meta`` word — row validity (bit 0) and all ``taint_slots`` 2-bit
  taint effects (bits ``1+2t``..``2+2t``) in ONE i32 per node;
- label fusion  — ``label_key``/``label_val`` fused into one i32 word per
  slot (``val << key_bits | key``) while the vocab fits the bit budget;
  fail-closed ``PackingOverflow`` past it, never an aliased id;
- narrow planes — ``zone``/``region``/``pods_alloc``/``taint_id`` drop to
  int16/int8 where the TableSpec bounds permit.

The host packing (``pack_columns_np``) is numpy and byte-identical to the
JAX package's.  The fused kernel reads the packed planes directly and
decodes in registers; ``unpack_chunk`` is the tensor decode the plain
paths use.  The hot columns (cpu/mem allocatable, the request columns the
commit updates every wave) stay plain i32.
"""

from __future__ import annotations

import dataclasses
import logging
import os

import numpy as np
import torch

from k8s1m_tpu_torch.config import TableSpec
from k8s1m_tpu_torch.device import resolve_device, to_tensor
from k8s1m_tpu_torch.snapshot.node_table import NodeTable, NodeTableHost, _map_tensors

# Columns the packed layout compresses, in NodeTable naming (the
# bytes/node evidence compares exactly this set between layouts).
COLD_COLUMNS = (
    "label_key", "label_val", "taint_id", "taint_effect", "valid",
    "zone", "region", "pods_alloc",
)

# Default label-fusion bit budget: 4096 distinct label keys and 512K
# distinct label values before the fail-closed split.
DEFAULT_KEY_BITS = 12
DEFAULT_VAL_BITS = 19


class PackingOverflow(ValueError):
    """A value no longer fits its packed width: rebuild under a wider
    layout, never truncate."""

    def __init__(self, field: str, msg: str):
        super().__init__(msg)
        self.field = field


# Every reason a coordinator's packed layout can fall back for: the
# PackingOverflow field names plus the static fallback (meta word too
# narrow for the TableSpec's taint slots).
FALLBACK_REASONS = (
    "label_key", "label_val", "taint_id", "taint_effect",
    "zone", "region", "pods_alloc", "taint_slots",
)


def resolve_packing(arg: str | None = None) -> str:
    """Packing mode from an explicit arg or the K8S1M_PACKING env var:
    "off" or "packed"; unknown values raise."""
    mode = arg if arg is not None else os.environ.get("K8S1M_PACKING", "off")
    if mode not in ("off", "packed"):
        raise ValueError(f"K8S1M_PACKING/packing must be off|packed, got {mode!r}")
    return mode


@dataclasses.dataclass(frozen=True)
class PackingSpec:
    """Static description of the packed layout ("off" is the absence of
    a spec)."""

    fuse_labels: bool = True
    key_bits: int = DEFAULT_KEY_BITS
    val_bits: int = DEFAULT_VAL_BITS
    taint_slots: int = 8
    zone_dtype: str = "int16"
    region_dtype: str = "int8"
    pods_dtype: str = "int16"
    taint_id_dtype: str = "int16"


def build_packing_spec(
    table_spec: TableSpec,
    vocab=None,
    *,
    fuse_labels: bool = True,
    key_bits: int = DEFAULT_KEY_BITS,
    val_bits: int = DEFAULT_VAL_BITS,
) -> PackingSpec | None:
    """The packed layout this TableSpec (and current vocab) supports;
    None when the taint effects do not fit the meta word."""
    if 1 + 2 * table_spec.taint_slots > 31:
        return None
    if key_bits + val_bits > 31:
        raise ValueError(
            f"key_bits {key_bits} + val_bits {val_bits} > 31 (sign bit)"
        )
    if vocab is not None:
        if (len(vocab.label_keys) >= (1 << key_bits)
                or len(vocab.label_values) >= (1 << val_bits)):
            fuse_labels = False
    return PackingSpec(
        fuse_labels=fuse_labels,
        key_bits=key_bits,
        val_bits=val_bits,
        taint_slots=table_spec.taint_slots,
        zone_dtype="int16" if table_spec.max_zones <= (1 << 15) else "int32",
        region_dtype=(
            "int8" if table_spec.max_regions <= (1 << 7)
            else "int16" if table_spec.max_regions <= (1 << 15)
            else "int32"
        ),
        pods_dtype="int16",
        taint_id_dtype=(
            "int16" if table_spec.max_taint_ids <= (1 << 15) else "int32"
        ),
    )


@dataclasses.dataclass
class DomainView:
    """The three full columns ``topology.prologue`` needs, decoded once
    per wave (global domain statistics do not belong in a chunk decode)."""

    valid: torch.Tensor    # bool[N]
    zone: torch.Tensor     # i32[N]
    region: torch.Tensor   # i32[N]


@dataclasses.dataclass
class PackedNodeTable:
    """Device-resident packed snapshot (the production layout).

    Columns the engine touches without decoding keep their NodeTable
    names, so ``commit_binds`` works on either layout.  With
    ``spec.fuse_labels``, ``label_key`` holds the fused words and
    ``label_val`` is an empty ``i32[N, 0]`` plane.
    """

    cpu_alloc: torch.Tensor    # i32[N]
    mem_alloc: torch.Tensor    # i32[N]
    cpu_req: torch.Tensor      # i32[N]
    mem_req: torch.Tensor      # i32[N]
    pods_req: torch.Tensor     # i32[N]
    name_id: torch.Tensor      # i32[N]
    label_num: torch.Tensor    # i32[N, L]
    meta: torch.Tensor         # i32[N] valid bit + 2-bit taint effects
    label_key: torch.Tensor    # i32[N, L] fused words (or plain keys)
    label_val: torch.Tensor    # i32[N, L] plain values (or [N, 0])
    taint_id: torch.Tensor     # int16/i32[N, T]
    zone: torch.Tensor         # int16/i32[N]
    region: torch.Tensor       # int8/int16/i32[N]
    pods_alloc: torch.Tensor   # int16[N]
    spec: PackingSpec

    @property
    def num_rows(self) -> int:
        return self.meta.shape[0]

    def free(self):
        """(cpu, mem, pods) still unrequested (pods widens the narrow plane)."""
        return (
            self.cpu_alloc - self.cpu_req,
            self.mem_alloc - self.mem_req,
            self.pods_alloc.to(torch.int32) - self.pods_req,
        )

    def narrow(self, start: int, rows: int):
        """Row window ``[start, start+rows)`` as views (no copy)."""
        return _map_tensors(self, lambda t: t.narrow(0, start, rows))

    def clone(self):
        return _map_tensors(self, torch.clone)

    def domain_view(self) -> DomainView:
        return DomainView(
            valid=(self.meta & 1) != 0,
            zone=self.zone.to(torch.int32),
            region=self.region.to(torch.int32),
        )


def is_packed(table) -> bool:
    return isinstance(table, PackedNodeTable)


def table_bytes(table) -> int:
    """Total device bytes of a NodeTable or PackedNodeTable (of every
    storage of a mesh's ShardedTable)."""
    parts = getattr(table, "parts", None)
    if parts is not None:
        return sum(table_bytes(p) for p in parts)
    return sum(
        t.numel() * t.element_size()
        for t in vars(table).values() if isinstance(t, torch.Tensor)
    )


# ---- host-side packing -----------------------------------------------------


def _check_range(field: str, arr: np.ndarray, hi: int) -> None:
    if arr.size and int(arr.max(initial=0)) >= hi:
        raise PackingOverflow(
            field,
            f"{field} id {int(arr.max())} >= packed bound {hi} "
            "(vocab drift past the static bit budget; fail closed and "
            "rebuild under a wider layout)",
        )


def pack_meta_np(valid: np.ndarray, taint_effect: np.ndarray) -> np.ndarray:
    """(valid bool[R], taint_effect i32[R, T]) -> meta i32[R]; an effect
    past the 2-bit budget raises."""
    _check_range("taint_effect", taint_effect, 4)
    meta = valid.astype(np.int32)
    for t in range(taint_effect.shape[1]):
        meta = meta | ((taint_effect[:, t].astype(np.int32) & 3) << (1 + 2 * t))
    return meta


def pack_columns_np(cols: dict, pspec: PackingSpec) -> dict:
    """Pack a dict of host (numpy) NodeTable columns into the packed
    column dict (PackedNodeTable field names); partial dicts pack the
    subset their keys imply.  Range checks raise PackingOverflow."""
    out: dict = {}
    for name in ("cpu_alloc", "mem_alloc", "cpu_req", "mem_req",
                 "pods_req", "name_id", "label_num"):
        if name in cols:
            out[name] = cols[name]
    if "valid" in cols:
        out["meta"] = pack_meta_np(cols["valid"], cols["taint_effect"])
    if "label_key" in cols:
        lk = cols["label_key"]
        lv = cols["label_val"]
        if pspec.fuse_labels:
            _check_range("label_key", lk, 1 << pspec.key_bits)
            _check_range("label_val", lv, 1 << pspec.val_bits)
            out["label_key"] = (
                (lv.astype(np.int32) << pspec.key_bits) | lk.astype(np.int32)
            )
            out["label_val"] = np.zeros((lk.shape[0], 0), np.int32)
        else:
            out["label_key"] = lk
            out["label_val"] = lv
    if "taint_id" in cols:
        dt = np.dtype(pspec.taint_id_dtype)
        _check_range("taint_id", cols["taint_id"], 1 << (8 * dt.itemsize - 1))
        out["taint_id"] = cols["taint_id"].astype(dt)
    for name, dtype in (
        ("zone", pspec.zone_dtype),
        ("region", pspec.region_dtype),
        ("pods_alloc", pspec.pods_dtype),
    ):
        if name in cols:
            dt = np.dtype(dtype)
            _check_range(name, cols[name], 1 << (8 * dt.itemsize - 1))
            out[name] = cols[name].astype(dt)
    return out


def packed_table_from_columns(packed: dict, pspec: PackingSpec, device) -> PackedNodeTable:
    """A PackedNodeTable on ``device`` from packed numpy columns."""
    dev = resolve_device(device)
    return PackedNodeTable(spec=pspec, **{
        k: to_tensor(v, dev)
        for k, v in packed.items()
    })


def pack_table_host(
    host: NodeTableHost, pspec: PackingSpec, device: str | torch.device = "cuda"
) -> PackedNodeTable:
    """Pack the full host mirror into a device PackedNodeTable (the
    packed counterpart of ``NodeTableHost.to_device``)."""
    return packed_table_from_columns(
        pack_columns_np(host.columns(), pspec), pspec, device
    )


def pack_table_auto(
    host: NodeTableHost, table_spec: TableSpec, device: str | torch.device = "cuda"
):
    """Pack under the layout this TableSpec + vocab support, falling back
    LOUDLY (a warning) to the plain layout when packing cannot apply;
    callers report the layout they got (``is_packed``)."""
    pspec = build_packing_spec(table_spec, host.vocab)
    if pspec is None:
        logging.getLogger(__name__).warning(
            "packing requested but taint_slots=%d does not fit the meta "
            "word; building the UNPACKED layout", table_spec.taint_slots,
        )
        return host.to_device(device)
    return pack_table_host(host, pspec, device)


def pack_row_delta(host: NodeTableHost, rows: np.ndarray, pspec: PackingSpec, columns) -> dict:
    """Packed dirty-row delta for ``scatter_rows``: the packed-layout
    equivalent of ``{c: getattr(host, c)[rows] for c in columns}``.
    ``columns`` is CAP_COLUMNS or ALL_COLUMNS (NodeTable naming); the
    returned dict uses PackedNodeTable field names."""
    cols = {c: getattr(host, c)[rows] for c in columns}
    return pack_columns_np(cols, pspec)


# ---- device-side unpacking -------------------------------------------------


def unpack_chunk(chunk: PackedNodeTable) -> NodeTable:
    """Decode a packed row slice into the plain NodeTable layout."""
    p = chunk.spec
    meta = chunk.meta
    taint_effect = torch.stack(
        [(meta >> (1 + 2 * t)) & 3 for t in range(p.taint_slots)], dim=1
    )
    if p.fuse_labels:
        label_key = chunk.label_key & ((1 << p.key_bits) - 1)
        label_val = chunk.label_key >> p.key_bits
    else:
        label_key = chunk.label_key
        label_val = chunk.label_val
    i32 = torch.int32
    return NodeTable(
        valid=(meta & 1) != 0,
        cpu_alloc=chunk.cpu_alloc,
        mem_alloc=chunk.mem_alloc,
        pods_alloc=chunk.pods_alloc.to(i32),
        cpu_req=chunk.cpu_req,
        mem_req=chunk.mem_req,
        pods_req=chunk.pods_req,
        label_key=label_key,
        label_val=label_val,
        label_num=chunk.label_num,
        taint_id=chunk.taint_id.to(i32),
        taint_effect=taint_effect,
        zone=chunk.zone.to(i32),
        region=chunk.region.to(i32),
        name_id=chunk.name_id,
    )


def mask_rows_packed(table: PackedNodeTable, row_mask: torch.Tensor) -> PackedNodeTable:
    """``engine.cycle.mask_rows`` for the packed layout: rows outside the
    mask lose their valid bit and their ``pods_alloc`` (the fused
    kernel's row-validity rule), in a new view; the commit state (request
    columns) is shared with ``table``."""
    return dataclasses.replace(
        table,
        meta=torch.where(row_mask, table.meta, table.meta & ~1),
        pods_alloc=torch.where(row_mask, table.pods_alloc,
                               torch.zeros((), dtype=table.pods_alloc.dtype,
                                           device=table.pods_alloc.device)),
    )


# ---- in-place evidence -------------------------------------------------------

# The planes every wave commits into or every scatter writes (i32[N]).
_HOT_PLANES = (
    "cpu_alloc", "mem_alloc", "cpu_req", "mem_req", "pods_req", "name_id",
)


def donation_probe(table) -> frozenset:
    """Storage pointers of the table's hot planes, read before a wave:
    the port's counterpart of the JAX package's buffer-donation probe
    (over every storage of a mesh's ShardedTable)."""
    parts = getattr(table, "parts", None)
    if parts is not None:
        return frozenset().union(*(donation_probe(p) for p in parts))
    return frozenset(getattr(table, c).data_ptr() for c in _HOT_PLANES)


def donation_inplace(table, probe: frozenset) -> bool:
    """True when the post-wave table still holds every probed plane (the
    wave committed in place, as ``commit_binds`` and ``scatter_rows``
    do); False would mean a plane was reallocated."""
    parts = getattr(table, "parts", None)
    if parts is not None:
        return all(donation_inplace(p, probe) for p in parts)
    return all(getattr(table, c).data_ptr() in probe for c in _HOT_PLANES)


# ---- device bytes ------------------------------------------------------------


# The JAX package's name for the same count.
hbm_bytes = table_bytes


_PACKED_COLD = (
    "label_key", "label_val", "taint_id", "meta", "zone", "region",
    "pods_alloc",
)


def cold_bytes_per_node(table) -> float:
    """Bytes/node of the COLD_COLUMNS set under the table's layout."""
    names = _PACKED_COLD if is_packed(table) else COLD_COLUMNS
    return sum(
        getattr(table, c).numel() * getattr(table, c).element_size() for c in names
    ) / max(table.num_rows, 1)


def unpacked_cold_bytes(table_spec: TableSpec) -> float:
    """COLD_COLUMNS bytes/node under the plain i32 layout — the fixed
    denominator of the reduction ratio."""
    l, t = table_spec.label_slots, table_spec.taint_slots
    #      label_key+label_val  taint_id+effect  valid  zone+region+pods
    return 8 * l + 8 * t + 1 + 4 + 4 + 4


def bytes_report(table, table_spec: TableSpec | None = None) -> dict:
    """Layout evidence for a report: layout name, total and cold
    bytes/node and (given the TableSpec) the cold-column reduction
    against the plain layout."""
    n = max(table.num_rows, 1)
    # A mesh's ShardedTable: the layout of its shards, the bytes of every
    # storage over the global rows.
    layout = getattr(table, "parts", [table])[0]
    out = {
        "layout": "packed" if is_packed(layout) else "unpacked",
        "hbm_bytes_per_node": round(hbm_bytes(table) / n, 2),
        "cold_bytes_per_node": round(cold_bytes_per_node(layout), 3),
    }
    if table_spec is not None:
        out["cold_bytes_reduction"] = round(
            unpacked_cold_bytes(table_spec) / max(out["cold_bytes_per_node"], 1e-9), 3,
        )
    return out
