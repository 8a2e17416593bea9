"""Host-side pod feature compiler: PodInfo -> fixed-shape pod-batch tensors.

Port of ``k8s1m_tpu/snapshot/pod_encoding.py``.  The host half (``PodInfo``
and friends, ``PodBatchHost.encode_packed``, the two-buffer
``PackedPodBatch``) is numpy and byte-identical to the JAX package's;
``unpack_pod_batch`` rebuilds a ``PodBatch`` of torch tensors on the
device from the two buffers, with the field groups the wave does not use
as zero tensors.

Tolerations are evaluated on the host against every distinct taint
triple the cluster has seen and ship as ``tolerated[B, max_taint_ids]``;
the device filter is an indexed load per taint slot, never a
(toleration x taint) comparison.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from k8s1m_tpu_torch.config import (
    NO_NUMERIC,
    NONE_ID,
    PodSpec,
    SEL_OP_GT,
    SEL_OP_LT,
    TableSpec,
)
from k8s1m_tpu_torch.device import resolve_device
from k8s1m_tpu_torch.semantics import pod_tolerates_taint
from k8s1m_tpu_torch.snapshot.interning import Vocab, numeric_of
from k8s1m_tpu_torch.snapshot.records import (  # noqa: F401 (re-exported)
    AffinityTermRef,
    NodeSelectorTerm,
    PodInfo,
    PreferredSchedulingTerm,
    SelectorRequirement,
    SpreadConstraintRef,
    Taint,
    Toleration,
)


@dataclasses.dataclass
class PodBatch:
    """Fixed-shape encoded pod batch (B pods, padded), torch tensors."""

    valid: torch.Tensor         # bool[B]
    cpu: torch.Tensor           # i32[B] milliCPU requested
    mem: torch.Tensor           # i32[B] KiB requested
    node_name_id: torch.Tensor  # i32[B] spec.nodeName (NONE_ID = unset, -1 = unknown node)
    tolerated: torch.Tensor     # bool[B, max_taint_ids]
    qkey: torch.Tensor          # i32[Q]
    sel_valid: torch.Tensor     # bool[B, S]
    sel_qidx: torch.Tensor      # i32[B, S]
    sel_val: torch.Tensor       # i32[B, S]
    req_term_valid: torch.Tensor  # bool[B, T]
    req_expr_valid: torch.Tensor  # bool[B, T, E]
    req_qidx: torch.Tensor        # i32[B, T, E]
    req_op: torch.Tensor          # i32[B, T, E]
    req_vals: torch.Tensor        # i32[B, T, E, V]
    req_num: torch.Tensor         # i32[B, T, E]
    pref_term_valid: torch.Tensor  # bool[B, P]
    pref_weight: torch.Tensor      # i32[B, P]
    pref_expr_valid: torch.Tensor  # bool[B, P, E]
    pref_qidx: torch.Tensor        # i32[B, P, E]
    pref_op: torch.Tensor          # i32[B, P, E]
    pref_vals: torch.Tensor        # i32[B, P, E, V]
    pref_num: torch.Tensor         # i32[B, P, E]
    spread_valid: torch.Tensor     # bool[B, SR]
    spread_cid: torch.Tensor
    spread_topo: torch.Tensor
    spread_max_skew: torch.Tensor
    spread_mode: torch.Tensor
    spread_self: torch.Tensor
    ipa_valid: torch.Tensor        # bool[B, AR]
    ipa_tid: torch.Tensor
    ipa_topo: torch.Tensor
    ipa_required: torch.Tensor
    ipa_anti: torch.Tensor
    ipa_weight: torch.Tensor
    ipa_self: torch.Tensor
    sinc_valid: torch.Tensor       # bool[B, SI]
    sinc_cid: torch.Tensor
    sinc_topo: torch.Tensor
    iinc_valid: torch.Tensor       # bool[B, AI]
    iinc_tid: torch.Tensor
    iinc_topo: torch.Tensor

    @property
    def batch(self) -> int:
        return self.valid.shape[0]


@functools.lru_cache(maxsize=16)
def batch_field_specs(
    s: PodSpec, t: TableSpec
) -> tuple[tuple[str, bool, tuple[int, ...]], ...]:
    """(name, is_bool, shape) for every PodBatch field, in field order —
    the one source of the encode allocation and the packed buffer layout.
    Shapes derive from the static specs alone, never from vocab ids."""
    b = s.batch
    shapes: dict[str, tuple[bool, tuple[int, ...]]] = dict(
        valid=(True, (b,)), cpu=(False, (b,)), mem=(False, (b,)),
        node_name_id=(False, (b,)),
        tolerated=(True, (b, t.max_taint_ids)),
        qkey=(False, (s.query_keys,)),
        sel_valid=(True, (b, s.aff_exprs)),
        sel_qidx=(False, (b, s.aff_exprs)),
        sel_val=(False, (b, s.aff_exprs)),
        req_term_valid=(True, (b, s.aff_terms)),
        req_expr_valid=(True, (b, s.aff_terms, s.aff_exprs)),
        req_qidx=(False, (b, s.aff_terms, s.aff_exprs)),
        req_op=(False, (b, s.aff_terms, s.aff_exprs)),
        req_vals=(False, (b, s.aff_terms, s.aff_exprs, s.aff_values)),
        req_num=(False, (b, s.aff_terms, s.aff_exprs)),
        pref_term_valid=(True, (b, s.pref_terms)),
        pref_weight=(False, (b, s.pref_terms)),
        pref_expr_valid=(True, (b, s.pref_terms, s.aff_exprs)),
        pref_qidx=(False, (b, s.pref_terms, s.aff_exprs)),
        pref_op=(False, (b, s.pref_terms, s.aff_exprs)),
        pref_vals=(False, (b, s.pref_terms, s.aff_exprs, s.aff_values)),
        pref_num=(False, (b, s.pref_terms, s.aff_exprs)),
        spread_valid=(True, (b, s.spread_refs)),
        spread_cid=(False, (b, s.spread_refs)),
        spread_topo=(False, (b, s.spread_refs)),
        spread_max_skew=(False, (b, s.spread_refs)),
        spread_mode=(False, (b, s.spread_refs)),
        spread_self=(True, (b, s.spread_refs)),
        ipa_valid=(True, (b, s.affinity_refs)),
        ipa_tid=(False, (b, s.affinity_refs)),
        ipa_topo=(False, (b, s.affinity_refs)),
        ipa_required=(True, (b, s.affinity_refs)),
        ipa_anti=(True, (b, s.affinity_refs)),
        ipa_weight=(False, (b, s.affinity_refs)),
        ipa_self=(True, (b, s.affinity_refs)),
        sinc_valid=(True, (b, s.spread_incs)),
        sinc_cid=(False, (b, s.spread_incs)),
        sinc_topo=(False, (b, s.spread_incs)),
        iinc_valid=(True, (b, s.ipa_incs)),
        iinc_tid=(False, (b, s.ipa_incs)),
        iinc_topo=(False, (b, s.ipa_incs)),
    )
    names = [f.name for f in dataclasses.fields(PodBatch)]
    if set(names) != set(shapes):
        raise AssertionError(set(names) ^ set(shapes))
    return tuple((n, *shapes[n]) for n in names)


# Field groups for sparse transfer: a group rides the packed buffers only
# when some pod in the wave sets it (detected from its sentinel array).
_GROUP_FIELDS: dict[str, tuple[str, ...]] = {
    "tol": ("tolerated",),
    "sel": ("sel_valid", "sel_qidx", "sel_val"),
    "req": ("req_term_valid", "req_expr_valid", "req_qidx", "req_op",
            "req_vals", "req_num"),
    "pref": ("pref_term_valid", "pref_weight", "pref_expr_valid",
             "pref_qidx", "pref_op", "pref_vals", "pref_num"),
    "spread": ("spread_valid", "spread_cid", "spread_topo",
               "spread_max_skew", "spread_mode", "spread_self"),
    "ipa": ("ipa_valid", "ipa_tid", "ipa_topo", "ipa_required", "ipa_anti",
            "ipa_weight", "ipa_self"),
    "sinc": ("sinc_valid", "sinc_cid", "sinc_topo"),
    "iinc": ("iinc_valid", "iinc_tid", "iinc_topo"),
    "qkey": ("qkey",),
}
_GROUP_SENTINEL: dict[str, str] = {
    "tol": "tolerated", "sel": "sel_valid", "req": "req_term_valid",
    "pref": "pref_term_valid", "spread": "spread_valid",
    "ipa": "ipa_valid", "sinc": "sinc_valid", "iinc": "iinc_valid",
}
_GROUP_OF: dict[str, str] = {
    f: g for g, fs in _GROUP_FIELDS.items() for f in fs
}
ALL_GROUPS: frozenset = frozenset(_GROUP_FIELDS)


@dataclasses.dataclass
class PackedPodBatch:
    """A pod batch as two host buffers (all-int32, all-bool) holding only
    the field groups this wave uses, plus the full host field dict."""

    ints: np.ndarray    # i32[sum of included int field sizes]
    bools: np.ndarray   # bool[sum of included bool field sizes]
    spec: PodSpec
    table_spec: TableSpec
    groups: frozenset   # included group names
    # name -> host numpy array, every field (excluded groups zero): what
    # the coordinator's constraint rollback reads a wave or more later.
    fields: dict | None = None
    # Vocab.feed_generation() the encode ran against (snapshot/hotfeed.py
    # stamps it); None = vocab-independent (the plain lane).
    vocab_gen: int | None = None

    @property
    def batch(self) -> int:
        return self.spec.batch


def unpack_pod_batch(
    ints,
    bools,
    spec: PodSpec,
    table_spec: TableSpec,
    groups: frozenset = ALL_GROUPS,
    device: str | torch.device = "cuda",
) -> PodBatch:
    """Rebuild a PodBatch on ``device`` from the packed buffers: two
    host-to-device copies, then views.  Fields of groups not in
    ``groups`` become zero tensors."""
    dev = resolve_device(device)
    ints_d = torch.as_tensor(np.asarray(ints, np.int32)).to(dev)
    bools_d = torch.as_tensor(np.asarray(bools, np.bool_)).to(dev)
    out = {}
    io = bo = 0
    for name, is_bool, shape in batch_field_specs(spec, table_spec):
        group = _GROUP_OF.get(name)
        if group is not None and group not in groups:
            out[name] = torch.zeros(
                shape, dtype=torch.bool if is_bool else torch.int32, device=dev
            )
            continue
        n = math.prod(shape)
        if is_bool:
            out[name] = bools_d[bo : bo + n].view(shape)
            bo += n
        else:
            out[name] = ints_d[io : io + n].view(shape)
            io += n
    return PodBatch(**out)


class PodBatchHost:
    """Compiles a list of PodInfo into one packed pod batch."""

    def __init__(self, spec: PodSpec, table_spec: TableSpec, vocab: Vocab) -> None:
        self.spec = spec
        self.table_spec = table_spec
        self.vocab = vocab

    def _zeros(self) -> dict:
        return {
            name: np.zeros(shape, np.bool_ if is_bool else np.int32)
            for name, is_bool, shape in batch_field_specs(self.spec, self.table_spec)
        }

    def _pack(self, out: dict, groups: frozenset) -> PackedPodBatch:
        int_parts, bool_parts = [], []
        for name, is_bool, _shape in batch_field_specs(self.spec, self.table_spec):
            g = _GROUP_OF.get(name)
            if g is not None and g not in groups:
                continue
            (bool_parts if is_bool else int_parts).append(out[name].ravel())
        ints = np.concatenate(int_parts) if int_parts else np.zeros(0, np.int32)
        bools = np.concatenate(bool_parts) if bool_parts else np.zeros(0, np.bool_)
        return PackedPodBatch(ints, bools, self.spec, self.table_spec, groups, fields=out)

    def encode_packed(self, pods: list[PodInfo]) -> PackedPodBatch:
        """Encode into the sparse two-buffer packed form."""
        out = self._zeros()
        self._fill(out, pods)
        groups = {
            g for g, sentinel in _GROUP_SENTINEL.items() if out[sentinel].any()
        }
        if groups & {"sel", "req", "pref"}:
            groups.add("qkey")
        return self._pack(out, frozenset(groups))

    def encode(self, pods: list[PodInfo], device: str | torch.device = "cuda") -> PodBatch:
        """Encode into an unpacked PodBatch on ``device``: every field,
        absent groups as zeros — field for field what ``unpack_pod_batch``
        gives for ``encode_packed`` of the same pods."""
        dev = resolve_device(device)
        out = self._zeros()
        self._fill(out, pods)
        return PodBatch(**{k: torch.from_numpy(a).to(dev, copy=True) for k, a in out.items()})

    def encode_packed_plain(self, cpu, mem) -> PackedPodBatch:
        """Packed encode of a wave of plain pods (no selectors,
        tolerations, affinity or constraint refs) from their cpu/mem
        columns alone — identical to ``encode_packed`` on the equivalent
        PodInfos."""
        out = self._zeros()
        n = len(cpu)
        if n > self.spec.batch:
            raise ValueError(f"{n} pods > batch {self.spec.batch}")
        out["valid"][:n] = True
        out["cpu"][:n] = cpu
        out["mem"][:n] = mem
        return self._pack(out, frozenset())

    def _fill(self, out: dict, pods: list[PodInfo]) -> None:
        s = self.spec
        b = s.batch
        if len(pods) > b:
            raise ValueError(f"{len(pods)} pods > batch {b}")
        v = self.vocab

        # Per-batch query-key table.  Index 0 is reserved for "key NONE".
        qidx_of: dict[str, int] = {}

        def qidx(key: str) -> int:
            i = qidx_of.get(key)
            if i is None:
                i = len(qidx_of) + 1
                if i >= s.query_keys:
                    raise ValueError(
                        f"batch references >{s.query_keys - 1} distinct selector "
                        "keys; grow PodSpec.query_keys"
                    )
                qidx_of[key] = i
                out["qkey"][i] = v.label_keys.lookup(key)
            return i

        n = len(pods)
        out["valid"][:n] = True
        out["cpu"][:n] = np.fromiter((p.cpu_milli for p in pods), np.int32, n)
        out["mem"][:n] = np.fromiter((p.mem_kib for p in pods), np.int32, n)
        taints = list(v.taints.items())

        for i, pod in enumerate(pods):
            # spec.nodeName naming a node never seen must match nothing
            # (not "unset"), hence the -1 sentinel.
            if pod.node_name is not None:
                nid = v.node_names.lookup(pod.node_name)
                out["node_name_id"][i] = nid if nid != NONE_ID else -1
            self._fill_pod(out, i, pod, qidx, taints)

    def _fill_pod(self, out: dict, i: int, pod: PodInfo, qidx, taints) -> None:
        """Encode one pod's structural features into row ``i`` of ``out``."""
        s = self.spec
        v = self.vocab

        if taints and pod.tolerations:
            for tid, (tkey, tval, teffect) in taints:
                out["tolerated"][i, tid] = pod_tolerates_taint(
                    pod.tolerations, Taint(tkey, tval, teffect)
                )

        if not (
            pod.node_selector or pod.required_terms or pod.preferred_terms
            or pod.spread_refs or pod.affinity_refs or pod.spread_incs
            or pod.ipa_incs
        ):
            return    # plain pod: everything below stays zero

        if len(pod.node_selector) > s.aff_exprs:
            raise ValueError(f"pod {pod.key}: nodeSelector too large")
        for j, (k, val) in enumerate(sorted(pod.node_selector.items())):
            out["sel_valid"][i, j] = True
            out["sel_qidx"][i, j] = qidx(k)
            out["sel_val"][i, j] = v.label_values.lookup(val)

        if len(pod.required_terms) > s.aff_terms:
            raise ValueError(f"pod {pod.key}: too many required affinity terms")
        for j, term in enumerate(pod.required_terms):
            out["req_term_valid"][i, j] = True
            self._encode_exprs(
                qidx, i, j, term.match_expressions, out["req_expr_valid"],
                out["req_qidx"], out["req_op"], out["req_vals"], out["req_num"],
            )
        if len(pod.preferred_terms) > s.pref_terms:
            raise ValueError(f"pod {pod.key}: too many preferred terms")
        for j, pt in enumerate(pod.preferred_terms):
            out["pref_term_valid"][i, j] = True
            out["pref_weight"][i, j] = pt.weight
            self._encode_exprs(
                qidx, i, j, pt.term.match_expressions, out["pref_expr_valid"],
                out["pref_qidx"], out["pref_op"], out["pref_vals"], out["pref_num"],
            )

        if len(pod.spread_refs) > s.spread_refs:
            raise ValueError(f"pod {pod.key}: too many spread constraints")
        for j, ref in enumerate(pod.spread_refs):
            out["spread_valid"][i, j] = True
            out["spread_cid"][i, j] = ref.cid
            out["spread_topo"][i, j] = ref.topo
            out["spread_max_skew"][i, j] = ref.max_skew
            out["spread_mode"][i, j] = ref.mode
            out["spread_self"][i, j] = ref.self_match
        if len(pod.affinity_refs) > s.affinity_refs:
            raise ValueError(f"pod {pod.key}: too many affinity terms")
        for j, ref in enumerate(pod.affinity_refs):
            out["ipa_valid"][i, j] = True
            out["ipa_tid"][i, j] = ref.tid
            out["ipa_topo"][i, j] = ref.topo
            out["ipa_required"][i, j] = ref.required
            out["ipa_anti"][i, j] = ref.anti
            out["ipa_weight"][i, j] = ref.weight
            out["ipa_self"][i, j] = ref.self_match

        if len(pod.spread_incs) > s.spread_incs:
            raise ValueError(f"pod {pod.key}: too many spread increments")
        for j, (cid, topo) in enumerate(pod.spread_incs):
            out["sinc_valid"][i, j] = True
            out["sinc_cid"][i, j] = cid
            out["sinc_topo"][i, j] = topo
        if len(pod.ipa_incs) > s.ipa_incs:
            raise ValueError(f"pod {pod.key}: too many affinity increments")
        for j, (tid, topo) in enumerate(pod.ipa_incs):
            out["iinc_valid"][i, j] = True
            out["iinc_tid"][i, j] = tid
            out["iinc_topo"][i, j] = topo

    def _encode_exprs(self, qidx, i, j, exprs, expr_valid, qidx_arr, op, vals, num):
        s = self.spec
        v = self.vocab
        if len(exprs) > s.aff_exprs:
            raise ValueError("too many match expressions in a term")
        for e, req in enumerate(exprs):
            expr_valid[i, j, e] = True
            qidx_arr[i, j, e] = qidx(req.key)
            op[i, j, e] = req.op
            if req.op in (SEL_OP_GT, SEL_OP_LT):
                # Missing/unparseable operand -> unsatisfiable (NO_NUMERIC).
                num[i, j, e] = (
                    numeric_of(req.values[0]) if req.values else NO_NUMERIC
                )
            else:
                if len(req.values) > s.aff_values:
                    raise ValueError("too many values in a match expression")
                for k, val in enumerate(req.values):
                    vals[i, j, e, k] = v.label_values.lookup(val)
