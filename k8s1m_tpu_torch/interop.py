"""Carry state across from the JAX package, as numpy arrays.

The port imports nothing of ``k8s1m_tpu``; a caller holding the JAX
package's state passes its arrays (``np.asarray`` of each field) and
receives the port's tensors, so both packages can compute on the same
state.  Specs are accepted as any object with the same fields (the JAX
package's frozen dataclasses) and converted to the port's own.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from k8s1m_tpu_torch.config import PodSpec, TableSpec
from k8s1m_tpu_torch.device import resolve_device, to_tensor
from k8s1m_tpu_torch.snapshot.constraints import FIELDS as CONSTRAINT_FIELDS
from k8s1m_tpu_torch.snapshot.constraints import ConstraintState
from k8s1m_tpu_torch.snapshot.node_table import COLUMNS, NodeTable
from k8s1m_tpu_torch.snapshot.packing import (
    PackedNodeTable,
    PackingSpec,
    packed_table_from_columns,
)
from k8s1m_tpu_torch.snapshot.pod_encoding import (
    PackedPodBatch,
    PodBatch,
    unpack_pod_batch,
)


def _as(cls, spec):
    """``spec`` as the port's ``cls`` (same field names and values)."""
    if spec is None or isinstance(spec, cls):
        return spec
    return cls(**{f.name: getattr(spec, f.name) for f in dataclasses.fields(cls)})


def node_table_from_numpy(
    cols: dict, packing=None, device: str | torch.device = "cuda"
) -> NodeTable | PackedNodeTable:
    """A device table from a dict of numpy columns.

    ``cols`` is ``{f: np.asarray(getattr(jax_table, f))}`` over the JAX
    table's fields: NodeTable names for the plain layout (``packing``
    None), PackedNodeTable names for the packed layout (``packing`` its
    PackingSpec).  Dtypes are kept as they are."""
    pspec = _as(PackingSpec, packing)
    if pspec is not None:
        fields = [f.name for f in dataclasses.fields(PackedNodeTable) if f.name != "spec"]
        return packed_table_from_columns({f: cols[f] for f in fields}, pspec, device)
    dev = resolve_device(device)
    return NodeTable(**{
        c: to_tensor(cols[c], dev) for c in COLUMNS
    })


def constraints_from_numpy(
    cols: dict, device: str | torch.device = "cuda"
) -> ConstraintState:
    """The port's ConstraintState from the nine count tables as numpy
    arrays (``{f: np.asarray(getattr(jax_state, f))}``)."""
    dev = resolve_device(device)
    return ConstraintState(**{
        f: to_tensor(np.asarray(cols[f], np.int32), dev) for f in CONSTRAINT_FIELDS
    })


def packed_pod_batch(ints, bools, spec, table_spec, groups) -> PackedPodBatch:
    """The port's PackedPodBatch (what ``schedule_batch_packed`` takes)
    from the JAX ``PackedPodBatch`` buffers and specs."""
    return PackedPodBatch(
        np.asarray(ints, np.int32), np.asarray(bools, np.bool_),
        _as(PodSpec, spec), _as(TableSpec, table_spec), frozenset(groups),
    )


def pod_batch_from_packed(
    ints, bools, spec, table_spec, groups, device: str | torch.device = "cuda"
) -> PodBatch:
    """A device PodBatch from the JAX ``PackedPodBatch`` buffers."""
    pb = packed_pod_batch(ints, bools, spec, table_spec, groups)
    return unpack_pod_batch(
        pb.ints, pb.bools, pb.spec, pb.table_spec, pb.groups, device=device
    )


def planes_from_numpy(mask, score, device: str | torch.device = "cuda"):
    """The deltasched planes (mask bool[S, N], score i32[S, N]) from the
    JAX package's cached plane arrays."""
    dev = resolve_device(device)
    return (to_tensor(np.asarray(mask, np.bool_), dev),
            to_tensor(np.asarray(score, np.int32), dev))


def index_from_numpy(row, cls, floor, device: str | torch.device = "cuda"):
    """The candidate-index triple (idx_row i32[S, K], idx_class i32[S, K],
    idx_floor i32[S]) from the JAX package's index arrays."""
    dev = resolve_device(device)
    return tuple(to_tensor(np.asarray(a, np.int32), dev) for a in (row, cls, floor))
