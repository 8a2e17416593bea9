"""The dp x sp mesh: ``mesh`` (the device grid and the sharded state),
``sharded_cycle`` (the sharded wave) and ``multihost`` (one process per
host).  The exports mirror the JAX package's ``k8s1m_tpu.parallel``; the
port's splits (``shard_table``, ``shard_constraints``, ``slice_batch``)
take the place of its ``table_specs``/``batch_specs``."""

from k8s1m_tpu_torch.parallel.mesh import (
    MESH_ENV,
    Mesh,
    ShardedConstraints,
    ShardedTable,
    ShardedTensor,
    auto_mesh_shape,
    make_mesh,
    parse_mesh,
    resolve_mesh,
    shard_constraints,
    shard_planes,
    shard_table,
    slice_batch,
)
from k8s1m_tpu_torch.parallel.sharded_cycle import (
    make_sharded_packed_step,
    make_sharded_step,
)

__all__ = [
    "MESH_ENV",
    "Mesh",
    "ShardedConstraints",
    "ShardedTable",
    "ShardedTensor",
    "auto_mesh_shape",
    "make_mesh",
    "parse_mesh",
    "resolve_mesh",
    "shard_constraints",
    "shard_planes",
    "shard_table",
    "slice_batch",
    "make_sharded_step",
    "make_sharded_packed_step",
]
