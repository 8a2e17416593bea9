"""The etcd v3 wire schema (``rpc.proto``, ``mvcc.proto``, ``batch.proto``)
and its hand codec (``codec.py``): the port speaks the wire without the
``protobuf`` package."""
