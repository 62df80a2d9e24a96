"""Cluster layer: membership, schema consensus, remote shard data plane
and the replica scaler (port of ``weaviate_tpu/cluster``).

Reference: usecases/cluster/ (memberlist gossip), cluster/ (raft schema
store), adapters/handlers/rest/clusterapi/ + adapters/clients/ (internal
HTTP data plane), usecases/sharding (remote index), usecases/scaler
(replication factor changes). 2PC writes, read repair and hashbeat live in
``weaviate_tpu_torch.replication``.
"""

from weaviate_tpu_torch.cluster.membership import Membership, NodeInfo
from weaviate_tpu_torch.cluster.node import ClusterNode
from weaviate_tpu_torch.cluster.raft import RaftNode
from weaviate_tpu_torch.cluster.remote import RemoteShardClient, register_incoming
from weaviate_tpu_torch.cluster.transport import (CircuitOpenError,
                                                  InternalServer, RpcError,
                                                  rpc)

__all__ = [
    "Membership",
    "NodeInfo",
    "ClusterNode",
    "RaftNode",
    "RemoteShardClient",
    "register_incoming",
    "InternalServer",
    "rpc",
    "CircuitOpenError",
    "RpcError",
]
