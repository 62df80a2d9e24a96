"""Cluster layer: membership, schema consensus, remote shard data plane
(port of ``weaviate_tpu/cluster``, replication factor 1).

Reference: usecases/cluster/ (memberlist gossip), cluster/ (raft schema
store), adapters/handlers/rest/clusterapi/ + adapters/clients/ (internal
HTTP data plane), usecases/sharding (remote index). Replication (the
scaler, 2PC, read repair, hashbeat) is ROADMAP Queue 1 item 7b.
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
