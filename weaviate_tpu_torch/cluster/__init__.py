"""Cluster layer (port of ``weaviate_tpu/cluster``).

Only the transport's error types are ported so far: the REST and gRPC
handlers map them to answers. Membership, Raft, the remote shard data
plane and the internal transport are ROADMAP Queue 1 item 7.
"""

from weaviate_tpu_torch.cluster.transport import CircuitOpenError, RpcError

__all__ = ["CircuitOpenError", "RpcError"]
