"""Replication: synchronous 2PC writes + async Merkle anti-entropy (port
of ``weaviate_tpu/replication``; it runs on the host and acts through the
collections it is given, whose shards keep their rows on their device).

Reference: usecases/replica/ — Replicator/coordinator (2PC,
coordinator.go:69,132,158), consistency levels (config.go), Finder reads
with digest comparison + read repair (repairer.go), hashtree/
(Merkle trees) + shard_hashbeater.go (background diff + propagation).
"""

from weaviate_tpu_torch.replication.finder import Finder
from weaviate_tpu_torch.replication.hashbeater import HashBeater
from weaviate_tpu_torch.replication.hashtree import MerkleTree
from weaviate_tpu_torch.replication.replicator import (
    ConsistencyError,
    Replicator,
    register_replication,
    required_acks,
)

__all__ = [
    "Finder",
    "HashBeater",
    "MerkleTree",
    "ConsistencyError",
    "Replicator",
    "register_replication",
    "required_acks",
]
