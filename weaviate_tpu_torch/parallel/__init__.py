"""Device-mesh parallelism: row-sharded corpora and the candidate merge
(port of ``weaviate_tpu/parallel``).

Each shard of a corpus lives on its mesh device and scans its own rows;
the per-shard top-k candidates merge in one step on the 1-D mesh, or in
two levels (inside a host, then across hosts) on the hierarchical one.
"""

from weaviate_tpu_torch.parallel.mesh import (
    Mesh,
    default_mesh,
    device_count,
    host_count,
    is_hierarchical,
    make_hierarchical_mesh,
    make_mesh,
    n_row_shards,
    shardable_capacity,
)
from weaviate_tpu_torch.parallel.partition import match_partition_rules
from weaviate_tpu_torch.parallel.sharded_search import sharded_topk

__all__ = [
    "Mesh",
    "default_mesh",
    "device_count",
    "host_count",
    "is_hierarchical",
    "make_hierarchical_mesh",
    "make_mesh",
    "match_partition_rules",
    "n_row_shards",
    "shardable_capacity",
    "sharded_topk",
]
