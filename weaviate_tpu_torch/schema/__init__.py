"""Schema: collection configs, properties, vector index configs."""

from weaviate_tpu_torch.schema.config import (
    CollectionConfig,
    InvertedIndexConfig,
    Property,
    ShardingConfig,
    MultiTenancyConfig,
    ReplicationConfig,
    VectorConfig,
    VectorIndexConfig,
    DataType,
)

__all__ = [
    "CollectionConfig",
    "InvertedIndexConfig",
    "Property",
    "ShardingConfig",
    "MultiTenancyConfig",
    "ReplicationConfig",
    "VectorConfig",
    "VectorIndexConfig",
    "DataType",
]
