"""Host-side persistence: object codec, WAL, LSM-style KV store.

Copied from the JAX package with only its import lines changed, so a
data directory written by either package opens in the other.
"""

from weaviate_tpu_torch.storage.objects import StorageObject
from weaviate_tpu_torch.storage.wal import WriteAheadLog
from weaviate_tpu_torch.storage.kv import KVStore, Bucket

__all__ = ["StorageObject", "WriteAheadLog", "KVStore", "Bucket"]
