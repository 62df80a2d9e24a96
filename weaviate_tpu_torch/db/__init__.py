"""Database / collection / shard layers of the port."""

from weaviate_tpu_torch.db.collection import Collection, SearchResult
from weaviate_tpu_torch.db.database import Database
from weaviate_tpu_torch.db.shard import Shard

__all__ = ["Database", "Collection", "SearchResult", "Shard"]
