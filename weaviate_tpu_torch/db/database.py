"""Database facade: schema store + collections (port of
``weaviate_tpu/db/database.py`` for one node).

The schema is persisted in its own KV bucket in the JAX package's format,
so a data directory written by ``weaviate_tpu.db.Database`` opens here and
answers the same queries. Every collection's vectors live on ``device``
(default: the CUDA card; ``device="cpu"`` only when asked).
"""

from __future__ import annotations

import os
import threading

from weaviate_tpu_torch.db.collection import Collection
from weaviate_tpu_torch.db.sharding import ShardingState
from weaviate_tpu_torch.device import resolve
from weaviate_tpu_torch.schema.config import CollectionConfig
from weaviate_tpu_torch.storage.kv import KVStore


class Database:
    def __init__(self, data_dir: str = "./data", mesh=None,
                 local_node: str = "node-0", sync_wal: bool | None = None,
                 device=None):
        if mesh is not None:
            raise NotImplementedError("multi-device: ROADMAP Queue 1 item 13")
        # resolved once, up front: no CUDA and no device= raises here,
        # before anything touches the data directory
        self.device = resolve(device)
        self.data_dir = data_dir
        self.mesh = None
        self.local_node = local_node
        if sync_wal is None:
            from weaviate_tpu_torch.config import _flag

            sync_wal = _flag(os.environ, "PERSISTENCE_WAL_SYNC")
        self.sync_wal = sync_wal
        os.makedirs(data_dir, exist_ok=True)
        self._lock = threading.RLock()
        self._schema_store = KVStore(os.path.join(data_dir, "_schema"),
                                     sync_wal=self.sync_wal)
        self._schema = self._schema_store.bucket("classes", "replace")
        self.collections: dict[str, Collection] = {}
        self._load_existing()

    def _new_collection(self, config: CollectionConfig, sharding_state=None):
        return Collection(self.data_dir, config, sharding_state=sharding_state,
                          local_node=self.local_node,
                          on_sharding_change=self._persist,
                          sync_wal=self.sync_wal, device=self.device)

    def _load_existing(self):
        for key in self._schema.keys():
            d = self._schema.get(key)
            cfg = CollectionConfig.from_dict(d["config"])
            state = ShardingState.from_dict(d["sharding"])
            self.collections[cfg.name] = self._new_collection(cfg, state)

    # -- schema ops ----------------------------------------------------------

    def create_collection(self, config: CollectionConfig,
                          sharding_state=None) -> Collection:
        config.validate()
        with self._lock:
            if config.name in self.collections:
                raise ValueError(f"collection {config.name!r} already exists")
            col = self._new_collection(config, sharding_state)
            self.collections[config.name] = col
            self._persist(col)
            return col

    def _persist(self, col: Collection):
        self._schema.put(
            col.config.name.encode(),
            {"config": col.config.to_dict(), "sharding": col.sharding.to_dict()},
        )

    def get_collection(self, name: str) -> Collection:
        col = self.collections.get(name)
        if col is None:
            raise KeyError(f"collection {name!r} does not exist")
        return col

    # -- lifecycle -----------------------------------------------------------

    def flush(self):
        for col in self.collections.values():
            col.flush()

    def close(self):
        with self._lock:
            for col in self.collections.values():
                col.close()
            self.collections.clear()
            self._schema_store.close()
