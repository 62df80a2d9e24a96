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
from weaviate_tpu_torch.schema.config import CollectionConfig, Property
from weaviate_tpu_torch.storage.kv import KVStore

MULTI_TENANCY = "multi-tenancy: ROADMAP Queue 1 item 7"


class Database:
    def __init__(self, data_dir: str = "./data", mesh=None,
                 local_node: str = "node-0", start_cycles: bool = False,
                 maintenance_interval: float = 5.0,
                 memory_monitor=None, async_indexing: bool | None = None,
                 sync_wal: bool | None = None, device=None):
        if mesh is not None:
            raise NotImplementedError("multi-device: ROADMAP Queue 1 item 6")
        # resolved once, up front: no CUDA and no device= raises here,
        # before anything touches the data directory
        self.device = resolve(device)
        self.data_dir = data_dir
        self.mesh = None
        # incident flight-recorder snapshots (tailboard) follow the data
        # dir of the most recently opened database
        from weaviate_tpu_torch.runtime import driftwatch, tailboard
        from weaviate_tpu_torch.runtime.hbm_ledger import ledger

        tailboard.set_data_dir(data_dir)
        driftwatch.set_data_dir(data_dir)
        ledger.set_host_count(1)
        self.local_node = local_node
        self.async_indexing = async_indexing  # None = env decides per shard
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
        from weaviate_tpu_torch.runtime.cyclemanager import CycleManager
        from weaviate_tpu_torch.runtime.memwatch import MemoryMonitor

        self.memwatch = memory_monitor or MemoryMonitor()
        # background maintenance (reference: cyclemanager drives LSM
        # flush/compaction); off by default so embedded/test use stays
        # deterministic — the server entry point enables it. The JAX
        # package also registers the epoch policy (ROADMAP Queue 1 item
        # 3) and the driftwatch canaries (item 8); neither is ported.
        self.cycles = CycleManager()
        self.cycles.register("lsm-maintenance", self._maintenance_cycle,
                             maintenance_interval)
        if start_cycles:
            self.cycles.start()
        self._load_existing()

    def _maintenance_cycle(self) -> bool:
        did = False
        for col in list(self.collections.values()):
            for shard in list(col.shards.values()):
                did = shard.maintenance() or did
        return did

    def _new_collection(self, config: CollectionConfig, sharding_state=None):
        return Collection(self.data_dir, config, sharding_state=sharding_state,
                          local_node=self.local_node,
                          on_sharding_change=self._persist,
                          sync_wal=self.sync_wal, memwatch=self.memwatch,
                          async_indexing=self.async_indexing,
                          device=self.device)

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

    def delete_collection(self, name: str) -> bool:
        with self._lock:
            col = self.collections.pop(name, None)
            if col is None:
                return False
            col.close()
            self._schema.delete(name.encode())
            import shutil

            # exact-case path (matches Shard dir layout): names differing
            # only in case are distinct collections
            shutil.rmtree(os.path.join(self.data_dir, name),
                          ignore_errors=True)
            return True

    def add_property(self, collection: str, prop: Property):
        """Schema evolution (reference: ADD_PROPERTY FSM op; auto-schema
        uses this too)."""
        with self._lock:
            col = self.get_collection(collection)
            prop.validate()
            # case-insensitive duplicate check, matching
            # CollectionConfig.validate() — a case-variant duplicate would
            # persist fine but make the schema unloadable on restart
            if any(p.name.lower() == prop.name.lower()
                   for p in col.config.properties):
                raise ValueError(f"property {prop.name!r} already exists")
            col.config.properties.append(prop)
            self._persist(col)

    def _persist(self, col: Collection):
        self._schema.put(
            col.config.name.encode(),
            {"config": col.config.to_dict(), "sharding": col.sharding.to_dict()},
        )

    # mutable-at-runtime config surface (reference: UpdateUserConfig /
    # update-class validation — vectorizer, index type, sharding and
    # multi-tenancy are immutable after creation)
    def validate_collection_update(self, new_cfg: CollectionConfig) -> None:
        """Immutability checks only — no mutation."""
        cur = self.get_collection(new_cfg.name).config
        for vc_new in new_cfg.vectors:
            vc_cur = cur.vector_config(vc_new.name)
            if vc_cur is None:
                raise ValueError(
                    f"cannot add vector space {vc_new.name!r} via update")
            if vc_new.vectorizer != vc_cur.vectorizer:
                raise ValueError("vectorizer is immutable")
            if vc_new.index.index_type != vc_cur.index.index_type:
                raise ValueError("vectorIndexType is immutable")
            if vc_new.index.metric != vc_cur.index.metric:
                raise ValueError("distance metric is immutable")
            if (vc_cur.index.quantization
                    and vc_new.index.quantization != vc_cur.index.quantization):
                # enabling is a one-way door (reference config_update.go:
                # compression can be turned ON via update, never off)
                raise ValueError("quantization cannot be disabled or "
                                 "changed once enabled")
            if vc_new.index.quantization and not vc_cur.index.quantization:
                # compatibility gate before anything persists — a config
                # that compress() would reject must not commit
                itype = vc_cur.index.index_type
                if itype in ("hnsw", "ivf") and \
                        vc_new.index.quantization != "pq":
                    raise ValueError(
                        f"{itype} supports runtime quantization='pq' only")
                if itype == "hnsw" and vc_cur.index.metric not in (
                        "l2-squared", "dot", "cosine", "cosine-dot"):
                    raise ValueError(
                        f"no ADC form for metric {vc_cur.index.metric!r}")
        if new_cfg.sharding.desired_count != cur.sharding.desired_count:
            raise ValueError("shard count is immutable (resharding "
                             "is not supported)")
        if new_cfg.multi_tenancy.enabled != cur.multi_tenancy.enabled:
            raise ValueError("multiTenancy.enabled is immutable")

    def update_collection(self, new_cfg: CollectionConfig) -> None:
        """Apply a schema update to a live collection: validate, persist
        the runtime-mutable fields, then push them into the live shards
        (runtime compression included). A replication-factor change moves
        shard data through the scaler, which is not ported: it raises."""
        with self._lock:
            self.validate_collection_update(new_cfg)
            cur = self.get_collection(new_cfg.name).config
            if new_cfg.replication.factor != cur.replication.factor:
                raise NotImplementedError(
                    "replication factor changes (the scaler): ROADMAP "
                    "Queue 1 item 7")

            def apply(cfg):
                cfg.description = new_cfg.description
                cfg.inverted = new_cfg.inverted
                cfg.module_config = new_cfg.module_config
                cfg.multi_tenancy.auto_tenant_creation = \
                    new_cfg.multi_tenancy.auto_tenant_creation
                cfg.multi_tenancy.auto_tenant_activation = \
                    new_cfg.multi_tenancy.auto_tenant_activation
                for vc_new in new_cfg.vectors:
                    vc = cfg.vector_config(vc_new.name)
                    # runtime-tunable index knobs (reference:
                    # hnsw/config_update.go — ef, rescore, thresholds)
                    vc.index.ef = vc_new.index.ef
                    vc.index.ef_construction = vc_new.index.ef_construction
                    vc.index.rescore_limit = vc_new.index.rescore_limit
                    vc.index.flat_to_ann_threshold = \
                        vc_new.index.flat_to_ann_threshold
                    vc.index.ivf_nprobe = vc_new.index.ivf_nprobe
                    if vc_new.index.quantization and \
                            not vc.index.quantization:
                        # runtime compression enable (compress.go:38 via
                        # config_update.go) — applied to live indexes in
                        # apply_runtime_config
                        vc.index.quantization = vc_new.index.quantization
                        vc.index.pq_segments = vc_new.index.pq_segments
                        vc.index.pq_centroids = vc_new.index.pq_centroids
                    vc.module_config = vc_new.module_config

            self.update_collection_config(new_cfg.name, apply)
            # push runtime knobs into LIVE objects — they copied config
            # values at construction
            self.get_collection(new_cfg.name).apply_runtime_config()

    def update_collection_config(self, name: str, mutate) -> None:
        """Runtime-mutable config path (reference: UpdateUserConfig,
        vector_index.go:33). ``mutate(config)`` edits in place; validation
        runs on a copy so a rejected update leaves the live config intact."""
        import copy

        with self._lock:
            col = self.get_collection(name)
            candidate = copy.deepcopy(col.config)
            mutate(candidate)
            candidate.validate()
            mutate(col.config)
            self._persist(col)

    def get_collection(self, name: str) -> Collection:
        col = self.collections.get(name)
        if col is None:
            raise KeyError(f"collection {name!r} does not exist")
        return col

    def list_collections(self) -> list[str]:
        return sorted(self.collections)

    def schema_dict(self) -> dict:
        return {name: col.config.to_dict()
                for name, col in sorted(self.collections.items())}

    # -- tenants (creating a multi-tenant collection raises, so every
    #    collection here has none) ----------------------------------------

    def add_tenants(self, collection: str, tenants: list[str]):
        self.get_collection(collection)
        raise NotImplementedError(MULTI_TENANCY)

    def update_tenant_status(self, collection: str,
                             tenants: list[dict]) -> None:
        self.get_collection(collection)
        raise NotImplementedError(MULTI_TENANCY)

    def remove_tenants(self, collection: str, tenants: list[str]):
        self.get_collection(collection)
        raise NotImplementedError(MULTI_TENANCY)

    def set_offload_backend(self, backend) -> None:
        """The FROZEN tenant tier ships offloaded tenants to a backup
        backend; there are no tenants here."""
        raise NotImplementedError(f"OFFLOAD_BACKEND: {MULTI_TENANCY}")

    # -- lifecycle -----------------------------------------------------------

    def flush(self):
        for col in self.collections.values():
            col.flush()

    def close(self):
        self.cycles.stop()
        with self._lock:
            for col in self.collections.values():
                col.close()
            self.collections.clear()
            self._schema_store.close()
