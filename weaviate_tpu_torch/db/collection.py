"""Collection: shard routing + scatter-gather queries (port of
``weaviate_tpu/db/collection.py`` for one node, replication factor 1 and
no tenants).

Reference: adapters/repos/db/index.go — putObject routes by sharding
state, objectVectorSearch scatter-gathers across shards and merges by
distance. Replication, tenants, backup/offload, remote shards and epoch
migration are later slices of the port.
"""

from __future__ import annotations

import functools
import logging
import threading
import time
import uuid as uuid_mod
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from weaviate_tpu_torch import native
from weaviate_tpu_torch.db.shard import Shard
from weaviate_tpu_torch.db.sharding import ShardingState
from weaviate_tpu_torch.runtime import metrics as monitoring
from weaviate_tpu_torch.runtime import tracing
from weaviate_tpu_torch.schema.config import CollectionConfig
from weaviate_tpu_torch.storage.objects import StorageObject

logger = logging.getLogger(__name__)


class SearchResult:
    __slots__ = ("uuid", "distance", "score", "object", "shard")

    def __init__(self, uuid, distance=None, score=None, object=None, shard=None):
        self.uuid = uuid
        self.distance = distance
        self.score = score
        self.object = object
        self.shard = shard

    def __repr__(self):
        return f"SearchResult({self.uuid}, dist={self.distance}, score={self.score})"


def _timed(query_type: str):
    """Record query latency per collection and log queries slower than
    the configured threshold (QUERY_SLOW_LOG_*)."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(self, *args, **kwargs):
            t0 = time.perf_counter()
            with monitoring.query_duration.labels(self.config.name,
                                                  query_type).time(), \
                    tracing.span(f"query.{query_type}",
                                 collection=self.config.name):
                out = fn(self, *args, **kwargs)
            threshold = tracing.get_slow_threshold()
            if threshold > 0 and not tracing.is_active():
                took = time.perf_counter() - t0
                if took >= threshold:
                    logging.getLogger("weaviate_tpu_torch.slow_query").warning(
                        "slow %s query on %s: %.3fs (threshold %.3fs)",
                        query_type, self.config.name, took, threshold)
            return out

        return wrapper

    return deco


class Collection:
    def __init__(self, data_dir: str, config: CollectionConfig,
                 sharding_state: ShardingState | None = None, mesh=None,
                 local_node: str = "node-0", on_sharding_change=None,
                 sync_wal: bool | None = None, device=None):
        config.validate()
        if config.multi_tenancy.enabled:
            raise NotImplementedError(
                "multi-tenant collections: a later slice of the port")
        if config.replication.factor > 1:
            raise NotImplementedError(
                "replication: a later slice of the port")
        if mesh is not None:
            raise NotImplementedError("multi-device: ROADMAP Queue 1 item 13")
        self.config = config
        self.data_dir = data_dir
        self.mesh = None
        self.device = device
        self.local_node = local_node
        self.sync_wal = sync_wal  # None = shard reads PERSISTENCE_WAL_SYNC
        self._lock = threading.RLock()
        if sharding_state is None:
            sharding_state = ShardingState.create(
                config.sharding.desired_count, nodes=[local_node],
                replication_factor=1)
        self.sharding = sharding_state
        # persistence hook (the database persists the schema entry)
        self._on_sharding_change = on_sharding_change or (lambda col: None)
        self.shards: dict[str, Shard] = {}
        for name in self.sharding.shard_names:
            if self.local_node in self.sharding.nodes_for(name):
                self._load_shard(name)
        self._pool = ThreadPoolExecutor(max_workers=8,
                                        thread_name_prefix=f"{config.name}-search")

    def apply_runtime_config(self) -> None:
        """Propagate runtime-mutable config (reference: UpdateUserConfig ->
        hnsw/config_update.go) into LIVE shard objects, which copied config
        values at construction: BM25 k1/b and runtime compression. The
        flat index takes no search knob at runtime (ef, nprobe and the
        upgrade threshold belong to the hnsw, ivf and dynamic indexes)."""
        with self._lock:
            shards = list(self.shards.values())
        for shard in shards:
            inv = shard._inverted
            inv.k1 = self.config.inverted.bm25_k1
            inv.b = self.config.inverted.bm25_b
            for vec_name, idx in shard.vector_indexes.items():
                vc = self.config.vector_config(vec_name)
                if idx is None or vc is None:
                    continue
                if vc.index.quantization and not idx.compressed and \
                        hasattr(idx, "compress"):
                    # runtime compression (compress.go:38): train on the
                    # live contents and swap to the compressed path. Too
                    # little data to train is not an error: the config
                    # sticks and a later update or restart retries
                    try:
                        idx.compress(
                            quantization=vc.index.quantization,
                            pq_segments=vc.index.pq_segments,
                            pq_centroids=vc.index.pq_centroids,
                        )
                    except (RuntimeError, ValueError) as e:
                        logger.warning(
                            "collection %s/%s: deferring runtime "
                            "compression: %s", self.config.name, vec_name, e)

    # -- shard management ----------------------------------------------------

    def _load_shard(self, name: str) -> Shard:
        # check-then-insert under the lock: two writers must not build two
        # Shard objects (two WALs, two doc counters) for one shard
        with self._lock:
            if name not in self.shards:
                self.shards[name] = Shard(
                    self.data_dir, self.config, name, sync_wal=self.sync_wal,
                    device=self.device)
            return self.shards[name]

    def _target_shards(self) -> list[Shard]:
        return [self._load_shard(n) for n in self.sharding.shard_names]

    # -- object CRUD ---------------------------------------------------------

    def put_object(self, properties: dict, vector=None, vectors: dict | None = None,
                   uuid: str | None = None, creation_time_ms: int = 0) -> str:
        """``creation_time_ms``: carried through on updates so a re-put
        keeps the original creation stamp."""
        uuid = uuid or str(uuid_mod.uuid4())
        obj = StorageObject(uuid=uuid, properties=properties,
                            creation_time_ms=creation_time_ms)
        if creation_time_ms:
            obj.last_update_time_ms = int(time.time() * 1000)
        if vector is not None:
            obj.vector = np.asarray(vector, dtype=np.float32)
        for name, vec in (vectors or {}).items():
            obj.vectors[name] = np.asarray(vec, dtype=np.float32)
        shard_name = self.sharding.shard_for(uuid, None)
        self._load_shard(shard_name).put_object_batch([obj])
        monitoring.objects_total.labels(self.config.name, "put").inc()
        return uuid

    def batch_put(self, objects: list[dict]) -> list[dict]:
        """Batch import; per-object error reporting, not transactional
        (reference: usecases/objects/batch_add.go)."""
        results = []
        by_shard: dict[str, list[StorageObject]] = {}
        metas: dict[str, list[int]] = {}
        for i, spec in enumerate(objects):
            try:
                uid = spec.get("uuid") or str(uuid_mod.uuid4())
                obj = StorageObject(uuid=uid,
                                    properties=spec.get("properties", {}))
                if spec.get("vector") is not None:
                    obj.vector = np.asarray(spec["vector"], dtype=np.float32)
                for name, vec in (spec.get("vectors") or {}).items():
                    obj.vectors[name] = np.asarray(vec, dtype=np.float32)
                shard_name = self.sharding.shard_for(uid, None)
                by_shard.setdefault(shard_name, []).append(obj)
                metas.setdefault(shard_name, []).append(i)
                results.append({"uuid": uid, "status": "SUCCESS"})
            except Exception as e:  # per-object failure, keep going
                results.append({"uuid": spec.get("uuid"), "status": "FAILED",
                                "error": str(e)})
        for shard_name, objs in by_shard.items():
            try:
                self._load_shard(shard_name).put_object_batch(objs)
                monitoring.objects_total.labels(self.config.name, "put"
                                                ).inc(len(objs))
            except MemoryError:
                # device memory exhaustion must surface, not dissolve into
                # per-object FAILED entries
                raise
            except Exception as e:
                for i in metas[shard_name]:
                    results[i] = {"uuid": results[i]["uuid"], "status": "FAILED",
                                  "error": str(e)}
        return results

    def get_object(self, uuid: str) -> StorageObject | None:
        return self._load_shard(self.sharding.shard_for(uuid, None)).get_object(uuid)

    def delete_object(self, uuid: str) -> bool:
        ok = self._load_shard(self.sharding.shard_for(uuid, None)).delete_object(uuid)
        if ok:
            monitoring.objects_total.labels(self.config.name, "delete").inc()
        return ok

    def object_count(self) -> int:
        return sum(s.object_count() for s in self._target_shards())

    # -- search --------------------------------------------------------------

    def _attach_objects(self, results: list[SearchResult]) -> None:
        """Fill in .object for results that don't carry one yet."""
        missing = [r for r in results if r.object is None]
        if not missing:
            return
        with tracing.span("objects.fetch", n=len(missing)):
            for r in missing:
                r.object = self._load_shard(r.shard).get_object(r.uuid)

    @staticmethod
    def _merge_by_distance(gathered: list[list], k: int) -> list:
        """Cross-shard reduce: each shard's list is already ascending;
        a stable merge keeps the first shard's entry on ties."""
        lists = [g for g in gathered if g]
        if not lists:
            return []
        if len(lists) == 1:
            return lists[0][:k]
        width = max(len(g) for g in lists)
        d = np.full((len(lists), width), np.float32(3.0e38), dtype=np.float32)
        idx = np.full((len(lists), width), -1, dtype=np.int64)
        flat: list = []
        for li, g in enumerate(lists):
            for pos, r in enumerate(g):
                d[li, pos] = r.distance
                idx[li, pos] = len(flat)
                flat.append(r)
        _, out_i = native.merge_topk_host(d, idx, k=min(k, len(flat)))
        return [flat[i] for i in out_i.tolist() if i >= 0]

    @_timed("vector")
    def near_vector(self, query, k: int = 10, vec_name: str = "",
                    include_objects: bool = True,
                    where=None) -> list[SearchResult]:
        """Scatter-gather nearVector: per-shard search (the ``where``
        filter evaluated per shard to an AllowList mask applied inside the
        device scan), merged by distance and truncated to k."""
        query = np.asarray(query, dtype=np.float32)
        names = list(self.sharding.shard_names)

        def one(name: str) -> list[SearchResult]:
            shard = self._load_shard(name)
            allow = shard.allow_mask(where)
            ids, dists = shard.vector_search(query, k, vec_name, allow)
            out = []
            for doc_id, dist in zip(ids.tolist(), dists.tolist()):
                uuid = shard._doc_to_uuid.get(doc_id)
                if uuid is not None:
                    out.append(SearchResult(uuid=uuid, distance=dist, shard=name))
            return out

        gathered = [one(names[0])] if len(names) == 1 else \
            list(self._pool.map(tracing.propagate(one), names))
        merged = self._merge_by_distance(gathered, k)
        if include_objects:
            self._attach_objects(merged)
        return merged

    # -- maintenance ---------------------------------------------------------

    def flush(self):
        for s in self.shards.values():
            s.flush()

    def close(self):
        self._pool.shutdown(wait=False)
        for s in self.shards.values():
            s.close()
