"""Collection: shard routing + scatter-gather queries (port of
``weaviate_tpu/db/collection.py`` for one node, replication factor 1 and
no tenants).

Reference: adapters/repos/db/index.go — putObject routes by sharding
state, objectVectorSearch scatter-gathers across shards and merges by
distance; keyword (bm25) and hybrid search scatter-gather the same way,
and a hybrid query on one shard runs as one fused device program.
Replication, tenants, backup/offload, remote shards and epoch migration
are later slices of the port (ROADMAP Queue 1 items 3 and 7). The query
and write methods keep the JAX package's ``tenant`` and ``consistency``
keywords, which a collection without tenants or replicas ignores, as the
JAX one does.
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
    __slots__ = ("uuid", "distance", "score", "object", "shard",
                 "rerank_score")

    def __init__(self, uuid, distance=None, score=None, object=None, shard=None):
        self.uuid = uuid
        self.distance = distance
        self.score = score
        self.object = object
        self.shard = shard
        self.rerank_score = None  # set by the reranker module path

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
                 sync_wal: bool | None = None, memwatch=None,
                 async_indexing: bool | None = None, device=None):
        config.validate()
        if config.multi_tenancy.enabled:
            raise NotImplementedError(
                "multi-tenant collections: ROADMAP Queue 1 item 7")
        if config.replication.factor > 1:
            raise NotImplementedError("replication: ROADMAP Queue 1 item 7")
        if mesh is not None:
            raise NotImplementedError("multi-device: ROADMAP Queue 1 item 6")
        self.config = config
        self.data_dir = data_dir
        self.mesh = None
        self.device = device
        self.memwatch = memwatch
        self.async_indexing = async_indexing  # None = env decides per shard
        self.local_node = local_node
        self.sync_wal = sync_wal  # None = shard reads PERSISTENCE_WAL_SYNC
        self._lock = threading.RLock()
        # striped read-modify-write locks (PATCH, reference adds)
        self._uuid_locks = [threading.RLock() for _ in range(64)]
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

    def uuid_lock(self, uuid: str) -> threading.RLock:
        """Lock guarding read-modify-write of one object (sharded by uuid
        hash; collisions just serialize two unrelated RMWs, never deadlock
        since callers take at most one)."""
        return self._uuid_locks[hash(uuid) % len(self._uuid_locks)]

    def _is_local(self, shard_name: str) -> bool:
        return self.local_node in self.sharding.nodes_for(shard_name)

    def tenants(self) -> list[str]:
        # multi-tenant collections raise at construction (item 7)
        return []

    def tenant_activity_snapshot(self) -> dict:
        """Per-tenant read/write activity: none without tenants."""
        return {}

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
                    memwatch=self.memwatch,
                    async_indexing=self.async_indexing, device=self.device)
            return self.shards[name]

    def _target_shards(self, tenant: str | None = None) -> list[Shard]:
        return [self._load_shard(n) for n in self.sharding.shard_names]

    # -- object CRUD ---------------------------------------------------------

    def put_object(self, properties: dict, vector=None, vectors: dict | None = None,
                   uuid: str | None = None, creation_time_ms: int = 0,
                   tenant: str | None = None,
                   consistency: str = "QUORUM") -> str:
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

    def batch_put(self, objects: list[dict], tenant: str | None = None,
                  consistency: str = "QUORUM") -> list[dict]:
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

    def get_object(self, uuid: str, tenant: str | None = None,
                   consistency: str | None = None) -> StorageObject | None:
        return self._load_shard(self.sharding.shard_for(uuid, None)).get_object(uuid)

    def delete_object(self, uuid: str, tenant: str | None = None,
                      consistency: str = "QUORUM") -> bool:
        ok = self._load_shard(self.sharding.shard_for(uuid, None)).delete_object(uuid)
        if ok:
            monitoring.objects_total.labels(self.config.name, "delete").inc()
        return ok

    def object_count(self, tenant: str | None = None) -> int:
        return sum(s.object_count() for s in self._target_shards())

    def batch_delete(self, where, tenant: str | None = None,
                     dry_run: bool = False, verbose: bool = False,
                     consistency: str = "QUORUM",
                     max_matches: int = 10_000) -> dict:
        """Delete all objects matching a filter (reference: batch_delete —
        REST DELETE /v1/batch/objects and gRPC BatchDelete; match set capped
        at QUERY_MAXIMUM_RESULTS like the reference's dryRun/match cap).
        Returns {"matches", "successful", "failed", "objects": [...]}, where
        ``objects`` is populated per-uuid only when ``verbose``."""
        uuids: list[str] = []
        for name in self.sharding.shard_names:
            if len(uuids) >= max_matches:
                break
            shard = self._load_shard(name)
            mask = shard.allow_mask(where) if where is not None else None
            with shard._lock:
                items = list(shard._doc_to_uuid.items())
            for doc_id, uid in items:
                if mask is not None and (doc_id >= len(mask)
                                         or not mask[doc_id]):
                    continue
                uuids.append(uid)
                if len(uuids) >= max_matches:
                    break
        result = {"matches": len(uuids), "successful": 0, "failed": 0,
                  "objects": []}
        for uid in uuids:
            if dry_run:
                ok, err = True, None
            else:
                try:
                    ok = self.delete_object(uid)
                    err = None if ok else "not found"
                except Exception as e:  # per-object errors, not transactional
                    ok, err = False, str(e)
            result["successful" if ok else "failed"] += 1
            if verbose:
                entry = {"id": uid, "successful": ok}
                if err:
                    entry["error"] = err
                result["objects"].append(entry)
        return result

    def iter_objects(self, tenant: str | None = None):
        for shard in self._target_shards():
            for key, raw in shard.objects.iter_items():
                yield StorageObject.from_bytes(raw)

    def fetch_objects(self, limit: int = 25, offset: int = 0,
                      sort: list[dict] | None = None, where=None,
                      tenant: str | None = None,
                      after: str | None = None) -> list[StorageObject]:
        """List objects with optional filter/sort/cursor (reference:
        /v1/objects listing; sorter/objects_sorter.go; cursor via ?after=
        which requires uuid order — sort and after are mutually exclusive,
        as in the reference API)."""
        from weaviate_tpu_torch.query.sorter import sort_objects

        if after is not None and sort:
            raise ValueError("'after' cursor cannot be combined with sort")
        names = list(self.sharding.shard_names)
        if sort:
            # property sort needs the values: materialize candidates
            objs: list[StorageObject] = []
            for name in names:
                shard = self._load_shard(name)
                mask = shard.allow_mask(where) if where is not None else None
                for _key, raw in shard.objects.iter_items():
                    obj = StorageObject.from_bytes(raw)
                    if mask is not None and (obj.doc_id >= len(mask)
                                             or not mask[obj.doc_id]):
                        continue
                    objs.append(obj)
            return sort_objects(objs, sort)[offset: offset + limit]
        # uuid-ordered page: select uuids from the in-RAM docid map, only
        # deserialize what is actually returned
        candidates: list[tuple[str, str]] = []  # (uuid, shard name)
        for name in names:
            shard = self._load_shard(name)
            mask = shard.allow_mask(where) if where is not None else None
            with shard._lock:  # snapshot: writers mutate _doc_to_uuid
                items = list(shard._doc_to_uuid.items())
            for doc_id, uid in items:
                if mask is not None and (doc_id >= len(mask)
                                         or not mask[doc_id]):
                    continue
                if after is not None and uid <= after:
                    continue
                candidates.append((uid, name))
        candidates.sort(key=lambda t: t[0])
        page = candidates[offset: offset + limit]
        out = []
        for uid, name in page:
            obj = self._load_shard(name).get_object(uid)
            if obj is not None:
                out.append(obj)
        return out

    # -- aggregation ---------------------------------------------------------

    @_timed("aggregate")
    def aggregate(self, properties: list[str] | None = None,
                  group_by: str | None = None, where=None,
                  tenant: str | None = None,
                  requested: dict[str, list[str]] | None = None,
                  near_vector=None, near_vec_name: str = "",
                  near_max_distance: float | None = None,
                  object_limit: int | None = None,
                  top_occurrences_limit: int = 5) -> dict:
        """Scatter-gather aggregation (reference: aggregator/aggregator.go →
        per-shard fold, shard_combiner.go merge). With ``near_vector`` +
        ``object_limit``, aggregates over the top-k of a vector search
        instead of the whole (filtered) corpus (aggregator/hybrid.go)."""
        from weaviate_tpu_torch.query.aggregator import (
            aggregate_objects,
            combine_partials,
            finalize_aggregation,
        )

        if near_vector is not None:
            k = object_limit or 100
            hits = self.near_vector(near_vector, k=k, vec_name=near_vec_name,
                                    include_objects=True, where=where,
                                    max_distance=near_max_distance)
            partials = [aggregate_objects((r.object for r in hits if r.object),
                                          properties, group_by)]
        else:
            def one(name: str):
                shard = self._load_shard(name)
                mask = shard.allow_mask(where) if where is not None else None

                def objs():
                    for _key, raw in shard.objects.iter_items():
                        obj = StorageObject.from_bytes(raw)
                        if mask is not None and (obj.doc_id >= len(mask)
                                                 or not mask[obj.doc_id]):
                            continue
                        yield obj

                return aggregate_objects(objs(), properties, group_by)

            names = list(self.sharding.shard_names)
            partials = [one(names[0])] if len(names) == 1 else \
                list(self._pool.map(tracing.propagate(one), names))
        return finalize_aggregation(combine_partials(partials), requested,
                                    top_occurrences_limit)

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

    @staticmethod
    def _and_masks(a, b) -> np.ndarray:
        """Intersect two allow lists (bool mask or doc-id array forms)."""
        a, b = np.asarray(a), np.asarray(b)
        if a.dtype != np.bool_ and b.dtype != np.bool_:
            # both doc-id arrays: sorted-set intersect (the roaring AND of
            # the reference)
            return native.intersect_sorted(
                np.unique(a), np.unique(b)).astype(np.int64)

        def to_mask(x, size):
            if x.dtype == np.bool_:
                m = np.zeros(size, dtype=bool)
                m[: len(x)] = x
                return m
            m = np.zeros(size, dtype=bool)
            m[x[x < size]] = True
            return m

        size = max(len(a) if a.dtype == np.bool_ else (int(a.max()) + 1 if len(a) else 0),
                   len(b) if b.dtype == np.bool_ else (int(b.max()) + 1 if len(b) else 0))
        return to_mask(a, size) & to_mask(b, size)

    def _shard_allow(self, shard: Shard, name: str, allow_list_by_shard, where):
        """The allow list a shard's leg runs under: the caller's per-shard
        list ANDed with the shard's evaluation of ``where``."""
        allow = None if allow_list_by_shard is None else \
            allow_list_by_shard.get(name)
        if where is not None:
            fmask = shard.allow_mask(where)
            allow = fmask if allow is None else self._and_masks(allow, fmask)
        return allow

    @_timed("vector")
    def near_vector(self, query, k: int = 10, vec_name: str = "",
                    include_objects: bool = True,
                    where=None, allow_list_by_shard: dict | None = None,
                    max_distance: float | None = None,
                    autocut: int = 0,
                    tenant: str | None = None) -> list[SearchResult]:
        """Scatter-gather nearVector: per-shard search (the ``where``
        filter evaluated per shard to an AllowList mask applied inside the
        device scan, ANDed with ``allow_list_by_shard``'s list), merged by
        distance and truncated to k."""
        query = np.asarray(query, dtype=np.float32)
        names = list(self.sharding.shard_names)

        def one(name: str) -> list[SearchResult]:
            shard = self._load_shard(name)
            allow = self._shard_allow(shard, name, allow_list_by_shard, where)
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
        if max_distance is not None:
            merged = [r for r in merged if r.distance <= max_distance]
        if autocut > 0 and merged:
            from weaviate_tpu_torch.query.autocut import autocut as _autocut

            merged = merged[: _autocut([r.distance for r in merged], autocut)]
        if include_objects:
            self._attach_objects(merged)
        return merged

    @_timed("bm25")
    def bm25(self, query: str, k: int = 10, properties: list[str] | None = None,
             include_objects: bool = True,
             allow_list_by_shard: dict | None = None,
             where=None, autocut: int = 0,
             tenant: str | None = None) -> list[SearchResult]:
        """Scatter-gather keyword search; merge by score descending
        (reference: Index.objectSearch -> per-shard BM25 -> merge)."""
        names = list(self.sharding.shard_names)

        def one(name: str) -> list[SearchResult]:
            shard = self._load_shard(name)
            allow = self._shard_allow(shard, name, allow_list_by_shard, where)
            ids, scores = shard.bm25_search(query, k, properties, allow)
            return self._results(shard, name, ids, scores)

        gathered = [one(names[0])] if len(names) == 1 else \
            list(self._pool.map(tracing.propagate(one), names))

        merged = [r for results in gathered for r in results]
        merged.sort(key=lambda r: -r.score)
        merged = merged[:k]
        if autocut > 0 and merged:
            from weaviate_tpu_torch.query.autocut import autocut as _autocut

            merged = merged[: _autocut([-r.score for r in merged], autocut)]
        if include_objects:
            self._attach_objects(merged)
        return merged

    @staticmethod
    def _results(shard: Shard, name: str, ids, scores) -> list[SearchResult]:
        """Score-ranked shard rows -> SearchResults (rows whose doc id no
        longer maps to a uuid are dropped)."""
        out = []
        for doc_id, score in zip(ids.tolist(), scores.tolist()):
            uuid = shard._doc_to_uuid.get(doc_id)
            if uuid is not None:
                out.append(SearchResult(uuid=uuid, score=score, shard=name))
        return out

    @_timed("hybrid")
    def hybrid(self, query: str, vector=None, alpha: float = 0.75, k: int = 10,
               properties: list[str] | None = None, vec_name: str = "",
               fusion: str = "relativeScore", where=None,
               include_objects: bool = True,
               autocut: int = 0,
               tenant: str | None = None) -> list[SearchResult]:
        """Hybrid sparse+dense search (reference: hybrid/searcher.go:74 runs
        both legs in parallel, then fuses). ``alpha`` weighs the dense leg
        (0 = pure BM25, 1 = pure vector). ``vector=None`` degrades to
        sparse-only, as the reference does without a vectorizer.

        Single-shard queries with a query vector take the fused DEVICE
        path first: one batched device program runs the dense scan,
        scores the packed BM25 candidates, and fuses — the host
        two-thread reference below stays the fallback (and the parity
        oracle) for everything the device path declines."""
        from weaviate_tpu_torch.text.hybrid import (fusion_ranked,
                                                    fusion_relative_score)

        if vector is None:
            alpha = 0.0  # degrade to sparse-only (reference does the same
            # when no vectorizer can produce a query vector)
        # evaluate the filter once per shard and let both legs reuse the
        # masks (every shard is local in the port)
        names = list(self.sharding.shard_names)
        allow_by_shard = None
        if where is not None:
            allow_by_shard = {n: self._load_shard(n).allow_mask(where)
                              for n in names}

        if vector is not None and len(names) == 1:
            dev = self._hybrid_device(
                names[0], query, vector, alpha, k, properties, vec_name,
                fusion, None if allow_by_shard is None
                else allow_by_shard.get(names[0]))
            if dev is not None:
                return self._finish_hybrid(dev, autocut, include_objects)

        # over-fetch each leg so fusion has overlap to work with; legs run
        # on ephemeral threads, NOT self._pool — a leg parked in a pool
        # worker while its inner scatter-gather waits for that same pool
        # can deadlock
        fetch = max(k * 10, 100)
        legs, weights = [], []
        results: dict[str, list] = {}
        errors: dict[str, BaseException] = {}

        def run(name, fn, *a, **kw):
            try:
                results[name] = fn(*a, **kw)
            except BaseException as e:  # re-raised on the caller thread
                errors[name] = e

        # legs skip object fetch; only the fused top-k pays for it below
        # (tracing.propagate: Thread targets don't inherit contextvars)
        threads = []
        if alpha < 1.0:
            threads.append(threading.Thread(
                target=tracing.propagate(run),
                args=("sparse", self.bm25, query, fetch, properties),
                kwargs=dict(include_objects=False,
                            allow_list_by_shard=allow_by_shard)))
        if vector is not None and alpha > 0.0:
            threads.append(threading.Thread(
                target=tracing.propagate(run),
                args=("dense", self.near_vector, vector, fetch, vec_name),
                kwargs=dict(include_objects=False,
                            allow_list_by_shard=allow_by_shard)))
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise next(iter(errors.values()))
        if "sparse" in results:
            legs.append(results["sparse"])
            weights.append(1.0 - alpha)
        if "dense" in results:
            dense = results["dense"]
            # similarity score for fusion: any monotone-decreasing map of
            # distance works (min-max normalization is affine-invariant)
            for r in dense:
                r.score = -r.distance
            legs.append(dense)
            weights.append(alpha)
        if not legs:
            return []
        fuse = fusion_relative_score if fusion == "relativeScore" else fusion_ranked
        # fusion returns (fused_score, result) pairs WITHOUT mutating the
        # leg results; materialize fresh results so concurrent queries
        # sharing leg objects never race on .score
        fused = [SearchResult(uuid=r.uuid, distance=r.distance, score=s,
                              object=r.object, shard=r.shard)
                 for s, r in fuse(legs, weights, k)]
        return self._finish_hybrid(fused, autocut, include_objects)

    def _finish_hybrid(self, results: list[SearchResult], autocut: int,
                       include_objects: bool) -> list[SearchResult]:
        if autocut > 0 and results:
            from weaviate_tpu_torch.query.autocut import autocut_results

            results = autocut_results(results, autocut, by="score")
        if include_objects:
            self._attach_objects(results)
        return results

    def _hybrid_device(self, name: str, query: str, vector, alpha: float,
                       k: int, properties, vec_name: str, fusion: str,
                       allow_mask) -> list[SearchResult] | None:
        """Fused device hybrid for one shard. None = the shard declined
        (unsupported index, candidate budget, kill switch) and the caller
        runs the host reference path."""
        shard = self._load_shard(name)
        res = shard.hybrid_search(
            query, np.asarray(vector, np.float32), k, alpha=alpha,
            fusion=fusion, properties=properties, vec_name=vec_name,
            allow_mask=allow_mask)
        if res is None:
            return None
        return self._results(shard, name, *res)

    def hybrid_async(self, query: str, vector=None, alpha: float = 0.75,
                     k: int = 10, properties: list[str] | None = None,
                     vec_name: str = "", fusion: str = "relativeScore",
                     where=None, include_objects: bool = True,
                     autocut: int = 0, tenant: str | None = None):
        """Dispatch-only twin of ``hybrid``: returns a
        ``DeviceResultHandle`` resolving to the same ``list[SearchResult]``.
        On the device path the copy to the host waits for ``.result()``;
        when the device path declines, the host reference runs inline and
        the handle is pre-resolved (``DeviceResultHandle.ready``)."""
        from weaviate_tpu_torch.runtime.transfer import DeviceResultHandle

        names = list(self.sharding.shard_names)
        if vector is not None and len(names) == 1 and where is None:
            shard = self._load_shard(names[0])
            h = shard.hybrid_search_async(
                query, np.asarray(vector, np.float32), k, alpha=alpha,
                fusion=fusion, properties=properties, vec_name=vec_name)
            if h is not None:
                return h.map(lambda res, _s=shard, _n=names[0]:
                             self._finish_hybrid(self._results(_s, _n, *res),
                                                 autocut, include_objects))
        return DeviceResultHandle.ready(self.hybrid(
            query, vector, alpha, k, properties, vec_name, fusion, where,
            include_objects, autocut))

    # -- maintenance ---------------------------------------------------------

    def flush(self):
        for s in self.shards.values():
            s.flush()

    def close(self):
        self._pool.shutdown(wait=False)
        for s in self.shards.values():
            s.close()
