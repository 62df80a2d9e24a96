"""Shard: the unit of storage + indexing (port of ``weaviate_tpu/db/shard.py``
for flat (plain or BQ/PQ-quantized) and noop vector indexes on one device).

Owns an LSM KV store (objects bucket + docid mappings), one vector index
per named vector, and the inverted index behind filters. Write path:
objects + postings land in the KV store, vectors in the device index;
read path: the vector index's top-k through the shard's query batcher,
resolved to uuids; keyword search in the inverted index; hybrid search as
one fused device program (BM25F of the host-planned candidates + fusion
with the dense scan) riding the same batcher. The on-disk layout is the
JAX package's, so either package reopens the other's shards.
"""

from __future__ import annotations

import logging
import os
import threading

import numpy as np

from weaviate_tpu_torch import native
from weaviate_tpu_torch.engine.flat import FlatIndex
from weaviate_tpu_torch.runtime import tracing
from weaviate_tpu_torch.schema.config import CollectionConfig, VectorConfig
from weaviate_tpu_torch.storage.kv import KVStore
from weaviate_tpu_torch.storage.objects import StorageObject

logger = logging.getLogger(__name__)


class ShardReadOnlyError(RuntimeError):
    """Write refused: shard status is READONLY."""


# bucket names (reference: helpers/helpers.go:22-25)
BUCKET_OBJECTS = "objects"
BUCKET_DOCID = "docid"  # uuid -> doc_id
BUCKET_META = "meta"  # counters, checkpoints

# index types that have a port, and the ROADMAP rows of the others
_NOT_PORTED = {
    "hnsw": "HNSW: ROADMAP Queue 1 item 12",
    "ivf": "IVF: ROADMAP Queue 1 item 11",
    "dynamic": "dynamic flat->IVF: ROADMAP Queue 1 item 11",
}


def _make_vector_index(vc: VectorConfig, dim: int, device=None):
    cfg = vc.index
    if cfg.index_type == "noop":
        return None
    common = dict(dim=dim, metric=cfg.metric, capacity=8192, chunk_size=8192,
                  device=device)
    if cfg.index_type == "flat" and cfg.quantization:
        return FlatIndex(
            quantization=cfg.quantization,
            pq_segments=cfg.pq_segments,
            pq_centroids=cfg.pq_centroids,
            rescore_limit=cfg.rescore_limit,
            prefix_bits=cfg.prefix_bits,
            epoch_rows=cfg.epoch_rows,
            **common,
        )
    if cfg.index_type in ("hnsw", "ivf") and cfg.quantization == "bq":
        # no bq form for graph hops or IVF lists: the JAX package honours
        # the compression request with the quantized flat scan
        return FlatIndex(quantization="bq", rescore_limit=cfg.rescore_limit,
                         prefix_bits=cfg.prefix_bits, **common)
    if cfg.index_type in _NOT_PORTED:
        raise NotImplementedError(_NOT_PORTED[cfg.index_type])
    if cfg.index_type != "flat":
        raise ValueError(f"unknown index type {cfg.index_type}")
    return FlatIndex(
        dtype="bfloat16" if cfg.storage_dtype == "bfloat16" else "float32",
        epoch_rows=cfg.epoch_rows,
        **common,
    )


class Shard:
    def __init__(self, data_dir: str, collection: CollectionConfig, name: str,
                 mesh=None, sync_wal: bool | None = None, device=None):
        if mesh is not None:
            raise NotImplementedError("multi-device: ROADMAP Queue 1 item 13")
        self.name = name
        self.device = device
        # PERSISTENCE_WAL_SYNC: fsync every acked write's WAL frame
        if sync_wal is None:
            from weaviate_tpu_torch.config import _flag

            sync_wal = _flag(os.environ, "PERSISTENCE_WAL_SYNC")
        self.sync_wal = sync_wal
        # server-side dynamic batching: concurrent single-query searches
        # coalesce into one device dispatch. QUERY_DYNAMIC_BATCHING=false
        # opts out.
        self.dynamic_batching = os.environ.get(
            "QUERY_DYNAMIC_BATCHING", "true").lower() in (
                "true", "1", "on", "enabled")
        # zero-sync serving pipeline: batched dispatches return device-
        # resident handles drained on a transfer thread.
        # QUERY_ASYNC_PIPELINE=false opts into worker-synchronous fetches.
        self.async_pipeline = os.environ.get(
            "QUERY_ASYNC_PIPELINE", "true").lower() in (
                "true", "1", "on", "enabled")
        self._query_batchers: dict[str, "QueryBatcher"] = {}
        # device hybrid: BM25 + fusion ride the dense dispatch when the
        # index supports it. The kill switch keeps hybrid on the host
        # reference path; the candidate budget bounds the packed sparse
        # operand (over-budget queries take the host path).
        self.device_hybrid = os.environ.get(
            "WEAVIATE_TPU_DEVICE_HYBRID", "true").lower() in (
                "true", "1", "on", "enabled")
        try:
            self.hybrid_max_candidates = int(os.environ.get(
                "WEAVIATE_TPU_HYBRID_MAX_CANDIDATES", "4096"))
        except ValueError:
            self.hybrid_max_candidates = 4096
        self.read_only = False
        self.collection_name = collection.name
        self.config = collection
        # exact-case directory: collections differing only in case are
        # distinct and must not share storage
        self.dir = os.path.join(data_dir, collection.name, name)
        os.makedirs(self.dir, exist_ok=True)
        self._lock = threading.RLock()
        self.store = KVStore(self.dir, sync_wal=self.sync_wal)
        self.objects = self.store.bucket(BUCKET_OBJECTS, "replace")
        self.docid = self.store.bucket(BUCKET_DOCID, "replace")
        self.meta = self.store.bucket(BUCKET_META, "replace")
        # deletion tombstones (uuid -> mtime ms), as the JAX shard keeps
        self.tombstones = self.store.bucket("tombstones", "replace")
        self._counter = self.meta.get(b"doc_counter") or 0
        self.read_only = bool(self.meta.get(b"read_only") or False)
        self.mesh = None
        # named vector indexes, built lazily at first insert (dim inference)
        self.vector_indexes: dict[str, FlatIndex] = {}
        from weaviate_tpu_torch.text.inverted import InvertedIndex

        # persistent inverted index: postings write through the shard's
        # own LSM store and are read on demand
        self._inverted = InvertedIndex(collection, store=self.store)
        # doc_id -> uuid, rebuilt at startup
        self._doc_to_uuid: dict[int, str] = {}
        self._restore_vector_indexes()

    # -- startup -------------------------------------------------------------

    def _restore_vector_indexes(self):
        """Rebuild the device state from the durable object store (the
        vectors ARE the log)."""
        batch: dict[str, tuple[list[int], list[np.ndarray]]] = {}
        # a shard written before the inverted index was persistent has
        # objects but empty inv_* buckets: rebuild postings once
        migrate_inverted = self._inverted.doc_count == 0
        migrate_chunk: list[StorageObject] = []
        for key, raw in self.objects.iter_items():
            obj = StorageObject.from_bytes(raw)
            self._doc_to_uuid[obj.doc_id] = obj.uuid
            if migrate_inverted:
                migrate_chunk.append(obj)
                if len(migrate_chunk) >= 2000:  # batched WAL frames
                    self._inverted.index_objects(migrate_chunk)
                    migrate_chunk = []
            for vec_name, vec in obj.vectors.items():
                ids, vecs = batch.setdefault(vec_name, ([], []))
                ids.append(obj.doc_id)
                vecs.append(vec)
        if migrate_chunk:
            self._inverted.index_objects(migrate_chunk)
        self._inverted.reconcile_doc_count(len(self._doc_to_uuid))
        for vec_name, (ids, vecs) in batch.items():
            # tolerate poisoned rows (dim drift) instead of refusing to start
            dim = len(vecs[0])
            keep = [j for j, v in enumerate(vecs) if len(v) == dim]
            if len(keep) != len(vecs):
                logger.warning(
                    "shard %s: skipping %d vectors with mismatched dims for %r",
                    self.name, len(vecs) - len(keep), vec_name)
            idx = self._ensure_vector_index(vec_name, dim)
            if idx is not None and keep:
                idx.add_batch(np.asarray([ids[j] for j in keep]),
                              np.stack([vecs[j] for j in keep]))
                # a config that asks for quantization on a plain index
                # compresses at runtime (compress.go:38): re-applied after
                # the rebuild so a restart does not drop compression
                self._maybe_compress(vec_name, idx)

    def _ensure_vector_index(self, vec_name: str, dim: int):
        if vec_name in self.vector_indexes:
            return self.vector_indexes[vec_name]
        vc = self.config.vector_config(vec_name)
        if vc is None:
            vc = VectorConfig(name=vec_name)
        # device-memory ledger owner scope for every tensor the index
        # allocates, now or on a later grow
        from weaviate_tpu_torch.runtime import hbm_ledger

        with hbm_ledger.owner(self.collection_name, self.name,
                              tenant=self._tenant_label()):
            idx = _make_vector_index(vc, dim, device=self.device)
        self.vector_indexes[vec_name] = idx
        return idx

    def _tenant_label(self) -> str:
        return self.name if self.config.multi_tenancy.enabled else ""

    def _maybe_compress(self, vec_name: str, idx) -> None:
        vc = self.config.vector_config(vec_name)
        if (vc is None or not vc.index.quantization
                or getattr(idx, "compressed", True)
                or not hasattr(idx, "compress")
                # trainability floor — the same gate the config-update path
                # has, so a restart never drops compression an update applied
                or len(idx) < (vc.index.pq_centroids or 16)):
            return
        try:
            idx.compress(quantization=vc.index.quantization,
                         pq_segments=vc.index.pq_segments,
                         pq_centroids=vc.index.pq_centroids,
                         rescore_limit=vc.index.rescore_limit,
                         prefix_bits=vc.index.prefix_bits)
        except (RuntimeError, ValueError) as e:
            logger.warning("shard %s/%s: deferring runtime compression: %s",
                           self.name, vec_name, e)

    # -- write path ----------------------------------------------------------

    def _expected_dim(self, vec_name: str) -> int | None:
        idx = self.vector_indexes.get(vec_name)
        if idx is not None:
            return idx.dim
        vc = self.config.vector_config(vec_name)
        if vc is not None and vc.dim:
            return vc.dim
        return None

    def _validate_vectors(self, objs: list[StorageObject]) -> None:
        """Reject dim mismatches BEFORE any mutation."""
        first_dims: dict[str, int] = {}
        for obj in objs:
            for vec_name, vec in obj.vectors.items():
                dim = self._expected_dim(vec_name) or first_dims.get(vec_name)
                if dim is None:
                    first_dims[vec_name] = len(vec)
                elif len(vec) != dim:
                    raise ValueError(
                        f"vector dim {len(vec)} != expected dim {dim} "
                        f"for vector {vec_name!r} (object {obj.uuid})")

    def put_object_batch(self, objs: list[StorageObject]) -> list[int]:
        """Batch write (reference: shard_write_batch_objects.go:33)."""
        # dedupe by uuid (last wins)
        if len({o.uuid for o in objs}) != len(objs):
            last = {o.uuid: i for i, o in enumerate(objs)}
            objs = [objs[i] for i in sorted(last.values())]
        doc_ids: list[int] = []
        with self._lock:
            if self.read_only:
                raise ShardReadOnlyError(
                    f"shard {self.name!r} is read-only (status READONLY)")
            self._validate_vectors(objs)
            vec_batches: dict[str, tuple[list[int], list[np.ndarray]]] = {}
            # doc ids for the whole batch come from one counter bump
            first_id = self._counter
            self._counter += len(objs)
            self.meta.put(b"doc_counter", self._counter)
            docid_puts: list[tuple[bytes, object]] = []
            object_puts: list[tuple[bytes, object]] = []
            uuid_keys = [o.uuid.encode() for o in objs]
            old_raws = self.docid.get_many(uuid_keys)
            # the import's common shape (exactly one unnamed vector per
            # object): every storobj value frame comes out of one native
            # call; props are msgpacked here so the bytes match the
            # per-object encoder exactly. Any other shape, or a uuid the
            # fast parser rejects, keeps the per-object codec.
            frames = None
            single_vec = (objs and native.available() and all(
                len(o.vectors) == 1 and "" in o.vectors for o in objs))
            if single_vec:
                import msgpack

                vec_block = np.stack([np.asarray(o.vectors[""], dtype=np.float32)
                                      for o in objs])
                n_objs = len(objs)
                frames = native.storobj_encode_batch(
                    uuid_keys,
                    [msgpack.packb(o.properties, use_bin_type=True) for o in objs],
                    vec_block,
                    np.arange(first_id, first_id + n_objs, dtype=np.int64),
                    np.fromiter((o.creation_time_ms for o in objs), np.int64, n_objs),
                    np.fromiter((o.last_update_time_ms for o in objs), np.int64, n_objs))
            # update path: every replaced doc's teardown runs batched
            updates = [(int(old_raw), obj.uuid)
                       for obj, old_raw in zip(objs, old_raws)
                       if old_raw is not None]
            if updates:
                self._delete_docs_batch(updates)
            for i, obj in enumerate(objs):
                obj.doc_id = first_id + i
                docid_puts.append((uuid_keys[i], obj.doc_id))
                self._doc_to_uuid[obj.doc_id] = obj.uuid
                object_puts.append((
                    uuid_keys[i], frames[i] if frames is not None else obj.to_bytes()))
                if frames is None:
                    for vec_name, vec in obj.vectors.items():
                        ids, vecs = vec_batches.setdefault(vec_name, ([], []))
                        ids.append(obj.doc_id)
                        vecs.append(np.asarray(vec, dtype=np.float32))
                doc_ids.append(obj.doc_id)
            if frames is not None:
                vec_batches[""] = (doc_ids, vec_block)
            # ordering invariant: inverted postings land BEFORE the objects
            # bucket (a crash in between leaves ghost postings, never
            # missing ones); the objects-bucket WAL is the commit point
            self._inverted.index_objects(objs)
            self.tombstones.delete_many(k for k, _ in docid_puts)
            self.docid.put_many(docid_puts)
            self.objects.put_many(object_puts)
            for vec_name, (ids, vecs) in vec_batches.items():
                idx = self._ensure_vector_index(vec_name, len(vecs[0]))
                if idx is not None:
                    # the fast path hands a prebuilt [n, d] block
                    block = vecs if isinstance(vecs, np.ndarray) else np.stack(vecs)
                    idx.add_batch(np.asarray(ids), block)
                    self._maybe_compress(vec_name, idx)
        return doc_ids

    def _batched_search(self, vec_name: str, idx, query: np.ndarray, k: int,
                        allow_list):
        """Dynamic-batched single-query search: concurrent callers share
        one device dispatch."""
        b = self._query_batcher(vec_name, idx)
        ids, dists = b.search(query, k, allow_list)
        live = ids >= 0
        return (np.asarray(ids)[live].astype(np.int64),
                np.asarray(dists)[live].astype(np.float32))

    def _query_batcher(self, vec_name: str, idx):
        """The shard's per-vector-space QueryBatcher, built lazily."""
        b = self._query_batchers.get(vec_name)
        if b is None:
            from weaviate_tpu_torch.runtime.query_batcher import QueryBatcher

            b = self._query_batchers.setdefault(
                vec_name,
                QueryBatcher(
                    idx.search_by_vector_batch,
                    supports_filter_batching=idx.supports_batched_filters,
                    # the single-device store has the solo gathered cutover
                    capacity_fn=lambda i=idx: i.store.capacity,
                    async_batch_fn=(idx.search_by_vector_batch_async
                                    if self.async_pipeline else None),
                    # fused sparse+dense drain: hybrid rows ride the
                    # same coalescing window as plain vector queries
                    hybrid_batch_fn=idx.hybrid_batch_async,
                    owner={"collection": self.collection_name,
                           "shard": self.name,
                           "tenant": self._tenant_label()},
                ))
        return b

    def _delete_docs_batch(self, pairs: list[tuple[int, str]]) -> None:
        """Tear down replaced docs: one vector-index delete, one batched
        object fetch, one inverted unindex pass."""
        doc_ids = [d for d, _u in pairs]
        for idx in self.vector_indexes.values():
            if idx is not None:
                idx.delete(*doc_ids)
        raws = self.objects.get_many([u.encode() for _d, u in pairs])
        olds = [StorageObject.from_bytes(r) for r in raws if r is not None]
        if olds:
            self._inverted.unindex_objects(olds)
        for d in doc_ids:
            self._doc_to_uuid.pop(d, None)

    def delete_object(self, uuid: str, tombstone_ms: int | None = None) -> bool:
        import time as _time

        with self._lock:
            if self.read_only:
                raise ShardReadOnlyError(
                    f"shard {self.name!r} is read-only (status READONLY)")
            raw = self.docid.get(uuid.encode())
            if raw is None:
                return False
            # the object/docid deletes commit FIRST, the unindex follows
            old = self.get_object(uuid)
            self.docid.delete(uuid.encode())
            self.objects.delete(uuid.encode())
            self.tombstones.put(uuid.encode(),
                                tombstone_ms or int(_time.time() * 1000))
            doc_id = int(raw)
            for idx in self.vector_indexes.values():
                if idx is not None:
                    idx.delete(doc_id)
            if old is not None:
                self._inverted.unindex_object(old)
            self._doc_to_uuid.pop(doc_id, None)
            return True

    # -- read path -----------------------------------------------------------

    def get_object(self, uuid: str) -> StorageObject | None:
        raw = self.objects.get(uuid.encode())
        if raw is None:
            return None
        return StorageObject.from_bytes(raw)

    def object_count(self) -> int:
        return len(self._doc_to_uuid)

    def objects_by_doc_ids(self, doc_ids) -> list[StorageObject | None]:
        """Batched doc-id -> object resolution: ONE ``kv.get_many`` for
        the whole id list."""
        uuids = [self._doc_to_uuid.get(int(d)) for d in doc_ids]
        keys = [u.encode() for u in uuids if u is not None]
        if not keys:
            return [None] * len(uuids)
        raws = iter(self.objects.get_many(keys))
        out: list[StorageObject | None] = []
        for u in uuids:
            if u is None:
                out.append(None)
                continue
            raw = next(raws)
            out.append(None if raw is None else StorageObject.from_bytes(raw))
        return out

    def vector_search(self, query: np.ndarray, k: int, vec_name: str = "",
                      allow_list: np.ndarray | None = None):
        """(doc_ids, dists) for the shard-local search (reference:
        shard_read.go ObjectVectorSearch)."""
        idx = self.vector_indexes.get(vec_name)
        if idx is None:
            return np.empty(0, np.int64), np.empty(0, np.float32)
        with tracing.span("shard.vector_search", shard=self.name, k=k,
                          filtered=allow_list is not None):
            if self.dynamic_batching and query.ndim == 1:
                return self._batched_search(vec_name, idx, query, k, allow_list)
            return idx.search_by_vector(query, k, allow_list=allow_list)

    def vector_search_batch(self, queries: np.ndarray, k: int,
                            vec_name: str = ""):
        """Batched twin of vector_search: one index batch search, no
        filters. Returns (ids [B, k], dists [B, k], counts [B]); dead rows
        are -1-padded."""
        idx = self.vector_indexes.get(vec_name)
        b = len(queries)
        if idx is None:
            return (np.full((b, k), -1, np.int64),
                    np.full((b, k), np.inf, np.float32),
                    np.zeros(b, np.int64))
        ids, dists = idx.search_by_vector_batch(queries, k)
        return self._finish_batch_results(ids, dists)

    def vector_search_batch_async(self, queries: np.ndarray, k: int,
                                  vec_name: str = ""):
        """Dispatch-only twin of ``vector_search_batch``: a
        ``DeviceResultHandle`` resolving to the same (ids, dists, counts),
        or None when the shard has no index for ``vec_name``."""
        idx = self.vector_indexes.get(vec_name)
        if idx is None:
            return None
        return idx.search_by_vector_batch_async(queries, k).map(
            lambda res: self._finish_batch_results(*res))

    @staticmethod
    def _finish_batch_results(ids, dists):
        ids = np.asarray(ids, np.int64)
        dists = np.asarray(dists, np.float32)
        counts = (ids >= 0).sum(axis=1).astype(np.int64)
        return ids, dists, counts

    def bm25_search(self, query: str, k: int = 10,
                    properties: list[str] | None = None,
                    allow_mask: np.ndarray | None = None):
        """(doc_ids, scores) keyword search (reference: shard ObjectSearch
        -> inverted.BM25Searcher). ``allow_mask`` accepts either form the
        vector path does: bool mask or doc-id array."""
        with tracing.span("shard.bm25_search", shard=self.name, k=k,
                          filtered=allow_mask is not None):
            return self._inverted.bm25_search(query, k, properties,
                                              self._norm_allow(allow_mask))

    def _norm_allow(self, allow_mask):
        """Allow-list normalization shared by the keyword and hybrid
        paths: bool mask passes through, doc-id arrays densify over this
        shard's doc-id space."""
        if allow_mask is None:
            return None
        allow_mask = np.asarray(allow_mask)
        if allow_mask.dtype != np.bool_:
            ids = allow_mask.astype(np.int64)
            allow_mask = np.zeros(self.doc_id_space, dtype=bool)
            allow_mask[ids[ids < len(allow_mask)]] = True
        return allow_mask

    # -- hybrid dataplane ------------------------------------------------------

    def _hybrid_index(self, vec_name: str):
        """The vector index for ``vec_name`` iff it can run the fused
        device hybrid program (and the kill switch is off)."""
        if not self.device_hybrid:
            return None
        idx = self.vector_indexes.get(vec_name)
        if idx is None or not getattr(idx, "supports_device_hybrid",
                                      False):
            return None
        return idx

    def _hybrid_operand(self, idx, query: str, k: int, alpha: float,
                        fusion: str, properties, allow_mask):
        """Plan one hybrid query's sparse leg for device scoring:
        ``bm25_pack`` picks the candidate universe + per-segment
        operands, doc ids translate to store slots. None = this query
        can't ride the device path (no candidates, budget blown, or a
        candidate isn't resident in the vector index)."""
        from weaviate_tpu_torch.ops.bm25 import SparseOperand, fusion_kind

        pack = self._inverted.bm25_pack(
            query, properties, allow_mask,
            max_candidates=self.hybrid_max_candidates)
        if pack is None:
            return None
        slots = idx.slots_for_doc_ids(pack["doc_ids"])
        if len(slots) == 0 or (slots < 0).any():
            # a candidate missing from the vector index would silently
            # vanish from the sparse leg — host fallback keeps recall
            return None
        return SparseOperand(
            pack["doc_ids"], slots, pack["seg_tf"], pack["seg_len"],
            pack["seg_term"], pack["seg_boost"], pack["seg_avg"],
            pack["idf"], pack["k1"], pack["b"], pack["one_minus_b"],
            float(alpha), fusion_kind(fusion),
            max(k * 10, 100),  # host reference over-fetch (collection.py)
            pack["stats"])

    def hybrid_search(self, query: str, vector, k: int = 10,
                      alpha: float = 0.75, fusion: str = "rankedFusion",
                      properties: list[str] | None = None,
                      vec_name: str = "",
                      allow_mask: np.ndarray | None = None):
        """Fused device hybrid: ONE batched device program runs the dense
        scan, BM25F-scores the packed sparse candidates, and merges the
        legs (RRF / relative-score) — no host scoring, no second
        dispatch. Single queries coalesce with concurrent vector and
        hybrid traffic through the shard's QueryBatcher. Returns
        (doc_ids, fused_scores) or None when the device path can't serve
        this query — callers then run the host reference path
        (text/hybrid.py). The JAX package also declines while vectors
        wait in its index queue; the port has no index queue, so every
        acknowledged vector is in the dense leg."""
        idx = self._hybrid_index(vec_name)
        if idx is None or vector is None:
            return None
        allow_mask = self._norm_allow(allow_mask)
        with tracing.span("shard.hybrid_search", shard=self.name, k=k,
                          filtered=allow_mask is not None):
            op = self._hybrid_operand(idx, query, k, alpha, fusion,
                                      properties, allow_mask)
            if op is None:
                return None
            from weaviate_tpu_torch.runtime.query_batcher import \
                DeviceHybridUnavailable

            q = np.asarray(vector, np.float32)
            try:
                if self.dynamic_batching and q.ndim == 1:
                    b = self._query_batcher(vec_name, idx)
                    ids, dists = b.search(q, k, allow_mask, sparse=op)
                else:
                    h = idx.hybrid_batch_async(
                        np.atleast_2d(q), k,
                        [allow_mask] if allow_mask is not None else None,
                        [op])
                    if h is None:
                        return None
                    ids, dists = h.result()
                    ids, dists = ids[0], dists[0]
            except DeviceHybridUnavailable:
                return None
            return self._hybrid_rows(ids, dists, k)

    @staticmethod
    def _hybrid_rows(ids, dists, k: int):
        """Hybrid rows carry NEGATED fused scores on the distance plane:
        drop dead slots and flip the scores back for the caller."""
        ids = np.asarray(ids)[:k]
        dists = np.asarray(dists)[:k]
        live = ids >= 0
        return (ids[live].astype(np.int64),
                (-dists[live]).astype(np.float32))

    def hybrid_search_async(self, query: str, vector, k: int = 10,
                            alpha: float = 0.75,
                            fusion: str = "rankedFusion",
                            properties: list[str] | None = None,
                            vec_name: str = "",
                            allow_mask: np.ndarray | None = None):
        """Dispatch-only twin of ``hybrid_search``: returns a
        ``DeviceResultHandle`` resolving to the same (doc_ids,
        fused_scores), with the copy to the host deferred to
        ``.result()``. None = host fallback (same conditions as the sync
        path)."""
        idx = self._hybrid_index(vec_name)
        if idx is None or vector is None:
            return None
        allow_mask = self._norm_allow(allow_mask)
        op = self._hybrid_operand(idx, query, k, alpha, fusion,
                                  properties, allow_mask)
        if op is None:
            return None
        q = np.atleast_2d(np.asarray(vector, np.float32))
        h = idx.hybrid_batch_async(
            q, k, [allow_mask] if allow_mask is not None else None, [op])
        if h is None:
            return None
        return h.map(lambda res, _k=k: self._hybrid_rows(res[0][0], res[1][0], _k))

    @property
    def doc_id_space(self) -> int:
        """Upper bound (exclusive) on doc ids ever assigned — the size of
        AllowList masks."""
        return self._counter

    def allow_mask(self, where) -> np.ndarray | None:
        """Filter tree -> bool mask over this shard's doc-id space."""
        if where is None:
            return None
        from weaviate_tpu_torch.filters import compute_allow_mask

        with tracing.span("shard.allow_mask", shard=self.name):
            with self._lock:
                return compute_allow_mask(where, self._inverted,
                                          self.doc_id_space)

    # -- maintenance ---------------------------------------------------------

    def flush(self):
        for b in (self.objects, self.docid, self.meta):
            b.flush()

    def close(self):
        for b in self._query_batchers.values():
            b.stop()
        self.store.close()
