"""Shard: the unit of storage + indexing (port of ``weaviate_tpu/db/shard.py``
for flat (plain or BQ/PQ-quantized, one buffer or a stack of epochs), ivf,
dynamic (flat, then ivf), hnsw and noop vector indexes on one device).

Owns an LSM KV store (objects bucket + docid mappings), one vector index
per named vector, and the inverted index behind filters. Write path:
objects + postings land in the KV store, vectors in the device index;
read path: the vector index's top-k through the shard's query batcher,
resolved to uuids; keyword search in the inverted index; hybrid search as
one fused device program (BM25F of the host-planned candidates + fusion
with the dense scan) riding the same batcher. For replication the shard
stages 2PC writes until commit or abort, serves replica digests and a
Merkle tree over them, and applies a peer's newer state (``apply_sync``).
The on-disk layout is the JAX package's, so either package reopens the
other's shards.
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


class StagedExpiredError(RuntimeError):
    """2PC commit refused: the staged entry outlived the staged-entry
    TTL (WEAVIATE_TPU_STAGED_TTL_S). The coordinator treats this like
    any other per-replica commit failure — abort + anti-entropy."""


# bucket names (reference: helpers/helpers.go:22-25)
BUCKET_OBJECTS = "objects"
BUCKET_DOCID = "docid"  # uuid -> doc_id
BUCKET_META = "meta"  # counters, checkpoints


def _make_vector_index(vc: VectorConfig, dim: int, device=None, mesh=None):
    cfg = vc.index
    if cfg.index_type == "noop":
        return None
    common = dict(dim=dim, metric=cfg.metric, capacity=8192, chunk_size=8192,
                  device=device)
    # the mesh reaches every flat store, and IVF so that its
    # single-replica guard raises instead of landing the corpus on one
    # device; the HNSW graph is host-side and takes none (JAX
    # _make_vector_index)
    meshed = dict(common, mesh=mesh)
    storage = "bfloat16" if cfg.storage_dtype == "bfloat16" else "float32"
    if cfg.index_type == "flat" and cfg.quantization:
        return FlatIndex(
            quantization=cfg.quantization,
            pq_segments=cfg.pq_segments,
            pq_centroids=cfg.pq_centroids,
            rescore_limit=cfg.rescore_limit,
            prefix_bits=cfg.prefix_bits,
            epoch_rows=cfg.epoch_rows,
            **meshed,
        )
    if cfg.index_type == "flat":
        return FlatIndex(dtype=storage, epoch_rows=cfg.epoch_rows, **meshed)
    if cfg.index_type in ("hnsw", "ivf") and cfg.quantization == "bq":
        # no bq form for graph hops or IVF lists: the compression request
        # is honoured on the quantized flat scan (documented fallback)
        return FlatIndex(quantization="bq", rescore_limit=cfg.rescore_limit,
                         prefix_bits=cfg.prefix_bits, **meshed)
    if cfg.index_type == "ivf":
        from weaviate_tpu_torch.engine.ivf import IVFIndex

        return IVFIndex(nlist=cfg.ivf_nlist, nprobe=cfg.ivf_nprobe,
                        quantization=cfg.quantization,
                        pq_segments=cfg.pq_segments,
                        pq_centroids=cfg.pq_centroids,
                        dtype=storage, **meshed)
    if cfg.index_type == "hnsw":
        # the reference's graph index: a pq-quantized hnsw keeps its GRAPH
        # (runtime ADC compression once enough data exists, compress.go:38)
        from weaviate_tpu_torch.engine.hnsw import HNSWIndex

        return HNSWIndex(
            dim=dim, metric=cfg.metric,
            max_connections=cfg.max_connections,
            ef_construction=cfg.ef_construction, ef=cfg.ef, device=device,
        )
    if cfg.index_type == "dynamic":
        # flat -> IVF upgrade, so small corpora stay exact
        from weaviate_tpu_torch.engine.dynamic import DynamicIndex

        if cfg.quantization:
            # the quantized flat scan is already the fast path: it stays
            # flat (DynamicIndex refuses to upgrade a quantized impl)
            return DynamicIndex(
                threshold=cfg.flat_to_ann_threshold,
                quantization=cfg.quantization,
                pq_segments=cfg.pq_segments,
                pq_centroids=cfg.pq_centroids,
                rescore_limit=cfg.rescore_limit,
                prefix_bits=cfg.prefix_bits,
                **meshed,
            )
        return DynamicIndex(
            threshold=cfg.flat_to_ann_threshold,
            nlist=cfg.ivf_nlist, nprobe=cfg.ivf_nprobe,
            dtype=storage, **meshed,
        )
    raise ValueError(f"unknown index type {cfg.index_type}")


class Shard:
    def __init__(self, data_dir: str, collection: CollectionConfig, name: str,
                 mesh=None, memwatch=None, async_indexing: bool | None = None,
                 sync_wal: bool | None = None, device=None):
        self.name = name
        self.device = device
        self.memwatch = memwatch
        # ASYNC_INDEXING (reference env gate, repo.go/index_queue.go):
        # imports enqueue vectors; a background worker drains into the
        # vector index. Off by default — searches stay read-your-writes
        # either way (the queued tail is brute-forced on the host).
        if async_indexing is None:
            async_indexing = os.environ.get(
                "ASYNC_INDEXING", "").lower() in ("true", "1", "on",
                                                  "enabled")
        self.async_indexing = async_indexing
        self._index_queues: dict[str, "IndexQueue"] = {}
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
        # staged 2PC batches: request id -> ("put", [objs]) | ("delete",
        # uuid, tombstone_ms). In memory ON PURPOSE: a replica that dies
        # between prepare and commit restarts with nothing staged (an
        # implicit abort), and the write converges through anti-entropy
        # if it committed elsewhere. Live orphans expire after
        # ``staged_ttl_s``: gc drops them, and commit_staged REFUSES them
        # even before gc ran, so a straggler commit racing a partition
        # heal never lands a stale write late.
        self._staged: dict[str, tuple] = {}
        self.staged_ttl_s = float(os.environ.get(
            "WEAVIATE_TPU_STAGED_TTL_S", str(self.STAGED_TTL_S)))
        self._staged_expired = 0
        # anti-entropy's digest snapshot: every write that changes an
        # object's or a tombstone's digest bumps ``_digest_version``; the
        # digest list and the hashtrees built at a version serve until
        # the next such write. A beat round walks each replica's tree
        # from every peer, and a rebuild decodes every object of the
        # shard (the JAX shard rebuilds per walk).
        self._digest_version = 0
        self._digest_cache: tuple | None = None  # (version, [digests])
        self._tree_cache: dict[int, tuple] = {}  # depth -> (version, tree)
        # epoch-migration routing overrides (uuid -> destination shard),
        # durable in the meta bucket; the in-memory count keeps the common
        # case (no migration ever) a free check on reads and puts
        self._migrated_count = sum(
            1 for k in self.meta.keys() if k.startswith(b"migrated:"))
        # memory-pressure rescue hook (db/collection.py wires it to epoch
        # compaction + migration): called once when admission would 507,
        # then admission re-checks before it refuses
        self.memory_rescue = None
        # optional per-shard device-memory quota
        # (WEAVIATE_TPU_SHARD_HBM_LIMIT_BYTES): the watermark epoch
        # migration exists for — moving the coldest sealed epoch to a
        # sibling relieves THIS shard's ledger footprint
        try:
            self.shard_hbm_limit = int(os.environ.get(
                "WEAVIATE_TPU_SHARD_HBM_LIMIT_BYTES", "0") or 0)
        except ValueError:
            self.shard_hbm_limit = 0
        self._counter = self.meta.get(b"doc_counter") or 0
        self.read_only = bool(self.meta.get(b"read_only") or False)
        self.mesh = mesh
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
            idx = _make_vector_index(vc, dim, device=self.device,
                                     mesh=self.mesh)
        self.vector_indexes[vec_name] = idx
        self._register_drift_canary(vec_name)
        return idx

    def _register_drift_canary(self, vec_name: str) -> None:
        """Hand this vector space to driftwatch as a canary target. The
        callbacks resolve ``self.vector_indexes[vec_name]`` per call so
        they survive compress() / DynamicIndex upgrades swapping stores
        under the same key, and the probe search routes through
        ``_query_batcher`` — the REAL serving dispatch (coalescing,
        faultline point, kernelscope attribution), not a side channel.
        The closures hold this shard: ``close`` unregisters them, or a
        closed tenant's tensors would stay on the card."""
        from weaviate_tpu_torch.runtime import driftwatch

        def _idx():
            return self.vector_indexes.get(vec_name)

        def corpus_fn():
            idx = _idx()
            id_map = getattr(idx, "_id_to_slot", None)
            if not id_map:
                return None
            doc_ids = sorted(int(d) for d in id_map)
            objs = self.objects_by_doc_ids(doc_ids)
            ids, vecs = [], []
            for d, obj in zip(doc_ids, objs):
                v = None if obj is None else obj.vectors.get(vec_name)
                if v is not None:
                    ids.append(d)
                    vecs.append(np.asarray(v, dtype=np.float32))
            if not ids:
                return None
            return np.asarray(ids, dtype=np.int64), np.stack(vecs)

        def epoch_token_fn():
            return self.epoch_token(vec_name)

        def pairwise_fn(qs, vecs):
            idx = _idx()
            metric = getattr(idx, "metric", "l2-squared")
            return Shard._host_pairwise(qs, vecs, metric)

        def search_fn(queries, k):
            idx = _idx()
            if idx is None or getattr(idx, "search_by_vector_batch",
                                      None) is None:
                return None
            b = self._query_batcher(vec_name, idx)
            out = []
            for q in np.asarray(queries, dtype=np.float32):
                ids, _ = b.search(q, k, None)
                ids = np.asarray(ids)
                out.append(ids[ids >= 0].astype(np.int64))
            return out

        driftwatch.register_canary(
            f"{self.collection_name}/{self.name}/{vec_name or '-'}",
            collection=self.collection_name, shard=self.name,
            search_fn=search_fn, corpus_fn=corpus_fn,
            epoch_token_fn=epoch_token_fn, pairwise_fn=pairwise_fn)

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
        gate = self.memwatch is not None or self.shard_hbm_limit
        if gate:
            nbytes = sum(int(np.asarray(v).nbytes)
                         for o in objs for v in o.vectors.values())
            # optimistic rescue pass OUTSIDE the shard lock, so the hook
            # (epoch compaction, then migrating the coldest sealed epoch
            # to a sibling: db/collection.py) can touch sibling shards
            # without a lock cycle; the authoritative check re-runs under
            # the lock below. A read-only shard skips it and refuses
            # with ShardReadOnlyError, not 507.
            if not self.read_only:
                try:
                    self._admit_device_bytes(nbytes)
                except MemoryError:
                    if self.memory_rescue is None:
                        raise
                    try:
                        self.memory_rescue()
                    except Exception:  # noqa: BLE001 — best effort; the
                        logger.exception(  # typed 507 below is the answer
                            "shard %s/%s: memory-pressure rescue failed",
                            self.collection_name, self.name)
        with self._lock:
            if self.read_only:
                raise ShardReadOnlyError(
                    f"shard {self.name!r} is read-only (status READONLY)")
            self._validate_vectors(objs)
            if gate:
                # refuse BEFORE mutating anything (reference memwatch
                # CheckAlloc semantics): vectors land in device memory
                self._admit_device_bytes(nbytes)
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
            self._digest_version += 1
            for vec_name, (ids, vecs) in vec_batches.items():
                idx = self._ensure_vector_index(vec_name, len(vecs[0]))
                if idx is None:
                    continue
                # the fast path hands a prebuilt [n, d] block
                block = vecs if isinstance(vecs, np.ndarray) else np.stack(vecs)
                if self.async_indexing:
                    self._index_queue(vec_name, idx).push(np.asarray(ids), block)
                else:
                    idx.add_batch(np.asarray(ids), block)
                    self._maybe_compress(vec_name, idx)
        return doc_ids

    def _batched_search(self, vec_name: str, idx, query: np.ndarray, k: int,
                        allow_list):
        """Dynamic-batched single-query search: concurrent callers share
        one device dispatch. Index types without a batch entry point take
        the direct path."""
        if getattr(idx, "search_by_vector_batch", None) is None:
            return idx.search_by_vector(query, k, allow_list=allow_list)
        b = self._query_batcher(vec_name, idx)
        ids, dists = b.search(query, k, allow_list)
        live = ids >= 0
        return (np.asarray(ids)[live].astype(np.int64),
                np.asarray(dists)[live].astype(np.float32))

    def _query_batcher(self, vec_name: str, idx):
        """The shard's per-vector-space QueryBatcher, built lazily. Every
        entry point and capability is resolved PER CALL: compress() and
        DynamicIndex.upgrade() swap the store or the impl under a live
        batcher, and a bound method captured at construction would serve
        from the dead one."""
        b = self._query_batchers.get(vec_name)
        if b is None:
            from weaviate_tpu_torch.runtime.query_batcher import QueryBatcher

            def _batch(queries, k2, allow=None, i=idx):
                return i.search_by_vector_batch(queries, k2, allow)

            # an index without an async twin (hnsw) returns None and the
            # batcher takes its sync path
            def _async_batch(queries, k2, allow=None, i=idx):
                fn = getattr(i, "search_by_vector_batch_async", None)
                return None if fn is None else fn(queries, k2, allow)

            # fused sparse+dense drain: hybrid rows ride the same
            # coalescing window as plain vector queries
            def _hybrid_batch(queries, k2, allows=None, sparses=None, i=idx):
                fn = getattr(i, "hybrid_batch_async", None)
                return None if fn is None else fn(queries, k2, allows, sparses)

            b = self._query_batchers.setdefault(
                vec_name,
                QueryBatcher(
                    _batch,
                    supports_filter_batching=lambda i=idx: bool(
                        getattr(i, "supports_batched_filters", False)),
                    capacity_fn=lambda i=idx: self._gathered_capacity(i),
                    # a graph search per row gains nothing from pow2 rows
                    pad_pow2=bool(getattr(idx, "compiled_batch_shapes", True)),
                    async_batch_fn=(_async_batch if self.async_pipeline
                                    else None),
                    hybrid_batch_fn=_hybrid_batch,
                    owner={"collection": self.collection_name,
                           "shard": self.name,
                           "tenant": self._tenant_label()},
                    # kernelscope variant label: residency EWMAs key on
                    # (index kind, b bucket, k bucket)
                    kind=str(getattr(idx, "index_type", "index")),
                    # residency on the card: CUDA events on this device
                    device=self.device,
                ))
        return b

    @staticmethod
    def _gathered_capacity(idx) -> int:
        """The batcher's selectivity cutover: the store's capacity when it
        has a solo gathered path, else 0 (never solo). One epoch at slot 0
        IS a single store and keeps the cutover; a multi-epoch stack has
        no host-remap solo path, so a selective filter rides the batched
        bitmask there. A mesh store has no gathered path (its rows stay
        on their shards): 0. Resolved per call: compress() swaps the
        store."""
        es = getattr(idx, "epoch_store", None)
        if es is not None:
            return es.capacity if (es.mesh is None and not es.quantization
                                   and es.epoch_count == 1) else 0
        # only a plain store has the solo gathered path; elsewhere (ivf,
        # hnsw) a solo dispatch is strictly worse than riding the batch
        s = getattr(idx, "store", None)
        if (s is None or getattr(s, "mesh", None) is not None
                or not hasattr(s, "_dispatch_gathered")):
            return 0
        return s.capacity

    def epoch_token(self, vec_name: str = ""):
        """A token that changes whenever the vector space's contents or
        epoch layout change (per-epoch rows and live counts, the index
        length): the key a driftwatch canary's cached ground truth is held
        against. None without an index."""
        idx = self.vector_indexes.get(vec_name)
        if idx is None:
            return None
        es = getattr(idx, "epoch_store", None)
        if es is not None:
            return (tuple((e["epoch"], e["rows"], e["live"])
                          for e in es.epoch_stats()), len(idx))
        return (len(idx),)

    def _index_queue(self, vec_name: str, idx):
        q = self._index_queues.get(vec_name)
        if q is None:
            from weaviate_tpu_torch.runtime.index_queue import IndexQueue

            q = IndexQueue(idx)
            self._index_queues[vec_name] = q
        return q

    def _delete_docs_batch(self, pairs: list[tuple[int, str]]) -> None:
        """Tear down replaced docs: one vector-index delete, one batched
        object fetch, one inverted unindex pass."""
        doc_ids = [d for d, _u in pairs]
        for q in self._index_queues.values():
            for d in doc_ids:
                q.delete(d)  # drop any queued insert for this doc
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
            self._digest_version += 1
            doc_id = int(raw)
            for q in self._index_queues.values():
                q.delete(doc_id)  # drop any queued insert for this doc
            for idx in self.vector_indexes.values():
                if idx is not None:
                    idx.delete(doc_id)
            if old is not None:
                self._inverted.unindex_object(old)
            self._doc_to_uuid.pop(doc_id, None)
            return True

    # -- read path -----------------------------------------------------------

    def put_object(self, obj: StorageObject) -> int:
        """Insert or update (reference: shard_write_put.go:218
        putObjectLSM); updates get a fresh doc id."""
        return self.put_object_batch([obj])[0]

    def exists(self, uuid: str) -> bool:
        return self.docid.get(uuid.encode()) is not None

    def object_by_doc_id(self, doc_id: int) -> StorageObject | None:
        uuid = self._doc_to_uuid.get(int(doc_id))
        return None if uuid is None else self.get_object(uuid)

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
        shard_read.go ObjectVectorSearch). With async indexing on, queued
        (not-yet-indexed) vectors are brute-forced and merged so the path
        stays read-your-writes (reference: index queue search over the
        unindexed tail)."""
        idx = self.vector_indexes.get(vec_name)
        if idx is None:
            return np.empty(0, np.int64), np.empty(0, np.float32)
        with tracing.span("shard.vector_search", shard=self.name, k=k,
                          filtered=allow_list is not None):
            return self._vector_search_traced(idx, query, k, vec_name,
                                              allow_list)

    def _vector_search_traced(self, idx, query, k, vec_name, allow_list):
        # snapshot BEFORE the index search: every queued vector is either
        # in the snapshot or already drained into the index by the time
        # the index search runs — the union misses nothing (the reverse
        # order races a drain finishing between the two reads)
        queued = self._queued_candidates(vec_name, query, allow_list)
        if self.dynamic_batching and query.ndim == 1:
            ids, dists = self._batched_search(vec_name, idx, query, k,
                                              allow_list)
        else:
            ids, dists = idx.search_by_vector(query, k, allow_list=allow_list)
        if queued is None:
            return ids, dists
        q_ids, q_dists = queued
        cat_ids = np.concatenate([np.asarray(ids, np.int64), q_ids])
        cat_d = np.concatenate([np.asarray(dists, np.float32), q_dists])
        order = np.argsort(cat_d, kind="stable")
        # dedup (a drain may have landed an in-flight vector in the index
        # between the index search and the snapshot), best distance first
        seen: set = set()
        out_ids, out_d = [], []
        for j in order:
            did = int(cat_ids[j])
            if did in seen:
                continue
            seen.add(did)
            out_ids.append(did)
            out_d.append(float(cat_d[j]))
            if len(out_ids) == k:
                break
        return (np.asarray(out_ids, np.int64),
                np.asarray(out_d, np.float32))

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
        queue = self._index_queues.get(vec_name)
        pending = queue.snapshot() if queue is not None else []
        ids, dists = idx.search_by_vector_batch(queries, k)
        return self._finish_batch_results(ids, dists, pending, queries,
                                          idx.metric, k)

    def vector_search_batch_async(self, queries: np.ndarray, k: int,
                                  vec_name: str = ""):
        """Dispatch-only twin of ``vector_search_batch``: a
        ``DeviceResultHandle`` resolving to the same (ids, dists, counts),
        or None when the shard has no index for ``vec_name`` or the index
        has no async path (hnsw: the caller runs the sync call). The
        queued-tail snapshot is taken BEFORE the index dispatch (the
        ordering of ``_vector_search_traced``) and merged in the handle's
        host finish step."""
        idx = self.vector_indexes.get(vec_name)
        if idx is None:
            return None
        fn = getattr(idx, "search_by_vector_batch_async", None)
        if fn is None:
            return None
        queue = self._index_queues.get(vec_name)
        pending = queue.snapshot() if queue is not None else []
        queries = np.asarray(queries, np.float32)
        return fn(queries, k).map(
            lambda res, _p=pending, _q=queries, _m=idx.metric:
            self._finish_batch_results(*res, _p, _q, _m, k))

    def _finish_batch_results(self, ids, dists, pending, queries,
                              metric: str, k: int):
        """Host half shared by the sync and pipelined batch paths:
        merge the queued (not-yet-indexed) tail, count live rows."""
        b = len(queries)
        ids = np.asarray(ids, np.int64)
        dists = np.asarray(dists, np.float32)
        if pending:
            q_ids = np.asarray([d for d, _ in pending], np.int64)
            q_vecs = np.stack([v for _, v in pending]).astype(np.float32)
            qd = self._host_pairwise(np.asarray(queries, np.float32),
                                     q_vecs, metric)  # [B, nq]
            cat_ids = np.concatenate(
                [ids, np.broadcast_to(q_ids, (b, len(q_ids)))], axis=1)
            cat_d = np.concatenate([dists, qd.astype(np.float32)], axis=1)
            order = np.argsort(cat_d, axis=1, kind="stable")
            out_i = np.full((b, k), -1, np.int64)
            out_d = np.full((b, k), np.inf, np.float32)
            for r in range(b):
                seen: set = set()
                n = 0
                for j in order[r]:
                    did = int(cat_ids[r, j])
                    if did < 0 or did in seen:
                        continue
                    seen.add(did)
                    out_i[r, n] = did
                    out_d[r, n] = cat_d[r, j]
                    n += 1
                    if n == k:
                        break
            ids, dists = out_i, out_d
        counts = (ids >= 0).sum(axis=1).astype(np.int64)
        return ids, dists, counts

    @staticmethod
    def _host_pairwise(qs: np.ndarray, vecs: np.ndarray,
                       metric: str) -> np.ndarray:
        """[B, n] host-BLAS distances of the queued tail (it is small and
        its length changes every drain tick: no device dispatch)."""
        if metric in ("cosine", "cosine-dot"):
            def unit(a):
                n = np.linalg.norm(a, axis=-1, keepdims=True)
                return a / np.where(n > 1e-30, n, 1.0)

            return 1.0 - unit(qs) @ unit(vecs).T
        if metric == "dot":
            return -(qs @ vecs.T)
        if metric == "hamming":
            return (qs[:, None, :] != vecs[None, :, :]).sum(-1).astype(
                np.float32)
        if metric == "manhattan":
            return np.abs(qs[:, None, :] - vecs[None, :, :]).sum(-1)
        sq = (qs ** 2).sum(-1)[:, None] + (vecs ** 2).sum(-1)[None, :]
        return sq - 2.0 * (qs @ vecs.T)

    def _queued_candidates(self, vec_name: str, query: np.ndarray,
                           allow_list: np.ndarray | None):
        queue = self._index_queues.get(vec_name)
        if queue is None:
            return None
        pending = queue.snapshot()
        if not pending:
            return None
        ids = np.asarray([d for d, _ in pending], dtype=np.int64)
        vecs = np.stack([v for _, v in pending]).astype(np.float32)
        if allow_list is not None:
            allow = np.asarray(allow_list)
            if allow.dtype == np.bool_:
                keep = (ids < len(allow)) & allow[
                    np.clip(ids, 0, len(allow) - 1)]
            else:
                keep = np.isin(ids, allow.astype(np.int64))
            ids, vecs = ids[keep], vecs[keep]
            if not len(ids):
                return None
        metric = getattr(self.vector_indexes.get(vec_name), "metric",
                         "l2-squared")
        q = np.asarray(query, np.float32)
        d = self._host_pairwise(q[None, :], vecs, metric)[0]
        return ids, d.astype(np.float32)

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

    def _queued_tail(self, vec_name: str) -> bool:
        queue = self._index_queues.get(vec_name)
        return queue is not None and bool(queue.snapshot())

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
        (text/hybrid.py)."""
        idx = self._hybrid_index(vec_name)
        if idx is None or vector is None:
            return None
        if self._queued_tail(vec_name):
            # queued (not-yet-indexed) vectors are invisible to the
            # device dense leg; the host path brute-forces that tail
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
        if idx is None or vector is None or self._queued_tail(vec_name):
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

    def set_read_only(self, value: bool) -> None:
        """Persisted so a restart keeps the freeze (reference persists
        shard status)."""
        with self._lock:
            self.read_only = bool(value)
            self.meta.put(b"read_only", bool(value))

    def _admit_device_bytes(self, nbytes: int) -> None:
        """Both admission gates, typed 507 on either: the device-global
        watermark (memwatch) and the per-shard quota (ledger bytes vs
        ``shard_hbm_limit``)."""
        what = f"import {self.collection_name}/{self.name}"
        if self.memwatch is not None:
            self.memwatch.check_device_alloc(nbytes, what=what)
        if self.shard_hbm_limit and self.over_shard_limit(nbytes):
            from weaviate_tpu_torch.runtime.hbm_ledger import ledger
            from weaviate_tpu_torch.runtime.memwatch import \
                InsufficientMemoryError

            used = ledger.shard_bytes(self.collection_name, self.name)
            high = (self.memwatch.high_watermark
                    if self.memwatch is not None else 0.9)
            raise InsufficientMemoryError(
                f"device allocation of {nbytes} bytes ({what}) would "
                f"exceed {high:.0%} of shard HBM quota "
                f"{self.shard_hbm_limit} (ledger usage {used})",
                projected=used + int(nbytes),
                budget=self.shard_hbm_limit, source="ledger")

    def over_shard_limit(self, extra: int = 0) -> bool:
        """Is this shard's ledger footprint (+``extra``) past its quota
        watermark? The epoch policy migrates when this trips."""
        if not self.shard_hbm_limit:
            return False
        from weaviate_tpu_torch.runtime.hbm_ledger import ledger

        high = (self.memwatch.high_watermark
                if self.memwatch is not None else 0.9)
        used = ledger.shard_bytes(self.collection_name, self.name)
        return used + int(extra) > self.shard_hbm_limit * high

    # -- epoch migration (db/collection.py orchestrates) ----------------------

    def migrated_to(self, uuid: str) -> str | None:
        """Destination shard of a migrated object, or None. The durable
        marker keeps uuid routing correct after an epoch moved its objects
        to a sibling; the in-memory count makes this free when no
        migration ever happened."""
        if self._migrated_count <= 0:
            return None
        v = self.meta.get(b"migrated:" + uuid.encode())
        if v is None:
            return None
        return v.decode() if isinstance(v, (bytes, bytearray)) else str(v)

    def clear_migrated(self, uuid: str) -> None:
        """Drop a routing override (the object was re-put or deleted at
        its ring home)."""
        with self._lock:
            if self.meta.get(b"migrated:" + uuid.encode()) is not None:
                self.meta.delete(b"migrated:" + uuid.encode())
                self._migrated_count = max(0, self._migrated_count - 1)

    def mark_migrating(self, uuids: list[str], dst_name: str) -> None:
        """Write the routing markers durably (one WAL frame) BEFORE the
        destination ingest: a kill anywhere after this leaves every copy
        findable — GETs prefer the ring copy and follow the marker only on
        a miss, deletes and re-puts clean BOTH sides through it, search
        dedups by uuid. A marker to a copy that never landed is harmless
        for the same reasons."""
        with self._lock:
            keys = [b"migrated:" + u.encode() for u in uuids]
            fresh = sum(1 for k in keys if self.meta.get(k) is None)
            self.meta.put_many([(k, dst_name) for k in keys])
            # re-marking an interrupted move must not inflate the count
            self._migrated_count += fresh

    def migrate_out(self, uuids: list[str], dst_name: str) -> int:
        """Source-side cutover AFTER the destination acknowledged the
        ingest (``mark_migrating`` wrote the markers before it): remove
        the objects — batched index tombstones, inverted unindex, docid
        and objects deletes. A kill before this leaves an object present
        twice (never lost; the markers reach both copies); after it, reads
        route through the markers to the destination."""
        with self._lock:
            keys = [u.encode() for u in uuids]
            pairs = []
            for u, k in zip(uuids, keys):
                raw = self.docid.get(k)
                if raw is not None:
                    pairs.append((int(raw), u))
            if pairs:
                self._delete_docs_batch(pairs)
            self.docid.delete_many(keys)
            self.objects.delete_many(keys)
            self._digest_version += 1
            return len(pairs)

    def epoch_maintenance(self) -> bool:
        """Run the epoch policy for every epoch-backed index of this
        shard: seal full active epochs, drop empty sealed ones, fold
        tombstone-heavy ones (their memory goes back through the ledger
        finalizers). Indexes with their own ``maintain`` hook (the IVF
        delta fold / drift retrain, dynamic's deferred upgrade) get the
        same tick. Returns True when it did work (the cyclemanager's
        backoff signal)."""
        did = False
        for idx in self.vector_indexes.values():
            es = getattr(idx, "epoch_store", None)
            if es is not None:
                did = es.maintain() or did
            idx_maintain = getattr(idx, "maintain", None)
            if idx_maintain is not None:
                idx_maintain()
        return did

    # -- replication support -------------------------------------------------

    STAGED_TTL_S = 120.0

    def stage(self, request_id: str, task: tuple) -> None:
        """2PC prepare: hold a write until commit/abort
        (reference: replica store staging before commit). A READONLY
        shard votes NO here — failing at prepare keeps all replicas
        consistent instead of silently diverging at commit."""
        import time as _time

        with self._lock:
            if self.read_only:
                raise ShardReadOnlyError(
                    f"shard {self.name!r} is read-only (status READONLY)")
            self._staged[request_id] = (_time.monotonic(), task)

    def gc_staged(self) -> int:
        """Drop staged batches whose coordinator never came back (crash
        between prepare and commit/abort) — anti-entropy re-delivers the
        write if it committed elsewhere. Every expiry is counted
        (``weaviate_tpu_replication_staged_expired_total``): an orphaned
        prepare must neither leak nor commit, and the counter is how a
        chaos run proves the TTL path actually fired."""
        import time as _time

        cutoff = _time.monotonic() - self.staged_ttl_s
        with self._lock:
            stale = [rid for rid, (t, _task) in self._staged.items()
                     if t < cutoff]
            for rid in stale:
                del self._staged[rid]
            self._staged_expired += len(stale)
        if stale:
            self._count_staged_expired(len(stale))
        return len(stale)

    def _count_staged_expired(self, n: int) -> None:
        try:
            from weaviate_tpu_torch.runtime.metrics import (
                replication_staged_expired)

            replication_staged_expired.labels(
                self.collection_name, self.name).inc(n)
        except Exception:  # pragma: no cover — registry unavailable
            pass

    def commit_staged(self, request_id: str):
        """2PC commit. An entry past its TTL is REFUSED, not applied:
        without this, a commit that sat in flight across a partition
        (or a coordinator straggler thread racing the heal) could land
        a stale write long after the rest of the replica set aborted —
        the expiry has to be deterministic at the commit boundary, not
        dependent on whether the gc cycle happened to run first."""
        import time as _time

        with self._lock:
            entry = self._staged.pop(request_id, None)
            if entry is not None \
                    and _time.monotonic() - entry[0] > self.staged_ttl_s:
                self._staged_expired += 1
                self._count_staged_expired(1)
                raise StagedExpiredError(
                    f"replication request {request_id!r} staged "
                    f"{_time.monotonic() - entry[0]:.1f}s ago, past the "
                    f"{self.staged_ttl_s:.0f}s TTL — refused (late "
                    "commit after partition heal)")
        if entry is None:
            raise KeyError(f"unknown replication request {request_id!r}")
        _t, task = entry
        kind = task[0]
        if kind == "put":
            return self.put_object_batch(task[1])
        if kind == "delete":
            return self.delete_object(task[1], tombstone_ms=task[2])
        raise ValueError(f"unknown staged task kind {kind!r}")

    def staged_status(self) -> dict:
        """Introspection for the chaos checker's leak invariant: live
        staged entries (gc'd first so the answer is TTL-deterministic)
        and the total this shard ever expired."""
        self.gc_staged()
        with self._lock:
            return {"staged": len(self._staged),
                    "expired_total": self._staged_expired}

    def abort_staged(self, request_id: str) -> None:
        with self._lock:
            self._staged.pop(request_id, None)

    def object_digest(self, uuid: str) -> dict | None:
        """Replica-comparable digest (reference: Finder digest reads,
        repairer.go). None = never seen here."""
        raw = self.objects.get(uuid.encode())
        if raw is not None:
            obj = StorageObject.from_bytes(raw)
            return {"uuid": uuid, "mtime": obj.last_update_time_ms,
                    "deleted": False, "hash": obj.content_hash()}
        ts = self.tombstones.get(uuid.encode())
        if ts is not None:
            return {"uuid": uuid, "mtime": int(ts), "deleted": True,
                    "hash": b""}
        return None

    def iter_digests(self):
        """Every live object's digest, in doc-id order, then every
        tombstone's: the JAX shard's entries in its order. The objects come
        from ONE scan of the objects bucket (a point read a uuid, as the
        JAX shard does, costs several times as much once the bucket has
        segments)."""
        with self._lock:
            uuids = list(self._doc_to_uuid.values())
            tombs = [(k.decode(), int(v)) for k, v in
                     ((k, self.tombstones.get(k)) for k in
                      self.tombstones.keys()) if v is not None]
        live = {}
        for _key, raw in self.objects.iter_items():
            obj = StorageObject.from_bytes(raw)
            live[obj.uuid] = {"uuid": obj.uuid,
                              "mtime": obj.last_update_time_ms,
                              "deleted": False, "hash": obj.content_hash()}
        for uuid in uuids:
            d = live.get(uuid)
            if d is not None:
                yield d
        for uuid, ts in tombs:
            yield {"uuid": uuid, "mtime": ts, "deleted": True, "hash": b""}

    def _digests(self) -> list[dict]:
        """``iter_digests`` as a list, kept until the next write that
        changes a digest. A write racing the walk leaves nothing cached."""
        with self._lock:
            version, cached = self._digest_version, self._digest_cache
        if cached is not None and cached[0] == version:
            return cached[1]
        digests = list(self.iter_digests())
        with self._lock:
            if self._digest_version == version:
                self._digest_cache = (version, digests)
        return digests

    def build_hashtree(self, depth: int = 8):
        """Merkle tree over all digests (reference: shard hashtree kept
        by the hashbeater), built once a digest version and depth; the
        tree is shared, so callers only read it."""
        from weaviate_tpu_torch.replication.hashtree import MerkleTree

        with self._lock:
            version = self._digest_version
            cached = self._tree_cache.get(depth)
        if cached is not None and cached[0] == version:
            return cached[1]
        tree = MerkleTree(depth)
        for d in self._digests():
            tree.insert(d["uuid"], d["mtime"], d["deleted"], d["hash"])
        with self._lock:
            if self._digest_version == version:
                self._tree_cache[depth] = (version, tree)
        return tree

    def bucket_digests(self, depth: int, buckets: list[int]) -> list[dict]:
        """Digest entries falling into the given hashtree leaf buckets."""
        from weaviate_tpu_torch.replication.hashtree import MerkleTree

        want = set(buckets)
        return [d for d in self._digests()
                if MerkleTree.bucket_of(d["uuid"], depth) in want]

    def apply_sync(self, raw_objects: list[bytes],
                   deletes: list[dict]) -> int:
        """Apply newer peer state (anti-entropy propagation). Winner per
        uuid decided by digest_rank (mtime, tombstone-beats-object,
        content-hash tie-break). The winning objects land in ONE
        put_object_batch (one scatter into the device store, where the
        JAX shard puts them one at a time); a uuid pushed twice keeps its
        highest-ranked copy."""
        from weaviate_tpu_torch.replication.hashtree import digest_rank

        applied = 0
        with self._lock:
            wins: dict[str, tuple] = {}  # uuid -> (object, its digest)
            for raw in raw_objects:
                obj = StorageObject.from_bytes(raw)
                if self.migrated_to(obj.uuid):
                    # the durable cutover moved this uuid to its marker
                    # destination: re-applying a peer's (stale) copy here
                    # would resurrect the moved-away object at its old
                    # ring home — double-present to search, and the next
                    # hashbeat would propagate the zombie back out.
                    # Anti-entropy must respect the marker like reads do.
                    logger.debug("apply_sync: skipping %s — migrated to "
                                 "%s", obj.uuid, self.migrated_to(obj.uuid))
                    continue
                mine = wins.get(obj.uuid, (None, None))[1] \
                    or self.object_digest(obj.uuid)
                incoming = {"mtime": obj.last_update_time_ms,
                            "deleted": False, "hash": obj.content_hash()}
                if mine is not None and digest_rank(mine) >= digest_rank(incoming):
                    continue
                obj.doc_id = 0  # re-assigned locally
                wins[obj.uuid] = (obj, incoming)
            if wins:
                self.put_object_batch([o for o, _d in wins.values()])
                applied += len(wins)
            for d in deletes:
                mine = self.object_digest(d["uuid"])
                incoming = {"mtime": d["mtime"], "deleted": True, "hash": b""}
                if mine is None:
                    # never saw it: record the tombstone so our tree converges
                    self.tombstones.put(d["uuid"].encode(), d["mtime"])
                    self._digest_version += 1
                    applied += 1
                    continue
                if digest_rank(mine) >= digest_rank(incoming):
                    continue
                if mine["deleted"]:
                    self.tombstones.put(d["uuid"].encode(), d["mtime"])
                    self._digest_version += 1
                else:
                    self.delete_object(d["uuid"], tombstone_ms=d["mtime"])
                applied += 1
        return applied

    # -- maintenance ---------------------------------------------------------

    def flush(self):
        for name, q in self._index_queues.items():
            if not q.wait_idle(timeout=30.0):
                logger.warning(
                    "shard %s/%s: index queue %r still has %d queued "
                    "vectors after 30s — flush() returns with the vector "
                    "index lagging the object store",
                    self.collection_name, self.name, name, q.size())
        for b in (self.objects, self.docid, self.meta):
            b.flush()

    def maintenance(self, compact_above: int = 4) -> bool:
        """One background cycle: flush dirty memtables, compact segment
        stacks past the threshold (reference: store_cyclecallbacks.go),
        and publish the vector indexes' gauges. Returns True when work
        was done (cyclemanager backoff signal)."""
        from weaviate_tpu_torch.runtime.metrics import (
            lsm_segment_count, vector_index_compressed,
            vector_index_hbm_bytes, vector_index_tombstones)

        did = False
        if self.gc_staged():
            did = True
        for b in self.store.buckets():
            # sealed-memtable flush + threshold compaction, all off the
            # write path (reference: store_cyclecallbacks.go)
            if b.maintain(compact_above=compact_above):
                did = True
            lsm_segment_count.labels(
                f"{self.collection_name}/{self.name}/{b.name}"
            ).set(b.segment_count)
        for vec_name, idx in self.vector_indexes.items():
            if idx is None:
                continue
            labels = (self.collection_name, self.name, vec_name or "default")
            store = getattr(idx, "store", None)
            live = len(idx)
            total = getattr(store, "count", live) if store is not None \
                else live
            vector_index_tombstones.labels(*labels).set(max(total - live, 0))
            vector_index_compressed.labels(*labels).set(
                1 if getattr(idx, "compressed", False) else 0)
            hbm = 0
            stores = ([ep.store for ep in store.epochs]
                      if getattr(idx, "epoch_store", None) is not None
                      else [store])
            for st in stores:
                for arr_name in ("vectors", "valid", "sq_norms", "codes",
                                 "rescore_rows"):
                    arr = getattr(st, arr_name, None)
                    if arr is not None and hasattr(arr, "nbytes"):
                        hbm += int(arr.nbytes)
            vector_index_hbm_bytes.labels(*labels).set(hbm)
        return did

    def close(self):
        from weaviate_tpu_torch.runtime import driftwatch

        driftwatch.unregister_canaries(
            f"{self.collection_name}/{self.name}/")
        for q in self._index_queues.values():
            q.stop()
        for b in self._query_batchers.values():
            b.stop()
        # the batchers' closures and the collection's rescue hook refer
        # back to this shard: dropping them here breaks those cycles, so
        # a closed (COLD / FROZEN) tenant's tensors leave the card when
        # the collection lets go of the shard, not at a later gc pass
        self._query_batchers.clear()
        self.memory_rescue = None
        self.store.close()
