"""Flat (brute-force) vector index (port of ``weaviate_tpu/engine/flat.py``,
plain or BQ/PQ-quantized, one device, no epochs).

Reference: adapters/repos/db/vector/flat/index.go (full scan). Here the
full scan is the CUDA kernels' workload: one batched distance product over
the device-resident corpus per chunk, fused with a running top-k; with
``quantization`` the store holds codes and scans them through the
scan-reduce kernels, then rescores exactly (engine/quantized.py).

Doc-id mapping: callers address vectors by external int64 doc ids (the
shard layer maps UUIDs -> doc ids). Internally ids map to store slots;
tombstoned slots are reclaimed by ``compact()``.
"""

from __future__ import annotations

import threading

import numpy as np

from weaviate_tpu_torch.engine.quantized import QuantizedVectorStore
from weaviate_tpu_torch.engine.store import DeviceVectorStore
from weaviate_tpu_torch.runtime import hbm_ledger, tracing


def _per_query_allow(allow_list) -> bool:
    """True when ``allow_list`` is a sequence of PER-QUERY allow lists
    (entries None or array-like) rather than one shared filter. A plain
    list of scalar doc ids — the empty list included — is one shared
    filter."""
    if not isinstance(allow_list, (list, tuple)) or len(allow_list) == 0:
        return False
    return any(a is None or np.ndim(a) > 0 for a in allow_list)


class FlatIndex:
    """Implements the reference ``VectorIndex`` contract for brute-force
    search. ``selection`` picks the scan's top-k strategy ("approx" |
    "exact" | "fused" — ops/topk.chunked_topk_distances). With
    ``quantization`` it passes through to the quantized store's survivor
    selection, which takes "approx" and "fused" only."""

    index_type = "flat"
    # the batched entry point accepts PER-QUERY allow lists and runs them
    # as one bitmask-batched device program
    supports_batched_filters = True
    # the batcher pads drains to pow2 buckets
    compiled_batch_shapes = True

    def __init__(self, dim: int, metric: str = "l2-squared", mesh=None,
                 dtype=None, capacity: int = 8192, chunk_size: int = 8192,
                 quantization: str | None = None,
                 selection: str = "approx", epoch_rows: int = 0,
                 device=None, **quant_kwargs):
        if epoch_rows:
            raise NotImplementedError("epoch stores: ROADMAP Queue 1 item 7")
        self.dim = dim
        self.metric = metric
        if quantization:
            self.store = QuantizedVectorStore(
                dim=dim, metric=metric, quantization=quantization,
                capacity=capacity, chunk_size=chunk_size, mesh=mesh,
                selection=selection, device=device, **quant_kwargs)
        else:
            if quant_kwargs:
                raise TypeError(
                    f"unexpected kwargs without quantization: {sorted(quant_kwargs)}")
            self.store = DeviceVectorStore(
                dim=dim, metric=metric, capacity=capacity, dtype=dtype,
                mesh=mesh, chunk_size=chunk_size, selection=selection,
                device=device)
        self._lock = threading.RLock()
        self._id_to_slot: dict[int, int] = {}
        self._slot_to_id: np.ndarray = np.full(self.store.capacity, -1, dtype=np.int64)

    # -- VectorIndex contract -------------------------------------------------

    def add(self, doc_id: int, vector: np.ndarray) -> None:
        self.add_batch([doc_id], np.asarray(vector)[None, :])

    def add_batch(self, doc_ids, vectors: np.ndarray) -> None:
        """Insert or update a batch; re-adding an existing id overwrites
        its vector in place."""
        doc_ids = np.asarray(doc_ids, dtype=np.int64)
        vectors = np.asarray(vectors, dtype=np.float32)
        if len(doc_ids) != len(vectors):
            raise ValueError(f"{len(doc_ids)} ids != {len(vectors)} vectors")
        # dedupe within the batch, last occurrence wins
        if len(doc_ids) != len(set(doc_ids.tolist())):
            last = {int(i): idx for idx, i in enumerate(doc_ids.tolist())}
            keep = sorted(last.values())
            doc_ids, vectors = doc_ids[keep], vectors[keep]
        with self._lock:
            existing = np.array([i in self._id_to_slot for i in doc_ids.tolist()],
                                dtype=bool)
            if existing.any():
                upd_slots = np.array(
                    [self._id_to_slot[int(i)] for i in doc_ids[existing]],
                    dtype=np.int64)
                self.store.set_at(upd_slots, vectors[existing])
            fresh = ~existing
            if fresh.any():
                slots = self.store.add(vectors[fresh])
                self._ensure_slot_map()
                for i, s in zip(doc_ids[fresh].tolist(), slots.tolist()):
                    self._id_to_slot[int(i)] = int(s)
                    self._slot_to_id[int(s)] = int(i)

    def _ensure_slot_map(self):
        """Grow the slot->id reverse map with store capacity. Caller
        holds ``_lock``."""
        if len(self._slot_to_id) < self.store.capacity:
            grown = np.full(self.store.capacity, -1, dtype=np.int64)
            grown[: len(self._slot_to_id)] = self._slot_to_id
            self._slot_to_id = grown

    def delete(self, *doc_ids) -> None:
        """Tombstone docs."""
        with self._lock:
            slots = [self._id_to_slot.pop(int(i)) for i in doc_ids
                     if int(i) in self._id_to_slot]
            if slots:
                self._slot_to_id[slots] = -1
                self.store.delete(np.asarray(slots))

    def contains(self, doc_id: int) -> bool:
        return int(doc_id) in self._id_to_slot

    def __len__(self) -> int:
        return len(self._id_to_slot)

    @property
    def compressed(self) -> bool:
        """Reference Compressed() (vector_index.go:37)."""
        return isinstance(self.store, QuantizedVectorStore)

    def search_by_vector(self, query: np.ndarray, k: int,
                         allow_list: np.ndarray | None = None):
        """Top-k by vector. ``allow_list``: bool mask over doc-id space or
        array of allowed doc ids. Returns (doc_ids [<=k] int64,
        dists [<=k] f32), ascending."""
        # the index lock spans search + id resolution so a concurrent
        # compact() can't remap slots between the scan and _resolve
        with tracing.span("flat.search", k=k,
                          filtered=allow_list is not None):
            with self._lock:
                allow_mask = self._allow_mask(allow_list)
                d, slots = self.store.search(np.asarray(query), k, allow_mask)
                return self._resolve(d, slots, k)

    def search_by_vector_batch(self, queries: np.ndarray, k: int,
                               allow_list=None):
        """Batched query path. ``allow_list`` is ONE allow list shared by
        the batch, or a list/tuple of B per-query allow lists (None =
        unfiltered) run as one bitmask-batched device program. Returns
        (doc_ids [B,k] int64 with -1 padding, dists [B,k])."""
        queries = np.atleast_2d(np.asarray(queries))
        per_query = _per_query_allow(allow_list)
        with tracing.span("flat.search_batch", k=k, queries=len(queries),
                          filtered=allow_list is not None,
                          per_query_filters=per_query):
            with self._lock:
                allow_mask = self._translate_batch_allow(
                    queries, allow_list, per_query)
                d, slots = self.store.search(queries, k, allow_mask)
                ids = np.where(slots >= 0, self._slot_to_id_safe(slots), -1)
                return ids, d

    def _translate_batch_allow(self, queries, allow_list, per_query: bool):
        """Allow-list intake shared by the sync and async batch paths.
        Caller holds ``_lock``. Returns the mask (or None)."""
        if not per_query:
            return self._allow_mask(allow_list)
        if len(allow_list) != len(queries):
            raise ValueError(
                f"{len(allow_list)} allow lists != "
                f"{len(queries)} queries")
        masks = [self._allow_mask(a) for a in allow_list]
        if all(m is None for m in masks):
            return None
        # unfiltered rows get an all-ones mask (the store still ANDs with
        # its live-slot validity)
        allow_mask = np.ones((len(masks), self.store.capacity), dtype=bool)
        for r, m in enumerate(masks):
            if m is not None:
                allow_mask[r, :] = False
                allow_mask[r, :len(m)] = m
        return allow_mask

    def search_by_vector_batch_async(self, queries: np.ndarray, k: int,
                                     allow_list=None):
        """Async twin of ``search_by_vector_batch``: dispatch under the
        index lock, results on the device in the returned handle
        (resolving to the same (doc_ids [B,k], dists [B,k])). The slot ->
        doc-id resolution runs against the ``_slot_to_id`` table captured
        AT DISPATCH (``compact()`` replaces it wholesale)."""
        queries = np.atleast_2d(np.asarray(queries))
        per_query = _per_query_allow(allow_list)
        with tracing.span("flat.search_batch", k=k, queries=len(queries),
                          filtered=allow_list is not None,
                          per_query_filters=per_query, dispatch="async"):
            with self._lock:
                allow_mask = self._translate_batch_allow(
                    queries, allow_list, per_query)
                handle = self.store.search_async(queries, k, allow_mask)
                table = self._slot_to_id

        def _resolve(res, _table=table):
            d, slots = res
            clipped = np.clip(slots, 0, len(_table) - 1)
            ids = np.where(slots >= 0, _table[clipped], -1)
            return ids, d

        return handle.map(_resolve)

    def compress(self, quantization: str = "pq", **quant_kwargs) -> None:
        """Runtime compression: train a quantizer on the current contents
        and swap the store (reference hnsw/compress.go:38, switched on by a
        config update once enough data exists). The slot layout is kept,
        so the id<->slot tables carry over untouched."""
        with self._lock:
            old = self.store
            if isinstance(old, QuantizedVectorStore):
                raise RuntimeError("index is already compressed")
            snap = old.snapshot()
            # the new store inherits the old one's memory-ledger owner
            # (compress runs outside the shard's owner scope); the old
            # store's entries go with it when the swap drops it
            own = old._hbm_owner or hbm_ledger.current_owner()
            with hbm_ledger.owner(**own):
                new = QuantizedVectorStore(
                    dim=self.dim, metric=self.metric, quantization=quantization,
                    capacity=old.capacity, chunk_size=old.chunk_size,
                    device=old.device, **quant_kwargs)
            live = np.nonzero(snap["valid"])[0]
            live_vecs = snap["vectors"][live]
            if quantization == "pq" and new.codebook is None:
                if len(live) < new.pq_centroids:
                    raise RuntimeError(
                        f"need >= {new.pq_centroids} live vectors to train PQ, "
                        f"have {len(live)}")
                new.train(live_vecs)
            if len(live):
                # vectors were already normalized at original insert
                new.set_at_prenormalized(live, live_vecs)
            new._count = snap["count"]
            self.store = new

    def hybrid_batch_async(self, *_args, **_kwargs):
        raise NotImplementedError("device hybrid search: ROADMAP Queue 1 item 10")

    # -- helpers --------------------------------------------------------------

    def _allow_mask(self, allow_list):
        """Doc-id allow list -> slot mask over the store. A bool mask over
        doc-id space is gathered through the slot table; an array of doc
        ids takes ``np.isin`` on it (the JAX package runs that membership
        test in its native library for both forms — same mask)."""
        if allow_list is None:
            return None
        allow_list = np.asarray(allow_list)
        with self._lock:
            table = self._slot_to_id[: self.store.capacity]
            if allow_list.dtype == np.bool_:
                hit = (table >= 0) & (table < len(allow_list))
                out = np.zeros(len(table), dtype=bool)
                out[hit] = allow_list[table[hit]]
                return out
            return (table >= 0) & np.isin(table, np.unique(allow_list).astype(np.int64))

    def _slot_to_id_safe(self, slots):
        clipped = np.clip(slots, 0, len(self._slot_to_id) - 1)
        return self._slot_to_id[clipped]

    def _resolve(self, d, slots, k):
        live = slots >= 0
        ids = self._slot_to_id_safe(slots)[live]
        return ids[:k], d[live][:k]

    # -- maintenance / persistence -------------------------------------------

    def compact(self):
        """Reclaim tombstoned rows; remaps id->slot tables."""
        with self._lock:
            mapping = self.store.compact()
            new_slot_to_id = np.full(self.store.capacity, -1, dtype=np.int64)
            for doc_id, slot in list(self._id_to_slot.items()):
                ns = int(mapping[slot])
                self._id_to_slot[doc_id] = ns
                new_slot_to_id[ns] = doc_id
            self._slot_to_id = new_slot_to_id

    def snapshot(self) -> dict:
        with self._lock:
            snap = self.store.snapshot()
            snap["slot_to_id"] = self._slot_to_id.copy()
            snap["index_type"] = self.index_type
            return snap

    @classmethod
    def restore(cls, snap: dict, mesh=None, **kwargs) -> "FlatIndex":
        if snap.get("epoch_rows"):
            raise NotImplementedError("epoch stores: ROADMAP Queue 1 item 7")
        idx = cls.__new__(cls)
        idx.dim = snap["dim"]
        idx.metric = snap["metric"]
        if snap.get("quantization"):
            idx.store = QuantizedVectorStore.restore(snap, mesh=mesh, **kwargs)
        else:
            idx.store = DeviceVectorStore.restore(snap, mesh=mesh, **kwargs)
        idx._lock = threading.RLock()
        slot_to_id = snap["slot_to_id"]
        size = max(idx.store.capacity, len(slot_to_id))
        idx._slot_to_id = np.full(size, -1, dtype=np.int64)
        idx._slot_to_id[: len(slot_to_id)] = slot_to_id
        idx._id_to_slot = {
            int(doc): int(slot)
            for slot, doc in enumerate(slot_to_id)
            if doc >= 0 and snap["valid"][slot]
        }
        return idx
