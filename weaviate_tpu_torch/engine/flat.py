"""Flat (brute-force) vector index (port of ``weaviate_tpu/engine/flat.py``,
plain or BQ/PQ-quantized, one buffer or a stack of epochs, on one device
or row-sharded over a ``mesh``).

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

from weaviate_tpu_torch import native
from weaviate_tpu_torch.engine.epochs import EpochStore
from weaviate_tpu_torch.engine.quantized import QuantizedVectorStore
from weaviate_tpu_torch.engine.store import DeviceVectorStore
from weaviate_tpu_torch.runtime import hbm_ledger, kernelscope, tracing
from weaviate_tpu_torch.runtime.transfer import DeviceResultHandle


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
        self.dim = dim
        self.metric = metric
        if epoch_rows:
            # epoch-stacked device corpus (engine/epochs.py): writes land
            # in a small active epoch, sealed epochs are immutable,
            # tombstone-heavy ones compact in the background and the
            # coldest can migrate to a sibling shard under memory pressure
            self.store = EpochStore(
                dim=dim, metric=metric, epoch_rows=epoch_rows,
                capacity=capacity, dtype=dtype, mesh=mesh,
                chunk_size=chunk_size, selection=selection,
                quantization=quantization,
                quant_kwargs=quant_kwargs or None, device=device)
        elif quantization:
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
        if isinstance(self.store, EpochStore):
            return bool(self.store.quantization)
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
                kernelscope.explain_note(
                    "index", kind=str(self.index_type),
                    per_query_filters=bool(per_query),
                    filtered=allow_list is not None,
                    queries=len(queries), k=k)
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
                # EXPLAIN: index-level plan facts (host ints only; the
                # store layer notes the cutover it actually takes)
                kernelscope.explain_note(
                    "index", kind=str(self.index_type),
                    per_query_filters=bool(per_query),
                    filtered=allow_mask is not None,
                    queries=len(queries), k=k)
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
            if isinstance(old, EpochStore):
                if old.quantization:
                    raise RuntimeError("index is already compressed")
                return self._compress_epochs(old, quantization, **quant_kwargs)
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
                    device=old.device, mesh=old.mesh, **quant_kwargs)
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

    def _compress_epochs(self, old: EpochStore, quantization: str,
                         **quant_kwargs) -> None:
        """Compression that keeps the epochs: the quantized twin keeps the
        SAME global slot layout (epochs re-split by ``epoch_rows``), so the
        id <-> slot tables carry over untouched. Caller holds ``_lock``."""
        snap = old.snapshot()
        own = old._owner or hbm_ledger.current_owner()
        with hbm_ledger.owner(**own):
            new = EpochStore(
                dim=self.dim, metric=self.metric,
                epoch_rows=old.epoch_rows, chunk_size=old.chunk_size,
                selection=old.selection, quantization=quantization,
                quant_kwargs=quant_kwargs, device=old.device, mesh=old.mesh)
        live = np.nonzero(snap["valid"])[0]
        live_vecs = snap["vectors"][live]
        if quantization == "pq":
            centroids = new._quant_kwargs.get("pq_centroids", 16)
            if len(live) < centroids:
                raise RuntimeError(
                    f"need >= {centroids} live vectors to train PQ, "
                    f"have {len(live)}")
        new._restore_rows(live, snap["vectors"], int(snap["count"]))
        if quantization == "pq":
            new.train(live_vecs)
        self.store = new

    # -- epoch hooks (engine/epochs.py; db/collection.py migration) -----------

    @property
    def epoch_store(self) -> EpochStore | None:
        """The backing ``EpochStore`` when this index is epoch-backed, else
        None (the maintenance policy keys on this)."""
        return self.store if isinstance(self.store, EpochStore) else None

    def epoch_doc_ids(self, eid: int) -> np.ndarray:
        """Doc ids of one epoch's live rows: the unit the migration policy
        moves to a sibling shard."""
        es = self.epoch_store
        if es is None:
            return np.empty(0, np.int64)
        with self._lock:
            gslots = es.live_globals_of(eid)
            gslots = gslots[gslots < len(self._slot_to_id)]
            ids = self._slot_to_id[gslots]
            return ids[ids >= 0]

    # -- hybrid dataplane ------------------------------------------------------

    @property
    def supports_device_hybrid(self) -> bool:
        """True when this index can run the fused sparse+dense hybrid
        program: the plain device store only — the quantized and epoch
        stores keep the host hybrid path (their handles don't expose raw
        (dist, slot) arrays in store-slot space)."""
        return type(self.store) is DeviceVectorStore

    def slots_for_doc_ids(self, doc_ids) -> np.ndarray:
        """Store slots for external doc ids (-1 = not in this index) —
        the shard layer translates BM25 candidates with this before
        packing sparse operands."""
        with self._lock:
            return np.asarray(
                [self._id_to_slot.get(int(d), -1) for d in doc_ids],
                dtype=np.int32)

    def hybrid_batch_async(self, queries: np.ndarray, k: int,
                           allow_list=None, sparse_ops=None):
        """One fused device program for a mixed hybrid + pure-vector
        drain: the dense scan dispatches async, its DEVICE-RESIDENT
        (dist, slot) tensors feed straight into the BM25 scoring + fusion
        program (``ops/bm25.py::hybrid_topk``) — one dispatch chain, one
        device->host copy through the returned handle. ``sparse_ops`` is
        a per-row list of ``SparseOperand`` (None = pure-vector row
        riding the same batch); ``ops/bm25.hybrid_program`` runs the
        program (a CUDA graph per batch size on the card). Returns
        None when the device hybrid path can't take the request
        (unsupported store) — callers fall back to the host hybrid path.

        A filter always takes the store's bitmask path, even a shared one
        or a batch of one: the gathered path's finish step remaps slots
        on the HOST, which would break the on-device fusion."""
        from weaviate_tpu_torch.ops.bm25 import (GRAPH_SHAPE, hybrid_program,
                                                 stack_dispatch_operands)

        if not self.supports_device_hybrid:
            return None
        queries = np.atleast_2d(np.asarray(queries))
        sparse_ops = list(sparse_ops or [None] * len(queries))
        live_ops = [op for op in sparse_ops if op is not None]
        per_query = _per_query_allow(allow_list)
        # dense leg depth: every row's over-fetch must fit so fusion
        # ranks match the host reference; pow2 so shapes bucket
        fetch = max([k] + [int(op.fetch) for op in live_ops])
        f_depth = 1 << max(0, fetch - 1).bit_length()
        with tracing.span("flat.hybrid_batch", k=k, queries=len(queries),
                          hybrid=len(live_ops), dispatch="async"):
            with self._lock:
                allow_mask = self._translate_batch_allow(
                    queries, allow_list, per_query)
                if allow_mask is not None and allow_mask.ndim == 1:
                    shared = np.zeros(self.store.capacity, dtype=bool)
                    shared[:len(allow_mask)] = allow_mask
                    allow_mask = np.broadcast_to(
                        shared, (len(queries), self.store.capacity))
                kernelscope.explain_note(
                    "hybrid", queries=len(queries),
                    hybrid_rows=len(live_ops), k=k, fetch=fetch,
                    terms=int(sum(op.stats.get("terms", 0)
                                  for op in live_ops)),
                    candidates=int(sum(op.stats.get("candidates", 0)
                                       for op in live_ops)),
                    pruned_frac=round(float(np.mean(
                        [op.stats.get("pruned_frac", 0.0)
                         for op in live_ops])), 6) if live_ops else 0.0,
                    fusion_ranked=int(sum(1 for op in live_ops
                                          if op.fusion == 0)),
                    fusion_relative=int(sum(1 for op in live_ops
                                            if op.fusion == 1)))
                handle = self.store.search_async(queries, f_depth,
                                                 allow_mask, keep_rows=True)
                dn_d, dn_i = handle.arrays
                # one page-locked buffer, sent with one non-blocking copy
                # (no wait on the dense scan just dispatched), then the
                # program's CUDA graph
                pack = stack_dispatch_operands(
                    sparse_ops, len(queries),
                    shape=GRAPH_SHAPE if dn_d.is_cuda else None, pin=dn_d.is_cuda)
                d, i = hybrid_program(dn_d, dn_i, pack, k)
                table = self._slot_to_id  # replaced wholesale by compact

        def _resolve(d_np, i_np, _table=table):
            clipped = np.clip(i_np, 0, len(_table) - 1)
            ids = np.where(i_np >= 0, _table[clipped], -1)
            return ids, d_np

        return DeviceResultHandle(
            (d, i), finish=_resolve,
            attrs=dict(handle.attrs, hybrid=len(live_ops), k=k))

    def hybrid_batch(self, queries: np.ndarray, k: int, allow_list=None,
                     sparse_ops=None):
        """Sync twin of ``hybrid_batch_async`` (same fused program, the
        copy to the host just happens inline). Returns None on the same
        conditions."""
        h = self.hybrid_batch_async(queries, k, allow_list, sparse_ops)
        return None if h is None else h.result()

    def search_by_vector_distance(self, query: np.ndarray, max_distance: float,
                                  allow_list: np.ndarray | None = None):
        """Range search (reference SearchByVectorDistance,
        vector_index.go:31): (doc_ids, dists) of every live row within
        ``max_distance``, ascending."""
        with self._lock:
            allow_mask = self._allow_mask(allow_list)
            d, slots = self.store.search_by_distance(np.asarray(query), max_distance,
                                                     allow_mask)
            return self._resolve(d, slots, len(slots))

    # -- helpers --------------------------------------------------------------

    def _allow_mask(self, allow_list):
        """Doc-id allow list -> slot mask over the store. A bool mask over
        doc-id space is gathered through the slot table; an array of doc
        ids takes a binary-search membership test over the slot table in
        the native library (csrc/host/weaviate_native.cpp; numpy without
        it). The JAX package turns the bool form into doc ids and tests
        membership too: the same mask."""
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
            ids = np.unique(allow_list.astype(np.int64))
            # negative ids match no slot; dropping them keeps the rest
            # ascending as the unsigned ids the membership test searches
            return native.membership(table, ids[ids >= 0])

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
        idx = cls.__new__(cls)
        idx.dim = snap["dim"]
        idx.metric = snap["metric"]
        if snap.get("epoch_rows"):
            idx.store = EpochStore.restore(snap, mesh=mesh, **kwargs)
        elif snap.get("quantization"):
            idx.store = QuantizedVectorStore.restore(snap, mesh=mesh, **kwargs)
        else:
            idx.store = DeviceVectorStore.restore(snap, mesh=mesh, **kwargs)
        idx._lock = threading.RLock()
        slot_to_id = snap["slot_to_id"]
        # an epoch store sealed early keeps an active epoch's unused range,
        # so the table can be wider than the re-split store's capacity:
        # size to the larger so no entry is dropped
        size = max(idx.store.capacity, len(slot_to_id))
        idx._slot_to_id = np.full(size, -1, dtype=np.int64)
        idx._slot_to_id[: len(slot_to_id)] = slot_to_id
        idx._id_to_slot = {
            int(doc): int(slot)
            for slot, doc in enumerate(slot_to_id)
            if doc >= 0 and snap["valid"][slot]
        }
        return idx
