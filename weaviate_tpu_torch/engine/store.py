"""Device-resident vector store (port of ``weaviate_tpu/engine/store.py``).

The authoritative hot copy lives on the card as capacity-padded tensors:

- ``vectors``  [C, d]  storage dtype f32 (exact) or bf16 (2x capacity)
- ``valid``    [C]     live-slot mask (False = unfilled or tombstoned)
- ``sq_norms`` [C]     cached squared row norms (corpus term of the l2 expansion)

Mutability: where the JAX package donates buffers to a jitted scatter so
XLA updates them in place, this store writes the same tensors in place
with ``index_copy_`` / ``index_fill_`` — no copy, no realloc per insert.
Deletes flip ``valid`` bits (tombstones); the mask is applied inside the
scan so dead slots never win. Capacity grows by power-of-two
re-allocation. One device only: the mesh (row-sharded) form of the JAX
store is ROADMAP Queue 1 item 13.
"""

from __future__ import annotations

import os
import threading
import weakref

import numpy as np
import torch

from weaviate_tpu_torch.device import resolve
from weaviate_tpu_torch.ops.candidates import shared_candidates_topk
from weaviate_tpu_torch.ops.distances import normalize
from weaviate_tpu_torch.ops.kernels import (KERNEL_METRICS, as_bits_tensor,
                                            mask_pad_cols, pack_allow_bitmask)
from weaviate_tpu_torch.ops.topk import chunked_topk_distances
from weaviate_tpu_torch.runtime import hbm_ledger, tracing, transfer
from weaviate_tpu_torch.runtime.transfer import DeviceResultHandle

_DEFAULT_CHUNK = 8192
_MULTI_DEVICE = "multi-device: ROADMAP Queue 1 item 13"


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def storage_dtype(dtype) -> torch.dtype:
    """float32 / bfloat16 from a torch dtype or its name (the JAX
    package's snapshots name it as a string)."""
    if dtype is None:
        return torch.float32
    if isinstance(dtype, torch.dtype):
        out = dtype
    else:
        out = {"float32": torch.float32, "bfloat16": torch.bfloat16}.get(
            str(dtype))
    if out not in (torch.float32, torch.bfloat16):
        raise ValueError(f"storage dtype {dtype!r}: expected float32 or bfloat16")
    return out


def normalize_allow_mask(allow_mask, n_queries: int, keep_rows: bool = False):
    """Allow-mask intake: [1, C] broadcasts to the shared [C] form
    (keeping the gathered low-selectivity cutover) unless ``keep_rows``;
    a [B, C] mask must match the query count."""
    if allow_mask is None:
        return None
    allow_mask = np.asarray(allow_mask)
    if allow_mask.ndim == 2 and allow_mask.shape[0] == 1 and not keep_rows:
        allow_mask = allow_mask[0]
    elif allow_mask.ndim == 2 and allow_mask.shape[0] != n_queries:
        raise ValueError(
            f"allow_mask rows {allow_mask.shape[0]} != "
            f"queries {n_queries}")
    return allow_mask


def batched_mask_operands(allow_mask, n_queries: int, capacity: int, device,
                          owner: dict | None = None):
    """[B, capacity] per-query mask -> packed allow words on the device
    (32x smaller transfer than the bool mask), under a
    ``store.mask_pack`` span. ``owner`` labels the transient device
    buffer in the memory ledger (tracked for the buffer's lifetime)."""
    with tracing.span("store.mask_pack", queries=n_queries):
        bits = as_bits_tensor(
            pack_allow_bitmask(allow_mask, mask_pad_cols(capacity)), device)
        hbm_ledger.ledger.track("allow_bitmask", bits, **(owner or {}))
        return bits


def _probe_scatter(valid: torch.Tensor, slot: int) -> None:
    """Force one element of a freshly scattered valid mask to the host.

    Kernel launches are asynchronous: the scatter returning only means it
    was enqueued. This tiny read surfaces an asynchronous failure at the
    flush site, while the staged rows are still held and re-flushable.
    Module-level so tests can inject failures."""
    bool(valid[slot].item())


class DeviceVectorStore:
    """Mutable (host-managed, device-resident) vector store.

    Thread-safe for interleaved add/delete/search: one host lock guards
    writes and the scan dispatch."""

    def __init__(
        self,
        dim: int,
        metric: str = "l2-squared",
        capacity: int = _DEFAULT_CHUNK,
        dtype=torch.float32,
        mesh=None,
        chunk_size: int = _DEFAULT_CHUNK,
        normalize_on_add: bool | None = None,
        selection: str = "approx",
        component: str = "corpus",
        device=None,
    ):
        if mesh is not None:
            raise NotImplementedError(_MULTI_DEVICE)
        self.device = resolve(device)
        self.dim = dim
        self.hbm_component = component
        self.metric = metric
        self.dtype = storage_dtype(dtype)
        self.mesh = None
        self.chunk_size = chunk_size
        # "approx" and "exact" run the exact per-chunk selection
        # (ops/topk.py); "fused" folds it into the fused_topk_scan kernel
        self.selection = selection
        self.n_shards = 1
        # cosine stores normalized rows (the reference's "cosine-dot")
        self.normalize_on_add = (
            metric in ("cosine", "cosine-dot")
            if normalize_on_add is None
            else normalize_on_add
        )
        self._lock = threading.RLock()
        # the per-chunk distance_block kernel on the card; the plain torch
        # scan on the CPU (the CUDA kernels run only on a card)
        self.use_pallas = self.device.type == "cuda" and metric in KERNEL_METRICS
        self._count = 0  # high-water mark of allocated slots
        # Host-side append staging: small add() batches land in numpy and
        # reach the device in large scatters. Every read path flushes
        # first, so visibility is unchanged.
        self._staged_slots: list[np.ndarray] = []
        self._staged_vecs: list[np.ndarray] = []
        self._staged_rows = 0
        self._stage_limit = max(4096, (32 << 20) // (dim * 4))
        # device-memory ledger: owner labels captured once from the
        # shard's scope; a finalizer releases the entries with the store
        self._hbm_owner = hbm_ledger.current_owner()
        self._hbm_keys: dict[str, int] = {}
        weakref.finalize(self, hbm_ledger.ledger.release_many,
                         self._hbm_keys.values())
        capacity = self._align(capacity)
        self.capacity = capacity
        # host mirror of the live-slot mask + O(1) live counter, both
        # maintained under ``_lock``; the serving path never syncs on a
        # device sum for a count
        self._valid_np = np.zeros(capacity, dtype=bool)
        self._live_count = 0
        self._alloc(capacity)

    # -- capacity management -------------------------------------------------

    def _align(self, capacity: int) -> int:
        capacity = _next_pow2(max(capacity, 2))
        cs = min(self.chunk_size, capacity)
        return -(-capacity // cs) * cs

    def _alloc(self, capacity: int):
        dev = self.device
        self.vectors = torch.zeros((capacity, self.dim), dtype=self.dtype, device=dev)
        self.valid = torch.zeros((capacity,), dtype=torch.bool, device=dev)
        self.sq_norms = torch.zeros((capacity,), dtype=torch.float32, device=dev)
        self._hbm_sync()

    def _hbm_sync(self):
        """(Re-)publish this store's device footprint into the ledger."""
        nbytes = sum(int(a.nbytes)
                     for a in (self.vectors, self.valid, self.sq_norms))
        hbm_ledger.ledger.set_keyed(
            self._hbm_keys, self.hbm_component, nbytes,
            owner=self._hbm_owner, dtype=str(self.dtype).replace("torch.", ""),
            sharding="single")

    def _grow(self, min_capacity: int):
        """Capacity-double the device tensors + host valid mirror.
        Caller holds ``_lock``."""
        new_cap = self._align(_next_pow2(min_capacity))
        pad = new_cap - self.capacity
        self.capacity = new_cap
        grown = np.zeros(new_cap, dtype=bool)
        grown[: len(self._valid_np)] = self._valid_np
        self._valid_np = grown

        def padded(a):
            return torch.cat([a, torch.zeros((pad,) + tuple(a.shape[1:]),
                                             dtype=a.dtype, device=a.device)])

        self.vectors = padded(self.vectors)
        self.valid = padded(self.valid)
        self.sq_norms = padded(self.sq_norms)
        self._hbm_sync()

    # -- mutation ------------------------------------------------------------

    def add(self, vectors: np.ndarray) -> np.ndarray:
        """Append a batch [m,d]; returns assigned slot ids [m] (int64),
        sequential from the high-water mark."""
        vectors = np.asarray(vectors, dtype=np.float32)
        if vectors.ndim == 1:
            vectors = vectors[None, :]
        m, d = vectors.shape
        if d != self.dim:
            raise ValueError(f"vector dim {d} != store dim {self.dim}")
        with self._lock:
            slots = np.arange(self._count, self._count + m, dtype=np.int64)
            if self._count + m > self.capacity:
                self._grow(self._count + m)
            self._count += m
            self._valid_np[slots] = True
            self._live_count += m
            # copy: the caller may reuse its buffer before the flush
            self._staged_slots.append(slots.astype(np.int32))
            self._staged_vecs.append(vectors.copy())
            self._staged_rows += m
            if self._staged_rows >= self._stage_limit:
                self._flush_staged_locked()
            return slots

    def flush_staged(self) -> None:
        """Push any host-staged rows to the device (one scatter)."""
        with self._lock:
            self._flush_staged_locked()

    def _scatter_rows(self, slots: np.ndarray, vecs: np.ndarray) -> None:
        """Write rows ``vecs`` [m, d] at ``slots`` [m] in place (the JAX
        store's donated ``_scatter_rows``): normalized first for cosine,
        stored in the storage dtype, norms from the stored rows."""
        idx = torch.from_numpy(np.asarray(slots, dtype=np.int64)).to(self.device)
        new = torch.from_numpy(np.ascontiguousarray(vecs, dtype=np.float32)).to(self.device)
        if self.normalize_on_add:
            new = normalize(new)
        new = new.to(self.dtype)
        self.vectors.index_copy_(0, idx, new)
        self.valid.index_fill_(0, idx, True)
        self.sq_norms.index_copy_(0, idx, (new.float() ** 2).sum(dim=-1))

    def _flush_staged_locked(self) -> None:
        """Scatter the staged rows to the device. Caller holds ``_lock``."""
        m = self._staged_rows
        if m == 0:
            return
        vectors = (self._staged_vecs[0] if len(self._staged_vecs) == 1
                   else np.concatenate(self._staged_vecs))
        slots = (self._staged_slots[0] if len(self._staged_slots) == 1
                 else np.concatenate(self._staged_slots))
        # the host->device copy is a real transient allocation: ledger-
        # tracked for the flush so peak watermarks see import bursts
        stage_key = hbm_ledger.ledger.register(
            "staging", vectors.nbytes + slots.nbytes, dtype="float32",
            sharding="single", **self._hbm_owner)
        try:
            self._scatter_rows(slots, vectors)
            # drop the staging buffers only once the scatter ran — a
            # failure surfaces here while the rows are still re-flushable
            _probe_scatter(self.valid, int(slots[m - 1]))
        finally:
            hbm_ledger.ledger.release(stage_key)
        self._staged_vecs.clear()
        self._staged_slots.clear()
        self._staged_rows = 0

    def set_at(self, slots: np.ndarray, vectors: np.ndarray):
        """Overwrite specific slots (update path)."""
        vectors = np.asarray(vectors, dtype=np.float32)
        slots = np.asarray(slots, dtype=np.int64)
        m = len(slots)
        with self._lock:
            self._flush_staged_locked()
            if m and int(slots.max()) >= self.capacity:
                self._grow(int(slots.max()) + 1)
            self._count = max(self._count, int(slots.max()) + 1 if m else 0)
            if m:
                u = np.unique(slots)
                self._live_count += int(np.count_nonzero(~self._valid_np[u]))
                self._valid_np[u] = True
                self._scatter_rows(slots, vectors)

    def delete(self, slots) -> None:
        """Tombstone slots; they stay allocated until compaction. Rows
        still host-staged are scrubbed from the staging buffer so they
        never reach the device."""
        slots = np.atleast_1d(np.asarray(slots, dtype=np.int64))
        if len(slots) == 0:
            return
        with self._lock:
            in_range = np.unique(slots[(slots >= 0) & (slots < self.capacity)])
            self._live_count -= int(np.count_nonzero(self._valid_np[in_range]))
            self._valid_np[in_range] = False
            if self._staged_rows:
                self._scrub_staged_locked(in_range)
            if len(in_range):
                self.valid.index_fill_(
                    0, torch.from_numpy(in_range).to(self.device), False)

    def _scrub_staged_locked(self, dead: np.ndarray) -> None:
        """Drop staged rows whose slots are in ``dead``. Caller holds
        ``_lock``."""
        kept_slots: list[np.ndarray] = []
        kept_vecs: list[np.ndarray] = []
        rows = 0
        for sl, vec in zip(self._staged_slots, self._staged_vecs):
            keep = ~np.isin(sl, dead)
            if keep.all():
                kept_slots.append(sl)
                kept_vecs.append(vec)
                rows += len(sl)
            elif keep.any():
                kept_slots.append(sl[keep])
                kept_vecs.append(vec[keep])
                rows += int(keep.sum())
        self._staged_slots = kept_slots
        self._staged_vecs = kept_vecs
        self._staged_rows = rows

    # -- queries -------------------------------------------------------------

    @property
    def count(self) -> int:
        """Allocated slots (including tombstones)."""
        return self._count

    def live_count(self) -> int:
        """Live slots — an O(1) host counter. ``WEAVIATE_TPU_DEBUG_COUNTS=1``
        cross-checks it against the device mask on every call."""
        with self._lock:
            if os.environ.get("WEAVIATE_TPU_DEBUG_COUNTS", "").lower() \
                    in ("1", "true", "on"):
                self._flush_staged_locked()
                dev = int(self.valid.sum().item())
                if dev != self._live_count:
                    raise AssertionError(
                        f"live-count drift: device says {dev}, host counter "
                        f"says {self._live_count}")
            return self._live_count

    def search(self, queries: np.ndarray, k: int, allow_mask: np.ndarray | None = None):
        """Brute-force top-k. queries [B,d] (or [d]); returns (dists [B,k],
        slots [B,k]) as numpy, ascending by distance.

        ``allow_mask`` is either [capacity] (or [count]) bool — one filter
        shared by the batch; highly selective masks cut over to the
        gathered path — or [B, capacity] bool, per-query filters packed
        into a bitmask the scan reads. This is
        ``search_async(...).result()``."""
        return self.search_async(queries, k, allow_mask).result()

    def _scan_metric(self) -> str:
        # cosine runs as "cosine" against rows normalized at insert
        return "cosine" if self.metric in ("cosine", "cosine-dot") else self.metric

    def search_async(self, queries: np.ndarray, k: int,
                     allow_mask: np.ndarray | None = None,
                     keep_rows: bool = False) -> DeviceResultHandle:
        """Dispatch-only twin of ``search``: the scan launches under
        ``_lock`` and the results STAY on the device in the returned
        handle; ``.result()`` performs the one device->host copy.
        ``keep_rows`` keeps a [1, C] mask per-query (the bitmask path),
        so the handle's device arrays hold store slots for any batch."""
        queries = np.asarray(queries, dtype=np.float32)
        squeeze = queries.ndim == 1
        if squeeze:
            queries = queries[None, :]
        allow_mask = normalize_allow_mask(allow_mask, len(queries), keep_rows)
        with tracing.span("store.scan", rows=self.capacity,
                          queries=len(queries), k=k, sharded=False,
                          filtered=allow_mask is not None) as sp:
            # Dispatch under the lock: a concurrent grow()/compact()
            # replaces the tensors. Execution is asynchronous, so the lock
            # covers only the launch.
            with self._lock:
                self._flush_staged_locked()
                vectors, valid, norms = (self.vectors, self.valid,
                                         self.sq_norms)
                capacity = self.capacity
                allow_bits = None
                slot_buf = None
                if allow_mask is not None and allow_mask.ndim == 2:
                    sp.set(path="bitmask_batched")
                    allow_bits = batched_mask_operands(
                        allow_mask, len(queries), capacity, self.device,
                        owner=self._hbm_owner)
                elif allow_mask is not None:
                    allowed = np.flatnonzero(allow_mask)
                    # selectivity policy: a dense gather of the allowed
                    # rows beats the full masked scan below capacity/8,
                    # within a 1 GB gather budget on the padded bucket
                    m_allowed = len(allowed)
                    bucket = 1 << max(7, (m_allowed - 1).bit_length()) \
                        if m_allowed else 0
                    row_bytes = self.dim * self.vectors.element_size()
                    if (m_allowed > 0 and m_allowed <= capacity // 8
                            and bucket * row_bytes <= (1 << 30)):
                        sp.set(path="gathered", allowed=m_allowed)
                        d, i, slot_buf = self._dispatch_gathered(
                            queries, k, allowed)
                    else:
                        full = np.zeros(capacity, dtype=bool)
                        full[: len(allow_mask)] = allow_mask
                        valid = valid & torch.from_numpy(full).to(self.device)
                if slot_buf is None:
                    d, i = chunked_topk_distances(
                        torch.from_numpy(queries).to(self.device), vectors,
                        k=min(k, capacity),
                        chunk_size=min(self.chunk_size, capacity),
                        metric=self._scan_metric(), valid=valid,
                        x_sq_norms=norms, use_pallas=self.use_pallas,
                        selection=self.selection, allow_bits=allow_bits,
                    )

        def _finish(d_np, i_np, _slot_buf=slot_buf, _k=k,
                    _squeeze=squeeze):
            if _slot_buf is not None:
                d_np, i_np = DeviceVectorStore._finish_gathered(
                    d_np, i_np, _slot_buf, _k)
            if _squeeze:
                return d_np[0], i_np[0]
            return d_np, i_np

        return DeviceResultHandle(
            (d, i), finish=_finish,
            attrs={"rows": capacity, "queries": len(queries), "k": k,
                   "path": "gathered" if slot_buf is not None else "device"})

    def _dispatch_gathered(self, queries: np.ndarray, k: int,
                           allowed: np.ndarray):
        """Filtered search at low selectivity: gather the allowed rows
        into a dense pow2-padded buffer on the device and scan THAT.
        Called under ``_lock``; dispatch only. Returns (d, i, slot_buf)."""
        m = len(allowed)
        bucket = 1 << max(7, (m - 1).bit_length())
        slot_buf = np.full(bucket, -1, dtype=np.int32)
        slot_buf[:m] = allowed
        d, i = shared_candidates_topk(
            torch.from_numpy(queries).to(self.device),
            torch.from_numpy(slot_buf).to(self.device), self.vectors,
            min(k, bucket), self._scan_metric(), row_norms=self.sq_norms,
            valid=self.valid, use_pallas=self.use_pallas,
            selection=self.selection,
        )
        return d, i, slot_buf

    @staticmethod
    def _finish_gathered(d_np: np.ndarray, i_np: np.ndarray,
                         slot_buf: np.ndarray, k: int):
        """Host half of the gathered path: the scan already remapped
        bucket-local winners to global slots, so this only pads up to
        search()'s [B, k] contract."""
        if i_np.shape[1] < k:
            pad = k - i_np.shape[1]
            i_np = np.pad(i_np, ((0, 0), (0, pad)), constant_values=-1)
            d_np = np.pad(d_np, ((0, 0), (0, pad)),
                          constant_values=np.float32(np.inf))
        return d_np, i_np

    # -- maintenance ---------------------------------------------------------

    def compact(self) -> np.ndarray:
        """Defragment: drop tombstoned rows, repack live rows contiguously.
        Returns old_slot -> new_slot mapping (-1 for dropped)."""
        with tracing.span("store.compact", rows=self.capacity) as sp, \
                self._lock:
            self._flush_staged_locked()
            live = np.nonzero(self._valid_np)[0]
            mapping = np.full(self.capacity, -1, dtype=np.int64)
            mapping[live] = np.arange(len(live))
            sp.set(live=len(live))
            (vec_host,) = transfer.d2h(self.vectors.float())
            vec_np = vec_host[live]
            self._count = len(live)
            new_cap = self._align(max(len(live), 2))
            self.capacity = new_cap
            self._valid_np = np.zeros(new_cap, dtype=bool)
            self._live_count = 0  # set_at below re-marks the live rows
            self._alloc(new_cap)
            if len(live):
                self.set_at(np.arange(len(live)), vec_np)
            return mapping

    # -- persistence hooks ---------------------------------------------------

    def snapshot(self) -> dict:
        """Host-side snapshot, the same dict as the JAX store's."""
        with self._lock:
            self._flush_staged_locked()
            vec, valid = transfer.d2h(self.vectors.float(), self.valid)
            return {
                "vectors": vec,
                "valid": valid,
                "count": self._count,
                "dim": self.dim,
                "metric": self.metric,
                "dtype": str(self.dtype).replace("torch.", ""),
                "chunk_size": self.chunk_size,
            }

    @classmethod
    def restore(cls, snap: dict, **kwargs) -> "DeviceVectorStore":
        # storage config survives the round trip unless overridden
        kwargs.setdefault("dtype", snap.get("dtype", "float32"))
        kwargs.setdefault("chunk_size", snap.get("chunk_size", _DEFAULT_CHUNK))
        store = cls(dim=snap["dim"], metric=snap["metric"],
                    capacity=max(len(snap["valid"]), 2), **kwargs)
        live = np.nonzero(snap["valid"])[0]
        if len(live):
            # rows were normalized at their original insert
            orig = store.normalize_on_add
            store.normalize_on_add = False
            store.set_at(live, np.asarray(snap["vectors"])[live])
            store.normalize_on_add = orig
        store._count = snap["count"]
        return store
