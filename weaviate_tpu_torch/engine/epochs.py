"""Epoch store: immutable device epochs with compaction on the card (port
of ``weaviate_tpu/engine/epochs.py``, one device).

The reference's LSM engine (lsmkv ``replace``: immutable segments, one
active memtable, background compaction) applied to device memory: the
corpus is a stack of IMMUTABLE epochs plus one small ACTIVE epoch instead
of one buffer that only grows.

- Writes land in the active epoch through the store's staged-scatter
  path; at ``epoch_rows`` it is SEALED (its vectors are frozen, the
  serving lock never guards them again) and a fresh active epoch opens.
- Reads fuse across the stack: every epoch runs the same scan kernels a
  single store runs (``distance_block`` / ``fused_topk_scan``, the BQ and
  PQ4 scan-reduce kernels), and the per-epoch survivor sets merge ON THE
  CARD through ``ops.topk.merge_epoch_topk`` (``fused_topk_pairs`` under
  ``selection="fused"``). The merge is exact and ties go to the lower
  global slot, so a multi-epoch answer equals a single-buffer scan's.
- Deletes stay tombstones, and ``maintain()`` (the database's
  ``epoch-maintenance`` cycle) reclaims their memory: a tombstone-heavy
  sealed epoch repacks its live rows into a fresh store and the old
  tensors go with their ledger entries; an empty epoch is dropped.
- Global slot ids are STABLE across compaction: each epoch carries a
  local -> global ``slot_map`` the merge gathers through, so the
  ``FlatIndex`` id <-> slot tables never change when an epoch repacks,
  and a sealed epoch can move to a sibling shard whole
  (``extract_epoch`` / ``drop_epoch``; db/collection.py makes the move
  durable).

Each epoch's tensors register in the memory ledger under a per-epoch
component label (``corpus@e3``, ``codes@e3``), so /v1/debug/memory shows
which epoch owns which bytes and dropping an epoch releases exactly its
entries.

On a ``mesh`` every epoch's store is built on it (row-sharded, a scan per
shard and the sharded merge inside each epoch's scan), and the slot maps
and the cross-epoch merge sit on the mesh's merge device, where each
epoch's candidates land.
"""

from __future__ import annotations

import os
import threading
import time

import numpy as np
import torch

from weaviate_tpu_torch.engine.quantized import (RESCORE_BLOCK_ELEMS, RESCORE_THREADS,
                                                 QuantizedVectorStore, _row_blocks,
                                                 _run_blocks)
from weaviate_tpu_torch.engine.store import (DeviceVectorStore, _next_pow2,
                                             normalize_allow_mask, range_search,
                                             storage_dtype, to_host)
from weaviate_tpu_torch.ops.bq import _auto_reduce_l
from weaviate_tpu_torch.ops.topk import merge_epoch_topk
from weaviate_tpu_torch.parallel.mesh import placement
from weaviate_tpu_torch.runtime import (hbm_ledger, kernelscope, tracing,
                                        transfer)
from weaviate_tpu_torch.runtime.transfer import DeviceResultHandle

#: default seal threshold (rows) when epochs are enabled without an
#: explicit size; 0 disables epoching (the single buffer)
DEFAULT_EPOCH_ROWS = int(os.environ.get("WEAVIATE_TPU_EPOCH_ROWS", "0") or 0)

#: tombstone fraction past which maintain() folds a sealed epoch
COMPACT_TOMBSTONE_FRAC = 0.25


class _Epoch:
    """One epoch: a backing store and its slice of the global slot space.

    ``base`` is the first global slot; ``span`` the number of global
    slots the epoch ever covered (fixed at seal). ``map_np`` is the
    local -> global table (None = identity ``base + local``, the layout
    before any compaction); ``local_of`` its inverse over ``[0, span)``
    (-1 = dropped). Compaction repacks local rows but keeps the global
    ids: only these maps change.
    """

    __slots__ = ("eid", "base", "span", "store", "sealed", "map_np",
                 "local_of", "_dev_map", "_dev_map_cap", "last_query_t",
                 "created_t")

    def __init__(self, eid: int, base: int, store):
        self.eid = eid
        self.base = base
        self.span = 0
        self.store = store
        self.sealed = False
        self.map_np: np.ndarray | None = None  # None = identity
        self.local_of: np.ndarray | None = None
        self._dev_map = None
        self._dev_map_cap = -1
        self.last_query_t = time.monotonic()
        self.created_t = time.monotonic()

    def slot_map_device(self) -> torch.Tensor:
        """int32 local -> global table on the store's device for the
        merge's gather, rebuilt when the store grows or compacts."""
        cap = self.store.capacity
        if self._dev_map is None or self._dev_map_cap != cap:
            if self.map_np is None:
                host = self.base + np.arange(cap, dtype=np.int32)
            else:
                host = np.full(cap, -1, dtype=np.int32)
                w = min(len(self.map_np), cap)
                host[:w] = self.map_np[:w]
            self._dev_map = torch.from_numpy(host).to(self.store.device)
            self._dev_map_cap = cap
        return self._dev_map

    def locals_for(self, gslots: np.ndarray) -> np.ndarray:
        """Global slots (already in this epoch's range) -> local rows
        (-1 = dropped by compaction)."""
        off = gslots - self.base
        if self.local_of is None:
            return off
        out = np.full(len(off), -1, dtype=np.int64)
        ok = (off >= 0) & (off < len(self.local_of))
        out[ok] = self.local_of[off[ok]]
        return out

    def live_globals(self) -> np.ndarray:
        """Global slot ids of this epoch's live rows."""
        valid = self.store._valid_np
        locs = np.nonzero(valid[: self.store.capacity])[0]
        if self.map_np is None:
            return self.base + locs.astype(np.int64)
        return self.map_np[locs]

    def live_count(self) -> int:
        return int(self.store.live_count())

    def stats(self) -> dict:
        live = self.live_count()
        return {
            "epoch": self.eid,
            "base": self.base,
            "span": self.span if self.sealed else self.store.count,
            "rows": int(self.store.count),
            "live": live,
            "tombstones": max(int(self.store.count) - live, 0),
            "sealed": self.sealed,
            "capacity": int(self.store.capacity),
            "lastQueryAgeS": round(time.monotonic() - self.last_query_t, 3),
        }


class EpochStore:
    """Epoch-stacked device store with the ``DeviceVectorStore`` method
    surface (and the quantized store's, when ``quantization`` is set).

    Thread-safe: ``_lock`` guards the epoch list and the slot-space
    bookkeeping; each backing store keeps its own lock for its tensor
    swaps, always taken AFTER this one (one order, no ABBA).
    """

    def __init__(self, dim: int, *, metric: str = "l2-squared",
                 epoch_rows: int = 0, capacity: int = 8192,
                 dtype=None, mesh=None, chunk_size: int = 8192,
                 normalize_on_add: bool | None = None,
                 selection: str = "approx",
                 quantization: str | None = None,
                 quant_kwargs: dict | None = None, device=None):
        self.device = placement(mesh, device)
        self.dim = dim
        self.metric = metric
        self.epoch_rows = int(epoch_rows) or DEFAULT_EPOCH_ROWS or (1 << 20)
        self.dtype = storage_dtype(dtype)
        self.mesh = mesh
        self.chunk_size = chunk_size
        self._selection = selection
        self.quantization = quantization
        self._quant_kwargs = dict(quant_kwargs or {})
        self.normalize_on_add = (
            metric in ("cosine", "cosine-dot")
            if normalize_on_add is None else normalize_on_add)
        self._initial_capacity = min(capacity, self.epoch_rows)
        self._lock = threading.RLock()
        self._owner = hbm_ledger.current_owner()
        self._codebook = self._quant_kwargs.pop("codebook", None)
        self._next_slot = 0
        self._next_eid = 0
        self.compactions_total = 0
        self.migrations_total = 0
        self._published_eids: set[str] = set()
        self.epochs: list[_Epoch] = []
        with self._lock:
            self._open_epoch_locked()

    @property
    def selection(self) -> str:
        return self._selection

    @selection.setter
    def selection(self, value: str) -> None:
        """The merge's selection and every epoch's scan selection, as a
        single store's ``selection`` governs its whole scan."""
        with self._lock:
            self._selection = value
            for ep in self.epochs:
                ep.store.selection = value

    # -- epoch lifecycle ------------------------------------------------------

    def _new_store(self, capacity: int, eid: int):
        """Backing store for one epoch, labelled per epoch in the ledger
        and built under this store's captured owner scope (sealing runs
        on the write path, which may be outside the shard's scope)."""
        with hbm_ledger.owner(**self._owner):
            if self.quantization:
                return QuantizedVectorStore(
                    dim=self.dim, metric=self.metric,
                    quantization=self.quantization, capacity=capacity,
                    chunk_size=self.chunk_size, selection=self._selection,
                    normalize_on_add=self.normalize_on_add,
                    codebook=self._codebook,
                    component_suffix=f"@e{eid}", device=self.device,
                    mesh=self.mesh, **self._quant_kwargs)
            return DeviceVectorStore(
                dim=self.dim, metric=self.metric, capacity=capacity,
                dtype=self.dtype, chunk_size=self.chunk_size,
                normalize_on_add=self.normalize_on_add,
                selection=self._selection, component=f"corpus@e{eid}",
                device=self.device, mesh=self.mesh)

    def _open_epoch_locked(self) -> _Epoch:
        """Open a fresh active epoch at the slot high-water mark. Caller
        holds ``_lock``."""
        eid = self._next_eid
        self._next_eid += 1
        ep = _Epoch(eid, self._next_slot,
                    self._new_store(self._initial_capacity, eid))
        self.epochs.append(ep)
        return ep

    def _seal_active_locked(self) -> None:
        """Freeze the active epoch (its staged rows flushed, so the sealed
        tensors are complete) and open a new one. Caller holds ``_lock``."""
        act = self.epochs[-1]
        if hasattr(act.store, "flush_staged"):
            act.store.flush_staged()
        act.span = int(act.store.count)
        act.sealed = True
        self._next_slot = act.base + act.span
        self._open_epoch_locked()

    def seal_active(self) -> None:
        """Public seal hook (tests, before a migration)."""
        with self._lock:
            if self.epochs[-1].store.count > 0:
                self._seal_active_locked()

    # -- slot-space mapping ---------------------------------------------------

    def _group_by_epoch(self, gslots: np.ndarray):
        """Global slots -> (epoch, local rows) groups. Caller holds
        ``_lock``. Slots in dropped or migrated ranges are skipped (their
        rows are gone: the contract of deleting a tombstoned slot)."""
        if len(self.epochs) == 1 and self.epochs[0].base == 0:
            yield self.epochs[0], gslots.astype(np.int64)
            return
        bases = np.array([e.base for e in self.epochs], dtype=np.int64)
        spans = np.array(
            [e.span if e.sealed else e.store.count for e in self.epochs],
            dtype=np.int64)
        gslots = np.asarray(gslots, dtype=np.int64)
        idx = np.searchsorted(bases, gslots, side="right") - 1
        ok = idx >= 0
        ok[ok] &= gslots[ok] - bases[idx[ok]] < np.maximum(
            spans[idx[ok]], 1)
        for ei in np.unique(idx[ok]):
            sel = ok & (idx == ei)
            ep = self.epochs[int(ei)]
            loc = ep.locals_for(gslots[sel])
            loc = loc[loc >= 0]
            if len(loc):
                yield ep, loc

    # -- DeviceVectorStore surface: mutation ----------------------------------

    def add(self, vectors: np.ndarray) -> np.ndarray:
        """Append a batch; returns GLOBAL slot ids. A batch larger than the
        active epoch's room splits across a seal: the ids stay contiguous
        because the new epoch opens exactly at the high-water mark."""
        vectors = np.asarray(vectors, dtype=np.float32)
        if vectors.ndim == 1:
            vectors = vectors[None, :]
        m = len(vectors)
        out = np.empty(m, dtype=np.int64)
        with self._lock:
            pos = 0
            while pos < m:
                act = self.epochs[-1]
                room = self.epoch_rows - int(act.store.count)
                if room <= 0:
                    self._seal_active_locked()
                    continue
                take = min(room, m - pos)
                locs = act.store.add(vectors[pos:pos + take])
                out[pos:pos + take] = act.base + np.asarray(locs,
                                                            dtype=np.int64)
                pos += take
                self._next_slot = max(self._next_slot,
                                      act.base + int(act.store.count))
        return out

    def set_at(self, slots, vectors: np.ndarray) -> None:
        """Overwrite existing global slots in the epochs that own them (the
        update path keeps slot ids; a sealed epoch's in-place write is the
        exception the reference makes for doc-id reuse)."""
        slots = np.atleast_1d(np.asarray(slots, dtype=np.int64))
        vectors = np.atleast_2d(np.asarray(vectors, dtype=np.float32))
        with self._lock:
            if len(slots) and int(slots.max()) >= self._addressable():
                raise ValueError(
                    f"set_at slot {int(slots.max())} beyond epoch-store "
                    f"high-water {self._addressable()}: epoch stores "
                    "assign slots at add()")
            order = {int(s): i for i, s in enumerate(slots)}
            for ep, loc in self._group_by_epoch(slots):
                gl = (ep.base + loc if ep.map_np is None
                      else ep.map_np[loc])
                rows = vectors[[order[int(g)] for g in gl]]
                ep.store.set_at(loc, rows)

    def set_at_prenormalized(self, slots, vectors: np.ndarray) -> None:
        """set_at for rows normalized at their original insert (restore
        and compress paths)."""
        with self._lock:
            flips = []
            for ep in self.epochs:
                flips.append((ep.store, ep.store.normalize_on_add))
                ep.store.normalize_on_add = False
            try:
                self.set_at(slots, vectors)
            finally:
                for st, orig in flips:
                    st.normalize_on_add = orig

    def delete(self, slots) -> None:
        slots = np.atleast_1d(np.asarray(slots, dtype=np.int64))
        if len(slots) == 0:
            return
        with self._lock:
            for ep, loc in self._group_by_epoch(slots):
                ep.store.delete(loc)

    def flush_staged(self) -> None:
        with self._lock:
            act = self.epochs[-1]
            if hasattr(act.store, "flush_staged"):
                act.store.flush_staged()

    # -- DeviceVectorStore surface: queries -----------------------------------

    def _addressable(self) -> int:
        """Exclusive upper bound on assigned global slots. Caller holds
        ``_lock``."""
        act = self.epochs[-1]
        return max(self._next_slot, act.base + int(act.store.count))

    @property
    def count(self) -> int:
        """Global slot high-water mark (tombstones and migrated ranges
        included): the size filters and doc tables key against."""
        with self._lock:
            return self._addressable()

    @property
    def capacity(self) -> int:
        """Addressable global slot space (the last epoch's range end): the
        width of shared allow masks and slot -> id tables."""
        with self._lock:
            act = self.epochs[-1]
            return act.base + int(act.store.capacity)

    def live_count(self) -> int:
        with self._lock:
            return sum(ep.live_count() for ep in self.epochs)

    @property
    def epoch_count(self) -> int:
        with self._lock:
            return len(self.epochs)

    @property
    def trained(self) -> bool:
        if not self.quantization:
            return True
        with self._lock:
            return self.epochs[-1].store.trained

    def train(self, vectors: np.ndarray | None = None, iters: int = 8,
              seed: int = 0) -> None:
        """Fit the shared PQ codebook and re-encode every epoch: one
        codebook across the stack, so candidates merge in one code space."""
        if self.quantization != "pq":
            return
        with self._lock:
            if vectors is None:
                parts = []
                for ep in self.epochs:
                    lg = ep.live_globals()
                    if len(lg):
                        loc = ep.locals_for(lg)
                        parts.append(ep.store._vectors_for(loc))
                vectors = (np.concatenate(parts) if parts
                           else np.zeros((0, self.dim), np.float32))
            act = self.epochs[-1]
            act.store.train(vectors, iters=iters, seed=seed)
            self._codebook = act.store.codebook
            for ep in self.epochs[:-1]:
                ep.store.codebook = self._codebook
                ep.store._reencode_all()
                ep.store._hbm_sync()

    def get(self, slots) -> np.ndarray:
        slots = np.atleast_1d(np.asarray(slots, dtype=np.int64))
        out = np.zeros((len(slots), self.dim), dtype=np.float32)
        order = {}
        with self._lock:
            for i, s in enumerate(slots):
                order.setdefault(int(s), []).append(i)
            for ep, loc in self._group_by_epoch(slots):
                gl = (ep.base + loc if ep.map_np is None
                      else ep.map_np[loc])
                rows = ep.store.get(loc)
                for g, row in zip(gl, rows):
                    for i in order.get(int(g), ()):
                        out[i] = row
        return out

    def _slice_allow(self, allow_mask, ep: _Epoch):
        """Column-slice a global allow mask to one epoch's LOCAL row space
        (through the epoch's maps after a compaction): a shared [C] numpy
        mask, or [B, C] per-query rows as a bool tensor on the device.
        Caller holds ``_lock``."""
        if allow_mask is None:
            return None
        base, cap = ep.base, int(ep.store.capacity)
        span = ep.span if ep.sealed else int(ep.store.count)
        if allow_mask.ndim == 1:
            seg = np.zeros(cap, dtype=bool)
            w = max(min(len(allow_mask) - base, span), 0)
            if w > 0:
                g_allowed = allow_mask[base:base + w]
                if ep.local_of is None:
                    seg[:w] = g_allowed
                else:
                    loc = ep.local_of[:w][g_allowed[: len(ep.local_of)]]
                    loc = loc[(loc >= 0) & (loc < cap)]
                    seg[loc] = True
            return seg
        # per-query rows: a bool tensor on the device (search_async)
        b, width = allow_mask.shape
        dev = allow_mask.device
        seg = torch.zeros((b, cap), dtype=torch.bool, device=dev)
        if ep.map_np is None:
            w = max(min(width - base, span), 0)
            seg[:, :w] = allow_mask[:, base:base + w]
            return seg
        # a compacted epoch: each local row takes its global slot's column
        filled = np.flatnonzero(ep.map_np[:cap] >= 0)
        gl = ep.map_np[filled]
        cols = allow_mask.index_select(
            1, torch.from_numpy(np.minimum(gl, width - 1)).to(dev))
        cols &= torch.from_numpy(gl < width).to(dev)
        if len(filled) and filled[-1] == len(filled) - 1:
            seg[:, :len(filled)] = cols  # compaction packs the live rows first
        else:
            seg[:, torch.from_numpy(filled).to(dev)] = cols
        return seg

    def search(self, queries: np.ndarray, k: int,
               allow_mask: np.ndarray | None = None):
        return self.search_async(queries, k, allow_mask).result()

    def search_async(self, queries: np.ndarray, k: int,
                     allow_mask: np.ndarray | None = None
                     ) -> DeviceResultHandle:
        """Dispatch-only search across the epochs: every epoch's scan
        launches under ``_lock``, the survivor sets merge on the card
        (``merge_epoch_topk``), and the handle's finish step runs the one
        global host rescore (quantized), so the serving pipeline drains
        one device->host copy per batch however many epochs exist."""
        queries = np.asarray(queries, dtype=np.float32)
        squeeze = queries.ndim == 1
        if squeeze:
            queries = queries[None, :]
        now = time.monotonic()
        with self._lock:
            eps = list(self.epochs)
            for ep in eps:
                ep.last_query_t = now
            if len(eps) == 1 and eps[0].base == 0 and eps[0].map_np is None:
                # one epoch at slot 0 IS the store: its own search,
                # gathered cutover included
                return eps[0].store.search_async(
                    queries[0] if squeeze else queries, k, allow_mask)
        allow_mask = normalize_allow_mask(allow_mask, len(queries))
        if allow_mask is not None and allow_mask.ndim == 2:
            # per-query rows reach the device once; each epoch's columns
            # are cut from them there (a host cut per epoch copies the
            # whole [B, C] mask again)
            allow_mask = torch.from_numpy(
                np.ascontiguousarray(allow_mask, dtype=bool)).to(self.device)
        with tracing.span("store.epoch_scan", epochs=len(eps),
                          queries=len(queries), k=k,
                          quantized=bool(self.quantization),
                          filtered=allow_mask is not None):
            with self._lock:
                eps = [e for e in self.epochs if int(e.store.count) > 0]
                if not eps:
                    b = len(queries)
                    d0 = np.full((b, k), np.float32(np.inf), np.float32)
                    i0 = np.full((b, k), -1, np.int64)
                    return DeviceResultHandle.ready(
                        (d0[0], i0[0]) if squeeze else (d0, i0))
                if self.quantization:
                    return self._dispatch_quantized_locked(
                        eps, queries, k, allow_mask, squeeze)
                return self._dispatch_flat_locked(
                    eps, queries, k, allow_mask, squeeze)

    def _dispatch_flat_locked(self, eps, queries, k, allow_mask, squeeze):
        """Per-epoch flat scans + the merge on the card. Caller holds
        ``_lock``."""
        parts, maps = [], []
        for ep in eps:
            d, i = ep.store.epoch_scan(
                queries, k, self._slice_allow(allow_mask, ep))
            parts.append((d, i))
            maps.append(ep.slot_map_device())
        # EXPLAIN (host ints, no-op without a sink): epoch fanout and
        # the on-device merge shape of this dispatch
        kernelscope.explain_note(
            "epochs", epochs=len(parts), merge_fanin=len(parts),
            k_merge=k, rescore_mode="none", queries=len(queries), k=k)
        md, mi = merge_epoch_topk(tuple(parts), tuple(maps), k=k,
                                  selection=self._selection)

        def _finish(d_np, i_np, _squeeze=squeeze):
            i_np = i_np.astype(np.int64, copy=False)
            if _squeeze:
                return d_np[0], i_np[0]
            return d_np, i_np

        return DeviceResultHandle(
            (md, mi), finish=_finish,
            attrs={"rows": self.capacity, "queries": len(queries),
                   "k": k, "epochs": len(parts)})

    def _dispatch_quantized_locked(self, eps, queries, k, allow_mask,
                                   squeeze):
        """Per-epoch compressed scans + the merge on the card + ONE global
        host rescore in the finish step. Caller holds ``_lock``."""
        template = eps[-1].store
        qn = template._maybe_norm(queries)
        mode = template.rescore_mode()
        rl = template.rescore_limit
        snaps = []  # (base, span, local_of, tiers, count) at dispatch
        parts, maps = [], []
        # "plane" (bf16 rows on the card) degrades to "post": the merged
        # candidates span per-epoch tier snapshots, so the exact pass
        # goes through the epoch-aware _vectors_for gather below
        if mode == "plane":
            mode = "post"
        # a mesh's inline rescore sees k_cand code-distance candidates per
        # epoch, as its single buffer does, and keeps k
        k_cand = max(k * rl, k) if mode in ("post", "inline") else k
        # the one-pass scan-reduce kernels keep one winner per reduce_l
        # rows, a factor a store takes from its capacity. Every epoch
        # takes the factor of the whole stack's slot space — the one a
        # single buffer of these rows takes — so the merged candidates are
        # a single buffer's and the rescored answer is too. (The JAX
        # package lets each epoch take its own: a smaller factor, another
        # candidate set on its TPU path. ROADMAP Queue 3.)
        reduce_l = _auto_reduce_l(_next_pow2(self.capacity))
        for ep in eps:
            cap = int(ep.store.capacity)
            kc = min(k_cand, cap)
            d, i, tiers = ep.store.epoch_scan(
                qn, kc, self._slice_allow(allow_mask, ep),
                pre_normalized=True, reduce_l=reduce_l,
                k_out=kc if mode == "post" else min(k, cap))
            parts.append((d, i))
            maps.append(ep.slot_map_device())
            snaps.append((ep.base, ep.span or int(ep.store.count),
                          None if ep.local_of is None
                          else ep.local_of.copy(), tiers,
                          int(ep.store.count)))
        k_merge = k_cand if mode == "post" else k
        # EXPLAIN: epoch fanout, merge shape and the (possibly plane->
        # post degraded) rescore mode of this dispatch — host ints only
        kernelscope.explain_note(
            "epochs", epochs=len(parts), merge_fanin=len(parts),
            k_merge=k_merge, k_cand=k_cand, rescore_mode=mode,
            queries=len(queries), k=k)
        md, mi = merge_epoch_topk(tuple(parts), tuple(maps), k=k_merge,
                                  selection=self._selection)
        cap_total = self.capacity
        dim = self.dim

        def _vectors_for(slots, out=None, _snaps=snaps, _dim=dim):
            """ASCENDING global slots -> full-precision rows across the
            dispatch-time epoch tier snapshots (the finish step's rescore
            feed), into ``out`` when given. The epochs hold ascending slot
            ranges, so each epoch's rows fill one run of the output."""
            slots = np.asarray(slots, dtype=np.int64)
            if out is None:
                out = np.zeros((len(slots), _dim), dtype=np.float32)
            else:
                out[...] = 0
            for base, span, local_of, tiers, cnt in _snaps:
                lo_i, hi_i = np.searchsorted(slots, (base, base + max(span, 1)))
                if lo_i == hi_i:
                    continue
                loc = slots[lo_i:hi_i] - base
                if local_of is not None:
                    lo = np.full(len(loc), 0, dtype=np.int64)
                    ok = loc < len(local_of)
                    lo[ok] = np.where(local_of[loc[ok]] >= 0,
                                      local_of[loc[ok]], 0)
                    loc = lo
                loc = np.clip(loc, 0, max(cnt - 1, 0))
                if tiers[0] is not None:  # host rows: gathered in place
                    np.take(tiers[0], loc, axis=0, out=out[lo_i:hi_i])
                else:
                    out[lo_i:hi_i] = QuantizedVectorStore._tier_vectors(*tiers, loc)
            return out

        def _finish(d_np, i_np, _queries=qn, _k=k, _squeeze=squeeze,
                    _mode=mode, _cap=cap_total):
            i_np = i_np.astype(np.int64, copy=False)
            if _mode == "post":
                with tracing.span("store.host_rescore",
                                  candidates=int(i_np.shape[1])):
                    d_np, i_np = _rescore_candidates(
                        template, _queries, i_np, _k, _cap, _vectors_for)
            out_d = d_np[:, :_k].astype(np.float32)
            out_i = i_np[:, :_k]
            if _squeeze:
                return out_d[0], out_i[0]
            return out_d, out_i

        return DeviceResultHandle(
            (md, mi), finish=_finish,
            attrs={"rows": cap_total, "queries": len(queries), "k": k,
                   "epochs": len(parts),
                   "quantization": self.quantization})

    def search_by_distance(self, query: np.ndarray, max_distance: float,
                           allow_mask: np.ndarray | None = None):
        return range_search(self, query, max_distance, allow_mask)

    # -- maintenance: compaction / migration ----------------------------------

    def compact(self) -> np.ndarray:
        """Full-store compaction with STABLE global slots: every sealed
        epoch folds its tombstones in place (live global ids unchanged).
        Returns the old -> new mapping the FlatIndex contract expects:
        identity for live slots, -1 for dead ones."""
        with self._lock:
            cap = self.capacity
            for ep in list(self.epochs):
                if ep.sealed:
                    if ep.live_count() == 0:
                        self.drop_epoch(ep.eid)
                    elif int(ep.store.count) > ep.live_count():
                        self.compact_epoch(ep.eid)
            mapping = np.full(cap, -1, dtype=np.int64)
            for ep in self.epochs:
                lg = ep.live_globals()
                lg = lg[lg < cap]
                mapping[lg] = lg
            return mapping

    def compact_epoch(self, eid: int) -> bool:
        """Fold one sealed epoch's tombstones: its store repacks the live
        rows into a right-sized fresh allocation (``compact()``, whose one
        device->host copy goes through ``transfer.d2h``), the old tensors
        go with their ledger entries, and the epoch's local -> global maps
        re-point. Global slot ids do not change, so no index table needs
        remapping."""
        with self._lock:
            ep = self._epoch_by_id(eid)
            if ep is None or not ep.sealed:
                return False
            old_cap = int(ep.store.capacity)
            old_map = (ep.base + np.arange(old_cap, dtype=np.int64)
                       if ep.map_np is None else ep.map_np)
            with tracing.span("store.compact_epoch", epoch=ep.eid,
                              rows=old_cap):
                mapping = ep.store.compact()
            new_cap = int(ep.store.capacity)
            new_map = np.full(new_cap, -1, dtype=np.int64)
            moved = mapping >= 0
            src = np.nonzero(moved)[0]
            new_map[mapping[src]] = old_map[src]
            ep.map_np = new_map
            local_of = np.full(ep.span, -1, dtype=np.int64)
            filled = new_map >= 0
            off = new_map[filled] - ep.base
            ok = (off >= 0) & (off < ep.span)
            local_of[off[ok]] = np.nonzero(filled)[0][ok]
            ep.local_of = local_of
            ep._dev_map = None
            self.compactions_total += 1
            try:
                from weaviate_tpu_torch.runtime.metrics import epoch_compactions

                epoch_compactions.labels(
                    self._owner.get("collection", "_unowned"),
                    self._owner.get("shard", "-")).inc()
            except Exception:  # noqa: BLE001 — observability must not gate
                pass
            self._publish_metrics_locked()
            return True

    def drop_epoch(self, eid: int) -> bool:
        """Remove an epoch from the stack (after a migration's cutover, or
        an all-tombstone epoch). Its tensors go with the stores' ledger
        finalizers once the last in-flight handle drops its reference."""
        with self._lock:
            ep = self._epoch_by_id(eid)
            if ep is None:
                return False
            if ep is self.epochs[-1] and not ep.sealed:
                return False  # never drop the live write target
            self.epochs.remove(ep)
            if not self.epochs:
                self._open_epoch_locked()
            self._publish_metrics_locked()
            return True

    def extract_epoch(self, eid: int):
        """Serialize one epoch for migration: ``(global_slots [n],
        vectors [n, d] f32)`` of its live rows (one ``transfer.d2h`` for
        the flat tier; a quantized epoch reads its full-precision tier).
        The epoch is untouched: the caller cuts over (``drop_epoch``) only
        after the target shard acknowledged the ingest."""
        with self._lock:
            ep = self._epoch_by_id(eid)
            if ep is None:
                return np.empty(0, np.int64), np.zeros((0, self.dim),
                                                       np.float32)
            if hasattr(ep.store, "flush_staged"):
                ep.store.flush_staged()
            lg = ep.live_globals()
            loc = ep.locals_for(lg)
            if isinstance(ep.store, QuantizedVectorStore):
                rows = ep.store._vectors_for(loc)
            else:
                rows = to_host(ep.store.vectors)[loc].astype(np.float32)
            return lg, rows

    def live_globals_of(self, eid: int) -> np.ndarray:
        """Global slot ids of one epoch's live rows (the migration planner
        maps them through the index's slot -> doc table)."""
        with self._lock:
            ep = self._epoch_by_id(eid)
            return (np.empty(0, np.int64) if ep is None
                    else ep.live_globals())

    def coldest_sealed(self) -> int | None:
        """The sealed epoch least recently touched by a query (the
        migration victim when the ledger crosses its watermark)."""
        with self._lock:
            cands = [e for e in self.epochs if e.sealed
                     and e.live_count() > 0]
            if not cands:
                return None
            return min(cands, key=lambda e: e.last_query_t).eid

    def maintain(self, tombstone_frac: float = COMPACT_TOMBSTONE_FRAC
                 ) -> bool:
        """One background cycle (the cyclemanager callback's body): seal a
        full active epoch, drop empty sealed epochs, fold tombstone-heavy
        ones. Returns True when it did work."""
        did = False
        with self._lock:
            if int(self.epochs[-1].store.count) >= self.epoch_rows:
                self._seal_active_locked()
                did = True
            for ep in list(self.epochs):
                if not ep.sealed:
                    continue
                total = int(ep.store.count)
                live = ep.live_count()
                if total and live == 0:
                    did = self.drop_epoch(ep.eid) or did
                elif total and (total - live) / total >= tombstone_frac:
                    did = self.compact_epoch(ep.eid) or did
            self._publish_metrics_locked()
        return did

    def _epoch_by_id(self, eid: int) -> _Epoch | None:
        """Caller holds ``_lock``."""
        for ep in self.epochs:
            if ep.eid == eid:
                return ep
        return None

    def epoch_stats(self) -> list[dict]:
        with self._lock:
            return [ep.stats() for ep in self.epochs]

    # -- observability --------------------------------------------------------

    def _publish_metrics_locked(self) -> None:
        """Refresh the ``weaviate_tpu_epoch_*`` gauges; a per-epoch series
        is removed when its epoch compacts away or migrates. Caller holds
        ``_lock``; the gauges have their own locks and never call back."""
        try:
            from weaviate_tpu_torch.runtime.metrics import (
                epoch_count, epoch_live_rows, epoch_tombstone_rows)

            col = self._owner.get("collection", "_unowned")
            shard = self._owner.get("shard", "-")
            epoch_count.labels(col, shard).set(float(len(self.epochs)))
            seen = set()
            for ep in self.epochs:
                label = f"e{ep.eid}"
                seen.add(label)
                st = ep.stats()
                epoch_live_rows.labels(col, shard, label).set(
                    float(st["live"]))
                epoch_tombstone_rows.labels(col, shard, label).set(
                    float(st["tombstones"]))
            for stale in self._published_eids - seen:
                epoch_live_rows.remove(col, shard, stale)
                epoch_tombstone_rows.remove(col, shard, stale)
            self._published_eids = seen
        except Exception:  # noqa: BLE001 — observability must not gate
            pass

    # -- persistence ----------------------------------------------------------

    def snapshot(self) -> dict:
        """Flattened host snapshot over the global slot space (epoch
        boundaries are a device-layout detail: restore re-splits by
        ``epoch_rows``). The ``DeviceVectorStore`` snapshot schema plus the
        epoch config; the JAX package's epoch snapshot has the same keys."""
        with self._lock:
            self.flush_staged()
            cap = self._addressable()
            vecs = np.zeros((cap, self.dim), dtype=np.float32)
            valid = np.zeros(max(cap, 1), dtype=bool)
            for ep in self.epochs:
                lg = ep.live_globals()
                lg = lg[lg < cap]
                if not len(lg):
                    continue
                loc = ep.locals_for(lg)
                if isinstance(ep.store, QuantizedVectorStore):
                    rows = ep.store._vectors_for(loc)
                else:
                    rows = to_host(ep.store.vectors)[loc]
                vecs[lg] = rows
                valid[lg] = True
            snap = {
                "vectors": vecs,
                "valid": valid[:max(cap, 1)],
                "count": cap,
                "dim": self.dim,
                "metric": self.metric,
                "dtype": str(self.dtype).replace("torch.", ""),
                "chunk_size": self.chunk_size,
                "selection": self._selection,
                "epoch_rows": self.epoch_rows,
                "quantization": self.quantization,
            }
            if self.quantization:
                snap["quant_kwargs"] = dict(self._quant_kwargs)
                snap["codebook"] = (
                    None if self._codebook is None
                    else tracing.d2h(self._codebook.centroids)[0])
            return snap

    @classmethod
    def restore(cls, snap: dict, mesh=None, **kwargs) -> "EpochStore":
        store = cls(
            dim=snap["dim"], metric=snap["metric"],
            epoch_rows=snap.get("epoch_rows", 0),
            dtype=snap.get("dtype", "float32"),
            mesh=mesh, chunk_size=snap.get("chunk_size", 8192),
            selection=snap.get("selection", "approx"),
            quantization=snap.get("quantization"),
            quant_kwargs=snap.get("quant_kwargs"), **kwargs)
        if snap.get("codebook") is not None:
            from weaviate_tpu_torch.ops import pq as pq_ops

            store._codebook = pq_ops.PQCodebook(torch.from_numpy(
                np.array(snap["codebook"], dtype=np.float32)).to(store.device))
            store.epochs[-1].store.codebook = store._codebook
        live = np.nonzero(snap["valid"])[0]
        store._restore_rows(live, np.asarray(snap["vectors"]),
                            int(snap["count"]))
        return store

    def _restore_rows(self, live: np.ndarray, vectors: np.ndarray,
                      count: int) -> None:
        """Rebuild the epoch stack over ``[0, count)`` global slots from
        flattened rows (restore, compress): epochs re-split every
        ``epoch_rows`` slots, identity maps, all but the last sealed."""
        with self._lock:
            assert self._next_slot == 0 and len(self.epochs) == 1, \
                "_restore_rows only populates a fresh store"
            for base in range(0, max(count, 1), self.epoch_rows):
                act = self.epochs[-1]
                act.base = base
                hi = min(base + self.epoch_rows, count)
                sel = live[(live >= base) & (live < hi)]
                if len(sel):
                    # pre-size the store so the local slots exist, then
                    # write the live ones (rows normalized already)
                    act.store.set_at(
                        np.array([hi - base - 1]),
                        np.zeros((1, self.dim), np.float32))
                    flips = act.store.normalize_on_add
                    act.store.normalize_on_add = False
                    try:
                        act.store.set_at(sel - base, vectors[sel])
                    finally:
                        act.store.normalize_on_add = flips
                    # the pre-size row is dead unless slot hi-1 is live
                    if (hi - 1) not in sel:
                        act.store.delete(np.array([hi - base - 1]))
                elif hi > base:
                    act.store.set_at(
                        np.array([hi - base - 1]),
                        np.zeros((1, self.dim), np.float32))
                    act.store.delete(np.array([hi - base - 1]))
                if hi < count:
                    self._seal_active_locked()
            self._next_slot = count
            self._publish_metrics_locked()


def _rescore_candidates(template: QuantizedVectorStore, queries: np.ndarray,
                        cand_ids: np.ndarray, k: int, capacity: int,
                        vectors_for):
    """The quantized store's exact host rescore over merged GLOBAL
    candidate slots. The store's ``_host_rescore`` gathers from one row
    tier by slot; here the rows live in several epochs. So the distinct
    candidates of a few queries at a time are gathered through
    ``vectors_for`` into a small tier of their own (``np.unique`` gives the
    ascending slots it takes), renumbered into it, rescored, and the ids
    mapped back. The groups run in blocks on the rescore threads; a group
    holds at most RESCORE_BLOCK_ELEMS candidate values, so each
    ``_host_rescore`` call stays on its thread. Each (query, candidate)
    distance comes from the same row by the same arithmetic, and each
    query's selection from its own row of distances, so the answer is the
    single store's."""
    b, kc = cand_ids.shape
    safe = np.clip(cand_ids, 0, capacity - 1)
    per = max(1, RESCORE_BLOCK_ELEMS // max(1, kc * template.dim))

    def block(lo, hi):
        out = []
        rows = np.empty((min(per, hi - lo) * kc, template.dim), dtype=np.float32)
        for g in range(lo, hi, per):
            g1 = min(hi, g + per)
            uniq, inv = np.unique(safe[g:g1], return_inverse=True)
            local = np.where(cand_ids[g:g1] >= 0, inv.reshape(g1 - g, kc), -1)
            d, i = template._host_rescore(
                queries[g:g1], local, k, capacity=max(len(uniq), 1),
                tiers=(vectors_for(uniq, rows[:len(uniq)]), None))
            out.append((d, np.where(i >= 0, uniq[np.clip(i, 0, len(uniq) - 1)], -1)))
        return out

    done = [part for parts in _run_blocks(block, _row_blocks(b, RESCORE_THREADS))
            for part in parts]
    return (np.concatenate([d for d, _ in done]),
            np.concatenate([i for _, i in done]))
