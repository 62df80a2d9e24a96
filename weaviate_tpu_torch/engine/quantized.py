"""Quantized (PQ/BQ) vector store: compressed codes on the card, exact
rescore (port of ``weaviate_tpu/engine/quantized.py``, one device).

Reference parity:
- flat BQ path with rescore: vector/flat/index.go:347 (searchByVectorBQ)
- runtime compression: vector/hnsw/compress.go:38 (train on current
  contents, swap in a compressed store)

Device memory holds only the codes ([C, m] uint8 for PQ; [C, w] sign words
for BQ, int32 tensors holding the uint32 bit pattern) plus the valid mask,
and for the two-stage scans a transposed sign prefix [Wp, C]. Three
rescore modes pick where full-precision candidates come from:

- ``"host"`` (default): f32 rows in host RAM; the compressed scan returns
  an oversampled candidate set and the exact rescore is a host gather +
  batched numpy distance in the result handle's finish step.
- ``"device"``: bf16 rows on the card beside the codes; the oversampled
  candidates rescore on the card through the candidate plane
  (``ops/candidates.gather_rescore_topk``).
- ``"none"``: codes only. Results are code-distance ordered.

On a ``mesh`` the codes, the valid mask and the ``"device"`` rescore rows
are ``RowSharded`` (``parallel/sharded_search.py``): every search runs a
compressed scan per shard, and in ``"device"`` mode each shard rescores
its own candidates against its own rows inside the scan (``"inline"``)
before the merge. A sign prefix exists only without a mesh. ``epoch_scan``
is the epoch store's per-epoch dispatch (engine/epochs.py).
"""

from __future__ import annotations

import os
import threading
import time
import weakref
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from weaviate_tpu_torch.engine.store import (_next_pow2, and_mask,
                                             batched_mask_operands,
                                             normalize_allow_mask, range_search,
                                             to_host)
from weaviate_tpu_torch.ops import bq as bq_ops
from weaviate_tpu_torch.ops import pq as pq_ops
from weaviate_tpu_torch.ops.candidates import gather_rescore_topk
from weaviate_tpu_torch.ops.distances import normalize_np
from weaviate_tpu_torch.parallel.mesh import (n_row_shards, placement,
                                              shardable_capacity)
from weaviate_tpu_torch.parallel.sharded_search import (RowSharded, grow_rows,
                                                        shard_array,
                                                        sharded_quantized_topk,
                                                        sharded_zeros)
from weaviate_tpu_torch.runtime import hbm_ledger, kernelscope, tracing
from weaviate_tpu_torch.runtime.transfer import DeviceResultHandle

_DEFAULT_CHUNK = 8192

# The exact host rescore's work cutting: blocks of queries on up to
# RESCORE_THREADS host threads (each block at least RESCORE_BLOCK_ELEMS
# f32 values of candidate rows, so a one-query drain stays on the caller's
# thread), each block gathered and scored RESCORE_CHUNK_BYTES of rows at a
# time, so that the rows are scored while they are in cache.
RESCORE_THREADS = max(1, min(8, len(os.sched_getaffinity(0))))
RESCORE_BLOCK_ELEMS = 1 << 20
RESCORE_CHUNK_BYTES = 1 << 21
_rescore_pool: ThreadPoolExecutor | None = None
_rescore_pool_lock = threading.Lock()


def _row_blocks(n: int, parts: int) -> list[tuple[int, int]]:
    """[lo, hi) blocks cutting range(n) into at most ``parts`` pieces."""
    step = max(1, -(-n // max(1, parts)))
    return [(lo, min(n, lo + step)) for lo in range(0, n, step)] or [(0, 0)]


def _run_blocks(fn, blocks: list[tuple[int, int]]) -> list:
    """``fn(lo, hi)`` for every block, on the rescore pool when there are
    several; results in block order."""
    global _rescore_pool
    if len(blocks) == 1:
        return [fn(*blocks[0])]
    with _rescore_pool_lock:
        if _rescore_pool is None:
            _rescore_pool = ThreadPoolExecutor(8, thread_name_prefix="host-rescore")
    return list(_rescore_pool.map(lambda blk: fn(*blk), blocks))


def _as_i32(codes: np.ndarray) -> np.ndarray:
    """Host codes -> the array the device tensor copies: uint8 PQ codes
    as they are, uint32 sign words as int32 with the same bits."""
    codes = np.ascontiguousarray(codes)
    return codes.view(np.int32) if codes.dtype == np.uint32 else codes


def _as_u32(a: np.ndarray) -> np.ndarray:
    return a.view(np.uint32) if a.dtype == np.int32 else a


class QuantizedVectorStore:
    """PQ- or BQ-compressed store with the DeviceVectorStore method surface."""

    def __init__(
        self,
        dim: int,
        metric: str = "l2-squared",
        quantization: str = "pq",
        capacity: int = _DEFAULT_CHUNK,
        chunk_size: int = _DEFAULT_CHUNK,
        pq_segments: int | None = None,
        pq_centroids: int = 16,
        # oversampling multiplier: the compressed scan returns
        # rescore_limit*k candidates for exact rescore (the reference keeps
        # an absolute rescoreLimit, flat/index.go:301)
        rescore_limit: int = 16,
        normalize_on_add: bool | None = None,
        codebook: pq_ops.PQCodebook | None = None,
        mesh=None,
        rescore: str = "host",
        # width (bits, multiple of 128) of a separately stored transposed
        # sign prefix: searches then run two-stage (prefix scan -> refine
        # -> rescore), reading ~prefix_bits/dim of the code bytes in stage 1
        prefix_bits: int | None = None,
        # survivor selector of the scan-reduce kernels: "approx" (exact
        # selection in the port) or "fused" (fused_topk_pairs)
        selection: str = "approx",
        # memory-ledger component suffix ("@e3" for an epoch's store):
        # codes / prefix / rescore rows / codebook register as "codes@e3"
        # and so on, so each epoch's bytes are seen and released alone
        component_suffix: str = "",
        device=None,
    ):
        if quantization not in ("pq", "bq"):
            raise ValueError(f"unknown quantization {quantization!r}")
        if rescore not in ("host", "device", "none"):
            raise ValueError(f"unknown rescore mode {rescore!r}")
        if selection not in ("approx", "fused"):
            raise ValueError(
                f"quantized stores support selection 'approx' or 'fused', "
                f"got {selection!r}")
        if selection == "fused" and quantization == "pq" and pq_centroids > 16:
            raise ValueError(
                "selection='fused' needs the pq4 scan-reduce kernel "
                "(pq_centroids <= 16) or quantization='bq'")
        self.device = placement(mesh, device)
        self.dim = dim
        self.metric = metric
        self.quantization = quantization
        self.chunk_size = chunk_size
        self.rescore_limit = rescore_limit
        self.rescore = rescore
        self.selection = selection
        self.pq_segments = pq_segments or pq_ops.default_pq_segments(dim, pq_centroids)
        self.pq_centroids = pq_centroids
        self.codebook = codebook
        self.component_suffix = component_suffix
        self.normalize_on_add = (
            metric in ("cosine", "cosine-dot")
            if normalize_on_add is None
            else normalize_on_add
        )
        self.mesh = mesh
        self.n_shards = n_row_shards(mesh)
        self.prefix_words = 0
        # the prefix is a one-buffer layout ([Wp, C] transposed): a mesh
        # scans the full codes per shard
        if prefix_bits and mesh is None:
            wp = max(4, prefix_bits // 32 // 4 * 4)
            if quantization == "bq":
                # a prefix at least as wide as the code saves nothing
                if wp < bq_ops.bq_words(dim):
                    self.prefix_words = wp
            elif wp * 32 <= dim:
                # PQ two-stage: the prefix is a BQ sign slice of the raw
                # vectors, so that many leading dims must exist
                self.prefix_words = wp
        # "take the scan-reduce kernels": on the card; the CPU runs the
        # exact XOR+popcount fallback (BQ) as the JAX package does there
        self.use_pallas = self.device.type == "cuda"
        self._lock = threading.RLock()
        self._count = 0
        self._hbm_owner = hbm_ledger.current_owner()
        self._hbm_keys: dict[str, int] = {}
        weakref.finalize(self, hbm_ledger.ledger.release_many,
                         self._hbm_keys.values())
        self.capacity = self._align(capacity)
        self._valid_np = np.zeros(self.capacity, dtype=bool)
        self._host_vectors = (
            np.zeros((self.capacity, dim), dtype=np.float32)
            if rescore == "host" else None
        )
        self._alloc_codes()

    # -- internals -----------------------------------------------------------

    def _align(self, capacity: int) -> int:
        capacity = _next_pow2(max(capacity, 2 * self.n_shards))
        cs = max(1, min(self.chunk_size, capacity // self.n_shards))
        return shardable_capacity(capacity, self.n_shards, cs)

    def _zeros(self, shape, dtype):
        if self.mesh is None:
            return torch.zeros(shape, dtype=dtype, device=self.device)
        return sharded_zeros(shape, dtype, self.mesh)

    def _code_width(self) -> int:
        if self.quantization == "pq":
            return self.pq_segments
        return bq_ops.bq_words(self.dim)

    def _code_dtype(self) -> torch.dtype:
        return torch.uint8 if self.quantization == "pq" else torch.int32

    def _alloc_codes(self):
        dev = self.device
        self.codes = self._zeros((self.capacity, self._code_width()),
                                 self._code_dtype())
        self.prefix_t = (
            torch.zeros((self.prefix_words, self.capacity), dtype=torch.int32, device=dev)
            if self.prefix_words else None)
        self.valid = (torch.from_numpy(self._valid_np.copy()).to(dev)
                      if self.mesh is None
                      else shard_array(self._valid_np.copy(), self.mesh))
        self.rescore_rows = (
            self._zeros((self.capacity, self.dim), torch.bfloat16)
            if self.rescore == "device" else None)
        self._hbm_sync()

    def _hbm_sync(self):
        """Publish the device footprint per component: codes (+valid),
        the transposed prefix, bf16 rescore rows, and the PQ codebook."""

        def _set(component, nbytes, dtype):
            hbm_ledger.ledger.set_keyed(
                self._hbm_keys, component + self.component_suffix,
                nbytes, owner=self._hbm_owner, dtype=dtype,
                sharding="single" if self.mesh is None else "sharded")

        _set("codes", int(self.codes.nbytes) + int(self.valid.nbytes),
             "uint8" if self.quantization == "pq" else "uint32")
        _set("prefix", 0 if self.prefix_t is None else int(self.prefix_t.nbytes),
             "uint32")
        _set("rescore_rows",
             0 if self.rescore_rows is None else int(self.rescore_rows.nbytes),
             "bfloat16")
        _set("codebook",
             0 if self.codebook is None else int(self.codebook.centroids.nbytes),
             "float32")

    def _encode(self, vectors: np.ndarray) -> np.ndarray:
        if self.quantization == "pq":
            if self.codebook is None:
                raise RuntimeError("PQ store not trained; call train() first")
            return pq_ops.pq_encode(self.codebook, vectors)
        (codes,) = tracing.d2h(bq_ops.bq_encode(
            torch.from_numpy(np.ascontiguousarray(vectors)).to(self.device)))
        return codes.view(np.uint32)

    def _maybe_norm(self, vectors: np.ndarray) -> np.ndarray:
        if self.normalize_on_add:
            return normalize_np(vectors)
        return vectors

    def _scan_metric(self) -> str:
        return "cosine" if self.metric in ("cosine", "cosine-dot") else self.metric

    # -- training ------------------------------------------------------------

    @property
    def trained(self) -> bool:
        return self.quantization == "bq" or self.codebook is not None

    def train(self, vectors: np.ndarray | None = None, iters: int = 8, seed: int = 0):
        """Fit the PQ codebook on the card (on given vectors or current
        live contents) and (re-)encode everything stored so far."""
        if self.quantization == "bq":
            return
        with self._lock:
            if vectors is None:
                live = np.nonzero(self._valid_np)[0]
                vectors = self._vectors_for(live)
            vectors = self._maybe_norm(np.asarray(vectors, dtype=np.float32))
            self.codebook = pq_ops.pq_fit(
                vectors, m=self.pq_segments, k=self.pq_centroids,
                iters=iters, seed=seed, device=self.device)
            self._reencode_all()
            self._hbm_sync()

    def _vectors_for(self, slots: np.ndarray) -> np.ndarray:
        """Full-precision rows for given slots from whichever tier has them."""
        return self._tier_vectors(self._host_vectors, self.rescore_rows, slots)

    @staticmethod
    def _tier_vectors(host_vectors, rescore_rows, slots: np.ndarray) -> np.ndarray:
        """Tier pick shared by the live path (``_vectors_for``) and the
        async finish step's dispatch-time snapshot."""
        if host_vectors is not None:
            return host_vectors[slots]
        if isinstance(rescore_rows, RowSharded):
            return to_host(rescore_rows.take(slots))
        if rescore_rows is not None:
            idx = torch.from_numpy(np.asarray(slots, dtype=np.int64)).to(rescore_rows.device)
            (rows,) = tracing.d2h(rescore_rows[idx].float())
            return rows
        raise RuntimeError(
            "no full-precision tier (rescore='none') — train() needs explicit vectors")

    def _reencode_all(self, batch: int = 262144):
        live = np.nonzero(self._valid_np)[0]
        for s in range(0, len(live), batch):
            sl = live[s:s + batch]
            rows = self._vectors_for(sl)
            # rows ride along so _write_codes can (re-)derive the PQ sign
            # prefix — a train() after add() must not leave it zeroed
            self._write_codes(sl, self._encode(rows), rows=rows)

    # -- mutation ------------------------------------------------------------

    def add(self, vectors: np.ndarray) -> np.ndarray:
        vectors = np.asarray(vectors, dtype=np.float32)
        if vectors.ndim == 1:
            vectors = vectors[None, :]
        m = len(vectors)
        with self._lock:
            slots = np.arange(self._count, self._count + m, dtype=np.int64)
            self._count += m
            if self._count > self.capacity:
                self._grow(self._count)
            self._write(slots, vectors)
            return slots

    def set_at(self, slots, vectors: np.ndarray):
        slots = np.atleast_1d(np.asarray(slots, dtype=np.int64))
        vectors = np.asarray(vectors, dtype=np.float32)
        with self._lock:
            if len(slots) and int(slots.max()) >= self.capacity:
                self._grow(int(slots.max()) + 1)
            self._count = max(self._count, int(slots.max()) + 1 if len(slots) else 0)
            self._write(slots, vectors)

    def _write(self, slots: np.ndarray, vectors: np.ndarray):
        vectors = self._maybe_norm(vectors)
        if self._host_vectors is not None:
            self._host_vectors[slots] = vectors
        self._valid_np[slots] = True
        codes = self._encode(vectors) if self.trained else None
        self._write_codes(slots, codes, rows=vectors)

    def _write_codes(self, slots: np.ndarray, codes: np.ndarray | None,
                     rows: np.ndarray | None, pref: np.ndarray | None = None):
        """Write codes (and the prefix, and bf16 rescore rows) into the
        device tensors in place (``index_copy_``: the JAX package's
        donated scatters)."""
        if (pref is None and rows is not None and self.prefix_words
                and self.quantization == "pq" and codes is not None):
            # the PQ prefix comes from the raw vectors' sign bits, not the
            # codes (the BQ store slices its own codes instead)
            (pref,) = tracing.d2h(bq_ops.bq_encode(torch.from_numpy(
                np.ascontiguousarray(np.asarray(rows)[:, :self.prefix_words * 32])
            ).to(self.device)))
        m = len(slots)
        if m == 0:
            return
        if self.mesh is not None:  # each row to the shard that owns its slot
            if codes is not None:
                self.codes.index_copy_(slots, torch.from_numpy(_as_i32(codes)))
            self.valid.index_fill_(slots, True)
            if self.rescore_rows is not None and rows is not None:
                self.rescore_rows.index_copy_(slots, torch.from_numpy(
                    np.ascontiguousarray(rows, dtype=np.float32)).to(torch.bfloat16))
            return
        dev = self.device
        idx = torch.from_numpy(np.asarray(slots, dtype=np.int64)).to(dev)
        if codes is not None:
            ct = torch.from_numpy(_as_i32(codes)).to(dev)
            self.codes.index_copy_(0, idx, ct)
            self.valid.index_fill_(0, idx, True)
            if self.prefix_t is not None:
                if self.quantization == "bq":
                    pcols = ct[:, :self.prefix_words].T
                elif pref is not None:
                    pcols = torch.from_numpy(_as_i32(
                        np.asarray(pref)[:, :self.prefix_words])).to(dev).T
                else:
                    pcols = torch.zeros((self.prefix_words, m), dtype=torch.int32,
                                        device=dev)
                self.prefix_t.index_copy_(1, idx, pcols.contiguous())
        else:
            self.valid.index_fill_(0, idx, True)
        if self.rescore_rows is not None and rows is not None:
            self.rescore_rows.index_copy_(0, idx, torch.from_numpy(
                np.ascontiguousarray(rows, dtype=np.float32)).to(dev).to(torch.bfloat16))

    def _grow(self, min_capacity: int):
        """Capacity-double codes/valid/mirrors. Caller holds ``_lock``."""
        new_cap = self._align(_next_pow2(min_capacity))
        if new_cap <= self.capacity:
            return
        old_cap = self.capacity
        pad = new_cap - old_cap
        grown_m = np.zeros(new_cap, dtype=bool)
        grown_m[:old_cap] = self._valid_np
        self._valid_np = grown_m
        if self._host_vectors is not None:
            grown_v = np.zeros((new_cap, self.dim), dtype=np.float32)
            grown_v[:old_cap] = self._host_vectors
            self._host_vectors = grown_v

        def rows_padded(a):
            if self.mesh is not None:
                return grow_rows(a, pad, self.mesh)
            return torch.cat([a, torch.zeros((pad,) + tuple(a.shape[1:]),
                                             dtype=a.dtype, device=a.device)])

        self.capacity = new_cap
        self.codes = rows_padded(self.codes)
        self.valid = rows_padded(self.valid)
        if self.rescore_rows is not None:
            self.rescore_rows = rows_padded(self.rescore_rows)
        if self.prefix_t is not None:
            self.prefix_t = torch.nn.functional.pad(self.prefix_t, (0, pad))
        self._hbm_sync()

    def set_at_prenormalized(self, slots, vectors: np.ndarray):
        """set_at for vectors already normalized at their original insert
        (restore/compact/compress paths) — skips re-normalization."""
        orig = self.normalize_on_add
        self.normalize_on_add = False
        try:
            self.set_at(slots, vectors)
        finally:
            self.normalize_on_add = orig

    def delete(self, slots) -> None:
        slots = np.atleast_1d(np.asarray(slots, dtype=np.int64))
        if len(slots) == 0:
            return
        with self._lock:
            self._valid_np[slots] = False
            if self.mesh is not None:
                self.valid.index_fill_(slots, False)
            else:
                self.valid.index_fill_(0, torch.from_numpy(slots).to(self.device), False)

    # -- queries -------------------------------------------------------------

    @property
    def count(self) -> int:
        return self._count

    def live_count(self) -> int:
        return int(self._valid_np.sum())

    def get(self, slots) -> np.ndarray:
        slots = np.atleast_1d(np.asarray(slots, dtype=np.int64))
        return self._vectors_for(slots).copy()

    def _scan(self, queries_dev: torch.Tensor, k_cand: int, valid,
              allow_bits=None, reduce_l: int | None = None,
              k_out: int | None = None):
        """Dispatch the compressed scan; ``allow_bits`` [B, C/32] int32
        packed per-query allow words. ``reduce_l`` overrides the one-pass
        scans' strided reduction (default: from this store's capacity).

        On a mesh this is ``sharded_quantized_topk``: ``allow_bits`` is
        then the column-sharded bool rows, each shard scans ``k_cand``
        candidates of its own rows (its reduction from its own rows), the
        ``"device"`` rows rescore them inline, and ``k_out`` survive the
        merge."""
        cs = min(self.chunk_size, self.capacity // self.n_shards)
        metric = self._scan_metric()
        if self.mesh is not None:
            pq4 = self.quantization == "pq" and self.pq_centroids <= 16
            return sharded_quantized_topk(
                queries_dev,
                bq_ops.bq_encode(queries_dev) if self.quantization == "bq" else None,
                self.codes, valid, self.rescore_rows,
                None if self.codebook is None else self.codebook.centroids,
                k=min(k_cand, self.capacity // self.n_shards),
                k_out=k_cand if k_out is None else k_out, chunk_size=cs,
                quantization="bq" if self.quantization == "bq" else (
                    "pq4" if pq4 else "pq"),
                metric=metric, mesh=self.mesh, use_pallas=self.use_pallas,
                selection=self.selection, allow_rows=allow_bits)
        if self.quantization == "pq":
            cent = self.codebook.centroids
            if self.prefix_t is not None:
                qp = bq_ops.bq_encode(queries_dev[:, :self.prefix_words * 32])
                return pq_ops.pq_topk_twostage(
                    queries_dev, qp, self.codes, cent, self.prefix_t,
                    k=k_cand, refine=max(2, self.rescore_limit // 2),
                    metric=metric, valid=valid, m=self.pq_segments,
                    use_pallas=self.use_pallas, selection=self.selection,
                    allow_bits=allow_bits)
            if self.pq_centroids <= 16:
                return pq_ops.pq4_topk(
                    queries_dev, self.codes, cent, k=k_cand, chunk_size=cs,
                    metric=metric, valid=valid, selection=self.selection,
                    allow_bits=allow_bits, reduce_l=reduce_l)
            return pq_ops.pq_topk(
                queries_dev, self.codes, cent, k=k_cand, chunk_size=cs,
                metric=metric, valid=valid, allow_bits=allow_bits)
        qw = bq_ops.bq_encode(queries_dev)
        if self.prefix_t is not None:
            return bq_ops.bq_topk_twostage(
                qw, self.codes, self.prefix_t, k=k_cand,
                refine=max(2, self.rescore_limit // 2), valid=valid,
                use_pallas=self.use_pallas, selection=self.selection,
                allow_bits=allow_bits)
        return bq_ops.bq_topk(
            qw, self.codes, k=k_cand, chunk_size=cs, valid=valid,
            use_pallas=self.use_pallas, selection=self.selection,
            allow_bits=allow_bits, reduce_l=reduce_l)

    def rescore_mode(self) -> str:
        """Where the exact rescore happens: ``"inline"`` (a mesh's bf16
        rows: each shard rescores its candidates inside the scan, the
        distances come out exact), ``"plane"`` (bf16 rows on the card: the
        oversampled candidates rescore there), ``"post"`` (oversampled
        candidates come back for a host rescore), or ``"none"``
        (code-distance order is the contract)."""
        if self.rescore == "device" and self.mesh is not None:
            return "inline"
        if self.rescore == "device" and self.rescore_rows is not None:
            return "plane"
        if self._host_vectors is not None:
            return "post"
        return "none"

    def epoch_scan(self, queries: np.ndarray, k_cand: int,
                   allow_mask: np.ndarray | None = None,
                   pre_normalized: bool = False, reduce_l: int | None = None,
                   k_out: int | None = None):
        """Dispatch-only compressed scan for the epoch store: the
        candidates stay on the device with store-local ids for the
        cross-epoch merge; the one global host rescore runs in the epoch
        store's finish step against the returned dispatch-time tier
        snapshot. ``pre_normalized`` skips the query normalization when
        the epoch store normalized once for every epoch (normalizing per
        epoch would not be bit for bit the single store's). ``reduce_l``
        is the strided reduction of the whole stack's slot space (see
        ``EpochStore``; a mesh's shards take their own). ``k_out`` is what
        survives a mesh's merge (default ``k_cand``). Returns
        ``(d, i, tiers)``."""
        queries = np.asarray(queries, dtype=np.float32)
        if not pre_normalized:
            queries = self._maybe_norm(queries)
        if not torch.is_tensor(allow_mask):  # else [B, cap] rows on the device
            allow_mask = normalize_allow_mask(allow_mask, len(queries))
        with self._lock:
            if not self.trained:
                raise RuntimeError("PQ store not trained; call train() first")
            capacity = self.capacity
            valid = self.valid
            allow_bits = None
            if allow_mask is not None and allow_mask.ndim == 2:
                allow_bits = batched_mask_operands(
                    allow_mask, len(queries), capacity, self.device,
                    owner=self._hbm_owner, mesh=self.mesh)
            elif allow_mask is not None:
                full = np.zeros(capacity, dtype=bool)
                w = min(len(allow_mask), capacity)
                full[:w] = allow_mask[:w]
                valid = and_mask(valid, full, self.mesh)
            q_dev = torch.from_numpy(np.ascontiguousarray(queries)).to(self.device)
            d, i = self._scan(q_dev, min(k_cand, capacity), valid,
                              allow_bits=allow_bits, reduce_l=reduce_l,
                              k_out=None if k_out is None else min(k_out, capacity))
            tiers = (self._host_vectors, self.rescore_rows)
        return d, i, tiers

    def search(self, queries: np.ndarray, k: int, allow_mask: np.ndarray | None = None):
        """Two stages: compressed scan (oversampled) -> exact rescore
        (reference BQ rescore: flat/index.go:347). ``allow_mask`` is a
        shared [capacity] bool mask or per-query [B, capacity] masks packed
        into a bitmask the scan kernels read. This is
        ``search_async(...).result()``."""
        return self.search_async(queries, k, allow_mask).result()

    def search_async(self, queries: np.ndarray, k: int,
                     allow_mask: np.ndarray | None = None) -> DeviceResultHandle:
        """Dispatch-only twin of ``search``: the compressed scan launches
        under ``_lock``; the oversampled candidates stay on the card in
        the returned handle, whose finish step runs the exact host rescore
        when this store's rescore mode needs one."""
        queries = np.asarray(queries, dtype=np.float32)
        squeeze = queries.ndim == 1
        if squeeze:
            queries = queries[None, :]
        queries = self._maybe_norm(queries)
        allow_mask = normalize_allow_mask(allow_mask, len(queries))
        mode = self.rescore_mode()
        inline_rescore = mode == "inline"
        plane_rescore = mode == "plane"
        post_rescore = mode == "post"
        with tracing.span("store.quantized_scan", rows=self.capacity,
                          queries=len(queries), k=k,
                          quantization=self.quantization,
                          sharded=self.mesh is not None) as sp:
            with self._lock:
                if not self.trained:
                    raise RuntimeError("PQ store not trained; call train() first")
                capacity = self.capacity
                valid = self.valid
                allow_bits = None
                if allow_mask is not None and allow_mask.ndim == 2:
                    sp.set(path="bitmask_batched")
                    allow_bits = batched_mask_operands(
                        allow_mask, len(queries), capacity, self.device,
                        owner=self._hbm_owner, mesh=self.mesh)
                elif allow_mask is not None:
                    full = np.zeros(capacity, dtype=bool)
                    full[: len(allow_mask)] = allow_mask[:capacity]
                    valid = and_mask(valid, full, self.mesh)
                if post_rescore or plane_rescore or inline_rescore:
                    k_cand = min(max(k * self.rescore_limit, k), capacity)
                else:
                    k_cand = min(k, capacity)
                # inline: the shards' rescored candidates merge to k
                k_out = min(k, capacity) if inline_rescore else k_cand
                # EXPLAIN: host ints only (no device reads), a no-op
                # when nobody asked — the rescore plan of this dispatch
                kernelscope.explain_note(
                    "quantized", quantization=str(self.quantization),
                    rescore_mode=mode, k_cand=k_cand, rows=capacity,
                    queries=len(queries), k=k,
                    path=("bitmask_batched" if allow_bits is not None
                          else "shared_mask" if allow_mask is not None
                          else "full_scan"))
                q_dev = torch.from_numpy(np.ascontiguousarray(queries)).to(self.device)
                d, i = self._scan(q_dev, k_cand, valid, allow_bits=allow_bits,
                                  k_out=k_out)
                if plane_rescore:
                    # the full-precision tier is already on the card: the
                    # oversampled candidates rescore there
                    sp.set(path="device_plane_rescore")
                    d, i = gather_rescore_topk(q_dev, i, self.rescore_rows,
                                               min(k, k_cand), self._scan_metric())
                # dispatch-time snapshot for the finish step's rescore: the
                # candidate slots mean something only against THIS row
                # layout (compact()/_grow() replace the tiers wholesale)
                rescore_tiers = (self._host_vectors, self.rescore_rows)

        def _finish(d_np, i_np, _queries=queries, _k=k, _squeeze=squeeze,
                    _post=post_rescore, _cap=capacity, _tiers=rescore_tiers):
            i_np = i_np.astype(np.int64, copy=False)
            if _post:
                with tracing.span("store.host_rescore",
                                  candidates=int(i_np.shape[1])):
                    d_np, i_np = self._host_rescore(
                        _queries, i_np, _k, capacity=_cap, tiers=_tiers)
            out_d = d_np[:, :_k].astype(np.float32)
            out_i = i_np[:, :_k]
            if _squeeze:
                return out_d[0], out_i[0]
            return out_d, out_i

        return DeviceResultHandle(
            (d, i), finish=_finish,
            attrs={"rows": capacity, "queries": len(queries), "k": k,
                   "quantization": self.quantization})

    def _host_rescore(self, queries: np.ndarray, cand_ids: np.ndarray,
                      k: int, capacity: int | None = None, tiers=None):
        """Vectorized exact rescore: a gather + a batched distance over
        [B, k_cand, d] (no per-query Python loop), then the top k.
        ``capacity`` / ``tiers`` (host rows, device bf16 rows) pin the row
        layout the candidate ids were scanned against (the async finish
        step passes its dispatch-time snapshot); defaults read the live
        store.

        The reference's arithmetic on the same rows: the same ``einsum``
        per metric, the ``cand_ids >= 0`` mask, ``argpartition`` and the
        stable ``argsort``, -1 ids past the live candidates. Only how the
        work is cut changes: the host tier's rows are gathered and scored
        in blocks of queries on up to RESCORE_THREADS host threads, a
        chunk of RESCORE_CHUNK_BYTES at a time into a scratch buffer that
        stays in cache. No (b, k) sum and no row's selection depends on
        the block it falls in, so the answer is the reference's bit for
        bit (tests/test_torch_bq_scan.py holds the two equal). The spans
        ``store.host_rescore.rows`` (gather and distance, with the threads'
        summed ``gather_ms`` / ``distance_ms``) and
        ``store.host_rescore.select`` time the stages."""
        b, kc = cand_ids.shape
        cap = self.capacity if capacity is None else capacity
        host_vectors, rescore_rows = (self._host_vectors, self.rescore_rows) \
            if tiers is None else tiers
        safe = np.clip(cand_ids, 0, cap - 1)
        metric = "cosine" if self.metric in ("cosine", "cosine-dot") else self.metric

        def distance(lo, hi, cand):  # queries [lo, hi) against their rows
            q = queries[lo:hi]
            if metric == "dot":
                dd = -np.einsum("bd,bkd->bk", q, cand)
            elif metric == "cosine":
                dd = 1.0 - np.einsum("bd,bkd->bk", q, cand)
            else:
                diff = q[:, None, :] - cand
                dd = np.einsum("bkd,bkd->bk", diff, diff)
            return np.where(cand_ids[lo:hi] >= 0, dd, np.float32(3.0e38))

        def block(lo, hi):  # gather and score queries [lo, hi), chunk by chunk
            per = max(1, RESCORE_CHUNK_BYTES // max(1, kc * self.dim * 4))
            scratch = np.empty((min(per, hi - lo) * kc, self.dim), dtype=host_vectors.dtype)
            parts, t_gather, t_dist = [], 0.0, 0.0
            for s0 in range(lo, hi, per):
                s1 = min(hi, s0 + per)
                rows = scratch[:(s1 - s0) * kc]
                t0 = time.perf_counter()
                # ids are in range: mode "clip" copies them as indexing does,
                # without the temporary that mode "raise" makes for ``out``
                np.take(host_vectors, safe[s0:s1].reshape(-1), axis=0, out=rows, mode="clip")
                t1 = time.perf_counter()
                parts.append(distance(s0, s1, rows.reshape(s1 - s0, kc, self.dim)))
                t_gather, t_dist = t_gather + t1 - t0, t_dist + time.perf_counter() - t1
            return parts, t_gather, t_dist

        with tracing.span("store.host_rescore.rows", rows=b * kc) as sp:
            if host_vectors is not None:
                n_blocks = min(RESCORE_THREADS, -(-b * kc * self.dim // RESCORE_BLOCK_ELEMS))
                done = _run_blocks(block, _row_blocks(b, n_blocks))
                dd = np.concatenate([p for parts, _, _ in done for p in parts] or
                                    [np.empty((0, kc), np.float32)])
                sp.set(blocks=len(done), gather_ms=sum(d[1] for d in done) * 1e3,
                       distance_ms=sum(d[2] for d in done) * 1e3)
            else:  # the device bf16 tier: one fetch, one block
                dd = distance(0, b, self._tier_vectors(host_vectors, rescore_rows,
                                                       safe.reshape(-1)).reshape(b, kc, self.dim))
        with tracing.span("store.host_rescore.select", k=min(k, kc)):
            k_eff = min(k, kc)
            part = np.argpartition(dd, k_eff - 1, axis=1)[:, :k_eff]
            pd = np.take_along_axis(dd, part, axis=1)
            order = np.argsort(pd, axis=1, kind="stable")
            sel = np.take_along_axis(part, order, axis=1)
            out_d = np.take_along_axis(dd, sel, axis=1).astype(np.float32)
            out_i = np.take_along_axis(cand_ids, sel, axis=1)
            out_i = np.where(out_d >= np.float32(3.0e38), -1, out_i)
        return out_d, out_i

    def search_by_distance(self, query: np.ndarray, max_distance: float,
                           allow_mask: np.ndarray | None = None):
        return range_search(self, query, max_distance, allow_mask)

    # -- maintenance / persistence -------------------------------------------

    def compact(self) -> np.ndarray:
        with tracing.span("store.compact", rows=self.capacity,
                          quantization=self.quantization), self._lock:
            live = np.nonzero(self._valid_np)[0]
            mapping = np.full(self.capacity, -1, dtype=np.int64)
            mapping[live] = np.arange(len(live))
            vecs = self._vectors_for(live) if len(live) else np.zeros(
                (0, self.dim), np.float32)
            self._count = 0
            self.capacity = self._align(max(len(live), 1))
            self._valid_np = np.zeros(self.capacity, dtype=bool)
            if self._host_vectors is not None:
                self._host_vectors = np.zeros(
                    (self.capacity, self.dim), dtype=np.float32)
            self._alloc_codes()
            if len(live):
                self.set_at_prenormalized(np.arange(len(live)), vecs)
            return mapping

    def snapshot(self) -> dict:
        """Host-side snapshot, the same dict as the JAX store's (codes as
        uint8 / uint32, the codebook as a [m, k, ds] f32 array)."""
        with self._lock:
            snap = {
                "valid": self._valid_np.copy(),
                "count": self._count,
                "dim": self.dim,
                "metric": self.metric,
                "quantization": self.quantization,
                "pq_segments": self.pq_segments,
                "pq_centroids": self.pq_centroids,
                "rescore_limit": self.rescore_limit,
                "rescore": self.rescore,
                "selection": self.selection,
                "prefix_bits": self.prefix_words * 32,
                "chunk_size": self.chunk_size,
                "codebook": (None if self.codebook is None
                             else tracing.d2h(self.codebook.centroids)[0]),
            }
            if self._host_vectors is not None:
                snap["vectors"] = self._host_vectors.copy()
            elif self.rescore == "device":
                snap["vectors"] = to_host(self.rescore_rows)
            else:
                snap["codes"] = _as_u32(to_host(self.codes))
                if self.prefix_t is not None and self.quantization == "pq":
                    # PQ prefixes derive from the raw vectors — a
                    # codes-only snapshot must carry them explicitly
                    (pt,) = tracing.d2h(self.prefix_t)
                    snap["prefix_t"] = _as_u32(pt)
            return snap

    @classmethod
    def restore(cls, snap: dict, mesh=None, **kwargs) -> "QuantizedVectorStore":
        kwargs.setdefault("rescore", snap.get("rescore", "host"))
        kwargs.setdefault("selection", snap.get("selection", "approx"))
        if snap.get("prefix_bits"):
            kwargs.setdefault("prefix_bits", snap["prefix_bits"])
        store = cls(
            dim=snap["dim"],
            metric=snap["metric"],
            quantization=snap["quantization"],
            capacity=max(len(snap["valid"]), 2),
            chunk_size=snap["chunk_size"],
            pq_segments=snap["pq_segments"],
            pq_centroids=snap["pq_centroids"],
            rescore_limit=snap["rescore_limit"],
            mesh=mesh,
            **kwargs,
        )
        if snap.get("codebook") is not None:
            store.codebook = pq_ops.PQCodebook(torch.from_numpy(np.ascontiguousarray(
                snap["codebook"], dtype=np.float32)).to(store.device))
        live = np.nonzero(snap["valid"])[0]
        if len(live):
            if "vectors" in snap:
                store.set_at_prenormalized(live, np.asarray(snap["vectors"])[live])
            else:
                # codes-only snapshot: restore codes directly
                store._valid_np[live] = True
                store._write_codes(live, np.asarray(snap["codes"])[live], rows=None)
                if snap.get("prefix_t") is not None and store.prefix_t is not None:
                    pt = np.asarray(snap["prefix_t"], dtype=np.uint32)
                    pt = np.pad(pt, ((0, 0), (0, store.capacity - pt.shape[1])))
                    store.prefix_t = torch.from_numpy(_as_i32(pt)).to(store.device)
        store._count = snap["count"]
        store._hbm_sync()  # codebook/prefix set after __init__'s sync
        return store
