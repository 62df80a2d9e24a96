"""IVF (inverted-file) ANN index (port of ``weaviate_tpu/engine/ivf.py``).

The reference's ANN is HNSW (vector/hnsw/index.go), a pointer-chasing
graph walk. The JAX package adds IVF partitioning as its batched ANN, and
the port carries it over on the card:

- **train**: coarse k-means over the corpus (ops/kmeans.py).
- **layout**: posting lists as ONE dense padded tensor ``[nlist, cap, d]``
  on the device (+ valid mask, slot ids, cached norms), so a probe is a
  static-shape gather, not ragged pointer chasing.
- **search**: query->centroid distances -> top-nprobe lists (ties to the
  lower list) -> the candidate plane (ops/candidates.py): one gather and
  one batched product over the probed rows, per-query ``allow_bits``
  folded per candidate, exact top-k. ``search_async`` returns a
  ``DeviceResultHandle`` and ``search`` is its ``.result()``, so sync and
  async agree bit for bit.
- **residual PQ** (quantization="pq"): the lists hold uint8 codes of the
  residual ``r = x - centroid[assign]``; the probe scores candidates by
  an integer ADC (``||q-c||^2 - 2 q.r^ + t_row`` with ``t_row = 2 c.r^ +
  ||r^||^2`` cached per row) and the oversampled candidates rescore
  exactly against a device tier of the full rows. A host f32 mirror
  serves retraining, rebuilds and persistence.
- **delta buffer**: recent inserts land in a small brute-force scanned
  ``DeviceVectorStore`` (exact; ``distance_block`` and
  ``fused_topk_pairs`` on the card), merged into the lists when it fills.

Deletes tombstone rows and record the hole (list, pos); later scatters
refill holes before the tail, and a row whose home list is full spills to
the next-nearest centroid with room. ``compact()`` folds the delta in
without a rebuild, and ``maintain()`` retrains only past a drift proxy
(the live count grew ``retrain_factor`` x since training).

Where the JAX package donates buffers to a jitted scatter, the port
writes the same tensors in place (``index_copy_`` / ``index_fill_``);
rows the JAX scatter drops by writing out of bounds are never selected
here. ``IVFIndex`` reuses the ``FlatIndex`` id<->slot bookkeeping over
the ``IVFStore`` (global slot ids are stable across flushes).
"""

from __future__ import annotations

import math
import threading
import weakref

import numpy as np
import torch

from weaviate_tpu_torch.device import resolve
from weaviate_tpu_torch.engine.flat import FlatIndex
from weaviate_tpu_torch.engine.store import (DeviceVectorStore, _next_pow2,
                                             batched_mask_operands,
                                             normalize_allow_mask,
                                             storage_dtype)
from weaviate_tpu_torch.ops.candidates import gather_rescore_topk
from weaviate_tpu_torch.ops.distances import (MASKED_DISTANCE, normalize,
                                              normalize_np, pairwise_distance)
from weaviate_tpu_torch.ops.kernels import (allow_bits_for_ids, as_bits_tensor,
                                            mask_pad_cols, pack_allow_bitmask,
                                            smallest_positions)
from weaviate_tpu_torch.ops.kmeans import kmeans_assign, kmeans_fit
from weaviate_tpu_torch.ops.topk import topk_smallest
from weaviate_tpu_torch.runtime import hbm_ledger, kernelscope, tracing
from weaviate_tpu_torch.runtime.transfer import DeviceResultHandle

_SUPPORTED_METRICS = ("l2-squared", "dot", "cosine", "cosine-dot")
# int64 gather indices per step of the PQ probe's ADC (the JAX probe
# bounds its one-hot transient the same way)
_ADC_STEP_ELEMS = 1 << 27


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _scatter_lists(list_vecs, list_valid, list_slots, list_norms,
                   flat_idx, vecs, slots) -> None:
    """Write rows into the flattened [nlist*cap] list tensors in place.
    Norms come from the rows as stored (bf16 storage rounds first)."""
    nlist, cap, dim = list_vecs.shape
    idx = flat_idx.to(torch.int64)
    vecs = vecs.to(list_vecs.dtype)
    list_vecs.view(nlist * cap, dim).index_copy_(0, idx, vecs)
    list_valid.view(-1).index_fill_(0, idx, True)
    list_slots.view(-1).index_copy_(0, idx, slots.to(torch.int32))
    list_norms.view(-1).index_copy_(0, idx, (vecs.float() ** 2).sum(dim=-1))


def _clear_list_rows(list_valid, flat_idx) -> None:
    list_valid.view(-1).index_fill_(0, flat_idx.to(torch.int64), False)


def _scatter_code_lists(list_codes, list_valid, list_slots, list_tvals,
                        flat_idx, codes, tvals, slots) -> None:
    """PQ-mode scatter in place: residual codes [m] uint8 + the per-row
    ADC constant ``t_row`` into the [nlist, cap, ...] list tensors."""
    nlist, cap, m = list_codes.shape
    idx = flat_idx.to(torch.int64)
    list_codes.view(nlist * cap, m).index_copy_(0, idx, codes)
    list_valid.view(-1).index_fill_(0, idx, True)
    list_slots.view(-1).index_copy_(0, idx, slots.to(torch.int32))
    list_tvals.view(-1).index_copy_(0, idx, tvals)


def _probe_lists(q32, centroids, c_norms, nprobe: int):
    """Centroid distances [B, nlist] and the nprobe nearest lists per
    query (ties to the lower list, as ``lax.top_k`` picks them)."""
    cd = pairwise_distance(q32, centroids, metric="l2-squared",
                           x_sq_norms=c_norms)
    return cd, smallest_positions(cd, nprobe)


def _ivf_probe_topk_pq(q, centroids, c_norms, list_codes, list_valid,
                       list_slots, list_tvals, pq_centroids, allow_bits,
                       k: int, nprobe: int, metric: str):
    """Residual-PQ probe: gather CODES from the probed lists and score by
    residual ADC. Codes encode ``r = x - centroid[assign]``, so

        l2:     ||q-c-r^||^2 = ||q-c||^2 - 2 q.r^ + (2 c.r^ + ||r^||^2)
        dot:    -q.x^        = -q.c      -   q.r^
        cosine: 1 - q.x^     = 1 + (-q.c -   q.r^)

    The only data-dependent part, ``q.r^``, is an integer sum of int8
    table entries (``ops/kernels.quantize_lut_int8``, the table the JAX
    probe quantizes with): the JAX package sums them through a one-hot
    int8 product into int32, the port gathers them by code and sums in
    int32 -- the same integers -- then divides by the table's scale in
    f32. ADC order is approximate; callers rescore the oversample
    exactly. ``allow_bits`` [B or 1, W] (None = unfiltered) folds per
    candidate. Returns (dists [B, k'], slots [B, k']) ascending, masked
    winners -1."""
    from weaviate_tpu_torch.ops.pq import quantize_lut_int8

    nlist, cap, m = list_codes.shape
    b = q.shape[0]
    q32 = q.float()
    if metric in ("cosine", "cosine-dot"):
        q32 = normalize(q32)
    cd, probes = _probe_lists(q32, centroids, c_norms, nprobe)
    cd_p = torch.gather(cd, 1, probes)  # ||q-c||^2 per probe

    codes = list_codes[probes].reshape(b, nprobe * cap, m)
    vld = list_valid[probes].reshape(b, nprobe * cap)
    slots = list_slots[probes].reshape(b, nprobe * cap)
    tval = list_tvals[probes].reshape(b, nprobe * cap)
    p = codes.shape[1]
    # residual table: factor * q_seg . codeword (-2 for l2, -1 for the
    # dot family); no qn/cn terms, those live in base/t_row
    ds = pq_centroids.shape[2]
    qs = q32.reshape(b, m, ds)
    rdots = torch.einsum("bms,mks->bmk", qs, pq_centroids.float())
    lut = (-2.0 if metric == "l2-squared" else -1.0) * rdots
    lut8, scale = quantize_lut_int8(lut)  # [B, kc*m], lane c*m + s
    lut32 = lut8.to(torch.int32)
    seg = torch.arange(m, device=q.device)
    pc = max(256, min(p, _ADC_STEP_ELEMS // (m * max(b, 1))))
    sums = []
    for s in range(0, p, pc):
        lane = codes[:, s:s + pc].to(torch.int64) * m + seg  # [B, Pc, m]
        g = torch.gather(lut32, 1, lane.reshape(b, -1)).reshape(lane.shape)
        sums.append(g.sum(dim=2, dtype=torch.int32))
    d8 = sums[0] if len(sums) == 1 else torch.cat(sums, dim=1)
    adc = d8.float() / scale[:, None]  # ~ factor * q.r^
    if metric == "l2-squared":
        d = torch.clamp(cd_p.repeat_interleave(cap, dim=1) + adc + tval,
                        min=0.0)
    else:
        qn = (q32 * q32).sum(dim=-1, keepdim=True)
        base = -0.5 * (qn + c_norms[probes] - cd_p)  # = -q.c per probe
        d = base.repeat_interleave(cap, dim=1) + adc
        if metric != "dot":
            d = 1.0 + d
    if allow_bits is not None:
        vld = vld & allow_bits_for_ids(allow_bits, slots)
    d = torch.where(vld, d, torch.full_like(d, MASKED_DISTANCE))
    td, ts = topk_smallest(d, slots, min(k, p))
    # masked rows keep their slot through the selection: drop them here
    # or the exact rescore downstream would resurrect them
    return td, torch.where(td >= MASKED_DISTANCE, torch.full_like(ts, -1), ts)


def _ivf_probe_topk(q, centroids, c_norms, list_vecs, list_valid, list_slots,
                    list_norms, allow_bits, k: int, nprobe: int, metric: str):
    """Full-rows probe: q [B,d] -> centroid distances [B,nlist] ->
    top-nprobe -> the flattened probed positions feed the candidate plane
    (ops/candidates.py), which gathers, scores, folds per-query
    ``allow_bits`` (None = unfiltered) per candidate and selects exactly.
    Returns (dists [B,k'], slots [B,k']) ascending; dead and filtered
    rows never surface. Memory is O(B * nprobe * cap * d): callers chunk
    B."""
    nlist, cap, dim = list_vecs.shape
    b = q.shape[0]
    q32 = q.float()
    if metric in ("cosine", "cosine-dot"):
        q32 = normalize(q32)
    _, probes = _probe_lists(q32, centroids, c_norms, nprobe)
    pos = torch.arange(cap, dtype=torch.int64, device=q.device)
    flat = (probes[:, :, None] * cap + pos).reshape(b, nprobe * cap)
    return gather_rescore_topk(
        q32, flat, list_vecs.view(nlist * cap, dim), k, metric,
        ids_of_row=list_slots.view(nlist * cap),
        row_norms=list_norms.view(nlist * cap),
        valid=list_valid.view(nlist * cap), allow_bits=allow_bits)


class IVFStore:
    """DeviceVectorStore-compatible store backed by IVF posting lists plus
    a brute-force delta buffer, on ``device`` (default: the card). Slot
    ids are append-order and stable."""

    mesh = None  # one device; collection sharding distributes IVF

    def __init__(self, dim: int, metric: str = "l2-squared",
                 capacity: int = 8192, chunk_size: int = 8192,
                 nlist: int = 0, nprobe: int = 0,
                 train_threshold: int = 16_384,
                 delta_threshold: int = 8192,
                 query_chunk: int = 16,
                 dtype=None,
                 quantization: str | None = None,
                 pq_segments: int | None = None,
                 pq_centroids: int = 16,
                 rescore_limit: int = 16,
                 retrain_factor: float = 4.0,
                 device=None):
        if metric not in _SUPPORTED_METRICS:
            raise ValueError(
                f"ivf supports {_SUPPORTED_METRICS}, not {metric!r}")
        if quantization not in (None, "pq"):
            raise ValueError(f"ivf quantization must be None or 'pq', "
                             f"not {quantization!r}")
        self.device = resolve(device)
        self.dim = dim
        self.metric = metric
        self.chunk_size = chunk_size
        self.dtype = storage_dtype(dtype)
        self.nlist = nlist  # 0 = auto at train time
        self.nprobe = nprobe  # 0 = auto (nlist/8, min 8)
        self.train_threshold = train_threshold
        self.delta_threshold = delta_threshold
        self.query_chunk = query_chunk
        # residual IVF-PQ residency: lists hold uint8 codes of x -
        # centroid[assign]; oversampled candidates rescore exactly against
        # the _rescore_rows tier. The host f32 mirror serves retraining,
        # rebuilds and persistence only. The delta stays exact either way.
        self.quantization = quantization
        self.pq_centroids = pq_centroids
        if quantization and not pq_segments:
            from weaviate_tpu_torch.ops.pq import default_pq_segments

            pq_segments = default_pq_segments(dim, pq_centroids)
        self.pq_segments = pq_segments
        self.rescore_limit = rescore_limit
        self.retrain_factor = retrain_factor
        self.codebook = None
        self.list_codes = None
        self.list_tvals = None  # [nlist, cap] f32 per-row ADC constant
        self._host_rows = (
            np.zeros((max(capacity, 1024), dim), dtype=np.float32)
            if quantization else None)
        self._rescore_rows = None  # device [pow2, d] exact-rescore tier
        self.normalize_on_add = metric in ("cosine", "cosine-dot")
        self._lock = threading.RLock()
        self._count = 0  # global slot high-water mark
        # maintenance counters: compaction must not rebuild, retrain only
        # past the drift proxy
        self.rebuild_count = 0
        self.retrain_count = 0
        self._live_at_train = 0
        # memory ledger: centroid + list tensors publish under the owner
        # captured here; the delta store accounts for itself
        self._hbm_owner = hbm_ledger.current_owner()
        self._hbm_keys: dict[str, int] = {}
        weakref.finalize(self, hbm_ledger.ledger.release_many,
                         self._hbm_keys.values())
        # delta buffer (exact scan); delta slot -> global slot
        self.delta = DeviceVectorStore(
            dim, metric, capacity=min(capacity, delta_threshold * 2),
            chunk_size=chunk_size, device=self.device)
        self._delta_slots: dict[int, int] = {}
        # slot -> ("delta", dslot) | ("list", flat_idx)
        self._slot_loc: dict[int, tuple] = {}
        # list tensors (allocated at train time)
        self.centroids = None  # [nlist, d] on the device
        self._centroids_np = None  # host twin (assign/residuals/spill)
        self._c_norms = None
        self.list_vecs = None  # [nlist, cap, d]
        self.list_valid = None
        self.list_slots = None
        self.list_norms = None
        self.list_cap = 0
        self._fill: np.ndarray | None = None  # host per-list fill count
        # freed (list, pos) positions, refilled LIFO before the tail grows
        # (positions survive cap growth, flat indices would not)
        self._holes: dict[int, list[int]] = {}

    def _hbm_sync(self):
        """Publish centroid + list + rescore-tier device bytes and the
        host mirror (host tier) to the ledger."""
        cent = 0 if self.centroids is None else (
            int(self.centroids.nbytes) + int(self._c_norms.nbytes))
        hbm_ledger.ledger.set_keyed(
            self._hbm_keys, "centroids", cent, owner=self._hbm_owner,
            dtype="float32")
        lists = sum(int(a.nbytes) for a in (
            self.list_vecs, self.list_codes, self.list_norms,
            self.list_tvals, self.list_valid, self.list_slots)
            if a is not None)
        hbm_ledger.ledger.set_keyed(
            self._hbm_keys, "lists", lists, owner=self._hbm_owner,
            dtype=("uint8" if self.quantization else _dtype_name(self.dtype)))
        hbm_ledger.ledger.set_keyed(
            self._hbm_keys, "rescore_rows",
            0 if self._rescore_rows is None
            else int(self._rescore_rows.nbytes),
            owner=self._hbm_owner, dtype=_dtype_name(self.dtype))
        hbm_ledger.ledger.set_keyed(
            self._hbm_keys, "host_mirror",
            0 if self._host_rows is None else int(self._host_rows.nbytes),
            owner=self._hbm_owner, dtype="float32", placement="host")

    def _t(self, a: np.ndarray) -> torch.Tensor:
        """A host array as a tensor on the store's device."""
        a = np.ascontiguousarray(a)
        if not a.flags.writeable:  # torch does not take read-only memory
            a = a.copy()
        return torch.from_numpy(a).to(self.device)

    # -- properties mirrored from DeviceVectorStore ---------------------------

    @property
    def count(self) -> int:
        return self._count

    @property
    def capacity(self) -> int:
        """Global slot-space bound (exclusive upper bound on slot ids)."""
        return max(_next_pow2(max(self._count, 1)), 8)

    @property
    def trained(self) -> bool:
        return self.centroids is not None

    def live_count(self) -> int:
        with self._lock:
            return len(self._slot_loc)

    # -- mutation -------------------------------------------------------------

    def add(self, vectors: np.ndarray) -> np.ndarray:
        vectors = np.asarray(vectors, dtype=np.float32)
        if vectors.ndim == 1:
            vectors = vectors[None, :]
        with self._lock:
            slots = np.arange(self._count, self._count + len(vectors),
                              dtype=np.int64)
            self._count += len(vectors)
            self._remember_rows(slots, vectors)
            self._add_to_delta(slots, vectors)
            self._maybe_reorganize()
            return slots

    def _remember_rows(self, slots: np.ndarray, vectors: np.ndarray):
        """PQ mode keeps the originals twice: an f32 host mirror (codes
        are lossy; retrain, rebuild and persistence read it) and the
        device ``_rescore_rows`` tier the exact rescore gathers from.
        Caller holds ``_lock``."""
        if self._host_rows is None or len(slots) == 0:
            return
        if self.normalize_on_add:
            vectors = normalize_np(vectors)
        mx = int(np.max(slots))
        if mx >= len(self._host_rows):
            grown = np.zeros((_next_pow2(mx + 1), self.dim), np.float32)
            grown[: len(self._host_rows)] = self._host_rows
            self._host_rows = grown
        self._host_rows[slots] = vectors
        need = _next_pow2(max(mx + 1, 1024))
        if self._rescore_rows is None:
            self._rescore_rows = torch.zeros((need, self.dim),
                                             dtype=self.dtype, device=self.device)
        elif mx >= self._rescore_rows.shape[0]:
            old = self._rescore_rows
            self._rescore_rows = torch.zeros((need, self.dim),
                                             dtype=self.dtype, device=self.device)
            self._rescore_rows[: old.shape[0]] = old
        self._rescore_rows.index_copy_(
            0, self._t(np.asarray(slots, dtype=np.int64)),
            self._t(np.asarray(vectors, dtype=np.float32)).to(self.dtype))
        self._hbm_sync()

    def _add_to_delta(self, slots: np.ndarray, vectors: np.ndarray):
        dslots = self.delta.add(vectors)
        for g, d in zip(slots.tolist(), dslots.tolist()):
            self._delta_slots[int(d)] = int(g)
            self._slot_loc[int(g)] = ("delta", int(d))

    def _punch_hole(self, flat_idx: int):
        """Record a freed list position for hole-first refill. Caller
        holds ``_lock``."""
        l, p = divmod(int(flat_idx), self.list_cap)
        self._holes.setdefault(l, []).append(p)

    def set_at(self, slots: np.ndarray, vectors: np.ndarray):
        """Overwrite slots in place. List-resident slots are tombstoned
        there and re-routed through the delta (their list may change)."""
        slots = np.atleast_1d(np.asarray(slots, dtype=np.int64))
        vectors = np.asarray(vectors, dtype=np.float32)
        if vectors.ndim == 1:
            vectors = vectors[None, :]
        with self._lock:
            self._count = max(self._count, int(slots.max()) + 1 if len(slots) else 0)
            self._remember_rows(slots, vectors)
            delta_upd_d, delta_upd_v = [], []
            fresh_s, fresh_v = [], []
            clear_flat = []
            for s, v in zip(slots.tolist(), vectors):
                loc = self._slot_loc.get(int(s))
                if loc is not None and loc[0] == "delta":
                    delta_upd_d.append(loc[1])
                    delta_upd_v.append(v)
                else:
                    if loc is not None:  # list-resident: tombstone there
                        clear_flat.append(loc[1])
                        self._punch_hole(loc[1])
                    fresh_s.append(int(s))
                    fresh_v.append(v)
            if clear_flat:
                _clear_list_rows(self.list_valid,
                                 self._t(np.asarray(clear_flat, np.int64)))
            if delta_upd_d:
                self.delta.set_at(np.asarray(delta_upd_d),
                                  np.stack(delta_upd_v))
            if fresh_s:
                self._add_to_delta(np.asarray(fresh_s), np.stack(fresh_v))
            self._maybe_reorganize()

    def delete(self, slots) -> None:
        slots = np.atleast_1d(np.asarray(slots, dtype=np.int64))
        with self._lock:
            clear_flat, delta_del = [], []
            for s in slots.tolist():
                loc = self._slot_loc.pop(int(s), None)
                if loc is None:
                    continue
                if loc[0] == "delta":
                    delta_del.append(loc[1])
                    self._delta_slots.pop(loc[1], None)
                else:
                    clear_flat.append(loc[1])
                    self._punch_hole(loc[1])
            if delta_del:
                self.delta.delete(np.asarray(delta_del))
            if clear_flat:
                _clear_list_rows(self.list_valid,
                                 self._t(np.asarray(clear_flat, np.int64)))

    # -- training / reorganization -------------------------------------------

    def _maybe_reorganize(self):
        if not self.trained:
            if len(self._slot_loc) >= self.train_threshold:
                self.train()
        elif len(self._delta_slots) >= self.delta_threshold:
            self.flush_delta()

    def _auto_nlist(self, n: int) -> int:
        # ~2*sqrt(N) lists, pow2-rounded, clamped
        return int(min(8192, max(16, _next_pow2(int(2 * math.sqrt(n))))))

    def train(self, force_nlist: int | None = None):
        """Learn the coarse partition from current contents and move
        everything into posting lists. On a trained store this is the
        RETRAIN path (``maintain``'s drift gate lands here); routine
        delta absorption goes through ``flush_delta``."""
        with self._lock:
            vecs, slots = self._all_live_host()
            n = len(vecs)
            if n == 0:
                raise RuntimeError("cannot train IVF on an empty store")
            was_trained = self.trained
            nlist = force_nlist or self.nlist or self._auto_nlist(n)
            nlist = min(nlist, n)
            self.nlist = nlist
            cents = kmeans_fit(vecs, nlist, iters=10, device=self.device)
            if self.normalize_on_add:
                # keep centroids on the sphere so probe distances compare
                cents = normalize_np(cents)
            self._set_centroids(np.asarray(cents, dtype=np.float32))
            assign = kmeans_assign(vecs, self._centroids_np, device=self.device)
            if self.quantization:
                from weaviate_tpu_torch.ops.pq import pq_fit

                # the codebook quantizes RESIDUALS (classic IVFADC)
                res = vecs - self._centroids_np[assign]
                self.codebook = pq_fit(res, m=self.pq_segments,
                                       k=self.pq_centroids, iters=8,
                                       device=self.device)
            self._rebuild_lists(vecs, slots, assign=assign)
            self._reset_delta()  # delta fully absorbed
            self._live_at_train = len(self._slot_loc)
            if was_trained:
                self.retrain_count += 1
            self._hbm_sync()

    def _set_centroids(self, cents: np.ndarray) -> None:
        self._centroids_np = cents
        self.centroids = self._t(cents)
        self._c_norms = (self.centroids * self.centroids).sum(dim=1)

    def maintain(self) -> None:
        """Incremental maintenance hook (db/shard.py epoch maintenance):
        fold the delta into lists; RETRAIN only when the corpus outgrew
        its partition (live count >= retrain_factor x live-at-train)."""
        with self._lock:
            if not self.trained:
                if len(self._slot_loc) >= self.train_threshold:
                    self.train()
                return
            if (len(self._slot_loc)
                    >= self.retrain_factor * max(self._live_at_train, 1)):
                self.train()
                return
            if self._delta_slots:
                self.flush_delta()

    def _all_live_host(self):
        """(vectors [L,d] f32, slots [L] int64) for every live slot."""
        out_v, out_s = [], []
        if self.trained and (self.list_vecs is not None
                             or self.list_codes is not None):
            lval = self.list_valid.reshape(-1).cpu().numpy()
            lslot = self.list_slots.reshape(-1).cpu().numpy()
            live = np.nonzero(lval)[0]
            slots_live = lslot[live].astype(np.int64)
            if self.quantization:
                # codes are lossy: the originals live in the host mirror
                out_v.append(self._host_rows[slots_live])
            else:
                rows = self.list_vecs.reshape(-1, self.dim)[
                    self._t(live.astype(np.int64))]
                out_v.append(rows.float().cpu().numpy())
            out_s.append(slots_live)
        dsnap = self.delta.snapshot()
        dlive = np.nonzero(dsnap["valid"])[0]
        if len(dlive):
            out_v.append(dsnap["vectors"][dlive])
            out_s.append(np.asarray(
                [self._delta_slots[int(d)] for d in dlive], dtype=np.int64))
        if not out_v:
            return (np.empty((0, self.dim), np.float32),
                    np.empty(0, np.int64))
        return np.concatenate(out_v), np.concatenate(out_s)

    def _rebuild_lists(self, vecs: np.ndarray, slots: np.ndarray,
                       assign: np.ndarray | None = None):
        """Assign + scatter everything into fresh list tensors. Caller
        holds ``_lock``."""
        if assign is None:
            assign = (kmeans_assign(vecs, self._centroids_np, device=self.device)
                      if len(vecs) else np.empty(0, np.int64))
        assign = np.asarray(assign, dtype=np.int64)
        n = len(vecs)
        counts = (np.bincount(assign, minlength=self.nlist) if n
                  else np.zeros(self.nlist, dtype=np.int64))
        # cap targets ~2x the even fill (pow2), not the fullest list:
        # overfull lists spill their farthest members instead
        cap = max(8, _next_pow2(-(-2 * n // max(self.nlist, 1))) if n else 8)
        while self.nlist * cap < n:
            cap *= 2
        if n:
            cap = min(cap, max(8, _next_pow2(int(counts.max()))))
        while True:
            spilled = self._spill_overfull(vecs, assign, cap)
            if spilled is not None:
                assign = spilled
                break
            cap *= 2  # unplaceable at this cap: relax and retry
        self.list_cap = cap
        dev = self.device
        if self.quantization:
            self.list_codes = torch.zeros(
                (self.nlist, cap, self.pq_segments), dtype=torch.uint8, device=dev)
            self.list_tvals = torch.zeros((self.nlist, cap),
                                          dtype=torch.float32, device=dev)
            self.list_vecs = None
            self.list_norms = None
        else:
            self.list_vecs = torch.zeros((self.nlist, cap, self.dim),
                                         dtype=self.dtype, device=dev)
            self.list_norms = torch.zeros((self.nlist, cap),
                                          dtype=torch.float32, device=dev)
            self.list_codes = None
            self.list_tvals = None
        self.list_valid = torch.zeros((self.nlist, cap), dtype=torch.bool, device=dev)
        self.list_slots = torch.full((self.nlist, cap), -1, dtype=torch.int32,
                                     device=dev)
        self._fill = np.zeros(self.nlist, dtype=np.int64)
        self._holes = {}
        self.rebuild_count += 1
        self._hbm_sync()
        self._scatter_assigned(vecs, slots, assign)

    def _spill_overfull(self, vecs: np.ndarray, assign: np.ndarray,
                        cap: int) -> np.ndarray | None:
        """Rebalance at train time: each overfull list keeps its ``cap``
        CLOSEST members (ties toward the lower row index) and spills the
        rest to the nearest centroid with room. Returns the adjusted
        assignment, or None when some row cannot be placed at this cap."""
        counts = np.bincount(assign, minlength=self.nlist)
        over = np.flatnonzero(counts > cap)
        if len(over) == 0:
            return assign
        cents = self._centroids_np
        assign = assign.copy()
        room = np.clip(cap - counts, 0, None)
        for l in over.tolist():
            members = np.flatnonzero(assign == l)
            d_own = np.sum((vecs[members] - cents[l]) ** 2, axis=1)
            # lexsort's LAST key is primary: distance asc, index tiebreak
            order = members[np.lexsort((members, d_own))]
            for r in order[cap:].tolist():
                d_all = np.sum((cents - vecs[r]) ** 2, axis=1)
                d_all[l] = np.inf
                for t in np.argsort(d_all, kind="stable").tolist():
                    if room[t] > 0:
                        assign[r] = t
                        room[t] -= 1
                        break
                else:
                    return None
        return assign

    def _take_position(self, l: int) -> int:
        """Next free position in list ``l``: holes first (LIFO), then the
        tail. -1 when the list is full. Caller holds ``_lock``."""
        hs = self._holes.get(l)
        if hs:
            return hs.pop()
        if self._fill[l] < self.list_cap:
            p = int(self._fill[l])
            self._fill[l] += 1
            return p
        return -1

    def _find_room(self, vec: np.ndarray, exclude: int) -> int:
        """Nearest centroid (excluding ``exclude``) whose list has a hole
        or tail room: the runtime spill target. -1 if every list is full."""
        d = np.sum((self._centroids_np - vec) ** 2, axis=1)
        d[exclude] = np.inf
        for t in np.argsort(d, kind="stable").tolist():
            if self._holes.get(t) or self._fill[t] < self.list_cap:
                return int(t)
        return -1

    def _scatter_assigned(self, vecs, slots, assign):
        """Place (vec, slot) pairs: holes first, then the list tail, then
        spill to the next-nearest centroid with room; capacity grows only
        when EVERY list is full. Residual PQ encodes against the FINAL
        assignment (spill included)."""
        if len(vecs) == 0:
            return
        assign = np.asarray(assign, dtype=np.int64).copy()
        pos = np.empty(len(assign), dtype=np.int64)
        for i, l in enumerate(assign.tolist()):
            p = self._take_position(int(l))
            if p >= 0:
                pos[i] = p
                continue
            t = self._find_room(vecs[i], exclude=int(l))
            if t >= 0:
                assign[i] = t
                pos[i] = self._take_position(t)
            else:
                self._grow_cap()
                pos[i] = self._take_position(int(l))
        # positions stay valid across _grow_cap; flat indices are computed
        # once, against the FINAL cap
        flat_idx = assign * self.list_cap + pos
        fi_t = self._t(flat_idx)
        s_t = self._t(np.asarray(slots, dtype=np.int64))
        if self.quantization:
            from weaviate_tpu_torch.ops.pq import pq_encode, pq_reconstruct

            cents = self._centroids_np[assign]
            res = vecs - cents
            codes = pq_encode(self.codebook, res)
            rhat = pq_reconstruct(self._t(codes), self.codebook.centroids,
                                  self.codebook.m).cpu().numpy()
            tvals = (2.0 * np.sum(cents * rhat, axis=1)
                     + np.sum(rhat * rhat, axis=1)).astype(np.float32)
            _scatter_code_lists(self.list_codes, self.list_valid,
                                self.list_slots, self.list_tvals, fi_t,
                                self._t(codes), self._t(tvals), s_t)
        else:
            _scatter_lists(self.list_vecs, self.list_valid, self.list_slots,
                           self.list_norms, fi_t,
                           self._t(np.asarray(vecs, dtype=np.float32)), s_t)
        for s, fi in zip(np.asarray(slots).tolist(), flat_idx.tolist()):
            self._slot_loc[int(s)] = ("list", int(fi))

    def _grow_cap(self):
        """Double per-list capacity (rare, amortized)."""
        old_cap = self.list_cap
        new_cap = old_cap * 2
        pad = new_cap - old_cap
        dev = self.device

        def grown(a, fill=0):
            extra = torch.full((self.nlist, pad) + tuple(a.shape[2:]), fill,
                               dtype=a.dtype, device=dev)
            return torch.cat([a, extra], dim=1)

        if self.quantization:
            self.list_codes = grown(self.list_codes)
            self.list_tvals = grown(self.list_tvals)
        else:
            self.list_vecs = grown(self.list_vecs)
            self.list_norms = grown(self.list_norms)
        self.list_valid = grown(self.list_valid, False)
        self.list_slots = grown(self.list_slots, -1)
        self.list_cap = new_cap
        self._hbm_sync()
        # flat indices shift: l*old_cap+p -> l*new_cap+p (hole POSITIONS
        # are cap-invariant)
        for s, loc in self._slot_loc.items():
            if loc[0] == "list":
                l, p = divmod(loc[1], old_cap)
                self._slot_loc[s] = ("list", l * new_cap + p)

    def flush_delta(self):
        """Merge the delta into the posting lists (memtable flush): an
        INCREMENTAL scatter into holes/tails, never a rebuild."""
        with self._lock:
            if not self.trained:
                return
            dsnap = self.delta.snapshot()
            live = np.nonzero(dsnap["valid"])[0]
            if len(live) == 0:
                self._reset_delta()
                return
            vecs = dsnap["vectors"][live]
            slots = np.asarray([self._delta_slots[int(d)] for d in live],
                               dtype=np.int64)
            if self.quantization and self.codebook is None:
                # compression was enabled while the store was empty: the
                # codebook trains on the first flush with enough data
                if len(vecs) < self.pq_centroids:
                    return
                from weaviate_tpu_torch.ops.pq import pq_fit

                a0 = kmeans_assign(vecs, self._centroids_np, device=self.device)
                self.codebook = pq_fit(vecs - self._centroids_np[a0],
                                       m=self.pq_segments,
                                       k=self.pq_centroids, iters=8,
                                       device=self.device)
            assign = kmeans_assign(vecs, self._centroids_np, device=self.device)
            self._scatter_assigned(vecs, slots, assign)
            self._reset_delta()

    def _reset_delta(self):
        """Swap in a fresh delta store. Caller holds ``_lock``."""
        # rebuilt outside the shard's construction scope: re-enter the
        # captured owner labels so the delta stays attributed
        with hbm_ledger.owner(**self._hbm_owner):
            self.delta = DeviceVectorStore(
                self.dim, self.metric,
                capacity=min(self.capacity, self.delta_threshold * 2),
                chunk_size=self.chunk_size, device=self.device)
        self._delta_slots = {}

    # -- queries -------------------------------------------------------------

    def _effective_nprobe(self) -> int:
        if self.nprobe:
            return min(self.nprobe, self.nlist)
        return min(self.nlist, max(8, self.nlist // 8))

    def _delta_allow(self, allow_mask, b: int):
        """Project the GLOBAL allow mask ([cap] shared or [B, cap]
        per-query) onto delta-local slots. Caller holds ``_lock``."""
        if allow_mask is None:
            return None
        cap_d = self.delta.capacity
        if allow_mask.ndim == 2:
            out = np.zeros((b, cap_d), dtype=bool)
            for ds, g in self._delta_slots.items():
                if ds < cap_d and g < allow_mask.shape[1]:
                    out[:, ds] = allow_mask[:, g]
            return out
        out = np.zeros(cap_d, dtype=bool)
        for ds, g in self._delta_slots.items():
            if ds < cap_d and g < len(allow_mask) and allow_mask[g]:
                out[ds] = True
        return out

    def _allow_bits(self, allow_mask, b: int) -> torch.Tensor:
        """The global allow mask as packed words on the device: [B, W]
        per query (packed on the card for a CUDA store) or [1, W]
        shared."""
        if allow_mask.ndim == 2:
            return batched_mask_operands(allow_mask, b, self.capacity,
                                         self.device, owner=self._hbm_owner)
        bits = as_bits_tensor(pack_allow_bitmask(
            allow_mask, mask_pad_cols(self.capacity)), self.device)
        hbm_ledger.ledger.track("allow_bitmask", bits, **self._hbm_owner)
        return bits

    def search(self, queries: np.ndarray, k: int,
               allow_mask: np.ndarray | None = None,
               nprobe: int | None = None):
        """Merged top-k over delta (exact) + probed lists (ANN). This IS
        ``search_async(...).result()``."""
        return self.search_async(queries, k, allow_mask,
                                 nprobe=nprobe).result()

    def search_async(self, queries: np.ndarray, k: int,
                     allow_mask: np.ndarray | None = None,
                     nprobe: int | None = None) -> DeviceResultHandle:
        """Dispatch-only twin of ``search``: both legs (the exact delta
        scan, ids remapped to global on the device, and the probe with
        the residual-PQ exact rescore) launch under ``_lock`` and merge on
        the device; the results stay there in the returned handle.
        ``allow_mask`` takes the DeviceVectorStore forms: [cap] bool
        shared, or [B, cap] bool per query (packed once and folded per
        candidate inside the probe, so B differently-filtered requests run
        as ONE device program)."""
        queries = np.asarray(queries, dtype=np.float32)
        squeeze = queries.ndim == 1
        if squeeze:
            queries = queries[None, :]
        b = len(queries)
        allow_mask = normalize_allow_mask(allow_mask, b)
        np_probe = 0
        with tracing.span("ivf.search", queries=b, k=k,
                          filtered=allow_mask is not None) as sp, \
                self._lock:
            legs_d, legs_i = [], []
            if self.delta.live_count() > 0:
                dd, di = self.delta.epoch_scan(
                    queries, min(k, self.delta.capacity),
                    self._delta_allow(allow_mask, b))
                gmap = np.full(max(self.delta.capacity, 1), -1, np.int32)
                for ds, g in self._delta_slots.items():
                    if ds < len(gmap):
                        gmap[ds] = g
                gd = self._t(gmap)
                di = torch.where(di >= 0, gd[di.clamp(0, len(gmap) - 1).long()],
                                 torch.full_like(di, -1))
                legs_d.append(torch.where(di >= 0, dd,
                                          torch.full_like(dd, MASKED_DISTANCE)))
                legs_i.append(di.to(torch.int32))
            if (self.trained and self._fill is not None
                    and int(self._fill.sum()) > 0):
                np_probe = min((nprobe or self._effective_nprobe()),
                               self.nlist)
                bits = (None if allow_mask is None
                        else self._allow_bits(allow_mask, b))
                k_cand = k * self.rescore_limit if self.quantization else k
                k_eff = min(k_cand, np_probe * self.list_cap)
                # EXPLAIN: the probe plan, host ints only (no device
                # reads); a no-op unless a sink is installed for this
                # dispatch
                kernelscope.explain_note(
                    "ivf", nprobe=np_probe, nlist=self.nlist,
                    lists_frac=(round(np_probe / self.nlist, 6)
                                if self.nlist else 0.0),
                    candidates=k_eff,
                    rescored=(k_eff if self.quantization else 0),
                    quantized=bool(self.quantization),
                    filtered=bits is not None, queries=b, k=k,
                    delta_leg=bool(legs_d))
                q_all = self._t(queries)
                outs_d, outs_i = [], []
                for s in range(0, b, self.query_chunk):
                    q_dev = q_all[s:s + self.query_chunk]
                    bch = (bits if bits is None or bits.shape[0] == 1
                           else bits[s:s + self.query_chunk])
                    if self.quantization:
                        _, cand = _ivf_probe_topk_pq(
                            q_dev, self.centroids, self._c_norms,
                            self.list_codes, self.list_valid,
                            self.list_slots, self.list_tvals,
                            self.codebook.centroids, bch, k_eff,
                            np_probe, self.metric)
                        # exact device rescore of the ADC oversample;
                        # masks already folded (dropped slots are -1)
                        qd, qs_ = gather_rescore_topk(
                            q_dev, cand, self._rescore_rows,
                            min(k, k_eff), self.metric)
                    else:
                        qd, qs_ = _ivf_probe_topk(
                            q_dev, self.centroids, self._c_norms,
                            self.list_vecs, self.list_valid,
                            self.list_slots, self.list_norms, bch, k_eff,
                            np_probe, self.metric)
                    outs_d.append(qd)
                    outs_i.append(qs_)
                legs_d.append(outs_d[0] if len(outs_d) == 1
                              else torch.cat(outs_d))
                legs_i.append((outs_i[0] if len(outs_i) == 1
                               else torch.cat(outs_i)).to(torch.int32))
            sp.set(nprobe=np_probe, nlist=self.nlist)
            kernelscope.explain_note("ivf", merge_legs=len(legs_d))
            if not legs_d:
                d_e = np.full((b, k), MASKED_DISTANCE, np.float32)
                i_e = np.full((b, k), -1, np.int64)
                return DeviceResultHandle.ready(
                    (d_e[0], i_e[0]) if squeeze else (d_e, i_e))
            if len(legs_d) == 1:
                md, mi = legs_d[0], legs_i[0]
            else:
                cat_d = torch.cat(legs_d, dim=1)
                cat_i = torch.cat(legs_i, dim=1)
                md, mi = topk_smallest(cat_d, cat_i, min(k, cat_d.shape[1]))

        def _finish(d_np, i_np, _k=k, _squeeze=squeeze):
            d_np = np.asarray(d_np, dtype=np.float32)
            i_np = np.asarray(i_np, dtype=np.int64)
            i_np = np.where(d_np >= MASKED_DISTANCE, -1, i_np)
            if d_np.shape[1] < _k:  # pad to k like the flat store contract
                pad = _k - d_np.shape[1]
                d_np = np.pad(d_np, ((0, 0), (0, pad)),
                              constant_values=MASKED_DISTANCE)
                i_np = np.pad(i_np, ((0, 0), (0, pad)), constant_values=-1)
            if _squeeze:
                return d_np[0], i_np[0]
            return d_np, i_np

        lists_frac = (np_probe / self.nlist) if self.nlist else 0.0
        return DeviceResultHandle(
            (md, mi), finish=_finish,
            attrs={"queries": b, "k": k, "nprobe": np_probe,
                   "nlist": self.nlist, "lists_frac": lists_frac})

    def search_by_distance(self, query: np.ndarray, max_distance: float,
                           allow_mask: np.ndarray | None = None):
        k = 64
        while True:
            d, i = self.search(query, k, allow_mask)
            within = (d <= max_distance) & (i >= 0)
            if (~within).any() or k >= max(self._count, 1):
                return d[within], i[within]
            k = min(k * 4, max(self._count, 1))

    # -- maintenance ---------------------------------------------------------

    def compact(self) -> np.ndarray:
        """Compaction is INCREMENTAL: deletes already punched reusable
        holes, so compaction just folds the delta into the lists
        (``rebuild_count`` stays flat). Slot ids stay stable (identity
        mapping for live slots)."""
        with self._lock:
            mapping = np.full(self.capacity, -1, dtype=np.int64)
            for s in self._slot_loc:
                mapping[s] = s
            if self.trained:
                self.flush_delta()
            return mapping

    # -- persistence ---------------------------------------------------------

    def snapshot(self) -> dict:
        """Host-side snapshot, the same dict as the JAX store's."""
        with self._lock:
            vecs, slots = self._all_live_host()
            keep = np.asarray([s in self._slot_loc for s in slots.tolist()],
                              dtype=bool) if len(slots) else np.empty(0, bool)
            return {
                "kind": "ivf",
                "dim": self.dim,
                "metric": self.metric,
                "count": self._count,
                "nlist": self.nlist if self.trained else 0,
                "nprobe": self.nprobe,
                "centroids": (self._centroids_np.copy()
                              if self.trained else None),
                "live_vectors": vecs[keep] if len(slots) else vecs,
                "live_slots": slots[keep] if len(slots) else slots,
                "chunk_size": self.chunk_size,
                "dtype": _dtype_name(self.dtype),
                "train_threshold": self.train_threshold,
                "delta_threshold": self.delta_threshold,
                # FlatIndex.snapshot() compatibility ("quantization" keys
                # the FlatIndex restore dispatch; IVF-PQ state rides under
                # its own keys)
                "valid": self._valid_over_slots(),
                "quantization": None,
                "ivf_quantization": self.quantization,
                "pq_segments": self.pq_segments,
                "pq_centroids": self.pq_centroids,
                "rescore_limit": self.rescore_limit,
                "retrain_factor": self.retrain_factor,
                "pq_codebook": (self.codebook.centroids.float().cpu().numpy()
                                if self.codebook is not None else None),
            }

    def _valid_over_slots(self) -> np.ndarray:
        v = np.zeros(self.capacity, dtype=bool)
        for s in self._slot_loc:
            v[s] = True
        return v

    @classmethod
    def restore(cls, snap: dict, device=None, **kwargs) -> "IVFStore":
        # the storage dtype survives the round trip unless overridden
        dtype = kwargs.pop("dtype", None) or snap.get("dtype", "float32")
        store = cls(dim=snap["dim"], metric=snap["metric"],
                    nlist=snap.get("nlist", 0), nprobe=snap.get("nprobe", 0),
                    chunk_size=snap.get("chunk_size", 8192),
                    train_threshold=snap.get("train_threshold", 16_384),
                    delta_threshold=snap.get("delta_threshold", 8192),
                    dtype=dtype,
                    quantization=snap.get("ivf_quantization"),
                    pq_segments=snap.get("pq_segments"),
                    pq_centroids=snap.get("pq_centroids", 16),
                    rescore_limit=snap.get("rescore_limit", 16),
                    retrain_factor=snap.get("retrain_factor", 4.0),
                    device=device)
        slots = np.asarray(snap["live_slots"], dtype=np.int64)
        vecs = np.asarray(snap["live_vectors"], dtype=np.float32)
        store._count = snap["count"]
        if snap.get("pq_codebook") is not None:
            from weaviate_tpu_torch.ops.pq import PQCodebook

            store.codebook = PQCodebook(store._t(np.asarray(
                snap["pq_codebook"], dtype=np.float32)))
        if store.quantization and len(slots):
            # mirror rows were normalized at the original insert
            norm = store.normalize_on_add
            store.normalize_on_add = False
            store._remember_rows(slots, vecs)
            store.normalize_on_add = norm
        if snap.get("centroids") is not None:
            store.nlist = snap["nlist"]
            store._set_centroids(np.asarray(snap["centroids"], np.float32))
            if store.quantization and store.codebook is None:
                # quantization enabled before any codebook could train:
                # rows go back to the exact delta; empty code lists keep
                # _fill truthful
                store._rebuild_lists(np.empty((0, store.dim), np.float32),
                                     np.empty(0, np.int64))
                if len(vecs):
                    store._add_to_delta(slots, vecs)
            else:
                # empty corpora still allocate list tensors so later
                # delta flushes have somewhere to scatter
                store._rebuild_lists(vecs, slots)
            store._live_at_train = len(store._slot_loc)
            store._hbm_sync()
        elif len(vecs):
            # untrained: everything back into the delta buffer
            store._add_to_delta(slots, vecs)
        return store


class IVFIndex(FlatIndex):
    """VectorIndex-contract ANN index: the FlatIndex id<->slot bookkeeping
    over an IVFStore on ``device`` (default: the card)."""

    index_type = "ivf"
    # IVFStore folds [B, capacity] per-query masks into packed allow
    # words inside the probe: the QueryBatcher coalesces filtered IVF
    # requests into one device program
    supports_batched_filters = True

    def __init__(self, dim: int, metric: str = "l2-squared",
                 capacity: int = 8192, chunk_size: int = 8192,
                 nlist: int = 0, nprobe: int = 0,
                 train_threshold: int = 16_384, delta_threshold: int = 8192,
                 mesh=None, dtype=None, quantization: str | None = None,
                 device=None, **quant_kwargs):
        if mesh is not None:
            raise NotImplementedError(
                "ivf is single-replica; collection sharding distributes it")
        self.dim = dim
        self.metric = metric
        self.store = IVFStore(dim=dim, metric=metric, capacity=capacity,
                              chunk_size=chunk_size, nlist=nlist, nprobe=nprobe,
                              train_threshold=train_threshold,
                              delta_threshold=delta_threshold, dtype=dtype,
                              quantization=quantization, device=device,
                              **quant_kwargs)
        self._lock = threading.RLock()
        self._id_to_slot: dict[int, int] = {}
        self._slot_to_id = np.full(self.store.capacity, -1, dtype=np.int64)

    def train(self, nlist: int | None = None):
        """Force coarse training now (normally automatic at threshold)."""
        with self._lock:
            self.store.train(force_nlist=nlist)

    def maintain(self) -> None:
        """Incremental maintenance (db/shard.py epoch_maintenance): delta
        flush always, retrain only past the drift gate."""
        with self._lock:
            self.store.maintain()

    def compress(self, quantization: str = "pq", **quant_kwargs) -> None:
        """Runtime switch to residual-PQ residency: fit a codebook on the
        residuals of the live contents and rebuild the lists as codes
        (reference lifecycle: hnsw/compress.go:38 via config update).
        Slot ids are stable, so the id<->slot maps carry over. On an
        untrained store the codebook waits for the coarse partition."""
        if quantization != "pq":
            raise ValueError("ivf supports quantization='pq'")
        from weaviate_tpu_torch.ops.pq import default_pq_segments, pq_fit

        with self._lock:
            st = self.store
            if st.quantization:
                raise RuntimeError("index is already compressed")
            vecs, slots = st._all_live_host()
            # every fallible step runs BEFORE any store mutation
            pq_centroids = quant_kwargs.get("pq_centroids") or st.pq_centroids
            pq_segments = (quant_kwargs.get("pq_segments")
                           or st.pq_segments
                           or default_pq_segments(st.dim, pq_centroids))
            if 0 < len(vecs) < pq_centroids:
                raise RuntimeError(
                    f"need >= {pq_centroids} live vectors to train PQ, "
                    f"have {len(vecs)}")
            codebook = None
            if len(vecs) and st.trained:
                assign = kmeans_assign(vecs, st._centroids_np, device=st.device)
                codebook = pq_fit(vecs - st._centroids_np[assign],
                                  m=pq_segments, k=pq_centroids, iters=8,
                                  device=st.device)
            st.quantization = "pq"
            st.pq_segments = pq_segments
            st.pq_centroids = pq_centroids
            if quant_kwargs.get("rescore_limit"):
                st.rescore_limit = quant_kwargs["rescore_limit"]
            st.codebook = codebook
            st._host_rows = np.zeros(
                (max(_next_pow2(max(st.capacity, 1)), 1024), st.dim),
                dtype=np.float32)
            if len(vecs):
                norm = st.normalize_on_add
                st.normalize_on_add = False  # rows already normalized
                st._remember_rows(slots, vecs)
                st.normalize_on_add = norm
            if st.trained:
                # the rebuild absorbs delta-resident rows too: reset the
                # delta or its slots would be live in BOTH legs. The empty
                # case still rebuilds so _fill reflects reality.
                st._rebuild_lists(vecs, slots)
                st._reset_delta()
            st._hbm_sync()

    @property
    def trained(self) -> bool:
        return self.store.trained

    @property
    def compressed(self) -> bool:
        return bool(self.store.quantization)

    @classmethod
    def restore(cls, snap: dict, device=None, **kwargs) -> "IVFIndex":
        idx = cls.__new__(cls)
        idx.dim = snap["dim"]
        idx.metric = snap["metric"]
        kwargs.pop("mesh", None)
        idx.store = IVFStore.restore(snap, device=device, **kwargs)
        idx._lock = threading.RLock()
        slot_to_id = snap["slot_to_id"]
        idx._slot_to_id = np.full(idx.store.capacity, -1, dtype=np.int64)
        idx._slot_to_id[: len(slot_to_id)] = slot_to_id
        idx._id_to_slot = {
            int(doc): int(slot)
            for slot, doc in enumerate(slot_to_id)
            if doc >= 0 and slot < len(snap["valid"]) and snap["valid"][slot]
        }
        return idx
