"""Product quantization (PQ) on tensors (port of ``weaviate_tpu/ops/pq.py``).

Reference: adapters/repos/db/vector/compressionhelpers/product_quantization.go
(ProductQuantizer: Fit :372, Encode :420, per-query DistanceLookUpTable
:33-151 with LUT ``Distance`` :440) trained by kmeans.

Because PQ segments are orthogonal, the asymmetric distance
sum_m LUT[m, code[n, m]] is exactly dist(q, x_hat_n) for the vector
x_hat_n rebuilt from centroids. The 8-bit path (``pq_topk``) scores
reconstructions per chunk; the 4-bit path (``pq4_topk``) runs the
``pq4_scan_reduce`` kernel over a per-query int8 LUT. k-means runs as
batched Lloyd iterations over all segments at once, on the device the
vectors are given to.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from weaviate_tpu_torch.device import resolve
from weaviate_tpu_torch.ops.distances import MASKED_DISTANCE, pairwise_distance
from weaviate_tpu_torch.ops.kernels import (fused_topk_pairs, pq4_scan_reduce,
                                            quantize_lut_int8, unpack_allow_bitmask)
from weaviate_tpu_torch.ops.topk import _pad_k, select_survivors, topk_smallest

__all__ = ["PQCodebook", "default_pq_segments", "pq_fit", "pq_encode",
           "pq_reconstruct", "pq_topk", "quantize_lut_int8", "pq_lut",
           "pq_topk_twostage", "pq4_topk"]


class PQCodebook(NamedTuple):
    """centroids [m, k, ds] f32 — m segments, k centroids each, ds = d/m."""

    centroids: torch.Tensor

    @property
    def m(self) -> int:
        return self.centroids.shape[0]

    @property
    def k(self) -> int:
        return self.centroids.shape[1]

    @property
    def ds(self) -> int:
        return self.centroids.shape[2]

    @property
    def dim(self) -> int:
        return self.m * self.ds


def default_pq_segments(dim: int, pq_centroids: int = 16) -> int:
    """Segment-count policy shared by every PQ surface: 4-bit codes target
    1 bit/dim (m = d/4), 8-bit codes 1 byte per 8 dims; m must divide d
    for the orthogonal-segment ADC."""
    target = max(1, dim // (4 if pq_centroids <= 16 else 8))
    while dim % target:
        target -= 1
    return target


def _seg_view(vectors: torch.Tensor, m: int) -> torch.Tensor:
    n, d = vectors.shape
    if d % m:
        raise ValueError(f"dim {d} not divisible by {m} segments")
    return vectors.reshape(n, m, d // m)


def _assign(vectors: torch.Tensor, centroids: torch.Tensor, m: int) -> torch.Tensor:
    """Nearest centroid per segment: [N, m] int64 (ties to the lower
    centroid, as ``argmin`` resolves them in both packages)."""
    vs = _seg_view(vectors.float(), m)  # [N, m, ds]
    # ||v - c||^2 = ||v||^2 - 2 v.c + ||c||^2 ; argmin over k drops ||v||^2
    dots = torch.einsum("nms,mks->nmk", vs, centroids)
    cn = (centroids * centroids).sum(dim=-1)  # [m, k]
    return torch.argmin(cn[None, :, :] - 2.0 * dots, dim=-1)


def _lloyd_step(vectors: torch.Tensor, centroids: torch.Tensor, m: int, k: int):
    """One Lloyd iteration over every segment at once. The per-cluster
    sums go through a one-hot product, not atomics, so they are the same
    from run to run."""
    vs = _seg_view(vectors.float(), m)
    assign = _assign(vectors, centroids, m)  # [N, m]
    one_hot = torch.nn.functional.one_hot(assign, k).float()  # [N, m, k]
    sums = torch.einsum("nmk,nms->mks", one_hot, vs)
    counts = one_hot.sum(dim=0)  # [m, k]
    fresh = sums / torch.clamp(counts, min=1.0)[:, :, None]
    # keep the old centroid for empty clusters
    return torch.where((counts > 0)[:, :, None], fresh, centroids)


def pq_fit(vectors: np.ndarray, m: int, k: int = 256, iters: int = 8,
           sample: int = 65536, seed: int = 0, device=None) -> PQCodebook:
    """Train a PQ codebook (reference Fit, product_quantization.go:372) on
    ``device`` (default: the card). The sample and the initial centroids
    are drawn with numpy exactly as the JAX package draws them, so one
    seed picks the same rows; the Lloyd steps run on the device."""
    device = resolve(device)
    vectors = np.asarray(vectors, dtype=np.float32)
    n, _d = vectors.shape
    if n < k:
        raise ValueError(f"need >= {k} vectors to train k={k} PQ, have {n}")
    rng = np.random.default_rng(seed)
    if n > sample:
        vectors = vectors[rng.choice(n, sample, replace=False)]
        n = sample
    # init: k distinct data points per segment
    init_idx = rng.choice(n, k, replace=False)
    x = torch.from_numpy(np.ascontiguousarray(vectors)).to(device)
    centroids = _seg_view(x, m)[torch.from_numpy(init_idx).to(device)] \
        .permute(1, 0, 2).contiguous()  # [m, k, ds]
    for _ in range(iters):
        centroids = _lloyd_step(x, centroids, m, k)
    return PQCodebook(centroids=centroids)


def pq_encode(codebook: PQCodebook, vectors: np.ndarray, batch: int = 65536) -> np.ndarray:
    """Encode vectors -> codes [N, m] uint8 (reference Encode :420) on the
    codebook's device."""
    from weaviate_tpu_torch.runtime import tracing  # lazy: ops must not pull runtime at import

    vectors = np.asarray(vectors, dtype=np.float32)
    out = np.empty((len(vectors), codebook.m), dtype=np.uint8)
    dev = codebook.centroids.device
    for s in range(0, len(vectors), batch):
        chunk = torch.from_numpy(np.ascontiguousarray(vectors[s:s + batch])).to(dev)
        (codes,) = tracing.d2h(_assign(chunk, codebook.centroids, codebook.m).to(torch.uint8))
        out[s:s + batch] = codes
    return out


def pq_reconstruct(codes: torch.Tensor, centroids: torch.Tensor, m: int) -> torch.Tensor:
    """codes [N, m] uint8 -> x_hat [N, d] f32 by per-segment centroid gather."""
    idx = codes.long()  # [N, m]
    seg = torch.arange(m, device=codes.device)
    gathered = centroids[seg[None, :], idx]  # [N, m, ds]
    return gathered.reshape(codes.shape[0], m * centroids.shape[2])


def pq_topk(q: torch.Tensor, codes: torch.Tensor, centroids: torch.Tensor, k: int,
            chunk_size: int, metric: str = "l2-squared",
            valid: torch.Tensor | None = None, id_offset: int = 0,
            m: int | None = None, allow_bits: torch.Tensor | None = None):
    """Compressed brute-force top-k (the 8-bit path): scan codes in chunks,
    reconstruct, score. Same contract as ``chunked_topk``."""
    m = m or centroids.shape[0]
    n = codes.shape[0]
    if n % chunk_size:
        raise ValueError(f"codes rows {n} not a multiple of {chunk_size}")
    b = q.shape[0]
    dev = codes.device
    allow_rows = None if allow_bits is None else unpack_allow_bitmask(allow_bits, n)
    best_d = torch.full((b, k), MASKED_DISTANCE, dtype=torch.float32, device=dev)
    best_i = torch.full((b, k), -1, dtype=torch.int32, device=dev)
    for c in range(n // chunk_size):
        lo, hi = c * chunk_size, (c + 1) * chunk_size
        x_hat = pq_reconstruct(codes[lo:hi], centroids, m)
        d = pairwise_distance(q, x_hat, metric=metric)
        if valid is not None:
            d = torch.where(valid[None, lo:hi], d, torch.full_like(d, MASKED_DISTANCE))
        if allow_rows is not None:
            d = torch.where(allow_rows[:, lo:hi], d, torch.full_like(d, MASKED_DISTANCE))
        ids = (torch.arange(chunk_size, dtype=torch.int32, device=dev)
               + (lo + id_offset)).expand(b, chunk_size)
        # select within this chunk, then merge with the carried set
        ck_d, ck_i = topk_smallest(d, ids, min(k, chunk_size))
        best_d, best_i = topk_smallest(torch.cat([best_d, ck_d], dim=1),
                                       torch.cat([best_i, ck_i], dim=1), k)
    return best_d, best_i


def pq_lut(q: torch.Tensor, centroids: torch.Tensor, metric: str, m: int) -> torch.Tensor:
    """Per-query ADC lookup tables: [B, m, k] f32.

    l2-squared: LUT[b,s,c] = ||q_seg[b,s] - centroids[s,c]||^2  (exact ADC)
    dot:        LUT[b,s,c] = -q_seg . c
    cosine:     1 - q.x_hat with the +1 folded into segment 0 (constant
                shift per code value keeps the sum exact)
    """
    qs = _seg_view(q.float(), m)  # [B, m, ds]
    dots = torch.einsum("bms,mks->bmk", qs, centroids)
    if metric == "l2-squared":
        qn = (qs * qs).sum(dim=-1)  # [B, m]
        cn = (centroids * centroids).sum(dim=-1)  # [m, k]
        return qn[:, :, None] - 2.0 * dots + cn[None, :, :]
    if metric == "dot":
        return -dots
    # cosine / cosine-dot: operands normalized by the caller
    lut = -dots
    lut[:, 0, :] += 1.0
    return lut


def pq_topk_twostage(q: torch.Tensor, q_prefix_words: torch.Tensor,
                     codes: torch.Tensor, centroids: torch.Tensor,
                     prefix_t: torch.Tensor, k: int, refine: int = 8,
                     metric: str = "l2-squared",
                     valid: torch.Tensor | None = None, id_offset: int = 0,
                     m: int | None = None, use_pallas: bool = True,
                     chunk_budget_bytes: int = 128 << 20,
                     selection: str = "approx",
                     allow_bits: torch.Tensor | None = None):
    """Two-stage PQ scan: stage 1 scans a 128/256-bit transposed BQ sign
    prefix (``bq_scan_reduce``) and keeps refine*k candidates; stage 2
    gathers their codes, rebuilds them from the codebook and scores the
    reconstructions in f32. Only R = refine*k code rows per query are
    touched after stage 1."""
    from weaviate_tpu_torch.ops import bq as bq_ops

    n = codes.shape[0]
    m = m or centroids.shape[0]
    if use_pallas:
        # per-query mask prunes in stage 1; stage 2 only sees allowed rows
        vals1, ids1 = bq_ops.bq_scan_reduce(
            q_prefix_words, prefix_t, valid=valid,
            reduce_l=bq_ops._auto_reduce_l(n), transposed=True,
            allow_bits=allow_bits)
        r = min(refine * k, vals1.shape[1])
        if selection == "fused" and r <= 256:
            cand_d1, cand = fused_topk_pairs(vals1, ids1, r)
            cand = torch.where(cand < 0, torch.zeros_like(cand), cand)
        else:
            cand_d1, cand = topk_smallest(vals1, ids1, r)
    else:
        cand_d1, ids1 = bq_ops.bq_topk(
            q_prefix_words, prefix_t.T, k=min(refine * k, n), valid=valid,
            use_pallas=False, allow_bits=allow_bits)
        cand = torch.where(ids1 < 0, torch.zeros_like(ids1), ids1)
        r = cand.shape[1]

    b = q.shape[0]
    q = q.float()
    cg = codes[cand.clamp(0, n - 1).long()]  # [B, R, m]
    kc = centroids.shape[1]
    qn = (q * q).sum(dim=-1)[:, None]

    def score_chunk(cg_c):  # [B, Rc, m] -> [B, Rc]
        rc_ = cg_c.shape[1]
        x_hat = pq_reconstruct(cg_c.reshape(b * rc_, m), centroids, m).reshape(b, rc_, -1)
        dots = torch.einsum("bd,brd->br", q, x_hat)
        if metric == "l2-squared":
            return qn - 2.0 * dots + (x_hat * x_hat).sum(dim=-1)
        if metric == "dot":
            return -dots
        # cosine / cosine-dot: operands normalized by the caller
        return 1.0 - dots

    # bound the transient: the reference sizes its one-hot [B*Rc, m, kc]
    # chunks by this budget; the same chunking keeps the gather bounded
    rc = max(1, min(r, chunk_budget_bytes // max(1, b * m * kc * 2)))
    d2 = torch.cat([score_chunk(cg[:, s:s + rc]) for s in range(0, r, rc)], dim=1)
    d2 = torch.where(cand_d1 >= MASKED_DISTANCE * 0.5,
                     torch.full_like(d2, MASKED_DISTANCE), d2)
    kk = min(k, r)
    fd, fi = _pad_k(*topk_smallest(d2, cand, kk), kk, k)
    fi = torch.where(fd >= MASKED_DISTANCE * 0.5, torch.full_like(fi, -1),
                     fi + id_offset)
    return fd, fi


def pq4_topk(q: torch.Tensor, codes: torch.Tensor, centroids: torch.Tensor,
             k: int, chunk_size: int = 0, metric: str = "l2-squared",
             valid: torch.Tensor | None = None, id_offset: int = 0,
             m: int | None = None, reduce_l: int | None = None,
             selection: str = "approx", allow_bits: torch.Tensor | None = None):
    """Compressed brute-force top-k over 4-bit codes: the per-query LUT,
    the ``pq4_scan_reduce`` kernel (strided block-argmin), then one
    survivor selection over the ~N/L candidates (``"fused"`` through
    ``fused_topk_pairs``). ``chunk_size`` is accepted for API
    compatibility."""
    from weaviate_tpu_torch.ops.bq import _auto_reduce_l

    m = m or centroids.shape[0]
    n = codes.shape[0]
    lut = pq_lut(q, centroids, metric, m)  # [B, m, k]
    rl = reduce_l if reduce_l is not None else _auto_reduce_l(n)
    vals, ids = pq4_scan_reduce(lut, codes, valid=valid, reduce_l=rl,
                                allow_bits=allow_bits)
    return select_survivors(vals, ids, k, selection, id_offset)
