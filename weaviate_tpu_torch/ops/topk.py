"""Top-k selection over large corpora (port of ``weaviate_tpu/ops/topk.py``).

- ``chunked_topk_distances``: scan an [N] axis in fixed-size chunks,
  carrying a running top-k — peak memory O(B * chunk), not O(B * N).
- ``merge_topk``: merge candidate sets into a final top-k.

Distances follow the "lower = closer" convention. Every selection here is
exact with ties to the lower position, the rule ``lax.top_k`` follows
(``torch.topk`` does not promise it, so selection goes through
``kernels.smallest_positions``).

``selection="approx"`` has no PyTorch analogue (``lax.approx_max_k`` is
the TPU's bucketed argmin). It maps to the exact per-chunk selection: the
JAX package lowers it to an exact ``top_k`` off the TPU as well, so the
two packages agree exactly on the CPU.
"""

from __future__ import annotations

import torch

from weaviate_tpu_torch.ops.distances import MASKED_DISTANCE, pairwise_distance
from weaviate_tpu_torch.ops.kernels import (
    FUSED_PAIRS_MAX_K,
    FUSED_TOPK_MAX_K,
    KERNEL_METRICS,
    as_bits_tensor,
    distance_block,
    fused_topk_pairs,
    fused_topk_scan,
    smallest_positions,
    unpack_allow_bitmask,
)


def topk_smallest(dists: torch.Tensor, ids: torch.Tensor, k: int):
    """Smallest-k along the last axis. dists [B,N] f32, ids [N] or [B,N].

    Returns (top_dists [B,k], top_ids [B,k]) sorted ascending by distance,
    ties to the lower index."""
    pos = smallest_positions(dists, k)
    top_d = torch.gather(dists, 1, pos)
    top_i = ids[pos] if ids.ndim == 1 else torch.gather(ids, 1, pos)
    return top_d, top_i


def _pad_k(fd, fi, kk: int, k: int):
    if kk < k:
        b = fd.shape[0]
        fd = torch.cat([fd, torch.full((b, k - kk), MASKED_DISTANCE,
                                       dtype=fd.dtype, device=fd.device)], 1)
        fi = torch.cat([fi, torch.full((b, k - kk), -1, dtype=fi.dtype,
                                       device=fi.device)], 1)
    return fd, fi


def select_survivors(vals, ids, k: int, selection: str = "approx", id_offset=0):
    """Final selection over a survivor array: vals [B, M] f32 (dead
    entries at MASKED_DISTANCE), ids [B, M] global rows. ``"fused"`` runs
    the pairs kernel (k <= 256); anything else the exact selection.
    Pads to [B, k] with (MASKED_DISTANCE, -1) and applies ``id_offset``
    to live entries only."""
    ncand = vals.shape[1]
    kk = min(k, ncand)
    if selection == "fused" and kk <= FUSED_PAIRS_MAX_K:
        fd, fi = fused_topk_pairs(vals, ids, kk)
    else:
        fd, fi = topk_smallest(vals, ids, kk)
    fd, fi = _pad_k(fd, fi, kk, k)
    fi = torch.where(fd >= MASKED_DISTANCE * 0.5, torch.full_like(fi, -1),
                     fi + id_offset)
    return fd, fi


def merge_epoch_topk(parts, slot_maps, k: int, selection: str = "approx"):
    """Cross-epoch candidate merge: per-epoch ``(d [B, k_e], i [B, k_e])``
    with epoch-local ids (-1 dead) gather through their ``[cap_e]``
    local->global slot maps, concatenate in epoch order (distance ties
    resolve to the lower global slot) and merge exactly — through the
    pairs kernel under ``selection="fused"``. Returns ``(d [B, k],
    i [B, k])`` global ids, (MASKED_DISTANCE, -1) padded."""
    mapped_d, mapped_i = [], []
    for (d, i), smap in zip(parts, slot_maps):
        cap = smap.shape[0]
        g = smap[i.clamp(0, cap - 1).long()].to(i.dtype)
        mapped_d.append(d)
        mapped_i.append(torch.where(i >= 0, g, torch.full_like(i, -1)))
    cat_d = torch.cat(mapped_d, dim=1)
    cat_i = torch.cat(mapped_i, dim=1)
    kk = min(k, cat_d.shape[1])
    if selection == "fused" and kk <= FUSED_PAIRS_MAX_K:
        fd, fi = fused_topk_pairs(cat_d, cat_i, kk)
    else:
        fd, fi = topk_smallest(cat_d, cat_i, kk)
    fd, fi = _pad_k(fd, fi, kk, k)
    fi = torch.where(fd >= MASKED_DISTANCE * 0.5, torch.full_like(fi, -1), fi)
    return fd, fi


def merge_topk(dists: torch.Tensor, ids: torch.Tensor, k: int):
    """Merge candidate sets: dists [B, M], ids [B, M] -> top-k of the union."""
    return topk_smallest(dists, ids, k)


def chunked_topk_distances(
    q: torch.Tensor,
    x: torch.Tensor,
    k: int,
    chunk_size: int,
    metric: str = "l2-squared",
    valid: torch.Tensor | None = None,
    x_sq_norms: torch.Tensor | None = None,
    id_offset: int = 0,
    use_pallas: bool = False,
    selection: str = "exact",
    allow_bits: torch.Tensor | None = None,
    allow_rows: torch.Tensor | None = None,
    row_ids: torch.Tensor | None = None,
):
    """Brute-force top-k of ``q`` [B,d] against ``x`` [N,d], in chunks.

    ``valid`` [N] bool masks live slots; invalid slots get
    MASKED_DISTANCE. ``id_offset`` shifts local row indices into global
    id space. N must be a multiple of chunk_size. Returns (dists [B,k] f32,
    ids [B,k] int32) ascending.

    ``allow_bits`` ([B, W] packed words, ``kernels.pack_allow_bitmask``
    layout) or ``allow_rows`` ([B, N] bool) add a per-query filter.
    ``row_ids`` ([N] int32) remaps scanned positions to global ids (-1
    marks padding); use with ``id_offset=0``.

    ``use_pallas`` keeps the JAX package's name: True runs each chunk
    through the ``distance_block`` kernel. ``selection``:

    - ``"exact"`` / ``"approx"``: the exact top-k of every [B, k + chunk]
      tile (see the module docstring for approx).
    - ``"fused"``: the ``fused_topk_scan`` kernel folds selection into the
      scan (then ``fused_topk_pairs`` merges its slices). Exact, ties to
      the lower row, unfilled slots (MASKED, -1) instead of dead-row ids.
      Needs a kernel metric and k <= 128; otherwise it runs as
      ``"approx"`` (kernel metrics) or ``"exact"``.
    """
    n = x.shape[0]
    if n % chunk_size:
        raise ValueError(f"corpus rows {n} not a multiple of chunk {chunk_size}")
    if selection == "fused" and metric in KERNEL_METRICS and k <= FUSED_TOPK_MAX_K:
        d, i = fused_topk_scan(q, x, k, metric=metric, valid=valid,
                               x_sq_norms=x_sq_norms, allow_bits=allow_bits,
                               allow_rows=allow_rows)
        dead = torch.full_like(i, -1)
        if row_ids is not None:
            remapped = row_ids[i.clamp(0, n - 1).long()].to(i.dtype)
            return d, torch.where(i < 0, dead, remapped)
        return d, torch.where(i < 0, dead, i + id_offset)
    num_chunks = n // chunk_size
    b = q.shape[0]
    dev = x.device

    if allow_rows is None and allow_bits is not None:
        allow_rows = unpack_allow_bitmask(as_bits_tensor(allow_bits, dev), n)
    if allow_rows is not None:
        allow_rows = allow_rows.bool()
        if allow_rows.shape[1] < n:
            pad = torch.zeros((b, n - allow_rows.shape[1]), dtype=torch.bool, device=dev)
            allow_rows = torch.cat([allow_rows, pad], dim=1)
        allow_rows = allow_rows[:, :n]

    best_d = torch.full((b, k), MASKED_DISTANCE, dtype=torch.float32, device=dev)
    best_i = torch.full((b, k), -1, dtype=torch.int32, device=dev)
    iota = torch.arange(chunk_size, dtype=torch.int32, device=dev)
    for c in range(num_chunks):
        lo, hi = c * chunk_size, (c + 1) * chunk_size
        xc = x[lo:hi]
        vc = None if valid is None else valid[lo:hi]
        nc = None if x_sq_norms is None else x_sq_norms[lo:hi]
        if use_pallas:
            d = distance_block(q, xc, metric=metric, valid=vc, x_sq_norms=nc)
        else:
            d = pairwise_distance(q, xc, metric=metric, x_sq_norms=nc)
            if vc is not None:
                d = torch.where(vc[None, :], d, torch.full_like(d, MASKED_DISTANCE))
        if allow_rows is not None:
            d = torch.where(allow_rows[:, lo:hi], d, torch.full_like(d, MASKED_DISTANCE))
        local_ids = (iota + (lo + id_offset)).expand(b, chunk_size)
        cat_d = torch.cat([best_d, d], dim=1)
        cat_i = torch.cat([best_i, local_ids], dim=1)
        best_d, best_i = topk_smallest(cat_d, cat_i, k)
    if row_ids is not None:
        remapped = row_ids[best_i.clamp(0, n - 1).long()].to(best_i.dtype)
        best_i = torch.where(best_i < 0, best_i, remapped)
    return best_d, best_i


def chunked_topk(q, x, k, chunk_size=8192, metric="l2-squared", valid=None,
                 x_sq_norms=None, id_offset=0, selection="exact",
                 allow_bits=None, allow_rows=None):
    """Convenience wrapper: any corpus size. When ``chunk_size`` does not
    divide N the corpus is padded with dead rows up to the next multiple
    (the store keeps capacity chunk-aligned and never pays this copy)."""
    n = x.shape[0]
    chunk_size = min(chunk_size, n) or 1
    rem = n % chunk_size
    if rem:
        pad = chunk_size - rem
        x = torch.cat([x, torch.zeros((pad, x.shape[1]), dtype=x.dtype, device=x.device)])
        if valid is None:
            valid = torch.arange(n + pad, device=x.device) < n
        else:
            valid = torch.cat([valid, torch.zeros(pad, dtype=valid.dtype, device=x.device)])
        if x_sq_norms is not None:
            x_sq_norms = torch.cat([x_sq_norms, torch.zeros(pad, dtype=x_sq_norms.dtype,
                                                            device=x.device)])
    return chunked_topk_distances(
        q, x, k, chunk_size, metric, valid, x_sq_norms, id_offset,
        selection=selection, allow_bits=allow_bits, allow_rows=allow_rows)
