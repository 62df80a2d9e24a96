"""The device candidate plane (port of ``weaviate_tpu/ops/candidates.py``).

Score a bounded candidate set instead of the whole corpus, on the device,
and return the exact top-k over it:

- ``masked_candidate_topk`` — the shared finishing move: exact top-k over
  (vals, ids) with masked winners normalized to -1 ids.
- ``gather_rescore_topk`` — per-query candidate sets [B, C]: one batched
  row gather [B, C, d], one batched distance, masked exact top-k. The
  quantized store rescores its oversampled candidates this way when its
  full-precision rows live on the card (``rescore="device"``).
- ``shared_candidates_topk`` — ONE candidate slot set shared by the whole
  batch, the store's cutover for highly selective filters
  (``engine/store.py``): gather the bucket once to [C, d], run the
  standard chunked scan over it (its kernels included), and remap the
  bucket-local winners to global slots on the device, so the host finish
  step only pads. Total work is O(B·C), not O(B·N).
"""

from __future__ import annotations

import torch

from weaviate_tpu_torch.ops.distances import MASKED_DISTANCE, normalize
from weaviate_tpu_torch.ops.kernels import allow_bits_for_ids
from weaviate_tpu_torch.ops.topk import chunked_topk_distances, topk_smallest


def masked_candidate_topk(vals: torch.Tensor, ids: torch.Tensor, k: int):
    """Exact top-k over ``(vals [B, M], ids [B, M])`` whose dead entries
    already carry MASKED_DISTANCE; masked winners get id -1. Ties resolve
    to the lower index."""
    fd, fi = topk_smallest(vals, ids, k)
    fi = torch.where(fd >= MASKED_DISTANCE, torch.full_like(fi, -1), fi)
    return fd, fi


def gather_rescore_topk(q, cand_idx, rows, k: int, metric: str, *,
                        ids_of_row=None, row_norms=None, valid=None,
                        allow_bits=None):
    """Exact top-k over per-query candidate sets, one gather and one
    batched product.

    ``q`` [B, d] f32; ``cand_idx`` [B, C] (or [1, C], broadcast) int
    gather indices into ``rows`` [N, d]; negative indices are empty
    padding. ``ids_of_row`` [N] optionally maps row positions to the
    global ids reported (and folded against ``allow_bits``). ``valid``
    [N] bool masks dead rows; ``allow_bits`` [B or 1, W] int32 is the
    packed per-query allow mask over global ids. Returns ``(dists
    [B, k'], ids [B, k'])`` ascending with k' = min(k, C), tails
    (MASKED_DISTANCE, -1). Cosine queries are normalized here; ``rows``
    are expected pre-normalized (the store invariant)."""
    b = q.shape[0]
    n = rows.shape[0]
    c = cand_idx.shape[1]
    idx = cand_idx.to(torch.int64).expand(b, c)
    safe = idx.clamp(0, n - 1)
    live = (idx >= 0) & (idx < n)
    g = rows[safe].float()  # [B, C, d]
    q32 = q.float()
    if metric in ("cosine", "cosine-dot"):
        q32 = normalize(q32)
    dots = torch.einsum("bd,bcd->bc", q32, g)
    if metric == "l2-squared":
        g_norms = (row_norms[safe].float() if row_norms is not None
                   else (g * g).sum(dim=-1))
        q_norms = (q32 * q32).sum(dim=-1, keepdim=True)
        d = torch.clamp(q_norms - 2.0 * dots + g_norms, min=0.0)
    elif metric == "dot":
        d = -dots
    else:  # cosine family: rows and q unit-norm -> distance 1 - cos
        d = 1.0 - dots
    minus1 = torch.full_like(idx, -1)
    if ids_of_row is not None:
        ids = torch.where(live, ids_of_row[safe].to(torch.int64), minus1)
    else:
        ids = torch.where(live, idx, minus1)
    ok = live & (ids >= 0)
    if valid is not None:
        ok = ok & valid[safe]
    if allow_bits is not None:
        ok = ok & allow_bits_for_ids(allow_bits, ids)
    d = torch.where(ok, d, torch.full_like(d, MASKED_DISTANCE))
    return masked_candidate_topk(d, ids.to(torch.int32), min(k, c))


def shared_candidates_topk(q, cand_slots, rows, k: int, metric: str, *,
                           row_norms=None, valid=None, use_pallas=False,
                           selection: str = "exact"):
    """Top-k over ``cand_slots`` [C] int32 global slots (-1 padding, C a
    power of two) of ``rows`` [N, d]. Returns (dists [B, k'], slots
    [B, k']) with k' = min(k, C), global slot ids straight off the scan."""
    n = rows.shape[0]
    slots = cand_slots.to(device=rows.device, dtype=torch.int32)
    safe = slots.clamp(0, n - 1).long()
    live = (slots >= 0) & (slots < n)
    g_rows = torch.where(live[:, None], rows[safe], torch.zeros((), dtype=rows.dtype,
                                                                device=rows.device))
    g_valid = live if valid is None else live & valid[safe]
    g_norms = None
    if metric == "l2-squared":
        g_norms = (row_norms[safe].float() if row_norms is not None
                   else (g_rows.float() ** 2).sum(dim=-1))
    return chunked_topk_distances(
        q, g_rows.contiguous(), k=min(k, slots.shape[0]),
        chunk_size=slots.shape[0], metric=metric, valid=g_valid,
        x_sq_norms=g_norms, use_pallas=use_pallas, selection=selection,
        row_ids=slots)
