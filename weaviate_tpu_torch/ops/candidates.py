"""Gathered low-selectivity scan (port of the shared-candidate half of
``weaviate_tpu/ops/candidates.py``).

``shared_candidates_topk`` scores ONE candidate slot set shared by the
whole batch — the store's cutover for highly selective filters
(``engine/store.py``): gather the bucket once to ``[C, d]``, run the
standard chunked scan over it (its kernels included), and remap the
bucket-local winners to global slots on the device, so the host finish
step only pads. Total work is O(B·C), not O(B·N).
"""

from __future__ import annotations

import torch

from weaviate_tpu_torch.ops.topk import chunked_topk_distances


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
