"""Hybrid search fusion: merge sparse (BM25) and dense (vector) rankings
(a copy of ``weaviate_tpu/text/hybrid.py``).

Reference: usecases/traverser/hybrid/hybrid_fusion.go —
``FusionRanked`` (:22, reciprocal-rank fusion with alpha weights) and
``FusionRelativeScore`` (:87, min-max normalized score blending); the
orchestration (parallel sparse+dense searches) mirrors hybrid/searcher.go:74.

These are also the hybridplane's PARITY ORACLE: the device fusion merge
(ops/bm25.py::fuse_topk) must rank identically to these functions,
including the dict-insertion-order tie-break (sparse leg first, then
unseen dense entries). Both fusions return ``(score, result)`` pairs —
the input result objects are NEVER mutated, because they may be shared
across concurrent hybrid queries (two overlapping fusions writing
``res.score`` in place used to clobber each other's rankings).
"""

from __future__ import annotations


def fusion_ranked(result_sets: list[list], weights: list[float],
                  k: int = 10) -> list[tuple[float, object]]:
    """Reciprocal-rank fusion. Each result keeps its best contribution:
    score_i = sum over sets of weight / (60 + rank). Reference:
    hybrid_fusion.go:22 (the constant 60 is the reference's, :36).
    Returns ``(fused_score, result)`` pairs, best first; the result
    objects pass through untouched."""
    fused: dict[str, tuple[float, object]] = {}
    for results, weight in zip(result_sets, weights):
        for rank, res in enumerate(results):
            add = weight / (60.0 + rank)
            prev = fused.get(res.uuid)
            fused[res.uuid] = (add + (prev[0] if prev else 0.0),
                              prev[1] if prev else res)
    return sorted(fused.values(), key=lambda t: -t[0])[:k]


def fusion_relative_score(result_sets: list[list], weights: list[float],
                          k: int = 10) -> list[tuple[float, object]]:
    """Min-max normalize each set's scores to [0,1], blend by weight.
    Reference: hybrid_fusion.go:87 (FusionRelativeScore). Distances from
    the dense set must already be converted to similarity scores
    (higher = better) by the caller. Returns ``(fused_score, result)``
    pairs, best first; the result objects pass through untouched."""
    fused: dict[str, tuple[float, object]] = {}
    for results, weight in zip(result_sets, weights):
        if not results:
            continue
        scores = [r.score for r in results]
        lo, hi = min(scores), max(scores)
        span = (hi - lo) or 1.0
        for res in results:
            norm = (res.score - lo) / span if hi > lo else 1.0
            add = weight * norm
            prev = fused.get(res.uuid)
            fused[res.uuid] = (add + (prev[0] if prev else 0.0),
                              prev[1] if prev else res)
    return sorted(fused.values(), key=lambda t: -t[0])[:k]
