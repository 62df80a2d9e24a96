"""Batched distances on tensors (port of ``weaviate_tpu/ops/distances.py``).

Reference semantics (adapters/repos/db/vector/hnsw/distancer/):
- ``l2-squared``  sum((a-b)^2)
- ``dot``         -dot(a, b)  (negated so that lower = closer)
- ``cosine``      1 - dot(a, b) with both vectors pre-normalized at insert
- ``hamming``     count of positions where a[i] != b[i] (float vectors)
- ``manhattan``   sum(|a-b|)

Layout convention: queries ``q`` are [B, d], corpus ``x`` is [N, d], the
result is [B, N] float32 distances (lower = closer), whatever the storage
dtype (bf16 storage is widened and accumulated in f32).

Precision: the JAX package asks XLA for ``Precision.HIGHEST`` on f32
operands. On a CUDA card a float32 matmul may run in TF32 (about three
decimal digits) when ``torch.backends.cuda.matmul.allow_tf32`` is on, so
this module turns it off when it is imported: every f32 product here is
exact float32, as the reference's is.
"""

from __future__ import annotations

import numpy as np
import torch

# Full float32 products, never TF32 (the reference asks for HIGHEST).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DISTANCE_METRICS = ("l2-squared", "dot", "cosine", "cosine-dot", "hamming", "manhattan")

# Distance value used to mask out dead/unfilled corpus slots so they can
# never win a top-k. Finite (not +inf) so sorts stay sane.
MASKED_DISTANCE = float(np.float32(3.0e38))


def normalize(v: torch.Tensor, eps: float = 1e-30) -> torch.Tensor:
    """L2-normalize along the last axis; zero vectors pass through."""
    norm = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    return v / torch.where(norm > eps, norm, torch.ones_like(norm))


def normalize_np(v, eps: float = 1e-30):
    """Host-side twin of ``normalize`` for numpy operands that stay on
    the host: same zero-vector semantics, no device round trip."""
    v = np.asarray(v, dtype=np.float32)
    norm = np.linalg.norm(v, axis=-1, keepdims=True)
    return v / np.where(norm > eps, norm, np.float32(1.0))


def dot_matrix(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """[B,d]x[N,d] -> [B,N] inner products accumulated in f32. bf16
    storage is widened to f32 first: the product of two bf16 values is
    exact in f32, so the only rounding is the f32 sum's."""
    return q.float() @ x.float().T


def sq_norms(x: torch.Tensor) -> torch.Tensor:
    x32 = x.float()
    return (x32 * x32).sum(dim=-1)


def pairwise_distance(
    q: torch.Tensor,
    x: torch.Tensor,
    metric: str = "l2-squared",
    x_sq_norms: torch.Tensor | None = None,
) -> torch.Tensor:
    """Distances between every query in ``q`` [B,d] and every row of
    ``x`` [N,d] -> [B, N] float32, lower = closer for every metric.

    ``x_sq_norms`` is an optional precomputed [N] tensor of squared row
    norms (the corpus term of the l2 expansion) kept by the store."""
    if metric not in DISTANCE_METRICS:
        raise ValueError(f"unknown distance metric {metric!r}; expected one of {DISTANCE_METRICS}")

    if metric == "l2-squared":
        # ||q-x||^2 = ||q||^2 - 2 q.x + ||x||^2, clamped at 0 to hide
        # cancellation error for near-identical rows
        dots = dot_matrix(q, x)
        qn = sq_norms(q)[:, None]
        xn = (sq_norms(x) if x_sq_norms is None else x_sq_norms.float())[None, :]
        return torch.clamp(qn - 2.0 * dots + xn, min=0.0)

    if metric == "dot":
        return -dot_matrix(q, x)

    if metric in ("cosine", "cosine-dot"):
        # rows are normalized at insert; queries are normalized here
        return 1.0 - dot_matrix(normalize(q.float()), x)

    if metric == "hamming":
        # compare in the STORAGE dtype: with a bf16 store an f32 query
        # would never equal its own bf16-rounded row after promotion
        neq = (q.to(x.dtype)[:, None, :] != x[None, :, :]).float()
        return neq.sum(dim=-1)

    # manhattan
    diff = (q[:, None, :].float() - x[None, :, :].float()).abs()
    return diff.sum(dim=-1)


def single_distance(a, b, metric: str = "l2-squared") -> torch.Tensor:
    """Distance between two single vectors [d], [d] -> 0-d float32
    tensor (the reference's ``SingleDist``, distancer/provider.go)."""
    a = torch.as_tensor(a)
    b = torch.as_tensor(b, device=a.device)
    return pairwise_distance(a[None, :], b[None, :], metric=metric)[0, 0]
