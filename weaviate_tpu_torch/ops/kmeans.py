"""Coarse k-means for IVF partitioning (port of ``weaviate_tpu/ops/kmeans.py``).

Lloyd's iteration over FULL vectors learns the IVF coarse partition (the
reference trains PQ sub-quantizers per segment the same way,
compressionhelpers/kmeans.go). On the device the assign step is one
[chunk, k] distance product plus an argmin and the update an
``index_add_`` segment sum; the host loops over chunks and carries the
running sums. The sample and the initial centroids are drawn with numpy
exactly as the JAX package draws them, so one seed picks the same rows in
both packages.
"""

from __future__ import annotations

import numpy as np
import torch

from weaviate_tpu_torch.device import resolve
from weaviate_tpu_torch.ops.distances import pairwise_distance


def _assign_accumulate(chunk: torch.Tensor, centroids: torch.Tensor,
                       c_norms: torch.Tensor, k: int):
    """One chunk's Lloyd contribution:
    (assign [n] int32, assigned_dist [n], sums [k, d], counts [k]).
    Ties go to the lower centroid, as ``argmin`` resolves them in both
    packages."""
    d = pairwise_distance(chunk, centroids, metric="l2-squared",
                          x_sq_norms=c_norms)
    dmin, assign = torch.min(d, dim=1)
    sums = torch.zeros((k, chunk.shape[1]), dtype=torch.float32,
                       device=chunk.device)
    sums.index_add_(0, assign, chunk.float())
    counts = torch.bincount(assign, minlength=k).float()
    return assign.to(torch.int32), dmin, sums, counts


def kmeans_fit(vectors: np.ndarray, k: int, iters: int = 10,
               sample: int = 262_144, batch: int = 16_384,
               seed: int = 0, device=None) -> np.ndarray:
    """Train ``k`` full-dim centroids on ``device`` (default: the card);
    returns [k, d] f32 on the host.

    Trains on a random sample of at most ``sample`` rows, chunked so the
    device holds at most [batch, k] distances at a time."""
    device = resolve(device)
    vectors = np.asarray(vectors, dtype=np.float32)
    n, dim = vectors.shape
    if n < k:
        raise ValueError(f"need >= {k} vectors to train {k} centroids, have {n}")
    rng = np.random.default_rng(seed)
    if n > sample:
        vectors = vectors[rng.choice(n, sample, replace=False)]
        n = sample
    x = torch.from_numpy(np.ascontiguousarray(vectors)).to(device)
    centroids = x[torch.from_numpy(rng.choice(n, k, replace=False)).to(device)]
    for _ in range(iters):
        c_norms = (centroids * centroids).sum(dim=1)
        sums = torch.zeros((k, dim), dtype=torch.float32, device=device)
        counts = torch.zeros((k,), dtype=torch.float32, device=device)
        for s in range(0, n, batch):
            _, _, cs, cc = _assign_accumulate(x[s:s + batch], centroids,
                                              c_norms, k)
            sums = sums + cs
            counts = counts + cc
        fresh = sums / torch.clamp(counts, min=1.0)[:, None]
        centroids = torch.where((counts > 0)[:, None], fresh, centroids)
        counts_np = counts.cpu().numpy()
        if (counts_np == 0).any():
            centroids = _reseed_empty(vectors, x, centroids, counts_np, batch)
    return centroids.cpu().numpy()


def _reseed_empty(vectors: np.ndarray, x: torch.Tensor,
                  centroids: torch.Tensor, counts_np: np.ndarray,
                  batch: int) -> torch.Tensor:
    """Reseed EMPTY clusters from the farthest-assigned points of the
    fullest cluster (deterministic: ties break toward the lowest point
    index, no RNG). Without it a dead centroid stays empty every later
    iteration and the partition runs with fewer lists. ``vectors`` is the
    host sample, ``x`` the same rows on the device."""
    n = len(vectors)
    k = centroids.shape[0]
    empties = np.flatnonzero(counts_np == 0)
    fullest = int(np.argmax(counts_np))
    c_norms = (centroids * centroids).sum(dim=1)
    assign_all = np.empty(n, dtype=np.int32)
    dist_all = np.empty(n, dtype=np.float32)
    for s in range(0, n, batch):
        a, dm, _, _ = _assign_accumulate(x[s:s + batch], centroids, c_norms, k)
        assign_all[s:s + batch] = a.cpu().numpy()
        dist_all[s:s + batch] = dm.cpu().numpy()
    pool = np.flatnonzero(assign_all == fullest)
    # farthest first; lexsort's LAST key is primary, `pool` breaks ties
    order = pool[np.lexsort((pool, -dist_all[pool]))]
    chosen = list(order[: len(empties)])
    if len(chosen) < len(empties):
        # degenerate fullest cluster (fewer members than empty slots):
        # top up with the globally farthest-from-assigned points
        taken = set(chosen)
        for idx in np.argsort(-dist_all, kind="stable"):
            if int(idx) not in taken:
                chosen.append(int(idx))
                taken.add(int(idx))
                if len(chosen) == len(empties):
                    break
    cents = centroids.cpu().numpy().copy()
    cents[empties] = vectors[np.asarray(chosen, dtype=np.int64)]
    return torch.from_numpy(cents).to(centroids.device)


def kmeans_assign(vectors: np.ndarray, centroids: np.ndarray,
                  batch: int = 16_384, device=None) -> np.ndarray:
    """Nearest-centroid id per vector, [N] int32 on the host, computed on
    ``device`` (default: the card)."""
    device = resolve(device)
    vectors = np.asarray(vectors, dtype=np.float32)
    cent = torch.from_numpy(np.ascontiguousarray(
        centroids, dtype=np.float32)).to(device)
    c_norms = (cent * cent).sum(dim=1)
    k = cent.shape[0]
    out = np.empty(len(vectors), dtype=np.int32)
    for s in range(0, len(vectors), batch):
        chunk = torch.from_numpy(np.ascontiguousarray(vectors[s:s + batch])).to(device)
        a, _, _, _ = _assign_accumulate(chunk, cent, c_norms, k)
        out[s:s + batch] = a.cpu().numpy()
    return out
