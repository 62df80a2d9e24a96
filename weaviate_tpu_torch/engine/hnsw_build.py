"""Bulk construction for HNSW (port of ``weaviate_tpu/engine/hnsw_build.py``).

The reference builds its graph by incremental insert (hnsw/insert.go:226):
each vector runs an ef-search against the partial graph, one vector at a
time. A bulk build of an EMPTY index instead turns construction into
batched work:

1. **kNN graph**: every node's ``knn_k`` nearest neighbors come from an
   exact scan. On the card (``index.device`` CUDA, layers above
   ``_HOST_KNN_MAX`` members) that is the ``fused_topk_scan`` kernel over
   a bf16 copy of the layer, 1,024 queries (corpus rows) a launch, through
   ``ops/topk.chunked_topk_distances(selection="fused")``; on the CPU the
   JAX package's host path (``_host_knn`` up to ``_CPU_HOST_KNN_MAX``).
2. **Vectorized diversity heuristic**: selectNeighborsHeuristic
   (heuristic.go) run batched over thousands of owners at once with a
   running dominated mask, nearest-first backfill included.
3. **Symmetrize + prune**: reverse edges join the forward links and the
   union is re-pruned with the same heuristic (insert.go's connectNeighbor
   shrink path, in bulk).

On the card the whole layer pipeline stays there (``_device_link_layer``:
knn -> self-drop -> select -> symmetrize -> select, torch ops around the
kernel; the JAX package runs the same stages as XLA programs); only the
final [M, budget] link table comes back. The result fills the SAME
``HNSWIndex`` structures the incremental path uses.
"""

from __future__ import annotations

import logging
import os
import time

import numpy as np
import torch

logger = logging.getLogger(__name__)

#: seconds per stage of the last bulk build, summed over its layers
#: (knn, self_drop, select1, symmetrize, select2, download on the card's
#: layers; host_layers; link_write), read by ``chip_smoke.py``
BUILD_STAGE_SECONDS: dict[str, float] = {}


def _batched_heuristic(cand_d: np.ndarray, pair: np.ndarray, budget: int,
                       valid: np.ndarray | None = None) -> np.ndarray:
    """Diversity-select ``budget`` neighbors per row.

    cand_d [B, C] distances owner->candidate; pair [B, C, C] candidate
    pairwise distances; valid [B, C] optional candidate mask. Returns
    [B, budget] indices into C (-1 padded). Matches
    HNSWIndex._select_heuristic semantics including nearest-first backfill
    of pruned candidates.
    """
    b, c = cand_d.shape
    d = cand_d.copy()
    if valid is not None:
        d[~valid] = np.inf
    order = np.argsort(d, axis=1, kind="stable")
    d_s = np.take_along_axis(d, order, axis=1)
    rows_ix = np.arange(b)[:, None, None]
    pair_s = pair[rows_ix, order[:, :, None], order[:, None, :]]

    dominated = np.zeros((b, c), dtype=bool)
    selected = np.zeros((b, c), dtype=bool)
    count = np.zeros(b, dtype=np.int64)
    rows = np.arange(b)
    for _step in range(min(budget, c)):
        avail = ~dominated & ~selected & np.isfinite(d_s)
        first = np.argmax(avail, axis=1)
        has = avail[rows, first] & (count < budget)
        r = rows[has]
        if len(r) == 0:
            break
        f = first[has]
        selected[r, f] = True
        count[has] += 1
        dominated[r] |= pair_s[r, :, f] <= d_s[r]
    # backfill pruned (dominated, unselected) nearest-first up to budget
    need = budget - count
    if np.any(need > 0):
        fillable = dominated & ~selected & np.isfinite(d_s)
        # rank fillable candidates by position (already distance-sorted)
        prio = np.where(fillable, np.arange(c)[None, :], c)
        fill_order = np.argsort(prio, axis=1, kind="stable")
        fill_rank = np.empty_like(fill_order)
        np.put_along_axis(fill_rank, fill_order,
                          np.arange(c)[None, :].repeat(b, 0), axis=1)
        take = fillable & (fill_rank < need[:, None])
        selected |= take
    # emit selected positions (sorted by distance), mapped back through
    # ``order`` to original candidate indices
    out = np.full((b, budget), -1, dtype=np.int64)
    sel_prio = np.where(selected, np.arange(c)[None, :], c)
    sel_sorted = np.argsort(sel_prio, axis=1, kind="stable")
    n_sel = selected.sum(axis=1)
    width = min(budget, c)
    picks = sel_sorted[:, :width]
    orig = np.take_along_axis(order, picks, axis=1)
    keep = np.arange(width)[None, :] < n_sel[:, None]
    out[:, :width] = np.where(keep, orig, -1)
    return out


def _pairwise_block(vecs: np.ndarray, metric: str) -> np.ndarray:
    """pair [B, C, C] distances between candidate rows [B, C, d].

    np.matmul (batched BLAS) — a 3-operand einsum here falls back to
    numpy's generic loop and is ~50x slower at [1024, 192, 192, 128]."""
    if metric in ("l2-squared", "dot", "cosine", "cosine-dot"):
        dots = np.matmul(vecs, vecs.transpose(0, 2, 1))
        if metric == "l2-squared":
            sq = np.einsum("bcd,bcd->bc", vecs, vecs)
            return sq[:, :, None] - 2.0 * dots + sq[:, None, :]
        if metric == "dot":
            return -dots
        return 1.0 - dots
    if metric == "manhattan":
        return np.abs(vecs[:, :, None, :] - vecs[:, None, :, :]).sum(-1)
    return (vecs[:, :, None, :] != vecs[:, None, :, :]).sum(-1).astype(
        np.float32)


def _owner_dists(owner: np.ndarray, cands: np.ndarray, metric: str):
    """[B, d] x [B, C, d] -> [B, C] distances."""
    if metric in ("l2-squared", "dot", "cosine", "cosine-dot"):
        dots = np.matmul(cands, owner[:, :, None])[:, :, 0]
        if metric == "l2-squared":
            o = np.einsum("bd,bd->b", owner, owner)
            c = np.einsum("bcd,bcd->bc", cands, cands)
            return o[:, None] - 2.0 * dots + c
        if metric == "dot":
            return -dots
        return 1.0 - dots
    if metric == "manhattan":
        return np.abs(cands - owner[:, None, :]).sum(-1)
    return (cands != owner[:, None, :]).sum(-1).astype(np.float32)


# host-BLAS knn ceiling on the card: above this the device path wins
_HOST_KNN_MAX = 8192
# CPU ceiling: the JAX package's host path up to here, its chunked scan
# above
_CPU_HOST_KNN_MAX = 65536
# owners per vectorized step of the select on the card: the step loop's
# kernels are tiny, so a wide block keeps the launches few ([8192, 128,
# 128] f32 pair matrices, 0.5 GB). Every owner's result is independent of
# the block it rides in.
_DEVICE_SELECT_BLOCK = 8192


def _on_card(device) -> bool:
    """The device link pipeline runs when the index's device is CUDA (the
    JAX package's ``_device_backend()``: the backend is a TPU)."""
    return torch.device(device).type == "cuda"


def _sync(device) -> None:
    if _on_card(device):
        torch.cuda.synchronize(device)


def _select_block(xd, cand_blk, owners, budget: int, metric: str):
    """Diversity-select for one block of owners on ``xd``'s device.

    xd [n, d] layer vectors (bf16 on the card: the scan-precision copy),
    cand_blk [B, C] candidate positions (-1 padded), owners [B, d] their
    rows. Every product accumulates in f32 from the rows widened to f32.
    Returns [B, budget] selected positions (-1 padded), int32. The same
    semantics as ``_batched_heuristic``; the sorts are stable, so equal
    distances (and the equal priorities of unselected columns) resolve to
    the lower column, as ``lax.top_k`` resolves them."""
    b, c = cand_blk.shape
    valid = cand_blk >= 0
    safe = cand_blk.clamp(0, xd.shape[0] - 1).long()
    cvecs = xd[safe].float()  # [B, C, d]
    of = owners.float()
    dots = torch.bmm(cvecs, cvecs.transpose(1, 2))  # [B, C, C]
    od = torch.bmm(cvecs, of[:, :, None])[:, :, 0]  # [B, C]
    if metric == "l2-squared":
        sq = (cvecs * cvecs).sum(dim=-1)
        pair = sq[:, :, None] - 2.0 * dots + sq[:, None, :]
        osq = (of * of).sum(dim=-1)
        cand_d = osq[:, None] - 2.0 * od + sq
    elif metric == "dot":
        pair = -dots
        cand_d = -od
    else:  # cosine family: rows normalized upstream
        pair = 1.0 - dots
        cand_d = 1.0 - od
    cand_d = torch.where(valid, cand_d, torch.full_like(cand_d, float("inf")))
    # sort candidates by owner distance
    d_s, order = torch.sort(cand_d, dim=1, stable=True)
    pair_s = torch.gather(torch.gather(pair, 1, order[:, :, None].expand(b, c, c)),
                          2, order[:, None, :].expand(b, c, c))
    iota_c = torch.arange(c, device=xd.device)[None, :].expand(b, c)
    finite = torch.isfinite(d_s)
    dominated = torch.zeros((b, c), dtype=torch.bool, device=xd.device)
    selected = torch.zeros((b, c), dtype=torch.bool, device=xd.device)
    count = torch.zeros((b,), dtype=torch.int32, device=xd.device)
    no_col = torch.full_like(iota_c, c)
    for _step in range(min(budget, c)):
        avail = ~dominated & ~selected & finite
        # the first available column (the smallest available position: no
        # reliance on which maximum an argmax returns)
        first = torch.where(avail, iota_c, no_col).amin(dim=1)
        has = (first < c) & (count < budget)
        first = first.clamp(max=c - 1)
        selected |= (iota_c == first[:, None]) & has[:, None]
        count += has.to(torch.int32)
        pcol = torch.gather(pair_s, 2, first[:, None, None].expand(b, c, 1))[:, :, 0]
        dominated |= (pcol <= d_s) & has[:, None]
    # nearest-first backfill of pruned candidates up to budget
    need = budget - count
    fillable = dominated & ~selected & finite
    fill_rank = torch.cumsum(fillable.to(torch.int32), dim=1) - 1
    selected |= fillable & (fill_rank < need[:, None])
    # emit selected (distance order), mapped back through `order`
    sel_prio = torch.where(selected, iota_c, no_col)
    prio_s, picks = torch.sort(sel_prio, dim=1, stable=True)
    width = min(budget, c)
    got = prio_s[:, :width] < c
    orig = torch.gather(order, 1, picks[:, :width])
    out = torch.where(got, torch.gather(safe, 1, orig),
                      torch.full_like(orig, -1)).to(torch.int32)
    if budget > c:
        out = torch.cat([out, torch.full((b, budget - c), -1, dtype=torch.int32,
                                         device=xd.device)], dim=1)
    return out


def _device_select(xd, cand, budget, metric, qb=1024):
    """Blocked selection over all owners on ``xd``'s device; returns a
    device tensor [M, budget] int32. Owners are the first cand.shape[0]
    rows of xd. ``qb`` owners form one vectorized block (the JAX package's
    ``lax.map`` block); the result of each owner does not depend on it."""
    m = cand.shape[0]
    outs = []
    for s in range(0, m, qb):
        rows = min(qb, m - s)
        outs.append(_select_block(xd, cand[s:s + rows], xd[s:s + rows],
                                  budget, metric))
    return torch.cat(outs, dim=0) if len(outs) > 1 else outs[0]


def _self_drop(kd, keep: int):
    """Drop self-hits, keep ``keep`` columns: a stable sort by is-self
    pushes non-self candidates to the front in distance order."""
    n = kd.shape[0]
    self_col = (kd == torch.arange(n, device=kd.device)[:, None]).to(torch.int32)
    order = torch.sort(self_col, dim=1, stable=True).indices
    return torch.gather(kd, 1, order)[:, :keep].to(torch.int32)


def _device_symmetrize(fwd):
    """Union forward links with reverse edges (cap budget each way): one
    stable sort of the edge list + a position-in-group scatter, then a
    per-row dedup (first occurrence wins). The vectorized twin of the host
    path in ``_link_layer``. Reverse edges past a row's ``budget`` are
    never written (the JAX program writes them out of bounds, dropped)."""
    m, budget = fwd.shape
    dev = fwd.device
    fwd = fwd.to(torch.int64)
    src = torch.arange(m, device=dev).repeat_interleave(budget)
    dst = fwd.reshape(-1)
    dst = torch.where(dst >= 0, dst, torch.full_like(dst, m))  # dead edges last
    dst_s, order = torch.sort(dst, stable=True)
    src_s = src[order]
    starts = torch.searchsorted(dst_s, torch.arange(m, device=dev))
    pos = torch.arange(dst_s.shape[0], device=dev) - starts[dst_s.clamp(0, m - 1)]
    keep = (dst_s < m) & (pos < budget)
    union = torch.full((m, 2 * budget), -1, dtype=torch.int64, device=dev)
    union[:, :budget] = fwd
    tgt = dst_s * (2 * budget) + budget + pos
    union.view(-1)[tgt[keep]] = src_s[keep]
    # dedup per row (first occurrence wins)
    srt_val, srt_idx = torch.sort(union, dim=1, stable=True)
    dup_sorted = torch.cat([
        torch.zeros((m, 1), dtype=torch.bool, device=dev),
        (srt_val[:, 1:] == srt_val[:, :-1]) & (srt_val[:, 1:] >= 0)], dim=1)
    dup = torch.zeros_like(dup_sorted).scatter_(1, srt_idx, dup_sorted)
    return torch.where(dup, torch.full_like(union, -1), union).to(torch.int32)


def _host_knn(sub: np.ndarray, k_eff: int, metric: str,
              block: int = 4096) -> np.ndarray:
    """Small member sets (upper layers): exact knn on host BLAS."""
    n = len(sub)
    if metric == "l2-squared":
        sq = np.einsum("nd,nd->n", sub, sub)
    out = np.empty((n, k_eff), dtype=np.int64)
    for s in range(0, n, block):
        qb = sub[s:s + block]
        dots = qb @ sub.T
        if metric == "l2-squared":
            d = sq[s:s + block, None] - 2.0 * dots + sq[None, :]
        elif metric == "dot":
            d = -dots
        elif metric in ("cosine", "cosine-dot"):
            d = 1.0 - dots
        elif metric == "manhattan":
            d = np.abs(qb[:, None, :] - sub[None, :, :]).sum(-1)
        else:
            d = (qb[:, None, :] != sub[None, :, :]).sum(-1).astype(np.float32)
        part = np.argpartition(d, k_eff - 1, axis=1)[:, :k_eff]
        pd = np.take_along_axis(d, part, axis=1)
        out[s:s + block] = np.take_along_axis(
            part, np.argsort(pd, axis=1, kind="stable"), axis=1)
    return out


def _device_knn(sub: np.ndarray, k_eff: int, metric: str, device,
                query_block: int = 1024, chunk_size: int = 16384,
                return_device: bool = False):
    """Full-layer knn on ``device``: the layer's rows are the queries,
    ``query_block`` (at most 1,024) of them per scan.

    On the card the scan runs the ``fused_topk_scan`` kernel over a bf16
    copy of the layer (the JAX package's TPU choice; l2 norms from the f32
    rows), its distances folded into an exact top-k with ties to the lower
    row. On the CPU it is the chunked exact scan over f32 rows in
    ``chunk_size`` chunks (the JAX package's CPU path).

    ``return_device=True`` returns (scan-precision rows, knn ids [n, k]
    int32) still on the device for the link pipeline; otherwise the ids
    come back as an [n, k] int64 numpy array."""
    from weaviate_tpu_torch.ops.topk import chunked_topk_distances
    from weaviate_tpu_torch.runtime.hbm_ledger import ledger as _hbm

    device = torch.device(device)
    n = len(sub)
    card = _on_card(device)
    query_block = min(query_block, 1024, n)
    xd = torch.from_numpy(np.ascontiguousarray(sub, dtype=np.float32)).to(device)
    norms = (xd * xd).sum(dim=-1) if metric == "l2-squared" else None
    if card:
        xscan, valid, cs, selection = xd.to(torch.bfloat16), None, n, "fused"
        del xd
    else:
        cs = min(chunk_size, 1 << (n - 1).bit_length())
        pad_rows = -(-n // cs) * cs - n
        xscan = torch.cat([xd, torch.zeros((pad_rows, xd.shape[1]),
                                           dtype=xd.dtype, device=device)])
        valid = torch.arange(n + pad_rows, device=device) < n
        if norms is not None:
            norms = torch.cat([norms, torch.zeros(pad_rows, device=device)])
        selection = "approx"
    # build-time scratch: ledger-tracked for as long as the tensor lives
    _hbm.track("build_scratch", xscan)
    parts = []
    for s in range(0, n, query_block):
        _d, i = chunked_topk_distances(
            xscan[s:s + query_block], xscan, k=k_eff, chunk_size=cs,
            metric=metric, valid=valid, x_sq_norms=norms,
            selection=selection, use_pallas=card)
        parts.append(i)
    knn = torch.cat(parts) if len(parts) > 1 else parts[0]
    if return_device:
        return xscan[:n], knn
    return knn.cpu().numpy().astype(np.int64)


def _knn_graph(vectors: np.ndarray, members: np.ndarray, knn_k: int,
               metric: str, device) -> np.ndarray:
    """For each member, its knn_k nearest OTHER members (positions into
    ``members``)."""
    sub = vectors[members]
    n = len(sub)
    k_eff = min(knn_k + 1, n)
    supported = metric in ("l2-squared", "dot", "cosine", "cosine-dot")
    # host BLAS for small layers; the device scan above the ceiling
    host_cap = _HOST_KNN_MAX if _on_card(device) else _CPU_HOST_KNN_MAX
    if not supported or n <= host_cap:
        if not supported and n > _CPU_HOST_KNN_MAX:
            logger.warning(
                "hnsw bulk build: %d-row layer falls back to the exact "
                "O(n^2 d) host BLAS knn — metric %r has no device scan",
                n, metric)
        out = _host_knn(sub, k_eff, metric)
    else:
        out = _device_knn(sub, k_eff, metric, device)
    # drop self-hits, keep knn_k columns: stable-sort by is_self pushes
    # non-self candidates to the front preserving distance order
    self_col = out == np.arange(n)[:, None]
    order = np.argsort(self_col, axis=1, kind="stable")
    res = np.take_along_axis(out, order, axis=1)[:, : min(knn_k, n - 1)]
    return res


def _device_link_layer(vectors: np.ndarray, members: np.ndarray,
                       knn_k: int, budget: int, metric: str,
                       device) -> np.ndarray:
    """Device-resident knn -> self-drop -> select -> symmetrize -> select
    for one layer: the [M, C] candidate tensors never leave the card; only
    the final [M, budget] link table comes back. The selects run on the
    scan-precision (bf16) rows with f32 accumulation, as the JAX package's
    do. Returns positions into ``members`` (-1 padded). Each stage's
    seconds add to ``BUILD_STAGE_SECONDS`` (``WEAVIATE_TPU_BUILD_TRACE=1``
    prints them)."""
    trace = os.environ.get("WEAVIATE_TPU_BUILD_TRACE") == "1"

    def _t(label, fn):
        t0 = time.perf_counter()
        out = fn()
        _sync(device)  # the stage's kernels done before the clock reads
        dt = time.perf_counter() - t0
        BUILD_STAGE_SECONDS[label] = BUILD_STAGE_SECONDS.get(label, 0.0) + dt
        if trace:
            print(f"    [build-trace] {label:12s} {dt:7.2f}s", flush=True)
        return out

    sub = vectors[members]
    n = len(sub)
    k_eff = min(knn_k + 1, n)
    xd, knn_dev = _t("knn", lambda: _device_knn(
        sub, k_eff, metric, device, return_device=True))
    knn_dev = _t("self_drop", lambda: _self_drop(knn_dev, min(knn_k, n - 1)))
    fwd = _t("select1", lambda: _device_select(
        xd, knn_dev, budget, metric, qb=_DEVICE_SELECT_BLOCK))
    union = _t("symmetrize", lambda: _device_symmetrize(fwd))
    final = _t("select2", lambda: _device_select(
        xd, union, budget, metric, qb=_DEVICE_SELECT_BLOCK))
    return _t("download", lambda: final.cpu().numpy())


def bulk_build(index, doc_ids, vectors: np.ndarray, knn_k: int = 64,
               query_block: int = 1024) -> None:
    """Populate an EMPTY HNSWIndex from scratch.

    Layer l links every node with level >= l against the other members of
    that layer using exact kNN candidates + the diversity heuristic +
    symmetrize/prune, on the card for layers above ``_HOST_KNN_MAX``
    members when ``index.device`` is CUDA, on the host otherwise. Per-link
    WAL writes are skipped; one condensed snapshot lands at the end (same
    durability fixed point, condensor.go:27).
    """
    doc_ids = np.asarray(doc_ids, dtype=np.int64)
    vectors = index._norm(np.asarray(vectors, dtype=np.float32))
    n = len(vectors)
    if len(doc_ids) != n:
        raise ValueError(f"{len(doc_ids)} ids != {n} vectors")
    if len(index) != 0:
        raise RuntimeError("bulk_build requires an empty index")
    BUILD_STAGE_SECONDS.clear()
    with index._lock:
        index._grow(n)
        # vectorized geometric level sampling, seeded from the index RNG
        # (the JAX package's draw, so one seed gives the same levels)
        rng = np.random.default_rng(int(index._rng.random() * 2**63))
        levels = (-np.log(np.maximum(rng.random(n), 1e-12))
                  * index._ml).astype(np.int32)
        index._vecs[:n] = vectors
        index._levels[:n] = levels
        index._doc_ids[:n] = doc_ids
        index._id_to_slot = {int(d): s for s, d in enumerate(doc_ids)}
        index._count = n
        max_level = int(levels.max())
        for layer in range(max_level + 1):
            members = np.nonzero(levels >= layer)[0]
            if len(members) == 0:
                continue
            if len(members) == 1:
                s = int(members[0])
                links = index._links[s]
                while len(links) <= layer:
                    links.append(np.empty(0, dtype=np.int32))
                continue
            budget = index.m0 if layer == 0 else index.m
            use_device = (
                len(members) > _HOST_KNN_MAX
                and index.metric in ("l2-squared", "dot",
                                     "cosine", "cosine-dot")
                and _on_card(index.device))
            if use_device:
                # 48 candidates on the device path (the JAX package's
                # choice: recall-equivalent to 64, the scan's selection
                # cost grows with k; symmetrize refills the budget)
                fwd = _device_link_layer(vectors, members, min(48, knn_k),
                                         budget, index.metric, index.device)
            else:
                t0 = time.perf_counter()
                knn = _knn_graph(vectors, members, knn_k, index.metric,
                                 index.device)
                fwd = _link_layer(index, vectors, members, knn, budget,
                                  query_block)
                BUILD_STAGE_SECONDS["host_layers"] = (
                    BUILD_STAGE_SECONDS.get("host_layers", 0.0)
                    + time.perf_counter() - t0)
            t0 = time.perf_counter()
            _write_links(index, members, fwd, layer)
            BUILD_STAGE_SECONDS["link_write"] = (
                BUILD_STAGE_SECONDS.get("link_write", 0.0)
                + time.perf_counter() - t0)
        # entrypoint: any node at the top level
        top = int(np.nonzero(levels == max_level)[0][0])
        index._ep = top
        index._max_level = max_level
        # vectors/levels/links were written past the native mirror — one
        # batched re-upload on next use
        index._native_dirty = True
        if index._log is not None:
            index.condense()


def _host_select(sub, owner_pos, cand_idx, budget, metric, query_block):
    """Blocked host-side heuristic selection (small layers, and metrics
    without a scan kernel). Returns [M, budget] member positions, -1
    padded."""
    m_count, c = cand_idx.shape
    out = np.full((m_count, budget), -1, dtype=np.int64)
    for s in range(0, m_count, query_block):
        blk = cand_idx[s:s + query_block]
        valid = blk >= 0
        safe = np.clip(blk, 0, len(sub) - 1)
        cvecs = sub[safe]
        pair = _pairwise_block(cvecs, metric)
        cand_d = _owner_dists(sub[owner_pos[s:s + query_block]], cvecs,
                              metric)
        sel = _batched_heuristic(cand_d, pair, budget, valid=valid)
        take = sel >= 0
        safe_sel = np.clip(sel, 0, c - 1)
        out[s:s + query_block] = np.where(
            take, np.take_along_axis(safe, safe_sel, axis=1), -1)
    return out


def _link_layer(index, vectors, members, knn, budget, query_block):
    """Heuristic-select forward links, symmetrize, shrink to budget.
    ``knn`` holds positions into ``members``; returns [M, budget] positions
    into ``members`` (-1 padded)."""
    metric = index.metric
    m_count, c = knn.shape
    sub = vectors[members]
    owner_pos = np.arange(m_count)

    # the host path: small layers (every layer on the CPU), where the
    # selection's gathers cost less on host BLAS than a device dispatch
    fwd = _host_select(sub, owner_pos, knn, budget, metric, query_block)

    # symmetrize: reverse edges via one argsort pass, then cap the union
    # at 2*budget nearest before the final heuristic prune
    src = np.repeat(np.arange(m_count), budget)
    dst = fwd.reshape(-1)
    live = dst >= 0
    src, dst = src[live], dst[live]
    order = np.argsort(dst, kind="stable")
    dst_sorted, src_sorted = dst[order], src[order]
    starts = np.searchsorted(dst_sorted, np.arange(m_count))
    c2 = budget
    union = np.full((m_count, budget + c2), -1, dtype=np.int64)
    union[:, :budget] = fwd
    # vectorized ragged fill: position-within-group scatter, capped at c2
    if len(dst_sorted):
        pos_in_group = np.arange(len(dst_sorted)) - starts[dst_sorted]
        keep = pos_in_group < c2
        union[dst_sorted[keep], budget + pos_in_group[keep]] = \
            src_sorted[keep]
    # dedup rows keeping the first occurrence (stable argsort groups equal
    # values in original order, so repeats after the first flag as dups)
    srt_idx = np.argsort(union, axis=1, kind="stable")
    srt_val = np.take_along_axis(union, srt_idx, axis=1)
    dup_sorted = np.zeros_like(srt_val, dtype=bool)
    dup_sorted[:, 1:] = (srt_val[:, 1:] == srt_val[:, :-1]) & \
        (srt_val[:, 1:] >= 0)
    dup = np.zeros_like(dup_sorted)
    np.put_along_axis(dup, srt_idx, dup_sorted, axis=1)
    union[dup] = -1
    # final shrink runs the FULL diversity heuristic over the capped union
    # — nearest-truncation here was 30% cheaper but collapsed recall@10
    # from 1.00 to 0.69 on 200k gaussian (the diversity property of the
    # reverse-merge is load-bearing, exactly why the reference's
    # connectNeighbor shrink path re-runs its heuristic)
    return _host_select(sub, owner_pos, union, budget, metric, query_block)


def _write_links(index, members, links_pos, layer):
    """Store [M, budget] member-position links as slot-id arrays."""
    for i, slot in enumerate(members.tolist()):
        row = links_pos[i]
        row = row[row >= 0]
        slots = members[row].astype(np.int32)
        lk = index._links[slot]
        while len(lk) <= layer:
            lk.append(np.empty(0, dtype=np.int32))
        lk[layer] = slots
