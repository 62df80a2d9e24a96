"""Top-k selection over large corpora (port of ``weaviate_tpu/ops/topk.py``).

- ``chunked_topk_distances``: scan an [N] axis in fixed-size chunks,
  carrying a running top-k — peak memory O(B * chunk), not O(B * N).
- ``merge_topk``: merge candidate sets into a final top-k.

Distances follow the "lower = closer" convention. Every selection here is
exact with ties to the lower position, the rule ``lax.top_k`` follows
(``torch.topk`` does not promise it, so selection goes through
``kernels.smallest_positions``).

``selection="approx"`` has no PyTorch analogue (``lax.approx_max_k`` is
the TPU's bucketed argmin). It maps to the exact running selection: the
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
    MASK_BLOCK,
    _check_kernel_operands,
    as_bits_tensor,
    distance_block,
    distance_block_prepared,
    distance_query,
    fused_topk_pairs,
    fused_topk_pairs_plain,
    fused_topk_scan,
    smallest_positions,
    unpack_allow_bitmask,
)
from weaviate_tpu_torch.runtime.kernelscope import kernel_span


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


@kernel_span("chunked_topk")
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

    ``use_pallas`` keeps the JAX package's name: True runs the distances
    through the ``distance_block`` kernel. ``selection``:

    - ``"exact"`` / ``"approx"``: an exact running top-k over groups of
      consecutive chunks (``grouped_scan_topk``; ``scan_group_chunks``
      sizes the groups), the answer of a per-chunk loop bit for bit (see
      the module docstring for approx).
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
    group = scan_group_chunks(q.shape[0], chunk_size, num_chunks, k,
                              allow_bits is not None or allow_rows is not None)
    return grouped_scan_topk(q, x, k, chunk_size, group, metric, valid, x_sq_norms,
                             id_offset, use_pallas, allow_bits, allow_rows, row_ids)


# -- the grouped chunk loop of selections "approx" / "exact" ------------------
#
# The corpus is scanned in groups of consecutive chunks: one distance
# launch over a group's rows, one exact top-k of the group and one merge
# into the running top-k, so a 1M-row scan at 8192-row chunks runs 16
# groups, not 128 rounds of ~15 small ops. A running exact top-k over
# ascending rows with ties to the lower row does not depend on how the
# rows are grouped, so the answers equal the per-chunk loop's bit for bit.
#
# Scratch budget of one group, at the largest drain: 256 MiB, a few
# percent of the card's memory beside the corpus, and 8 chunks of 8192
# rows at B = 256. Per (query, row) entry a group holds its distance
# (f32), its position (i32, built once per call), the NaN guard's int32
# bits and selection value (f32); a filter adds its unpacked column (i32
# word bits and a bool), and k past the pairs kernel's 256 the plain
# selection's int64 keys and their temporaries.
SCAN_GROUP_BYTES = 256 << 20
_ENTRY_BYTES = 16
_FILTER_BYTES = 5
_PLAIN_SELECT_BYTES = 24
# At most 65,536 rows a group: at small drains a group is cut into few
# 16,384-row parts, one pairs CTA each, and wider groups only lengthen the
# merge that follows.
SCAN_GROUP_MAX_ROWS = 1 << 16
# widest row the pairs kernel stages in shared memory (its STAGE_MAX); a
# group's rows are selected in parts this wide
PAIRS_STAGED_ROWS = 16384
_NEG_INF_BITS = -(1 << 23)  # int32 bits of -inf (0xff800000)


def scan_group_chunks(b: int, chunk_size: int, num_chunks: int, k: int,
                      filtered: bool) -> int:
    """Chunks per group of the grouped scan for a [b, d] query block:
    as many as ``SCAN_GROUP_BYTES`` and ``SCAN_GROUP_MAX_ROWS`` allow,
    at least one."""
    per = _ENTRY_BYTES + (_FILTER_BYTES if filtered else 0) \
        + (_PLAIN_SELECT_BYTES if k > FUSED_PAIRS_MAX_K else 0)
    fit = SCAN_GROUP_BYTES // (max(b, 1) * chunk_size * per)
    return max(1, min(fit, SCAN_GROUP_MAX_ROWS // chunk_size, num_chunks))


def _allow_columns(allow_bits, allow_rows, lo: int, hi: int) -> torch.Tensor:
    """[Ba, hi - lo] bool allow columns of rows [lo, hi): from the packed
    words (only the MASK_BLOCK blocks that cover the rows are unpacked) or
    the bool rows; columns past either are disallowed."""
    if allow_rows is not None:
        cols = allow_rows[:, lo:hi]
    else:
        blk0, blk1 = lo // MASK_BLOCK, -(-hi // MASK_BLOCK)
        words = allow_bits[:, blk0 * 16:blk1 * 16]
        cols = unpack_allow_bitmask(words)[:, lo - blk0 * MASK_BLOCK:hi - blk0 * MASK_BLOCK]
    if cols.shape[1] < hi - lo:
        pad = torch.zeros((cols.shape[0], hi - lo - cols.shape[1]), dtype=torch.bool,
                          device=cols.device)
        cols = torch.cat([cols, pad], dim=1)
    return cols.bool()


def _split_parts(m: int) -> int:
    """Rows of a group's selection are cut into this many equal parts of
    at most ``PAIRS_STAGED_ROWS`` (the least such count up to twice the
    fewest, that divides m), so each part runs the pairs kernel from
    shared memory; 1 (one part, read from L2) when none divides m."""
    least = -(-m // PAIRS_STAGED_ROWS)
    for p in range(least, 2 * least + 1):
        if m % p == 0:
            return p
    return 1


def grouped_scan_topk(q, x, k: int, chunk_size: int, group_chunks: int,
                      metric: str = "l2-squared", valid=None, x_sq_norms=None,
                      id_offset: int = 0, use_pallas: bool = False,
                      allow_bits=None, allow_rows=None, row_ids=None):
    """The exact running top-k of ``chunked_topk_distances`` (selections
    "approx" / "exact"), ``group_chunks`` chunks a group.

    Exact order is the int32 order of each distance's float bits (-0.0 as
    +0.0), then the row. It puts three classes of entry in turn: NaN with
    the sign bit set (below -inf), then the live values (below
    MASKED_DISTANCE: finite, or -inf), then the k (MASKED_DISTANCE, -1)
    slots the running top-k starts from, which every later MASKED, larger,
    or positive-NaN entry follows and never passes. So the answer is the
    negative NaNs in order, then the live values in order, then those
    slots. The live values go through ``fused_topk_pairs`` (the pairs
    kernel on the card; past its k <= 256 its plain version), which keeps
    exactly them, ties to the lower position: first over a group's rows
    cut into parts the kernel stages in shared memory, then over [running
    k | the parts' k each], in row order. The negative NaNs go through a
    second such selection over their bits inverted into non-negative
    floats, which orders them as the exact order does. That guard is left
    out where no negative NaN can arise: distance_block on the card with
    a valid mask, whose epilogue adds 0 or MASKED to every value, and the
    card's arithmetic returns its canonical NaN, which is positive
    (``chip_smoke.py`` phase 2 holds this to the per-chunk loop)."""
    n = x.shape[0]
    b = q.shape[0]
    dev = x.device
    select = fused_topk_pairs if 1 <= k <= FUSED_PAIRS_MAX_K else fused_topk_pairs_plain
    if allow_rows is None and allow_bits is not None:
        allow_bits = as_bits_tensor(allow_bits, dev)
    elif allow_rows is not None:
        allow_rows = allow_rows.bool()
    nan_guard = not (use_pallas and dev.type == "cuda" and valid is not None)
    # on the card the query operands are prepared once, not once a group
    prepared = None
    if use_pallas and dev.type == "cuda":
        _check_kernel_operands(q, x, metric, valid, x_sq_norms)
        prepared = distance_query(q, metric)
    rows = group_chunks * chunk_size
    positions = {}  # part width -> [B * parts, width] row positions, built once per call
    masked = torch.tensor(MASKED_DISTANCE, dtype=torch.float32).view(torch.int32).item()
    live_d = torch.full((b, k), MASKED_DISTANCE, dtype=torch.float32, device=dev)
    live_i = torch.full((b, k), -1, dtype=torch.int32, device=dev)
    nan_d, nan_i = live_d, live_i

    def merge(best_d, best_i, vals, lo):
        m = vals.shape[1]
        parts = _split_parts(m)
        width = m // parts
        pos = positions.get(width)
        if pos is None or pos.shape[0] < b * parts:
            pos = torch.arange(width, dtype=torch.int32, device=dev).expand(
                b * max(parts, rows // width), width).contiguous()
            positions[width] = pos
        gd, gi = select(vals.reshape(b * parts, width), pos[:b * parts], k)
        base = torch.arange(parts, dtype=torch.int32, device=dev).repeat_interleave(k) * width
        gi = gi.reshape(b, parts * k)
        gi = torch.where(gi >= 0, gi + (base + (lo + id_offset))[None, :], gi)
        return select(torch.cat([best_d, gd.reshape(b, parts * k)], 1),
                      torch.cat([best_i, gi], 1), k)

    for lo in range(0, n, rows):
        hi = min(n, lo + rows)
        xc = x[lo:hi]
        vc = None if valid is None else valid[lo:hi]
        nc = None if x_sq_norms is None else x_sq_norms[lo:hi]
        if prepared is not None:
            d = distance_block_prepared(prepared, xc, metric=metric, valid=vc, x_sq_norms=nc)
        elif use_pallas:
            d = distance_block(q, xc, metric=metric, valid=vc, x_sq_norms=nc)
        else:
            d = pairwise_distance(q, xc, metric=metric, x_sq_norms=nc)
            if vc is not None:
                d = torch.where(vc[None, :], d, torch.full_like(d, MASKED_DISTANCE))
        if allow_bits is not None or allow_rows is not None:
            d = torch.where(_allow_columns(allow_bits, allow_rows, lo, hi), d,
                            torch.full_like(d, MASKED_DISTANCE))
        live_d, live_i = merge(live_d, live_i, d, lo)
        if nan_guard:
            bits = d.view(torch.int32)
            neg_nan = (bits < 0) & (bits > _NEG_INF_BITS)
            inv = torch.where(neg_nan, torch.bitwise_not(bits), masked).view(torch.float32)
            nan_d, nan_i = merge(nan_d, nan_i, inv, lo)

    best_d, best_i = live_d, live_i
    if nan_guard:
        n_nan = (nan_d < MASKED_DISTANCE).sum(dim=1, keepdim=True)
        slot = torch.arange(k, device=dev)[None, :]
        from_nan = slot < n_nan
        at = (slot - n_nan).clamp(min=0)
        nan_vals = torch.bitwise_not(nan_d.view(torch.int32)).view(torch.float32)
        best_d = torch.where(from_nan, nan_vals, torch.gather(live_d, 1, at))
        best_i = torch.where(from_nan, nan_i, torch.gather(live_i, 1, at))
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
