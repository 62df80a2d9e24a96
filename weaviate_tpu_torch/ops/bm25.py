"""Device-resident BM25F scoring + sparse/dense hybrid fusion (port of
``weaviate_tpu/ops/bm25.py``).

The host MaxScore scorer (text/inverted.py) stays the PLANNER: it picks
which documents are worth shipping (the candidate universe = the allowed
union of every query term's postings, so the device top-k is provably
exact) and computes the per-term idf / per-prop average-length scalars.
The SCORING runs on the card: candidates pack into padded operands
(``SparseOperand`` / ``stack_sparse_operands``), the ``bm25_block`` CUDA
kernel scores them (``ops/kernels.py``; its plain version on the CPU),
the sparse top-k rides the shared candidate plane
(``ops/candidates.masked_candidate_topk``), and fusion with the dense leg
is a device merge (``fuse_topk``) that mirrors ``text/hybrid.py`` — the
host implementations are the parity oracle.

Layout (the ``pack_allow_bitmask`` MASK_BLOCK discipline):

- the candidate axis C pads to a pow2 >= 512 (a whole number of
  MASK_BLOCK column blocks); candidate liveness packs block-strided, the
  layout every masked kernel reads;
- per-(term, prop) posting segments land as dense [S, C] tf / prop-len
  planes over the candidate axis (only candidate columns, never corpus
  columns);
- per-segment scalars (term index, boost, prop avg-len) and per-term idf
  ride as small operands; b/k1 ship as f32 scalars per row.

Arithmetic parity: the host scorer accumulates in f32 with weakly-cast
Python-float scalars. The kernel reproduces the host op order exactly —
segments accumulate in pack order (prop order within the ub-sorted term
order), terms saturate and sum in ub order, and ``1 - b`` is pre-rounded
on the host (``one_minus_b``) so the same f32 value flows through both
paths. ``fuse_topk`` and ``hybrid_topk`` are plain torch, as they are
plain XLA in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from weaviate_tpu_torch.ops.candidates import masked_candidate_topk
from weaviate_tpu_torch.ops.distances import MASKED_DISTANCE
from weaviate_tpu_torch.ops.kernels import (MASK_BLOCK, as_bits_tensor, bm25_block,
                                            pack_allow_bitmask)

#: fusion kinds, matching text/hybrid.py's two reference implementations
FUSION_RANKED = 0
FUSION_RELATIVE = 1

#: reciprocal-rank fusion constant (hybrid_fusion.go:36 via text/hybrid.py)
RRF_K = 60.0


def fusion_kind(name: str) -> int:
    return FUSION_RELATIVE if name == "relativeScore" else FUSION_RANKED


class SparseOperand:
    """One hybrid query's host-packed sparse operands.

    Built by ``text/inverted.py::bm25_pack`` (+ the shard layer's
    doc-id -> store-slot translation); consumed by
    ``stack_sparse_operands`` at dispatch. All arrays are host numpy.
    """

    __slots__ = ("doc_ids", "slots", "seg_tf", "seg_len", "seg_term",
                 "seg_boost", "seg_avg", "idf", "k1", "b", "one_minus_b",
                 "alpha", "fusion", "fetch", "stats")

    def __init__(self, doc_ids, slots, seg_tf, seg_len, seg_term,
                 seg_boost, seg_avg, idf, k1, b, one_minus_b,
                 alpha, fusion, fetch, stats=None):
        self.doc_ids = doc_ids      # [C] int64, ascending
        self.slots = slots          # [C] int32 store slots
        self.seg_tf = seg_tf        # [S, C] f32
        self.seg_len = seg_len      # [S, C] f32
        self.seg_term = seg_term    # [S] int32 (ub-descending term order)
        self.seg_boost = seg_boost  # [S] f32
        self.seg_avg = seg_avg      # [S] f32 (per-prop avg_len)
        self.idf = idf              # [T] f32 (ub-descending term order)
        self.k1 = k1
        self.b = b
        self.one_minus_b = one_minus_b  # host-rounded f32(1.0 - b)
        self.alpha = alpha          # dense weight (host hybrid semantics)
        self.fusion = fusion        # FUSION_RANKED | FUSION_RELATIVE
        self.fetch = fetch          # per-leg depth: max(k * 10, 100)
        self.stats = dict(stats or {})


def _bucket(n: int, lo: int) -> int:
    p = lo
    while p < n:
        p *= 2
    return p


def stack_sparse_operands(ops, b_pad: int) -> dict:
    """Stack per-row operands (entries may be None — pure-vector rows)
    into one padded batch dict of host arrays. Shapes bucket to pow2, the
    candidate axis pads to MASK_BLOCK multiples and liveness packs
    block-strided for the kernel."""
    live = [op for op in ops if op is not None]
    c_pad = _bucket(max((len(op.slots) for op in live), default=1),
                    MASK_BLOCK)
    s_pad = _bucket(max((op.seg_tf.shape[0] for op in live), default=1), 8)
    t_pad = _bucket(max((len(op.idf) for op in live), default=1), 8)
    b_pad = max(b_pad, len(ops))

    slots = np.full((b_pad, c_pad), -1, np.int32)
    seg_tf = np.zeros((b_pad, s_pad, c_pad), np.float32)
    seg_len = np.zeros((b_pad, s_pad, c_pad), np.float32)
    seg_term = np.zeros((b_pad, s_pad), np.int32)
    seg_boost = np.zeros((b_pad, s_pad), np.float32)
    seg_avg = np.ones((b_pad, s_pad), np.float32)
    idf = np.zeros((b_pad, t_pad), np.float32)
    k1 = np.ones(b_pad, np.float32)
    b_arr = np.zeros(b_pad, np.float32)
    omb = np.ones(b_pad, np.float32)
    alpha = np.ones(b_pad, np.float32)   # pad rows: dense-only
    kind = np.zeros(b_pad, np.int32)
    fetch = np.ones(b_pad, np.int32)
    is_hybrid = np.zeros(b_pad, bool)
    for row, op in enumerate(ops):
        if op is None:
            continue
        c = len(op.slots)
        s = op.seg_tf.shape[0]
        t = len(op.idf)
        slots[row, :c] = op.slots
        seg_tf[row, :s, :c] = op.seg_tf
        seg_len[row, :s, :c] = op.seg_len
        seg_term[row, :s] = op.seg_term
        seg_boost[row, :s] = op.seg_boost
        seg_avg[row, :s] = op.seg_avg
        idf[row, :t] = op.idf
        k1[row] = op.k1
        b_arr[row] = op.b
        omb[row] = op.one_minus_b
        alpha[row] = op.alpha
        kind[row] = op.fusion
        fetch[row] = op.fetch
        is_hybrid[row] = True
    return {
        "slots": slots, "seg_tf": seg_tf, "seg_len": seg_len,
        "seg_term": seg_term, "seg_boost": seg_boost, "seg_avg": seg_avg,
        "idf": idf, "k1": k1, "b": b_arr, "omb": omb, "alpha": alpha,
        "kind": kind, "fetch": fetch, "is_hybrid": is_hybrid,
        # block-strided candidate liveness (MASK_BLOCK discipline): the
        # kernel reads it word by word instead of a dense [B, C] plane
        "cand_bits": pack_allow_bitmask(slots >= 0, c_pad),
    }


def pack_to_device(pack: dict, device) -> dict:
    """The stacked host arrays as tensors on ``device`` (``cand_bits`` as
    int32 words with the same bits)."""
    out = {}
    for name, arr in pack.items():
        if name == "cand_bits":
            out[name] = as_bits_tensor(arr, device)
        else:
            out[name] = torch.from_numpy(np.ascontiguousarray(arr)).to(device)
    return out


def bm25_neg_scores(seg_tf, seg_len, seg_term, seg_boost, seg_avg, idf,
                    k1, b, omb, cand_bits):
    """NEGATED BM25F scores [B, C] f32 over the candidate axis (negated +
    MASKED_DISTANCE padding so the result feeds the shared candidate
    top-k directly). Tensors on the card launch the ``bm25_block``
    kernel; CPU tensors take its plain version."""
    return bm25_block(seg_tf, seg_len, seg_term, seg_boost, seg_avg, idf,
                      k1, b, omb, cand_bits)


def fuse_topk(sp_neg, sp_ids, dn_d, dn_i, alpha, kind, fetch, k: int):
    """Device twin of ``text/hybrid.py`` fusion, one merged top-k.

    ``sp_neg``/``sp_ids`` [B, Fs]: the sparse leg as negated scores
    (ascending = best first, MASKED_DISTANCE + -1 = dead) over store
    slots; ``dn_d``/``dn_i`` [B, Fd]: the dense leg (distances
    ascending, -1 = dead). ``alpha`` [B] f32 is the dense weight,
    ``kind`` [B] int32 picks RRF vs relative-score per row, ``fetch``
    [B] int32 caps each leg's rank depth at the host's over-fetch so
    padded leg widths never change the fusion inputs.

    Parity with the host reference: leg presence follows the host's
    thread gating (sparse iff alpha < 1, dense iff alpha > 0), RRF adds
    ``w / (60 + rank)`` over 0-based ranks, relative-score min-max
    normalizes over the leg's live entries (``norm = 1`` when a leg is
    constant), and the merged tie-break is the host dict's insertion
    order — sparse entries first, then unmatched dense — via the
    concat + lower-index-wins top-k. Returns (neg_fused [B, k'],
    ids [B, k']) ascending by negated fused score, k' = min(k, Fs + Fd).
    """
    fs = sp_neg.shape[1]
    fd = dn_d.shape[1]
    dev = sp_neg.device
    rank_s = torch.arange(fs, dtype=torch.int32, device=dev)[None, :]
    rank_d = torch.arange(fd, dtype=torch.int32, device=dev)[None, :]
    sparse_on = (alpha < 1.0)[:, None]
    dense_on = (alpha > 0.0)[:, None]
    sp_ok = (sp_ids >= 0) & (sp_neg < MASKED_DISTANCE * 0.5) \
        & (rank_s < fetch[:, None]) & sparse_on
    dn_ok = (dn_i >= 0) & (dn_d < MASKED_DISTANCE * 0.5) \
        & (rank_d < fetch[:, None]) & dense_on
    sp_score = -sp_neg
    dn_score = -dn_d
    w_s = (1.0 - alpha)[:, None]
    w_d = alpha[:, None]
    zero = torch.zeros((), dtype=torch.float32, device=dev)

    # -- reciprocal-rank contributions (ranks are leg positions: both
    # legs arrive sorted with dead entries pushed past the live tail)
    rrf_s = w_s / (RRF_K + rank_s.float())
    rrf_d = w_d / (RRF_K + rank_d.float())

    # -- relative-score contributions: min-max over each leg's LIVE
    # entries; a constant leg normalizes to 1.0 (host: hi > lo gate)
    def _rel(score, ok, w):
        inf = torch.full_like(score, float("inf"))
        lo = torch.where(ok, score, inf).amin(dim=1, keepdim=True)
        hi = torch.where(ok, score, -inf).amax(dim=1, keepdim=True)
        span = hi - lo
        norm = torch.where(hi > lo,
                           (score - lo) / torch.where(span > 0.0, span,
                                                      torch.ones_like(span)),
                           torch.ones_like(score))
        return w * norm

    rel_s = _rel(sp_score, sp_ok, w_s)
    rel_d = _rel(dn_score, dn_ok, w_d)

    ranked = (kind == FUSION_RANKED)[:, None]
    c_s = torch.where(sp_ok, torch.where(ranked, rrf_s, rel_s), zero)
    c_d = torch.where(dn_ok, torch.where(ranked, rrf_d, rel_d), zero)

    # -- slot-match join: a doc in both legs keeps its SPARSE entry
    # (host dict insertion order) and absorbs the dense contribution; the
    # sum over the dense axis has at most one nonzero term, so it is exact
    eq = (sp_ids[:, :, None] == dn_i[:, None, :]) \
        & sp_ok[:, :, None] & dn_ok[:, None, :]        # [B, Fs, Fd]
    sp_tot = c_s + torch.where(eq, c_d[:, None, :], zero).sum(dim=2)
    matched_d = eq.any(dim=1)                           # [B, Fd]
    dn_keep = dn_ok & ~matched_d

    masked = torch.full((), MASKED_DISTANCE, dtype=torch.float32, device=dev)
    vals = torch.cat([torch.where(sp_ok, -sp_tot, masked),
                      torch.where(dn_keep, -c_d, masked)], dim=1)
    ids = torch.cat([sp_ids.to(torch.int32), dn_i.to(torch.int32)], dim=1)
    return masked_candidate_topk(vals, ids, min(k, vals.shape[1]))


def hybrid_topk(dn_d, dn_i, pack: dict, k: int):
    """The one batched hybrid program: score the packed sparse
    candidates, take the sparse top-leg through the shared candidate
    plane, fuse against the dense leg, and per-row select fused (hybrid
    rows) vs plain dense (pure-vector rows riding the same drain).

    ``dn_d``/``dn_i`` [B, F] are the dense scan's device-resident
    results over store slots (F >= both k and every row's fetch);
    ``pack`` is ``pack_to_device(stack_sparse_operands(...))`` on their
    device. Returns (dists [B, k], ids [B, k]): hybrid rows carry
    (-fused_score, slot), dense rows carry (distance, slot) — the
    caller's finish step resolves slots to doc ids for both."""
    neg = bm25_neg_scores(
        pack["seg_tf"], pack["seg_len"], pack["seg_term"],
        pack["seg_boost"], pack["seg_avg"], pack["idf"], pack["k1"],
        pack["b"], pack["omb"], pack["cand_bits"])
    fs = min(neg.shape[1], dn_d.shape[1])
    sp_neg, sp_ids = masked_candidate_topk(neg, pack["slots"], fs)
    f_d, f_i = fuse_topk(sp_neg, sp_ids, dn_d, dn_i, pack["alpha"],
                         pack["kind"], pack["fetch"], k)
    hyb = pack["is_hybrid"][:, None]
    out_d = torch.where(hyb, f_d[:, :k], dn_d[:, :k])
    out_i = torch.where(hyb, f_i[:, :k], dn_i[:, :k].to(f_i.dtype))
    return out_d, out_i
