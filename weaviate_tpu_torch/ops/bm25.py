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
host implementations are the parity oracle. A dispatch stacks its
operands into one host buffer, sends it with one copy and, on the card,
replays the plane expansion, scoring, top-k and fusion as a CUDA graph
(``hybrid_program``).

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

import math
import threading
from collections import OrderedDict
from types import SimpleNamespace

import numpy as np
import torch

from weaviate_tpu_torch.ops.candidates import masked_candidate_topk
from weaviate_tpu_torch.ops.distances import MASKED_DISTANCE
from weaviate_tpu_torch.ops.kernels import (MASK_BLOCK, as_bits_tensor, bm25_block,
                                            count_launches, pack_allow_bitmask,
                                            recording_launches)

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


def _padded_shape(ops, b_pad: int):
    """(B, S, T, C) of a stacked batch: the rows, segments and terms
    bucket to pow2, the candidates to MASK_BLOCK multiples."""
    live = [op for op in ops if op is not None]
    c_pad = _bucket(max((len(op.slots) for op in live), default=1), MASK_BLOCK)
    s_pad = _bucket(max((op.seg_tf.shape[0] for op in live), default=1), 8)
    t_pad = _bucket(max((len(op.idf) for op in live), default=1), 8)
    return max(b_pad, len(ops)), s_pad, t_pad, c_pad


def stack_sparse_operands(ops, b_pad: int) -> dict:
    """Stack per-row operands (entries may be None — pure-vector rows)
    into one padded batch dict of host arrays. Shapes bucket to pow2, the
    candidate axis pads to MASK_BLOCK multiples and liveness packs
    block-strided for the kernel."""
    b_pad, s_pad, t_pad, c_pad = _padded_shape(ops, b_pad)
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


# -- the dispatch's operands: one page-locked buffer, the planes compact -----
#
# A dispatch sends the batch in ONE copy: the small operands at their
# padded shapes, then each row's [S_i, C_i] tf and len blocks back to back
# (no padding: the planes are most of the bytes, and most of the padded
# planes are zero). The device expands the planes to [B, S, C].

#: the shape (segments, terms, candidates) a dispatch on the card is padded
#: up to when its operands fit in it, so that a few CUDA graphs (one per
#: batch size, dense depth and k) serve every dispatch that fits; any
#: other runs eagerly. Padding more adds exactly nothing: a segment with
#: tf 0 adds +0.0, a term with idf 0 adds +0.0, a dead candidate column
#: never surfaces.
GRAPH_SHAPE = (64, 32, 4096)

_TORCH_DTYPES = {np.dtype(np.float32): torch.float32, np.dtype(np.int32): torch.int32,
                 np.dtype(np.uint32): torch.int32, np.dtype(np.int64): torch.int64,
                 np.dtype(np.bool_): torch.bool}


def _dispatch_layout(b_pad: int, s_pad: int, t_pad: int, c_pad: int, n: int):
    """(name, dtype, shape, fill, byte offset) of each operand in the one
    buffer, 16-byte aligned, and the buffer's bytes. ``rows`` holds each
    row's (S_i, C_i, offset of its blocks), ``planes`` the tf blocks then
    the len blocks (n elements each)."""
    f32, i32 = np.float32, np.int32
    fields = (
        ("slots", i32, (b_pad, c_pad), -1),
        ("cand_bits", np.uint32, (b_pad, c_pad // 32), 0),
        ("seg_term", i32, (b_pad, s_pad), 0),
        ("seg_boost", f32, (b_pad, s_pad), 0.0),
        ("seg_avg", f32, (b_pad, s_pad), 1.0),
        ("idf", f32, (b_pad, t_pad), 0.0),
        ("k1", f32, (b_pad,), 1.0),
        ("b", f32, (b_pad,), 0.0),
        ("omb", f32, (b_pad,), 1.0),
        ("alpha", f32, (b_pad,), 1.0),   # pad rows: dense-only
        ("kind", i32, (b_pad,), 0),
        ("fetch", i32, (b_pad,), 1),
        ("is_hybrid", np.bool_, (b_pad,), False),
        ("rows", np.int64, (b_pad, 3), 0),
        ("n", np.int64, (1,), 0),
        ("planes", f32, (2 * max(n, 1),), 0.0),
    )
    out, off = [], 0
    for name, dt, shape, fill in fields:
        out.append((name, dt, shape, fill, off))
        off += -(-math.prod(shape) * np.dtype(dt).itemsize // 16) * 16
    return out, off


def _views(buf, layout, numpy: bool) -> dict:
    out = {}
    for name, dt, shape, _fill, off in layout:
        size = math.prod(shape) * np.dtype(dt).itemsize
        if numpy:
            out[name] = buf[off:off + size].view(dt).reshape(shape)
        else:
            out[name] = buf[off:off + size].view(_TORCH_DTYPES[np.dtype(dt)]).view(shape)
    return out


def stack_dispatch_operands(ops, b_pad: int, shape=None, pin: bool = False) -> dict:
    """One dispatch's operands (entries of ``ops`` may be None — pure-vector
    rows) in ONE uint8 host buffer (page-locked from PyTorch's caching host
    allocator when ``pin``): the arrays of ``stack_sparse_operands`` save
    the two planes, which go compact. ``shape`` (S, T, C), when the
    operands fit in it, replaces their own pow2 buckets. Returns the
    buffer, the padded (B, S, T, C) and n, the elements of each plane's
    compact blocks."""
    b_pad, s_pad, t_pad, c_pad = _padded_shape(ops, b_pad)
    if shape is not None and s_pad <= shape[0] and t_pad <= shape[1] and c_pad <= shape[2]:
        s_pad, t_pad, c_pad = shape
    n = sum(op.seg_tf.size for op in ops if op is not None)
    layout, nbytes = _dispatch_layout(b_pad, s_pad, t_pad, c_pad, n)
    buf = torch.empty(nbytes, dtype=torch.uint8, pin_memory=pin)
    out = _views(buf.numpy(), layout, numpy=True)
    for name, _dt, _shape, fill, _off in layout:
        if name != "planes":
            out[name].fill(fill)
    planes, off = out["planes"], 0
    for row, op in enumerate(ops):
        if op is None:
            continue
        s, c = op.seg_tf.shape
        t = len(op.idf)
        out["slots"][row, :c] = op.slots
        out["seg_term"][row, :s] = op.seg_term
        out["seg_boost"][row, :s] = op.seg_boost
        out["seg_avg"][row, :s] = op.seg_avg
        out["idf"][row, :t] = op.idf
        out["k1"][row] = op.k1
        out["b"][row] = op.b
        out["omb"][row] = op.one_minus_b
        out["alpha"][row] = op.alpha
        out["kind"][row] = op.fusion
        out["fetch"][row] = op.fetch
        out["is_hybrid"][row] = True
        out["rows"][row] = (s, c, off)
        planes[off:off + s * c] = op.seg_tf.ravel()
        planes[n + off:n + off + s * c] = op.seg_len.ravel()
        off += s * c
    out["n"][0] = n
    # block-strided candidate liveness (MASK_BLOCK discipline)
    out["cand_bits"][...] = pack_allow_bitmask(out["slots"] >= 0, c_pad)
    return {"buffer": buf, "shape": (b_pad, s_pad, t_pad, c_pad), "n": n}


def _expand_planes(planes, rows, n, s_pad: int, c_pad: int):
    """[B, S, C] tf and len from the rows' compact blocks: row i's block
    at its offset, zero past (S_i, C_i)."""
    dev = planes.device
    s = torch.arange(s_pad, device=dev)[None, :, None]
    c = torch.arange(c_pad, device=dev)[None, None, :]
    s_i, c_i, off = (rows[:, j, None, None] for j in range(3))
    live = (s < s_i) & (c < c_i)
    idx = torch.where(live, off + s * c_i + c, 0)
    zero = torch.zeros((), dtype=planes.dtype, device=dev)
    return torch.where(live, planes[idx], zero), torch.where(live, planes[idx + n], zero)


def _device_operands(dev, pack: dict, n_cap: int) -> dict:
    """The operands of ``hybrid_topk`` from the buffer's copy ``dev``
    (whose planes region holds 2 * n_cap floats): views of it, and the
    two planes expanded to [B, S, C]."""
    b_pad, s_pad, t_pad, c_pad = pack["shape"]
    layout, _ = _dispatch_layout(b_pad, s_pad, t_pad, c_pad, n_cap)
    out = _views(dev, layout, numpy=False)
    out["seg_tf"], out["seg_len"] = _expand_planes(out.pop("planes"), out.pop("rows"),
                                                   out.pop("n"), s_pad, c_pad)
    return out


def dispatch_to_device(pack: dict, device) -> dict:
    """``stack_dispatch_operands``' buffer on ``device`` in ONE copy
    (non-blocking from page-locked memory, on the current stream) and the
    operands of ``hybrid_topk`` made from it. On the CPU the views share
    the host buffer."""
    return _device_operands(pack["buffer"].to(device, non_blocking=True), pack, pack["n"])


#: bytes per [B, S, C] element that a graph's private pool may hold for
#: the plane expansion (``_expand_planes``: a bool, three int64 and four
#: f32 intermediates), on top of its operand buffer
_EXPAND_BYTES = 1 + 3 * 8 + 4 * 4


def graph_bytes(shape) -> int:
    """The device bytes a CUDA graph of ``hybrid_topk`` at the padded
    (B, S, T, C) ``shape`` holds at most: its operand buffer (planes for
    the full shape) and the plane expansion's intermediates. An estimate
    from above; the [B, C]-sized rest of the program is small beside it."""
    b_pad, s_pad, _t, c_pad = shape
    _, nbytes = _dispatch_layout(*shape, b_pad * s_pad * c_pad)
    return nbytes + b_pad * s_pad * c_pad * _EXPAND_BYTES


class _HybridGraphs:
    """``hybrid_topk`` on the card as CUDA graphs, one per (batch, dense
    depth, k) of a dispatch padded to ``GRAPH_SHAPE``: the plane expansion,
    the kernel, the sparse top-k and the fusion (~110 small launches)
    replay for the host cost of a handful, and the host is what a fused
    dispatch waits on. Any other shape runs eagerly.

    A call copies its operands into the graph's own buffers, replays it
    and clones the outputs on the caller's stream, then records an event
    there; the next call of that graph, from any stream, makes its copies
    wait for that event, so a replay still reading the buffers is never
    overwritten. The first call of a key runs the program eagerly (its
    answer), then captures it on a side stream.

    The graphs together hold at most ``max_bytes`` (``graph_bytes``, an
    estimate from above): the least recently used go first, and a key
    whose graph alone would not fit runs eagerly."""

    MAX_BYTES = 2 << 30

    def __init__(self, max_bytes: int = MAX_BYTES):
        self.max_bytes = max_bytes
        self.bytes = 0
        self._graphs: OrderedDict = OrderedDict()  # least recently used first
        self._lock = threading.Lock()

    def _admit(self, key, nbytes: int) -> bool:
        """Make room for a graph of ``nbytes`` under ``key``, evicting the
        least recently used (each after its last replay has finished);
        False when it alone exceeds the budget."""
        if nbytes > self.max_bytes:
            return False
        while self.bytes + nbytes > self.max_bytes:
            _key, old = self._graphs.popitem(last=False)
            old.done.synchronize()
            self.bytes -= old.nbytes
        return True

    def __call__(self, dn_d, dn_i, pack: dict, k: int):
        dev = dn_d.device
        if pack["shape"][1:] != GRAPH_SHAPE:
            return hybrid_topk(dn_d, dn_i, dispatch_to_device(pack, dev), k)
        key = (dev.index, k, tuple(dn_d.shape), dn_d.dtype, tuple(dn_i.shape), dn_i.dtype,
               pack["shape"])
        cur = torch.cuda.current_stream(dev)
        with self._lock:
            g = self._graphs.get(key)
            if g is not None:
                self._graphs.move_to_end(key)
                cur.wait_event(g.done)
                g.dn_d.copy_(dn_d)
                g.dn_i.copy_(dn_i)
                g.buf[:pack["buffer"].numel()].copy_(pack["buffer"], non_blocking=True)
                g.graph.replay()
                count_launches(g.launches)
                out = g.out_d.clone(), g.out_i.clone()
                g.done.record(cur)
                return out
            nbytes = graph_bytes(pack["shape"])
            if not self._admit(key, nbytes):
                return hybrid_topk(dn_d, dn_i, dispatch_to_device(pack, dev), k)
            b_pad, s_pad, _t, c_pad = pack["shape"]
            n_cap = b_pad * s_pad * c_pad  # the most planes the shape can hold
            _, buf_bytes = _dispatch_layout(*pack["shape"], n_cap)
            g = SimpleNamespace(buf=torch.zeros(buf_bytes, dtype=torch.uint8, device=dev),
                                dn_d=dn_d.clone(), dn_i=dn_i.clone(),
                                graph=torch.cuda.CUDAGraph(), done=torch.cuda.Event(),
                                nbytes=nbytes)
            g.buf[:pack["buffer"].numel()].copy_(pack["buffer"], non_blocking=True)
            # this call's answer, launched as usual; it also warms the ops up
            out = hybrid_topk(g.dn_d, g.dn_i, _device_operands(g.buf, pack, n_cap), k)
            side = torch.cuda.Stream(dev)
            side.wait_stream(cur)
            with torch.cuda.stream(side), recording_launches() as names:
                g.graph.capture_begin(capture_error_mode="thread_local")
                try:
                    g.out_d, g.out_i = hybrid_topk(
                        g.dn_d, g.dn_i, _device_operands(g.buf, pack, n_cap), k)
                finally:
                    g.graph.capture_end()
            cur.wait_stream(side)
            g.done.record(cur)
            g.launches = tuple(names)
            self._graphs[key] = g
            self.bytes += nbytes
            return out


_GRAPHS = _HybridGraphs()


def hybrid_graph_bytes() -> int:
    """The device bytes the cached hybrid graphs hold (``graph_bytes``)."""
    return _GRAPHS.bytes


def hybrid_program(dn_d, dn_i, pack: dict, k: int):
    """The fused hybrid program of one dispatch: ``stack_dispatch_operands``'
    buffer sent in one copy, then ``hybrid_topk`` against the dense leg's
    device-resident (dn_d, dn_i). On the card it replays a CUDA graph of
    the program at ``GRAPH_SHAPE`` (``_HybridGraphs``), on the caller's
    stream; on the CPU, and at any other shape, it runs it as is. No host
    synchronisation."""
    if dn_d.device.type != "cuda":
        return hybrid_topk(dn_d, dn_i, dispatch_to_device(pack, dn_d.device), k)
    return _GRAPHS(dn_d, dn_i, pack, k)
