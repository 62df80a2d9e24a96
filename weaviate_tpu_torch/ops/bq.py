"""Binary quantization (BQ) on tensors (port of ``weaviate_tpu/ops/bq.py``).

Reference: adapters/repos/db/vector/compressionhelpers/binary_quantization.go
(sign bit per dimension packed into words, hamming distance via XOR +
popcount, full-precision rescore in the flat index, vector/flat/index.go:347).

Codes are packed sign bits, 32 to a word. torch has almost no uint32
arithmetic, so words live in int32 tensors holding the same bit pattern
(as the allow bitmasks do, ``ops/kernels.py``); numpy callers see them
as uint32 (``.view(np.uint32)``). The full scan goes through the
``bq_scan_reduce`` kernel (``use_pallas``, the name the JAX package uses
for "take the kernel path"); the exact XOR + popcount pass is the
fallback for the CPU and small corpora.
"""

from __future__ import annotations

import numpy as np
import torch

from weaviate_tpu_torch.ops.distances import MASKED_DISTANCE
from weaviate_tpu_torch.ops.kernels import (bq_scan_reduce, fused_topk_pairs,
                                            popcount32, unpack_allow_bitmask)
from weaviate_tpu_torch.ops.topk import _pad_k, select_survivors, topk_smallest

WORD_BITS = 32


def bq_words(dim: int) -> int:
    return -(-dim // WORD_BITS)


def bq_encode(vectors: torch.Tensor) -> torch.Tensor:
    """Pack sign bits: [N, d] float -> [N, ceil(d/32)] int32 words.

    Bit j of word w is set iff vectors[:, w*32+j] >= 0 (the reference
    uses the sign bit the same way, binary_quantization.go:30)."""
    n, d = vectors.shape
    w = bq_words(d)
    bits = (vectors >= 0).to(torch.int64)
    if w * WORD_BITS != d:
        bits = torch.nn.functional.pad(bits, (0, w * WORD_BITS - d))
    shifts = torch.arange(WORD_BITS, dtype=torch.int64, device=vectors.device)
    words = (bits.reshape(n, w, WORD_BITS) << shifts).sum(dim=-1)
    # the sum is < 2**32; fold into int32's range keeping the bit pattern
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)


def hamming(q_words: torch.Tensor, x_words: torch.Tensor) -> torch.Tensor:
    """Exact hamming [B, N] (int64) between packed rows q [B, W] and x
    [N, W]: XOR + popcount, one word at a time."""
    q = q_words.to(torch.int64) & 0xFFFFFFFF
    x = x_words.to(torch.int64) & 0xFFFFFFFF
    out = torch.zeros((q.shape[0], x.shape[0]), dtype=torch.int64, device=x.device)
    for j in range(q.shape[1]):
        out += popcount32(q[:, j, None] ^ x[None, :, j])
    return out


def _auto_reduce_l(n: int) -> int:
    """Strided-reduction factor: keep >= ~16k candidate slots so the
    birthday-bound top-k loss stays negligible, cap at the kernel's 64."""
    l = max(1, min(n // 16384, 64))
    return 1 << (l.bit_length() - 1)


def bq_topk(q_words: torch.Tensor, x_words: torch.Tensor, k: int,
            chunk_size: int = 0, valid: torch.Tensor | None = None,
            id_offset: int = 0, use_pallas: bool = False,
            reduce_l: int | None = None, selection: str = "approx",
            allow_bits: torch.Tensor | None = None):
    """Hamming top-k over packed words: q [B, W], x [N, W] int32 words.

    ``use_pallas`` takes the ``bq_scan_reduce`` kernel (strided
    block-argmin, then one survivor selection over the N/L candidates:
    ``"fused"`` through ``fused_topk_pairs``, else exact). The fallback
    is the exact chunked XOR + popcount pass. The kernel path keeps one
    winner per ``reduce_l`` rows, so the two paths differ by that loss;
    production callers oversample and rescore. ``allow_bits`` [B, W_a]
    packed per-query allow words."""
    n, w = x_words.shape
    b = q_words.shape[0]
    if use_pallas:
        rl = reduce_l if reduce_l is not None else _auto_reduce_l(n)
        vals, ids = bq_scan_reduce(q_words, x_words, valid=valid, reduce_l=rl,
                                   allow_bits=allow_bits)
        return select_survivors(vals, ids, k, selection, id_offset)

    dev = x_words.device
    allow_rows = None
    if allow_bits is not None:
        allow_rows = unpack_allow_bitmask(allow_bits, n)
    chunk_size = min(chunk_size or 8192, n)
    best_d = torch.full((b, k), MASKED_DISTANCE, dtype=torch.float32, device=dev)
    best_i = torch.full((b, k), -1, dtype=torch.int32, device=dev)
    num_chunks = -(-n // chunk_size)
    for c in range(num_chunks):
        lo = c * chunk_size
        hi = min(n, lo + chunk_size)
        d = hamming(q_words, x_words[lo:hi]).float()
        if hi - lo < chunk_size:  # dead padding rows, as the reference pads
            d = torch.nn.functional.pad(d, (0, chunk_size - (hi - lo)),
                                        value=MASKED_DISTANCE)
        if valid is not None:
            vc = torch.zeros(chunk_size, dtype=torch.bool, device=dev)
            vc[:hi - lo] = valid[lo:hi]
            d = torch.where(vc[None, :], d, torch.full_like(d, MASKED_DISTANCE))
        if allow_rows is not None:
            ac = torch.zeros((b, chunk_size), dtype=torch.bool, device=dev)
            ac[:, :hi - lo] = allow_rows[:, lo:hi]
            d = torch.where(ac, d, torch.full_like(d, MASKED_DISTANCE))
        ids = (torch.arange(chunk_size, dtype=torch.int32, device=dev)
               + (lo + id_offset)).expand(b, chunk_size)
        best_d, best_i = topk_smallest(torch.cat([best_d, d], dim=1),
                                       torch.cat([best_i, ids], dim=1), k)
        best_i = torch.where(best_d >= MASKED_DISTANCE, torch.full_like(best_i, -1),
                             best_i)
    return best_d, best_i


def bq_topk_twostage(q_words: torch.Tensor, x_words: torch.Tensor,
                     x_prefix_t: torch.Tensor, k: int, refine: int = 8,
                     valid: torch.Tensor | None = None, id_offset: int = 0,
                     use_pallas: bool = True, selection: str = "approx",
                     allow_bits: torch.Tensor | None = None):
    """Two-stage BQ scan for the capacity regime: stage 1 scans the
    contiguous transposed prefix ``x_prefix_t`` [Wp, N] (the first 32*Wp
    sign bits of every row) and keeps refine*k candidates per query;
    stage 2 gathers their full rows from ``x_words`` [N, W] and scores
    exact hamming. ``selection="fused"`` makes the stage-1 refine go
    through ``fused_topk_pairs`` (refine*k <= 256)."""
    n, w = x_words.shape
    wp = x_prefix_t.shape[0]
    if use_pallas:
        # the per-query mask prunes in stage 1: disallowed rows never
        # become candidates, so stage 2 inherits the filter
        vals1, ids1 = bq_scan_reduce(
            q_words[:, :wp].contiguous(), x_prefix_t, valid=valid,
            reduce_l=_auto_reduce_l(n), transposed=True, allow_bits=allow_bits)
        r = min(refine * k, vals1.shape[1])
        if selection == "fused" and r <= 256:
            cand_d1, cand = fused_topk_pairs(vals1, ids1, r)
            cand = torch.where(cand < 0, torch.zeros_like(cand), cand)
        else:
            cand_d1, cand = topk_smallest(vals1, ids1, r)
    else:
        cand_d1, ids1 = bq_topk(q_words[:, :wp], x_prefix_t.T, k=min(refine * k, n),
                                valid=valid, use_pallas=False, allow_bits=allow_bits)
        cand = torch.where(ids1 < 0, torch.zeros_like(ids1), ids1)
        r = cand.shape[1]
    # stage 2: full-width exact hamming on the gathered candidates
    xg = x_words[cand.clamp(0, n - 1).long()]  # [B, R, W]
    q = q_words.to(torch.int64) & 0xFFFFFFFF
    xg = xg.to(torch.int64) & 0xFFFFFFFF
    ham = popcount32(q[:, None, :] ^ xg).sum(dim=-1).float()
    ham = torch.where(cand_d1 >= MASKED_DISTANCE * 0.5,
                      torch.full_like(ham, MASKED_DISTANCE), ham)
    kk = min(k, r)
    fd, fi = _pad_k(*topk_smallest(ham, cand, kk), kk, k)
    fi = torch.where(fd >= MASKED_DISTANCE * 0.5, torch.full_like(fi, -1),
                     fi + id_offset)
    return fd, fi


def bq_hamming_np(a_words: np.ndarray, b_words: np.ndarray) -> np.ndarray:
    """Host reference: hamming between packed rows [A, w] x [B, w] -> [A, B]."""
    x = np.bitwise_xor(a_words[:, None, :], b_words[None, :, :])
    return np.unpackbits(x.view(np.uint8), axis=-1).sum(-1)
