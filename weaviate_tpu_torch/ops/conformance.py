"""Kernel conformance: the port's kernels against numpy ground truth.

Counterpart of ``bench.py``'s ``sec_conformance``, with the same checks on
the same shapes (8 queries x 512 rows at ``dim`` dims) and the same
tolerances:

1. ``distance_block`` l2-squared within rtol 1e-4 / atol 1e-3 of numpy;
2. ``bq_mxu_block`` on the sign words equal to the exact hamming
   (``bq_hamming_np``);
3. ``pq4_lut_block`` within ``8e-3 * max(1, max|ref|)`` of the sum of the
   bf16-rounded LUT entries (m = dim // 4, 16 codes);
4. ``fused_topk_scan`` ids (k = 10) equal to a stable argsort of the l2
   distances, then
5. the same under a 30% per-query allow mask (the first 16 rows always
   allowed, so every query has k).

Check 2 holds only for dim <= 256: ``bq_mxu_block`` writes bf16, which
holds integers exactly only up to 256, so a hamming distance past 256 is
rounded (at 768 dims its output is bf16(exact hamming), not the exact
hamming). Hence the default of 128 dims, bench's own.
"""

from __future__ import annotations

import numpy as np
import torch

from weaviate_tpu_torch import device as device_mod
from weaviate_tpu_torch.ops import bq as bq_ops
from weaviate_tpu_torch.ops import kernels

QUERIES, ROWS, TOP_K = 8, 512, 10


def kernel_conformance(device=None, dim: int = 128, seed: int = 0) -> str:
    """Run the five checks on ``device`` (the card by default) with
    inputs from ``np.random.default_rng(seed)``; returns ``"ok"`` or the
    first mismatch, in bench's words."""
    dev = device_mod.resolve(device)
    rng = np.random.default_rng(seed)
    found: list[str] = []  # mismatches, in the order of the checks
    cq = rng.standard_normal((QUERIES, dim)).astype(np.float32)
    cx = rng.standard_normal((ROWS, dim)).astype(np.float32)
    tq, tx = torch.from_numpy(cq).to(dev), torch.from_numpy(cx).to(dev)
    dist = ((cq[:, None] - cx[None]) ** 2).sum(-1)

    out = kernels.distance_block(tq, tx, metric="l2-squared").cpu().numpy()
    if not np.allclose(out, dist, rtol=1e-4, atol=1e-3):
        found.append(f"distance_block mismatch {np.abs(out - dist).max()}")

    qb, xb = bq_ops.bq_encode(tq), bq_ops.bq_encode(tx)
    out = kernels.bq_mxu_block(qb, xb).float().cpu().numpy()
    ref = bq_ops.bq_hamming_np(qb.cpu().numpy().view(np.uint32),
                               xb.cpu().numpy().view(np.uint32))
    if not np.array_equal(out, ref):
        found.append(f"bq_mxu_block mismatch {np.abs(out - ref).max()}")

    m4 = dim // 4
    lut = rng.standard_normal((QUERIES, m4, 16)).astype(np.float32)
    codes4 = rng.integers(0, 16, (ROWS, m4)).astype(np.uint8)
    out = kernels.pq4_lut_block(torch.from_numpy(lut).to(dev),
                                torch.from_numpy(codes4).to(dev)).float().cpu().numpy()
    lut16 = torch.from_numpy(lut).to(torch.bfloat16).float().numpy()
    ref = np.zeros((QUERIES, ROWS), np.float32)
    for s in range(m4):
        ref += lut16[:, s, :][:, codes4[:, s]]
    tol = 8e-3 * max(np.abs(ref).max(), 1.0)
    if not np.allclose(out, ref, atol=tol):
        found.append(f"pq4_lut_block mismatch {np.abs(out - ref).max()}")

    fi = kernels.fused_topk_scan(tq, tx, TOP_K)[1].cpu().numpy()
    if not np.array_equal(fi, np.argsort(dist, axis=1, kind="stable")[:, :TOP_K]):
        found.append("fused_topk_scan id mismatch")
    allow = rng.random((QUERIES, ROWS)) < 0.3
    allow[:, :16] = True  # never fewer than k allowed
    fi = kernels.fused_topk_scan(tq, tx, TOP_K, allow_bits=kernels.pack_allow_bitmask(allow))
    want = np.argsort(np.where(allow, dist, np.inf), axis=1, kind="stable")[:, :TOP_K]
    if not np.array_equal(fi[1].cpu().numpy(), want):
        found.append("fused_topk_scan masked id mismatch")
    return found[0] if found else "ok"
