#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``weaviate_tpu_torch``) on one
NVIDIA card.

Run from the repository root:
    python3 chip_smoke.py [--seed N] [--rows N] [--hybrid-docs N]
    python3 chip_smoke.py --topk-times   # phases 0-1 and the selection timings only
    python3 chip_smoke.py --dist-times   # phases 0-1, distance_block, pq4_scan_reduce
                                         # and one approx batch, timed only
    python3 chip_smoke.py --bq-times     # phases 0-1, bq_scan_reduce at B = 1 / 8 /
                                         # 64 / 256, the prefix, the single-bit probe
    python3 chip_smoke.py --block-times  # phases 0-1, bq_hamming_block, bq_mxu_block,
                                         # pq4_recon_block, pq4_lut_block and bm25_block
                                         # checked and timed, the hybrid dispatch split
    python3 chip_smoke.py --import-times # phases 0-1, the FiQA-sized text import and a
                                         # 100,000-row vector batch_put with the native
                                         # host library, without it, and with it again

It drives the port's flat nearVector path at VectorDBBench's
Performance768D1M case (Cohere wiki-22-12: 1,000,000 x 768, cosine,
top-k 100), with clustered Gaussian vectors made from ``--seed`` (nothing
is downloaded), in phases:

0. card: name and power limit (nvidia-smi), torch and CUDA versions;
1. build: compiles every kernel in weaviate_tpu_torch/csrc with nvcc and
   prints each one's registers, shared memory and spills, and the
   residency (CTAs per SM) of the two selection kernels; beside them it
   builds the native host library (csrc/host/weaviate_native.cpp, g++)
   and fails unless it is active, so that the import phases time it;
2. kernels: each CUDA kernel against its plain PyTorch version on the
   card, at the main path's shapes, with timings and bounds.
   fused_topk_scan also on the bf16 copy of the 1M-row corpus, at ragged
   shapes, under the dot metric on rows with exact zero products, and
   with its distances equal bit for bit to distance_block's at the rows
   it returns; fused_topk_pairs equal to its plain version on ties,
   +0.0 / -0.0, NaN / inf / MASKED entries, empty rows, M < k, k = 1 to
   256 and a row too wide for shared memory; both timed at the drain
   shapes (B = 1, 8, 64, 256; topk_times). distance_block also timed at
   the approx loop's group shape [256, 65536] beside addmm, and the
   grouped approx loop held bit for bit to the per-chunk loop on the card
   (filters, k past the live rows, NaN). pq4_scan_reduce also at m = 1024
   and ragged m past 896 segments. bq_scan_reduce at 17 ragged shapes (B
   past one query block, W = 1, 3, 25, 33 and 200, N = 1 and 9001, both
   layouts, with and without allow words and valid rows; W = 200 takes
   the popcount body it keeps), at the drains' B = 1, 8, 64 on the 1M-row
   words, and timed at B = 1, 8, 64, 256 and on the prefix beside the
   torch._int_mm product yardstick (bq_times). The four
   block kernels (bq_hamming_block, bq_mxu_block, pq4_lut_block,
   pq4_recon_block) at ragged shapes, then at 256 queries x the 1M-row
   corpus's sign words and 4-bit PQ codes with ~10% dead rows (and
   bq_hamming_block at HAM_CHECKS and UNALIGNED, timed beside
   torch.cdist(p=0) on the 0/1 planes and torch._int_mm), then
   bq_mxu_block at the two shapes of tools/probe_r4.py; bq_mxu_block is
   also held to bf16(exact hamming) at 768 dims and at MXU_CHECKS (W = 1,
   8, 9 and the popcount body's 200, B = 8, 129, 1,024), pq4_recon_block
   at RECON_CHECKS (ds = 1, 2, 3, 8, d off 16, codes past 15, the FFMA
   body at d = 1,024); pq4_lut_block also at
   LUT_CHECKS (ragged m up to 4,100, past the first design's cap, codes
   past 15, subnormal, -0.0 and infinite entries, dead rows). bm25_block
   at BM25_CHECKS (every term tile, T past one tile, terms outside [0,
   T), the 8-row dispatch's shape as padded to ops/bm25.GRAPH_SHAPE),
   timed from a CUDA graph. No path of the repo runs bq_hamming_block or
   pq4_recon_block: their launches are counted in this section's own
   window;
3. index: FlatIndex on the card, 1M rows, 1,024 queries through the
   async batch entry point for selection "approx" (distance_block per
   group of 8192-row chunks, fused_topk_pairs per group) and "fused" (fused_topk_scan + fused_topk_pairs),
   held to an exact plain recomputation (recall@10 / @100 must be 1.0),
   plus per-query filters (bitmask path) and a shared 0.5% filter
   (gathered path);
4. end to end: Database -> Collection.batch_put -> 8 client threads of
   near_vector through the shard's query batcher, held to the serial path
   and to the plain recomputation, then deletes and queries again. The
   kernels' launch counters are reset just before this phase and read
   just after it. Before that, the filter's allow words as a CUDA store
   packs them on the card are held bit for bit to numpy's packer at B =
   1, 8 and 64, each way timed; after the two selections, the approx run
   once more with the words packed on the host, as before the card
   packer (the filtered p50 before and after, in one call);
5. quantized index: the same corpus in a BQ FlatIndex, a BQ FlatIndex
   with a 128-bit sign prefix (two-stage scan) and a flat index that
   ``compress("pq")`` turns into 4-bit PQ on the card, 1,024 queries
   each at k=10 and k=100 (selection "approx") and k=10 ("fused"), plus
   per-query 10% filters; every returned id must carry its exact
   distance, deleted and disallowed ids never surface, recall@10 against
   the exact recomputation must reach the floor in RECALL_FLOOR (it also
   prints what rescore_limit 1 reads, a path without oversampling, and
   one batch's exact host rescore split into gather, distance and
   selection, as the reference arranges it and as the store does, whose
   answers must be equal bit for bit);
6. quantized end to end: ``Database.update_collection`` turns PQ on for
   phase 4's live collection and 8 client threads query it near its rows;
   then a second collection is created with BQ in its schema, loaded
   through batch_put and queried the same way. Each quantized collection
   is held to the serial path, to exact distances and to RECALL_FLOOR.

7. hybrid: a collection at the size of BEIR FiQA-2018 (Thakur et al.,
   NeurIPS 2021 Datasets and Benchmarks, Table 1: 57,638 documents,
   648 test queries, documents of 132 words and queries of 11 on
   average), ``title`` and ``text`` TEXT properties (word tokenization,
   en stopwords) and a 768-d cosine flat vector, Weaviate's BM25 defaults
   (k1 1.2, b 0.75), k=10 and the hybrid default (relativeScore, alpha
   0.75) in turn with rankedFusion at alpha 0.3 and 0.75. Deviations from
   FiQA: the text is Zipf text made from ``--seed`` (the en stopwords as
   the most frequent words), the vectors are clustered as in phase 4, the
   titles hold ~6 words (FiQA's are empty) and an int property ``n``
   carries a 10% filter. 8 client threads send (a) 648 FiQA-shaped
   queries, (b) 256 queries of the same shape whose words keep the
   candidate union within the 4,096-candidate budget, (c) (b) under
   where(n == 0) and (d) (b)'s queries with the index's selection set to
   "fused", so that the dense leg runs fused_topk_scan, each with one
   plain nearVector request per three hybrid ones on the same batcher.
   Every query of (b), (c) and (d) must take the device path (counted per
   query); every device answer is held to the host reference path
   (device_hybrid off), and every host-served query of (a) must exceed
   the budget. Then where a fused dispatch of 8 (b) rows goes
   (hybrid_split): the dense scan, the stacking, the upload and program
   on the host clock and CUDA events, and the card's memory after the
   phase (``--block-times`` sets the first design's program and the
   program's stages beside it).
8. conformance: ``kernel_conformance(device="cuda")``
   (weaviate_tpu_torch/ops/conformance.py, bench.py's sec_conformance) at
   bench's 128 dims must return "ok", and must launch every kernel in
   CONFORMANCE_KERNELS.
9. server: the port's ``Server`` serves the Database of phases 4-7 on
   127.0.0.1 (ports from the OS, no telemetry; REST and GraphQL, and gRPC
   where ``import grpc, google.protobuf`` works, else ``Server.assemble``
   without the gRPC listener, said on its line). 9a runs right after
   phase 4, before phase 6 compresses its collection: 1,024 GraphQL
   nearVector queries at limit 100 (every 4th under the 10% filter: host
   filter evaluation bounds those) from 8 client threads, and the same
   through gRPC Search, each answer equal to the in-process
   ``Collection.near_vector`` answer (ids and distance bits), then 64 of
   them under selection "fused". 9b runs after phase 7: 128 nearVector
   queries (half filtered) on each of phase 6's PQ and BQ collections and 64 hybrid queries
   on phase 7's, held to the in-process answers (hybrid under phase 7's
   tie rule), then the write path: 10,000 new 768-d objects through POST
   /v1/batch/objects in batches of 1,000, 1,000 of them (chosen by seed)
   read back with their vectors and found first by nearVector. Each half
   computes its in-process answers first, then resets the launch counters,
   runs its socket queries and reads them: 9a must launch distance_block,
   fused_topk_pairs and fused_topk_scan, 9b bm25_block, distance_block,
   bq_scan_reduce and pq4_scan_reduce. Each prints socket p50/p99/QPS
   beside the in-process numbers, the import rate and the card's name and
   power limit.

Phases 5, 6, 7, 8, 9a and 9b each reset the launch counters as they start and read
them as they end: every kernel in QUANT_KERNELS must have run in phases 5
and 6, and ``bm25_block`` and ``distance_block`` in phase 7, whose run (d)
must launch ``fused_topk_scan``.

It prints one line per phase, then a JSON line of per-kernel numbers, and
as its last line ``{"ok": true, "device": {...}}``. Any failure exits
non-zero without that line. Without CUDA it exits 2 at once.
"""

from __future__ import annotations

import argparse
import contextlib
import http.client
import json
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import traceback

import numpy as np

DIM = 768
METRIC = "cosine"
TOP_K = 100
ROWS = 1_000_000
BATCH = 256
QUERIES = 1024
CHUNK = 8192
ADD_BATCH = 65_536
IMPORT_BATCH = 10_000
IMPORT_BUDGET_S = 300.0  # phase 4 cuts its row count past this
IMPORT_ROWS = 100_000    # --import-times' vector batch_put
# calls per client in phase 6 (CALLS) and phase 4 (PLAIN_CALLS), and phase
# 4's queries after its deletes: cut so that phase 7's FiQA-sized hybrid
# collection (whose text import takes minutes on the host) keeps the script
# within its time
CLIENTS, CALLS = 8, 32
PLAIN_CALLS = 16
VIEWS_CUT = 90           # where(views >= 90) keeps 10% of the 0..99 values
DELETES, REQUERIES = 1000, 32

# H100 SXM published peaks (NVIDIA data sheet, dense, 700 W)
FP32_FLOPS = 67e12
# f32 additions a second: an FADD takes the issue slot of an FMA, which
# the FP32 rate counts as two operations
FP32_ADDS = FP32_FLOPS / 2
BF16_FLOPS = 989e12
HBM_BYTES_S = 3.35e12

RTOL, ATOL = 2e-4, 2e-3  # the reference's kernel tolerance (f32)
TIE_TOL = 1e-5           # distances closer than this are a tie
INT8_OPS = 1979e12
# single-bit products (wgmma .b1 AND-popc, bq_scan_reduce, bq_mxu_block): the guide's
# table has no such rate; one m64nNk256 b1 MMA issues at the rate of one
# m64nNk32 int8 MMA and covers 8 times its K (csrc/probes/wgmma_b1.cu,
# ``--bq-times``, NVIDIA H100 80GB HBM3 at 700 W), so 8 x the int8 peak
B1_OPS = 8 * INT8_OPS
KERNEL_SOURCES = {
    "distance_block": ("weaviate_tpu_torch/csrc/distance_block.cu",
                       "weaviate_tpu/ops/pallas_kernels.py:281"),
    "fused_topk_scan": ("weaviate_tpu_torch/csrc/fused_topk_scan.cu",
                        "weaviate_tpu/ops/pallas_kernels.py:851"),
    "fused_topk_pairs": ("weaviate_tpu_torch/csrc/fused_topk_pairs.cu",
                         "weaviate_tpu/ops/pallas_kernels.py:992"),
    "bq_scan_reduce": ("weaviate_tpu_torch/csrc/bq_scan_reduce.cu",
                       "weaviate_tpu/ops/pallas_kernels.py:1166"),
    "pq4_scan_reduce": ("weaviate_tpu_torch/csrc/pq4_scan_reduce.cu",
                        "weaviate_tpu/ops/pallas_kernels.py:1397"),
    "bm25_block": ("weaviate_tpu_torch/csrc/bm25_block.cu",
                   "weaviate_tpu/ops/pallas_kernels.py:1606"),
    "bq_mxu_block": ("weaviate_tpu_torch/csrc/bq_mxu_block.cu",
                     "weaviate_tpu/ops/pallas_kernels.py:417"),
    "pq4_lut_block": ("weaviate_tpu_torch/csrc/pq4_lut_block.cu",
                      "weaviate_tpu/ops/pallas_kernels.py:516"),
    "pq4_recon_block": ("weaviate_tpu_torch/csrc/pq4_recon_block.cu",
                        "weaviate_tpu/ops/pallas_kernels.py:624"),
    "bq_hamming_block": ("weaviate_tpu_torch/csrc/bq_hamming_block.cu",
                         "weaviate_tpu/ops/pallas_kernels.py:1495"),
}
# no path of the repo runs these two (the conformance entry point drives
# the other two block kernels): phase 2's block-kernel window counts them
PHASE2_PATH = ("bq_hamming_block", "pq4_recon_block")
CONFORMANCE_KERNELS = ("distance_block", "bq_mxu_block", "pq4_lut_block", "fused_topk_scan")
# bench.py's pq4 tolerance, 8e-3 * max(1, max|ref|): one bf16 ulp at the
# output's scale, for f32 sums taken in another order (pq4_recon_block)
PQ_TOL = 8e-3
PROBE_SHAPES = ((256, 48), (1024, 4))  # tools/probe_r4.py:176-177: (B, W) at 1M rows
# no single PyTorch call computes a strided block-argmin over hamming or
# LUT sums: the scan-reduce kernels have no library yardstick
NO_LIBRARY = "none: no single PyTorch call computes the function"
BQ_E2E_ROWS = 100_000
NEAR_NOISE = 0.3 / float(np.sqrt(DIM))  # noise of length 0.3 on a unit row
# recall@10 floors of the quantized paths (exact rescore of rescore_limit
# x k candidates, queries at cosine ~0.96 to a corpus row). The 1M-row runs
# on an H100 measured BQ 0.9728, BQ + prefix 0.9620, PQ4 0.8585, the PQ4
# collection 0.9744 and the BQ collection 0.9752 (PERF.md); each floor sits
# 0.06-0.08 below its reading. Phase 5 also prints what the same index
# reads with rescore_limit 1, a path that has lost its oversampling.
RECALL_FLOOR = {"bq": 0.9, "bq+prefix128": 0.9, "pq4": 0.8,
                "e2e pq4": 0.9, "e2e bq": 0.9}
# kernels each quantized phase must launch: the scans, and the pairs top-k
# that selection "fused" runs (phase 6 serves with "approx"). Neither phase
# runs distance_block or fused_topk_scan: the quantized store scans codes
# and rescores its candidates on the host
QUANT_KERNELS = {5: ("bq_scan_reduce", "pq4_scan_reduce", "fused_topk_pairs"),
                 6: ("bq_scan_reduce", "pq4_scan_reduce")}


def log(msg: str) -> None:
    print(msg, flush=True)


# -- data ---------------------------------------------------------------------

def centers(seed: int) -> np.ndarray:
    return np.random.default_rng([seed, 1 << 40]).standard_normal(
        (1024, DIM), dtype=np.float32)


def clustered(seed: int, start: int, count: int, cent: np.ndarray) -> np.ndarray:
    """Rows [start, start + count) of the corpus: cluster centre plus
    noise of a per-row scale, so neighbours are spread, not tied."""
    rng = np.random.default_rng([seed, start])
    assign = rng.integers(0, len(cent), count)
    scale = rng.uniform(0.3, 1.2, (count, 1)).astype(np.float32)
    return cent[assign] + scale * rng.standard_normal((count, DIM), dtype=np.float32)


def near_queries(seed: int, rows: np.ndarray, corpus_fn, noise: float = 0.3) -> np.ndarray:
    """Queries next to given corpus rows: the row plus Gaussian noise of
    ``noise`` per dimension. The corpus functions return unit rows, so
    the default (0.3 per dimension, 8x the row's length) leaves a query
    almost unrelated to its row, which an exact scan does not mind;
    the quantized phases take NEAR_NOISE, a query at cosine ~0.96 to its
    row, so that recall after a quantized scan means something."""
    rng = np.random.default_rng([seed, 1 << 41])
    base = corpus_fn(rows)
    return base + noise * rng.standard_normal(base.shape, dtype=np.float32)


# -- checks -------------------------------------------------------------------

def tie_aware_mismatches(ai, ad, bi, bd) -> int:
    """Positions where ids ``ai`` differ from the reference ``bi`` other
    than by a reordering among near-equal distances (or another member
    of a tie at the k-th place)."""
    bad = 0
    for r, p in zip(*np.nonzero(ai != bi)):
        if abs(float(ad[r, p]) - float(bd[r, p])) > TIE_TOL:
            bad += 1
            continue
        same = np.abs(bd[r] - bd[r, p]) <= TIE_TOL
        if not (ai[r, p] in bi[r][same] or abs(float(bd[r, p]) - float(bd[r, -1])) <= TIE_TOL):
            bad += 1
    return bad


def recall_at_k(exact_d_of_got, kth_d, k) -> float:
    """Mean share of the k returned ids whose exact distance is within
    TIE_TOL of the exact k-th distance (ties at the k-th place count)."""
    return float(((exact_d_of_got[:, :k] <= kth_d[:, None] + TIE_TOL).sum(1) / k).mean())


def recall(got_ids, exact_d_of_got, kth_d, k) -> float:
    """Share of the k returned ids that are true top-k: an id counts when
    its exact distance is within TIE_TOL of the exact k-th distance."""
    hits = [(len(set(g[:k].tolist())) == k
             and bool((dg[:k] <= kd + TIE_TOL).all()))
            for g, dg, kd in zip(got_ids, exact_d_of_got, kth_d)]
    return float(np.mean(hits))


class Timer:
    """Mean milliseconds of ``fn`` over ``reps`` launches, CUDA events."""

    def __init__(self, torch):
        self.torch = torch

    def __call__(self, fn, reps: int = 10, warmup: int = 2) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / reps


def bound_ms(nbytes: float, ops: float, peak_ops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_S, ops / peak_ops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _bound_text(o: dict) -> str:
    """The bound and the kernel's share of it (bound_ms / ms), as the
    phase 2 lines print them."""
    return (f"bound {o['bound_ms']:.4f} ms ({o['bound_by']}), kernel at "
            f"{o['bound_ms'] / o['ms']:.1%} of its bound")


def scan_corpus(torch, seed: int, n: int = 1 << 20):
    """The full capacity of the 1M-row store on the card: unit rows of
    the clustered corpus, f32."""
    cent = centers(seed)
    X = torch.empty((n, DIM), dtype=torch.float32, device="cuda")
    for s in range(0, n, ADD_BATCH):
        X[s:s + ADD_BATCH] = torch.nn.functional.normalize(
            torch.from_numpy(clustered(seed, s, ADD_BATCH, cent)).to("cuda"), dim=1)
    return X


def _scan_bound(X, b: int, k: int) -> tuple[float, str]:
    """fused_topk_scan's bound: the corpus, queries and valid bytes read
    once and [b, k] (f32, i32) written, against 2*b*n*d FP32 FFMA."""
    n, d = X.shape
    return bound_ms(n * d * X.element_size() + b * d * 4 + n + b * k * 8,
                    2.0 * b * n * d, FP32_FLOPS)


def _pairs_bound(b: int, m: int, k: int) -> tuple[float, str]:
    """fused_topk_pairs's bound: every value read once, the k winners' ids
    gathered and [b, k] (f32, i32) written; one compare per value."""
    return bound_ms(b * m * 4 + b * k * (4 + 8), b * m, FP32_FLOPS)


def scan_breakdown(torch, K, X, qs, timer) -> list[str]:
    """The scan kernel alone (no merge) against a build of it without its
    selection (``-DWTT_SCAN_SELECT=0``: tiles parked, nothing filtered),
    at B = 64 and 256, k = 100: what the product with its loads costs and
    what the filter and merges add."""
    from weaviate_tpu_torch.ops import _build

    full = _build.kernel("fused_topk_scan")
    product = _build.build_variant("fused_topk_scan", ("WTT_SCAN_SELECT=0",))
    parts = []
    for b in (64, 256):
        qk, qn, xn, valid, async_ok = K._kernel_args(qs[:b], X, METRIC, None, None)
        rows_per, slices = K.scan_slices(X.shape[0], b)
        od = torch.empty((b, slices * TOP_K), device="cuda")
        oi = torch.empty((b, slices * TOP_K), device="cuda", dtype=torch.int32)
        ms = {}
        for name, fn in (("scan", full), ("product", product)):
            def run(fn=fn):
                rc = fn(qk.data_ptr(), None, X.data_ptr(), 0, None, None, None, 0, b,
                        X.shape[0], X.shape[1], TOP_K, 2, rows_per, slices, od.data_ptr(),
                        oi.data_ptr(), int(async_ok), torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"fused_topk_scan {name} build: cudaError {rc}")
            ms[name] = timer(run, reps=5)
        bm, _ = _scan_bound(X, b, TOP_K)
        parts.append(f"scan kernel alone B={b}: {ms['scan']:.4f} ms, its product alone "
                     f"{ms['product']:.4f} ms ({bm / ms['product']:.1%} of the FP32 bound), "
                     f"selection {ms['scan'] - ms['product']:.4f} ms")
    return parts


def group_rows(K) -> int:
    """Rows of one distance launch in the approx loop at a 256-query drain
    over the 1M-row store (ops/topk.scan_group_chunks). A tree from before
    the grouped loop (``--dist-times`` on a parent) launched 8192-row
    chunks; it is timed at 8 chunks, the group the budget gives."""
    from weaviate_tpu_torch.ops import topk

    if not hasattr(topk, "scan_group_chunks"):
        return 8 * CHUNK
    return topk.scan_group_chunks(BATCH, CHUNK, (1 << 20) // CHUNK, TOP_K, False) * CHUNK


def distance_times(torch, K, q, x, valid, timer, plain: bool = False) -> dict:
    """distance_block (cosine, valid mask) at q [B, d] x x [N, d] beside one
    cuBLAS addmm of the same product (1 - q.x) and its FP32 bound: q, x,
    valid read once and [B, N] f32 written, against 2*B*N*d FFMA. ``ms``
    is the kernel launched with its query prepared once, as the approx
    loop launches it (distance_block_prepared); ``wrapper_ms`` the whole
    wrapper call, which also normalizes the query in f64 on every call
    (at one 8192-row chunk its Python and small ops take longer than the
    kernel). A tree from before the prepared launch times the wrapper."""
    b, n = q.shape[0], x.shape[0]
    reps = max(10, min(50, (50 * CHUNK) // n))
    one = torch.ones((), device=x.device)
    qn = torch.nn.functional.normalize(q, dim=1)
    b_ms, b_by = bound_ms(q.numel() * 4 + x.numel() * x.element_size() + n + b * n * 4,
                          2.0 * b * n * q.shape[1], FP32_FLOPS)
    wrapper_ms = timer(lambda: K.distance_block(q, x, METRIC, valid=valid), reps=reps)
    o = dict(ms=wrapper_ms)
    if hasattr(K, "distance_query"):
        prep = K.distance_query(q, METRIC)
        o = dict(ms=timer(lambda: K.distance_block_prepared(prep, x, METRIC, valid=valid),
                          reps=reps), wrapper_ms=wrapper_ms)
    if plain:
        o["plain_ms"] = timer(lambda: K.distance_block_plain(q, x, METRIC, valid=valid),
                              reps=reps)
    o.update(library_ms=timer(lambda: torch.addmm(one, qn, x.T, alpha=-1.0), reps=reps),
             bound_ms=b_ms, bound_by=b_by)
    return o


def _distance_text(o: dict) -> str:
    plain = f"plain {o['plain_ms']:.4f} ms, " if "plain_ms" in o else ""
    wrapper = f" (wrapper call {o['wrapper_ms']:.4f} ms)" if "wrapper_ms" in o else ""
    return (f"kernel {o['ms']:.4f} ms{wrapper}, {plain}addmm {o['library_ms']:.4f} ms "
            f"(kernel / addmm {o['ms'] / o['library_ms']:.2f}), {_bound_text(o)}")


def _per_chunk_topk(torch, K, q, x, k, valid=None, allow_bits=None, metric=METRIC):
    """The approx loop as it ran before the grouped one: per 8192-row chunk
    distance_block, the filter, and the exact top-k of [running k | chunk]
    by int64 keys (ties to the lower position). The grouped loop must
    return its answer bit for bit."""
    from weaviate_tpu_torch.ops.distances import MASKED_DISTANCE
    from weaviate_tpu_torch.ops.topk import topk_smallest

    n, b = x.shape[0], q.shape[0]
    allow = None if allow_bits is None else K.unpack_allow_bitmask(allow_bits, n)
    best_d = torch.full((b, k), MASKED_DISTANCE, device=x.device)
    best_i = torch.full((b, k), -1, dtype=torch.int32, device=x.device)
    iota = torch.arange(CHUNK, dtype=torch.int32, device=x.device)
    for lo in range(0, n, CHUNK):
        d = K.distance_block(q, x[lo:lo + CHUNK], metric,
                             valid=None if valid is None else valid[lo:lo + CHUNK])
        if allow is not None:
            d = torch.where(allow[:, lo:lo + CHUNK], d, torch.full_like(d, MASKED_DISTANCE))
        best_d, best_i = topk_smallest(torch.cat([best_d, d], 1),
                                       torch.cat([best_i, (iota + lo).expand(b, CHUNK)], 1), k)
    return best_d, best_i


def _approx_loop_check(torch, K, seed: int) -> None:
    """The grouped approx loop (chunked_topk_distances: distance_block per
    group, fused_topk_pairs per group and per merge, the NaN guard) against
    the per-chunk loop on the card, bit for bit in distances and ids
    (MASKED slots' ids included): 256 queries x 2.5 groups of rows with 5%
    dead rows at k = 10 / 100, with per-query 10% allow bits, with k past
    the live rows, and under the dot metric with NaN rows and a NaN query
    (a negated NaN product sorts first) without a valid mask, and with one
    (the loop then trusts the card's canonical NaN, which is positive)."""
    from weaviate_tpu_torch.ops.topk import chunked_topk_distances

    rng = np.random.default_rng([seed, 9])
    n = group_rows(K) * 5 // 2 // CHUNK * CHUNK
    x = torch.nn.functional.normalize(
        torch.from_numpy(clustered(seed, 4 * 10**9, n, centers(seed))).to("cuda"), dim=1)
    q = torch.from_numpy(clustered(seed, 5 * 10**9, BATCH, centers(seed))).to("cuda")
    valid = torch.from_numpy(rng.random(n) > 0.05).to("cuda")
    bits = K.pack_allow_bitmask_t(torch.from_numpy(rng.random((BATCH, n)) < 0.1).to("cuda"))
    few = torch.zeros(n, dtype=torch.bool, device="cuda")
    few[::n // 7] = True
    xnan, qnan = x.clone(), q.clone()
    xnan[[5, n // 2, n - 1]] = float("nan")
    qnan[3] = float("nan")
    cases = [("valid k=10", q, x, 10, valid, None, METRIC),
             ("valid k=100", q, x, TOP_K, valid, None, METRIC),
             ("allow bits k=100", q, x, TOP_K, valid, bits, METRIC),
             ("k past the live rows", q, x, 16, few, None, METRIC),
             ("dot with NaN", qnan, xnan, 16, None, None, "dot"),
             ("dot with NaN and valid", qnan, xnan, 16, valid, None, "dot")]
    for name, qq, xx, k, v, ab, metric in cases:
        got = chunked_topk_distances(qq, xx, k, CHUNK, metric, valid=v, use_pallas=True,
                                     selection="approx", allow_bits=ab)
        want = _per_chunk_topk(torch, K, qq, xx, k, v, ab, metric)
        if not (torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
                and torch.equal(got[1], want[1])):
            raise AssertionError(f"approx loop {name}: grouped answer != per-chunk answer")
    log(f"phase 2 kernels: approx loop, {BATCH} queries x [{n},{DIM}] in groups of "
        f"{group_rows(K)} rows ({', '.join(c[0] for c in cases)}): distances and ids equal "
        f"to the per-chunk loop's bit for bit")


def residency_text(K) -> str:
    """CTAs per SM and dynamic shared memory of the two selection kernels
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor) at the k and widths
    the paths give them."""
    return "residency (CTAs per SM, dynamic smem bytes): " + "; ".join(
        f"{name} {label}: {K.kernel_residency(name, *args)}" for name, label, args in (
            ("fused_topk_scan", "k=10 f32", (10, 0, 256)),
            ("fused_topk_scan", "k=100 f32", (100, 0, 256)),
            ("fused_topk_scan", "k=128 f32", (128, 0, 256)),
            ("fused_topk_scan", "k=100 bf16", (100, 1, 256)),
            ("fused_topk_scan", "k=100 f32 B<=32", (100, 0, 8)),
            ("fused_topk_pairs", "M=12800", (12800,)),
            ("fused_topk_pairs", "M=16384", (16384,)),
            ("fused_topk_pairs", "M=200000", (200000,))))


def topk_times(torch, K, X, vmask, qs, timer) -> list[str]:
    """Times of the two selection kernels at the shapes a drain gives
    them: fused_topk_scan (merge included) at B = 1, 8, 64 and 256 on the
    f32 corpus ``X`` and at B = 256 on its bf16 copy, and fused_topk_pairs
    at each B's merge shape, at [256, 16384] for k = 100 and 256 and at
    [1 / 8, 12800]. Each beside its bound; the residency of both kernels
    where the build exports it. Returns one text part per shape."""
    parts = []
    n = X.shape[0]
    Xb = X.to(torch.bfloat16)
    for xs, name, bs in ((X, "f32", (1, 8, 64, 256)), (Xb, "bf16", (1, 256))):
        for b in bs:
            ms = timer(lambda: K.fused_topk_scan(qs[:b], xs, TOP_K, METRIC, valid=vmask), reps=5)
            bm, by = _scan_bound(xs, b, TOP_K)
            rows_per, slices = K.scan_slices(n, b)
            parts.append(f"scan {name} B={b} k={TOP_K}: {ms:.4f} ms ({slices} slices of "
                         f"{rows_per}), bound {bm:.4f} ms ({by}, {bm / ms:.1%})")
    del Xb
    gen = torch.Generator(device="cuda").manual_seed(5)
    shapes = [(b, K.scan_slices(n, b)[1] * TOP_K, TOP_K) for b in (1, 8, 64, 256)]
    # [256, 12800] is the merge shape of the 8192-row slices the scan took
    # before its slices grew
    shapes += [(256, 12800, 100), (256, 16384, 100), (256, 16384, 256), (1, 12800, 100),
               (8, 12800, 100)]
    for b, m, k in shapes:
        v = torch.rand((b, m), device="cuda", generator=gen)
        i = torch.randint(0, n, (b, m), device="cuda", dtype=torch.int32, generator=gen)
        ms = timer(lambda: K.fused_topk_pairs(v, i, k), reps=20)
        lib = timer(lambda: torch.topk(v, k, dim=1, largest=False), reps=20)
        bm, by = _pairs_bound(b, m, k)
        parts.append(f"pairs [{b},{m}] k={k}: {ms:.4f} ms, torch.topk {lib:.4f} ms, "
                     f"bound {bm:.5f} ms ({by}, {bm / ms:.1%})")
    return parts


def dist_times(torch, K, seed: int, timer) -> list[str]:
    """The kernels and the loop this slice redesigned, timed so that two
    trees can be compared in one call (``--dist-times``): distance_block
    at [256, 8192] and at the approx loop's group shape beside cuBLAS
    addmm; pq4_scan_reduce at lut [256, 192, 16] x codes [1,048,576, 192]
    (random codes and tables: the time does not follow the values);
    then one 256-query approx batch over the 1M-row corpus through
    chunked_topk_distances (k = 100, 1% dead rows), unfiltered and with
    per-query 10% allow bits, host clock around a synchronised call,
    median of 5. Returns one text part per measurement."""
    from weaviate_tpu_torch.ops.topk import chunked_topk_distances

    X = scan_corpus(torch, seed)
    n = X.shape[0]
    rng = np.random.default_rng([seed, 2])
    vmask = torch.from_numpy(rng.random(n) > 0.01).to("cuda")
    qs = torch.from_numpy(near_queries(seed, rng.integers(0, ROWS, BATCH), lambda r: X[
        torch.from_numpy(r).to("cuda")].cpu().numpy())).to("cuda")
    parts = []
    for rows in (CHUNK, group_rows(K)):
        o = distance_times(torch, K, qs, X[:rows], vmask[:rows], timer)
        parts.append(f"distance_block [{BATCH},{DIM}] x [{rows},{DIM}]: {_distance_text(o)}")
    m = 192
    gen = torch.Generator(device="cuda").manual_seed(seed)
    codes = torch.randint(0, 16, (n, m), device="cuda", dtype=torch.uint8, generator=gen)
    lut = torch.randn((BATCH, m, 16), device="cuda", generator=gen)
    o = dict(ms=timer(lambda: K.pq4_scan_reduce(lut, codes, vmask, 64), reps=10))
    o["bound_ms"], o["bound_by"] = bound_ms(lut.numel() * 4 + codes.numel() + n
                                            + BATCH * (n // 64) * 8,
                                            2.0 * BATCH * n * 16 * m, INT8_OPS)
    parts.append(f"pq4_scan_reduce lut [{BATCH},{m},16] x codes [{n},{m}] reduce_l 64: "
                 f"kernel {o['ms']:.4f} ms, {_bound_text(o)}")
    del codes, lut
    bits = K.pack_allow_bitmask_t(torch.from_numpy(rng.random((BATCH, n)) < 0.1).to("cuda"))
    for name, ab in (("unfiltered", None), ("per-query 10% allow bits", bits)):
        times = []
        for rep in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            chunked_topk_distances(qs, X, TOP_K, CHUNK, METRIC, valid=vmask, use_pallas=True,
                                   selection="approx", allow_bits=ab)
            torch.cuda.synchronize()
            if rep:  # the first call warms up
                times.append((time.perf_counter() - t0) * 1e3)
        parts.append(f"approx batch {BATCH} x [{n},{DIM}] k={TOP_K} {name}: "
                     f"{np.median(times):.2f} ms (median of {len(times)}, host clock; "
                     f"all {', '.join(f'{t:.2f}' for t in times)})")
    return parts


def _bq_bound(qw, xw, L) -> dict:
    """bq_scan_reduce's bound: words, valid and both outputs once against
    the reference kernel's cost estimate (2*B*N*32W, the +-1 product) at
    the single-bit rate B1_OPS the kernel's MMAs run at. ``xw`` is [N, W]
    or, transposed, [W, N]."""
    b, w = qw.shape
    n = xw.numel() // w
    ms, by = bound_ms(qw.numel() * 4 + xw.numel() * 4 + n + b * (n // L) * 8,
                      2.0 * b * n * 32 * w, B1_OPS)
    return dict(bound_ms=ms, bound_by=by)


def bq_times(torch, K, qw, xw, vmask, timer) -> list[str]:
    """bq_scan_reduce timed at the drains' B = 1, 8, 64 and 256 on the
    [N, 24 words] corpus, each beside its bound; the transposed 128-bit
    prefix [4, N] at B = 256; and the product alone
    as a yardstick: torch._int_mm on the unpacked operands, [256, 768] int8
    (+-1) x [768, N] int8 (0/1), no reduction (not library_ms: no single
    PyTorch call computes the function). Returns one text part each."""
    from weaviate_tpu_torch.ops import bq as bq_ops

    n, w = xw.shape
    L = bq_ops._auto_reduce_l(n)
    parts = []
    for b in (1, 8, 64, 256):
        q = qw[:b].contiguous()
        o = dict(ms=timer(lambda: K.bq_scan_reduce(q, xw, vmask, L), reps=20),
                 **_bq_bound(q, xw, L))
        parts.append(f"B={b}: {o['ms']:.4f} ms, {_bound_text(o)}")
    qp, pt = qw[:, :4].contiguous(), xw[:, :4].T.contiguous()
    o = dict(ms=timer(lambda: K.bq_scan_reduce(qp, pt, vmask, L, transposed=True), reps=20),
             **_bq_bound(qp, pt, L))
    parts.append(f"prefix [{qp.shape[0]},4] x [4,{n}] transposed: {o['ms']:.4f} ms, "
                 f"{_bound_text(o)}")
    del pt
    if not hasattr(K, "bq_queries_to_pm1"):  # a tree before this yardstick
        return parts
    try:
        pm1 = K.bq_queries_to_pm1(qw, w)  # [B, 32W] +-1 in bit-plane order j*W + word
        x01 = _bit_planes(torch, xw, torch.int8)
        ms = timer(lambda: torch._int_mm(pm1, x01.t()), reps=5)
        parts.append(f"yardstick torch._int_mm [{qw.shape[0]},{32 * w}] x [{32 * w},{n}] "
                     f"int8 (the product alone): {ms:.4f} ms")
        del x01
    except RuntimeError as e:  # a yardstick only: the run goes on without it
        parts.append(f"yardstick torch._int_mm failed: {str(e).splitlines()[0]}")
    return parts


def bq_probe(torch) -> list[str]:
    """The single-bit wgmma probe (weaviate_tpu_torch/csrc/probes/
    wgmma_b1.cu): whether nvcc takes it for sm_90a, the tensor-core
    instructions its SASS holds, and the time of one m64n128k256 b1 MMA
    against one m64n128k32 s8 MMA (528 CTAs of one warpgroup, 4096 x 4
    MMAs each, chained on one accumulator)."""
    import ctypes
    import os

    from weaviate_tpu_torch.ops import _build

    src = os.path.join(_build.CSRC, "probes", "wgmma_b1.cu")
    if not os.path.exists(src):
        return ["probe: not in this tree"]
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    so = os.path.join(_build.BUILD_DIR, "probe_wgmma_b1.so")
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, src],
                       capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        err = [ln for ln in (r.stdout + r.stderr).splitlines() if "rror" in ln]
        return [f"probe: nvcc refused the b1 MMA for sm_90a: {' | '.join(err[:3])}"]
    parts = [f"probe: built ({_sass_summary(so)})"]
    fn = ctypes.CDLL(so).wtt_probe_mma_loop
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    blocks, iters = 528, 4096
    out = torch.empty(blocks * 128, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    timer = Timer(torch)
    ms = {}
    for b1 in (0, 1, 0, 1):
        rc = []
        t = timer(lambda: rc.append(fn(b1, blocks, iters, out.data_ptr(), stream)), reps=3)
        if any(rc):
            return parts + [f"probe: launch failed, cudaError {max(rc)}"]
        ms.setdefault(b1, []).append(t)
    per = {b1: min(v) * 1e6 / (blocks * iters * 4) for b1, v in ms.items()}  # ns per MMA, all SMs
    parts.append(f"probe: {blocks} x {iters * 4} MMAs: s8 m64n128k32 {min(ms[0]):.3f} ms, "
                 f"b1 m64n128k256 {min(ms[1]):.3f} ms; one b1 MMA takes "
                 f"{per[1] / per[0]:.2f}x one s8 MMA and covers 8x its K bits")
    return parts


def _sass_summary(so: str) -> str:
    """Tensor-core instructions in a built library's SASS (cuobjdump
    -sass): each opcode with a GMMA or MMA in its name, and its count."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    r = subprocess.run([cuobjdump, "-sass", so], capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        return f"cuobjdump failed: {r.stderr.strip()[:200]}"
    ops: dict = {}
    # (not the register moves HFMA2.MMA, which issue on the MMA pipe)
    for op in re.findall(r"(?<![.\w])([A-Z0-9]*MMA[A-Z0-9_.x]*)", r.stdout):
        ops[op] = ops.get(op, 0) + 1
    return ", ".join(f"{op} x{c}" for op, c in sorted(ops.items())) or "no MMA instruction"


# -- phases -------------------------------------------------------------------

def card_clocks() -> str:
    """SM clock now and at most, power draw, temperature: two calls can
    land on cards of one name whose clocks differ, and every time of the
    run moves with them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]


def phase_card(torch) -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    log(smi.splitlines()[0])
    name = torch.cuda.get_device_name(0)
    log(f"phase 0 card: {name}; torch {torch.__version__}; CUDA {torch.version.cuda}; "
        f"devices {torch.cuda.device_count()}")
    return {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}


def phase_build(K) -> None:
    from weaviate_tpu_torch import native
    from weaviate_tpu_torch.ops import _build

    # the host library builds with g++ beside the kernels' nvcc runs
    t_native = time.perf_counter()
    lib = threading.Thread(target=native.available)
    lib.start()
    secs = _build.build_all()
    lib.join()
    native_s = time.perf_counter() - t_native
    regs = []
    for name in _build.SIGNATURES:
        with open(_build.log_path(name)) as f:
            text = f.read()
        used = [int(t.split()[0]) for t in text.split("Used ")[1:]]
        smem = [int(b) for b in re.findall(r"(\d+) bytes smem", text)]
        # ptxas prints one line per instantiation: any non-zero one spills
        spills = [int(b) for b in re.findall(r"(\d+) bytes spill (?:stores|loads)", text)]
        regs.append(f"{name} max {max(used) if used else '?'} registers, "
                    f"{max(smem) if smem else 0} bytes static smem, "
                    f"{max(spills) if spills else 0} bytes spilled")
    log(f"phase 1 build: {secs:.1f} s for {len(_build.SIGNATURES)} kernels "
        f"(nvcc sm_90a, in parallel); {'; '.join(regs)}")
    if hasattr(K, "kernel_residency"):  # absent from builds before the radix select
        log(f"phase 1 build: {residency_text(K)}")
    for name in ("bq_scan_reduce", "pq4_scan_reduce", "pq4_lut_block", "bq_mxu_block",
                 "pq4_recon_block", "bq_hamming_block"):
        log(f"phase 1 build: {name} SASS: {_sass_summary(_build._lib_path(name))}")
    gxx = subprocess.run(["g++", "--version"], capture_output=True, text=True,
                         timeout=60).stdout.splitlines()
    if not native.available():
        # the import phases would time the numpy codecs as the library's
        raise AssertionError("the native host library did not build or load "
                             f"({native.SRC} with {gxx[:1]})")
    built = ("built in " + f"{native.build_seconds:.1f} s" if native.build_seconds is not None
             else "loaded from an earlier build")
    log(f"phase 1 build: native host library {native.library_path()} ({gxx[0]}, "
        f"{' '.join(native.CXX_FLAGS)}) {built}; {native_s:.1f} s beside the kernels")


def phase_kernels(torch, K, seed: int) -> tuple[dict, dict]:
    """Each kernel against its plain version at the main path's shapes.
    Returns the per-kernel numbers and the launch counts of the block
    kernels' window."""
    from weaviate_tpu_torch.ops.distances import MASKED_DISTANCE
    from weaviate_tpu_torch.ops.topk import merge_epoch_topk

    dev = "cuda"
    timer = Timer(torch)
    cent = centers(seed)
    rng = np.random.default_rng([seed, 2])
    out = {}

    def to_dev(a):
        return torch.from_numpy(a).to(dev)

    # distance_block: q [256, 768] x one 8192-row chunk
    q = to_dev(clustered(seed, 10**9, BATCH, cent))
    x = to_dev(clustered(seed, 2 * 10**9, CHUNK, cent))
    valid = to_dev(rng.random(CHUNK) > 0.05)
    err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for metric in ("l2-squared", "dot", "cosine"):
            xx = torch.nn.functional.normalize(x, dim=1) if metric == "cosine" else x
            xx = xx.to(dtype).contiguous()
            a = K.distance_block(q, xx, metric, valid=valid)
            b = K.distance_block_plain(q, xx, metric, valid=valid)
            if not torch.allclose(a, b, rtol=RTOL, atol=ATOL):
                raise AssertionError(f"distance_block {metric} {dtype} disagrees")
            err = max(err, (a - b).abs().max().item())
    xn = torch.nn.functional.normalize(x, dim=1).contiguous()
    # batch invariance: a query's distances must not move with the rows
    # batched beside it (the batcher pads drains to 1, 2, 4, 8, ... rows)
    full = K.distance_block(q, xn, METRIC)
    for b in (1, 2, 4, 8, 16, 32, 33, 64):
        if not torch.equal(K.distance_block(q[:b], xn, METRIC), full[:b]):
            raise AssertionError(f"distance_block rows at B={b} differ from B={BATCH}")
    at_chunk = distance_times(torch, K, q, xn, valid, timer, plain=True)
    # the wrapper's time is logged below; the kernels line keeps its keys
    out["distance_block"] = dict(max_abs_err=err,
                                 **{k: v for k, v in at_chunk.items() if k != "wrapper_ms"})
    group = group_rows(K)
    xg = torch.nn.functional.normalize(
        to_dev(clustered(seed, 3 * 10**9, group, cent)), dim=1).contiguous()
    vg = to_dev(rng.random(group) > 0.05)
    a = K.distance_block(q, xg, METRIC, valid=vg)
    if not torch.allclose(a, K.distance_block_plain(q, xg, METRIC, valid=vg), rtol=RTOL,
                          atol=ATOL):
        raise AssertionError(f"distance_block at the group shape [{BATCH},{group}] disagrees")
    at_group = distance_times(torch, K, q, xg, vg, timer)
    del a, xg, vg
    log(f"phase 2 kernels: distance_block q[{BATCH},{DIM}] x [{CHUNK},{DIM}] "
        f"l2/dot/cosine x f32/bf16 with valid mask, and cosine at the approx loop's group "
        f"shape [{group},{DIM}]: max_abs_err {err:.3g} (rtol {RTOL}, atol {ATOL}), rows "
        f"equal at B = 1..{BATCH} (batch-invariant); {_distance_text(at_chunk)}; "
        f"at [{BATCH}] x [{group}]: {_distance_text(at_group)}")
    _approx_loop_check(torch, K, seed)

    # fused_topk_scan at the full capacity of the 1M-row store
    X = scan_corpus(torch, seed)
    n = X.shape[0]
    vmask = to_dev(rng.random(n) > 0.01)
    allow = to_dev(rng.random((BATCH, n)) < 0.1)
    bits = K.pack_allow_bitmask_t(allow)
    qs = to_dev(near_queries(seed, rng.integers(0, ROWS, BATCH),
                             lambda r: X[torch.from_numpy(r).to(dev)].cpu().numpy()))
    err, bad = 0.0, 0
    cases = [(10, None), (100, None), (10, bits), (100, bits)]
    for k, ab in cases:
        ad, ai = K.fused_topk_scan(qs, X, k, METRIC, valid=vmask, allow_bits=ab)
        bd, bi = K.fused_topk_scan_plain(qs, X, k, METRIC, valid=vmask, allow_bits=ab)
        ad, ai, bd, bi = (t.cpu().numpy() for t in (ad, ai, bd, bi))
        if not np.array_equal(ai < 0, bi < 0):
            raise AssertionError(f"fused_topk_scan k={k}: live slots differ")
        live = bi >= 0
        if not np.allclose(ad[live], bd[live], rtol=RTOL, atol=ATOL):
            raise AssertionError(f"fused_topk_scan k={k}: distances disagree")
        err = max(err, float(np.abs(ad[live] - bd[live]).max()))
        bad += tie_aware_mismatches(ai, ad, bi, bd)
    # k beyond the live rows: -1 tails
    few = torch.zeros(4096, dtype=torch.bool, device=dev)
    few[::97] = True
    ad, ai = K.fused_topk_scan(qs, X[:4096], 100, METRIC, valid=few)
    bd, bi = K.fused_topk_scan_plain(qs, X[:4096], 100, METRIC, valid=few)
    if not torch.equal(ai, bi) or not bool((ai[:, int(few.sum()):] == -1).all()):
        raise AssertionError("fused_topk_scan k > live rows disagrees")
    if bad:
        raise AssertionError(f"fused_topk_scan: {bad} id mismatches outside ties")
    rows_per, slices = K.scan_slices(n, BATCH)
    b_ms, b_by = _scan_bound(X, BATCH, TOP_K)
    # yardstick: cuBLAS addmm (1 - q.x, dead rows + MASKED as a bias row) then torch.topk
    qsn = torch.nn.functional.normalize(qs, dim=1)
    bias = 1.0 + (~vmask).float() * MASKED_DISTANCE
    out["fused_topk_scan"] = dict(
        max_abs_err=err,
        ms=timer(lambda: K.fused_topk_scan(qs, X, TOP_K, METRIC, valid=vmask), reps=5),
        plain_ms=timer(lambda: K.fused_topk_scan_plain(qs, X, TOP_K, METRIC, valid=vmask),
                       reps=3, warmup=1),
        library_ms=timer(lambda: torch.topk(torch.addmm(bias, qsn, X.T, alpha=-1.0), TOP_K,
                                            dim=1, largest=False), reps=3, warmup=1),
        bound_ms=b_ms, bound_by=b_by)
    log(f"phase 2 kernels: fused_topk_scan q[{BATCH},{DIM}] x [{n},{DIM}] k=10/100 "
        f"with and without per-query allow_bits, and k > live rows: ids equal to the plain "
        f"version ({bad} mismatches outside ties of {TIE_TOL}), max_abs_err {err:.3g}; "
        f"kernel {out['fused_topk_scan']['ms']:.3f} ms ({slices} slices of {rows_per} rows, "
        f"merge included), plain {out['fused_topk_scan']['plain_ms']:.3f} ms, "
        f"addmm+topk {out['fused_topk_scan']['library_ms']:.3f} ms, "
        f"{_bound_text(out['fused_topk_scan'])}")
    _scan_checks(torch, K, X, qs, vmask, bits)
    for part in topk_times(torch, K, X, vmask, qs, timer):
        log(f"phase 2 kernels: topk times: {part}")
    scan, operands = _scan_reduce_kernels(torch, K, X, qs, vmask, bits, rng, timer)
    out.update(scan)
    block, counts2 = _block_kernels(torch, K, operands, qs, rng, timer)
    out.update(block)
    del X, allow, bits, vmask, bias, operands
    torch.cuda.empty_cache()

    # fused_topk_pairs: [256, 8192] at k = 100 and 256, and the scan's merge shape
    vals = torch.randn((BATCH, CHUNK), device=dev)
    vals[:, ::5] = MASKED_DISTANCE
    ids = torch.randint(0, 1 << 30, (BATCH, CHUNK), device=dev, dtype=torch.int32)
    for k in (100, 256):
        a = K.fused_topk_pairs(vals, ids, k)
        b = K.fused_topk_pairs_plain(vals, ids, k)
        if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])):
            raise AssertionError(f"fused_topk_pairs k={k} disagrees")
    parts = [(torch.sort(torch.randn((BATCH, 64), device=dev), dim=1)[0],
              torch.randint(-1, 4096, (BATCH, 64), device=dev, dtype=torch.int32))
             for _ in range(3)]
    maps = [torch.randperm(1 << 16, device=dev)[:4096].to(torch.int32) for _ in range(3)]
    fa = merge_epoch_topk(parts, maps, TOP_K, selection="fused")
    fb = merge_epoch_topk(parts, maps, TOP_K, selection="exact")
    if not (torch.equal(fa[0], fb[0]) and torch.equal(fa[1], fb[1])):
        raise AssertionError("merge_epoch_topk(selection='fused') disagrees with exact")
    m = slices * TOP_K
    mv = torch.sort(torch.rand((BATCH, slices, TOP_K), device=dev), dim=2)[0].reshape(BATCH, m)
    mi = torch.randint(0, n, (BATCH, m), device=dev, dtype=torch.int32)
    a = K.fused_topk_pairs(mv, mi, TOP_K)
    b = K.fused_topk_pairs_plain(mv, mi, TOP_K)
    if not torch.equal(a[1], b[1]):
        raise AssertionError(f"fused_topk_pairs [{BATCH},{m}] k={TOP_K}: ids disagree")
    err = (a[0] - b[0]).abs().max().item()
    b_ms, b_by = _pairs_bound(BATCH, m, TOP_K)
    out["fused_topk_pairs"] = dict(
        max_abs_err=err,
        ms=timer(lambda: K.fused_topk_pairs(mv, mi, TOP_K), reps=20),
        plain_ms=timer(lambda: K.fused_topk_pairs_plain(mv, mi, TOP_K), reps=20),
        library_ms=timer(lambda: torch.topk(mv, TOP_K, dim=1, largest=False), reps=20),
        bound_ms=b_ms, bound_by=b_by)
    log(f"phase 2 kernels: fused_topk_pairs [{BATCH},{CHUNK}] k=100/256 and "
        f"merge_epoch_topk(selection='fused'): equal to the plain version; at the scan's "
        f"merge shape [{BATCH},{m}] k={TOP_K}: ids equal, max_abs_err {err:.3g}; "
        f"kernel {out['fused_topk_pairs']['ms']:.4f} ms, "
        f"plain {out['fused_topk_pairs']['plain_ms']:.4f} ms, torch.topk "
        f"{out['fused_topk_pairs']['library_ms']:.4f} ms, {_bound_text(out['fused_topk_pairs'])}")
    _pairs_checks(torch, K)
    out["bm25_block"] = _bm25_kernel(torch, K, rng, timer)
    return out, counts2


def _scan_checks(torch, K, X, qs, vmask, bits) -> None:
    """fused_topk_scan beyond phase 2's f32 cases: the bf16 copy of the
    corpus held tie-aware to the plain version; its returned distances
    equal distance_block's at the returned rows, bit for bit, at f32 and
    bf16 (both sum k = 0 .. d-1 in one fmaf chain); the dot metric on rows
    orthogonal to the queries (exact zero products: every such row is at
    distance -0.0, thousands of ties that only the row breaks) equal to
    the plain version id for id."""
    n = X.shape[0]
    Xb = X.to(torch.bfloat16)
    bad, err = 0, 0.0
    for xs, name in ((X, "f32"), (Xb, "bf16")):
        for k, ab in ((10, bits), (TOP_K, None)):
            ad, ai = K.fused_topk_scan(qs, xs, k, METRIC, valid=vmask, allow_bits=ab)
            if xs is Xb:
                bd, bi = K.fused_topk_scan_plain(qs, xs, k, METRIC, valid=vmask, allow_bits=ab)
                a_, b_ = (ad.cpu().numpy(), ai.cpu().numpy()), (bd.cpu().numpy(), bi.cpu().numpy())
                if not np.array_equal(a_[1] < 0, b_[1] < 0):
                    raise AssertionError(f"fused_topk_scan bf16 k={k}: live slots differ")
                live = b_[1] >= 0
                if not np.allclose(a_[0][live], b_[0][live], rtol=RTOL, atol=ATOL):
                    raise AssertionError(f"fused_topk_scan bf16 k={k}: distances disagree")
                err = max(err, float(np.abs(a_[0][live] - b_[0][live]).max()))
                bad += tie_aware_mismatches(a_[1], a_[0], b_[1], b_[0])
            # bit-identity with distance_block at the returned rows
            same = True
            for s in range(0, qs.shape[0], 64):
                full = K.distance_block(qs[s:s + 64], xs, METRIC)
                got = ai[s:s + 64]
                want = torch.gather(full, 1, got.clamp(min=0).long())
                same &= bool(torch.equal(torch.where(got >= 0, want, ad[s:s + 64]), ad[s:s + 64]))
                del full
            if not same:
                raise AssertionError(f"fused_topk_scan {name} k={k}: distances differ from "
                                     "distance_block's at the returned rows")
    if bad:
        raise AssertionError(f"fused_topk_scan bf16: {bad} id mismatches outside ties")
    del Xb
    # ragged shapes: B past a 64-query block, N past a 128-row tile, d not
    # a multiple of 16 or of 4 (the synchronous, non-cp.async path)
    gen = torch.Generator(device="cuda").manual_seed(3)
    ragged = ((3, 1000, 77), (70, 5000, 130), (1, 129, DIM), (130, 300, 36), (65, 9000, 20))
    for (b, m, d), metric in zip(ragged * 3, ("l2-squared",) * 5 + ("dot",) * 5 + ("cosine",) * 5):
        qr = torch.randn((b, d), device="cuda", generator=gen)
        for dtype in (torch.float32, torch.bfloat16):
            xr = torch.randn((m, d), device="cuda", generator=gen).to(dtype)
            vr = torch.rand(m, device="cuda", generator=gen) > 0.2
            br = K.pack_allow_bitmask_t(torch.rand((b, m), device="cuda", generator=gen) < 0.7)
            for k, ab in ((7, None), (128, br)):
                ad, ai = K.fused_topk_scan(qr, xr, k, metric, valid=vr, allow_bits=ab)
                bd, bi = K.fused_topk_scan_plain(qr, xr, k, metric, valid=vr, allow_bits=ab)
                a_, b_ = (ad.cpu().numpy(), ai.cpu().numpy()), (bd.cpu().numpy(), bi.cpu().numpy())
                live = b_[1] >= 0
                if not (np.array_equal(a_[1] < 0, ~live)
                        and np.allclose(a_[0][live], b_[0][live], rtol=RTOL, atol=ATOL)
                        and tie_aware_mismatches(a_[1], a_[0], b_[1], b_[0]) == 0):
                    raise AssertionError(f"fused_topk_scan {metric} {dtype} [{b},{d}] x "
                                         f"[{m},{d}] k={k} disagrees with the plain version")
                full = K.distance_block(qr, xr, metric)
                want = torch.gather(full, 1, ai.clamp(min=0).long())
                if not torch.equal(torch.where(ai >= 0, want, ad), ad):
                    raise AssertionError(f"fused_topk_scan {metric} {dtype} [{b},{d}] x "
                                         f"[{m},{d}]: distances differ from distance_block's")
    # dot metric, exact zero products: queries live in the first half of
    # the dimensions, every third row in the second half only; the other
    # rows point away (distance > 0), so the k best are all zero ties
    gen = torch.Generator(device="cuda").manual_seed(7)
    nd = 20_000
    qd = torch.rand((64, DIM), device="cuda", generator=gen)
    qd[:, DIM // 2:] = 0.0
    xd = -torch.rand((nd, DIM), device="cuda", generator=gen)
    xd[::3, :DIM // 2] = 0.0
    for k in (10, TOP_K, 128):
        ad, ai = K.fused_topk_scan(qd, xd, k, "dot")
        bd, bi = K.fused_topk_scan_plain(qd, xd, k, "dot")
        if not (torch.equal(ai, bi) and torch.equal(ad, bd)):
            raise AssertionError(f"fused_topk_scan dot zero products k={k} disagrees")
        if not bool((ad == 0).all()):
            raise AssertionError("fused_topk_scan dot zero products: the ties did not win")
    log(f"phase 2 kernels: fused_topk_scan bf16 copy of the [{n},{DIM}] corpus k=10 (per-query "
        f"allow_bits) / {TOP_K}: ids equal to the plain version ({bad} mismatches outside ties),"
        f" max_abs_err {err:.3g}; f32 and bf16 distances equal distance_block's at the returned "
        f"rows bit for bit; {len(ragged)} ragged shapes x 3 metrics x f32/bf16 x k=7/128 "
        f"(per-query allow_bits at 128, d = 20 / 36 / 77 / 130 / 768) held alike; dot on [{nd},{DIM}] rows with exact zero products (ties at 0) "
        f"k=10/{TOP_K}/128: equal to the plain version")


def _pairs_checks(torch, K) -> None:
    """fused_topk_pairs equal to its plain version (ids and values under
    ==) on the inputs that break a careless select: values on 16 levels
    (the k-th value shared by many positions), +0.0 / -0.0 groups, NaN,
    +inf, -inf and MASKED_DISTANCE entries, rows with nothing live, M < k,
    M = 1, M not a multiple of 32, k = 1 / 100 / 256, [256, 16384] and a
    row too wide for shared memory ([8, 200000])."""
    from weaviate_tpu_torch.ops.distances import MASKED_DISTANCE

    gen = torch.Generator(device="cuda").manual_seed(11)

    def rand(b, m):
        return torch.rand((b, m), device="cuda", generator=gen)

    def levels(b, m):
        return torch.floor(rand(b, m) * 16) / 16

    def zeros(b, m):
        v = levels(b, m) + 0.5
        z = rand(b, m) < 0.3
        sign = torch.where(rand(b, m) < 0.5, -1.0, 1.0)
        return torch.where(z, sign * 0.0, v)

    def specials(b, m):
        v = levels(b, m) - 0.5
        r = rand(b, m)
        v = torch.where(r < 0.1, float("nan"), v)
        v = torch.where((r >= 0.1) & (r < 0.2), float("inf"), v)
        v = torch.where((r >= 0.2) & (r < 0.3), MASKED_DISTANCE, v)
        v = torch.where((r >= 0.3) & (r < 0.32), float("-inf"), v)
        v[::4] = MASKED_DISTANCE  # nothing live
        v[1::4] = float("nan")
        v[2::8, : m // 2] = float("nan")
        return v

    cases = []
    for k in (1, TOP_K, 256):
        cases += [(f"16 levels k={k}", levels(64, 8192), k),
                  (f"+-0 k={k}", zeros(64, 4099), k),
                  (f"specials k={k}", specials(64, 4096), k),
                  (f"random k={k}", rand(64, 8192), k)]
    cases += [("M<k", levels(16, 50), TOP_K), ("M<k zeros", zeros(16, 200), 256),
              ("M=1 k=1", rand(8, 1), 1), ("M=1 k=100", specials(8, 1), TOP_K),
              ("M=1000+7", levels(33, 1007), TOP_K), ("M=31", zeros(3, 31), 16),
              ("[256,16384] k=100", rand(256, 16384), TOP_K),
              ("[256,16384] k=256", levels(256, 16384), 256),
              ("[256,16385] levels", levels(256, 16385), TOP_K),
              ("[8,200000] k=100", rand(8, 200_000), TOP_K),
              ("[8,200000] levels k=256", levels(8, 200_000), 256),
              ("[8,200000] specials", specials(8, 200_000), TOP_K)]
    for name, v, k in cases:
        ids = torch.randint(0, 1 << 30, v.shape, device="cuda", dtype=torch.int32, generator=gen)
        a = K.fused_topk_pairs(v, ids, k)
        b = K.fused_topk_pairs_plain(v, ids, k)
        if not (torch.equal(a[1], b[1]) and torch.equal(a[0], b[0])):
            raise AssertionError(f"fused_topk_pairs {name} {tuple(v.shape)} disagrees")
    log(f"phase 2 kernels: fused_topk_pairs {len(cases)} edge cases (16-level ties, +0/-0, "
        f"NaN/+-inf/MASKED, empty rows, M < k, M = 1, ragged M, k = 1/100/256, [256,16384], "
        f"[8,200000] past shared memory): ids and values equal to the plain version")


def _bm25_operands(torch, rng, b, s, t, c, wild=False, dev="cuda"):
    """Random operands of bm25_block on the card: integer term
    frequencies (60% zero), property lengths, boosts including 0, real
    term indexes (every segment names a term below T, or with ``wild``
    ~15% of them a term outside [0, T) and the terms out of order) and
    idf, per-row k1 / b with the host-rounded 1 - b, and ~90% live
    candidates."""
    from weaviate_tpu_torch.ops import kernels as K

    tf = rng.integers(1, 6, (b, s, c)).astype(np.float32)
    tf[rng.random((b, s, c)) < 0.6] = 0.0
    k1 = rng.uniform(0.5, 2.0, b).astype(np.float32)
    bb = rng.uniform(0.0, 1.0, b).astype(np.float32)
    term = rng.integers(0, t, (b, s)).astype(np.int32)
    if wild:
        odd = rng.random((b, s)) < 0.15
        term[odd] = rng.choice(np.int32([-1, -7, t, t + 5, 2 ** 30]), int(odd.sum()))
    host = dict(
        seg_tf=tf, seg_len=rng.integers(1, 400, (b, s, c)).astype(np.float32),
        seg_term=term, seg_boost=rng.choice(np.float32([0.0, 0.5, 1.0, 2.0]), (b, s)),
        seg_avg=rng.uniform(20.0, 200.0, (b, s)).astype(np.float32),
        idf=rng.uniform(0.0, 8.0, (b, t)).astype(np.float32), k1=k1, b=bb,
        omb=(np.float32(1.0) - bb).astype(np.float32))
    ops = {n: torch.from_numpy(a).to(dev) for n, a in host.items()}
    ops["cand_bits"] = K.pack_allow_bitmask_t(
        torch.from_numpy(rng.random((b, c)) < 0.9).to(dev))
    return ops


BM25_ARGS = ("seg_tf", "seg_len", "seg_term", "seg_boost", "seg_avg", "idf", "k1", "b",
             "omb", "cand_bits")
BM25_SHAPE = (64, 16, 8, 4096)  # B, S, T, C of the hybrid path at its 4096 budget
# one fused hybrid dispatch of 8 rows as the card runs it: its operands
# padded up to ops/bm25.GRAPH_SHAPE (phase 7's split prints the padded
# shape of its own dispatches)
BM25_DISPATCH_SHAPE = (8, 64, 32, 4096)
# (B, S, T, C, wild terms): ragged shapes, every term tile of the kernel
# (8, 16, 32, 64 terms), T past one 64-term tile (T = 320 ending in a
# partial tile, T = 512), terms out of order and outside [0, T), and an
# 8-row dispatch's own pow2 shape before the padding
BM25_CHECKS = ((1, 1, 1, 512, False), (3, 5, 3, 1024, False), (7, 13, 6, 1536, False),
               (16, 32, 16, 2048, False), (2, 64, 64, 512, False), (33, 8, 8, 512, False),
               (2, 640, 320, 512, False), (3, 1024, 512, 1024, False),
               (4, 24, 24, 1024, True), (5, 40, 40, 512, True), (9, 300, 70, 1024, True),
               (6, 12, 12, 1536, True), (8, 32, 16, 4096, False), BM25_DISPATCH_SHAPE + (False,),
               BM25_SHAPE + (False,))


def bm25_checks(torch, K, rng, dev="cuda") -> int:
    """bm25_block against its plain version, bit for bit, at BM25_CHECKS:
    both evaluate the host scorer's f32 operations in its order, so
    equality is exact. Returns the number of shapes."""
    for b, s, t, c, wild in BM25_CHECKS:
        ops = _bm25_operands(torch, rng, b, s, t, c, wild, dev)
        a = K.bm25_block(*(ops[n] for n in BM25_ARGS))
        p = K.bm25_block_plain(*(ops[n] for n in BM25_ARGS))
        if not torch.equal(a.view(torch.int32), p.view(torch.int32)):
            bad = int((a != p).sum().item())
            raise AssertionError(f"bm25_block [{b},{s},{t},{c}]{' wild' if wild else ''}: "
                                 f"{bad} values differ from the plain version")
    return len(BM25_CHECKS)


def graph_ms(torch, K, fns, reps: int = 24) -> float:
    """Mean ms of one call on the card without the host's cost of
    launching it: ``reps`` calls, cycling through ``fns`` (operand sets
    that together overflow the 50 MB L2, so each call reads its operands
    from device memory), captured in one CUDA graph (the capture counts
    no launch) and replayed between CUDA events."""
    for fn in fns:  # warm-up, outside the graph
        fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with getattr(K, "recording_launches", contextlib.nullcontext)():
        with torch.cuda.graph(g):
            for i in range(reps):
                fns[i % len(fns)]()
    g.replay()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    g.replay()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def bm25_time(torch, K, rng, timer, shape, plain: bool = True) -> dict:
    """bm25_block timed at ``shape`` (B, S, T, C) beside its bound: both
    planes and the scalars read once, the output written once; operations,
    the reference kernel's cost estimate B*C*(4S + T(S+3)) at the FP32
    rate. ``ms`` is the kernel on the card (graph_ms, operands from device
    memory); ``call_ms`` the wrapper called from Python back to back, which
    the host's launch path bounds at these sizes."""
    b, s, t, c = shape
    nbytes = 2 * b * s * c * 4 + 3 * b * s * 4 + b * t * 4 + 3 * b * 4 + b * c // 8 \
        + b * c * 4
    sets = [[o[n] for n in BM25_ARGS] for o in (
        _bm25_operands(torch, rng, b, s, t, c) for _ in range(max(2, -(-120_000_000 // nbytes))))]
    args = sets[0]
    b_ms, b_by = bound_ms(nbytes, b * c * (4 * s + t * (s + 3)), FP32_FLOPS)
    return dict(max_abs_err=0.0,
                ms=graph_ms(torch, K, [lambda a=a: K.bm25_block(*a) for a in sets]),
                call_ms=timer(lambda: K.bm25_block(*args), reps=50),
                plain_ms=timer(lambda: K.bm25_block_plain(*args), reps=5) if plain else None,
                library_ms=None, bound_ms=b_ms, bound_by=b_by)


def _bm25_kernel(torch, K, rng, timer) -> dict:
    """bm25_block against its plain version on the card, bit for bit
    (bm25_checks), then timed at the hybrid path's [64, 16, 8, 4096] and at
    one 8-row dispatch's BM25_DISPATCH_SHAPE."""
    from weaviate_tpu_torch.ops import bm25 as B

    if getattr(B, "GRAPH_SHAPE", BM25_DISPATCH_SHAPE[1:]) != BM25_DISPATCH_SHAPE[1:]:
        raise AssertionError(f"BM25_DISPATCH_SHAPE {BM25_DISPATCH_SHAPE} is not 8 rows at "
                             f"ops/bm25.GRAPH_SHAPE {B.GRAPH_SHAPE}")
    n = bm25_checks(torch, K, rng)
    o = bm25_time(torch, K, rng, timer, BM25_SHAPE)
    od = bm25_time(torch, K, rng, timer, BM25_DISPATCH_SHAPE, plain=False)
    call_ms = o.pop("call_ms")
    log(f"phase 2 kernels: bm25_block {n} shapes (ragged, every term tile, T past one tile, "
        f"terms outside [0, T), the dispatch's {list(BM25_DISPATCH_SHAPE)} and the hybrid "
        f"path's {list(BM25_SHAPE)} (B, S, T, C)): equal to the plain version bit for bit; "
        f"at {list(BM25_SHAPE)} kernel {o['ms']:.4f} ms (CUDA graph of launches, operands "
        f"from device memory; the wrapper called back to back {call_ms:.4f} ms), plain "
        f"{o['plain_ms']:.4f} ms, library {NO_LIBRARY}, {_bound_text(o)}; at "
        f"{list(BM25_DISPATCH_SHAPE)} kernel {od['ms']:.4f} ms (called {od['call_ms']:.4f}), "
        f"{_bound_text(od)}")
    return o


# pq4_lut_block beyond the main shape: (B, N, m, k, table, valid). Ragged m
# (1, 3, 17, 33) and m past the first design's 3,632-segment cap, B off the
# 64-query block, codes past k and past 15 (codes run to 17), tables of
# bf16 subnormals, -0.0 and zeros ("tiny"), infinite entries ("inf": NaN
# wherever the one-hot product meets 0 * inf), all-dead and partly dead rows
LUT_CHECKS = ((1, 257, 1, 16, "normal", None), (3, 1000, 3, 12, "normal", "dead10"),
              (65, 513, 17, 16, "tiny", "alldead"), (130, 2050, 33, 16, "tiny", "dead10"),
              (5, 4099, 192, 16, "normal", "dead10"), (64, 777, 48, 16, "inf", None),
              (70, 600, 40, 16, "inf", "dead10"), (7, 3001, 3700, 16, "normal", "dead10"),
              (2, 1536, 4100, 9, "tiny", None))


def _lut_table(rng, b, m, kc, kind) -> np.ndarray:
    lut = (rng.standard_normal((b, m, kc)) * 3).astype(np.float32)
    if kind == "tiny":  # bf16 subnormals j * 2**-133, -0.0 and zeros among small normals
        sub = (rng.integers(-127, 128, (b, m, kc)) * 2.0 ** -133).astype(np.float32)
        pick = rng.random((b, m, kc))
        lut = np.where(pick < 0.6, sub, lut * np.float32(2.0 ** -120)).astype(np.float32)
        lut[pick > 0.95] = -0.0
    elif kind == "inf":
        pick = rng.random((b, m, kc))
        lut[pick < 0.002] = np.inf
        lut[pick > 0.999] = -np.inf
    return lut


def _same_bits(torch, a, b, what) -> None:
    """Equal bit for bit, NaN payloads aside: NaN in the same places, every
    other entry the same bits."""
    if a.dtype != b.dtype or a.shape != b.shape:
        raise AssertionError(f"{what}: {a.dtype} {tuple(a.shape)} against the plain "
                             f"version's {b.dtype} {tuple(b.shape)}")
    an, bn = a.isnan(), b.isnan()
    if not torch.equal(an, bn):
        raise AssertionError(f"{what}: NaN at {int((an != bn).sum())} other places")
    ia, ib = a[~an].view(torch.int16), b[~bn].view(torch.int16)
    if not torch.equal(ia, ib):
        raise AssertionError(f"{what}: {int((ia != ib).sum())} values differ from the "
                             "plain version")


def lut_checks(torch, K, rng, dev="cuda") -> int:
    """pq4_lut_block against its plain version at LUT_CHECKS, bit for bit
    (NaN payloads aside). Returns the number of cases run; a tree whose
    kernel refuses m past its cap skips those."""
    ran = 0
    for b, n, m, kc, kind, vmode in LUT_CHECKS:
        if m > getattr(K, "PQ4_LUT_MAX_SEGMENTS", m):
            continue
        lut = torch.from_numpy(_lut_table(rng, b, m, kc, kind)).to(dev)
        codes = torch.from_numpy(rng.integers(0, 18, (n, m)).astype(np.uint8)).to(dev)
        valid = None if vmode is None else torch.from_numpy(
            rng.random(n) > (1.1 if vmode == "alldead" else 0.1)).to(dev)
        _same_bits(torch, K.pq4_lut_block(lut, codes, valid),
                   K.pq4_lut_block_plain(lut, codes, valid),
                   f"pq4_lut_block [{b},{m},{kc}] x [{n},{m}] {kind} valid {vmode}")
        ran += 1
    return ran


def lut_time(torch, K, lut, codes, valid, timer, plain: bool = True) -> dict:
    """pq4_lut_block timed beside its bound: the f32 LUT, the codes and
    valid read once, the bf16 output written once; operations, the
    function's B*N*m f32 additions (the sum in segment order), each an
    FADD at the FP32 issue rate. ``onehot_ms``: a design figure, the
    one-hot product's 2*B*N*16m at the bf16 rate (the TPU kernel's MXU
    product; the kernel issues it besides the additions)."""
    b, m, _ = lut.shape
    n = codes.shape[0]
    b_ms, b_by = bound_ms(lut.numel() * 4 + codes.numel() + n + b * n * 2,
                          float(b * n * m), FP32_ADDS)
    return dict(max_abs_err=0.0, ms=timer(lambda: K.pq4_lut_block(lut, codes, valid), reps=5),
                plain_ms=timer(lambda: K.pq4_lut_block_plain(lut, codes, valid), reps=1,
                               warmup=0) if plain else None,
                library_ms=None, bound_ms=b_ms, bound_by=b_by,
                onehot_ms=2.0 * b * n * 16 * m / BF16_FLOPS * 1e3)


def _same_scan(torch, a, b, what) -> float:
    """Scan-reduce outputs must be equal: vals everywhere, ids wherever
    the slot is live (the ids of masked slots are never read)."""
    from weaviate_tpu_torch.ops.distances import MASKED_DISTANCE

    (av, ai), (bv, bi) = a, b
    live = bv < MASKED_DISTANCE
    if not (torch.equal(av, bv) and torch.equal(ai[live], bi[live])):
        raise AssertionError(f"{what}: kernel disagrees with its plain version")
    return (av - bv).abs().max().item()


def bq_ragged_checks(torch, K, rng, dev) -> int:
    """bq_scan_reduce against its plain version, bit for bit, at ragged
    shapes; returns the number of shapes."""
    def words(shape):
        return torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, shape, dtype=np.int64)
                                .astype(np.int32)).to(dev)

    def allow_of(b, rows):
        return K.pack_allow_bitmask_t(torch.from_numpy(rng.random((b, rows)) < 0.5).to(dev))

    # B, N and W off every tile size, both layouts, masks: B past one
    # query block of the tensor-core body (65, 129, 257, 300), W = 1, 3,
    # 25, 33 and 200 (too wide for it: the popcount body), N = 1 and 9001,
    # with and without valid rows
    ragged = 0
    for b, rows, w, L, tp, masked, has_valid in [
            (1, 1, 1, 4, False, False, True), (7, 130, 3, 4, False, False, True),
            (33, 2001, 4, 8, True, False, True), (40, 9001, 24, 64, False, True, True),
            (70, 3000, 4, 2, True, True, True), (5, 5000, 25, 16, False, True, True),
            (65, 9001, 25, 16, False, True, True), (65, 1, 33, 2, True, False, False),
            (129, 1, 1, 4, False, True, True), (129, 9001, 24, 64, True, False, False),
            (257, 9001, 33, 64, False, False, True), (257, 2001, 1, 32, True, True, False),
            (300, 5000, 3, 8, False, True, False), (300, 9001, 25, 64, True, True, True),
            (1, 9001, 24, 64, False, True, False), (8, 9001, 33, 16, True, False, True),
            (17, 3000, 200, 8, False, True, True)]:
        q, x = words((b, w)), words((w, rows) if tp else (rows, w))
        valid = torch.from_numpy(rng.random(rows) > 0.3).to(dev) if has_valid else None
        ab = allow_of(b, rows) if masked else None
        _same_scan(torch, K.bq_scan_reduce(q, x, valid, L, tp, allow_bits=ab),
                   K.bq_scan_reduce_plain(q, x, valid, L, tp, allow_bits=ab),
                   f"bq_scan_reduce ragged b={b} n={rows} w={w} transposed={tp} "
                   f"allow={masked} valid={has_valid}")
        ragged += 1
    return ragged


def _scan_reduce_kernels(torch, K, X, qs, vmask, bits, rng, timer) -> dict:
    """bq_scan_reduce and pq4_scan_reduce against their plain versions on
    the card: ragged shapes first, then the main path's (the 1M-row
    corpus X as sign words and as 4-bit PQ codes, with and without the
    per-query allow bits, and the two-stage scan's transposed prefix).
    Equality is exact: the arithmetic is integer, and the one f32
    division by the query's scale is exact in IEEE. Returns the numbers
    and the operands the block kernels reuse (the sign words, the 4-bit
    codes, the queries' LUTs and the centroids)."""
    from weaviate_tpu_torch.ops import bq as bq_ops
    from weaviate_tpu_torch.ops import pq as pq_ops

    dev = X.device
    n = X.shape[0]
    out = {}

    def allow_of(b, rows):
        return K.pack_allow_bitmask_t(torch.from_numpy(rng.random((b, rows)) < 0.5).to(dev))

    # ragged: B, N and m off every tile size, both layouts, masks
    ragged, pq_ragged = bq_ragged_checks(torch, K, rng, dev), 0
    for b, rows, m, kc, L, tp, masked in [(1, 1, 1, 16, 4, False, False),
                                          (7, 130, 8, 12, 4, False, False),
                                          (17, 2001, 12, 16, 8, True, True),
                                          (20, 9001, 24, 16, 64, False, True),
                                          (33, 5000, 33, 16, 16, False, False),
                                          (5, 4000, 192, 9, 32, True, False),
                                          # past the 896 segments the first kernel
                                          # refused: m = 1024 and ragged m
                                          (70, 9001, 1024, 16, 16, False, True),
                                          (70, 9001, 1024, 16, 16, True, True),
                                          (33, 5000, 901, 16, 8, False, True),
                                          (33, 5000, 901, 11, 8, True, True),
                                          (65, 3000, 1000, 16, 64, False, False)]:
        lut = torch.from_numpy((rng.standard_normal((b, m, kc)) * 3).astype(np.float32)).to(dev)
        codes = rng.integers(0, kc, (rows, m)).astype(np.uint8)
        c = torch.from_numpy(np.ascontiguousarray(codes.T) if tp else codes).to(dev)
        valid = torch.from_numpy(rng.random(rows) > 0.3).to(dev)
        ab = allow_of(b, rows) if masked else None
        _same_scan(torch, K.pq4_scan_reduce(lut, c, valid, L, tp, allow_bits=ab),
                   K.pq4_scan_reduce_plain(lut, c, valid, L, tp, allow_bits=ab),
                   f"pq4_scan_reduce ragged b={b} n={rows} m={m} kc={kc} transposed={tp}")
        pq_ragged += 1

    # the main path's shapes: [256, 24 words] x 1,048,576 rows, reduce_l 64
    # (and the drains' B = 1, 8, 64)
    L = bq_ops._auto_reduce_l(n)
    xw = torch.cat([bq_ops.bq_encode(X[s:s + ADD_BATCH]) for s in range(0, n, ADD_BATCH)])
    qw = bq_ops.bq_encode(qs)
    err = 0.0
    for ab in (None, bits):
        err = max(err, _same_scan(torch, K.bq_scan_reduce(qw, xw, vmask, L, allow_bits=ab),
                                  K.bq_scan_reduce_plain(qw, xw, vmask, L, allow_bits=ab),
                                  f"bq_scan_reduce [{BATCH},{qw.shape[1]}] x [{n}]"))
    for b in (1, 8, 64):
        _same_scan(torch, K.bq_scan_reduce(qw[:b], xw, vmask, L),
                   K.bq_scan_reduce_plain(qw[:b], xw, vmask, L),
                   f"bq_scan_reduce [{b},{qw.shape[1]}] x [{n}]")
    qp, pt = qw[:, :4].contiguous(), xw[:, :4].T.contiguous()  # the 128-bit prefix
    for ab in (None, bits):
        err = max(err, _same_scan(
            torch, K.bq_scan_reduce(qp, pt, vmask, L, transposed=True, allow_bits=ab),
            K.bq_scan_reduce_plain(qp, pt, vmask, L, transposed=True, allow_bits=ab),
            f"bq_scan_reduce prefix [4,{n}]"))
    w = qw.shape[1]
    out["bq_scan_reduce"] = dict(
        max_abs_err=err,
        ms=timer(lambda: K.bq_scan_reduce(qw, xw, vmask, L), reps=10),
        plain_ms=timer(lambda: K.bq_scan_reduce_plain(qw, xw, vmask, L), reps=1, warmup=1),
        library_ms=None, **_bq_bound(qw, xw, L))
    o = out["bq_scan_reduce"]
    log(f"phase 2 kernels: bq_scan_reduce {ragged} ragged shapes, then "
        f"[{BATCH},{w} words] x [{n},{w}] reduce_l {L} with and without per-query "
        f"allow_bits, B = 1, 8, 64, and the transposed prefix [4,{n}]: equal to the plain "
        f"version (max_abs_err {err:.3g}); kernel {o['ms']:.4f} ms, plain "
        f"{o['plain_ms']:.3f} ms, library {NO_LIBRARY}, {_bound_text(o)}")
    for part in bq_times(torch, K, qw, xw, vmask, timer):
        log(f"phase 2 kernels: bq times: {part}")
    del pt

    # [256, m = 192] 4-bit codes of the same corpus, codebook trained here
    m = pq_ops.default_pq_segments(DIM)
    sample = X[torch.from_numpy(rng.choice(n, 65536, replace=False)).to(dev)].cpu().numpy()
    book = pq_ops.pq_fit(sample, m=m, k=16, iters=4, device=dev)
    codes = torch.cat([pq_ops._assign(X[s:s + ADD_BATCH], book.centroids, m).to(torch.uint8)
                       for s in range(0, n, ADD_BATCH)])
    lut = pq_ops.pq_lut(torch.nn.functional.normalize(qs, dim=1), book.centroids, METRIC, m)
    err = 0.0
    for ab in (None, bits):
        err = max(err, _same_scan(torch, K.pq4_scan_reduce(lut, codes, vmask, L, allow_bits=ab),
                                  K.pq4_scan_reduce_plain(lut, codes, vmask, L, allow_bits=ab),
                                  f"pq4_scan_reduce [{BATCH},{m}] x [{n}]"))
    b_ms, b_by = bound_ms(lut.numel() * 4 + codes.numel() + n + BATCH * (n // L) * 8,
                          2.0 * BATCH * n * 16 * m, INT8_OPS)
    out["pq4_scan_reduce"] = dict(
        max_abs_err=err,
        ms=timer(lambda: K.pq4_scan_reduce(lut, codes, vmask, L), reps=10),
        plain_ms=timer(lambda: K.pq4_scan_reduce_plain(lut, codes, vmask, L), reps=1, warmup=1),
        library_ms=None, bound_ms=b_ms, bound_by=b_by)
    o = out["pq4_scan_reduce"]
    log(f"phase 2 kernels: pq4_scan_reduce {pq_ragged} ragged shapes (m = 1024 and 901 / "
        f"1000 among them, row-major and transposed, with allow words), then "
        f"lut [{BATCH},{m},16] x codes [{n},{m}] reduce_l {L} with and without per-query "
        f"allow_bits: equal to the plain version (max_abs_err {err:.3g}); kernel "
        f"{o['ms']:.3f} ms (the int8 table's quantization and blocked layout included), plain "
        f"{o['plain_ms']:.3f} ms, "
        f"library {NO_LIBRARY}, {_bound_text(o)}")
    return out, dict(qw=qw, xw=xw, codes=codes, lut=lut, centroids=book.centroids)


def _same_block(torch, a, b, what, tol=None) -> float:
    """Block-kernel outputs against the plain version's: the same dtype
    and shape; equal, or (``tol``) within tol * max(1, max|ref|) on live
    entries with every masked entry equal. Returns the largest error."""
    if a.dtype != b.dtype or a.shape != b.shape:
        raise AssertionError(f"{what}: {a.dtype} {tuple(a.shape)} against the plain "
                             f"version's {b.dtype} {tuple(b.shape)}")
    if tol is None:
        if not torch.equal(a, b):
            raise AssertionError(f"{what}: {int((a != b).sum())} values differ from the "
                                 "plain version")
        return 0.0
    af, bf = a.float(), b.float()
    live = bf < 1e38  # masked entries are bf16(d + MASKED_DISTANCE)
    diff = (af - bf)[live].abs()
    err = diff.max().item() if diff.numel() else 0.0
    lim = tol * max(1.0, bf[live].abs().max().item() if diff.numel() else 0.0)
    if err > lim or not torch.equal(a[~live], b[~live]):
        raise AssertionError(f"{what}: max error {err} past {lim}, or masked entries differ")
    return err


# bq_mxu_block beyond the main shape: (B, N, W). W = 1, 8 and 9 on the
# single-bit body (one K step, a full one, one past it), W = 200 on the
# popcount body it keeps (bq_mxu_qblock 0); B = 8, 129 (two query blocks of
# 128) and 1,024 (the probe's), N off the 64-row tile
MXU_CHECKS = ((8, 4099, 1), (129, 9001, 8), (1024, 2050, 9), (8, 3001, 200),
              (129, 777, 200), (1024, 1001, 4))
# bq_hamming_block beyond the main shape: (B, N, W), the shapes of
# tests/test_torch_hamming_tc.py (W = 1, 3, 8, 9, 24, 25, 33; B = 1, 8, 129;
# N = 1, 63, 65, 9001), then W = 120 and 200 on the popcount body it keeps
# (bq_hamming_qblock 0) and the main W at B = 256; ham_checks also runs
# UNALIGNED on a base 4 bytes past 16-byte alignment (the 4-byte copies)
HAM_CHECKS = ((1, 1, 1), (8, 63, 3), (129, 65, 8), (1, 9001, 9), (8, 9001, 24),
              (129, 63, 25), (8, 65, 33), (129, 9001, 1), (1, 65, 24), (129, 1, 33),
              (8, 1, 9), (1, 63, 8), (1, 70, 120), (129, 33, 200), (256, 9001, 24))
UNALIGNED = ((8, 4099, 24), (129, 1001, 8), (256, 9001, 24))
# pq4_recon_block beyond the main shape: (B, N, m, k, ds, top code). ds = 3
# and 1 with d = m * ds no multiple of 16, ds = 8 and 2, codes past 15 (top
# code past 16), B past one 64-query block; d = 1,024 takes the FFMA body
# it keeps (pq4_recon_smem past the card's shared memory)
RECON_CHECKS = ((5, 7001, 25, 12, 3, 20), (65, 4099, 96, 16, 8, 17),
                (3, 999, 7, 16, 2, 18), (130, 2050, 33, 9, 1, 16), (7, 3001, 256, 16, 4, 20))


def mxu_recon_checks(torch, K, rng, dev) -> int:
    """bq_mxu_block (bit for bit) and pq4_recon_block (within PQ_TOL,
    l2 / dot / cosine) against their plain versions at MXU_CHECKS and
    RECON_CHECKS, with and without dead rows; bq_mxu_block also with a
    cached x_pop of arbitrary values and q_planes / q_pop. Returns the
    number of shapes run."""
    def words(shape):
        return torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, shape, dtype=np.int64)
                                .astype(np.int32)).to(dev)

    for b, n, w in MXU_CHECKS:
        q, x = words((b, w)), words((n, w))
        valid = torch.from_numpy(rng.random(n) > 0.1).to(dev)
        xp = torch.from_numpy(rng.uniform(0, 32 * w, n).astype(np.float32)).to(dev)
        planes = K.bq_queries_to_planes(q, w)
        for kw in ({}, dict(valid=valid),
                   dict(valid=valid, x_pop=xp, q_planes=planes, q_pop=planes.float().sum(1))):
            _same_block(torch, K.bq_mxu_block(q, x, **kw), K.bq_mxu_block_plain(q, x, **kw),
                        f"bq_mxu_block [{b},{w}] x [{n},{w}] {sorted(kw)}")
    for b, n, m, kc, ds, top in RECON_CHECKS:
        q = torch.from_numpy(rng.standard_normal((b, m * ds)).astype(np.float32)).to(dev)
        cent = torch.from_numpy(rng.standard_normal((m, kc, ds)).astype(np.float32)).to(dev)
        codes = torch.from_numpy(rng.integers(0, top, (n, m)).astype(np.uint8)).to(dev)
        valid = torch.from_numpy(rng.random(n) > 0.1).to(dev)
        for metric in ("l2-squared", "dot", "cosine"):
            qm = torch.nn.functional.normalize(q, dim=1) if metric == "cosine" else q
            for v in (None, valid):
                _same_block(torch, K.pq4_recon_block(qm, codes, cent, metric, v),
                            K.pq4_recon_block_plain(qm, codes, cent, metric, v),
                            f"pq4_recon_block {metric} [{b},{m * ds}] x [{n},{m}] ds {ds} "
                            f"codes < {top} valid {v is not None}", tol=PQ_TOL)
    return len(MXU_CHECKS) + len(RECON_CHECKS)


def ham_checks(torch, K, rng, dev) -> int:
    """bq_hamming_block bit for bit against its plain version at
    HAM_CHECKS, and at UNALIGNED on a corpus whose base is 4 bytes past
    16-byte alignment (the kernel's 4-byte copies where W % 4 == 0 would
    take 16-byte ones). Returns the number of shapes run."""
    def words(count):
        return torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, count, dtype=np.int64)
                                .astype(np.int32)).to(dev)

    for b, n, w in HAM_CHECKS:
        q, x = words(b * w).reshape(b, w), words(n * w).reshape(n, w)
        _same_block(torch, K.bq_hamming_block(q, x), K.bq_hamming_block_plain(q, x),
                    f"bq_hamming_block [{b},{w}] x [{n},{w}]")
    for b, n, w in UNALIGNED:
        q = words(b * w).reshape(b, w)
        x = words(n * w + 1)[1:].view(n, w)  # 4 bytes past the allocation's start
        if x.data_ptr() % 16 == 0:
            raise AssertionError("the unaligned corpus is aligned")
        _same_block(torch, K.bq_hamming_block(q, x), K.bq_hamming_block_plain(q, x),
                    f"bq_hamming_block unaligned [{b},{w}] x [{n},{w}]")
    return len(HAM_CHECKS) + len(UNALIGNED)


def ham_bound(b: int, n: int, w: int) -> tuple[float, str]:
    """bq_hamming_block's bound: the words and the f32 output once, against
    the reference kernel's 2*B*N*32W operations at the single-bit rate
    B1_OPS its MMAs run at: bound by the bytes."""
    return bound_ms((b + n) * w * 4 + b * n * 4, 2.0 * b * n * 32 * w, B1_OPS)


def _bit_planes(torch, words, dtype):
    """[R, W] sign words -> [R, 32W] 0/1 planes in bit-plane order (column
    j*W + word), built in slices of ADD_BATCH rows."""
    n, w = words.shape
    shifts = torch.arange(32, device=words.device)
    out = torch.empty((n, 32 * w), dtype=dtype, device=words.device)
    for s in range(0, n, ADD_BATCH):
        out[s:s + ADD_BATCH] = ((words[s:s + ADD_BATCH].long()[:, None, :]
                                 >> shifts[None, :, None]) & 1).reshape(-1, 32 * w)
    return out


def ham_yardsticks(torch, qw, xw, ham, timer) -> tuple[float | None, str]:
    """bq_hamming_block's two yardsticks at its main shape: the library
    call, torch.cdist(p=0) on the 0/1 f32 bit planes (the count of planes
    that differ: the same function, which must equal the kernel's answer
    to count), and the product alone, torch._int_mm of the 0/1 int8 planes.
    Returns (library ms or None, text)."""
    lib_ms, parts = None, []
    try:
        q01, x01 = _bit_planes(torch, qw, torch.float32), _bit_planes(torch, xw, torch.float32)
        cd = torch.cdist(q01, x01, p=0)
        if torch.equal(cd, ham):
            lib_ms = timer(lambda: torch.cdist(q01, x01, p=0), reps=2, warmup=0)
            parts.append(f"library torch.cdist(p=0) on the 0/1 f32 planes [{qw.shape[0]},"
                         f"{q01.shape[1]}] x [{x01.shape[0]},{x01.shape[1]}]: equal to the "
                         f"kernel, {lib_ms:.4f} ms")
        else:
            parts.append(f"library torch.cdist(p=0): {int((cd != ham).sum())} values differ "
                         "from the kernel's: not counted")
        del q01, x01, cd
    except RuntimeError as e:  # a yardstick only: the run goes on without it
        parts.append(f"library torch.cdist(p=0) failed: {str(e).splitlines()[0]}")
    torch.cuda.empty_cache()
    try:
        q01, x01 = _bit_planes(torch, qw, torch.int8), _bit_planes(torch, xw, torch.int8)
        ms = timer(lambda: torch._int_mm(q01, x01.t()), reps=5)
        parts.append(f"the product alone, torch._int_mm [{qw.shape[0]},{q01.shape[1]}] x "
                     f"[{q01.shape[1]},{x01.shape[0]}] 0/1 int8: {ms:.4f} ms")
        del q01, x01
    except RuntimeError as e:
        parts.append(f"yardstick torch._int_mm failed: {str(e).splitlines()[0]}")
    torch.cuda.empty_cache()
    return lib_ms, "; ".join(parts)


def mxu_bound(b: int, n: int, w: int) -> tuple[float, str]:
    """bq_mxu_block's bound: the words, the query popcounts, valid and the
    bf16 output once, against the reference kernel's cost estimate
    (2*B*N*32W, the 0/1 product) at the single-bit rate B1_OPS its MMAs
    run at, as bq_scan_reduce's: bound by the bytes."""
    return bound_ms((b + n) * w * 4 + b * 4 + n + b * n * 2, 2.0 * b * n * 32 * w, B1_OPS)


def _block_kernels(torch, K, ops, qs, rng, timer) -> tuple[dict, dict]:
    """The four block kernels against their plain versions on the card:
    ragged shapes (B = 1, 5, 256; N off every tile; W = 3 and 48; m = 24
    and 384; k = 12 and 16; LUT_CHECKS, MXU_CHECKS, RECON_CHECKS), then
    the main path's: 256 queries x the 1M-row corpus's sign words (W = 24)
    and 4-bit PQ codes (m = 192, ds = 4) from _scan_reduce_kernels, with
    ~10% dead rows; then bq_mxu_block at the shapes of tools/probe_r4.py.
    The bq kernels and pq4_lut_block must equal their plain versions bit
    for bit, pq4_recon_block within PQ_TOL. Returns the numbers and the
    launch counts of this window."""
    from weaviate_tpu_torch.ops.bq import bq_hamming_np

    dev = qs.device
    out = {}
    t0 = time.perf_counter()
    K.reset_launch_counts()  # the block kernels' window starts here

    def words(shape):
        return torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, shape, dtype=np.int64)
                                .astype(np.int32)).to(dev)

    def randn(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(dev)

    def dead10(n):
        return torch.from_numpy(rng.random(n) > 0.1).to(dev)

    def popcounts(x):
        return K.popcount32(x.to(torch.int64) & 0xFFFFFFFF).sum(dim=1).float()

    ragged = 0
    for b, n, w in [(1, 1001, 3), (5, 70001, 48), (256, 4099, 3), (256, 9001, 48)]:
        q, x, valid = words((b, w)), words((n, w)), dead10(n)
        _same_block(torch, K.bq_hamming_block(q, x), K.bq_hamming_block_plain(q, x),
                    f"bq_hamming_block ragged [{b},{w}] x [{n},{w}]")
        # a caller's cached popcounts are used as given: any f32 values
        xp = torch.from_numpy(rng.uniform(0, 32 * w, n).astype(np.float32)).to(dev)
        planes = K.bq_queries_to_planes(q, w)
        for kw in ({}, dict(valid=valid),
                   dict(valid=valid, x_pop=xp, q_planes=planes, q_pop=planes.float().sum(1))):
            _same_block(torch, K.bq_mxu_block(q, x, **kw), K.bq_mxu_block_plain(q, x, **kw),
                        f"bq_mxu_block ragged [{b},{w}] x [{n},{w}] {sorted(kw)}")
        ragged += 1
    for b, n, m, kc, ds in [(1, 1001, 24, 12, 4), (5, 70001, 384, 16, 2),
                            (256, 4099, 24, 12, 4), (256, 9001, 384, 16, 2)]:
        lut, valid = randn(b, m, kc, scale=3.0), dead10(n)
        codes = torch.from_numpy(rng.integers(0, 16, (n, m)).astype(np.uint8)).to(dev)
        for v in (None, valid):
            _same_block(torch, K.pq4_lut_block(lut, codes, v), K.pq4_lut_block_plain(lut, codes, v),
                        f"pq4_lut_block ragged [{b},{m},{kc}] x [{n},{m}]")
        q, cent = randn(b, m * ds), randn(m, kc, ds)
        for metric in ("l2-squared", "dot", "cosine"):
            qm = torch.nn.functional.normalize(q, dim=1) if metric == "cosine" else q
            _same_block(torch, K.pq4_recon_block(qm, codes, cent, metric, valid),
                        K.pq4_recon_block_plain(qm, codes, cent, metric, valid),
                        f"pq4_recon_block ragged {metric} [{b},{m * ds}] x [{n},{m}] ds {ds}",
                        tol=PQ_TOL)
        ragged += 1
    lut_cases = lut_checks(torch, K, rng, dev)
    mr_cases = mxu_recon_checks(torch, K, rng, dev)
    ham_cases = ham_checks(torch, K, rng, dev)

    # the main path's shapes: 256 queries x 1,048,576 rows, 768 dims
    qw, xw = ops["qw"], ops["xw"]
    (b, w), n = qw.shape, xw.shape[0]
    valid = dead10(n)
    ham = K.bq_hamming_block(qw, xw)
    _same_block(torch, ham, K.bq_hamming_block_plain(qw, xw), f"bq_hamming_block [{b},{w}] x [{n}]")
    np_rows = 512  # numpy's unpacked bits of [B, np_rows, W] words stay at 100 MB
    want = bq_hamming_np(qw.cpu().numpy().view(np.uint32),
                         xw[:np_rows].cpu().numpy().view(np.uint32))
    if not np.array_equal(ham[:, :np_rows].cpu().numpy(), want):
        raise AssertionError("bq_hamming_block differs from bq_hamming_np")
    mxu = K.bq_mxu_block(qw, xw, valid=valid)
    _same_block(torch, mxu, K.bq_mxu_block_plain(qw, xw, valid=valid),
                f"bq_mxu_block [{b},{w}] x [{n}]")
    # past 256 bits bf16 rounds: live rows are bf16(exact hamming)
    if not torch.equal(mxu[:, valid], ham[:, valid].to(torch.bfloat16)):
        raise AssertionError("bq_mxu_block is not bf16(exact hamming) on the live rows")
    planes = K.bq_queries_to_planes(qw, w)
    cached = K.bq_mxu_block(qw, xw, popcounts(xw), valid, planes, planes.float().sum(1))
    if not torch.equal(cached, mxu):
        raise AssertionError("bq_mxu_block with cached x_pop and q_planes differs")
    del mxu, cached
    b_ms, b_by = ham_bound(b, n, w)
    ham_ms = timer(lambda: K.bq_hamming_block(qw, xw), reps=10)
    ham_lib_ms, ham_yard = ham_yardsticks(torch, qw, xw, ham, timer)
    del ham
    out["bq_hamming_block"] = dict(
        max_abs_err=0.0, ms=ham_ms,
        plain_ms=timer(lambda: K.bq_hamming_block_plain(qw, xw), reps=1, warmup=0),
        library_ms=ham_lib_ms, bound_ms=b_ms, bound_by=b_by)
    b_ms, b_by = mxu_bound(b, n, w)
    out["bq_mxu_block"] = dict(
        max_abs_err=0.0, ms=timer(lambda: K.bq_mxu_block(qw, xw, valid=valid), reps=10),
        plain_ms=timer(lambda: K.bq_mxu_block_plain(qw, xw, valid=valid), reps=1, warmup=0),
        library_ms=None, bound_ms=b_ms, bound_by=b_by)

    # the probe shapes, kernel only, equal to the plain version on the first rows
    probe = []
    for pb, pw in PROBE_SHAPES:
        q2, x2 = words((pb, pw)), words((n, pw))
        head = 65_536
        _same_block(torch, K.bq_mxu_block(q2, x2)[:, :head], K.bq_mxu_block_plain(q2, x2[:head]),
                    f"bq_mxu_block probe [{pb},{pw}] x [{n}]")
        probe.append(f"[{pb},{pw} words] x [{n},{pw}] "
                     f"{timer(lambda: K.bq_mxu_block(q2, x2), reps=5):.3f} ms")
        del q2, x2
        torch.cuda.empty_cache()

    codes, lut, cent = ops["codes"], ops["lut"], ops["centroids"]
    m = cent.shape[0]
    _same_block(torch, K.pq4_lut_block(lut, codes, valid), K.pq4_lut_block_plain(lut, codes, valid),
                f"pq4_lut_block [{b},{m},16] x [{n},{m}]")
    qn = torch.nn.functional.normalize(qs, dim=1)
    err = 0.0
    for metric in ("l2-squared", "dot", "cosine"):
        err = max(err, _same_block(
            torch, K.pq4_recon_block(qn, codes, cent, metric, valid),
            K.pq4_recon_block_plain(qn, codes, cent, metric, valid),
            f"pq4_recon_block {metric} [{b},{DIM}] x [{n},{m}]", tol=PQ_TOL))
    lt = lut_time(torch, K, lut, codes, valid, timer)
    onehot = lt.pop("onehot_ms")
    out["pq4_lut_block"] = lt
    # operations: the distance product only; the reconstruction is a gather
    b_ms, b_by = bound_ms(qn.numel() * 4 + codes.numel() + cent.numel() * 4 + n + b * n * 2,
                          2.0 * b * n * DIM, BF16_FLOPS)
    out["pq4_recon_block"] = dict(
        max_abs_err=err, ms=timer(lambda: K.pq4_recon_block(qn, codes, cent, METRIC, valid),
                                  reps=5),
        plain_ms=timer(lambda: K.pq4_recon_block_plain(qn, codes, cent, METRIC, valid),
                       reps=1, warmup=0),
        library_ms=None, bound_ms=b_ms, bound_by=b_by)
    counts = dict(K.launch_counts)
    for name in PHASE2_PATH:
        if counts[name] == 0:
            raise AssertionError(f"{name} was not launched in phase 2")
    o = out
    log(f"phase 2 kernels: block kernels, {ragged // 2} ragged shapes each, then "
        f"[{b},{w} words] x [{n},{w}] with ~10% dead rows: bq_hamming_block equal to the plain "
        f"version and to bq_hamming_np (first {np_rows} rows), also at {ham_cases} more "
        f"shapes (HAM_CHECKS, UNALIGNED: W = 1 / 3 / 8 / 9 / 24 / 25 / 33 and the popcount "
        f"body's 120 / 200, B = 1 / 8 / 129 / 256, N = 1 / 63 / 65 / 9001, a base off 16-byte "
        f"alignment), kernel (query block {K.bq_hamming_qblock(b, w)}) "
        f"{o['bq_hamming_block']['ms']:.3f} ms, plain {o['bq_hamming_block']['plain_ms']:.3f} ms, "
        f"{_bound_text(o['bq_hamming_block'])}; {ham_yard}; bq_mxu_block equal to the plain version and "
        f"to bf16(exact hamming) on the live rows, also with cached x_pop / q_planes, kernel "
        f"{o['bq_mxu_block']['ms']:.3f} ms, plain {o['bq_mxu_block']['plain_ms']:.3f} ms, "
        f"{_bound_text(o['bq_mxu_block'])}; at the probe shapes {', '.join(probe)}; "
        f"bq_mxu_block and pq4_recon_block also at {mr_cases} more shapes (MXU_CHECKS, "
        f"RECON_CHECKS: W = 1 / 8 / 9 / 200, B = 8 / 129 / 1024; ds = 1 / 2 / 3 / 8, d off "
        f"16, codes past 15, the FFMA body at d = 1024)")
    log(f"phase 2 kernels: lut [{b},{m},16] x codes [{n},{m}] with ~10% dead rows: "
        f"pq4_lut_block equal to the plain version there and at {lut_cases} more cases "
        f"(LUT_CHECKS: ragged m up to 4100, codes past 15, subnormal / -0.0 / infinite "
        f"entries, dead rows), kernel "
        f"{o['pq4_lut_block']['ms']:.3f} ms, plain {o['pq4_lut_block']['plain_ms']:.3f} ms, "
        f"{_bound_text(o['pq4_lut_block'])} (the exact sum's FADDs), the one-hot "
        f"product at the bf16 rate {onehot:.3f} ms; "
        f"pq4_recon_block l2/dot/cosine within "
        f"{PQ_TOL} x max(1, max|ref|) (max_abs_err {err:.3g}), {METRIC} kernel "
        f"{o['pq4_recon_block']['ms']:.3f} ms, plain {o['pq4_recon_block']['plain_ms']:.3f} ms, "
        f"{_bound_text(o['pq4_recon_block'])}; library {NO_LIBRARY}; launches in this window "
        f"{ {k: counts[k] for k in out} }; block kernels' checks and timings "
        f"{time.perf_counter() - t0:.1f} s")
    return out, counts


def _exact_distances(torch, qn, ref, mask):
    """Plain recomputation (TF32 off): exact cosine distances of unit
    queries ``qn`` to unit rows ``ref``; rows outside ``mask`` are inf."""
    d = 1.0 - qn @ ref.T
    return torch.where(mask, d, torch.full_like(d, float("inf")))


def _check_against_exact(torch, d_full, got_ids, k, what):
    got = torch.from_numpy(np.asarray(got_ids, dtype=np.int64)).to(d_full.device)
    if bool((got < 0).any()):
        raise AssertionError(f"{what}: fewer than {k} results")
    dg = torch.gather(d_full, 1, got)
    kd = torch.topk(d_full, k, dim=1, largest=False)[0][:, -1]
    if not bool(torch.isfinite(dg).all()):
        raise AssertionError(f"{what}: returned a deleted or disallowed row")
    r = recall(got.cpu().numpy(), dg.cpu().numpy(), kd.cpu().numpy(), k)
    if r != 1.0:
        raise AssertionError(f"{what}: recall@{k} {r}")
    return r


def phase_index(torch, seed: int, rows: int) -> None:
    from weaviate_tpu_torch.engine.flat import FlatIndex

    dev = "cuda"
    cent = centers(seed)
    rng = np.random.default_rng([seed, 3])
    idx = FlatIndex(dim=DIM, metric=METRIC, chunk_size=CHUNK, device=dev)
    ref = torch.empty((rows, DIM), dtype=torch.float32, device=dev)
    t0 = time.perf_counter()
    for s in range(0, rows, ADD_BATCH):
        v = clustered(seed, s, min(ADD_BATCH, rows - s), cent)
        idx.add_batch(np.arange(s, s + len(v)), v)
        ref[s:s + len(v)] = torch.nn.functional.normalize(torch.from_numpy(v).to(dev), dim=1)
    idx.store.flush_staged()
    torch.cuda.synchronize()
    add_s = time.perf_counter() - t0
    deleted = rng.choice(rows, 10_000, replace=False)
    idx.delete(*deleted.tolist())
    live = torch.ones(rows, dtype=torch.bool, device=dev)
    live[torch.from_numpy(deleted).to(dev)] = False
    deleted_set = set(deleted.tolist())
    queries = near_queries(seed, rng.integers(0, rows, QUERIES),
                           lambda r: ref[torch.from_numpy(r).to(dev)].cpu().numpy())
    qn_all = torch.nn.functional.normalize(torch.from_numpy(queries).to(dev), dim=1)
    parts = [f"add {rows} rows in {add_s:.1f} s ({rows / add_s:.0f} rows/s), "
             f"capacity {idx.store.capacity}, 10000 deleted"]
    for selection in ("approx", "fused"):
        idx.store.selection = selection
        times = []
        for s in range(0, QUERIES, BATCH):
            qb = queries[s:s + BATCH]
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            ids, _d = idx.search_by_vector_batch_async(qb, TOP_K).result()
            times.append((time.perf_counter() - t1) * 1e3)
            if deleted_set.intersection(ids.ravel().tolist()):
                raise AssertionError(f"{selection}: a deleted id was returned")
            d_full = _exact_distances(torch, qn_all[s:s + BATCH], ref,
                                      live[None, :])
            for k in (10, TOP_K):
                _check_against_exact(torch, d_full, ids[:, :k], k,
                                     f"index {selection} recall@{k}")
            del d_full
        parts.append(f"{selection}: recall@10 1.0, recall@100 1.0, "
                     f"{np.median(times):.1f} ms per {BATCH}-query batch (median of "
                     f"{len(times)}, host clock)")
        # per-query filters at 10% selectivity (bitmask-batched path)
        nq = 64
        masks = rng.random((nq, rows)) < 0.10
        qb = queries[:nq]
        ids, _d = idx.search_by_vector_batch_async(qb, 10, [m for m in masks]).result()
        allowed = torch.from_numpy(masks).to(dev) & live[None, :]
        d_full = _exact_distances(torch, qn_all[:nq], ref, allowed)
        _check_against_exact(torch, d_full, ids, 10, f"{selection} per-query 10% filter")
        # one shared filter at 0.5% (gathered path)
        shared = rng.choice(rows, rows // 200, replace=False)
        h = idx.store.search_async(qb, 10, idx._allow_mask(shared))
        if h.attrs["path"] != "gathered":
            raise AssertionError("0.5% shared filter did not take the gathered path")
        h.result()
        ids2, _d = idx.search_by_vector_batch(qb, 10, shared)
        smask = torch.zeros(rows, dtype=torch.bool, device=dev)
        smask[torch.from_numpy(shared).to(dev)] = True
        d_full = _exact_distances(torch, qn_all[:nq], ref, (smask & live)[None, :])
        _check_against_exact(torch, d_full, ids2, 10, f"{selection} shared 0.5% filter")
    log(f"phase 3 index: FlatIndex(device='cuda') {rows} x {DIM} {METRIC} f32; "
        + "; ".join(parts) + "; per-query 10% filters (bitmask) and a shared 0.5% "
        "filter (gathered) recall@10 1.0 for both selections")
    del idx, ref
    torch.cuda.empty_cache()


def _collection(db, name: str, quantization: str | None = None):
    from weaviate_tpu_torch.schema.config import (CollectionConfig, Property,
                                                  VectorConfig, VectorIndexConfig)

    return db.create_collection(CollectionConfig(
        name=name,
        properties=[Property(name="category", data_type="text"),
                    Property(name="views", data_type="int")],
        vectors=[VectorConfig(index=VectorIndexConfig(
            index_type="flat", metric=METRIC, quantization=quantization))]))


def _uuid(prefix: int, row: int) -> str:
    return f"00000000-0000-4000-{prefix:04d}-{row:012d}"


def _import(torch, col, seed: int, rows: int, prefix: int, rng, budget_s: float):
    """batch_put ``rows`` objects of clustered vectors (cut when the time
    budget runs out). Returns (unit rows on the card, views, count, s)."""
    dev = "cuda"
    cent = centers(seed)
    ref = torch.empty((rows, DIM), dtype=torch.float32, device=dev)
    views = np.empty(rows, dtype=np.int64)
    t0 = time.perf_counter()
    done = 0
    while done < rows and time.perf_counter() - t0 < budget_s:
        n = min(IMPORT_BATCH, rows - done)
        v = clustered(seed, done, n, cent)
        vw = rng.integers(0, 100, n)
        res = col.batch_put([
            {"uuid": _uuid(prefix, done + i),
             "properties": {"category": f"cat{(done + i) % 100}", "views": int(vw[i])},
             "vector": v[i]} for i in range(n)])
        if any(r["status"] != "SUCCESS" for r in res):
            raise AssertionError(f"batch_put failed: {res[0]}")
        ref[done:done + n] = torch.nn.functional.normalize(torch.from_numpy(v).to(dev), dim=1)
        views[done:done + n] = vw
        done += n
    return ref[:done], views[:done], done, time.perf_counter() - t0


def _row_of(r) -> int:
    return int(r.uuid.rsplit("-", 1)[1])


def _run_clients(ask, nq: int):
    """CLIENTS threads, client c asking queries c, c + CLIENTS, ...;
    returns (answers, latencies ms, wall s)."""
    out = [None] * nq
    lat = [0.0] * nq
    errors = []

    def client(c):
        try:
            for i in range(c, nq, CLIENTS):
                t2 = time.perf_counter()
                out[i] = ask(i)
                lat[i] = (time.perf_counter() - t2) * 1e3
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(c,)) for c in range(CLIENTS)]
    t1 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t1
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"client errors: {errors[:1]}")
    return out, lat, wall


def _latency_stats(nq, lat, wall) -> str:
    lat_u, lat_f = np.asarray(lat[0::2]), np.asarray(lat[1::2])
    return (f"{nq / wall:.1f} QPS, p50 {np.percentile(lat, 50):.1f} ms, "
            f"p99 {np.percentile(lat, 99):.1f} ms (unfiltered p50 "
            f"{np.percentile(lat_u, 50):.1f} ms, filtered p50 {np.percentile(lat_f, 50):.1f} ms)")


def _filter_mask(torch, n_res, live, views_t):
    """[n_res, rows] rows each query may return: odd queries carry the
    where(views >= VIEWS_CUT) filter."""
    odd = torch.arange(n_res, device=live.device)[:, None] % 2 == 1
    return live[None, :] & (~odd | (views_t[None, :] >= VIEWS_CUT))


@contextlib.contextmanager
def _host_packed_masks(K):
    """Swap the flat store's mask packer for the host (numpy) one the
    store used before packing moved to the card."""
    from weaviate_tpu_torch.engine import store as S

    card = S.batched_mask_operands

    def host_packed(allow_mask, n_queries, capacity, device, owner=None):
        with S.tracing.span("store.mask_pack", queries=n_queries):
            return K.as_bits_tensor(
                K.pack_allow_bitmask(allow_mask, K.mask_pad_cols(capacity)), device)

    S.batched_mask_operands = host_packed
    try:
        yield
    finally:
        S.batched_mask_operands = card


def _mask_pack_check(torch, K, shard, idx, where, rng) -> str:
    """The card packer's words against numpy's on phase 4's filter (each
    query's slot mask ANDed with a random 50% row), bit for bit, at B = 1,
    8 and 64, and what each way takes: numpy's pack (+ the upload of the
    words) against the upload of the bool rows + the card's pack."""
    from weaviate_tpu_torch.engine import store as S

    cap = idx.store.capacity
    n_cols = K.mask_pad_cols(cap)
    t0 = time.perf_counter()
    doc_mask = shard.allow_mask(where)
    eval_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    slot_mask = idx._allow_mask(doc_mask)
    translate_ms = (time.perf_counter() - t0) * 1e3
    parts = [f"where() evaluated in {eval_ms:.1f} ms, translated to {cap} store slots in "
             f"{translate_ms:.1f} ms"]
    for b in (1, 8, 64):
        rows = slot_mask[None, :] & (rng.random((b, cap)) < 0.5)
        want = K.pack_allow_bitmask(rows, n_cols)
        got = S.batched_mask_operands(rows, b, cap, "cuda")
        if not np.array_equal(got.cpu().numpy().view(np.uint32), want):
            raise AssertionError(f"card-packed allow words != numpy's at B = {b}")
        host, card = [], []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            K.as_bits_tensor(K.pack_allow_bitmask(rows, n_cols), "cuda")
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            S.batched_mask_operands(rows, b, cap, "cuda")
            torch.cuda.synchronize()
            host.append((t1 - t0) * 1e3)
            card.append((time.perf_counter() - t1) * 1e3)
        parts.append(f"B = {b}: bit for bit; numpy pack + upload {np.median(host):.2f} ms, "
                     f"upload + card pack {np.median(card):.2f} ms")
    return "; ".join(parts)


def phase_end_to_end(torch, K, seed: int, rows: int, db) -> tuple[dict, dict]:
    """Returns phase 4's launch counts and the live collection's state,
    which phase 6 compresses and queries again."""
    from weaviate_tpu_torch.filters import Filter, Operator

    dev = "cuda"
    rng = np.random.default_rng([seed, 4])
    col = _collection(db, "Wiki")
    ref, views, done, import_s = _import(torch, col, seed + 1, rows, 8000, rng,
                                         IMPORT_BUDGET_S)
    cut = "" if done == rows else (
        f" (cut from {rows}: the import budget of {IMPORT_BUDGET_S:.0f} s ran out)")
    if col.object_count() != done:
        raise AssertionError(f"object_count {col.object_count()} != {done}")
    shard = next(iter(col.shards.values()))
    idx = shard.vector_indexes[""]
    live = torch.ones(done, dtype=torch.bool, device=dev)
    views_t = torch.from_numpy(views).to(dev)
    nq = CLIENTS * PLAIN_CALLS
    queries = near_queries(seed + 1, rng.integers(0, done, nq),
                           lambda r: ref[torch.from_numpy(r).to(dev)].cpu().numpy())
    qn = torch.nn.functional.normalize(torch.from_numpy(queries).to(dev), dim=1)
    where = Filter.where("views", Operator.GREATER_THAN_EQUAL, VIEWS_CUT)

    def ask(i):
        return col.near_vector(queries[i], k=10, where=where if i % 2 else None,
                               include_objects=False)

    def check_exact(results, what):
        """results[i] answers query i; odd queries carry the filter."""
        n_res = len(results)
        mask = _filter_mask(torch, n_res, live, views_t)
        for s in range(0, n_res, BATCH):
            d_full = _exact_distances(torch, qn[s:min(s + BATCH, n_res)], ref,
                                      mask[s:s + BATCH])
            got = [[_row_of(r) for r in res] for res in results[s:s + BATCH]]
            _check_against_exact(torch, d_full, got, 10, what)

    pack_text = _mask_pack_check(torch, K, shard, idx, where, rng)
    K.reset_launch_counts()  # the main path's run starts here
    timings = {}
    t1 = time.perf_counter()
    shard.dynamic_batching = False
    serial = [ask(i) for i in range(nq)]  # selection "approx", one at a time
    timings["serial"] = time.perf_counter() - t1
    check_exact(serial, "end to end serial")
    shard.dynamic_batching = True
    stats = []
    for selection in ("approx", "fused"):
        idx.store.selection = selection
        out, lat, wall = _run_clients(ask, nq)
        for a, b in zip(serial, out):
            if [r.uuid for r in a] != [r.uuid for r in b]:
                raise AssertionError(f"{selection}: concurrent result != serial path")
        check_exact(out, f"end to end {selection}")
        stats.append(f"{selection}: {_latency_stats(nq, lat, wall)}")
    # the same approx run with the filter words packed on the host, as
    # before the card packer: the filtered p50 before and after, one call
    idx.store.selection = "approx"
    with _host_packed_masks(K):
        out, lat, wall = _run_clients(ask, nq)
    for a, b in zip(serial, out):
        if [r.uuid for r in a] != [r.uuid for r in b]:
            raise AssertionError("host-packed: concurrent result != serial path")
    stats.append(f"approx with the words packed on the host (numpy, as before): "
                 f"{_latency_stats(nq, lat, wall)}")
    batcher = shard._query_batchers[""]
    # deletes, then queries again through the batcher, both selections
    gone = rng.choice(done, DELETES, replace=False)
    t1 = time.perf_counter()
    for r in gone:
        if not col.delete_object(_uuid(8000, int(r))):
            raise AssertionError("delete_object returned False")
    timings["deletes"] = time.perf_counter() - t1
    live[torch.from_numpy(gone).to(dev)] = False
    gone_set = set(gone.tolist())
    for selection in ("approx", "fused"):
        idx.store.selection = selection
        again = [ask(i) for i in range(REQUERIES)]
        if any(_row_of(r) in gone_set for res in again for r in res):
            raise AssertionError("a deleted object was returned")
        check_exact(again, f"after deletes {selection}")
    counts = dict(K.launch_counts)  # ... and ends here
    log(f"phase 4 end to end: Database(device='cuda') flat {METRIC} collection, "
        f"batch_put {done} objects{cut} in {import_s:.1f} s "
        f"({done / import_s:.0f} objects/s, native host library {_native_state()}); serial path {nq} near_vector(k=10) in "
        f"{timings['serial']:.1f} s; {CLIENTS} clients x {PLAIN_CALLS} near_vector(k=10), "
        f"half where(views >= {VIEWS_CUT}, values 0..99): "
        + "; ".join(stats)
        + f"; equal to the serial path and recall@10 1.0 vs the plain recomputation; "
        f"{batcher.dispatches} batched dispatches for {batcher.batched_queries} "
        f"queries ({batcher.async_dispatches} async); {DELETES} deleted in "
        f"{timings['deletes']:.1f} s, {REQUERIES} queries per selection again, none "
        f"returned; launches {counts}; filter words: {pack_text}")
    for name in ("distance_block", "fused_topk_scan", "fused_topk_pairs"):
        if counts[name] <= 0:
            raise AssertionError(f"{name} was not launched on the main path")
    idx.store.selection = "approx"
    return counts, dict(col=col, ref=ref, live=live, views=views_t)


def _check_quantized(torch, d_full, ids, dists, k: int, what: str) -> float:
    """A quantized answer: every id live and allowed (a finite exact
    distance), every returned distance the exact one (the store rescored
    it), and recall@k against the exact top-k, which is returned."""
    got = torch.from_numpy(np.asarray(ids, dtype=np.int64)).to(d_full.device)
    if bool((got < 0).any()):
        raise AssertionError(f"{what}: fewer than {k} results")
    dg = torch.gather(d_full, 1, got)
    if not bool(torch.isfinite(dg).all()):
        raise AssertionError(f"{what}: returned a deleted or disallowed row")
    dt = torch.from_numpy(np.asarray(dists, dtype=np.float32)).to(d_full.device)
    if not torch.allclose(dt, dg, rtol=RTOL, atol=ATOL):
        raise AssertionError(f"{what}: a returned distance is not its exact distance "
                             f"(max error {(dt - dg).abs().max().item():.3g})")
    kd = torch.topk(d_full, k, dim=1, largest=False)[0][:, -1]
    return recall_at_k(dg.cpu().numpy(), kd.cpu().numpy(), k)


QUANT_INDEXES = {"bq": {"quantization": "bq"},
                 "bq+prefix128": {"quantization": "bq", "prefix_bits": 128},
                 "pq4": {}}  # built plain, then compress("pq")


def _require_launched(counts: dict, phase: int) -> None:
    for name in QUANT_KERNELS[phase]:
        if counts[name] <= 0:
            raise AssertionError(f"{name} was not launched in phase {phase}")


def phase_quantized_index(torch, K, seed: int, rows: int) -> dict:
    from weaviate_tpu_torch.engine.flat import FlatIndex
    from weaviate_tpu_torch.ops.distances import normalize_np

    dev = "cuda"
    cent = centers(seed)
    rng = np.random.default_rng([seed, 5])
    # made once on the host (3 GB at 1M rows) and added to all three indexes
    corpus = np.concatenate([clustered(seed, s, min(ADD_BATCH, rows - s), cent)
                             for s in range(0, rows, ADD_BATCH)])
    ref = torch.empty((rows, DIM), dtype=torch.float32, device=dev)
    for s in range(0, rows, ADD_BATCH):
        ref[s:s + ADD_BATCH] = torch.nn.functional.normalize(
            torch.from_numpy(corpus[s:s + ADD_BATCH]).to(dev), dim=1)
    deleted = rng.choice(rows, 10_000, replace=False)
    deleted_set = set(deleted.tolist())
    live = torch.ones(rows, dtype=torch.bool, device=dev)
    live[torch.from_numpy(deleted).to(dev)] = False
    queries = near_queries(seed, rng.integers(0, rows, QUERIES),
                           lambda r: ref[torch.from_numpy(r).to(dev)].cpu().numpy(),
                           NEAR_NOISE)
    qn_all = torch.nn.functional.normalize(torch.from_numpy(queries).to(dev), dim=1)
    masks = rng.random((64, rows)) < 0.10
    allowed = torch.from_numpy(masks).to(dev) & live[None, :]
    parts = []
    K.reset_launch_counts()  # phase 5's run starts here
    timing_launches = dict.fromkeys(K.launch_counts, 0)  # the scan timed alone
    for name, kw in QUANT_INDEXES.items():
        t0 = time.perf_counter()
        idx = FlatIndex(dim=DIM, metric=METRIC, chunk_size=CHUNK, device=dev, **kw)
        for s in range(0, rows, ADD_BATCH):
            v = corpus[s:s + ADD_BATCH]
            idx.add_batch(np.arange(s, s + len(v)), v)
        train = ""
        if not kw:
            idx.store.flush_staged()
            t1 = time.perf_counter()
            idx.compress("pq")  # 16 centroids, m = 192: trained and encoded on the card
            torch.cuda.synchronize()
            train = f" (compress('pq') {time.perf_counter() - t1:.1f} s)"
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        st = idx.store
        idx.delete(*deleted.tolist())
        runs = []
        for selection, k in (("approx", 10), ("approx", TOP_K), ("fused", 10)):
            st.selection = selection
            times, scans, recs = [], [], []
            for s in range(0, QUERIES, BATCH):
                qb = queries[s:s + BATCH]
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                ids, d = idx.search_by_vector_batch_async(qb, k).result()
                times.append((time.perf_counter() - t1) * 1e3)
                if deleted_set.intersection(ids.ravel().tolist()):
                    raise AssertionError(f"{name} {selection}: a deleted id was returned")
                d_full = _exact_distances(torch, qn_all[s:s + BATCH], ref, live[None, :])
                recs.append(_check_quantized(torch, d_full, ids, d, k,
                                             f"{name} {selection} k={k}"))
                del d_full
                # the compressed scan alone on the same batch, host clock
                qd = torch.from_numpy(normalize_np(qb)).to(dev)
                before = dict(K.launch_counts)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                st._scan(qd, min(k * st.rescore_limit, st.capacity), st.valid)
                torch.cuda.synchronize()
                scans.append((time.perf_counter() - t1) * 1e3)
                for kn, c in K.launch_counts.items():  # a yardstick, not the path
                    timing_launches[kn] += c - before[kn]
            r = float(np.mean(recs))
            if k == 10 and r < RECALL_FLOOR[name]:
                raise AssertionError(f"{name} {selection}: recall@10 {r:.4f} below the "
                                     f"floor {RECALL_FLOOR[name]}")
            t_med, s_med = float(np.median(times)), float(np.median(scans))
            split = ""
            if selection == "approx":
                before = dict(K.launch_counts)
                split = "; " + _rescore_split(torch, idx, queries[:BATCH], k)
                for kn, c in K.launch_counts.items():  # a measurement, not the path
                    timing_launches[kn] += c - before[kn]
            runs.append(f"{selection} k={k}: recall@{k} {r:.4f}, {t_med:.1f} ms per "
                        f"{BATCH}-query batch, scan {s_med:.1f} ms ({s_med / t_med:.0%})"
                        + split)
        st.selection = "approx"
        # what a path that has lost its oversampling reads: rescore_limit 1
        # hands the exact rescore only the scan's best k candidates
        limit, st.rescore_limit, recs = st.rescore_limit, 1, []
        for s in range(0, QUERIES, BATCH):
            ids, d = idx.search_by_vector_batch_async(queries[s:s + BATCH], 10).result()
            d_full = _exact_distances(torch, qn_all[s:s + BATCH], ref, live[None, :])
            recs.append(_check_quantized(torch, d_full, ids, d, 10, f"{name} rescore_limit 1"))
        st.rescore_limit = limit
        nq = len(masks)
        ids, d = idx.search_by_vector_batch_async(queries[:nq], 10, list(masks)).result()
        d_full = _exact_distances(torch, qn_all[:nq], ref, allowed)
        rf = _check_quantized(torch, d_full, ids, d, 10, f"{name} per-query 10% filters")
        parts.append(f"{name}: built in {build_s:.1f} s{train}; " + "; ".join(runs)
                     + f"; {nq} queries with per-query 10% filters: recall@10 {rf:.4f}; "
                     f"with rescore_limit 1 (floor {RECALL_FLOOR[name]}): recall@10 "
                     f"{float(np.mean(recs)):.4f}")
        del idx, st, d_full
        torch.cuda.empty_cache()
    counts = {kn: c - timing_launches[kn]  # ... and ends here
              for kn, c in K.launch_counts.items()}
    log(f"phase 5 quantized index: FlatIndex(device='cuda') {rows} x {DIM} {METRIC}, "
        f"10000 deleted, {QUERIES} queries through search_by_vector_batch_async (times "
        f"median by host clock; the scan's share is the compressed scan alone on the same "
        f"batch), every returned id at its exact distance, none deleted or disallowed: "
        + " | ".join(parts) + f"; launches {counts}")
    _require_launched(counts, 5)
    return counts


def _reference_rescore(hv, q, cand, k: int, metric: str, cap: int):
    """The exact host rescore as the reference writes it (the JAX
    package's ``QuantizedVectorStore._host_rescore``): one gather of every
    candidate row, one einsum, the mask, argpartition and a stable
    argsort. Returns ((out_d, out_i), [gather, distance, select] seconds)."""
    b, kc = cand.shape
    t0 = time.perf_counter()
    rows = hv[np.clip(cand, 0, cap - 1).reshape(-1)].reshape(b, kc, -1)
    t1 = time.perf_counter()
    if metric == "dot":
        dd = -np.einsum("bd,bkd->bk", q, rows)
    elif metric in ("cosine", "cosine-dot"):
        dd = 1.0 - np.einsum("bd,bkd->bk", q, rows)
    else:
        diff = q[:, None, :] - rows
        dd = np.einsum("bkd,bkd->bk", diff, diff)
    dd = np.where(cand >= 0, dd, np.float32(3.0e38))
    t2 = time.perf_counter()
    k_eff = min(k, kc)
    part = np.argpartition(dd, k_eff - 1, axis=1)[:, :k_eff]
    sel = np.take_along_axis(part, np.argsort(np.take_along_axis(dd, part, axis=1), axis=1,
                                              kind="stable"), axis=1)
    out_d = np.take_along_axis(dd, sel, axis=1).astype(np.float32)
    out_i = np.where(out_d >= np.float32(3.0e38), -1, np.take_along_axis(cand, sel, axis=1))
    return (out_d, out_i), [t1 - t0, t2 - t1, time.perf_counter() - t2]


def _rescore_split(torch, idx, qb, k: int) -> str:
    """One batch's exact host rescore before and after this slice's
    threads, on the same candidates (the store's own scan of the batch):
    the reference's arrangement, timed here (_reference_rescore), against
    the store's, read from its spans under a forced trace
    (``store.host_rescore.rows`` with the threads' summed gather and
    distance times, ``store.host_rescore.select``); host clock, median of
    3 each. The answers must be equal bit for bit."""
    from weaviate_tpu_torch.runtime import tracing

    st = idx.store
    q = st._maybe_norm(np.asarray(qb, dtype=np.float32))
    k_cand = min(max(k * st.rescore_limit, k), st.capacity)
    cand = st._scan(torch.from_numpy(q).to(st.device), k_cand, st.valid)[1]
    cand = cand.cpu().numpy().astype(np.int64)
    before, after = [], []
    for _ in range(3):
        want, secs = _reference_rescore(st._host_vectors, q, cand, k, st.metric, st.capacity)
        before.append([t * 1e3 for t in secs])
        with tracing.trace("chip_smoke.rescore", force=True):
            tr = tracing.capture()[0]
            got = st._host_rescore(q, cand, k)
        spans = {sp["name"]: sp for sp in tr.to_dict()["spans"]}
        rows = spans["store.host_rescore.rows"]
        after.append([rows["duration_ms"], spans["store.host_rescore.select"]["duration_ms"],
                      rows["attrs"]["gather_ms"], rows["attrs"]["distance_ms"],
                      rows["attrs"]["blocks"]])
        if not all(np.array_equal(a, b) for a, b in zip(want, got)):
            raise AssertionError("the host rescore differs from the reference's arithmetic")
    bm, am = np.median(before, axis=0), np.median(after, axis=0)
    return (f"host rescore of {cand.shape[1]} candidates a query: reference arrangement "
            f"{bm.sum():.1f} ms (gather {bm[0]:.1f}, distance {bm[1]:.1f}, select "
            f"{bm[2]:.1f}), the store {am[0] + am[1]:.1f} ms (gather + distance "
            f"{am[0]:.1f} in {am[4]:.0f} blocks on host threads, whose summed gather is "
            f"{am[2]:.1f} and distance {am[3]:.1f}; select {am[1]:.1f}), equal bit for bit")


def _quantized_clients(torch, col, ref, live, views_t, queries, where, what: str) -> str:
    """CLIENTS threads of near_vector(k=10), half filtered, through the
    shard's batcher, held to the serial path, to exact distances and to
    RECALL_FLOOR[what]."""
    shard = next(iter(col.shards.values()))
    nq = len(queries)
    qn = torch.nn.functional.normalize(torch.from_numpy(queries).to(ref.device), dim=1)

    def ask(i, k=10):
        return col.near_vector(queries[i], k=k, where=where if i % 2 else None,
                               include_objects=False)

    # the batcher pads k to a power of two (10 -> 16) and the store
    # oversamples rescore_limit x k candidates: the serial path that gives
    # the batcher's answers is the one asked for k = 16
    shard.dynamic_batching = False
    t1 = time.perf_counter()
    answers = [ask(i, 16)[:10] for i in range(nq)]
    serial_s = time.perf_counter() - t1
    shard.dynamic_batching = True
    out, lat, wall = _run_clients(ask, nq)
    for a, b in zip(answers, out):
        if [r.uuid for r in a] != [r.uuid for r in b]:
            raise AssertionError(f"{what}: concurrent result != serial path")
    mask = _filter_mask(torch, nq, live, views_t)
    recs = []
    for s in range(0, nq, BATCH):
        res = out[s:s + BATCH]
        d_full = _exact_distances(torch, qn[s:s + BATCH], ref, mask[s:s + BATCH])
        recs.append(_check_quantized(torch, d_full, [[_row_of(r) for r in x] for x in res],
                                     [[r.distance for r in x] for x in res], 10, what))
    r = float(np.mean(recs))
    if r < RECALL_FLOOR[what]:
        raise AssertionError(f"{what}: recall@10 {r:.4f} below the floor {RECALL_FLOOR[what]}")
    return (f"serial path {nq} near_vector(k=16) in {serial_s:.1f} s; {CLIENTS} clients x "
            f"{CALLS} near_vector(k=10), half where(views >= {VIEWS_CUT}): "
            f"{_latency_stats(nq, lat, wall)}; equal to the serial path, exact distances, "
            f"recall@10 {r:.4f}")


def phase_quantized_end_to_end(torch, K, seed: int, db, st4: dict) -> dict:
    import copy

    from weaviate_tpu_torch.filters import Filter, Operator

    dev = "cuda"
    where = Filter.where("views", Operator.GREATER_THAN_EQUAL, VIEWS_CUT)
    col = st4["col"]
    rng = np.random.default_rng([seed, 6])
    ref = st4["ref"]
    queries = near_queries(seed + 1, rng.integers(0, len(ref), CLIENTS * CALLS),
                           lambda r: ref[torch.from_numpy(r).to(dev)].cpu().numpy(),
                           NEAR_NOISE)
    K.reset_launch_counts()  # phase 6's run starts here
    cfg = copy.deepcopy(col.config)
    cfg.vectors[0].index.quantization = "pq"
    t0 = time.perf_counter()
    db.update_collection(cfg)  # trains and encodes the live rows on the card
    torch.cuda.synchronize()
    compress_s = time.perf_counter() - t0
    store = next(iter(col.shards.values())).vector_indexes[""].store
    if getattr(store, "quantization", None) != "pq" or \
            tuple(store.codebook.centroids.shape) != (DIM // 4, 16, 4):
        raise AssertionError("update_collection did not switch the live index to 4-bit PQ")
    part_pq = _quantized_clients(torch, col, ref, st4["live"], st4["views"], queries,
                                 where, "e2e pq4")
    col2 = _collection(db, "WikiBQ", quantization="bq")
    ref2, views2, done2, import_s = _import(torch, col2, seed + 2, BQ_E2E_ROWS, 8001, rng,
                                            IMPORT_BUDGET_S)
    if done2 != BQ_E2E_ROWS or col2.object_count() != done2:
        raise AssertionError(f"BQ collection holds {col2.object_count()} of {BQ_E2E_ROWS}")
    queries2 = near_queries(seed + 2, rng.integers(0, done2, CLIENTS * CALLS),
                            lambda r: ref2[torch.from_numpy(r).to(dev)].cpu().numpy(),
                            NEAR_NOISE)
    part_bq = _quantized_clients(torch, col2, ref2, torch.ones(done2, dtype=torch.bool,
                                                               device=dev),
                                 torch.from_numpy(views2).to(dev), queries2, where, "e2e bq")
    counts = dict(K.launch_counts)  # ... and ends here
    log(f"phase 6 quantized end to end: update_collection(quantization='pq') on phase 4's "
        f"live {len(ref)}-row collection in {compress_s:.1f} s (train + encode on the card); "
        f"queries near its rows: {part_pq} | a collection with quantization='bq' in its "
        f"schema, batch_put {done2} objects in {import_s:.1f} s "
        f"({done2 / import_s:.0f} objects/s); {part_bq}; launches {counts}")
    _require_launched(counts, 6)
    return counts


# -- phase 7: hybrid search at the size of BEIR FiQA-2018 -------------------------

FIQA_DOCS = 57_638        # corpus documents (Thakur et al., NeurIPS 2021 D&B, Table 1)
FIQA_QUERIES = 648        # test queries
FIQA_DOC_WORDS = 132.32   # average document length in words
FIQA_QUERY_WORDS = 10.77  # average query length in words
TITLE_WORDS = 6           # FiQA's titles are empty; here short ones, so BM25F spans two
VOCAB, ZIPF_S = 100_000, 1.0
HYBRID_K = 10
HYBRID_BUDGET = 4096      # WEAVIATE_TPU_HYBRID_MAX_CANDIDATES' default
BUDGET_QUERIES = 256      # queries of runs (b) and (c) each
# Weaviate's hybrid default (relativeScore, alpha 0.75), then rankedFusion at 0.3 and 0.75
HYBRID_SETTINGS = (("relativeScore", 0.75), ("rankedFusion", 0.3), ("rankedFusion", 0.75))
FUSED_RTOL = 1e-6         # the host fuses in Python floats, the device in f32


def _zipf_words(seed: int):
    """The vocabulary (rank -> word: the en stopwords first, as the most
    frequent ranks of English text are, then ``w<rank>``) and its Zipf
    probabilities."""
    from weaviate_tpu_torch.text.stopwords import _EN

    stop = sorted(_EN)
    words = np.array(stop + [f"w{r}" for r in range(len(stop), VOCAB)], dtype=object)
    p = 1.0 / np.arange(1, VOCAB + 1, dtype=np.float64) ** ZIPF_S
    return words, p / p.sum(), len(stop)


def _fiqa_corpus(seed: int, n: int):
    """``n`` documents of Zipf text (text ~132 words, title ~6), an int
    property ``n`` (i % 10: ``n == 0`` keeps 10%), and each word's
    document frequency over both properties (an upper bound of any query's
    candidate union)."""
    rng = np.random.default_rng([seed, 7])
    words, p, _ = _zipf_words(seed)
    sigma = 0.6
    lens = np.clip(np.rint(rng.lognormal(np.log(FIQA_DOC_WORDS) - sigma ** 2 / 2, sigma, n)),
                   5, 2000).astype(np.int64)
    tlens = 1 + rng.poisson(TITLE_WORDS - 1, n)
    df = np.zeros(VOCAB, np.int64)
    props = []
    for ln in (lens, tlens):
        ranks = rng.choice(VOCAB, int(ln.sum()), p=p)
        doc = np.repeat(np.arange(n, dtype=np.int64), ln)
        df += np.bincount(np.unique(doc * VOCAB + ranks) % VOCAB, minlength=VOCAB)
        ends = np.cumsum(ln)
        props.append([" ".join(words[ranks[e - m:e]]) for e, m in zip(ends, ln)])
    return props[0], props[1], df, float(lens.mean())


def _fiqa_queries(seed: int, df, budget: bool, count: int):
    """FiQA-shaped queries (~10.8 words, Zipf, stopwords included). With
    ``budget``, content words come only from the band of words whose
    document frequency keeps the sum over the query, and so its candidate
    union, within HYBRID_BUDGET."""
    rng = np.random.default_rng([seed, 8, int(budget)])
    words, p, n_stop = _zipf_words(seed)
    band = np.flatnonzero((df >= 8) & (df <= 1200))
    band = band[band >= n_stop]
    pb = p[band] / p[band].sum()
    out = []
    for _ in range(count):
        m = 1 + rng.poisson(FIQA_QUERY_WORDS - 1)
        toks, used = [], 0
        for r in rng.choice(VOCAB, m, p=p):
            if r < n_stop:
                toks.append(words[r])
                continue
            if budget:
                r = rng.choice(band, p=pb)
                if used + df[r] > HYBRID_BUDGET:
                    continue
                used += df[r]
            toks.append(words[r])
        if budget and used == 0:
            r = rng.choice(band, p=pb)
            toks.append(words[r])
        out.append(" ".join(toks))
    return out


def _same_answer(dev, ref) -> bool:
    """Two hybrid answers [(uuid, score)] agree: scores equal position by
    position within FUSED_RTOL, and every uuid that differs sits in a tie
    (within FUSED_RTOL) inside the list or at its k-th place."""
    if len(dev) != len(ref):
        return False
    ds = np.array([x[1] for x in dev], np.float64)
    rs = np.array([x[1] for x in ref], np.float64)
    if not np.allclose(ds, rs, rtol=FUSED_RTOL, atol=1e-9):
        return False
    tol = FUSED_RTOL * np.maximum(np.abs(rs), 1e-9) + 1e-9
    for pos, (u, sc) in enumerate(dev):
        if u == ref[pos][0]:
            continue
        tied = [v for v, t in ref if abs(t - sc) <= tol[pos]]
        if u not in tied and abs(sc - rs[-1]) > tol[pos]:
            return False
    return True


def _tie_ordered_reference(col, shard, query, vec, fusion, alpha, allow):
    """The host reference with the device path's tie order: every BM25
    candidate scored by the host scorer, the leg cut at the over-fetch
    after ordering by (score desc, doc id asc), the dense leg from the
    host path, fused by text/hybrid.py. Differs from the host path only
    in the order of exactly tied BM25 scores, which the host's
    argpartition leaves arbitrary (and which moves RRF ranks)."""
    from weaviate_tpu_torch.db.collection import SearchResult
    from weaviate_tpu_torch.text.hybrid import fusion_ranked, fusion_relative_score

    fetch = max(HYBRID_K * 10, 100)
    ids, scores = shard.bm25_search(query, 1 << 30, None, allow)
    order = np.lexsort((ids, -scores.astype(np.float64)))[:fetch]
    sparse = [SearchResult(uuid=shard._doc_to_uuid[int(i)], score=float(scores[j]))
              for j, i in zip(order, ids[order])]
    legs, weights = [], []
    if alpha < 1.0:
        legs.append(sparse)
        weights.append(1.0 - alpha)
    if alpha > 0.0:
        dense = col.near_vector(vec, k=fetch, include_objects=False,
                                allow_list_by_shard=None if allow is None
                                else {shard.name: allow})
        for r in dense:
            r.score = -r.distance
        legs.append(dense)
        weights.append(alpha)
    fuse = fusion_relative_score if fusion == "relativeScore" else fusion_ranked
    return [(r.uuid, s) for s, r in fuse(legs, weights, HYBRID_K)]


def _native_state() -> str:
    from weaviate_tpu_torch import native

    return "on" if native.available() else "off (numpy)"


def _fiqa_import(torch, seed: int, db, n_docs: int):
    """Phase 7's collection: FiQA-shaped text and clustered vectors
    through Collection.batch_put in batches of 2,000. Returns (collection,
    unit rows on the card, document frequencies, mean text length, the
    seconds spent making the text and importing it)."""
    from weaviate_tpu_torch.schema.config import (CollectionConfig, Property,
                                                  VectorConfig, VectorIndexConfig)

    dev = "cuda"
    t0 = time.perf_counter()
    texts, titles, df, mean_len = _fiqa_corpus(seed, n_docs)
    cent = centers(seed)
    gen_s = time.perf_counter() - t0
    col = db.create_collection(CollectionConfig(
        name="FiQA",
        properties=[Property(name="title", data_type="text"),
                    Property(name="text", data_type="text"),
                    Property(name="n", data_type="int")],
        vectors=[VectorConfig(index=VectorIndexConfig(index_type="flat", metric=METRIC))]))
    ref = torch.empty((n_docs, DIM), dtype=torch.float32, device=dev)
    t0 = time.perf_counter()
    for s in range(0, n_docs, 2000):
        n = min(2000, n_docs - s)
        v = clustered(seed + 3, s, n, cent)
        res = col.batch_put([
            {"uuid": _uuid(8002, s + i),
             "properties": {"title": titles[s + i], "text": texts[s + i], "n": (s + i) % 10},
             "vector": v[i]} for i in range(n)])
        if any(r["status"] != "SUCCESS" for r in res):
            raise AssertionError(f"batch_put failed: {res[0]}")
        ref[s:s + n] = torch.nn.functional.normalize(torch.from_numpy(v).to(dev), dim=1)
    return col, ref, df, mean_len, gen_s, time.perf_counter() - t0


def import_run(torch, seed: int, n_docs: int, rows: int) -> dict:
    """The FiQA-sized text import (phase 7's) and a ``rows``-row vector
    batch_put (phase 4's) into a fresh Database on the card, with the
    native host library or without it (WEAVIATE_TPU_NO_NATIVE=1): the
    import rates of whichever path is active."""
    from weaviate_tpu_torch import native
    from weaviate_tpu_torch.db import Database

    tmp = tempfile.mkdtemp(prefix="chip_smoke_import_")
    db = None
    try:
        db = Database(tmp, device="cuda")
        col, _ref, _df, _len, _gen, text_s = _fiqa_import(torch, seed, db, n_docs)
        if col.object_count() != n_docs:
            raise AssertionError(f"object_count {col.object_count()} != {n_docs}")
        vcol = _collection(db, "Wiki")
        _, _, done, vec_s = _import(torch, vcol, seed + 1, rows, 8000,
                                    np.random.default_rng([seed, 4]), IMPORT_BUDGET_S)
        if vcol.object_count() != done:
            raise AssertionError(f"object_count {vcol.object_count()} != {done}")
    finally:
        if db is not None:
            db.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return {"native": native.available(), "text_docs": n_docs, "text_s": text_s,
            "text_objects_s": n_docs / text_s, "vector_rows": done, "vector_s": vec_s,
            "vector_objects_s": done / vec_s}


def import_times(torch, seed: int, n_docs: int, rows: int) -> list[str]:
    """``--import-times``: import_run with the native host library, then
    in a child process with WEAVIATE_TPU_NO_NATIVE=1 (the numpy codecs),
    then with the library again, in one call. Returns one text part
    each."""
    import os

    def text(r):
        return (f"native host library {'on' if r['native'] else 'off (numpy)'}: "
                f"FiQA-sized text import {r['text_docs']} documents in {r['text_s']:.1f} s "
                f"({r['text_objects_s']:.0f} objects/s), vector batch_put {r['vector_rows']} "
                f"rows x {DIM} in {r['vector_s']:.1f} s ({r['vector_objects_s']:.0f} objects/s)")

    parts = [text(import_run(torch, seed, n_docs, rows))]
    env = dict(os.environ, WEAVIATE_TPU_NO_NATIVE="1")
    child = subprocess.run(
        [sys.executable, __file__, "--import-run", "--seed", str(seed), "--rows", str(rows),
         "--hybrid-docs", str(n_docs)], capture_output=True, text=True, timeout=1800, env=env)
    if child.returncode != 0:
        raise AssertionError(f"the numpy import run failed:\n{child.stderr[-4000:]}")
    numpy_run = json.loads(child.stdout.strip().splitlines()[-1])
    if numpy_run["native"]:
        raise AssertionError("WEAVIATE_TPU_NO_NATIVE=1 did not turn the library off")
    parts.append(text(numpy_run))
    parts.append(text(import_run(torch, seed, n_docs, rows)) + " (again)")
    return parts


def phase_hybrid(torch, K, seed: int, db, n_docs: int) -> tuple[dict, dict]:
    """Phase 7. Returns its launch counts and its collection's state
    (collection, unit rows on the card, document frequencies), which
    phase 9b queries again over the socket."""
    from weaviate_tpu_torch.filters import Filter, Operator

    dev = "cuda"
    rng = np.random.default_rng([seed, 9])
    col, ref, df, mean_len, gen_s, import_s = _fiqa_import(torch, seed, db, n_docs)
    if col.object_count() != n_docs:
        raise AssertionError(f"object_count {col.object_count()} != {n_docs}")
    shard = next(iter(col.shards.values()))
    if shard.hybrid_max_candidates != HYBRID_BUDGET:
        raise AssertionError(f"candidate budget {shard.hybrid_max_candidates}")
    where = Filter.where("n", Operator.EQUAL, 0)
    # run -> (queries, filter, the index's selection)
    runs = {"a": (_fiqa_queries(seed, df, False, FIQA_QUERIES), None, "approx"),
            "b": (_fiqa_queries(seed, df, True, BUDGET_QUERIES), None, "approx")}
    runs["c"] = (runs["b"][0], where, "approx")
    runs["d"] = (runs["b"][0], None, "fused")

    def vectors(count, tag):
        return near_queries(seed + tag, rng.integers(0, n_docs, count),
                            lambda r: ref[torch.from_numpy(r).to(dev)].cpu().numpy(),
                            NEAR_NOISE)

    # per-query attribution: which path served each hybrid call
    tls = threading.local()
    served: dict = {}
    orig = col._hybrid_device

    def recording(*a, **kw):
        r = orig(*a, **kw)
        served[tls.key] = r is not None
        return r

    col._hybrid_device = recording
    idx = shard.vector_indexes[""]
    batcher = shard._query_batcher("", idx)
    K.reset_launch_counts()  # phase 7's run starts here
    d0 = batcher.dispatches
    answers, parts, qvecs, fused_launches = {}, [], {}, {}
    for name, (queries, flt, selection) in runs.items():
        idx.store.selection = selection
        nq = len(queries)
        qv = qvecs[name] = vectors(nq, 10 + ord(name))
        pv = vectors(nq // 3, 20 + ord(name))
        # one plain nearVector request after every third hybrid one
        reqs = []
        for i in range(nq):
            reqs.append(("h", i))
            if i % 3 == 2:
                reqs.append(("v", i // 3))

        def ask(j, _q=queries, _qv=qv, _pv=pv, _f=flt, _name=name, _reqs=reqs):
            kind, i = _reqs[j]
            if kind == "v":
                return col.near_vector(_pv[i], k=HYBRID_K, include_objects=False)
            fusion, alpha = HYBRID_SETTINGS[i % 3]
            tls.key = (_name, i)
            return col.hybrid(_q[i], vector=_qv[i], alpha=alpha, k=HYBRID_K, fusion=fusion,
                              where=_f, include_objects=False)

        h0, l0 = batcher.hybrid_batched, K.launch_counts["bm25_block"]
        f0 = {kn: K.launch_counts[kn] for kn in ("fused_topk_scan", "fused_topk_pairs")}
        out, lat, wall = _run_clients(ask, len(reqs))
        fused_launches[name] = {kn: K.launch_counts[kn] - c for kn, c in f0.items()}
        hyb = [j for j, r in enumerate(reqs) if r[0] == "h"]
        n_dev = sum(served[(name, reqs[j][1])] for j in hyb)
        if batcher.hybrid_batched - h0 != n_dev:
            raise AssertionError(f"run {name}: {n_dev} queries served on the device but "
                                 f"hybrid_batched rose by {batcher.hybrid_batched - h0}")
        if name != "a" and n_dev != nq:
            raise AssertionError(f"run {name}: {nq - n_dev} of {nq} budget-eligible "
                                 "queries left the device path")
        for j in hyb:
            i = reqs[j][1]
            res = out[j]
            sc = np.array([r.score for r in res], np.float64)
            if not len(res) or not np.isfinite(sc).all() or (np.diff(sc) > 1e-7).any():
                raise AssertionError(f"run {name} query {i}: malformed answer")
            answers[(name, i)] = [(r.uuid, r.score) for r in res]
        launches = K.launch_counts["bm25_block"] - l0
        hl = np.asarray([lat[j] for j in hyb])
        parts.append(
            f"({name}) {nq} {'FiQA-shaped' if name == 'a' else 'budget-eligible'} hybrid "
            f"queries{' with where(n == 0), 10%' if flt is not None else ''} under "
            f"selection {selection} + {nq // 3} "
            f"nearVector from {CLIENTS} clients: device path served {n_dev}/{nq} "
            f"({n_dev / nq:.1%}), hybrid_batched +{batcher.hybrid_batched - h0}; "
            f"{len(hyb) / wall:.1f} hybrid QPS, p50 "
            f"{np.percentile(hl, 50):.1f} ms, p99 {np.percentile(hl, 99):.1f} ms; "
            f"bm25_block launches {launches} (one per fused dispatch, "
            f"{n_dev / max(launches, 1):.2f} hybrid rows each)")
    dispatches = batcher.dispatches - d0
    # ... and ends here: the host reference below runs the dense leg on the
    # card too, and its launches are not the hybrid path's
    counts = dict(K.launch_counts)
    col._hybrid_device = orig
    idx.store.selection = "approx"
    if fused_launches["d"]["fused_topk_scan"] <= 0:
        raise AssertionError("run d: the fused selection's dense leg did not launch "
                             "fused_topk_scan")
    # every answer of the device path against the host reference path, serially
    shard.device_hybrid = False
    exact = tie_ordered = over_budget = 0
    t1 = time.perf_counter()
    try:
        for (name, i), ans in answers.items():
            queries, flt, _selection = runs[name]
            if not served[(name, i)]:
                # the host path served it: the query's candidate union must
                # really exceed the budget
                allow = None if flt is None else shard.allow_mask(flt)
                pack = shard._inverted.bm25_pack(queries[i], None, allow,
                                                 max_candidates=1 << 30)
                if pack is None or len(pack["doc_ids"]) <= HYBRID_BUDGET:
                    raise AssertionError(f"run {name} query {i} took the host path "
                                         "within the candidate budget")
                over_budget += 1
                continue
            fusion, alpha = HYBRID_SETTINGS[i % 3]
            host = col.hybrid(queries[i], vector=qvecs[name][i],
                              alpha=alpha, k=HYBRID_K, fusion=fusion, where=flt,
                              include_objects=False)
            if _same_answer(ans, [(r.uuid, r.score) for r in host]):
                exact += 1
                continue
            allow = None if flt is None else shard.allow_mask(flt)
            oracle = _tie_ordered_reference(col, shard, queries[i], qvecs[name][i],
                                            fusion, alpha, allow)
            if not _same_answer(ans, oracle):
                raise AssertionError(
                    f"run {name} query {i} {queries[i]!r} ({fusion} {alpha}): device, "
                    "host path, tie-ordered reference:\n" + "\n".join(
                        f"  {a[0][-8:]} {a[1]!r} | {h.uuid[-8:]} {h.score!r} | "
                        f"{o[0][-8:]} {o[1]!r}" for a, h, o in zip(ans, host, oracle)))
            tie_ordered += 1
    finally:
        shard.device_hybrid = True
    ref_s = time.perf_counter() - t1
    # where a device-served query's time goes (host clock, after the
    # count): the host's BM25 planning of one query, and one fused
    # dispatch of 8 (b) rows against the dense scan alone at its depth
    plan_ms, ops = [], []
    for i in range(64):
        fusion, alpha = HYBRID_SETTINGS[i % 3]
        t2 = time.perf_counter()
        ops.append(shard._hybrid_operand(idx, runs["b"][0][i], HYBRID_K, alpha, fusion,
                                         None, None))
        plan_ms.append((time.perf_counter() - t2) * 1e3)
    fused_ms, dense_ms = [], []
    batches = [(qvecs["b"][8 * r:8 * r + 8], ops[8 * r:8 * r + 8]) for r in range(8)]
    split = hybrid_split(torch, idx, batches)
    for r in range(8):
        rows = qvecs["b"][8 * r:8 * r + 8]
        t2 = time.perf_counter()
        idx.hybrid_batch_async(rows, 16, None, ops[8 * r:8 * r + 8]).result()
        t3 = time.perf_counter()
        idx.search_by_vector_batch_async(rows, 128).result()
        fused_ms.append((t3 - t2) * 1e3)
        dense_ms.append((time.perf_counter() - t3) * 1e3)
    log(f"phase 7 hybrid: BEIR FiQA-2018 shape, {n_docs} documents (text {mean_len:.1f} "
        f"words, title ~{TITLE_WORDS}, Zipf s={ZIPF_S} over {VOCAB} words, made in "
        f"{gen_s:.1f} s), {DIM}-d {METRIC} flat; batch_put in {import_s:.1f} s "
        f"({n_docs / import_s:.0f} objects/s, native host library {_native_state()}); k1 1.2, b 0.75, k={HYBRID_K}, "
        f"{'/'.join(f'{f} {a}' for f, a in HYBRID_SETTINGS)} in turn: " + " | ".join(parts)
        + f"; {dispatches} batched dispatches in all; host reference ({ref_s:.1f} s, serial, "
        f"device_hybrid off): {exact} device answers equal to it (uuids, scores within "
        f"rtol {FUSED_RTOL}, order where scores differ), {tie_ordered} equal to it once "
        f"exactly tied BM25 scores are ordered by doc id as the device orders them, 0 "
        f"differ; {over_budget} host-served queries all over the {HYBRID_BUDGET}-candidate "
        f"budget; launches {counts}, of which run (d) {fused_launches['d']}; "
        f"per device-served query: BM25 planning on the host "
        f"p50 {np.median(plan_ms):.2f} ms; a fused dispatch of 8 rows p50 "
        f"{np.median(fused_ms):.2f} ms against the dense scan alone (k 128) "
        f"{np.median(dense_ms):.2f} ms; the dispatch's split (one page-locked buffer with "
        f"compact planes, one non-blocking copy, a CUDA graph of the program): {split}; "
        f"device memory after the phase: {_memory_text(torch)}")
    for kn in ("bm25_block", "distance_block"):
        if counts[kn] <= 0:
            raise AssertionError(f"{kn} was not launched on the hybrid path")
    return counts, dict(col=col, ref=ref, df=df)


# -- where a fused hybrid dispatch's time goes ----------------------------------

# (module attribute, label, on the device): the stages of
# FlatIndex.hybrid_batch_async and ops/bm25.hybrid_topk that the split
# times, each wrapped while it runs
SPLIT_STAGES = (("search_async", "dense scan", True),
                ("stack_sparse_operands", "stack", False),
                ("stack_dispatch_operands", "stack", False),
                ("pack_to_device", "upload", True),
                ("hybrid_program", "upload + program", True),
                ("bm25_neg_scores", "bm25_block", True),
                ("masked_candidate_topk", "sparse top-k", True), ("fuse_topk", "fusion", True))


def _upload_per_array(pack: dict, device) -> dict:
    """The first design's upload, kept to compare with: one pageable
    ``.to(device)`` per stacked array (each waits for the stream)."""
    import torch

    from weaviate_tpu_torch.ops.kernels import as_bits_tensor

    out = {}
    for name, arr in pack.items():
        if not isinstance(arr, np.ndarray):
            continue
        if name == "cand_bits":
            out[name] = as_bits_tensor(np.array(arr), device)
        else:
            out[name] = torch.from_numpy(np.array(arr)).to(device)
    return out


def _memory_text(torch) -> str:
    """The card's memory as PyTorch holds it, and the bytes the cached
    hybrid CUDA graphs hold by their own estimate (ops/bm25.graph_bytes)."""
    from weaviate_tpu_torch.ops import bm25 as B

    gib = 1 << 30
    text = (f"reserved {torch.cuda.memory_reserved() / gib:.3f} GiB, allocated "
            f"{torch.cuda.memory_allocated() / gib:.3f} GiB")
    if hasattr(B, "hybrid_graph_bytes"):
        text += f", hybrid graphs {B.hybrid_graph_bytes() / gib:.3f} GiB (estimate)"
    return text


def _stacked_shape(pack) -> tuple:
    """(B, S, T, C) that a stacking stage returned: the padded shape of
    ``stack_dispatch_operands``, or the arrays' of ``stack_sparse_operands``."""
    if "shape" in pack:
        return tuple(int(x) for x in pack["shape"])
    b, s, c = pack["seg_tf"].shape
    return b, s, pack["idf"].shape[1], c


def hybrid_split(torch, idx, batches, k: int = 16, first_design: bool = False) -> str:
    """Where one fused hybrid dispatch goes: ``idx.hybrid_batch_async(rows,
    k, None, ops).result()`` for each (rows, ops) of ``batches`` (the first
    one warms up), with each stage of SPLIT_STAGES wrapped: its host time
    (the enqueue; an upload that waits for the stream waits here) and, for
    the device stages, CUDA events around it (the device's span of the
    stage, gaps included where the host is slower than the device); then
    the handle's ``.result()`` (the wait for the device and the copy back)
    on the host clock. Medians in ms. ``first_design``: the program as
    the first design ran it, to compare with: one pageable copy per
    stacked array (``_upload_per_array``), then hybrid_topk's launches one
    by one, no CUDA graph."""
    from weaviate_tpu_torch.ops import bm25 as B

    rec: dict = {}
    stacked: set = set()
    nest = threading.local()  # the stacking runs on another thread

    def timed(label, fn, device):
        def wrapper(*a, **kw):
            if getattr(nest, "depth", 0):  # a stage inside another (fuse_topk's top-k)
                return fn(*a, **kw)
            nest.depth = 1
            try:
                e0 = torch.cuda.Event(enable_timing=True) if device else None
                if e0 is not None:
                    e0.record()
                t0 = time.perf_counter()
                r = fn(*a, **kw)
                host = (time.perf_counter() - t0) * 1e3
                if label == "stack":
                    stacked.add(_stacked_shape(r))
                e1 = torch.cuda.Event(enable_timing=True) if device else None
                if e1 is not None:
                    e1.record()
                rec.setdefault(label, []).append((host, e0, e1))
                return r
            finally:
                nest.depth = 0
        return wrapper

    saved = []
    for attr, label, device in SPLIT_STAGES:
        owner = idx.store if attr == "search_async" else B
        fn = getattr(owner, attr, None)
        if fn is None:  # a tree without this stage
            continue
        saved.append((owner, attr, owner.__dict__.get(attr)))
        if first_design and attr == "stack_dispatch_operands":
            # the first design's padded planes (B.stack_sparse_operands, timed
            # as "stack" above)
            setattr(owner, attr, lambda ops, b_pad, **_kw: {
                "padded": B.stack_sparse_operands(ops, b_pad)})
            continue
        if first_design and attr == "hybrid_program":
            setattr(owner, attr, lambda dn_d, dn_i, pack, kk: B.hybrid_topk(
                dn_d, dn_i, B.pack_to_device(pack["padded"], dn_d.device), kk))
            continue
        if first_design and attr == "pack_to_device":
            fn = _upload_per_array
        setattr(owner, attr, timed(label, fn, device))
    rows_of = []
    walls, results = [], []
    try:
        for i, (rows, ops) in enumerate(batches):
            rec_before = {lb: len(v) for lb, v in rec.items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            h = idx.hybrid_batch_async(rows, k, None, ops)
            t1 = time.perf_counter()
            h.result()
            t2 = time.perf_counter()
            if i == 0:  # warm-up: drop its records
                for lb in rec:
                    del rec[lb][rec_before.get(lb, 0):]
                continue
            walls.append((t2 - t0) * 1e3)
            results.append((t2 - t1) * 1e3)
            live = [op for op in ops if op is not None]
            rows_of.append((len(ops), max(op.seg_tf.shape[0] for op in live),
                            max(len(op.idf) for op in live), max(len(op.slots) for op in live)))
    finally:
        for owner, attr, orig in saved:
            if orig is None:
                delattr(owner, attr)
            else:
                setattr(owner, attr, orig)
    torch.cuda.synchronize()
    parts = [f"wall p50 {np.median(walls):.3f} ms"]
    for label, device in dict((lb, dv) for _a, lb, dv in SPLIT_STAGES).items():
        got = rec.get(label, [])
        if not got:
            continue
        text = f"{label} host {np.median([h for h, _e0, _e1 in got]):.3f}"
        if device:
            text += f" / device {np.median([e0.elapsed_time(e1) for _h, e0, e1 in got]):.3f}"
        parts.append(text)
    parts.append(f"result() wait + copy host {np.median(results):.3f}")
    b, s_, t_, c_ = np.max(np.asarray(rows_of), axis=0)
    shapes = " / ".join(str(list(sh)) for sh in sorted(stacked))
    return (f"{len(walls)} dispatches of {b} rows (unpadded S <= {s_}, T <= {t_}, C <= {c_}; "
            f"stacked and launched at (B, S, T, C) {shapes}): " + ", ".join(parts) + " ms")


def hybrid_stages(torch, idx, rows, ops, k: int = 16) -> str:
    """One dispatch's program stage by stage, each alone on an idle card
    (synchronized before and after, CUDA events around it, so a stage's
    time is the device's span of it, host gaps between its launches
    included): the upload of the stacked operands, bm25_block, the sparse
    top-k, the fusion and the copy back, launched as ``hybrid_topk``
    launches them; then the whole program as a dispatch runs it
    (``hybrid_program``: a CUDA graph's replay, where the tree has one).
    Medians of 5 after a warm-up, in ms."""
    from weaviate_tpu_torch.ops import bm25 as B
    from weaviate_tpu_torch.ops.candidates import masked_candidate_topk

    fetch = max([k] + [int(op.fetch) for op in ops if op is not None])
    f_depth = 1 << max(0, fetch - 1).bit_length()
    dn_d, dn_i = idx.store.search_async(rows, f_depth, None, keep_rows=True).arrays
    pack = B.stack_sparse_operands(ops, len(rows))
    times: dict = {}

    def stage(name, fn):
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        r = fn()
        e1.record()
        torch.cuda.synchronize()
        times.setdefault(name, []).append(e0.elapsed_time(e1))
        return r

    for _rep in range(6):
        dev = stage("upload", lambda: B.pack_to_device(pack, dn_d.device))
        neg = stage("bm25_block", lambda: B.bm25_neg_scores(*(dev[n] for n in BM25_ARGS)))
        fs = min(neg.shape[1], dn_d.shape[1])
        sp = stage("sparse top-k", lambda: masked_candidate_topk(neg, dev["slots"], fs))
        fu = stage("fusion", lambda: B.fuse_topk(sp[0], sp[1], dn_d, dn_i, dev["alpha"],
                                                 dev["kind"], dev["fetch"], k))
        stage("copy back", lambda: (fu[0][:, :k].cpu(), fu[1][:, :k].cpu()))
        if hasattr(B, "hybrid_program"):
            packed = B.stack_dispatch_operands(ops, len(rows), shape=B.GRAPH_SHAPE,
                                               pin=dn_d.is_cuda)
            stage("whole program (one upload, graph replay)",
                  lambda: B.hybrid_program(dn_d, dn_i, packed, k))
    return ", ".join(f"{name} {np.median(v[1:]):.3f}" for name, v in times.items()) + " ms"


def synthetic_hybrid(torch, seed: int, n_docs: int = FIQA_DOCS, dispatches: int = 9,
                     dev: str = "cuda"):
    """A flat cosine index of ``n_docs`` random 768-d rows on the card and
    ``dispatches`` batches of 8 hybrid rows with random FiQA-like sparse
    operands (8 query terms over two properties, 1,000-4,000 candidates),
    for timing the fused dispatch without phase 7's text import."""
    from weaviate_tpu_torch.engine.flat import FlatIndex
    from weaviate_tpu_torch.ops.bm25 import SparseOperand, fusion_kind

    rng = np.random.default_rng([seed, 11])
    cent = centers(seed)
    idx = FlatIndex(DIM, METRIC, capacity=1 << 16, device=dev)
    for s in range(0, n_docs, 16384):
        n = min(16384, n_docs - s)
        idx.add_batch(np.arange(s, s + n), clustered(seed + 3, s, n, cent))
    batches = []
    for d in range(dispatches):
        ops = []
        for r in range(8):
            t = 8
            c = int(rng.integers(1000, HYBRID_BUDGET + 1))
            docs = np.sort(rng.choice(n_docs, c, replace=False)).astype(np.int64)
            tf = rng.integers(1, 4, (2 * t, c)).astype(np.float32)
            tf[rng.random((2 * t, c)) < 0.8] = 0.0
            fusion, alpha = HYBRID_SETTINGS[(8 * d + r) % 3]
            ops.append(SparseOperand(
                docs, idx.slots_for_doc_ids(docs), tf,
                rng.integers(1, 300, (2 * t, c)).astype(np.float32),
                np.repeat(np.arange(t, dtype=np.int32), 2),
                np.tile(np.float32([1.0, 1.0]), t), np.tile(np.float32([6.0, 132.0]), t),
                rng.uniform(0.5, 8.0, t).astype(np.float32), 1.2, 0.75,
                float(np.float32(1.0) - np.float32(0.75)), alpha, fusion_kind(fusion),
                max(HYBRID_K * 10, 100)))
        rows = clustered(seed + 5, 8 * d, 8, cent)
        batches.append((rows, ops))
    return idx, batches


def mxu_times(torch, K, gen, timer) -> list[str]:
    """bq_mxu_block at the main shape [256, 24 words] x 1,048,576 rows
    (~10% dead), equal to its plain version, timed beside its bound, with
    each query block the kernel could take (BQ_TC_QBLOCKS; the wrapper
    picks 128) and the popcount body it keeps; phase 8's [8, 4 words] x 512
    from a CUDA graph; and the product alone as a yardstick: torch._int_mm
    of the 0/1 int8 bit planes, [256, 768] x [768, N] (not library_ms: no
    PyTorch call computes the function). Returns one text part each."""
    dev = "cuda"
    n, w = 1 << 20, DIM // 32
    xw = torch.randint(-2 ** 31, 2 ** 31 - 1, (n, w), dtype=torch.int32, device=dev,
                       generator=gen)
    qw = torch.randint(-2 ** 31, 2 ** 31 - 1, (BATCH, w), dtype=torch.int32, device=dev,
                       generator=gen)
    valid = torch.rand(n, device=dev, generator=gen) > 0.1
    _same_block(torch, K.bq_mxu_block(qw, xw, valid=valid),
                K.bq_mxu_block_plain(qw, xw, valid=valid), f"bq_mxu_block [{BATCH},{w}] x [{n}]")
    b_ms, b_by = mxu_bound(BATCH, n, w)
    o = dict(ms=timer(lambda: K.bq_mxu_block(qw, xw, valid=valid), reps=20), bound_ms=b_ms,
             bound_by=b_by)
    parts = [f"bq_mxu_block [{BATCH},{w} words] x [{n},{w}] ~10% dead: equal to the plain "
             f"version; kernel {o['ms']:.4f} ms, {_bound_text(o)}"]
    if hasattr(K, "bq_mxu_launch"):  # absent from trees before the single-bit body
        blocks = {qn: timer(lambda: K.bq_mxu_launch(qw, None, xw, None, valid, qn), reps=20)
                  for qn in K.BQ_TC_QBLOCKS[2:] + (0,)}
        parts.append(f"by query block (the wrapper takes {K.bq_mxu_qblock(BATCH, w)}; 0: the "
                     "popcount body): " + ", ".join(f"{qn} {ms:.4f} ms"
                                                    for qn, ms in blocks.items()))
    q8, x8 = qw[:8, :4].contiguous(), xw[:512, :4].contiguous()
    parts.append(f"phase 8's [8,4 words] x [512,4]: "
                 f"{graph_ms(torch, K, [lambda: K.bq_mxu_block(q8, x8)]):.4f} ms "
                 "(a CUDA graph of launches)")
    try:
        q01, x01 = _bit_planes(torch, qw, torch.int8), _bit_planes(torch, xw, torch.int8)
        ms = timer(lambda: torch._int_mm(q01, x01.t()), reps=5)
        parts.append(f"yardstick torch._int_mm [{BATCH},{32 * w}] x [{32 * w},{n}] 0/1 int8 "
                     f"(the product alone): {ms:.4f} ms")
        del x01
    except RuntimeError as e:  # a yardstick only: the run goes on without it
        parts.append(f"yardstick torch._int_mm failed: {str(e).splitlines()[0]}")
    return parts


def ham_times(torch, K, gen, timer) -> list[str]:
    """bq_hamming_block at the main shape [256, 24 words] x 1,048,576 rows,
    equal to its plain version, timed beside its bound: the wrapper (which
    lays out the query blocks each call), the kernel alone on blocks laid
    out once, each query block the tensor-core body could take and the
    popcount body it keeps (query block 0); then its two yardsticks
    (ham_yardsticks). Returns one text part each."""
    from weaviate_tpu_torch.ops import _build

    dev = "cuda"
    n, w = 1 << 20, DIM // 32
    xw = torch.randint(-2 ** 31, 2 ** 31 - 1, (n, w), dtype=torch.int32, device=dev,
                       generator=gen)
    qw = torch.randint(-2 ** 31, 2 ** 31 - 1, (BATCH, w), dtype=torch.int32, device=dev,
                       generator=gen)
    ham = K.bq_hamming_block(qw, xw)
    _same_block(torch, ham, K.bq_hamming_block_plain(qw, xw), f"bq_hamming_block [{BATCH},{w}] x [{n}]")
    b_ms, b_by = ham_bound(BATCH, n, w)
    o = dict(ms=timer(lambda: K.bq_hamming_block(qw, xw), reps=20), bound_ms=b_ms, bound_by=b_by)
    parts = [f"bq_hamming_block [{BATCH},{w} words] x [{n},{w}]: equal to the plain version; "
             f"the wrapper {o['ms']:.4f} ms, {_bound_text(o)}"]
    qn = K.bq_hamming_qblock(BATCH, w)
    qm, out = K.bq_query_blocks(qw, qn), torch.empty_like(ham)
    fn, stream = _build.kernel("bq_hamming_block"), torch.cuda.current_stream().cuda_stream

    def kernel_only():
        fn(qm.data_ptr(), qw.data_ptr(), xw.data_ptr(), 1, BATCH, n, w, qn, -(-BATCH // qn), 1,
           out.data_ptr(), stream)
    kernel_only()
    if not torch.equal(out, ham):
        raise AssertionError("bq_hamming_block's kernel alone differs from the wrapper")
    o = dict(ms=timer(kernel_only, reps=20), bound_ms=b_ms, bound_by=b_by)
    parts.append(f"the kernel alone (query blocks laid out once) {o['ms']:.4f} ms, "
                 f"{_bound_text(o)}")
    # the body without its global stores (a -DWTT_BQ_TC_NOSTORE build),
    # beside the stores alone: one fill_ of the [B, N] f32 output
    nostore = _build.build_variant("bq_hamming_block", ("WTT_BQ_TC_NOSTORE",))

    def no_stores():
        nostore(qm.data_ptr(), qw.data_ptr(), xw.data_ptr(), 1, BATCH, n, w, qn, -(-BATCH // qn),
                1, out.data_ptr(), stream)
    no_stores()
    torch.cuda.synchronize()
    parts.append(f"its breakdown: the body without its global stores (-DWTT_BQ_TC_NOSTORE) "
                 f"{timer(no_stores, reps=20):.4f} ms, the stores alone (fill_ of the "
                 f"[{BATCH},{n}] f32 output) {timer(lambda: out.fill_(1.0), reps=20):.4f} ms")
    blocks = {q: timer(lambda: K.bq_hamming_launch(qw, xw, q), reps=20)
              for q in K.BQ_TC_QBLOCKS[2:] + (0,)}
    parts.append(f"by query block (the wrapper takes {qn}; 0: the popcount body it keeps): "
                 + ", ".join(f"{q} {ms:.4f} ms" for q, ms in blocks.items()))
    del out, qm
    parts.append(ham_yardsticks(torch, qw, xw, ham, timer)[1])
    return parts


def recon_times(torch, K, gen, timer) -> list[str]:
    """pq4_recon_block at the main shape, q [256, 768] x codes [1,048,576,
    192], ds 4, ~10% dead: l2 / dot / cosine within PQ_TOL of the plain
    version, each timed beside the bound; its fast path's MMAs alone and
    its A build alone (``-DWTT_RECON_PART`` builds); and the product alone as a
    yardstick: a bf16 torch.matmul of q by a materialized x_hat^T [768, N]
    (1.6 GB; not library_ms: the port never materializes x_hat). Returns
    one text part each."""
    dev = "cuda"
    n, m, ds = 1 << 20, DIM // 4, 4
    codes = torch.randint(0, 16, (n, m), dtype=torch.uint8, device=dev, generator=gen)
    cent = torch.randn((m, 16, ds), device=dev, generator=gen) * 0.2
    q = torch.nn.functional.normalize(torch.randn((BATCH, DIM), device=dev, generator=gen), dim=1)
    valid = torch.rand(n, device=dev, generator=gen) > 0.1
    b_ms, b_by = bound_ms(q.numel() * 4 + codes.numel() + cent.numel() * 4 + n + BATCH * n * 2,
                          2.0 * BATCH * n * DIM, BF16_FLOPS)
    parts = []
    for metric in ("l2-squared", "dot", "cosine"):
        err = _same_block(torch, K.pq4_recon_block(q, codes, cent, metric, valid),
                          K.pq4_recon_block_plain(q, codes, cent, metric, valid),
                          f"pq4_recon_block {metric} [{BATCH},{DIM}] x [{n},{m}]", tol=PQ_TOL)
        o = dict(ms=timer(lambda: K.pq4_recon_block(q, codes, cent, metric, valid), reps=10),
                 bound_ms=b_ms, bound_by=b_by)
        parts.append(f"pq4_recon_block {metric} [{BATCH},{DIM}] x [{n},{m}] ds {ds}: within "
                     f"PQ_TOL (max_abs_err {err:.3g}); kernel {o['ms']:.4f} ms, {_bound_text(o)}")
    if hasattr(K, "pq4_recon_fast"):  # the breakdown builds are this design's
        from weaviate_tpu_torch.ops import _build

        full, ms = _build.kernel("pq4_recon_block"), {}
        try:
            for part, what in ((1, "the MMAs alone"), (2, "the A build alone")):
                _build._funcs["pq4_recon_block"] = _build.build_variant(
                    "pq4_recon_block", (f"WTT_RECON_PART={part}",))
                ms[what] = timer(lambda: K.pq4_recon_block(q, codes, cent, METRIC, valid), reps=10)
        finally:
            _build._funcs["pq4_recon_block"] = full
        parts.append(f"pq4_recon_block {METRIC} breakdown (-DWTT_RECON_PART builds of the fast "
                     "path, same call): " + ", ".join(f"{w} {t:.4f} ms" for w, t in ms.items()))
    try:
        cb = torch.nn.functional.pad(K._pq4_recon_centroids(cent), (0, 0, 0, 1)) \
            .to(torch.bfloat16)  # [m, 17, ds], row 16 for the codes past 15
        seg = torch.arange(m, device=dev)
        xhat = torch.empty((n, DIM), dtype=torch.bfloat16, device=dev)
        for s in range(0, n, ADD_BATCH):
            c = codes[s:s + ADD_BATCH].long().clamp(max=16)
            xhat[s:s + ADD_BATCH] = cb[seg[None, :], c].reshape(-1, DIM)
        qb = q.to(torch.bfloat16)
        ms = timer(lambda: torch.matmul(qb, xhat.t()), reps=5)
        parts.append(f"yardstick torch.matmul [{BATCH},{DIM}] x [{DIM},{n}] bf16 on a "
                     f"materialized x_hat (the product alone): {ms:.4f} ms")
        del xhat
    except RuntimeError as e:  # a yardstick only: the run goes on without it
        parts.append(f"yardstick torch.matmul failed: {str(e).splitlines()[0]}")
    return parts


def block_times(torch, K, seed: int, timer) -> list[str]:
    """``--block-times``: bq_hamming_block, bq_mxu_block and
    pq4_recon_block held to their plain versions (HAM_CHECKS, UNALIGNED,
    MXU_CHECKS, RECON_CHECKS, the main shapes) and timed beside their
    bounds and yardsticks (ham_times, mxu_times, recon_times);
    pq4_lut_block and bm25_block held to their plain versions (LUT_CHECKS,
    the 1M-row shape; BM25_CHECKS) and timed at the main and dispatch
    shapes, then the fused hybrid dispatch's split on a synthetic
    FiQA-sized index. Returns one text part each."""
    from weaviate_tpu_torch.ops import bm25 as B

    rng = np.random.default_rng([seed, 2])
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(seed)
    parts = [f"bq_mxu_block and pq4_recon_block held to the plain versions at "
             f"{mxu_recon_checks(torch, K, rng, dev)} MXU_CHECKS / RECON_CHECKS shapes, "
             f"bq_hamming_block at {ham_checks(torch, K, rng, dev)} HAM_CHECKS / UNALIGNED "
             "shapes"]
    parts += ham_times(torch, K, gen, timer)
    torch.cuda.empty_cache()
    parts += mxu_times(torch, K, gen, timer) + recon_times(torch, K, gen, timer)
    torch.cuda.empty_cache()
    parts.append(f"pq4_lut_block equal to the plain version at {lut_checks(torch, K, rng)} "
                 f"LUT_CHECKS cases")
    n, m = 1 << 20, DIM // 4
    codes = torch.randint(0, 16, (n, m), dtype=torch.uint8, device=dev, generator=gen)
    lut = torch.randn((BATCH, m, 16), device=dev, generator=gen) * 3
    valid = torch.rand(n, device=dev, generator=gen) > 0.1
    _same_bits(torch, K.pq4_lut_block(lut, codes, valid), K.pq4_lut_block_plain(lut, codes, valid),
               f"pq4_lut_block [{BATCH},{m},16] x [{n},{m}]")
    o = lut_time(torch, K, lut, codes, valid, timer, plain=False)
    parts.append(f"pq4_lut_block [{BATCH},{m},16] x [{n},{m}] equal to the plain version; "
                 f"kernel {o['ms']:.3f} ms, {_bound_text(o)} (the exact sum's FADDs), the "
                 f"one-hot product at the bf16 rate {o['onehot_ms']:.3f} ms")
    del codes, lut, valid
    parts.append(f"bm25_block equal to the plain version at {bm25_checks(torch, K, rng)} "
                 "BM25_CHECKS shapes")
    for shape in (BM25_SHAPE, BM25_DISPATCH_SHAPE):
        o = bm25_time(torch, K, rng, timer, shape, plain=False)
        parts.append(f"bm25_block {list(shape)}: {o['ms']:.4f} ms (CUDA graph of launches; "
                     f"the wrapper called back to back {o['call_ms']:.4f}), {_bound_text(o)}")
    idx, batches = synthetic_hybrid(torch, seed)
    parts.append("fused dispatch split, synthetic FiQA-sized index: "
                 + hybrid_split(torch, idx, batches))
    if hasattr(B, "hybrid_program"):
        parts.append("the first design's program on the same index (padded planes, "
                     "per-array pageable uploads, launches one by one): "
                     + hybrid_split(torch, idx, batches, first_design=True))
    parts.append("the program's stages alone: " + hybrid_stages(torch, idx, *batches[1]))
    return parts


def phase_conformance(K) -> dict:
    """bench.py's kernel conformance through the port's entry point on the
    card; returns the launch counts of its run."""
    from weaviate_tpu_torch.ops.conformance import kernel_conformance

    K.reset_launch_counts()  # phase 8's run starts here
    t0 = time.perf_counter()
    status = kernel_conformance(device="cuda")
    counts = dict(K.launch_counts)
    if status != "ok":
        raise AssertionError(f"kernel conformance: {status}")
    for name in CONFORMANCE_KERNELS:
        if counts[name] == 0:
            raise AssertionError(f"{name} was not launched in phase 8")
    log(f"phase 8 conformance: kernel_conformance(device='cuda') at 128 dims, 8 queries x "
        f"512 rows: {status} in {time.perf_counter() - t0:.2f} s; launches "
        f"{ {k: v for k, v in counts.items() if v} }")
    return counts


# -- phase 9: the server over a real socket --------------------------------------

SERVER_QUERIES = 1024     # 9a: GraphQL nearVector queries, every 4th filtered
SERVER_FILTER_EVERY = 4   # 9a: host filter evaluation bounds the filtered ones
SERVER_FUSED = 64         # 9a: of them again under selection "fused"
SERVER_K = 100
SERVER_QUANT = 128        # 9b: nearVector queries on each quantized collection, half filtered
SERVER_HYBRID = 64        # 9b: hybrid queries on phase 7's collection
WRITE_ROWS, WRITE_BATCH, READ_BACK = 10_000, 1_000, 1_000
# kernels each half of the server phase must launch through the socket
SERVER_KERNELS = {"9a": ("distance_block", "fused_topk_pairs", "fused_topk_scan"),
                  "9b": ("bm25_block", "distance_block", "bq_scan_reduce",
                         "pq4_scan_reduce")}


def _grpc_present() -> bool:
    try:
        import google.protobuf  # noqa: F401
        import grpc  # noqa: F401
    except ImportError:
        return False
    return True


def start_server(db):
    """The port's Server over phase 4's Database on 127.0.0.1, ports
    chosen by the OS, no telemetry. Without grpcio the same assembly
    serves REST alone (Server.assemble), and says so."""
    from weaviate_tpu_torch.config import ServerConfig
    from weaviate_tpu_torch.server import Server

    cfg = ServerConfig(data_path=db.data_dir, host="127.0.0.1", rest_port=0, grpc_port=0,
                       disable_telemetry=True)
    srv = Server(cfg, device="cuda", db=db)
    if _grpc_present():
        srv.start()
        log(f"phase 9 server: REST + GraphQL on {srv.rest.address}, gRPC on "
            f":{srv.grpc.port} (grpcio present)")
    else:
        srv.assemble()
        log(f"phase 9 server: grpc is absent (import grpc, google.protobuf failed): "
            f"REST + GraphQL on {srv.rest.address} through Server.assemble, no gRPC "
            "listener; nothing installed")
    return srv


def _gql(client, query: str, variables: dict) -> list:
    out = client.graphql(query, variables)
    if "errors" in out:
        raise AssertionError(f"GraphQL errors: {out['errors'][:1]}")
    return next(iter(out["data"]["Get"].values()))


def _near_gql(limit: int, filtered: bool, key: str = "distance") -> str:
    where = f", where: {{path: [\"views\"], operator: GreaterThanEqual, valueInt: {VIEWS_CUT}}}"
    return (f"query Q($v: [Float]) {{ Get {{ %s(limit: {limit}, nearVector: {{vector: $v}}"
            f"{where if filtered else ''}) {{ _additional {{ id {key} }} }} }} }}")


def _timed_text(lat, wall, nq: int) -> str:
    return (f"{nq / wall:.1f} QPS, p50 {np.percentile(lat, 50):.1f} ms, "
            f"p99 {np.percentile(lat, 99):.1f} ms")


def _socket_vs_inproc(col, client, queries, k: int, where, what: str,
                      grpc_port=None, every: int = 2) -> tuple[list[str], dict]:
    """``queries`` in process (CLIENTS threads through the batcher, the
    reference) and then over the socket; query i carries ``where`` when
    i % every == every - 1.
    GraphQL answers must equal the in-process ones exactly (ids, distance
    bits); so must gRPC's where grpcio is present. The reference runs
    outside the caller's launch window: it returns the socket closures."""
    nq = len(queries)
    name = col.config.name
    gql = {f: _near_gql(k, f) % name for f in (False, True)}

    def filtered(i):
        return i % every == every - 1

    def inproc(i):
        return [(r.uuid, r.distance) for r in
                col.near_vector(queries[i], k=k, where=where if filtered(i) else None)]

    ref, lat, wall = _run_clients(inproc, nq)
    parts = [f"{what}: in process {_timed_text(lat, wall, nq)}"]

    def over_graphql():
        def ask(i):
            rows = _gql(client, gql[filtered(i)], {"v": queries[i].tolist()})
            return [(r["_additional"]["id"], r["_additional"]["distance"]) for r in rows]

        out, lat, wall = _run_clients(ask, nq)
        for i, (a, b) in enumerate(zip(ref, out)):
            if a != b:
                raise AssertionError(f"{what} query {i}: GraphQL answer != in-process answer")
        return f"GraphQL over the socket {_timed_text(lat, wall, nq)}, identical"

    def over_grpc():
        import grpc

        from weaviate_tpu_torch.api.grpc import v1_pb2 as pb

        chan = grpc.insecure_channel(f"127.0.0.1:{grpc_port}")
        search = chan.unary_unary("/weaviate.v1.Weaviate/Search",
                                  request_serializer=pb.SearchRequest.SerializeToString,
                                  response_deserializer=pb.SearchReply.FromString)

        def ask(i):
            req = pb.SearchRequest(collection=name, limit=k)
            req.near_vector.vector_bytes = np.asarray(queries[i], np.float32).tobytes()
            if filtered(i):
                req.filters.operator = pb.Filters.OPERATOR_GREATER_THAN_EQUAL
                req.filters.target.property = "views"
                req.filters.value_int = VIEWS_CUT
            req.metadata.uuid = True
            req.metadata.distance = True
            return [(r.metadata.id, r.metadata.distance) for r in search(req).results]

        try:
            out, lat, wall = _run_clients(ask, nq)
        finally:
            chan.close()
        for i, (a, b) in enumerate(zip(ref, out)):
            if [u for u, _ in a] != [u for u, _ in b] or \
                    [np.float32(d) for _, d in a] != [np.float32(d) for _, d in b]:
                raise AssertionError(f"{what} query {i}: gRPC answer != in-process answer")
        return f"gRPC Search {_timed_text(lat, wall, nq)}, identical"

    runs = {"graphql": over_graphql}
    if grpc_port is not None:
        runs["grpc"] = over_grpc
    return parts, runs


def phase_server_plain(torch, K, seed: int, srv, st4: dict) -> dict:
    """Phase 9a, before phase 6 compresses phase 4's collection: GraphQL
    (and gRPC) nearVector at limit 100, half under the 10% filter, held to
    the in-process answers; then SERVER_FUSED of them under selection
    "fused". Counts the socket runs' launches."""
    from weaviate_tpu_torch.api.client import Client
    from weaviate_tpu_torch.filters import Filter, Operator

    dev = "cuda"
    t0 = time.perf_counter()
    col, ref = st4["col"], st4["ref"]
    rng = np.random.default_rng([seed, 91])
    where = Filter.where("views", Operator.GREATER_THAN_EQUAL, VIEWS_CUT)
    queries = near_queries(seed + 91, rng.integers(0, len(ref), SERVER_QUERIES),
                           lambda r: ref[torch.from_numpy(r).to(dev)].cpu().numpy())
    client = Client(srv.rest.address, timeout=120.0)
    grpc_port = srv.grpc.port if srv.grpc is not None else None
    idx = next(iter(col.shards.values())).vector_indexes[""]
    idx.store.selection = "approx"
    mix = (f"every {SERVER_FILTER_EVERY}th under where(views >= {VIEWS_CUT}), 10%")
    parts, runs = _socket_vs_inproc(col, client, queries, SERVER_K, where,
                                    f"{SERVER_QUERIES} nearVector(limit {SERVER_K}), {mix}, "
                                    "selection approx", grpc_port, SERVER_FILTER_EVERY)
    idx.store.selection = "fused"
    fparts, fruns = _socket_vs_inproc(col, client, queries[:SERVER_FUSED], SERVER_K, where,
                                      f"{SERVER_FUSED} of them under selection fused",
                                      every=SERVER_FILTER_EVERY)
    idx.store.selection = "approx"
    K.reset_launch_counts()  # phase 9a's socket window starts here
    for fn in runs.values():
        parts.append(fn())
    idx.store.selection = "fused"
    try:
        fparts.append(fruns["graphql"]())
    finally:
        idx.store.selection = "approx"
    counts = dict(K.launch_counts)  # ... and ends here
    log(f"phase 9a server ({time.perf_counter() - t0:.1f} s), plain nearVector on phase 4's "
        f"{len(ref)}-row collection over 127.0.0.1 from {CLIENTS} client threads "
        f"({_smi_line()}): " + "; ".join(parts)
        + " | " + "; ".join(fparts) + f"; launches through the socket {counts}")
    _require_server_launches(counts, "9a")
    return counts


def _require_server_launches(counts: dict, part: str) -> None:
    for name in SERVER_KERNELS[part]:
        if counts[name] <= 0:
            raise AssertionError(f"{name} was not launched through the server in phase {part}")


def _smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]


def _quant_queries(torch, col, seed: int, prefix: int, rows: int, tag: int) -> np.ndarray:
    """SERVER_QUANT queries near stored rows of ``col`` (deleted rows are
    skipped), read back through get_object."""
    rng = np.random.default_rng([seed, tag])
    vecs = []
    for r in rng.permutation(rows):
        obj = col.get_object(_uuid(prefix, int(r)))
        if obj is not None:
            vecs.append(obj.vector)
        if len(vecs) == SERVER_QUANT:
            break
    base = np.stack(vecs).astype(np.float32)
    base /= np.linalg.norm(base, axis=1, keepdims=True)
    noise = rng.standard_normal(base.shape).astype(np.float32) * NEAR_NOISE
    return base + noise


def phase_server_rest(torch, K, seed: int, srv, db, st7: dict, rows: int) -> dict:
    """Phase 9b, after phase 7: nearVector on phase 6's PQ and BQ
    collections and hybrid on phase 7's, held to the in-process answers;
    then the write path: WRITE_ROWS new objects through POST
    /v1/batch/objects, READ_BACK of them read back and found first by
    nearVector. Counts the socket runs' launches."""
    from weaviate_tpu_torch.api.client import Client
    from weaviate_tpu_torch.filters import Filter, Operator

    t0 = time.perf_counter()
    client = Client(srv.rest.address, timeout=120.0)
    where = Filter.where("views", Operator.GREATER_THAN_EQUAL, VIEWS_CUT)
    socket_runs, parts = [], []
    for name, prefix, n_rows, tag in (("Wiki", 8000, rows, 92), ("WikiBQ", 8001,
                                                                 BQ_E2E_ROWS, 93)):
        col = db.get_collection(name)
        kind = getattr(next(iter(col.shards.values())).vector_indexes[""].store,
                       "quantization", "flat")
        qs = _quant_queries(torch, col, seed, prefix, n_rows, tag)
        p, r = _socket_vs_inproc(col, client, qs, 10, where,
                                 f"{SERVER_QUANT} nearVector(limit 10), half filtered, on "
                                 f"phase 6's {kind} collection {name}")
        parts.append(p)
        socket_runs.append(r["graphql"])
    # hybrid: GraphQL against Collection.hybrid, phase 7's tie rule
    fiqa = st7["col"]
    hq = _fiqa_queries(seed + 9, st7["df"], True, SERVER_HYBRID)
    rng = np.random.default_rng([seed, 94])
    hv = near_queries(seed + 94, rng.integers(0, len(st7["ref"]), SERVER_HYBRID),
                      lambda r: st7["ref"][torch.from_numpy(r).to("cuda")].cpu().numpy(),
                      NEAR_NOISE)
    fusion_arg = {"relativeScore": "relativeScoreFusion", "rankedFusion": "rankedFusion"}
    hgql = ("query Q($v: [Float], $q: String, $a: Float) { Get { FiQA(limit: %d, "
            "hybrid: {query: $q, alpha: $a, vector: $v, fusionType: %s}) "
            "{ _additional { id score } } } }")

    def hyb_inproc(i):
        fusion, alpha = HYBRID_SETTINGS[i % 3]
        return [(r.uuid, r.score) for r in fiqa.hybrid(hq[i], vector=hv[i], alpha=alpha,
                                                       k=HYBRID_K, fusion=fusion)]

    href, lat, wall = _run_clients(hyb_inproc, SERVER_HYBRID)
    hparts = [f"{SERVER_HYBRID} hybrid(limit {HYBRID_K}) on phase 7's collection: in process "
              f"{_timed_text(lat, wall, SERVER_HYBRID)}"]

    def hyb_socket():
        def ask(i):
            fusion, alpha = HYBRID_SETTINGS[i % 3]
            rows_ = _gql(client, hgql % (HYBRID_K, fusion_arg[fusion]),
                         {"v": hv[i].tolist(), "q": hq[i], "a": alpha})
            return [(r["_additional"]["id"], r["_additional"]["score"]) for r in rows_]

        out, lat, wall = _run_clients(ask, SERVER_HYBRID)
        same = 0
        for i, (a, b) in enumerate(zip(href, out)):
            if not _same_answer(b, a):
                raise AssertionError(f"hybrid query {i}: GraphQL answer != in-process answer")
            same += a == b
        return (f"GraphQL over the socket {_timed_text(lat, wall, SERVER_HYBRID)}, "
                f"{same} identical, {SERVER_HYBRID - same} equal under phase 7's tie rule")

    K.reset_launch_counts()  # phase 9b's socket window starts here
    for p, fn in zip(parts, socket_runs):
        p.append(fn())
    hparts.append(hyb_socket())
    write_text = _server_writes(client, seed)
    counts = dict(K.launch_counts)  # ... and ends here
    log(f"phase 9b server ({time.perf_counter() - t0:.1f} s), quantized, hybrid and the "
        f"write path over 127.0.0.1 from {CLIENTS} client threads ({_smi_line()}): "
        + " | ".join("; ".join(p) for p in parts) + " | " + "; ".join(hparts)
        + f" | {write_text}; launches through the socket {counts}")
    _require_server_launches(counts, "9b")
    return counts


def _server_writes(client, seed: int) -> str:
    """WRITE_ROWS 768-d objects through POST /v1/batch/objects in batches
    of WRITE_BATCH; READ_BACK of them, chosen by seed, must come back from
    GET /v1/objects/{class}/{id} with the stored vector and first from a
    nearVector query on that vector."""
    name = "ServerWrites"
    client.create_class({"class": name, "vectorizer": "none", "vectorIndexType": "flat",
                         "vectorIndexConfig": {"distance": METRIC},
                         "properties": [{"name": "n", "dataType": ["int"]}]})
    rng = np.random.default_rng([seed, 95])
    vecs = rng.standard_normal((WRITE_ROWS, DIM)).astype(np.float32)
    ids = [_uuid(8009, i) for i in range(WRITE_ROWS)]
    # the request bodies are encoded before the clock starts: the rate is
    # the server's (JSON decoding, validation, batch_put), not the client's
    t0 = time.perf_counter()
    bodies = [json.dumps({"objects": [
        {"class": name, "id": ids[i], "properties": {"n": i}, "vector": vecs[i].tolist()}
        for i in range(s, min(WRITE_ROWS, s + WRITE_BATCH))]}).encode()
        for s in range(0, WRITE_ROWS, WRITE_BATCH)]
    encode_s = time.perf_counter() - t0
    host, port = client.addr.rsplit(":", 1)
    t0 = time.perf_counter()
    for body in bodies:
        conn = http.client.HTTPConnection(host, int(port), timeout=300)
        try:
            conn.request("POST", "/v1/batch/objects", body=body,
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            res = json.loads(resp.read())
        finally:
            conn.close()
        if resp.status != 200 or any(r["result"].get("status") != "SUCCESS" for r in res):
            raise AssertionError(f"batch import failed: {resp.status} {res if resp.status != 200 else res[0]}")
    import_s = time.perf_counter() - t0
    pick = rng.choice(WRITE_ROWS, READ_BACK, replace=False)

    def read(j):
        i = int(pick[j])
        got = client.request("GET", f"/v1/objects/{name}/{ids[i]}",
                             params={"include": "vector"})
        if not np.array_equal(np.asarray(got["vector"], np.float32), vecs[i]):
            raise AssertionError(f"object {ids[i]} read back another vector")
        rows = _gql(client, _near_gql(10, False) % name, {"v": vecs[i].tolist()})
        if rows[0]["_additional"]["id"] != ids[i]:
            raise AssertionError(f"nearVector on object {ids[i]}'s vector returned "
                                 f"{rows[0]['_additional']['id']} first")
        return True

    _out, lat, wall = _run_clients(read, READ_BACK)
    return (f"write path: {WRITE_ROWS} objects through POST /v1/batch/objects in batches of "
            f"{WRITE_BATCH} in {import_s:.1f} s ({WRITE_ROWS / import_s:.0f} objects/s; the "
            f"client encoded the bodies beforehand in {encode_s:.1f} s), {READ_BACK} read back with their vectors and found first by "
            f"nearVector ({_timed_text(lat, wall, READ_BACK)} per read + query)")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rows", type=int, default=ROWS,
                    help="corpus rows (default: the 1M of Performance768D1M)")
    ap.add_argument("--hybrid-docs", type=int, default=FIQA_DOCS,
                    help="phase 7's documents (default: FiQA-2018's 57,638)")
    ap.add_argument("--topk-times", action="store_true",
                    help="only build the kernels and time fused_topk_scan and "
                    "fused_topk_pairs at the drain shapes (no checks, no result line)")
    ap.add_argument("--bq-times", action="store_true",
                    help="only build the kernels, hold bq_scan_reduce to its plain version "
                    "(ragged shapes, the 1M-row shape, the prefix), time it at B = 1, 8, 64, "
                    "256 and on the prefix beside the _int_mm yardstick, and run the "
                    "single-bit wgmma probe (no result line)")
    ap.add_argument("--block-times", action="store_true",
                    help="only build the kernels, hold bq_mxu_block, pq4_recon_block, "
                    "pq4_lut_block and bm25_block to their plain versions, time them at the "
                    "main and dispatch shapes (the first two beside their product "
                    "yardsticks) and print the fused hybrid dispatch's split on a synthetic "
                    "index (no result line)")
    ap.add_argument("--dist-times", action="store_true",
                    help="only build the kernels and time distance_block, "
                    "pq4_scan_reduce and one approx batch (no checks, no result line)")
    ap.add_argument("--import-times", action="store_true",
                    help="only build the kernels and the native host library, then time "
                    "the FiQA-sized text import and a vector batch_put of --import-rows rows "
                    "with the library, without it (WEAVIATE_TPU_NO_NATIVE=1, a child "
                    "process) and with it again (no result line)")
    ap.add_argument("--import-rows", type=int, default=IMPORT_ROWS,
                    help="--import-times' vector rows (default 100,000)")
    ap.add_argument("--import-run", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.import_run:  # --import-times' child: one import run, its JSON line
        import torch

        print(json.dumps(import_run(torch, args.seed, args.hybrid_docs, args.rows)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: CUDA is not available; it needs an NVIDIA card",
              file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    from weaviate_tpu_torch.ops import kernels as K

    from weaviate_tpu_torch.db import Database

    t0 = time.perf_counter()
    device = phase_card(torch)
    phase_build(K)
    if args.topk_times:
        X = scan_corpus(torch, args.seed)
        rng = np.random.default_rng([args.seed, 2])
        vmask = torch.from_numpy(rng.random(X.shape[0]) > 0.01).to("cuda")
        qs = torch.from_numpy(near_queries(args.seed, rng.integers(0, ROWS, BATCH), lambda r: X[
            torch.from_numpy(r).to("cuda")].cpu().numpy())).to("cuda")
        for part in topk_times(torch, K, X, vmask, qs, Timer(torch)):
            log(f"topk times: {part}")
        if hasattr(K, "kernel_residency"):  # the product-only build is this design's
            for part in scan_breakdown(torch, K, X, qs, Timer(torch)):
                log(f"topk times: {part}")
        log(f"card after (SM clock, max SM clock, power, temperature): {card_clocks()}")
        return 0
    if args.bq_times:
        # random words: the kernel's time does not follow the values
        gen = torch.Generator(device="cuda").manual_seed(args.seed)
        xw = torch.randint(-2 ** 31, 2 ** 31 - 1, (1 << 20, 24), dtype=torch.int32,
                           device="cuda", generator=gen)
        qw = torch.randint(-2 ** 31, 2 ** 31 - 1, (BATCH, 24), dtype=torch.int32,
                           device="cuda", generator=gen)
        vmask = torch.rand(1 << 20, device="cuda", generator=gen) > 0.01
        rng = np.random.default_rng([args.seed, 2])
        L = 64
        _same_scan(torch, K.bq_scan_reduce(qw, xw, vmask, L), K.bq_scan_reduce_plain(qw, xw, vmask, L),
                   "bq_scan_reduce main shape")
        pt = xw[:, :4].T.contiguous()
        _same_scan(torch, K.bq_scan_reduce(qw[:, :4].contiguous(), pt, vmask, L, transposed=True),
                   K.bq_scan_reduce_plain(qw[:, :4].contiguous(), pt, vmask, L, transposed=True),
                   "bq_scan_reduce prefix")
        del pt
        log(f"bq times: equal to the plain version at {bq_ragged_checks(torch, K, rng, 'cuda')} "
            "ragged shapes, the main shape and the prefix")
        for part in bq_times(torch, K, qw, xw, vmask, Timer(torch)) + bq_probe(torch):
            log(f"bq times: {part}")
        log(f"card after (SM clock, max SM clock, power, temperature): {card_clocks()}")
        return 0
    if args.block_times:
        for part in block_times(torch, K, args.seed, Timer(torch)):
            log(f"block times: {part}")
        log(f"card after (SM clock, max SM clock, power, temperature): {card_clocks()}")
        return 0
    if args.dist_times:
        for part in dist_times(torch, K, args.seed, Timer(torch)):
            log(f"dist times: {part}")
        log(f"card after (SM clock, max SM clock, power, temperature): {card_clocks()}")
        return 0
    if args.import_times:
        for part in import_times(torch, args.seed, args.hybrid_docs, args.import_rows):
            log(f"import times: {part}")
        log(f"card after (SM clock, max SM clock, power, temperature): {card_clocks()}")
        return 0
    numbers, counts2 = phase_kernels(torch, K, args.seed)
    log(f"card after phase 2 (SM clock, max SM clock, power, temperature): {card_clocks()}")
    phase_index(torch, args.seed, args.rows)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    db = srv = None
    try:
        db = Database(tmp, device="cuda")
        # each path counts its own launches: phase 4 the plain one, phase 5
        # the quantized index, phase 6 the quantized collections, phase 7
        # hybrid, phase 9a/9b the server's socket runs (the server serves
        # phase 4's database from here on; 9a runs before phase 6
        # compresses its collection)
        counts4, st4 = phase_end_to_end(torch, K, args.seed, args.rows, db)
        srv = start_server(db)
        counts9a = phase_server_plain(torch, K, args.seed, srv, st4)
        counts5 = phase_quantized_index(torch, K, args.seed, args.rows)
        counts6 = phase_quantized_end_to_end(torch, K, args.seed, db, st4)
        counts7, st7 = phase_hybrid(torch, K, args.seed, db, args.hybrid_docs)
        counts9b = phase_server_rest(torch, K, args.seed, srv, db, st7, args.rows)
    finally:
        if srv is not None:
            srv.stop()
        if db is not None:
            db.close()
        shutil.rmtree(tmp, ignore_errors=True)
    counts8 = phase_conformance(K)
    kernels = []
    for name, (source, replaces) in KERNEL_SOURCES.items():
        # launches over the main paths: phases 4, 5, 6, 7, 8 and the
        # server's 9a and 9b, and phase 2's window for the two kernels that
        # no path runs
        launches = sum(c[name] for c in (counts4, counts5, counts6, counts7, counts8,
                                         counts9a, counts9b))
        if name in PHASE2_PATH:
            launches += counts2[name]
        kernels.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                            launches=launches, **numbers[name]))
    log(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:  # noqa: BLE001 — any failed phase fails the run
        traceback.print_exc()
        print("chip_smoke.py: FAILED", file=sys.stderr)
        sys.exit(1)
