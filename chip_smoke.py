#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``weaviate_tpu_torch``) on one
NVIDIA card.

Run from the repository root:  python3 chip_smoke.py [--seed N] [--rows N]

It drives the port's flat nearVector path at VectorDBBench's
Performance768D1M case (Cohere wiki-22-12: 1,000,000 x 768, cosine,
top-k 100), with clustered Gaussian vectors made from ``--seed`` (nothing
is downloaded), in phases:

0. card: name and power limit (nvidia-smi), torch and CUDA versions;
1. build: compiles every kernel in weaviate_tpu_torch/csrc with nvcc;
2. kernels: each CUDA kernel against its plain PyTorch version on the
   card, at the main path's shapes, with timings and bounds;
3. index: FlatIndex on the card, 1M rows, 1,024 queries through the
   async batch entry point for selection "approx" (distance_block per
   8192-row chunk) and "fused" (fused_topk_scan + fused_topk_pairs),
   held to an exact plain recomputation (recall@10 / @100 must be 1.0),
   plus per-query filters (bitmask path) and a shared 0.5% filter
   (gathered path);
4. end to end: Database -> Collection.batch_put -> 8 client threads of
   near_vector through the shard's query batcher, held to the serial path
   and to the plain recomputation, then deletes and queries again. The
   kernels' launch counters are reset just before this phase and read
   just after it;
5. quantized index: the same corpus in a BQ FlatIndex, a BQ FlatIndex
   with a 128-bit sign prefix (two-stage scan) and a flat index that
   ``compress("pq")`` turns into 4-bit PQ on the card, 1,024 queries
   each at k=10 and k=100 (selection "approx") and k=10 ("fused"), plus
   per-query 10% filters; every returned id must carry its exact
   distance, deleted and disallowed ids never surface, recall@10 against
   the exact recomputation must reach the floor in RECALL_FLOOR (it also
   prints what rescore_limit 1 reads, a path without oversampling);
6. quantized end to end: ``Database.update_collection`` turns PQ on for
   phase 4's live collection and 8 client threads query it near its rows;
   then a second collection is created with BQ in its schema, loaded
   through batch_put and queried the same way. Each quantized collection
   is held to the serial path, to exact distances and to RECALL_FLOOR.

Phases 5 and 6 each reset the launch counters as they start and read them
as they end: every kernel in QUANT_KERNELS must have run there.

It prints one line per phase, then a JSON line of per-kernel numbers, and
as its last line ``{"ok": true, "device": {...}}``. Any failure exits
non-zero without that line. Without CUDA it exits 2 at once.
"""

from __future__ import annotations

import argparse
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
CLIENTS, CALLS = 8, 64
PLAIN_CALLS = 32  # phase 4 at half the calls, to keep the script near 600 s
VIEWS_CUT = 90           # where(views >= 90) keeps 10% of the 0..99 values
DELETES, REQUERIES = 1000, 64

# H100 SXM published peaks (NVIDIA data sheet, dense, 700 W)
FP32_FLOPS = 67e12
BF16_FLOPS = 989e12
HBM_BYTES_S = 3.35e12

RTOL, ATOL = 2e-4, 2e-3  # the reference's kernel tolerance (f32)
TIE_TOL = 1e-5           # distances closer than this are a tie
INT8_OPS = 1979e12
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
}
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


def phase_build() -> None:
    from weaviate_tpu_torch.ops import _build

    secs = _build.build_all()
    regs = []
    for name in _build.SIGNATURES:
        with open(_build.log_path(name)) as f:
            text = f.read()
        used = [int(t.split()[0]) for t in text.split("Used ")[1:]]
        # ptxas prints one line per instantiation: any non-zero one spills
        spills = [int(b) for b in re.findall(r"(\d+) bytes spill (?:stores|loads)", text)]
        regs.append(f"{name} max {max(used) if used else '?'} registers"
                    f"{' (spills)' if any(spills) else ''}")
    log(f"phase 1 build: {secs:.1f} s for {len(_build.SIGNATURES)} kernels "
        f"(nvcc sm_90a, in parallel); {'; '.join(regs)}")


def phase_kernels(torch, K, seed: int) -> dict:
    """Each kernel against its plain version at the main path's shapes."""
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
    one = torch.ones((), device=dev)
    qn = torch.nn.functional.normalize(q, dim=1)
    b_ms, b_by = bound_ms(q.numel() * 4 + xn.numel() * 4 + CHUNK + BATCH * CHUNK * 4,
                          2.0 * BATCH * CHUNK * DIM, FP32_FLOPS)
    out["distance_block"] = dict(
        max_abs_err=err,
        ms=timer(lambda: K.distance_block(q, xn, METRIC, valid=valid), reps=50),
        plain_ms=timer(lambda: K.distance_block_plain(q, xn, METRIC, valid=valid), reps=50),
        library_ms=timer(lambda: torch.addmm(one, qn, xn.T, alpha=-1.0), reps=50),
        bound_ms=b_ms, bound_by=b_by)
    log(f"phase 2 kernels: distance_block q[{BATCH},{DIM}] x [{CHUNK},{DIM}] "
        f"l2/dot/cosine x f32/bf16 with valid mask: max_abs_err {err:.3g} "
        f"(rtol {RTOL}, atol {ATOL}); kernel {out['distance_block']['ms']:.4f} ms, "
        f"plain {out['distance_block']['plain_ms']:.4f} ms, "
        f"addmm {out['distance_block']['library_ms']:.4f} ms, "
        f"{_bound_text(out['distance_block'])}")

    # fused_topk_scan at the full capacity of the 1M-row store
    n = 1 << 20
    X = torch.empty((n, DIM), dtype=torch.float32, device=dev)
    for s in range(0, n, ADD_BATCH):
        X[s:s + ADD_BATCH] = torch.nn.functional.normalize(
            to_dev(clustered(seed, s, ADD_BATCH, cent)), dim=1)
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
    b_ms, b_by = bound_ms(X.numel() * 4 + qs.numel() * 4 + n + BATCH * TOP_K * 8,
                          2.0 * BATCH * n * DIM, FP32_FLOPS)
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
    out.update(_scan_reduce_kernels(torch, K, X, qs, vmask, bits, rng, timer))
    del X, allow, bits, vmask, bias
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
    # every value read once, the k winners' ids gathered, [B, k] (f32, i32) written
    b_ms, b_by = bound_ms(BATCH * m * 4 + BATCH * TOP_K * (4 + 8), BATCH * m, FP32_FLOPS)
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
    return out


def _same_scan(torch, a, b, what) -> float:
    """Scan-reduce outputs must be equal: vals everywhere, ids wherever
    the slot is live (the ids of masked slots are never read)."""
    from weaviate_tpu_torch.ops.distances import MASKED_DISTANCE

    (av, ai), (bv, bi) = a, b
    live = bv < MASKED_DISTANCE
    if not (torch.equal(av, bv) and torch.equal(ai[live], bi[live])):
        raise AssertionError(f"{what}: kernel disagrees with its plain version")
    return (av - bv).abs().max().item()


def _scan_reduce_kernels(torch, K, X, qs, vmask, bits, rng, timer) -> dict:
    """bq_scan_reduce and pq4_scan_reduce against their plain versions on
    the card: ragged shapes first, then the main path's (the 1M-row
    corpus X as sign words and as 4-bit PQ codes, with and without the
    per-query allow bits, and the two-stage scan's transposed prefix).
    Equality is exact: the arithmetic is integer, and the one f32
    division by the query's scale is exact in IEEE."""
    from weaviate_tpu_torch.ops import bq as bq_ops
    from weaviate_tpu_torch.ops import pq as pq_ops

    dev = X.device
    n = X.shape[0]
    out = {}

    def words(shape):
        return torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, shape, dtype=np.int64)
                                .astype(np.int32)).to(dev)

    def allow_of(b, rows):
        return K.pack_allow_bitmask_t(torch.from_numpy(rng.random((b, rows)) < 0.5).to(dev))

    # ragged: B, N and W / m off every tile size, both layouts, masks
    ragged = 0
    for b, rows, w, L, tp, masked in [(1, 1, 1, 4, False, False), (7, 130, 3, 4, False, False),
                                      (33, 2001, 4, 8, True, False), (40, 9001, 24, 64, False, True),
                                      (70, 3000, 4, 2, True, True), (5, 5000, 25, 16, False, True)]:
        q, x = words((b, w)), words((w, rows) if tp else (rows, w))
        valid = torch.from_numpy(rng.random(rows) > 0.3).to(dev)
        ab = allow_of(b, rows) if masked else None
        _same_scan(torch, K.bq_scan_reduce(q, x, valid, L, tp, allow_bits=ab),
                   K.bq_scan_reduce_plain(q, x, valid, L, tp, allow_bits=ab),
                   f"bq_scan_reduce ragged b={b} n={rows} w={w} transposed={tp}")
        ragged += 1
    for b, rows, m, kc, L, tp, masked in [(1, 1, 1, 16, 4, False, False),
                                          (7, 130, 8, 12, 4, False, False),
                                          (17, 2001, 12, 16, 8, True, True),
                                          (20, 9001, 24, 16, 64, False, True),
                                          (33, 5000, 33, 16, 16, False, False),
                                          (5, 4000, 192, 9, 32, True, False)]:
        lut = torch.from_numpy((rng.standard_normal((b, m, kc)) * 3).astype(np.float32)).to(dev)
        codes = rng.integers(0, kc, (rows, m)).astype(np.uint8)
        c = torch.from_numpy(np.ascontiguousarray(codes.T) if tp else codes).to(dev)
        valid = torch.from_numpy(rng.random(rows) > 0.3).to(dev)
        ab = allow_of(b, rows) if masked else None
        _same_scan(torch, K.pq4_scan_reduce(lut, c, valid, L, tp, allow_bits=ab),
                   K.pq4_scan_reduce_plain(lut, c, valid, L, tp, allow_bits=ab),
                   f"pq4_scan_reduce ragged b={b} n={rows} m={m} kc={kc} transposed={tp}")
        ragged += 1

    # the main path's shapes: [256, 24 words] x 1,048,576 rows, reduce_l 64
    L = bq_ops._auto_reduce_l(n)
    xw = torch.cat([bq_ops.bq_encode(X[s:s + ADD_BATCH]) for s in range(0, n, ADD_BATCH)])
    qw = bq_ops.bq_encode(qs)
    err = 0.0
    for ab in (None, bits):
        err = max(err, _same_scan(torch, K.bq_scan_reduce(qw, xw, vmask, L, allow_bits=ab),
                                  K.bq_scan_reduce_plain(qw, xw, vmask, L, allow_bits=ab),
                                  f"bq_scan_reduce [{BATCH},{qw.shape[1]}] x [{n}]"))
    qp, pt = qw[:, :4].contiguous(), xw[:, :4].T.contiguous()  # the 128-bit prefix
    for ab in (None, bits):
        err = max(err, _same_scan(
            torch, K.bq_scan_reduce(qp, pt, vmask, L, transposed=True, allow_bits=ab),
            K.bq_scan_reduce_plain(qp, pt, vmask, L, transposed=True, allow_bits=ab),
            f"bq_scan_reduce prefix [4,{n}]"))
    w = qw.shape[1]
    # bytes: words, valid and both outputs once; operations: the reference
    # kernel's cost estimate (the +-1 int8 product, 2*B*N*32W)
    b_ms, b_by = bound_ms(qw.numel() * 4 + xw.numel() * 4 + n + BATCH * (n // L) * 8,
                          2.0 * BATCH * n * 32 * w, INT8_OPS)
    prefix_ms = timer(lambda: K.bq_scan_reduce(qp, pt, vmask, L, transposed=True), reps=10)
    out["bq_scan_reduce"] = dict(
        max_abs_err=err,
        ms=timer(lambda: K.bq_scan_reduce(qw, xw, vmask, L), reps=10),
        plain_ms=timer(lambda: K.bq_scan_reduce_plain(qw, xw, vmask, L), reps=1, warmup=1),
        library_ms=None, bound_ms=b_ms, bound_by=b_by)
    o = out["bq_scan_reduce"]
    log(f"phase 2 kernels: bq_scan_reduce {ragged // 2} ragged shapes, then "
        f"[{BATCH},{w} words] x [{n},{w}] reduce_l {L} with and without per-query "
        f"allow_bits, and the transposed prefix [4,{n}]: equal to the plain version "
        f"(max_abs_err {err:.3g}); kernel {o['ms']:.3f} ms (prefix {prefix_ms:.3f} ms), "
        f"plain {o['plain_ms']:.3f} ms, library {NO_LIBRARY}, {_bound_text(o)}")
    del xw, pt

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
    log(f"phase 2 kernels: pq4_scan_reduce {ragged - ragged // 2} ragged shapes, then "
        f"lut [{BATCH},{m},16] x codes [{n},{m}] reduce_l {L} with and without per-query "
        f"allow_bits: equal to the plain version (max_abs_err {err:.3g}); kernel "
        f"{o['ms']:.3f} ms (int8 LUT quantization included), plain {o['plain_ms']:.3f} ms, "
        f"library {NO_LIBRARY}, {_bound_text(o)}")
    return out


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
        f"({done / import_s:.0f} objects/s); serial path {nq} near_vector(k=10) in "
        f"{timings['serial']:.1f} s; {CLIENTS} clients x {PLAIN_CALLS} near_vector(k=10), "
        f"half where(views >= {VIEWS_CUT}, values 0..99): "
        + "; ".join(stats)
        + f"; equal to the serial path and recall@10 1.0 vs the plain recomputation; "
        f"{batcher.dispatches} batched dispatches for {batcher.batched_queries} "
        f"queries ({batcher.async_dispatches} async); {DELETES} deleted in "
        f"{timings['deletes']:.1f} s, {REQUERIES} queries per selection again, none "
        f"returned; launches {counts}")
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
            runs.append(f"{selection} k={k}: recall@{k} {r:.4f}, {t_med:.1f} ms per "
                        f"{BATCH}-query batch, scan {s_med:.1f} ms ({s_med / t_med:.0%})")
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rows", type=int, default=ROWS,
                    help="corpus rows (default: the 1M of Performance768D1M)")
    args = ap.parse_args()
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
    phase_build()
    numbers = phase_kernels(torch, K, args.seed)
    log(f"card after phase 2 (SM clock, max SM clock, power, temperature): {card_clocks()}")
    phase_index(torch, args.seed, args.rows)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    db = None
    try:
        db = Database(tmp, device="cuda")
        # each path counts its own launches: phase 4 the plain one, phase 5
        # the quantized index, phase 6 the quantized collections
        counts4, st4 = phase_end_to_end(torch, K, args.seed, args.rows, db)
        counts5 = phase_quantized_index(torch, K, args.seed, args.rows)
        counts6 = phase_quantized_end_to_end(torch, K, args.seed, db, st4)
    finally:
        if db is not None:
            db.close()
        shutil.rmtree(tmp, ignore_errors=True)
    kernels = []
    for name, (source, replaces) in KERNEL_SOURCES.items():
        # launches over the three main paths: phases 4, 5 and 6
        kernels.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                            launches=counts4[name] + counts5[name] + counts6[name],
                            **numbers[name]))
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
