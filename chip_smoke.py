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
   just after it.

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
VIEWS_CUT = 90           # where(views >= 90) keeps 10% of the 0..99 values
DELETES, REQUERIES = 1000, 64

# H100 SXM published peaks (NVIDIA data sheet, dense, 700 W)
FP32_FLOPS = 67e12
BF16_FLOPS = 989e12
HBM_BYTES_S = 3.35e12

RTOL, ATOL = 2e-4, 2e-3  # the reference's kernel tolerance (f32)
TIE_TOL = 1e-5           # distances closer than this are a tie
KERNEL_SOURCES = {
    "distance_block": ("weaviate_tpu_torch/csrc/distance_block.cu",
                       "weaviate_tpu/ops/pallas_kernels.py:281"),
    "fused_topk_scan": ("weaviate_tpu_torch/csrc/fused_topk_scan.cu",
                        "weaviate_tpu/ops/pallas_kernels.py:851"),
    "fused_topk_pairs": ("weaviate_tpu_torch/csrc/fused_topk_pairs.cu",
                         "weaviate_tpu/ops/pallas_kernels.py:992"),
}


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


def near_queries(seed: int, rows: np.ndarray, corpus_fn) -> np.ndarray:
    """Queries next to given corpus rows."""
    rng = np.random.default_rng([seed, 1 << 41])
    base = corpus_fn(rows)
    return base + 0.3 * rng.standard_normal(base.shape, dtype=np.float32)


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


# -- phases -------------------------------------------------------------------

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
        f"addmm {out['distance_block']['library_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by})")

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
        f"addmm+topk {out['fused_topk_scan']['library_ms']:.3f} ms, bound {b_ms:.3f} ms ({b_by})")
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
        f"{out['fused_topk_pairs']['library_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
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


def phase_end_to_end(torch, K, seed: int, rows: int) -> dict:
    from weaviate_tpu_torch.db import Database
    from weaviate_tpu_torch.filters import Filter, Operator
    from weaviate_tpu_torch.schema.config import (CollectionConfig, Property,
                                                  VectorConfig, VectorIndexConfig)

    dev = "cuda"
    cent = centers(seed + 1)
    rng = np.random.default_rng([seed, 4])
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    db = Database(tmp, device=dev)
    try:
        col = db.create_collection(CollectionConfig(
            name="Wiki",
            properties=[Property(name="category", data_type="text"),
                        Property(name="views", data_type="int")],
            vectors=[VectorConfig(index=VectorIndexConfig(
                index_type="flat", metric=METRIC))]))
        ref = torch.empty((rows, DIM), dtype=torch.float32, device=dev)
        views = np.empty(rows, dtype=np.int64)
        t0 = time.perf_counter()
        done = 0
        while done < rows and time.perf_counter() - t0 < IMPORT_BUDGET_S:
            n = min(IMPORT_BATCH, rows - done)
            v = clustered(seed + 1, done, n, cent)
            vw = rng.integers(0, 100, n)
            res = col.batch_put([
                {"uuid": f"00000000-0000-4000-8000-{done + i:012d}",
                 "properties": {"category": f"cat{(done + i) % 100}", "views": int(vw[i])},
                 "vector": v[i]} for i in range(n)])
            if any(r["status"] != "SUCCESS" for r in res):
                raise AssertionError(f"batch_put failed: {res[0]}")
            ref[done:done + n] = torch.nn.functional.normalize(
                torch.from_numpy(v).to(dev), dim=1)
            views[done:done + n] = vw
            done += n
        import_s = time.perf_counter() - t0
        cut = "" if done == rows else (
            f" (cut from {rows}: the import budget of {IMPORT_BUDGET_S:.0f} s ran out)")
        ref = ref[:done]
        if col.object_count() != done:
            raise AssertionError(f"object_count {col.object_count()} != {done}")
        shard = next(iter(col.shards.values()))
        idx = shard.vector_indexes[""]
        live = torch.ones(done, dtype=torch.bool, device=dev)
        views_t = torch.from_numpy(views[:done]).to(dev)
        nq = CLIENTS * CALLS
        queries = near_queries(seed + 1, rng.integers(0, done, nq),
                               lambda r: ref[torch.from_numpy(r).to(dev)].cpu().numpy())
        qn = torch.nn.functional.normalize(torch.from_numpy(queries).to(dev), dim=1)
        where = Filter.where("views", Operator.GREATER_THAN_EQUAL, VIEWS_CUT)

        def ask(i):
            return col.near_vector(queries[i], k=10, where=where if i % 2 else None,
                                   include_objects=False)

        def row_of(r):
            return int(r.uuid.rsplit("-", 1)[1])

        def check_exact(results, what):
            """results[i] answers query i; odd queries carry the filter."""
            n_res = len(results)
            odd = torch.arange(n_res, device=dev)[:, None] % 2 == 1
            mask = live[None, :] & (~odd | (views_t[None, :] >= VIEWS_CUT))
            for s in range(0, n_res, BATCH):
                d_full = _exact_distances(torch, qn[s:min(s + BATCH, n_res)], ref,
                                          mask[s:s + BATCH])
                got = [[row_of(r) for r in res] for res in results[s:s + BATCH]]
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
            for a, b in zip(serial, out):
                if [r.uuid for r in a] != [r.uuid for r in b]:
                    raise AssertionError(f"{selection}: concurrent result != serial path")
            check_exact(out, f"end to end {selection}")
            lat_u, lat_f = np.asarray(lat[0::2]), np.asarray(lat[1::2])
            stats.append(
                f"{selection}: {nq / wall:.1f} QPS, p50 {np.percentile(lat, 50):.1f} ms, "
                f"p99 {np.percentile(lat, 99):.1f} ms (unfiltered p50 "
                f"{np.percentile(lat_u, 50):.1f} ms, filtered p50 {np.percentile(lat_f, 50):.1f} ms)")
        batcher = shard._query_batchers[""]
        # deletes, then queries again through the batcher, both selections
        gone = rng.choice(done, DELETES, replace=False)
        t1 = time.perf_counter()
        for r in gone:
            if not col.delete_object(f"00000000-0000-4000-8000-{int(r):012d}"):
                raise AssertionError("delete_object returned False")
        timings["deletes"] = time.perf_counter() - t1
        live[torch.from_numpy(gone).to(dev)] = False
        gone_set = set(gone.tolist())
        for selection in ("approx", "fused"):
            idx.store.selection = selection
            again = [ask(i) for i in range(REQUERIES)]
            if any(row_of(r) in gone_set for res in again for r in res):
                raise AssertionError("a deleted object was returned")
            check_exact(again, f"after deletes {selection}")
        counts = dict(K.launch_counts)  # ... and ends here
        log(f"phase 4 end to end: Database(device='cuda') flat {METRIC} collection, "
            f"batch_put {done} objects{cut} in {import_s:.1f} s "
            f"({done / import_s:.0f} objects/s); serial path {nq} near_vector(k=10) in "
            f"{timings['serial']:.1f} s; {CLIENTS} clients x {CALLS} near_vector(k=10), "
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
        return counts
    finally:
        db.close()
        shutil.rmtree(tmp, ignore_errors=True)


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

    t0 = time.perf_counter()
    device = phase_card(torch)
    phase_build()
    numbers = phase_kernels(torch, K, args.seed)
    phase_index(torch, args.seed, args.rows)
    counts = phase_end_to_end(torch, K, args.seed, args.rows)
    kernels = []
    for name, (source, replaces) in KERNEL_SOURCES.items():
        kernels.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                            launches=counts[name], **numbers[name]))
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
