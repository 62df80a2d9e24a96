"""The plain reference and the comparison that decides ``correct``.

Exact cosine distances (1 - cos) in float64 from the seeded vectors, in
blocks of rows, with the filter applied as a mask over the rows; the
exact top-k of every query. Plain PyTorch: nothing of the program, of
``jax`` or of the JAX package is imported, and nothing the program made
(its normalized rows, codes or doc ids) is read. The served answers are
judged by what they say: each returned uuid must name a row that exists
and passes the filter, once, with a distance that matches the exact
distance of that row, in order, and (on an exact path) be one of the
exact top k.

The control puts the reference in the program's place one precision
below the configuration's float32: the same top-k with the products in
TF32 (``allow_tf32`` on the card; the inputs rounded to TF32's 10-bit
mantissa elsewhere).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

BLOCK_ROWS = 65536


def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def unit(a: torch.Tensor) -> torch.Tensor:
    return a / a.norm(dim=-1, keepdim=True)


def allowed_rows(keys: np.ndarray, flt: dict | None) -> np.ndarray:
    """Bool mask of the rows that pass the traffic's filter."""
    if flt is None:
        return np.ones(len(keys), bool)
    v = flt["value"]
    op = flt["operator"]
    if op == "GreaterThanEqual":
        return keys >= v
    if op == "LessThan":
        return keys < v
    if op == "Equal":
        return keys == v
    raise ValueError(f"unknown filter operator {op!r}")


def exact_topk(vectors: np.ndarray, queries: np.ndarray, k: int,
               allow: np.ndarray, device: str):
    """(distances f64 [nq, k'], rows int64 [nq, k']) of the exact top
    k' = min(k, allowed rows), nearest first."""
    _no_tf32()
    q = unit(torch.from_numpy(queries).to(device, torch.float64))
    rows = np.flatnonzero(allow)
    kk = min(k, len(rows))
    best_d = torch.full((len(queries), 0), float("inf"), dtype=torch.float64,
                        device=device)
    best_i = torch.empty((len(queries), 0), dtype=torch.int64, device=device)
    for s in range(0, len(rows), BLOCK_ROWS):
        r = torch.from_numpy(rows[s:s + BLOCK_ROWS]).to(device)
        x = unit(torch.from_numpy(vectors[rows[s:s + BLOCK_ROWS]]).to(
            device, torch.float64))
        d = 1.0 - q @ x.T
        cat_d = torch.cat([best_d, d], 1)
        cat_i = torch.cat([best_i, r.expand(len(queries), -1)], 1)
        best_d, pos = torch.topk(cat_d, min(kk, cat_d.shape[1]), dim=1,
                                 largest=False, sorted=True)
        best_i = torch.gather(cat_i, 1, pos)
    return best_d.cpu().numpy(), best_i.cpu().numpy()


def _round_tf32(a: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 explicit mantissa bits (to nearest)."""
    bits = a.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def control_topk(vectors: np.ndarray, queries: np.ndarray, k: int,
                 allow: np.ndarray, device: str):
    """The reference one precision below float32: unit rows in float32,
    products in TF32, the distances it ranks by as its answer."""
    q = unit(torch.from_numpy(queries).to(device, torch.float32))
    rows = np.flatnonzero(allow)
    kk = min(k, len(rows))
    on_card = torch.device(device).type == "cuda"
    if not on_card:
        q = _round_tf32(q)
    best_d = torch.full((len(queries), 0), float("inf"), device=device)
    best_i = torch.empty((len(queries), 0), dtype=torch.int64, device=device)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        for s in range(0, len(rows), BLOCK_ROWS):
            r = torch.from_numpy(rows[s:s + BLOCK_ROWS]).to(device)
            x = unit(torch.from_numpy(vectors[rows[s:s + BLOCK_ROWS]]).to(device))
            if not on_card:
                x = _round_tf32(x)
            d = 1.0 - q @ x.T
            cat_d = torch.cat([best_d, d], 1)
            cat_i = torch.cat([best_i, r.expand(len(queries), -1)], 1)
            best_d, pos = torch.topk(cat_d, min(kk, cat_d.shape[1]), dim=1,
                                     largest=False, sorted=True)
            best_i = torch.gather(cat_i, 1, pos)
    finally:
        _no_tf32()
    return best_d.cpu().numpy(), best_i.cpu().numpy()


@dataclass
class Answer:
    """One distinct list of uuids returned for one query, how many replies
    gave it, and position by position the least (``dists``) and the
    greatest (``dists_max``, where they differ) distance they gave."""
    query: int
    count: int
    uuids: list[str]
    dists: np.ndarray  # float32
    dists_max: np.ndarray | None = None


@dataclass
class Verdict:
    checks: dict = field(default_factory=dict)  # name -> (value, limit)
    recall: float = 0.0          # mean over every reply
    answers: int = 0             # replies judged
    distinct: int = 0            # distinct (query, reply) pairs judged

    @property
    def correct(self) -> bool:
        return all(v <= lim for v, lim in self.checks.values())


def judge(answers: list[Answer], vectors: np.ndarray, queries: np.ndarray,
          uuid_row: dict, allow: np.ndarray, k: int, gap_limit: float,
          exact: bool, failed: int, device: str, unordered: int = 0,
          shortfall_limit: float | None = None) -> Verdict:
    """Every distinct reply against the reference. ``gap_limit`` bounds
    |served - exact| distance and is the tie tolerance at the k-th place;
    ``exact``: the path promises the exact top k (every result is held to
    it); ``shortfall_limit``: where the path does not, 1 - recall is held
    to it; ``unordered``: replies whose distances fell or were NaN,
    counted as they came."""
    _no_tf32()
    ref_d, _ = exact_topk(vectors, queries, k, allow, device)
    kth = ref_d[:, -1]
    want = ref_d.shape[1]
    q = unit(torch.from_numpy(queries).to(device, torch.float64))
    bad = missed = 0
    gap = 0.0
    hits_w = replies = 0
    for a in answers:
        rows = [uuid_row.get(u, -1) for u in a.uuids]
        seen = set()
        ok = []
        for j, r in enumerate(rows):
            if r < 0 or r in seen or not allow[r]:
                bad += a.count
                continue
            seen.add(r)
            ok.append(j)
        if len(rows) != want:
            bad += abs(want - len(rows)) * a.count
        if a.dists_max is None and len(a.dists) > 1:
            bad += int((np.diff(a.dists) < 0).sum()) * a.count
        hits = 0
        if ok:
            rr = np.asarray([rows[j] for j in ok])
            x = unit(torch.from_numpy(vectors[rr]).to(device, torch.float64))
            ex = (1.0 - x @ q[a.query]).cpu().numpy()
            lo = a.dists[ok].astype(np.float64)
            hi = lo if a.dists_max is None else a.dists_max[ok].astype(np.float64)
            diff = np.maximum(np.abs(lo - ex), np.abs(hi - ex))
            finite = np.isfinite(diff)
            bad += int((~finite).sum()) * a.count
            if finite.any():
                gap = max(gap, float(diff[finite].max()))
            inside = (ex <= kth[a.query] + gap_limit) & finite
            hits = int(inside.sum())
            missed += (len(ok) - hits) * a.count
        hits_w += hits * a.count
        replies += a.count
    v = Verdict(answers=replies, distinct=len(answers))
    v.recall = hits_w / (replies * want) if replies and want else 0.0
    v.checks["failed"] = (failed, 0)
    v.checks["no_reply"] = (0 if replies else 1, 0)
    v.checks["bad_results"] = (bad + unordered, 0)
    v.checks["max_dist_gap"] = (gap, gap_limit)
    if exact:
        v.checks["missed_exact"] = (missed, 0)
    if shortfall_limit is not None:
        v.checks["recall_shortfall"] = (1.0 - v.recall, shortfall_limit)
    return v
