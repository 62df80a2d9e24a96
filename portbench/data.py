"""The seeded corpus, keys, uuids and query set of a cell.

A clustered mixture: ``clusters`` centres drawn from N(0, 1) and each row
its centre plus Gaussian noise of a per-row scale in [0.3, 1.2], so that
neighbours are spread and not tied (the generator ``chip_smoke.py``'s
``centers`` / ``clustered`` use, redrawn here with a ``torch.Generator``
so that 250,000 x 768 rows take the card a fraction of a second). The
queries are held-out draws from the same mixture, not copies of corpus
rows. Each row carries an integer ``key``: a seeded sample without
replacement of ``range(key_space)``, the share of the source's keys that
hash sharding would place on this node.

Imports nothing of the program: the reference reads the same arrays.
"""

from __future__ import annotations

import uuid as uuid_mod
from dataclasses import dataclass

import numpy as np
import torch

SCALE_LO, SCALE_HI = 0.3, 1.2
DRAW_ROWS = 65536  # rows drawn on the device in one call


@dataclass
class Dataset:
    vectors: np.ndarray   # float32 [rows, dim], as imported (not normalized)
    keys: np.ndarray      # int64 [rows]
    uuids: list[str]      # [rows]
    queries: np.ndarray   # float32 [n_queries, dim]


def _seed64(seed: int, stream: int) -> int:
    """A 63-bit seed for one stream of one run: any whole ``seed``."""
    return (int(seed) * 0x9E3779B97F4A7C15 + stream * 0xBF58476D1CE4E5B9) % (1 << 63)


def make_dataset(seed: int, rows: int, dim: int, n_queries: int,
                 key_space: int, clusters: int, device: str = "cpu") -> Dataset:
    """The cell's data from ``seed``; the same seed and device give the
    same arrays. Rows are drawn on ``device`` in blocks and kept on the
    host, where the import and the reference read them."""
    if rows > key_space:
        raise ValueError(f"{rows} rows need distinct keys from {key_space}")
    g = torch.Generator(device=device)
    g.manual_seed(_seed64(seed, 1))
    cent = torch.randn(clusters, dim, generator=g, device=device)

    def draw(n: int) -> np.ndarray:
        out = np.empty((n, dim), np.float32)
        for s in range(0, n, DRAW_ROWS):
            m = min(DRAW_ROWS, n - s)
            assign = torch.randint(0, clusters, (m,), generator=g, device=device)
            scale = torch.empty(m, 1, device=device).uniform_(
                SCALE_LO, SCALE_HI, generator=g)
            noise = torch.randn(m, dim, generator=g, device=device)
            out[s:s + m] = (cent[assign] + scale * noise).cpu().numpy()
        return out

    vectors = draw(rows)
    queries = draw(n_queries)
    rng = np.random.default_rng([_seed64(seed, 2)])
    keys = np.sort(rng.choice(key_space, rows, replace=False)).astype(np.int64)
    rng.shuffle(keys)
    raw = rng.integers(0, 1 << 64, (rows, 2), dtype=np.uint64, endpoint=False)
    uuids = [str(uuid_mod.UUID(int=(int(a) << 64) | int(b))) for a, b in raw]
    if len(set(uuids)) != rows:
        raise ValueError("uuid collision")  # 2**-90 per run
    return Dataset(vectors, keys, uuids, queries)


def query_order(seed: int, n_queries: int) -> np.ndarray:
    """The order in which the load generator cycles the run's query set:
    every run sends each of its queries as often, in an order of its own."""
    return np.random.default_rng([_seed64(seed, 3)]).permutation(n_queries)
