"""Host-side codecs and set algebra, in numpy.

The JAX package binds these to a C++ library (``weaviate_tpu/native``)
and keeps numpy versions as its fallback. This package loads no native
library: it carries those numpy versions alone, under the same names, so
the storage, inverted-index and collection modules it copies keep their
call sites. ``available()`` is always False, which sends every caller
down its pure-Python path — the entry points that exist only in the
native library (``PostingsTable``, ``analyze_batch``,
``storobj_encode_batch``) are never reached, so they are not here. The
bytes written are the same either way (the on-disk format is shared).
"""

from __future__ import annotations

import numpy as np


def available() -> bool:
    return False


def _u64(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, dtype=np.uint64))


# ---- sorted uint64 set algebra -------------------------------------------


# The inputs are already sorted and unique, so these merge by binary
# search or a run-merging sort instead of np.unique: numpy >= 2.3 takes a
# hash path there that is several times slower on these postings.

def _in_sorted(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """For each a[i]: is it in the ascending array b?"""
    if len(b) == 0:
        return np.zeros(len(a), dtype=bool)
    pos = np.searchsorted(b, a)
    pos[pos == len(b)] = len(b) - 1
    return b[pos] == a


def intersect_sorted(a, b) -> np.ndarray:
    """Intersection of two ascending unique uint64 arrays."""
    a, b = _u64(a), _u64(b)
    return a[_in_sorted(a, b)]


def union_sorted(a, b) -> np.ndarray:
    """Union of two ascending unique uint64 arrays, ascending."""
    a, b = _u64(a), _u64(b)
    c = np.concatenate([a, b])
    c.sort(kind="stable")  # two sorted runs: a linear merge
    if len(c) < 2:
        return c
    keep = np.empty(len(c), dtype=bool)
    keep[0] = True
    np.not_equal(c[1:], c[:-1], out=keep[1:])
    return c[keep]


def difference_sorted(a, b) -> np.ndarray:
    """a \\ b for ascending unique uint64 arrays."""
    a, b = _u64(a), _u64(b)
    return a[~_in_sorted(a, b)]


# ---- varint delta codec ---------------------------------------------------


def varint_encode(vals) -> bytes:
    """Ascending uint64 -> delta + LEB128 bytes (posting-block codec)."""
    out = bytearray()
    prev = 0
    for v in _u64(vals).tolist():
        d = v - prev
        prev = v
        while d >= 0x80:
            out.append((d & 0x7F) | 0x80)
            d >>= 7
        out.append(d)
    return bytes(out)


def varint_decode(buf: bytes, count_hint: int | None = None) -> np.ndarray:
    """Decode a varint-delta block. ``count_hint`` is the declared element
    count from the surrounding record; a block holding another number of
    values raises (corrupt/truncated data) — the count field is untrusted
    on-disk input."""
    out, prev, d, shift = [], 0, 0, 0
    for byte in buf:
        if shift > 63:
            raise ValueError("corrupt varint block: over-long varint")
        d |= (byte & 0x7F) << shift
        if byte & 0x80:
            shift += 7
        else:
            prev += d
            out.append(prev)
            d, shift = 0, 0
    if count_hint is not None and len(out) != count_hint:
        raise ValueError(
            f"corrupt varint block: {len(out)} values, "
            f"{count_hint} declared")
    return np.asarray(out, dtype=np.uint64)


def varint_encode_many(arrays: list[np.ndarray]) -> list[bytes]:
    """Encode many ascending-u64 blocks; one bytes object per block."""
    return [varint_encode(a) for a in arrays]


# ---- cross-shard top-k merge ----------------------------------------------


def merge_topk_host(dists: np.ndarray, ids: np.ndarray, k: int):
    """Merge [L, len] ascending per-shard candidates into global top-k.

    ids < 0 mark dead tail slots. Returns (dists [k] f32, ids [k] i64),
    padded with (3e38, -1); ties keep the earlier list's entry first."""
    dists = np.asarray(dists, dtype=np.float32)
    ids = np.asarray(ids, dtype=np.int64)
    if dists.ndim == 1:
        dists, ids = dists[None, :], ids[None, :]
    flat_d, flat_i = dists.ravel(), ids.ravel()
    live = flat_i >= 0
    flat_d, flat_i = flat_d[live], flat_i[live]
    order = np.argsort(flat_d, kind="stable")[:k]
    out_d = np.full(k, 3.0e38, dtype=np.float32)
    out_i = np.full(k, -1, dtype=np.int64)
    out_d[: len(order)] = flat_d[order]
    out_i[: len(order)] = flat_i[order]
    return out_d, out_i
