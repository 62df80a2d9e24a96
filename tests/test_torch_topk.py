"""Parity of the port's top-k selection (weaviate_tpu_torch/ops/topk.py)
with ``weaviate_tpu.ops.topk`` on the same numpy inputs.

On the CPU the JAX package lowers ``selection="approx"`` to an exact
top-k, and the port maps it to the exact per-chunk selection, so ids must
match exactly (ties to the lower row in both); distances within rtol 2e-4
/ atol 2e-3. ``use_pallas=True`` routes the port through its
``distance_block`` wrapper (the plain version here on the CPU) and the
JAX package through its Pallas kernel in interpret mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from weaviate_tpu.ops import topk as jtopk
from weaviate_tpu.ops.pallas_kernels import pack_allow_bitmask
from weaviate_tpu_torch.ops import topk as ttopk
from weaviate_tpu_torch.ops.candidates import shared_candidates_topk
from weaviate_tpu_torch.ops.distances import MASKED_DISTANCE, pairwise_distance

RTOL, ATOL = 2e-4, 2e-3


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(5)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _both(rng, b=6, n=2048, d=32, metric="l2-squared"):
    q = rng.standard_normal((b, d)).astype(np.float32)
    x = rng.standard_normal((n, d)).astype(np.float32)
    if metric == "cosine":
        x /= np.linalg.norm(x, axis=1, keepdims=True)
    valid = rng.random(n) > 0.25
    xn = (x ** 2).sum(1).astype(np.float32)
    return q, x, valid, xn


def _check(jd, ji, td, ti):
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("metric", ["l2-squared", "dot", "cosine", "manhattan"])
def test_pairwise_distance_matches(rng, metric):
    from weaviate_tpu.ops.distances import pairwise_distance as jpd

    q, x, _, _ = _both(rng, b=3, n=200, d=16, metric=metric)
    want = np.asarray(jpd(jnp.asarray(q), jnp.asarray(x), metric=metric))
    got = pairwise_distance(_t(q), _t(x), metric=metric).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("selection", ["exact", "approx", "fused"])
@pytest.mark.parametrize("metric", ["l2-squared", "cosine"])
def test_chunked_topk_distances_parity(rng, selection, metric):
    q, x, valid, xn = _both(rng, metric=metric)
    kw = dict(k=10, chunk_size=512, metric=metric, id_offset=1000,
              selection=selection)
    jd, ji = jtopk.chunked_topk_distances(
        jnp.asarray(q), jnp.asarray(x), valid=jnp.asarray(valid),
        x_sq_norms=jnp.asarray(xn), **kw)
    td, ti = ttopk.chunked_topk_distances(
        _t(q), _t(x), valid=_t(valid), x_sq_norms=_t(xn), **kw)
    _check(jd, ji, td, ti)


@pytest.mark.parametrize("selection", ["approx", "fused"])
def test_chunked_topk_per_query_bits_and_row_ids(rng, selection):
    q, x, valid, xn = _both(rng, n=1024)
    allow = rng.random((q.shape[0], x.shape[0])) < 0.1
    bits = pack_allow_bitmask(allow)
    row_ids = rng.permutation(4096)[:1024].astype(np.int32)
    row_ids[::9] = -1
    kw = dict(k=16, chunk_size=256, metric="l2-squared", selection=selection)
    jd, ji = jtopk.chunked_topk_distances(
        jnp.asarray(q), jnp.asarray(x), valid=jnp.asarray(valid),
        x_sq_norms=jnp.asarray(xn), allow_bits=jnp.asarray(bits),
        row_ids=jnp.asarray(row_ids), **kw)
    td, ti = ttopk.chunked_topk_distances(
        _t(q), _t(x), valid=_t(valid), x_sq_norms=_t(xn), allow_bits=bits,
        row_ids=_t(row_ids), **kw)
    _check(jd, ji, td, ti)


def test_chunked_topk_kernel_route_matches_pallas(rng):
    """use_pallas=True: the port's distance_block wrapper against the
    JAX package's Pallas distance_block (interpreter)."""
    q, x, valid, xn = _both(rng, b=3, n=1024, d=16)
    kw = dict(k=8, chunk_size=512, metric="dot", use_pallas=True,
              selection="approx")
    jd, ji = jtopk.chunked_topk_distances(
        jnp.asarray(q), jnp.asarray(x), valid=jnp.asarray(valid), **kw)
    td, ti = ttopk.chunked_topk_distances(_t(q), _t(x), valid=_t(valid), **kw)
    _check(jd, ji, td, ti)


def test_k_beyond_live_rows(rng):
    q, x, _, _ = _both(rng, n=512)
    valid = np.zeros(512, dtype=bool)
    valid[[3, 100, 401]] = True
    for selection in ("exact", "fused"):
        kw = dict(k=6, chunk_size=256, selection=selection)
        jd, ji = jtopk.chunked_topk_distances(
            jnp.asarray(q), jnp.asarray(x), valid=jnp.asarray(valid), **kw)
        td, ti = ttopk.chunked_topk_distances(_t(q), _t(x), valid=_t(valid), **kw)
        _check(jd, ji, td, ti)
    assert (ti[:, 3:] == -1).all()


def test_chunked_topk_pads_ragged_corpus(rng):
    q, x, _, _ = _both(rng, n=1000)
    jd, ji = jtopk.chunked_topk(jnp.asarray(q), jnp.asarray(x), 7, chunk_size=256)
    td, ti = ttopk.chunked_topk(_t(q), _t(x), 7, chunk_size=256)
    _check(jd, ji, td, ti)


@pytest.mark.parametrize("selection", ["approx", "fused"])
def test_merge_epoch_topk_and_select_survivors(rng, selection):
    b = 4
    parts_np, maps_np = [], []
    for cap in (64, 128):
        d = np.sort(rng.standard_normal((b, 12)).astype(np.float32), axis=1)
        i = rng.integers(-1, cap, (b, 12)).astype(np.int32)
        d[i < 0] = MASKED_DISTANCE
        parts_np.append((d, i))
        maps_np.append(rng.permutation(1000)[:cap].astype(np.int32))
    jd, ji = jtopk.merge_epoch_topk(
        tuple((jnp.asarray(d), jnp.asarray(i)) for d, i in parts_np),
        tuple(jnp.asarray(m) for m in maps_np), k=30, selection=selection)
    td, ti = ttopk.merge_epoch_topk(
        [(_t(d), _t(i)) for d, i in parts_np], [_t(m) for m in maps_np],
        k=30, selection=selection)
    _check(jd, ji, td, ti)

    vals = rng.standard_normal((b, 300)).astype(np.float32)
    vals[:, ::5] = MASKED_DISTANCE
    ids = rng.integers(0, 5000, (b, 300)).astype(np.int32)
    jd, ji = jtopk.select_survivors(jnp.asarray(vals), jnp.asarray(ids), 20,
                                    selection=selection, id_offset=7)
    td, ti = ttopk.select_survivors(_t(vals), _t(ids), 20,
                                    selection=selection, id_offset=7)
    _check(jd, ji, td, ti)


def test_shared_candidates_topk_matches(rng):
    from weaviate_tpu.ops.candidates import shared_candidates_topk as jsc

    q, x, valid, xn = _both(rng, n=700)
    slots = np.full(128, -1, dtype=np.int32)
    slots[:90] = rng.choice(700, 90, replace=False)
    for selection in ("approx", "fused"):
        jd, ji = jsc(jnp.asarray(q), jnp.asarray(slots), jnp.asarray(x), 10,
                     "l2-squared", row_norms=jnp.asarray(xn),
                     valid=jnp.asarray(valid), selection=selection)
        td, ti = shared_candidates_topk(_t(q), _t(slots), _t(x), 10,
                                        "l2-squared", row_norms=_t(xn),
                                        valid=_t(valid), selection=selection)
        _check(jd, ji, td, ti)


def test_topk_smallest_tie_rule():
    d = torch.tensor([[2.0, 1.0, 1.0, 0.5, 1.0]])
    ids = torch.tensor([10, 11, 12, 13, 14], dtype=torch.int32)
    td, ti = ttopk.topk_smallest(d, ids, 4)
    jd, ji = jtopk.topk_smallest(jnp.asarray(d.numpy()), jnp.asarray(ids.numpy()), 4)
    _check(jd, ji, td, ti)
    assert ti.tolist() == [[13, 11, 12, 14]]
