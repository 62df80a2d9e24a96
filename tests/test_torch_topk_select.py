"""The specification of the two selection kernels, held to the JAX package
on the inputs that break a careless select.

``fused_topk_pairs_plain`` and ``fused_topk_scan_plain``
(weaviate_tpu_torch/ops/kernels.py) are what csrc/fused_topk_pairs.cu and
csrc/fused_topk_scan.cu are held to on the card (chip_smoke.py phase 2).
Here they are held to ``weaviate_tpu.ops.pallas_kernels`` run through the
Pallas interpreter, on the same numpy inputs: ids exactly, values under
``==`` (so -0.0 equals +0.0), scan distances within the reference's
kernel tolerance (rtol 2e-4 / atol 2e-3) where they are not exact ties.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from weaviate_tpu.ops import pallas_kernels as pk
from weaviate_tpu_torch.ops import kernels as K
from weaviate_tpu_torch.ops.distances import MASKED_DISTANCE

RTOL, ATOL = 2e-4, 2e-3


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _pairs_both(vals, k, ids=None):
    vals = np.asarray(vals, dtype=np.float32)
    if ids is None:
        ids = np.arange(vals.size, dtype=np.int32).reshape(vals.shape) * 3 + 1
    rd, ri = pk.fused_topk_pairs(jnp.asarray(vals), jnp.asarray(ids), k, interpret=True)
    gd, gi = K.fused_topk_pairs(_t(vals), _t(ids), k)
    return (np.asarray(rd), np.asarray(ri)), (gd.numpy(), gi.numpy())


def _assert_same(ref, got):
    np.testing.assert_array_equal(got[1], ref[1])
    assert (got[0] == ref[0]).all(), (got[0], ref[0])  # -0.0 == +0.0


def _levels(rng, shape, n=16):
    return (np.floor(rng.random(shape) * n) / n).astype(np.float32)


def test_signed_zero_group_ties_by_position():
    row = np.array([[1.0, 0.0, 2.0, -0.0, 0.5, -0.0, 0.0, 3.0]], np.float32)
    for k in (1, 3, 4, 5, 8, 12):
        ref, got = _pairs_both(row, k)
        _assert_same(ref, got)
    # the four zeros come first, by position, whatever their signs
    _, got = _pairs_both(row, 4, ids=np.arange(8, dtype=np.int32)[None])
    assert got[1].tolist() == [[1, 3, 5, 6]]
    # each slot keeps its entry's own bits
    assert np.signbit(got[0]).tolist() == [[False, True, True, False]]


@pytest.mark.parametrize("k", [1, 7, 37, 100])
def test_signed_zero_groups_random(k):
    rng = np.random.default_rng(k)
    v = _levels(rng, (4, 300)) + 0.5
    z = rng.random(v.shape) < 0.3
    v[z] = np.where(rng.random(int(z.sum())) < 0.5, -0.0, 0.0)
    ref, got = _pairs_both(v, k)
    _assert_same(ref, got)


@pytest.mark.parametrize("k", [1, 16, 50, 64])
def test_heavy_ties_at_the_kth_value(k):
    rng = np.random.default_rng(100 + k)
    v = _levels(rng, (5, 700))  # ~44 entries per level: the k-th value is shared
    ref, got = _pairs_both(v, k)
    _assert_same(ref, got)


@pytest.mark.parametrize("k", [1, 256])
def test_k_edges(k):
    rng = np.random.default_rng(7 + k)
    v = rng.standard_normal((3, 600)).astype(np.float32)
    v[:, ::7] = MASKED_DISTANCE
    ref, got = _pairs_both(v, k)
    _assert_same(ref, got)


@pytest.mark.parametrize("m,k", [(1, 1), (1, 10), (5, 10), (50, 100), (33, 256)])
def test_fewer_entries_than_k(m, k):
    rng = np.random.default_rng(m * 1000 + k)
    v = _levels(rng, (4, m))
    v[1] = MASKED_DISTANCE  # a row with nothing live
    ref, got = _pairs_both(v, k)
    _assert_same(ref, got)
    live = min(m, k)
    assert (got[1][0, live:] == -1).all() and (got[0][0, live:] == MASKED_DISTANCE).all()
    assert (got[1][1] == -1).all()


def test_infinities_and_masked_never_or_always_as_the_reference():
    v = np.array([[np.inf, 2.0, MASKED_DISTANCE, -np.inf, 1.0, np.inf, 3.0e38, 0.5]],
                 np.float32)
    ref, got = _pairs_both(v, 6)
    _assert_same(ref, got)
    assert got[1][0, 4:].tolist() == [-1, -1]  # +inf and MASKED never surface


def test_nan_never_surfaces_in_the_port():
    """A deliberate difference: a NaN in a row makes the reference return
    (nan, 2**30) in every slot (``jnp.min`` in ``_fold_tile_topk``
    propagates NaN and the sorted insert puts it first); the port treats
    NaN as a dead entry, like MASKED_DISTANCE, and returns the row's live
    entries."""
    v = np.array([[1.0, 0.0, np.nan, -0.0, 0.5, -0.0, 0.0, 3.0]], np.float32)
    ref, got = _pairs_both(v, 5, ids=np.arange(8, dtype=np.int32)[None])
    assert np.isnan(ref[0]).all() and (ref[1] == 2 ** 30).all()
    assert not np.isnan(got[0]).any()
    assert got[1].tolist() == [[1, 3, 5, 6, 4]]
    ref, got = _pairs_both(np.delete(v, 2, axis=1), 5,
                           ids=np.delete(np.arange(8, dtype=np.int32), 2)[None])
    _assert_same(ref, got)  # without the NaN both agree
    # the scan: a NaN row of the corpus is dead to the port
    q = np.ones((2, 4), np.float32)
    x = np.tile(np.arange(10, dtype=np.float32)[:, None], (1, 4))
    x[3, 0] = np.nan
    rd, ri = pk.fused_topk_scan(jnp.asarray(q), jnp.asarray(x), 3, metric="dot",
                                interpret=True)
    assert np.isnan(np.asarray(rd)).all() and (np.asarray(ri) == 2 ** 30).all()
    gd, gi = K.fused_topk_scan(_t(q), _t(x), 3, "dot")
    assert gi.tolist() == [[9, 8, 7]] * 2 and not torch.isnan(gd).any()


@pytest.mark.parametrize("k", [5, 40, 128])
def test_scan_dot_exact_zero_products(k):
    """Rows orthogonal to every query sit at distance -0.0 under the dot
    metric: a tie group far larger than k that only the row breaks."""
    rng = np.random.default_rng(k)
    d = 24
    q = rng.random((3, d)).astype(np.float32)
    q[:, d // 2:] = 0.0
    x = -rng.random((600, d)).astype(np.float32)
    x[::3, :d // 2] = 0.0
    valid = rng.random(600) > 0.1
    rd, ri = pk.fused_topk_scan(jnp.asarray(q), jnp.asarray(x), k, metric="dot",
                                valid=jnp.asarray(valid), interpret=True)
    gd, gi = K.fused_topk_scan(_t(q), _t(x), k, "dot", valid=_t(valid))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
    assert (gd.numpy() == np.asarray(rd)).all()
    assert (gd.numpy() == 0).all()
    assert gi[0].tolist() == [r for r in range(0, 600, 3) if valid[r]][:k]


def test_scan_heavy_ties_with_filters():
    """Quantized rows make many exact distance ties at the k-th place."""
    rng = np.random.default_rng(3)
    q = np.round(rng.standard_normal((4, 16))).astype(np.float32)
    x = np.round(rng.standard_normal((900, 16))).astype(np.float32)
    allow = rng.random((4, 900)) < 0.5
    bits = pk.pack_allow_bitmask(allow)
    for metric in ("l2-squared", "dot"):
        rd, ri = pk.fused_topk_scan(jnp.asarray(q), jnp.asarray(x), 64, metric=metric,
                                    allow_bits=jnp.asarray(bits), interpret=True)
        gd, gi = K.fused_topk_scan(_t(q), _t(x), 64, metric, allow_bits=bits)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
        np.testing.assert_allclose(gd.numpy(), np.asarray(rd), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("n", [1, 127, 128, 129, 8191, 8192, 8193, 1 << 20, (1 << 20) + 1,
                               100_000_000])
@pytest.mark.parametrize("b", [1, 16, 32, 33, 63, 64, 65, 256, 1024])
def test_scan_slices_edges(n, b):
    """The slice geometry the CUDA scan takes: whole 128-row tiles, at
    most 511 of them a slice (its lists key rows by 16-bit offsets in the
    slice), covering the corpus exactly, and, below that cap, no more
    (query block, slice) CTAs than about one wave of two per SM on 132
    SMs."""
    rows, slices = K.scan_slices(n, b)
    assert rows % 128 == 0 and 128 <= rows <= 511 * 128 < 1 << 16
    assert (slices - 1) * rows < n <= slices * rows
    qblocks = -(-b // K.scan_query_tile(b))
    if rows < 511 * 128:
        assert qblocks * slices <= 264 + qblocks


@pytest.mark.parametrize("b,tile", [(1, 16), (8, 16), (32, 16), (33, 64), (256, 64)])
def test_scan_query_tile(b, tile):
    assert K.scan_query_tile(b) == tile
