"""The grouped chunk loop of the port's approx / exact scan
(``weaviate_tpu_torch.ops.topk.grouped_scan_topk``) and the wide-PQ
inputs of ``pq4_scan_reduce``.

The grouped loop must give the per-chunk loop's answer bit for bit
(distances, ids, and the ids of MASKED_DISTANCE slots) for any group size,
and the JAX package's ``chunked_topk_distances`` ids exactly, with
distances within the reference's kernel tolerance (rtol 2e-4 / atol 2e-3:
the two packages' f32 products sum in another order). ``use_pallas=True``
runs the port through its ``distance_block`` wrapper (the plain version on
the CPU) and the JAX package through its Pallas kernel in interpret mode.

``pq4_scan_reduce``'s plain version is held to the Pallas interpreter past
the 896 segments the first CUDA kernel refused; the CUDA kernel's
segment-major table is held to ``quantize_lut_int8``'s layout.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from weaviate_tpu.ops import pallas_kernels as pk
from weaviate_tpu.ops import pq as jpq
from weaviate_tpu.ops import topk as jtopk
from weaviate_tpu_torch.ops import kernels as K
from weaviate_tpu_torch.ops import topk as ttopk
from weaviate_tpu_torch.ops.distances import MASKED_DISTANCE, pairwise_distance

RTOL, ATOL = 2e-4, 2e-3


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(11)


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


def _per_chunk(q, x, k, chunk_size, metric="l2-squared", valid=None, x_sq_norms=None,
               id_offset=0, use_pallas=False, allow_bits=None, allow_rows=None,
               row_ids=None):
    """The per-chunk loop the grouped one replaces: per chunk the
    distances, the filter, then the exact top-k of [running k | chunk]
    with ties to the lower position."""
    n, b = x.shape[0], q.shape[0]
    if allow_rows is None and allow_bits is not None:
        allow_rows = K.unpack_allow_bitmask(K.as_bits_tensor(allow_bits, x.device), n)
    if allow_rows is not None:
        allow_rows = allow_rows.bool()
        if allow_rows.shape[1] < n:
            pad = torch.zeros((b, n - allow_rows.shape[1]), dtype=torch.bool)
            allow_rows = torch.cat([allow_rows, pad], dim=1)
        allow_rows = allow_rows[:, :n]
    best_d = torch.full((b, k), MASKED_DISTANCE, dtype=torch.float32)
    best_i = torch.full((b, k), -1, dtype=torch.int32)
    iota = torch.arange(chunk_size, dtype=torch.int32)
    for lo in range(0, n, chunk_size):
        hi = lo + chunk_size
        vc = None if valid is None else valid[lo:hi]
        nc = None if x_sq_norms is None else x_sq_norms[lo:hi]
        if use_pallas:
            d = K.distance_block(q, x[lo:hi], metric=metric, valid=vc, x_sq_norms=nc)
        else:
            d = pairwise_distance(q, x[lo:hi], metric=metric, x_sq_norms=nc)
            if vc is not None:
                d = torch.where(vc[None, :], d, torch.full_like(d, MASKED_DISTANCE))
        if allow_rows is not None:
            d = torch.where(allow_rows[:, lo:hi], d, torch.full_like(d, MASKED_DISTANCE))
        ids = (iota + (lo + id_offset)).expand(b, chunk_size)
        best_d, best_i = ttopk.topk_smallest(torch.cat([best_d, d], 1),
                                             torch.cat([best_i, ids], 1), k)
    if row_ids is not None:
        remapped = row_ids[best_i.clamp(0, n - 1).long()].to(best_i.dtype)
        best_i = torch.where(best_i < 0, best_i, remapped)
    return best_d, best_i


def _bit_equal(got, want):
    """Distances equal bit for bit (NaN payloads and -0.0 included), ids
    equal everywhere (MASKED slots too)."""
    (gd, gi), (wd, wi) = got, want
    assert gd.shape == wd.shape and gi.shape == wi.shape
    assert torch.equal(gd.contiguous().view(torch.int32), wd.contiguous().view(torch.int32))
    assert torch.equal(gi, wi)


def _jax_equal(got, want):
    (gd, gi), (wd, wi) = got, want
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), rtol=RTOL, atol=ATOL)


def _case(rng, b=5, n=1536, d=24, metric="l2-squared", dead=0.3):
    q = rng.standard_normal((b, d)).astype(np.float32)
    x = rng.standard_normal((n, d)).astype(np.float32)
    if metric == "cosine":
        x /= np.linalg.norm(x, axis=1, keepdims=True)
    valid = rng.random(n) > dead
    xn = (x ** 2).sum(1).astype(np.float32)
    return q, x, valid, xn


# 1536 rows in chunks of 192: 8 chunks; 3 chunks a group leaves a group of 2
GROUPS = (1, 2, 3, 8)


@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("metric", ["l2-squared", "dot", "cosine"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_equals_per_chunk_kernel_route(rng, group, metric, dtype):
    q, x, valid, xn = _case(rng, metric=metric)
    xt = _t(x).to(dtype)
    kw = dict(metric=metric, valid=_t(valid), id_offset=4000, use_pallas=True)
    if metric == "l2-squared":
        kw["x_sq_norms"] = K.sq_norms(xt)
    got = ttopk.grouped_scan_topk(_t(q), xt, 10, 192, group, **kw)
    _bit_equal(got, _per_chunk(_t(q), xt, 10, 192, **kw))


@pytest.mark.parametrize("metric", ["l2-squared", "dot", "cosine"])
@pytest.mark.parametrize("selection", ["approx", "exact"])
def test_chunked_topk_matches_jax_and_per_chunk(rng, metric, selection):
    """The public entry point (the group size from the scratch budget)
    against the JAX package and the per-chunk loop, both routes."""
    q, x, valid, xn = _case(rng, metric=metric)
    for use_pallas in (False, True):
        kw = dict(k=12, chunk_size=256, metric=metric, id_offset=77, use_pallas=use_pallas)
        jd, ji = jtopk.chunked_topk_distances(
            jnp.asarray(q), jnp.asarray(x), valid=jnp.asarray(valid),
            x_sq_norms=jnp.asarray(xn), selection=selection, **kw)
        got = ttopk.chunked_topk_distances(_t(q), _t(x), valid=_t(valid),
                                           x_sq_norms=_t(xn), selection=selection, **kw)
        _jax_equal(got, (jd, ji))
        _bit_equal(got, _per_chunk(_t(q), _t(x), valid=_t(valid), x_sq_norms=_t(xn), **kw))


@pytest.mark.parametrize("group", GROUPS)
def test_grouped_bf16_matches_jax(rng, group):
    """bf16 rows through the kernel route against the JAX package's
    Pallas distance_block on the same bf16 rows."""
    q, x, valid, _ = _case(rng, metric="cosine")
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    kw = dict(k=9, chunk_size=192, metric="cosine", use_pallas=True, selection="approx")
    jd, ji = jtopk.chunked_topk_distances(jnp.asarray(q), xb, valid=jnp.asarray(valid), **kw)
    xt = _t(np.asarray(xb.astype(jnp.float32))).to(torch.bfloat16)
    got = ttopk.grouped_scan_topk(_t(q), xt, 9, 192, group, "cosine", valid=_t(valid),
                                  use_pallas=True)
    _jax_equal(got, (jd, ji))


@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("filt", ["bits", "rows", "row_ids"])
def test_grouped_filters(rng, group, filt):
    """Per-query allow bits and allow rows (10% allowed, past the live
    rows' count at k = 40 for some queries), and row_ids remapping."""
    q, x, valid, xn = _case(rng, b=6)
    n = x.shape[0]
    allow = rng.random((q.shape[0], n)) < 0.1
    allow[0] = False
    allow[0, [5, 700]] = True  # fewer allowed rows than k
    kw = dict(metric="l2-squared", valid=_t(valid), x_sq_norms=_t(xn))
    jkw = dict(valid=jnp.asarray(valid), x_sq_norms=jnp.asarray(xn))
    if filt == "bits":
        bits = pk.pack_allow_bitmask(allow)
        kw["allow_bits"], jkw["allow_bits"] = bits, jnp.asarray(bits)
    elif filt == "rows":
        kw["allow_rows"], jkw["allow_rows"] = _t(allow), jnp.asarray(allow)
    else:
        row_ids = rng.permutation(8192)[:n].astype(np.int32)
        row_ids[::7] = -1
        kw["row_ids"], jkw["row_ids"] = _t(row_ids), jnp.asarray(row_ids)
    got = ttopk.grouped_scan_topk(_t(q), _t(x), 40, 192, group, **kw)
    _bit_equal(got, _per_chunk(_t(q), _t(x), 40, 192, **kw))
    jd, ji = jtopk.chunked_topk_distances(jnp.asarray(q), jnp.asarray(x), 40, 192,
                                          selection="approx", **jkw)
    _jax_equal(got, (jd, ji))
    if filt != "row_ids":
        assert (got[1][0, 2:] == -1).all() and (got[0][0, 2:] == MASKED_DISTANCE).all()


@pytest.mark.parametrize("group", (1, 2, 5))
def test_grouped_bits_on_chunks_off_the_mask_block(rng, group):
    """Chunks of 96 rows: a group starts inside a 512-column block of the
    packed words, and the words end before the corpus does."""
    q, x, valid, _ = _case(rng, b=4, n=960, d=8)
    allow = rng.random((4, 700)) < 0.3  # words cover 1024 columns, rows past 700 disallowed
    bits = pk.pack_allow_bitmask(allow)
    kw = dict(metric="dot", valid=_t(valid), allow_bits=bits, id_offset=3)
    got = ttopk.grouped_scan_topk(_t(q), _t(x), 16, 96, group, **kw)
    _bit_equal(got, _per_chunk(_t(q), _t(x), 16, 96, **kw))


@pytest.mark.parametrize("group", (1, 3))
def test_k_beyond_live_rows_and_wide_k(rng, group):
    """k past the live rows (MASKED slots keep id -1), and k past the pairs
    kernel's 256 (the plain selection)."""
    q, x, _, xn = _case(rng, b=3, n=768, d=8)
    valid = np.zeros(768, dtype=bool)
    valid[[1, 200, 201, 600]] = True
    for k, v in ((8, valid), (300, rng.random(768) > 0.5)):
        kw = dict(metric="l2-squared", valid=_t(v), x_sq_norms=_t(xn), use_pallas=True)
        got = ttopk.grouped_scan_topk(_t(q), _t(x), k, 128, group, **kw)
        _bit_equal(got, _per_chunk(_t(q), _t(x), k, 128, **kw))
        jd, ji = jtopk.chunked_topk_distances(jnp.asarray(q), jnp.asarray(x), k, 128,
                                              valid=jnp.asarray(v),
                                              x_sq_norms=jnp.asarray(xn))
        _jax_equal(got, (jd, ji))


@pytest.mark.parametrize("group", (1, 2, 3))
@pytest.mark.parametrize("metric", ["dot", "cosine", "l2-squared"])
def test_nan_distances_in_the_exact_order(rng, group, metric):
    """NaN rows and a NaN query: NaN with the sign bit set sorts before
    every value (the dot metric negates a NaN product; inf - inf makes one
    on the host), positive NaN after MASKED_DISTANCE — as in the per-chunk
    loop, bit for bit, and as in the JAX package."""
    q, x, _, _ = _case(rng, b=4, n=576, d=8)
    x[[3, 300, 500]] = np.nan
    x[10, 0] = np.inf
    q[1] = np.nan
    q[2, 0] = np.inf
    kw = dict(metric=metric)
    got = ttopk.grouped_scan_topk(_t(q), _t(x), 6, 96, group, **kw)
    _bit_equal(got, _per_chunk(_t(q), _t(x), 6, 96, **kw))
    jd, ji = jtopk.chunked_topk_distances(jnp.asarray(q), jnp.asarray(x), 6, 96, metric=metric)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ji))


@pytest.mark.parametrize("group", (1, 3, 4))
def test_grouped_selection_in_staged_parts(rng, group):
    """Groups wider than the pairs kernel's 16,384 staged entries are
    selected in equal parts (24,576 rows in 2, 32,768 in 2) and merged in
    row order; ties on a few levels make the row order decide."""
    q = rng.standard_normal((3, 4)).astype(np.float32)
    x = np.round(rng.standard_normal((32768, 4)) * 2).astype(np.float32)
    valid = rng.random(32768) > 0.1
    kw = dict(metric="dot", valid=_t(valid), id_offset=9)
    got = ttopk.grouped_scan_topk(_t(q), _t(x), 50, 8192, group, **kw)
    _bit_equal(got, _per_chunk(_t(q), _t(x), 50, 8192, **kw))


def test_split_parts():
    assert [ttopk._split_parts(m) for m in (100, 16384, 16385, 24576, 40960, 65536, 16411)] \
        == [1, 1, 1, 2, 4, 4, 1]


def test_scan_group_budget():
    """Chunks per group: the 256 MiB budget and the 65,536-row cap."""
    assert ttopk.scan_group_chunks(256, 8192, 128, 100, False) == 8
    assert ttopk.scan_group_chunks(256, 8192, 128, 100, True) == 6
    assert ttopk.scan_group_chunks(256, 8192, 128, 300, False) == 3
    assert ttopk.scan_group_chunks(8, 8192, 128, 10, True) == 8  # the row cap
    assert ttopk.scan_group_chunks(8, 8192, 3, 10, False) == 3   # the corpus
    assert ttopk.scan_group_chunks(4096, 8192, 128, 10, True) == 1
    assert ttopk.scan_group_chunks(1, 1 << 17, 4, 10, False) == 1
    per = 256 * 8 * 8192 * 16  # B x group rows x entry bytes at the serving drain
    assert per <= ttopk.SCAN_GROUP_BYTES


# -- pq4_scan_reduce past 896 segments -----------------------------------------

@pytest.mark.parametrize("m", [1024, 901])
@pytest.mark.parametrize("tp", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_pq4_scan_reduce_wide_matches_pallas(rng, m, tp, masked):
    b, n, L = 3, 300, 4
    lut = (rng.standard_normal((b, m, 16)) * 3).astype(np.float32)
    codes = rng.integers(0, 16, (n, m)).astype(np.uint8)
    valid = rng.random(n) > 0.2
    bits = pk.pack_allow_bitmask(rng.random((b, n)) < 0.5) if masked else None
    cin = np.ascontiguousarray(codes.T) if tp else codes
    want = pk.pq4_scan_reduce(jnp.asarray(lut), jnp.asarray(cin), valid=jnp.asarray(valid),
                              reduce_l=L, interpret=True, transposed=tp,
                              allow_bits=None if bits is None else jnp.asarray(bits))
    words = None if bits is None else _t(np.ascontiguousarray(bits).view(np.int32))
    got = K.pq4_scan_reduce_plain(_t(lut), _t(cin), valid=_t(valid), reduce_l=L,
                                  transposed=tp, allow_bits=words)
    gv, gi = (a.numpy() for a in got)
    wv, wi = (np.asarray(a) for a in want)
    np.testing.assert_array_equal(gv, wv)
    live = wv < MASKED_DISTANCE
    np.testing.assert_array_equal(gi[live], wi[live])


@pytest.mark.parametrize("b,m,kc", [(4, 192, 16), (70, 33, 9), (3, 1024, 16), (9, 1, 5)])
def test_pq4_table_blocks_layout(rng, b, m, kc):
    """Entry (query q, segment s, code c) of the kernel's blocked table is
    quantize_lut_int8's entry of code c, segment s (JAX's and the port's);
    padded queries, segments and codes hold 0; the segment count is a
    multiple of the kernel's slice and the queries of its query block."""
    lut = (rng.standard_normal((b, m, kc)) * 2).astype(np.float32)
    lut8, scale, pm = K.pq4_lut8(_t(lut))
    b_pad = -(-b // K.PQ4_QBLOCK) * K.PQ4_QBLOCK
    table, ks = K.pq4_lut_blocks(lut8, pm, b_pad)
    assert ks % K.PQ4_SLICE_SEGMENTS == 0 and ks >= pm and table.shape == (b_pad * 16 * ks,)
    want8, wscale = jpq.quantize_lut_int8(
        jnp.asarray(np.pad(lut, ((0, 0), (0, pm - m), (0, 16 - kc)))))
    want8 = np.asarray(want8).reshape(b, 16, pm)  # [q, code, segment]
    np.testing.assert_array_equal(scale.numpy(), np.asarray(wscale))
    t = table.numpy().reshape(b_pad // 8, ks // 32, 32, 8, 16)
    t = t.transpose(0, 3, 1, 2, 4).reshape(b_pad, ks, 16)  # [q, segment, code]
    np.testing.assert_array_equal(t[:b, :pm, :], want8.transpose(0, 2, 1))
    assert not t[b:].any() and not t[:, pm:].any()
    assert not t[:, m:, :].any() and not t[:, :, kc:].any()
