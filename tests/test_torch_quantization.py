"""Parity of the port's quantization ops (weaviate_tpu_torch/ops/bq.py,
ops/pq.py and the two scan-reduce kernels of ops/kernels.py) with the JAX
package.

On the CPU the scan-reduce wrappers take their plain PyTorch versions —
the functions the CUDA kernels are held to on the card (chip_smoke.py).
Here they are held to ``weaviate_tpu.ops.pallas_kernels`` run through the
Pallas interpreter on the same numpy inputs. Tolerances:

- the scan-reduce outputs are integer arithmetic (plus one f32 division
  by the per-query scale for PQ4, exact in IEEE): ``vals`` bit-identical
  everywhere, ``ids`` equal wherever ``vals`` is live (downstream code
  never reads the id of a masked slot);
- sign words, int8 LUTs and the sampled PQ initialisation: bit-identical;
- f32 products summed in another order (LUTs, Lloyd steps, the search
  functions' distances): rtol 2e-4 / atol 2e-3, the reference's kernel
  tolerance, and ids compared tie-aware.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from weaviate_tpu.ops import bq as jbq
from weaviate_tpu.ops import pallas_kernels as pk
from weaviate_tpu.ops import pq as jpq
from weaviate_tpu_torch.ops import bq as tbq
from weaviate_tpu_torch.ops import kernels as K
from weaviate_tpu_torch.ops import pq as tpq
from weaviate_tpu_torch.ops.distances import MASKED_DISTANCE

RTOL, ATOL = 2e-4, 2e-3
TIE_TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


def _words(a):
    """uint32 sign words (numpy) -> the port's int32 tensor, same bits."""
    return _t(np.ascontiguousarray(a, dtype=np.uint32).view(np.int32))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same_scan(got, want):
    gv, gi = (_np(a) for a in got)
    wv, wi = (_np(a) for a in want)
    assert gv.shape == wv.shape and gi.shape == wi.shape
    np.testing.assert_array_equal(gv, wv)
    live = wv < MASKED_DISTANCE
    np.testing.assert_array_equal(gi[live], wi[live])


def _same_topk(got, want, rtol=RTOL, atol=ATOL):
    """Ids equal except where two candidates' distances tie (within
    TIE_TOL); distances within the stated tolerance."""
    gd, gi = (_np(a) for a in got)
    wd, wi = (_np(a) for a in want)
    np.testing.assert_allclose(gd, wd, rtol=rtol, atol=atol)
    for r, p in zip(*np.nonzero(gi != wi)):
        tied = np.abs(wd[r] - wd[r, p]) <= TIE_TOL
        assert gi[r, p] in wi[r][tied] or abs(wd[r, p] - wd[r, -1]) <= TIE_TOL, (r, p)


# -- bq ----------------------------------------------------------------------

@pytest.mark.parametrize("d", [64, 70, 768])
def test_bq_encode_bit_identical(rng, d):
    v = rng.standard_normal((37, d)).astype(np.float32)
    v[0, :5] = 0.0  # zero counts as non-negative in both
    want = np.asarray(jbq.bq_encode(jnp.asarray(v)))
    got = tbq.bq_encode(_t(v))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy().view(np.uint32), want)
    assert tbq.bq_words(d) == jbq.bq_words(d)


def test_bq_hamming_helpers_agree(rng):
    a = rng.integers(0, 2 ** 32, (5, 7), dtype=np.uint32)
    b = rng.integers(0, 2 ** 32, (9, 7), dtype=np.uint32)
    want = jbq.bq_hamming_np(a, b)
    np.testing.assert_array_equal(tbq.bq_hamming_np(a, b), want)
    np.testing.assert_array_equal(tbq.hamming(_words(a), _words(b)).numpy(), want)
    for n in (0, 1000, 16384, 1 << 20, 1 << 24):
        assert tbq._auto_reduce_l(n) == jbq._auto_reduce_l(n)


def _bq_case(rng, b, n, d):
    v = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((b, d)).astype(np.float32)
    return (np.asarray(jbq.bq_encode(jnp.asarray(v))),
            np.asarray(jbq.bq_encode(jnp.asarray(q))))


@pytest.mark.parametrize("b,n,d,L,tp,masked", [
    # the four shapes of test_pallas_kernels.test_bq_scan_reduce_strided_argmin
    (8, 2000, 128, 32, False, False),
    (5, 700, 96, 8, True, False),
    (6, 9000, 768, 64, False, False),
    (3, 130, 64, 4, False, False),
    # per-query allow bits (MASK_BLOCK-aligned supertiles), both orientations
    (4, 1500, 128, 16, True, True),
    (3, 2600, 768, 64, False, True),
    # B > 8 and N off every supertile multiple
    (13, 5000, 256, 128, False, False),
    # past one query block of the CUDA kernel's tensor-core body (64 / 128
    # queries), and d = 800: W = 25 words, no multiple of 4 or 8
    (65, 1500, 128, 16, False, False),
    (130, 1200, 256, 8, True, True),
    (5, 2500, 800, 32, False, False),
    (9, 1700, 800, 16, False, True),
    (6, 900, 800, 8, True, False),
])
def test_bq_scan_reduce_plain_matches_pallas(rng, b, n, d, L, tp, masked):
    xw, qw = _bq_case(rng, b, n, d)
    valid = rng.random(n) > 0.3
    allow = rng.random((b, n)) < 0.5
    allow[0, : n // 2] = False
    bits = pk.pack_allow_bitmask(allow) if masked else None
    xin = np.ascontiguousarray(xw.T) if tp else xw
    want = pk.bq_scan_reduce(jnp.asarray(qw), jnp.asarray(xin), valid=jnp.asarray(valid),
                             reduce_l=L, interpret=True, transposed=tp,
                             allow_bits=None if bits is None else jnp.asarray(bits))
    got = K.bq_scan_reduce(_words(qw), _words(xin), valid=_t(valid), reduce_l=L,
                           transposed=tp, allow_bits=None if bits is None else _words(bits))
    _same_scan(got, want)


def test_bq_scan_reduce_prefix_shape(rng):
    """The two-stage prefix scan: [Wp=4, N] transposed words."""
    xw, qw = _bq_case(rng, 6, 3000, 512)
    pt = np.ascontiguousarray(xw[:, :4].T)
    want = pk.bq_scan_reduce(jnp.asarray(qw[:, :4]), jnp.asarray(pt), reduce_l=2,
                             interpret=True, transposed=True)
    got = K.bq_scan_reduce(_words(qw[:, :4]), _words(pt), reduce_l=2, transposed=True)
    _same_scan(got, want)


def test_scan_wrappers_reject_bad_operands(rng):
    xw, qw = _bq_case(rng, 2, 100, 64)
    with pytest.raises(ValueError):
        K.bq_scan_reduce(_words(qw).long(), _words(xw))
    with pytest.raises(ValueError):
        K.bq_scan_reduce(_words(qw), _words(xw[:, :1]))
    with pytest.raises(ValueError):
        K.bq_scan_reduce(_words(qw), _words(xw).T.contiguous().T)
    with pytest.raises(ValueError):
        K.bq_scan_reduce(_words(qw), _words(xw), valid=torch.ones(99, dtype=torch.bool))
    with pytest.raises(TypeError):
        K.pq4_scan_reduce(torch.zeros((2, 4, 16)), torch.zeros((10, 4), dtype=torch.int32))
    with pytest.raises(ValueError):
        K.pq4_scan_reduce(torch.zeros((2, 4, 17)), torch.zeros((10, 4), dtype=torch.uint8))


def test_scan_geometry_matches_reference_rules():
    """out_w, supertile and the padded row count for the shapes the main
    path uses (the ids depend on out_w)."""
    g = K.bq_geometry(1 << 20, 24, 256, reduce_l=64)
    assert (g.row_major, g.reduce_l, g.out_w, g.supertile) == (True, 64, 128, 8192)
    g = K.bq_geometry(1 << 20, 4, 256, reduce_l=64, transposed=True)
    assert (g.row_major, g.out_w, g.supertile) == (False, 256, 16384)
    g = K.pq4_geometry(1 << 20, 192, 256, reduce_l=64)
    assert (g.out_w, g.supertile, g.out_cols) == (128, 8192, 1 << 14)
    g = K.pq4_geometry(1000, 8, 600, reduce_l=3, masked=True)
    assert g.reduce_l == 2 and g.supertile % K.MASK_BLOCK == 0


# -- pq ----------------------------------------------------------------------

def _lut(rng, b, m, kc):
    return (rng.standard_normal((b, m, kc)) * 3).astype(np.float32)


def test_quantize_lut_int8_bit_identical(rng):
    lut = _lut(rng, 7, 24, 16)
    lut[2] = 0.0  # an all-zero table: the 1e-20 clamp
    lut[3, 0, 0] = 127.5 / 127.0 * np.abs(lut[3]).max()  # a rounding edge
    w8, ws = jpq.quantize_lut_int8(jnp.asarray(lut))
    g8, gs = K.quantize_lut_int8(_t(lut))
    assert np.array_equal(g8.numpy(), np.asarray(w8))
    assert np.array_equal(gs.numpy(), np.asarray(ws))


@pytest.mark.parametrize("b,n,m,kc,L,tp,masked", [
    (5, 1800, 8, 16, 16, False, False),    # m < 24: the transposed geometry
    (4, 2100, 32, 16, 64, False, False),   # m >= 24: row-major
    (3, 900, 12, 12, 4, True, False),      # fewer than 16 centroids, [m, N] codes
    (6, 2600, 32, 16, 32, False, True),    # per-query allow bits
    (10, 1300, 8, 16, 8, True, True),      # B > 8, transposed, allow bits
])
def test_pq4_scan_reduce_plain_matches_pallas(rng, b, n, m, kc, L, tp, masked):
    lut = _lut(rng, b, m, kc)
    codes = rng.integers(0, kc, (n, m)).astype(np.uint8)
    valid = rng.random(n) > 0.2
    allow = rng.random((b, n)) < 0.4
    bits = pk.pack_allow_bitmask(allow) if masked else None
    cin = np.ascontiguousarray(codes.T) if tp else codes
    want = pk.pq4_scan_reduce(jnp.asarray(lut), jnp.asarray(cin), valid=jnp.asarray(valid),
                              reduce_l=L, interpret=True, transposed=tp,
                              allow_bits=None if bits is None else jnp.asarray(bits))
    got = K.pq4_scan_reduce(_t(lut), _t(cin), valid=_t(valid), reduce_l=L, transposed=tp,
                            allow_bits=None if bits is None else _words(bits))
    _same_scan(got, want)


def test_pq_lut_matches_jax(rng):
    q = rng.standard_normal((5, 64)).astype(np.float32)
    cent = rng.standard_normal((16, 16, 4)).astype(np.float32)
    for metric in ("l2-squared", "dot", "cosine"):
        want = np.asarray(jpq.pq_lut(jnp.asarray(q), jnp.asarray(cent), metric, 16))
        got = tpq.pq_lut(_t(q), _t(cent), metric, 16).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _separated(rng, n, d, m):
    """Data whose every segment is one of 16 far-apart points, so both
    packages assign every row alike (equal rows tie exactly, and argmin
    takes the lower centroid in both) and converge to the same centroids."""
    ds = d // m
    base = rng.standard_normal((m, 16, ds)).astype(np.float32) * 20
    pick = rng.integers(0, 16, (n, m))
    return base[np.arange(m)[None, :], pick].reshape(n, d)


def test_pq_fit_same_seed_same_start_and_converged_centroids(rng):
    v = _separated(rng, 3000, 32, 8)
    # iters=0: the sampled rows and the initial centroids alone
    j0 = np.asarray(jpq.pq_fit(v, m=8, k=16, iters=0, sample=2000, seed=3).centroids)
    t0 = tpq.pq_fit(v, m=8, k=16, iters=0, sample=2000, seed=3, device="cpu")
    assert np.array_equal(t0.centroids.numpy(), j0)
    j = np.asarray(jpq.pq_fit(v, m=8, k=16, iters=6, seed=3).centroids)
    t = tpq.pq_fit(v, m=8, k=16, iters=6, seed=3, device="cpu").centroids.numpy()
    np.testing.assert_allclose(t, j, rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError):
        tpq.pq_fit(v[:10], m=8, k=16, device="cpu")
    assert tpq.default_pq_segments(768) == jpq.default_pq_segments(768) == 192
    assert tpq.default_pq_segments(100, 256) == jpq.default_pq_segments(100, 256)


def test_pq_encode_with_carried_codebook(rng):
    v = rng.standard_normal((1500, 32)).astype(np.float32)
    book = jpq.pq_fit(v, m=8, k=16, iters=3)
    cent = np.asarray(book.centroids)
    want = jpq.pq_encode(book, v)
    got = tpq.pq_encode(tpq.PQCodebook(_t(cent)), v, batch=512)
    assert got.dtype == np.uint8
    # codes may differ only where the two nearest centroids tie within 1e-5
    seg = v.reshape(len(v), 8, 4)
    d2 = ((seg[:, :, None, :] - cent[None]) ** 2).sum(-1)
    two = np.sort(d2, axis=-1)[:, :, :2]
    near_tie = (two[:, :, 1] - two[:, :, 0]) <= 1e-5
    assert not (got != want)[~near_tie].any()
    recon_w = np.asarray(jpq.pq_reconstruct(jnp.asarray(want), jnp.asarray(cent), 8))
    recon_g = tpq.pq_reconstruct(_t(want), _t(cent), 8).numpy()
    assert np.array_equal(recon_g, recon_w)


# -- the search functions ----------------------------------------------------

@pytest.fixture(scope="module")
def clustered():
    rng = np.random.default_rng(5)
    n, d = 3000, 64
    cent = rng.standard_normal((60, d)).astype(np.float32)
    v = (cent[rng.integers(0, 60, n)] + 0.4 * rng.standard_normal((n, d))).astype(np.float32)
    q = (v[rng.integers(0, n, 6)] + 0.1 * rng.standard_normal((6, d))).astype(np.float32)
    valid = rng.random(n) > 0.1
    allow = rng.random((6, n)) < 0.5
    return v, q, valid, pk.pack_allow_bitmask(allow)


@pytest.mark.parametrize("use_pallas,selection,masked", [
    (False, "approx", False), (False, "approx", True),
    (True, "approx", False), (True, "fused", True), (True, "approx", True),
])
def test_bq_topk_matches_jax(clustered, use_pallas, selection, masked):
    v, q, valid, bits = clustered
    xw = np.asarray(jbq.bq_encode(jnp.asarray(v)))
    qw = np.asarray(jbq.bq_encode(jnp.asarray(q)))
    ab = bits if masked else None
    want = jbq.bq_topk(jnp.asarray(qw), jnp.asarray(xw), k=20, chunk_size=1024,
                       valid=jnp.asarray(valid), use_pallas=use_pallas, reduce_l=8,
                       selection=selection, id_offset=7,
                       allow_bits=None if ab is None else jnp.asarray(ab))
    got = tbq.bq_topk(_words(qw), _words(xw), k=20, chunk_size=1024, valid=_t(valid),
                      use_pallas=use_pallas, reduce_l=8, selection=selection, id_offset=7,
                      allow_bits=None if ab is None else _words(ab))
    # hamming distances are integers: exact, ties broken by position in both
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("use_pallas,selection", [(True, "approx"), (True, "fused"),
                                                  (False, "approx")])
def test_bq_topk_twostage_matches_jax(clustered, use_pallas, selection):
    v, q, valid, bits = clustered
    xw = np.asarray(jbq.bq_encode(jnp.asarray(v)))
    qw = np.asarray(jbq.bq_encode(jnp.asarray(q)))
    wp = 1
    pt = np.ascontiguousarray(xw[:, :wp].T)
    want = jbq.bq_topk_twostage(jnp.asarray(qw), jnp.asarray(xw), jnp.asarray(pt), k=10,
                                refine=8, valid=jnp.asarray(valid), use_pallas=use_pallas,
                                selection=selection, allow_bits=jnp.asarray(bits))
    got = tbq.bq_topk_twostage(_words(qw), _words(xw), _words(pt), k=10, refine=8,
                               valid=_t(valid), use_pallas=use_pallas,
                               selection=selection, allow_bits=_words(bits))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


@pytest.fixture(scope="module")
def pq_setup(clustered):
    v, q, valid, bits = clustered
    book4 = jpq.pq_fit(v, m=16, k=16, iters=3)
    book8 = jpq.pq_fit(v, m=8, k=256, iters=2)
    return {
        4: (np.asarray(book4.centroids), jpq.pq_encode(book4, v)),
        8: (np.asarray(book8.centroids), jpq.pq_encode(book8, v)),
    }


@pytest.mark.parametrize("metric,selection,masked", [
    ("l2-squared", "approx", False), ("cosine", "fused", True), ("dot", "approx", True),
])
def test_pq4_topk_matches_jax(clustered, pq_setup, metric, selection, masked):
    v, q, valid, bits = clustered
    cent, codes = pq_setup[4]
    ab = bits if masked else None
    want = jpq.pq4_topk(jnp.asarray(q), jnp.asarray(codes), jnp.asarray(cent), k=15,
                        metric=metric, valid=jnp.asarray(valid), reduce_l=4,
                        selection=selection, id_offset=3,
                        allow_bits=None if ab is None else jnp.asarray(ab))
    got = tpq.pq4_topk(_t(q), _t(codes), _t(cent), k=15, metric=metric, valid=_t(valid),
                       reduce_l=4, selection=selection, id_offset=3,
                       allow_bits=None if ab is None else _words(ab))
    # the f32 LUTs differ in the last bits (einsum order), so the int8
    # tables and scales may too: distances within tolerance, ids tie-aware
    _same_topk(got, want)


@pytest.mark.parametrize("masked", [False, True])
def test_pq_topk_8bit_matches_jax(clustered, pq_setup, masked):
    v, q, valid, bits = clustered
    cent, codes = pq_setup[8]
    n = 2048
    ab = pk.pack_allow_bitmask(pk.unpack_allow_bitmask(bits, n)) if masked else None
    want = jpq.pq_topk(jnp.asarray(q), jnp.asarray(codes[:n]), jnp.asarray(cent), k=12,
                       chunk_size=512, valid=jnp.asarray(valid[:n]),
                       allow_bits=None if ab is None else jnp.asarray(ab))
    got = tpq.pq_topk(_t(q), _t(codes[:n]), _t(cent), k=12, chunk_size=512,
                      valid=_t(valid[:n]), allow_bits=None if ab is None else _words(ab))
    _same_topk(got, want)


@pytest.mark.parametrize("use_pallas,selection", [(True, "approx"), (True, "fused"),
                                                  (False, "approx")])
def test_pq_topk_twostage_matches_jax(clustered, pq_setup, use_pallas, selection):
    v, q, valid, bits = clustered
    cent, codes = pq_setup[4]
    pw = np.asarray(jbq.bq_encode(jnp.asarray(v[:, :32])))
    qp = np.asarray(jbq.bq_encode(jnp.asarray(q[:, :32])))
    pt = np.ascontiguousarray(pw.T)
    want = jpq.pq_topk_twostage(jnp.asarray(q), jnp.asarray(qp), jnp.asarray(codes),
                                jnp.asarray(cent), jnp.asarray(pt), k=10, refine=8,
                                valid=jnp.asarray(valid), use_pallas=use_pallas,
                                selection=selection, allow_bits=jnp.asarray(bits))
    got = tpq.pq_topk_twostage(_t(q), _words(qp), _t(codes), _t(cent), _words(pt), k=10,
                               refine=8, valid=_t(valid), use_pallas=use_pallas,
                               selection=selection, allow_bits=_words(bits))
    _same_topk(got, want)
