"""Parity of the port's kernel module (weaviate_tpu_torch/ops/kernels.py)
with the JAX package's Pallas kernels.

On the CPU each kernel wrapper takes its plain PyTorch version — the same
function the CUDA kernel is held to on the card (chip_smoke.py). Here the
plain versions are held to ``weaviate_tpu.ops.pallas_kernels`` run through
the Pallas interpreter, on the same numpy inputs. Distances: rtol 2e-4 /
atol 2e-3, the reference's own kernel-vs-XLA tolerance; ids: exact (the
data is tie-free random Gaussian).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from weaviate_tpu.ops import pallas_kernels as pk
from weaviate_tpu_torch.ops import kernels as K
from weaviate_tpu_torch.ops.distances import MASKED_DISTANCE

RTOL, ATOL = 2e-4, 2e-3


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(11)


def _corpus(rng, n, d, metric):
    x = rng.standard_normal((n, d)).astype(np.float32)
    if metric == "cosine":
        x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("metric", ["l2-squared", "dot", "cosine"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_distance_block_plain_matches_pallas(rng, metric, dtype):
    b, n, d = 5, 700, 48
    q = rng.standard_normal((b, d)).astype(np.float32)
    x = _corpus(rng, n, d, metric)
    valid = rng.random(n) > 0.3
    xj = jnp.asarray(x).astype(jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    want = np.asarray(pk.distance_block(jnp.asarray(q), xj, metric=metric,
                                        valid=jnp.asarray(valid), interpret=True))
    xt = _t(x).to(torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    got = K.distance_block(_t(q), xt, metric, valid=_t(valid)).numpy()
    # same bf16 rows on both sides, so the f32 tolerance holds for bf16 too
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert (got[:, ~valid] >= MASKED_DISTANCE * 0.99).all()


def test_distance_block_precomputed_norms(rng):
    q = rng.standard_normal((3, 64)).astype(np.float32)
    x = rng.standard_normal((300, 64)).astype(np.float32)
    xn = (x.astype(np.float64) ** 2).sum(1).astype(np.float32)
    want = np.asarray(pk.distance_block(jnp.asarray(q), jnp.asarray(x),
                                        x_sq_norms=jnp.asarray(xn), interpret=True))
    got = K.distance_block(_t(q), _t(x), "l2-squared", x_sq_norms=_t(xn)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("metric,k,masked,live_frac,dtype", [
    ("l2-squared", 10, False, 0.7, "float32"),
    ("dot", 64, True, 0.5, "float32"),
    ("cosine", 128, True, 0.6, "float32"),
    ("cosine", 16, True, 0.6, "bfloat16"),
    ("l2-squared", 40, True, 0.02, "float32"),  # k > live & allowed: -1 tails
])
def test_fused_topk_scan_plain_matches_pallas(rng, metric, k, masked, live_frac, dtype):
    b, n, d = 6, 1100, 24
    q = rng.standard_normal((b, d)).astype(np.float32)
    x = _corpus(rng, n, d, metric)
    valid = rng.random(n) < live_frac
    allow = rng.random((b, n)) < 0.6
    allow[0] = False  # an empty allow row
    bits = pk.pack_allow_bitmask(allow) if masked else None
    bf16 = dtype == "bfloat16"
    rd, ri = pk.fused_topk_scan(
        jnp.asarray(q), jnp.asarray(x).astype(jnp.bfloat16 if bf16 else jnp.float32),
        k, metric=metric, valid=jnp.asarray(valid),
        allow_bits=None if bits is None else jnp.asarray(bits), interpret=True)
    xt = _t(x).to(torch.bfloat16 if bf16 else torch.float32)
    gd, gi = K.fused_topk_scan(_t(q), xt, k, metric, valid=_t(valid),
                               allow_bits=None if bits is None else bits)
    assert gi.dtype == torch.int32
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
    np.testing.assert_allclose(gd.numpy(), np.asarray(rd), rtol=RTOL, atol=ATOL)
    if masked:
        assert (gi[0] == -1).all() and (gd[0] == MASKED_DISTANCE).all()
    if live_frac < 0.1:
        assert (gi == -1).any()


def test_fused_topk_scan_allow_rows_equals_bits(rng):
    q = rng.standard_normal((4, 16)).astype(np.float32)
    x = rng.standard_normal((530, 16)).astype(np.float32)
    allow = rng.random((4, 530)) < 0.3
    a = K.fused_topk_scan(_t(q), _t(x), 9, allow_rows=_t(allow))
    b = K.fused_topk_scan(_t(q), _t(x), 9, allow_bits=K.pack_allow_bitmask(allow))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("k", [1, 7, 100, 256])
def test_fused_topk_pairs_plain_matches_pallas(rng, k):
    b, m = 4, 900
    vals = rng.standard_normal((b, m)).astype(np.float32)
    vals[:, ::7] = MASKED_DISTANCE        # dead entries never surface
    vals[1, 500:] = np.inf
    vals[:, 30] = vals[:, 3]              # exact ties: earlier position wins
    vals[2, :] = MASKED_DISTANCE          # a row with nothing live
    ids = rng.integers(0, 1 << 30, (b, m)).astype(np.int32)
    rd, ri = pk.fused_topk_pairs(jnp.asarray(vals), jnp.asarray(ids), k,
                                 interpret=True)
    gd, gi = K.fused_topk_pairs(_t(vals), _t(ids), k)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(gd.numpy(), np.asarray(rd))
    assert (gi[2] == -1).all()


def test_fused_topk_pairs_k_beyond_candidates(rng):
    vals = rng.standard_normal((2, 5)).astype(np.float32)
    ids = np.arange(10, dtype=np.int32).reshape(2, 5)
    rd, ri = pk.fused_topk_pairs(jnp.asarray(vals), jnp.asarray(ids), 8,
                                 interpret=True)
    gd, gi = K.fused_topk_pairs(_t(vals), _t(ids), 8)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(gd.numpy(), np.asarray(rd))


@pytest.mark.parametrize("cols", [1, 31, 500, 512, 513, 1300])
def test_bitmask_helpers_bit_identical(rng, cols):
    allow = rng.random((3, cols)) < 0.4
    want = pk.pack_allow_bitmask(allow)
    assert np.array_equal(K.pack_allow_bitmask(allow), want)
    packed_t = K.pack_allow_bitmask_t(_t(allow))
    assert np.array_equal(packed_t.numpy().view(np.uint32), want)
    assert K.mask_pad_cols(cols) == pk.mask_pad_cols(cols)
    back = K.unpack_allow_bitmask(packed_t, cols).numpy()
    assert np.array_equal(back, np.asarray(pk.unpack_allow_bitmask(want, cols)))
    ids = rng.integers(-3, cols + 600, (3, 50)).astype(np.int32)
    got = K.allow_bits_for_ids(packed_t, _t(ids)).numpy()
    ref = np.asarray(pk.allow_bits_for_ids(jnp.asarray(want), jnp.asarray(ids)))
    assert np.array_equal(got, ref)


def test_smallest_positions_ties_to_lower_index():
    v = torch.tensor([[3.0, 1.0, 1.0, -0.0, 0.0, -2.0, 1.0]])
    pos = K.smallest_positions(v, 6)
    assert pos.tolist() == [[5, 3, 4, 1, 2, 6]]


def test_cpu_plain_path_counts_no_launch(rng):
    before = dict(K.launch_counts)
    q = _t(rng.standard_normal((2, 8)).astype(np.float32))
    x = _t(rng.standard_normal((40, 8)).astype(np.float32))
    K.distance_block(q, x)
    K.fused_topk_scan(q, x, 3)
    assert K.launch_counts == before


def test_wrappers_reject_bad_operands(rng):
    q = _t(rng.standard_normal((2, 8)).astype(np.float32))
    x = _t(rng.standard_normal((40, 8)).astype(np.float32))
    with pytest.raises(ValueError):
        K.distance_block(q, x, "hamming")
    with pytest.raises(TypeError):
        K.distance_block(q, x.double())
    with pytest.raises(ValueError):
        K.distance_block(q, x[:, :4])
    with pytest.raises(ValueError):
        K.distance_block(q, x.T.contiguous().T)
    with pytest.raises(ValueError):
        K.fused_topk_scan(q, x, 129)
    with pytest.raises(ValueError):
        K.fused_topk_pairs(x, x.to(torch.int32), 257)


def test_scan_slices_cover_corpus():
    for n, b in [(1, 1), (50, 5), (8192, 256), (1 << 20, 256), (3000, 1)]:
        rows, slices = K.scan_slices(n, b)
        assert rows % 128 == 0 and rows <= 65408
        assert (slices - 1) * rows < n <= slices * rows


def test_empty_corpus_yields_unfilled_slots(rng):
    q = rng.standard_normal((3, 8)).astype(np.float32)
    x = np.zeros((0, 8), dtype=np.float32)
    rd, ri = pk.fused_topk_scan(jnp.asarray(q), jnp.asarray(x), 4, interpret=True)
    gd, gi = K.fused_topk_scan(_t(q), _t(x), 4)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(gd.numpy(), np.asarray(rd))
    assert (gi == -1).all()


@pytest.mark.parametrize("shape,n_cols", [
    ((1, 512), None), ((1, 1), None), ((5, 513), None), ((3, 1300), 2048),
    ((8, 4096), 4096), ((2, 700), 512), ((17, 9000), 16384)])
@pytest.mark.parametrize("density", [0.0, 0.1, 0.5, 1.0])
def test_device_packer_bit_identical_to_numpy(rng, monkeypatch, shape,
                                              n_cols, density):
    """The packer a CUDA store runs on the card (``pack_allow_bitmask_t``)
    gives the numpy packer's words at ragged capacities ([1, 512] was the
    PR 3 fault), explicit padding, truncation past ``n_cols``, full rows
    (bit 31 set: word -1) and rows packed over several passes."""
    monkeypatch.setattr(K, "_PACK_PASS_ELEMS", 3 * 1024)
    allow = rng.random(shape) < density
    want = K.pack_allow_bitmask(allow, n_cols)
    assert np.array_equal(want, pk.pack_allow_bitmask(allow, n_cols))
    got = K.pack_allow_bitmask_t(_t(allow), n_cols)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy().view(np.uint32), want)
