"""Parity of the port's four block kernels (weaviate_tpu_torch/ops/kernels.py:
``bq_hamming_block``, ``bq_mxu_block``, ``pq4_lut_block``,
``pq4_recon_block``) and of its kernel-conformance entry point
(ops/conformance.py) with the JAX package.

On the CPU the wrappers take their plain PyTorch versions, the functions
the CUDA kernels are held to on the card (chip_smoke.py). Here they are
held to ``weaviate_tpu.ops.pallas_kernels`` run through the Pallas
interpreter on the same numpy inputs. Tolerances:

- ``bq_hamming_block`` and ``bq_mxu_block``: bit-equal (integer popcounts;
  the f32 epilogue runs in the reference's order). ``bq_mxu_block`` and
  the two pq4 kernels return bf16 in both packages;
- ``pq4_lut_block``: bit-equal, as measured: the sum of the bf16 table
  entries in f32, segment by segment, matches the interpreter's one-hot
  product exactly;
- ``pq4_recon_block``: within ``8e-3 * max(1, max|ref|)`` on live rows,
  one bf16 ulp at the output's scale, because the f32 sums of q . x_hat
  and |x_hat|^2 run in another order; masked rows bit-equal;
- ``bq_queries_to_planes``: bit-equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from weaviate_tpu.ops import pallas_kernels as pk
from weaviate_tpu_torch.ops import conformance
from weaviate_tpu_torch.ops import kernels as K
from weaviate_tpu_torch.ops.bq import bq_hamming_np


def _words(rng, shape):
    return rng.integers(0, 2 ** 32, size=shape, dtype=np.uint32)


def _t(a):
    """numpy -> a writable torch copy; uint32 words keep their bits as int32."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a.copy())


def _bf16_np(j):
    return np.asarray(j.astype(jnp.float32))


def _pad_rows(a, mult=8):
    return np.pad(a, ((0, -a.shape[0] % mult),) + ((0, 0),) * (a.ndim - 1))


@pytest.mark.parametrize("b,n,w", [(3, 100, 4), (1, 7, 3), (5, 1000, 24), (9, 513, 48)])
def test_bq_hamming_block_matches_jax(b, n, w):
    rng = np.random.default_rng([b, n, w])
    q, x = _words(rng, (b, w)), _words(rng, (n, w))
    want = np.asarray(pk.bq_hamming_block(jnp.asarray(q), jnp.asarray(x), interpret=True))
    got = K.bq_hamming_block(_t(q), _t(x))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), bq_hamming_np(q, x))


# (B, N, W, valid, x_pop, q_planes): d = 32W; W = 24 is 768 dims, where the
# bf16 output rounds hamming distances past 256
MXU_CASES = [(4, 512, 24, False, False, False), (4, 512, 24, True, True, True),
             (5, 1000, 4, True, False, False), (1, 7, 3, False, True, False),
             (9, 513, 48, True, False, True), (3, 130, 1, False, False, True)]


@pytest.mark.parametrize("b,n,w,masked,xpop,planes", MXU_CASES)
def test_bq_mxu_block_matches_jax(b, n, w, masked, xpop, planes):
    rng = np.random.default_rng([b, n, w, masked, xpop, planes])
    q, x = _words(rng, (b, w)), _words(rng, (n, w))
    valid = rng.random(n) > 0.2 if masked else None
    # a caller's cached popcounts are used as given: any f32 values
    x_pop = (rng.uniform(0, 32 * w, n).astype(np.float32) if xpop else None)
    jkw, tkw = {}, {}
    if valid is not None:
        jkw["valid"], tkw["valid"] = jnp.asarray(valid), _t(valid)
    if x_pop is not None:
        jkw["x_pop"], tkw["x_pop"] = jnp.asarray(x_pop), _t(x_pop)
    if planes:  # the reference takes them padded to its 8-row sublane
        q01 = pk.bq_queries_to_planes(jnp.asarray(_pad_rows(q)), w)
        jkw["q_planes"] = q01
        jkw["q_pop"] = jnp.sum(q01.astype(jnp.float32), axis=1, keepdims=True)
        tkw["q_planes"] = K.bq_queries_to_planes(_t(q), w)
        tkw["q_pop"] = tkw["q_planes"].float().sum(dim=1)
    want = _bf16_np(pk.bq_mxu_block(jnp.asarray(q), jnp.asarray(x), interpret=True, **jkw))
    got = K.bq_mxu_block(_t(q), _t(x), **tkw)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
    if masked:  # a dead row reads bf16(d + MASKED_DISTANCE): finite, not 3e38
        dead = got.float().numpy()[:, ~valid]
        assert np.isfinite(dead).all() and (dead > 3.0e38).all()


def test_bq_mxu_block_past_256_bits_is_rounded_hamming():
    """At 768 dims the output is bf16(exact hamming), not the exact
    hamming: the reason the conformance check runs at 128 dims."""
    rng = np.random.default_rng(7)
    q, x = _words(rng, (4, 24)), _words(rng, (512, 24))
    exact = K.bq_hamming_block(_t(q), _t(x))
    got = K.bq_mxu_block(_t(q), _t(x))
    assert torch.equal(got, exact.to(torch.bfloat16))
    assert not torch.equal(got.float(), exact)


@pytest.mark.parametrize("b,w", [(3, 4), (8, 24), (1, 1)])
def test_bq_queries_to_planes_matches_jax(b, w):
    q = _words(np.random.default_rng([b, w]), (b, w))
    want = _bf16_np(pk.bq_queries_to_planes(jnp.asarray(q), w))
    got = K.bq_queries_to_planes(_t(q), w)
    assert got.dtype == torch.bfloat16 and got.shape == (b, 32 * w)
    np.testing.assert_array_equal(got.float().numpy(), want)


# (B, m, k, N, valid, top code): m = 192 is 768 dims; codes past k read
# the zero padding, codes past 15 add nothing in both packages
LUT_CASES = [(8, 192, 16, 600, True, 16), (5, 24, 12, 700, True, 16),
             (3, 32, 16, 513, False, 16), (2, 13, 16, 130, True, 16),
             (1, 8, 12, 64, False, 12), (4, 16, 16, 200, False, 20)]


@pytest.mark.parametrize("b,m,kc,n,masked,top", LUT_CASES)
def test_pq4_lut_block_matches_jax(b, m, kc, n, masked, top):
    rng = np.random.default_rng([b, m, kc, n, top])
    lut = (rng.standard_normal((b, m, kc)) * 3).astype(np.float32)
    codes = rng.integers(0, top, (n, m)).astype(np.uint8)
    valid = rng.random(n) > 0.2 if masked else None
    want = _bf16_np(pk.pq4_lut_block(jnp.asarray(lut), jnp.asarray(codes),
                                     None if valid is None else jnp.asarray(valid),
                                     interpret=True))
    got = K.pq4_lut_block(_t(lut), _t(codes), None if valid is None else _t(valid))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)


RECON_SHAPES = [(8, 32, 16, 4, 600, True), (5, 24, 12, 2, 300, False),
                (3, 7, 16, 3, 130, True)]


@pytest.mark.parametrize("metric", ["l2-squared", "dot", "cosine", "cosine-dot"])
@pytest.mark.parametrize("b,m,kc,ds,n,masked", RECON_SHAPES)
def test_pq4_recon_block_matches_jax(metric, b, m, kc, ds, n, masked):
    rng = np.random.default_rng([b, m, kc, ds, n])
    q = rng.standard_normal((b, m * ds)).astype(np.float32)
    if metric.startswith("cosine"):  # the caller normalizes, in both packages
        q /= np.linalg.norm(q, axis=1, keepdims=True)
    cent = rng.standard_normal((m, kc, ds)).astype(np.float32)
    codes = rng.integers(0, 16, (n, m)).astype(np.uint8)
    valid = rng.random(n) > 0.2 if masked else None
    want = _bf16_np(pk.pq4_recon_block(
        jnp.asarray(q), jnp.asarray(codes), jnp.asarray(cent), metric=metric,
        valid=None if valid is None else jnp.asarray(valid), interpret=True))
    got = K.pq4_recon_block(_t(q), _t(codes), _t(cent), metric,
                            None if valid is None else _t(valid))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    live = np.ones(n, bool) if valid is None else valid
    tol = 8e-3 * max(1.0, float(np.abs(want[:, live]).max()))
    np.testing.assert_allclose(got[:, live], want[:, live], rtol=0, atol=tol)
    np.testing.assert_array_equal(got[:, ~live], want[:, ~live])


def test_kernel_conformance_on_cpu():
    assert conformance.kernel_conformance(device="cpu") == "ok"
    assert conformance.kernel_conformance(device="cpu", dim=256, seed=3) == "ok"
    # past 256 dims the exact-hamming check cannot hold (bf16 output)
    assert conformance.kernel_conformance(device="cpu", dim=768).startswith(
        "bq_mxu_block mismatch")


def _corrupt(fn, index=None):
    """``fn`` with its output (or output ``index``) moved off the truth."""
    def wrapped(*a, **kw):
        out = fn(*a, **kw)
        if index is None:
            return out + 1.0
        out = list(out)
        out[index] = torch.flip(out[index], dims=[1])
        return tuple(out)
    return wrapped


@pytest.mark.parametrize("name,index,want", [
    ("distance_block", None, "distance_block mismatch"),
    ("bq_mxu_block", None, "bq_mxu_block mismatch 1.0"),
    ("pq4_lut_block", None, "pq4_lut_block mismatch"),
    ("fused_topk_scan", 1, "fused_topk_scan id mismatch")])
def test_kernel_conformance_reports_a_corrupted_kernel(monkeypatch, name, index, want):
    monkeypatch.setattr(K, name, _corrupt(getattr(K, name), index))
    assert conformance.kernel_conformance(device="cpu").startswith(want)


def test_kernel_conformance_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the default device exists")
    with pytest.raises(RuntimeError, match="CUDA"):
        conformance.kernel_conformance()


def _bad_operands():
    w = torch.ones((2, 3), dtype=torch.int32)
    x = torch.zeros((5, 3), dtype=torch.int32)
    lut = torch.zeros((2, 4, 16))
    codes = torch.zeros((5, 4), dtype=torch.uint8)
    q8 = torch.zeros((2, 8))
    cent = torch.zeros((4, 16, 2))
    return [
        ("hamming float words", lambda: K.bq_hamming_block(w.float(), x)),
        ("hamming 1-D", lambda: K.bq_hamming_block(w[0], x)),
        ("hamming width", lambda: K.bq_hamming_block(w, x[:, :2])),
        ("hamming devices", lambda: K.bq_hamming_block(w, x.to("meta"))),
        ("mxu uint8 words", lambda: K.bq_mxu_block(w, x.to(torch.uint8))),
        ("mxu valid dtype", lambda: K.bq_mxu_block(w, x, valid=torch.ones(5))),
        ("mxu valid length", lambda: K.bq_mxu_block(
            w, x, valid=torch.ones(4, dtype=torch.bool))),
        ("mxu x_pop length", lambda: K.bq_mxu_block(w, x, x_pop=torch.ones(6))),
        ("mxu planes alone", lambda: K.bq_mxu_block(
            w, x, q_planes=K.bq_queries_to_planes(w, 3))),
        ("mxu planes not 0/1", lambda: K.bq_mxu_block(
            w, x, q_planes=K.bq_queries_to_planes(w, 3).float() * 2, q_pop=torch.ones(2))),
        ("mxu planes shape", lambda: K.bq_mxu_block(
            w, x, q_planes=torch.zeros((2, 95)), q_pop=torch.ones(2))),
        ("lut k > 16", lambda: K.pq4_lut_block(torch.zeros((2, 4, 17)), codes)),
        ("lut codes dtype", lambda: K.pq4_lut_block(lut, codes.to(torch.int32))),
        ("lut segments", lambda: K.pq4_lut_block(lut, codes[:, :3])),
        ("lut 2-D", lambda: K.pq4_lut_block(lut[0], codes)),
        ("lut devices", lambda: K.pq4_lut_block(lut, codes.to("meta"))),
        ("recon metric", lambda: K.pq4_recon_block(q8, codes, cent, "manhattan")),
        ("recon unknown metric", lambda: K.pq4_recon_block(q8, codes, cent, "l2")),
        ("recon k > 16", lambda: K.pq4_recon_block(q8, codes, torch.zeros((4, 17, 2)))),
        ("recon m*ds != d", lambda: K.pq4_recon_block(torch.zeros((2, 9)), codes, cent)),
        ("recon codes dtype", lambda: K.pq4_recon_block(q8, codes.float(), cent)),
        ("recon valid", lambda: K.pq4_recon_block(
            q8, codes, cent, valid=torch.ones(5, dtype=torch.int32))),
        ("recon devices", lambda: K.pq4_recon_block(q8, codes, cent.to("meta"))),
    ]


BAD_OPERANDS = _bad_operands()


@pytest.mark.parametrize("call", [c for _, c in BAD_OPERANDS],
                         ids=[name for name, _ in BAD_OPERANDS])
def test_bad_operands_raise(call):
    with pytest.raises(ValueError):
        call()


def test_cpu_path_counts_no_launch():
    K.reset_launch_counts()
    w = torch.zeros((2, 3), dtype=torch.int32)
    x = torch.ones((5, 3), dtype=torch.int32)
    codes = torch.zeros((5, 4), dtype=torch.uint8)
    K.bq_hamming_block(w, x)
    K.bq_mxu_block(w, x)
    K.pq4_lut_block(torch.ones((2, 4, 16)), codes)
    K.pq4_recon_block(torch.ones((2, 8)), codes, torch.ones((4, 16, 2)))
    assert all(v == 0 for v in K.launch_counts.values()), K.launch_counts
