"""The tensor-core body of the port's ``bq_scan_reduce``
(weaviate_tpu_torch/csrc/bq_scan_reduce.cu), its host-side query operand,
and the exact host rescore that follows the scan.

The CUDA kernel runs only on the card, where chip_smoke.py phase 2 holds
it to its plain version bit for bit. Here what surrounds it is held: the
port's ``bq_queries_to_pm1`` (the int8 operand of the product yardstick)
equals the reference's at scale 1 and 64; ``bq_query_blocks``' blocked
layout round-trips to the query words; and the single-bit product as the
kernel forms it (its ring laid out by its copy offsets, both operands
read at the descriptors' core-matrix addresses, popc(x AND q) per K step
of 256 bits, popc(x) from the all-ones columns) gives hamming -
popcount(q) exactly. The rescore (``QuantizedVectorStore._host_rescore``,
cut into blocks on host threads) is held ``np.array_equal`` to the JAX
package's on the same inputs. All of it is integer or identical numpy
arithmetic: no tolerance.
"""

import re
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from weaviate_tpu.engine.quantized import QuantizedVectorStore as JStore
from weaviate_tpu.ops import pallas_kernels as pk
from weaviate_tpu_torch.engine import quantized as tq
from weaviate_tpu_torch.engine.quantized import QuantizedVectorStore as TStore
from weaviate_tpu_torch.ops import _build
from weaviate_tpu_torch.ops import kernels as K
from weaviate_tpu_torch.runtime import tracing


def _words(a):
    """uint32 sign words (numpy) -> the port's int32 tensor, same bits."""
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32).view(np.int32).copy())


def _popc(a):
    return np.unpackbits(np.ascontiguousarray(a, dtype=np.uint32).view(np.uint8),
                         axis=-1).sum(axis=-1).astype(np.int64)


@pytest.mark.parametrize("scale", [1, 64])
@pytest.mark.parametrize("w", [1, 4, 24, 25])
def test_bq_queries_to_pm1_matches_pallas(rng, scale, w):
    q = rng.integers(0, 2 ** 32, (5, w), dtype=np.uint32)
    q[0] = 0
    q[1] = 0xFFFFFFFF
    want = np.asarray(pk.bq_queries_to_pm1(jnp.asarray(q), w, scale))
    got = K.bq_queries_to_pm1(_words(q), w, scale)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)


def _unblock(flat, w, qn):
    """bq_query_blocks' layout back to [blocks, qn + 16, W8] words."""
    w8 = -(-w // 8) * 8
    return flat.reshape(-1, qn // 8 + 2, w8 // 4, 8, 4).transpose(0, 1, 3, 2, 4) \
        .reshape(-1, qn + 16, w8)


@pytest.mark.parametrize("b,w,qn", [(1, 24, 8), (8, 1, 8), (13, 3, 16), (65, 25, 128),
                                    (130, 24, 64)])
def test_bq_query_blocks_round_trip(rng, b, w, qn):
    q = rng.integers(0, 2 ** 32, (b, w), dtype=np.uint32)
    flat = K.bq_query_blocks(_words(q), qn)
    n_qb, w8 = -(-b // qn), -(-w // 8) * 8
    assert flat.dtype == torch.int32 and flat.shape == (n_qb * (qn + 16) * w8,)
    blocks = _unblock(flat.numpy().view(np.uint32), w, qn)
    np.testing.assert_array_equal(blocks[:, :qn].reshape(-1, w8)[:b, :w], q)
    assert not blocks[:, :qn].reshape(-1, w8)[b:].any() and not blocks[:, :, w:].any()
    assert (blocks[:, qn:, :w] == 0xFFFFFFFF).all()


def _ring(x, w):
    """One 64-row tile as the kernel's copies lay it out: word j of row r
    at byte (r/8)*32*W8 + (j/4)*128 + (r%8)*16 + (j%4)*4."""
    w8 = -(-w // 8) * 8
    ring = np.zeros(64 * w8 * 4, dtype=np.uint8)
    for r in range(len(x)):
        for j in range(w):
            o = (r >> 3) * 32 * w8 + (j >> 2) * 128 + (r & 7) * 16 + (j & 3) * 4
            ring[o:o + 4] = np.frombuffer(x[r, j].tobytes(), dtype=np.uint8)
    return ring


def _core_rows(buf, base, rows, step, w8):
    """The 256 bits of K step ``step`` of ``rows`` rows read through a
    K-major, no-swizzle descriptor at ``base`` (LBO 128, SBO 32 * W8):
    core matrix (row group, chunk c) at base + group*SBO + (2*step + c)*128."""
    out = np.zeros((rows, 8), dtype=np.uint32)
    for r in range(rows):
        for c in range(2):
            o = base + (r >> 3) * 32 * w8 + (2 * step + c) * 128 + (r & 7) * 16
            out[r, 4 * c:4 * c + 4] = buf[o:o + 16].view(np.uint32)
    return out


@pytest.mark.parametrize("b,n,w,qn", [(5, 64, 24, 8), (40, 33, 3, 64), (130, 20, 25, 128)])
def test_bq_single_bit_product_gives_hamming(rng, b, n, w, qn):
    """The kernel's product, emulated: popc(x AND q) summed over K steps
    of 256 bits, popc(x) from the all-ones columns, and popc(x) - 2D ==
    hamming - popcount(q) for every row and query, in every query block."""
    x = rng.integers(0, 2 ** 32, (n, w), dtype=np.uint32)
    q = rng.integers(0, 2 ** 32, (b, w), dtype=np.uint32)
    w8 = -(-w // 8) * 8
    ring = _ring(x, w)
    blk = K.bq_query_blocks(_words(q), qn).numpy().view(np.uint8)
    want = _popc(x[:, None, :] ^ q[None, :, :]) - _popc(q)[None, :]
    for qb in range(-(-b // qn)):
        d = np.zeros((64, qn + 16), dtype=np.int64)
        for step in range(w8 // 8):
            a = _core_rows(ring, 0, 64, step, w8)
            bm = _core_rows(blk, qb * (qn + 16) * w8 * 4, qn + 16, step, w8)
            d += _popc(a[:, None, :] & bm[None, :, :])
        popx = d[:, qn]
        assert (d[:, qn:] == popx[:, None]).all()
        np.testing.assert_array_equal(popx[:n], _popc(x))
        got = popx[:, None] - 2 * d[:, :qn]
        hi = min(b, (qb + 1) * qn)
        np.testing.assert_array_equal(got[:n, :hi - qb * qn], want[:, qb * qn:hi])


def test_bq_qblock_picks_a_body_that_fits():
    for b, want in ((1, 8), (8, 8), (9, 16), (32, 32), (64, 64), (65, 128), (256, 128)):
        assert K.bq_qblock(b, 24, 128) == want
    assert K.bq_qblock(256, 33, 256) == 128
    assert K.bq_qblock(256, 96, 128) == 64  # 128 queries of 96 words overflow shared memory
    assert K.bq_qblock(1, 200, 128) == 0  # too wide for 8 queries: the popcount body
    assert K.bq_qblock(8, 24, 64) == 0  # out_w no multiple of 128
    for b in (1, 7, 100, 300):
        for w in range(1, 120, 7):
            qn = K.bq_qblock(b, w, 128)
            assert qn == 0 or K.bq_tc_smem(qn, w) <= K._SMEM_MAX
    # the host's shared-memory sum is the kernel's
    src = open(f"{_build.CSRC}/bq_scan_reduce.cu").read()
    consts = dict(re.findall(r"constexpr int (STAGES|TILE|SMEM_MAX) = (\d+);", src))
    assert (int(consts["STAGES"]), int(consts["TILE"]), int(consts["SMEM_MAX"])) == \
        (K._BQ_TC_STAGES, K._BQ_TC_TILE, K._SMEM_MAX)


# -- the exact host rescore ---------------------------------------------------

def _rescore_case(rng, metric, b, kc, n=300, d=24):
    hv = rng.standard_normal((n, d)).astype(np.float32)
    hv[1::7] = hv[0]  # exact duplicates: tied distances
    if metric == "cosine":
        hv /= np.linalg.norm(hv, axis=1, keepdims=True)
    q = rng.standard_normal((b, d)).astype(np.float32)
    if metric == "cosine":
        q /= np.linalg.norm(q, axis=1, keepdims=True)
    ids = rng.integers(0, n, (b, kc)).astype(np.int64)
    ids[:, ::5] = -1  # dead candidates
    ids[:, 1::6] = ids[:, :1]  # repeated candidate ids
    ids[:, 2::9] = 0  # rows tied with row 0's duplicates
    if b > 1:
        ids[-1, kc // 2:] = -1  # a query with few live candidates
    return hv, q, ids


def _store(hv, metric):
    return SimpleNamespace(capacity=len(hv), dim=hv.shape[1], metric=metric,
                           _host_vectors=hv, rescore_rows=None,
                           _tier_vectors=TStore._tier_vectors)


@pytest.mark.parametrize("metric", ["l2-squared", "dot", "cosine"])
@pytest.mark.parametrize("b,kc,k", [(1, 40, 10), (7, 33, 5), (16, 12, 20), (33, 160, 16)])
def test_host_rescore_bit_identical_to_jax(rng, monkeypatch, metric, b, kc, k):
    hv, q, ids = _rescore_case(rng, metric, b, kc)
    want = JStore._host_rescore(SimpleNamespace(dim=hv.shape[1], metric=metric), q, ids, k,
                                capacity=len(hv), vectors_for=lambda s: hv[s])
    monkeypatch.setattr(tq, "RESCORE_BLOCK_ELEMS", 1)  # as many blocks as threads
    for threads, chunk_queries in ((1, 1), (2, 3), (3, 1), (8, 2), (8, 1000)):
        monkeypatch.setattr(tq, "RESCORE_THREADS", threads)
        monkeypatch.setattr(tq, "RESCORE_CHUNK_BYTES", chunk_queries * kc * hv.shape[1] * 4)
        got = TStore._host_rescore(_store(hv, metric), q, ids, k)
        for g, w_ in zip(got, want):
            assert g.dtype == w_.dtype
            np.testing.assert_array_equal(g, w_)


def test_host_rescore_spans_split_its_stages(rng):
    hv, q, ids = _rescore_case(rng, "cosine", 4, 20)
    with tracing.trace("rescore", force=True):
        tr = tracing.capture()[0]
        TStore._host_rescore(_store(hv, "cosine"), q, ids, 10)
    spans = {sp["name"]: sp for sp in tr.to_dict()["spans"]}
    assert {"gather_ms", "distance_ms", "blocks"} <= set(spans["store.host_rescore.rows"]["attrs"])
    assert "store.host_rescore.select" in spans


def test_store_rescore_matches_single_block(monkeypatch):
    """Through a real store's search: the threaded, chunked blocks give
    the answer of one block on one thread."""
    rng = np.random.default_rng(3)
    v = rng.standard_normal((2000, 64)).astype(np.float32)
    q = v[:9] + 0.05 * rng.standard_normal((9, 64)).astype(np.float32)
    st = TStore(64, metric="cosine", quantization="bq", device="cpu")
    st.add(v)
    monkeypatch.setattr(tq, "RESCORE_THREADS", 1)
    monkeypatch.setattr(tq, "RESCORE_CHUNK_BYTES", 1 << 30)
    want = st.search(q, 10)
    monkeypatch.setattr(tq, "RESCORE_THREADS", 4)
    monkeypatch.setattr(tq, "RESCORE_BLOCK_ELEMS", 1)
    monkeypatch.setattr(tq, "RESCORE_CHUNK_BYTES", 1)
    got = st.search(q, 10)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g, w_)
