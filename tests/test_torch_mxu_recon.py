"""The redesigned ``bq_mxu_block`` and ``pq4_recon_block`` of the port
(weaviate_tpu_torch/csrc/bq_mxu_block.cu, pq4_recon_block.cu) and the
operands their wrappers lay out on the host.

The CUDA kernels run only on the card, where chip_smoke.py phase 2 holds
them to their plain versions. Here their arithmetic is emulated on the
CPU in the kernels' own order and held to the plain versions and to the
JAX package (Pallas interpreter), on the same numpy inputs:

- ``bq_mxu_block``: the single-bit product as the kernel forms it (each
  64-row tile laid out by its copy offsets, both operands read at the
  descriptors' core-matrix addresses, popc(x AND q) summed per K step of
  256 bits in int32, popc(x) from the all-ones columns), then the f32
  epilogue ``(qpop + xpop) - 2 dot`` and the mask, rounded to bf16. Equal
  bit for bit: every term is an integer (or the caller's cached f32) and
  the f32 operations are the reference's, in its order.
- ``pq4_recon_block``: x_hat read from the dim-major centroid table at
  the row's codes (equal to the plain version's gather, bit for bit), the
  product summed as f32 partials of 16 dims (a K step of the tensor
  cores), |x_hat|^2 from the centroid-norm table summed per code slice
  and lane as the kernel does, the metric epilogue and the mask. Within
  8e-3 * max(1, max|ref|) (chip_smoke.PQ_TOL, one bf16 ulp at the
  output's scale) of the plain version and of the interpreter: the f32
  sums run in another order; masked entries equal.
- the blocked query words, the bf16 query blocks, the centroid table and
  the norm table unblock to their operands, and the host's shared-memory
  sums are the kernels'.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from weaviate_tpu.ops import pallas_kernels as pk
from weaviate_tpu_torch.ops import _build
from weaviate_tpu_torch.ops import kernels as K

MASKED = np.float32(3.0e38)
PQ_TOL = 8e-3


def _words(a):
    """uint32 sign words (numpy) -> the port's int32 tensor, same bits."""
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32).view(np.int32).copy())


def _popc(a):
    return np.unpackbits(np.ascontiguousarray(a, dtype=np.uint32).view(np.uint8),
                         axis=-1).sum(axis=-1).astype(np.int64)


def _bf16(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(torch.bfloat16)


def _jax_bf16(j):
    return torch.from_numpy(np.array(j.astype(jnp.float32))).to(torch.bfloat16)


# -- bq_mxu_block --------------------------------------------------------------

def _ring(x, w):
    """One 64-row tile as the kernel's copies lay it out: word j of row r
    at byte (r/8)*32*W8 + (j/4)*128 + (r%8)*16 + (j%4)*4; the words past W
    hold whatever the ring held before (here: all ones)."""
    w8 = -(-w // 8) * 8
    ring = np.full(64 * w8 * 4, 0xFF, dtype=np.uint8)
    for r in range(64):
        for j in range(w):
            o = (r >> 3) * 32 * w8 + (j >> 2) * 128 + (r & 7) * 16 + (j & 3) * 4
            word = x[r, j] if r < len(x) else np.uint32(0)  # rows past N: zero-filled
            ring[o:o + 4] = np.frombuffer(np.uint32(word).tobytes(), dtype=np.uint8)
    return ring


def _core_rows(buf, base, rows, step, w8):
    """The 256 bits of K step ``step`` of ``rows`` rows read through a
    K-major, no-swizzle descriptor at ``base`` (LBO 128, SBO 32 * W8)."""
    out = np.zeros((rows, 8), dtype=np.uint32)
    for r in range(rows):
        for c in range(2):
            o = base + (r >> 3) * 32 * w8 + (2 * step + c) * 128 + (r & 7) * 16
            out[r, 4 * c:4 * c + 4] = buf[o:o + 16].view(np.uint32)
    return out


def _emulate_mxu(q, x, qpop, x_pop, valid):
    """The tensor-core body's order, per query block and 64-row tile:
    D = sum over K steps of popc(x AND q) in int32, popc(x) from the
    all-ones columns unless ``x_pop`` is given, then bf16_rn((qpop + xp)
    - 2 D (+ mask)) in f32."""
    b, w = q.shape
    n = x.shape[0]
    qn = K.bq_mxu_qblock(b, w)
    assert qn > 0
    w8 = -(-w // 8) * 8
    blk = K.bq_query_blocks(_words(q), qn).numpy().view(np.uint8)
    out = np.zeros((b, n), np.float32)
    for qb in range(-(-b // qn)):
        for r0 in range(0, n, 64):
            ring = _ring(x[r0:r0 + 64], w)
            d = np.zeros((64, qn + 16), dtype=np.int32)
            for step in range(w8 // 8):
                a = _core_rows(ring, 0, 64, step, w8)
                bm = _core_rows(blk, qb * (qn + 16) * w8 * 4, qn + 16, step, w8)
                d += _popc(a[:, None, :] & bm[None, :, :]).astype(np.int32)
            rows = min(64, n - r0)
            xp = (d[:rows, qn].astype(np.float32) if x_pop is None
                  else x_pop[r0:r0 + rows].astype(np.float32))
            hi = min(b, (qb + 1) * qn)
            qp = qpop[qb * qn:hi].astype(np.float32)
            dot = d[:rows, :hi - qb * qn].T.astype(np.float32)
            v = (qp[:, None] + xp[None, :]) - np.float32(2.0) * dot
            if valid is not None:
                v = v + np.where(valid[r0:r0 + rows], np.float32(0), MASKED)[None, :]
            out[qb * qn:hi, r0:r0 + rows] = v
    return _bf16(out)


# (B, N, W, dead rows, cached x_pop, q_planes): W = 48 crosses the 256-bit
# bf16 rounding; B = 129 takes two query blocks of 128
MXU_CASES = [(1, 70, 1, False, False, False), (5, 130, 3, True, False, False),
             (8, 65, 8, True, True, False), (17, 100, 9, False, False, True),
             (129, 70, 48, True, True, True), (8, 200, 4, True, False, True),
             (5, 64, 48, False, True, False), (17, 1, 3, True, False, False)]


@pytest.mark.parametrize("b,n,w,masked,xpop,planes", MXU_CASES)
def test_bq_mxu_emulation_equals_plain_and_jax(b, n, w, masked, xpop, planes):
    rng = np.random.default_rng([b, n, w, masked, xpop, planes])
    q = rng.integers(0, 2 ** 32, (b, w), dtype=np.uint32)
    x = rng.integers(0, 2 ** 32, (n, w), dtype=np.uint32)
    q[0] = 0
    if n > 1:
        x[1] = 0xFFFFFFFF
    valid = rng.random(n) > 0.3 if masked else None
    x_pop = rng.uniform(0, 32 * w, n).astype(np.float32) if xpop else None
    tkw, jkw = {}, {}
    if valid is not None:
        tkw["valid"], jkw["valid"] = torch.from_numpy(valid), jnp.asarray(valid)
    if x_pop is not None:
        tkw["x_pop"], jkw["x_pop"] = torch.from_numpy(x_pop), jnp.asarray(x_pop)
    qpop = _popc(q).astype(np.float32)
    if planes:  # the planes stand in for the words, q_pop is used as given
        tkw["q_planes"] = K.bq_queries_to_planes(_words(q), w)
        tkw["q_pop"] = tkw["q_planes"].float().sum(dim=1)
        pad = np.pad(q, ((0, -b % 8), (0, 0)))  # the reference's 8-row sublane
        jkw["q_planes"] = pk.bq_queries_to_planes(jnp.asarray(pad), w)
        jkw["q_pop"] = jnp.sum(jkw["q_planes"].astype(jnp.float32), axis=1, keepdims=True)
    emu = _emulate_mxu(q, x, qpop, x_pop, valid)
    plain = K.bq_mxu_block_plain(_words(q), _words(x), **tkw)
    assert plain.dtype == torch.bfloat16 and plain.shape == (b, n)
    np.testing.assert_array_equal(emu.view(torch.int16).numpy(),
                                  plain.view(torch.int16).numpy())
    want = _jax_bf16(pk.bq_mxu_block(jnp.asarray(q), jnp.asarray(x), interpret=True, **jkw))
    np.testing.assert_array_equal(plain.view(torch.int16).numpy(),
                                  want.view(torch.int16).numpy())


def test_bq_mxu_qblock_picks_a_body_that_fits():
    for b, want in ((1, 8), (8, 8), (9, 16), (17, 32), (64, 64), (129, 128), (1024, 128)):
        assert K.bq_mxu_qblock(b, 24) == want
    assert K.bq_mxu_qblock(256, 96) == 32  # 128 and 64 queries of 96 words overflow
    assert K.bq_mxu_qblock(1, 200) == 0  # too wide for 8 queries: the popcount body
    for b in (1, 7, 100, 300):
        for w in range(1, 130, 7):
            qn = K.bq_mxu_qblock(b, w)
            assert qn == 0 or K.bq_mxu_smem(qn, w) <= K._SMEM_MAX
    # the host's shared-memory sum is the kernel's (its body is shared with
    # bq_hamming_block in bq_block_tc.cuh, its epilogue's stride is its own)
    src = open(f"{_build.CSRC}/bq_mxu_block.cu").read() + \
        open(f"{_build.CSRC}/bq_block_tc.cuh").read()
    consts = dict(re.findall(r"constexpr int (STAGES|TILE|SMEM_MAX) = (\d+);", src))
    assert (int(consts["STAGES"]), int(consts["TILE"]), int(consts["SMEM_MAX"])) == \
        (K._BQ_TC_STAGES, K._BQ_TC_TILE, K._SMEM_MAX)
    assert re.search(r"constexpr int OS = TILE \+ 8;", src) and K._BQ_MXU_OS == 64 + 8


@pytest.mark.parametrize("b,w,qn", [(1, 1, 8), (5, 9, 8), (17, 48, 32), (129, 3, 128)])
def test_bq_mxu_query_blocks_unblock(b, w, qn):
    rng = np.random.default_rng([b, w, qn])
    q = rng.integers(0, 2 ** 32, (b, w), dtype=np.uint32)
    w8 = -(-w // 8) * 8
    flat = K.bq_query_blocks(_words(q), qn).numpy().view(np.uint32)
    blocks = flat.reshape(-1, qn // 8 + 2, w8 // 4, 8, 4).transpose(0, 1, 3, 2, 4) \
        .reshape(-1, qn + 16, w8)
    np.testing.assert_array_equal(blocks[:, :qn].reshape(-1, w8)[:b, :w], q)
    assert not blocks[:, :qn].reshape(-1, w8)[b:].any() and not blocks[:, :, w:].any()
    assert (blocks[:, qn:, :w] == 0xFFFFFFFF).all()


# -- pq4_recon_block -------------------------------------------------------------

def _recon_case(rng, b, m, kc, ds, n, vmode, top, metric):
    q = rng.standard_normal((b, m * ds)).astype(np.float32)
    if metric == "cosine":
        q /= np.linalg.norm(q, axis=1, keepdims=True)
    cent = rng.standard_normal((m, kc, ds)).astype(np.float32)
    codes = rng.integers(0, top, (n, m)).astype(np.uint8)
    valid = None if vmode is None else (rng.random(n) > 0.3 if vmode == "part"
                                        else np.zeros(n, bool))
    return q, cent, codes, valid


def _xhat_from_table(codes, cent):
    """x_hat as the kernel reads it: table[min(code, 16), k] at each dim."""
    m, kc, ds = cent.shape
    table = K.pq4_recon_table(torch.from_numpy(cent)).float().numpy()
    k = np.arange(m * ds)
    c = np.minimum(codes[:, k // ds].astype(np.int64), 16)
    return table[c, k[None, :]]


def _emulate_recon(q, codes, cent, metric, valid):
    """The tensor-core body's order: q . x_hat as f32 partials of 16 dims
    (one K step) added in K order; |x_hat|^2 per code slice of 64
    segments, each of the four lanes summing the norm table at segments
    t, t + 4, ..., then the lanes' sums added pairwise; the plain
    epilogue and the mask in f32, rounded to bf16."""
    m, kc, ds = cent.shape
    b, d = q.shape
    d16 = -(-d // 16) * 16
    qb = torch.from_numpy(q).to(torch.bfloat16).float().numpy()
    qb = np.pad(qb, ((0, 0), (0, d16 - d)))
    xh = np.pad(_xhat_from_table(codes, cent), ((0, 0), (0, d16 - d)))
    dot = np.zeros((b, len(codes)), np.float32)
    for k0 in range(0, d16, 16):
        dot = dot + (qb[:, None, k0:k0 + 16] * xh[None, :, k0:k0 + 16]).sum(axis=2,
                                                                         dtype=np.float32)
    if metric == "l2-squared":
        norms = K.pq4_recon_norms(torch.from_numpy(cent)).numpy()
        ms = norms.shape[0]
        cp = np.pad(np.minimum(codes.astype(np.int64), 16), ((0, 0), (0, ms - m)))
        lane = np.zeros((len(codes), 4), np.float32)
        for s0 in range(0, ms, 64):
            for t in range(4):
                part = np.zeros(len(codes), np.float32)
                for sg in range(s0 + t, s0 + 64, 4):
                    part = part + norms[sg, cp[:, sg]]
                lane[:, t] = lane[:, t] + part
        xn = (lane[:, 0] + lane[:, 1]) + (lane[:, 2] + lane[:, 3])
        qn = (qb * qb).sum(axis=1, dtype=np.float32)
        v = (qn[:, None] - np.float32(2.0) * dot) + xn[None, :]
    elif metric == "dot":
        v = -dot
    else:
        v = np.float32(1.0) - dot
    if valid is not None:
        v = v + np.where(valid, np.float32(0), MASKED)[None, :]
    return _bf16(v)


def _close(got, want):
    """Within PQ_TOL * max(1, max|ref|) on live entries, masked entries equal."""
    g, w = got.float().numpy(), want.float().numpy()
    live = w < 1e38
    if live.any():
        tol = PQ_TOL * max(1.0, float(np.abs(w[live]).max()))
        np.testing.assert_allclose(g[live], w[live], rtol=0, atol=tol)
    np.testing.assert_array_equal(g[~live], w[~live])


# (B, m, k, ds, N, valid, top code): ds 1, 2, 3, 4, 8; d = m * ds not a
# multiple of 16 (25 * 3, 7 * 2, 33 * 1, 5 * 3), k < 16, codes past 15
# (top 20), all-dead and partly dead rows, B past one 64-query block
RECON_EMU_CASES = [(3, 24, 16, 4, 70, "part", 16), (5, 25, 12, 3, 90, None, 20),
                   (2, 7, 16, 2, 40, "dead", 18), (65, 33, 9, 1, 30, "part", 16),
                   (4, 12, 16, 8, 50, None, 17), (1, 5, 16, 3, 64, "part", 16),
                   (6, 96, 16, 8, 20, "part", 20), (2, 130, 16, 1, 25, None, 16)]


@pytest.mark.parametrize("metric", ["l2-squared", "dot", "cosine"])
@pytest.mark.parametrize("b,m,kc,ds,n,vmode,top", RECON_EMU_CASES)
def test_pq4_recon_emulation_within_tol_of_plain_and_jax(metric, b, m, kc, ds, n, vmode, top):
    rng = np.random.default_rng([b, m, kc, ds, n, top])
    q, cent, codes, valid = _recon_case(rng, b, m, kc, ds, n, vmode, top, metric)
    tv = None if valid is None else torch.from_numpy(valid)
    plain = K.pq4_recon_block_plain(torch.from_numpy(q), torch.from_numpy(codes),
                                    torch.from_numpy(cent), metric, tv)
    assert plain.dtype == torch.bfloat16 and plain.shape == (b, n)
    emu = _emulate_recon(q, codes, cent, metric, valid)
    _close(emu, plain)
    want = _jax_bf16(pk.pq4_recon_block(
        jnp.asarray(q), jnp.asarray(codes), jnp.asarray(cent), metric=metric,
        valid=None if valid is None else jnp.asarray(valid), interpret=True))
    _close(emu, want)
    _close(plain, want)


@pytest.mark.parametrize("m,kc,ds,top", [(24, 16, 4, 16), (25, 12, 3, 20), (33, 9, 1, 17),
                                         (12, 16, 8, 16), (7, 5, 2, 20)])
def test_pq4_recon_table_gives_the_plain_x_hat(m, kc, ds, top):
    """x_hat from the dim-major table equals the plain version's gather
    bit for bit (codes past k read zeros, codes past 15 the zero row)."""
    rng = np.random.default_rng([m, kc, ds, top])
    cent = rng.standard_normal((m, kc, ds)).astype(np.float32)
    codes = rng.integers(0, top, (40, m)).astype(np.uint8)
    cb = K._pq4_recon_centroids(torch.from_numpy(cent))
    cb = torch.nn.functional.pad(cb, (0, 0, 0, 1))
    seg = torch.arange(m)
    want = cb[seg[None, :], K._pq4_codes_idx(torch.from_numpy(codes))].reshape(40, m * ds)
    got = _xhat_from_table(codes, cent)
    np.testing.assert_array_equal(got.view(np.int32), want.numpy().view(np.int32))


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("b,d", [(1, 16), (5, 75), (64, 96), (65, 14), (130, 33)])
def test_pq4_recon_query_blocks_unblock(b, d, fast):
    rng = np.random.default_rng([b, d])
    qb = torch.from_numpy(rng.standard_normal((b, d)).astype(np.float32)).to(torch.bfloat16)
    flat = K.pq4_recon_query_blocks(qb, fast)
    d16, n_qb = -(-d // 16) * 16, -(-b // 64)
    assert flat.dtype == torch.bfloat16 and flat.shape == (n_qb * 64 * d16,)
    q = flat.reshape(n_qb, 8, d16 // 8, 8, 8).permute(0, 1, 3, 2, 4).reshape(n_qb * 64, d16)
    if fast:  # slot j of each 16 holds dim _RECON_FAST_DIMS[j]: undo it
        inv = np.argsort(K._RECON_FAST_DIMS)
        q = q.reshape(-1, d16 // 16, 16)[:, :, inv].reshape(-1, d16)
    np.testing.assert_array_equal(q[:b, :d].view(torch.int16).numpy(),
                                  qb.view(torch.int16).numpy())
    assert not q[b:].any() and not q[:, d:].any()
    # the descriptor's addresses: query i, slot k at group i/8 (16 * d16
    # bytes), chunk k/8 (128 bytes), row i%8 (16 bytes), element k%8
    raw = flat.view(torch.int16).numpy()
    dims = K._RECON_FAST_DIMS if fast else tuple(range(16))
    for i, k in zip(rng.integers(0, b, 30), rng.integers(0, d16, 30)):
        off = ((i // 64) * 64 * d16 * 2 + (i % 64 // 8) * 16 * d16 + (k // 8) * 128
               + (i % 8) * 16 + (k % 8) * 2)
        dim = k // 16 * 16 + dims[k % 16]
        want = qb[i, dim].view(torch.int16).item() if dim < d else 0
        assert raw[off // 2] == want


@pytest.mark.parametrize("m,b", [(64, 3), (128, 70)])
def test_pq4_recon_fast_operands_give_the_product(m, b):
    """The fast path's operands as the kernel reads them: lane t of K step
    kk holds, in its two A registers of a row, the whole centroid of
    segment 4kk + t (one 8-byte load of the table at the row's code), and
    B is read from the permuted query blocks at the descriptor's slots
    2t, 2t + 1 (dims 0, 1) and 8 + 2t, 9 + 2t (dims 2, 3). Summed over the
    slots and K steps they give q . x_hat of the plain version."""
    ds, n = 4, 9
    assert K.pq4_recon_fast(m, ds) and not K.pq4_recon_fast(m + 16, ds)
    rng = np.random.default_rng([m, b])
    q = rng.standard_normal((b, m * ds)).astype(np.float32)
    cent = rng.standard_normal((m, 16, ds)).astype(np.float32)
    codes = rng.integers(0, 18, (n, m)).astype(np.uint8)
    d16 = m * ds
    qb = torch.from_numpy(q).to(torch.bfloat16)
    raw = K.pq4_recon_query_blocks(qb, True).float().numpy()
    table = K.pq4_recon_table(torch.from_numpy(cent)).float().numpy()
    ts = table.shape[1]
    flat_tab = table.reshape(-1)
    dot = np.zeros((n, b))
    for kk in range(d16 // 16):
        a = np.zeros((n, 16))
        for t in range(4):
            code = np.minimum(codes[:, 4 * kk + t], 16).astype(np.int64)
            base = code * ts + 16 * kk + 4 * t  # the 8-byte load
            a[:, 2 * t:2 * t + 2] = flat_tab[base[:, None] + np.arange(2)]
            a[:, 8 + 2 * t:10 + 2 * t] = flat_tab[base[:, None] + 2 + np.arange(2)]
        bm = np.zeros((16, b))
        for i in range(b):
            for j in range(16):
                off = ((i // 64) * 64 * d16 + (i % 64 // 8) * 8 * d16
                       + (2 * kk + j // 8) * 64 + (i % 8) * 8 + j % 8)
                bm[j, i] = raw[off]
        dot += a @ bm
    xh = _xhat_from_table(codes, cent).astype(np.float64)
    want = xh @ qb.float().numpy().astype(np.float64).T
    np.testing.assert_allclose(dot, want, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("m,kc,ds", [(24, 16, 4), (25, 12, 3), (33, 9, 1), (384, 16, 2)])
def test_pq4_recon_tables_unblock(m, kc, ds):
    rng = np.random.default_rng([m, kc, ds])
    cent = torch.from_numpy(rng.standard_normal((m, kc, ds)).astype(np.float32))
    d, d16 = m * ds, -(-m * ds // 16) * 16
    table = K.pq4_recon_table(cent)
    ts = table.shape[1]
    assert table.dtype == torch.bfloat16 and table.shape == (17, K._recon_row_stride(d16))
    assert d16 <= ts < d16 + 64 and ts % 64 == 16  # rows of two codes 8 banks apart
    cb = cent.to(torch.bfloat16)
    for c in range(kc):
        np.testing.assert_array_equal(table[c, :d].view(torch.int16).numpy(),
                                      cb[:, c, :].reshape(-1).view(torch.int16).numpy())
    assert not table[kc:].any() and not table[:, d:].any()
    norms = K.pq4_recon_norms(cent)
    nks = d16 // 16
    assert norms.dtype == torch.float32 and norms.shape == (-(-nks // (4 * ds)) * 64, 17)
    assert norms.shape[0] >= m and norms.shape[0] % 64 == 0
    cf = cb.float()
    np.testing.assert_array_equal(norms[:m, :kc].numpy(), (cf * cf).sum(dim=2).numpy())
    assert not norms[m:].any() and not norms[:, kc:].any()


def test_pq4_recon_smem_is_the_kernels():
    src = open(f"{_build.CSRC}/pq4_recon_block.cu").read()
    consts = dict(re.findall(r"constexpr int (QB|SC|STAGES|SMEM_MAX) = (\d+);", src))
    assert (int(consts["QB"]), int(consts["SC"]), int(consts["STAGES"]),
            int(consts["SMEM_MAX"])) == (K.PQ4_RECON_QBLOCK, K._RECON_SLICE, K._RECON_STAGES,
                                         K._SMEM_MAX)
    assert "constexpr int ROWS = 2 * SPP * 64;" in src and K._RECON_ROWS == 2 * 2 * 64
    assert "constexpr int OS = SPP * 64 + 8;" in src and K._RECON_OS == 2 * 64 + 8
    assert "return ds == 4 && m % 64 == 0;" in src  # recon_fast, as pq4_recon_fast
    # the main shape and phase 2's ragged m = 384 take the tensor-core body
    assert K.pq4_recon_smem(768, 192, 4, "l2-squared") <= K._SMEM_MAX
    assert K.pq4_recon_smem(768, 384, 2, "l2-squared") <= K._SMEM_MAX
    assert K.pq4_recon_smem(1024, 256, 4, "cosine") > K._SMEM_MAX  # the FFMA body
