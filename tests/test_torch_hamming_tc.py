"""The redesigned ``bq_hamming_block`` of the port
(weaviate_tpu_torch/csrc/bq_hamming_block.cu on the single-bit tensor-core
body of csrc/bq_block_tc.cuh, shared with ``bq_mxu_block``).

The CUDA kernel runs only on the card, where chip_smoke.py phase 2 holds
it to its plain version bit for bit. Here its arithmetic is emulated on
the CPU in the kernel's own order, from the host layouts its wrapper
builds, and held to the plain version and to the JAX package's
``bq_hamming_block`` run through the Pallas interpreter, on the same
numpy inputs:

- the query operand is ``bq_query_blocks``: blocks of QN queries, each
  followed by 16 all-ones rows, zero-padded to a K step of 8 words;
- each 64-row tile lies in the row ring at its copy offsets, the words
  past W holding whatever the ring held before (here: all ones), rows
  past N zero-filled;
- the product D = popc(x AND q) per K step of 256 bits in int32, read at
  the descriptors' core-matrix addresses; each lane's entries taken at
  the accumulator layout the kernel reads (query 8(i/4) + 2(lane%4) +
  i%2, row 16 warp + lane/4 + 8((i/2)%2)); popc(x) from the all-ones
  columns at the same layout, popc(q) from the query words;
- ham = popc(q) + popc(x) - 2 D in int32, converted to f32 into the
  transposed output tile (row stride 68) and stored a query's 64 rows at
  a time.

All of it is integer arithmetic: no tolerance.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from weaviate_tpu.ops import pallas_kernels as pk
from weaviate_tpu_torch.ops import _build
from weaviate_tpu_torch.ops import kernels as K

TILE = 64


def _words(a):
    """uint32 sign words (numpy) -> the port's int32 tensor, same bits."""
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32).view(np.int32).copy())


def _popc(a):
    return np.unpackbits(np.ascontiguousarray(a, dtype=np.uint32).view(np.uint8),
                         axis=-1).sum(axis=-1).astype(np.int64)


def _ring(x, w):
    """One 64-row tile as the kernel's copies lay it out (uint32 words):
    word j of row r at word (r/8)*8*W8 + (j/4)*32 + (r%8)*4 + j%4; the words
    past W keep what the ring held before (all ones), rows past N are
    zero-filled."""
    w8 = -(-w // 8) * 8
    ring = np.full(TILE * w8, 0xFFFFFFFF, dtype=np.uint32)
    r, j = np.meshgrid(np.arange(TILE), np.arange(w), indexing="ij")
    off = (r >> 3) * 8 * w8 + (j >> 2) * 32 + (r & 7) * 4 + (j & 3)
    rows = np.zeros((TILE, w), dtype=np.uint32)
    rows[:len(x)] = x
    ring[off] = rows
    return ring


def _core_rows(buf, base, rows, step, w8):
    """The 8 words (256 bits) of K step ``step`` of ``rows`` rows read
    through a K-major, no-swizzle descriptor at word ``base`` (LBO 128
    bytes, SBO 32 * W8 bytes)."""
    r = np.arange(rows)[:, None]
    c = np.arange(8)[None, :]
    off = base + (r >> 3) * 8 * w8 + (2 * step + (c >> 2)) * 32 + (r & 7) * 4 + (c & 3)
    return buf[off]


def _lane_entries(qn):
    """(query, row) of every accumulator entry i of every thread tw of a
    warpgroup, as the kernel reads them: [128, qn / 2 + 8] each."""
    tw = np.arange(128)[:, None]
    i = np.arange(qn // 2 + 8)[None, :]
    lane = tw & 31
    row = (tw >> 5) * 16 + (lane >> 2) + 8 * ((i >> 1) & 1)
    col = (i >> 2) * 8 + 2 * (lane & 3) + (i & 1)
    return col, row


def _emulate_hamming(q, x):
    """The tensor-core body with the hamming epilogue, per query block and
    64-row tile, in the kernel's order."""
    b, w = q.shape
    n = x.shape[0]
    qn = K.bq_hamming_qblock(b, w)
    assert qn > 0
    w8 = -(-w // 8) * 8
    blk = K.bq_query_blocks(_words(q), qn).numpy().view(np.uint32)
    os_ = K._BQ_HAM_OS
    col, row = _lane_entries(qn)
    qpop = np.zeros(-(-b // qn) * qn, dtype=np.int32)
    qpop[:b] = _popc(q)  # counted from the words in the kernel
    out = np.full((b, n), np.nan, np.float32)
    for qb in range(-(-b // qn)):
        q0 = qb * qn
        nq = min(qn, b - q0)
        for r0 in range(0, n, TILE):
            ring = _ring(x[r0:r0 + TILE], w)
            d = np.zeros((TILE, qn + 16), dtype=np.int32)
            for step in range(w8 // 8):
                a = _core_rows(ring, 0, TILE, step, w8)
                bm = _core_rows(blk, qb * (qn + 16) * w8, qn + 16, step, w8)
                d += _popc(a[:, None, :] & bm[None, :, :]).astype(np.int32)
            acc = d[row, col]  # [thread, entry]
            # the 16 all-ones columns each give popc(x); the kernel reads two
            assert (d[:, qn:] == d[:, qn:qn + 1]).all()
            xp = np.stack([acc[:, qn // 2 + 2 * r] for r in range(2)], axis=1)
            otile = np.full(qn * os_, np.nan, np.float32)
            e = col[:, :qn // 2]
            r = (np.arange(qn // 2)[None, :] >> 1) & 1
            ham = qpop[q0 + e] + np.take_along_axis(xp, r, axis=1) - 2 * acc[:, :qn // 2]
            otile[e * os_ + row[:, :qn // 2]] = ham.astype(np.float32)
            # each query's 64 rows leave as one run, 4 f32 a store
            nr = min(TILE, n - r0)
            for qi in range(nq):
                for c in range(0, TILE, 4):
                    if c < nr:
                        m = min(4, nr - c)
                        out[q0 + qi, r0 + c:r0 + c + m] = otile[qi * os_ + c:qi * os_ + c + m]
    return out


# (B, N, W): W = 1, 3, 8, 9, 24, 25, 33 (one K step, a full one, one past
# it, the main path's 24, past 32); B = 1, 8, 129 (three query blocks of
# 64); N = 1, 63, 65 and 9001 (off the 64-row tile)
HAM_CASES = [(1, 1, 1), (8, 63, 3), (129, 65, 8), (1, 9001, 9), (8, 9001, 24),
             (129, 63, 25), (8, 65, 33), (129, 9001, 1), (1, 65, 24), (129, 1, 33),
             (8, 1, 9), (1, 63, 8)]


@pytest.mark.parametrize("b,n,w", HAM_CASES)
def test_bq_hamming_emulation_equals_plain_and_jax(b, n, w):
    rng = np.random.default_rng([b, n, w])
    q = rng.integers(0, 2 ** 32, (b, w), dtype=np.uint32)
    x = rng.integers(0, 2 ** 32, (n, w), dtype=np.uint32)
    q[0] = 0
    if n > 1:
        x[1] = 0xFFFFFFFF
    if b > 1:
        q[1] = 0xFFFFFFFF
    emu = _emulate_hamming(q, x)
    plain = K.bq_hamming_block_plain(_words(q), _words(x))
    assert plain.dtype == torch.float32 and plain.shape == (b, n)
    np.testing.assert_array_equal(emu, plain.numpy())
    want = np.asarray(pk.bq_hamming_block(jnp.asarray(q), jnp.asarray(x), interpret=True))
    np.testing.assert_array_equal(plain.numpy(), want)
    # and the wrapper on a CPU tensor is the plain version
    np.testing.assert_array_equal(K.bq_hamming_block(_words(q), _words(x)).numpy(), want)


@pytest.mark.parametrize("b,n,w", [(1, 70, 120), (129, 33, 200)])
def test_bq_hamming_past_the_tensor_core_body(b, n, w):
    """W past the tensor-core body's shared memory: the wrapper keeps the
    popcount body (qblock 0); its plain version still equals the JAX
    package's."""
    assert K.bq_hamming_qblock(b, w) == 0
    rng = np.random.default_rng([b, n, w])
    q = rng.integers(0, 2 ** 32, (b, w), dtype=np.uint32)
    x = rng.integers(0, 2 ** 32, (n, w), dtype=np.uint32)
    want = np.asarray(pk.bq_hamming_block(jnp.asarray(q), jnp.asarray(x), interpret=True))
    np.testing.assert_array_equal(K.bq_hamming_block_plain(_words(q), _words(x)).numpy(), want)


@pytest.mark.parametrize("w", [1, 3, 9, 25, 33])
def test_all_ones_columns_count_only_the_real_words(w):
    """The all-ones rows of the query operand are ones over the W real
    words only, and the zero padding of a K step adds 0 to both popc(x)
    and the product, whatever the row ring holds past W."""
    qn = 8
    w8 = -(-w // 8) * 8
    rng = np.random.default_rng(w)
    x = rng.integers(0, 2 ** 32, (TILE, w), dtype=np.uint32)
    q = rng.integers(0, 2 ** 32, (3, w), dtype=np.uint32)
    blk = K.bq_query_blocks(_words(q), qn).numpy().view(np.uint32)
    ring = _ring(x, w)  # ones past W
    d = np.zeros((TILE, qn + 16), dtype=np.int64)
    for step in range(w8 // 8):
        d += _popc(_core_rows(ring, 0, TILE, step, w8)[:, None, :]
                   & _core_rows(blk, 0, qn + 16, step, w8)[None, :, :])
    np.testing.assert_array_equal(d[:, qn:], np.repeat(_popc(x)[:, None], 16, axis=1))
    np.testing.assert_array_equal(d[:, :3], _popc(x[:, None, :] & q[None, :, :]))
    assert not d[:, 3:qn].any()  # the query rows past B are zero


def test_bq_hamming_qblock_picks_a_body_that_fits():
    # at most BQ_HAM_MAX_QBLOCK = 64 queries: two CTAs an SM
    for b, want in ((1, 8), (8, 8), (9, 16), (17, 32), (64, 64), (65, 64), (129, 64),
                    (256, 64)):
        assert K.bq_hamming_qblock(b, 24) == want
    assert K.bq_hamming_qblock(256, 33) == 64
    assert K.bq_hamming_qblock(256, 96) == 16  # f32 tiles: 64 and 32 queries overflow
    assert K.bq_hamming_smem(128, 24) > 114 * 1024 >= K.bq_hamming_smem(64, 24)
    assert K.bq_hamming_qblock(1, 104) == 8 and K.bq_hamming_qblock(1, 105) == 0
    assert K.bq_hamming_qblock(1, 200) == 0  # too wide for 8 queries: the popcount body
    for b in (1, 7, 100, 300):
        for w in range(1, 130, 7):
            qn = K.bq_hamming_qblock(b, w)
            assert qn == 0 or K.bq_hamming_smem(qn, w) <= K._SMEM_MAX
            assert qn == 0 or K.bq_hamming_smem(qn, w) > K.bq_mxu_smem(qn, w)
    # the host's shared-memory sums are the body's, with each epilogue's stride
    body = open(f"{_build.CSRC}/bq_block_tc.cuh").read()
    consts = dict(re.findall(r"constexpr int (STAGES|TILE|SMEM_MAX) = (\d+);", body))
    assert (int(consts["STAGES"]), int(consts["TILE"]), int(consts["SMEM_MAX"])) == \
        (K._BQ_TC_STAGES, K._BQ_TC_TILE, K._SMEM_MAX)
    assert "2 * qn * EP::OS * (int)sizeof(typename EP::T) + qn * 4 + 16" in body
    ham = open(f"{_build.CSRC}/bq_hamming_block.cu").read()
    assert re.search(r"constexpr int OS = TILE \+ 4;", ham) and K._BQ_HAM_OS == 64 + 4
    assert re.search(r"using T = float;", ham)
    # one body: neither kernel file carries a wgmma of its own
    for name in ("bq_hamming_block", "bq_mxu_block"):
        src = open(f"{_build.CSRC}/{name}.cu").read()
        assert '#include "bq_block_tc.cuh"' in src and "wgmma_b1(" not in src


def test_bq_hamming_output_tile_is_free_of_bank_conflicts():
    """The f32 tile's stride (68 words) puts the 32 lanes' scattered writes
    of one entry on 32 different banks, and a query's 64 rows start on a
    16-byte boundary for the vector reads."""
    os_ = K._BQ_HAM_OS
    col, row = _lane_entries(128)
    for warp in range(4):
        lanes = slice(32 * warp, 32 * warp + 32)
        for i in range(64):
            banks = (col[lanes, i] * os_ + row[lanes, i]) % 32
            assert len(set(banks.tolist())) == 32
    assert (os_ * 4) % 16 == 0
