"""The redesigned ``pq4_lut_block`` and ``bm25_block`` of the port
(weaviate_tpu_torch/csrc/pq4_lut_block.cu, bm25_block.cu) and the
single-buffer packing of the fused hybrid dispatch (ops/bm25.py).

The CUDA kernels run only on the card, where chip_smoke.py phase 2 holds
them to their plain versions bit for bit. Here their arithmetic is
emulated on the CPU in the kernels' own order and held to the plain
versions and to the JAX package (Pallas interpreter):

- ``pq4_lut_block``: one tensor-core product per segment (the one-hot of
  the rows' codes times the segment's 16 bf16 entries, each product
  exact), then an f32 sum in segment order. Equal bit for bit; where an
  infinite entry makes the one-hot product NaN, NaN in the same places.
  The one-hot registers the kernel builds with one shift are checked
  against the one-hot itself, and its blocked bf16 table unblocks to
  ``_pq4_lut_table``.
- ``bm25_block``: per-thread register accumulators of a term tile (8, 16,
  32 or 64 terms), each segment adding ``term == t ? contrib : 0`` into
  every accumulator, T past 64 in tiles where groups of segments with no
  term in the tile are skipped. Equal bit for bit.
- the stacked hybrid operands in one host buffer, sent with one copy:
  the same tensors as one copy per array, and the same ``hybrid_topk``
  answers.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from weaviate_tpu.ops import pallas_kernels as pk
from weaviate_tpu_torch.ops import bm25 as tbm25
from weaviate_tpu_torch.ops import kernels as K

MASKED = np.float32(3.0e38)


# -- pq4_lut_block ---------------------------------------------------------------

def _bf16_table(lut: np.ndarray) -> np.ndarray:
    """[B, m, 16] f32 holding the bf16-rounded entries, zero past k."""
    t = torch.from_numpy(lut).to(torch.bfloat16).float().numpy()
    return np.pad(t, ((0, 0), (0, 0), (0, 16 - lut.shape[2])))


def _ftz(x):
    """Subnormals flushed to a zero of their sign."""
    return np.where(np.abs(x) < np.float32(2.0 ** -126), np.copysign(np.float32(0), x), x)


def _emulate_lut(lut, codes, valid, ftz=False):
    """The kernel's order: per segment, the MMA's sum of 16 products of
    the one-hot (1.0 at the row's code, none past 15) and the segment's
    bf16 entries; then an f32 running sum from +0.0 in segment order.
    ``ftz``: every entry and every sum with its subnormals flushed, as
    XLA:CPU computes (the JAX package's interpreter)."""
    flush = _ftz if ftz else (lambda x: x)
    tab = flush(_bf16_table(lut))
    b, m, _ = tab.shape
    acc = np.zeros((b, codes.shape[0]), np.float32)
    with np.errstate(invalid="ignore"):
        for s in range(m):
            prod = np.zeros_like(acc)
            for c in range(16):
                one = (codes[:, s] == c).astype(np.float32)
                prod = prod + one[None, :] * tab[:, s, c][:, None]
            acc = flush(acc + prod)
        if valid is not None:
            acc = acc + (~valid).astype(np.float32)[None, :] * MASKED
    return torch.from_numpy(acc).to(torch.bfloat16)


def _same_bits(got, want):
    """bf16 tensors equal bit for bit, NaN payloads aside."""
    gn, wn = got.isnan(), want.isnan()
    assert torch.equal(gn, wn)
    np.testing.assert_array_equal(got[~gn].view(torch.int16).numpy(),
                                  want[~wn].view(torch.int16).numpy())


def _lut_of(rng, b, m, kc, kind):
    lut = (rng.standard_normal((b, m, kc)) * 3).astype(np.float32)
    if kind == "tiny":  # bf16 subnormals, -0.0 and zeros among small normals
        sub = (rng.integers(-127, 128, (b, m, kc)) * 2.0 ** -133).astype(np.float32)
        pick = rng.random((b, m, kc))
        lut = np.where(pick < 0.6, sub, lut * np.float32(2.0 ** -120)).astype(np.float32)
        lut[pick > 0.9] = -0.0
    elif kind == "inf":
        pick = rng.random((b, m, kc))
        lut[pick < 0.01] = np.inf
        lut[pick > 0.995] = -np.inf
        lut[0, 0, 0] = np.inf
    return lut


# (B, m, k, N, table, valid, top code): ragged m, k < 16, codes past 15,
# all-dead and partly dead rows, B off the kernel's 64-query block,
# subnormal / -0.0 entries, infinite entries
LUT_EMU_CASES = [
    (3, 1, 16, 70, "normal", None, 16), (5, 3, 12, 90, "normal", "part", 18),
    (65, 17, 16, 40, "normal", "dead", 16), (2, 33, 9, 130, "normal", "part", 20),
    (4, 17, 16, 100, "tiny", None, 16), (66, 3, 16, 33, "tiny", "part", 17),
    (3, 33, 16, 60, "inf", None, 16), (2, 5, 12, 80, "inf", "part", 18),
    (1, 40, 16, 50, "tiny", "dead", 18), (7, 1, 3, 20, "inf", None, 20),
]


@pytest.mark.parametrize("b,m,kc,n,kind,vmode,top", LUT_EMU_CASES)
def test_pq4_lut_emulation_equals_plain_and_jax(b, m, kc, n, kind, vmode, top):
    rng = np.random.default_rng([b, m, kc, n, top])
    lut = _lut_of(rng, b, m, kc, kind)
    codes = rng.integers(0, top, (n, m)).astype(np.uint8)
    valid = None if vmode is None else (rng.random(n) > 0.3 if vmode == "part"
                                        else np.zeros(n, bool))
    emu = _emulate_lut(lut, codes, valid)
    plain = K.pq4_lut_block(torch.from_numpy(lut), torch.from_numpy(codes),
                            None if valid is None else torch.from_numpy(valid))
    assert plain.dtype == torch.bfloat16 and plain.shape == (b, n)
    _same_bits(emu, plain)
    jv = None if valid is None else jnp.asarray(valid)
    want = torch.from_numpy(np.array(pk.pq4_lut_block(
        jnp.asarray(lut), jnp.asarray(codes), jv, interpret=True).astype(jnp.float32)))
    if kind == "tiny":
        # the one difference (ROADMAP, deliberate differences): the port
        # keeps subnormal entries and sums, XLA:CPU flushes them to zero;
        # the interpreter's answer is this order with every subnormal flushed
        _same_bits(_emulate_lut(lut, codes, valid, ftz=True), want.to(torch.bfloat16))
        if valid is None or valid.any():
            assert not torch.equal(plain.float(), want)
    else:
        _same_bits(plain, want.to(torch.bfloat16))
    if kind == "inf":  # the one-hot product's 0 * inf: NaN on rows, as the reference
        assert plain.isnan().any()


def _one_hot_pairs(c: int, t: int, byte: int) -> tuple[int, int]:
    """The kernel's A registers of one row for lane t: code c sits in byte
    ``byte`` of a 32-bit code word; (c << 4) comes out of one shift and
    mask, then 0x3F80 (bf16 1.0) shifted by (c << 4) ^ (t << 5) and by
    that ^ 128, a shift of 32 or more giving 0 (shl.b32 clamps)."""
    cw = c << (8 * byte)
    c4 = ((cw << 4) if byte == 0 else (cw >> (8 * byte - 4))) & 0xFF0
    lo = c4 ^ (t << 5)

    def shl(s):
        return (0x3F80 << s) & 0xFFFFFFFF if s < 32 else 0

    return shl(lo), shl(lo ^ 128)


@pytest.mark.parametrize("byte", [0, 1, 2, 3])
def test_pq4_lut_one_hot_registers(byte):
    """Lane t holds k = 2t, 2t + 1 in its first register and 8 + 2t, 9 + 2t
    in its second (the lower k in the low half): together the four lanes
    must hold bf16 1.0 at k = c for c < 16 and nothing for any other code."""
    for c in range(256):
        got = np.zeros(16, np.uint16)
        for t in range(4):
            lo, hi = _one_hot_pairs(c, t, byte)
            for reg, k0 in ((lo, 2 * t), (hi, 8 + 2 * t)):
                got[k0] = reg & 0xFFFF
                got[k0 + 1] = reg >> 16
        want = np.zeros(16, np.uint16)
        if c < 16:
            want[c] = 0x3F80
        np.testing.assert_array_equal(got, want, err_msg=f"code {c}")


@pytest.mark.parametrize("b,m,kc", [(1, 1, 16), (65, 33, 12), (3, 64, 16), (130, 7, 5)])
def test_pq4_lut_block_table_unblocks(b, m, kc):
    rng = np.random.default_rng([b, m, kc])
    lut = torch.from_numpy(_lut_of(rng, b, m, kc, "tiny" if b % 2 else "normal"))
    b_pad = -(-b // K.PQ4_LUT_QBLOCK) * K.PQ4_LUT_QBLOCK
    flat, ks = K.pq4_lut_block_table(lut, b_pad)
    assert flat.dtype == torch.bfloat16 and ks % 32 == 0 and ks >= m
    tab = flat.reshape(b_pad // 8, ks // 32, 32, 2, 8, 8).permute(0, 4, 1, 2, 3, 5)
    tab = tab.reshape(b_pad, ks, 16)
    np.testing.assert_array_equal(tab[:b, :m].float().view(torch.int32).numpy(),
                                  K._pq4_lut_table(lut).view(torch.int32).numpy())
    assert not tab[b:].any() and not tab[:, m:].any()
    # the byte address the kernel's copies and descriptors give entry
    # (query q, segment s, code c): 8 KB blocks of (8 queries, 32
    # segments), 256 bytes a segment, 128 bytes a half of the codes, 16 a
    # query, 2 a code
    raw = flat.view(torch.int16).numpy()
    nk = ks // 32
    for q, s, c in zip(rng.integers(0, b, 50), rng.integers(0, m, 50), rng.integers(0, 16, 50)):
        off = ((q // 8 * nk + s // 32) * 8192 + (s % 32) * 256 + (c // 8) * 128
               + (q % 8) * 16 + (c % 8) * 2)
        want = K._pq4_lut_table(lut)[q, s, c].to(torch.bfloat16).view(torch.int16).item()
        assert raw[off // 2] == want


def test_pq4_lut_block_has_no_segment_limit():
    assert not hasattr(K, "PQ4_LUT_MAX_SEGMENTS")
    rng = np.random.default_rng(5)
    lut = torch.from_numpy(_lut_of(rng, 2, 4000, 16, "normal"))
    codes = torch.from_numpy(rng.integers(0, 16, (9, 4000)).astype(np.uint8))
    got = K.pq4_lut_block(lut, codes)
    _same_bits(got, _emulate_lut(lut.numpy(), codes.numpy(), None))


# -- bm25_block ------------------------------------------------------------------

def _term_tile(t: int) -> int:
    """Terms a tile of the kernel's variant for T."""
    return 8 if t <= 8 else 16 if t <= 16 else 32 if t <= 32 else 64


def _emulate_bm25(tf, ln, term, boost, avg, idf, k1, b, omb, live):
    """The kernel's order: term tiles in ascending order, groups of 16
    segments (past one tile, a group with no term in the tile skipped),
    each segment adding ``term == t ? contrib : 0`` into every accumulator
    of the tile, then the tile's terms saturated and summed."""
    f32 = np.float32
    n_b, n_s, n_c = tf.shape
    n_t = idf.shape[1]
    tt_n = _term_tile(n_t)
    score = np.zeros((n_b, n_c), f32)
    for r in range(n_b):
        for t0 in range(0, n_t, tt_n):
            tn = min(tt_n, n_t - t0)
            acc = np.zeros((tt_n, n_c), f32)
            for g0 in range(0, n_s, 16):
                seg = range(g0, min(g0 + 16, n_s))
                if n_t > tt_n and not any(t0 <= term[r, s] < t0 + tn for s in seg):
                    continue
                for s in seg:
                    norm = omb[r] + (b[r] * ln[r, s]) / avg[r, s]
                    den = np.where(norm < f32(1e-9), f32(1e-9), norm)
                    x = (boost[r, s] * tf[r, s]) / den
                    contrib = np.where(tf[r, s] > f32(0), x, f32(0))
                    for tt in range(tt_n):
                        hit = term[r, s] == t0 + tt
                        acc[tt] = acc[tt] + np.where(hit, contrib, f32(0))
            for tt in range(tn):
                score[r] = score[r] + (idf[r, t0 + tt] * acc[tt]) / (k1[r] + acc[tt])
    return np.where(live, -score, MASKED)


# (B, S, T, C, wild): every term tile, T past one tile, terms out of order
# and outside [0, T), padded segments, boost 0
BM25_EMU_CASES = [(2, 5, 3, 512, False), (3, 13, 12, 512, True), (2, 24, 24, 512, True),
                  (1, 40, 40, 512, False), (2, 70, 70, 512, True), (1, 9, 130, 512, True),
                  (4, 16, 8, 1024, True), (1, 1, 1, 512, False)]


@pytest.mark.parametrize("nb,ns,nt,nc,wild", BM25_EMU_CASES)
def test_bm25_emulation_equals_plain_and_jax(nb, ns, nt, nc, wild):
    rng = np.random.default_rng([nb, ns, nt, nc, int(wild)])
    tf = rng.integers(1, 6, (nb, ns, nc)).astype(np.float32)
    tf[rng.random((nb, ns, nc)) < 0.6] = 0.0
    ln = rng.integers(1, 400, (nb, ns, nc)).astype(np.float32)
    term = rng.integers(0, nt, (nb, ns)).astype(np.int32)  # out of order
    if wild:
        odd = rng.random((nb, ns)) < 0.2
        term[odd] = rng.choice(np.int32([-1, -9, nt, nt + 3]), int(odd.sum()))
    tf[:, -1:] = 0.0  # a padded segment: tf 0, term 0
    term[:, -1] = 0
    boost = rng.choice(np.float32([0.0, 0.5, 1.0, 2.0]), (nb, ns))
    avg = rng.uniform(20.0, 200.0, (nb, ns)).astype(np.float32)
    idf = rng.uniform(0.0, 8.0, (nb, nt)).astype(np.float32)
    k1 = rng.uniform(0.5, 2.0, nb).astype(np.float32)
    b = rng.uniform(0.0, 1.0, nb).astype(np.float32)
    omb = (np.float32(1.0) - b).astype(np.float32)
    live = rng.random((nb, nc)) < 0.9
    bits = K.pack_allow_bitmask(live, nc)
    emu = _emulate_bm25(tf, ln, term, boost, avg, idf, k1, b, omb, live)
    args = [torch.from_numpy(a) for a in (tf, ln, term, boost, avg, idf, k1, b, omb)]
    plain = K.bm25_block(*args, K.as_bits_tensor(bits, "cpu")).numpy()
    np.testing.assert_array_equal(plain.view(np.int32), emu.view(np.int32))
    want = np.asarray(pk.bm25_block(*(jnp.asarray(a) for a in (tf, ln, term, boost, avg, idf,
                                                                k1, b, omb)),
                                    jnp.asarray(bits), interpret=True))
    np.testing.assert_array_equal(plain.view(np.int32), want.view(np.int32))


# -- the single-buffer packing ---------------------------------------------------

def _sparse_ops(rng, rows, n_slots=3000):
    ops = []
    for r in range(rows):
        if r % 3 == 2:
            ops.append(None)  # a pure-vector row in the drain
            continue
        c = int(rng.integers(1, 700))
        s = int(rng.integers(1, 12))
        t = int(rng.integers(1, 10))
        docs = np.sort(rng.choice(n_slots, c, replace=False)).astype(np.int64)
        tf = rng.integers(0, 4, (s, c)).astype(np.float32)
        ops.append(tbm25.SparseOperand(
            docs, docs.astype(np.int32), tf, rng.integers(1, 300, (s, c)).astype(np.float32),
            rng.integers(0, t, s).astype(np.int32), rng.choice(np.float32([0.0, 1.0, 2.0]), s),
            rng.uniform(5.0, 100.0, s).astype(np.float32),
            rng.uniform(0.1, 6.0, t).astype(np.float32), 1.2, 0.75,
            float(np.float32(1.0) - np.float32(0.75)), float(rng.choice([0.0, 0.3, 0.75, 1.0])),
            int(rng.integers(0, 2)), 100))
    return ops


@pytest.mark.parametrize("rows,b_pad", [(1, 1), (5, 8), (8, 8), (3, 16)])
def test_dispatch_pack_equals_per_array_form(rows, b_pad):
    """One buffer with compact planes, expanded on the device, gives the
    tensors of one copy per padded array (``pack_to_device`` of
    ``stack_sparse_operands``), and ``hybrid_program`` the answers of
    ``hybrid_topk`` on them — also padded up to ``GRAPH_SHAPE``, as the
    card runs it."""
    rng = np.random.default_rng([rows, b_pad])
    ops = _sparse_ops(rng, rows)
    pack = tbm25.stack_dispatch_operands(ops, b_pad)
    layout, _ = tbm25._dispatch_layout(*pack["shape"], pack["n"])
    assert all(off % 16 == 0 for *_x, off in layout)
    got = tbm25.dispatch_to_device(pack, "cpu")
    want = tbm25.pack_to_device(tbm25.stack_sparse_operands(ops, b_pad), "cpu")
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        g = got[name]
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.equal(g, w), name
    wide = tbm25.stack_dispatch_operands(ops, b_pad, shape=tbm25.GRAPH_SHAPE)
    assert wide["shape"][1:] == tbm25.GRAPH_SHAPE
    n = 3000
    dn_d = torch.from_numpy(np.sort(rng.random((pack["shape"][0], 128)).astype(np.float32),
                                    axis=1))
    dn_i = torch.from_numpy(rng.integers(0, n, dn_d.shape).astype(np.int32))
    for k in (4, 16):
        a = tbm25.hybrid_topk(dn_d, dn_i, want, k)
        for p in (pack, wide):
            for x, y in zip(a, tbm25.hybrid_program(dn_d, dn_i, p, k)):
                assert torch.equal(x, y)


class _Done:
    """Stands in for a graph's CUDA event: records that it was waited on."""

    def __init__(self, log, key):
        self.log, self.key = log, key

    def synchronize(self):
        self.log.append(self.key)


@pytest.mark.parametrize("new,evicted,fits", [
    (10, [], True),                    # room left: nothing goes
    (20, ["g1"], True),                # the least recently used goes first
    (70, ["g1", "g2"], True),          # exactly full
    (71, ["g1", "g2", "g0"], True),
    (101, [], False),                  # alone past the budget: eager, nothing goes
])
def test_hybrid_graph_cache_bounded_by_bytes(new, evicted, fits):
    """The graph cache keeps at most ``max_bytes``: admitting a graph
    evicts the least recently used, each only after its last replay
    (its event) has finished; a graph larger than the budget is refused."""
    from types import SimpleNamespace

    cache = tbm25._HybridGraphs(max_bytes=100)
    waited = []
    for key in ("g0", "g1", "g2"):
        cache._graphs[key] = SimpleNamespace(nbytes=30, done=_Done(waited, key))
        cache.bytes += 30
    cache._graphs.move_to_end("g0")  # g0 used last: g1 is now the oldest
    assert cache._admit("new", new) is fits
    assert waited == evicted
    assert list(cache._graphs) == [k for k in ("g1", "g2", "g0") if k not in evicted]
    assert cache.bytes == 30 * (3 - len(evicted))
    assert cache.bytes + (new if fits else 0) <= 100


def test_graph_bytes_bounds_the_dispatch_shapes():
    """``graph_bytes`` counts the operand buffer at the full shape plus the
    expansion's intermediates; small batches at ``GRAPH_SHAPE`` fit the
    default budget, and a batch of 256 runs eagerly."""
    for b in (1, 8, 64, 256):
        shape = (b,) + tbm25.GRAPH_SHAPE
        el = b * tbm25.GRAPH_SHAPE[0] * tbm25.GRAPH_SHAPE[2]
        _, buf = tbm25._dispatch_layout(*shape, el)
        assert tbm25.graph_bytes(shape) == buf + el * tbm25._EXPAND_BYTES
    budget = tbm25._HybridGraphs.MAX_BYTES
    assert tbm25.graph_bytes((8,) + tbm25.GRAPH_SHAPE) * 8 <= budget
    assert tbm25.graph_bytes((256,) + tbm25.GRAPH_SHAPE) > budget
