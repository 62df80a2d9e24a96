"""Hand-written CUDA kernels of the flat scans, with their plain versions.

Port of ``weaviate_tpu/ops/pallas_kernels.py`` for the kernels on the
flat nearVector path and the quantized flat path:

- ``distance_block``    masked [B,d] x [N,d] -> [B,N] distances
                        (csrc/distance_block.cu)
- ``fused_topk_scan``   the same distances folded into an exact per-query
                        top-k, never written out (csrc/fused_topk_scan.cu;
                        its per-slice partials merge through the pairs
                        kernel)
- ``fused_topk_pairs``  exact top-k over (value, id) candidate pairs
                        (csrc/fused_topk_pairs.cu)
- ``bq_scan_reduce``    hamming over packed sign words with a strided
                        block-argmin: one candidate per ``reduce_l`` rows
                        (csrc/bq_scan_reduce.cu)
- ``pq4_scan_reduce``   4-bit PQ ADC through a per-query int8 LUT with the
                        same strided block-argmin (csrc/pq4_scan_reduce.cu)

Each wrapper takes its plain PyTorch version (``*_plain``) only when the
tensors it is given lie on the CPU — the tests run that way. On a CUDA
tensor it launches its kernel or raises; it never falls back. Every launch
adds one to ``launch_counts[name]``.

Also here: the block-strided per-query allow bitmask of the reference
(``MASK_BLOCK`` layout), bit-identical to ``pack_allow_bitmask`` there.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from weaviate_tpu_torch.ops.distances import MASKED_DISTANCE, normalize, sq_norms

# Metrics with a hand-written kernel; hamming and manhattan stay plain
# torch (elementwise 3D intermediates — nothing for a kernel to win).
KERNEL_METRICS = ("l2-squared", "dot", "cosine", "cosine-dot")
_METRIC_ID = {"l2-squared": 0, "dot": 1, "cosine": 2, "cosine-dot": 2}

FUSED_TOPK_MAX_K = 128
FUSED_PAIRS_MAX_K = 256

launch_counts = {"distance_block": 0, "fused_topk_scan": 0,
                 "fused_topk_pairs": 0, "bq_scan_reduce": 0,
                 "pq4_scan_reduce": 0}
_count_lock = threading.Lock()


def _count(name: str) -> None:
    with _count_lock:
        launch_counts[name] += 1


def reset_launch_counts() -> None:
    with _count_lock:
        for name in launch_counts:
            launch_counts[name] = 0


def _pad_to(n: int, m: int) -> int:
    return (n + m - 1) // m * m


# -- per-query allow bitmasks -------------------------------------------------
#
# Within each MASK_BLOCK-column block, the block's W = MASK_BLOCK/32 words
# hold   bit j of word w  =  allow[block_base + j*W + w]
# (lane l of block b is bit l // 16 of word b*16 + l % 16), the layout
# of the reference's in-VMEM unpack. The kernels read it word by word.

MASK_BLOCK = 512
_MASK_WORDS = MASK_BLOCK // 32  # 16 words per block


def mask_pad_cols(n: int) -> int:
    """Packed-mask column count covering ``n`` corpus rows."""
    return _pad_to(max(n, 1), MASK_BLOCK)


def pack_allow_bitmask(allow, n_cols: int | None = None) -> np.ndarray:
    """Host-side packer: allow [B, C] (or [C]) bool -> uint32
    [B, n_cols // 32] in block-strided order. Columns past C pack as 0."""
    allow = np.asarray(allow, dtype=bool)
    if allow.ndim == 1:
        allow = allow[None, :]
    b, c = allow.shape
    if n_cols is None:
        n_cols = mask_pad_cols(c)
    buf = np.zeros((b, n_cols), dtype=bool)
    keep = min(c, n_cols)
    buf[:, :keep] = allow[:, :keep]
    # [B, block, j, w] -> bits j of word w: packbits over j, little-endian
    a = buf.reshape(b, n_cols // MASK_BLOCK, 32, _MASK_WORDS).transpose(0, 1, 3, 2)
    packed = np.packbits(a, axis=-1, bitorder="little")  # [B, block, w, 4] bytes
    return packed.view("<u4").astype(np.uint32).reshape(b, n_cols // 32)


def pack_allow_bitmask_t(allow: torch.Tensor) -> torch.Tensor:
    """Tensor twin of ``pack_allow_bitmask``: [B, C] bool -> int32
    [B, mask_pad_cols(C) // 32] holding the same 32-bit words (torch
    keeps them as int32; the kernels read them as uint32)."""
    b, c = allow.shape
    n_cols = mask_pad_cols(c)
    a = torch.zeros((b, n_cols), dtype=torch.int64, device=allow.device)
    a[:, :c] = allow.to(torch.int64)
    a = a.reshape(b, n_cols // MASK_BLOCK, 32, _MASK_WORDS)
    shifts = torch.arange(32, dtype=torch.int64, device=allow.device)
    words = (a << shifts[None, None, :, None]).sum(dim=2)
    # the sum is < 2**32; fold into int32's range keeping the bit pattern
    words = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
    return words.to(torch.int32).reshape(b, n_cols // 32)


def as_bits_tensor(bits, device) -> torch.Tensor:
    """Packed words (numpy uint32 or a tensor) -> int32 tensor on device."""
    if isinstance(bits, torch.Tensor):
        return bits.to(device=device, dtype=torch.int32)
    arr = np.ascontiguousarray(np.asarray(bits, dtype=np.uint32)).view(np.int32)
    return torch.from_numpy(arr).to(device)


def unpack_allow_bitmask(bits: torch.Tensor, n_cols: int | None = None) -> torch.Tensor:
    """Inverse of the packer: [B, W] words -> [B, n_cols] bool."""
    b, w_total = bits.shape
    total = w_total * 32
    a = bits.to(torch.int64).reshape(b, total // MASK_BLOCK, 1, _MASK_WORDS)
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    cols = ((a >> shifts[None, None, :, None]) & 1).reshape(b, total)
    out = cols.bool()
    if n_cols is not None and n_cols != total:
        if n_cols < total:
            out = out[:, :n_cols]
        else:
            pad = torch.zeros((b, n_cols - total), dtype=torch.bool, device=bits.device)
            out = torch.cat([out, pad], dim=1)
    return out


def allow_bits_for_ids(bits: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Per-candidate allow lookup: ``bits`` [Ba, W] (``Ba == 1``
    broadcasts), ``ids`` [B, C] global column ids -> [B, C] bool. Ids
    outside [0, 32·W), the -1 sentinel included, read as disallowed."""
    b, c = ids.shape
    n_cols = bits.shape[1] * 32
    ids = ids.to(torch.int64)
    safe = ids.clamp(0, n_cols - 1)
    off = safe % MASK_BLOCK
    word = (safe // MASK_BLOCK) * _MASK_WORDS + (off % _MASK_WORDS)
    bit = off // _MASK_WORDS
    wb = bits.to(torch.int64).expand(b, bits.shape[1])
    w = torch.gather(wb, 1, word)
    ok = ((w >> bit) & 1) != 0
    return ok & (ids >= 0) & (ids < n_cols)


# -- exact selection shared by the plain versions and ops/topk.py ------------

def smallest_positions(vals: torch.Tensor, k: int) -> torch.Tensor:
    """Positions [B, k] of the k smallest entries of each row of ``vals``
    [B, M] f32, ascending, ties to the lower position (``lax.top_k``'s
    rule, which ``torch.topk`` does not promise). Each entry gets one
    int64 key, its order-preserving float bits above its position, so the
    keys are unique and the selection is exact."""
    b, m = vals.shape
    bits = (vals.float() + 0.0).view(torch.int32).to(torch.int64)  # -0.0 -> +0.0
    key = torch.where(bits >= 0, bits + 2 ** 31, -1 - bits)
    pos = torch.arange(m, dtype=torch.int64, device=vals.device)
    return torch.topk(key * 2 ** 31 + pos, k, dim=1, largest=False, sorted=True).indices


# -- distance_block ----------------------------------------------------------

def _kernel_query(q: torch.Tensor, metric: str) -> torch.Tensor:
    q = q.float()
    if metric in ("cosine", "cosine-dot"):
        q = normalize(q)
    return q.contiguous()


def _distances_plain(q, x, metric, x_sq_norms):
    """The kernels' distance epilogue, unmasked: f32 q . x^T, then the
    l2 / dot / cosine form of ``pallas_kernels._distance_kernel``."""
    q = _kernel_query(q, metric)
    dots = q @ x.float().T
    if metric == "l2-squared":
        qn = (q * q).sum(dim=1)
        xn = sq_norms(x) if x_sq_norms is None else x_sq_norms.float()
        return torch.clamp(qn[:, None] - 2.0 * dots + xn[None, :], min=0.0)
    if metric == "dot":
        return -dots
    return 1.0 - dots


def distance_block_plain(q, x, metric="l2-squared", valid=None, x_sq_norms=None):
    """Plain PyTorch version of ``distance_block``: dead rows get
    + MASKED_DISTANCE (an add, as in the reference's epilogue)."""
    d = _distances_plain(q, x, metric, x_sq_norms)
    if valid is not None:
        d = d + (1.0 - valid.float())[None, :] * MASKED_DISTANCE
    return d


def _check_kernel_operands(q, x, metric, valid, x_sq_norms):
    if metric not in KERNEL_METRICS:
        raise ValueError(f"no CUDA kernel for metric {metric!r}")
    if q.ndim != 2 or x.ndim != 2 or q.shape[1] != x.shape[1]:
        raise ValueError(f"shapes q {tuple(q.shape)} / x {tuple(x.shape)} do not match")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"corpus dtype {x.dtype} has no kernel (float32 or bfloat16)")
    if not x.is_contiguous():
        raise ValueError("corpus must be contiguous")
    if q.device != x.device:
        raise ValueError(f"q on {q.device}, x on {x.device}")
    n = x.shape[0]
    if valid is not None and (valid.device != x.device or valid.shape != (n,)
                              or valid.dtype != torch.bool):
        raise ValueError("valid must be a [N] bool tensor on the corpus device")
    if x_sq_norms is not None and (x_sq_norms.device != x.device
                                   or x_sq_norms.shape != (n,)):
        raise ValueError("x_sq_norms must be a [N] tensor on the corpus device")


def _kernel_args(q, x, metric, valid, x_sq_norms):
    """Device operands shared by the scan kernels: f32 query rows (unit
    length for cosine), their squared norms and the corpus norms (l2
    only), and whether every row is 16-byte aligned for cp.async."""
    q = _kernel_query(q, metric)
    qn = xn = None
    if metric == "l2-squared":
        qn = (q * q).sum(dim=1).contiguous()
        xn = (sq_norms(x) if x_sq_norms is None else x_sq_norms.float()).contiguous()
    valid = None if valid is None else valid.contiguous()
    d = x.shape[1]
    async_ok = (d % 4 == 0 and (d * x.element_size()) % 16 == 0
                and q.data_ptr() % 16 == 0 and x.data_ptr() % 16 == 0)
    return q, qn, xn, valid, async_ok


def _ptr(t):
    return None if t is None else t.data_ptr()


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _check_rc(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {rc}")


def distance_block(q: torch.Tensor, x: torch.Tensor, metric: str = "l2-squared",
                   valid: torch.Tensor | None = None,
                   x_sq_norms: torch.Tensor | None = None) -> torch.Tensor:
    """Fused masked distances: q [B,d] vs x [N,d] -> [B,N] f32, lower =
    closer, dead rows + MASKED_DISTANCE. CUDA tensors launch
    csrc/distance_block.cu; CPU tensors take ``distance_block_plain``."""
    _check_kernel_operands(q, x, metric, valid, x_sq_norms)
    if x.device.type == "cpu":
        return distance_block_plain(q, x, metric, valid, x_sq_norms)
    from weaviate_tpu_torch.ops import _build

    qk, qn, xn, valid, async_ok = _kernel_args(q, x, metric, valid, x_sq_norms)
    b, n = qk.shape[0], x.shape[0]
    out = torch.empty((b, n), dtype=torch.float32, device=x.device)
    rc = _build.kernel("distance_block")(
        qk.data_ptr(), _ptr(qn), x.data_ptr(), int(x.dtype == torch.bfloat16),
        _ptr(xn), _ptr(valid), b, n, x.shape[1], _METRIC_ID[metric],
        out.data_ptr(), int(async_ok), _stream(x.device))
    _check_rc("distance_block", rc)
    _count("distance_block")
    return out


# -- fused_topk_pairs ----------------------------------------------------------

def fused_topk_pairs_plain(vals: torch.Tensor, ids: torch.Tensor, k: int):
    """Plain version of ``fused_topk_pairs``: entries below
    MASKED_DISTANCE, stably sorted (ties to the earlier position), first
    k; unfilled slots are (MASKED_DISTANCE, -1)."""
    b, m = vals.shape
    vals = vals.float()
    live = vals < MASKED_DISTANCE  # False for NaN too: never surfaces
    keyed = torch.where(live, vals, torch.full_like(vals, float("inf")))
    kk = min(k, m)
    pos = smallest_positions(keyed, kk)
    out_d = torch.full((b, k), MASKED_DISTANCE, dtype=torch.float32, device=vals.device)
    out_i = torch.full((b, k), -1, dtype=torch.int32, device=vals.device)
    sel_live = torch.gather(live, 1, pos)
    sel_d = torch.gather(vals, 1, pos)
    sel_i = torch.gather(ids.to(torch.int32), 1, pos)
    out_d[:, :kk] = torch.where(sel_live, sel_d, torch.full_like(sel_d, MASKED_DISTANCE))
    out_i[:, :kk] = torch.where(sel_live, sel_i, torch.full_like(sel_i, -1))
    return out_d, out_i


def fused_topk_pairs(vals: torch.Tensor, ids: torch.Tensor, k: int):
    """EXACT top-k over explicit (vals [B,M] f32, ids [B,M] i32) pairs ->
    ([B,k] f32 ascending, [B,k] i32). Entries >= MASKED_DISTANCE never
    surface. CUDA tensors launch csrc/fused_topk_pairs.cu."""
    if not 1 <= k <= FUSED_PAIRS_MAX_K:
        raise ValueError(f"fused pairs top-k requires 1 <= k <= 256, got {k}")
    if vals.ndim != 2 or vals.shape != ids.shape:
        raise ValueError(f"vals {tuple(vals.shape)} and ids {tuple(ids.shape)} must be [B, M]")
    if vals.device != ids.device:
        raise ValueError(f"vals on {vals.device}, ids on {ids.device}")
    if vals.device.type == "cpu":
        return fused_topk_pairs_plain(vals, ids, k)
    from weaviate_tpu_torch.ops import _build

    vals = vals.float().contiguous()
    ids = ids.to(torch.int32).contiguous()
    b, m = vals.shape
    out_d = torch.empty((b, k), dtype=torch.float32, device=vals.device)
    out_i = torch.empty((b, k), dtype=torch.int32, device=vals.device)
    rc = _build.kernel("fused_topk_pairs")(
        vals.data_ptr(), ids.data_ptr(), b, m, k, out_d.data_ptr(),
        out_i.data_ptr(), _stream(vals.device))
    _check_rc("fused_topk_pairs", rc)
    _count("fused_topk_pairs")
    return out_d, out_i


# -- fused_topk_scan -----------------------------------------------------------

def _scan_ok_mask(n, valid, allow_bits, device):
    """[B or 1, N] bool: live rows the query's allow bitmask keeps."""
    ok = torch.ones((1, n), dtype=torch.bool, device=device)
    if valid is not None:
        ok = ok & valid[None, :]
    if allow_bits is not None:
        ok = ok & unpack_allow_bitmask(allow_bits, n)
    return ok


def fused_topk_scan_plain(q, x, k, metric="l2-squared", valid=None,
                          x_sq_norms=None, allow_bits=None):
    """Plain version of ``fused_topk_scan``: exact distances, dead and
    disallowed rows replaced by MASKED_DISTANCE (they never surface),
    then the pairs selection over row positions."""
    d = _distances_plain(q, x, metric, x_sq_norms)
    ok = _scan_ok_mask(x.shape[0], valid, allow_bits, x.device)
    d = torch.where(ok, d, torch.full_like(d, MASKED_DISTANCE))
    rows = torch.arange(x.shape[0], dtype=torch.int32, device=x.device)
    return fused_topk_pairs_plain(d, rows.expand_as(d), k)


def scan_slices(n: int, b: int) -> tuple[int, int]:
    """(rows_per_slice, n_slices) of the CUDA scan: enough (slice, query
    block) CTAs for about two waves on 132 SMs, and at most 8192 rows a
    slice so the partial lists stay short."""
    tiles = max(1, -(-n // 128))
    qblocks = -(-b // 64)
    per = max(1, min(64, -(-tiles * qblocks // 264)))
    return per * 128, -(-tiles // per)


def fused_topk_scan(q: torch.Tensor, x: torch.Tensor, k: int,
                    metric: str = "l2-squared",
                    valid: torch.Tensor | None = None,
                    x_sq_norms: torch.Tensor | None = None,
                    allow_bits: torch.Tensor | None = None,
                    allow_rows: torch.Tensor | None = None):
    """Fused masked distance scan + EXACT top-k: q [B,d] vs x [N,d] ->
    (dists [B,k] f32 ascending, row ids [B,k] i32, -1 where fewer than k
    rows are live and allowed). Ties go to the lower row. ``allow_bits``
    [B, >= N/32] packed words (``pack_allow_bitmask`` layout) or
    ``allow_rows`` [B, N] bool add a per-query filter.

    On CUDA: csrc/fused_topk_scan.cu writes a partial top-k per corpus
    slice and ``fused_topk_pairs`` merges them; the [B, N] distances are
    never written out. CPU tensors take ``fused_topk_scan_plain``."""
    _check_kernel_operands(q, x, metric, valid, x_sq_norms)
    if not 1 <= k <= FUSED_TOPK_MAX_K:
        raise ValueError(f"fused top-k requires 1 <= k <= 128, got {k}")
    if allow_bits is None and allow_rows is not None:
        allow_bits = pack_allow_bitmask_t(allow_rows.bool())
    if allow_bits is not None:
        allow_bits = as_bits_tensor(allow_bits, x.device)
        if allow_bits.ndim != 2 or allow_bits.shape[0] != q.shape[0]:
            raise ValueError(f"allow_bits {tuple(allow_bits.shape)} must be [B, W]")
    if x.device.type == "cpu":
        return fused_topk_scan_plain(q, x, k, metric, valid, x_sq_norms, allow_bits)
    from weaviate_tpu_torch.ops import _build

    qk, qn, xn, valid, async_ok = _kernel_args(q, x, metric, valid, x_sq_norms)
    b, n = qk.shape[0], x.shape[0]
    if n == 0:  # nothing to scan: every slot unfilled
        return (torch.full((b, k), MASKED_DISTANCE, device=x.device),
                torch.full((b, k), -1, dtype=torch.int32, device=x.device))
    rows_per_slice, n_slices = scan_slices(n, b)
    part_d = torch.empty((b, n_slices * k), dtype=torch.float32, device=x.device)
    part_i = torch.empty((b, n_slices * k), dtype=torch.int32, device=x.device)
    bits = None if allow_bits is None else allow_bits.contiguous()
    rc = _build.kernel("fused_topk_scan")(
        qk.data_ptr(), _ptr(qn), x.data_ptr(), int(x.dtype == torch.bfloat16),
        _ptr(xn), _ptr(valid), _ptr(bits), 0 if bits is None else bits.shape[1],
        b, n, x.shape[1], k, _METRIC_ID[metric], rows_per_slice, n_slices,
        part_d.data_ptr(), part_i.data_ptr(), int(async_ok), _stream(x.device))
    _check_rc("fused_topk_scan", rc)
    _count("fused_topk_scan")
    return fused_topk_pairs(part_d, part_i, k)


# -- the quantized scan-reduce kernels ----------------------------------------
#
# Both kernels compute what the reference's wrappers return
# (pallas_kernels.bq_scan_reduce / pq4_scan_reduce), not the TPU's block
# structure. The rows are cut into supertiles of ``reduce_l * out_w``
# rows; output column c of supertile t keeps the best of the rows
# t*supertile + s*out_w + c, s = 0 .. reduce_l-1, ordered by the packed
# int32 key ``value * 64 + s`` (ties go to the lower slice). A dead row
# (``valid`` False, or past N) carries a dead offset that puts it past any
# live value; a row the query's allow bits forbid is INT32_MAX and never
# wins. The geometry is the reference's host-side geometry, number for
# number: the ids depend on ``out_w``.

SCAN_ID_BITS = 6  # slice-id field of the packed key: reduce_l <= 64
_INT32_MAX = 2 ** 31 - 1
_SCAN_CHUNK_ELEMS = 1 << 24  # plain versions: [B, rows] intermediates per chunk


class ScanGeometry:
    """Host-side geometry of one scan-reduce call."""

    __slots__ = ("row_major", "reduce_l", "out_w", "supertile", "pn")

    def __init__(self, row_major, reduce_l, out_w, supertile, pn):
        self.row_major = row_major
        self.reduce_l = reduce_l
        self.out_w = out_w
        self.supertile = supertile
        self.pn = pn

    @property
    def n_supertiles(self) -> int:
        return self.pn // self.supertile

    @property
    def out_cols(self) -> int:
        return self.pn // self.reduce_l


def scan_geometry(n: int, width: int, b: int, reduce_l: int, *,
                  width_pad: int, transposed: bool = False,
                  sub_rows: int | None = None,
                  masked: bool = False) -> ScanGeometry:
    """The reference's geometry (``bq_scan_reduce`` :1196-1252 with
    ``width_pad`` 4 words, ``pq4_scan_reduce`` :1421-1453 with 8
    segments): orientation by code width, sub-rows by padded width and
    batch, ``reduce_l`` floored to a power of two <= 64, ``out_w`` from
    the supertile cap, and MASK_BLOCK alignment when a mask is given."""
    pw = _pad_to(max(width, 1), width_pad)
    pb = _pad_to(max(b, 1), 8)
    row_major = width >= 24 if not transposed else False
    if sub_rows is None:
        if row_major:
            sub_rows = 256
        else:
            sub_rows = 2048 if pw <= 8 else (1024 if pw <= 24 else 512)
        if pb > 512:
            sub_rows = min(sub_rows, 1024)
    reduce_l = max(1, min(reduce_l, 64))
    reduce_l = 1 << (reduce_l.bit_length() - 1)
    st_cap = 8192 if row_major else 16384
    out_w = min(max(128, st_cap // reduce_l), sub_rows)
    supertile = reduce_l * out_w
    if masked:
        while supertile % MASK_BLOCK:
            out_w *= 2
            supertile = reduce_l * out_w
    return ScanGeometry(row_major, reduce_l, out_w, supertile,
                        _pad_to(max(n, 1), supertile))


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Bit count of 32-bit words held in an int64 tensor (0 <= x < 2**32),
    SWAR: torch has no popcount op."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def _u32(words: torch.Tensor) -> torch.Tensor:
    """int32 words (the uint32 bit pattern) -> int64 in [0, 2**32)."""
    return words.to(torch.int64) & 0xFFFFFFFF


def _fit_allow_words(allow_bits: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """Words of columns [lo, hi) (MASK_BLOCK-aligned); columns past the
    given words are disallowed, as the reference's zero padding makes them."""
    b, wa = allow_bits.shape
    w0, w1 = lo // 32, hi // 32
    out = torch.zeros((b, w1 - w0), dtype=torch.int32, device=allow_bits.device)
    keep = max(0, min(wa, w1) - w0)
    if keep:
        out[:, :keep] = allow_bits[:, w0:w0 + keep]
    return out


def _strided_argmin_plain(values, b: int, n: int, g: ScanGeometry,
                          dead_off: int, valid, allow_bits, device):
    """The plain strided block-argmin: ``values(lo, hi)`` -> [B, hi-lo]
    int64 row values (rows past N read as all-zero codes). Returns
    (raw [B, cols] int64 winning values with the dead offset, ids [B, cols]
    int32 global rows)."""
    st, L, ow = g.supertile, g.reduce_l, g.out_w
    n_st = g.n_supertiles
    per = max(1, _SCAN_CHUNK_ELEMS // max(1, b) // st)
    packed = torch.empty((b, n_st * ow), dtype=torch.int64, device=device)
    for t0 in range(0, n_st, per):
        t1 = min(n_st, t0 + per)
        lo, hi = t0 * st, t1 * st
        v = values(lo, hi)
        pos = torch.arange(lo, hi, dtype=torch.int64, device=device)
        dead = pos >= n
        if valid is not None:
            live = torch.zeros(hi - lo, dtype=torch.bool, device=device)
            top = min(hi, n)
            if top > lo:
                live[:top - lo] = valid[lo:top]
            dead = dead | ~live
        key = (v + dead.to(torch.int64)[None, :] * dead_off) * 64 \
            + (pos % st // ow)[None, :]
        if allow_bits is not None:
            ok = unpack_allow_bitmask(_fit_allow_words(allow_bits, lo, hi))
            key = torch.where(ok, key, torch.full_like(key, _INT32_MAX))
        packed[:, t0 * ow:t1 * ow] = key.reshape(b, t1 - t0, L, ow).amin(dim=2) \
            .reshape(b, -1)
    col = torch.arange(n_st * ow, dtype=torch.int64, device=device)
    ids = (packed & 63) * ow + (col % ow)[None, :] + (col // ow * st)[None, :]
    return packed >> SCAN_ID_BITS, ids.to(torch.int32)


def _check_scan_operands(name, codes, codes_dtypes, width, transposed, valid,
                         allow_bits, b):
    if codes.ndim != 2:
        raise ValueError(f"{name}: codes must be 2-D, got {tuple(codes.shape)}")
    if codes.dtype not in codes_dtypes:
        raise TypeError(f"{name}: codes dtype {codes.dtype}, expected {codes_dtypes}")
    if not codes.is_contiguous():
        raise ValueError(f"{name}: codes must be contiguous")
    cw = codes.shape[0] if transposed else codes.shape[1]
    if cw != width:
        raise ValueError(f"{name}: code width {cw} != {width}")
    n = codes.shape[1] if transposed else codes.shape[0]
    if valid is not None and (valid.device != codes.device or valid.shape != (n,)
                              or valid.dtype != torch.bool):
        raise ValueError(f"{name}: valid must be a [N] bool tensor on the codes' device")
    if allow_bits is not None and (
            allow_bits.device != codes.device or allow_bits.ndim != 2
            or allow_bits.shape[0] != b or allow_bits.dtype != torch.int32):
        raise ValueError(f"{name}: allow_bits must be [B, W] int32 words on the "
                         f"codes' device, got {tuple(allow_bits.shape)}")
    return n


def _launch_scan(name, g, b, qblock, device, *args):
    """Shared launch of the two scan-reduce kernels: the output buffers,
    the grid's column blocks, the C call and its count."""
    from weaviate_tpu_torch.ops import _build

    vals = torch.empty((b, g.out_cols), dtype=torch.float32, device=device)
    ids = torch.empty((b, g.out_cols), dtype=torch.int32, device=device)
    rc = _build.kernel(name)(*args, g.reduce_l, g.out_w, g.supertile,
                             g.n_supertiles, -(-b // qblock),
                             vals.data_ptr(), ids.data_ptr(), _stream(device))
    _check_rc(name, rc)
    _count(name)
    return vals, ids


# -- bq_scan_reduce ------------------------------------------------------------

BQ_QBLOCK = 32  # queries per CTA (csrc/bq_scan_reduce.cu)


def bq_geometry(n, w, b, reduce_l=128, transposed=False, sub_rows=None,
                masked=False) -> ScanGeometry:
    return scan_geometry(n, w, b, reduce_l, width_pad=4, transposed=transposed,
                         sub_rows=sub_rows, masked=masked)


def bq_scan_reduce_plain(q_bits, x_bits, valid=None, reduce_l=128,
                         transposed=False, sub_rows=None, allow_bits=None):
    """Plain version of ``bq_scan_reduce``: XOR + popcount per word, the
    strided block-argmin over packed (hamming - popcount(q), slice) keys."""
    b, w = q_bits.shape
    n = x_bits.shape[1] if transposed else x_bits.shape[0]
    g = bq_geometry(n, w, b, reduce_l, transposed, sub_rows, allow_bits is not None)
    d = 32 * w
    dev = x_bits.device
    q64 = _u32(q_bits)
    qpop = popcount32(q64).sum(dim=1)

    def values(lo, hi):
        top = min(hi, n)
        xs = torch.zeros((hi - lo, w), dtype=torch.int64, device=dev)
        if top > lo:
            xs[:top - lo] = _u32(x_bits[:, lo:top].T if transposed else x_bits[lo:top])
        acc = torch.zeros((b, hi - lo), dtype=torch.int64, device=dev)
        for j in range(w):
            acc += popcount32(q64[:, j, None] ^ xs[None, :, j])
        return acc - qpop[:, None]

    raw, ids = _strided_argmin_plain(values, b, n, g, 2 * d + 2, valid, allow_bits, dev)
    vals = raw.float() + qpop.float()[:, None]
    vals = torch.where(vals > d, torch.full_like(vals, MASKED_DISTANCE), vals)
    return vals, ids


def bq_scan_reduce(q_bits: torch.Tensor, x_bits: torch.Tensor,
                   valid: torch.Tensor | None = None, reduce_l: int = 128,
                   transposed: bool = False, sub_rows: int | None = None,
                   allow_bits: torch.Tensor | None = None):
    """Full-corpus BQ scan with candidate reduction (reference
    ``pallas_kernels.bq_scan_reduce``). ``q_bits`` [B, W] and ``x_bits``
    [N, W] (or [W, N] with ``transposed``) are int32 tensors holding the
    uint32 sign words; ``allow_bits`` [B, Wa] int32 packed allow words.

    Returns (vals [B, pn/L] f32 true hamming distances, dead and
    disallowed slots at MASKED_DISTANCE; ids [B, pn/L] int32 global rows).
    CUDA tensors launch csrc/bq_scan_reduce.cu; CPU tensors take
    ``bq_scan_reduce_plain``."""
    if q_bits.ndim != 2 or q_bits.dtype != torch.int32:
        raise ValueError(f"bq_scan_reduce: q_bits must be [B, W] int32, got "
                         f"{tuple(q_bits.shape)} {q_bits.dtype}")
    if q_bits.device != x_bits.device:
        raise ValueError(f"q_bits on {q_bits.device}, x_bits on {x_bits.device}")
    b, w = q_bits.shape
    n = _check_scan_operands("bq_scan_reduce", x_bits, (torch.int32,), w,
                             transposed, valid, allow_bits, b)
    if x_bits.device.type == "cpu":
        return bq_scan_reduce_plain(q_bits, x_bits, valid, reduce_l, transposed,
                                    sub_rows, allow_bits)
    g = bq_geometry(n, w, b, reduce_l, transposed, sub_rows, allow_bits is not None)
    q_bits = q_bits.contiguous()
    vec4 = int(not transposed and w % 4 == 0 and x_bits.data_ptr() % 16 == 0)
    valid = None if valid is None else valid.contiguous()
    bits = None if allow_bits is None else allow_bits.contiguous()
    return _launch_scan(
        "bq_scan_reduce", g, b, BQ_QBLOCK, x_bits.device,
        q_bits.data_ptr(), x_bits.data_ptr(), int(transposed), vec4,
        _ptr(valid), _ptr(bits), 0 if bits is None else bits.shape[1], b, n, w)


# -- pq4_scan_reduce -----------------------------------------------------------

PQ4_QBLOCK = 16  # queries per CTA (csrc/pq4_scan_reduce.cu)
# The kernel holds its 16 queries' tables for every segment in shared
# memory: m padded to 16 segments x 16 codes x 16 queries bytes, within
# the 227 KB a CTA may opt into on sm_90. So m <= 896 segments (3584 dims
# at the default m = d/4).
PQ4_SMEM_BYTES = 227 * 1024
PQ4_MAX_SEGMENTS = PQ4_SMEM_BYTES // (16 * PQ4_QBLOCK) // 16 * 16


def pq4_check_segments(m: int) -> None:
    """Raise when the CUDA kernel's shared-memory table cannot hold ``m``
    segments."""
    if m > PQ4_MAX_SEGMENTS:
        raise ValueError(
            f"pq4_scan_reduce on CUDA holds at most {PQ4_MAX_SEGMENTS} segments "
            f"(a {PQ4_SMEM_BYTES}-byte shared-memory table), got m = {m}")


def pq4_geometry(n, m, b, reduce_l=64, transposed=False, sub_rows=None,
                 masked=False) -> ScanGeometry:
    return scan_geometry(n, m, b, reduce_l, width_pad=8, transposed=transposed,
                         sub_rows=sub_rows, masked=masked)


def quantize_lut_int8(lut: torch.Tensor):
    """Per-query int8 quantization of ADC tables, code-major flattened
    (reference ``ops/pq.py:263``): lut [B, m, kc] f32 -> (lut8 [B, kc*m]
    int8 with lane order c*m + s, scale [B] f32); adc = sums / scale."""
    b, m, kc = lut.shape
    amax = torch.clamp(lut.reshape(b, -1).abs().amax(dim=1), min=1e-20)
    # a true division: ``127.0 / tensor`` is a reciprocal times 127 in torch
    scale = torch.full_like(amax, 127.0) / amax
    lut8 = torch.clamp(torch.round(lut * scale[:, None, None]), -127, 127)
    lut8 = lut8.transpose(1, 2).reshape(b, kc * m)
    return lut8.to(torch.int8), scale


def pq4_lut8(lut: torch.Tensor):
    """The scan's table: lut [B, m, kc<=16] f32 padded to 8-multiple
    segments and 16 centroids with zeros, quantized per query. Returns
    (lut8 [B, 16*pm] int8 code-major, scale [B] f32, pm)."""
    b, m, kc = lut.shape
    if kc > 16:
        raise ValueError(f"pq4 kernel requires k <= 16 centroids, got {kc}")
    pm = _pad_to(max(m, 1), 8)
    lut = torch.nn.functional.pad(lut.float(), (0, 16 - kc, 0, pm - m))
    lut8, scale = quantize_lut_int8(lut)
    return lut8.contiguous(), scale.contiguous(), pm


def pq4_scan_reduce_plain(lut, codes, valid=None, reduce_l=64, transposed=False,
                          sub_rows=None, allow_bits=None):
    """Plain version of ``pq4_scan_reduce``: per segment, the int8 table
    entry of each row's code (``code & 15``) summed in int64, then the
    strided block-argmin."""
    b, m, _kc = lut.shape
    n = codes.shape[1] if transposed else codes.shape[0]
    g = pq4_geometry(n, m, b, reduce_l, transposed, sub_rows, allow_bits is not None)
    lut8, scale, pm = pq4_lut8(lut)
    dev = codes.device
    lut64 = lut8.to(torch.int64)

    def values(lo, hi):
        top = min(hi, n)
        cs = torch.zeros((hi - lo, m), dtype=torch.int64, device=dev)
        if top > lo:
            cs[:top - lo] = (codes[:, lo:top].T if transposed else codes[lo:top]).to(
                torch.int64)
        cs = cs & 15
        acc = torch.zeros((b, hi - lo), dtype=torch.int64, device=dev)
        for s in range(m):
            acc += torch.index_select(lut64, 1, cs[:, s] * pm + s)
        return acc

    raw, ids = _strided_argmin_plain(values, b, n, g, 2 * 127 * pm + 2, valid,
                                     allow_bits, dev)
    vals = raw.float() / scale[:, None]
    vals = torch.where(raw > 127 * pm, torch.full_like(vals, MASKED_DISTANCE), vals)
    return vals, ids


def pq4_scan_reduce(lut: torch.Tensor, codes: torch.Tensor,
                    valid: torch.Tensor | None = None, reduce_l: int = 64,
                    transposed: bool = False, sub_rows: int | None = None,
                    allow_bits: torch.Tensor | None = None):
    """Full-corpus 4-bit PQ ADC scan with candidate reduction (reference
    ``pallas_kernels.pq4_scan_reduce``). ``lut`` [B, m, kc<=16] f32 ADC
    tables (``ops/pq.pq_lut``), ``codes`` [N, m] uint8 (or [m, N] with
    ``transposed``) holding codes below 16.

    Returns (vals [B, pn/L] f32 approximate ADC distances, dead and
    disallowed slots at MASKED_DISTANCE; ids [B, pn/L] int32). CUDA
    tensors launch csrc/pq4_scan_reduce.cu; CPU tensors take
    ``pq4_scan_reduce_plain``."""
    if lut.ndim != 3:
        raise ValueError(f"pq4_scan_reduce: lut must be [B, m, k], got {tuple(lut.shape)}")
    if lut.device != codes.device:
        raise ValueError(f"lut on {lut.device}, codes on {codes.device}")
    b, m, kc = lut.shape
    if kc > 16:
        raise ValueError(f"pq4 kernel requires k <= 16 centroids, got {kc}")
    n = _check_scan_operands("pq4_scan_reduce", codes, (torch.uint8,), m,
                             transposed, valid, allow_bits, b)
    if codes.device.type == "cpu":
        return pq4_scan_reduce_plain(lut, codes, valid, reduce_l, transposed,
                                     sub_rows, allow_bits)
    pq4_check_segments(m)
    g = pq4_geometry(n, m, b, reduce_l, transposed, sub_rows, allow_bits is not None)
    lut8, scale, pm = pq4_lut8(lut)
    vec16 = int(not transposed and m % 16 == 0 and codes.data_ptr() % 16 == 0)
    valid = None if valid is None else valid.contiguous()
    bits = None if allow_bits is None else allow_bits.contiguous()
    return _launch_scan(
        "pq4_scan_reduce", g, b, PQ4_QBLOCK, codes.device,
        lut8.data_ptr(), scale.data_ptr(), pm, codes.data_ptr(), int(transposed),
        vec16, _ptr(valid), _ptr(bits), 0 if bits is None else bits.shape[1], b, n, m)
