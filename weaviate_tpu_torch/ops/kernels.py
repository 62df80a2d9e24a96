"""Hand-written CUDA kernels of the flat scans and of BM25F scoring, with
their plain versions.

Port of ``weaviate_tpu/ops/pallas_kernels.py`` for the kernels on the
flat nearVector path, the quantized flat path and the hybrid path:

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
- ``bm25_block``        negated BM25F over packed posting candidates, bit
                        for bit the host scorer's f32 (csrc/bm25_block.cu)
- ``bq_hamming_block``  exact f32 hamming [B, N] over packed sign words
                        (csrc/bq_hamming_block.cu)
- ``bq_mxu_block``      masked hamming as |q| + |x| - 2 q.x, bf16
                        (csrc/bq_mxu_block.cu)
- ``pq4_lut_block``     masked 4-bit ADC through a bf16 LUT, bf16
                        (csrc/pq4_lut_block.cu)
- ``pq4_recon_block``   masked 4-bit ADC through the reconstructed rows,
                        l2 / dot / cosine, bf16 (csrc/pq4_recon_block.cu)

Each wrapper takes its plain PyTorch version (``*_plain``) only when the
tensors it is given lie on the CPU — the tests run that way. On a CUDA
tensor it launches its kernel or raises; it never falls back. Every launch
adds one to ``launch_counts[name]``.

Also here: the block-strided per-query allow bitmask of the reference
(``MASK_BLOCK`` layout), bit-identical to ``pack_allow_bitmask`` there.
"""

from __future__ import annotations

import contextlib
import functools
import threading

import numpy as np
import torch

from weaviate_tpu_torch.ops.distances import MASKED_DISTANCE, sq_norms

# Metrics with a hand-written kernel; hamming and manhattan stay plain
# torch (elementwise 3D intermediates — nothing for a kernel to win).
KERNEL_METRICS = ("l2-squared", "dot", "cosine", "cosine-dot")
_METRIC_ID = {"l2-squared": 0, "dot": 1, "cosine": 2, "cosine-dot": 2}

FUSED_TOPK_MAX_K = 128
FUSED_PAIRS_MAX_K = 256

launch_counts = {"distance_block": 0, "fused_topk_scan": 0,
                 "fused_topk_pairs": 0, "bq_scan_reduce": 0,
                 "pq4_scan_reduce": 0, "bm25_block": 0, "bq_hamming_block": 0,
                 "bq_mxu_block": 0, "pq4_lut_block": 0, "pq4_recon_block": 0}
_count_lock = threading.Lock()
_recording = threading.local()


def _count(name: str) -> None:
    names = getattr(_recording, "names", None)
    if names is not None:  # a CUDA graph's capture: nothing is launched yet
        names.append(name)
        return
    with _count_lock:
        launch_counts[name] += 1


@contextlib.contextmanager
def recording_launches():
    """While a CUDA graph is captured on this thread, the wrappers launch
    nothing: collect the names they would count instead, for
    ``count_launches`` at each replay of the graph."""
    _recording.names = []
    try:
        yield _recording.names
    finally:
        _recording.names = None


def count_launches(names) -> None:
    """One replay of a captured graph launches each kernel in ``names``."""
    with _count_lock:
        for name in names:
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
    # packbits may return non-contiguous strides for size-1 axes ([1, 512])
    packed = np.ascontiguousarray(packed)
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
    # int32 words: the arithmetic shift keeps bit 31 readable as ``& 1``
    a = bits.to(torch.int32).reshape(b, total // MASK_BLOCK, 1, _MASK_WORDS)
    shifts = torch.arange(32, dtype=torch.int32, device=bits.device)
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
    """f32 query rows for the kernels; unit length for cosine. The norm is
    taken in f64 and rounded once: torch's f32 row reductions on the card
    sum in an order that depends on the number of rows, so a query's unit
    vector, and with it every distance, would move with the rows batched
    beside it (by 1 ulp at B = 4 against B = 8)."""
    q = q.float()
    if metric in ("cosine", "cosine-dot"):
        norm = torch.linalg.vector_norm(q.double(), dim=-1, keepdim=True).float()
        q = q / torch.where(norm > 1e-30, norm, torch.ones_like(norm))
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


def distance_query(q: torch.Tensor, metric: str):
    """The scan kernels' query operands for q [B, d]: (f32 rows, unit
    length for cosine; their squared norms for l2, else None). A loop
    that launches ``distance_block`` on many corpus blocks with one query
    batch prepares them once (``distance_block_prepared``)."""
    qk = _kernel_query(q, metric)
    return qk, ((qk * qk).sum(dim=1).contiguous() if metric == "l2-squared" else None)


def _corpus_args(qk, x, metric, valid, x_sq_norms):
    """The corpus operands: its squared norms (l2 only), the valid mask,
    and whether every row is 16-byte aligned for cp.async."""
    xn = None
    if metric == "l2-squared":
        xn = (sq_norms(x) if x_sq_norms is None else x_sq_norms.float()).contiguous()
    valid = None if valid is None else valid.contiguous()
    d = x.shape[1]
    async_ok = (d % 4 == 0 and (d * x.element_size()) % 16 == 0
                and qk.data_ptr() % 16 == 0 and x.data_ptr() % 16 == 0)
    return xn, valid, async_ok


def _kernel_args(q, x, metric, valid, x_sq_norms):
    """Device operands shared by the scan kernels: ``distance_query``'s
    and ``_corpus_args``'."""
    qk, qn = distance_query(q, metric)
    return (qk, qn, *_corpus_args(qk, x, metric, valid, x_sq_norms))


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
    return distance_block_prepared(distance_query(q, metric), x, metric, valid, x_sq_norms)


def distance_block_prepared(query, x: torch.Tensor, metric: str = "l2-squared",
                            valid: torch.Tensor | None = None,
                            x_sq_norms: torch.Tensor | None = None) -> torch.Tensor:
    """``distance_block`` with its query operands from ``distance_query``:
    the same launch and the same bits, without preparing the query again.
    CUDA tensors only."""
    if metric not in KERNEL_METRICS or x.device.type != "cuda":
        raise ValueError("distance_block_prepared takes a kernel metric and CUDA tensors")
    from weaviate_tpu_torch.ops import _build

    qk, qn = query
    xn, valid, async_ok = _corpus_args(qk, x, metric, valid, x_sq_norms)
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

def kernel_residency(name: str, *shape) -> tuple[int, int]:
    """(CTAs per SM, dynamic shared memory bytes per CTA) of a selection
    kernel on the current card: ``fused_topk_scan`` takes (k, bf16, B),
    ``fused_topk_pairs`` (M,). Builds the kernels on first use."""
    import ctypes

    from weaviate_tpu_torch.ops import _build

    smem = ctypes.c_int(0)
    ctas = _build.kernel(f"{name}.residency")(*(int(a) for a in shape), ctypes.byref(smem))
    return ctas, smem.value


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


def scan_query_tile(b: int) -> int:
    """Queries per CTA of the CUDA scan: 16 for drains of <= 32 queries
    (a full 64-query tile would multiply mostly zero rows), else 64. The
    kernel makes the same choice (``small_tile`` in
    csrc/fused_topk_scan.cu, which also needs 16-byte aligned rows); here
    it only sizes the slices."""
    return 16 if b <= 32 else 64


def scan_slices(n: int, b: int) -> tuple[int, int]:
    """(rows_per_slice, n_slices) of the CUDA scan: about one wave of
    (query block, slice) CTAs at two per SM on 132 SMs, in slices of
    whole 128-row tiles. A slice holds at most 511 tiles (65,408 rows):
    the kernel keys its lists by 16-bit offsets in the slice. Fewer,
    longer slices mean fewer values passing each slice's k-th best."""
    tiles = max(1, -(-n // 128))
    qblocks = -(-b // scan_query_tile(b))
    per = max(1, min(511, -(-tiles * qblocks // 264)))
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

BQ_QBLOCK = 32  # queries per CTA of the popcount body (csrc/bq_scan_reduce.cu)
BQ_TC_QBLOCKS = (8, 16, 32, 64, 128)  # queries per CTA of the tensor-core body
_BQ_TC_STAGES, _BQ_TC_TILE, _BQ_TC_COLS = 4, 64, 128  # ring depth, MMA rows, columns a CTA
_SMEM_MAX = 232448  # dynamic shared memory a block can use on an H100


def bq_tc_smem(qn: int, w: int) -> int:
    """Shared memory of the tensor-core body (csrc ``tc_smem``): the query
    block's words and its all-ones rows, the two warpgroups' row rings,
    the popcounts, the mbarrier."""
    w8 = _pad_to(w, 8)
    return (qn + 16) * w8 * 4 + 2 * _BQ_TC_STAGES * _BQ_TC_TILE * w8 * 4 + qn * 4 + 16


def bq_qblock(b: int, w: int, out_w: int) -> int:
    """The body the wrapper launches for ``b`` queries of ``w`` words: the
    tensor-core body's query block (the smallest of BQ_TC_QBLOCKS that
    holds B, at most 128, halved while its shared memory exceeds the
    card's), or 0 for the popcount body, where even 8 queries do not fit
    (W past ~100 words) or ``out_w`` is no multiple of 128."""
    if out_w % _BQ_TC_COLS:
        return 0
    qn = next((n for n in BQ_TC_QBLOCKS if n >= b), BQ_TC_QBLOCKS[-1])
    while qn >= BQ_TC_QBLOCKS[0] and bq_tc_smem(qn, w) > _SMEM_MAX:
        qn //= 2
    return qn if qn >= BQ_TC_QBLOCKS[0] else 0


def bq_queries_to_pm1(q_bits: torch.Tensor, w: int, scale: int = 1) -> torch.Tensor:
    """Packed query words [B, W] (int32 holding the uint32 bits) -> +-scale
    int8 [B, 32W] in bit-plane order (column j*W + word): +scale where the
    bit is 0, -scale where it is 1, so pm1 . x_bits = scale * sum x_d
    (1 - 2 q_d) (reference ``pallas_kernels.bq_queries_to_pm1``; the
    operand of the int8 product that chip_smoke.py times beside the
    kernel)."""
    shifts = torch.arange(32, dtype=torch.int64, device=q_bits.device)
    q01 = ((_u32(q_bits)[:, None, :] >> shifts[None, :, None]) & 1).reshape(-1, 32 * w)
    return (scale - 2 * scale * q01).to(torch.int8)


@functools.lru_cache(maxsize=32)
def _bq_ones(w: int, device) -> torch.Tensor:
    """16 rows of W all-ones words, zero-padded to a multiple of 8 words."""
    ones = torch.zeros((16, _pad_to(max(w, 1), 8)), dtype=torch.int32, device=device)
    ones[:, :w] = -1  # all 32 bits set
    return ones


def bq_query_blocks(q_bits: torch.Tensor, qn: int) -> torch.Tensor:
    """The CUDA kernel's query operand: ``q_bits`` [B, W] (int32 holding
    the uint32 words) cut into blocks of ``qn`` queries, each followed by
    16 all-ones rows (whose products give popc(x); wgmma's N = qn + 16
    past 32 must be a multiple of 16), W zero-padded to a multiple of 8
    words (one single-bit K step), and laid out as the tensor cores read
    it from shared memory: [blocks][qn / 8 + 2 groups of
    8 rows][W8 / 4 chunks of 16 bytes][8 rows][4 words], K-major core
    matrices, zero past B. Returns the flat int32 tensor; one group
    (32 * W8 bytes) is one bulk copy."""
    b, w = q_bits.shape
    w8 = _pad_to(max(w, 1), 8)
    n_qb = -(-b // qn)
    words = torch.nn.functional.pad(q_bits, (0, w8 - w, 0, n_qb * qn - b))
    rows = torch.cat([words.reshape(n_qb, qn, w8),
                      _bq_ones(w, q_bits.device).expand(n_qb, 16, w8)], dim=1)
    return rows.reshape(n_qb, qn // 8 + 2, 8, w8 // 4, 4).permute(0, 1, 3, 2, 4) \
        .contiguous().reshape(-1)


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
    CUDA tensors launch csrc/bq_scan_reduce.cu (its tensor-core body, or
    the popcount body where ``bq_qblock`` says so); CPU tensors take
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
    qn = bq_qblock(b, w, g.out_w)
    q_bits = q_bits.contiguous()
    qm = None if qn == 0 else bq_query_blocks(q_bits, qn)
    vec = int(not transposed and w % 4 == 0 and x_bits.data_ptr() % 16 == 0)
    valid = None if valid is None else valid.contiguous()
    bits = None if allow_bits is None else allow_bits.contiguous()
    return _launch_scan(
        "bq_scan_reduce", g, b, qn or BQ_QBLOCK, x_bits.device,
        _ptr(qm), q_bits.data_ptr(), x_bits.data_ptr(), int(transposed), vec,
        _ptr(valid), _ptr(bits), 0 if bits is None else bits.shape[1], b, n, w, qn)


# -- pq4_scan_reduce -----------------------------------------------------------

PQ4_QBLOCK = 64  # queries per CTA (csrc/pq4_scan_reduce.cu)
PQ4_SLICE_SEGMENTS = 32  # segments per K slice of the kernel's table ring


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


def pq4_lut_blocks(lut8: torch.Tensor, pm: int, b_pad: int):
    """The CUDA kernel's table: ``pq4_lut8``'s code-major [B, 16*pm] (entry
    of code c, segment s at c*pm + s) reordered into the blocks the
    kernel's bulk copies fetch: [b_pad / 8 query groups][ks / 32 slices]
    [32 segments][8 queries][16 codes], zero past B and past pm, ks = pm
    rounded up to ``PQ4_SLICE_SEGMENTS``. One block (a query group's
    slice) is 4 KB, in the tensor cores' core-matrix order. Returns (the
    flat int8 table, ks)."""
    b = lut8.shape[0]
    ks = _pad_to(max(pm, 1), PQ4_SLICE_SEGMENTS)
    seg = lut8.reshape(b, 16, pm).transpose(1, 2)  # [B, pm, 16]: entry (s, c)
    seg = torch.nn.functional.pad(seg, (0, 0, 0, ks - pm, 0, b_pad - b))
    blocks = seg.reshape(b_pad // 8, 8, ks // PQ4_SLICE_SEGMENTS, PQ4_SLICE_SEGMENTS, 16)
    return blocks.permute(0, 2, 3, 1, 4).contiguous().reshape(-1), ks


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
    g = pq4_geometry(n, m, b, reduce_l, transposed, sub_rows, allow_bits is not None)
    lut8, scale, pm = pq4_lut8(lut)
    table, ks = pq4_lut_blocks(lut8, pm, _pad_to(b, PQ4_QBLOCK))
    vec16 = int(not transposed and m % 16 == 0 and codes.data_ptr() % 16 == 0)
    valid = None if valid is None else valid.contiguous()
    bits = None if allow_bits is None else allow_bits.contiguous()
    return _launch_scan(
        "pq4_scan_reduce", g, b, PQ4_QBLOCK, codes.device,
        table.data_ptr(), scale.data_ptr(), pm, ks, codes.data_ptr(), int(transposed),
        vec16, _ptr(valid), _ptr(bits), 0 if bits is None else bits.shape[1], b, n, m)


# -- bm25_block ----------------------------------------------------------------
#
# The host scorer (text/inverted.py ``bm25_search``) accumulates in f32;
# the kernel and its plain version evaluate the same f32 operations in the
# same order, so all three agree bit for bit (ops/bm25.py's parity note).

def bm25_block_plain(seg_tf, seg_len, seg_term, seg_boost, seg_avg, idf,
                     k1, b, omb, cand_bits):
    """Plain version of ``bm25_block``: the reference kernel's unrolled
    loops as whole-tensor ops — per segment ``contrib = boost*tf /
    max(omb + b*len/avg, 1e-9)`` (0 where tf <= 0), segments summed per
    term in pack order, terms saturated ``idf*a / (k1 + a)`` and summed in
    order."""
    n_b, n_s, n_c = seg_tf.shape
    n_t = idf.shape[1]
    norm = omb[:, None, None] + (b[:, None, None] * seg_len) / seg_avg[:, :, None]
    contrib = (seg_boost[:, :, None] * seg_tf) / torch.clamp(norm, min=1e-9)
    contrib = torch.where(seg_tf > 0.0, contrib, torch.zeros_like(contrib))
    t_iota = torch.arange(n_t, dtype=seg_term.dtype, device=seg_tf.device)
    acc = torch.zeros((n_b, n_t, n_c), dtype=torch.float32, device=seg_tf.device)
    zero = torch.zeros((), dtype=torch.float32, device=seg_tf.device)
    for s in range(n_s):
        hit = (seg_term[:, s, None] == t_iota)[:, :, None]
        acc = acc + torch.where(hit, contrib[:, s, None, :], zero)
    score = torch.zeros((n_b, n_c), dtype=torch.float32, device=seg_tf.device)
    for t in range(n_t):
        a = acc[:, t, :]
        score = score + (idf[:, t, None] * a) / (k1[:, None] + a)
    live = unpack_allow_bitmask(cand_bits, n_c)
    return torch.where(live, -score, torch.full_like(score, MASKED_DISTANCE))


def bm25_block(seg_tf: torch.Tensor, seg_len: torch.Tensor, seg_term: torch.Tensor,
               seg_boost: torch.Tensor, seg_avg: torch.Tensor, idf: torch.Tensor,
               k1: torch.Tensor, b: torch.Tensor, omb: torch.Tensor,
               cand_bits: torch.Tensor) -> torch.Tensor:
    """NEGATED BM25F scores over packed candidates (reference
    ``pallas_kernels.bm25_block``). ``seg_tf``/``seg_len`` [B, S, C] f32
    planes over the candidate axis; ``seg_term`` [B, S] int32,
    ``seg_boost``/``seg_avg`` [B, S] f32; ``idf`` [B, T] f32;
    ``k1``/``b``/``omb`` [B] f32 (``omb`` the host-rounded f32 ``1 - b``);
    ``cand_bits`` [B, C // 32] int32 block-strided candidate liveness. C
    is a MASK_BLOCK multiple.

    Returns [B, C] f32: ``-score`` on live candidates, MASKED_DISTANCE
    elsewhere. CUDA tensors launch csrc/bm25_block.cu, which takes any S
    and T; CPU tensors take ``bm25_block_plain``."""
    if seg_tf.ndim != 3 or seg_len.shape != seg_tf.shape:
        raise ValueError(f"seg_tf {tuple(seg_tf.shape)} and seg_len "
                         f"{tuple(seg_len.shape)} must be one [B, S, C] shape")
    n_b, n_s, n_c = seg_tf.shape
    n_t = idf.shape[1] if idf.ndim == 2 else -1
    if n_c % MASK_BLOCK:
        raise ValueError(f"bm25_block: C = {n_c} is not a multiple of {MASK_BLOCK}")
    shapes = {"seg_term": (seg_term, (n_b, n_s)), "seg_boost": (seg_boost, (n_b, n_s)),
              "seg_avg": (seg_avg, (n_b, n_s)), "idf": (idf, (n_b, n_t)),
              "k1": (k1, (n_b,)), "b": (b, (n_b,)), "omb": (omb, (n_b,)),
              "cand_bits": (cand_bits, (n_b, n_c // 32))}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape or t.device != seg_tf.device:
            raise ValueError(f"bm25_block: {name} must be {shape} on {seg_tf.device}, "
                             f"got {tuple(t.shape)} on {t.device}")
    if seg_tf.device.type == "cpu":
        return bm25_block_plain(seg_tf.float(), seg_len.float(), seg_term,
                                seg_boost.float(), seg_avg.float(), idf.float(),
                                k1.float(), b.float(), omb.float(), cand_bits)
    from weaviate_tpu_torch.ops import _build

    f32 = [t.float().contiguous() for t in (seg_tf, seg_len)]
    term = seg_term.to(torch.int32).contiguous()
    rest = [t.float().contiguous() for t in (seg_boost, seg_avg, idf, k1, b, omb)]
    bits = cand_bits.to(torch.int32).contiguous()
    out = torch.empty((n_b, n_c), dtype=torch.float32, device=seg_tf.device)
    rc = _build.kernel("bm25_block")(
        f32[0].data_ptr(), f32[1].data_ptr(), term.data_ptr(),
        *(t.data_ptr() for t in rest), bits.data_ptr(), n_b, n_s, n_t, n_c,
        out.data_ptr(), _stream(seg_tf.device))
    _check_rc("bm25_block", rc)
    _count("bm25_block")
    return out


# -- the block kernels: bq_hamming_block, bq_mxu_block, pq4_lut_block,
#    pq4_recon_block ------------------------------------------------------------
#
# Each writes the whole [B, N] matrix, as the reference's do. The three
# masked ones return bf16, as the reference kernels write it (their
# docstrings say f32): the f32 value, plus MASKED_DISTANCE on dead rows,
# rounded to nearest even. A masked entry is therefore bf16(d + 3e38) =
# 3.004e38, finite, not MASKED_DISTANCE itself. bf16 holds integers exactly
# only up to 256, so past 256 bits ``bq_mxu_block`` is the exact hamming
# rounded to bf16.

def _check_words(name: str, what: str, t, w: int | None = None) -> None:
    if not isinstance(t, torch.Tensor) or t.ndim != 2 or t.dtype != torch.int32:
        raise ValueError(f"{name}: {what} must be a 2-D int32 tensor of sign words, got "
                         f"{getattr(t, 'dtype', type(t))} {tuple(getattr(t, 'shape', ()))}")
    if w is not None and t.shape[1] != w:
        raise ValueError(f"{name}: {what} has {t.shape[1]} words, expected {w}")


def _check_rows(name: str, what: str, t, n: int, device, dtype=None) -> None:
    if t is None:
        return
    if t.shape != (n,) or t.device != device or (dtype is not None and t.dtype != dtype):
        want = f"{dtype} " if dtype is not None else ""
        raise ValueError(f"{name}: {what} must be a [{n}] {want}tensor on {device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


def _same_device(name: str, *ts) -> None:
    devs = {t.device for t in ts if t is not None}
    if len(devs) > 1:
        raise ValueError(f"{name}: operands on different devices {sorted(map(str, devs))}")


def _row_chunk(b: int, width: int) -> int:
    """Rows per chunk of a plain version: [B, rows] and [rows, width]
    intermediates stay within _SCAN_CHUNK_ELEMS elements."""
    return max(1, _SCAN_CHUNK_ELEMS // max(1, b, width))


def _masked_bf16(d: torch.Tensor, valid, lo: int, hi: int) -> torch.Tensor:
    """The reference kernels' epilogue: d + (1 - valid) * MASKED_DISTANCE
    in f32, rounded to bf16."""
    if valid is not None:
        d = d + (~valid[lo:hi]).float()[None, :] * MASKED_DISTANCE
    return d.to(torch.bfloat16)


# -- bq_hamming_block ----------------------------------------------------------

def bq_hamming_block_plain(q_bits: torch.Tensor, x_bits: torch.Tensor) -> torch.Tensor:
    """Plain version of ``bq_hamming_block``: XOR + popcount per word."""
    b, w = q_bits.shape
    n = x_bits.shape[0]
    q64 = _u32(q_bits)
    out = torch.empty((b, n), dtype=torch.float32, device=x_bits.device)
    per = _row_chunk(b, w)
    for lo in range(0, n, per):
        xs = _u32(x_bits[lo:lo + per])
        acc = torch.zeros((b, xs.shape[0]), dtype=torch.int64, device=x_bits.device)
        for j in range(w):
            acc += popcount32(q64[:, j, None] ^ xs[None, :, j])
        out[:, lo:lo + per] = acc.float()
    return out


_BQ_HAM_OS = 68  # f32 stride of a query's rows in the kernel's output tile
_BQ_MXU_OS = 72  # bf16 stride of a query's rows in the kernel's output tile


def _bq_block_smem(qn: int, w: int, os_elems: int, out_bytes: int) -> int:
    """Shared memory of the bq block kernels' tensor-core body (csrc
    bq_block_tc.cuh ``tc_smem``): the query block's words and its all-ones
    rows, the two warpgroups' row rings and output tiles (``os_elems``
    elements of ``out_bytes`` a query), the popcounts, the mbarrier."""
    w8 = _pad_to(max(w, 1), 8)
    return ((qn + 16) * w8 * 4 + 2 * _BQ_TC_STAGES * _BQ_TC_TILE * w8 * 4
            + 2 * qn * os_elems * out_bytes + qn * 4 + 16)


def _bq_block_qblock(b: int, w: int, smem, most: int = BQ_TC_QBLOCKS[-1]) -> int:
    """The tensor-core body's query block for ``b`` queries of ``w``
    words: the smallest of BQ_TC_QBLOCKS that holds B, at most ``most``,
    halved while ``smem(qn, w)`` exceeds the card's; 0 (the popcount
    body) where even 8 queries do not fit."""
    qn = next((n for n in BQ_TC_QBLOCKS if n >= min(b, most)), BQ_TC_QBLOCKS[-1])
    while qn >= BQ_TC_QBLOCKS[0] and smem(qn, w) > _SMEM_MAX:
        qn //= 2
    return qn if qn >= BQ_TC_QBLOCKS[0] else 0


def bq_hamming_smem(qn: int, w: int) -> int:
    """Shared memory of ``bq_hamming_block``'s tensor-core body (f32
    output tile)."""
    return _bq_block_smem(qn, w, _BQ_HAM_OS, 4)


# bq_hamming_block's largest query block: with its f32 output tile a block
# of 128 takes one CTA an SM (133 KB at W = 24), 64 two, and two CTAs keep
# more stores in flight: at [256, 24 words] x 1M, 0.4798 ms against 0.5522
# (chip_smoke.py --block-times on an NVIDIA H100 80GB HBM3, 700 W; PERF.md)
BQ_HAM_MAX_QBLOCK = 64


def bq_hamming_qblock(b: int, w: int) -> int:
    """The body ``bq_hamming_block`` launches for ``b`` queries of ``w``
    words: the tensor-core body's query block (at most
    BQ_HAM_MAX_QBLOCK), or 0 for the popcount body (W past ~100 words)."""
    return _bq_block_qblock(b, w, bq_hamming_smem, BQ_HAM_MAX_QBLOCK)


def bq_hamming_launch(q_bits: torch.Tensor, x_bits: torch.Tensor, qn: int) -> torch.Tensor:
    """One launch of csrc/bq_hamming_block.cu on checked CUDA operands
    with query block ``qn`` (``bq_hamming_qblock``'s choice, or 0 for the
    popcount body). This is ``bq_hamming_block``'s launch, also called
    directly to time another block."""
    from weaviate_tpu_torch.ops import _build

    q_bits, x_bits = q_bits.contiguous(), x_bits.contiguous()
    (b, w), n = q_bits.shape, x_bits.shape[0]
    qm = None if qn == 0 else bq_query_blocks(q_bits, qn)
    out = torch.empty((b, n), dtype=torch.float32, device=x_bits.device)
    vec4 = int(w % 4 == 0 and x_bits.data_ptr() % 16 == 0)
    out16 = int(n % 4 == 0 and out.data_ptr() % 16 == 0)
    rc = _build.kernel("bq_hamming_block")(
        _ptr(qm), q_bits.data_ptr(), x_bits.data_ptr(), vec4, b, n, w, qn,
        -(-b // (qn or BQ_QBLOCK)), out16, out.data_ptr(), _stream(x_bits.device))
    _check_rc("bq_hamming_block", rc)
    _count("bq_hamming_block")
    return out


def bq_hamming_block(q_bits: torch.Tensor, x_bits: torch.Tensor) -> torch.Tensor:
    """Exact hamming distances between packed sign words (reference
    ``pallas_kernels.bq_hamming_block``): q_bits [B, W] and x_bits [N, W]
    int32 tensors holding the uint32 words -> [B, N] f32 bit differences.
    CUDA tensors launch csrc/bq_hamming_block.cu (its single-bit
    tensor-core body, or the popcount body where ``bq_hamming_qblock``
    says so); CPU tensors take ``bq_hamming_block_plain``."""
    _check_words("bq_hamming_block", "q_bits", q_bits)
    _check_words("bq_hamming_block", "x_bits", x_bits, q_bits.shape[1])
    _same_device("bq_hamming_block", q_bits, x_bits)
    if x_bits.device.type == "cpu":
        return bq_hamming_block_plain(q_bits, x_bits)
    return bq_hamming_launch(q_bits, x_bits, bq_hamming_qblock(*q_bits.shape))


# -- bq_mxu_block ----------------------------------------------------------------

def bq_queries_to_planes(q_bits: torch.Tensor, w: int) -> torch.Tensor:
    """Packed query words [B, W] (int32 holding the uint32 bits) -> 0/1
    bf16 [B, 32W] in bit-plane order d' = j*W + w: plane j holds bit j of
    every word (reference ``pallas_kernels.bq_queries_to_planes``)."""
    u = _u32(q_bits)
    return torch.cat([(u >> j) & 1 for j in range(32)], dim=1).to(torch.bfloat16)


def _planes_to_words(q_planes: torch.Tensor, w: int) -> torch.Tensor:
    """Inverse of ``bq_queries_to_planes`` for 0/1 planes."""
    b = q_planes.shape[0]
    bits = q_planes.reshape(b, 32, w).to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=q_planes.device)
    words = (bits << shifts[None, :, None]).sum(dim=1)
    # the sum is < 2**32; fold into int32's range keeping the bit pattern
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)


def _bq_mxu_operands(q_bits, x_bits, x_pop, valid, q_planes, q_pop):
    """Checks ``bq_mxu_block``'s operands; returns (query words, query
    popcounts [B] f32 or None: the words' own). With ``q_planes`` the words
    are packed back from the planes, which must hold only 0 and 1, and
    ``q_pop`` is used as given, as the reference kernel uses both."""
    name = "bq_mxu_block"
    _check_words(name, "q_bits", q_bits)
    _check_words(name, "x_bits", x_bits, q_bits.shape[1])
    (b, w), n = q_bits.shape, x_bits.shape[0]
    _same_device(name, q_bits, x_bits, x_pop, valid, q_planes, q_pop)
    _check_rows(name, "valid", valid, n, x_bits.device, torch.bool)
    _check_rows(name, "x_pop", x_pop, n, x_bits.device)
    if (q_planes is None) != (q_pop is None):
        raise ValueError(f"{name}: q_planes and q_pop are given together")
    if q_planes is None:
        return q_bits, None
    if q_planes.shape != (b, 32 * w):
        raise ValueError(f"{name}: q_planes must be [{b}, {32 * w}], got {tuple(q_planes.shape)}")
    if q_pop.numel() != b or q_pop.shape not in ((b,), (b, 1)):
        raise ValueError(f"{name}: q_pop must be [{b}] or [{b}, 1], got {tuple(q_pop.shape)}")
    if not bool(((q_planes == 0) | (q_planes == 1)).all()):
        raise ValueError(f"{name}: q_planes must hold only 0 and 1")
    return _planes_to_words(q_planes, w), q_pop.reshape(b).float()


def bq_mxu_block_plain(q_bits, x_bits, x_pop=None, valid=None, q_planes=None, q_pop=None):
    """Plain version of ``bq_mxu_block``: per row ``q_pop + x_pop - 2 *
    popcount(q & x)`` in f32, the mask added, rounded to bf16."""
    q_words, qpop = _bq_mxu_operands(q_bits, x_bits, x_pop, valid, q_planes, q_pop)
    return _bq_mxu_plain(q_words, qpop, x_bits, x_pop, valid)


def _bq_mxu_plain(q_words, qpop, x_bits, x_pop, valid):
    (b, w), n = q_words.shape, x_bits.shape[0]
    q64 = _u32(q_words)
    if qpop is None:
        qpop = popcount32(q64).sum(dim=1).float()
    out = torch.empty((b, n), dtype=torch.bfloat16, device=x_bits.device)
    per = _row_chunk(b, w)
    for lo in range(0, n, per):
        hi = min(n, lo + per)
        xs = _u32(x_bits[lo:hi])
        dot = torch.zeros((b, hi - lo), dtype=torch.int64, device=x_bits.device)
        for j in range(w):
            dot += popcount32(q64[:, j, None] & xs[None, :, j])
        xp = popcount32(xs).sum(dim=1).float() if x_pop is None else x_pop[lo:hi].float()
        d = (qpop[:, None] + xp[None, :]) - 2.0 * dot.float()
        out[:, lo:hi] = _masked_bf16(d, valid, lo, hi)
    return out


def bq_mxu_smem(qn: int, w: int) -> int:
    """Shared memory of ``bq_mxu_block``'s tensor-core body (bf16 output
    tile)."""
    return _bq_block_smem(qn, w, _BQ_MXU_OS, 2)


def bq_mxu_qblock(b: int, w: int) -> int:
    """The body ``bq_mxu_block`` launches for ``b`` queries of ``w``
    words: the tensor-core body's query block, or 0 for the popcount body
    (W past ~100 words)."""
    return _bq_block_qblock(b, w, bq_mxu_smem)


def bq_mxu_launch(q_words: torch.Tensor, qpop, x_bits: torch.Tensor,
                  x_pop, valid, qn: int) -> torch.Tensor:
    """One launch of csrc/bq_mxu_block.cu on checked CUDA operands with
    query block ``qn`` (``bq_mxu_qblock``'s choice, or 0 for the popcount
    body); ``qpop`` None: the kernel counts the query words. This is
    ``bq_mxu_block``'s launch, also called directly to time another
    block."""
    from weaviate_tpu_torch.ops import _build

    q_words, x_bits = q_words.contiguous(), x_bits.contiguous()
    qpop = None if qpop is None else qpop.contiguous()
    xpop = None if x_pop is None else x_pop.float().contiguous()
    valid = None if valid is None else valid.contiguous()
    (b, w), n = q_words.shape, x_bits.shape[0]
    qm = None if qn == 0 else bq_query_blocks(q_words, qn)
    out = torch.empty((b, n), dtype=torch.bfloat16, device=x_bits.device)
    vec4 = int(w % 4 == 0 and x_bits.data_ptr() % 16 == 0)
    out16 = int(n % 8 == 0 and out.data_ptr() % 16 == 0)
    rc = _build.kernel("bq_mxu_block")(
        _ptr(qm), q_words.data_ptr(), x_bits.data_ptr(), vec4, _ptr(qpop), _ptr(xpop),
        _ptr(valid), b, n, w, qn, -(-b // (qn or BQ_QBLOCK)), out16, out.data_ptr(),
        _stream(x_bits.device))
    _check_rc("bq_mxu_block", rc)
    _count("bq_mxu_block")
    return out


def bq_mxu_block(q_bits: torch.Tensor, x_bits: torch.Tensor,
                 x_pop: torch.Tensor | None = None, valid: torch.Tensor | None = None,
                 q_planes: torch.Tensor | None = None,
                 q_pop: torch.Tensor | None = None) -> torch.Tensor:
    """Masked hamming distances as the reference's MXU kernel computes
    them (``pallas_kernels.bq_mxu_block``): q_bits [B, W], x_bits [N, W]
    int32 sign words -> [B, N] bf16 ``bf16(|q| + |x| - 2 q.x + (1 -
    valid) * MASKED_DISTANCE)``. ``x_pop`` [N] caches the rows' popcounts;
    ``q_planes`` [B, 32W] (``bq_queries_to_planes``) with ``q_pop`` [B]
    stand in for the query words. CUDA tensors launch
    csrc/bq_mxu_block.cu (its single-bit tensor-core body, or the
    popcount body where ``bq_mxu_qblock`` says so); CPU tensors take
    ``bq_mxu_block_plain``."""
    q_words, qpop = _bq_mxu_operands(q_bits, x_bits, x_pop, valid, q_planes, q_pop)
    if x_bits.device.type == "cpu":
        return _bq_mxu_plain(q_words, qpop, x_bits, x_pop, valid)
    return bq_mxu_launch(q_words, qpop, x_bits, x_pop, valid,
                         bq_mxu_qblock(q_words.shape[0], q_words.shape[1]))


# -- pq4_lut_block -------------------------------------------------------------

def _check_pq4_codes(name: str, codes, m: int, device) -> int:
    if not isinstance(codes, torch.Tensor) or codes.ndim != 2 or codes.dtype != torch.uint8:
        raise ValueError(f"{name}: codes must be a 2-D uint8 tensor, got "
                         f"{getattr(codes, 'dtype', type(codes))}")
    if codes.shape[1] != m:
        raise ValueError(f"{name}: codes have {codes.shape[1]} segments, expected {m}")
    if codes.device != device:
        raise ValueError(f"{name}: codes on {codes.device}, expected {device}")
    return codes.shape[0]


def _pq4_codes_idx(codes: torch.Tensor) -> torch.Tensor:
    """Codes as table columns: a code past 15 matches no lane of the
    reference's one-hot and adds 0, here the zero column 16."""
    return codes.to(torch.int64).clamp(max=16)


def _pq4_lut_table(lut: torch.Tensor) -> torch.Tensor:
    """lut [B, m, k<=16] -> [B, m, 16] f32 holding the bf16-rounded
    entries, zero for the codes past k (the reference pads and casts its
    LUT the same way before its product)."""
    b, m, kc = lut.shape
    return torch.nn.functional.pad(lut.to(torch.bfloat16).float(), (0, 16 - kc))


PQ4_LUT_QBLOCK = 64  # queries per CTA (csrc/pq4_lut_block.cu): the MMA's N


def pq4_lut_block_table(lut: torch.Tensor, b_pad: int):
    """The CUDA kernel's table: ``_pq4_lut_table(lut)`` in bf16, reordered
    into the blocks its bulk copies fetch: [b_pad / 8 query groups]
    [ks / 32 slices][32 segments][2 halves][8 queries][8 codes], zero past
    B and past m, ks = m rounded up to ``PQ4_SLICE_SEGMENTS``. A block (a
    query group's slice) is 8 KB, K-major core matrices of 8 queries x 8
    codes: the tensor cores' B operand. Returns (the flat bf16 table,
    ks)."""
    b, m, kc = lut.shape
    ks = _pad_to(max(m, 1), PQ4_SLICE_SEGMENTS)
    tab = torch.nn.functional.pad(lut.to(torch.bfloat16), (0, 16 - kc, 0, ks - m, 0, b_pad - b))
    blocks = tab.reshape(b_pad // 8, 8, ks // PQ4_SLICE_SEGMENTS, PQ4_SLICE_SEGMENTS, 2, 8)
    return blocks.permute(0, 2, 3, 4, 1, 5).contiguous().reshape(-1), ks


def _check_pq4_lut(name: str, lut, codes, valid):
    if not isinstance(lut, torch.Tensor) or lut.ndim != 3 or not lut.is_floating_point():
        raise ValueError(f"{name}: lut must be a [B, m, k] float tensor")
    b, m, kc = lut.shape
    if kc > 16:
        raise ValueError(f"pq4 kernel requires k <= 16 centroids, got {kc}")
    n = _check_pq4_codes(name, codes, m, lut.device)
    _check_rows(name, "valid", valid, n, lut.device, torch.bool)
    return b, m, n


def _pq4_segment_table(lut: torch.Tensor) -> torch.Tensor:
    """[B, m, 17] f32: what segment s adds for code c (column 16: a code
    past 15), as the one-hot product computes it: the entry times 1.0 plus
    the segment's other fifteen entries times 0.0. That is the bf16 entry
    itself, or NaN where another entry of the segment is infinite or NaN
    (0 * inf), as in the reference's product."""
    tab = _pq4_lut_table(lut)
    bad = ~torch.isfinite(tab)
    n_bad = bad.sum(dim=2, keepdim=True)
    nan = torch.full((), float("nan"), device=tab.device)
    pick = torch.where(n_bad - bad.to(n_bad.dtype) > 0, nan, tab)
    miss = torch.where(n_bad > 0, nan, torch.zeros((), device=tab.device))
    return torch.cat([pick, miss], dim=2)


def pq4_lut_block_plain(lut, codes, valid=None):
    """Plain version of ``pq4_lut_block``: per row, what each segment's
    one-hot product adds (``_pq4_segment_table``: the bf16 table entry of
    its code) summed in f32 in segment order s = 0..m-1 from +0.0, the
    mask added, rounded to bf16."""
    b, m, n = _check_pq4_lut("pq4_lut_block", lut, codes, valid)
    table = _pq4_segment_table(lut).reshape(b, m * 17)
    off = torch.arange(m, dtype=torch.int64, device=codes.device) * 17
    out = torch.empty((b, n), dtype=torch.bfloat16, device=codes.device)
    per = _row_chunk(b, m)
    for lo in range(0, n, per):
        hi = min(n, lo + per)
        idx = _pq4_codes_idx(codes[lo:hi]) + off[None, :]
        acc = torch.zeros((b, hi - lo), dtype=torch.float32, device=codes.device)
        for s in range(m):
            acc += torch.index_select(table, 1, idx[:, s])
        out[:, lo:hi] = _masked_bf16(acc, valid, lo, hi)
    return out


def pq4_lut_block(lut: torch.Tensor, codes: torch.Tensor,
                  valid: torch.Tensor | None = None) -> torch.Tensor:
    """ADC distances of 4-bit PQ codes through their LUT (reference
    ``pallas_kernels.pq4_lut_block``): lut [B, m, k<=16] f32 seg-major,
    codes [N, m] uint8 -> [B, N] bf16 ``bf16(sum_s bf16(lut[b, s,
    codes[n, s]]) + (1 - valid) * MASKED_DISTANCE)``, the sum in f32, any
    m. CUDA tensors launch csrc/pq4_lut_block.cu; CPU tensors take
    ``pq4_lut_block_plain``."""
    b, m, n = _check_pq4_lut("pq4_lut_block", lut, codes, valid)
    if codes.device.type == "cpu":
        return pq4_lut_block_plain(lut, codes, valid)
    from weaviate_tpu_torch.ops import _build

    b_pad = _pad_to(max(b, 1), PQ4_LUT_QBLOCK)
    table, ks = pq4_lut_block_table(lut, b_pad)
    codes = codes.contiguous()
    valid = None if valid is None else valid.contiguous()
    out = torch.empty((b, n), dtype=torch.bfloat16, device=codes.device)
    vec16 = int(m % 16 == 0 and codes.data_ptr() % 16 == 0)
    out16 = int(n % 8 == 0 and out.data_ptr() % 16 == 0)
    rc = _build.kernel("pq4_lut_block")(
        table.data_ptr(), ks, codes.data_ptr(), vec16, _ptr(valid), b, n, m,
        b_pad // PQ4_LUT_QBLOCK, out16, out.data_ptr(), _stream(codes.device))
    _check_rc("pq4_lut_block", rc)
    _count("pq4_lut_block")
    return out


# -- pq4_recon_block -----------------------------------------------------------

def _check_pq4_recon(q, codes, centroids, metric, valid):
    name = "pq4_recon_block"
    # the reference takes any other name as cosine; the port names its metrics
    if metric not in KERNEL_METRICS:
        raise ValueError(f"{name}: no kernel for metric {metric!r}")
    if not isinstance(q, torch.Tensor) or q.ndim != 2 or not q.is_floating_point():
        raise ValueError(f"{name}: q must be a [B, d] float tensor")
    if (not isinstance(centroids, torch.Tensor) or centroids.ndim != 3
            or not centroids.is_floating_point()):
        raise ValueError(f"{name}: centroids must be a [m, k, ds] float tensor")
    m, kc, ds = centroids.shape
    if kc > 16:
        raise ValueError(f"pq4 kernel requires k <= 16 centroids, got {kc}")
    if m * ds != q.shape[1]:
        raise ValueError(f"{name}: m * ds = {m} * {ds} != d = {q.shape[1]}")
    _same_device(name, q, centroids)
    n = _check_pq4_codes(name, codes, m, q.device)
    _check_rows(name, "valid", valid, n, q.device, torch.bool)
    return q.shape[0], n, m, ds


def _pq4_recon_centroids(centroids: torch.Tensor) -> torch.Tensor:
    """centroids [m, k<=16, ds] -> [m, 16, ds] f32 holding the bf16-rounded
    values, zero for the codes past k (the reference's padded bf16 block
    diagonal, without its zeros)."""
    m, kc, ds = centroids.shape
    return torch.nn.functional.pad(centroids.to(torch.bfloat16).float(),
                                   (0, 0, 0, 16 - kc))


def _recon_epilogue(dots, qn, xn, metric):
    if metric == "l2-squared":
        return qn[:, None] - 2.0 * dots + xn[None, :]  # no clamp, as the reference
    if metric == "dot":
        return -dots
    return 1.0 - dots


def pq4_recon_block_plain(q, codes, centroids, metric="l2-squared", valid=None):
    """Plain version of ``pq4_recon_block``: gather each row's x_hat from
    the bf16 centroids, ||x_hat||^2 and bf16(q) . x_hat in f32, the
    reference's epilogue and mask, rounded to bf16."""
    b, n, m, ds = _check_pq4_recon(q, codes, centroids, metric, valid)
    qb = q.to(torch.bfloat16).float()
    qn = (qb * qb).sum(dim=1)
    cent = torch.nn.functional.pad(_pq4_recon_centroids(centroids), (0, 0, 0, 1))
    seg = torch.arange(m, dtype=torch.int64, device=codes.device)
    out = torch.empty((b, n), dtype=torch.bfloat16, device=codes.device)
    per = _row_chunk(b, m * ds)
    for lo in range(0, n, per):
        hi = min(n, lo + per)
        x_hat = cent[seg[None, :], _pq4_codes_idx(codes[lo:hi])].reshape(hi - lo, m * ds)
        d = _recon_epilogue(qb @ x_hat.T, qn, (x_hat * x_hat).sum(dim=1), metric)
        out[:, lo:hi] = _masked_bf16(d, valid, lo, hi)
    return out


PQ4_RECON_QBLOCK = 64  # queries per CTA of the tensor-core body: the MMA's N
# the tensor-core body's code slices (segments), CTA row tile, ring depth,
# and bf16 stride of a query's rows in its output tile (csrc/pq4_recon_block.cu)
_RECON_SLICE, _RECON_ROWS, _RECON_STAGES, _RECON_OS = 64, 256, 2, 136


def _recon_slices(d: int, ds: int) -> int:
    """Code slices of 64 segments (4 * ds K steps of 16 dims) that cover
    d rounded up to 16: the kernel's ``nsl``."""
    return -(-(_pad_to(d, 16) // 16) // (4 * ds))


def pq4_recon_fast(m: int, ds: int) -> bool:
    """Whether the tensor-core body takes its fast path (csrc
    ``recon_fast``): ds = 4 and m a multiple of 64, so that every code slice
    holds 16 whole K steps and a lane's four dims of a K step are one
    centroid."""
    return ds == 4 and m % 64 == 0


def _recon_row_stride(d16: int) -> int:
    """Columns of the centroid table: d16 and up to 48 more, so that a row
    holds 16 mod 64 bf16 and rows of different codes start 8 banks apart."""
    return d16 + (16 - d16) % 64


def pq4_recon_smem(d: int, m: int, ds: int, metric: str) -> int:
    """Shared memory of ``pq4_recon_block``'s tensor-core body (csrc
    ``tc_smem``): the resident query block, centroid table and (l2) norm
    table, the code ring, the two output tiles, |q|^2, the mbarrier."""
    d16 = _pad_to(d, 16)
    norm = _recon_slices(d, ds) * _RECON_SLICE * 17 * 4 if metric == "l2-squared" else 0
    return (PQ4_RECON_QBLOCK * d16 * 2 + 17 * _recon_row_stride(d16) * 2 + norm
            + _RECON_STAGES * _RECON_ROWS * (_RECON_SLICE + 16)
            + 2 * PQ4_RECON_QBLOCK * _RECON_OS * 2 + PQ4_RECON_QBLOCK * 4 + 16)


# the fast path's order of the 16 dims of a K step: lane t holds MMA slots
# 2t, 2t + 1 and 8 + 2t, 9 + 2t, which take dims 4t .. 4t + 3 (one centroid)
_RECON_FAST_DIMS = (0, 1, 4, 5, 8, 9, 12, 13, 2, 3, 6, 7, 10, 11, 14, 15)


def pq4_recon_query_blocks(qb: torch.Tensor, fast: bool = False) -> torch.Tensor:
    """The tensor-core body's query operand: bf16 ``qb`` [B, d] zero-padded
    to blocks of 64 queries and d16 = d rounded up to 16 dims (with
    ``fast``, each 16 dims in the order _RECON_FAST_DIMS), laid out as the
    tensor cores read it from shared memory: [blocks][8 groups of 8
    queries][d16 / 8 chunks of 8 dims][8 queries][8 dims], K-major core
    matrices of 128 bytes. Returns the flat bf16 tensor; one group (16 *
    d16 bytes) is one bulk copy."""
    b, d = qb.shape
    d16, n_qb = _pad_to(d, 16), -(-b // PQ4_RECON_QBLOCK)
    q = torch.nn.functional.pad(qb, (0, d16 - d, 0, n_qb * PQ4_RECON_QBLOCK - b))
    if fast:
        q = q.reshape(-1, d16 // 16, 16)[:, :, list(_RECON_FAST_DIMS)].reshape(-1, d16)
    return q.reshape(n_qb, 8, 8, d16 // 8, 8).permute(0, 1, 3, 2, 4).contiguous().reshape(-1)


def pq4_recon_table(centroids: torch.Tensor) -> torch.Tensor:
    """The kernels' centroid table, dim-major: [17, ts] bf16 with
    table[c, s * ds + j] = bf16(centroids[s, c, j]), zero for the codes
    past k, in row 16 (every code past 15) and past d. Row x_hat[n, k] is
    table[min(codes[n, k // ds], 16), k]; ts = _recon_row_stride(d16)."""
    m, kc, ds = centroids.shape
    d16 = _pad_to(m * ds, 16)
    table = torch.zeros((17, _recon_row_stride(d16)), dtype=torch.bfloat16,
                        device=centroids.device)
    table[:kc, :m * ds] = centroids.to(torch.bfloat16).permute(1, 0, 2).reshape(kc, m * ds)
    return table


def pq4_recon_norms(centroids: torch.Tensor) -> torch.Tensor:
    """The l2 epilogue's table of the bf16 centroids' squared norms: [ms,
    17] f32, norms[s, c] = sum_j bf16(centroids[s, c, j])^2 in f32, zero
    for the codes past k, in column 16 and past m; ms covers every code
    slice the kernel reads. A row's |x_hat|^2 is the sum of its m
    entries."""
    m, kc, ds = centroids.shape
    cb = centroids.to(torch.bfloat16).float()
    norms = torch.zeros((_recon_slices(m * ds, ds) * _RECON_SLICE, 17), dtype=torch.float32,
                        device=centroids.device)
    norms[:m, :kc] = (cb * cb).sum(dim=2)
    return norms


def pq4_recon_block(q: torch.Tensor, codes: torch.Tensor, centroids: torch.Tensor,
                    metric: str = "l2-squared",
                    valid: torch.Tensor | None = None) -> torch.Tensor:
    """ADC distances of 4-bit PQ codes through the reconstructed rows
    (reference ``pallas_kernels.pq4_recon_block``): q [B, d] (cosine:
    unit length, the caller's job, as in the reference), codes [N, m]
    uint8, centroids [m, k<=16, ds] with m * ds = d -> [B, N] bf16.
    q and the centroids are rounded to bf16; ||x_hat||^2 and q . x_hat
    are f32; l2 is ``|q|^2 - 2 q.x_hat + |x_hat|^2`` unclamped, dot
    ``-q.x_hat``, cosine ``1 - q.x_hat``. Unlike the reference, a metric
    outside KERNEL_METRICS raises. CUDA tensors launch
    csrc/pq4_recon_block.cu (its bf16 tensor-core body, or the FFMA body
    where ``pq4_recon_smem`` exceeds the card's shared memory); CPU
    tensors take ``pq4_recon_block_plain``."""
    b, n, m, ds = _check_pq4_recon(q, codes, centroids, metric, valid)
    if q.device.type == "cpu":
        return pq4_recon_block_plain(q, codes, centroids, metric, valid)
    from weaviate_tpu_torch.ops import _build

    l2 = metric == "l2-squared"
    qb = q.to(torch.bfloat16).contiguous()
    qf = qb.float()
    qn = (qf * qf).sum(dim=1).contiguous()
    tc = pq4_recon_smem(m * ds, m, ds, metric) <= _SMEM_MAX
    qblk = pq4_recon_query_blocks(qb, pq4_recon_fast(m, ds)) if tc else None
    table = pq4_recon_table(centroids)
    norms = pq4_recon_norms(centroids) if tc and l2 else None
    codes = codes.contiguous()
    valid = None if valid is None else valid.contiguous()
    out = torch.empty((b, n), dtype=torch.bfloat16, device=q.device)
    vec16 = int(m % 16 == 0 and codes.data_ptr() % 16 == 0)
    out16 = int(n % 8 == 0 and out.data_ptr() % 16 == 0)
    rc = _build.kernel("pq4_recon_block")(
        _ptr(qblk), qb.data_ptr(), qn.data_ptr(), codes.data_ptr(), table.data_ptr(),
        table.shape[1], _ptr(norms), 0 if norms is None else norms.numel() * 4, _ptr(valid),
        b, n, m, ds, _METRIC_ID[metric], int(tc), -(-b // PQ4_RECON_QBLOCK), vec16, out16,
        out.data_ptr(), _stream(q.device))
    _check_rc("pq4_recon_block", rc)
    _count("pq4_recon_block")
    return out
