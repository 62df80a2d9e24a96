"""Hand-written CUDA kernels of the flat scan, with their plain versions.

Port of ``weaviate_tpu/ops/pallas_kernels.py`` for the three kernels on
the flat nearVector path:

- ``distance_block``    masked [B,d] x [N,d] -> [B,N] distances
                        (csrc/distance_block.cu)
- ``fused_topk_scan``   the same distances folded into an exact per-query
                        top-k, never written out (csrc/fused_topk_scan.cu;
                        its per-slice partials merge through the pairs
                        kernel)
- ``fused_topk_pairs``  exact top-k over (value, id) candidate pairs
                        (csrc/fused_topk_pairs.cu)

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
                 "fused_topk_pairs": 0}
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
