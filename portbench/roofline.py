"""Peaks of one NVIDIA H100 SXM and the least time a kernel's work needs.

The peaks are NVIDIA's data-sheet figures (dense, at the 700 W limit).
A bound is the larger of two times: the operations over the peak of the
narrowest exact type the kernel computes in, and its bytes over the HBM
bandwidth, with each input read once and each output written once. The
work counted is the useful work of the served queries: their number
times the live rows times the width, whatever the kernel pads to.
"""

from __future__ import annotations

FP32_FLOPS = 67e12
INT8_OPS = 1979e12
# single-bit products (wgmma .b1 AND-popc, bq_scan_reduce): one m64nNk256
# b1 MMA issues at the rate of one m64nNk32 int8 MMA and covers 8 times
# its K, so 8 x the int8 peak
B1_OPS = 8 * INT8_OPS
HBM_BYTES_S = 3.35e12


def bound_s(nbytes: float, ops: float, peak_ops: float) -> float:
    """Seconds the chip needs at least: bytes or operations, the larger."""
    return max(nbytes / HBM_BYTES_S, ops / peak_ops)


def distance_block_s(queries: int, rows: int, dim: int) -> float:
    """[queries, dim] x [rows, dim] f32 distances: 2*q*n*d FP32 operations;
    the rows, the queries and the row norms read once, the [q, n] f32
    distances written once."""
    nbytes = rows * dim * 4 + queries * dim * 4 + rows * 4 + queries * rows * 4
    return bound_s(nbytes, 2.0 * queries * rows * dim, FP32_FLOPS)


def bq_scan_reduce_s(queries: int, rows: int, dim: int, candidates: int) -> float:
    """The sign-bit scan of ``queries`` over ``rows`` codes of ``dim`` bits,
    keeping ``candidates`` (id, distance) pairs a query: 2*q*n*d single-bit
    operations; the code words, the query words and a valid byte a row
    read once, the candidates written once (f32 + i32)."""
    words = -(-dim // 32)
    nbytes = rows * words * 4 + queries * words * 4 + rows + queries * candidates * 8
    return bound_s(nbytes, 2.0 * queries * rows * dim, B1_OPS)
