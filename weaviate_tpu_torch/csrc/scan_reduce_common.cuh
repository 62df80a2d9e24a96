// Shared device code of the two scan-reduce kernels (bq_scan_reduce.cu,
// pq4_scan_reduce.cu); the query staging, sign-word loads and popcount
// pass also serve the two bq block kernels (bq_hamming_block.cu,
// bq_mxu_block.cu).
//
// Both cut the rows into supertiles of reduce_l * out_w rows. Output column
// c of supertile t keeps the best of the rows t*supertile + s*out_w + c,
// s = 0 .. reduce_l-1, by the packed key value * 64 + s (unique per s, so
// the minimum is the lexicographic (value, s) order of the reference's
// packed int32 merge). One CTA of THREADS threads owns THREADS output
// columns of one supertile for one block of queries; each thread walks its
// column's reduce_l rows and keeps one running key per query in registers.
//
// Grid: one dimension, the query block fastest, so the CTAs that read the
// same code rows run side by side and share them through L2.
#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace wtt_scan {

constexpr float MASKED = 3.0e38f;  // MASKED_DISTANCE of ops/distances.py
constexpr int THREADS = 128;       // output columns per CTA

// Where one CTA sits: supertile t, output column c, first query q0.
struct Place {
  long long t;
  int c, q0;
};

__device__ __forceinline__ Place place(int n_qblocks, int qblock, int out_w) {
  const int n_colblocks = (out_w + THREADS - 1) / THREADS;
  const long long tile = blockIdx.x / n_qblocks;
  Place p;
  p.q0 = (int)(blockIdx.x % n_qblocks) * qblock;
  p.t = tile / n_colblocks;
  p.c = (int)(tile % n_colblocks) * THREADS + (int)threadIdx.x;
  return p;
}

// Allow bit of row r in one query's packed words (pack_allow_bitmask's
// block-strided layout: row r is bit (r % 512) / 16 of word
// (r / 512) * 16 + r % 16). Words past ``wa`` are disallowed, as the
// reference's zero padding makes them.
__device__ __forceinline__ bool allowed(const uint32_t* __restrict__ words, int wa,
                                        long long r) {
  const long long w = (r >> 9) * 16 + (r & 15);
  if (w >= wa) return false;
  return (__ldg(words + w) >> ((r & 511) >> 4)) & 1u;
}

// Words [w0, w0 + WC) of one row into registers, zero past W or for a row
// out of range. Row-major rows are read in two 16-byte loads when ``vec4``
// (W % 4 == 0 and a 16-byte-aligned base); a transposed [W, N] corpus is
// read one word per thread, coalesced across the warp.
constexpr int WC = 8;  // words per register chunk
__device__ __forceinline__ void load_words(uint32_t (&xr)[WC], const uint32_t* __restrict__ x,
                                           bool in, int transposed, int vec4, long long row,
                                           int N, int W, int w0) {
  if (!in) {
#pragma unroll
    for (int j = 0; j < WC; ++j) xr[j] = 0u;
  } else if (!transposed) {
    const uint32_t* p = x + (size_t)row * W + w0;
    if (vec4 && w0 + WC <= W) {
      const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
      const uint4 b = __ldg(reinterpret_cast<const uint4*>(p) + 1);
      xr[0] = a.x; xr[1] = a.y; xr[2] = a.z; xr[3] = a.w;
      xr[4] = b.x; xr[5] = b.y; xr[6] = b.z; xr[7] = b.w;
    } else {
#pragma unroll
      for (int j = 0; j < WC; ++j) xr[j] = (w0 + j < W) ? __ldg(p + j) : 0u;
    }
  } else {
#pragma unroll
    for (int j = 0; j < WC; ++j)
      xr[j] = (w0 + j < W) ? __ldg(x + (size_t)(w0 + j) * N + row) : 0u;
  }
}

// Popcount pass of the bq kernels: for QB queries whose words sit in
// shared memory (``wp`` words each, zero past W, wp a multiple of WC, read
// as 16-byte broadcasts), acc[i] += popc(q_i ^ x) (hamming) or popc(q_i & x)
// (AND, the bit-plane dot) over one row's words (load_words' layouts; a
// row not ``in`` reads as zeros); ``xpop`` gets popc(x) when COUNT_X. Each
// row word is loaded once for all QB queries.
template <int QB, bool AND, bool COUNT_X>
__device__ __forceinline__ void row_popcounts(const uint32_t* sq, int wp,
                                              const uint32_t* __restrict__ x, bool in,
                                              int transposed, int vec4, long long row, int N,
                                              int W, int (&acc)[QB], int& xpop) {
  for (int w0 = 0; w0 < wp; w0 += WC) {
    uint32_t xr[WC];
    load_words(xr, x, in, transposed, vec4, row, N, W, w0);
    if (COUNT_X) {
#pragma unroll
      for (int j = 0; j < WC; ++j) xpop += __popc(xr[j]);
    }
#pragma unroll
    for (int i = 0; i < QB; ++i) {
      const uint4* qw = reinterpret_cast<const uint4*>(sq + i * wp + w0);
      const uint4 a = qw[0], b = qw[1];
      if (AND)
        acc[i] += __popc(a.x & xr[0]) + __popc(a.y & xr[1]) + __popc(a.z & xr[2]) +
                  __popc(a.w & xr[3]) + __popc(b.x & xr[4]) + __popc(b.y & xr[5]) +
                  __popc(b.z & xr[6]) + __popc(b.w & xr[7]);
      else
        acc[i] += __popc(a.x ^ xr[0]) + __popc(a.y ^ xr[1]) + __popc(a.z ^ xr[2]) +
                  __popc(a.w ^ xr[3]) + __popc(b.x ^ xr[4]) + __popc(b.y ^ xr[5]) +
                  __popc(b.z ^ xr[6]) + __popc(b.w ^ xr[7]);
    }
  }
}

// Stage the words of queries [q0, q0 + QB) into shared memory, ``wp``
// words a query, zero past W and past B.
template <int QB>
__device__ __forceinline__ void stage_query_words(uint32_t* sq, const uint32_t* __restrict__ q,
                                                  int q0, int B, int W, int wp, int nthreads) {
  for (int e = threadIdx.x; e < QB * wp; e += nthreads) {
    const int qi = e / wp, w = e % wp;
    sq[e] = (q0 + qi < B && w < W) ? q[(size_t)(q0 + qi) * W + w] : 0u;
  }
}

__host__ inline int padded_words(int W) { return (W + WC - 1) / WC * WC; }

__host__ inline int n_colblocks(int out_w) { return (out_w + THREADS - 1) / THREADS; }

}  // namespace wtt_scan
