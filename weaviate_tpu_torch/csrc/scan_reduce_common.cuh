// Shared device code of the two scan-reduce kernels (bq_scan_reduce.cu,
// pq4_scan_reduce.cu).
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

__host__ inline int n_colblocks(int out_w) { return (out_w + THREADS - 1) / THREADS; }

}  // namespace wtt_scan
