// bm25_block: negated BM25F scores over packed posting candidates.
//   seg_tf, seg_len [B, S, C] f32   per-(term, prop) planes over candidates
//   seg_term [B, S] i32, seg_boost, seg_avg [B, S] f32   segment scalars
//   idf [B, T] f32, k1, b, omb [B] f32 (omb = host-rounded f32(1 - b))
//   cand_bits [B, C / 32] uint32 block-strided candidate liveness
//   -> out [B, C] f32: -score on live candidates, MASKED elsewhere.
//
// Replaces the TPU kernel weaviate_tpu/ops/pallas_kernels.py ``bm25_block``
// (pallas_call in ``_bm25_tiled``, body ``_bm25_kernel``), which keeps one
// query row's [S, tile] planes in VMEM and its scalars in SMEM.
//
// Exactness: the result must equal the host scorer (text/inverted.py
// bm25_search) bit for bit, so every f32 operation of the reference runs
// here in its order and with its rounding:
//   norm    = omb + (b * len) / avg[s]
//   contrib = (boost[s] * tf) / max(norm, 1e-9)     (0 where tf <= 0)
//   acc[t]  = sum of contrib over the segments of term t, ascending s
//   score   = sum over ascending t of (idf[t] * acc[t]) / (k1 + acc[t])
// The arithmetic uses the _rn intrinsics, which nvcc never contracts into
// an FMA, and IEEE division (no fast math).
//
// One pass over s adds contrib[s] into acc[seg_term[s]]: each term's
// segments still sum in ascending s from +0.0, and a segment of another
// term or with tf <= 0 adds exactly +0.0 in the reference, which leaves the
// sum unchanged. The term loop runs over all T terms, padded ones included
// (idf 0, acc 0), exactly as the reference does.
//
// Bound on an H100 SXM: the kernel reads the two planes once (2*B*S*C*4
// bytes) and writes [B, C] f32; the reference's cost estimate counts
// B*C*(4S + T(S+3)) operations. At B = 64, S = 16, T = 8, C = 4096 that is
// 34.6 MB (10.3 us at 3.35 TB/s) against 50 MFLOP (0.75 us at 67 TFLOP/s):
// bound by bytes.
//
// Design: one thread per candidate column, THREADS columns per CTA, one
// CTA per (row, column tile). Loads of seg_tf[b, s, c] and seg_len[b, s, c]
// are coalesced across the warp; the row's segment scalars and idf are the
// same address for every thread, so each is one broadcast load per warp.
// The per-term accumulators are a [TERM_TILE][THREADS] shared array, each
// thread touching only its own column, so no barrier is needed. Any T is
// taken in tiles of TERM_TILE terms, in ascending order: each tile re-reads
// the row's segment terms and loads the planes only of the segments whose
// term falls in it, and `score` carries across the tiles, so the sums keep
// the reference's order. A segment whose term lies outside [0, T) adds
// nothing, as in the reference's `seg_term[s] == t` test.

#include <cuda_runtime.h>
#include <stdint.h>

#include "scan_reduce_common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int TERM_TILE = 64;  // 32 KB of accumulators, static shared memory

__global__ void __launch_bounds__(THREADS)
bm25_block_kernel(const float* __restrict__ seg_tf, const float* __restrict__ seg_len,
                  const int* __restrict__ seg_term, const float* __restrict__ seg_boost,
                  const float* __restrict__ seg_avg, const float* __restrict__ idf,
                  const float* __restrict__ k1, const float* __restrict__ bb,
                  const float* __restrict__ omb, const uint32_t* __restrict__ cand_bits,
                  int S, int T, int C, int c_tiles, float* __restrict__ out) {
  __shared__ float acc[TERM_TILE][THREADS];

  const int row = blockIdx.x / c_tiles;
  const int c = (blockIdx.x % c_tiles) * THREADS + threadIdx.x;
  if (c >= C) return;

  const float kk = k1[row], b = bb[row], om = omb[row];
  const int* term = seg_term + (size_t)row * S;
  const float* boost = seg_boost + (size_t)row * S;
  const float* avg = seg_avg + (size_t)row * S;
  const float* w = idf + (size_t)row * T;
  const size_t plane = (size_t)row * S * C + c;
  float score = 0.0f;
  for (int t0 = 0; t0 < T; t0 += TERM_TILE) {
    const int tn = min(TERM_TILE, T - t0);
    for (int t = 0; t < tn; ++t) acc[t][threadIdx.x] = 0.0f;
    for (int s = 0; s < S; ++s) {
      const int ts = __ldg(term + s) - t0;
      if (ts < 0 || ts >= tn) continue;
      const float tf = __ldg(seg_tf + plane + (size_t)s * C);
      if (tf > 0.0f) {
        const float ln = __ldg(seg_len + plane + (size_t)s * C);
        const float norm = __fadd_rn(om, __fdiv_rn(__fmul_rn(b, ln), __ldg(avg + s)));
        // max(norm, 1e-9) with the reference's NaN propagation
        const float den = norm < 1e-9f ? 1e-9f : norm;
        const float contrib = __fdiv_rn(__fmul_rn(__ldg(boost + s), tf), den);
        acc[ts][threadIdx.x] = __fadd_rn(acc[ts][threadIdx.x], contrib);
      }
    }
    for (int t = 0; t < tn; ++t) {
      const float a = acc[t][threadIdx.x];
      score = __fadd_rn(score, __fdiv_rn(__fmul_rn(__ldg(w + t0 + t), a), __fadd_rn(kk, a)));
    }
  }
  const bool live = wtt_scan::allowed(cand_bits + (size_t)row * (C / 32), C / 32, c);
  out[(size_t)row * C + c] = live ? -score : wtt_scan::MASKED;
}

}  // namespace

// C interface (ctypes). Any B, S, T; C is a multiple of 512. Returns the
// launch's cudaGetLastError().
extern "C" int wtt_bm25_block(const void* seg_tf, const void* seg_len, const void* seg_term,
                              const void* seg_boost, const void* seg_avg, const void* idf,
                              const void* k1, const void* b, const void* omb,
                              const void* cand_bits, int B, int S, int T, int C, void* out,
                              void* stream) {
  if (B > 0 && C > 0) {
    const int c_tiles = (C + THREADS - 1) / THREADS;
    bm25_block_kernel<<<B * c_tiles, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(seg_tf), static_cast<const float*>(seg_len),
        static_cast<const int*>(seg_term), static_cast<const float*>(seg_boost),
        static_cast<const float*>(seg_avg), static_cast<const float*>(idf),
        static_cast<const float*>(k1), static_cast<const float*>(b),
        static_cast<const float*>(omb), static_cast<const uint32_t*>(cand_bits), S, T, C,
        c_tiles, static_cast<float*>(out));
  }
  return (int)cudaGetLastError();
}
