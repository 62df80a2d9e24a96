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
//   acc[t]  = sum over ascending s of (seg_term[s] == t ? contrib : 0)
//   score   = sum over ascending t of (idf[t] * acc[t]) / (k1 + acc[t])
// The arithmetic uses the _rn intrinsics, which nvcc never contracts into
// an FMA, and IEEE division (no fast math). The accumulators follow the
// reference's own form, a compare-select into every term of the tile, and
// the plain version (ops/kernels.bm25_block_plain) does the same. A
// segment whose term lies outside [0, T) adds nothing. The term loop runs
// over all T terms, padded ones included (idf 0, acc 0), as the reference
// does.
//
// Bound on an H100 SXM: the kernel reads the two planes once (2*B*S*C*4
// bytes) and writes [B, C] f32; the reference's cost estimate counts
// B*C*(4S + T(S+3)) operations. At B = 64, S = 16, T = 8, C = 4096 that is
// 34.6 MB (10.3 us at 3.35 TB/s) against 50 MFLOP (0.75 us at 67 TFLOP/s):
// bound by bytes.
//
// What held the first design back (0.0659 ms, 15.7% of that bound, timed
// from a CUDA graph; NVIDIA H100 80GB HBM3, 700 W; PERF.md):
// its accumulators were a 32 KB static shared array (7 CTAs an SM), and
// each thread walked its one column's segments with dependent loads (the
// term, then tf, then len when tf > 0), so few loads were in flight.
//
// Design: one thread per candidate column keeps the TT accumulators of a
// term tile in registers, a variant for each tile (TT = 8, 16, 32, 64
// terms); CTAs of 128 threads, one per (row, 128 columns). What bounds a
// CTA is the number of dependent trips to device memory, so the thread
// first issues its liveness word and its first group of plane loads (G
// segments, tf and len unconditionally), and only then does the CTA stage
// the row's segment scalars (term, boost, avg; SCH segments at a time)
// and the tile's idf in shared memory: one round trip covers the three.
// Each later group's loads go out together. T past 64 is taken in tiles of
// 64 terms in ascending order, `score` carried across them; there a group
// of segments none of whose terms falls in the tile is skipped (a uniform
// branch). Wider threads (2 or 4 columns, 16-byte loads) and CTAs of 64
// or 256 measured no faster (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

#include "scan_reduce_common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int SCH = 256;  // segments whose scalars are staged at a time
constexpr int G = 16;     // segments per group of plane loads

template <int TT>
__global__ void __launch_bounds__(THREADS)
bm25_block_kernel(const float* __restrict__ seg_tf, const float* __restrict__ seg_len,
                  const int* __restrict__ seg_term, const float* __restrict__ seg_boost,
                  const float* __restrict__ seg_avg, const float* __restrict__ idf,
                  const float* __restrict__ k1, const float* __restrict__ bb,
                  const float* __restrict__ omb, const uint32_t* __restrict__ cand_bits,
                  int S, int T, int C, int c_tiles, float* __restrict__ out) {
  __shared__ int s_term[SCH];
  __shared__ float s_boost[SCH], s_avg[SCH], s_idf[TT];

  const int row = blockIdx.x / c_tiles;
  const int c = (blockIdx.x % c_tiles) * THREADS + threadIdx.x;  // C % THREADS == 0
  const bool live = wtt_scan::allowed(cand_bits + (size_t)row * (C / 32), C / 32, c);
  const float kk = k1[row], b = bb[row], om = omb[row];
  const float* tfp = seg_tf + (size_t)row * S * C + c;
  const float* lnp = seg_len + (size_t)row * S * C + c;
  const bool tiled = T > TT;  // several term tiles: groups outside the tile are skipped

  float tf[G], ln[G];
  auto load = [&](int s0, int n) {  // segments s0 .. s0 + n - 1, zero past them
#pragma unroll
    for (int i = 0; i < G; ++i) {
      tf[i] = i < n ? __ldg(tfp + (size_t)(s0 + i) * C) : 0.0f;
      ln[i] = i < n ? __ldg(lnp + (size_t)(s0 + i) * C) : 0.0f;
    }
  };

  float score = 0.0f;
  for (int t0 = 0; t0 < T; t0 += TT) {
    const int tn = min(TT, T - t0);
    float acc[TT];
#pragma unroll
    for (int tt = 0; tt < TT; ++tt) acc[tt] = 0.0f;
    __syncthreads();  // the last tile's scalars and idf are read
    for (int i = threadIdx.x; i < TT; i += THREADS)
      s_idf[i] = i < tn ? idf[(size_t)row * T + t0 + i] : 0.0f;
    for (int sc0 = 0; sc0 < S; sc0 += SCH) {
      const int sn = min(SCH, S - sc0);
      if (!tiled) load(sc0, min(G, sn));  // in flight while the scalars are staged
      if (sc0 > 0) __syncthreads();  // the last chunk's scalars are read
      for (int i = threadIdx.x; i < SCH; i += THREADS) {
        const int s = sc0 + i;
        const bool in = s < S;
        // a segment past S names term -1: it never matches
        s_term[i] = in ? seg_term[(size_t)row * S + s] : -1;
        s_boost[i] = in ? seg_boost[(size_t)row * S + s] : 0.0f;
        s_avg[i] = in ? seg_avg[(size_t)row * S + s] : 1.0f;
      }
      __syncthreads();
      for (int g0 = 0; g0 < sn; g0 += G) {
        const int gn = min(G, sn - g0);
        if (tiled) {
          bool any = false;  // the same for every thread: a uniform branch
#pragma unroll
          for (int i = 0; i < G; ++i) {  // G divides SCH: g0 + i < SCH
            const int ts = s_term[g0 + i];
            any |= ts >= t0 && ts < t0 + tn;
          }
          if (!any) continue;
          load(sc0 + g0, gn);
        } else if (g0 > 0) {
          load(sc0 + g0, gn);
        }
#pragma unroll
        for (int i = 0; i < G; ++i) {
          if (i >= gn) break;
          const int term = s_term[g0 + i];
          const float boost = s_boost[g0 + i], avg = s_avg[g0 + i];
          const float norm = __fadd_rn(om, __fdiv_rn(__fmul_rn(b, ln[i]), avg));
          // max(norm, 1e-9) with the reference's NaN propagation
          const float den = norm < 1e-9f ? 1e-9f : norm;
          const float x = __fdiv_rn(__fmul_rn(boost, tf[i]), den);
          const float contrib = tf[i] > 0.0f ? x : 0.0f;
#pragma unroll
          for (int tt = 0; tt < TT; ++tt)
            acc[tt] = __fadd_rn(acc[tt], term == t0 + tt ? contrib : 0.0f);
        }
      }
    }
    __syncthreads();  // s_idf is staged even when S is 0
#pragma unroll
    for (int tt = 0; tt < TT; ++tt) {
      if (tt >= tn) break;
      score = __fadd_rn(score, __fdiv_rn(__fmul_rn(s_idf[tt], acc[tt]), __fadd_rn(kk, acc[tt])));
    }
  }
  out[(size_t)row * C + c] = live ? -score : wtt_scan::MASKED;
}

template <int TT>
int launch(const void* seg_tf, const void* seg_len, const void* seg_term, const void* seg_boost,
           const void* seg_avg, const void* idf, const void* k1, const void* b, const void* omb,
           const void* cand_bits, int B, int S, int T, int C, void* out, cudaStream_t stream) {
  const int c_tiles = C / THREADS;
  bm25_block_kernel<TT><<<B * c_tiles, THREADS, 0, stream>>>(
      static_cast<const float*>(seg_tf), static_cast<const float*>(seg_len),
      static_cast<const int*>(seg_term), static_cast<const float*>(seg_boost),
      static_cast<const float*>(seg_avg), static_cast<const float*>(idf),
      static_cast<const float*>(k1), static_cast<const float*>(b),
      static_cast<const float*>(omb), static_cast<const uint32_t*>(cand_bits), S, T, C, c_tiles,
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

// C interface (ctypes). Any B, S, T; C is a multiple of 512. Returns the
// launch's cudaGetLastError().
extern "C" int wtt_bm25_block(const void* seg_tf, const void* seg_len, const void* seg_term,
                              const void* seg_boost, const void* seg_avg, const void* idf,
                              const void* k1, const void* b, const void* omb,
                              const void* cand_bits, int B, int S, int T, int C, void* out,
                              void* stream) {
  if (B <= 0 || C <= 0) return (int)cudaGetLastError();
  if (C % 512 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (T <= 8)
    return launch<8>(seg_tf, seg_len, seg_term, seg_boost, seg_avg, idf, k1, b, omb, cand_bits,
                     B, S, T, C, out, s);
  if (T <= 16)
    return launch<16>(seg_tf, seg_len, seg_term, seg_boost, seg_avg, idf, k1, b, omb, cand_bits,
                      B, S, T, C, out, s);
  if (T <= 32)
    return launch<32>(seg_tf, seg_len, seg_term, seg_boost, seg_avg, idf, k1, b, omb, cand_bits,
                      B, S, T, C, out, s);
  return launch<64>(seg_tf, seg_len, seg_term, seg_boost, seg_avg, idf, k1, b, omb, cand_bits,
                    B, S, T, C, out, s);
}
