// pq4_scan_reduce: full-corpus 4-bit PQ ADC scan through a per-query int8
// lookup table, with a strided block-argmin that keeps one candidate per
// reduce_l rows.
//   lut8 [B, 16*pm] int8 code-major (entry of code c, segment s at c*pm + s,
//   quantize_lut_int8's layout), scale [B] f32, codes [N, m] uint8 (or
//   [m, N] transposed), valid [N] bool, allow [B, wa] uint32 allow words
//   -> vals [B, n_st * out_w] f32 (ADC sum / scale, MASKED where dead or
//      disallowed), ids [B, n_st * out_w] i32 global rows.
//
// Replaces the TPU kernel weaviate_tpu/ops/pallas_kernels.py
// ``pq4_scan_reduce`` (pallas_call in ``_pq4_scan_tiled``, body
// ``_pq4_scan_kernel``): a one-hot x int8 LUT matmul on the MXU, fused with
// the packed (value << 6 | slice) strided minimum.
//
// Bound on an H100 SXM: the reference's cost estimate counts 2*B*N*16m
// int8 operations (the one-hot product); against the dense int8 peak of
// 1,979 TOP/s that is 0.83 ms at B = 256, N = 1,048,576, m = 192, while the
// bytes (201 MB of codes read once) take 0.06 ms at 3.35 TB/s: bound by
// operations.
//
// Design (the simple, exact version): a table lookup per (row, segment)
// instead of the one-hot product, so the cost is B*N*m lookups on the CUDA
// cores and shared memory. One CTA owns 128 output columns of one
// supertile for 16 queries. Their tables sit in shared memory as
// [segment][code][16 queries] bytes biased by +128 (unsigned 1..255), so one
// 16-byte load gives a row's entry for all 16 queries; __byte_perm spreads
// each 4-byte word into two 16-bit lanes and plain 32-bit adds sum two
// queries at once (255 * 256 < 65536: the lanes are flushed into int32 sums
// every 256 segments and the bias is taken off at the end). Each thread
// walks its column's reduce_l rows, loading a row's codes 16 at a time (one
// 16-byte load when rows are 16-byte aligned; a transposed corpus is read
// one byte per thread, coalesced across the warp). Codes are read as
// code & 15. The running (value * 64 + s) key of each query stays in a
// register; vals and ids are written once. A later version can run the
// one-hot x LUT product on int8 mma/wgmma, as the TPU kernel does.

#include "scan_reduce_common.cuh"

using namespace wtt_scan;

constexpr int QB = 16;  // queries per CTA: one 16-byte table row per (segment, code)
constexpr int SC = 16;  // segments per code load
constexpr int FLUSH = 256;  // segments summed in 16-bit lanes before a flush

__device__ __forceinline__ void load_codes(uint32_t (&cw)[4], const uint8_t* __restrict__ codes,
                                           bool in, int transposed, int vec16, long long row,
                                           int N, int m, int seg0) {
  if (!in) {
    cw[0] = cw[1] = cw[2] = cw[3] = 0u;
  } else if (!transposed && vec16 && seg0 + SC <= m) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(codes + (size_t)row * m + seg0));
    cw[0] = u.x; cw[1] = u.y; cw[2] = u.z; cw[3] = u.w;
  } else {
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      uint32_t v = 0u;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int seg = seg0 + 4 * w + j;
        if (seg < m) {
          const uint8_t c = transposed ? __ldg(codes + (size_t)seg * N + row)
                                       : __ldg(codes + (size_t)row * m + seg);
          v |= (uint32_t)c << (8 * j);
        }
      }
      cw[w] = v;
    }
  }
}

__device__ __forceinline__ void flush(uint32_t (&acc)[QB / 2], int (&tot)[QB]) {
#pragma unroll
  for (int a = 0; a < QB / 2; ++a) {
    tot[2 * a] += (int)(acc[a] & 0xFFFFu);
    tot[2 * a + 1] += (int)(acc[a] >> 16);
    acc[a] = 0u;
  }
}

__global__ void __launch_bounds__(THREADS)
pq4_scan_reduce_kernel(const int8_t* __restrict__ lut8, const float* __restrict__ scale,
                       int pm, const uint8_t* __restrict__ codes, int transposed, int vec16,
                       const bool* __restrict__ valid, const uint32_t* __restrict__ allow,
                       int wa, int B, int N, int m, int m16, int reduce_l, int out_w,
                       int supertile, int out_cols, int n_qblocks, float* __restrict__ out_v,
                       int* __restrict__ out_i) {
  extern __shared__ __align__(16) uint4 slut[];  // [m16][16 codes] rows of 16 query bytes
  uint8_t* sbytes = reinterpret_cast<uint8_t*>(slut);
  const Place p = place(n_qblocks, QB, out_w);
  const int nq = min(QB, B - p.q0);
  // fill: walk the global table in its own order (coalesced reads); padded
  // queries and segments hold a zero entry (the +128 bias alone)
  for (int e = threadIdx.x; e < QB * 16 * m16; e += THREADS) {
    const int seg = e % m16, code = (e / m16) % 16, qi = e / (m16 * 16);
    int v = 0;
    if (qi < nq && seg < m) v = lut8[(size_t)(p.q0 + qi) * 16 * pm + code * pm + seg];
    sbytes[(seg * 16 + code) * QB + qi] = (uint8_t)(v + 128);
  }
  __syncthreads();
  if (p.c >= out_w) return;

  const int dead_off = 2 * 127 * pm + 2;  // past any live ADC sum
  int best[QB];
#pragma unroll
  for (int i = 0; i < QB; ++i) best[i] = INT_MAX;
  for (int s = 0; s < reduce_l; ++s) {
    const long long row = p.t * supertile + (long long)s * out_w + p.c;
    const bool in = row < N;
    const bool dead = !in || (valid != nullptr && !valid[row]);
    uint32_t acc[QB / 2];
    int tot[QB];
#pragma unroll
    for (int a = 0; a < QB / 2; ++a) acc[a] = 0u;
#pragma unroll
    for (int i = 0; i < QB; ++i) tot[i] = 0;
    for (int seg0 = 0; seg0 < m16; seg0 += SC) {
      uint32_t cw[4];
      load_codes(cw, codes, in, transposed, vec16, row, N, m, seg0);
#pragma unroll
      for (int j = 0; j < SC; ++j) {
        const int code = (cw[j >> 2] >> (8 * (j & 3))) & 15;
        const uint4 e = slut[(seg0 + j) * 16 + code];
        acc[0] += __byte_perm(e.x, 0u, 0x4140);
        acc[1] += __byte_perm(e.x, 0u, 0x4342);
        acc[2] += __byte_perm(e.y, 0u, 0x4140);
        acc[3] += __byte_perm(e.y, 0u, 0x4342);
        acc[4] += __byte_perm(e.z, 0u, 0x4140);
        acc[5] += __byte_perm(e.z, 0u, 0x4342);
        acc[6] += __byte_perm(e.w, 0u, 0x4140);
        acc[7] += __byte_perm(e.w, 0u, 0x4342);
      }
      if ((seg0 + SC) % FLUSH == 0) flush(acc, tot);
    }
    flush(acc, tot);
#pragma unroll
    for (int i = 0; i < QB; ++i) {
      const int raw = tot[i] - 128 * m16;
      int key = (raw + (dead ? dead_off : 0)) * 64 + s;
      if (allow != nullptr &&
          (i >= nq || !allowed(allow + (size_t)(p.q0 + i) * wa, wa, row)))
        key = INT_MAX;
      best[i] = min(best[i], key);
    }
  }
  const long long col = p.t * out_w + p.c;
  const int base = (int)(p.t * supertile) + p.c;
#pragma unroll
  for (int i = 0; i < QB; ++i) {
    if (i < nq) {
      const int k = best[i];
      const int raw = k >> 6;
      const size_t o = (size_t)(p.q0 + i) * out_cols + col;
      out_v[o] = raw > 127 * pm ? MASKED : (float)raw / scale[p.q0 + i];
      out_i[o] = (k & 63) * out_w + base;
    }
  }
}

// C interface (ctypes); valid and allow may be null. Returns the launch's
// cudaGetLastError().
extern "C" int wtt_pq4_scan_reduce(const void* lut8, const void* scale, int pm,
                                   const void* codes, int transposed, int vec16,
                                   const void* valid, const void* allow, int wa, int B, int N,
                                   int m, int reduce_l, int out_w, int supertile, int n_st,
                                   int n_qblocks, void* vals, void* ids, void* stream) {
  if (B > 0 && n_st > 0) {
    const int m16 = ((m + SC - 1) / SC) * SC;
    const int smem = m16 * 16 * QB;
    cudaFuncSetAttribute(pq4_scan_reduce_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem);
    const long long blocks = (long long)n_st * n_colblocks(out_w) * n_qblocks;
    pq4_scan_reduce_kernel<<<(unsigned)blocks, THREADS, smem,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(lut8), static_cast<const float*>(scale), pm,
        static_cast<const uint8_t*>(codes), transposed, vec16, static_cast<const bool*>(valid),
        static_cast<const uint32_t*>(allow), wa, B, N, m, m16, reduce_l, out_w, supertile,
        n_st * out_w, n_qblocks, static_cast<float*>(vals), static_cast<int*>(ids));
  }
  return (int)cudaGetLastError();
}
