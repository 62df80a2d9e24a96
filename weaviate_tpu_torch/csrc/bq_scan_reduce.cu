// bq_scan_reduce: full-corpus hamming scan over packed sign words with a
// strided block-argmin that keeps one candidate per reduce_l rows.
//   q [B, W] uint32, x [N, W] uint32 (or [W, N] transposed), valid [N] bool,
//   allow [B, wa] uint32 packed allow words
//   -> vals [B, n_st * out_w] f32 (true hamming, MASKED where dead or
//      disallowed), ids [B, n_st * out_w] i32 global rows.
//
// Replaces the TPU kernel weaviate_tpu/ops/pallas_kernels.py
// ``bq_scan_reduce`` (pallas_call in ``_bq_scan_tiled``, body
// ``_bq_scan_kernel``): a +-64 int8 matmul over bit planes unpacked in
// VMEM, fused with the packed (value << 6 | slice) strided minimum.
//
// Bound on an H100 SXM: the reference's cost estimate counts 2*B*N*32W int8
// operations (the +-1 matmul); against the dense int8 peak of 1,979 TOP/s
// that is 0.21 ms at B = 256, N = 1,048,576, W = 24, while the bytes (the
// 100 MB of codes read once) take 0.03 ms at 3.35 TB/s: bound by
// operations.
//
// Design (the simple, exact version): hamming as XOR + __popc on the CUDA
// cores, B*N*W popcounts, so the popcount rate (16 per clock per SM), not
// the tensor cores, sets the pace. One CTA owns 128 output columns of one
// supertile for 32 queries whose words sit in shared memory (zero-padded to
// a multiple of 8 words, read as 16-byte broadcasts). Each thread walks its
// column's reduce_l rows, loads a row's words 8 at a time into registers
// (two 16-byte loads when rows are 16-byte aligned; a transposed corpus is
// read one word per thread, coalesced across the warp) and reuses them for
// all 32 queries. The running (value * 64 + s) key of each query stays in a
// register; vals and ids are written once. A later version can move the
// +-1 product onto int8 mma/wgmma, as the TPU kernel does.

#include "scan_reduce_common.cuh"

using namespace wtt_scan;

constexpr int QB = 32;  // queries per CTA

__global__ void __launch_bounds__(THREADS)
bq_scan_reduce_kernel(const uint32_t* __restrict__ q, const uint32_t* __restrict__ x,
                      int transposed, int vec4, const bool* __restrict__ valid,
                      const uint32_t* __restrict__ allow, int wa, int B, int N, int W, int wp,
                      int reduce_l, int out_w, int supertile, int out_cols, int n_qblocks,
                      float* __restrict__ out_v, int* __restrict__ out_i) {
  extern __shared__ __align__(16) uint32_t sq[];  // [QB][wp] query words
  __shared__ int spop[QB];
  const Place p = place(n_qblocks, QB, out_w);
  const int nq = min(QB, B - p.q0);
  stage_query_words<QB>(sq, q, p.q0, B, W, wp, THREADS);
  __syncthreads();
  if (threadIdx.x < QB) {
    int pop = 0;
    for (int w = 0; w < wp; ++w) pop += __popc(sq[threadIdx.x * wp + w]);
    spop[threadIdx.x] = pop;
  }
  __syncthreads();
  if (p.c >= out_w) return;

  const int dead_off = 2 * 32 * W + 2;  // past any live hamming - popcount(q)
  int best[QB];
#pragma unroll
  for (int i = 0; i < QB; ++i) best[i] = INT_MAX;
  for (int s = 0; s < reduce_l; ++s) {
    const long long row = p.t * supertile + (long long)s * out_w + p.c;
    const bool in = row < N;
    const bool dead = !in || (valid != nullptr && !valid[row]);
    int ham[QB];
#pragma unroll
    for (int i = 0; i < QB; ++i) ham[i] = 0;
    int unused = 0;
    row_popcounts<QB, false, false>(sq, wp, x, in, transposed, vec4, row, N, W, ham,
                                    unused);
#pragma unroll
    for (int i = 0; i < QB; ++i) {
      int key = (ham[i] - spop[i] + (dead ? dead_off : 0)) * 64 + s;
      if (allow != nullptr &&
          (i >= nq || !allowed(allow + (size_t)(p.q0 + i) * wa, wa, row)))
        key = INT_MAX;
      best[i] = min(best[i], key);
    }
  }
  const int d = 32 * W;
  const long long col = p.t * out_w + p.c;
  const int base = (int)(p.t * supertile) + p.c;
#pragma unroll
  for (int i = 0; i < QB; ++i) {
    if (i < nq) {
      const int k = best[i];
      const float v = (float)(k >> 6) + (float)spop[i];
      const size_t o = (size_t)(p.q0 + i) * out_cols + col;
      out_v[o] = v > (float)d ? MASKED : v;
      out_i[o] = (k & 63) * out_w + base;
    }
  }
}

// C interface (ctypes); valid and allow may be null. Returns the launch's
// cudaGetLastError().
extern "C" int wtt_bq_scan_reduce(const void* q, const void* x, int transposed, int vec4,
                                  const void* valid, const void* allow, int wa, int B, int N,
                                  int W, int reduce_l, int out_w, int supertile, int n_st,
                                  int n_qblocks, void* vals, void* ids, void* stream) {
  if (B > 0 && n_st > 0) {
    const int wp = padded_words(W);
    const int smem = QB * wp * (int)sizeof(uint32_t);
    cudaFuncSetAttribute(bq_scan_reduce_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem);
    const long long blocks = (long long)n_st * n_colblocks(out_w) * n_qblocks;
    bq_scan_reduce_kernel<<<(unsigned)blocks, THREADS, smem,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(x), transposed, vec4,
        static_cast<const bool*>(valid), static_cast<const uint32_t*>(allow), wa, B, N, W, wp,
        reduce_l, out_w, supertile, n_st * out_w, n_qblocks, static_cast<float*>(vals),
        static_cast<int*>(ids));
  }
  return (int)cudaGetLastError();
}
