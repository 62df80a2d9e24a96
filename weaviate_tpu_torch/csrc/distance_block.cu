// distance_block: masked distances q [B, d] x x [N, d] -> out [B, N] f32.
//
// Replaces the TPU kernel weaviate_tpu/ops/pallas_kernels.py
// ``distance_block`` (pallas_call in ``_distance_tiled``, body
// ``_distance_kernel``): one MXU contraction per 512-row tile with the
// metric and (1 - valid) * MASKED epilogue fused in VMEM.
//
// Bound on an H100 SXM: the f32 product must be exact FP32 (the reference
// asks for Precision.HIGHEST), so it runs on the FFMA pipes, ~67 TFLOP/s:
// at the serving shape B = 256, N = 8192, d = 768 that is 3.2 GFLOP, about
// 48 us, against 25 MB of corpus + output traffic (~7.5 us at 3.35 TB/s) —
// bound by operations. bf16 rows are widened to f32 in shared memory and
// share the FFMA path.
//
// What held the first design back (0.1310 ms at [256,768] x [8192,768],
// 1.46x cuBLAS addmm's 0.0895; NVIDIA H100 80GB HBM3, 700 W; PERF.md):
// tile_common.cuh's gemm_tile, 4 x 8 outputs a thread (12 LDS for every 32
// FFMA per K step) in a two-stage ring of 16-wide K slices.
//
// Design: the product is ffma_tile.cuh's product_tile, the main loop of
// fused_topk_scan.cu: 128 threads, 64 queries x 128 rows a tile (16 x 128
// for drains of <= 32 queries), 8 (or 2) x 8 outputs a thread, here with
// K slices of 32 in a 4-stage cp.async ring. Both kernels sum each output
// in one fmaf chain over k = 0 .. d-1 from +0.0 (zero fill to d rounded up
// to 16), so the scan's distances equal these bit for bit and no distance
// depends on the batch. This file adds only the epilogue:
// the metric, the valid mask, and one write of each output (a half-warp
// writes 16 consecutive floats of a row: whole 32-byte sectors). Grid: the
// query block is the fastest index, so the CTAs that read one corpus tile
// run side by side and the corpus comes from HBM about once; at [256, 8192]
// the 256 CTAs fit the 132 SMs' 264 slots (two CTAs an SM) in one wave.

#include "ffma_tile.cuh"

using namespace wtt;
using namespace wtt::ffma;

namespace {

// The product's ring: K slices of 32 in 4 stages (108 KB at the 64-query
// tile, two CTAs an SM): half the barriers and ring turns of the scan's
// 16-wide slices, which its lists leave no room for.
template <typename T, int TM> using DistRing = Ring<T, TM, 32, 4>;

template <typename T, int METRIC, bool ASYNC, int TM>
__global__ void __launch_bounds__(STH, 2)
distance_block_kernel(const float* __restrict__ q, const float* __restrict__ qn,
                      const T* __restrict__ x, const float* __restrict__ xn,
                      const uint8_t* __restrict__ valid, int B, int N, int d,
                      float* __restrict__ out) {
  constexpr int SBM = 8 * TM;
  extern __shared__ __align__(16) unsigned char smem[];
  const int qblocks = (B + SBM - 1) / SBM;
  const int m0 = (int)(blockIdx.x % qblocks) * SBM;
  const int n0 = (int)(blockIdx.x / qblocks) * SBN;
  float acc[TM][TN];
  product_tile<T, ASYNC, DistRing<T, TM>>(q, x, B, N, d, m0, n0, smem, acc);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float xv[TN];
  bool live[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int n = n0 + tx + 16 * j;
    xv[j] = (METRIC == L2 && n < N) ? xn[n] : 0.f;
    live[j] = n < N && (valid == nullptr || valid[n]);
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + 8 * i;
    if (m >= B) continue;
    const float qv = (METRIC == L2) ? qn[m] : 0.f;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= N) continue;
      float v = metric_of<METRIC>(acc[i][j], qv, xv[j]);
      if (valid != nullptr) v = v + (1.0f - (live[j] ? 1.0f : 0.0f)) * MASKED;
      out[(size_t)m * N + n] = v;
    }
  }
}

template <typename T, int METRIC, bool ASYNC, int TM>
static void launch(const float* q, const float* qn, const void* x, const float* xn,
                   const uint8_t* valid, int B, int N, int d, float* out, cudaStream_t stream) {
  constexpr int SBM = 8 * TM;
  constexpr int smem = DistRing<T, TM>::BYTES;
  auto kern = distance_block_kernel<T, METRIC, ASYNC, TM>;
  // the attribute is set once per instantiation, not per launch
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  (void)attr;
  const long long blocks = (long long)((B + SBM - 1) / SBM) * ((N + SBN - 1) / SBN);
  kern<<<(unsigned)blocks, STH, smem, stream>>>(q, qn, static_cast<const T*>(x), xn, valid, B,
                                                N, d, out);
}

template <typename T, int METRIC>
static void launch_tile(bool async_ok, const float* q, const float* qn, const void* x,
                        const float* xn, const uint8_t* valid, int B, int N, int d, float* out,
                        cudaStream_t s) {
  if (small_tile(B, async_ok))
    launch<T, METRIC, true, 2>(q, qn, x, xn, valid, B, N, d, out, s);
  else if (async_ok)
    launch<T, METRIC, true, 8>(q, qn, x, xn, valid, B, N, d, out, s);
  else
    launch<T, METRIC, false, 8>(q, qn, x, xn, valid, B, N, d, out, s);
}

template <typename T>
static void launch_metric(int metric, bool async_ok, const float* q, const float* qn,
                          const void* x, const float* xn, const uint8_t* valid, int B, int N,
                          int d, float* out, cudaStream_t s) {
  if (metric == L2)
    launch_tile<T, L2>(async_ok, q, qn, x, xn, valid, B, N, d, out, s);
  else if (metric == DOT)
    launch_tile<T, DOT>(async_ok, q, qn, x, xn, valid, B, N, d, out, s);
  else
    launch_tile<T, COSINE>(async_ok, q, qn, x, xn, valid, B, N, d, out, s);
}

}  // namespace

// C interface (ctypes). x_bf16 != 0 means x holds bfloat16 rows. qn / xn
// are read for l2 only; valid may be null (every row live). Returns the
// launch's cudaGetLastError().
extern "C" int wtt_distance_block(const void* q, const void* qn, const void* x, int x_bf16,
                                  const void* xn, const void* valid, int B, int N, int d,
                                  int metric, void* out, int async_ok, void* stream) {
  if (B > 0 && N > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float* qf = static_cast<const float*>(q);
    const float* qnf = static_cast<const float*>(qn);
    const float* xnf = static_cast<const float*>(xn);
    const uint8_t* v = static_cast<const uint8_t*>(valid);
    float* o = static_cast<float*>(out);
    if (x_bf16)
      launch_metric<uint16_t>(metric, async_ok != 0, qf, qnf, x, xnf, v, B, N, d, o, s);
    else
      launch_metric<float>(metric, async_ok != 0, qf, qnf, x, xnf, v, B, N, d, o, s);
  }
  return (int)cudaGetLastError();
}
