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
// bound by operations. bf16 storage could use the tensor cores, and is then
// bound by its corpus bytes over 3.35 TB/s; this first kernel widens bf16
// rows to f32 in shared memory and shares the FFMA path.
//
// Design: 64 x 128 output tile per CTA of 256 threads, 4 x 8 outputs per
// thread in registers, K slices of 16 double-buffered in shared memory
// through cp.async (tile_common.cuh). The metric epilogue and the validity
// mask are applied on the accumulators, so the [B, N] matrix is written
// exactly once. Ragged B, N and d are masked in the kernel.

#include "tile_common.cuh"

using namespace wtt;

template <typename T, int METRIC, bool ASYNC>
__global__ void __launch_bounds__(THREADS)
distance_block_kernel(const float* __restrict__ q, const float* __restrict__ qn,
                      const T* __restrict__ x, const float* __restrict__ xn,
                      const uint8_t* __restrict__ valid, int B, int N, int d,
                      float* __restrict__ out) {
  __shared__ __align__(16) unsigned char smem[gemm_smem_bytes<T>()];
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  float acc[TM][TN];
  gemm_tile<T, ASYNC>(q, x, B, N, d, m0, n0, smem, acc);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= B) continue;
    const float qv = (METRIC == L2) ? qn[m] : 0.f;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= N) continue;
      float v = metric_of<METRIC>(acc[i][j], qv, (METRIC == L2) ? xn[n] : 0.f);
      if (valid != nullptr) v = v + (1.0f - (valid[n] ? 1.0f : 0.0f)) * MASKED;
      out[(size_t)m * N + n] = v;
    }
  }
}

template <typename T, int METRIC>
static void launch(const float* q, const float* qn, const void* x, const float* xn,
                   const uint8_t* valid, int B, int N, int d, float* out, bool async_ok,
                   cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (B + BM - 1) / BM);
  const T* xt = static_cast<const T*>(x);
  if (async_ok)
    distance_block_kernel<T, METRIC, true><<<grid, THREADS, 0, stream>>>(q, qn, xt, xn, valid, B,
                                                                         N, d, out);
  else
    distance_block_kernel<T, METRIC, false><<<grid, THREADS, 0, stream>>>(q, qn, xt, xn, valid, B,
                                                                          N, d, out);
}

template <typename T>
static void launch_metric(int metric, const float* q, const float* qn, const void* x,
                          const float* xn, const uint8_t* valid, int B, int N, int d, float* out,
                          bool async_ok, cudaStream_t stream) {
  if (metric == L2)
    launch<T, L2>(q, qn, x, xn, valid, B, N, d, out, async_ok, stream);
  else if (metric == DOT)
    launch<T, DOT>(q, qn, x, xn, valid, B, N, d, out, async_ok, stream);
  else
    launch<T, COSINE>(q, qn, x, xn, valid, B, N, d, out, async_ok, stream);
}

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
      launch_metric<uint16_t>(metric, qf, qnf, x, xnf, v, B, N, d, o, async_ok != 0, s);
    else
      launch_metric<float>(metric, qf, qnf, x, xnf, v, B, N, d, o, async_ok != 0, s);
  }
  return (int)cudaGetLastError();
}
