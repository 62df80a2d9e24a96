// pq4_recon_block: ADC distances of 4-bit PQ codes through the reconstructed
// rows, written as bf16.
//   q [B, d] f32 holding bf16-rounded values, qn [B] f32 (|q|^2, l2 only),
//   codes [N, m] uint8, cent [m, 16, ds] f32 holding bf16-rounded
//   centroids (zero past k), valid [N] bool (or null), d = m * ds
//   -> out [B, N] bf16 of
//        l2-squared  qn - 2 q.x_hat + |x_hat|^2   (no clamp)
//        dot         -q.x_hat
//        cosine      1 - q.x_hat                  (q unit length upstream)
//      plus (1 - valid) * MASKED, in f32, rounded to nearest even;
//   x_hat[n, s*ds + j] = cent[s, codes[n, s], j], 0 for a code past 15.
//
// Replaces the TPU kernel weaviate_tpu/ops/pallas_kernels.py
// ``pq4_recon_block`` (pallas_call in ``_pq4_recon_tiled``, body
// ``_pq4_recon_kernel``): a one-hot [TILE, 16m] matrix times the
// block-diagonal bf16 centroids [16m, d] rebuilds x_hat in VMEM (exactly:
// one nonzero term per column), then |x_hat|^2 and the bf16 product q.x_hat,
// both summed in f32, and the metric epilogue.
//
// Bound on an H100 SXM: the distance product is 2*B*N*d operations, 4.12e11
// at B = 256, N = 1,048,576, d = 768: 0.417 ms on the bf16 tensor cores
// (989 TFLOP/s), above the bytes (201 MB of codes, the 537 MB bf16 output:
// about 0.22 ms). The reconstruction needs no multiply here: it is a
// gather (the reference's cost estimate, 5.36e12, counts its one-hot
// product). Bound by operations. This kernel multiplies on the FFMA pipes
// (67 TFLOP/s), which sets its pace; the products of bf16 values are exact
// in f32, so only the order of the sums differs from the reference.
//
// Design: distance_block's register tile (tile_common.cuh): a CTA of 256
// threads computes 64 queries x 128 rows, 4 x 8 per thread, over K slices
// of 16 dims. Each slice stages the queries' values and the rows' x_hat
// into shared memory, x_hat gathered from the centroids (a 48 KB table at
// d = 768 that stays in L1 and L2) by the rows' codes. The first 128
// threads add their row's |x_hat|^2 from the staged slice (l2 only). The
// epilogue adds the metric and the mask on the accumulators and writes each
// value once.

#include <cuda_bf16.h>

#include "tile_common.cuh"

using namespace wtt;

namespace {

constexpr int SK = BK + 4;  // f32 row stride of a staged slice (80 B)

template <int METRIC>
__global__ void __launch_bounds__(THREADS)
pq4_recon_block_kernel(const float* __restrict__ q, const float* __restrict__ qn,
                       const uint8_t* __restrict__ codes, const float* __restrict__ cent,
                       const bool* __restrict__ valid, int B, int N, int m, int ds,
                       __nv_bfloat16* __restrict__ out) {
  __shared__ __align__(16) float qs[BM * SK];
  __shared__ __align__(16) float xs[BN * SK];
  __shared__ float sxn[BN];
  const int d = m * ds;
  const long long n0 = (long long)blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int t = threadIdx.x, tx = t % 16, ty = t / 16;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  float xn = 0.f;  // thread t < BN: |x_hat|^2 of row n0 + t

  for (int k0 = 0; k0 < d; k0 += BK) {
    for (int e = t; e < BM * BK; e += THREADS) {
      const int r = e / BK, c = e % BK, mm = m0 + r, k = k0 + c;
      qs[r * SK + c] = (mm < B && k < d) ? __ldg(q + (size_t)mm * d + k) : 0.f;
    }
    for (int e = t; e < BN * BK; e += THREADS) {
      const int r = e / BK, c = e % BK, k = k0 + c;
      const long long n = n0 + r;
      float v = 0.f;
      if (n < N && k < d) {
        const int s = k / ds, j = k - s * ds;
        const uint32_t code = __ldg(codes + (size_t)n * m + s);
        if (code < 16u) v = __ldg(cent + ((size_t)s * 16 + code) * ds + j);
      }
      xs[r * SK + c] = v;
    }
    __syncthreads();
    if (METRIC == L2 && t < BN) {
#pragma unroll
      for (int c = 0; c < BK; ++c) xn = fmaf(xs[t * SK + c], xs[t * SK + c], xn);
    }
#pragma unroll
    for (int kk = 0; kk < BK; kk += 4) {
      float4 a[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = load4(qs + (ty * TM + i) * SK + kk);
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float4 b = load4(xs + (tx + 16 * j) * SK + kk);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          acc[i][j] = fmaf(a[i].x, b.x, acc[i][j]);
          acc[i][j] = fmaf(a[i].y, b.y, acc[i][j]);
          acc[i][j] = fmaf(a[i].z, b.z, acc[i][j]);
          acc[i][j] = fmaf(a[i].w, b.w, acc[i][j]);
        }
      }
    }
    __syncthreads();  // the next slice restages both buffers
  }
  if (METRIC == L2 && t < BN) sxn[t] = xn;
  __syncthreads();

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int mm = m0 + ty * TM + i;
    if (mm >= B) continue;
    const float qv = (METRIC == L2) ? qn[mm] : 0.f;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const long long n = n0 + tx + 16 * j;
      if (n >= N) continue;
      const float dot = acc[i][j];
      float v;
      if (METRIC == L2)
        v = __fadd_rn(__fsub_rn(qv, __fmul_rn(2.f, dot)), sxn[tx + 16 * j]);
      else if (METRIC == DOT)
        v = -dot;
      else
        v = __fsub_rn(1.f, dot);
      if (valid != nullptr) v = __fadd_rn(v, valid[n] ? 0.f : MASKED);
      out[(size_t)mm * N + n] = __float2bfloat16_rn(v);
    }
  }
}

template <int METRIC>
void launch(const float* q, const float* qn, const uint8_t* codes, const float* cent,
            const bool* valid, int B, int N, int m, int ds, __nv_bfloat16* out,
            cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (B + BM - 1) / BM);
  pq4_recon_block_kernel<METRIC><<<grid, THREADS, 0, stream>>>(q, qn, codes, cent, valid, B, N,
                                                                m, ds, out);
}

}  // namespace

// C interface (ctypes). metric: 0 l2-squared, 1 dot, 2 cosine; qn is read
// for l2 only; valid may be null. Returns the launch's cudaGetLastError().
extern "C" int wtt_pq4_recon_block(const void* q, const void* qn, const void* codes,
                                   const void* cent, const void* valid, int B, int N, int m,
                                   int ds, int metric, void* out, void* stream) {
  if (B > 0 && N > 0) {
    const float* qf = static_cast<const float*>(q);
    const float* qnf = static_cast<const float*>(qn);
    const uint8_t* c = static_cast<const uint8_t*>(codes);
    const float* ct = static_cast<const float*>(cent);
    const bool* v = static_cast<const bool*>(valid);
    __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (metric == L2)
      launch<L2>(qf, qnf, c, ct, v, B, N, m, ds, o, s);
    else if (metric == DOT)
      launch<DOT>(qf, qnf, c, ct, v, B, N, m, ds, o, s);
    else
      launch<COSINE>(qf, qnf, c, ct, v, B, N, m, ds, o, s);
  }
  return (int)cudaGetLastError();
}
