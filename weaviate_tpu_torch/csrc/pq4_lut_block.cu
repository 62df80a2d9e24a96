// pq4_lut_block: exact ADC distances of 4-bit PQ codes through a bf16 LUT,
// written as bf16.
//   lut [B, m, 16] f32 holding bf16-rounded entries (zero past k),
//   codes [N, m] uint8, valid [N] bool (or null)
//   -> out [B, N] bf16 = bf16_rn(sum_s lut[b, s, codes[n, s]]
//                               + (1 - valid) * MASKED), the sum in f32.
//
// Replaces the TPU kernel weaviate_tpu/ops/pallas_kernels.py
// ``pq4_lut_block`` (pallas_call in ``_pq4_tiled``, body ``_pq4_kernel``):
// the code row is tiled 16 times into a one-hot [TILE, 16m] bf16 matrix in
// VMEM and one MXU product against the code-major bf16 LUT sums one entry
// per segment in f32. A code past 15 matches no lane and adds nothing.
//
// Exactness: the one-hot product adds exactly one bf16 entry per segment,
// so the function is the f32 sum of those entries. This kernel adds them in
// segment order s = 0..m-1 from +0.0, the order of the plain version
// (ops/kernels.pq4_lut_block_plain), which equals the reference's output
// bit for bit in the tests; the mask add and the bf16 rounding follow.
//
// Bound on an H100 SXM: the reference's cost estimate counts 2*B*N*16m
// operations of the one-hot product; on the bf16 tensor cores (989
// TFLOP/s) that is 1.667 ms at B = 256, N = 1,048,576, m = 192, above the
// bytes (201 MB of codes, the 537 MB bf16 output: about 0.22 ms): bound by
// operations. The B*N*m table lookups this kernel does instead are shared-
// memory loads (one warp-wide load per clock per SM), which set its pace.
//
// Design: QB queries' tables sit in shared memory as f32, [QB][m][16] (12
// KB a query at m = 192; QB is the largest of 16, 8, 4, 2, 1 that fits the
// 227 KB a CTA may opt into and that B fills past its half). One thread
// per row: it loads 16 codes at a time (one 16-byte load when rows are
// 16-byte aligned) and adds, for each of its QB queries, the table entry
// of each code. The lanes of a warp read
// entries of one 64-byte table row, so the loads never conflict. A CTA
// walks ROW_PASSES blocks of THREADS rows, so its table fill is paid once
// for 2,048 rows. Stores: neighbouring threads on neighbouring rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float MASKED = 3.0e38f;  // MASKED_DISTANCE of ops/distances.py
constexpr int THREADS = 256;       // rows per pass
constexpr int ROW_PASSES = 8;      // passes per CTA
constexpr int SMEM_MAX = 232448;   // 227 KB, the opt-in limit of sm_90

// the 16 codes of segments [s0, s0 + 16) of one row, packed 4 to a word;
// segments past m read 0 (never used)
__device__ __forceinline__ void load_codes(uint32_t (&cw)[4], const uint8_t* __restrict__ row,
                                           int vec16, int s0, int m) {
  if (vec16) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(row + s0));
    cw[0] = v.x; cw[1] = v.y; cw[2] = v.z; cw[3] = v.w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      uint32_t w = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int s = s0 + 4 * k + b;
        if (s < m) w |= (uint32_t)__ldg(row + s) << (8 * b);
      }
      cw[k] = w;
    }
  }
}

template <int QB>
__global__ void __launch_bounds__(THREADS)
pq4_lut_block_kernel(const float* __restrict__ lut, const uint8_t* __restrict__ codes, int vec16,
                     const bool* __restrict__ valid, int B, int N, int m, int n_qblocks,
                     __nv_bfloat16* __restrict__ out) {
  extern __shared__ __align__(16) float slut[];  // [QB][m][16]
  const int q0 = (int)(blockIdx.x % n_qblocks) * QB;
  const int nq = min(QB, B - q0);
  const long long r0 = (long long)(blockIdx.x / n_qblocks) * THREADS * ROW_PASSES;
  {  // the block's tables: m * 16 floats a query, 16-byte copies, zero past B
    const int per_q4 = m * 4;
    const float4* src = reinterpret_cast<const float4*>(lut) + (size_t)q0 * per_q4;
    float4* dst = reinterpret_cast<float4*>(slut);
    for (int e = threadIdx.x; e < QB * per_q4; e += THREADS)
      dst[e] = (e / per_q4 < nq) ? __ldg(src + e) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();
  for (int pass = 0; pass < ROW_PASSES; ++pass) {
    const long long n = r0 + (long long)pass * THREADS + threadIdx.x;
    if (n >= N) return;
    const uint8_t* row = codes + (size_t)n * m;
    float acc[QB];
#pragma unroll
    for (int i = 0; i < QB; ++i) acc[i] = 0.f;
    for (int s0 = 0; s0 < m; s0 += 16) {
      uint32_t cw[4];
      load_codes(cw, row, vec16, s0, m);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        if (s0 + j < m) {
          const uint32_t c = (cw[j >> 2] >> (8 * (j & 3))) & 0xffu;
          const float* t = slut + (s0 + j) * 16 + (c & 15u);
#pragma unroll
          for (int i = 0; i < QB; ++i)
            acc[i] = __fadd_rn(acc[i], c < 16u ? t[(size_t)i * m * 16] : 0.f);
        }
      }
    }
    const float dead = (valid != nullptr && !valid[n]) ? MASKED : 0.f;
#pragma unroll
    for (int i = 0; i < QB; ++i) {
      if (i < nq) {
        const float v = (valid != nullptr) ? __fadd_rn(acc[i], dead) : acc[i];
        out[(size_t)(q0 + i) * N + n] = __float2bfloat16_rn(v);
      }
    }
  }
}

template <int QB>
int launch(const float* lut, const uint8_t* codes, int vec16, const bool* valid, int B, int N,
           int m, __nv_bfloat16* out, cudaStream_t stream) {
  // once per instantiation: opt in to the whole 227 KB
  static const cudaError_t attr = cudaFuncSetAttribute(
      pq4_lut_block_kernel<QB>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  if (attr != cudaSuccess) return (int)attr;
  const int smem = QB * m * 16 * (int)sizeof(float);
  const int n_qblocks = (B + QB - 1) / QB;
  const long long rows_per_cta = (long long)THREADS * ROW_PASSES;
  const long long blocks = ((long long)N + rows_per_cta - 1) / rows_per_cta * n_qblocks;
  pq4_lut_block_kernel<QB><<<(unsigned)blocks, THREADS, smem, stream>>>(
      lut, codes, vec16, valid, B, N, m, n_qblocks, out);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface (ctypes). lut is [B, m, 16] f32; valid may be null; vec16:
// m % 16 == 0 and codes 16-byte aligned. m <= SMEM_MAX / 64 (the wrapper
// checks). Returns the launch's cudaGetLastError().
extern "C" int wtt_pq4_lut_block(const void* lut, const void* codes, int vec16, const void* valid,
                                 int B, int N, int m, void* out, void* stream) {
  if (B <= 0 || N <= 0) return (int)cudaGetLastError();
  const float* l = static_cast<const float*>(lut);
  const uint8_t* c = static_cast<const uint8_t*>(codes);
  const bool* v = static_cast<const bool*>(valid);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the largest query block that fits and that B fills past its half
  const long long per_q = (long long)m * 16 * sizeof(float);
  if (16 * per_q <= SMEM_MAX && B > 8) return launch<16>(l, c, vec16, v, B, N, m, o, s);
  if (8 * per_q <= SMEM_MAX && B > 4) return launch<8>(l, c, vec16, v, B, N, m, o, s);
  if (4 * per_q <= SMEM_MAX && B > 2) return launch<4>(l, c, vec16, v, B, N, m, o, s);
  if (2 * per_q <= SMEM_MAX && B > 1) return launch<2>(l, c, vec16, v, B, N, m, o, s);
  return launch<1>(l, c, vec16, v, B, N, m, o, s);
}
