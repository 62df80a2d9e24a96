// bq_mxu_block: masked hamming distances in the form of the TPU's MXU
// kernel, written as bf16.
//   q [B, W] uint32, x [N, W] uint32, qpop [B] f32, xpop [N] f32 (or null:
//   popcount of the row), valid [N] bool (or null)
//   -> out [B, N] bf16 = bf16_rn(qpop + xpop - 2 * popc(q & x)
//                               + (1 - valid) * MASKED), the sum in f32.
//
// Replaces the TPU kernel weaviate_tpu/ops/pallas_kernels.py
// ``bq_mxu_block`` (pallas_call in ``_bq_mxu_tiled``, body
// ``_bq_mxu_kernel``): the corpus words are unpacked into 0/1 bf16 bit
// planes in VMEM and one MXU product with the queries' planes gives the
// bit-plane dot q.x, exact in its f32 accumulator; the epilogue is
// |q| + |x| - 2 q.x plus the mask, in f32, rounded to bf16. The dot of 0/1
// planes is popc(q & x) summed over the words, so no planes are needed here
// and the result is the same function, bit for bit: every term is an
// integer below 2^24 and the f32 operations run in the reference's order
// with its rounding (the _rn intrinsics, never contracted).
//
// Bound on an H100 SXM: the reference's cost estimate counts 2*B*N*32W
// operations of the 0/1 product; on the int8 tensor cores (1,979 TOP/s)
// that is 0.208 ms at B = 256, N = 1,048,576, W = 24, above the bytes
// (101 MB of words and the 537 MB bf16 output: about 0.19 ms at 3.35
// TB/s): bound by operations. This kernel does B*N*W AND + popcounts on
// the CUDA cores instead (16 popcounts per clock per SM), which sets its
// pace.
//
// Design: bq_hamming_block's (one thread per row, THREADS rows and QB
// queries per CTA, the queries' words in shared memory, the row's words
// loaded once for all queries), with AND for XOR, the row's popcount taken
// on the way when the caller has none cached, and the mask epilogue. A
// warp's stores are 64 contiguous bytes per query.

#include <cuda_bf16.h>

#include "scan_reduce_common.cuh"

using namespace wtt_scan;

namespace {

constexpr int QB = 32;  // queries per CTA

template <bool COUNT_X>
__global__ void __launch_bounds__(THREADS)
bq_mxu_block_kernel(const uint32_t* __restrict__ q, const uint32_t* __restrict__ x, int vec4,
                    const float* __restrict__ qpop, const float* __restrict__ xpop,
                    const bool* __restrict__ valid, int B, int N, int W, int wp, int n_qblocks,
                    __nv_bfloat16* __restrict__ out) {
  extern __shared__ __align__(16) uint32_t sq[];  // [QB][wp] query words
  __shared__ float sqpop[QB];
  const int q0 = (int)(blockIdx.x % n_qblocks) * QB;
  const long long row = (long long)(blockIdx.x / n_qblocks) * THREADS + threadIdx.x;
  stage_query_words<QB>(sq, q, q0, B, W, wp, THREADS);
  const int t = (int)threadIdx.x;
  if (t < QB) sqpop[t] = (q0 + t < B) ? qpop[q0 + t] : 0.f;
  __syncthreads();
  if (row >= N) return;
  int dot[QB];
#pragma unroll
  for (int i = 0; i < QB; ++i) dot[i] = 0;
  int xcount = 0;
  row_popcounts<QB, true, COUNT_X>(sq, wp, x, true, 0, vec4, row, N, W, dot, xcount);
  const float xp = COUNT_X ? (float)xcount : xpop[row];
  const float dead = (valid != nullptr && !valid[row]) ? MASKED : 0.f;
  const int nq = min(QB, B - q0);
#pragma unroll
  for (int i = 0; i < QB; ++i) {
    if (i < nq) {
      float d = __fsub_rn(__fadd_rn(sqpop[i], xp), __fmul_rn(2.f, (float)dot[i]));
      if (valid != nullptr) d = __fadd_rn(d, dead);
      out[(size_t)(q0 + i) * N + row] = __float2bfloat16_rn(d);
    }
  }
}

template <bool COUNT_X>
void launch(const uint32_t* q, const uint32_t* x, int vec4, const float* qpop, const float* xpop,
            const bool* valid, int B, int N, int W, __nv_bfloat16* out, cudaStream_t stream) {
  const int wp = padded_words(W);
  const int smem = QB * wp * (int)sizeof(uint32_t);
  if (smem > 40 * 1024)  // beside the static qpop array
    cudaFuncSetAttribute(bq_mxu_block_kernel<COUNT_X>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const int n_qblocks = (B + QB - 1) / QB;
  const long long blocks = (long long)((N + THREADS - 1) / THREADS) * n_qblocks;
  bq_mxu_block_kernel<COUNT_X><<<(unsigned)blocks, THREADS, smem, stream>>>(
      q, x, vec4, qpop, xpop, valid, B, N, W, wp, n_qblocks, out);
}

}  // namespace

// C interface (ctypes). xpop and valid may be null. vec4: W % 4 == 0 and x
// 16-byte aligned. Returns the launch's cudaGetLastError().
extern "C" int wtt_bq_mxu_block(const void* q, const void* x, int vec4, const void* qpop,
                                const void* xpop, const void* valid, int B, int N, int W,
                                void* out, void* stream) {
  if (B > 0 && N > 0) {
    const uint32_t* qq = static_cast<const uint32_t*>(q);
    const uint32_t* xx = static_cast<const uint32_t*>(x);
    const float* qp = static_cast<const float*>(qpop);
    const float* xp = static_cast<const float*>(xpop);
    const bool* v = static_cast<const bool*>(valid);
    __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (xp == nullptr)
      launch<true>(qq, xx, vec4, qp, xp, v, B, N, W, o, s);
    else
      launch<false>(qq, xx, vec4, qp, xp, v, B, N, W, o, s);
  }
  return (int)cudaGetLastError();
}
