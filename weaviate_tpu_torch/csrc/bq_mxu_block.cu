// bq_mxu_block: masked hamming distances in the form of the TPU's MXU
// kernel, written as bf16.
//   qblk uint32, the query words in the tensor-core body's blocks
//   (ops/kernels.bq_query_blocks), q [B, W] uint32, x [N, W] uint32,
//   qpop [B] f32 (or null: popcount of the query), xpop [N] f32 (or null:
//   popcount of the row), valid [N] bool (or null)
//   -> out [B, N] bf16 = bf16_rn((qpop + xpop) - 2 * popc(q & x)
//                               + (1 - valid) * MASKED), the sum in f32.
//
// Replaces the TPU kernel weaviate_tpu/ops/pallas_kernels.py
// ``bq_mxu_block`` (pallas_call in ``_bq_mxu_tiled``, body
// ``_bq_mxu_kernel``): the corpus words are unpacked into 0/1 bf16 bit
// planes in VMEM and one MXU product with the queries' planes gives the
// bit-plane dot q.x, exact in its f32 accumulator; the epilogue is
// |q| + |x| - 2 q.x plus the mask, in f32, rounded to bf16.
//
// Exactness. The dot of 0/1 planes is popc(q AND x) summed over the words;
// the single-bit MMA below sums the same popcounts in int32, exactly. Every
// term of the epilogue is an integer below 2^24 (or the caller's cached f32
// popcounts, used as given) and the f32 operations run in the reference's
// order with its rounding (the _rn intrinsics, never contracted), so the
// result equals the plain version (ops/kernels.bq_mxu_block_plain) bit for
// bit. The words past W that a K step of 8 words covers are zero in the
// query operand, so whatever the row ring holds there adds 0 to an integer
// sum: no -0.0 can come from the padding (an integer converts to +0.0), and
// the f32 epilogue is the plain version's own.
//
// Bound on an H100 SXM: the reference's cost estimate counts 2*B*N*32W
// operations of the 0/1 product; Hopper's single-bit MMA covers 8 times the
// bits of an int8 MMA in the same time (csrc/probes/wgmma_b1.cu), 0.026 ms
// at B = 256, N = 1,048,576, W = 24, so the bytes bound it: 101 MB of words
// and the 537 MB bf16 output, about 0.19 ms at 3.35 TB/s.
//
// What held the first design back (1.764 ms, 11% of that bound; NVIDIA
// H100 80GB HBM3, 700 W; PERF.md): AND + __popc on the CUDA cores, B*N*W
// popcounts at 16 per clock per SM, ~1.5 ms whatever the tuning, and
// stores of 64 contiguous bytes per query and warp.
//
// Design: bq_scan_reduce's single-bit body with a block epilogue, shared
// with bq_hamming_block (bq_block_tc.cuh: the MMAs, the row ring, the
// transposed output tile and its stores). The epilogue here is the f32
// formula and the mask, rounded to bf16 into a tile of 144-byte rows; each
// query's 64 rows leave as one 128-byte run. The first design's body (AND +
// __popc, 32 queries a CTA) stays for codes too wide for the tensor-core
// body's shared memory (W past ~100 words).

#include <cuda_bf16.h>

#include "bq_block_tc.cuh"

namespace {

using namespace wtt_scan;
using namespace wtt_bq_tc;

// -- the popcount body ---------------------------------------------------------

constexpr int QB = 32;  // queries per CTA of the popcount body

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
  __syncthreads();
  const int t = (int)threadIdx.x;
  if (t < QB) {  // the caller's popcounts as given, else the words' (zero past W)
    int pop = 0;
    for (int w = 0; w < wp; ++w) pop += __popc(sq[t * wp + w]);
    sqpop[t] = (q0 + t >= B) ? 0.f : qpop != nullptr ? qpop[q0 + t] : (float)pop;
  }
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
void launch_popc(const uint32_t* q, const uint32_t* x, int vec4, const float* qpop,
                 const float* xpop, const bool* valid, int B, int N, int W,
                 __nv_bfloat16* out, cudaStream_t stream) {
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

// -- the tensor-core body's epilogue ------------------------------------------

// the reference's f32 order: (qpop + xpop) - 2 dot, then the mask, rounded
// to bf16; the popcounts are f32 (a caller's cached ones are used as given)
struct MxuEpilogue {
  using T = __nv_bfloat16;
  using P = float;
  static constexpr int OS = TILE + 8;  // bf16 stride of a query's row in the output tile (144 B)
  __device__ static __forceinline__ T entry(int dot, float qp, float xp, float dead, bool masked) {
    float d = __fsub_rn(__fadd_rn(qp, xp), __fmul_rn(2.f, (float)dot));
    if (masked) d = __fadd_rn(d, dead);
    return __float2bfloat16_rn(d);
  }
};

}  // namespace

// C interface (ctypes). qpop, xpop and valid may be null. ``qblock`` picks the
// body: 0 the popcount body (32 queries a CTA; ``qm`` unused), else the
// tensor-core body with qblock queries a CTA (8, 16, 32, 64 or 128), ``qm``
// its blocked query words for n_qblocks * qblock queries. vec4: W % 4 == 0
// and x 16-byte aligned; out16: N % 8 == 0 and out 16-byte aligned.
// Returns the launch's cudaGetLastError().
extern "C" int wtt_bq_mxu_block(const void* qm, const void* q, const void* x, int vec4,
                                const void* qpop, const void* xpop, const void* valid, int B,
                                int N, int W, int qblock, int n_qblocks, int out16, void* out,
                                void* stream) {
  if (B <= 0 || N <= 0) return (int)cudaGetLastError();
  const uint32_t* qq = static_cast<const uint32_t*>(q);
  const uint32_t* xx = static_cast<const uint32_t*>(x);
  const float* qp = static_cast<const float*>(qpop);
  const float* xp = static_cast<const float*>(xpop);
  const bool* v = static_cast<const bool*>(valid);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (qblock == 0) {
    if (xp == nullptr)
      launch_popc<true>(qq, xx, vec4, qp, xp, v, B, N, W, o, s);
    else
      launch_popc<false>(qq, xx, vec4, qp, xp, v, B, N, W, o, s);
    return (int)cudaGetLastError();
  }
  const TcOperands p{static_cast<const uint32_t*>(qm), qq, xx, qp, xp, v};
  return run_tc<MxuEpilogue>(p, vec4, B, N, W, qblock, n_qblocks, out16, o, s);
}
