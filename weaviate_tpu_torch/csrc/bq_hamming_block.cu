// bq_hamming_block: exact hamming distances between packed sign words.
//   qblk uint32, the query words in the tensor-core body's blocks
//   (ops/kernels.bq_query_blocks), q [B, W] uint32, x [N, W] uint32
//   -> out [B, N] f32 bit differences.
//
// Replaces the TPU kernel weaviate_tpu/ops/pallas_kernels.py
// ``bq_hamming_block`` (pallas_call in ``_bq_tiled``, body ``_bq_kernel``):
// XOR + population count of a [B, W] x [TILE, W] block in VMEM, summed over
// the words.
//
// Exactness. popc(q XOR x) = popc(q) + popc(x) - 2 popc(q AND x) per word,
// so the single-bit MMA's integer sums give the hamming distance in int32;
// every value is below 2^24, so its f32 conversion is exact and the output
// equals XOR + popcount (ops/kernels.bq_hamming_block_plain) bit for bit.
//
// Bound on an H100 SXM: the kernel reads the words once (B*W + N*W words)
// and writes the [B, N] f32 matrix. At B = 256, N = 1,048,576, W = 24 that
// is 101 MB of words and a 1,074 MB output: 0.351 ms at 3.35 TB/s, bound by
// the bytes (the single-bit MMAs' 2*B*N*32W operations take ~0.026 ms).
//
// What held the first design back (1.634 ms, 21.5% of that bound; NVIDIA
// H100 80GB HBM3, 700 W; PERF.md): XOR + __popc on the CUDA cores, B*N*W =
// 6.4e9 popcounts at 16 per clock per SM, ~1.7 ms whatever the tuning.
//
// Design: bq_mxu_block's single-bit tensor-core body (bq_block_tc.cuh), one
// body with another epilogue: popc(q) counted from the query words in the
// kernel, popc(x) from the all-ones columns of the same MMA, ham = popc(q) +
// popc(x) - 2 popc(q AND x) in int32, converted to f32 into a tile of
// 272-byte rows (64 rows + 4 of padding, no bank conflicts), and each
// query's 64 rows leave as one 256-byte run of 16-byte stores. The output is
// the bytes (twice bq_mxu_block's), so the stores are the design: the
// tile's stores are in flight while the next tile's MMAs run.
//
// The first design's body (one thread a row, QB queries a CTA, the query
// words in shared memory, XOR + __popc) stays for codes too wide for the
// tensor-core body's shared memory (W past ~100 words).

#include "bq_block_tc.cuh"

namespace {

using namespace wtt_scan;
using namespace wtt_bq_tc;

// -- the popcount body -------------------------------------------------------------

constexpr int QB = 32;  // queries per CTA

__global__ void __launch_bounds__(THREADS)
bq_hamming_block_kernel(const uint32_t* __restrict__ q, const uint32_t* __restrict__ x, int vec4,
                        int B, int N, int W, int wp, int n_qblocks, float* __restrict__ out) {
  extern __shared__ __align__(16) uint32_t sq[];  // [QB][wp] query words
  const int q0 = (int)(blockIdx.x % n_qblocks) * QB;
  const long long row = (long long)(blockIdx.x / n_qblocks) * THREADS + threadIdx.x;
  stage_query_words<QB>(sq, q, q0, B, W, wp, THREADS);
  __syncthreads();
  if (row >= N) return;
  int ham[QB];
#pragma unroll
  for (int i = 0; i < QB; ++i) ham[i] = 0;
  int unused = 0;
  row_popcounts<QB, false, false>(sq, wp, x, true, 0, vec4, row, N, W, ham, unused);
  const int nq = min(QB, B - q0);
#pragma unroll
  for (int i = 0; i < QB; ++i)
    if (i < nq) out[(size_t)(q0 + i) * N + row] = (float)ham[i];
}

void launch_popc(const uint32_t* q, const uint32_t* x, int vec4, int B, int N, int W, float* out,
                 cudaStream_t stream) {
  const int wp = padded_words(W);
  const int smem = QB * wp * (int)sizeof(uint32_t);
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(bq_hamming_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem);
  const int n_qblocks = (B + QB - 1) / QB;
  const long long blocks = (long long)((N + THREADS - 1) / THREADS) * n_qblocks;
  bq_hamming_block_kernel<<<(unsigned)blocks, THREADS, smem, stream>>>(q, x, vec4, B, N, W, wp,
                                                                       n_qblocks, out);
}

// -- the tensor-core body's epilogue ------------------------------------------

// popc(q) + popc(x) - 2 popc(q AND x), exact in int32 and in its f32 value
struct HammingEpilogue {
  using T = float;
  using P = int;
  static constexpr int OS = TILE + 4;  // f32 stride of a query's row in the output tile (272 B)
  __device__ static __forceinline__ T entry(int dot, int qp, int xp, float, bool) {
    return (float)(qp + xp - 2 * dot);
  }
};

}  // namespace

// C interface (ctypes). ``qblock`` picks the body: 0 the popcount body (32
// queries a CTA; ``qm`` unused), else the tensor-core body with qblock
// queries a CTA (8, 16, 32, 64 or 128), ``qm`` its blocked query words for
// n_qblocks * qblock queries. vec4: W % 4 == 0 and x 16-byte aligned;
// out16: N % 4 == 0 and out 16-byte aligned. Returns the launch's
// cudaGetLastError().
extern "C" int wtt_bq_hamming_block(const void* qm, const void* q, const void* x, int vec4, int B,
                                    int N, int W, int qblock, int n_qblocks, int out16, void* out,
                                    void* stream) {
  if (B <= 0 || N <= 0) return (int)cudaGetLastError();
  const uint32_t* qq = static_cast<const uint32_t*>(q);
  const uint32_t* xx = static_cast<const uint32_t*>(x);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (qblock == 0) {
    launch_popc(qq, xx, vec4, B, N, W, o, s);
    return (int)cudaGetLastError();
  }
  const TcOperands p{static_cast<const uint32_t*>(qm), qq, xx, nullptr, nullptr, nullptr};
  return run_tc<HammingEpilogue>(p, vec4, B, N, W, qblock, n_qblocks, out16, o, s);
}
