// bq_hamming_block: exact hamming distances between packed sign words.
//   q [B, W] uint32, x [N, W] uint32 -> out [B, N] f32 bit differences.
//
// Replaces the TPU kernel weaviate_tpu/ops/pallas_kernels.py
// ``bq_hamming_block`` (pallas_call in ``_bq_tiled``, body ``_bq_kernel``):
// XOR + population count of a [B, W] x [TILE, W] block in VMEM, summed over
// the words.
//
// Bound on an H100 SXM: the kernel reads the words once (B*W + N*W words)
// and writes the [B, N] f32 matrix. At B = 256, N = 1,048,576, W = 24 that
// is 101 MB of words and a 1,074 MB output: 0.351 ms at 3.35 TB/s, bound by
// bytes (the B*N*W = 6.4e9 popcounts are integer work of the CUDA cores, at
// 16 per clock per SM about 1.7 ms: in practice the popcounts, not the
// bytes, set the pace of this design).
//
// Design: one thread per corpus row, THREADS rows and QB queries per CTA.
// The queries' words sit in shared memory (zero-padded to a multiple of 8,
// read as 16-byte broadcasts); each thread loads its row's words 8 at a
// time into registers, once for all QB queries (row_popcounts), and writes
// f32 with neighbouring threads on neighbouring rows, so every store of a
// warp is one 128-byte line. The query block runs fastest in the grid, so
// the CTAs that read the same rows run side by side and share them in L2.

#include "scan_reduce_common.cuh"

using namespace wtt_scan;

namespace {

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

}  // namespace

// C interface (ctypes). vec4: W % 4 == 0 and x 16-byte aligned. Returns the
// launch's cudaGetLastError().
extern "C" int wtt_bq_hamming_block(const void* q, const void* x, int vec4, int B, int N, int W,
                                    void* out, void* stream) {
  if (B > 0 && N > 0) {
    const int wp = padded_words(W);
    const int smem = QB * wp * (int)sizeof(uint32_t);
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(bq_hamming_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem);
    const int n_qblocks = (B + QB - 1) / QB;
    const long long blocks = (long long)((N + THREADS - 1) / THREADS) * n_qblocks;
    bq_hamming_block_kernel<<<(unsigned)blocks, THREADS, smem,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(x), vec4, B, N, W, wp,
        n_qblocks, static_cast<float*>(out));
  }
  return (int)cudaGetLastError();
}
