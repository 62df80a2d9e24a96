// fused_topk_pairs: exact top-k over candidate pairs (vals [B, M] f32,
// ids [B, M] i32) -> ([B, k] f32 ascending, [B, k] i32).
//
// Replaces the TPU kernel weaviate_tpu/ops/pallas_kernels.py
// ``fused_topk_pairs`` (pallas_call in ``_fused_pairs_tiled``, body
// ``_fused_pairs_kernel``): a running top-k carry folded over 2048-wide
// tiles in VMEM. Entries >= MASKED_DISTANCE never surface; ties go to the
// earlier position; unfilled slots are (MASKED_DISTANCE, -1).
//
// Bound on an H100 SXM: the work is one read of the pairs (8 B each) and
// a write of [B, k]; the selection itself is a few compares per pair once
// the running k-th best is tight. At [256, 8192] that is 16.8 MB, ~5 us
// at 3.35 TB/s — bound by bytes.
//
// Design: one CTA of 8 warps per query row. Each warp folds a strided
// share of the row (32 pairs at a time, in position order) into its own
// sorted list of k (value, position) entries in shared memory, inserting
// only pairs below its current k-th best. Warp 0 then folds the other
// seven lists into its own, and the winners' positions gather their ids.
// Positions are the tie key, so the result does not depend on which warp
// saw which pair first.

#include "tile_common.cuh"

using namespace wtt;

constexpr int WARPS = THREADS / 32;

__global__ void __launch_bounds__(THREADS)
fused_topk_pairs_kernel(const float* __restrict__ vals, const int* __restrict__ ids, int M, int k,
                        int kc, float* __restrict__ out_d, int* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* lists_d = reinterpret_cast<float*>(smem);
  int* lists_k = reinterpret_cast<int*>(lists_d + WARPS * kc);
  const int b = blockIdx.x, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* ld = lists_d + warp * kc;
  int* lk = lists_k + warp * kc;
  list_init(ld, lk, kc);
  __syncwarp();
  const float* row = vals + (size_t)b * M;
  for (int p0 = warp * 32; p0 < M; p0 += WARPS * 32)
    list_fold(ld, lk, k, row + p0, nullptr, min(32, M - p0), p0);
  __syncthreads();
  if (warp != 0) return;
  for (int w = 1; w < WARPS; ++w)
    list_fold(ld, lk, k, lists_d + w * kc, lists_k + w * kc, k, 0);
  for (int i = lane; i < k; i += 32) {
    const float v = ld[i];
    const bool live = v < MASKED;
    out_d[(size_t)b * k + i] = live ? v : MASKED;
    out_i[(size_t)b * k + i] = live ? ids[(size_t)b * M + lk[i]] : -1;
  }
}

// C interface (ctypes). Returns the launch's cudaGetLastError().
extern "C" int wtt_fused_topk_pairs(const void* vals, const void* ids, int B, int M, int k,
                                    void* out_d, void* out_i, void* stream) {
  if (B > 0 && k > 0) {
    const int kc = ((k + 31) / 32) * 32;
    const int smem = WARPS * kc * 8;
    cudaFuncSetAttribute(fused_topk_pairs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem);
    fused_topk_pairs_kernel<<<B, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(vals), static_cast<const int*>(ids), M, k, kc,
        static_cast<float*>(out_d), static_cast<int*>(out_i));
  }
  return (int)cudaGetLastError();
}
