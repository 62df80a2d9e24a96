// fused_topk_scan: masked distance scan + exact per-query top-k, with the
// [B, N] distance matrix never written to device memory.
//
// Replaces the TPU kernel weaviate_tpu/ops/pallas_kernels.py
// ``fused_topk_scan`` (pallas_call in ``_fused_topk_tiled``, body
// ``_fused_topk_kernel`` + ``_fold_tile_topk``). On the TPU the grid walks
// the corpus in order on one core and carries one running top-k in VMEM.
// Here CTAs run in parallel and in no order, so the corpus is cut into
// slices: CTA (slice, query block) scans its slice and writes a partial
// top-k [B, n_slices, k] in slice order; fused_topk_pairs.cu then merges
// the partials into [B, k]. Slices are in row order and both folds break
// ties by key, so the merge keeps the reference's tie rule (lower row).
//
// Bound on an H100 SXM: the same exact-FP32 product as distance_block,
// 2 * B * N * d FLOP on the FFMA pipes (~67 TFLOP/s): 403 GFLOP (~6.0 ms)
// for B = 256 at 1M x 768, while the corpus read is 3.2 GB (~0.96 ms at
// 3.35 TB/s) — bound by operations. The fold adds work that depends on the
// data: after the first tiles of a slice the k-th best (tau) is tight and
// most tiles insert nothing.
//
// Design: each 64 x 128 distance tile comes from tile_common.cuh's GEMM
// body; its epilogue replaces dead rows (valid == 0) and rows the query's
// allow bitmask clears by MASKED, exactly as pallas_kernels.py does before
// its fold, and parks the tile in shared memory. Each warp then folds 8
// query rows: candidates below the row's tau are inserted, in column
// order, into a sorted per-query list of k entries kept in shared memory
// (tile_common.cuh list_fold). Dead and disallowed rows never enter, so
// unfilled slots come out as (MASKED, -1).

#include "tile_common.cuh"

using namespace wtt;

constexpr int DT_STRIDE = BN + 1;  // distance tile row stride (floats)

template <typename T>
__host__ __device__ constexpr int scan_smem_bytes(int kc) {
  return gemm_smem_bytes<T>() + BM * DT_STRIDE * 4 + BM * kc * 8;
}

template <typename T, int METRIC, bool ASYNC>
__global__ void __launch_bounds__(THREADS)
fused_topk_scan_kernel(const float* __restrict__ q, const float* __restrict__ qn,
                       const T* __restrict__ x, const float* __restrict__ xn,
                       const uint8_t* __restrict__ valid, const uint32_t* __restrict__ bits,
                       int words, int B, int N, int d, int k, int kc, int rows_per_slice,
                       float* __restrict__ out_d, int* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* dtile = reinterpret_cast<float*>(smem + gemm_smem_bytes<T>());
  float* lists_d = dtile + BM * DT_STRIDE;
  int* lists_k = reinterpret_cast<int*>(lists_d + BM * kc);

  const int slice = blockIdx.x, n_slices = gridDim.x;
  const int m0 = blockIdx.y * BM;
  const int row_begin = slice * rows_per_slice;
  const int row_end = min(N, row_begin + rows_per_slice);
  const int warp = threadIdx.x / 32;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  constexpr int ROWS_PER_WARP = BM / (THREADS / 32);

  for (int r = warp * ROWS_PER_WARP; r < (warp + 1) * ROWS_PER_WARP; ++r)
    list_init(lists_d + r * kc, lists_k + r * kc, kc);

  for (int n0 = row_begin; n0 < row_end; n0 += BN) {
    float acc[TM][TN];
    gemm_tile<T, ASYNC>(q, x, B, N, d, m0, n0, smem, acc);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = ty * TM + i, m = m0 + r;
      const float qv = (METRIC == L2 && m < B) ? qn[m] : 0.f;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int c = tx + 16 * j, n = n0 + c;
        float v = MASKED;
        if (m < B && n < row_end) {
          bool ok = (valid == nullptr) || valid[n];
          if (ok && bits != nullptr) ok = allow_bit(bits, words, m, n);
          if (ok) v = metric_of<METRIC>(acc[i][j], qv, (METRIC == L2) ? xn[n] : 0.f);
        }
        dtile[r * DT_STRIDE + c] = v;
      }
    }
    __syncthreads();
    for (int r = warp * ROWS_PER_WARP; r < (warp + 1) * ROWS_PER_WARP; ++r)
      if (m0 + r < B)
        list_fold(lists_d + r * kc, lists_k + r * kc, k, dtile + r * DT_STRIDE, nullptr,
                  min(BN, row_end - n0), n0);
    __syncthreads();  // the next tile's epilogue rewrites dtile
  }

  // partial top-k of this slice: [B, n_slices, k], keys are global rows
  const int lane = threadIdx.x % 32;
  for (int r = warp * ROWS_PER_WARP; r < (warp + 1) * ROWS_PER_WARP; ++r) {
    const int m = m0 + r;
    if (m >= B) continue;
    const size_t base = ((size_t)m * n_slices + slice) * k;
    for (int i = lane; i < k; i += 32) {
      const float v = lists_d[r * kc + i];
      const bool live = v < MASKED;
      out_d[base + i] = live ? v : MASKED;
      out_i[base + i] = live ? lists_k[r * kc + i] : -1;
    }
  }
}

template <typename T, int METRIC>
static void launch(const float* q, const float* qn, const void* x, const float* xn,
                   const uint8_t* valid, const uint32_t* bits, int words, int B, int N, int d,
                   int k, int rows_per_slice, int n_slices, float* od, int* oi, bool async_ok,
                   cudaStream_t stream) {
  const int kc = ((k + 31) / 32) * 32;
  const int smem = scan_smem_bytes<T>(kc);
  dim3 grid(n_slices, (B + BM - 1) / BM);
  const T* xt = static_cast<const T*>(x);
  if (async_ok) {
    auto kern = fused_topk_scan_kernel<T, METRIC, true>;
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    kern<<<grid, THREADS, smem, stream>>>(q, qn, xt, xn, valid, bits, words, B, N, d, k, kc,
                                          rows_per_slice, od, oi);
  } else {
    auto kern = fused_topk_scan_kernel<T, METRIC, false>;
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    kern<<<grid, THREADS, smem, stream>>>(q, qn, xt, xn, valid, bits, words, B, N, d, k, kc,
                                          rows_per_slice, od, oi);
  }
}

template <typename T>
static void launch_metric(int metric, const float* q, const float* qn, const void* x,
                          const float* xn, const uint8_t* valid, const uint32_t* bits, int words,
                          int B, int N, int d, int k, int rps, int ns, float* od, int* oi,
                          bool async_ok, cudaStream_t s) {
  if (metric == L2)
    launch<T, L2>(q, qn, x, xn, valid, bits, words, B, N, d, k, rps, ns, od, oi, async_ok, s);
  else if (metric == DOT)
    launch<T, DOT>(q, qn, x, xn, valid, bits, words, B, N, d, k, rps, ns, od, oi, async_ok, s);
  else
    launch<T, COSINE>(q, qn, x, xn, valid, bits, words, B, N, d, k, rps, ns, od, oi, async_ok, s);
}

// C interface (ctypes). Writes the partial top-k of every slice:
// out_d [B, n_slices, k] f32 ascending per slice, out_i [B, n_slices, k]
// int32 global rows (-1 unfilled). rows_per_slice is a multiple of 128
// and n_slices = ceil(N / rows_per_slice). bits ([B, words] u32) and valid
// may be null. Returns the launch's cudaGetLastError().
extern "C" int wtt_fused_topk_scan(const void* q, const void* qn, const void* x, int x_bf16,
                                   const void* xn, const void* valid, const void* bits,
                                   int words, int B, int N, int d, int k, int metric,
                                   int rows_per_slice, int n_slices, void* out_d, void* out_i,
                                   int async_ok, void* stream) {
  if (B > 0 && N > 0 && k > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float* qf = static_cast<const float*>(q);
    const float* qnf = static_cast<const float*>(qn);
    const float* xnf = static_cast<const float*>(xn);
    const uint8_t* v = static_cast<const uint8_t*>(valid);
    const uint32_t* b = static_cast<const uint32_t*>(bits);
    float* od = static_cast<float*>(out_d);
    int* oi = static_cast<int*>(out_i);
    if (x_bf16)
      launch_metric<uint16_t>(metric, qf, qnf, x, xnf, v, b, words, B, N, d, k, rows_per_slice,
                              n_slices, od, oi, async_ok != 0, s);
    else
      launch_metric<float>(metric, qf, qnf, x, xnf, v, b, words, B, N, d, k, rows_per_slice,
                           n_slices, od, oi, async_ok != 0, s);
  }
  return (int)cudaGetLastError();
}
