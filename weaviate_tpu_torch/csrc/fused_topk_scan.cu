// fused_topk_scan: masked distance scan + exact per-query top-k, with the
// [B, N] distance matrix never written to device memory.
//
// Replaces the TPU kernel weaviate_tpu/ops/pallas_kernels.py
// ``fused_topk_scan`` (pallas_call in ``_fused_topk_tiled``, body
// ``_fused_topk_kernel`` + ``_fold_tile_topk``). On the TPU the grid walks
// the corpus in order on one core and carries one running top-k in VMEM.
// Here CTAs run in parallel and in no order, so the corpus is cut into
// slices: CTA (query block, slice) scans its slice and writes a partial
// top-k [B, n_slices, k] in slice order; fused_topk_pairs.cu then merges
// the partials into [B, k]. Both select by (value, global row), so the
// merge keeps the reference's tie rule (lower row).
//
// Bound on an H100 SXM: the exact-FP32 product, 2 * B * N * d FLOP on the
// FFMA pipes (67 TFLOP/s): 403 GFLOP, 6.154 ms for B = 256 at 1,048,576 x
// 768, while the corpus read is 3.2 GB (0.96 ms at 3.35 TB/s) — bound by
// operations from B ~ 40 up, by bytes below (f32).
//
// What held the first design back (27.351 ms at B = 256, k = 100, merge
// included, against 11.246 ms for addmm + topk; NVIDIA H100 80GB HBM3,
// 700 W; PERF.md): (1) 129,280 B of shared memory at k = 100 (the GEMM
// double buffer, a parked 64 x 129 distance tile, 64 sorted lists of 128
// pairs), so one CTA of 8 warps per SM; (2) tile_common.cuh's 64 x 128
// tile with 4 x 8 outputs per thread, 12 LDS.128 for every 128 FFMA;
// (3) after every tile a block-wide fold (a ballot per 32 columns, serial
// inserts) with no FFMA issuing on the SM; (4) the CTAs that read one
// corpus slice launched 128 CTAs apart, so the corpus could come from HBM
// up to four times.
//
// Design:
//  - Product: ffma_tile.cuh's product_tile, shared with distance_block.cu:
//    a CTA of 128 threads computes 64 queries x 128 rows a tile (16 x 128
//    for drains of <= 32 queries), each thread 8 (or 2) x 8 outputs, K in
//    slices of 16 through a 3-stage (4 for the small tile) cp.async ring:
//    16 LDS.128 for every 256 FFMA. Each output is one fmaf chain over k =
//    0 .. d-1 from 0.0f, so every distance equals distance_block's bit for
//    bit (no TF32, no split-K, nothing that depends on B).
//  - Selection: after a tile's last slice its dot products are parked over
//    the ring, and each warp filters its own query rows. The metric, the
//    valid mask and the allow bit are applied, and a row's 128 values are
//    held to its tau (the k-th entry of its sorted list of k (value, row -
//    slice start as 16 bits) pairs in shared memory); only values below
//    tau go, in column order, to the row's queue of 48. Once a queue holds
//    more than 16 the warp merges it into the list: queue ranks by
//    shuffles, list ranks by binary search, every entry moved once, tau
//    tightened. After the first tiles of a slice almost nothing passes.
//  - Residency: 105,216 B of shared memory at k = 100 (114,432 at k = 128)
//    for f32, so two CTAs share an SM.
//  - Slices and launch order: scan_slices (ops/kernels.py) cuts about one
//    wave of (query block, slice) CTAs, in slices of up to 511 tiles: fewer,
//    longer slices let fewer values pass. The query block is the fastest
//    grid index, so the CTAs that read one slice run together and the
//    corpus comes from HBM about once, then from L2.
// Dead and disallowed rows never pass tau (their value is MASKED), so
// unfilled slots come out as (MASKED, -1).

#include "ffma_tile.cuh"

// 0 builds the product alone (tiles parked, nothing selected): the
// breakdown build of ``chip_smoke.py --topk-times``, never a serving one
#ifndef WTT_SCAN_SELECT
#define WTT_SCAN_SELECT 1
#endif

using namespace wtt;
using namespace wtt::ffma;

namespace {

constexpr int QC = 48;        // queue slots per query row
constexpr int FLUSH = QC - 32;  // a row's queue merges once it holds more (a chunk adds <= 32)
constexpr int DT = SBN + 1;   // row stride of the parked dot-product tile (floats)
constexpr int NIL = 0xffff;   // local key of an unfilled list entry
constexpr int WARPS = STH / 32;
constexpr int LIST_PER_LANE = 4;  // list entries per lane in a merge: k <= 128

__host__ __device__ constexpr int list_stride(int k) { return (k + 7) / 8 * 8; }

// the product's ring: K slices of 16, 3 stages (4 for the 16-query tile),
// small enough that two CTAs with their lists share an SM
template <typename T, int TM> using ScanRing = Ring<T, TM, 16, TM == 8 ? 3 : 4>;

// ring | list values | queue values | tau values | queue counts | tau keys |
// list keys (u16) | queue keys (u16)
template <typename T, int TM>
__host__ __device__ constexpr int scan_smem_bytes(int k) {
  return ScanRing<T, TM>::BYTES + 8 * TM * (list_stride(k) * 6 + QC * 6 + 12);
}

template <typename T, int TM>
constexpr bool ring_holds_tile() {
  return ScanRing<T, TM>::BYTES >= 8 * TM * DT * 4;
}
static_assert(ring_holds_tile<float, 8>() && ring_holds_tile<uint16_t, 8>() &&
              ring_holds_tile<float, 2>() && ring_holds_tile<uint16_t, 2>(),
              "the ring holds the parked tile");

__device__ __forceinline__ bool lex_less16(float a, int ak, float b, int bk) {
  return a < b || (a == b && ak < bk);
}

// entries of the sorted run (v[0..n), key[0..n)) before (x, xk)
__device__ __forceinline__ int rank_in(const float* v, const uint16_t* key, int n, float x, int xk) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (lex_less16(v[mid], key[mid], x, xk)) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// One query row's selection state in shared memory: its sorted list of k
// (value, key) entries, the queue of candidates below tau, tau itself (the
// list's k-th entry) and the queue's count.
struct Row {
  float* L;
  uint16_t* LK;
  float* Q;
  uint16_t* QK;
  float* td;
  int* tk;
  int* cnt;
};

// Merge the row's queue (1 .. QC entries, any order) into its list; the
// whole warp calls. Every entry moves once: a queue entry to (its rank in
// the queue) + (its rank in the list), list entry i to i + (queue entries
// before it). Keys are unique, so the ranks are exact. Leaves the queue
// empty and tau at the new k-th entry.
__device__ __forceinline__ void merge_queue(const Row& w, int k) {
  const int lane = threadIdx.x % 32;
  const int c = *w.cnt;
  float v[2];
  int key[2], rq[2] = {0, 0}, pos[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const bool has = lane + 32 * e < c;
    v[e] = has ? w.Q[lane + 32 * e] : MASKED;
    key[e] = has ? (int)w.QK[lane + 32 * e] : NIL;
  }
  // ranks among the queue; the empty slots hold (MASKED, NIL) and rank
  // after every entry
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (h * 32 >= c) break;  // warp-uniform
#pragma unroll
    for (int s = 0; s < 32; ++s) {
      const float o = __shfl_sync(0xffffffffu, v[h], s);
      const int ok = __shfl_sync(0xffffffffu, key[h], s);
#pragma unroll
      for (int e = 0; e < 2; ++e) rq[e] += lex_less16(o, ok, v[e], key[e]) ? 1 : 0;
    }
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) pos[e] = rq[e] + rank_in(w.L, w.LK, k, v[e], key[e]);
  __syncwarp();
#pragma unroll
  for (int e = 0; e < 2; ++e)
    if (lane + 32 * e < c) {  // the queue, sorted in place
      w.Q[rq[e]] = v[e];
      w.QK[rq[e]] = (uint16_t)key[e];
    }
  __syncwarp();
  float ed[LIST_PER_LANE];
  int ek[LIST_PER_LANE], ep[LIST_PER_LANE];
#pragma unroll
  for (int e = 0; e < LIST_PER_LANE; ++e) {
    const int i = lane + 32 * e;
    ep[e] = k;
    if (i < k) {
      ed[e] = w.L[i];
      ek[e] = w.LK[i];
      ep[e] = i + rank_in(w.Q, w.QK, c, ed[e], ek[e]);
    }
  }
  __syncwarp();
#pragma unroll
  for (int e = 0; e < LIST_PER_LANE; ++e)
    if (ep[e] < k && ep[e] != lane + 32 * e) {
      w.L[ep[e]] = ed[e];
      w.LK[ep[e]] = (uint16_t)ek[e];
    }
#pragma unroll
  for (int e = 0; e < 2; ++e)
    if (lane + 32 * e < c && pos[e] < k) {
      w.L[pos[e]] = v[e];
      w.LK[pos[e]] = (uint16_t)key[e];
    }
  __syncwarp();
  if (lane == 0) {
    *w.td = w.L[k - 1];
    *w.tk = w.LK[k - 1];
    *w.cnt = 0;
  }
  __syncwarp();
}

template <typename T, int METRIC, bool ASYNC, int TM>
__global__ void __launch_bounds__(STH, 2)
fused_topk_scan_kernel(const float* __restrict__ q, const float* __restrict__ qn,
                       const T* __restrict__ x, const float* __restrict__ xn,
                       const uint8_t* __restrict__ valid, const uint32_t* __restrict__ bits,
                       int words, int B, int N, int d, int k, int rows_per_slice,
                       int n_slices, float* __restrict__ out_d, int* __restrict__ out_i) {
  constexpr int SBM = 8 * TM;
  extern __shared__ __align__(16) unsigned char smem[];
  const int kc = list_stride(k);
  float* ld = reinterpret_cast<float*>(smem + ScanRing<T, TM>::BYTES);
  float* qd = ld + SBM * kc;
  float* td = qd + SBM * QC;
  int* qcnt = reinterpret_cast<int*>(td + SBM);
  int* tk = qcnt + SBM;
  uint16_t* lk = reinterpret_cast<uint16_t*>(tk + SBM);
  uint16_t* qk = lk + SBM * kc;
  auto row = [&](int r) {
    return Row{ld + r * kc, lk + r * kc, qd + r * QC, qk + r * QC, td + r, tk + r, qcnt + r};
  };

  const int qblocks = (B + SBM - 1) / SBM;
  const int m0 = (blockIdx.x % qblocks) * SBM;
  const int slice = blockIdx.x / qblocks;
  const int row_begin = slice * rows_per_slice;
  const int row_end = min(N, row_begin + rows_per_slice);
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int tx = t % 16, ty = t / 16;

  // warp w keeps the lists of rows w, w + 4, ...
  for (int r = warp; r < SBM; r += WARPS) {
    for (int i = lane; i < k; i += 32) {
      ld[r * kc + i] = MASKED;
      lk[r * kc + i] = (uint16_t)NIL;
    }
    if (lane == 0) {
      td[r] = MASKED;
      tk[r] = NIL;
      qcnt[r] = 0;
    }
  }

  float* dtile = reinterpret_cast<float*>(smem);  // a tile's dot products, parked over the ring
  for (int n0 = row_begin; n0 < row_end; n0 += SBN) {
    float acc[TM][TN];
    product_tile<T, ASYNC, ScanRing<T, TM>>(q, x, B, N, d, m0, n0, smem, acc);
    // park the dot products over the ring: every slice of the tile is read
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) dtile[(ty + 8 * i) * DT + tx + 16 * j] = acc[i][j];
    __syncthreads();

    // each warp filters its own rows, 32 columns at a time in column order
    const int cols = min(SBN, row_end - n0);
    for (int r = warp; WTT_SCAN_SELECT && r < SBM; r += WARPS) {
      const int m = m0 + r;
      if (m >= B) break;  // r only grows: uniform over the warp
      const Row w = row(r);
      const float qv = (METRIC == L2) ? qn[m] : 0.f;
      for (int c0 = 0; c0 < cols; c0 += 32) {
        const int c = c0 + lane, n = n0 + c, key = n - row_begin;
        float v = MASKED;
        if (c < cols && (valid == nullptr || valid[n]) &&
            (bits == nullptr || allow_bit(bits, words, m, n)))
          v = metric_of<METRIC>(dtile[r * DT + c], qv, (METRIC == L2) ? xn[n] : 0.f);
        const bool pass = v < MASKED && lex_less16(v, key, *w.td, *w.tk);
        const unsigned bal = __ballot_sync(0xffffffffu, pass);
        if (bal == 0u) continue;
        const int base = *w.cnt;
        if (pass) {
          const int slot = base + __popc(bal & ((1u << lane) - 1u));
          w.Q[slot] = v;
          w.QK[slot] = (uint16_t)key;
        }
        __syncwarp();
        if (lane == 0) *w.cnt = base + __popc(bal);
        __syncwarp();
        if (base + __popc(bal) > FLUSH) merge_queue(w, k);
      }
    }
    __syncthreads();  // the ring is staged again
  }

  // the last queues, then the partial top-k of this slice: [B, n_slices,
  // k], keys are global rows
  for (int r = warp; r < SBM; r += WARPS) {
    const int m = m0 + r;
    if (m >= B) break;
    const Row w = row(r);
    if (*w.cnt > 0) merge_queue(w, k);
    const size_t base = ((size_t)m * n_slices + slice) * k;
    for (int i = lane; i < k; i += 32) {
      const float v = w.L[i];
      const bool live = v < MASKED;
      out_d[base + i] = live ? v : MASKED;
      out_i[base + i] = live ? row_begin + (int)w.LK[i] : -1;
    }
  }
}

template <typename T, int METRIC, bool ASYNC, int TM>
static void launch(const float* q, const float* qn, const void* x, const float* xn,
                   const uint8_t* valid, const uint32_t* bits, int words, int B, int N, int d,
                   int k, int rows_per_slice, int n_slices, float* od, int* oi,
                   cudaStream_t stream) {
  const int smem = scan_smem_bytes<T, TM>(k);
  const int grid = ((B + 8 * TM - 1) / (8 * TM)) * n_slices;
  auto kern = fused_topk_scan_kernel<T, METRIC, ASYNC, TM>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  kern<<<grid, STH, smem, stream>>>(q, qn, static_cast<const T*>(x), xn, valid, bits, words, B,
                                    N, d, k, rows_per_slice, n_slices, od, oi);
}

template <typename T, int METRIC>
static void launch_tile(bool async_ok, const float* q, const float* qn, const void* x,
                        const float* xn, const uint8_t* valid, const uint32_t* bits, int words,
                        int B, int N, int d, int k, int rps, int ns, float* od, int* oi,
                        cudaStream_t s) {
  if (small_tile(B, async_ok))
    launch<T, METRIC, true, 2>(q, qn, x, xn, valid, bits, words, B, N, d, k, rps, ns, od, oi, s);
  else if (async_ok)
    launch<T, METRIC, true, 8>(q, qn, x, xn, valid, bits, words, B, N, d, k, rps, ns, od, oi, s);
  else
    launch<T, METRIC, false, 8>(q, qn, x, xn, valid, bits, words, B, N, d, k, rps, ns, od, oi, s);
}

template <typename T>
static void launch_metric(int metric, bool async_ok, const float* q, const float* qn,
                          const void* x, const float* xn, const uint8_t* valid,
                          const uint32_t* bits, int words, int B, int N, int d, int k, int rps,
                          int ns, float* od, int* oi, cudaStream_t s) {
  if (metric == L2)
    launch_tile<T, L2>(async_ok, q, qn, x, xn, valid, bits, words, B, N, d, k, rps, ns, od, oi, s);
  else if (metric == DOT)
    launch_tile<T, DOT>(async_ok, q, qn, x, xn, valid, bits, words, B, N, d, k, rps, ns, od, oi, s);
  else
    launch_tile<T, COSINE>(async_ok, q, qn, x, xn, valid, bits, words, B, N, d, k, rps, ns, od,
                           oi, s);
}

template <typename T, int TM>
static int residency(int k, int* smem_bytes) {
  int blocks = 0;
  auto kern = fused_topk_scan_kernel<T, COSINE, true, TM>;
  *smem_bytes = scan_smem_bytes<T, TM>(k);
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem_bytes);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, STH, *smem_bytes);
  return blocks;
}

}  // namespace

// C interface (ctypes). Writes the partial top-k of every slice:
// out_d [B, n_slices, k] f32 ascending per slice, out_i [B, n_slices, k]
// int32 global rows (-1 unfilled). rows_per_slice is a multiple of 128 and
// at most 65,535 (list keys are 16-bit offsets in the slice), n_slices =
// ceil(N / rows_per_slice), k <= 128. bits ([B, words] u32) and valid may
// be null. Returns the launch's cudaGetLastError().
extern "C" int wtt_fused_topk_scan(const void* q, const void* qn, const void* x, int x_bf16,
                                   const void* xn, const void* valid, const void* bits,
                                   int words, int B, int N, int d, int k, int metric,
                                   int rows_per_slice, int n_slices, void* out_d, void* out_i,
                                   int async_ok, void* stream) {
  if (B > 0 && N > 0 && k > 0) {
    if (k > LIST_PER_LANE * 32 || rows_per_slice > NIL || rows_per_slice % SBN != 0)
      return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float* qf = static_cast<const float*>(q);
    const float* qnf = static_cast<const float*>(qn);
    const float* xnf = static_cast<const float*>(xn);
    const uint8_t* v = static_cast<const uint8_t*>(valid);
    const uint32_t* b = static_cast<const uint32_t*>(bits);
    float* od = static_cast<float*>(out_d);
    int* oi = static_cast<int*>(out_i);
    if (x_bf16)
      launch_metric<uint16_t>(metric, async_ok != 0, qf, qnf, x, xnf, v, b, words, B, N, d, k,
                              rows_per_slice, n_slices, od, oi, s);
    else
      launch_metric<float>(metric, async_ok != 0, qf, qnf, x, xnf, v, b, words, B, N, d, k,
                           rows_per_slice, n_slices, od, oi, s);
  }
  return (int)cudaGetLastError();
}

// CTAs of the kernel (cosine, cp.async path, 64-query tile; ``B`` <= 32
// takes the 16-query tile) that fit on one SM at this k and storage type,
// and the dynamic shared memory each takes.
extern "C" int wtt_fused_topk_scan_residency(int k, int x_bf16, int B, int* smem_bytes) {
  const bool small = small_tile(B, true);
  if (x_bf16) return small ? residency<uint16_t, 2>(k, smem_bytes) : residency<uint16_t, 8>(k, smem_bytes);
  return small ? residency<float, 2>(k, smem_bytes) : residency<float, 8>(k, smem_bytes);
}
