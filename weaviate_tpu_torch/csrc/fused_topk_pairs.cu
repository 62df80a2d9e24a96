// fused_topk_pairs: exact top-k over candidate pairs (vals [B, M] f32,
// ids [B, M] i32) -> ([B, k] f32 ascending, [B, k] i32), k <= 256.
//
// Replaces the TPU kernel weaviate_tpu/ops/pallas_kernels.py
// ``fused_topk_pairs`` (pallas_call in ``_fused_pairs_tiled``, body
// ``_fused_pairs_kernel``): a running top-k carry folded over 2048-wide
// tiles in VMEM. Entries >= MASKED_DISTANCE, and NaN, never surface; ties
// go to the earlier position; unfilled slots are (MASKED_DISTANCE, -1).
//
// Bound on an H100 SXM: one read of the values (4 B each), the k winners'
// ids and a [B, k] write; one compare per value. At the fused scan's merge
// shape [256, 12800], k = 100, that is 13.4 MB, ~4 us at 3.35 TB/s: bound
// by bytes.
//
// What held the first design back: one CTA of 8 warps per row, each warp
// folding its share of the row into a sorted list by serial insertion (a
// warp-wide count and a k/32-segment shift per insert), then warp 0 alone
// folding the other seven lists while seven warps idle. Its cost followed
// the data, and the scan's merge input (each slice's partial list written
// in ascending order) is its worst case: 0.3467 ms at [256, 12800], 3.31x
// torch.topk's 0.1047 ms (NVIDIA H100 80GB HBM3, 700 W; PERF.md).
//
// Design: a radix select: a fixed number of passes over the row with every
// thread busy, no serial insert and no single-warp tail, whatever the
// order of the data (only the histogram atomics contend more when equal
// digits cluster). One CTA of 256 threads per row, several per SM.
//  1. Each live value (< MASKED, so never NaN) gets an order-preserving
//     32-bit key of its float bits, -0.0 mapped to +0.0 so that both zeros
//     tie by position. The row's keys are staged in shared memory when the
//     row holds at most STAGE_MAX entries; a wider row is re-read from
//     global memory (L2) on each pass.
//  2. Four passes of 8-bit digit histograms (warp-aggregated shared
//     atomics) find T, the kk-th smallest key (kk = min(k, live)), the
//     count ``below`` of keys < T and the count of keys == T.
//  3. One pass keeps every key < T and the first kk - below entries with
//     key == T in position order (a block-wide ballot scan, taken only
//     when more keys equal T than are needed): the position tie rule is
//     decided before any sort.
//  4. The kk survivors are sorted by (key, position) with a bitonic
//     network over 256 slots in shared memory; their own f32 values and
//     their ids are written, then (MASKED, -1) tails.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float MASKED = 3.0e38f;  // MASKED_DISTANCE of ops/distances.py
constexpr int PT = 256;            // threads per CTA; also the digit bins and sort slots
constexpr int PWARPS = PT / 32;
constexpr int STAGE_MAX = 16384;   // widest row staged in shared memory (64 KB)
constexpr uint32_t DEAD = 0xffffffffu;

// order-preserving key of a live value; -0.0 and +0.0 share one key
__device__ __forceinline__ uint32_t key_of(float v) {
  uint32_t b = __float_as_uint(v);
  if (b == 0x80000000u) b = 0u;
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ uint32_t live_key(const float* row, int i) {
  const float v = row[i];
  return v < MASKED ? key_of(v) : DEAD;  // false for NaN: never counted
}

struct Shared {
  uint32_t hist[PT];
  unsigned long long sel[PT];
  int wsum[PWARPS];
  int n_sel, bin, excl, cnt;
};

// inclusive block scan of one int per thread; ``wsum`` is scratch
__device__ __forceinline__ int block_scan(int v, int* wsum, int* total) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += u;
  }
  if (lane == 31) wsum[warp] = v;
  __syncthreads();
  int before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < PWARPS; ++w) {
    before += (w < warp) ? wsum[w] : 0;
    all += wsum[w];
  }
  __syncthreads();  // wsum may be rewritten by the next scan
  *total = all;
  return v + before;
}

template <bool STAGED>
__global__ void __launch_bounds__(PT)
fused_topk_pairs_kernel(const float* __restrict__ vals, const int* __restrict__ ids, int M, int k,
                        float* __restrict__ out_d, int* __restrict__ out_i) {
  __shared__ Shared sh;
  extern __shared__ __align__(16) uint32_t keys[];  // STAGED: the row's keys
  const int b = blockIdx.x, t = threadIdx.x, lane = t % 32;
  const float* row = vals + (size_t)b * M;
  auto key_at = [&](int i) -> uint32_t { return STAGED ? keys[i] : live_key(row, i); };

  // 1. keys (staged) and the live count
  int live = 0;
  for (int i = t; i < M; i += PT) {
    const uint32_t key = live_key(row, i);
    if (STAGED) keys[i] = key;
    live += key != DEAD;
  }
  int n_live;
  block_scan(live, sh.wsum, &n_live);
  const int kk = min(k, n_live);

  // 2. the kk-th smallest key T, four 8-bit digits from the top
  uint32_t prefix = 0u, mask = 0u;
  int want = kk, below = 0, cnt_eq = 0;
  for (int shift = 24; kk > 0 && shift >= 0; shift -= 8) {
    sh.hist[t] = 0u;
    __syncthreads();
    for (int base = 0; base < M; base += PT) {
      const int i = base + t;
      const uint32_t key = i < M ? key_at(i) : DEAD;
      const bool in = key != DEAD && (key & mask) == prefix;
      const unsigned any = __ballot_sync(0xffffffffu, in);
      if (any) {
        const int bin = in ? (int)((key >> shift) & 255u) : -1;
        const unsigned peers = __match_any_sync(0xffffffffu, bin);
        if (in && lane == __ffs(peers) - 1) atomicAdd(&sh.hist[bin], (uint32_t)__popc(peers));
      }
    }
    __syncthreads();
    const int h = (int)sh.hist[t];
    int total;
    const int incl = block_scan(h, sh.wsum, &total);
    if (incl - h < want && want <= incl) {  // exactly one bin holds the want-th key
      sh.bin = t;
      sh.excl = incl - h;
      sh.cnt = h;
    }
    __syncthreads();
    prefix |= (uint32_t)sh.bin << shift;
    mask |= 255u << shift;
    below += sh.excl;
    want -= sh.excl;
    cnt_eq = sh.cnt;
    __syncthreads();  // sh.bin / excl / cnt are rewritten by the next pass
  }
  const uint32_t T = prefix;
  const int need_eq = want;  // entries with key == T to keep, 1 <= need_eq <= cnt_eq

  // 3. the kk survivors: every key < T, the first need_eq keys == T
  if (t == 0) sh.n_sel = 0;
  sh.sel[t] = ~0ull;
  __syncthreads();
  if (kk > 0) {
    if (cnt_eq == need_eq) {  // every tie is kept: no order needed
      for (int i = t; i < M; i += PT) {
        const uint32_t key = key_at(i);
        if (key <= T) sh.sel[atomicAdd(&sh.n_sel, 1)] = ((unsigned long long)key << 32) | (uint32_t)i;
      }
    } else {
      int taken = 0;  // ties kept so far, block-uniform
      for (int base = 0; base < M; base += PT) {
        const int i = base + t;
        const uint32_t key = i < M ? key_at(i) : DEAD;
        if (key < T) sh.sel[atomicAdd(&sh.n_sel, 1)] = ((unsigned long long)key << 32) | (uint32_t)i;
        if (taken >= need_eq) continue;  // uniform: every thread holds the same count
        const bool eq = key == T;
        int n_eq;
        const int rank = block_scan(eq ? 1 : 0, sh.wsum, &n_eq) - (eq ? 1 : 0);
        if (eq && taken + rank < need_eq)
          sh.sel[atomicAdd(&sh.n_sel, 1)] = ((unsigned long long)key << 32) | (uint32_t)i;
        taken += n_eq;
      }
    }
  }
  __syncthreads();

  // 4. sort the survivors by (key, position); unused slots hold ~0
  for (int size = 2; size <= PT; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const int p = t ^ stride;
      if (p > t) {
        const unsigned long long a = sh.sel[t], c = sh.sel[p];
        const bool up = (t & size) == 0;
        if ((a > c) == up) {
          sh.sel[t] = c;
          sh.sel[p] = a;
        }
      }
      __syncthreads();
    }
  }
  for (int i = t; i < k; i += PT) {
    float d = MASKED;
    int id = -1;
    if (i < kk) {
      const int pos = (int)(uint32_t)(sh.sel[i] & 0xffffffffull);
      d = row[pos];
      id = ids[(size_t)b * M + pos];
    }
    out_d[(size_t)b * k + i] = d;
    out_i[(size_t)b * k + i] = id;
  }
}

inline int staged_bytes(int M) { return M <= STAGE_MAX ? M * 4 : 0; }

}  // namespace

// C interface (ctypes). Returns the launch's cudaGetLastError().
extern "C" int wtt_fused_topk_pairs(const void* vals, const void* ids, int B, int M, int k,
                                    void* out_d, void* out_i, void* stream) {
  if (B > 0 && k > 0) {
    if (k > PT) return (int)cudaErrorInvalidValue;
    const float* v = static_cast<const float*>(vals);
    const int* id = static_cast<const int*>(ids);
    float* od = static_cast<float*>(out_d);
    int* oi = static_cast<int*>(out_i);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int smem = staged_bytes(M);
    if (M <= STAGE_MAX) {
      cudaFuncSetAttribute(fused_topk_pairs_kernel<true>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      fused_topk_pairs_kernel<true><<<B, PT, smem, s>>>(v, id, M, k, od, oi);
    } else {
      fused_topk_pairs_kernel<false><<<B, PT, 0, s>>>(v, id, M, k, od, oi);
    }
  }
  return (int)cudaGetLastError();
}

// CTAs of the kernel that fit on one SM for rows of M entries, and the
// dynamic shared memory each takes (written to *smem_bytes).
extern "C" int wtt_fused_topk_pairs_residency(int M, int* smem_bytes) {
  int blocks = 0;
  const int smem = staged_bytes(M);
  *smem_bytes = smem;
  if (M <= STAGE_MAX) {
    cudaFuncSetAttribute(fused_topk_pairs_kernel<true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fused_topk_pairs_kernel<true>, PT, smem);
  } else {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fused_topk_pairs_kernel<false>, PT, 0);
  }
  return blocks;
}
