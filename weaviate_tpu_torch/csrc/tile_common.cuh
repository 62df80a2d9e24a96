// Shared device code for the distance and fused top-k kernels.
//
// One CTA of 256 threads computes a 64 x 128 tile of q . x^T in exact
// FP32 (FFMA, never TF32): q is [B, d] f32, x is [N, d] in the storage
// type T (float, or bf16 carried as its raw uint16 bits and widened to f32
// on read, which is exact). Each thread owns a 4 x 8 block of the tile:
// rows ty*4 + i, columns tx + 16*j (tx = t % 16, ty = t / 16), so the
// corpus reads of one quarter-warp hit 8 different shared-memory rows at
// an 80-byte stride and never collide on a bank.
//
// K is walked in slices of 16. Both slices of the double buffer live in
// shared memory. When every row starts on a 16-byte boundary (ASYNC) the
// slices are copied with cp.async (zero-filled past the ragged edges of
// B, N and d) while the previous slice is multiplied; otherwise each
// element is loaded and bounds-checked by hand. Nothing is padded on the
// host.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace wtt {

constexpr float MASKED = 3.0e38f;  // MASKED_DISTANCE of ops/distances.py
constexpr int BM = 64;             // queries per tile
constexpr int BN = 128;            // corpus rows per tile
constexpr int BK = 16;             // K slice
constexpr int THREADS = 256;
constexpr int TM = 4;              // rows per thread
constexpr int TN = 8;              // columns per thread
constexpr int QSK = BK + 4;        // f32 row stride of the q slice (80 B)

enum Metric { L2 = 0, DOT = 1, COSINE = 2 };

// shared-memory row stride (elements) of the corpus slice: 16 bytes of
// padding keeps every row 16-byte aligned for cp.async and float4 reads
template <typename T> struct Stride { static constexpr int XSK = BK + 16 / (int)sizeof(T); };

template <typename T>
__host__ __device__ constexpr int gemm_smem_bytes() {
  return 2 * BN * Stride<T>::XSK * (int)sizeof(T) + 2 * BM * QSK * (int)sizeof(float);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(uint16_t v) {
  return __uint_as_float(((uint32_t)v) << 16);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  int n = pred ? 16 : 0;  // 0 source bytes: the 16 destination bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait1() { asm volatile("cp.async.wait_group 1;\n" ::); }

// four consecutive K values of one shared row, widened to f32
__device__ __forceinline__ float4 load4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 load4(const uint16_t* p) {
  uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

// Stage K slice [k0, k0 + BK) of the q rows [m0, m0 + BM) and corpus rows
// [n0, n0 + BN) into one buffer. Rows past B / N and columns past d read 0.
template <typename T, bool ASYNC>
__device__ __forceinline__ void stage_slice(const float* __restrict__ q, const T* __restrict__ x,
                                            int B, int N, int d, int m0, int n0, int k0,
                                            float* qs, T* xs) {
  constexpr int XSK = Stride<T>::XSK;
  constexpr int EPC = 16 / (int)sizeof(T);  // elements per 16-byte chunk
  constexpr int XCPR = BK / EPC;            // corpus chunks per row
  const int t = threadIdx.x;
  // q: BM rows x 4 chunks of 4 floats = 256 chunks, one per thread
  {
    const int r = t / 4, c = t % 4;
    const int m = m0 + r, k = k0 + c * 4;
    float* dst = qs + r * QSK + c * 4;
    if (ASYNC) {
      const bool ok = (m < B) && (k < d);
      cp_async16(dst, ok ? (const void*)(q + (size_t)m * d + k) : (const void*)q, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dst[e] = (m < B && k + e < d) ? q[(size_t)m * d + k + e] : 0.f;
    }
  }
  // x: BN rows x XCPR chunks
#pragma unroll
  for (int id = t; id < BN * XCPR; id += THREADS) {
    const int r = id / XCPR, c = id % XCPR;
    const int n = n0 + r, k = k0 + c * EPC;
    T* dst = xs + r * XSK + c * EPC;
    if (ASYNC) {
      const bool ok = (n < N) && (k < d);
      cp_async16(dst, ok ? (const void*)(x + (size_t)n * d + k) : (const void*)x, ok);
    } else {
#pragma unroll
      for (int e = 0; e < EPC; ++e)
        dst[e] = (n < N && k + e < d) ? x[(size_t)n * d + k + e] : (T)0;
    }
  }
}

// acc[i][j] = q[m0 + ty*4 + i] . x[n0 + tx + 16*j] over all of d.
// ``smem`` holds the corpus double buffer followed by the q double buffer.
// Ends with a __syncthreads, so the caller may reuse shared memory.
template <typename T, bool ASYNC>
__device__ __forceinline__ void gemm_tile(const float* __restrict__ q, const T* __restrict__ x,
                                          int B, int N, int d, int m0, int n0,
                                          unsigned char* smem, float acc[TM][TN]) {
  constexpr int XSK = Stride<T>::XSK;
  T* xs = reinterpret_cast<T*>(smem);
  float* qs = reinterpret_cast<float*>(smem + 2 * BN * XSK * sizeof(T));
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  const int kt_n = (d + BK - 1) / BK;
  stage_slice<T, ASYNC>(q, x, B, N, d, m0, n0, 0, qs, xs);
  if (ASYNC) cp_async_commit();
  for (int kt = 0; kt < kt_n; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < kt_n)
      stage_slice<T, ASYNC>(q, x, B, N, d, m0, n0, (kt + 1) * BK, qs + (cur ^ 1) * BM * QSK,
                            xs + (cur ^ 1) * BN * XSK);
    if (ASYNC) {
      cp_async_commit();  // possibly empty group: keeps wait_group 1 exact
      cp_async_wait1();   // slice kt has landed
    }
    __syncthreads();
    const float* qb = qs + cur * BM * QSK;
    const T* xb = xs + cur * BN * XSK;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 4) {
      float4 a[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = load4(qb + (ty * TM + i) * QSK + kk);
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float4 b = load4(xb + (tx + 16 * j) * XSK + kk);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          acc[i][j] = fmaf(a[i].x, b.x, acc[i][j]);
          acc[i][j] = fmaf(a[i].y, b.y, acc[i][j]);
          acc[i][j] = fmaf(a[i].z, b.z, acc[i][j]);
          acc[i][j] = fmaf(a[i].w, b.w, acc[i][j]);
        }
      }
    }
    __syncthreads();  // the next iteration restages this buffer
  }
}

// distance epilogue of pallas_kernels._distance_kernel (before masking)
template <int METRIC>
__device__ __forceinline__ float metric_of(float dot, float qn, float xn) {
  if (METRIC == L2) return fmaxf(qn - 2.0f * dot + xn, 0.0f);
  if (METRIC == DOT) return -dot;
  return 1.0f - dot;
}

// per-query allow bit of column n in the block-strided packed layout of
// ops/kernels.pack_allow_bitmask: lane l of 512-column block b is bit
// l / 16 of word b * 16 + l % 16. Columns past the packed width are
// disallowed.
__device__ __forceinline__ bool allow_bit(const uint32_t* __restrict__ bits, int words, int m, int n) {
  const int blk = n >> 9, lane = n & 511;
  const int w = blk * 16 + (lane & 15);
  if (w >= words) return false;
  return (bits[(size_t)m * words + w] >> (lane >> 4)) & 1u;
}

// ---- exact top-k lists kept by one warp in shared memory ----------------
//
// A list holds k entries (value, key) sorted ascending by the pair, keys
// breaking ties (lower key first, as lax.top_k's lower index does).
// Unfilled entries are (MASKED, INT_MAX), so a real candidate (value <
// MASKED) always ranks before them and a value >= MASKED never enters.
// Entry i lives at index i; lane l handles indices l, l + 32, ...

__device__ __forceinline__ bool lex_less(float a, int ak, float b, int bk) {
  return a < b || (a == b && ak < bk);
}

__device__ __forceinline__ void list_init(float* ld, int* lk, int kc) {
  for (int i = threadIdx.x % 32; i < kc; i += 32) {
    ld[i] = MASKED;
    lk[i] = 0x7fffffff;
  }
}

// Insert (m, key), m < MASKED, if it ranks before the k-th entry; all 32
// lanes call with the same arguments. Returns with the list updated and
// visible to the whole warp.
__device__ __forceinline__ void list_insert(float* ld, int* lk, int k, float m, int key) {
  const int lane = threadIdx.x % 32;
  int cnt = 0;
  for (int i = lane; i < k; i += 32) cnt += lex_less(ld[i], lk[i], m, key) ? 1 : 0;
  const int pos = __reduce_add_sync(0xffffffffu, cnt);
  if (pos >= k) return;  // uniform across the warp
  // entry i of the new list: old[i] below pos, (m, key) at pos, old[i-1]
  // above. Segments of 32 are rewritten from the top down, so each one
  // reads only entries that no lane has overwritten yet.
  for (int base = ((k - 1) / 32) * 32; base >= (pos / 32) * 32; base -= 32) {
    const int i = base + lane;
    const bool w = (i < k) && (i >= pos);
    float nd = m;
    int nk = key;
    if (w && i > pos) {
      nd = ld[i - 1];
      nk = lk[i - 1];
    }
    __syncwarp();
    if (w) {
      ld[i] = nd;
      lk[i] = nk;
    }
    __syncwarp();
  }
}

// Fold ``count`` candidates vals[i] into the list, keyed keys[i] or, when
// ``keys`` is null, key0 + i. Candidates are visited in index order; each
// is compared with the current k-th entry at the moment it is visited,
// and values >= MASKED (dead, disallowed, unfilled) never enter.
__device__ __forceinline__ void list_fold(float* ld, int* lk, int k, const float* vals,
                                          const int* keys, int count, int key0) {
  const int lane = threadIdx.x % 32;
  for (int base = 0; base < count; base += 32) {
    const int i = base + lane;
    const float v = (i < count) ? vals[i] : MASKED;
    const int vk = (i < count && keys != nullptr) ? keys[i] : key0 + i;
    float td = ld[k - 1];
    int tk = lk[k - 1];
    unsigned bal = __ballot_sync(0xffffffffu, v < MASKED && lex_less(v, vk, td, tk));
    while (bal) {
      const int s = __ffs(bal) - 1;
      bal &= bal - 1;
      const float m = __shfl_sync(0xffffffffu, v, s);
      const int key = __shfl_sync(0xffffffffu, vk, s);
      if (lex_less(m, key, td, tk)) {
        list_insert(ld, lk, k, m, key);
        td = ld[k - 1];
        tk = lk[k - 1];
      }
    }
  }
}

}  // namespace wtt
