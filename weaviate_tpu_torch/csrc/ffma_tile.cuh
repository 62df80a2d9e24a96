// The exact-FP32 product tile shared by distance_block.cu and
// fused_topk_scan.cu: one CTA of 128 threads computes q[m0 : m0 + SBM] .
// x[n0 : n0 + 128]^T, q [B, d] f32 and x [N, d] in the storage type T (f32,
// or bf16 carried as its raw uint16 bits and widened to f32 on read, which
// is exact).
//
// Each thread owns TM x 8 outputs: rows ty + 8i, columns tx + 16j (tx =
// t % 16, ty = t / 16). TM is 8 (64-query tiles) or, for drains of <= 32
// queries, 2 (16-query tiles, where 64 would multiply mostly zero rows).
// K runs through a cp.async ring (Ring: the slice width and the stage count
// are each kernel's, sized to its shared memory): per K step of 4 a thread
// reads TM + 8 float4 from shared memory for 32 * TM FFMA.
//
// Every output is ONE fmaf chain over k = 0 .. d-1 started from +0.0f,
// with rows past B / N and columns past d read as 0 (the zero fill of the
// ragged edges). No TF32, no split-K, nothing that depends on B: so both
// kernels give the same bits for the same (query, row), whatever the tile
// or the batch, and the scan's distances equal distance_block's. When a
// row is not 16-byte aligned (ASYNC false) the slices are loaded by hand
// into the same ring.
#pragma once

#include "tile_common.cuh"

namespace wtt {
namespace ffma {

// corpus rows per thread: TN = 8 (tile_common.cuh)
constexpr int SBN = 16 * TN;  // corpus rows per tile
constexpr int STH = 128;      // threads

// A kernel's ring: TM query rows per thread (SBM = 8 TM queries a tile), K
// slices of KSL, NST stages. Row strides are padded by 16 bytes: 16-byte
// aligned rows for cp.async and float4 reads, and no bank conflicts.
template <typename T, int TM, int KSL, int NST>
struct Ring {
  static constexpr int SBM = 8 * TM;
  static constexpr int SBK = KSL;
  static constexpr int STAGES = NST;
  static constexpr int QS = KSL + 4;                   // f32 row stride of the q slice
  static constexpr int XS = KSL + 16 / (int)sizeof(T);  // row stride of the corpus slice
  static constexpr int STAGE = SBM * QS * 4 + SBN * XS * (int)sizeof(T);
  static constexpr int BYTES = NST * STAGE;
};

template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// Stage K slice [k0, k0 + SBK) of the q rows [m0, m0 + SBM) and corpus rows
// [n0, n0 + SBN). Rows past B / N and columns past d read 0.
template <typename T, bool ASYNC, typename R>
__device__ __forceinline__ void stage(const float* __restrict__ q, const T* __restrict__ x, int B,
                                      int N, int d, int m0, int n0, int k0, float* qs, T* xs) {
  constexpr int EPC = 16 / (int)sizeof(T);  // elements per 16-byte chunk
  constexpr int QCPR = R::SBK / 4;          // q chunks per row
  constexpr int XCPR = R::SBK / EPC;        // corpus chunks per row
  const int t = threadIdx.x;
#pragma unroll
  for (int id = t; id < R::SBM * QCPR; id += STH) {
    const int r = id / QCPR, c = id % QCPR;
    const int m = m0 + r, k = k0 + c * 4;
    float* dst = qs + r * R::QS + c * 4;
    if (ASYNC) {
      const bool ok = (m < B) && (k < d);
      cp_async16(dst, ok ? (const void*)(q + (size_t)m * d + k) : (const void*)q, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) dst[e] = (m < B && k + e < d) ? q[(size_t)m * d + k + e] : 0.f;
    }
  }
#pragma unroll
  for (int id = t; id < SBN * XCPR; id += STH) {
    const int r = id / XCPR, c = id % XCPR;
    const int n = n0 + r, k = k0 + c * EPC;
    T* dst = xs + r * R::XS + c * EPC;
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

// acc[i][j] = q[m0 + ty + 8i] . x[n0 + tx + 16j] over all of d, TM = R's.
// ``ring`` holds R::BYTES of shared memory. The chain runs over k = 0 ..
// d16 - 1, d16 = d rounded up to 16, whatever the slice: past d16 a wider
// slice skips its zero-filled steps, so every kernel's zero fill (and so
// its +0.0 / -0.0 result on an exact zero) is the same. Ends with every
// copy landed and a __syncthreads, so the caller may reuse the ring.
template <typename T, bool ASYNC, typename R>
__device__ __forceinline__ void product_tile(const float* __restrict__ q,
                                             const T* __restrict__ x, int B, int N, int d,
                                             int m0, int n0, unsigned char* ring,
                                             float (&acc)[R::SBM / 8][TN]) {
  constexpr int TM = R::SBM / 8;
  constexpr int STAGES = R::STAGES;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int kt_n = (d + R::SBK - 1) / R::SBK;
  const int d16 = (d + 15) / 16 * 16;
  auto load = [&](int kt) {
    unsigned char* st = ring + (kt % STAGES) * R::STAGE;
    stage<T, ASYNC, R>(q, x, B, N, d, m0, n0, kt * R::SBK, reinterpret_cast<float*>(st),
                       reinterpret_cast<T*>(st + R::SBM * R::QS * 4));
  };
#pragma unroll
  for (int kt = 0; kt < STAGES - 1; ++kt) {
    if (kt < kt_n) load(kt);
    if (ASYNC) cp_async_commit();
  }
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  for (int kt = 0; kt < kt_n; ++kt) {
    if (ASYNC) cp_async_wait<STAGES - 2>();  // slice kt has landed
    __syncthreads();  // ... for every thread, and slice kt-1's buffer is free
    if (kt + STAGES - 1 < kt_n) load(kt + STAGES - 1);
    if (ASYNC) cp_async_commit();
    const unsigned char* st = ring + (kt % STAGES) * R::STAGE;
    const float* qb = reinterpret_cast<const float*>(st);
    const T* xb = reinterpret_cast<const T*>(st + R::SBM * R::QS * 4);
    auto step = [&](int kk) {
      float4 a[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = load4(qb + (ty + 8 * i) * R::QS + kk);
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float4 b = load4(xb + (tx + 16 * j) * R::XS + kk);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          acc[i][j] = fmaf(a[i].x, b.x, acc[i][j]);
          acc[i][j] = fmaf(a[i].y, b.y, acc[i][j]);
          acc[i][j] = fmaf(a[i].z, b.z, acc[i][j]);
          acc[i][j] = fmaf(a[i].w, b.w, acc[i][j]);
        }
      }
    };
    if (R::SBK == 16 || (kt + 1) * R::SBK <= d16) {
#pragma unroll
      for (int kk = 0; kk < R::SBK; kk += 4) step(kk);
    } else {  // the last slice of a wider ring: the zero fill ends at d16
#pragma unroll
      for (int kk = 0; kk < 16; kk += 4) step(kk);
    }
  }
  if (ASYNC) cp_async_wait<0>();
  __syncthreads();
}

// the query tile of a launch: 16 rows for drains of <= 32 queries
// (cp.async path only), else 64
inline bool small_tile(int B, bool async_ok) { return async_ok && B <= 32; }

}  // namespace ffma
}  // namespace wtt
