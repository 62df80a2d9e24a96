// pq4_lut_block: exact ADC distances of 4-bit PQ codes through a bf16 LUT,
// written as bf16.
//   lut bf16, the [B, m, 16] table (bf16-rounded entries, zero past k) in
//   the kernel's blocks (ops/kernels.pq4_lut_block_table: [n_qblocks * 8]
//   [ks / 32][32 segments][2 halves][8 queries][8 codes], zero past B and
//   past m), codes [N, m] uint8, valid [N] bool (or null)
//   -> out [B, N] bf16 = bf16_rn(sum_s lut[b, s, codes[n, s]]
//                               + (1 - valid) * MASKED), the sum in f32.
//
// Replaces the TPU kernel weaviate_tpu/ops/pallas_kernels.py
// ``pq4_lut_block`` (pallas_call in ``_pq4_tiled``, body ``_pq4_kernel``):
// the code row is tiled 16 times into a one-hot [TILE, 16m] bf16 matrix in
// VMEM and one MXU product against the code-major bf16 LUT sums one entry
// per segment in f32. A code past 15 matches no lane and adds nothing.
//
// Exactness. The plain version (ops/kernels.pq4_lut_block_plain) adds the
// segments' entries in f32 in segment order s = 0..m-1 from +0.0, and so
// does this kernel; the mask add and the bf16 rounding follow.
//  - Each segment is one MMA issued with scale-d = 0: its result is one
//    product by 1.0 plus fifteen by 0.0, exactly lut[b, s, code] (a code
//    past 15 gives +0.0). The tensor cores never sum across segments: their
//    internal sum does not round like a sequential f32 sum. Each result is
//    added into a running f32 sum with __fadd_rn, in segment order.
//  - A -0.0 entry may come out of the MMA as +0.0 (-0.0 plus the zero
//    products). That changes no bit of the answer: the running sum starts
//    at +0.0, so it is never -0.0, and x + (+0.0) = x + (-0.0) for every x
//    that is not -0.0.
//  - An infinite or NaN entry makes the MMA's 0 * inf a NaN for every row
//    of that (query, segment) whose code does not pick it, as the
//    reference's one-hot product does; the plain version computes the
//    same (ops/kernels._pq4_segment_table).
//
// Bound on an H100 SXM: the reference's cost estimate counts 2*B*N*16m
// operations of the one-hot product; on the bf16 tensor cores (989
// TFLOP/s) that is 1.667 ms at B = 256, N = 1,048,576, m = 192, above the
// bytes (201 MB of codes, the 537 MB bf16 output: about 0.22 ms): bound by
// operations. The exact sum adds B*N*m FADDs, 1.54 ms at the FP32 rate
// (67 TFLOP/s counts an FMA as two), the same order.
//
// What held the first design back (20.891 ms, 8% of that bound; NVIDIA
// H100 80GB HBM3, 700 W; PERF.md): one shared-memory table load per (row,
// segment, query) on the CUDA cores, 16 queries a CTA (every code byte
// read 16 times at B = 256), and a query's whole table resident in shared
// memory, which refused m past 3,632 segments.
//
// Design: the tensor cores do the lookups, the CUDA cores the exact sum.
//  - wgmma.m64n64k16.f32.bf16.bf16: D [64 rows x 64 queries] = A [64 rows
//    x 16 codes] . B [16 codes x 64 queries]; one K step of 16 is one
//    segment (k = code). A is the one-hot of the rows' codes for that
//    segment, built in registers: lane (g, t) holds k = 2t, 2t + 1 and 8 +
//    2t, 9 + 2t, i.e. bf16 1.0 (0x3F80) shifted by 16 * (c & 1) when
//    c >> 1 == t (or t + 4), one shift by (c << 4) ^ (t << 5) that PTX
//    clamps to 0 for every other lane and for codes past 15.
//  - B is the 64 queries' table slice, read by the tensor cores from shared
//    memory through a descriptor (K-major, no swizzle: core matrices of 8
//    queries x 8 codes, 128 bytes apart along K, 8 KB apart along the
//    queries). The host lays the table out in that order, so a 32-segment
//    slice (64 KB) arrives as 8 bulk copies of 8 KB on an mbarrier.
//  - A CTA of two warpgroups serves 64 queries and a tile of 256 rows:
//    warpgroup w owns two 64-row tiles, one f32 accumulator of 64 x 64
//    each. A segment's two MMAs (one a tile) are one commit group into one
//    of two D register sets: while segment s's group runs, segment s - 1's
//    results are added (wait_group 1). After each wait the retired group's
//    registers are fenced: NVVM may move register work across
//    wgmma.wait_group (PERF.md). Every slice runs all 32
//    segments: an early exit inside the unrolled loop made ptxas serialize
//    the MMAs (its warning C7514).
//  - What bounds it (NVIDIA H100 80GB HBM3, 700 W; PERF.md):
//    4.6-4.7 ms at the main shape. Built without the FADDs the kernel takes
//    1.85 ms, without the MMAs 3.24: the two sides add up instead of
//    overlapping. Each lookup is written to a register twice (the MMA's
//    f32 result, then the FADD's sum), which would make the register
//    file's write rate the shared limit. A deeper pipeline, four
//    warpgroups, a shared-memory one-hot table and A from shared memory
//    all measured 4.6-5.9 ms.
//  - The table and the tile's codes stream through a 2-stage ring of
//    32-segment slices, continued across the CTA's tiles (the CTAs are
//    persistent, one an SM), so any m runs: there is no segment limit.
//  - Epilogue: mask add and bf16 rounding in registers, then the [256 rows
//    x 64 queries] tile is transposed through shared memory, so that each
//    query's rows go out as 16-byte stores.
//  - Rows past N read as zero codes and are never stored. Row-major codes
//    with m % 16 == 0 on 16-byte aligned rows take cp.async; others are
//    loaded byte by byte into the same ring.

#include <cuda_bf16.h>

#include "wgmma_common.cuh"

namespace {

using namespace wtt_wgmma;

constexpr float MASKED = 3.0e38f;  // MASKED_DISTANCE of ops/distances.py
constexpr int THREADS = 256;       // two warpgroups
constexpr int QB = 64;             // queries per CTA: the MMA's N
constexpr int SPP = 2;             // 64-row tiles per warpgroup
constexpr int ROWS = 2 * SPP * 64; // rows per CTA tile
constexpr int SEGS = 32;           // segments per K slice
constexpr int CS = SEGS + 16;      // smem row stride of the codes slice: 16-byte rows, distinct banks
constexpr int STAGES = 2;
constexpr int LUT_BYTES = QB * SEGS * 16 * 2;  // a slice of 64 queries' bf16 table
constexpr int STAGE_BYTES = LUT_BYTES + ROWS * CS;
constexpr int OS = ROWS + 8;       // bf16 stride of the output staging per query (16-byte rows)
constexpr int SMEM = STAGES * STAGE_BYTES + QB * OS * 2 + STAGES * 8;
constexpr int LBO = 128;           // bytes between core matrices along K
constexpr int SBO = SEGS * 2 * 128;  // bytes between core matrices along the queries
constexpr uint32_t ONE = 0x3F80u;  // bf16 1.0

// x << s, and 0 for s >= 32 (shl.b32 clamps its shift)
__device__ __forceinline__ uint32_t shl(uint32_t x, uint32_t s) {
  uint32_t r;
  asm("shl.b32 %0, %1, %2;\n" : "=r"(r) : "r"(x), "r"(s));
  return r;
}

struct Geo {
  int B, N, m, nk, n_qb, vec16;
  long long items;  // row tiles x query blocks
};

template <bool ASYNC>
__global__ void __launch_bounds__(THREADS, 1)
pq4_lut_block_kernel(const __nv_bfloat16* __restrict__ lut, const uint8_t* __restrict__ codes,
                     const bool* __restrict__ valid, Geo g, __nv_bfloat16* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int t = threadIdx.x, lane = t % 32;
  const int wg = t / 128, wr = (t / 32) % 4;  // warpgroup, warp in it
  const int gq = lane >> 2, tq = lane & 3;    // fragment row group, thread in group
  // this lane's rows in the CTA tile: tile j, half r -> row_of(j) + 8r
  auto row_of = [&](int j) { return (wg * SPP + j) * 64 + wr * 16 + gq; };

  const long long mine = g.items > blockIdx.x
                             ? (g.items - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const long long total = mine * g.nk;

  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_BYTES + QB * OS * 2);
  __nv_bfloat16* stile = reinterpret_cast<__nv_bfloat16*>(smem + STAGES * STAGE_BYTES);
  if (t == 0) {
    for (int i = 0; i < STAGES; ++i) mbar_init(bars + i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  auto load = [&](long long it) {
    const long long item = blockIdx.x + (it / g.nk) * gridDim.x;
    const int kt = (int)(it % g.nk), qb = (int)(item % g.n_qb);
    const long long r0 = item / g.n_qb * ROWS;
    unsigned char* stg = smem + (it % STAGES) * STAGE_BYTES;
    if (t == 0) {  // the 64 queries' table slice: 8 blocks of 8 KB, one per 8 queries
      uint64_t* bar = bars + it % STAGES;
      mbar_expect(bar, LUT_BYTES);
#pragma unroll
      for (int qg = 0; qg < QB / 8; ++qg)
        bulk_copy(stg + qg * SBO, lut + ((size_t)(qb * (QB / 8) + qg) * g.nk + kt) * (SBO / 2),
                  SBO, bar);
    }
    uint8_t* cs = stg + LUT_BYTES;
    const int seg0 = kt * SEGS;
    if (ASYNC) {  // m % 16 == 0, 16-byte aligned rows
      for (int e = t; e < ROWS * 2; e += THREADS) {
        const int rr = e >> 1, seg = seg0 + (e & 1) * 16;
        const long long row = r0 + rr;
        const bool ok = row < g.N && seg < g.m;
        cp_async16(cs + rr * CS + (e & 1) * 16,
                   ok ? (const void*)(codes + (size_t)row * g.m + seg) : (const void*)codes, ok);
      }
    } else {
      for (int e = t; e < ROWS * SEGS; e += THREADS) {
        const int rr = e / SEGS, sg = e % SEGS, seg = seg0 + sg;
        const long long row = r0 + rr;
        cs[rr * CS + sg] = (row < g.N && seg < g.m) ? __ldg(codes + (size_t)row * g.m + seg) : 0;
      }
    }
  };

  float acc[SPP][32];     // running sums: tile j, entry as wgmma_s8's d
  float d[2][SPP][32];    // the MMA results of two segments: one in flight, one retiring
  uint32_t a[2][SPP][4];  // their one-hot A
  // retire segment group p: its A may be rebuilt, its results join the
  // running sums in segment order
  auto retire = [&](int p) {
#pragma unroll
    for (int j = 0; j < SPP; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) fence_operand(a[p][j][i]);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        fence_operand(d[p][j][i]);
        acc[j][i] = __fadd_rn(acc[j][i], d[p][j][i]);
      }
    }
  };
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int j = 0; j < SPP; ++j)
#pragma unroll
      for (int i = 0; i < 32; ++i) d[p][j][i] = 0.f;

  if (total > 0) load(0);
  cp_async_commit();
  const uint32_t t32 = (uint32_t)tq << 5;
  uint32_t dead = 0;  // bit 2j + r: this lane's row of tile j, half r, is dead
  for (long long it = 0; it < total; ++it) {
    cp_async_wait<0>();                                  // slice it's codes have landed
    mbar_wait(bars + it % STAGES, (uint32_t)(it / STAGES) & 1);  // ... and its table
    __syncthreads();  // ... for every thread; slice it-1's buffer is free
    if (it + 1 < total) load(it + 1);
    cp_async_commit();

    const long long item = blockIdx.x + (it / g.nk) * gridDim.x;
    const int kt = (int)(it % g.nk);
    const long long r0 = item / g.n_qb * ROWS;
    if (kt == 0) {  // a tile starts: zero sums, its rows' valid flags
      dead = 0;
#pragma unroll
      for (int j = 0; j < SPP; ++j) {
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[j][i] = 0.f;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const long long row = r0 + row_of(j) + 8 * r;
          if (row < g.N && valid != nullptr && !valid[row]) dead |= 1u << (2 * j + r);
        }
      }
    }
    const unsigned char* stg = smem + (it % STAGES) * STAGE_BYTES;
    const unsigned char* cs = stg + LUT_BYTES;
    const uint64_t desc0 = desc_of((uint32_t)__cvta_generic_to_shared(stg), LBO, SBO);
    uint32_t cw[SPP][2];  // 4 segments of this lane's two rows in each tile
    // every slice runs its 32 segments: past m the table is zero and the
    // codes are 0, which adds +0.0 (the sums are never -0.0)
#pragma unroll
    for (int s = 0; s < SEGS; ++s) {
      if (s % 4 == 0) {
#pragma unroll
        for (int j = 0; j < SPP; ++j)
#pragma unroll
          for (int r = 0; r < 2; ++r)
            cw[j][r] = *reinterpret_cast<const uint32_t*>(cs + (row_of(j) + 8 * r) * CS + s);
      }
      const int p = s & 1;
#pragma unroll
      for (int j = 0; j < SPP; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          // code << 4 of segment s (byte s % 4 of cw), then the one-hot pairs
          const int b = s % 4;
          const uint32_t c4 = (b == 0 ? (cw[j][r] << 4) : (cw[j][r] >> (8 * b - 4))) & 0xFF0u;
          const uint32_t lo = c4 ^ t32;
          a[p][j][r] = shl(ONE, lo);
          a[p][j][2 + r] = shl(ONE, lo ^ 128u);
        }
      // both tiles' MMAs of segment s are one group; then segment s - 1's retire
      wgmma_fence();
      const uint64_t desc = desc0 + (uint64_t)(s * 2 * LBO / 16);
#pragma unroll
      for (int j = 0; j < SPP; ++j) wgmma_bf16(d[p][j], a[p][j], desc, 0);
      wgmma_commit();
      if (s > 0) {
        wgmma_wait<1>();
        retire(p ^ 1);
      }
    }
    wgmma_wait<0>();  // the slice's buffer may be restaged
    retire((SEGS - 1) & 1);

    if (kt == g.nk - 1) {  // the tile is summed: mask, round, transpose, store
      const int q0 = (int)(item % g.n_qb) * QB;
#pragma unroll
      for (int j = 0; j < SPP; ++j)
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int r = (i >> 1) & 1, q = (i >> 2) * 8 + 2 * tq + (i & 1);
          const float v = valid != nullptr
                              ? __fadd_rn(acc[j][i], (dead >> (2 * j + r)) & 1u ? MASKED : 0.f)
                              : acc[j][i];
          stile[q * OS + row_of(j) + 8 * r] = __float2bfloat16_rn(v);
        }
      __syncthreads();
      const int nq = min(QB, g.B - q0);
      const long long nr = min((long long)ROWS, (long long)g.N - r0);
      for (int e = t; e < QB * (ROWS / 8); e += THREADS) {
        const int q = e / (ROWS / 8), c8 = (e % (ROWS / 8)) * 8;
        if (q >= nq || c8 >= nr) continue;
        __nv_bfloat16* dst = out + (size_t)(q0 + q) * g.N + r0 + c8;
        const __nv_bfloat16* src = stile + q * OS + c8;
        if (g.vec16 && c8 + 8 <= nr) {
          *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
        } else {
          for (int k = 0; k < 8 && c8 + k < nr; ++k) dst[k] = src[k];
        }
      }
      // the staging is written again only after the next slice's barrier
    }
  }
  cp_async_wait<0>();
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 132;
  }
  return n;
}

template <bool ASYNC>
int launch(const __nv_bfloat16* lut, const uint8_t* codes, const bool* valid, const Geo& g,
           __nv_bfloat16* out, cudaStream_t s) {
  auto kern = pq4_lut_block_kernel<ASYNC>;
  // the attribute is set once per instantiation, not per launch
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (attr != cudaSuccess) return (int)attr;
  const long long blocks = g.items < sm_count() ? g.items : sm_count();
  kern<<<(unsigned)blocks, THREADS, SMEM, s>>>(lut, codes, valid, g, out);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface (ctypes). ``lut`` is the blocked bf16 table of ``ks``
// segments (a multiple of 32) for n_qblocks * 64 queries; valid may be
// null; vec16: m % 16 == 0 and the codes 16-byte aligned; out16: N % 8 ==
// 0 and out 16-byte aligned. Any m. Returns the launch's
// cudaGetLastError().
extern "C" int wtt_pq4_lut_block(const void* lut, int ks, const void* codes, int vec16,
                                 const void* valid, int B, int N, int m, int n_qblocks,
                                 int out16, void* out, void* stream) {
  if (B <= 0 || N <= 0) return (int)cudaGetLastError();
  if (ks % SEGS != 0 || ks < m || n_qblocks * QB < B) return (int)cudaErrorInvalidValue;
  Geo g;
  g.B = B; g.N = N; g.m = m; g.nk = ks / SEGS; g.n_qb = n_qblocks; g.vec16 = out16;
  g.items = ((long long)N + ROWS - 1) / ROWS * n_qblocks;
  const __nv_bfloat16* l = static_cast<const __nv_bfloat16*>(lut);
  const uint8_t* c = static_cast<const uint8_t*>(codes);
  const bool* v = static_cast<const bool*>(valid);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return vec16 ? launch<true>(l, c, v, g, o, s) : launch<false>(l, c, v, g, o, s);
}
