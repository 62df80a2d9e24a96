// pq4_recon_block: ADC distances of 4-bit PQ codes through the reconstructed
// rows, written as bf16.
//   qblk bf16, the queries in the tensor-core body's blocks
//   (ops/kernels.pq4_recon_operands: [n_qblocks][8 query groups][d16 / 8
//   chunks][8 queries][8 dims], zero past B and past d), q [B, d] bf16,
//   qn [B] f32 (|q|^2, l2 only), codes [N, m] uint8, table bf16 [17][ts]
//   (table[c][k] = cent[k / ds, c, k % ds], zero for a code past k, row 16
//   and the columns past d zero; ts = d16 + 8), norms f32 [ms][17] (the bf16
//   centroids' squared norms, l2 only, zero past m and past k), valid [N]
//   bool (or null), d = m * ds, d16 = d rounded up to 16
//   -> out [B, N] bf16 of
//        l2-squared  qn - 2 q.x_hat + |x_hat|^2   (no clamp)
//        dot         -q.x_hat
//        cosine      1 - q.x_hat                  (q unit length upstream)
//      plus (1 - valid) * MASKED, in f32, rounded to nearest even;
//   x_hat[n, s*ds + j] = cent[s, codes[n, s], j], 0 for a code past 15.
//
// Replaces the TPU kernel weaviate_tpu/ops/pallas_kernels.py
// ``pq4_recon_block`` (pallas_call in ``_pq4_recon_tiled``, body
// ``_pq4_recon_kernel``): a one-hot [TILE, 16m] matrix times the
// block-diagonal bf16 centroids [16m, d] rebuilds x_hat in VMEM (exactly:
// one nonzero term per column), then |x_hat|^2 and the bf16 product q.x_hat,
// both summed in f32, and the metric epilogue.
//
// Arithmetic. The products of bf16 values are exact in f32; the sums run in
// another order than the plain version's (ops/kernels.pq4_recon_block_plain):
// the tensor cores sum q.x_hat over K steps of 16, and |x_hat|^2 is the sum
// over the row's m codes of the table ``norms`` (each entry the f32 sum of
// its centroid's ds squares). chip_smoke.py holds the two within 8e-3 *
// max(1, max|ref|), one bf16 ulp at the output's scale. The epilogue is the
// plain version's, in its order, with the _rn intrinsics.
//
// Bound on an H100 SXM: the distance product is 2*B*N*d operations, 4.12e11
// at B = 256, N = 1,048,576, d = 768: 0.417 ms on the bf16 tensor cores
// (989 TFLOP/s), above the bytes (201 MB of codes, the 537 MB bf16 output:
// about 0.22 ms). The reconstruction needs no multiply: it is a gather.
// Bound by operations.
//
// What held the first design back (25.300 ms, 1.6% of that bound; NVIDIA
// H100 80GB HBM3, 700 W; PERF.md): the product on the FFMA pipes (67
// TFLOP/s) and x_hat gathered into shared memory element by element, a code
// load and a centroid load from L1 for each.
//
// Design: the product on the tensor cores, x_hat built in registers.
//  - wgmma.m64n64k16.f32.bf16.bf16: D [64 rows x 64 queries] += A [64 rows
//    x 16 dims] . B [16 dims x 64 queries], f32. A comes from registers:
//    lane (g, t) of warp w holds rows 16w + g and 16w + g + 8 at MMA slots
//    2t, 2t + 1 and 8 + 2t, 9 + 2t of the K step, read from the dim-major
//    centroid table resident in shared memory at the row's code. On the
//    fast path (ds = 4, m a multiple of 64: the main shape) the slots hold
//    dims 4t .. 4t + 3, the whole centroid of the step's segment t, one
//    8-byte load, and the host orders each 16 query dims to match; else
//    they hold dims 2t, 2t + 1, 8 + 2t, 9 + 2t, a 4-byte load a pair (two
//    2-byte loads where a pair straddles two segments, ds odd). x_hat never
//    goes to shared or global memory.
//  - B, the 64 queries' bf16 values, resident in shared memory in K-major
//    core matrices (8 queries x 8 dims, 128 bytes apart along K, 16 * d16
//    bytes apart along the queries), read through a descriptor. The CTA
//    keeps its query block: the CTAs are persistent, query block fastest in
//    the grid, so the CTAs of one row tile read its codes side by side.
//  - A CTA of two warpgroups serves a tile of 256 rows, each warpgroup two
//    64-row MMA tiles. Each warpgroup streams its rows' codes through a
//    2-stage cp.async ring of its own in slices of 64 segments (4 * ds K
//    steps, so no K step straddles two slices) and waits on a barrier of
//    its own, so that one warpgroup's epilogue overlaps the other's MMAs.
//  - What bounds it (NVIDIA H100 80GB HBM3, 700 W; PERF.md, from the
//    breakdown builds of chip_smoke.py --block-times): the MMAs alone and
//    the A build alone each take most of the whole, and they overlap only
//    in part: both read shared memory, B (2 KB an MMA at N = 64) and the
//    table gathers, whose random codes meet in banks. N stays 64: 64
//    queries of d = 768 already take 96 KB of it. A first cut
//    with a runtime K loop and branches around the warpgroup instructions
//    spent more time on that loop than on its loads and MMAs.
//  - The fast path runs each slice's 16 K steps fully unrolled in blocks of
//    four, one fence and one commit group a block (8 MMAs, as CUTLASS's
//    register-A mainloops group a k-block), A of the next block built into
//    the other of two register sets named at compile time while the block
//    runs. The retired A registers are fenced after the wait: NVVM may
//    move register work across wgmma.wait_group (PERF.md). Loops over K
//    steps have no early exit: a break in an unrolled MMA loop made ptxas
//    serialize the MMAs.
//  - |x_hat|^2 (l2 only): each lane adds the norm table at a quarter of the
//    row's segments (on the fast path its own segment of each K step,
//    inside the build), then the four lanes of the row add theirs.
//  - Epilogue: the metric and the mask on the f32 accumulators, bf16
//    rounding, the [128 rows x 64 queries] tile of a warpgroup transposed
//    through shared memory, each query's rows out as 16-byte stores.
//  - d not a multiple of 16 reads zeros past d in both operands; rows past
//    N read zero codes and are never stored; codes past 15 read the zero
//    row 16 of the table.
//  - The first design's FFMA body stays for shapes whose resident queries
//    and table exceed shared memory (d past ~900).

#include <cuda_bf16.h>

#include "tile_common.cuh"
#include "wgmma_common.cuh"

// 1 builds the fast path's MMAs alone (A not built, no code or table
// read), 2 its A build alone (no MMA issued): the breakdown builds of
// ``chip_smoke.py --block-times``, never a serving one
#ifndef WTT_RECON_PART
#define WTT_RECON_PART 0
#endif

namespace {

using namespace wtt_wgmma;  // tile_common.cuh has cp.async helpers of the same names
using wtt::BK;
using wtt::BM;
using wtt::BN;
using wtt::COSINE;
using wtt::DOT;
using wtt::L2;
using wtt::load4;
using wtt::MASKED;
using wtt::THREADS;
using wtt::TM;
using wtt::TN;

// -- the tensor-core body ------------------------------------------------------

constexpr int TC_THREADS = 256;         // two warpgroups
constexpr int QB = 64;                  // queries per CTA: the MMA's N
constexpr int SPP = 2;                  // 64-row tiles per warpgroup
constexpr int ROWS = 2 * SPP * 64;      // rows per CTA tile
constexpr int SC = 64;                  // segments per code slice
constexpr int CS = SC + 16;             // smem row stride of a code slice (distinct banks)
constexpr int STAGES = 2;
constexpr int WG_ROWS = SPP * 64;       // rows of a warpgroup
constexpr int WG_STAGE = WG_ROWS * CS;  // a warpgroup's code slice
constexpr int STAGE_BYTES = ROWS * CS;
constexpr int OS = SPP * 64 + 8;        // bf16 stride of a query's rows in the output tile
constexpr int SMEM_MAX = 232448;        // dynamic shared memory a block can use

// resident queries, table and norm table, the code ring, the two output
// tiles, |q|^2, the mbarrier (ops/kernels.pq4_recon_smem computes the same)
__host__ inline int tc_smem(int d16, int ts, int norm_bytes) {
  return QB * d16 * 2 + 17 * ts * 2 + norm_bytes + STAGES * STAGE_BYTES + 2 * QB * OS * 2 +
         QB * 4 + 16;
}

struct TcGeo {
  int B, N, m, ds, d16, ts, nks, nsl, n_qb, cpq, vec16, out16, metric, norm_bytes, n_rt;
};

// the fast body's shapes (ops/kernels.pq4_recon_fast decides the same)
__host__ inline bool recon_fast(int m, int ds) { return ds == 4 && m % 64 == 0; }

// x_hat of one row at dims k, k + 1 (k even) as a bf16 pair: ``cs`` the
// row's codes of this slice, ``kl`` = k - the slice's first dim
__device__ __forceinline__ uint32_t xhat_pair(const uint8_t* cs, const uint16_t* tab, int ts,
                                              int k, int kl, int ds) {
  const uint32_t c0 = min((uint32_t)cs[kl / ds], 16u);
  if (ds % 2 == 0) return *reinterpret_cast<const uint32_t*>(tab + c0 * ts + k);
  const uint32_t c1 = min((uint32_t)cs[(kl + 1) / ds], 16u);
  return (uint32_t)tab[c0 * ts + k] | ((uint32_t)tab[c1 * ts + k + 1] << 16);
}

// FAST: ds = 4 and d16 a multiple of 256, so that every slice holds 16 K
// steps and lane t of a K step takes all four dims of segment t of the
// step's four: its A registers are one 8-byte load of that centroid, and
// the host permutes each 16 query dims to match (pq4_recon_query_blocks)
template <bool FAST, bool NORMS>
__global__ void __launch_bounds__(TC_THREADS, 1)
pq4_recon_tc_kernel(const __nv_bfloat16* __restrict__ qblk, const float* __restrict__ qn,
                    const uint8_t* __restrict__ codes, const __nv_bfloat16* __restrict__ table,
                    const float* __restrict__ norms, const bool* __restrict__ valid, TcGeo g,
                    __nv_bfloat16* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int qbytes = QB * g.d16 * 2, tbytes = 17 * g.ts * 2;
  const uint16_t* stab = reinterpret_cast<const uint16_t*>(smem + qbytes);
  const float* snorm = reinterpret_cast<const float*>(smem + qbytes + tbytes);
  unsigned char* ring = smem + qbytes + tbytes + g.norm_bytes;
  __nv_bfloat16* stile_all = reinterpret_cast<__nv_bfloat16*>(ring + STAGES * STAGE_BYTES);
  float* sqn = reinterpret_cast<float*>(stile_all + 2 * QB * OS);
  uint64_t* bar = reinterpret_cast<uint64_t*>(sqn + QB);

  const int t = threadIdx.x, lane = t & 31;
  const int wg = t >> 7, wr = (t >> 5) & 3;  // warpgroup, warp in it
  const int gq = lane >> 2, tq = lane & 3;
  // this lane's rows in the CTA tile: MMA tile j, half r -> row_of(j) + 8r,
  // in its warpgroup's code slice lrow(j) + 8r
  auto lrow = [&](int j) { return j * 64 + wr * 16 + gq; };
  auto row_of = [&](int j) { return wg * WG_ROWS + lrow(j); };
  // each warpgroup streams its own rows' codes and waits on its own
  // barrier, so that one warpgroup's epilogue overlaps the other's MMAs
  unsigned char* wring = ring + wg * STAGES * WG_STAGE;
  const int tw = t & 127;
  __nv_bfloat16* stile = stile_all + wg * QB * OS;  // [QB][OS]: query-major rows

  const int qb = (int)(blockIdx.x % g.n_qb);
  const int k0 = (int)(blockIdx.x / g.n_qb);
  const int q0 = qb * QB;
  const int mine = g.n_rt > k0 ? (g.n_rt - 1 - k0) / g.cpq + 1 : 0;
  const int total = mine * g.nsl;

  if (t == 0) {
    mbar_init(bar);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = t; i < QB; i += TC_THREADS)
    sqn[i] = (g.metric == L2 && q0 + i < g.B) ? qn[q0 + i] : 0.f;
  __syncthreads();
  if (t == 0) {  // the query block, the table and the norms stay for the CTA's life
    mbar_expect(bar, qbytes + tbytes + g.norm_bytes);
    const int group = 16 * g.d16;  // 8 queries' bytes
    for (int i = 0; i < QB / 8; ++i)
      bulk_copy(smem + i * group,
                reinterpret_cast<const unsigned char*>(qblk) + (size_t)qb * qbytes +
                    (size_t)i * group, group, bar);
    bulk_copy(smem + qbytes, table, tbytes, bar);
    if (g.norm_bytes) bulk_copy(smem + qbytes + tbytes, norms, g.norm_bytes, bar);
  }

  // slice it of this warpgroup: codes of its 128 rows of the tile,
  // segments 64c .. 64c + 63
  auto load = [&](int it) {
    const long long r0 = (long long)(k0 + (it / g.nsl) * g.cpq) * ROWS + wg * WG_ROWS;
    const int seg0 = (it % g.nsl) * SC;
    uint8_t* cs = wring + (it % STAGES) * WG_STAGE;
    if (g.vec16) {  // m % 16 == 0, 16-byte aligned rows
      for (int e = tw; e < WG_ROWS * (SC / 16); e += 128) {
        const int rr = e >> 2, seg = seg0 + (e & 3) * 16;
        const long long row = r0 + rr;
        const bool ok = row < g.N && seg < g.m;
        cp_async16(cs + rr * CS + (e & 3) * 16,
                   ok ? (const void*)(codes + (size_t)row * g.m + seg) : (const void*)codes, ok);
      }
    } else {
      for (int e = tw; e < WG_ROWS * SC; e += 128) {
        const int rr = e / SC, sg = e % SC, seg = seg0 + sg;
        const long long row = r0 + rr;
        cs[rr * CS + sg] = (row < g.N && seg < g.m) ? __ldg(codes + (size_t)row * g.m + seg) : 0;
      }
    }
  };

  float acc[SPP][32];  // entry i: row_of(j) + 8((i/2)%2), query 8(i/4) + 2t + i%2
  float xn[SPP][2];    // |x_hat|^2 of this lane's rows (l2)
  float dead[SPP][2];  // MASKED for this lane's dead rows of the tile
  const uint32_t q_s = (uint32_t)__cvta_generic_to_shared(smem);

  // both MMA tiles of one K step are one commit group
  auto issue = [&](int kk, uint32_t (&ab)[SPP][4]) {
    wgmma_fence();
    const uint64_t desc = desc_of(q_s + kk * 256, 128, 16 * g.d16);
#pragma unroll
    for (int j = 0; j < SPP; ++j) wgmma_bf16(acc[j], ab[j], desc, 1);
    wgmma_commit();
  };
  // a retired group's A may be rebuilt: fence it after the wait
  auto retire = [&](uint32_t (&ab)[SPP][4]) {
#pragma unroll
    for (int j = 0; j < SPP; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) fence_operand(ab[j][i]);
  };

  if (total > 0) load(0);
  cp_async_commit();
  mbar_wait(bar, 0);
  for (int it = 0; it < total; ++it) {
    cp_async_wait<0>();  // slice it's codes have landed ...
    // ... for the warpgroup; its slice it-1 buffer is free
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    if (it + 1 < total) load(it + 1);
    cp_async_commit();

    const int c = it % g.nsl;
    const long long r0 = (long long)(k0 + (it / g.nsl) * g.cpq) * ROWS;
    const uint8_t* cs = wring + (it % STAGES) * WG_STAGE;
    if (c == 0) {
#pragma unroll
      for (int j = 0; j < SPP; ++j) {
        xn[j][0] = xn[j][1] = 0.f;
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[j][i] = 0.f;
      }
    }
    if (c == g.nsl - 1) {  // the epilogue's mask, read ahead of the slice's MMAs
#pragma unroll
      for (int j = 0; j < SPP; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const long long row = r0 + row_of(j) + 8 * r;
          dead[j][r] = (valid != nullptr && row < g.N && !valid[row]) ? MASKED : 0.f;
        }
    }
    const int seg0 = c * SC;
    if (FAST) {
      // 16 K steps, unrolled, in 4 blocks of 4: one fence and one commit
      // group a block (8 MMAs). While block b runs, block b + 1's A is built
      // (one 16-byte code load a row, then a centroid a step and row) into
      // the other of two register sets, after the wait that retires b - 1
      const int kk0 = c * 16;
      uint32_t a[2][4][SPP][4];  // [set][step of the block][tile][register]
      auto build = [&](int blk, uint32_t (&ab)[4][SPP][4]) {
#pragma unroll
        for (int j = 0; j < SPP; ++j)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            if (WTT_RECON_PART == 1) {
#pragma unroll
              for (int s = 0; s < 4; ++s) ab[s][j][r] = ab[s][j][2 + r] = 0x3F803F80u;
              continue;
            }
            // the codes of the block's 16 segments, byte 4s + t: step s, lane t
            const uint4 cv =
                *reinterpret_cast<const uint4*>(cs + (lrow(j) + 8 * r) * CS + 16 * blk);
#pragma unroll
            for (int s = 0; s < 4; ++s) {
              const uint32_t cw = s == 0 ? cv.x : s == 1 ? cv.y : s == 2 ? cv.z : cv.w;
              // lane t: segment 4(kk0 + 4blk + s) + t, the centroid's dims 0, 1 and 2, 3
              const uint32_t code = min((cw >> (8 * tq)) & 0xFFu, 16u);
              const uint2 v = *reinterpret_cast<const uint2*>(
                  stab + code * g.ts + (kk0 + 4 * blk + s) * 16 + 4 * tq);
              ab[s][j][r] = v.x;
              ab[s][j][2 + r] = v.y;
              if (NORMS)
                xn[j][r] = __fadd_rn(xn[j][r],
                                     snorm[(seg0 + 16 * blk + 4 * s + tq) * 17 + code]);
            }
          }
      };
      auto issue4 = [&](int blk, uint32_t (&ab)[4][SPP][4]) {
        wgmma_fence();
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const uint64_t desc = desc_of(q_s + (kk0 + 4 * blk + s) * 256, 128, 16 * g.d16);
#pragma unroll
          for (int j = 0; j < SPP; ++j) {
            if (WTT_RECON_PART == 2)  // keep the build's loads live
              acc[j][s] += __uint_as_float(ab[s][j][0] ^ ab[s][j][1] ^ ab[s][j][2] ^ ab[s][j][3]);
            else
              wgmma_bf16(acc[j], ab[s][j], desc, 1);
          }
        }
        wgmma_commit();
      };
      auto retire4 = [&](uint32_t (&ab)[4][SPP][4]) {
#pragma unroll
        for (int s = 0; s < 4; ++s) retire(ab[s]);
      };
      build(0, a[0]);
#pragma unroll
      for (int blk = 0; blk < 4; ++blk) {
        issue4(blk, a[blk % 2]);
        if (blk > 0) {
          wgmma_wait<1>();  // block blk - 1 has retired
          retire4(a[(blk + 1) % 2]);
        }
        if (blk + 1 < 4) build(blk + 1, a[(blk + 1) % 2]);
      }
      wgmma_wait<0>();  // the slice's last group
      retire4(a[0]);
      retire4(a[1]);
    } else {
      // 4 * ds K steps, fewer at the end of d16, two a turn, so that each A
      // buffer is named at compile time; the next step's loads are issued
      // before the wait for the groups in flight, into registers of their own
      const int kk0 = c * 4 * g.ds, kk1 = min(g.nks, kk0 + 4 * g.ds);
      uint32_t a0[SPP][4] = {}, a1[SPP][4] = {}, ta[SPP][4];
      auto build = [&](int kk) {
        const int k = kk * 16 + 2 * tq, kl = k - kk0 * 16;
#pragma unroll
        for (int j = 0; j < SPP; ++j)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const uint8_t* crow = cs + (lrow(j) + 8 * r) * CS;
            ta[j][r] = xhat_pair(crow, stab, g.ts, k, kl, g.ds);
            ta[j][2 + r] = xhat_pair(crow, stab, g.ts, k + 8, kl + 8, g.ds);
          }
      };
      auto take = [&](uint32_t (&ab)[SPP][4]) {
#pragma unroll
        for (int j = 0; j < SPP; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) ab[j][i] = ta[j][i];
      };
      build(kk0);
      take(a0);
      for (int kk = kk0; kk < kk1; kk += 2) {
        issue(kk, a0);
        const bool odd = kk + 1 < kk1;
        if (odd) build(kk + 1);
        if (kk > kk0) {
          wgmma_wait<1>();  // step kk - 1 has retired
          retire(a1);
        }
        if (odd) {
          take(a1);
          issue(kk + 1, a1);
          if (kk + 2 < kk1) build(kk + 2);
          wgmma_wait<1>();  // step kk has retired
          retire(a0);
          if (kk + 2 < kk1) take(a0);
        }
      }
      if (NORMS) {  // lane t adds the norms of segments t, t + 4, ... of the slice
#pragma unroll
        for (int sg = 0; sg < SC; sg += 4)
#pragma unroll
          for (int j = 0; j < SPP; ++j)
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int code = min((int)cs[(lrow(j) + 8 * r) * CS + sg + tq], 16);
              xn[j][r] = __fadd_rn(xn[j][r], snorm[(seg0 + sg + tq) * 17 + code]);
            }
      }
      wgmma_wait<0>();  // the slice's last group
      retire(a0);
      retire(a1);
    }

    if (c == g.nsl - 1) {  // the tile is summed: metric, mask, round, transpose, store
#pragma unroll
      for (int j = 0; j < SPP; ++j)
#pragma unroll
        for (int i = 0; i < 32; ++i) fence_operand(acc[j][i]);
#pragma unroll
      for (int j = 0; j < SPP; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {  // the four lanes of a row hold a quarter each
          xn[j][r] = __fadd_rn(xn[j][r], __shfl_xor_sync(0xffffffffu, xn[j][r], 1));
          xn[j][r] = __fadd_rn(xn[j][r], __shfl_xor_sync(0xffffffffu, xn[j][r], 2));
        }
#pragma unroll
      for (int j = 0; j < SPP; ++j)
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int r = (i >> 1) & 1, q = (i >> 2) * 8 + 2 * tq + (i & 1);
          const float dot = acc[j][i];
          float v;
          if (NORMS)
            v = __fadd_rn(__fsub_rn(sqn[q], __fmul_rn(2.f, dot)), xn[j][r]);
          else if (g.metric == DOT)
            v = -dot;
          else
            v = __fsub_rn(1.f, dot);
          if (valid != nullptr) v = __fadd_rn(v, dead[j][r]);
          stile[q * OS + j * 64 + wr * 16 + gq + 8 * r] = __float2bfloat16_rn(v);
        }
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
      // the warpgroup's 128 rows of each query: 16-byte stores
      const long long rw = r0 + wg * SPP * 64;
      const int nq = min(QB, g.B - q0);
      const long long nr = min((long long)(SPP * 64), (long long)g.N - rw);
      for (int e = tw; e < QB * (SPP * 8); e += 128) {
        const int q = e / (SPP * 8), c8 = (e % (SPP * 8)) * 8;
        if (q >= nq || c8 >= nr) continue;
        __nv_bfloat16* dst = out + (size_t)(q0 + q) * g.N + rw + c8;
        const __nv_bfloat16* src = stile + q * OS + c8;
        if (g.out16 && c8 + 8 <= nr) {
          *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
        } else {
          for (int e2 = 0; e2 < 8 && c8 + e2 < nr; ++e2) dst[e2] = src[e2];
        }
      }
      // the output tile is written again only after the next slice's barrier
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

template <bool FAST, bool NORMS>
int launch_tc(const __nv_bfloat16* qblk, const float* qn, const uint8_t* codes,
              const __nv_bfloat16* table, const float* norms, const bool* valid,
              const TcGeo& g, int smem, __nv_bfloat16* out, cudaStream_t s) {
  auto kern = pq4_recon_tc_kernel<FAST, NORMS>;
  // the cap is set once per instantiation; a launch asks for what its d needs
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  if (attr != cudaSuccess) return (int)attr;
  kern<<<(unsigned)((long long)g.n_qb * g.cpq), TC_THREADS, smem, s>>>(qblk, qn, codes, table,
                                                                        norms, valid, g, out);
  return (int)cudaGetLastError();
}

// -- the FFMA body (d past what the tensor-core body holds) ----------------------

constexpr int SK = BK + 4;  // f32 row stride of a staged slice (80 B)

template <int METRIC>
__global__ void __launch_bounds__(THREADS)
pq4_recon_ffma_kernel(const __nv_bfloat16* __restrict__ q, const float* __restrict__ qn,
                      const uint8_t* __restrict__ codes, const __nv_bfloat16* __restrict__ table,
                      int ts, const bool* __restrict__ valid, int B, int N, int m, int ds,
                      __nv_bfloat16* __restrict__ out) {
  __shared__ __align__(16) float qs[BM * SK];
  __shared__ __align__(16) float xs[BN * SK];
  __shared__ float sxn[BN];
  const int d = m * ds;
  const long long n0 = (long long)blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int t = threadIdx.x, tx = t % 16, ty = t / 16;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  float xn = 0.f;  // thread t < BN: |x_hat|^2 of row n0 + t

  for (int k0 = 0; k0 < d; k0 += BK) {
    for (int e = t; e < BM * BK; e += THREADS) {
      const int r = e / BK, c = e % BK, mm = m0 + r, k = k0 + c;
      qs[r * SK + c] = (mm < B && k < d) ? __bfloat162float(q[(size_t)mm * d + k]) : 0.f;
    }
    for (int e = t; e < BN * BK; e += THREADS) {
      const int r = e / BK, c = e % BK, k = k0 + c;
      const long long n = n0 + r;
      float v = 0.f;
      if (n < N && k < d) {
        const uint32_t code = min((uint32_t)__ldg(codes + (size_t)n * m + k / ds), 16u);
        v = __bfloat162float(table[code * ts + k]);
      }
      xs[r * SK + c] = v;
    }
    __syncthreads();
    if (METRIC == L2 && t < BN) {
#pragma unroll
      for (int c = 0; c < BK; ++c) xn = fmaf(xs[t * SK + c], xs[t * SK + c], xn);
    }
#pragma unroll
    for (int kk = 0; kk < BK; kk += 4) {
      float4 a4[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) a4[i] = load4(qs + (ty * TM + i) * SK + kk);
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float4 b = load4(xs + (tx + 16 * j) * SK + kk);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          acc[i][j] = fmaf(a4[i].x, b.x, acc[i][j]);
          acc[i][j] = fmaf(a4[i].y, b.y, acc[i][j]);
          acc[i][j] = fmaf(a4[i].z, b.z, acc[i][j]);
          acc[i][j] = fmaf(a4[i].w, b.w, acc[i][j]);
        }
      }
    }
    __syncthreads();  // the next slice restages both buffers
  }
  if (METRIC == L2 && t < BN) sxn[t] = xn;
  __syncthreads();

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int mm = m0 + ty * TM + i;
    if (mm >= B) continue;
    const float qv = (METRIC == L2) ? qn[mm] : 0.f;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const long long n = n0 + tx + 16 * j;
      if (n >= N) continue;
      const float dot = acc[i][j];
      float v;
      if (METRIC == L2)
        v = __fadd_rn(__fsub_rn(qv, __fmul_rn(2.f, dot)), sxn[tx + 16 * j]);
      else if (METRIC == DOT)
        v = -dot;
      else
        v = __fsub_rn(1.f, dot);
      if (valid != nullptr) v = __fadd_rn(v, valid[n] ? 0.f : MASKED);
      out[(size_t)mm * N + n] = __float2bfloat16_rn(v);
    }
  }
}

template <int METRIC>
void launch_ffma(const __nv_bfloat16* q, const float* qn, const uint8_t* codes,
                 const __nv_bfloat16* table, int ts, const bool* valid, int B, int N, int m,
                 int ds, __nv_bfloat16* out, cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (B + BM - 1) / BM);
  pq4_recon_ffma_kernel<METRIC><<<grid, THREADS, 0, stream>>>(q, qn, codes, table, ts, valid, B,
                                                               N, m, ds, out);
}

}  // namespace

// C interface (ctypes). metric: 0 l2-squared, 1 dot, 2 cosine; qn and
// norms are read for l2 only (norm_bytes: the norm table's bytes, 0 for the
// other metrics); valid may be null. ``tc`` picks the body: 1 the
// tensor-core body (``qblk`` for n_qblocks * 64 queries), 0 the FFMA body
// (``q``). vec16: m % 16 == 0 and the codes 16-byte aligned; out16: N % 8
// == 0 and out 16-byte aligned. Returns the launch's cudaGetLastError().
extern "C" int wtt_pq4_recon_block(const void* qblk, const void* q, const void* qn,
                                   const void* codes, const void* table, int ts,
                                   const void* norms, int norm_bytes, const void* valid, int B,
                                   int N, int m, int ds, int metric, int tc, int n_qblocks,
                                   int vec16, int out16, void* out, void* stream) {
  if (B <= 0 || N <= 0) return (int)cudaGetLastError();
  const float* qnf = static_cast<const float*>(qn);
  const uint8_t* c = static_cast<const uint8_t*>(codes);
  const __nv_bfloat16* tab = static_cast<const __nv_bfloat16*>(table);
  const bool* v = static_cast<const bool*>(valid);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!tc) {
    const __nv_bfloat16* qq = static_cast<const __nv_bfloat16*>(q);
    if (metric == L2)
      launch_ffma<L2>(qq, qnf, c, tab, ts, v, B, N, m, ds, o, s);
    else if (metric == DOT)
      launch_ffma<DOT>(qq, qnf, c, tab, ts, v, B, N, m, ds, o, s);
    else
      launch_ffma<COSINE>(qq, qnf, c, tab, ts, v, B, N, m, ds, o, s);
    return (int)cudaGetLastError();
  }
  TcGeo g;
  g.B = B; g.N = N; g.m = m; g.ds = ds; g.d16 = (m * ds + 15) / 16 * 16; g.ts = ts;
  g.nks = g.d16 / 16; g.nsl = (g.nks + 4 * ds - 1) / (4 * ds); g.n_qb = n_qblocks;
  g.vec16 = vec16; g.out16 = out16; g.metric = metric; g.norm_bytes = metric == L2 ? norm_bytes : 0;
  g.n_rt = (N + ROWS - 1) / ROWS;
  const int per = sm_count() / n_qblocks;
  g.cpq = per < 1 ? 1 : (per < g.n_rt ? per : g.n_rt);
  const int smem = tc_smem(g.d16, ts, g.norm_bytes);
  if (n_qblocks * QB < B || ts < g.d16 || smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  const __nv_bfloat16* qb = static_cast<const __nv_bfloat16*>(qblk);
  const float* nf = static_cast<const float*>(norms);
  const bool l2 = metric == L2;
  if (recon_fast(m, ds))
    return l2 ? launch_tc<true, true>(qb, qnf, c, tab, nf, v, g, smem, o, s)
              : launch_tc<true, false>(qb, qnf, c, tab, nf, v, g, smem, o, s);
  return l2 ? launch_tc<false, true>(qb, qnf, c, tab, nf, v, g, smem, o, s)
            : launch_tc<false, false>(qb, qnf, c, tab, nf, v, g, smem, o, s);
}
