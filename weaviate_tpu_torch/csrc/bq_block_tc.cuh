// The single-bit tensor-core body of the two bq block kernels
// (bq_mxu_block.cu, bq_hamming_block.cu). Each supplies its epilogue, a
// struct of the output type and the per-entry formula; the body is one.
//
//  - wgmma.m64nNk256.s32.b1.b1.and.popc, both operands from shared memory:
//    D[row, query] = popc(x AND q) over 256 bits a K step. Rows are the
//    MMA's M: the x words themselves, K-major core matrices of 8 rows x 16
//    bytes, no unpack, through a 4-stage cp.async ring per warpgroup (16-byte
//    copies when W % 4 == 0 on an aligned base, 4-byte copies otherwise).
//    Queries are its N: the query block's words plus 16 all-ones rows,
//    resident for the CTA (bulk copies on an mbarrier); the all-ones
//    columns give popc(x) of every row from the same MMA, used when the
//    caller has no cached popcounts.
//  - The query words past W that a K step of 8 words covers are zero, and
//    the all-ones rows are ones over the W real words only
//    (ops/kernels.bq_query_blocks), so whatever the row ring holds there
//    adds 0 to both the product and popc(x).
//  - N = QN + 16 (wgmma's N past 32 is a multiple of 16), QN chosen from B
//    (8, 16, 32, 64 or 128 queries) by the wrapper. Larger B runs over
//    several query blocks, the query block fastest in the grid so that CTAs
//    reading the same rows run together.
//  - The queries' popcounts are counted from their words in the kernel
//    (or taken as the caller gives them).
//  - A CTA of two warpgroups owns 2 * TPW consecutive 64-row tiles;
//    warpgroup w takes tiles w, w + 2, ... After a tile's MMAs each entry
//    goes through the epilogue into a shared-memory tile [QN queries x 64
//    rows] (transposed, a row stride of EP::OS elements that keeps both the
//    scattered writes and the 16-byte reads free of bank conflicts), and
//    each query's 64 rows go out as one run of 16-byte stores (128 bytes in
//    bf16, 256 in f32). A tile's stores are in flight while the next tile's
//    MMAs run.
//  - Rows past N are zero-filled by the copies and never stored.
//
// An epilogue EP gives: T, the output element; P, the type of the
// popcounts (float where a caller's cached f32 popcounts are used as
// given, int otherwise); OS, the output tile's row stride in elements; and
// ``T entry(int dot, P qpop, P xpop, float dead, bool masked)``.
#pragma once

#include "scan_reduce_common.cuh"
#include "wgmma_common.cuh"

namespace wtt_bq_tc {

using namespace wtt_wgmma;

constexpr int TC_THREADS = 256;  // two warpgroups
constexpr int TILE = 64;         // rows of one warpgroup step: the MMA's M
constexpr int STAGES = 4;        // row tiles in flight per warpgroup
constexpr int TPW = 8;           // tiles per warpgroup and CTA
constexpr int SMEM_MAX = 232448; // dynamic shared memory a block can use

__host__ __device__ inline int tc_words(int W) { return (W + 7) / 8 * 8; }  // K steps of 8 words
// the query block's words and its all-ones rows, the two warpgroups' rings
// and output tiles, the queries' popcounts, the mbarrier
// (ops/kernels._bq_block_smem computes the same)
template <class EP>
__host__ inline int tc_smem(int qn, int W) {
  return (qn + 16) * tc_words(W) * 4 + 2 * STAGES * TILE * tc_words(W) * 4 +
         2 * qn * EP::OS * (int)sizeof(typename EP::T) + qn * 4 + 16;
}

struct TcGeo {
  int B, N, W, n_qb, vec16;  // vec16: N a multiple of a 16-byte run, out 16-byte aligned
};

// qblk: the blocked query words (ops/kernels.bq_query_blocks); q the plain
// ones; qpop, xpop, valid may be null
struct TcOperands {
  const uint32_t* qblk;
  const uint32_t* q;
  const uint32_t* x;
  const float* qpop;
  const float* xpop;
  const bool* valid;
};

template <class EP, int QN, bool VEC>
__global__ void __launch_bounds__(TC_THREADS, QN >= 128 ? 1 : 2)
bq_tc_kernel(const uint32_t* __restrict__ qblk, const uint32_t* __restrict__ q,
             const uint32_t* __restrict__ x, const float* __restrict__ qpop,
             const float* __restrict__ xpop, const bool* __restrict__ valid, TcGeo g,
             typename EP::T* __restrict__ out) {
  using T = typename EP::T;
  using P = typename EP::P;
  constexpr int OS = EP::OS;
  constexpr int V = 16 / (int)sizeof(T);  // elements of one 16-byte store
  constexpr int PER = TILE / V;           // stores of one query's 64 rows
  extern __shared__ __align__(128) unsigned char smem[];
  const int w8 = tc_words(g.W);
  const int sbo = 32 * w8;  // bytes between core matrices along M / N: all K chunks of 8 rows
  const int qbytes = (QN + 16) * w8 * 4;
  const int stage_bytes = TILE * w8 * 4;
  T* otile_all = reinterpret_cast<T*>(smem + qbytes + 2 * STAGES * stage_bytes);
  P* sqpop = reinterpret_cast<P*>(otile_all + 2 * QN * OS);
  uint64_t* bar = reinterpret_cast<uint64_t*>(sqpop + QN);

  const int qb = (int)(blockIdx.x % g.n_qb);
  const long long chunk = blockIdx.x / g.n_qb;
  const int q0 = qb * QN;
  const int t = threadIdx.x, lane = t & 31, tw = t & 127;
  const int wg = t >> 7, gq = lane >> 2, tq = lane & 3;
  const int rl = (tw >> 5) * 16 + gq;  // this lane's rows of a tile: rl, rl + 8
  unsigned char* ring = smem + qbytes + wg * STAGES * stage_bytes;
  T* otile = otile_all + wg * QN * OS;  // [QN][OS]: query-major rows

  if (t == 0) {
    mbar_init(bar);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = t; i < QN; i += TC_THREADS) {  // the caller's popcounts as given, else the words'
    P p = 0;
    if (q0 + i < g.B && qpop != nullptr) {
      p = (P)qpop[q0 + i];
    } else if (q0 + i < g.B) {
      int pop = 0;
      for (int w = 0; w < g.W; ++w) pop += __popc(__ldg(q + (size_t)(q0 + i) * g.W + w));
      p = (P)pop;
    }
    sqpop[i] = p;
  }
  __syncthreads();
  if (t == 0) {  // the query block's words, one bulk copy per 8 queries
    mbar_expect(bar, qbytes);
    for (int i = 0; i < QN / 8 + 2; ++i)
      bulk_copy(smem + i * sbo, reinterpret_cast<const unsigned char*>(qblk) +
                                    (size_t)qb * qbytes + (size_t)i * sbo, sbo, bar);
  }

  // this warpgroup's tiles: s = 0 .. n_tiles-1 at rows row0 + 2 s TILE
  const long long row0 = (chunk * 2 * TPW + wg) * TILE;
  const long long left = g.N - row0;
  const int n_tiles = left <= 0 ? 0 : (int)min((long long)TPW, (left + 2 * TILE - 1) / (2 * TILE));
  // tile s in core-matrix order: word j of row r at (r/8)*sbo + (j/4)*128 + (r%8)*16 + (j%4)*4
  auto load = [&](int s) {
    unsigned char* dst = ring + (s % STAGES) * stage_bytes;
    const long long r0 = row0 + (long long)s * 2 * TILE;
    const int rr = tw >> 1;  // two threads a row
    const long long row = r0 + rr;
    const bool ok = row < g.N;
    unsigned char* d = dst + (rr >> 3) * sbo + (rr & 7) * 16;
    if (VEC) {  // 16-byte chunks of row-major rows
      for (int c = tw & 1; c < g.W / 4; c += 2)
        cp_async16(d + c * 128, ok ? (const void*)(x + row * g.W + 4 * c) : (const void*)x, ok);
    } else {
      for (int j = tw & 1; j < g.W; j += 2)
        cp_async4(d + (j >> 2) * 128 + (j & 3) * 4, ok ? x + (size_t)row * g.W + j : x, ok);
    }
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_tiles) load(s);
    cp_async_commit();
  }

  const uint32_t qm_s = (uint32_t)__cvta_generic_to_shared(smem);
  const uint32_t ring_s = (uint32_t)__cvta_generic_to_shared(ring);
  const int nq = min(QN, g.B - q0);
  mbar_wait(bar, 0);
  for (int s = 0; s < n_tiles; ++s) {
    cp_async_wait<STAGES - 2>();  // tile s has landed; the MMAs read it through the
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // async proxy ...
    // ... for the warpgroup, whose stores of tile s-1 have read the output tile
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    if (s + STAGES - 1 < n_tiles) load(s + STAGES - 1);  // into tile s-1's stage
    cp_async_commit();
    const long long r0 = row0 + (long long)s * 2 * TILE;
    // D[row, n] = popc(x AND q_n); the all-ones columns n >= QN give popc(x)
    int acc[QN / 2 + 8];
    const uint32_t a_s = ring_s + (s % STAGES) * stage_bytes;
    wgmma_fence();
    for (int j = 0; j < w8 / 8; ++j)  // K step j: words 8j .. 8j+7, two core matrices
      wgmma_b1(acc, desc_of(a_s + j * 256, 128, sbo), desc_of(qm_s + j * 256, 128, sbo), j);
    wgmma_commit();
    // this lane's two rows: popcount and mask, read while the MMAs run
    P xp[2];
    float dead[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const long long row = r0 + rl + 8 * r;
      const bool in = row < g.N;
      xp[r] = (xpop != nullptr && in) ? (P)xpop[row] : (P)0;
      dead[r] = (valid != nullptr && in && !valid[row]) ? wtt_scan::MASKED : 0.f;
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < QN / 2 + 8; ++i) fence_operand(acc[i]);
    if (xpop == nullptr) {
#pragma unroll
      for (int r = 0; r < 2; ++r) xp[r] = (P)acc[QN / 2 + 2 * r];
    }
    // entry i: query 8(i/4) + 2t + i%2, row rl + 8((i/2)%2)
#pragma unroll
    for (int i = 0; i < QN / 2; ++i) {
      const int r = (i >> 1) & 1, qi = (i >> 2) * 8 + 2 * tq + (i & 1);
      otile[qi * OS + rl + 8 * r] = EP::entry(acc[i], sqpop[qi], xp[r], dead[r], valid != nullptr);
    }
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    // each query's 64 rows: one run, PER threads of 16 bytes (a diagnostic
    // build with WTT_BQ_TC_NOSTORE leaves them out: chip_smoke.py --block-times)
    const int nr = (int)min((long long)TILE, (long long)g.N - r0);
#ifndef WTT_BQ_TC_NOSTORE
    for (int e = tw; e < nq * PER; e += 128) {
      const int qi = e / PER, c = (e % PER) * V;
      if (c >= nr) continue;
      T* dst = out + (size_t)(q0 + qi) * g.N + r0 + c;
      const T* src = otile + qi * OS + c;
      if (g.vec16 && c + V <= nr) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
        for (int k = 0; k < V && c + k < nr; ++k) dst[k] = src[k];
      }
    }
#endif
  }
  cp_async_wait<0>();
}

template <class EP, int QN, bool VEC>
int launch_tc(const TcOperands& p, const TcGeo& g, long long blocks, int smem,
              typename EP::T* out, cudaStream_t s) {
  auto kern = bq_tc_kernel<EP, QN, VEC>;
  // the cap is set at every launch (a launch asks for what its W needs): a
  // function-local static here would be one object across the libraries
  // built from one source file (a -D diagnostic build beside the kernel's),
  // and the second library's kernels would launch without their cap
  const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  if (attr != cudaSuccess) return (int)attr;
  kern<<<(unsigned)blocks, TC_THREADS, smem, s>>>(p.qblk, p.q, p.x, p.qpop, p.xpop, p.valid, g,
                                                  out);
  return (int)cudaGetLastError();
}

template <class EP, bool VEC>
int dispatch_tc(int qn, const TcOperands& p, const TcGeo& g, long long blocks, int smem,
                typename EP::T* out, cudaStream_t s) {
  switch (qn) {
    case 8: return launch_tc<EP, 8, VEC>(p, g, blocks, smem, out, s);
    case 16: return launch_tc<EP, 16, VEC>(p, g, blocks, smem, out, s);
    case 32: return launch_tc<EP, 32, VEC>(p, g, blocks, smem, out, s);
    case 64: return launch_tc<EP, 64, VEC>(p, g, blocks, smem, out, s);
    case 128: return launch_tc<EP, 128, VEC>(p, g, blocks, smem, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// One launch of the body with ``qblock`` queries a CTA over ``n_qblocks``
// query blocks. vec4: W % 4 == 0 and x 16-byte aligned; out16: N a
// multiple of 16 / sizeof(T) and out 16-byte aligned. Returns the
// launch's cudaGetLastError(), or cudaErrorInvalidValue for a block that
// does not cover B or does not fit in shared memory.
template <class EP>
int run_tc(const TcOperands& p, int vec4, int B, int N, int W, int qblock, int n_qblocks,
           int out16, typename EP::T* out, cudaStream_t s) {
  const int smem = tc_smem<EP>(qblock, W);
  if (n_qblocks * qblock < B || smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  TcGeo g;
  g.B = B; g.N = N; g.W = W; g.n_qb = n_qblocks; g.vec16 = out16;
  const long long chunks = ((long long)N + 2 * TPW * TILE - 1) / (2 * TPW * TILE);
  const long long blocks = chunks * n_qblocks;
  return vec4 ? dispatch_tc<EP, true>(qblock, p, g, blocks, smem, out, s)
              : dispatch_tc<EP, false>(qblock, p, g, blocks, smem, out, s);
}

}  // namespace wtt_bq_tc
