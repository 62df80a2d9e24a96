// bq_mxu_block: masked hamming distances in the form of the TPU's MXU
// kernel, written as bf16.
//   qblk uint32, the query words in the tensor-core body's blocks
//   (ops/kernels.bq_query_blocks), q [B, W] uint32, x [N, W] uint32,
//   qpop [B] f32 (or null: popcount of the query), xpop [N] f32 (or null:
//   popcount of the row), valid [N] bool (or null)
//   -> out [B, N] bf16 = bf16_rn((qpop + xpop) - 2 * popc(q & x)
//                               + (1 - valid) * MASKED), the sum in f32.
//
// Replaces the TPU kernel weaviate_tpu/ops/pallas_kernels.py
// ``bq_mxu_block`` (pallas_call in ``_bq_mxu_tiled``, body
// ``_bq_mxu_kernel``): the corpus words are unpacked into 0/1 bf16 bit
// planes in VMEM and one MXU product with the queries' planes gives the
// bit-plane dot q.x, exact in its f32 accumulator; the epilogue is
// |q| + |x| - 2 q.x plus the mask, in f32, rounded to bf16.
//
// Exactness. The dot of 0/1 planes is popc(q AND x) summed over the words;
// the single-bit MMA below sums the same popcounts in int32, exactly. Every
// term of the epilogue is an integer below 2^24 (or the caller's cached f32
// popcounts, used as given) and the f32 operations run in the reference's
// order with its rounding (the _rn intrinsics, never contracted), so the
// result equals the plain version (ops/kernels.bq_mxu_block_plain) bit for
// bit. The words past W that a K step of 8 words covers are zero in the
// query operand, so whatever the row ring holds there adds 0 to an integer
// sum: no -0.0 can come from the padding (an integer converts to +0.0), and
// the f32 epilogue is the plain version's own.
//
// Bound on an H100 SXM: the reference's cost estimate counts 2*B*N*32W
// operations of the 0/1 product; Hopper's single-bit MMA covers 8 times the
// bits of an int8 MMA in the same time (csrc/probes/wgmma_b1.cu), 0.026 ms
// at B = 256, N = 1,048,576, W = 24, so the bytes bound it: 101 MB of words
// and the 537 MB bf16 output, about 0.19 ms at 3.35 TB/s.
//
// What held the first design back (1.764 ms, 11% of that bound; NVIDIA
// H100 80GB HBM3, 700 W; PERF.md): AND + __popc on the CUDA cores, B*N*W
// popcounts at 16 per clock per SM, ~1.5 ms whatever the tuning, and
// stores of 64 contiguous bytes per query and warp.
//
// Design: bq_scan_reduce's single-bit body with a block epilogue.
//  - wgmma.m64nNk256.s32.b1.b1.and.popc, both operands from shared memory:
//    D[row, query] = popc(x AND q) over 256 bits a K step. Rows are the
//    MMA's M: the x words themselves, K-major core matrices of 8 rows x 16
//    bytes, no unpack, through a 4-stage cp.async ring per warpgroup (16-byte
//    copies when W % 4 == 0 on an aligned base, 4-byte copies otherwise).
//    Queries are its N: the query block's words plus 16 all-ones rows,
//    resident for the CTA (bulk copies on an mbarrier); the all-ones
//    columns give popc(x) of every row from the same MMA, used when the
//    caller has no cached popcounts.
//  - N = QN + 16 (wgmma's N past 32 is a multiple of 16), QN chosen from B
//    (8, 16, 32, 64 or 128 queries): phase 8's 8-query call does not pay
//    for 128. Larger B runs over several query blocks, the query block
//    fastest in the grid so that CTAs reading the same rows run together.
//  - A CTA of two warpgroups owns 2 * TPW consecutive 64-row tiles;
//    warpgroup w takes tiles w, w + 2, ... After a tile's MMAs each entry
//    goes through the f32 epilogue into a shared-memory tile [QN queries x
//    64 rows] (transposed), and each query's 64 rows go out as one
//    128-byte run of 16-byte stores. A tile's stores are in flight while
//    the next tile's MMAs run.
//  - Rows past N are zero-filled by the copies and never stored.
//  - The first design's body (AND + __popc, 32 queries a CTA) stays for
//    codes too wide for the tensor-core body's shared memory (W past ~100
//    words).

#include <cuda_bf16.h>

#include "scan_reduce_common.cuh"
#include "wgmma_common.cuh"

namespace {

using namespace wtt_scan;
using namespace wtt_wgmma;

// -- the popcount body ---------------------------------------------------------

constexpr int QB = 32;  // queries per CTA of the popcount body

template <bool COUNT_X>
__global__ void __launch_bounds__(THREADS)
bq_mxu_block_kernel(const uint32_t* __restrict__ q, const uint32_t* __restrict__ x, int vec4,
                    const float* __restrict__ qpop, const float* __restrict__ xpop,
                    const bool* __restrict__ valid, int B, int N, int W, int wp, int n_qblocks,
                    __nv_bfloat16* __restrict__ out) {
  extern __shared__ __align__(16) uint32_t sq[];  // [QB][wp] query words
  __shared__ float sqpop[QB];
  const int q0 = (int)(blockIdx.x % n_qblocks) * QB;
  const long long row = (long long)(blockIdx.x / n_qblocks) * THREADS + threadIdx.x;
  stage_query_words<QB>(sq, q, q0, B, W, wp, THREADS);
  __syncthreads();
  const int t = (int)threadIdx.x;
  if (t < QB) {  // the caller's popcounts as given, else the words' (zero past W)
    int pop = 0;
    for (int w = 0; w < wp; ++w) pop += __popc(sq[t * wp + w]);
    sqpop[t] = (q0 + t >= B) ? 0.f : qpop != nullptr ? qpop[q0 + t] : (float)pop;
  }
  __syncthreads();
  if (row >= N) return;
  int dot[QB];
#pragma unroll
  for (int i = 0; i < QB; ++i) dot[i] = 0;
  int xcount = 0;
  row_popcounts<QB, true, COUNT_X>(sq, wp, x, true, 0, vec4, row, N, W, dot, xcount);
  const float xp = COUNT_X ? (float)xcount : xpop[row];
  const float dead = (valid != nullptr && !valid[row]) ? MASKED : 0.f;
  const int nq = min(QB, B - q0);
#pragma unroll
  for (int i = 0; i < QB; ++i) {
    if (i < nq) {
      float d = __fsub_rn(__fadd_rn(sqpop[i], xp), __fmul_rn(2.f, (float)dot[i]));
      if (valid != nullptr) d = __fadd_rn(d, dead);
      out[(size_t)(q0 + i) * N + row] = __float2bfloat16_rn(d);
    }
  }
}

template <bool COUNT_X>
void launch_popc(const uint32_t* q, const uint32_t* x, int vec4, const float* qpop,
                 const float* xpop, const bool* valid, int B, int N, int W,
                 __nv_bfloat16* out, cudaStream_t stream) {
  const int wp = padded_words(W);
  const int smem = QB * wp * (int)sizeof(uint32_t);
  if (smem > 40 * 1024)  // beside the static qpop array
    cudaFuncSetAttribute(bq_mxu_block_kernel<COUNT_X>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const int n_qblocks = (B + QB - 1) / QB;
  const long long blocks = (long long)((N + THREADS - 1) / THREADS) * n_qblocks;
  bq_mxu_block_kernel<COUNT_X><<<(unsigned)blocks, THREADS, smem, stream>>>(
      q, x, vec4, qpop, xpop, valid, B, N, W, wp, n_qblocks, out);
}

// -- the tensor-core body --------------------------------------------------------

constexpr int TC_THREADS = 256;  // two warpgroups
constexpr int TILE = 64;         // rows of one warpgroup step: the MMA's M
constexpr int STAGES = 4;        // row tiles in flight per warpgroup
constexpr int TPW = 8;           // tiles per warpgroup and CTA
constexpr int OS = TILE + 8;     // bf16 stride of a query's row in the output tile (144 B)
constexpr int SMEM_MAX = 232448; // dynamic shared memory a block can use

__host__ __device__ inline int tc_words(int W) { return (W + 7) / 8 * 8; }  // K steps of 8 words
// the query block's words and its all-ones rows, the two warpgroups' rings
// and output tiles, the queries' popcounts, the mbarrier
// (ops/kernels.bq_mxu_smem computes the same)
__host__ inline int tc_smem(int qn, int W) {
  return (qn + 16) * tc_words(W) * 4 + 2 * STAGES * TILE * tc_words(W) * 4 + 2 * qn * OS * 2 +
         qn * 4 + 16;
}

struct TcGeo {
  int B, N, W, n_qb, vec16;  // vec16: N % 8 == 0 and out 16-byte aligned
};

template <int QN, bool VEC>
__global__ void __launch_bounds__(TC_THREADS, QN >= 128 ? 1 : 2)
bq_mxu_tc_kernel(const uint32_t* __restrict__ qblk, const uint32_t* __restrict__ q,
                 const uint32_t* __restrict__ x, const float* __restrict__ qpop,
                 const float* __restrict__ xpop,
                 const bool* __restrict__ valid, TcGeo g, __nv_bfloat16* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int w8 = tc_words(g.W);
  const int sbo = 32 * w8;  // bytes between core matrices along M / N: all K chunks of 8 rows
  const int qbytes = (QN + 16) * w8 * 4;
  const int stage_bytes = TILE * w8 * 4;
  __nv_bfloat16* otile_all =
      reinterpret_cast<__nv_bfloat16*>(smem + qbytes + 2 * STAGES * stage_bytes);
  float* sqpop = reinterpret_cast<float*>(otile_all + 2 * QN * OS);
  uint64_t* bar = reinterpret_cast<uint64_t*>(sqpop + QN);

  const int qb = (int)(blockIdx.x % g.n_qb);
  const long long chunk = blockIdx.x / g.n_qb;
  const int q0 = qb * QN;
  const int t = threadIdx.x, lane = t & 31, tw = t & 127;
  const int wg = t >> 7, gq = lane >> 2, tq = lane & 3;
  const int rl = (tw >> 5) * 16 + gq;  // this lane's rows of a tile: rl, rl + 8
  unsigned char* ring = smem + qbytes + wg * STAGES * stage_bytes;
  __nv_bfloat16* otile = otile_all + wg * QN * OS;  // [QN][OS]: query-major rows

  if (t == 0) {
    mbar_init(bar);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = t; i < QN; i += TC_THREADS) {  // the caller's popcounts as given, else the words'
    float p = 0.f;
    if (q0 + i < g.B && qpop != nullptr) {
      p = qpop[q0 + i];
    } else if (q0 + i < g.B) {
      int pop = 0;
      for (int w = 0; w < g.W; ++w) pop += __popc(__ldg(q + (size_t)(q0 + i) * g.W + w));
      p = (float)pop;
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
    float xp[2], dead[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const long long row = r0 + rl + 8 * r;
      const bool in = row < g.N;
      xp[r] = (xpop != nullptr && in) ? xpop[row] : 0.f;
      dead[r] = (valid != nullptr && in && !valid[row]) ? MASKED : 0.f;
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < QN / 2 + 8; ++i) fence_operand(acc[i]);
    if (xpop == nullptr) {
#pragma unroll
      for (int r = 0; r < 2; ++r) xp[r] = (float)acc[QN / 2 + 2 * r];
    }
    // entry i: query 8(i/4) + 2t + i%2, row rl + 8((i/2)%2); the reference's
    // f32 order: (qpop + xpop) - 2 dot, then the mask
#pragma unroll
    for (int i = 0; i < QN / 2; ++i) {
      const int r = (i >> 1) & 1, qi = (i >> 2) * 8 + 2 * tq + (i & 1);
      float d = __fsub_rn(__fadd_rn(sqpop[qi], xp[r]), __fmul_rn(2.f, (float)acc[i]));
      if (valid != nullptr) d = __fadd_rn(d, dead[r]);
      otile[qi * OS + rl + 8 * r] = __float2bfloat16_rn(d);
    }
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    // each query's 64 rows: one 128-byte run, 8 threads of 16 bytes
    const int nr = (int)min((long long)TILE, (long long)g.N - r0);
    for (int e = tw; e < nq * 8; e += 128) {
      const int qi = e >> 3, c8 = (e & 7) * 8;
      if (c8 >= nr) continue;
      __nv_bfloat16* dst = out + (size_t)(q0 + qi) * g.N + r0 + c8;
      const __nv_bfloat16* src = otile + qi * OS + c8;
      if (g.vec16 && c8 + 8 <= nr) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
        for (int k = 0; k < 8 && c8 + k < nr; ++k) dst[k] = src[k];
      }
    }
  }
  cp_async_wait<0>();
}

template <int QN, bool VEC>
int launch_tc(const uint32_t* qm, const uint32_t* q, const uint32_t* x, const float* qpop,
              const float* xpop, const bool* valid, const TcGeo& g, long long blocks, int smem,
              __nv_bfloat16* out, cudaStream_t s) {
  auto kern = bq_mxu_tc_kernel<QN, VEC>;
  // the cap is set once per instantiation; a launch asks for what its W needs
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  if (attr != cudaSuccess) return (int)attr;
  kern<<<(unsigned)blocks, TC_THREADS, smem, s>>>(qm, q, x, qpop, xpop, valid, g, out);
  return (int)cudaGetLastError();
}

template <bool VEC>
int dispatch_tc(int qn, const uint32_t* qm, const uint32_t* q, const uint32_t* x,
                const float* qpop, const float* xpop, const bool* valid, const TcGeo& g,
                long long blocks, int smem, __nv_bfloat16* out, cudaStream_t s) {
  switch (qn) {
    case 8: return launch_tc<8, VEC>(qm, q, x, qpop, xpop, valid, g, blocks, smem, out, s);
    case 16: return launch_tc<16, VEC>(qm, q, x, qpop, xpop, valid, g, blocks, smem, out, s);
    case 32: return launch_tc<32, VEC>(qm, q, x, qpop, xpop, valid, g, blocks, smem, out, s);
    case 64: return launch_tc<64, VEC>(qm, q, x, qpop, xpop, valid, g, blocks, smem, out, s);
    case 128: return launch_tc<128, VEC>(qm, q, x, qpop, xpop, valid, g, blocks, smem, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// C interface (ctypes). qpop, xpop and valid may be null. ``qblock`` picks the
// body: 0 the popcount body (32 queries a CTA; ``qm`` unused), else the
// tensor-core body with qblock queries a CTA (8, 16, 32, 64 or 128), ``qm``
// its blocked query words for n_qblocks * qblock queries. vec4: W % 4 == 0
// and x 16-byte aligned; out16: N % 8 == 0 and out 16-byte aligned.
// Returns the launch's cudaGetLastError().
extern "C" int wtt_bq_mxu_block(const void* qm, const void* q, const void* x, int vec4,
                                const void* qpop, const void* xpop, const void* valid, int B,
                                int N, int W, int qblock, int n_qblocks, int out16, void* out,
                                void* stream) {
  if (B <= 0 || N <= 0) return (int)cudaGetLastError();
  const uint32_t* qq = static_cast<const uint32_t*>(q);
  const uint32_t* xx = static_cast<const uint32_t*>(x);
  const float* qp = static_cast<const float*>(qpop);
  const float* xp = static_cast<const float*>(xpop);
  const bool* v = static_cast<const bool*>(valid);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (qblock == 0) {
    if (xp == nullptr)
      launch_popc<true>(qq, xx, vec4, qp, xp, v, B, N, W, o, s);
    else
      launch_popc<false>(qq, xx, vec4, qp, xp, v, B, N, W, o, s);
    return (int)cudaGetLastError();
  }
  const int smem = tc_smem(qblock, W);
  if (n_qblocks * qblock < B || smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  TcGeo g;
  g.B = B; g.N = N; g.W = W; g.n_qb = n_qblocks; g.vec16 = out16;
  const long long chunks = ((long long)N + 2 * TPW * TILE - 1) / (2 * TPW * TILE);
  const long long blocks = chunks * n_qblocks;
  const uint32_t* m = static_cast<const uint32_t*>(qm);
  return vec4 ? dispatch_tc<true>(qblock, m, qq, xx, qp, xp, v, g, blocks, smem, o, s)
              : dispatch_tc<false>(qblock, m, qq, xx, qp, xp, v, g, blocks, smem, o, s);
}
