// bq_scan_reduce: full-corpus hamming scan over packed sign words with a
// strided block-argmin that keeps one candidate per reduce_l rows.
//   qblk uint32, the query words in the kernel's blocks
//   (ops/kernels.bq_query_blocks), q [B, W] uint32, x [N, W] uint32 (or
//   [W, N] transposed), valid [N] bool, allow [B, wa] uint32 packed allow
//   words
//   -> vals [B, n_st * out_w] f32 (true hamming, MASKED where dead or
//      disallowed), ids [B, n_st * out_w] i32 global rows.
//
// Replaces the TPU kernel weaviate_tpu/ops/pallas_kernels.py
// ``bq_scan_reduce`` (pallas_call in ``_bq_scan_tiled``, body
// ``_bq_scan_kernel``): a +-64 int8 matmul over bit planes unpacked in
// VMEM, fused with the packed (value << 6 | slice) strided minimum.
//
// Bound on an H100 SXM: the reference's cost estimate counts 2*B*N*32W
// operations (the +-1 product), 0.21 ms at the dense int8 peak (1,979
// TOP/s) at B = 256, N = 1,048,576, W = 24. Hopper's single-bit MMA
// (BGMMA) covers 8 times the bits of an int8 MMA in the same time (the
// probe in csrc/probes/wgmma_b1.cu), 0.026 ms for that product, so the
// bytes bound it: the 100 MB of codes, valid and the 34 MB of outputs
// once, 0.040 ms at 3.35 TB/s.
//
// What held the first design back (1.842 ms, 11% of that bound; NVIDIA
// H100 80GB HBM3, 700 W; PERF.md): hamming as XOR + __popc on the CUDA
// cores, B*N*W popcounts at 16 per clock per SM, ~1.5 ms whatever the
// tuning, and 32 queries a CTA even for one query.
//
// Design: the product on the tensor cores as the single-bit warpgroup MMA
// wgmma.m64nNk256.s32.b1.b1.and.popc, both operands from shared memory:
//   D[row, query] = popc(x AND q) over 256 bits a K step, exact in int32,
//   hamming - popcount(q) = popc(x) - 2D.
//  - Rows are the MMA's M, queries its N. One K step is 8 sign words; the
//    words themselves are the operands, K-major core matrices of 8 rows x
//    16 bytes: no unpack. Words past W are zero in B, so whatever the ring
//    holds there adds nothing.
//  - B, the query block's words plus 16 all-ones rows (zero
//    past W), arrives once per CTA by bulk copies on an mbarrier and stays
//    resident; the all-ones columns give popc(x) of every row from the
//    same MMA.
//  - N = QN + 16 (wgmma's N past 32 is a multiple of 16), with QN chosen
//    from B (8, 16, 32, 64 or 128 queries), so that one query does not
//    pay for 128.
//  - A CTA of two warpgroups owns 128 output columns of one supertile;
//    warpgroup w walks its 64 columns through the reduce_l strided slices
//    s (64 consecutive rows each, a 4-stage cp.async ring laid out in
//    core-matrix order). After a tile's MMAs each accumulator entry
//    becomes the packed (popc(x) - 2D + dead offset) * 64 + s key and the
//    thread keeps the minimum over s in registers: the block-min needs no
//    exchange between threads.
//  - Rows past N are zero-filled by the copies and count as dead, as in
//    the reference. Row-major words with W % 4 == 0 on a 16-byte aligned
//    base take 16-byte copies; a transposed or ragged corpus 4-byte ones.
//  - The first design's body (XOR + __popc, 32 queries a CTA) stays for
//    codes too wide for the tensor-core body's shared memory (W past ~100
//    words) and for an out_w that is not a multiple of 128.

#include "scan_reduce_common.cuh"
#include "wgmma_common.cuh"

namespace {

using namespace wtt_scan;
using namespace wtt_wgmma;

// -- the popcount body --------------------------------------------------------

constexpr int QB = 32;  // queries per CTA of the popcount body

__global__ void __launch_bounds__(THREADS)
bq_scan_reduce_kernel(const uint32_t* __restrict__ q, const uint32_t* __restrict__ x,
                      int transposed, int vec4, const bool* __restrict__ valid,
                      const uint32_t* __restrict__ allow, int wa, int B, int N, int W, int wp,
                      int reduce_l, int out_w, int supertile, int out_cols, int n_qblocks,
                      float* __restrict__ out_v, int* __restrict__ out_i) {
  extern __shared__ __align__(16) uint32_t sq[];  // [QB][wp] query words
  __shared__ int spop[QB];
  const Place p = place(n_qblocks, QB, out_w);
  const int nq = min(QB, B - p.q0);
  stage_query_words<QB>(sq, q, p.q0, B, W, wp, THREADS);
  __syncthreads();
  if (threadIdx.x < QB) {
    int pop = 0;
    for (int w = 0; w < wp; ++w) pop += __popc(sq[threadIdx.x * wp + w]);
    spop[threadIdx.x] = pop;
  }
  __syncthreads();
  if (p.c >= out_w) return;

  const int dead_off = 2 * 32 * W + 2;  // past any live hamming - popcount(q)
  int best[QB];
#pragma unroll
  for (int i = 0; i < QB; ++i) best[i] = INT_MAX;
  for (int s = 0; s < reduce_l; ++s) {
    const long long row = p.t * supertile + (long long)s * out_w + p.c;
    const bool in = row < N;
    const bool dead = !in || (valid != nullptr && !valid[row]);
    int ham[QB];
#pragma unroll
    for (int i = 0; i < QB; ++i) ham[i] = 0;
    int unused = 0;
    row_popcounts<QB, false, false>(sq, wp, x, in, transposed, vec4, row, N, W, ham,
                                    unused);
#pragma unroll
    for (int i = 0; i < QB; ++i) {
      int key = (ham[i] - spop[i] + (dead ? dead_off : 0)) * 64 + s;
      if (allow != nullptr &&
          (i >= nq || !allowed(allow + (size_t)(p.q0 + i) * wa, wa, row)))
        key = INT_MAX;
      best[i] = min(best[i], key);
    }
  }
  const int d = 32 * W;
  const long long col = p.t * out_w + p.c;
  const int base = (int)(p.t * supertile) + p.c;
#pragma unroll
  for (int i = 0; i < QB; ++i) {
    if (i < nq) {
      const int k = best[i];
      const float v = (float)(k >> 6) + (float)spop[i];
      const size_t o = (size_t)(p.q0 + i) * out_cols + col;
      out_v[o] = v > (float)d ? MASKED : v;
      out_i[o] = (k & 63) * out_w + base;
    }
  }
}


// -- the tensor-core body -----------------------------------------------------

constexpr int TC_THREADS = 256;    // two warpgroups
constexpr int TILE = 64;           // rows of one warpgroup step: the MMA's M
constexpr int TC_COLS = 2 * TILE;  // output columns per CTA
constexpr int STAGES = 4;          // row tiles in flight per warpgroup
constexpr int SMEM_MAX = 232448;   // dynamic shared memory a block can use

__host__ __device__ inline int tc_words(int W) { return (W + 7) / 8 * 8; }  // K steps of 8 words
// the query block's words (and its two all-ones groups), the two warpgroups'
// rings, the queries' popcounts and the mbarrier (ops/kernels.bq_tc_smem
// computes the same)
__host__ inline int tc_smem(int qn, int W) {
  return (qn + 16) * tc_words(W) * 4 + 2 * STAGES * TILE * tc_words(W) * 4 + qn * 4 + 16;
}

struct TcGeo {
  int B, N, W, L, out_w, n_cb, n_qb, wa, out_cols;
  long long supertile;
};

template <int QN, bool VEC>
__global__ void __launch_bounds__(TC_THREADS, QN >= 128 ? 1 : 2)
bq_scan_tc_kernel(const uint32_t* __restrict__ qblk, const uint32_t* __restrict__ q,
                  const uint32_t* __restrict__ x, int transposed,
                  const bool* __restrict__ valid, const uint32_t* __restrict__ allow,
                  TcGeo g, float* __restrict__ out_v, int* __restrict__ out_i) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int w8 = tc_words(g.W);
  const int sbo = 32 * w8;  // bytes between core matrices along M / N: all K chunks of 8 rows
  const int qbytes = (QN + 16) * w8 * 4;
  const int stage_bytes = TILE * w8 * 4;
  int* spop = reinterpret_cast<int*>(smem + qbytes + 2 * STAGES * stage_bytes);
  uint64_t* bar = reinterpret_cast<uint64_t*>(spop + QN);

  const int qb = (int)(blockIdx.x % g.n_qb);
  const long long tile = blockIdx.x / g.n_qb;
  const int cb = (int)(tile % g.n_cb);
  const long long st = tile / g.n_cb;
  const int q0 = qb * QN;
  const int t = threadIdx.x, lane = t & 31, tw = t & 127;
  const int wg = t >> 7, gq = lane >> 2, tq = lane & 3;
  const int rl = (tw >> 5) * 16 + gq;  // this lane's rows of a tile: rl, rl + 8
  const int col0 = cb * TC_COLS + wg * TILE;  // the warpgroup's first column
  unsigned char* ring = smem + qbytes + wg * STAGES * stage_bytes;

  if (t == 0) {
    mbar_init(bar);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = t; i < QN; i += TC_THREADS) {
    int pop = 0;
    if (q0 + i < g.B)
      for (int w = 0; w < g.W; ++w) pop += __popc(__ldg(q + (size_t)(q0 + i) * g.W + w));
    spop[i] = pop;
  }
  __syncthreads();
  if (t == 0) {  // the query block's words, one bulk copy per 8 queries
    mbar_expect(bar, qbytes);
    for (int i = 0; i < QN / 8 + 2; ++i)
      bulk_copy(smem + i * sbo, reinterpret_cast<const unsigned char*>(qblk) +
                                    (size_t)qb * qbytes + (size_t)i * sbo, sbo, bar);
  }

  // tile s: rows base + s*out_w .. +63 in core-matrix order: word j of
  // row r at (r/8)*sbo + (j/4)*128 + (r%8)*16 + (j%4)*4
  const long long base = st * g.supertile + col0;
  auto load = [&](int s) {
    unsigned char* dst = ring + (s % STAGES) * stage_bytes;
    const long long r0 = base + (long long)s * g.out_w;
    if (VEC) {  // 16-byte chunks of row-major rows: two threads a row
      const int rr = tw >> 1;
      const bool ok = r0 + rr < g.N;
      unsigned char* d = dst + (rr >> 3) * sbo + (rr & 7) * 16;
      for (int c = tw & 1; c < g.W / 4; c += 2)
        cp_async16(d + c * 128, ok ? (const void*)(x + (r0 + rr) * g.W + 4 * c) : (const void*)x,
                   ok);
    } else if (transposed) {  // [W, N]: 64 consecutive rows of a word, coalesced
      const int rr = tw & 63;
      const long long row = r0 + rr;
      const bool ok = row < g.N;
      unsigned char* d = dst + (rr >> 3) * sbo + (rr & 7) * 16;
      for (int j = tw >> 6; j < g.W; j += 2)
        cp_async4(d + (j >> 2) * 128 + (j & 3) * 4, ok ? x + (size_t)j * g.N + row : x, ok);
    } else {  // row-major words that take no 16-byte copy
      const int rr = tw >> 1;
      const long long row = r0 + rr;
      const bool ok = row < g.N;
      unsigned char* d = dst + (rr >> 3) * sbo + (rr & 7) * 16;
      for (int j = tw & 1; j < g.W; j += 2)
        cp_async4(d + (j >> 2) * 128 + (j & 3) * 4, ok ? x + (size_t)row * g.W + j : x, ok);
    }
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < g.L) load(s);
    cp_async_commit();
  }

  int best[QN / 2];  // running block-min keys of this lane's entries
#pragma unroll
  for (int i = 0; i < QN / 2; ++i) best[i] = INT_MAX;
  const int dead_off = 2 * 32 * g.W + 2;  // past any live hamming - popcount(q)
  const uint32_t qm_s = (uint32_t)__cvta_generic_to_shared(smem);
  const uint32_t ring_s = (uint32_t)__cvta_generic_to_shared(ring);
  // the dead flags of this lane's two rows of the tile at row r0
  auto is_dead = [&](long long r0, bool (&dead)[2]) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const long long row = r0 + rl + 8 * r;
      dead[r] = row >= g.N || (valid != nullptr && !valid[row]);
    }
  };
  bool dead_next[2];
  is_dead(base, dead_next);
  mbar_wait(bar, 0);
  for (int s = 0; s < g.L; ++s) {
    cp_async_wait<STAGES - 2>();  // tile s has landed; the MMAs read it through the
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // async proxy ...
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");  // ... for the warpgroup
    if (s + STAGES - 1 < g.L) load(s + STAGES - 1);  // into tile s-1's stage
    cp_async_commit();
    const long long r0 = base + (long long)s * g.out_w;
    // D[row, n] = popc(x AND q_n); the all-ones columns n >= QN give popc(x)
    int acc[QN / 2 + 8];
    const uint32_t a_s = ring_s + (s % STAGES) * stage_bytes;
    wgmma_fence();
    for (int j = 0; j < w8 / 8; ++j)  // K step j: words 8j .. 8j+7, two core matrices
      wgmma_b1(acc, desc_of(a_s + j * 256, 128, sbo), desc_of(qm_s + j * 256, 128, sbo), j);
    wgmma_commit();
    const bool dead[2] = {dead_next[0], dead_next[1]};
    if (s + 1 < g.L) is_dead(r0 + g.out_w, dead_next);  // read while the MMAs run
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < QN / 2 + 8; ++i) fence_operand(acc[i]);
    // key = (hamming - popc(q) + dead offset) * 64 + s, hamming - popc(q) = popc(x) - 2D
    int bias[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) bias[r] = (acc[QN / 2 + 2 * r] + (dead[r] ? dead_off : 0)) * 64 + s;
    if (allow == nullptr) {  // entry i: query 8(i/4) + 2t + i%2, row rl + 8((i/2)%2)
#pragma unroll
      for (int i = 0; i < QN / 2; ++i) best[i] = min(best[i], bias[(i >> 1) & 1] - 128 * acc[i]);
    } else {
#pragma unroll
      for (int i = 0; i < QN / 2; ++i) {
        const int r = (i >> 1) & 1, qq = q0 + (i >> 2) * 8 + 2 * tq + (i & 1);
        const bool ok = qq < g.B && allowed(allow + (size_t)qq * g.wa, g.wa, r0 + rl + 8 * r);
        best[i] = min(best[i], ok ? bias[r] - 128 * acc[i] : INT_MAX);
      }
    }
  }
  cp_async_wait<0>();

  const int d = 32 * g.W;
#pragma unroll
  for (int i = 0; i < QN / 2; ++i) {
    const int qi = (i >> 2) * 8 + 2 * tq + (i & 1);
    if (q0 + qi >= g.B) continue;
    const int col = col0 + rl + 8 * ((i >> 1) & 1);
    const int k = best[i];
    const float v = (float)(k >> 6) + (float)spop[qi];
    const size_t o = (size_t)(q0 + qi) * g.out_cols + st * g.out_w + col;
    out_v[o] = v > (float)d ? MASKED : v;
    out_i[o] = (k & 63) * g.out_w + (int)(st * g.supertile) + col;
  }
}

template <int QN, bool VEC>
void launch_tc(const uint32_t* qm, const uint32_t* q, const uint32_t* x, int transposed,
               const bool* valid, const uint32_t* allow, const TcGeo& g, long long blocks,
               int smem, float* vals, int* ids, cudaStream_t s) {
  auto kern = bq_scan_tc_kernel<QN, VEC>;
  // the cap is set once per instantiation; a launch asks for what its W needs
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  (void)attr;
  kern<<<(unsigned)blocks, TC_THREADS, smem, s>>>(qm, q, x, transposed, valid, allow, g, vals,
                                                   ids);
}

template <bool VEC>
cudaError_t dispatch_tc(int qn, const uint32_t* qm, const uint32_t* q, const uint32_t* x,
                        int transposed, const bool* valid, const uint32_t* allow,
                        const TcGeo& g, long long blocks, int smem, float* vals, int* ids,
                        cudaStream_t s) {
  switch (qn) {
    case 8: launch_tc<8, VEC>(qm, q, x, transposed, valid, allow, g, blocks, smem, vals, ids, s); break;
    case 16: launch_tc<16, VEC>(qm, q, x, transposed, valid, allow, g, blocks, smem, vals, ids, s); break;
    case 32: launch_tc<32, VEC>(qm, q, x, transposed, valid, allow, g, blocks, smem, vals, ids, s); break;
    case 64: launch_tc<64, VEC>(qm, q, x, transposed, valid, allow, g, blocks, smem, vals, ids, s); break;
    case 128: launch_tc<128, VEC>(qm, q, x, transposed, valid, allow, g, blocks, smem, vals, ids, s); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

}  // namespace

// C interface (ctypes); valid and allow may be null. ``qblock`` picks the
// body: 0 the popcount body (32 queries a CTA; ``qm`` unused), else the
// tensor-core body with qblock queries a CTA (8, 16, 32, 64 or 128), ``qm``
// its blocked query words for n_qblocks * qblock queries. vec: the words
// are row-major, W % 4 == 0 and 16-byte aligned. Returns the launch's
// cudaGetLastError().
extern "C" int wtt_bq_scan_reduce(const void* qm, const void* q, const void* x, int transposed,
                                  int vec, const void* valid, const void* allow, int wa, int B,
                                  int N, int W, int qblock, int reduce_l, int out_w,
                                  int supertile, int n_st, int n_qblocks, void* vals, void* ids,
                                  void* stream) {
  if (B <= 0 || n_st <= 0) return (int)cudaGetLastError();
  const uint32_t* qw = static_cast<const uint32_t*>(q);
  const uint32_t* xw = static_cast<const uint32_t*>(x);
  const bool* v = static_cast<const bool*>(valid);
  const uint32_t* a = static_cast<const uint32_t*>(allow);
  float* ov = static_cast<float*>(vals);
  int* oi = static_cast<int*>(ids);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (qblock == 0) {
    if (n_qblocks * QB < B) return (int)cudaErrorInvalidValue;
    const int wp = padded_words(W);
    const int smem = QB * wp * (int)sizeof(uint32_t);
    cudaFuncSetAttribute(bq_scan_reduce_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem);
    const long long blocks = (long long)n_st * n_colblocks(out_w) * n_qblocks;
    bq_scan_reduce_kernel<<<(unsigned)blocks, THREADS, smem, s>>>(
        qw, xw, transposed, vec, v, a, wa, B, N, W, wp, reduce_l, out_w, supertile,
        n_st * out_w, n_qblocks, ov, oi);
    return (int)cudaGetLastError();
  }
  const int smem = tc_smem(qblock, W);
  if (out_w % TC_COLS != 0 || n_qblocks * qblock < B || smem > SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  TcGeo g;
  g.B = B; g.N = N; g.W = W; g.L = reduce_l; g.out_w = out_w;
  g.n_cb = out_w / TC_COLS; g.n_qb = n_qblocks; g.wa = wa; g.out_cols = n_st * out_w;
  g.supertile = supertile;
  const long long blocks = (long long)n_st * g.n_cb * n_qblocks;
  const uint32_t* m = static_cast<const uint32_t*>(qm);
  const cudaError_t rc =
      vec && !transposed
          ? dispatch_tc<true>(qblock, m, qw, xw, 0, v, a, g, blocks, smem, ov, oi, s)
          : dispatch_tc<false>(qblock, m, qw, xw, transposed, v, a, g, blocks, smem, ov, oi, s);
  if (rc != cudaSuccess) return (int)rc;
  return (int)cudaGetLastError();
}
