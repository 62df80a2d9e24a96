// pq4_scan_reduce: full-corpus 4-bit PQ ADC scan through a per-query int8
// lookup table, with a strided block-argmin that keeps one candidate per
// reduce_l rows.
//   lut int8, quantize_lut_int8's table in the kernel's blocks
//   (ops/kernels.pq4_lut_blocks: [n_qblocks * 8][ks / 32][32 segments][8
//   queries][16 codes], zero past B and past the reference's pm
//   segments), scale [B] f32, codes
//   [N, m] uint8 (or [m, N] transposed), valid [N] bool, allow [B, wa]
//   uint32 allow words
//   -> vals [B, n_st * out_w] f32 (ADC sum / scale, MASKED where dead or
//      disallowed), ids [B, n_st * out_w] i32 global rows.
//
// Replaces the TPU kernel weaviate_tpu/ops/pallas_kernels.py
// ``pq4_scan_reduce`` (pallas_call in ``_pq4_scan_tiled``, body
// ``_pq4_scan_kernel``): a one-hot x int8 LUT matmul on the MXU, fused with
// the packed (value << 6 | slice) strided minimum.
//
// Bound on an H100 SXM: the one-hot product is 2*B*N*16m int8 operations;
// against the dense int8 peak of 1,979 TOP/s that is 0.83 ms at B = 256,
// N = 1,048,576, m = 192, while the bytes (201 MB of codes read once) take
// 0.06 ms at 3.35 TB/s: bound by operations.
//
// What held the first design back (4.418 ms, 19% of that bound; NVIDIA H100
// 80GB HBM3, 700 W; PERF.md): a table lookup per (row, segment) on the CUDA
// cores, 16 queries a CTA (every code byte read 16 times at B = 256), and
// the 16 queries' whole table resident in shared memory, which refused m >
// 896 segments.
//
// Design: the TPU kernel's product on the int8 tensor cores, as Hopper's
// warpgroup MMA: wgmma.m64n64k32.s32.s8.s8, D [64 rows x 64 queries] +=
// A [64 rows x 32] . B [32 x 64 queries]. K = 16 * segments, segment-major
// (k = s*16 + c), so one K step of 32 covers two segments.
//  - A is the one-hot of the rows' codes, built in registers (wgmma takes A
//    from registers): lane (g, t) holds k = 4t .. 4t+3 of its rows, i.e.
//    the byte (c & 3) set when c >> 2 == t — one shift by ((c * 8) ^ 32t),
//    which PTX clamps to 0 for the other three lanes. It is built KG K
//    steps at a time into one of two register sets, so the next group's
//    one-hot is built while the last group's MMAs run.
//  - B is the 64 queries' table slice, read by the tensor cores from shared
//    memory through a descriptor (K-major, no swizzle: 8 x 16-byte core
//    matrices, 128 bytes apart along K, 4 KB apart along the queries). The
//    host lays the table out in that order (ops/kernels.pq4_lut_blocks), so
//    a slice arrives as 8 bulk copies of 4 KB on an mbarrier.
//  - The int32 sums are exact, so any K order gives the plain version's
//    bits.
//  - A CTA of two warpgroups serves 64 queries (a 256-query batch reads the
//    codes 4 times) and one 128-column block of one supertile. A pass takes
//    4 strided slices s .. s+3 of those columns (512 rows); warpgroup w
//    owns columns 64w .. 64w+63 in all four, one 64 x 64 accumulator per
//    slice. After a pass each accumulator takes the packed (sum << 6 | s)
//    key of its row, and the thread keeps the minimum over s of the entries
//    it owns (in shared memory): the block-min needs no exchange between
//    threads.
//  - K is streamed through a 2-stage ring of 32-segment slices
//    (the table slice, 32 KB, and the pass rows' codes, 24 KB), continued
//    across passes, so any m runs: there is no segment limit.
//  - Rows past N read as all-zero codes and count as dead, as in the
//    reference; codes are read as code & 15. Row-major codes whose rows
//    are 16-byte aligned take cp.async; a transposed or unaligned corpus is
//    loaded byte by byte into the same ring.

#include <limits.h>

#include "wgmma_common.cuh"

namespace {

using namespace wtt_wgmma;

constexpr float MASKED = 3.0e38f;  // MASKED_DISTANCE of ops/distances.py
constexpr int THREADS = 256;       // two warpgroups
constexpr int QB = 64;             // queries per CTA: the MMA's N
constexpr int COLS = 128;          // output columns per CTA
constexpr int WCOLS = COLS / 2;    // columns a warpgroup owns: the MMA's M
constexpr int SPP = 4;             // strided slices (s values) per pass
constexpr int PROWS = SPP * COLS;  // rows per pass
constexpr int SEGS = 32;           // segments per K slice
constexpr int KS = SEGS * 16;      // table bytes per query per K slice
constexpr int CS = SEGS + 16;      // smem row stride of the codes slice: 16-byte rows, distinct banks
constexpr int STAGES = 2;
constexpr int LUT_BYTES = QB * KS;
constexpr int STAGE_BYTES = LUT_BYTES + PROWS * CS;
constexpr int BS = COLS + 4;       // query stride of the running keys: 32 lanes on 32 banks
constexpr int SMEM = STAGES * STAGE_BYTES + QB * BS * 4 + STAGES * 8;
constexpr int LBO = 128;           // bytes between core matrices along K
constexpr int SBO = (KS / 16) * 128;  // bytes between core matrices along the queries
constexpr int KG = 1;              // K steps per group of MMAs (one one-hot register set)

// 1 << x, and 0 for x >= 32 (shl.b32 clamps its shift)
__device__ __forceinline__ uint32_t shl1(uint32_t x) {
  uint32_t r;
  asm("shl.b32 %0, %1, %2;\n" : "=r"(r) : "r"(1u), "r"(x));
  return r;
}

// Allow bit of row r in one query's packed words (pack_allow_bitmask's
// block-strided layout). Words past ``wa`` are disallowed, as the
// reference's zero padding makes them.
__device__ __forceinline__ bool allowed(const uint32_t* __restrict__ words, int wa, long long r) {
  const long long w = (r >> 9) * 16 + (r & 15);
  if (w >= wa) return false;
  return (__ldg(words + w) >> ((r & 511) >> 4)) & 1u;
}

struct Geo {
  int B, N, m, ks, L, out_w, n_cb, n_qb;
  long long supertile;
};

// the corpus row of pass row rr (slice pass*SPP + rr / COLS, column
// cb*COLS + rr % COLS of supertile st), or -1 where there is none
__device__ __forceinline__ long long pass_row(const Geo& g, long long st, int cb, int pass,
                                              int rr) {
  const int s = pass * SPP + rr / COLS, col = cb * COLS + rr % COLS;
  if (s >= g.L || col >= g.out_w) return -1;
  const long long row = st * g.supertile + (long long)s * g.out_w + col;
  return row < g.N ? row : -1;
}

template <bool ASYNC>
__global__ void __launch_bounds__(THREADS, 1)
pq4_scan_reduce_kernel(const int8_t* __restrict__ lut, const float* __restrict__ scale, int pm,
                       const uint8_t* __restrict__ codes, int transposed,
                       const bool* __restrict__ valid, const uint32_t* __restrict__ allow,
                       int wa, Geo g, float* __restrict__ out_v, int* __restrict__ out_i) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int qb = (int)(blockIdx.x % g.n_qb);
  const long long tile = blockIdx.x / g.n_qb;
  const int cb = (int)(tile % g.n_cb);
  const long long st = tile / g.n_cb;
  const int q0 = qb * QB;
  const int t = threadIdx.x, lane = t % 32;
  const int wg = t / 128, wr = (t / 32) % 4;  // warpgroup, warp in it
  const int gq = lane >> 2, tq = lane & 3;    // fragment row group, thread in group
  const int c_own = wg * WCOLS + wr * 16 + gq;  // this lane's columns: c_own, c_own + 8

  const int nk = g.ks / SEGS;
  const int passes = (g.L + SPP - 1) / SPP;
  const int total = passes * nk;

  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_BYTES + QB * BS * 4);
  if (t == 0) {
    for (int i = 0; i < STAGES; ++i) mbar_init(bars + i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // each CTA starts its K slices at its own offset, so the CTAs that read
  // one table do not all ask L2 for the same lines at once (the sums are
  // exact: their order does not matter)
  const int koff = (int)(tile % nk);
  auto load = [&](int it) {
    const int pass = it / nk, kt = (it % nk + koff) % nk;
    unsigned char* stg = smem + (it % STAGES) * STAGE_BYTES;
    // the 64 queries' table slice: 8 blocks of 4 KB, one per 8 queries,
    // already in core-matrix order (query r, chunk c at c * 128 + r * 16)
    if (t == 0) {
      uint64_t* bar = bars + it % STAGES;
      mbar_expect(bar, LUT_BYTES);
#pragma unroll
      for (int qg = 0; qg < QB / 8; ++qg)
        bulk_copy(stg + qg * (KS / 16) * 128,
                  lut + ((size_t)(qb * (QB / 8) + qg) * nk + kt) * (8 * KS), 8 * KS, bar);
    }
    uint8_t* cs = stg + LUT_BYTES;
    const int seg0 = kt * SEGS;
    if (ASYNC) {  // row-major, m % 16 == 0, 16-byte aligned rows
      for (int e = t; e < PROWS * 2; e += THREADS) {
        const int rr = e >> 1, seg = seg0 + (e & 1) * 16;
        const long long row = pass_row(g, st, cb, pass, rr);
        const bool ok = row >= 0 && seg < g.m;
        cp_async16(cs + rr * CS + (e & 1) * 16,
                   ok ? (const void*)(codes + (size_t)row * g.m + seg) : (const void*)codes, ok);
      }
    } else if (transposed) {  // [m, N]: consecutive threads read consecutive rows
      for (int e = t; e < PROWS * SEGS; e += THREADS) {
        const int rr = e % PROWS, sg = e / PROWS, seg = seg0 + sg;
        const long long row = pass_row(g, st, cb, pass, rr);
        cs[rr * CS + sg] = (row >= 0 && seg < g.m) ? __ldg(codes + (size_t)seg * g.N + row) : 0;
      }
    } else {
      for (int e = t; e < PROWS * SEGS; e += THREADS) {
        const int rr = e / SEGS, sg = e % SEGS, seg = seg0 + sg;
        const long long row = pass_row(g, st, cb, pass, rr);
        cs[rr * CS + sg] = (row >= 0 && seg < g.m) ? __ldg(codes + (size_t)row * g.m + seg) : 0;
      }
    }
  };

  int acc[SPP][32];  // one 64 x 64 accumulator per slice of the pass
  // running block-min keys [query][column] past the ring (registers go to
  // the accumulators and the one-hot); after the loop's first barrier each
  // entry is read and written by one thread only
  int* best = reinterpret_cast<int*>(smem + STAGES * STAGE_BYTES);
  for (int e = t; e < QB * BS; e += THREADS) best[e] = INT_MAX;
#pragma unroll
  for (int j = 0; j < SPP; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[j][i] = 0;

#pragma unroll
  for (int it = 0; it < STAGES - 1; ++it) {
    if (it < total) load(it);
    cp_async_commit();
  }
  const uint32_t t32 = (uint32_t)tq << 5;
  const int dead_off = 2 * 127 * pm + 2;  // past any live ADC sum
  uint32_t a[2][KG][SPP][4];  // one-hot A of KG K steps: two sets, one in flight
  uint32_t dead = 0;  // bit 2j + r: this lane's row of slice j, column c_own + 8r, is dead
  for (int it = 0; it < total; ++it) {
    cp_async_wait<STAGES - 2>();                    // slice it's codes have landed
    mbar_wait(bars + it % STAGES, (it / STAGES) & 1);  // ... and its table
    __syncthreads();  // ... for every thread; slice it-1's buffer is free
    if (it + STAGES - 1 < total) load(it + STAGES - 1);
    cp_async_commit();
    if (it % nk == 0) {  // a pass starts: its rows' valid flags, read long before the fold
      dead = 0;
#pragma unroll
      for (int j = 0; j < SPP; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const long long row = st * g.supertile + (long long)((it / nk) * SPP + j) * g.out_w +
                                cb * COLS + c_own + 8 * r;
          if (row >= g.N || (valid != nullptr && !valid[row])) dead |= 1u << (2 * j + r);
        }
    }
    const unsigned char* stg = smem + (it % STAGES) * STAGE_BYTES;
    const unsigned char* cs = stg + LUT_BYTES;
    const uint32_t lut_s = (uint32_t)__cvta_generic_to_shared(stg);
#pragma unroll
    for (int u = 0; u < SEGS / 4; ++u) {  // 4 segments: two K steps
      uint32_t cw[SPP][2];  // segments 4u .. 4u+3 of this lane's two rows in each slice
#pragma unroll
      for (int j = 0; j < SPP; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          cw[j][r] = *reinterpret_cast<const uint32_t*>(cs + (j * COLS + c_own + 8 * r) * CS + 4 * u);
#pragma unroll
      for (int grp = 0; grp < 2 / KG; ++grp) {
        const int set = (u * (2 / KG) + grp) & 1;
        wgmma_wait<1>();  // the MMAs that read this set have finished
#pragma unroll
        for (int hh = 0; hh < KG; ++hh)
#pragma unroll
          for (int j = 0; j < SPP; ++j)
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              // K step 2u + h: code * 8 of segments 4u + 2h (a[..][r]) and
              // 4u + 2h + 1 (a[..][2 + r]), bytes 2h and 2h + 1 of cw
              const int h = grp * KG + hh;
              const uint32_t c0 = (h == 0 ? (cw[j][r] << 3) : (cw[j][r] >> 13)) & 0x78u;
              const uint32_t c1 = (cw[j][r] >> (h == 0 ? 5 : 21)) & 0x78u;
              a[set][hh][j][r] = shl1(c0 ^ t32);
              a[set][hh][j][2 + r] = shl1(c1 ^ t32);
            }
        wgmma_fence();
#pragma unroll
        for (int hh = 0; hh < KG; ++hh) {
          const uint64_t desc = desc_of(lut_s + (2 * u + grp * KG + hh) * 2 * LBO, LBO, SBO);
#pragma unroll
          for (int j = 0; j < SPP; ++j) wgmma_s8(acc[j], a[set][hh][j], desc, 1);
        }
        wgmma_commit();
      }
    }
    wgmma_wait<0>();  // the slice's buffer may be restaged; the sums may be read
#pragma unroll
    for (int j = 0; j < SPP; ++j)
#pragma unroll
      for (int i = 0; i < 32; ++i) fence_operand(acc[j][i]);
    if (it % nk == nk - 1) {  // the pass is summed: fold its slices into the block-min
      const int pass = it / nk;
#pragma unroll
      for (int j = 0; j < SPP; ++j) {
        const int s = pass * SPP + j;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int col = cb * COLS + c_own + 8 * r;
          const long long row = st * g.supertile + (long long)s * g.out_w + col;
          const bool in = s < g.L && col < g.out_w;
          const int off = (dead >> (2 * j + r)) & 1u ? dead_off : 0;
#pragma unroll
          for (int i = 0; i < 16; ++i) {
            const int q = q0 + (i >> 1) * 8 + 2 * tq + (i & 1);
            int key = (acc[j][(i >> 1) * 4 + 2 * r + (i & 1)] + off) * 64 + s;
            if (allow != nullptr && (q >= g.B || !allowed(allow + (size_t)q * wa, wa, row)))
              key = INT_MAX;
            int& bk = best[((i >> 1) * 8 + 2 * tq + (i & 1)) * BS + c_own + 8 * r];
            if (in) bk = min(bk, key);
          }
        }
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[j][i] = 0;
      }
    }
  }
  cp_async_wait<0>();

  const int out_cols = (int)(((long long)gridDim.x / g.n_qb / g.n_cb) * g.out_w);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int col = cb * COLS + c_own + 8 * r;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int q = q0 + (i >> 1) * 8 + 2 * tq + (i & 1);
      if (q >= g.B || col >= g.out_w) continue;
      const int key = best[((i >> 1) * 8 + 2 * tq + (i & 1)) * BS + c_own + 8 * r];
      const int raw = key >> 6;
      const size_t o = (size_t)q * out_cols + st * g.out_w + col;
      out_v[o] = raw > 127 * pm ? MASKED : (float)raw / scale[q];
      out_i[o] = (key & 63) * g.out_w + (int)(st * g.supertile) + col;
    }
  }
}

template <bool ASYNC>
void launch(const int8_t* lut, const float* scale, int pm, const uint8_t* codes, int transposed,
            const bool* valid, const uint32_t* allow, int wa, const Geo& g, long long blocks,
            float* vals, int* ids, cudaStream_t s) {
  auto kern = pq4_scan_reduce_kernel<ASYNC>;
  // the attribute is set once per instantiation, not per launch
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  (void)attr;
  kern<<<(unsigned)blocks, THREADS, SMEM, s>>>(lut, scale, pm, codes, transposed, valid, allow,
                                              wa, g, vals, ids);
}

}  // namespace

// C interface (ctypes); valid and allow may be null. ``lut`` is the
// blocked table of ``ks`` segments (a multiple of 32) for n_qblocks * 64
// queries; ``pm`` the reference's padded segment count, which sets the
// dead offset. vec16: the codes are row-major, m % 16 == 0 and 16-byte
// aligned. Returns the launch's cudaGetLastError().
extern "C" int wtt_pq4_scan_reduce(const void* lut, const void* scale, int pm, int ks,
                                   const void* codes, int transposed, int vec16,
                                   const void* valid, const void* allow, int wa, int B, int N,
                                   int m, int reduce_l, int out_w, int supertile, int n_st,
                                   int n_qblocks, void* vals, void* ids, void* stream) {
  if (B > 0 && n_st > 0) {
    if (ks % SEGS != 0 || ks < m || n_qblocks * QB < B) return (int)cudaErrorInvalidValue;
    Geo g;
    g.B = B; g.N = N; g.m = m; g.ks = ks; g.L = reduce_l; g.out_w = out_w;
    g.n_cb = (out_w + COLS - 1) / COLS; g.n_qb = n_qblocks; g.supertile = supertile;
    const long long blocks = (long long)n_st * g.n_cb * n_qblocks;
    const int8_t* l = static_cast<const int8_t*>(lut);
    const float* sc = static_cast<const float*>(scale);
    const uint8_t* c = static_cast<const uint8_t*>(codes);
    const bool* v = static_cast<const bool*>(valid);
    const uint32_t* a = static_cast<const uint32_t*>(allow);
    float* ov = static_cast<float*>(vals);
    int* oi = static_cast<int*>(ids);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (vec16 && !transposed)
      launch<true>(l, sc, pm, c, 0, v, a, wa, g, blocks, ov, oi, s);
    else
      launch<false>(l, sc, pm, c, transposed, v, a, wa, g, blocks, ov, oi, s);
  }
  return (int)cudaGetLastError();
}
