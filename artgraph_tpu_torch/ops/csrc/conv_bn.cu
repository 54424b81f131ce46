// The fused 1x1-conv + BatchNorm-statistics unit of the ResNet bottleneck,
// forward and backward (ops/conv_bn.py).
//
// Replaces the Pallas kernels artgraph_tpu/ops/conv_bn.py:_fwd_kernel
// (called by _unit_fwd) and _bwd_kernel (called by _unit_bwd). Rounding
// points are theirs, so kernel and plain version differ only in the order of
// accumulation:
//   prologue:  z  = bf16(max(f32(x) * f32(a) + f32(b), 0)), multiply and add
//              rounded separately (no FMA), as the plain version computes it
//   forward:   y  = bf16(z . W^T), f32 accumulation;
//              s1 = sum_rows f32(y), s2 = sum_rows f32(y)^2 (the rounded y)
//   backward:  dyt = bf16(f32(dy) + ds1 + 2 f32(y) ds2)
//              dz  = dyt . W (f32); dx = bf16(where(zf > 0, dz, 0) * a),
//              da = sum_rows dzf * f32(x), db = sum_rows dzf (prologue only;
//              dx = bf16(dz) and da = db = 0 without it)
//              dW  = dyt^T . z (f32)
// with x [M, K] bf16 rows of an NHWC activation (M = B*H*W), W the 1x1
// conv's weight [N, K] bf16 (torch OIHW viewed as [N, K]), a, b [K] bf16.
//
// What bounds it on an H100: at ResNet50's shapes the products are small in
// K or N (64 to 2048), so most units move more bytes than they compute (at
// layer1, M = 100352, K = 64, N = 256: ~50 FLOP a byte against the card's
// ~295) and device memory bounds them; only layer4's widest units
// (K x N = 512 x 2048) are bound by the tensor cores. So the design keeps
// the SMs fed with bytes and moves as few as it can:
//   * Three products (FWD y = z . W^T, DZ = dyt . W, DW = dyt^T . z), each
//     a 128x128 block tile over 8 warps (2 x 4, 64x32 each) with mma.sync
//     m16n8k16 (bf16 in, f32 accumulate), fragments read with ldmatrix
//     (.trans for the k-major operands), and a ring of STAGES = 3 k-steps of
//     32 in dynamic shared memory filled by 16-byte cp.async copies with
//     zero-fill for the ragged rows: one block barrier a k-step, the copies
//     of step k + 2 in flight while step k multiplies. Two blocks an SM.
//   * The transforms run in place on the staged tiles: after its own
//     cp.async group lands, each thread passes the 16-byte chunks it copied
//     through the prologue (FWD's A tile of x, DW's B tile of x) or forms
//     dyt on them (DZ's A tile, from its dy and y chunks and ds1, ds2),
//     before the block barrier. Rows beyond M stay zero.
//   * dyt costs 8MN bytes either way: formed on both products' operands,
//     DZ and DW each read dy and y (4MN + 4MN); formed once, DZ reads dy
//     and y (4MN), writes dyt (2MN) and DW reads it back (2MN). The second
//     keeps DW a plain product, so the DZ blocks of the first column tile
//     store the dyt chunks they formed and DW reads them. (The separate dyt
//     pass it replaces moved 10MN: 6MN for the pass, 2MN each product.)
//   * Epilogues from the accumulator fragments: the f32 dW goes out as the
//     pairs lie (a lane quad fills a 32-byte sector), y and dx through a
//     transpose within each lane quad to 16-byte stores (ptx_helpers.cuh;
//     the pairs as they lie write half sectors, with which the forward's
//     kernel took 35% longer at layer1 on an H100); the column partials of
//     (y, y^2) and (dzf * x, dzf) are summed over the thread's rows, then
//     over the 8 lanes of a column by shuffles, then over the 2 warp rows
//     in shared memory, into one f32 partial row per 128-row tile. The
//     second pass (sum_groups.cuh) adds the partial rows, and DW's M-chunk
//     partials (DW splits M so that a small [N, K] fills the card), in a
//     fixed order. No atomics: every result is bit-identical from call to
//     call. Without the prologue the pass writes da = db = 0 (no memset).
//   * Where DZ's [M, K] grid leaves the card's 264 block slots mostly empty
//     (layer4: 1568 x 512, 52 tiles over N = 2048), DZ splits N in chunks
//     (DZ_PART, f32 partials) and a second launch adds them in chunk order
//     under DZ's own epilogue (DZ_SUM).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ptx_helpers.cuh"
#include "sum_groups.cuh"

namespace {

using namespace ptx;
using bf16 = __nv_bfloat16;

constexpr int BM = 128, BN = 128, BK = 32;
constexpr int STAGES = 3;
constexpr int THREADS = 256;
constexpr int WARP_M = 64, WARP_N = 32;  // 2 x 4 warps over the block tile
constexpr int MI = WARP_M / 16, NJ = WARP_N / 8;
// Shared-memory row strides in bf16, so that the 8 rows an ldmatrix phase
// reads fall on 8 different 16-byte bank groups: a [128][32] row tile at 80
// bytes, a [32][128] k-major tile at 272.
constexpr int LDS = BK + 8;
constexpr int LDT = BN + 8;
constexpr int ROW_TILE = BM * LDS;
constexpr int KM_TILE = BK * LDT;

// The three products of the unit, out[rows, cols] = sum_i A(r, i) B(i, c):
//   FWD: y [M, N]  = z . W^T:   A = x [M, K] (prologue), B = W [N, K]
//   DZ:  dx [M, K] from dyt . W: A = dyt [M, N] formed from dy and y,
//        B = W [N, K] read k-major
//   DW:  dW [N, K] = dyt^T . z: A = dyt [M, N] (k-major), B = x [M, K]
//        (k-major, prologue), over one chunk of M per blockIdx.z
// and, where DZ's grid is too small for the card (few rows, wide N), DZ in
// two passes: DZ_PART, DZ's product over one chunk of N per blockIdx.z
// into an f32 partial, then DZ_SUM, DZ's epilogue on the partials added in
// chunk order.
enum Mode {
  MODE_FWD = 0,
  MODE_DZ = 1,
  MODE_DW = 2,
  MODE_DZ_PART = 3,
  MODE_DZ_SUM = 4
};

// One ring stage in bf16 elements: the A tile, DZ's y tile, the B tile.
template <int MODE>
struct Stage {
  static constexpr bool DZ_LOADS = MODE == MODE_DZ || MODE == MODE_DZ_PART;
  static constexpr int A = MODE == MODE_DW ? KM_TILE : ROW_TILE;
  static constexpr int Y = DZ_LOADS ? ROW_TILE : 0;
  static constexpr int B = MODE == MODE_FWD ? ROW_TILE : KM_TILE;
  static constexpr int ELEMS = A + Y + B;
  static constexpr int SMEM_BYTES =
      MODE == MODE_DZ_SUM ? 0 : STAGES * ELEMS * 2;
};

struct UnitArgs {
  const bf16* A;      // FWD: x; DZ: dy; DW: dyt
  const bf16* Y;      // DZ: the forward's y
  const bf16* B;      // FWD, DZ: w [N, K]; DW: x
  const bf16* x;      // DZ: x, for the ReLU mask and da
  const bf16* pa;     // the prologue's a and b [K]
  const bf16* pb;
  const float* ds1;   // DZ: the cotangents of s1, s2 [N]
  const float* ds2;
  void* out;          // FWD: y; DZ, DZ_SUM: dx; DW: dw, or its chunk
                      // partials; DZ_PART: dz's chunk partials
  bf16* dyt;          // DZ, DZ_PART: dyt [M, N], stored by the first
                      // column tile
  float* part;        // FWD, DZ (prologue): per-tile column partials
  const float* dz_part;  // DZ_SUM: DZ_PART's partials
  int rows, cols, inner;
  int chunk;          // DW, DZ_PART: inner rows per blockIdx.z;
                      // DZ_SUM: the number of partials
};

// 8 bf16 of x through the prologue with their 8 channels' a and b:
// bf16(max(x * a + b, 0)) in f32, multiply and add rounded apart.
__device__ __forceinline__ uint4 prologue8(uint4 xv, uint4 av, uint4 bv) {
  const uint32_t x[4] = {xv.x, xv.y, xv.z, xv.w};
  const uint32_t a[4] = {av.x, av.y, av.z, av.w};
  const uint32_t b[4] = {bv.x, bv.y, bv.z, bv.w};
  uint32_t z[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    z[e] = pack_bf16(
        fmaxf(__fadd_rn(__fmul_rn(bf16_lo(x[e]), bf16_lo(a[e])),
                        bf16_lo(b[e])), 0.f),
        fmaxf(__fadd_rn(__fmul_rn(bf16_hi(x[e]), bf16_hi(a[e])),
                        bf16_hi(b[e])), 0.f));
  return make_uint4(z[0], z[1], z[2], z[3]);
}

// dyt = bf16(f32(dy) + ds1 + 2 f32(y) ds2) for 8 elements of one row (ds1,
// ds2 at their 8 columns); the adds and products rounded apart, as the
// plain version computes them.
__device__ __forceinline__ uint4 dyt8(uint4 dv, uint4 yv,
                                      const float* __restrict__ ds1,
                                      const float* __restrict__ ds2) {
  const bf16* de = reinterpret_cast<const bf16*>(&dv);
  const bf16* ye = reinterpret_cast<const bf16*>(&yv);
  uint4 out;
  bf16* oe = reinterpret_cast<bf16*>(&out);
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const float t = __fadd_rn(
        __fadd_rn(__bfloat162float(de[e]), ds1[e]),
        __fmul_rn(__fmul_rn(2.f, __bfloat162float(ye[e])), ds2[e]));
    oe[e] = __float2bfloat16(t);
  }
  return out;
}

// This thread's chunks of a [128][32] row tile: chunk i is row v >> 2,
// columns (v & 3) * 8.. with v = threadIdx.x + i * THREADS.
constexpr int CHUNKS = BM * BK / 8 / THREADS;  // 2, in either tile shape

// Issues the copies of rows [r0, r0 + 128) x columns [k0, k0 + 32) of a
// row-major operand (row stride ld) into a row tile; rows >= row_lim zero.
__device__ __forceinline__ void load_rows(bf16* s, const bf16* src, int ld,
                                          int r0, int row_lim, int k0) {
#pragma unroll
  for (int i = 0; i < CHUNKS; ++i) {
    const int v = threadIdx.x + i * THREADS, r = v >> 2, c = (v & 3) * 8;
    const bool ok = r0 + r < row_lim;
    cp_async16(s + r * LDS + c, ok ? src + (size_t)(r0 + r) * ld + k0 + c : src,
               ok);
  }
}

// Issues the copies of inner rows [k0, k0 + 32) (zero at or beyond k_lim)
// x columns [c0, c0 + 128) (zero at or beyond col_lim, a multiple of 8) of
// a k-major operand (row stride ld) into a [32][128] tile; chunk i is row
// v >> 4, columns (v & 15) * 8..
__device__ __forceinline__ void load_kmajor(bf16* s, const bf16* src, int ld,
                                            int k0, int k_lim, int c0,
                                            int col_lim) {
#pragma unroll
  for (int i = 0; i < CHUNKS; ++i) {
    const int v = threadIdx.x + i * THREADS, kr = v >> 4, kc = (v & 15) * 8;
    const bool ok = k0 + kr < k_lim && c0 + kc < col_lim;
    cp_async16(s + kr * LDT + kc,
               ok ? src + (size_t)(k0 + kr) * ld + c0 + kc : src, ok);
  }
}

// The in-place transforms of this thread's own chunks of a landed stage.
// FWD: the prologue on the x row tile (channels k0 + c; a thread's chunks
// share their 8 channels).
__device__ __forceinline__ void prologue_rows(bf16* s, const bf16* pa,
                                              const bf16* pb, int r0,
                                              int row_lim, int k0) {
  const int c = (threadIdx.x & 3) * 8;
  const uint4 av = *reinterpret_cast<const uint4*>(pa + k0 + c);
  const uint4 bv = *reinterpret_cast<const uint4*>(pb + k0 + c);
#pragma unroll
  for (int i = 0; i < CHUNKS; ++i) {
    const int r = (threadIdx.x + i * THREADS) >> 2;
    if (r0 + r < row_lim) {
      uint4* p = reinterpret_cast<uint4*>(s + r * LDS + c);
      *p = prologue8(*p, av, bv);
    }
  }
}

// DW: the prologue on the k-major x tile (channels c0 + kc; a thread's
// chunks share theirs).
__device__ __forceinline__ void prologue_kmajor(bf16* s, const bf16* pa,
                                                const bf16* pb, int k0,
                                                int k_lim, int c0,
                                                int col_lim) {
  const int kc = (threadIdx.x & 15) * 8;
  if (c0 + kc >= col_lim) return;
  const uint4 av = *reinterpret_cast<const uint4*>(pa + c0 + kc);
  const uint4 bv = *reinterpret_cast<const uint4*>(pb + c0 + kc);
#pragma unroll
  for (int i = 0; i < CHUNKS; ++i) {
    const int kr = (threadIdx.x + i * THREADS) >> 4;
    if (k0 + kr < k_lim) {
      uint4* p = reinterpret_cast<uint4*>(s + kr * LDT + kc);
      *p = prologue8(*p, av, bv);
    }
  }
}

// DZ: dyt over the dy row tile from the y row tile (columns k0 + c of
// [M, ld]), stored to dyt_out too where it is given.
__device__ __forceinline__ void dyt_rows(bf16* s, const bf16* sy,
                                         const float* ds1, const float* ds2,
                                         int r0, int row_lim, int k0,
                                         bf16* dyt_out, int ld) {
#pragma unroll
  for (int i = 0; i < CHUNKS; ++i) {
    const int v = threadIdx.x + i * THREADS, r = v >> 2, c = (v & 3) * 8;
    if (r0 + r < row_lim) {
      uint4* p = reinterpret_cast<uint4*>(s + r * LDS + c);
      const uint4 t = dyt8(*p, *reinterpret_cast<const uint4*>(
                                   sy + r * LDS + c),
                           ds1 + k0 + c, ds2 + k0 + c);
      *p = t;
      if (dyt_out != nullptr)
        *reinterpret_cast<uint4*>(dyt_out + (size_t)(r0 + r) * ld + k0 + c) =
            t;
    }
  }
}

// acc += the block tile's product over one landed stage (two k16 steps):
// the warp's 64x32 output from A (a [128][32] row tile, or k-major
// [32][128] when A_KM) and B (a [128][32] tile of its columns' rows, or
// k-major [32][128] when B_KM).
template <bool A_KM, bool B_KM>
__device__ __forceinline__ void mma_stage(float (&acc)[MI][NJ][4],
                                          const bf16* sA, const bf16* sB,
                                          int wm, int wn, int lane) {
#pragma unroll
  for (int kk = 0; kk < BK; kk += 16) {
    uint32_t a[MI][4], b[NJ][2];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
      const int m = wm * WARP_M + mi * 16;
      if (A_KM)
        ldsm_x4_trans(a[mi], sA + (kk + (lane & 7) + ((lane >> 4) << 3)) *
                                      LDT + m + ((lane >> 3) & 1) * 8);
      else
        ldsm_x4(a[mi], sA + (m + (lane & 15)) * LDS + kk + (lane >> 4) * 8);
    }
#pragma unroll
    for (int np = 0; np < NJ / 2; ++np) {
      const int n = wn * WARP_N + np * 16;
      uint32_t t[4];
      if (B_KM)
        ldsm_x4_trans(t, sB + (kk + (lane & 15)) * LDT + n + (lane >> 4) * 8);
      else
        ldsm_x4(t, sB + (n + (lane & 7) + ((lane >> 4) << 3)) * LDS + kk +
                       ((lane >> 3) & 1) * 8);
      b[2 * np][0] = t[0];
      b[2 * np][1] = t[1];
      b[2 * np + 1][0] = t[2];
      b[2 * np + 1][1] = t[3];
    }
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int nj = 0; nj < NJ; ++nj)
        mma_bf16(acc[mi][nj], a[mi], b[nj][0], b[nj][1]);
  }
}

// One 128x128 output tile of a product of the unit (see Mode). FWD and DZ
// (with the prologue) also write the tile's per-column partial sums,
// part[blockIdx.y][2 * cols]: (y, y^2) for FWD, (dzf * x, dzf) for DZ.
template <int MODE, bool PRO>
__global__ void __launch_bounds__(THREADS, 2)
unit_gemm_kernel(const UnitArgs p) {
  using L = Stage<MODE>;
  constexpr bool DZ_EPI = MODE == MODE_DZ || MODE == MODE_DZ_SUM;
  constexpr bool F32_OUT = MODE == MODE_DW || MODE == MODE_DZ_PART;
  constexpr bool STATS = MODE == MODE_FWD || (DZ_EPI && PRO);
  AG_DYNAMIC_SMEM(smem_raw);
  bf16* const smem = reinterpret_cast<bf16*>(smem_raw);
  __shared__ float colpart[BM / WARP_M][2][BN];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp / (BN / WARP_N), wn = warp % (BN / WARP_N);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  int kbeg = 0, kend = p.inner;
  if (F32_OUT) {
    kbeg = blockIdx.z * p.chunk;
    kend = min(p.inner, kbeg + p.chunk);
  }
  const int nk = MODE == MODE_DZ_SUM ? 0 : (kend - kbeg + BK - 1) / BK;
  bf16* const dyt_out = L::DZ_LOADS && blockIdx.x == 0 ? p.dyt : nullptr;

  // Issues the copies of k-step kt into its ring stage, and commits a group
  // (empty past the last step, so the group count stays uniform).
  auto issue = [&](int kt) {
    if (kt < nk) {
      bf16* st = smem + (kt % STAGES) * L::ELEMS;
      const int k0 = kbeg + kt * BK;
      if (MODE == MODE_FWD) {
        load_rows(st, p.A, p.inner, m0, p.rows, k0);
        load_rows(st + L::A, p.B, p.inner, n0, p.cols, k0);
      } else if (L::DZ_LOADS) {
        load_rows(st, p.A, p.inner, m0, p.rows, k0);
        load_rows(st + L::A, p.Y, p.inner, m0, p.rows, k0);
        load_kmajor(st + L::A + L::Y, p.B, p.cols, k0, kend, n0, p.cols);
      } else {
        load_kmajor(st, p.A, p.rows, k0, kend, m0, p.rows);
        load_kmajor(st + L::A, p.B, p.cols, k0, kend, n0, p.cols);
      }
    }
    cp_async_commit();
  };

  float acc[MI][NJ][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int nj = 0; nj < NJ; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) issue(s);
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of step kt landed
    bf16* st = smem + (kt % STAGES) * L::ELEMS;
    const int k0 = kbeg + kt * BK;
    if (MODE == MODE_FWD && PRO)
      prologue_rows(st, p.pa, p.pb, m0, p.rows, k0);
    if (L::DZ_LOADS)
      dyt_rows(st, st + L::A, p.ds1, p.ds2, m0, p.rows, k0, dyt_out,
               p.inner);
    if (MODE == MODE_DW && PRO)
      prologue_kmajor(st + L::A, p.pa, p.pb, k0, kend, n0, p.cols);
    // every thread's step kt is staged, and every warp is done with step
    // kt - 1, whose stage the next copies overwrite
    __syncthreads();
    issue(kt + STAGES - 1);
    mma_stage<MODE == MODE_DW, MODE != MODE_FWD>(acc, st, st + L::A + L::Y,
                                                 wm, wn, lane);
  }
  cp_async_wait<0>();
  if (MODE == MODE_DZ_SUM) {
    // the product is DZ_PART's: its partials at this thread's accumulator
    // elements, added in chunk order (a chunk's loads all independent)
    for (int z = 0; z < p.chunk; ++z) {
      const float* src = p.dz_part + (size_t)z * p.rows * p.cols;
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = m0 + wm * WARP_M + mi * 16 + (lane >> 2) + 8 * h;
#pragma unroll
          for (int nj = 0; nj < NJ; ++nj) {
            const int c = n0 + wn * WARP_N + nj * 8 + 2 * (lane & 3);
            if (r >= p.rows || c >= p.cols) continue;
            const float2 v = *reinterpret_cast<const float2*>(
                src + (size_t)r * p.cols + c);
            acc[mi][nj][2 * h] += v.x;
            acc[mi][nj][2 * h + 1] += v.y;
          }
        }
    }
  }

  // Epilogue. Element (mi, nj, e) of the accumulator is row
  // wm*64 + mi*16 + lane/4 + 8 (e >> 1), column wn*32 + nj*8 + 2 (lane % 4)
  // + (e & 1) of the tile; e = 2h, 2h + 1 are a column pair. The f32
  // outputs go out as the pairs lie (a lane quad fills a 32-byte sector);
  // y and dx are rounded where they lie, then transposed within the quad to
  // 16-byte stores (ptx_helpers.cuh). A warp's 32 columns are all in or all
  // out (cols % 32 == 0).
  const int q = lane & 3;
  const int wc = n0 + wn * WARP_N;  // the warp's first column
  float v1[NJ][2], v2[NJ][2];
#pragma unroll
  for (int nj = 0; nj < NJ; ++nj)
    v1[nj][0] = v1[nj][1] = v2[nj][0] = v2[nj][1] = 0.f;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + wm * WARP_M + mi * 16 + (lane >> 2) + 8 * h;
      const bool in = r < p.rows && wc < p.cols;
      uint32_t packed[NJ];
#pragma unroll
      for (int nj = 0; nj < NJ; ++nj) {
        const int c = wc + nj * 8 + 2 * q;
        const size_t o = (size_t)r * p.cols + c;
        const float a0 = acc[mi][nj][2 * h], a1 = acc[mi][nj][2 * h + 1];
        if (MODE == MODE_FWD) {
          packed[nj] = pack_bf16(a0, a1);
        } else if (DZ_EPI && PRO) {
          float dx[2] = {0.f, 0.f};
          if (in) {
            const __nv_bfloat162 xb =
                *reinterpret_cast<const __nv_bfloat162*>(p.x + o);
            const __nv_bfloat162 ab =
                *reinterpret_cast<const __nv_bfloat162*>(p.pa + c);
            const __nv_bfloat162 bb =
                *reinterpret_cast<const __nv_bfloat162*>(p.pb + c);
            const float xf[2] = {__bfloat162float(xb.x),
                                 __bfloat162float(xb.y)};
            const float af[2] = {__bfloat162float(ab.x),
                                 __bfloat162float(ab.y)};
            const float bf[2] = {__bfloat162float(bb.x),
                                 __bfloat162float(bb.y)};
            const float dz[2] = {a0, a1};
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float zf = __fadd_rn(__fmul_rn(xf[e], af[e]), bf[e]);
              const float dzf = zf > 0.f ? dz[e] : 0.f;
              dx[e] = __fmul_rn(dzf, af[e]);
              v1[nj][e] += dzf * xf[e];
              v2[nj][e] += dzf;
            }
          }
          packed[nj] = pack_bf16(dx[0], dx[1]);
        } else if (DZ_EPI) {
          packed[nj] = pack_bf16(a0, a1);
        } else if (in) {
          float* out = static_cast<float*>(p.out) +
                       (size_t)blockIdx.z * p.rows * p.cols;
          *reinterpret_cast<float2*>(out + o) = make_float2(a0, a1);
        }
      }
      if (MODE == MODE_FWD || DZ_EPI) {
        quad_transpose(packed, q);
        if (in)
          *reinterpret_cast<uint4*>(static_cast<bf16*>(p.out) +
                                    (size_t)r * p.cols + wc + 8 * q) =
              make_uint4(packed[0], packed[1], packed[2], packed[3]);
      }
    }
  }

  if (MODE == MODE_FWD) {
    // the column sums of the rounded y, apart from its stores (fewer live
    // registers at once)
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + wm * WARP_M + mi * 16 + (lane >> 2) + 8 * h;
        if (r >= p.rows || wc >= p.cols) continue;
#pragma unroll
        for (int nj = 0; nj < NJ; ++nj) {
          const uint32_t y = pack_bf16(acc[mi][nj][2 * h],
                                       acc[mi][nj][2 * h + 1]);
          const float y0 = bf16_lo(y), y1 = bf16_hi(y);
          v1[nj][0] += y0;
          v1[nj][1] += y1;
          v2[nj][0] += y0 * y0;
          v2[nj][1] += y1 * y1;
        }
      }
  }

  if constexpr (STATS) {
    // over the 8 lanes of each column (same lane % 4), then the 2 warp rows
#pragma unroll
    for (int nj = 0; nj < NJ; ++nj)
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
          v1[nj][e] += __shfl_xor_sync(0xffffffffu, v1[nj][e], o);
          v2[nj][e] += __shfl_xor_sync(0xffffffffu, v2[nj][e], o);
        }
    if (lane < 4) {
#pragma unroll
      for (int nj = 0; nj < NJ; ++nj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = wn * WARP_N + nj * 8 + 2 * lane + e;
          colpart[wm][0][c] = v1[nj][e];
          colpart[wm][1][c] = v2[nj][e];
        }
    }
    __syncthreads();
    const int c = n0 + tid;
    if (tid < BN && c < p.cols) {
      float* out = p.part + (size_t)blockIdx.y * 2 * p.cols;
      out[c] = colpart[0][0][tid] + colpart[1][0][tid];
      out[p.cols + c] = colpart[0][1][tid] + colpart[1][1][tid];
    }
  }
}

// The launch sequences of the two entry points over a launcher `run`:
// run.template unit<MODE, PRO>(grid, args) runs unit_gemm_kernel on a grid,
// run.sums(part, lo, hi, groups, cols, half) the second pass of
// sum_groups.cuh; each returns 0 or an error code, and a sequence stops at
// the first error. (The emulation of the kernels on the host runs them with
// its own launcher.)
template <bool PRO, class Run>
int fwd_sequence(Run& run, const bf16* x, const bf16* a, const bf16* b,
                 const bf16* w, void* y, float* part, float* s1, float* s2,
                 int M, int K, int N) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const UnitArgs args{x,       nullptr, w,       nullptr, a, b,
                      nullptr, nullptr, y,       nullptr, part,
                      nullptr, M,       N,       K,       0};
  int err = run.template unit<MODE_FWD, PRO>(grid, args);
  return err ? err : run.sums(part, s1, s2, grid.y, 2 * N, N);
}

// The backward: DZ (in one pass, or as DZ_PART over dz_splits chunks of
// dz_chunk columns of N into dz_part, then DZ_SUM), the sums of da and db,
// DW over `splits` chunks of `chunk` rows of M (into dw_part when split),
// and the sum of DW's chunks.
template <bool PRO, class Run>
int bwd_sequence(Run& run, const bf16* x, const bf16* a, const bf16* b,
                 const bf16* w, const bf16* y, const bf16* dy,
                 const float* ds1, const float* ds2, bf16* dyt, void* dx,
                 float* part, float* da, float* db, float* dz_part,
                 float* dw_part, float* dw, int M, int K, int N, int chunk,
                 int splits, int dz_chunk, int dz_splits) {
  const dim3 gdz((K + BN - 1) / BN, (M + BM - 1) / BM);
  UnitArgs dz{dy,  y,   w,  x,       a, b, ds1, ds2, dx, dyt, part,
              nullptr, M, K, N, 0};
  int err;
  if (dz_splits == 1) {
    err = run.template unit<MODE_DZ, PRO>(gdz, dz);
  } else {
    UnitArgs prod = dz;
    prod.out = dz_part;
    prod.chunk = dz_chunk;
    err = run.template unit<MODE_DZ_PART, PRO>(
        dim3(gdz.x, gdz.y, dz_splits), prod);
    dz.dz_part = dz_part;
    dz.chunk = dz_splits;
    if (!err) err = run.template unit<MODE_DZ_SUM, PRO>(gdz, dz);
  }
  // da, db: the partials' sums, or zeros without the prologue
  if (!err) err = run.sums(part, da, db, PRO ? (int)gdz.y : 0, 2 * K, K);
  if (err) return err;
  const dim3 gdw((K + BN - 1) / BN, (N + BM - 1) / BM, splits);
  const UnitArgs dwa{dyt,     nullptr, x,       nullptr,
                     a,       b,       nullptr, nullptr,
                     splits > 1 ? (void*)dw_part : (void*)dw,
                     nullptr, nullptr, nullptr, N,
                     K,       M,       chunk};
  err = run.template unit<MODE_DW, PRO>(gdw, dwa);
  if (err || splits == 1) return err;
  return run.sums(dw_part, dw, nullptr, splits, N * K, N * K);
}

// Host side: launches.

template <int MODE, bool PRO>
cudaError_t launch_unit(dim3 grid, const UnitArgs& args, cudaStream_t s) {
  constexpr int bytes = Stage<MODE>::SMEM_BYTES;
  // above 48 KB of dynamic shared memory: allowed once per process, never
  // on a launch (which stays safe to capture in a CUDA graph)
  static const cudaError_t attr = [] {
    cudaError_t e = cudaFuncSetAttribute(
        unit_gemm_kernel<MODE, PRO>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(unit_gemm_kernel<MODE, PRO>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    return e;
  }();
  if (attr != cudaSuccess) return attr;
  unit_gemm_kernel<MODE, PRO><<<grid, THREADS, bytes, s>>>(args);
  return cudaGetLastError();
}

// The launcher of the sequences above on a CUDA stream.
struct StreamRun {
  cudaStream_t s;
  template <int MODE, bool PRO>
  int unit(dim3 grid, const UnitArgs& args) {
    return (int)launch_unit<MODE, PRO>(grid, args, s);
  }
  int sums(const float* part, float* lo, float* hi, int groups, int cols,
           int half) {
    return (int)sum_groups(part, lo, hi, groups, cols, half, s);
  }
};

bool bad_shape(int M, int K, int N) {
  return M < 1 || K < 32 || N < 32 || K % 32 || N % 32 ||
         (M + BM - 1) / BM > 65535 || (N + BM - 1) / BM > 65535;
}

// A split of `inner` rows into `splits` chunks of `chunk`, a multiple of
// the k-step, whose scratch is given when there is more than one.
bool bad_split(int inner, int chunk, int splits, const void* scratch) {
  return chunk < BK || chunk % BK || splits < 1 || splits > 65535 ||
         (inner + chunk - 1) / chunk != splits ||
         (splits > 1 && scratch == nullptr);
}

}  // namespace

extern "C" {

// Forward: y [M, N] bf16, s1 and s2 [N] f32. part is f32 scratch of
// ceil(M / 128) x 2N. x [M, K], w [N, K], a and b [K]: bf16, contiguous,
// 16-byte aligned; K and N multiples of 32. a and b are read only with the
// prologue.
int ag_conv_bn_fwd_bf16(const void* x, const void* a, const void* b,
                        const void* w, void* y, void* part, void* s1, void* s2,
                        int M, int K, int N, int prologue, void* stream) {
  if (bad_shape(M, K, N)) return (int)cudaErrorInvalidValue;
  StreamRun run{(cudaStream_t)stream};
  const auto args = [&](auto seq) {
    return seq(run, (const bf16*)x, (const bf16*)a, (const bf16*)b,
               (const bf16*)w, y, (float*)part, (float*)s1, (float*)s2, M, K,
               N);
  };
  return prologue ? args(fwd_sequence<true, StreamRun>)
                  : args(fwd_sequence<false, StreamRun>);
}

// Backward from (dy [M, N] bf16, ds1, ds2 [N] f32) and the forward's y:
// dx [M, K] bf16, da and db [K] f32, dw [N, K] f32. Scratch: dyt [M, N] bf16
// (written by the DZ product, read by DW), part f32 ceil(M / 128) x 2K,
// dz_part f32 dz_splits x M x K when dz_splits > 1, and dw_part f32
// splits x N x K when splits > 1 (null otherwise). DZ runs over dz_splits
// chunks of dz_chunk columns of N, the weight gradient over `splits` chunks
// of `chunk` rows of M (multiples of 32; splits == ceil(M / chunk),
// dz_splits == ceil(N / dz_chunk)).
int ag_conv_bn_bwd_bf16(const void* x, const void* a, const void* b,
                        const void* w, const void* y, const void* dy,
                        const void* ds1, const void* ds2, void* dyt, void* dx,
                        void* part, void* da, void* db, void* dz_part,
                        void* dw_part, void* dw, int M, int K, int N,
                        int prologue, int chunk, int splits, int dz_chunk,
                        int dz_splits, void* stream) {
  if (bad_shape(M, K, N) || bad_split(M, chunk, splits, dw_part) ||
      bad_split(N, dz_chunk, dz_splits, dz_part))
    return (int)cudaErrorInvalidValue;
  StreamRun run{(cudaStream_t)stream};
  const auto args = [&](auto seq) {
    return seq(run, (const bf16*)x, (const bf16*)a, (const bf16*)b,
               (const bf16*)w, (const bf16*)y, (const bf16*)dy,
               (const float*)ds1, (const float*)ds2, (bf16*)dyt, dx,
               (float*)part, (float*)da, (float*)db, (float*)dz_part,
               (float*)dw_part, (float*)dw, M, K, N, chunk, splits, dz_chunk,
               dz_splits);
  };
  return prologue ? args(bwd_sequence<true, StreamRun>)
                  : args(bwd_sequence<false, StreamRun>);
}

}  // extern "C"
