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
// Design. The Pallas kernels walk M sequentially and carry s1/s2, da/db and
// dW in VMEM accumulators. Blocks here run in no order, so nothing carries
// across the grid:
//   * the forward is one bf16 tensor-core GEMM (NT) whose A tile passes
//     through the prologue as it is staged into shared memory, and whose
//     epilogue rounds y, stores it and reduces the tile's per-column sums of
//     y and y^2 over its rows into one f32 partial row per 128-row tile; a
//     second small pass adds the partial rows in tile order;
//   * the backward forms dyt once ([M, N] bf16, an elementwise pass), then
//     dz = dyt . W (NN) with an epilogue that recomputes the prologue's ReLU
//     mask from x, a and b, writes dx and the per-column partials of da and
//     db (merged as above); then dW = dyt^T . z (TN) with the prologue on the
//     z tile, its M rows split into chunks so that even a 64x64 output fills
//     the card (one block per 128x128 tile over all of M would leave one
//     block on 132 SMs at layer1's M = 100352), each chunk writing an f32
//     partial dW merged in chunk order by the same second pass.
// No atomics: every result is bit-identical from call to call.
//
// What bounds it on an H100: at ResNet50's shapes the products are small in
// K or N (64 to 2048), so most units move more bytes than they compute (at
// layer1, M = 100352, K = 64, N = 256: ~50 FLOP a byte against the card's
// ~295) and device memory bounds them; only layer4's widest units
// (K x N = 512 x 2048) are bound by the tensor cores. This first version is
// deliberately simple, the GEMM of block_gemm.cu restated: 128x128x32 block
// tiles filled by 16-byte loads, nvcuda::wmma 16x16x16 bf16 fragments with
// f32 accumulation, 8 warps each owning a 64x32 tile, the epilogue staged
// through a per-warp 16x16 f32 tile. No cp.async pipelining, no wgmma/TMA:
// later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

using namespace nvcuda;

namespace {

constexpr int BM = 128, BN = 128, BK = 32;
constexpr int LDS = BK + 8;   // [128][32] tile row stride (bf16)
constexpr int LDT = BM + 8;   // [32][128] tile row stride (bf16)
constexpr int TILE_ELEMS = BM * LDS > BK * LDT ? BM * LDS : BK * LDT;
constexpr int THREADS = 256;
constexpr int WARP_M = 64, WARP_N = 32;  // 2 x 4 warps over the 128x128 tile
constexpr int FRAG_M = WARP_M / 16, FRAG_N = WARP_N / 16;
constexpr int SUM_X = 32, SUM_Y = 16;    // second pass: columns x row groups
constexpr int EW_THREADS = 256;

// The three products of the unit, out[rows, cols] = sum_i A(r, i) B(i, c):
//   FWD: y [M, N]  = z . W^T:   A = x [M, K] (prologue), B = W [N, K]
//   DZ:  dx [M, K] from dyt . W: A = dyt [M, N],         B = W [N, K]
//   DW:  dW [N, K] = dyt^T . z: A = dyt [M, N] (k-major), B = x [M, K]
//        (k-major, prologue), over one chunk of M per blockIdx.z
enum Mode { MODE_FWD = 0, MODE_DZ = 1, MODE_DW = 2 };

// 8 bf16 of x through the prologue with their 8 channels' a and b (16-byte
// aligned): bf16(max(x * a + b, 0)) in f32, multiply and add rounded apart.
__device__ __forceinline__ uint4 prologue8(uint4 xv,
                                           const __nv_bfloat16* __restrict__ a,
                                           const __nv_bfloat16* __restrict__ b) {
  const uint4 av = *reinterpret_cast<const uint4*>(a);
  const uint4 bv = *reinterpret_cast<const uint4*>(b);
  const __nv_bfloat16* xe = reinterpret_cast<const __nv_bfloat16*>(&xv);
  const __nv_bfloat16* ae = reinterpret_cast<const __nv_bfloat16*>(&av);
  const __nv_bfloat16* be = reinterpret_cast<const __nv_bfloat16*>(&bv);
  uint4 out;
  __nv_bfloat16* oe = reinterpret_cast<__nv_bfloat16*>(&out);
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const float zf = __fadd_rn(
        __fmul_rn(__bfloat162float(xe[e]), __bfloat162float(ae[e])),
        __bfloat162float(be[e]));
    oe[e] = __float2bfloat16(fmaxf(zf, 0.f));
  }
  return out;
}

// A [128][32] tile of a row-major [rows, ld] operand: rows r0.. (zero at or
// beyond row_lim), columns k0..k0+31 (ld % 32 == 0, so no column check).
template <bool PRO>
__device__ __forceinline__ void load_rows(
    const __nv_bfloat16* __restrict__ src, int ld, int r0, int row_lim,
    int k0, const __nv_bfloat16* __restrict__ pa,
    const __nv_bfloat16* __restrict__ pb, __nv_bfloat16* s, int tid) {
  for (int v = tid; v < BM * BK / 8; v += THREADS) {
    const int r = v / (BK / 8), c = (v % (BK / 8)) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < row_lim) {
      val = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * ld +
                                            k0 + c);
      if (PRO) val = prologue8(val, pa + k0 + c, pb + k0 + c);
    }
    *reinterpret_cast<uint4*>(s + r * LDS + c) = val;
  }
}

// A [32][128] tile of a k-major [inner, ld] operand: inner rows k0.. (zero
// at or beyond k_lim), columns c0.. (zero at or beyond col_lim, a multiple
// of 8). With the prologue the column is the channel.
template <bool PRO>
__device__ __forceinline__ void load_kmajor(
    const __nv_bfloat16* __restrict__ src, int ld, int k0, int k_lim, int c0,
    int col_lim, const __nv_bfloat16* __restrict__ pa,
    const __nv_bfloat16* __restrict__ pb, __nv_bfloat16* s, int tid) {
  for (int v = tid; v < BK * BM / 8; v += THREADS) {
    const int kr = v / (BM / 8), kc = (v % (BM / 8)) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (k0 + kr < k_lim && c0 + kc < col_lim) {
      val = *reinterpret_cast<const uint4*>(src + (size_t)(k0 + kr) * ld +
                                            c0 + kc);
      if (PRO) val = prologue8(val, pa + c0 + kc, pb + c0 + kc);
    }
    *reinterpret_cast<uint4*>(s + kr * LDT + kc) = val;
  }
}

// One 128x128 output tile of a product of the unit (see Mode). FWD and DZ
// (with the prologue) also write the tile's per-column partial sums,
// part[blockIdx.y][2 * cols]: (y, y^2) for FWD, (dzf * x, dzf) for DZ.
// Two blocks per SM: at most 128 registers a thread.
template <int MODE, bool PRO>
__global__ void __launch_bounds__(THREADS, 2)
unit_gemm_kernel(const __nv_bfloat16* __restrict__ A,
                 const __nv_bfloat16* __restrict__ Bm,
                 const __nv_bfloat16* __restrict__ x,
                 const __nv_bfloat16* __restrict__ pa,
                 const __nv_bfloat16* __restrict__ pb, void* __restrict__ out,
                 float* __restrict__ part, int rows, int cols, int inner,
                 int chunk) {
  constexpr bool A_KMAJOR = MODE == MODE_DW;
  constexpr bool B_KMAJOR = MODE != MODE_FWD;
  constexpr bool STATS = MODE == MODE_FWD || (MODE == MODE_DZ && PRO);
  using ALayout = std::conditional_t<A_KMAJOR, wmma::col_major,
                                     wmma::row_major>;
  using BLayout = std::conditional_t<B_KMAJOR, wmma::row_major,
                                     wmma::col_major>;
  __shared__ __align__(128) __nv_bfloat16 sA[TILE_ELEMS];
  __shared__ __align__(128) __nv_bfloat16 sB[TILE_ELEMS];
  __shared__ __align__(128) float stage[THREADS / 32][16 * 16];
  __shared__ float colpart[BM / WARP_M][2][BN];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp / (BN / WARP_N), wn = warp % (BN / WARP_N);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  int kbeg = 0, kend = inner;
  if (MODE == MODE_DW) {
    kbeg = blockIdx.z * chunk;
    kend = min(inner, kbeg + chunk);
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FRAG_M][FRAG_N];
#pragma unroll
  for (int i = 0; i < FRAG_M; ++i)
#pragma unroll
    for (int j = 0; j < FRAG_N; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = kbeg; k0 < kend; k0 += BK) {
    if constexpr (MODE == MODE_FWD) {
      load_rows<PRO>(A, inner, m0, rows, k0, pa, pb, sA, tid);
      load_rows<false>(Bm, inner, n0, cols, k0, nullptr, nullptr, sB, tid);
    } else if constexpr (MODE == MODE_DZ) {
      load_rows<false>(A, inner, m0, rows, k0, nullptr, nullptr, sA, tid);
      load_kmajor<false>(Bm, cols, k0, kend, n0, cols, nullptr, nullptr, sB,
                         tid);
    } else {
      load_kmajor<false>(A, rows, k0, kend, m0, rows, nullptr, nullptr, sA,
                         tid);
      load_kmajor<PRO>(Bm, cols, k0, kend, n0, cols, pa, pb, sB, tid);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, ALayout>
          fa[FRAG_M];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, BLayout>
          fb[FRAG_N];
#pragma unroll
      for (int i = 0; i < FRAG_M; ++i) {
        const int m = wm * WARP_M + i * 16;
        // A^T stored [k][m], read column-major, is A
        wmma::load_matrix_sync(fa[i], A_KMAJOR ? sA + kk * LDT + m
                                               : sA + m * LDS + kk,
                               A_KMAJOR ? LDT : LDS);
      }
#pragma unroll
      for (int j = 0; j < FRAG_N; ++j) {
        const int n = wn * WARP_N + j * 16;
        // W[n][k] read as a K x N column-major matrix is W^T
        wmma::load_matrix_sync(fb[j], B_KMAJOR ? sB + kk * LDT + n
                                               : sB + n * LDS + kk,
                               B_KMAJOR ? LDT : LDS);
      }
#pragma unroll
      for (int i = 0; i < FRAG_M; ++i)
#pragma unroll
        for (int j = 0; j < FRAG_N; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

  // Epilogue. Lane l handles element e = l + 32 t of each 16x16 tile: row
  // (l >> 4) + 2t, column l & 15, so each lane sums one column over half of
  // the warp's rows and lanes l, l ^ 16 hold the two halves.
  float v1[FRAG_N], v2[FRAG_N];
#pragma unroll
  for (int j = 0; j < FRAG_N; ++j) v1[j] = v2[j] = 0.f;
  float* st = stage[warp];
#pragma unroll
  for (int i = 0; i < FRAG_M; ++i) {
#pragma unroll
    for (int j = 0; j < FRAG_N; ++j) {
      wmma::store_matrix_sync(st, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int rbase = m0 + wm * WARP_M + i * 16;
      const int cbase = n0 + wn * WARP_N + j * 16;
      for (int e = lane; e < 256; e += 32) {
        const int r = rbase + (e >> 4), c = cbase + (e & 15);
        if (r < rows && c < cols) {
          const size_t o = (size_t)r * cols + c;
          const float accv = st[e];
          if constexpr (MODE == MODE_FWD) {
            const __nv_bfloat16 yb = __float2bfloat16(accv);
            static_cast<__nv_bfloat16*>(out)[o] = yb;
            const float yf = __bfloat162float(yb);
            v1[j] += yf;
            v2[j] += yf * yf;
          } else if constexpr (MODE == MODE_DZ) {
            if constexpr (PRO) {
              const float xf = __bfloat162float(x[o]);
              const float af = __bfloat162float(pa[c]);
              const float zf = __fadd_rn(__fmul_rn(xf, af),
                                         __bfloat162float(pb[c]));
              const float dzf = zf > 0.f ? accv : 0.f;
              static_cast<__nv_bfloat16*>(out)[o] =
                  __float2bfloat16(__fmul_rn(dzf, af));
              v1[j] += dzf * xf;
              v2[j] += dzf;
            } else {
              static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16(accv);
            }
          } else {
            static_cast<float*>(out)[(size_t)blockIdx.z * rows * cols + o] =
                accv;
          }
        }
      }
      __syncwarp();
    }
  }

  if constexpr (STATS) {
#pragma unroll
    for (int j = 0; j < FRAG_N; ++j) {
      v1[j] += __shfl_xor_sync(0xffffffffu, v1[j], 16);
      v2[j] += __shfl_xor_sync(0xffffffffu, v2[j], 16);
      if (lane < 16) {
        colpart[wm][0][wn * WARP_N + j * 16 + lane] = v1[j];
        colpart[wm][1][wn * WARP_N + j * 16 + lane] = v2[j];
      }
    }
    __syncthreads();
    const int c = n0 + tid;
    if (tid < BN && c < cols) {
      float* p = part + (size_t)blockIdx.y * 2 * cols;
      p[c] = colpart[0][0][tid] + colpart[1][0][tid];
      p[cols + c] = colpart[0][1][tid] + colpart[1][1][tid];
    }
  }
}

// out[c] = sum_g part[g][c] over the groups in a fixed order: each of SUM_Y
// threads of a column adds every SUM_Y-th group, then one adds the SUM_Y
// sums in order. Columns below `half` go to lo[c], the rest to hi[c - half].
__global__ void __launch_bounds__(SUM_X * SUM_Y)
sum_groups_kernel(const float* __restrict__ part, float* __restrict__ lo,
                  float* __restrict__ hi, int groups, int cols, int half) {
  __shared__ float sm[SUM_Y][SUM_X];
  const int c = blockIdx.x * SUM_X + threadIdx.x;
  float s = 0.f;
  if (c < cols)
    for (int g = threadIdx.y; g < groups; g += SUM_Y)
      s += part[(size_t)g * cols + c];
  sm[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && c < cols) {
    float t = 0.f;
#pragma unroll
    for (int y = 0; y < SUM_Y; ++y) t += sm[y][threadIdx.x];
    if (c < half)
      lo[c] = t;
    else
      hi[c - half] = t;
  }
}

cudaError_t sum_groups(const float* part, float* lo, float* hi, int groups,
                       int cols, int half, cudaStream_t s) {
  sum_groups_kernel<<<(cols + SUM_X - 1) / SUM_X, dim3(SUM_X, SUM_Y), 0, s>>>(
      part, lo, hi, groups, cols, half);
  return cudaGetLastError();
}

// dyt = bf16(f32(dy) + ds1 + 2 f32(y) ds2), 8 elements a thread (N % 8 == 0,
// so the 8 share a row); the adds and products rounded apart, as the plain
// version computes them.
__global__ void __launch_bounds__(EW_THREADS)
dyt_kernel(const __nv_bfloat16* __restrict__ dy,
           const __nv_bfloat16* __restrict__ y, const float* __restrict__ ds1,
           const float* __restrict__ ds2, __nv_bfloat16* __restrict__ dyt,
           size_t n8, int N) {
  for (size_t v = (size_t)blockIdx.x * EW_THREADS + threadIdx.x; v < n8;
       v += (size_t)gridDim.x * EW_THREADS) {
    const size_t e0 = v * 8;
    const int c0 = (int)(e0 % N);
    const uint4 dv = *reinterpret_cast<const uint4*>(dy + e0);
    const uint4 yv = *reinterpret_cast<const uint4*>(y + e0);
    const __nv_bfloat16* de = reinterpret_cast<const __nv_bfloat16*>(&dv);
    const __nv_bfloat16* ye = reinterpret_cast<const __nv_bfloat16*>(&yv);
    uint4 out;
    __nv_bfloat16* oe = reinterpret_cast<__nv_bfloat16*>(&out);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float t = __fadd_rn(
          __fadd_rn(__bfloat162float(de[e]), ds1[c0 + e]),
          __fmul_rn(__fmul_rn(2.f, __bfloat162float(ye[e])), ds2[c0 + e]));
      oe[e] = __float2bfloat16(t);
    }
    *reinterpret_cast<uint4*>(dyt + e0) = out;
  }
}

template <int MODE, bool PRO>
cudaError_t launch_unit(dim3 grid, const void* A, const void* Bm,
                        const void* x, const void* a, const void* b, void* out,
                        float* part, int rows, int cols, int inner, int chunk,
                        cudaStream_t s) {
  unit_gemm_kernel<MODE, PRO><<<grid, THREADS, 0, s>>>(
      (const __nv_bfloat16*)A, (const __nv_bfloat16*)Bm,
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)a,
      (const __nv_bfloat16*)b, out, part, rows, cols, inner, chunk);
  return cudaGetLastError();
}

bool bad_shape(int M, int K, int N) {
  return M < 1 || K < 32 || N < 32 || K % 32 || N % 32 ||
         (M + BM - 1) / BM > 65535;
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
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  cudaError_t err =
      prologue ? launch_unit<MODE_FWD, true>(grid, x, w, nullptr, a, b, y,
                                             (float*)part, M, N, K, 0, s)
               : launch_unit<MODE_FWD, false>(grid, x, w, nullptr, a, b, y,
                                              (float*)part, M, N, K, 0, s);
  if (err != cudaSuccess) return (int)err;
  return (int)sum_groups((const float*)part, (float*)s1, (float*)s2, grid.y,
                         2 * N, N, s);
}

// Backward from (dy [M, N] bf16, ds1, ds2 [N] f32) and the forward's y:
// dx [M, K] bf16, da and db [K] f32, dw [N, K] f32. Scratch: dyt [M, N] bf16,
// part f32 ceil(M / 128) x 2K, and dw_part f32 splits x N x K when
// splits > 1 (null otherwise). The weight gradient runs over `splits` chunks
// of `chunk` rows (a multiple of 32; splits == ceil(M / chunk)).
int ag_conv_bn_bwd_bf16(const void* x, const void* a, const void* b,
                        const void* w, const void* y, const void* dy,
                        const void* ds1, const void* ds2, void* dyt, void* dx,
                        void* part, void* da, void* db, void* dw_part,
                        void* dw, int M, int K, int N, int prologue, int chunk,
                        int splits, void* stream) {
  if (bad_shape(M, K, N) || chunk < BK || chunk % BK || splits < 1 ||
      splits > 65535 || (M + chunk - 1) / chunk != splits ||
      (splits > 1 && dw_part == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t n8 = (size_t)M * N / 8;
  const unsigned ew_blocks =
      (unsigned)(n8 / EW_THREADS + 1 < 132 * 16 ? n8 / EW_THREADS + 1
                                                : 132 * 16);
  dyt_kernel<<<ew_blocks, EW_THREADS, 0, s>>>(
      (const __nv_bfloat16*)dy, (const __nv_bfloat16*)y, (const float*)ds1,
      (const float*)ds2, (__nv_bfloat16*)dyt, n8, N);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const dim3 gdz((K + BN - 1) / BN, (M + BM - 1) / BM);
  err = prologue
            ? launch_unit<MODE_DZ, true>(gdz, dyt, w, x, a, b, dx,
                                         (float*)part, M, K, N, 0, s)
            : launch_unit<MODE_DZ, false>(gdz, dyt, w, x, a, b, dx,
                                          (float*)part, M, K, N, 0, s);
  if (err != cudaSuccess) return (int)err;
  if (prologue) {
    err = sum_groups((const float*)part, (float*)da, (float*)db, gdz.y, 2 * K,
                     K, s);
  } else {
    err = cudaMemsetAsync(da, 0, sizeof(float) * K, s);
    if (err == cudaSuccess) err = cudaMemsetAsync(db, 0, sizeof(float) * K, s);
  }
  if (err != cudaSuccess) return (int)err;

  const dim3 gdw((K + BN - 1) / BN, (N + BM - 1) / BM, splits);
  void* dw_out = splits > 1 ? dw_part : dw;
  err = prologue ? launch_unit<MODE_DW, true>(gdw, dyt, x, nullptr, a, b,
                                              dw_out, nullptr, N, K, M, chunk,
                                              s)
                 : launch_unit<MODE_DW, false>(gdw, dyt, x, nullptr, a, b,
                                               dw_out, nullptr, N, K, M,
                                               chunk, s);
  if (err != cudaSuccess || splits == 1) return (int)err;
  return (int)sum_groups((const float*)dw_part, (float*)dw, nullptr, splits,
                         N * K, N * K, s);
}

}  // extern "C"
