// Tile machinery shared by the attention cores (block_attention.cu,
// block_attention_bwd.cu): 64-row bf16 tiles of one head (D = 64 or 32, a
// template parameter) staged in shared memory by cp.async, and warp-level
// products on the tensor cores with mma.sync m16n8k16 (bf16 in, f32
// accumulate), over the PTX helpers of ptx_helpers.cuh (whose note gives the
// fragment layouts).
//
// A warp's 16 x 8NT f32 accumulator is float[NT][4], n-tile nt holding
// columns 8nt..8nt+7 (NT = 8: 64 columns). Its columns 16kc..16kc+15 are, as
// bf16 pairs, exactly the A fragment of k-chunk kc of the next product
// (pack_a): probabilities and score gradients go from one product to the
// next without shared memory.
//
// The windowed cores (Swin's shifted windows) add to the scaled scores
// before the softmax a per-head f32 bias [H, N, N] and the shift mask, -100
// between tokens of different regions, from int32 region ids [nW, N] (image
// b takes row b mod nW): timm's attn_mask without its [nW, N, N] loads
// (Additive, add_scores).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ptx_helpers.cuh"

namespace attn {

using namespace ptx;

constexpr int TILE = 64;       // rows of a query or key tile
constexpr int STAGE = 32;      // rows of a streamed tile in the cp.async ring
constexpr int WARPS = 4;       // each owns 16 rows of the block's tile
constexpr int THREADS = WARPS * 32;
// The windowed cores hold a whole window's keys: at most this many stages.
constexpr int WIN_STAGES = 5;
constexpr int WIN_MAX_N = WIN_STAGES * STAGE;  // 160: Swin's 12x12 fits
// ... and are built at one head dim, Swin's (ViT's D = 64 blocks take the
// two-pass cores).
constexpr int WIN_D = 32;

// The shapes of one head dim D (64 or 32: the ones built).
template <int D>
struct Head {
  static_assert(D == 64 || D == 32, "head dims 64 and 32 are built");
  // Shared-memory row stride in bf16: 144 bytes at D = 64, 80 at 32, so
  // the 8 rows an ldmatrix phase reads fall on 8 different 16-byte bank
  // groups.
  static constexpr int LDT = D + 8;
  static constexpr int TILE_ELEMS = TILE * LDT;
  static constexpr int KC = D / 16;   // 16-column chunks of a row
  static constexpr int NT = D / 8;    // 8-column n-tiles of a row
  static constexpr int VECS = D / 8;  // 16-byte vectors of a row
  static constexpr int VSHIFT = D == 64 ? 3 : 2;  // log2(VECS)
};

using bf16 = __nv_bfloat16;

// Shapes the entry points refuse: a head dim other than the one built for
// them (64 for ViT's cores, 32 for the windowed ones), or a grid dimension
// out of range (grid = (tiles, H, B)).
inline bool bad_shape(int B, int N, int H, int Dh, int built = 64) {
  return Dh != built || N < 1 || B < 1 || H < 1 ||
         B > 65535 || H > 65535;
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// One head's rows of a [B*N, ld] row-major bf16 operand: row n of image b
// at base + (b*N + n) * ld + h*D.
struct Rows {
  const bf16* p;
  int ld;
};

template <int D>
__device__ __forceinline__ const bf16* head_rows(Rows r, int b, int h,
                                                 int N) {
  return r.p + (size_t)b * N * r.ld + (size_t)h * D;
}

// Issues the cp.async copies of rows [r0, r0 + ROWS) of `base` (row stride
// ld) into a ROWS x LDT shared tile; rows >= N are zero-filled.
template <int D, int ROWS = TILE>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* base, int ld,
                                          int r0, int N) {
  constexpr int V = Head<D>::VECS, LDT = Head<D>::LDT;
  constexpr int VECS = ROWS * V;  // 16-byte vectors
  static_assert(VECS % THREADS == 0, "whole vectors a thread");
#pragma unroll
  for (int i = 0; i < VECS / THREADS; ++i) {
    const int v = threadIdx.x + i * THREADS, r = v >> Head<D>::VSHIFT,
              c = (v & (V - 1)) * 8;
    const bool ok = r0 + r < N;
    cp_async16(dst + r * LDT + c, base + (size_t)(ok ? r0 + r : 0) * ld + c,
               ok);
  }
}

// A fragments of this warp's 16 rows (row0..row0+15) of a shared tile,
// all D/16 16-column chunks.
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&a)[Head<D>::KC][4],
                                       const bf16* tile, int row0) {
  constexpr int LDT = Head<D>::LDT;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kc = 0; kc < Head<D>::KC; ++kc)
    ldsm_x4(a[kc], tile + (row0 + (lane & 15)) * LDT + kc * 16 +
                       (lane >> 4) * 8);
}

template <int NT>
__device__ __forceinline__ void zero(float (&c)[NT][4]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[nt][e] = 0.f;
}

// c[16 x 8NT] += A[16 x D] . X^T, X a shared tile read as [n][k] (rows
// are the output columns): Q K^T, K Q^T, dO V^T, V dO^T.
template <int D, int NT>
__device__ __forceinline__ void mma_abt(float (&c)[NT][4],
                                        const uint32_t (&a)[Head<D>::KC][4],
                                        const bf16* x) {
  constexpr int LDT = Head<D>::LDT;
  const int lane = threadIdx.x & 31;
  const bf16* p =
      x + ((lane & 7) + ((lane >> 4) << 3)) * LDT + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kc = 0; kc < Head<D>::KC; ++kc)
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b[4];
      ldsm_x4(b, p + np * 16 * LDT + kc * 16);
      mma_bf16(c[2 * np], a[kc], b[0], b[1]);
      mma_bf16(c[2 * np + 1], a[kc], b[2], b[3]);
    }
}

// c[16 x D] += A[16 x 16KC] . X, X a shared tile read as [k][n]: P V,
// P^T dO, dS^T Q, dS K.
template <int D, int KC>
__device__ __forceinline__ void mma_ab(float (&c)[Head<D>::NT][4],
                                       const uint32_t (&a)[KC][4],
                                       const bf16* x) {
  constexpr int LDT = Head<D>::LDT;
  const int lane = threadIdx.x & 31;
  const bf16* p = x + (lane & 15) * LDT + (lane >> 4) * 8;
#pragma unroll
  for (int kc = 0; kc < KC; ++kc)
#pragma unroll
    for (int np = 0; np < Head<D>::NT / 2; ++np) {
      uint32_t b[4];
      ldsm_x4_trans(b, p + kc * 16 * LDT + np * 16);
      mma_bf16(c[2 * np], a[kc], b[0], b[1]);
      mma_bf16(c[2 * np + 1], a[kc], b[2], b[3]);
    }
}

// The 16 x 16KC values v (accumulator layout) as bf16 A fragments.
template <int KC>
__device__ __forceinline__ void pack_a(uint32_t (&a)[KC][4],
                                       const float (&v)[2 * KC][4]) {
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    a[kc][0] = pack_bf16(v[2 * kc][0], v[2 * kc][1]);
    a[kc][1] = pack_bf16(v[2 * kc][2], v[2 * kc][3]);
    a[kc][2] = pack_bf16(v[2 * kc + 1][0], v[2 * kc + 1][1]);
    a[kc][3] = pack_bf16(v[2 * kc + 1][2], v[2 * kc + 1][3]);
  }
}

// Column of accumulator element (nt, e) within its tile, and its row
// within the warp's 16.
__device__ __forceinline__ int acc_col(int nt, int e) {
  return nt * 8 + (threadIdx.x & 3) * 2 + (e & 1);
}
__device__ __forceinline__ int acc_row(int e) {
  return ((threadIdx.x & 31) >> 2) + (e >> 1) * 8;
}

// Sets the columns col0 + c >= N of the accumulator to v: the ragged last
// tile of a walk (a warp-uniform test; full tiles return at once).
template <int NT>
__device__ __forceinline__ void mask_tail(float (&c)[NT][4], int col0, int N,
                                          float v) {
  if (col0 + NT * 8 <= N) return;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (col0 + acc_col(nt, e) >= N) c[nt][e] = v;
}

// What the windowed cores add to the scaled scores: bias [H, N, N] f32
// (query row, key column; the key-major copy for phase 2), and the shift
// regions [nW, N] int32 of image b's window b mod nW; either may be null.
constexpr float MASKED = -100.f;  // timm's score between shift regions
struct Additive {
  const float* bias;
  const int* regions;
  int nW;
};

// s = (s + bias) + mask on this warp's 16 x 8NT scores of image b, head h,
// mask = MASKED where the two tokens' regions differ, else 0: accumulator
// row r is token row0 + r and column c token col0 + c of bias[h] (the
// transposed bias for the transposed scores K Q^T). A thread's two columns
// 2t, 2t + 1 are adjacent, so for even N (Swin's 144) the bias and the
// region ids come as float2 and int2 loads. Rows >= N read row N - 1 (they
// are never stored); columns >= N add nothing (mask_tail sets them after).
template <int NT>
__device__ __forceinline__ void add_scores(float (&c)[NT][4],
                                           const Additive& ad, int b, int h,
                                           int row0, int col0, int N) {
  const float* bias = ad.bias ? ad.bias + (size_t)h * N * N : nullptr;
  const int* rid = ad.regions ? ad.regions + (size_t)(b % ad.nW) * N
                              : nullptr;
  const bool pairs = (N & 1) == 0;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {  // rows g and g + 8
    const int r = min(row0 + acc_row(2 * hf), N - 1);
    const int rr = rid ? __ldg(rid + r) : 0;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = col0 + acc_col(nt, 0);  // even; col + 1 beside it
      if (col >= N) continue;
      float2 bv = make_float2(0.f, 0.f);
      int2 kv = {rr, rr};
      if (pairs) {
        if (bias)
          bv = __ldg(reinterpret_cast<const float2*>(bias + (size_t)r * N +
                                                      col));
        if (rid) kv = __ldg(reinterpret_cast<const int2*>(rid + col));
      } else {
        const bool two = col + 1 < N;
        if (bias) {
          bv.x = __ldg(bias + (size_t)r * N + col);
          if (two) bv.y = __ldg(bias + (size_t)r * N + col + 1);
        }
        if (rid) {
          kv.x = __ldg(rid + col);
          if (two) kv.y = __ldg(rid + col + 1);
        }
      }
      float& c0 = c[nt][2 * hf];
      float& c1 = c[nt][2 * hf + 1];
      if (bias) {
        c0 = __fadd_rn(c0, bv.x);
        c1 = __fadd_rn(c1, bv.y);
      }
      if (kv.x != rr) c0 = __fadd_rn(c0, MASKED);
      if (kv.y != rr) c1 = __fadd_rn(c1, MASKED);
    }
  }
}

// Max / sum over the 4 lanes of a quad, which together hold a full row.
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Writes this warp's 16 x D f32 values c, rounded to bf16, to rows
// row0 + r < N of `base` (stride ld), staged through the warp's 16 rows of
// the shared tile `stage` for 16-byte stores.
template <int D>
__device__ __forceinline__ void store_rows(const float (&c)[Head<D>::NT][4],
                                           bf16* stage, int warp_row,
                                           bf16* base, int ld, int row0,
                                           int N) {
  constexpr int LDT = Head<D>::LDT, V = Head<D>::VECS;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int nt = 0; nt < Head<D>::NT; ++nt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      *reinterpret_cast<uint32_t*>(
          stage + (warp_row + acc_row(2 * hf)) * LDT + acc_col(nt, 0)) =
          pack_bf16(c[nt][2 * hf], c[nt][2 * hf + 1]);
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 16 * V / 32; ++i) {
    const int v = lane + i * 32, r = v >> Head<D>::VSHIFT,
              col = (v & (V - 1)) * 8;
    const int n = row0 + warp_row + r;
    if (n < N)
      *reinterpret_cast<uint4*>(base + (size_t)n * ld + col) =
          *reinterpret_cast<const uint4*>(stage + (warp_row + r) * LDT + col);
  }
}

}  // namespace attn
