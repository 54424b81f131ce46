// Tile machinery shared by the attention cores (block_attention.cu,
// block_attention_bwd.cu): 64-row bf16 tiles of one head (D = 64) staged in
// shared memory by cp.async, and warp-level products on the tensor cores
// with mma.sync m16n8k16 (bf16 in, f32 accumulate).
//
// Fragment layouts (PTX ISA, mma.m16n8k16 .bf16; g = lane / 4, t = lane % 4):
//   A 16x16, 4 registers of 2 bf16: {row g, cols 2t..2t+1}, {row g+8, cols
//     2t..}, {row g, cols 8+2t..}, {row g+8, cols 8+2t..};
//   B 16x8, 2 registers: {k 2t..2t+1, col g}, {k 8+2t.., col g};
//   C 16x8 f32: {row g, cols 2t, 2t+1}, {row g+8, cols 2t, 2t+1}.
// A warp's 16 x 8NT f32 accumulator is float[NT][4], n-tile nt holding
// columns 8nt..8nt+7 (NT = 8: 64 columns). Its columns 16kc..16kc+15 are, as
// bf16 pairs, exactly the A fragment of k-chunk kc of the next product
// (pack_a): probabilities and score gradients go from one product to the
// next without shared memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace attn {

constexpr int D = 64;          // head dim, the only one built
constexpr int TILE = 64;       // rows of a query or key tile
constexpr int STAGE = 32;      // rows of a streamed tile in the cp.async ring
constexpr int WARPS = 4;       // each owns 16 rows of the block's tile
constexpr int THREADS = WARPS * 32;
// Shared-memory row stride in bf16: 144 bytes, so the 8 rows an ldmatrix
// phase reads fall on 8 different 16-byte bank groups.
constexpr int LDT = D + 8;
constexpr int TILE_ELEMS = TILE * LDT;

using bf16 = __nv_bfloat16;

// Shapes the entry points refuse: a head dim other than D, or a grid
// dimension out of range (grid = (tiles, H, B)).
inline bool bad_shape(int B, int N, int H, int Dh) {
  return Dh != D || N < 1 || B < 1 || H < 1 || B > 65535 || H > 65535;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; !valid writes 16 zero bytes instead (the
// source address must still be a mapped one).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

// 4-byte global -> shared copy (row statistics); !valid writes zeros.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// bf16(lo) in the low half, bf16(hi) in the high half (round to nearest).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// The two bf16 of a packed pair as f32 (exact).
__device__ __forceinline__ float bf16_lo(uint32_t u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t u) {
  return __uint_as_float(u & 0xffff0000u);
}

// One head's rows of a [B*N, ld] row-major bf16 operand: row n of image b
// at base + (b*N + n) * ld + h*D.
struct Rows {
  const bf16* p;
  int ld;
};

__device__ __forceinline__ const bf16* head_rows(Rows r, int b, int h,
                                                 int N) {
  return r.p + (size_t)b * N * r.ld + (size_t)h * D;
}

// Issues the cp.async copies of rows [r0, r0 + ROWS) of `base` (row stride
// ld) into a ROWS x LDT shared tile; rows >= N are zero-filled.
template <int ROWS = TILE>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* base, int ld,
                                          int r0, int N) {
  constexpr int VECS = ROWS * D / 8;  // 16-byte vectors
#pragma unroll
  for (int i = 0; i < VECS / THREADS; ++i) {
    const int v = threadIdx.x + i * THREADS, r = v >> 3, c = (v & 7) * 8;
    const bool ok = r0 + r < N;
    cp_async16(dst + r * LDT + c, base + (size_t)(ok ? r0 + r : 0) * ld + c,
               ok);
  }
}

// A fragments of this warp's 16 rows (row0..row0+15) of a shared tile,
// all four 16-column chunks.
__device__ __forceinline__ void load_a(uint32_t (&a)[4][4], const bf16* tile,
                                       int row0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kc = 0; kc < 4; ++kc)
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

// c[16 x 8NT] += A[16 x 64] . X^T, X a shared tile read as [n][k] (rows
// are the output columns): Q K^T, K Q^T, dO V^T, V dO^T.
template <int NT>
__device__ __forceinline__ void mma_abt(float (&c)[NT][4],
                                        const uint32_t (&a)[4][4],
                                        const bf16* x) {
  const int lane = threadIdx.x & 31;
  const bf16* p =
      x + ((lane & 7) + ((lane >> 4) << 3)) * LDT + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kc = 0; kc < 4; ++kc)
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b[4];
      ldsm_x4(b, p + np * 16 * LDT + kc * 16);
      mma_bf16(c[2 * np], a[kc], b[0], b[1]);
      mma_bf16(c[2 * np + 1], a[kc], b[2], b[3]);
    }
}

// c[16 x 64] += A[16 x 16KC] . X, X a shared tile read as [k][n]: P V,
// P^T dO, dS^T Q, dS K.
template <int KC>
__device__ __forceinline__ void mma_ab(float (&c)[8][4],
                                       const uint32_t (&a)[KC][4],
                                       const bf16* x) {
  const int lane = threadIdx.x & 31;
  const bf16* p = x + (lane & 15) * LDT + (lane >> 4) * 8;
#pragma unroll
  for (int kc = 0; kc < KC; ++kc)
#pragma unroll
    for (int np = 0; np < 4; ++np) {
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

// Column of accumulator element (nt, e) within its 64-column tile, and its
// row within the warp's 16.
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

// Max / sum over the 4 lanes of a quad, which together hold a full row.
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Writes this warp's 16 x 64 f32 values c, rounded to bf16, to rows
// row0 + r < N of `base` (stride ld), staged through the warp's 16 rows of
// the shared tile `stage` for 16-byte stores.
__device__ __forceinline__ void store_rows(const float (&c)[8][4],
                                           bf16* stage, int warp_row,
                                           bf16* base, int ld, int row0,
                                           int N) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      *reinterpret_cast<uint32_t*>(
          stage + (warp_row + acc_row(2 * hf)) * LDT + acc_col(nt, 0)) =
          pack_bf16(c[nt][2 * hf], c[nt][2 * hf + 1]);
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 16 * 8 / 32; ++i) {
    const int v = lane + i * 32, r = v >> 3, col = (v & 7) * 8;
    const int n = row0 + warp_row + r;
    if (n < N)
      *reinterpret_cast<uint4*>(base + (size_t)n * ld + col) =
          *reinterpret_cast<const uint4*>(stage + (warp_row + r) * LDT + col);
  }
}

}  // namespace attn
