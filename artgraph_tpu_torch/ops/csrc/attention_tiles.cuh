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
// The windowed cores (Swin's shifted windows) have helpers of their own at
// the end (Win*, win_*): a block owns whole windows of one head, ceil(N/16)
// warps of 16 rows, the keys in 16-key chunks, a ring of window tiles and
// the head's f32 bias resident in dynamic shared memory. They add to the
// scaled scores a per-head f32 bias [H, N, N] and the shift mask, -100
// between tokens of different regions, from int32 region ids [nW, N] (image
// b takes row b mod nW): timm's attn_mask without its [nW, N, N] loads.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ptx_helpers.cuh"

namespace attn {

using namespace ptx;

constexpr int TILE = 64;       // rows of a query or key tile
constexpr int STAGE = 32;      // rows of a streamed tile in the cp.async ring
constexpr int WARPS = 4;       // each owns 16 rows of the block's tile
constexpr int THREADS = WARPS * 32;
// The windowed cores take windows of at most WIN_MAX_N tokens, one warp a
// WIN_CHUNK rows, at one head dim, Swin's (ViT's D = 64 blocks take the
// two-pass cores).
constexpr int WIN_CHUNK = 16;
constexpr int WIN_MAX_N = 160;  // 10 warps; Swin's 12x12 windows are 144
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

// ---- The windowed cores ----
//
// A block owns whole windows of one head: ceil(N / WIN_CHUNK) warps, warp w
// the window's rows 16w..16w+15 (queries; keys in dK/dV), and walks a run of
// consecutive windows. The keys (queries in dK/dV) go in 16-row chunks: one
// m16n8k16 k-step of P V, two n-tiles of Q K^T. R = 16 ceil(N / 16) rows
// and keys are computed: N at Swin's 144.

// What the windowed cores add to the scaled scores: bias [H, N, N] f32
// (query row, key column; its key-major copy for dK/dV), and the shift
// regions [nW, N] int32 of window b's row b mod nW; either may be null.
constexpr float MASKED = -100.f;  // timm's score between shift regions
struct Additive {
  const float* bias;
  const int* regions;
  int nW;
};

__host__ __device__ inline int win_rows(int N) {
  return (N + WIN_CHUNK - 1) / WIN_CHUNK * WIN_CHUNK;
}

// Windows a run: about this many blocks of (run, head) a launch, one an SM
// of the H100 (132): a block holds more than half an SM's shared memory.
constexpr int WIN_BLOCKS = 132;
inline int win_per_run(int B, int H) {
  const long long per = ((long long)B * H + WIN_BLOCKS - 1) / WIN_BLOCKS;
  return per < 1 ? 1 : (int)per;
}

// A windowed block's dynamic shared memory: the head's f32 bias [N][bias_ld]
// (stays for the run), then a ring of two slots, each TILES bf16 tiles
// [R][LDT] of a window, its region ids [R] and STATS f32 rows [R] (dK/dV:
// each query's m, l, d_row). bias_ld = R + 8 keeps a float2 read of 4 lanes
// x 8 rows on distinct banks and every chunk's columns inside the row.
template <int D, int TILES, int STATS>
struct WinSmem {
  static constexpr int LDT = Head<D>::LDT;
  static __host__ __device__ int bias_ld(int N) { return win_rows(N) + 8; }
  static __host__ __device__ int slot_bytes(int N) {
    return win_rows(N) * (TILES * LDT * (int)sizeof(bf16) + (1 + STATS) * 4);
  }
  static __host__ __device__ int bytes(int N) {
    return N * bias_ld(N) * 4 + 2 * slot_bytes(N);
  }

  float* bias;
  unsigned char* ring;
  int R, slot;

  __device__ WinSmem(unsigned char* p, int N)
      : bias(reinterpret_cast<float*>(p)),
        ring(p + N * bias_ld(N) * 4),
        R(win_rows(N)),
        slot(slot_bytes(N)) {}
  __device__ bf16* tile(int s, int t) const {
    return reinterpret_cast<bf16*>(ring + s * slot) + t * R * LDT;
  }
  __device__ int* regions(int s) const {
    return reinterpret_cast<int*>(tile(s, TILES));
  }
  __device__ float* stats(int s, int w) const {
    return reinterpret_cast<float*>(regions(s) + R) + w * R;
  }
};

// cp.async of window b's rows [0, R) of one head of a [B*N, ld] operand
// into a shared tile [R][LDT]; rows >= N are zero-filled. The block's
// threads, whatever their number, share the 16-byte vectors.
template <int D>
__device__ __forceinline__ void win_load(bf16* dst, Rows r, int b, int h,
                                         int N, int R) {
  constexpr int V = Head<D>::VECS, LDT = Head<D>::LDT;
  const bf16* base = head_rows<D>(r, b, h, N);
  for (int v = threadIdx.x; v < R * V; v += blockDim.x) {
    const int row = v >> Head<D>::VSHIFT, c = (v & (V - 1)) * 8;
    const bool ok = row < N;
    cp_async16(dst + row * LDT + c, base + (size_t)(ok ? row : 0) * r.ld + c,
               ok);
  }
}

// cp.async of window b's region ids [R] (zero past N); nothing without
// regions.
__device__ __forceinline__ void win_load_regions(int* dst, const Additive& ad,
                                                 int b, int N, int R) {
  if (!ad.regions) return;
  const int* src = ad.regions + (size_t)(b % ad.nW) * N;
  for (int i = threadIdx.x; i < R; i += blockDim.x)
    cp_async4(dst + i, src + (i < N ? i : 0), i < N);
}

// cp.async of head h's bias [N][N] f32 into [N][ld] (16-byte copies where
// a row is whole vectors); nothing without a bias.
__device__ __forceinline__ void win_load_bias(float* dst, const float* bias,
                                              int h, int N, int ld) {
  if (!bias) return;
  const float* src = bias + (size_t)h * N * N;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  for (int r = warp; r < N; r += warps) {
    if ((N & 3) == 0) {
      for (int c = 4 * lane; c < N; c += 128)
        cp_async16(dst + r * ld + c, src + (size_t)r * N + c, true);
    } else {
      for (int c = lane; c < N; c += 32)
        cp_async4(dst + r * ld + c, src + (size_t)r * N + c, true);
    }
  }
}

// The lane's two rows (g, g + 8 of the warp's 16, clamped to the window:
// rows >= N are computed and never stored) in the shared bias, or null.
struct WinRows {
  const float* b0;
  const float* b1;
  int r0, r1;
};
__device__ __forceinline__ WinRows win_rows_of(const float* bias, int ld,
                                               bool has_bias, int row0,
                                               int N) {
  const int g = (threadIdx.x & 31) >> 2;
  const int r0 = min(row0 + g, N - 1), r1 = min(row0 + g + 8, N - 1);
  return {has_bias ? bias + r0 * ld : nullptr,
          has_bias ? bias + r1 * ld : nullptr, r0, r1};
}

// s = ((s * scale) + bias) + mask on this warp's 16 rows x the chunk's 16
// columns c0.. (accumulator layout): rw's bias rows (null: none), rid the
// window's shared region ids (null: no mask), rr0 and rr1 the regions of
// the lane's two rows. A lane's columns come in adjacent pairs, read as
// float2 and int2 from shared memory. Columns >= N read padding; the
// caller's mask_tail overwrites them.
__device__ __forceinline__ void win_scores(float (&s)[2][4], int c0,
                                           float scale, const WinRows& rw,
                                           const int* rid, int rr0,
                                           int rr1) {
  const int col = c0 + 2 * (threadIdx.x & 3);
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    const int k = col + nt * 8;
    int2 kv = {0, 0};
    if (rid) kv = *reinterpret_cast<const int2*>(rid + k);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float& x0 = s[nt][2 * hf];
      float& x1 = s[nt][2 * hf + 1];
      x0 = __fmul_rn(x0, scale);
      x1 = __fmul_rn(x1, scale);
      if (rw.b0) {
        const float2 bv =
            *reinterpret_cast<const float2*>((hf ? rw.b1 : rw.b0) + k);
        x0 = __fadd_rn(x0, bv.x);
        x1 = __fadd_rn(x1, bv.y);
      }
      if (rid) {
        const int rr = hf ? rr1 : rr0;
        if (kv.x != rr) x0 = __fadd_rn(x0, MASKED);
        if (kv.y != rr) x1 = __fadd_rn(x1, MASKED);
      }
    }
  }
}

// A warp's 16 x R scores of one window in registers, NCH chunks of 16 keys
// (chunks >= `chunks` untouched): s = Q K^T scaled, plus the bias and the
// mask, keys >= N at -inf; then e = exp(s - m) in place, with each row's
// exact max m and sum l = sum e over all its keys (the quad's lanes).
template <int D, int NCH>
__device__ __forceinline__ void win_exp_scores(
    float (&sc)[NCH][2][4], float (&m)[2], float (&l)[2], const bf16* sQ,
    const bf16* sK, int row0, int chunks, int N, float scale,
    const WinRows& rw, const int* rid, int rr0, int rr1) {
  constexpr int LDT = Head<D>::LDT;
  uint32_t qf[Head<D>::KC][4];
  load_a<D>(qf, sQ, row0);
  m[0] = m[1] = -INFINITY;
  l[0] = l[1] = 0.f;
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    if (c >= chunks) continue;
    zero(sc[c]);
    mma_abt<D>(sc[c], qf, sK + c * WIN_CHUNK * LDT);
    win_scores(sc[c], c * WIN_CHUNK, scale, rw, rid, rr0, rr1);
    mask_tail(sc[c], c * WIN_CHUNK, N, -INFINITY);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) m[e >> 1] = fmaxf(m[e >> 1], sc[c][nt][e]);
  }
  m[0] = quad_max(m[0]);
  m[1] = quad_max(m[1]);
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    if (c >= chunks) continue;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[c][nt][e] = expf(sc[c][nt][e] - m[e >> 1]);
        l[e >> 1] += sc[c][nt][e];
      }
  }
  l[0] = quad_sum(l[0]);
  l[1] = quad_sum(l[1]);
}

// A probability to be rounded to bf16: e / l (__fdiv_rn), or 0 where e <
// 2^-134, whose quotient (l >= 1) rounds to bf16 0 as well, so that
// bf16(win_p(e, l)) = bf16(__fdiv_rn(e, l)) bit for bit. A masked key's e ~
// exp(-100) gives a subnormal quotient, which sends __fdiv_rn to its slow
// path, a called routine; such an e is divided as 1 instead and its
// quotient dropped, so the divide stays on its fast path without a branch.
__device__ __forceinline__ float win_p(float e, float l) {
  const bool zero = e < 0x1p-134f;
  const float q = __fdiv_rn(zero ? 1.f : e, l);
  return zero ? 0.f : q;
}

#ifdef __CUDACC__
// Lets `kernel` take `bytes` of dynamic shared memory (past the 48 KB a
// launch gets unasked), once a device: `ready` is the caller's mask of the
// devices done. A process's first launch of a kernel is an eager one, before
// any graph capture.
template <class Kernel>
inline cudaError_t opt_in_smem(Kernel kernel, int bytes,
                               unsigned long long& ready) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && (ready >> dev & 1)) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess && dev < 64) ready |= 1ull << dev;
  return err;
}
#endif

}  // namespace attn
