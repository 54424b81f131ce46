// Backward of the multi-head attention core, in two instantiations of one
// pair of kernels.
//
// Recomputed o (block path, ag_attention_core_bwd_bf16): d(qkv) from the
// fused qkv tensor and the gradient of the attention output. Replaces the
// per-head backward inside the Pallas kernel
// artgraph_tpu/ops/attention.py:_block_bwd_kernel (:409-426).
// ops/attention.py wraps it between the recomputed forward, the do . W_proj
// GEMM and the dqkv . W_qkv GEMM (csrc/block_gemm.cu). Its reference reads
// d_row from o = f32(p . v), recomputed in f32.
//
// Saved o (SAVED_O, ag_attention_bwd_bf16): q, k, v, the forward's bf16
// output o, do and dq, dk, dv as [B*N, ld] row-major views, head h at column
// h*D of each row (the fused qkv and dqkv tensors are the case ld = 3C,
// offsets 0, C, 2C). Replaces the Pallas kernels
// artgraph_tpu/ops/attention.py:_bwd_kernel (fused_attention, :61) and
// _qkv_bwd_kernel (fused_qkv_attention, :209), whose d_row reads the saved
// bf16 o (:82-83, :237-238).
//
// Rounding points are the Pallas kernels'. For each query row: s = f32(q.k)
// * scale, exact max m and sum l over the N keys, p = bf16(exp(s - m) / l),
// dp = f32(do . v), ds = bf16(p * (dp - d_row) * scale); then dq = ds . k,
// dk = ds^T . q, dv = p^T . do, each summed in f32 over all N rows and
// rounded to bf16 once.
//
// Design: three phases in two launches. A block of 4 warps owns one 64-row
// tile (16 rows a warp), which stays in shared memory; the other operand
// streams through a two-stage cp.async ring in 32-row stages; every
// product is an mma.sync with register accumulators (attention_tiles.cuh).
// Shared memory is 36-37 KB whatever N is. No atomics: every gradient row
// is summed in f32 inside one block in a fixed order and rounded once, so
// results are bit-identical from run to run.
//  1. Row statistics (attention_bwd_dq_kernel, blocks over image, head and
//     64-query tile, Q and dO resident). One walk of the key stages gives m
//     and l, merged across stages as in the forward's pass 1. d_row: saved
//     o, sum_d f32(do) f32(o); block path, a second walk: sum_j p_j dp_j
//     with dp = f32(do . v), the same sum as sum_d do_d (sum_j p_j v_jd)
//     taken in another order. m, l and d_row go to an f32 [3, B, H, N]
//     scratch for phase 2.
//  3. dQ (the same blocks, a last walk of the key stages): S, P, dP = dO V^T
//     and dS again, dQ += dS K.
//  2. dK and dV (attention_bwd_dkv_kernel, blocks over image, head and
//     64-key tile, K and V resident) walk the query stages with their
//     statistics. S^T = K Q^T puts P^T in accumulator layout: P^T =
//     bf16(exp(s - m) / l), dV += P^T dO, dP^T = V dO^T, dS^T = bf16(P^T
//     (dP^T - d_row) scale), dK += dS^T Q.
//
// What bounds it on an H100: at ViT-B/16 (B = 32, N = 197, H = 12, D = 64)
// the four backward products are 7.6 GFLOP (0.008 ms at 989 TFLOP/s) on
// 77.5 MB of q, k, v, o, do, dq, dk, dv (0.023 ms at 3.35 TB/s): bytes. The
// recomputed Q K^T (twice in phases 1 and 3, once in phase 2) and dO V^T
// (twice, plus once more on the block path) roughly double the products,
// which the tensor cores absorb; by estimate the exp / divide work per
// score, done in both launches, and occupancy (registers) set the pace.
// 1536 blocks a launch, 5 (phases 1, 3) and 4 (phase 2) resident per SM.
#include "attention_tiles.cuh"

#include <math.h>

namespace {

using namespace attn;

struct BwdArgs {
  Rows q, k, v, o, dout;  // o: the saved output (SAVED_O only)
  bf16 *dq, *dk, *dv;
  int ld_dq, ld_dk, ld_dv;
};

// Phases 1 and 3 for one (image, head, 64-query tile). The Q and dO tile
// stays in shared memory and the key tiles come through the ring 32 rows at
// a time, so the f32 dQ accumulator, one 16 x 32 score tile and its
// operands fit in 96 registers with no spill: 5 blocks an SM.
template <bool SAVED_O>
__global__ void __launch_bounds__(THREADS, 5)
attention_bwd_dq_kernel(BwdArgs a, float* __restrict__ stats, int N, int H,
                        float scale) {
  __shared__ __align__(128) bf16 qdo[2][TILE_ELEMS];  // [Q, dO]
  __shared__ __align__(128) bf16 ring[2][2][STAGE * LDT];  // [slot][K, V]
  const int q0 = blockIdx.x * TILE, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = warp * 16;
  const bf16* kb = head_rows(a.k, b, h, N);
  const bf16* vb = head_rows(a.v, b, h, N);
  const int T = (N + STAGE - 1) / STAGE;
  // walks of the key tiles: (m, l), [d_row,] dQ
  constexpr int PASSES = SAVED_O ? 2 : 3;

  auto issue = [&](int s) {
    const int pass = s / T, j = s - pass * T;
    load_tile<STAGE>(ring[s & 1][0], kb, a.k.ld, j * STAGE, N);
    if (pass > 0) load_tile<STAGE>(ring[s & 1][1], vb, a.v.ld, j * STAGE, N);
    cp_async_commit();
  };

  load_tile(qdo[0], head_rows(a.q, b, h, N), a.q.ld, q0, N);
  load_tile(qdo[1], head_rows(a.dout, b, h, N), a.dout.ld, q0, N);
  issue(0);

  float m[2] = {-INFINITY, -INFINITY};  // rows g, g + 8 of the warp
  float l[2] = {0.f, 0.f};
  float drow[2] = {0.f, 0.f};
  float dq[8][4];
  zero(dq);
  for (int s = 0; s < PASSES * T; ++s) {
    if (s + 1 < PASSES * T) {
      issue(s + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (SAVED_O && s == 0) {
      // d_row = sum_d f32(do) f32(o): two lanes a row, 32 columns each
      const int r = lane >> 1, c0 = (lane & 1) * 32, n = q0 + row0 + r;
      float sum = 0.f;
      if (n < N) {
        const bf16* orow = head_rows(a.o, b, h, N) + (size_t)n * a.o.ld + c0;
        const bf16* dorow = qdo[1] + (row0 + r) * LDT + c0;
#pragma unroll
        for (int c = 0; c < 32; c += 8) {
          const uint4 ov = *reinterpret_cast<const uint4*>(orow + c);
          const uint4 dv = *reinterpret_cast<const uint4*>(dorow + c);
          const uint32_t ow[4] = {ov.x, ov.y, ov.z, ov.w};
          const uint32_t dw[4] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
            sum += bf16_lo(dw[i]) * bf16_lo(ow[i]) +
                   bf16_hi(dw[i]) * bf16_hi(ow[i]);
        }
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      const int g = lane >> 2;
      drow[0] = __shfl_sync(0xffffffffu, sum, 2 * g);
      drow[1] = __shfl_sync(0xffffffffu, sum, 2 * (g + 8));
    }
    const int pass = s / T, k0 = (s - pass * T) * STAGE;
    const bf16* sK = ring[s & 1][0];
    uint32_t qf[4][4];
    load_a(qf, qdo[0], row0);
    float sc[4][4];  // this warp's 16 queries x the stage's 32 keys
    zero(sc);
    mma_abt(sc, qf, sK);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = __fmul_rn(sc[nt][e], scale);
    mask_tail(sc, k0, N, -INFINITY);

    if (pass == 0) {  // (m, l), merged across tiles
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mt = -INFINITY;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mt = fmaxf(mt, fmaxf(sc[nt][2 * r], sc[nt][2 * r + 1]));
        const float mn = fmaxf(m[r], quad_max(mt));
        float sum = 0.f;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          sum += expf(sc[nt][2 * r] - mn) + expf(sc[nt][2 * r + 1] - mn);
        l[r] = l[r] * expf(m[r] - mn) + sum;
        m[r] = mn;
      }
      if (s == T - 1) {
        l[0] = quad_sum(l[0]);
        l[1] = quad_sum(l[1]);
      }
    } else {
      // p = bf16(exp(s - m) / l), 0 on keys >= N; dP = dO V^T
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sc[nt][e] = round_bf16(
              __fdiv_rn(expf(sc[nt][e] - m[e >> 1]), l[e >> 1]));
      uint32_t dof[4][4];
      load_a(dof, qdo[1], row0);
      float dp[4][4];
      zero(dp);
      mma_abt(dp, dof, ring[s & 1][1]);
      if (!SAVED_O && pass == 1) {  // d_row = sum_j p_j dp_j
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) drow[e >> 1] += sc[nt][e] * dp[nt][e];
        if (s == 2 * T - 1) {
          drow[0] = quad_sum(drow[0]);
          drow[1] = quad_sum(drow[1]);
        }
      } else {  // dS = bf16(p (dp - d_row) scale), dQ += dS K
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dp[nt][e] = sc[nt][e] * (dp[nt][e] - drow[e >> 1]) * scale;
        uint32_t dsf[2][4];
        pack_a(dsf, dp);
        mma_ab(dq, dsf, sK);
      }
    }
    __syncthreads();
  }

  if ((lane & 3) == 0) {
    const size_t plane = (size_t)gridDim.z * H * N;
    float* row_stats = stats + ((size_t)b * H + h) * N;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int n = q0 + row0 + acc_row(2 * r);
      if (n < N) {
        row_stats[n] = m[r];
        row_stats[plane + n] = l[r];
        row_stats[2 * plane + n] = drow[r];
      }
    }
  }
  store_rows(dq, qdo[0], row0,
             a.dq + (size_t)b * N * a.ld_dq + (size_t)h * D, a.ld_dq, q0, N);
}

// Phase 2 for one (image, head, 64-key tile). The K and V tile stays in
// shared memory and the query tiles come through the ring 32 rows at a time,
// so the f32 dK and dV accumulators, one 16 x 32 score tile and its
// operands fit in 128 registers with no spill: 4 blocks an SM (at 96
// registers it spills and timed slower on the H100).
__global__ void __launch_bounds__(THREADS, 4)
attention_bwd_dkv_kernel(BwdArgs a, const float* __restrict__ stats, int N,
                         int H, float scale) {
  __shared__ __align__(128) bf16 kv[2][TILE_ELEMS];  // [K, V]
  __shared__ __align__(128) bf16 ring[2][2][STAGE * LDT];  // [slot][Q, dO]
  __shared__ float st[2][3][STAGE];  // [slot][m, l, d_row] of the rows
  const int k0 = blockIdx.x * TILE, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, row0 = warp * 16;
  const bf16* qb = head_rows(a.q, b, h, N);
  const bf16* dob = head_rows(a.dout, b, h, N);
  const size_t plane = (size_t)gridDim.z * H * N;
  const float* row_stats = stats + ((size_t)b * H + h) * N;
  const int T = (N + STAGE - 1) / STAGE;

  auto issue = [&](int i) {
    load_tile<STAGE>(ring[i & 1][0], qb, a.q.ld, i * STAGE, N);
    load_tile<STAGE>(ring[i & 1][1], dob, a.dout.ld, i * STAGE, N);
    if (threadIdx.x < 3 * STAGE) {
      const int w = threadIdx.x / STAGE, r = threadIdx.x - w * STAGE;
      const int n = i * STAGE + r;
      cp_async4(&st[i & 1][w][r], row_stats + w * plane + (n < N ? n : 0),
                n < N);
    }
    cp_async_commit();
  };

  load_tile(kv[0], head_rows(a.k, b, h, N), a.k.ld, k0, N);
  load_tile(kv[1], head_rows(a.v, b, h, N), a.v.ld, k0, N);
  issue(0);

  float dk[8][4], dv[8][4];
  zero(dk);
  zero(dv);
  for (int i = 0; i < T; ++i) {
    if (i + 1 < T) {
      issue(i + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* sQ = ring[i & 1][0];
    const bf16* sdO = ring[i & 1][1];
    const float* sm = st[i & 1][0];
    const float* sl = st[i & 1][1];
    const float* sd = st[i & 1][2];
    uint32_t kf[4][4];
    load_a(kf, kv[0], row0);
    float sc[4][4];  // S^T: this warp's 16 keys x the stage's 32 queries
    zero(sc);
    mma_abt(sc, kf, sQ);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = acc_col(nt, e);
        sc[nt][e] = round_bf16(
            __fdiv_rn(expf(__fmul_rn(sc[nt][e], scale) - sm[c]), sl[c]));
      }
    // queries >= N (their m, l are zero-filled)
    mask_tail(sc, i * STAGE, N, 0.f);
    uint32_t pf[2][4];
    pack_a(pf, sc);
    mma_ab(dv, pf, sdO);
    uint32_t vf[4][4];
    load_a(vf, kv[1], row0);
    float dp[4][4];  // dP^T = V dO^T
    zero(dp);
    mma_abt(dp, vf, sdO);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[nt][e] = sc[nt][e] * (dp[nt][e] - sd[acc_col(nt, e)]) * scale;
    uint32_t dsf[2][4];
    pack_a(dsf, dp);
    mma_ab(dk, dsf, sQ);
    __syncthreads();
  }

  store_rows(dk, kv[0], row0,
             a.dk + (size_t)b * N * a.ld_dk + (size_t)h * D, a.ld_dk, k0, N);
  store_rows(dv, kv[1], row0,
             a.dv + (size_t)b * N * a.ld_dv + (size_t)h * D, a.ld_dv, k0, N);
}

template <bool SAVED_O>
int launch(const BwdArgs& a, float* stats, int B, int N, int H, float scale,
           void* stream) {
  const dim3 grid((N + TILE - 1) / TILE, H, B);
  attention_bwd_dq_kernel<SAVED_O>
      <<<grid, THREADS, 0, (cudaStream_t)stream>>>(a, stats, N, H, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attention_bwd_dkv_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      a, stats, N, H, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// qkv: [B*N, 3*H*D] bf16 (the forward's, columns ordered qkv-slot, head,
// dim); dout: [B*N, H*D] bf16, the gradient of the attention output;
// dqkv: [B*N, 3*H*D] bf16, every element written; stats: f32 scratch of
// 3*B*H*N. Only D = 64 is built.
int ag_attention_core_bwd_bf16(const void* qkv, const void* dout, void* dqkv,
                               void* stats, int B, int N, int H, int Dh,
                               float scale, void* stream) {
  if (bad_shape(B, N, H, Dh)) return (int)cudaErrorInvalidValue;
  const int C = H * D;
  const bf16* p = (const bf16*)qkv;
  bf16* g = (bf16*)dqkv;
  const BwdArgs a{{p, 3 * C},     {p + C, 3 * C}, {p + 2 * C, 3 * C},
                  {nullptr, 0},   {(const bf16*)dout, C},
                  g,              g + C,          g + 2 * C,
                  3 * C,          3 * C,          3 * C};
  return launch<false>(a, (float*)stats, B, N, H, scale, stream);
}

// q, k, v, o (the forward's bf16 output), dout, dq, dk, dv: [B*N, ld_*] bf16
// row-major, head h at columns [h*D, h*D+D) of a row; each pointer 16-byte
// aligned and each ld_* a multiple of 8 (checked by the caller); every
// element of dq, dk and dv at a head column of a valid row is written.
// stats: f32 scratch of 3*B*H*N. Only D = 64 is built.
int ag_attention_bwd_bf16(const void* q, const void* k, const void* v,
                          const void* o, const void* dout, void* dq, void* dk,
                          void* dv, void* stats, int B, int N, int H, int Dh,
                          int ld_q, int ld_k, int ld_v, int ld_o, int ld_do,
                          int ld_dq, int ld_dk, int ld_dv, float scale,
                          void* stream) {
  if (bad_shape(B, N, H, Dh)) return (int)cudaErrorInvalidValue;
  const BwdArgs a{{(const bf16*)q, ld_q}, {(const bf16*)k, ld_k},
                  {(const bf16*)v, ld_v}, {(const bf16*)o, ld_o},
                  {(const bf16*)dout, ld_do}, (bf16*)dq, (bf16*)dk,
                  (bf16*)dv, ld_dq, ld_dk, ld_dv};
  return launch<true>(a, (float*)stats, B, N, H, scale, stream);
}

}  // extern "C"
