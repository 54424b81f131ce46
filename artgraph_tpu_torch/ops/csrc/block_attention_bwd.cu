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
// Windowed (ag_window_attention_bwd_bf16): the recomputed-o path on
// [B*nW, N, C] windows at head dim 32 (the kernels are written over D;
// only D = 32 is built), with the forward's bias
// [H, N, N] and the shift mask (int32 region ids [nW, N]) added to the
// scores in every phase
// (window_bwd_dq_kernel<D>, window_bwd_dkv_kernel<D>), and the bias's
// gradient dBias[h, i, j] = sum over the windows of p (dp - d_row), in f32,
// unrounded. Windows have at most WIN_MAX_N = 160 tokens, so phases 1 and 3
// (window_bwd_dq_kernel) hold a window's K and V in shared memory and a
// row's p in registers and make one pass (see the kernel); d_row is then
// sum_d do_d o_d with o = f32(p . v), the reference's own sum. A block runs
// a run of `per_run` consecutive windows one after another and adds each
// window's dS into the run's own f32 partial [runs, H, N, N] (each element
// owned by one thread, the windows in order); sum_groups.cuh then adds the
// runs in a fixed order. No atomics: dBias is bit-identical from run to run
// too.
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
#include "sum_groups.cuh"

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
  __shared__ __align__(128) bf16 qdo[2][Head<64>::TILE_ELEMS];  // [Q, dO]
  // [slot][K, V]
  __shared__ __align__(128) bf16 ring[2][2][STAGE * Head<64>::LDT];
  const int q0 = blockIdx.x * TILE, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = warp * 16;
  const bf16* kb = head_rows<64>(a.k, b, h, N);
  const bf16* vb = head_rows<64>(a.v, b, h, N);
  const int T = (N + STAGE - 1) / STAGE;
  // walks of the key tiles: (m, l), [d_row,] dQ
  constexpr int PASSES = SAVED_O ? 2 : 3;

  auto issue = [&](int s) {
    const int pass = s / T, j = s - pass * T;
    load_tile<64, STAGE>(ring[s & 1][0], kb, a.k.ld, j * STAGE, N);
    if (pass > 0)
      load_tile<64, STAGE>(ring[s & 1][1], vb, a.v.ld, j * STAGE, N);
    cp_async_commit();
  };

  load_tile<64>(qdo[0], head_rows<64>(a.q, b, h, N), a.q.ld, q0, N);
  load_tile<64>(qdo[1], head_rows<64>(a.dout, b, h, N), a.dout.ld, q0, N);
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
        const bf16* orow =
            head_rows<64>(a.o, b, h, N) + (size_t)n * a.o.ld + c0;
        const bf16* dorow = qdo[1] + (row0 + r) * Head<64>::LDT + c0;
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
    load_a<64>(qf, qdo[0], row0);
    float sc[4][4];  // this warp's 16 queries x the stage's 32 keys
    zero(sc);
    mma_abt<64>(sc, qf, sK);
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
      load_a<64>(dof, qdo[1], row0);
      float dp[4][4];
      zero(dp);
      mma_abt<64>(dp, dof, ring[s & 1][1]);
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
        mma_ab<64>(dq, dsf, sK);
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
  store_rows<64>(dq, qdo[0], row0,
             a.dq + (size_t)b * N * a.ld_dq + (size_t)h * 64, a.ld_dq, q0, N);
}

// Phase 2 for one (image, head, 64-key tile). The K and V tile stays in
// shared memory and the query tiles come through the ring 32 rows at a time,
// so the f32 dK and dV accumulators, one 16 x 32 score tile and its
// operands fit in 128 registers with no spill: 4 blocks an SM (at 96
// registers it spills and timed slower on the H100).
__global__ void __launch_bounds__(THREADS, 4)
attention_bwd_dkv_kernel(BwdArgs a, const float* __restrict__ stats, int N,
                         int H, float scale) {
  __shared__ __align__(128) bf16 kv[2][Head<64>::TILE_ELEMS];  // [K, V]
  // [slot][Q, dO]
  __shared__ __align__(128) bf16 ring[2][2][STAGE * Head<64>::LDT];
  __shared__ float st[2][3][STAGE];  // [slot][m, l, d_row] of the rows
  const int k0 = blockIdx.x * TILE, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, row0 = warp * 16;
  const bf16* qb = head_rows<64>(a.q, b, h, N);
  const bf16* dob = head_rows<64>(a.dout, b, h, N);
  const size_t plane = (size_t)gridDim.z * H * N;
  const float* row_stats = stats + ((size_t)b * H + h) * N;
  const int T = (N + STAGE - 1) / STAGE;

  auto issue = [&](int i) {
    load_tile<64, STAGE>(ring[i & 1][0], qb, a.q.ld, i * STAGE, N);
    load_tile<64, STAGE>(ring[i & 1][1], dob, a.dout.ld, i * STAGE, N);
    if (threadIdx.x < 3 * STAGE) {
      const int w = threadIdx.x / STAGE, r = threadIdx.x - w * STAGE;
      const int n = i * STAGE + r;
      cp_async4(&st[i & 1][w][r], row_stats + w * plane + (n < N ? n : 0),
                n < N);
    }
    cp_async_commit();
  };

  load_tile<64>(kv[0], head_rows<64>(a.k, b, h, N), a.k.ld, k0, N);
  load_tile<64>(kv[1], head_rows<64>(a.v, b, h, N), a.v.ld, k0, N);
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
    load_a<64>(kf, kv[0], row0);
    float sc[4][4];  // S^T: this warp's 16 keys x the stage's 32 queries
    zero(sc);
    mma_abt<64>(sc, kf, sQ);
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
    mma_ab<64>(dv, pf, sdO);
    uint32_t vf[4][4];
    load_a<64>(vf, kv[1], row0);
    float dp[4][4];  // dP^T = V dO^T
    zero(dp);
    mma_abt<64>(dp, vf, sdO);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[nt][e] = sc[nt][e] * (dp[nt][e] - sd[acc_col(nt, e)]) * scale;
    uint32_t dsf[2][4];
    pack_a(dsf, dp);
    mma_ab<64>(dk, dsf, sQ);
    __syncthreads();
  }

  store_rows<64>(dk, kv[0], row0,
             a.dk + (size_t)b * N * a.ld_dk + (size_t)h * 64, a.ld_dk, k0, N);
  store_rows<64>(dv, kv[1], row0,
             a.dv + (size_t)b * N * a.ld_dv + (size_t)h * 64, a.ld_dv, k0, N);
}

// Where the windowed phases 1 and 3 add dS: the f32 partial [runs, H, N, N]
// (null: no bias, no gradient), per_run windows a run of B.
struct BiasGrad {
  float* part;
  int per_run, B;
};

// Dynamic shared memory of window_bwd_dq_kernel<D>: Q and dO tiles, all of
// K and V.
template <int D>
constexpr int window_dq_smem() {
  return (2 * TILE + 2 * WIN_MAX_N) * Head<D>::LDT * (int)sizeof(bf16);
}

// Phases 1 and 3 of the windowed backward for one (64-query tile, head, run
// of windows [z per_run, (z + 1) per_run)), the windows in turn. A window's
// keys fit the block (at most WIN_STAGES stages), so one pass over them
// gives, as the forward, the exact m and l and p = bf16(exp(s - m) / l) in
// registers; then o = f32(p . v) and d_row = sum_d do_d o_d; then per key
// stage dP = dO V^T, dS = p (dP - d_row), which is added into the run's
// dBias partial (stored for the run's first window, added after; each
// element one thread's), and dQ += bf16(dS scale) K. m, l and d_row go to
// the stats for phase 2.
template <int D>
__global__ void __launch_bounds__(THREADS, 3)
window_bwd_dq_kernel(BwdArgs a, Additive ad, BiasGrad g,
                     float* __restrict__ stats, int N, int H, float scale) {
  constexpr int LDT = Head<D>::LDT;
  AG_DYNAMIC_SMEM(smem_raw);
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sdO = sQ + Head<D>::TILE_ELEMS;
  bf16* sK = sdO + Head<D>::TILE_ELEMS;
  bf16* sV = sK + WIN_MAX_N * LDT;
  const int q0 = blockIdx.x * TILE, h = blockIdx.y;
  const int warp = threadIdx.x >> 5, row0 = warp * 16;
  const int T = (N + STAGE - 1) / STAGE;
  const bool pairs = (N & 1) == 0;  // dBias as float2 (even N)
  const size_t plane = (size_t)g.B * H * N;
  float* part = g.part ? g.part + ((size_t)blockIdx.z * H + h) * N * N
                       : nullptr;
  const int w0 = blockIdx.z * g.per_run, w1 = min(g.B, w0 + g.per_run);
  for (int b = w0; b < w1; ++b) {
    if (b > w0) __syncthreads();  // the last window's stores have read sQ
    load_tile<D>(sQ, head_rows<D>(a.q, b, h, N), a.q.ld, q0, N);
    for (int j = 0; j < T; ++j)
      load_tile<D, STAGE>(sK + j * STAGE * LDT, head_rows<D>(a.k, b, h, N),
                          a.k.ld, j * STAGE, N);
    cp_async_commit();
    load_tile<D>(sdO, head_rows<D>(a.dout, b, h, N), a.dout.ld, q0, N);
    for (int j = 0; j < T; ++j)
      load_tile<D, STAGE>(sV + j * STAGE * LDT, head_rows<D>(a.v, b, h, N),
                          a.v.ld, j * STAGE, N);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    uint32_t qf[Head<D>::KC][4];
    load_a<D>(qf, sQ, row0);
    float p[WIN_STAGES][4][4];  // this warp's 16 queries x every key
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < WIN_STAGES; ++j) {
      if (j >= T) continue;
      zero(p[j]);
      mma_abt<D>(p[j], qf, sK + j * STAGE * LDT);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) p[j][nt][e] = __fmul_rn(p[j][nt][e], scale);
      add_scores(p[j], ad, b, h, q0 + row0, j * STAGE, N);
      mask_tail(p[j], j * STAGE, N, -INFINITY);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) m[e >> 1] = fmaxf(m[e >> 1], p[j][nt][e]);
    }
    m[0] = quad_max(m[0]);
    m[1] = quad_max(m[1]);
#pragma unroll
    for (int j = 0; j < WIN_STAGES; ++j) {
      if (j >= T) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[j][nt][e] = expf(p[j][nt][e] - m[e >> 1]);
          l[e >> 1] += p[j][nt][e];
        }
    }
    l[0] = quad_sum(l[0]);
    l[1] = quad_sum(l[1]);
    cp_async_wait<0>();
    __syncthreads();

    // p rounded; o = f32(p . v); d_row = sum_d do_d o_d
    float o[Head<D>::NT][4];
    zero(o);
#pragma unroll
    for (int j = 0; j < WIN_STAGES; ++j) {
      if (j >= T) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          p[j][nt][e] = round_bf16(__fdiv_rn(p[j][nt][e], l[e >> 1]));
      uint32_t pf[2][4];
      pack_a(pf, p[j]);
      mma_ab<D>(o, pf, sV + j * STAGE * LDT);
    }
    float drow[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < Head<D>::NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        drow[e >> 1] += __bfloat162float(
                            sdO[(row0 + acc_row(e)) * LDT + acc_col(nt, e)]) *
                        o[nt][e];
    drow[0] = quad_sum(drow[0]);
    drow[1] = quad_sum(drow[1]);

    uint32_t dof[Head<D>::KC][4];
    load_a<D>(dof, sdO, row0);
    float dq[Head<D>::NT][4];
    zero(dq);
#pragma unroll
    for (int j = 0; j < WIN_STAGES; ++j) {
      if (j >= T) continue;
      float dp[4][4];  // dP = dO V^T over the stage's 32 keys
      zero(dp);
      mma_abt<D>(dp, dof, sV + j * STAGE * LDT);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {  // rows g, g + 8; keys c, c + 1
          const int e = 2 * hf;
          const float ds0 = p[j][nt][e] * (dp[nt][e] - drow[hf]);
          const float ds1 = p[j][nt][e + 1] * (dp[nt][e + 1] - drow[hf]);
          const int n = q0 + row0 + acc_row(e), c = j * STAGE + acc_col(nt, e);
          if (part && n < N && c < N) {
            float* at = part + (size_t)n * N + c;
            if (pairs) {
              float2* at2 = reinterpret_cast<float2*>(at);
              *at2 = b == w0 ? make_float2(ds0, ds1)
                             : make_float2(at2->x + ds0, at2->y + ds1);
            } else {
              at[0] = b == w0 ? ds0 : at[0] + ds0;
              if (c + 1 < N) at[1] = b == w0 ? ds1 : at[1] + ds1;
            }
          }
          dp[nt][e] = ds0 * scale;
          dp[nt][e + 1] = ds1 * scale;
        }
      uint32_t dsf[2][4];
      pack_a(dsf, dp);
      mma_ab<D>(dq, dsf, sK + j * STAGE * LDT);
    }

    if ((threadIdx.x & 3) == 0) {
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
    // each warp stages its own 16 rows of sQ, which only it read
    store_rows<D>(dq, sQ, row0,
                  a.dq + (size_t)b * N * a.ld_dq + (size_t)h * D, a.ld_dq,
                  q0, N);
  }
}

// Phase 2 of the windowed backward for one (window, head, 64-key tile) at
// head dim D, as attention_bwd_dkv_kernel with the bias (its key-major
// copy, so a row is a key) and mask added to the transposed scores
// S^T = K Q^T.
template <int D>
__device__ __forceinline__ void window_dkv_tile(
    const BwdArgs& a, const Additive& ad, const float* __restrict__ stats,
    int N, int H, float scale, bf16 (*kv)[Head<D>::TILE_ELEMS],
    bf16 (*ring)[2][STAGE * Head<D>::LDT], float (*st)[3][STAGE]) {
  const int k0 = blockIdx.x * TILE, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, row0 = warp * 16;
  const bf16* qb = head_rows<D>(a.q, b, h, N);
  const bf16* dob = head_rows<D>(a.dout, b, h, N);
  const size_t plane = (size_t)gridDim.z * H * N;
  const float* row_stats = stats + ((size_t)b * H + h) * N;
  const int T = (N + STAGE - 1) / STAGE;

  auto issue = [&](int i) {
    load_tile<D, STAGE>(ring[i & 1][0], qb, a.q.ld, i * STAGE, N);
    load_tile<D, STAGE>(ring[i & 1][1], dob, a.dout.ld, i * STAGE, N);
    if (threadIdx.x < 3 * STAGE) {
      const int w = threadIdx.x / STAGE, r = threadIdx.x - w * STAGE;
      const int n = i * STAGE + r;
      cp_async4(&st[i & 1][w][r], row_stats + w * plane + (n < N ? n : 0),
                n < N);
    }
    cp_async_commit();
  };

  load_tile<D>(kv[0], head_rows<D>(a.k, b, h, N), a.k.ld, k0, N);
  load_tile<D>(kv[1], head_rows<D>(a.v, b, h, N), a.v.ld, k0, N);
  issue(0);

  float dk[Head<D>::NT][4], dv[Head<D>::NT][4];
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
    uint32_t kf[Head<D>::KC][4];
    load_a<D>(kf, kv[0], row0);
    float sc[4][4];  // S^T: this warp's 16 keys x the stage's 32 queries
    zero(sc);
    mma_abt<D>(sc, kf, sQ);
    {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[nt][e] = __fmul_rn(sc[nt][e], scale);
      add_scores(sc, ad, b, h, k0 + row0, i * STAGE, N);
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = acc_col(nt, e);
        sc[nt][e] = round_bf16(__fdiv_rn(expf(sc[nt][e] - sm[c]), sl[c]));
      }
    // queries >= N (their m, l are zero-filled)
    mask_tail(sc, i * STAGE, N, 0.f);
    uint32_t pf[2][4];
    pack_a(pf, sc);
    mma_ab<D>(dv, pf, sdO);
    uint32_t vf[Head<D>::KC][4];
    load_a<D>(vf, kv[1], row0);
    float dp[4][4];  // dP^T = V dO^T
    zero(dp);
    mma_abt<D>(dp, vf, sdO);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[nt][e] = sc[nt][e] * (dp[nt][e] - sd[acc_col(nt, e)]) * scale;
    uint32_t dsf[2][4];
    pack_a(dsf, dp);
    mma_ab<D>(dk, dsf, sQ);
    __syncthreads();
  }

  store_rows<D>(dk, kv[0], row0,
                a.dk + (size_t)b * N * a.ld_dk + (size_t)h * D, a.ld_dk, k0,
                N);
  store_rows<D>(dv, kv[1], row0,
                a.dv + (size_t)b * N * a.ld_dv + (size_t)h * D, a.ld_dv, k0,
                N);
}

template <int D>
__global__ void __launch_bounds__(THREADS, 4)
window_bwd_dkv_kernel(BwdArgs a, Additive ad, const float* __restrict__ stats,
                      int N, int H, float scale) {
  __shared__ __align__(128) bf16 kv[2][Head<D>::TILE_ELEMS];  // [K, V]
  __shared__ __align__(128) bf16 ring[2][2][STAGE * Head<D>::LDT];
  __shared__ float st[2][3][STAGE];  // [slot][m, l, d_row] of the rows
  window_dkv_tile<D>(a, ad, stats, N, H, scale, kv, ring, st);
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

// within the 48 KB of dynamic shared memory a launch gets unasked
static_assert(window_dq_smem<WIN_D>() <= 48 * 1024, "window smem");

int launch_window(const BwdArgs& a, const Additive& ad,
                  const Additive& ad_t, const BiasGrad& g, float* dbias,
                  float* stats, int N, int H, float scale, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int tiles = (N + TILE - 1) / TILE;
  const int runs = (g.B + g.per_run - 1) / g.per_run;
  window_bwd_dq_kernel<WIN_D>
      <<<dim3(tiles, H, runs), THREADS, window_dq_smem<WIN_D>(), s>>>(
          a, ad, g, stats, N, H, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  window_bwd_dkv_kernel<WIN_D><<<dim3(tiles, H, g.B), THREADS, 0, s>>>(
      a, ad_t, stats, N, H, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || !g.part) return (int)err;
  const int cols = H * N * N;
  return (int)sum_groups(g.part, dbias, dbias + cols, runs, cols, cols, s);
}

// The packed operands of the block path: qkv [B*N, 3C] and dqkv [B*N, 3C]
// (columns ordered qkv-slot, head, dim), dout [B*N, C].
BwdArgs packed_args(const void* qkv, const void* dout, void* dqkv, int C) {
  const bf16* p = (const bf16*)qkv;
  bf16* g = (bf16*)dqkv;
  return BwdArgs{{p, 3 * C},     {p + C, 3 * C}, {p + 2 * C, 3 * C},
                 {nullptr, 0},   {(const bf16*)dout, C},
                 g,              g + C,          g + 2 * C,
                 3 * C,          3 * C,          3 * C};
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
  return launch<false>(packed_args(qkv, dout, dqkv, H * Dh), (float*)stats,
                       B, N, H, scale, stream);
}

// The windowed block path: qkv, dout, dqkv and stats as above over B
// windows of N tokens, with the forward's bias [H, N, N] f32, bias_t its
// key-major copy (bias transposed per head, for phase 2) and regions [nW, N]
// int32 (each null or contiguous), N <= WIN_MAX_N. With a bias,
// dbias [H, N, N] f32 gets its gradient through part, f32 scratch of
// ceil(B / per_run) * H * N * N. Only D = 32 is built.
int ag_window_attention_bwd_bf16(const void* qkv, const void* dout,
                                 void* dqkv, void* stats, const void* bias,
                                 const void* bias_t, const void* regions,
                                 int nW, void* part,
                                 void* dbias, int per_run, int B, int N,
                                 int H, int Dh, float scale, void* stream) {
  if (bad_shape(B, N, H, Dh, WIN_D) || N > WIN_MAX_N || nW < 1 ||
      per_run < 1 || (B + per_run - 1) / per_run > 65535)
    return (int)cudaErrorInvalidValue;
  const Additive ad{(const float*)bias, (const int*)regions, nW};
  const Additive ad_t{(const float*)bias_t, (const int*)regions, nW};
  const BiasGrad g{bias ? (float*)part : nullptr, per_run, B};
  return launch_window(packed_args(qkv, dout, dqkv, H * Dh), ad, ad_t, g,
                       (float*)dbias, (float*)stats, N, H, scale, stream);
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
