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
// (window_bwd_dq_kernel<D, NCH>, window_bwd_dkv_kernel<D, NCH>), and the
// bias's gradient dBias[h, i, j] = sum over the windows of p (dp - d_row),
// in f32, unrounded. Both kernels are built around the whole window (at
// most WIN_MAX_N = 160 tokens), as the forward: a block of ceil(N/16)
// warps (9 at Swin's 144) owns a run of `per_run` consecutive windows of
// one head, about one block an SM, each warp 16 rows of the window (query
// rows in phases 1 and 3, key rows in phase 2); the head's bias (its
// key-major copy in phase 2) stays in shared memory for the run, and each
// window's operands are staged once through a two-slot cp.async ring.
// Phases 1 and 3 hold a row's p in registers and make one pass (see the
// kernel); d_row is then sum_d do_d o_d with o = f32(p . v), the
// reference's own sum. Each window's dS adds into the run's f32 dBias
// partial, kept on chip (part in shared memory, part in registers; each
// element one thread's, the windows in order) and written once a run to
// [runs, H, N, N]; sum_groups.cuh then adds the runs in a fixed order. No
// atomics: dBias is bit-identical from run to run too.
//
// What bounds the windowed kernels: as the forward, the per-score FP32
// instructions (twice the forward's products, dS and its dBias sums on
// top) on 9 warps an SM, not the tensor cores or the bytes. On an H100
// 80GB HBM3 at 700 W, Swin-B at batch 32, stage 3 (128 windows, H = 16,
// the shift mask): dQ 0.237 ms, dK/dV 0.185 ms (stages 1 / 2 / 4: 0.881 /
// 0.460 / 0.122 and 0.686 / 0.360 / 0.094), against 0.806 and 0.489 ms
// (2.575 / 1.423 / 0.256 and 1.290 / 0.770 / 0.145) for the 64-row-tile
// kernels these replaced (their __fdiv_rn slow path at masked keys, 144
// rows padded to 192, operands staged three times, dBias read, added and
// written back in device memory for every window).
//
// What bounds ViT's cores on an H100: at ViT-B/16 (B = 32, N = 197, H = 12,
// D = 64) the four backward products are 7.6 GFLOP (0.008 ms at 989 TFLOP/s)
// on 77.5 MB of q, k, v, o, do, dq, dk, dv (0.023 ms at 3.35 TB/s): bytes. The
// recomputed Q K^T (twice in phases 1 and 3, once in phase 2) and dO V^T
// (twice, plus once more on the block path) roughly double the products, which
// the tensor cores absorb; by estimate the exp / divide work per score, done
// in both launches, and occupancy (registers) set the pace. 1536 blocks a
// launch, 5 (phases 1, 3) and 4 (phase 2) resident per SM.
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

// Where the windowed phases 1 and 3 put dBias: the f32 partial [runs, H,
// N, N] (null: no bias, no gradient), per_run windows a run of B.
struct BiasGrad {
  float* part;
  int per_run, B;
};

// Phases 1 and 3 of the windowed backward: a block of ceil(N/16) warps owns
// a run of consecutive windows [w0, w1) of head h, warp w the window's
// query rows 16w..16w+15. The head's bias stays in shared memory for the
// run; each window's Q, dO, K, V and region ids come through a two-slot
// cp.async ring. A warp's 16 x R scores stay in registers, so one pass
// gives, as the forward, the exact m and l and p = bf16(exp(s - m) / l);
// then o = f32(p . v) and d_row = sum_d do_d o_d; then per 16-key chunk
// dP = dO V^T, dS = p (dP - d_row), dQ += bf16(dS scale) K. dS adds into
// the run's dBias partial, kept on chip (each element one lane's, the
// windows in order) and written once at the run's end: the first
// WinDq<NCH>::SMEM_CHUNKS key chunks in shared memory (as much as the
// bias and the ring leave), the rest in the lanes' accumulator positions.
// m, l and d_row go to the stats for phase 2. Bound by instruction issue
// (see the note at the head of the file).
template <int NCH>
struct WinDq {
  using Smem = WinSmem<WIN_D, 4, 0>;  // tiles Q, dO, K, V
  // key chunks of the run's dBias in shared memory [R][LD] (the rest in
  // registers: 9 warps leave a lane at most 168 registers)
  static constexpr int SMEM_CHUNKS = NCH == 9 ? 5 : 1;
  static constexpr int LD = SMEM_CHUNKS * WIN_CHUNK + 8;
  static __host__ __device__ int bytes(int N) {
    return Smem::bytes(N) + win_rows(N) * LD * 4;
  }
};

template <int D, int NCH>
__global__ void __launch_bounds__(NCH * 32, 1)
window_bwd_dq_kernel(BwdArgs a, Additive ad, BiasGrad g,
                     float* __restrict__ stats, int N, int H, float scale) {
  constexpr int LDT = Head<D>::LDT;
  using Smem = typename WinDq<NCH>::Smem;
  constexpr int DBS = WinDq<NCH>::SMEM_CHUNKS, DB_LD = WinDq<NCH>::LD;
  AG_DYNAMIC_SMEM(smem_raw);
  const Smem sm(smem_raw, N);
  const int R = sm.R, chunks = R / WIN_CHUNK, h = blockIdx.y;
  const int w0 = blockIdx.x * g.per_run, w1 = min(g.B, w0 + g.per_run);
  float* sdb = reinterpret_cast<float*>(smem_raw + Smem::bytes(N));
  const int row0 = (threadIdx.x >> 5) * 16;
  const WinRows rw = win_rows_of(sm.bias, Smem::bias_ld(N), ad.bias, row0, N);
  const size_t plane = (size_t)g.B * H * N;

  auto issue = [&](int b) {
    const int s = (b - w0) & 1;
    win_load<D>(sm.tile(s, 0), a.q, b, h, N, R);
    win_load<D>(sm.tile(s, 1), a.dout, b, h, N, R);
    win_load<D>(sm.tile(s, 2), a.k, b, h, N, R);
    win_load<D>(sm.tile(s, 3), a.v, b, h, N, R);
    win_load_regions(sm.regions(s), ad, b, N, R);
    cp_async_commit();
  };
  win_load_bias(sm.bias, ad.bias, h, N, Smem::bias_ld(N));
  issue(w0);

  // the run's dBias at the lane's score positions of chunks DBS..
  float db[NCH - DBS][2][4];
#pragma unroll
  for (int c = 0; c < NCH - DBS; ++c) zero(db[c]);
  if (g.part)
    for (int i = threadIdx.x; i < R * DB_LD; i += blockDim.x) sdb[i] = 0.f;
  for (int b = w0; b < w1; ++b) {
    const int s = (b - w0) & 1;
    cp_async_wait<0>();
    __syncthreads();  // window b landed; every warp is done with b - 1
    if (b + 1 < w1) issue(b + 1);
    bf16* sQ = sm.tile(s, 0);
    const bf16* sdO = sm.tile(s, 1);
    const bf16* sK = sm.tile(s, 2);
    const bf16* sV = sm.tile(s, 3);
    const int* rid = ad.regions ? sm.regions(s) : nullptr;
    const int rr0 = rid ? rid[rw.r0] : 0, rr1 = rid ? rid[rw.r1] : 0;

    float p[NCH][2][4];  // this warp's 16 queries x every key
    float m[2], l[2];
    win_exp_scores<D>(p, m, l, sQ, sK, row0, chunks, N, scale, rw, rid, rr0,
                      rr1);

    // p = bf16(e / l), kept as the A fragments of P V (half the registers
    // of f32); o = f32(p . v); d_row = sum_d do_d o_d
    uint32_t pf[NCH][1][4];
    float o[Head<D>::NT][4];
    zero(o);
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      if (c >= chunks) continue;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          p[c][nt][e] = win_p(p[c][nt][e], l[e >> 1]);
      pack_a(pf[c], p[c]);
      mma_ab<D>(o, pf[c], sV + c * WIN_CHUNK * LDT);
    }
    // dO's A fragments hold the lane's o positions: n-tile 2kc + j of rows
    // g and g + 8 in registers 2j and 2j + 1 of k-chunk kc
    uint32_t dof[Head<D>::KC][4];
    load_a<D>(dof, sdO, row0);
    float drow[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < Head<D>::NT; ++nt) {
      const uint32_t* f = dof[nt >> 1] + 2 * (nt & 1);
      drow[0] += bf16_lo(f[0]) * o[nt][0];
      drow[0] += bf16_hi(f[0]) * o[nt][1];
      drow[1] += bf16_lo(f[1]) * o[nt][2];
      drow[1] += bf16_hi(f[1]) * o[nt][3];
    }
    drow[0] = quad_sum(drow[0]);
    drow[1] = quad_sum(drow[1]);

    float dq[Head<D>::NT][4];
    zero(dq);
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      if (c >= chunks) continue;
      float dp[2][4];  // dP = dO V^T over the chunk's 16 keys
      zero(dp);
      mma_abt<D>(dp, dof, sV + c * WIN_CHUNK * LDT);
      float ds[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // p of (nt, e): pack_a's register 2 nt + e / 2, half e % 2
          const uint32_t pp = pf[c][0][2 * nt + (e >> 1)];
          ds[nt][e] = (e & 1 ? bf16_hi(pp) : bf16_lo(pp)) *
                      (dp[nt][e] - drow[e >> 1]);
          dp[nt][e] = ds[nt][e] * scale;
        }
      if (g.part) {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            if (c < DBS) {
              float2* at = reinterpret_cast<float2*>(
                  sdb + (row0 + acc_row(2 * hf)) * DB_LD + c * WIN_CHUNK +
                  acc_col(nt, 0));
              *at = make_float2(at->x + ds[nt][2 * hf],
                                at->y + ds[nt][2 * hf + 1]);
            } else {
              db[c - DBS][nt][2 * hf] += ds[nt][2 * hf];
              db[c - DBS][nt][2 * hf + 1] += ds[nt][2 * hf + 1];
            }
          }
      }
      uint32_t dsf[1][4];
      pack_a(dsf, dp);
      mma_ab<D>(dq, dsf, sK + c * WIN_CHUNK * LDT);
    }

    if ((threadIdx.x & 3) == 0) {
      float* row_stats = stats + ((size_t)b * H + h) * N;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int n = row0 + acc_row(2 * r);
        if (n < N) {
          row_stats[n] = m[r];
          row_stats[plane + n] = l[r];
          row_stats[2 * plane + n] = drow[r];
        }
      }
    }
    // each warp stages its own 16 rows of sQ, which only it read
    store_rows<D>(dq, sQ, row0,
                  a.dq + (size_t)b * N * a.ld_dq + (size_t)h * D, a.ld_dq, 0,
                  N);
  }

  if (!g.part) return;
  float* part = g.part + ((size_t)blockIdx.x * H + h) * N * N;
  const bool pairs = (N & 1) == 0;  // float2 stores (even N)
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    if (c >= chunks) continue;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {  // rows g, g + 8; keys k, k + 1
        const int n = row0 + acc_row(2 * hf);
        const int k = c * WIN_CHUNK + acc_col(nt, 0);
        if (n >= N || k >= N) continue;
        float2 v;
        if (c < DBS) {
          v = *reinterpret_cast<const float2*>(sdb + n * DB_LD + k);
        } else {
          v = make_float2(db[c - DBS][nt][2 * hf],
                          db[c - DBS][nt][2 * hf + 1]);
        }
        float* at = part + (size_t)n * N + k;
        if (pairs) {
          *reinterpret_cast<float2*>(at) = v;
        } else {
          at[0] = v.x;
          if (k + 1 < N) at[1] = v.y;
        }
      }
  }
}

// Phase 2 of the windowed backward: a block of ceil(N/16) warps owns a run
// of consecutive windows [w0, w1) of head h, warp w the window's key rows
// 16w..16w+15, K and V as A fragments. The bias's key-major copy stays in
// shared memory for the run; each window's K, V, Q, dO, region ids and the
// queries' m, l and d_row come through a two-slot cp.async ring. Per
// 16-query chunk: S^T = K Q^T with the bias and mask, P^T = bf16(exp(s - m)
// / l) against each query's stats, dV += P^T dO, dP^T = V dO^T, dS^T =
// bf16(P^T (dP^T - d_row) scale), dK += dS^T Q. Bound by instruction issue
// (see the note at the head of the file).
template <int D, int NCH>
__global__ void __launch_bounds__(NCH * 32, 1)
window_bwd_dkv_kernel(BwdArgs a, Additive ad, const float* __restrict__ stats,
                      int B, int N, int H, int per_run, float scale) {
  constexpr int LDT = Head<D>::LDT;
  using Smem = WinSmem<D, 4, 3>;  // tiles K, V, Q, dO; stats m, l, d_row
  AG_DYNAMIC_SMEM(smem_raw);
  const Smem sm(smem_raw, N);
  const int R = sm.R, chunks = R / WIN_CHUNK, h = blockIdx.y;
  const int w0 = blockIdx.x * per_run, w1 = min(B, w0 + per_run);
  const int row0 = (threadIdx.x >> 5) * 16;
  const WinRows rw = win_rows_of(sm.bias, Smem::bias_ld(N), ad.bias, row0, N);
  const size_t plane = (size_t)B * H * N;

  auto issue = [&](int b) {
    const int s = (b - w0) & 1;
    win_load<D>(sm.tile(s, 0), a.k, b, h, N, R);
    win_load<D>(sm.tile(s, 1), a.v, b, h, N, R);
    win_load<D>(sm.tile(s, 2), a.q, b, h, N, R);
    win_load<D>(sm.tile(s, 3), a.dout, b, h, N, R);
    win_load_regions(sm.regions(s), ad, b, N, R);
    const float* row_stats = stats + ((size_t)b * H + h) * N;
    for (int i = threadIdx.x; i < R; i += blockDim.x)
#pragma unroll
      for (int w = 0; w < 3; ++w)
        cp_async4(sm.stats(s, w) + i, row_stats + w * plane + (i < N ? i : 0),
                  i < N);
    cp_async_commit();
  };
  win_load_bias(sm.bias, ad.bias, h, N, Smem::bias_ld(N));
  issue(w0);

  for (int b = w0; b < w1; ++b) {
    const int s = (b - w0) & 1;
    cp_async_wait<0>();
    __syncthreads();  // window b landed; every warp is done with b - 1
    if (b + 1 < w1) issue(b + 1);
    bf16* sK = sm.tile(s, 0);
    bf16* sV = sm.tile(s, 1);
    const bf16* sQ = sm.tile(s, 2);
    const bf16* sdO = sm.tile(s, 3);
    const float* s_m = sm.stats(s, 0);
    const float* s_l = sm.stats(s, 1);
    const float* s_d = sm.stats(s, 2);
    const int* rid = ad.regions ? sm.regions(s) : nullptr;
    const int rr0 = rid ? rid[rw.r0] : 0, rr1 = rid ? rid[rw.r1] : 0;

    uint32_t kf[Head<D>::KC][4], vf[Head<D>::KC][4];
    load_a<D>(kf, sK, row0);
    load_a<D>(vf, sV, row0);
    float dk[Head<D>::NT][4], dv[Head<D>::NT][4];
    zero(dk);
    zero(dv);
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      if (c >= chunks) continue;
      const int q0 = c * WIN_CHUNK;
      float sc[2][4];  // S^T: this warp's 16 keys x the chunk's 16 queries
      zero(sc);
      mma_abt<D>(sc, kf, sQ + q0 * LDT);
      win_scores(sc, q0, scale, rw, rid, rr0, rr1);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int q = q0 + acc_col(nt, 0);
        const float2 mq = *reinterpret_cast<const float2*>(s_m + q);
        const float2 lq = *reinterpret_cast<const float2*>(s_l + q);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sc[nt][e] = round_bf16(win_p(
              expf(sc[nt][e] - (e & 1 ? mq.y : mq.x)), e & 1 ? lq.y : lq.x));
      }
      // queries >= N (their m, l are zero-filled)
      mask_tail(sc, q0, N, 0.f);
      uint32_t pf[1][4];
      pack_a(pf, sc);
      mma_ab<D>(dv, pf, sdO + q0 * LDT);
      float dp[2][4];  // dP^T = V dO^T
      zero(dp);
      mma_abt<D>(dp, vf, sdO + q0 * LDT);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const float2 dr = *reinterpret_cast<const float2*>(
            s_d + q0 + acc_col(nt, 0));
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[nt][e] =
              sc[nt][e] * (dp[nt][e] - (e & 1 ? dr.y : dr.x)) * scale;
      }
      uint32_t dsf[1][4];
      pack_a(dsf, dp);
      mma_ab<D>(dk, dsf, sQ + q0 * LDT);
    }

    // each warp stages its own 16 rows of sK and sV, which only it read
    store_rows<D>(dk, sK, row0,
                  a.dk + (size_t)b * N * a.ld_dk + (size_t)h * D, a.ld_dk, 0,
                  N);
    store_rows<D>(dv, sV, row0,
                  a.dv + (size_t)b * N * a.ld_dv + (size_t)h * D, a.ld_dv, 0,
                  N);
  }
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

// The windowed launches: runs of per_run windows (set by the caller: the
// runs' dBias partials are summed in run order, so the split fixes dBias
// bit for bit), a block of ceil(N/16) warps each; the kernels built for 9
// chunks (Swin's 144 tokens, up to 224 registers a thread) or for 10 (up to
// 160). Then the runs' partials summed in order.
template <int NCH>
int launch_window_chunks(const BwdArgs& a, const Additive& ad,
                         const Additive& ad_t, const BiasGrad& g,
                         float* dbias, float* stats, int N, int H,
                         float scale, cudaStream_t s) {
  using DkvSmem = WinSmem<WIN_D, 4, 3>;
  static unsigned long long ready_dq = 0, ready_dkv = 0;  // devices opted in
  cudaError_t err = opt_in_smem(window_bwd_dq_kernel<WIN_D, NCH>,
                                WinDq<NCH>::bytes(NCH * WIN_CHUNK), ready_dq);
  if (err == cudaSuccess)
    err = opt_in_smem(window_bwd_dkv_kernel<WIN_D, NCH>,
                      DkvSmem::bytes(NCH * WIN_CHUNK), ready_dkv);
  if (err != cudaSuccess) return (int)err;
  const int runs = (g.B + g.per_run - 1) / g.per_run;
  const dim3 grid(runs, H);
  const int threads = win_rows(N) / WIN_CHUNK * 32;
  window_bwd_dq_kernel<WIN_D, NCH>
      <<<grid, threads, WinDq<NCH>::bytes(N), s>>>(a, ad, g, stats, N, H,
                                                   scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  window_bwd_dkv_kernel<WIN_D, NCH><<<grid, threads, DkvSmem::bytes(N), s>>>(
      a, ad_t, stats, g.B, N, H, g.per_run, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || !g.part) return (int)err;
  const int cols = H * N * N;
  return (int)sum_groups(g.part, dbias, dbias + cols, runs, cols, cols, s);
}

int launch_window(const BwdArgs& a, const Additive& ad,
                  const Additive& ad_t, const BiasGrad& g, float* dbias,
                  float* stats, int N, int H, float scale, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  return win_rows(N) <= 144
             ? launch_window_chunks<9>(a, ad, ad_t, g, dbias, stats, N, H,
                                       scale, s)
             : launch_window_chunks<10>(a, ad, ad_t, g, dbias, stats, N, H,
                                        scale, s);
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
