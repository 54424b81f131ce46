// Multi-head attention core, forward: per (image, head, 64-row query tile),
// softmax(q k^T * scale) v, in two instantiations of one kernel.
//
// Packed (block path, ag_attention_core_bf16): q, k, v from the fused qkv
// tensor of the transformer block. Replaces the per-head attention inside
// the Pallas kernel artgraph_tpu/ops/attention.py:_block_fwd_kernel
// (_head_attention, :348-361). ops/attention.py wraps it between the
// LayerNorm + qkv GEMM and the proj GEMM with its residual epilogue
// (csrc/block_gemm.cu). Rounding points are that kernel's: s = f32(q . k) *
// scale, exact row max m and sum l over all N keys, p = bf16(exp(s - m) /
// l), then o = bf16(f32(p . v)).
//
// Strided (STRIDED, ag_attention_bf16): q, k, v, o as [B*N, ld] row-major
// views, head h at column h*D of each row; the fused qkv tensor is the case
// ld = 3C with k and v at offsets C and 2C. Replaces the Pallas kernels
// artgraph_tpu/ops/attention.py:_fwd_kernel (fused_attention, :41) and
// _qkv_fwd_kernel (fused_qkv_attention, :183) after its qkv product. Both
// divide AFTER the product: o = bf16(f32(bf16(exp(s - m)) . v) / l).
//
// Design. A block of 4 warps owns one (image, head, 64-row query tile); each
// warp owns 16 query rows end to end and holds them in registers. The block
// walks K and V in 32-key stages through a two-stage cp.async ring, so
// shared memory is the Q tile (9 KB, reused to stage the output) and the
// ring (18 KB): 27 KB at D = 64 whatever N is. Products are mma.sync
// m16n8k16 with register accumulators (attention_tiles.cuh): S = Q K^T
// lands in registers, the row max and sum reduce across the 4 lanes of a
// quad, and the probabilities go from the S accumulators straight into the
// A fragments of P V; no score, probability or output tile passes through
// shared memory. The ragged last stage masks keys >= N to -inf; rows >= N
// are computed on zeros and not stored.
//
// To keep the reference's rounding points with the exact m and l, the
// kernel walks the key tiles twice. Pass 1 computes S and each row's max m;
// the block path also sums l there, merging tiles with the usual rescale l =
// l * exp(m_old - m_new) + sum(exp(s - m_new)): the same values, summed in
// another order. Pass 2 recomputes S and forms e = exp(s - m) against the
// final m. The block path rounds p = bf16(e / l) before the product; the
// strided path rounds bf16(e), sums l from the same e (the reference's own
// sum) and divides the f32 product by it at the end. A one-pass online
// softmax would round p against a running max, which the reference never
// does. s = f32(q . k) * scale rounded before exp (__fmul_rn, no FMA
// contraction), expf and __fdiv_rn as in the reference, so kernel and plain
// twin differ only in summation order.
//
// Windowed (ag_window_attention_bf16): the packed path on [B*nW, N, C]
// windows (Swin's shifted-window blocks), each window an image of N tokens,
// at head dim 32 (the kernel is written over D; only D = 32 is built), with
// an f32 bias [H, N, N] and the shift mask
// (-100 between tokens of different regions; int32 region ids [nW, N],
// window b taking row b mod nW), either optional, added to the scaled
// scores before the softmax: s = ((f32(q . k) * scale) + bias) + mask.
// Its kernel, window_attention_kernel<D, NCH>, is built around the whole
// window (at most WIN_MAX_N = 160 tokens): a block of ceil(N/16) warps (9
// at Swin's 144: no padded row or key) owns a run of consecutive windows of
// one head, about one block an SM. The head's bias stays in shared memory
// for the run; each window's Q, K, V and region ids are staged once,
// through a two-slot cp.async ring that loads the next window while this
// one computes; a row's scores stay in registers, so the kernel makes one
// pass with the exact m and l and one exponential a score (see the
// kernel). The packed kernel above stays as it is for ViT's blocks.
//
// What bounds the windowed kernel: each score costs some 30 FP32-pipe
// instructions (scale, bias, mask, max, exp, sum, the IEEE divide) against
// about 2 bytes of device memory and 128 tensor-core FLOPs, so instruction
// issue bounds it, not the tensor cores or the bytes: a block
// has 9 warps on the SM's 4 schedulers, one of which runs three of them
// (and so at most 168 registers a lane). On an H100 80GB HBM3 at 700 W,
// Swin-B at batch 32: 0.139 ms at stage 3 (128 windows, H = 16, the shift
// mask), 0.519 / 0.270 / 0.066 ms at stages 1, 2, 4, against 0.466 (1.258
// / 0.731 / 0.122) ms for the 64-row-tile kernel this one replaced, whose
// __fdiv_rn took its slow path at every masked key (see win_p) and whose
// tiles padded 144 rows to 192 and staged K and V three times.
//
// What bounds ViT's cores on an H100: at ViT-B/16 (B = 32, N = 197, H = 12,
// D = 64) the two products are 3.8 GFLOP (0.004 ms at 989 TFLOP/s) on 38.7 MB
// of q, k, v and o (0.0116 ms at 3.35 TB/s): bytes. Pass 1's extra Q K^T adds
// 1.9 GFLOP. By estimate (no instruction-level profile is available), the
// exp / divide work per score and each warp's shared-memory fragment loads
// set the pace more than either bound. 1536 blocks of 128 threads, 5
// resident per SM (96 registers), keep the loads of one block overlapping the
// products of others, and the ring overlaps each block's next stage with its
// current one.
#include "attention_tiles.cuh"

#include <math.h>

namespace {

using namespace attn;

struct FwdArgs {
  Rows q, k, v;
  bf16* o;
  int ld_o;
};

// At most 96 registers a thread: 5 blocks an SM, no spills (timed faster
// on the H100 than 4 blocks at 122).
template <bool STRIDED>
__global__ void __launch_bounds__(THREADS, 5)
attention_core_kernel(FwdArgs a, int N, float scale) {
  __shared__ __align__(128) bf16 sQ[Head<64>::TILE_ELEMS];
  // [slot][K, V]
  __shared__ __align__(128) bf16 ring[2][2][STAGE * Head<64>::LDT];
  const int q0 = blockIdx.x * TILE, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, row0 = warp * 16;
  const bf16* kb = head_rows<64>(a.k, b, h, N);
  const bf16* vb = head_rows<64>(a.v, b, h, N);
  const int T = (N + STAGE - 1) / STAGE;  // key stages a pass

  // stage s: key rows of tile s % T; pass 1 (s < T) reads K, pass 2 K and V
  auto issue = [&](int s) {
    const int j = s < T ? s : s - T;
    load_tile<64, STAGE>(ring[s & 1][0], kb, a.k.ld, j * STAGE, N);
    if (s >= T)
      load_tile<64, STAGE>(ring[s & 1][1], vb, a.v.ld, j * STAGE, N);
    cp_async_commit();
  };

  load_tile<64>(sQ, head_rows<64>(a.q, b, h, N), a.q.ld, q0, N);
  issue(0);

  uint32_t qf[4][4];
  float m[2] = {-INFINITY, -INFINITY};  // rows g, g + 8 of the warp
  float l[2] = {0.f, 0.f};  // this lane's share until its pass ends
  float o[8][4];
  zero(o);
  for (int s = 0; s < 2 * T; ++s) {
    if (s + 1 < 2 * T) {
      issue(s + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (s == 0) load_a<64>(qf, sQ, row0);
    const int k0 = (s < T ? s : s - T) * STAGE;
    float sc[4][4];  // this warp's 16 queries x the stage's 32 keys
    zero(sc);
    mma_abt<64>(sc, qf, ring[s & 1][0]);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = __fmul_rn(sc[nt][e], scale);
    mask_tail(sc, k0, N, -INFINITY);

    if (s < T) {  // pass 1
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mt = -INFINITY;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mt = fmaxf(mt, fmaxf(sc[nt][2 * r], sc[nt][2 * r + 1]));
        if (STRIDED) {  // the max alone: l is summed in pass 2
          m[r] = fmaxf(m[r], mt);
          continue;
        }
        // merge this tile into (m, l)
        const float mn = fmaxf(m[r], quad_max(mt));
        float sum = 0.f;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          sum += expf(sc[nt][2 * r] - mn) + expf(sc[nt][2 * r + 1] - mn);
        l[r] = l[r] * expf(m[r] - mn) + sum;
        m[r] = mn;
      }
      if (s == T - 1) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          if (STRIDED)
            m[r] = quad_max(m[r]);
          else
            l[r] = quad_sum(l[r]);
        }
      }
    } else {  // pass 2: p against the final m (and l), then O += P V
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = expf(sc[nt][e] - m[e >> 1]);
          if (STRIDED) l[e >> 1] += p;
          sc[nt][e] = STRIDED ? p : __fdiv_rn(p, l[e >> 1]);
        }
      uint32_t pf[2][4];
      pack_a(pf, sc);
      mma_ab<64>(o, pf, ring[s & 1][1]);
    }
    __syncthreads();
  }

  if (STRIDED) {
    l[0] = quad_sum(l[0]);
    l[1] = quad_sum(l[1]);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nt][e] = __fdiv_rn(o[nt][e], l[e >> 1]);
  }
  bf16* ob = a.o + (size_t)b * N * a.ld_o + (size_t)h * 64;
  store_rows<64>(o, sQ, row0, ob, a.ld_o, q0, N);
}

// The windowed core: a block of ceil(N/16) warps owns a run of consecutive
// windows [w0, w1) of head h, warp w the window's query rows 16w..16w+15.
// The head's bias stays in shared memory for the run; each window's Q, K,
// V and region ids come through a two-slot cp.async ring, the next window's
// loads in flight while this one computes. A warp's 16 x R scores stay in
// registers (NCH chunks of 16 keys: NCH = 9 covers Swin's 144), so one pass
// gives S = Q K^T scaled, plus the bias and the mask; the exact row max m
// and sum l = sum exp(s - m); p = bf16(exp(s - m) / l); o = bf16(f32(p .
// v)): the block path's rounding points with one exponential a score.
// Bound by instruction issue (see the note at the head of the file).
template <int D, int NCH>
__global__ void __launch_bounds__(NCH * 32, 1)
window_attention_kernel(FwdArgs a, Additive ad, int B, int N, int per_run,
                        float scale) {
  constexpr int LDT = Head<D>::LDT;
  using Smem = WinSmem<D, 3, 0>;  // tiles Q, K, V
  AG_DYNAMIC_SMEM(smem_raw);
  const Smem sm(smem_raw, N);
  const int R = sm.R, chunks = R / WIN_CHUNK, h = blockIdx.y;
  const int w0 = blockIdx.x * per_run, w1 = min(B, w0 + per_run);
  const int row0 = (threadIdx.x >> 5) * 16;
  const WinRows rw = win_rows_of(sm.bias, Smem::bias_ld(N), ad.bias, row0, N);

  auto issue = [&](int b) {
    const int s = (b - w0) & 1;
    win_load<D>(sm.tile(s, 0), a.q, b, h, N, R);
    win_load<D>(sm.tile(s, 1), a.k, b, h, N, R);
    win_load<D>(sm.tile(s, 2), a.v, b, h, N, R);
    win_load_regions(sm.regions(s), ad, b, N, R);
    cp_async_commit();
  };
  win_load_bias(sm.bias, ad.bias, h, N, Smem::bias_ld(N));
  issue(w0);

  for (int b = w0; b < w1; ++b) {
    const int s = (b - w0) & 1;
    cp_async_wait<0>();
    __syncthreads();  // window b landed; every warp is done with b - 1
    if (b + 1 < w1) issue(b + 1);
    bf16* sQ = sm.tile(s, 0);
    const bf16* sK = sm.tile(s, 1);
    const bf16* sV = sm.tile(s, 2);
    const int* rid = ad.regions ? sm.regions(s) : nullptr;
    const int rr0 = rid ? rid[rw.r0] : 0, rr1 = rid ? rid[rw.r1] : 0;

    float sc[NCH][2][4];  // this warp's 16 queries x every key
    float m[2], l[2];
    win_exp_scores<D>(sc, m, l, sQ, sK, row0, chunks, N, scale, rw, rid, rr0,
                      rr1);
    float o[Head<D>::NT][4];
    zero(o);
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      if (c >= chunks) continue;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sc[c][nt][e] = win_p(sc[c][nt][e], l[e >> 1]);
      uint32_t pf[1][4];
      pack_a(pf, sc[c]);
      mma_ab<D>(o, pf, sV + c * WIN_CHUNK * LDT);
    }
    // each warp stages its own 16 rows of sQ, which only it read
    store_rows<D>(o, sQ, row0, a.o + (size_t)b * N * a.ld_o + (size_t)h * D,
                  a.ld_o, 0, N);
  }
}

template <bool STRIDED>
int launch(const FwdArgs& a, int B, int N, int H, float scale,
           void* stream) {
  const dim3 grid((N + TILE - 1) / TILE, H, B);
  attention_core_kernel<STRIDED>
      <<<grid, THREADS, 0, (cudaStream_t)stream>>>(a, N, scale);
  return (int)cudaGetLastError();
}

// The windowed launch: runs of win_per_run(B, H) windows, a block of
// ceil(N/16) warps each; the kernel built for 9 chunks (Swin's 144 tokens,
// up to 224 registers a thread) or for 10 (up to 160).
template <int NCH>
int launch_window_chunks(const FwdArgs& a, const Additive& ad, int B, int N,
                         int H, float scale, cudaStream_t s) {
  using Smem = WinSmem<WIN_D, 3, 0>;
  static unsigned long long ready = 0;  // devices opted in
  const cudaError_t err = opt_in_smem(window_attention_kernel<WIN_D, NCH>,
                                      Smem::bytes(NCH * WIN_CHUNK), ready);
  if (err != cudaSuccess) return (int)err;
  const int per = win_per_run(B, H);
  window_attention_kernel<WIN_D, NCH>
      <<<dim3((B + per - 1) / per, H), win_rows(N) / WIN_CHUNK * 32,
         Smem::bytes(N), s>>>(a, ad, B, N, per, scale);
  return (int)cudaGetLastError();
}

int launch_window(const FwdArgs& a, const Additive& ad, int B, int N, int H,
                  float scale, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  return win_rows(N) <= 144
             ? launch_window_chunks<9>(a, ad, B, N, H, scale, s)
             : launch_window_chunks<10>(a, ad, B, N, H, scale, s);
}

// The packed qkv operands of [B*N, 3*H*D] (columns ordered qkv-slot, head,
// dim) and the [B*N, H*D] output.
FwdArgs packed_args(const void* qkv, void* out, int C) {
  const bf16* p = (const bf16*)qkv;
  return FwdArgs{{p, 3 * C}, {p + C, 3 * C}, {p + 2 * C, 3 * C}, (bf16*)out,
                 C};
}

}  // namespace

extern "C" {

// qkv: [B*N, 3*H*D] bf16 (columns ordered qkv-slot, head, dim);
// out: [B*N, H*D] bf16. Only D = 64 is built.
int ag_attention_core_bf16(const void* qkv, void* out, int B, int N, int H,
                           int Dh, float scale, void* stream) {
  if (bad_shape(B, N, H, Dh)) return (int)cudaErrorInvalidValue;
  return launch<false>(packed_args(qkv, out, H * Dh), B, N, H, scale,
                       stream);
}

// The windowed block path: qkv [B*N, 3*H*D] and out [B*N, H*D] bf16 as
// above, B windows of N tokens; bias [H, N, N] f32 and regions [nW, N]
// int32 (window b takes row b mod nW; B a multiple of nW), each null or
// contiguous; N <= WIN_MAX_N. Only D = 32 is built.
int ag_window_attention_bf16(const void* qkv, void* out, const void* bias,
                             const void* regions, int nW, int B, int N, int H,
                             int Dh, float scale, void* stream) {
  if (bad_shape(B, N, H, Dh, WIN_D) || N > WIN_MAX_N || nW < 1)
    return (int)cudaErrorInvalidValue;
  const Additive ad{(const float*)bias, (const int*)regions, nW};
  return launch_window(packed_args(qkv, out, H * Dh), ad, B, N, H, scale,
                       stream);
}

// q, k, v, out: [B*N, ld_*] bf16 row-major, head h at columns [h*D, h*D+D)
// of a row; each pointer 16-byte aligned and each ld_* a multiple of 8
// (checked by the caller). out = softmax(q k^T * scale) v per (image,
// head), divided by the row sum after the p . v product. Only D = 64 is
// built.
int ag_attention_bf16(const void* q, const void* k, const void* v, void* out,
                      int B, int N, int H, int Dh, int ld_q, int ld_k,
                      int ld_v, int ld_o, float scale, void* stream) {
  if (bad_shape(B, N, H, Dh)) return (int)cudaErrorInvalidValue;
  const FwdArgs a{{(const bf16*)q, ld_q}, {(const bf16*)k, ld_k},
                  {(const bf16*)v, ld_v}, (bf16*)out, ld_o};
  return launch<true>(a, B, N, H, scale, stream);
}

}  // extern "C"
