// Runs the port's CUDA kernels on the host: the attention cores, the
// conv + BN-statistics unit (conv_bn.cu), the LayerNorm backward and
// column sums (block_norm_bwd.cu), the CSR scalar sum (csr_segment.cu) and
// the BatchNorm chain (batchnorm.cu), each of the last four in its own
// namespace, with the second pass of sum_groups.cuh. The patched sources
// are included here, and every block of a grid runs as one host thread per
// CUDA thread, one block after another. Built and driven by
// ops/attention_emulation.py.
#include <stdio.h>
#include <stdlib.h>

#include <thread>

#include "cuda_runtime.h"

thread_local dim3 threadIdx, blockIdx;
thread_local int emu_tid;
dim3 gridDim, blockDim;
EmuBlock* emu;

#include "block_attention.cu"
#include "block_attention_bwd.cu"
#include "sum_groups.cuh"  // shared by the two sources below

namespace convbn {
#include "conv_bn.cu"
}

namespace norm {
#include "block_norm_bwd.cu"
}

namespace csr {
#include "csr_segment.cu"
}

namespace bn {
#include "batchnorm.cu"
}

thread_local std::vector<ptx::EmuCopy> ptx::emu_copies;
thread_local int ptx::emu_group;
unsigned char* ptx::emu_dyn_smem;

// Every block of `grid` in turn, `block` threads each, with `smem` bytes of
// dynamic shared memory (filled with 0xff, NaN as bf16, so a read before a
// write shows). The host threads are made once for the grid and walk its
// blocks together, meeting at a barrier after each block (the static
// shared memory is the next block's).
template <class F>
static void run_grid(dim3 grid, dim3 block, F kernel, size_t smem = 0) {
  const int threads = (int)(block.x * block.y * block.z);
  if (threads > 32 * 32 || threads % 32) {
    fprintf(stderr, "emulation: blocks of whole warps, at most 32\n");
    abort();
  }
  gridDim = grid;
  blockDim = block;
  std::vector<unsigned char> dyn(smem + 128, 0xff);
  ptx::emu_dyn_smem = (unsigned char*)(((uintptr_t)dyn.data() + 127) &
                                       ~(uintptr_t)127);
  EmuBlock blk;
  std::barrier<> sync(threads);
  std::vector<std::barrier<>*> warps;
  for (int w = 0; w < threads / 32; ++w)
    warps.push_back(blk.warp[w] = new std::barrier<>(32));
  blk.block = &sync;
  emu = &blk;
  std::vector<std::thread> pool;
  for (int t = 0; t < threads; ++t)
    pool.emplace_back([&, t] {
      emu_tid = t;
      threadIdx = {t % block.x, (t / block.x) % block.y,
                   t / (block.x * block.y)};
      for (unsigned z = 0; z < grid.z; ++z)
        for (unsigned y = 0; y < grid.y; ++y)
          for (unsigned x = 0; x < grid.x; ++x) {
            blockIdx = {x, y, z};
            ptx::emu_copies.clear();
            ptx::emu_group = 0;
            kernel();
            if (!ptx::emu_copies.empty()) {
              fprintf(stderr, "cp.async copies never waited for\n");
              abort();
            }
            sync.arrive_and_wait();
          }
    });
  for (std::thread& t : pool) t.join();
  for (std::barrier<>* w : warps) delete w;
}

static dim3 grid_of(int B, int N, int H) {
  return {(unsigned)((N + attn::TILE - 1) / attn::TILE), (unsigned)H,
          (unsigned)B};
}

static const dim3 ATTN_BLOCK{(unsigned)attn::THREADS, 1, 1};

using attn::bf16;

extern "C" int emu_attention(int strided, const void* q, const void* k,
                             const void* v, void* o, int B, int N, int H,
                             int ld_q, int ld_k, int ld_v, int ld_o,
                             float scale) {
  const FwdArgs a{{(const bf16*)q, ld_q}, {(const bf16*)k, ld_k},
                  {(const bf16*)v, ld_v}, (bf16*)o, ld_o};
  if (strided)
    run_grid(grid_of(B, N, H), ATTN_BLOCK,
             [&] { attention_core_kernel<true>(a, N, scale); });
  else
    run_grid(grid_of(B, N, H), ATTN_BLOCK,
             [&] { attention_core_kernel<false>(a, N, scale); });
  return 0;
}

extern "C" int emu_attention_bwd(int saved_o, const void* q, const void* k,
                                 const void* v, const void* o,
                                 const void* dout, void* dq, void* dk,
                                 void* dv, void* stats, int B, int N, int H,
                                 int ld_q, int ld_k, int ld_v, int ld_o,
                                 int ld_do, int ld_dq, int ld_dk, int ld_dv,
                                 float scale) {
  const BwdArgs a{{(const bf16*)q, ld_q}, {(const bf16*)k, ld_k},
                  {(const bf16*)v, ld_v}, {(const bf16*)o, ld_o},
                  {(const bf16*)dout, ld_do}, (bf16*)dq, (bf16*)dk,
                  (bf16*)dv, ld_dq, ld_dk, ld_dv};
  float* st = (float*)stats;
  if (saved_o)
    run_grid(grid_of(B, N, H), ATTN_BLOCK,
             [&] { attention_bwd_dq_kernel<true>(a, st, N, H, scale); });
  else
    run_grid(grid_of(B, N, H), ATTN_BLOCK,
             [&] { attention_bwd_dq_kernel<false>(a, st, N, H, scale); });
  run_grid(grid_of(B, N, H), ATTN_BLOCK,
           [&] { attention_bwd_dkv_kernel(a, st, N, H, scale); });
  return 0;
}

// sum_groups.cuh's pass, as sum_groups launches it.
static int emu_sums(const float* part, float* lo, float* hi, int groups,
                    int cols, int half) {
  if (sum_in_order(groups, cols))
    run_grid({(unsigned)((cols + SUM_SEQ_THREADS - 1) / SUM_SEQ_THREADS), 1,
              1},
             {(unsigned)SUM_SEQ_THREADS, 1, 1}, [&] {
               sum_groups_seq_kernel(part, lo, hi, groups, cols, half);
             });
  else
    run_grid({(unsigned)((cols + SUM_X - 1) / SUM_X), 1, 1},
             {(unsigned)SUM_X, (unsigned)SUM_Y, 1},
             [&] { sum_groups_kernel(part, lo, hi, groups, cols, half); });
  return 0;
}

// The windowed block path at head dim 32, as ag_window_attention_bf16 and
// ag_window_attention_bwd_bf16 launch it (any other head dim: 1), but with
// the forward's windows a run given (per_run) so that small shapes walk the
// ring too: a block of ceil(N/16) warps, the 9- or 10-chunk build.
using attn::WIN_D;
static FwdArgs window_fwd_args(const void* qkv, void* o, int C) {
  const bf16* p = (const bf16*)qkv;
  return FwdArgs{{p, 3 * C}, {p + C, 3 * C}, {p + 2 * C, 3 * C}, (bf16*)o, C};
}

static dim3 window_block(int N) {
  return {(unsigned)(attn::win_rows(N) / attn::WIN_CHUNK * 32), 1, 1};
}

template <int NCH>
static void window_fwd(const FwdArgs& a, const attn::Additive& ad, int B,
                       int N, int H, int per_run, float scale) {
  run_grid({(unsigned)((B + per_run - 1) / per_run), (unsigned)H, 1},
           window_block(N),
           [&] {
             window_attention_kernel<WIN_D, NCH>(a, ad, B, N, per_run, scale);
           },
           attn::WinSmem<WIN_D, 3, 0>::bytes(N));
}

extern "C" int emu_window_attention(const void* qkv, void* o,
                                    const void* bias, const void* regions,
                                    int nW, int B, int N, int H, int Dh,
                                    int per_run, float scale) {
  if (Dh != WIN_D) return 1;
  const FwdArgs a = window_fwd_args(qkv, o, H * Dh);
  const attn::Additive ad{(const float*)bias, (const int*)regions, nW};
  if (attn::win_rows(N) <= 144)
    window_fwd<9>(a, ad, B, N, H, per_run, scale);
  else
    window_fwd<10>(a, ad, B, N, H, per_run, scale);
  return 0;
}

template <int NCH>
static void window_bwd(const BwdArgs& a, const attn::Additive& ad,
                       const attn::Additive& ad_t, const BiasGrad& bg,
                       float* st, int N, int H, float scale) {
  const dim3 grid{(unsigned)((bg.B + bg.per_run - 1) / bg.per_run),
                  (unsigned)H, 1};
  run_grid(grid, window_block(N),
           [&] { window_bwd_dq_kernel<WIN_D, NCH>(a, ad, bg, st, N, H,
                                                  scale); },
           WinDq<NCH>::bytes(N));
  run_grid(grid, window_block(N),
           [&] {
             window_bwd_dkv_kernel<WIN_D, NCH>(a, ad_t, st, bg.B, N, H,
                                               bg.per_run, scale);
           },
           attn::WinSmem<WIN_D, 4, 3>::bytes(N));
}

extern "C" int emu_window_attention_bwd(const void* qkv, const void* dout,
                                        void* dqkv, void* stats,
                                        const void* bias, const void* bias_t,
                                        const void* regions, int nW,
                                        void* part, void* dbias,
                                        int per_run, int B, int N, int H,
                                        int Dh, float scale) {
  if (Dh != WIN_D) return 1;
  const int C = H * Dh;
  const bf16* p = (const bf16*)qkv;
  bf16* g = (bf16*)dqkv;
  const BwdArgs a{{p, 3 * C},   {p + C, 3 * C}, {p + 2 * C, 3 * C},
                  {nullptr, 0}, {(const bf16*)dout, C},
                  g,            g + C,          g + 2 * C,
                  3 * C,        3 * C,          3 * C};
  const attn::Additive ad{(const float*)bias, (const int*)regions, nW};
  const attn::Additive ad_t{(const float*)bias_t, (const int*)regions, nW};
  const BiasGrad bg{bias ? (float*)part : nullptr, per_run, B};
  float* st = (float*)stats;
  if (attn::win_rows(N) <= 144)
    window_bwd<9>(a, ad, ad_t, bg, st, N, H, scale);
  else
    window_bwd<10>(a, ad, ad_t, bg, st, N, H, scale);
  if (bg.part) {
    const int cols = H * N * N;
    const int runs = (B + per_run - 1) / per_run;
    emu_sums(bg.part, (float*)dbias, (float*)dbias + cols, runs, cols, cols);
  }
  return 0;
}

// conv_bn.cu's launch sequences with a launcher that runs each grid here.
namespace convbn {

struct EmuRun {
  template <int MODE, bool PRO>
  int unit(dim3 grid, const UnitArgs& args) {
    run_grid(grid, {(unsigned)THREADS, 1, 1},
             [&] { unit_gemm_kernel<MODE, PRO>(args); },
             Stage<MODE>::SMEM_BYTES);
    return 0;
  }
  int sums(const float* part, float* lo, float* hi, int groups, int cols,
           int half) {
    return emu_sums(part, lo, hi, groups, cols, half);
  }
};

}  // namespace convbn

extern "C" int emu_conv_bn_fwd(const void* x, const void* a, const void* b,
                               const void* w, void* y, void* part, void* s1,
                               void* s2, int M, int K, int N, int prologue) {
  using namespace convbn;
  EmuRun run;
  const auto go = [&](auto seq) {
    return seq(run, (const bf16*)x, (const bf16*)a, (const bf16*)b,
               (const bf16*)w, y, (float*)part, (float*)s1, (float*)s2, M, K,
               N);
  };
  return prologue ? go(fwd_sequence<true, EmuRun>)
                  : go(fwd_sequence<false, EmuRun>);
}

extern "C" int emu_conv_bn_bwd(const void* x, const void* a, const void* b,
                               const void* w, const void* y, const void* dy,
                               const void* ds1, const void* ds2, void* dyt,
                               void* dx, void* part, void* da, void* db,
                               void* dz_part, void* dw_part, void* dw, int M,
                               int K, int N, int prologue, int chunk,
                               int splits, int dz_chunk, int dz_splits) {
  using namespace convbn;
  EmuRun run;
  const auto go = [&](auto seq) {
    return seq(run, (const bf16*)x, (const bf16*)a, (const bf16*)b,
               (const bf16*)w, (const bf16*)y, (const bf16*)dy,
               (const float*)ds1, (const float*)ds2, (bf16*)dyt, dx,
               (float*)part, (float*)da, (float*)db, (float*)dz_part,
               (float*)dw_part, (float*)dw, M, K, N, chunk, splits, dz_chunk,
               dz_splits);
  };
  return prologue ? go(bwd_sequence<true, EmuRun>)
                  : go(bwd_sequence<false, EmuRun>);
}

// block_norm_bwd.cu's launch sequences with a launcher that runs each grid
// here.
namespace norm {

struct EmuRun {
  int norm(int chunks, int groups, const NormArgs& a) {
    const auto go = [&](auto kernel) {
      run_grid({(unsigned)groups, 1, 1}, {(unsigned)(LNB_WARPS * 32), 1, 1},
               kernel);
      return 0;
    };
    switch (chunks) {
      case 1: return go([&] { layernorm_bwd_kernel<1>(a); });
      case 2: return go([&] { layernorm_bwd_kernel<2>(a); });
      case 3: return go([&] { layernorm_bwd_kernel<3>(a); });
      case 4: return go([&] { layernorm_bwd_kernel<4>(a); });
    }
    return 1;
  }
  int colsum(dim3 grid, const bf16* in, float* part, int rows, int cols,
             int rows_per_chunk) {
    run_grid(grid, {(unsigned)COLSUM_X, (unsigned)COLSUM_Y, 1}, [&] {
      colsum_kernel(in, part, rows, cols, rows_per_chunk);
    });
    return 0;
  }
  int sums(const float* part, float* lo, float* hi, int groups, int cols,
           int half) {
    return emu_sums(part, lo, hi, groups, cols, half);
  }
};

}  // namespace norm

extern "C" int emu_layernorm_bwd(const void* x, const void* gamma,
                                 const void* dy, const void* dres, void* dx,
                                 void* part, void* out, int rows, int cols,
                                 float eps, int rows_per_group, int groups) {
  using namespace norm;
  EmuRun run;
  const NormArgs a{(const bf16*)x,    (const float*)gamma, (const float*)dy,
                   (const bf16*)dres, (bf16*)dx,           (float*)part,
                   rows,              cols,                rows_per_group,
                   eps};
  return norm_sequence(run, a, groups, (float*)out);
}

extern "C" int emu_colsum(const void* in, void* part, void* out, int rows,
                          int cols, int rows_per_chunk, int chunks) {
  using namespace norm;
  EmuRun run;
  return colsum_sequence(run, (const bf16*)in, (float*)part, (float*)out,
                         rows, cols, rows_per_chunk, chunks);
}

// csr_segment.cu's scalar sum, as ag_csr_scalar_sum_f32 launches it.
namespace csr {

struct EmuRun {
  int scalar_chunks(int lanes, int blocks, const float* w, const Plan& plan,
                    int C, float* part, float* out) {
    const auto go = [&](auto kernel) {
      run_grid({(unsigned)blocks, 1, 1}, {256, 1, 1}, kernel);
      return 0;
    };
    switch (lanes) {
      case 4: return go([&] { csr_scalar_chunk_kernel<4>(w, plan, C, part,
                                                          out); });
      case 16: return go([&] { csr_scalar_chunk_kernel<16>(w, plan, C, part,
                                                            out); });
      case 32: return go([&] { csr_scalar_chunk_kernel<32>(w, plan, C, part,
                                                            out); });
    }
    return 1;
  }
  int scalar_merge(int blocks, const Plan& plan, int M, const float* part,
                   float* out) {
    run_grid({(unsigned)blocks, 1, 1}, {256, 1, 1},
             [&] { csr_scalar_merge_kernel(plan, M, part, out); });
    return 0;
  }
};

}  // namespace csr

extern "C" int emu_csr_scalar_sum(const void* w, const void* plan, int C,
                                  int M, void* scratch, void* out,
                                  int lanes) {
  using namespace csr;
  EmuRun run;
  return scalar_sequence(run, (const float*)w,
                         make_plan((const int*)plan, C, M), C, M,
                         (float*)scratch, (float*)out, lanes);
}

// batchnorm.cu's entry points with a launcher that runs each grid here.
namespace bn {

struct EmuRun {
  template <class A>
  int go(void (*kernel)(const A), dim3 grid, dim3 block, const A& args) {
    run_grid(grid, block, [&] { kernel(args); });
    return 0;
  }
};

}  // namespace bn

extern "C" int emu_bn_stats(const void* x, void* part, int M, int C,
                            int rows_per_chunk, int chunks) {
  bn::EmuRun run;
  return bn::stats_entry(run, x, part, M, C, rows_per_chunk, chunks);
}

extern "C" int emu_bn_finish(const void* p1, const void* p2, int groups,
                             int stride, const void* n_dev, float n_host,
                             const void* w, const void* bias, void* rm,
                             void* rv, void* nbt, void* a, void* b,
                             void* saved, void* sums, int C, int mode,
                             float eps, float momentum, float keep) {
  bn::EmuRun run;
  return bn::finish_entry(run, p1, p2, groups, stride, n_dev, n_host, w, bias,
                          rm, rv, nbt, a, b, saved, sums, C, mode, eps,
                          momentum, keep);
}

extern "C" int emu_bn_apply(const void* x0, const void* a0, const void* b0,
                            const void* x1, const void* a1, const void* b1,
                            const void* id, void* out, int M, int C, int relu,
                            int rows_per_chunk, int chunks) {
  bn::EmuRun run;
  return bn::apply_entry(run, x0, a0, b0, x1, a1, b1, id, out, M, C, relu,
                         rows_per_chunk, chunks);
}

extern "C" int emu_bn_colsum(const void* g, const void* o, const void* x0,
                             const void* x1, void* part, int M, int C,
                             int rows_per_chunk, int chunks) {
  bn::EmuRun run;
  return bn::colsum_entry(run, g, o, x0, x1, part, M, C, rows_per_chunk,
                          chunks);
}

extern "C" int emu_bn_finish_bwd(const void* p1, const void* p2, int groups,
                                 int stride, const void* da, const void* db,
                                 const void* saved, const void* w,
                                 const void* n_dev, float n_host, void* dw,
                                 void* dbias, void* cs, int C, int train) {
  bn::EmuRun run;
  return bn::finish_bwd_entry(run, p1, p2, groups, stride, da, db, saved, w,
                              n_dev, n_host, dw, dbias, cs, C, train);
}

extern "C" int emu_bn_dx(const void* g, const void* o, const void* x0,
                         const void* a0, const void* cs0, const void* x1,
                         const void* a1, const void* cs1, void* dx0,
                         void* dx1, void* did, int M, int C,
                         int rows_per_chunk, int chunks) {
  bn::EmuRun run;
  return bn::dx_entry(run, g, o, x0, a0, cs0, x1, a1, cs1, dx0, dx1, did, M,
                      C, rows_per_chunk, chunks);
}
