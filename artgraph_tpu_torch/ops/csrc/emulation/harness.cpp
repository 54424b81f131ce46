// Runs the port's CUDA kernels on the host: the attention cores, the
// conv + BN-statistics unit (conv_bn.cu), the LayerNorm backward and
// column sums (block_norm_bwd.cu) and the CSR scalar sum (csr_segment.cu),
// each of the last three in its own namespace, with the second pass of
// sum_groups.cuh. The patched sources
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
