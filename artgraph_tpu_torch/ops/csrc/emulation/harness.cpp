// Runs the attention cores' kernels on the host: the patched sources are
// included here, and every block of a grid runs as 128 host threads, one
// block after another. Built and driven by ops/attention_emulation.py.
#include <stdio.h>
#include <stdlib.h>

#include <thread>

#include "cuda_runtime.h"

thread_local dim3 threadIdx, blockIdx;
dim3 gridDim, blockDim;
EmuBlock* emu;

#include "block_attention.cu"
#include "block_attention_bwd.cu"

thread_local std::vector<attn::EmuCopy> attn::emu_copies;
thread_local int attn::emu_group;

template <class F>
static void run_grid(dim3 grid, F kernel) {
  gridDim = grid;
  blockDim = {(unsigned)attn::THREADS, 1, 1};
  for (unsigned z = 0; z < grid.z; ++z)
    for (unsigned y = 0; y < grid.y; ++y)
      for (unsigned x = 0; x < grid.x; ++x) {
        EmuBlock blk;
        std::barrier<> block(attn::THREADS);
        std::vector<std::barrier<>*> warps;
        for (int w = 0; w < attn::WARPS; ++w)
          warps.push_back(blk.warp[w] = new std::barrier<>(32));
        blk.block = &block;
        emu = &blk;
        std::vector<std::thread> threads;
        for (unsigned t = 0; t < (unsigned)attn::THREADS; ++t)
          threads.emplace_back([&, t] {
            threadIdx = {t, 0, 0};
            blockIdx = {x, y, z};
            attn::emu_copies.clear();
            attn::emu_group = 0;
            kernel();
            if (!attn::emu_copies.empty()) {
              fprintf(stderr, "cp.async copies never waited for\n");
              abort();
            }
          });
        for (std::thread& t : threads) t.join();
        for (std::barrier<>* w : warps) delete w;
      }
}

static dim3 grid_of(int B, int N, int H) {
  return {(unsigned)((N + attn::TILE - 1) / attn::TILE), (unsigned)H,
          (unsigned)B};
}

using attn::bf16;

extern "C" int emu_attention(int strided, const void* q, const void* k,
                             const void* v, void* o, int B, int N, int H,
                             int ld_q, int ld_k, int ld_v, int ld_o,
                             float scale) {
  const FwdArgs a{{(const bf16*)q, ld_q}, {(const bf16*)k, ld_k},
                  {(const bf16*)v, ld_v}, (bf16*)o, ld_o};
  if (strided)
    run_grid(grid_of(B, N, H), [&] { attention_core_kernel<true>(a, N, scale); });
  else
    run_grid(grid_of(B, N, H), [&] { attention_core_kernel<false>(a, N, scale); });
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
    run_grid(grid_of(B, N, H),
             [&] { attention_bwd_dq_kernel<true>(a, st, N, H, scale); });
  else
    run_grid(grid_of(B, N, H),
             [&] { attention_bwd_dq_kernel<false>(a, st, N, H, scale); });
  run_grid(grid_of(B, N, H),
           [&] { attention_bwd_dkv_kernel(a, st, N, H, scale); });
  return 0;
}
