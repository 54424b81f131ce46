// Host stand-in for <cuda_runtime.h>: each thread of a block is a host
// thread; __syncthreads and __syncwarp are barriers, and the warp-wide
// operations exchange values through the block's EmuBlock.
#pragma once
#include <math.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

#include <barrier>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __align__(n) __attribute__((aligned(n)))
#define __shared__ static  // blocks run one after another

struct dim3 {
  unsigned x = 1, y = 1, z = 1;
};
struct alignas(16) uint4 {
  unsigned x, y, z, w;
};
extern thread_local dim3 threadIdx, blockIdx;
extern dim3 gridDim, blockDim;

struct EmuBlock {
  std::barrier<>* block;
  std::barrier<>* warp[32];
  float fx[32][32];
  const void* px[32][32];
  uint32_t ux[32][32][6];
};
extern EmuBlock* emu;

inline int emu_warp() { return threadIdx.x >> 5; }
inline int emu_lane() { return threadIdx.x & 31; }
inline void __syncthreads() { emu->block->arrive_and_wait(); }
inline void __syncwarp() { emu->warp[emu_warp()]->arrive_and_wait(); }
inline float __shfl_xor_sync(unsigned, float v, int mask) {
  const int w = emu_warp(), l = emu_lane();
  emu->fx[w][l] = v;
  __syncwarp();
  const float r = emu->fx[w][l ^ mask];
  __syncwarp();
  return r;
}
inline float __shfl_sync(unsigned, float v, int src) {
  const int w = emu_warp(), l = emu_lane();
  emu->fx[w][l] = v;
  __syncwarp();
  const float r = emu->fx[w][src];
  __syncwarp();
  return r;
}
inline float __uint_as_float(uint32_t u) {
  float f;
  memcpy(&f, &u, 4);
  return f;
}
