// Host stand-in for <cuda_runtime.h>: each thread of a block is a host
// thread (blocks of up to 32 warps); __syncthreads and __syncwarp are barriers, and the warp-wide
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

constexpr int cudaErrorInvalidValue = 1;  // the entry points' refusal

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1)
      : x(x_), y(y_), z(z_) {}
};
struct alignas(16) uint4 {
  unsigned x, y, z, w;
};
struct alignas(8) float2 {
  float x, y;
};
struct alignas(16) float4 {
  float x, y, z, w;
};
struct alignas(8) int2 {
  int x, y;
};
inline float2 make_float2(float x, float y) { return {x, y}; }
template <class T>
inline T __ldg(const T* p) {
  return *p;
}
inline float rsqrtf(float v) { return 1.0f / sqrtf(v); }
inline uint4 make_uint4(unsigned x, unsigned y, unsigned z, unsigned w) {
  return {x, y, z, w};
}
inline int min(int a, int b) { return a < b ? a : b; }
extern thread_local dim3 threadIdx, blockIdx;
extern thread_local int emu_tid;  // the thread's linear index in its block
extern dim3 gridDim, blockDim;

struct EmuBlock {
  std::barrier<>* block;
  std::barrier<>* warp[32];
  float fx[32][32];
  const void* px[32][32];
  uint32_t ux[32][32][6];
  uint32_t sx[32][32];
};
extern EmuBlock* emu;

inline int emu_warp() { return emu_tid >> 5; }
inline int emu_lane() { return emu_tid & 31; }
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
inline uint32_t __shfl_sync(unsigned, uint32_t v, int src) {
  const int w = emu_warp(), l = emu_lane();
  emu->sx[w][l] = v;
  __syncwarp();
  const uint32_t r = emu->sx[w][src];
  __syncwarp();
  return r;
}
// lane l + delta's value, or l's own where that is past the warp
inline float __shfl_down_sync(unsigned, float v, unsigned delta) {
  const int w = emu_warp(), l = emu_lane();
  emu->fx[w][l] = v;
  __syncwarp();
  const float r = l + delta < 32 ? emu->fx[w][l + delta] : v;
  __syncwarp();
  return r;
}
inline float __uint_as_float(uint32_t u) {
  float f;
  memcpy(&f, &u, 4);
  return f;
}
