// The warp-level PTX the port's mma.sync kernels share (the attention cores
// through attention_tiles.cuh, and the conv + BN-statistics unit,
// conv_bn.cu): cp.async 16- and 4-byte copies with zero-fill into shared
// memory, their commit and wait, ldmatrix (plain and .trans), mma.sync
// m16n8k16 bf16 -> f32, the bf16 pair packing, and the lane-quad transpose
// that turns an accumulator's pairs into 16-byte stores (which the wgmma
// GEMM, block_gemm.cu, uses too: its accumulator has the same quads).
//
// Fragment layouts (PTX ISA, mma.m16n8k16 .bf16; g = lane / 4, t = lane % 4):
//   A 16x16, 4 registers of 2 bf16: {row g, cols 2t..2t+1}, {row g+8, cols
//     2t..}, {row g, cols 8+2t..}, {row g+8, cols 8+2t..};
//   B 16x8, 2 registers: {k 2t..2t+1, col g}, {k 8+2t.., col g};
//   C 16x8 f32: {row g, cols 2t, 2t+1}, {row g+8, cols 2t, 2t+1}.
//
// ops/attention_emulation.py replaces the helpers between `smem_addr` and
// `pack_bf16` with the host versions of emulation/ptx_emulation.h, so that
// the kernels built on them run on the CPU.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ptx {

// A kernel's dynamic shared memory, 128-byte aligned.
#define AG_DYNAMIC_SMEM(name) \
  extern __shared__ __align__(128) unsigned char name[]

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; !valid writes 16 zero bytes instead (the
// source address must still be a mapped one).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

// 4-byte global -> shared copy; !valid writes zeros.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Waits until at most PENDING of this thread's committed groups are in
// flight: its own copies of the older groups have landed.
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4],
                                        const __nv_bfloat16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const __nv_bfloat16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// bf16(lo) in the low half, bf16(hi) in the high half (round to nearest).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The two bf16 of a packed pair as f32 (exact).
__device__ __forceinline__ float bf16_lo(uint32_t u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t u) {
  return __uint_as_float(u & 0xffff0000u);
}

// x rotated by r (0..3) places: left, y[i] = x[(i + r) & 3], or right,
// y[i] = x[(i - r) & 3]; r is this lane's, so the registers stay static.
template <bool LEFT>
__device__ __forceinline__ void rotate4(uint32_t (&x)[4], int r) {
  if (r & 1) {
    const uint32_t t = LEFT ? x[0] : x[3];
    if (LEFT) {
      x[0] = x[1];
      x[1] = x[2];
      x[2] = x[3];
      x[3] = t;
    } else {
      x[3] = x[2];
      x[2] = x[1];
      x[1] = x[0];
      x[0] = t;
    }
  }
  if (r & 2) {
    uint32_t t = x[0];
    x[0] = x[2];
    x[2] = t;
    t = x[1];
    x[1] = x[3];
    x[3] = t;
  }
}

// A 4 x 4 transpose of packed pairs within each quad of lanes: lane q
// holds p[i] = columns 2q, 2q + 1 of n8 tile i of its row; it returns the
// eight columns of tile q, so that one 16-byte store covers them. (Writing
// the pairs as they lie stores 16 bytes of each 32-byte sector at a time,
// which runs a bf16 epilogue at a fraction of the device's write rate.)
__device__ __forceinline__ void quad_transpose(uint32_t (&p)[4], int q) {
  rotate4<true>(p, q);  // round k sends tile (q + k) & 3 to lane (q + k) & 3
  uint32_t r[4];
  const int base = (threadIdx.x & 31) & ~3;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    r[k] = __shfl_sync(0xffffffffu, p[k], base | ((q - k) & 3));
  // r[k] came from lane (q - k) & 3: columns 2((q - k) & 3).. of tile q
  p[0] = r[0];
  p[1] = r[3];
  p[2] = r[2];
  p[3] = r[1];
  rotate4<false>(p, q);
}

}  // namespace ptx
