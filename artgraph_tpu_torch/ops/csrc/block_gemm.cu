// Row LayerNorm and the bf16 GEMM with fused epilogues: the pieces that the
// transformer-block kernels (ops/attention.py, ops/mlp.py) launch, in both
// directions.
//
// Replaces the LayerNorm and the dense products inside the Pallas kernels
// artgraph_tpu/ops/attention.py:_block_fwd_kernel (norm1, qkv, proj) and
// _block_bwd_kernel (do . W_proj, dqkv . W_qkv, dW_qkv, dW_proj), and
// artgraph_tpu/ops/mlp.py:_mlp_fwd_kernel (norm2, fc1 + GELU, fc2) and
// _mlp_bwd_kernel (do . W2 through GELU', dh . W1, dW1, dW2); also the qkv
// products of _qkv_fwd_kernel and _qkv_bwd_kernel (ops/attention.py).
//
// Rounding points are the Pallas kernels' own, so kernel and plain version
// differ only in accumulation order:
//   LayerNorm:  f32 stats, var = max(E[x^2] - E[x]^2, 0), y = bf16(xhat*g + b)
//   GEMM:       f32 accumulation of bf16 products;
//               v = bf16(acc + f32(bf16 bias))
//   GELU:       act = bf16(gelu_erf(f32(v)))  (erf form; erf as the Pallas
//               kernels evaluate it, see erf_as)
//   residual:   out = bf16(f32(x) + f32(v))
//   backward:   do_attn = bf16(acc); dh = bf16(acc * gelu'(f32(h)));
//               dy, dW = acc in f32 (one rounding, none)
//
// What bounds it on an H100: at ViT-B/16 shapes (M = 32*197 = 6304 rows,
// K and N in {768, 2304, 3072}; K = 6304 for the weight gradients) the
// products do 360 or more FLOP per byte they must move, above the card's
// ~295: the tensor cores bound them, and only wgmma reaches their rate. The
// LayerNorm is bound by device memory. The GEMM is the Hopper one:
//   * One persistent block an SM walks 128x128 output tiles. A producer
//     warp keeps a ring of STAGES = 6 k-steps of 64 (32 KB each, 193 KB of
//     dynamic shared memory) filled with TMA (cp.async.bulk.tensor) copies:
//     full/empty mbarriers per stage, the TMA's transaction bytes
//     completing `full`, the reading warps' arrivals after their wgmma
//     group retires releasing `empty`. Two consumer warpgroups take the
//     tiles in turn (ping-pong), each with the whole tile in its registers
//     (two wgmma.mma_async m64n128k16 a k16 step, bf16 in, f32 accumulate,
//     one group left in flight over the next stage's wait): the epilogue of
//     one tile runs while the other group's products keep the tensor
//     cores busy. (On an H100 SXM, without its epilogue this loop ran the
//     wide products at 600-700 TFLOP/s, and an epilogue that waited for
//     its stores took a third to a half of the time.)
//   * Operands sit in shared memory in wgmma's canonical 128-byte swizzled
//     layout, which the TMA writes itself (CU_TENSOR_MAP_SWIZZLE_128B): a
//     k-major operand (A of NT/NN, B of NT) as 64-element (128-byte) rows,
//     an m- or n-major one (A of TN, B of NN/TN) as [64 k][64] boxes. The
//     three layouts differ only in the descriptors and wgmma's transpose
//     bits. The TMA zero-fills what lies beyond M, N or K (the ragged
//     M = 6304 = 49.25 x 128 and the weight gradients' K).
//   * Tile counts at ViT-B/16 against the card's 264 warpgroups: qkv 900;
//     proj, fc2 and the NN products onto 768 300 each; fc1 and do . W2
//     1200 each. The weight gradients (TN) have few tiles (dW_qkv 108,
//     dW_proj 36, dW1 and dW2 144), so their K is split into chunks of
//     whole k-steps (`tn_splits`: 3, 8, 2, 2 at K = 6304) that write f32
//     partials, added in chunk order by the second pass of sum_groups.cuh.
//     No atomics: every output is bit-identical from call to call.
//   * The epilogues read the accumulator registers (wgmma's layout: the
//     warp's 16 rows, column pairs 8j + 2 (lane % 4)) at the rounding
//     points above; the f32 output goes out as the pairs lie, a bf16 one
//     through a transpose within each lane quad to 16-byte stores
//     (ptx_helpers.cuh).
// Tensor maps are encoded on the host per launch with cuTensorMapEncodeTiled
// (through cudaGetDriverEntryPoint: no -lcuda) and passed as
// __grid_constant__ parameters; the shared-memory attribute is set once per
// process, so a launch is safe to capture in a CUDA graph.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ptx_helpers.cuh"
#include "sum_groups.cuh"

namespace {

using bf16 = __nv_bfloat16;
using ptx::pack_bf16;
using ptx::quad_transpose;

constexpr int LN_ROWS_PER_BLOCK = 8;  // one warp per row

__global__ void __launch_bounds__(LN_ROWS_PER_BLOCK * 32)
layernorm_rows_kernel(const __nv_bfloat16* __restrict__ x,
                      const float* __restrict__ gamma,
                      const float* __restrict__ beta,
                      __nv_bfloat16* __restrict__ y, int rows, int cols,
                      float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * LN_ROWS_PER_BLOCK + warp;
  if (row >= rows) return;
  const __nv_bfloat16* xr = x + (size_t)row * cols;
  float s = 0.f, s2 = 0.f;
  for (int c = lane; c < cols; c += 32) {
    const float v = __bfloat162float(xr[c]);
    s += v;
    s2 += v * v;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, o);
    s2 += __shfl_xor_sync(0xffffffffu, s2, o);
  }
  const float mean = s / (float)cols;
  const float mean2 = s2 / (float)cols;
  const float var = fmaxf(__fsub_rn(mean2, __fmul_rn(mean, mean)), 0.f);
  const float rstd = rsqrtf(var + eps);
  __nv_bfloat16* yr = y + (size_t)row * cols;
  for (int c = lane; c < cols; c += 32) {
    const float xhat =
        __fmul_rn(__fsub_rn(__bfloat162float(xr[c]), mean), rstd);
    yr[c] = __float2bfloat16(__fadd_rn(__fmul_rn(xhat, gamma[c]), beta[c]));
  }
}

constexpr int BM = 128, BN = 128, BK = 64;
constexpr int STAGES = 6;
constexpr int CONSUMERS = 2;                    // warpgroups, a tile each
constexpr int GEMM_THREADS = CONSUMERS * 128 + 32;  // + the producer warp
constexpr int TILE_A = BM * BK * 2, TILE_B = BN * BK * 2;  // bytes
constexpr int STAGE_BYTES = TILE_A + TILE_B;
constexpr int GEMM_SMEM = 1024 + STAGES * STAGE_BYTES + (2 * STAGES + 2) * 8;
constexpr int BOX = 64;            // elements in a 128-byte swizzled row
constexpr int BOX_BYTES = BOX * BOX * 2;  // one [64][64] box
// the split-K weight gradients: about a tile for each consumer warpgroup
// of the card, each chunk at least MIN_SPLIT_STEPS k-steps, at most
// SUM_SEQ_MAX_GROUPS chunks (the in-order pass of sum_groups.cuh)
constexpr int MIN_SPLIT_STEPS = 4;

// Operand layouts, out[M,N] = sum_k A(m,k) B(k,n):
//   NT: A [M,K] row-major, B stored [N,K] (nn.Linear weight: y = a . W^T)
//   NN: A [M,K] row-major, B stored [K,N] (grad of an input: dy . W)
//   TN: A stored [K,M],    B stored [K,N] (grad of a weight: dz^T . a)
enum Layout { LAYOUT_NT = 0, LAYOUT_NN = 1, LAYOUT_TN = 2 };

enum Epilogue {
  EPI_BIAS = 0,           // bf16(acc + bias)
  EPI_BIAS_GELU = 1,      // bf16(gelu(bf16(acc + bias)))
  EPI_BIAS_RESIDUAL = 2,  // bf16(R + bf16(acc + bias))
  EPI_BIAS_GELU_AUX = 3,  // h = bf16(acc + bias) -> out, bf16(gelu(h)) -> out2
  EPI_NONE = 4,           // bf16(acc)
  EPI_F32 = 5,            // acc, f32 output
  EPI_DGELU = 6,          // bf16(acc * gelu'(aux)), aux = the bf16 fc1 output
};

// erf(x) by Abramowitz-Stegun 7.1.26 with e = exp(-x^2) given, as the
// Pallas kernels compute it (artgraph_tpu/ops/mlp.py:_erf_f32; |error| <=
// 1.5e-7, four orders below bf16's rounding): branch-free, one reciprocal.
// With CUDA's erff and expf the dGELU epilogue spilled 88 bytes (ptxas,
// 168 registers); with this, no instantiation spills.
__device__ __forceinline__ float erf_as(float x, float e) {
  const float t = __fdividef(1.0f, fmaf(0.3275911f, fabsf(x), 1.0f));
  const float poly =
      t * (0.254829592f +
           t * (-0.284496736f +
                t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  return copysignf(1.0f - poly * e, x);
}

__device__ __forceinline__ float gelu_erf(float h) {
  const float x = h * 0.70710678118654752f;
  return 0.5f * h * (1.0f + erf_as(x, __expf(-x * x)));
}

// d gelu(h) / dh = Phi(h) + h phi(h); phi shares erf's exponential
__device__ __forceinline__ float gelu_erf_grad(float h) {
  const float x = h * 0.70710678118654752f;
  const float e = __expf(-x * x);  // exp(-h^2 / 2)
  return 0.5f * (1.0f + erf_as(x, e)) + h * (0.3989422804014327f * e);
}

// --- mbarriers, TMA and wgmma (sm_90a) -------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}

// One arrival that also expects `bytes` of TMA transactions on the barrier.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Spins until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// The box of `map` at (c0 inner, c1 outer) into shared memory at dst,
// completing its bytes on the barrier; out-of-bounds elements read as zero.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// A shared-memory matrix descriptor, 128-byte swizzle: start address,
// leading byte offset (between 64-element chunks along M or N of an m- or
// n-major operand; unused for k-major), stride byte offset (between groups
// of 8 rows: 1024 bytes).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(PENDING)
               : "memory");
}

// Keeps the compiler from moving accesses of the accumulators across the
// asynchronous wgmma (it sees them written only by the issuing asm).
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 128] += A[64 x 16] . B[16 x 128] from shared memory; TA / TB: the
// operand is m- / n-major (transposed against wgmma's k-major default).
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// --- the GEMM --------------------------------------------------------------

// The epilogue of 64 rows of a tile from the registers: acc[4j + 2h + e] is
// row half*64 + 16 (warp % 4) + lane/4 + 8h, column 8j + 2 (lane % 4) + e. The
// f32 output goes out as the pairs lie (a lane quad fills a 32-byte
// sector). A bf16 one is rounded where it lies (bf16(acc), bf16(acc + bias)),
// transposed within the quad, and finished on each lane's 8 consecutive
// columns (gelu, the residual); EPI_DGELU transposes the f32 acc instead,
// to read h there. So every load and store is 16 bytes (N % 8 == 0).
template <int EPI>
__device__ __forceinline__ void epilogue(const float (&acc)[BN / 2],
                                         const bf16* __restrict__ bias,
                                         const bf16* __restrict__ aux,
                                         void* __restrict__ out,
                                         bf16* __restrict__ out2, int M,
                                         int N, int z, int m0, int n0,
                                         int half, int warp, int lane) {
  const int q = lane & 3;
  const int row0 = m0 + half * 64 + (warp & 3) * 16 + (lane >> 2);
  const int col0 = n0 + 2 * q;
  if constexpr (EPI == EPI_F32) {
    float* dst = static_cast<float*>(out) + (size_t)z * M * N;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = col0 + 8 * j;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row0 + 8 * h;
        if (r < M && c < N)
          *reinterpret_cast<float2*>(dst + (size_t)r * N + c) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
  } else {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + 8 * h;
#pragma unroll
      for (int jg = 0; jg < BN / 32; ++jg) {
        // the acc-side rounding at the pairs, then the transpose: v holds
        // this lane's 8 consecutive columns c8.. of row r
        const int c8 = n0 + 32 * jg + 8 * q;
        const bool in = r < M && c8 < N;
        uint32_t v[4];
        if (EPI == EPI_DGELU) {
          // bf16(acc gelu'(h)) needs the f32 acc at h's columns: transpose
          // the two halves of the pairs, then read h 16 bytes at a time
          uint32_t lo[4], hi[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            lo[i] = __float_as_uint(acc[4 * (4 * jg + i) + 2 * h]);
            hi[i] = __float_as_uint(acc[4 * (4 * jg + i) + 2 * h + 1]);
          }
          quad_transpose(lo, q);  // lo[s], hi[s]: columns 2s, 2s + 1
          quad_transpose(hi, q);
          uint4 hv = make_uint4(0u, 0u, 0u, 0u);
          if (in)
            hv = *reinterpret_cast<const uint4*>(aux + (size_t)r * N + c8);
          const uint32_t hh[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
            v[i] = pack_bf16(
                __uint_as_float(lo[i]) * gelu_erf_grad(ptx::bf16_lo(hh[i])),
                __uint_as_float(hi[i]) * gelu_erf_grad(ptx::bf16_hi(hh[i])));
          if (in)
            *reinterpret_cast<uint4*>(static_cast<bf16*>(out) +
                                      (size_t)r * N + c8) =
                make_uint4(v[0], v[1], v[2], v[3]);
          continue;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int j = 4 * jg + i, c = col0 + 8 * j;
          const float a0 = acc[4 * j + 2 * h], a1 = acc[4 * j + 2 * h + 1];
          if (EPI == EPI_NONE) {
            v[i] = pack_bf16(a0, a1);
          } else {  // h = bf16(acc + bias)
            float b0 = 0.f, b1 = 0.f;
            if (c < N) {
              const __nv_bfloat162 bb =
                  *reinterpret_cast<const __nv_bfloat162*>(bias + c);
              b0 = __bfloat162float(bb.x);
              b1 = __bfloat162float(bb.y);
            }
            v[i] = pack_bf16(a0 + b0, a1 + b1);
          }
        }
        quad_transpose(v, q);
        if (!in) continue;
        const size_t o = (size_t)r * N + c8;
        bf16* dst = static_cast<bf16*>(out) + o;
        if (EPI == EPI_BIAS_GELU_AUX) {  // h to out, gelu(h) to out2
          *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
          dst = out2 + o;
        }
        if (EPI == EPI_BIAS_GELU || EPI == EPI_BIAS_GELU_AUX) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            v[i] = pack_bf16(gelu_erf(ptx::bf16_lo(v[i])),
                             gelu_erf(ptx::bf16_hi(v[i])));
        }
        if (EPI == EPI_BIAS_RESIDUAL) {  // bf16(R + h)
          const uint4 rv = *reinterpret_cast<const uint4*>(aux + o);
          const uint32_t rr[4] = {rv.x, rv.y, rv.z, rv.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
            v[i] = pack_bf16(ptx::bf16_lo(rr[i]) + ptx::bf16_lo(v[i]),
                             ptx::bf16_hi(rr[i]) + ptx::bf16_hi(v[i]));
        }
        *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
      }
    }
  }
}

// Work unit u: chunk z of the K split, the tile's origin, its k-steps.
struct Unit {
  int z, m0, n0, nk;
};

__device__ __forceinline__ Unit unit_of(int u, int per_split, int tiles_n,
                                        int K, int k_chunk) {
  const int z = u / per_split, t = u % per_split;
  return {z, (t / tiles_n) * BM, (t % tiles_n) * BN,
          (min(K, z * k_chunk + k_chunk) - z * k_chunk + BK - 1) / BK};
}

// A persistent block: it walks the work units u = blockIdx.x, + gridDim.x,
// ..., each a 128 x 128 tile of out (or, with the K split in `splits`
// chunks of k_chunk, chunk z's f32 partial: out + z * M * N), N tiles
// fastest. Its two consumer warpgroups take the units in turn (ping-pong):
// while one runs its tile's epilogue, the other's products run. The
// producer loads the units' k-steps into the ring in unit order, so each
// stage is read by one warpgroup, and the ring's phases run on across the
// units.
template <int EPI, int LAYOUT>
__global__ void __launch_bounds__(GEMM_THREADS, 1)
gemm_kernel(const __grid_constant__ CUtensorMap map_a,
            const __grid_constant__ CUtensorMap map_b,
            const bf16* __restrict__ bias, const bf16* __restrict__ aux,
            void* __restrict__ out, bf16* __restrict__ out2, int M, int N,
            int K, int k_chunk, int splits) {
  constexpr bool A_KMAJOR = LAYOUT != LAYOUT_TN;
  constexpr bool B_KMAJOR = LAYOUT == LAYOUT_NT;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the swizzled tiles need 1024-byte alignment
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t tiles = (raw + 1023) & ~1023u;
  const uint32_t full = tiles + STAGES * STAGE_BYTES;  // STAGES mbarriers
  const uint32_t empty = full + STAGES * 8;            // STAGES mbarriers

  // done[w]: warpgroup w has waited through its tile's k-steps
  const uint32_t done = empty + STAGES * 8;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tiles_n = (N + BN - 1) / BN;
  const int per_split = tiles_n * ((M + BM - 1) / BM);
  const int units = per_split * splits;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4);  // the 4 warps of the reading group
    }
    mbar_init(done, 1);
    mbar_init(done + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == CONSUMERS * 4) {
    // producer: one thread keeps the ring full
    if (lane != 0) return;
    int it = 0;  // k-steps through the ring so far
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const Unit t = unit_of(u, per_split, tiles_n, K, k_chunk);
      const int z = t.z, m0 = t.m0, n0 = t.n0, nk = t.nk;
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int s = it % STAGES;
        const uint32_t a = tiles + s * STAGE_BYTES, b = a + TILE_A;
        const uint32_t bar = full + 8 * s;
        const int k0 = z * k_chunk + kt * BK;
        mbar_wait(empty + 8 * s, ((it / STAGES) & 1) ^ 1);
        mbar_expect_tx(bar, STAGE_BYTES);
        if (A_KMAJOR) {
          tma_load(a, &map_a, bar, k0, m0);
        } else {
          tma_load(a, &map_a, bar, m0, k0);
          tma_load(a + BOX_BYTES, &map_a, bar, m0 + BOX, k0);
        }
        if (B_KMAJOR) {
          tma_load(b, &map_b, bar, k0, n0);
        } else {
          tma_load(b, &map_b, bar, n0, k0);
          tma_load(b + BOX_BYTES, &map_b, bar, n0 + BOX, k0);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg takes the block's units j = wg, wg + 2, ...
  // Unit j's products start only once the other group has waited through
  // unit j - 1's k-steps: a group never waits on a ring position more than
  // STAGES ahead of the last one waited on, where the stage's mbarrier
  // phases would alias.
  const int wg = warp >> 2;
  int it = 0;  // the ring position of unit j's first k-step
  for (int u = blockIdx.x, j = 0; u < units; u += gridDim.x, ++j) {
    const Unit t = unit_of(u, per_split, tiles_n, K, k_chunk);
    const int z = t.z, m0 = t.m0, n0 = t.n0, nk = t.nk;
    if ((j & 1) != wg) {
      it += nk;
      continue;
    }
    // the other group's arrivals so far: unit j - 1 is its (j - 1) / 2-th
    if (j > 0) mbar_wait(done + 8 * (wg ^ 1), ((j - 1) >> 1) & 1);
    float acc[2][BN / 2];  // rows 0-63 and 64-127 of the tile
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[0][i] = acc[1][i] = 0.f;
    fence_acc(acc[0]);
    fence_acc(acc[1]);
    for (int kt = 0; kt < nk; ++kt, ++it) {
      const int s = it % STAGES;
      const uint32_t a = tiles + s * STAGE_BYTES, b = a + TILE_A;
      mbar_wait(full + 8 * s, (it / STAGES) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        // k-major: 16 elements = 32 bytes along the swizzled row; m- or
        // n-major: 16 k-rows of 128 bytes
        const uint64_t db = B_KMAJOR ? smem_desc(b + kk * 32, 16)
                                     : smem_desc(b + kk * 2048, BOX_BYTES);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const uint64_t da =
              A_KMAJOR
                  ? smem_desc(a + half * 64 * 128 + kk * 32, 16)
                  : smem_desc(a + half * BOX_BYTES + kk * 2048, BOX_BYTES);
          wgmma_m64n128k16<A_KMAJOR ? 0 : 1, B_KMAJOR ? 0 : 1>(acc[half], da,
                                                               db);
        }
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous step's products are done: free it
      if (kt > 0 && lane == 0) mbar_arrive(empty + 8 * ((it - 1) % STAGES));
    }
    if (threadIdx.x % 128 == 0) mbar_arrive(done + 8 * wg);
    wgmma_wait<0>();
    fence_acc(acc[0]);
    fence_acc(acc[1]);
    if (lane == 0) mbar_arrive(empty + 8 * ((it - 1) % STAGES));
#pragma unroll
    for (int half = 0; half < 2; ++half)
      epilogue<EPI>(acc[half], bias, aux, out, out2, M, N, z, m0, n0, half,
                    warp, lane);
  }
}

// --- host side -------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime loaded (null if none).
EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// A row-major bf16 [outer, inner] operand read in boxes of [box_outer][64],
// 128-byte swizzled, zeros beyond its edges.
bool make_map(CUtensorMap* map, const void* ptr, int inner, int outer,
              int box_outer) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)inner * 2};
  const cuuint32_t box[2] = {(cuuint32_t)BOX, (cuuint32_t)box_outer};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The card's SMs (132 on an H100 SXM), read once.
int sm_count() {
  static const int n = [] {
    int dev = 0, count = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount,
                               dev) != cudaSuccess)
      count = 132;
    return count;
  }();
  return n;
}

// Chunks of the TN product's K: a unit for each consumer warpgroup of the
// card, each chunk whole k-steps and at least MIN_SPLIT_STEPS of them.
int tn_splits(int M, int N, int K) {
  const int tiles = ((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  const int slots = sm_count() * CONSUMERS;
  const int steps = (K + BK - 1) / BK;
  int want = (slots + tiles - 1) / tiles;
  want = min(want, SUM_SEQ_MAX_GROUPS);
  want = max(1, min(want, steps / MIN_SPLIT_STEPS));
  const int per = (steps + want - 1) / want;
  return (steps + per - 1) / per;
}

// What the kernel cannot take: TMA needs 16-byte row strides (rows of a
// multiple of 8 bf16), the epilogue's 16-byte stores rows of a multiple of
// 8 outputs, and the split sum of a TN product indexes its M x N outputs
// with an int.
bool bad_gemm_shape(int M, int N, int K, int layout) {
  if (M < 1 || N < 1 || K < 1 || N % 8) return true;
  switch (layout) {
    case LAYOUT_NT: return K % 8 != 0;
    case LAYOUT_NN: return K % 8 != 0;
    case LAYOUT_TN:
      return M % 8 != 0 || (long long)M * N > 0x7fffffff;
    default: return true;
  }
}

template <int EPI, int LAYOUT>
cudaError_t launch_gemm(const void* a, const void* b, const void* bias,
                        const void* aux, void* out, void* out2, int M, int N,
                        int K, cudaStream_t s) {
  // dynamic shared memory past 48 KB: allowed once per process, never on a
  // launch (which stays safe to capture in a CUDA graph)
  static const cudaError_t attr = cudaFuncSetAttribute(
      gemm_kernel<EPI, LAYOUT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      GEMM_SMEM);
  if (attr != cudaSuccess) return attr;
  CUtensorMap map_a, map_b;
  const bool ok =
      (LAYOUT == LAYOUT_TN ? make_map(&map_a, a, M, K, BOX)
                           : make_map(&map_a, a, K, M, BM)) &&
      (LAYOUT == LAYOUT_NT ? make_map(&map_b, b, K, N, BN)
                           : make_map(&map_b, b, N, K, BOX));
  if (!ok) return cudaErrorInvalidValue;
  const int splits = LAYOUT == LAYOUT_TN ? tn_splits(M, N, K) : 1;
  const int k_chunk = ((K + BK - 1) / BK + splits - 1) / splits * BK;
  const int units = ((N + BN - 1) / BN) * ((M + BM - 1) / BM) * splits;
  const int blocks = min((units + CONSUMERS - 1) / CONSUMERS, sm_count());
  // split: f32 partials in out2, added in chunk order into out
  gemm_kernel<EPI, LAYOUT><<<blocks, GEMM_THREADS, GEMM_SMEM, s>>>(
      map_a, map_b, (const bf16*)bias, (const bf16*)aux,
      splits > 1 ? out2 : out, (bf16*)out2, M, N, K, k_chunk, splits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  return sum_groups((const float*)out2, (float*)out, nullptr, splits, M * N,
                    M * N, s);
}

}  // namespace

extern "C" {

int ag_layernorm_bf16(const void* x, const void* gamma, const void* beta,
                      void* y, int rows, int cols, float eps, void* stream) {
  const dim3 grid((rows + LN_ROWS_PER_BLOCK - 1) / LN_ROWS_PER_BLOCK);
  layernorm_rows_kernel<<<grid, LN_ROWS_PER_BLOCK * 32, 0,
                          (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const float*)gamma, (const float*)beta,
      (__nv_bfloat16*)y, rows, cols, eps);
  return (int)cudaGetLastError();
}

// 0 if ag_gemm_bf16 refuses the shape (see bad_gemm_shape); else the chunks
// it splits the product's K into (TN only; 1 otherwise), whose f32 [M, N]
// partials its scratch out2 then holds.
int ag_gemm_splits(int M, int N, int K, int layout) {
  if (bad_gemm_shape(M, N, K, layout)) return 0;
  return layout == LAYOUT_TN ? tn_splits(M, N, K) : 1;
}

// out[M,N] = epilogue(sum_k A(m,k) B(k,n)) for the layouts and epilogues
// above. bf16 operands, contiguous and 16-byte aligned; N a multiple of 8,
// and so K for NT and NN, M for TN (rows of 16 bytes for the TMA).
// Pointers an epilogue does not read may be null: bias for EPI_BIAS*, aux for
// EPI_BIAS_RESIDUAL (the residual R) and EPI_DGELU (h), out2 for
// EPI_BIAS_GELU_AUX. out is f32 for EPI_F32 and bf16 otherwise. For TN, out2
// is f32 scratch of ag_gemm_splits(M, N, K, 2) x M x N (null if that is 1).
// Built combinations: NT with the four EPI_BIAS* epilogues, NN with
// EPI_NONE, EPI_F32 and EPI_DGELU, TN with EPI_F32.
int ag_gemm_bf16(const void* a, const void* b, const void* bias,
                 const void* aux, void* out, void* out2, int M, int N, int K,
                 int layout, int epilogue, void* stream) {
  if (bad_gemm_shape(M, N, K, layout)) return (int)cudaErrorInvalidValue;
  const bool needs_bias = epilogue <= EPI_BIAS_GELU_AUX;
  if ((needs_bias && bias == nullptr) ||
      ((epilogue == EPI_BIAS_RESIDUAL || epilogue == EPI_DGELU) &&
       aux == nullptr) ||
      (epilogue == EPI_BIAS_GELU_AUX && out2 == nullptr) ||
      (layout == LAYOUT_TN && tn_splits(M, N, K) > 1 && out2 == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define AG_GEMM(E, L) launch_gemm<E, L>(a, b, bias, aux, out, out2, M, N, K, s)
  cudaError_t err = cudaErrorInvalidValue;
  if (layout == LAYOUT_NT) {
    switch (epilogue) {
      case EPI_BIAS: err = AG_GEMM(EPI_BIAS, LAYOUT_NT); break;
      case EPI_BIAS_GELU: err = AG_GEMM(EPI_BIAS_GELU, LAYOUT_NT); break;
      case EPI_BIAS_RESIDUAL:
        err = AG_GEMM(EPI_BIAS_RESIDUAL, LAYOUT_NT);
        break;
      case EPI_BIAS_GELU_AUX:
        err = AG_GEMM(EPI_BIAS_GELU_AUX, LAYOUT_NT);
        break;
      default: break;
    }
  } else if (layout == LAYOUT_NN) {
    switch (epilogue) {
      case EPI_NONE: err = AG_GEMM(EPI_NONE, LAYOUT_NN); break;
      case EPI_F32: err = AG_GEMM(EPI_F32, LAYOUT_NN); break;
      case EPI_DGELU: err = AG_GEMM(EPI_DGELU, LAYOUT_NN); break;
      default: break;
    }
  } else if (layout == LAYOUT_TN && epilogue == EPI_F32) {
    err = AG_GEMM(EPI_F32, LAYOUT_TN);
  }
#undef AG_GEMM
  return (int)err;
}

const char* ag_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
