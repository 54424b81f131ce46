// LayerNorm backward with the residual gradient, and deterministic column
// sums: the row-wise and column-wise reductions of the transformer blocks'
// backward (ops/attention.py, ops/mlp.py).
//
// Replaces, inside the Pallas kernels
// artgraph_tpu/ops/attention.py:_block_bwd_kernel and
// artgraph_tpu/ops/mlp.py:_mlp_bwd_kernel:
//   the LayerNorm backward  dyg = dy * gamma,
//                           dx  = bf16(do + rstd * (dyg - mean(dyg)
//                                                - xhat * mean(dyg * xhat)))
//   with dy f32 (never rounded) and do added in f32 before the one rounding;
//   the gradient sums       dgamma = sum_rows dy * xhat, dbeta = sum_rows dy,
//                           db = sum_rows f32(bf16 dz) for the dense biases.
// The Pallas kernels carry these sums in VMEM across their sequential grid.
// Blocks on Hopper run in no order, so each sum runs in two passes: every
// block writes its partial sums over a fixed set of rows to a scratch row,
// then one pass adds the partials in block order. The grouping depends only
// on the shapes, so the result is the same on every run (no atomics).
//
// What bounds it on an H100: device memory. The LayerNorm backward reads x
// (bf16), dy (f32) and do (bf16) once and writes dx (bf16): at M = 6304,
// C = 768 that is 48 MB, 14 us at 3.35 TB/s. xhat and rstd are recomputed
// from x, not stored.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int LNB_WARPS = 4;  // one warp per row
constexpr int COLSUM_THREADS = 256;

__global__ void __launch_bounds__(LNB_WARPS * 32)
layernorm_bwd_kernel(const __nv_bfloat16* __restrict__ x,
                     const float* __restrict__ gamma,
                     const float* __restrict__ dy,
                     const __nv_bfloat16* __restrict__ dres,
                     __nv_bfloat16* __restrict__ dx,
                     float* __restrict__ part_g, float* __restrict__ part_b,
                     int rows, int cols, float eps) {
  // per warp: its own column partials of dgamma and dbeta, [2][WARPS][cols]
  extern __shared__ float sacc[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* acc_g = sacc + warp * cols;
  float* acc_b = sacc + (LNB_WARPS + warp) * cols;
  for (int c = lane; c < cols; c += 32) {
    acc_g[c] = 0.f;
    acc_b[c] = 0.f;
  }
  const float inv_cols = 1.0f / (float)cols;
  for (int row = blockIdx.x * LNB_WARPS + warp; row < rows;
       row += gridDim.x * LNB_WARPS) {
    const __nv_bfloat16* xr = x + (size_t)row * cols;
    const float* dyr = dy + (size_t)row * cols;
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
    const float var = fmaxf(
        __fsub_rn(s2 / (float)cols, __fmul_rn(mean, mean)), 0.f);
    const float rstd = rsqrtf(var + eps);
    float sg = 0.f, sgx = 0.f;
    for (int c = lane; c < cols; c += 32) {
      const float xhat =
          __fmul_rn(__fsub_rn(__bfloat162float(xr[c]), mean), rstd);
      const float dyg = dyr[c] * gamma[c];
      sg += dyg;
      sgx += dyg * xhat;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      sg += __shfl_xor_sync(0xffffffffu, sg, o);
      sgx += __shfl_xor_sync(0xffffffffu, sgx, o);
    }
    const float mean_dyg = sg * inv_cols, mean_dyg_xhat = sgx * inv_cols;
    const __nv_bfloat16* dr = dres + (size_t)row * cols;
    __nv_bfloat16* dxr = dx + (size_t)row * cols;
    for (int c = lane; c < cols; c += 32) {
      const float xhat =
          __fmul_rn(__fsub_rn(__bfloat162float(xr[c]), mean), rstd);
      const float d = dyr[c];
      const float dyg = d * gamma[c];
      const float dx_ln = rstd * (dyg - mean_dyg - xhat * mean_dyg_xhat);
      dxr[c] = __float2bfloat16(__bfloat162float(dr[c]) + dx_ln);
      acc_g[c] += d * xhat;
      acc_b[c] += d;
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < cols; c += blockDim.x) {
    float g = 0.f, b = 0.f;
#pragma unroll
    for (int w = 0; w < LNB_WARPS; ++w) {
      g += sacc[w * cols + c];
      b += sacc[(LNB_WARPS + w) * cols + c];
    }
    part_g[(size_t)blockIdx.x * cols + c] = g;
    part_b[(size_t)blockIdx.x * cols + c] = b;
  }
}

// part[chunk, c] = sum over the chunk's rows of f32(in[r, c]); block
// (x, chunk) covers COLSUM_THREADS columns, one per thread (coalesced).
__global__ void __launch_bounds__(COLSUM_THREADS)
colsum_bf16_partial_kernel(const __nv_bfloat16* __restrict__ in,
                           float* __restrict__ part, int rows, int cols,
                           int rows_per_chunk) {
  const int c = blockIdx.x * COLSUM_THREADS + threadIdx.x;
  if (c >= cols) return;
  const int r0 = blockIdx.y * rows_per_chunk;
  const int r1 = min(rows, r0 + rows_per_chunk);
  float s = 0.f;
  for (int r = r0; r < r1; ++r) s += __bfloat162float(in[(size_t)r * cols + c]);
  part[(size_t)blockIdx.y * cols + c] = s;
}

// out[c] = sum_g part[g, c], g in order
__global__ void __launch_bounds__(COLSUM_THREADS)
colsum_f32_final_kernel(const float* __restrict__ part,
                        float* __restrict__ out, int groups, int cols) {
  const int c = blockIdx.x * COLSUM_THREADS + threadIdx.x;
  if (c >= cols) return;
  float s = 0.f;
  for (int g = 0; g < groups; ++g) s += part[(size_t)g * cols + c];
  out[c] = s;
}

cudaError_t colsum_final(const float* part, float* out, int groups, int cols,
                         cudaStream_t s) {
  colsum_f32_final_kernel<<<(cols + COLSUM_THREADS - 1) / COLSUM_THREADS,
                            COLSUM_THREADS, 0, s>>>(part, out, groups, cols);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dx [rows, cols] bf16 and dgamma, dbeta [cols] f32 from x (bf16), gamma
// (f32), dy (f32) and dres (bf16, the gradient reaching the block output).
// scratch: f32 [2, groups, cols]; groups blocks take the rows in turn.
int ag_layernorm_bwd_bf16(const void* x, const void* gamma, const void* dy,
                          const void* dres, void* dx, void* scratch,
                          void* dgamma, void* dbeta, int rows, int cols,
                          float eps, int groups, void* stream) {
  if (rows < 1 || cols < 1 || groups < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = (size_t)2 * LNB_WARPS * cols * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      layernorm_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  float* part_g = (float*)scratch;
  float* part_b = part_g + (size_t)groups * cols;
  layernorm_bwd_kernel<<<groups, LNB_WARPS * 32, smem, s>>>(
      (const __nv_bfloat16*)x, (const float*)gamma, (const float*)dy,
      (const __nv_bfloat16*)dres, (__nv_bfloat16*)dx, part_g, part_b, rows,
      cols, eps);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if ((err = colsum_final(part_g, (float*)dgamma, groups, cols, s)) !=
      cudaSuccess)
    return (int)err;
  return (int)colsum_final(part_b, (float*)dbeta, groups, cols, s);
}

// out[c] = sum_r f32(in[r, c]) for bf16 in [rows, cols], in two passes over
// `groups` chunks of rows; scratch: f32 [groups, cols].
int ag_colsum_bf16(const void* in, void* scratch, void* out, int rows,
                   int cols, int groups, void* stream) {
  if (rows < 1 || cols < 1 || groups < 1 || groups > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int rows_per_chunk = (rows + groups - 1) / groups;
  const dim3 grid((cols + COLSUM_THREADS - 1) / COLSUM_THREADS, groups);
  colsum_bf16_partial_kernel<<<grid, COLSUM_THREADS, 0, s>>>(
      (const __nv_bfloat16*)in, (float*)scratch, rows, cols, rows_per_chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)colsum_final((const float*)scratch, (float*)out, groups, cols,
                           s);
}

}  // extern "C"
