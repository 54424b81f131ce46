// Row LayerNorm and the bf16 "NT" GEMM with fused epilogues: the pieces that
// the transformer-block kernels (ops/attention.py, ops/mlp.py) launch.
//
// Replaces the LayerNorm and the dense products inside the Pallas kernels
// artgraph_tpu/ops/attention.py:_block_fwd_kernel (norm1, qkv, proj) and
// artgraph_tpu/ops/mlp.py:_mlp_fwd_kernel (norm2, fc1 + GELU, fc2).
//
// Rounding points are the Pallas kernels' own, so kernel and plain version
// differ only in accumulation order:
//   LayerNorm:  f32 stats, var = max(E[x^2] - E[x]^2, 0), y = bf16(xhat*g + b)
//   GEMM:       f32 accumulation of bf16 products;
//               v = bf16(acc + f32(bf16 bias))
//   GELU:       act = bf16(gelu_erf(f32(v)))             (exact erf, erff)
//   residual:   out = bf16(f32(x) + f32(v))
//
// What bounds it on an H100: at ViT-B/16 serving shapes (M = 32*197 = 6304
// rows, K = 768 or 3072) the products are compute bound (about 100 FLOP per
// byte of operand traffic per 128x128 tile); the LayerNorm is bound by device
// memory. This first version is deliberately simple: 128x128x32 block tiles
// in shared memory filled by 16-byte loads, bf16 tensor-core fragments
// (nvcuda::wmma 16x16x16, f32 accumulation), 8 warps each owning a 64x32 tile,
// and an epilogue staged through a per-warp 16x16 f32 tile so the bias, GELU
// and residual run in f32 before the single bf16 store. No cp.async
// pipelining, no wgmma/TMA yet: those are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

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

constexpr int BM = 128, BN = 128, BK = 32;
// padded smem row (bf16): 80 bytes, keeps fragment starts 32-byte aligned
constexpr int LDS = BK + 8;
constexpr int GEMM_THREADS = 256;
constexpr int WARP_M = 64, WARP_N = 32;  // 2 x 4 warps over the 128x128 tile
constexpr int FRAG_M = WARP_M / 16, FRAG_N = WARP_N / 16;

enum Epilogue { EPI_BIAS = 0, EPI_BIAS_GELU = 1, EPI_BIAS_RESIDUAL = 2 };

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float gelu_erf(float h) {
  return 0.5f * h * (1.0f + erff(h * 0.70710678118654752f));
}

// out[M,N] = epilogue(A[M,K] . W[N,K]^T + bias[N]); A, W, bias, R, out bf16.
template <int EPI>
__global__ void __launch_bounds__(GEMM_THREADS)
gemm_nt_kernel(const __nv_bfloat16* __restrict__ A,
               const __nv_bfloat16* __restrict__ W,
               const __nv_bfloat16* __restrict__ bias,
               const __nv_bfloat16* __restrict__ R,
               __nv_bfloat16* __restrict__ out, int M, int N, int K) {
  __shared__ __align__(128) __nv_bfloat16 sA[BM * LDS];
  __shared__ __align__(128) __nv_bfloat16 sW[BN * LDS];
  __shared__ __align__(128) float stage[GEMM_THREADS / 32][16 * 16];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp / (BN / WARP_N), wn = warp % (BN / WARP_N);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FRAG_M][FRAG_N];
#pragma unroll
  for (int i = 0; i < FRAG_M; ++i)
#pragma unroll
    for (int j = 0; j < FRAG_N; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < K; k0 += BK) {
    // 16-byte vectors: a 128x32 bf16 tile is 512 of them, two per thread.
    for (int v = tid; v < BM * BK / 8; v += GEMM_THREADS) {
      const int r = v / (BK / 8), c = (v % (BK / 8)) * 8;
      uint4 a = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + r < M)
        a = *reinterpret_cast<const uint4*>(A + (size_t)(m0 + r) * K + k0 + c);
      *reinterpret_cast<uint4*>(sA + r * LDS + c) = a;
      uint4 w = make_uint4(0u, 0u, 0u, 0u);
      if (n0 + r < N)
        w = *reinterpret_cast<const uint4*>(W + (size_t)(n0 + r) * K + k0 + c);
      *reinterpret_cast<uint4*>(sW + r * LDS + c) = w;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fa[FRAG_M];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major> fb[FRAG_N];
#pragma unroll
      for (int i = 0; i < FRAG_M; ++i)
        wmma::load_matrix_sync(fa[i], sA + (wm * WARP_M + i * 16) * LDS + kk,
                               LDS);
      // W[n][k] read as a K x N column-major matrix is W^T.
#pragma unroll
      for (int j = 0; j < FRAG_N; ++j)
        wmma::load_matrix_sync(fb[j], sW + (wn * WARP_N + j * 16) * LDS + kk,
                               LDS);
#pragma unroll
      for (int i = 0; i < FRAG_M; ++i)
#pragma unroll
        for (int j = 0; j < FRAG_N; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* st = stage[warp];
#pragma unroll
  for (int i = 0; i < FRAG_M; ++i) {
#pragma unroll
    for (int j = 0; j < FRAG_N; ++j) {
      wmma::store_matrix_sync(st, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int rbase = m0 + wm * WARP_M + i * 16;
      const int cbase = n0 + wn * WARP_N + j * 16;
      for (int e = lane; e < 256; e += 32) {
        const int r = rbase + (e >> 4), c = cbase + (e & 15);
        if (r < M && c < N) {
          float v = round_bf16(st[e] + __bfloat162float(bias[c]));
          if (EPI == EPI_BIAS_GELU) v = gelu_erf(v);
          if (EPI == EPI_BIAS_RESIDUAL)
            v = __bfloat162float(R[(size_t)r * N + c]) + v;
          out[(size_t)r * N + c] = __float2bfloat16(v);
        }
      }
      __syncwarp();
    }
  }
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

// epilogue: 0 = bias, 1 = bias + GELU, 2 = bias + residual (R).
// K must be a multiple of 32; A, W, R, out contiguous and 16-byte aligned.
int ag_gemm_nt_bf16(const void* a, const void* w, const void* bias,
                    const void* residual, void* out, int M, int N, int K,
                    int epilogue, void* stream) {
  if (K % BK != 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const auto* A = (const __nv_bfloat16*)a;
  const auto* Wt = (const __nv_bfloat16*)w;
  const auto* b = (const __nv_bfloat16*)bias;
  const auto* R = (const __nv_bfloat16*)residual;
  auto* o = (__nv_bfloat16*)out;
  cudaStream_t s = (cudaStream_t)stream;
  switch (epilogue) {
    case EPI_BIAS:
      gemm_nt_kernel<EPI_BIAS><<<grid, GEMM_THREADS, 0, s>>>(A, Wt, b, R, o,
                                                            M, N, K);
      break;
    case EPI_BIAS_GELU:
      gemm_nt_kernel<EPI_BIAS_GELU><<<grid, GEMM_THREADS, 0, s>>>(A, Wt, b, R,
                                                                 o, M, N, K);
      break;
    case EPI_BIAS_RESIDUAL:
      if (residual == nullptr) return (int)cudaErrorInvalidValue;
      gemm_nt_kernel<EPI_BIAS_RESIDUAL><<<grid, GEMM_THREADS, 0, s>>>(
          A, Wt, b, R, o, M, N, K);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* ag_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
