// Row LayerNorm and the bf16 GEMM with fused epilogues: the pieces that the
// transformer-block kernels (ops/attention.py, ops/mlp.py) launch, in both
// directions.
//
// Replaces the LayerNorm and the dense products inside the Pallas kernels
// artgraph_tpu/ops/attention.py:_block_fwd_kernel (norm1, qkv, proj) and
// _block_bwd_kernel (do . W_proj, dqkv . W_qkv, dW_qkv, dW_proj), and
// artgraph_tpu/ops/mlp.py:_mlp_fwd_kernel (norm2, fc1 + GELU, fc2) and
// _mlp_bwd_kernel (do . W2 through GELU', dh . W1, dW1, dW2).
//
// Rounding points are the Pallas kernels' own, so kernel and plain version
// differ only in accumulation order:
//   LayerNorm:  f32 stats, var = max(E[x^2] - E[x]^2, 0), y = bf16(xhat*g + b)
//   GEMM:       f32 accumulation of bf16 products;
//               v = bf16(acc + f32(bf16 bias))
//   GELU:       act = bf16(gelu_erf(f32(v)))             (exact erf, erff)
//   residual:   out = bf16(f32(x) + f32(v))
//   backward:   do_attn = bf16(acc); dh = bf16(acc * gelu'(f32(h)));
//               dy, dW = acc in f32 (one rounding, none)
//
// What bounds it on an H100: at ViT-B/16 shapes (M = 32*197 = 6304 rows,
// K = 768 or 3072; K = 6304 for the weight gradients) the products are
// compute bound (about 100 FLOP per byte of operand traffic per 128x128
// tile); the LayerNorm is bound by device memory. This first version is
// deliberately simple: 128x128x32 block tiles in shared memory filled by
// 16-byte loads, bf16 tensor-core fragments (nvcuda::wmma 16x16x16, f32
// accumulation), 8 warps each owning a 64x32 tile, and an epilogue staged
// through a per-warp 16x16 f32 tile so the bias, GELU and residual run in f32
// before the single store. One kernel template covers the three operand
// layouts (the transposed operand is staged k-major in shared memory and read
// as a column-major fragment) and, for the weight gradients (TN), a ragged K
// (K = B*197 rows). The weight-gradient GEMMs run one block
// per 128x128 output tile over the whole K: no split-K, so dW_proj fills 36
// blocks. No cp.async pipelining, no wgmma/TMA yet: those are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

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
// padded smem rows (bf16): a [128][32] tile is stored with row stride 40
// (80 bytes), a [32][128] tile with row stride 136 (272 bytes); both keep
// 16x16 fragment starts 32-byte aligned
constexpr int LDS = BK + 8;
constexpr int LDT = BM + 8;
constexpr int TILE_ELEMS = BM * LDS > BK * LDT ? BM * LDS : BK * LDT;
constexpr int GEMM_THREADS = 256;
constexpr int WARP_M = 64, WARP_N = 32;  // 2 x 4 warps over the 128x128 tile
constexpr int FRAG_M = WARP_M / 16, FRAG_N = WARP_N / 16;

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

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float gelu_erf(float h) {
  return 0.5f * h * (1.0f + erff(h * 0.70710678118654752f));
}

// d gelu(h) / dh = Phi(h) + h phi(h)
__device__ __forceinline__ float gelu_erf_grad(float h) {
  const float cdf = 0.5f * (1.0f + erff(h * 0.70710678118654752f));
  const float pdf = 0.3989422804014327f * expf(-0.5f * h * h);
  return cdf + h * pdf;
}

// The A and B tiles of one K step into shared memory with 16-byte loads:
// a [128][32] tile from a [rows, K] operand (K contiguous; K % 32 == 0, so
// no K check), or a [32][128] tile from a k-major [K, rows] operand (rows
// contiguous; k beyond K reads as zero, the ragged K of the weight
// gradients). Rows beyond M or N read as zero. Both operands load in one
// loop, two independent loads per iteration.
template <bool A_KMAJOR, bool B_KMAJOR>
__device__ __forceinline__ void load_tiles(
    const __nv_bfloat16* __restrict__ A, const __nv_bfloat16* __restrict__ Bm,
    __nv_bfloat16* sA, __nv_bfloat16* sB, int M, int N, int K, int m0,
    int n0, int k0, int tid) {
  for (int v = tid; v < BM * BK / 8; v += GEMM_THREADS) {
    const int r = v / (BK / 8), c = (v % (BK / 8)) * 8;   // [128][32] tile
    const int kr = v / (BM / 8), kc = (v % (BM / 8)) * 8; // [32][128] tile
    uint4 a = make_uint4(0u, 0u, 0u, 0u);
    if (!A_KMAJOR) {
      if (m0 + r < M)
        a = *reinterpret_cast<const uint4*>(A + (size_t)(m0 + r) * K + k0 +
                                            c);
      *reinterpret_cast<uint4*>(sA + r * LDS + c) = a;
    } else {
      if (k0 + kr < K && m0 + kc < M)
        a = *reinterpret_cast<const uint4*>(A + (size_t)(k0 + kr) * M + m0 +
                                            kc);
      *reinterpret_cast<uint4*>(sA + kr * LDT + kc) = a;
    }
    uint4 b = make_uint4(0u, 0u, 0u, 0u);
    if (!B_KMAJOR) {
      if (n0 + r < N)
        b = *reinterpret_cast<const uint4*>(Bm + (size_t)(n0 + r) * K + k0 +
                                            c);
      *reinterpret_cast<uint4*>(sB + r * LDS + c) = b;
    } else {
      if (k0 + kr < K && n0 + kc < N)
        b = *reinterpret_cast<const uint4*>(Bm + (size_t)(k0 + kr) * N + n0 +
                                            kc);
      *reinterpret_cast<uint4*>(sB + kr * LDT + kc) = b;
    }
  }
}

// Two blocks per SM: at most 128 registers a thread.
template <int EPI, int LAYOUT>
__global__ void __launch_bounds__(GEMM_THREADS, 2)
gemm_kernel(const __nv_bfloat16* __restrict__ A,
            const __nv_bfloat16* __restrict__ Bm,
            const __nv_bfloat16* __restrict__ bias,
            const __nv_bfloat16* __restrict__ aux, void* __restrict__ out,
            __nv_bfloat16* __restrict__ out2, int M, int N, int K) {
  constexpr bool A_KMAJOR = LAYOUT == LAYOUT_TN;
  constexpr bool B_KMAJOR = LAYOUT != LAYOUT_NT;
  using ALayout = std::conditional_t<A_KMAJOR, wmma::col_major,
                                     wmma::row_major>;
  using BLayout = std::conditional_t<B_KMAJOR, wmma::row_major,
                                     wmma::col_major>;
  __shared__ __align__(128) __nv_bfloat16 sA[TILE_ELEMS];
  __shared__ __align__(128) __nv_bfloat16 sB[TILE_ELEMS];
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
    load_tiles<A_KMAJOR, B_KMAJOR>(A, Bm, sA, sB, M, N, K, m0, n0, k0, tid);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, ALayout>
          fa[FRAG_M];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, BLayout>
          fb[FRAG_N];
#pragma unroll
      for (int i = 0; i < FRAG_M; ++i) {
        const int m = wm * WARP_M + i * 16;
        // A^T stored [k][m], read column-major, is A
        wmma::load_matrix_sync(fa[i], A_KMAJOR ? sA + kk * LDT + m
                                               : sA + m * LDS + kk,
                               A_KMAJOR ? LDT : LDS);
      }
#pragma unroll
      for (int j = 0; j < FRAG_N; ++j) {
        const int n = wn * WARP_N + j * 16;
        // W[n][k] read as a K x N column-major matrix is W^T
        wmma::load_matrix_sync(fb[j], B_KMAJOR ? sB + kk * LDT + n
                                               : sB + n * LDS + kk,
                               B_KMAJOR ? LDT : LDS);
      }
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
          const size_t o = (size_t)r * N + c;
          const float a = st[e];
          if constexpr (EPI == EPI_F32) {
            static_cast<float*>(out)[o] = a;
          } else {
            float v;
            if constexpr (EPI == EPI_NONE) {
              v = a;
            } else if constexpr (EPI == EPI_DGELU) {
              v = a * gelu_erf_grad(__bfloat162float(aux[o]));
            } else {
              v = round_bf16(a + __bfloat162float(bias[c]));
              if constexpr (EPI == EPI_BIAS_GELU) v = gelu_erf(v);
              if constexpr (EPI == EPI_BIAS_RESIDUAL)
                v = __bfloat162float(aux[o]) + v;
              if constexpr (EPI == EPI_BIAS_GELU_AUX)
                out2[o] = __float2bfloat16(gelu_erf(v));
            }
            static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16(v);
          }
        }
      }
      __syncwarp();
    }
  }
}

template <int EPI, int LAYOUT>
cudaError_t launch_gemm(const void* a, const void* b, const void* bias,
                        const void* aux, void* out, void* out2, int M, int N,
                        int K, cudaStream_t s) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  gemm_kernel<EPI, LAYOUT><<<grid, GEMM_THREADS, 0, s>>>(
      (const __nv_bfloat16*)a, (const __nv_bfloat16*)b,
      (const __nv_bfloat16*)bias, (const __nv_bfloat16*)aux, out,
      (__nv_bfloat16*)out2, M, N, K);
  return cudaGetLastError();
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

// out[M,N] = epilogue(sum_k A(m,k) B(k,n)) for the layouts and epilogues
// above. bf16 operands, contiguous and 16-byte aligned. K must be a multiple
// of 32 for NT and NN; TN takes any K, and M and N multiples of 8 (its
// operands are contiguous along M and N).
// Pointers an epilogue does not read may be null: bias for EPI_BIAS*, aux for
// EPI_BIAS_RESIDUAL (the residual R) and EPI_DGELU (h), out2 for
// EPI_BIAS_GELU_AUX. out is f32 for EPI_F32 and bf16 otherwise.
// Built combinations: NT with the four EPI_BIAS* epilogues, NN with
// EPI_NONE, EPI_F32 and EPI_DGELU, TN with EPI_F32.
int ag_gemm_bf16(const void* a, const void* b, const void* bias,
                 const void* aux, void* out, void* out2, int M, int N, int K,
                 int layout, int epilogue, void* stream) {
  if (M < 1 || N < 1 || K < 1 ||
      (layout == LAYOUT_TN ? (M % 8 || N % 8) : K % BK) ||
      (layout == LAYOUT_NN && N % 8))
    return (int)cudaErrorInvalidValue;
  const bool needs_bias = epilogue <= EPI_BIAS_GELU_AUX;
  if ((needs_bias && bias == nullptr) ||
      ((epilogue == EPI_BIAS_RESIDUAL || epilogue == EPI_DGELU) &&
       aux == nullptr) ||
      (epilogue == EPI_BIAS_GELU_AUX && out2 == nullptr))
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
