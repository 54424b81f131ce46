// Backward of the multi-head attention core, one block per (head, image), in
// two instantiations of one kernel.
//
// Recomputed o (block path): d(qkv) from the fused qkv tensor and the
// gradient of the attention output. Replaces the per-head backward inside
// the Pallas kernel artgraph_tpu/ops/attention.py:_block_bwd_kernel
// (:409-426). ops/attention.py wraps it between the recomputed forward, the
// do . W_proj GEMM and the dqkv . W_qkv GEMM (csrc/block_gemm.cu). Its d_row
// reads o = f32(p . v), recomputed here in f32, not the bf16 output.
//
// Saved o (ag_attention_bwd_bf16): q, k, v, the forward's bf16 output o, do
// and dq, dk, dv as [B*N, ld] row-major views, head h at column h*D of each
// row (the fused qkv and dqkv tensors are the case ld = 3C, offsets 0, C,
// 2C). Replaces the Pallas kernels artgraph_tpu/ops/attention.py:_bwd_kernel
// (fused_attention, :61) and _qkv_bwd_kernel (fused_qkv_attention, :209),
// whose d_row reads the saved bf16 o (:82-83, :237-238); the p . v product
// is skipped.
//
// Rounding points are the Pallas kernels'. For each query row: s = f32(q.k)
// * scale, exact max m and sum l over the N keys, p = bf16(exp(s - m) / l),
// d_row = sum_d f32(do) * f32(o), dp = f32(do . v), ds = bf16(p * (dp -
// d_row) * scale); then dq = ds . k, dk = ds^T . q, dv = p^T . do, each
// summed in f32 over all N rows and rounded to bf16 once.
//
// Design. dk and dv sum over every query row, which the TPU kernel gets from
// its whole-sequence VMEM tiles. Here one block owns one (image, head) and
// walks the queries in tiles of 32 rows, so the f32 dK and dV accumulators
// stay in shared memory for the whole sum and are rounded once at the end
// (no atomics, no partial rounding). Shared memory at N = 197 (padded to 208
// rows in shared memory only), D = 64: K and V 60 KB, f32 dK and dV 113 KB,
// the Q and dO tiles 9 KB, the f32 score tile (reused for O, dP and the dQ
// staging) 27 KB and the bf16 probabilities (overwritten by dS) 14 KB: 218
// KB, one block of 8 warps per SM. Each warp takes 16x16 output tiles in
// turn (nvcuda::wmma, bf16 in, f32 accumulation).
//
// What bounds it on an H100: per (image, head) it does 6 products of
// 2*N*N*D FLOP (S, O, dV, dP, dQ, dK; 4 of them are the backward proper),
// 3 MFLOP each at N = 197 (the saved-o instantiation skips O: 5), on ~100
// KB of q/k/v/do: neither the tensor cores nor device memory but
// shared-memory traffic and the one-block-per-SM occupancy, as for the
// forward core.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BQT = 32;  // query rows per tile
constexpr int BWD_WARPS = 8;
constexpr int BWD_THREADS = BWD_WARPS * 32;

__host__ __device__ inline int pad16(int n) { return (n + 15) & ~15; }
// Row strides in elements; all keep 16-row fragment starts 32-byte aligned.
__host__ __device__ inline int ld_qkv(int d) { return d + 8; }   // bf16
__host__ __device__ inline int ld_acc(int d) { return d + 4; }   // f32
__host__ __device__ inline int ld_s(int np, int d) {             // f32
  return (np > d ? np : d) + 4;
}
__host__ __device__ inline int ld_p(int np) { return np + 8; }   // bf16

__host__ __device__ inline size_t attention_bwd_smem_bytes(int n, int d) {
  const int np = pad16(n);
  return (size_t)2 * np * ld_qkv(d) * 2      // K, V (bf16)
         + (size_t)2 * np * ld_acc(d) * 4    // dK, dV accumulators (f32)
         + (size_t)2 * BQT * ld_qkv(d) * 2   // Q, dO tiles (bf16)
         + (size_t)BQT * ld_s(np, d) * 4     // S / O / dP / dQ staging (f32)
         + (size_t)BQT * ld_p(np) * 2        // P, then dS (bf16)
         + (size_t)BQT * 4;                  // d_row (f32)
}

using FragAcc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
using FragARow = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                                wmma::row_major>;
using FragACol = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                                wmma::col_major>;
using FragBRow = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                                wmma::row_major>;
using FragBCol = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                                wmma::col_major>;

// Row-major [B*N, ld] operands of the saved-o instantiation (elements).
struct StridedGrad {
  const __nv_bfloat16 *q, *k, *v, *o, *dout;
  __nv_bfloat16 *dq, *dk, *dv;
  int ld_q, ld_k, ld_v, ld_o, ld_do, ld_dq, ld_dk, ld_dv;
};

// SAVED_O = false: the block path (packed qkv, dout and dqkv; o recomputed
// in f32). SAVED_O = true: every operand from `sg`, d_row from the saved o.
template <int D, bool SAVED_O>
__global__ void __launch_bounds__(BWD_THREADS)
attention_core_bwd_kernel(const __nv_bfloat16* __restrict__ qkv,
                          const __nv_bfloat16* __restrict__ dout,
                          __nv_bfloat16* __restrict__ dqkv, int N, int H,
                          float scale, StridedGrad sg) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int NP = pad16(N), NT = NP / 16;
  constexpr int LDQ = D + 8, LDA = D + 4, DT = D / 16, QTT = BQT / 16;
  const int LDS_ = ld_s(NP, D), LDP = ld_p(NP);
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sV = sK + NP * LDQ;
  float* sdK = reinterpret_cast<float*>(sV + NP * LDQ);
  float* sdV = sdK + NP * LDA;
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(sdV + NP * LDA);
  __nv_bfloat16* sdO = sQ + BQT * LDQ;
  float* sS = reinterpret_cast<float*>(sdO + BQT * LDQ);
  __nv_bfloat16* sP = reinterpret_cast<__nv_bfloat16*>(sS + BQT * LDS_);
  float* sRow = reinterpret_cast<float*>(sP + BQT * LDP);

  const int h = blockIdx.x, b = blockIdx.y;
  const int C = H * D;
  const size_t qkv_stride = (size_t)3 * C;
  const __nv_bfloat16* base = qkv + (size_t)b * N * qkv_stride + h * D;
  const __nv_bfloat16* dbase = dout + (size_t)b * N * C + h * D;
  __nv_bfloat16* gbase = dqkv + (size_t)b * N * qkv_stride + h * D;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  constexpr int VEC = D / 8;  // 16-byte vectors per head row

  for (int v = tid; v < NP * VEC; v += BWD_THREADS) {
    const int r = v / VEC, c = (v % VEC) * 8;
    uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = make_uint4(0u, 0u, 0u, 0u);
    if (r < N) {
      if constexpr (SAVED_O) {
        const size_t row = (size_t)b * N + r;
        kv = *reinterpret_cast<const uint4*>(sg.k + row * sg.ld_k + h * D + c);
        vv = *reinterpret_cast<const uint4*>(sg.v + row * sg.ld_v + h * D + c);
      } else {
        kv = *reinterpret_cast<const uint4*>(base + r * qkv_stride + C + c);
        vv = *reinterpret_cast<const uint4*>(base + r * qkv_stride + 2 * C +
                                             c);
      }
    }
    *reinterpret_cast<uint4*>(sK + r * LDQ + c) = kv;
    *reinterpret_cast<uint4*>(sV + r * LDQ + c) = vv;
  }
  for (int i = tid; i < NP * LDA; i += BWD_THREADS) {
    sdK[i] = 0.f;
    sdV[i] = 0.f;
  }

  for (int q0 = 0; q0 < N; q0 += BQT) {
    for (int v = tid; v < BQT * VEC; v += BWD_THREADS) {
      const int r = v / VEC, c = (v % VEC) * 8;
      uint4 qv = make_uint4(0u, 0u, 0u, 0u), dv = make_uint4(0u, 0u, 0u, 0u);
      if (q0 + r < N) {
        if constexpr (SAVED_O) {
          const size_t row = (size_t)b * N + q0 + r;
          qv = *reinterpret_cast<const uint4*>(sg.q + row * sg.ld_q + h * D +
                                               c);
          dv = *reinterpret_cast<const uint4*>(sg.dout + row * sg.ld_do +
                                               h * D + c);
        } else {
          qv = *reinterpret_cast<const uint4*>(base + (q0 + r) * qkv_stride +
                                               c);
          dv = *reinterpret_cast<const uint4*>(dbase + (size_t)(q0 + r) * C +
                                               c);
        }
      }
      *reinterpret_cast<uint4*>(sQ + r * LDQ + c) = qv;
      *reinterpret_cast<uint4*>(sdO + r * LDQ + c) = dv;
    }
    __syncthreads();

    // S = (Q K^T) * scale
    for (int t = warp; t < QTT * NT; t += BWD_WARPS) {
      const int i = t / NT, j = t % NT;
      FragAcc acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < DT; ++kk) {
        FragARow fq;
        FragBCol fk;  // K[j][d] read as a D x N column-major matrix is K^T
        wmma::load_matrix_sync(fq, sQ + i * 16 * LDQ + kk * 16, LDQ);
        wmma::load_matrix_sync(fk, sK + j * 16 * LDQ + kk * 16, LDQ);
        wmma::mma_sync(acc, fq, fk, acc);
      }
#pragma unroll
      for (int e = 0; e < acc.num_elements; ++e) acc.x[e] *= scale;
      wmma::store_matrix_sync(sS + i * 16 * LDS_ + j * 16, acc, LDS_,
                              wmma::mem_row_major);
    }
    __syncthreads();

    // exact softmax over the N keys; p = bf16(e / l), 0 on pad rows/columns
    for (int r = warp; r < BQT; r += BWD_WARPS) {
      float* srow = sS + r * LDS_;
      __nv_bfloat16* prow = sP + r * LDP;
      if (q0 + r >= N) {
        for (int j = lane; j < NP; j += 32) prow[j] = __float2bfloat16(0.f);
        continue;
      }
      float m = -INFINITY;
      for (int j = lane; j < N; j += 32) m = fmaxf(m, srow[j]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      float l = 0.f;
      for (int j = lane; j < N; j += 32) {
        const float e = expf(srow[j] - m);
        srow[j] = e;
        l += e;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
      for (int j = lane; j < NP; j += 32)
        prow[j] = __float2bfloat16(j < N ? __fdiv_rn(srow[j], l) : 0.f);
    }
    __syncthreads();

    // O = P V in f32, staged in the score tile (the block path only)
    if constexpr (!SAVED_O) {
      for (int t = warp; t < QTT * DT; t += BWD_WARPS) {
        const int i = t / DT, dj = t % DT;
        FragAcc acc;
        wmma::fill_fragment(acc, 0.f);
        for (int kt = 0; kt < NT; ++kt) {
          FragARow fp;
          FragBRow fv;
          wmma::load_matrix_sync(fp, sP + i * 16 * LDP + kt * 16, LDP);
          wmma::load_matrix_sync(fv, sV + kt * 16 * LDQ + dj * 16, LDQ);
          wmma::mma_sync(acc, fp, fv, acc);
        }
        wmma::store_matrix_sync(sS + i * 16 * LDS_ + dj * 16, acc, LDS_,
                                wmma::mem_row_major);
      }
      __syncthreads();
    }

    // d_row = sum_d f32(dO) * O, with the f32 O recomputed above or the
    // saved bf16 o (0 on pad rows, whose dO is 0)
    for (int r = warp; r < BQT; r += BWD_WARPS) {
      float s = 0.f;
      if constexpr (SAVED_O) {
        if (q0 + r < N) {
          const __nv_bfloat16* orow =
              sg.o + ((size_t)b * N + q0 + r) * sg.ld_o + h * D;
          for (int c = lane; c < D; c += 32)
            s += __bfloat162float(sdO[r * LDQ + c]) *
                 __bfloat162float(orow[c]);
        }
      } else {
        for (int c = lane; c < D; c += 32)
          s += __bfloat162float(sdO[r * LDQ + c]) * sS[r * LDS_ + c];
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == 0) sRow[r] = s;
    }
    __syncthreads();

    // dV += P^T dO (accumulated in shared memory)
    for (int t = warp; t < NT * DT; t += BWD_WARPS) {
      const int j = t / DT, dj = t % DT;
      FragAcc acc;
      wmma::load_matrix_sync(acc, sdV + j * 16 * LDA + dj * 16, LDA,
                             wmma::mem_row_major);
#pragma unroll
      for (int ks = 0; ks < QTT; ++ks) {
        FragACol fpt;  // P[q][j] read column-major is P^T
        FragBRow fdo;
        wmma::load_matrix_sync(fpt, sP + ks * 16 * LDP + j * 16, LDP);
        wmma::load_matrix_sync(fdo, sdO + ks * 16 * LDQ + dj * 16, LDQ);
        wmma::mma_sync(acc, fpt, fdo, acc);
      }
      wmma::store_matrix_sync(sdV + j * 16 * LDA + dj * 16, acc, LDA,
                              wmma::mem_row_major);
    }
    // dP = dO V^T into the score tile (O and d_row are read already)
    for (int t = warp; t < QTT * NT; t += BWD_WARPS) {
      const int i = t / NT, j = t % NT;
      FragAcc acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < DT; ++kk) {
        FragARow fdo;
        FragBCol fvt;
        wmma::load_matrix_sync(fdo, sdO + i * 16 * LDQ + kk * 16, LDQ);
        wmma::load_matrix_sync(fvt, sV + j * 16 * LDQ + kk * 16, LDQ);
        wmma::mma_sync(acc, fdo, fvt, acc);
      }
      wmma::store_matrix_sync(sS + i * 16 * LDS_ + j * 16, acc, LDS_,
                              wmma::mem_row_major);
    }
    __syncthreads();

    // dS = bf16(P * (dP - d_row) * scale), over P in place
    for (int e = tid; e < BQT * NP; e += BWD_THREADS) {
      const int r = e / NP, j = e % NP;
      const float p = __bfloat162float(sP[r * LDP + j]);
      sP[r * LDP + j] =
          __float2bfloat16(p * (sS[r * LDS_ + j] - sRow[r]) * scale);
    }
    __syncthreads();

    // dK += dS^T Q (accumulated in shared memory)
    for (int t = warp; t < NT * DT; t += BWD_WARPS) {
      const int j = t / DT, dj = t % DT;
      FragAcc acc;
      wmma::load_matrix_sync(acc, sdK + j * 16 * LDA + dj * 16, LDA,
                             wmma::mem_row_major);
#pragma unroll
      for (int ks = 0; ks < QTT; ++ks) {
        FragACol fdst;
        FragBRow fq;
        wmma::load_matrix_sync(fdst, sP + ks * 16 * LDP + j * 16, LDP);
        wmma::load_matrix_sync(fq, sQ + ks * 16 * LDQ + dj * 16, LDQ);
        wmma::mma_sync(acc, fdst, fq, acc);
      }
      wmma::store_matrix_sync(sdK + j * 16 * LDA + dj * 16, acc, LDA,
                              wmma::mem_row_major);
    }
    // dQ = dS K, staged in the score tile (dP is consumed)
    for (int t = warp; t < QTT * DT; t += BWD_WARPS) {
      const int i = t / DT, dj = t % DT;
      FragAcc acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kt = 0; kt < NT; ++kt) {
        FragARow fds;
        FragBRow fk;
        wmma::load_matrix_sync(fds, sP + i * 16 * LDP + kt * 16, LDP);
        wmma::load_matrix_sync(fk, sK + kt * 16 * LDQ + dj * 16, LDQ);
        wmma::mma_sync(acc, fds, fk, acc);
      }
      wmma::store_matrix_sync(sS + i * 16 * LDS_ + dj * 16, acc, LDS_,
                              wmma::mem_row_major);
    }
    __syncthreads();

    for (int e = tid; e < BQT * D; e += BWD_THREADS) {
      const int r = e / D, c = e % D;
      if (q0 + r >= N) continue;
      const __nv_bfloat16 val = __float2bfloat16(sS[r * LDS_ + c]);
      if constexpr (SAVED_O)
        sg.dq[((size_t)b * N + q0 + r) * sg.ld_dq + h * D + c] = val;
      else
        gbase[(size_t)(q0 + r) * qkv_stride + c] = val;
    }
    __syncthreads();  // the next tile overwrites Q, dO and the score tile
  }

  for (int e = tid; e < N * D; e += BWD_THREADS) {
    const int j = e / D, c = e % D;
    if constexpr (SAVED_O) {
      const size_t row = (size_t)b * N + j;
      sg.dk[row * sg.ld_dk + h * D + c] = __float2bfloat16(sdK[j * LDA + c]);
      sg.dv[row * sg.ld_dv + h * D + c] = __float2bfloat16(sdV[j * LDA + c]);
    } else {
      __nv_bfloat16* row = gbase + (size_t)j * qkv_stride;
      row[C + c] = __float2bfloat16(sdK[j * LDA + c]);
      row[2 * C + c] = __float2bfloat16(sdV[j * LDA + c]);
    }
  }
}

}  // namespace

extern "C" {

size_t ag_attention_bwd_smem_bytes(int n, int d) {
  return attention_bwd_smem_bytes(n, d);
}

// qkv: [B*N, 3*H*D] bf16 (the forward's, columns ordered qkv-slot, head,
// dim); dout: [B*N, H*D] bf16, the gradient of the attention output;
// dqkv: [B*N, 3*H*D] bf16, every element written. Only D = 64 is built.
int ag_attention_core_bwd_bf16(const void* qkv, const void* dout, void* dqkv,
                               int B, int N, int H, int D, float scale,
                               void* stream) {
  if (D != 64 || N < 1 || B < 1 || H < 1 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t smem = attention_bwd_smem_bytes(N, D);
  cudaError_t err = cudaFuncSetAttribute(
      attention_core_bwd_kernel<64, false>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(H, B);
  attention_core_bwd_kernel<64, false><<<grid, BWD_THREADS, smem,
                                         (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)qkv, (const __nv_bfloat16*)dout,
      (__nv_bfloat16*)dqkv, N, H, scale, StridedGrad{});
  return (int)cudaGetLastError();
}

// q, k, v, o (the forward's bf16 output), dout, dq, dk, dv: [B*N, ld_*] bf16
// row-major, head h at columns [h*D, h*D+D) of a row; each pointer 16-byte
// aligned and each ld_* a multiple of 8 (checked by the caller); every
// element of dq, dk and dv at a head column of a valid row is written. Only
// D = 64 is built.
int ag_attention_bwd_bf16(const void* q, const void* k, const void* v,
                          const void* o, const void* dout, void* dq, void* dk,
                          void* dv, int B, int N, int H, int D, int ld_q,
                          int ld_k, int ld_v, int ld_o, int ld_do, int ld_dq,
                          int ld_dk, int ld_dv, float scale, void* stream) {
  if (D != 64 || N < 1 || B < 1 || H < 1 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t smem = attention_bwd_smem_bytes(N, D);
  cudaError_t err = cudaFuncSetAttribute(
      attention_core_bwd_kernel<64, true>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const StridedGrad sg{
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (const __nv_bfloat16*)o,
      (const __nv_bfloat16*)dout, (__nv_bfloat16*)dq, (__nv_bfloat16*)dk,
      (__nv_bfloat16*)dv, ld_q, ld_k, ld_v, ld_o, ld_do, ld_dq, ld_dk, ld_dv};
  const dim3 grid(H, B);
  attention_core_bwd_kernel<64, true><<<grid, BWD_THREADS, smem,
                                        (cudaStream_t)stream>>>(
      nullptr, nullptr, nullptr, N, H, scale, sg);
  return (int)cudaGetLastError();
}

}  // extern "C"
