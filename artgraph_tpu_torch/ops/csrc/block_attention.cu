// Multi-head attention core: per (batch, head, 64-row query tile),
// softmax(q k^T * scale) v, in two instantiations of one kernel.
//
// Packed (block path): q, k, v from the fused qkv tensor of the transformer
// block. Replaces the per-head attention inside the Pallas kernel
// artgraph_tpu/ops/attention.py:_block_fwd_kernel (_head_attention,
// :348-361). ops/attention.py wraps it between the LayerNorm + qkv GEMM and
// the proj GEMM with its residual epilogue (csrc/block_gemm.cu). Rounding
// points are that kernel's: s = f32(q . k) * scale, exact row max m and sum l
// over all N keys, p = bf16(exp(s - m) / l), then o = bf16(f32(p . v)).
//
// Strided (ag_attention_bf16): q, k, v, o as [B*N, ld] row-major views, head
// h at column h*D of each row; the fused qkv tensor is the special case
// ld = 3C with k and v at offsets C and 2C. Replaces the Pallas kernels
// artgraph_tpu/ops/attention.py:_fwd_kernel (fused_attention, :41) and
// _qkv_fwd_kernel (fused_qkv_attention, :183) after its qkv product. Both
// divide AFTER the product: o = bf16(f32(bf16(exp(s - m)) . v) / l).
//
// There is no online softmax: the whole [64, N] f32 score tile sits in
// shared memory, so the division happens where the reference divides.
//
// What bounds it on an H100: at ViT-B/16 (N = 197, D = 64) a block does
// 2 * 64 * 208 * 64 * 2 = 3.4 MFLOP on ~70 KB of q/k/v, so it is neither
// compute nor bandwidth heavy; the limit is shared memory. The design keeps
// the unpadded sequence in device memory (197 rows, masked here, padded to
// 208 only in shared memory with zeros) and holds Q (9 KB), K and V (30 KB
// each), the f32 scores (54 KB) and bf16 probabilities (28 KB): 148 KB, one
// block per SM. bf16 tensor-core fragments (nvcuda::wmma 16x16x16) do both
// products; each of the 4 warps owns 16 query rows end to end, so after the
// loads no block-wide barrier is needed.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int QT = 64;  // query rows per block
constexpr int ATT_WARPS = QT / 16;

__host__ __device__ inline int pad16(int n) { return (n + 15) & ~15; }
// Row strides in elements; all keep 16-row fragment starts 32-byte aligned.
__host__ __device__ inline int ld_qkv(int d) { return d + 8; }
__host__ __device__ inline int ld_s(int np, int d) {
  return (np > d ? np : d) + 4;
}
__host__ __device__ inline int ld_p(int np) { return np + 8; }

__host__ __device__ inline size_t attention_smem_bytes(int n, int d) {
  const int np = pad16(n);
  return (size_t)(QT + 2 * np) * ld_qkv(d) * 2  // Q, K, V (bf16)
         + (size_t)QT * ld_s(np, d) * 4         // scores / output staging
         + (size_t)QT * ld_p(np) * 2;           // probabilities (bf16)
}

// Row-major [B*N, ld] operands of the strided instantiation (elements).
struct StridedQKV {
  const __nv_bfloat16 *q, *k, *v;
  __nv_bfloat16* o;
  int ld_q, ld_k, ld_v, ld_o;
};

// STRIDED = false: the block path, q/k/v from the packed qkv tensor (`qkv`)
// and p = bf16(e / l) before the p . v product. STRIDED = true: q/k/v/o from
// `sv`, and the division by l after the product.
template <int D, bool STRIDED>
__global__ void __launch_bounds__(ATT_WARPS * 32)
attention_core_kernel(const __nv_bfloat16* __restrict__ qkv,
                      __nv_bfloat16* __restrict__ out, int N, int H,
                      float scale, StridedQKV sv) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int NP = pad16(N);
  const int LDQ = ld_qkv(D), LDS_ = ld_s(NP, D), LDP = ld_p(NP);
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sK = sQ + QT * LDQ;
  __nv_bfloat16* sV = sK + NP * LDQ;
  float* sS = reinterpret_cast<float*>(sV + NP * LDQ);
  __nv_bfloat16* sP = reinterpret_cast<__nv_bfloat16*>(sS + QT * LDS_);

  const int q0 = blockIdx.x * QT, h = blockIdx.y, b = blockIdx.z;
  const int C = H * D;
  const size_t row_stride = (size_t)3 * C;
  const __nv_bfloat16* base = qkv + (size_t)b * N * row_stride + h * D;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  constexpr int VEC = D / 8;  // 16-byte vectors per head row

  for (int v = tid; v < QT * VEC; v += blockDim.x) {
    const int r = v / VEC, c = (v % VEC) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < N) {
      if constexpr (STRIDED)
        val = *reinterpret_cast<const uint4*>(
            sv.q + ((size_t)b * N + q0 + r) * sv.ld_q + h * D + c);
      else
        val = *reinterpret_cast<const uint4*>(
            base + (q0 + r) * row_stride + c);
    }
    *reinterpret_cast<uint4*>(sQ + r * LDQ + c) = val;
  }
  for (int v = tid; v < NP * VEC; v += blockDim.x) {
    const int r = v / VEC, c = (v % VEC) * 8;
    uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = make_uint4(0u, 0u, 0u, 0u);
    if (r < N) {
      if constexpr (STRIDED) {
        const size_t row = (size_t)b * N + r;
        kv = *reinterpret_cast<const uint4*>(sv.k + row * sv.ld_k + h * D + c);
        vv = *reinterpret_cast<const uint4*>(sv.v + row * sv.ld_v + h * D + c);
      } else {
        kv = *reinterpret_cast<const uint4*>(base + r * row_stride + C + c);
        vv = *reinterpret_cast<const uint4*>(base + r * row_stride + 2 * C + c);
      }
    }
    *reinterpret_cast<uint4*>(sK + r * LDQ + c) = kv;
    *reinterpret_cast<uint4*>(sV + r * LDQ + c) = vv;
  }
  __syncthreads();

  // S = (Q K^T) * scale for this warp's 16 rows.
  const int r0 = warp * 16;
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>
      fq[D / 16];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wmma::load_matrix_sync(fq[kk], sQ + r0 * LDQ + kk * 16, LDQ);
  for (int jt = 0; jt < NP / 16; ++jt) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      // K[j][d] read as a D x N column-major matrix is K^T.
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major> fk;
      wmma::load_matrix_sync(fk, sK + jt * 16 * LDQ + kk * 16, LDQ);
      wmma::mma_sync(acc, fq[kk], fk, acc);
    }
#pragma unroll
    for (int e = 0; e < acc.num_elements; ++e) acc.x[e] *= scale;
    wmma::store_matrix_sync(sS + r0 * LDS_ + jt * 16, acc, LDS_,
                            wmma::mem_row_major);
  }
  __syncwarp();

  // Exact softmax over the N valid keys of each row: p = bf16(e / l), or
  // (STRIDED) p = bf16(e) with lane r - r0 keeping row r's l for the end.
  float row_l = 1.f;
  for (int r = r0; r < r0 + 16; ++r) {
    float* srow = sS + r * LDS_;
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
    __nv_bfloat16* prow = sP + r * LDP;
    if constexpr (STRIDED) {
      if (lane == r - r0) row_l = l;
      for (int j = lane; j < NP; j += 32)
        prow[j] = __float2bfloat16(j < N ? srow[j] : 0.f);
    } else {
      for (int j = lane; j < NP; j += 32)
        prow[j] = __float2bfloat16(j < N ? __fdiv_rn(srow[j], l) : 0.f);
    }
  }
  __syncwarp();

  // O = P V (f32 accumulation), staged in this warp's score rows.
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> fo[D / 16];
#pragma unroll
  for (int dj = 0; dj < D / 16; ++dj) wmma::fill_fragment(fo[dj], 0.f);
  for (int kt = 0; kt < NP / 16; ++kt) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                   wmma::row_major> fp;
    wmma::load_matrix_sync(fp, sP + r0 * LDP + kt * 16, LDP);
#pragma unroll
    for (int dj = 0; dj < D / 16; ++dj) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fv;
      wmma::load_matrix_sync(fv, sV + kt * 16 * LDQ + dj * 16, LDQ);
      wmma::mma_sync(fo[dj], fp, fv, fo[dj]);
    }
  }
  float* stage = sS + r0 * LDS_;
#pragma unroll
  for (int dj = 0; dj < D / 16; ++dj)
    wmma::store_matrix_sync(stage + dj * 16, fo[dj], LDS_,
                            wmma::mem_row_major);
  __syncwarp();
  for (int e = lane; e < 16 * D; e += 32) {
    const int r = e / D, c = e % D;
    const int n = q0 + r0 + r;
    if constexpr (STRIDED) {
      // every lane runs the same 16 * D / 32 iterations: a full-warp shuffle
      const float l = __shfl_sync(0xffffffffu, row_l, r);
      if (n < N)
        sv.o[((size_t)b * N + n) * sv.ld_o + h * D + c] =
            __float2bfloat16(__fdiv_rn(stage[r * LDS_ + c], l));
    } else {
      if (n < N)
        out[((size_t)b * N + n) * C + h * D + c] =
            __float2bfloat16(stage[r * LDS_ + c]);
    }
  }
}

}  // namespace

extern "C" {

size_t ag_attention_smem_bytes(int n, int d) {
  return attention_smem_bytes(n, d);
}

// qkv: [B*N, 3*H*D] bf16 (columns ordered qkv-slot, head, dim);
// out: [B*N, H*D] bf16. Only D = 64 is built.
int ag_attention_core_bf16(const void* qkv, void* out, int B, int N, int H,
                           int D, float scale, void* stream) {
  if (D != 64 || N < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = attention_smem_bytes(N, D);
  cudaError_t err = cudaFuncSetAttribute(
      attention_core_kernel<64, false>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + QT - 1) / QT, H, B);
  attention_core_kernel<64, false><<<grid, ATT_WARPS * 32, smem,
                                     (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)qkv, (__nv_bfloat16*)out, N, H, scale,
      StridedQKV{});
  return (int)cudaGetLastError();
}

// q, k, v, out: [B*N, ld_*] bf16 row-major, head h at columns [h*D, h*D+D)
// of a row; each pointer 16-byte aligned and each ld_* a multiple of 8
// (checked by the caller). out = softmax(q k^T * scale) v per (image,
// head), divided by the row sum after the p . v product. Only D = 64 is
// built.
int ag_attention_bf16(const void* q, const void* k, const void* v, void* out,
                      int B, int N, int H, int D, int ld_q, int ld_k,
                      int ld_v, int ld_o, float scale, void* stream) {
  if (D != 64 || N < 1 || B < 1 || H < 1 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t smem = attention_smem_bytes(N, D);
  cudaError_t err = cudaFuncSetAttribute(
      attention_core_kernel<64, true>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const StridedQKV sv{(const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
                      (const __nv_bfloat16*)v, (__nv_bfloat16*)out,
                      ld_q, ld_k, ld_v, ld_o};
  const dim3 grid((N + QT - 1) / QT, H, B);
  attention_core_kernel<64, true><<<grid, ATT_WARPS * 32, smem,
                                    (cudaStream_t)stream>>>(
      nullptr, nullptr, N, H, scale, sv);
  return (int)cudaGetLastError();
}

}  // extern "C"
