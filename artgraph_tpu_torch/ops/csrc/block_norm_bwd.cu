// LayerNorm backward with the residual gradient, and the bias column sums:
// the row-wise and column-wise reductions of the transformer blocks'
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
//                           db_res = sum_rows f32(do) (db2, db_proj: the
//                           bias on the residual branch, whose gradient is
//                           do), in the same pass;
//   and the other dense bias's sum, db = sum_rows f32(dz) (db1 from dh,
//   db_qkv from dqkv), in colsum_kernel.
// The Pallas kernels carry these sums in VMEM across their sequential grid.
// Blocks on Hopper run in no order, so each sum runs in two passes: every
// block writes its partial sums over a fixed run of rows to a scratch row,
// then sum_groups.cuh adds the partials in block order. The runs depend only
// on the shapes (ops/attention.py: norm_groups, colsum_groups), so the
// results are the same on every call. No atomics.
//
// What bounds them on an H100: device memory. The LayerNorm backward reads x
// (bf16), dy (f32) and do (bf16) once and writes dx (bf16): at M = 6304,
// C = 768 that is 48.4 MB, 14.5 us at 3.35 TB/s. The column sums read their
// bf16 input once: 29 MB (8.7 us) for dqkv, 39 MB (11.6 us) for dh.
//
// The design, for that bound:
// - layernorm_bwd_kernel: one warp a row. Lane l owns the columns
//   [8l + 256j, 8l + 256j + 8) for j < CH = ceil(C / 256), so the row is read
//   once, as 16-byte loads (x and do one a chunk, dy two), and stays in
//   registers through the two warp reductions (sum x and sum x^2; then
//   sum dyg and sum dyg * xhat); dx goes out as 16-byte stores. The lane's
//   column partials of dgamma, dbeta and db_res sit in registers across
//   the warp's rows, gamma in shared memory. A block of LNB_WARPS warps
//   takes a fixed run of rows, adds its warps' partials in warp order
//   through shared memory and writes one f32 row [dgamma | dbeta | db_res]
//   of the scratch. The
//   registers (167 at C = 768, no spill) allow three blocks an SM; two an
//   SM (the split of ops/attention.py at ViT-B/16's shape) keep eight
//   warps' rows, 48 KB of loads, in flight on each.
// - colsum_kernel: a block of 32 x 8 threads covers 256 columns; thread
//   (x, y) owns 8 consecutive columns (one 16-byte load a row) and every
//   8th row of the block's run, COLSUM_UNROLL rows' loads in flight, with 8
//   f32 sums in registers; the 8 row lanes are added in order through shared
//   memory into one partial row a block.
// - No per-launch attribute call and no allocation: the launches are safe to
//   capture in a CUDA graph on PyTorch's current stream.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ptx_helpers.cuh"
#include "sum_groups.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int LNB_WARPS = 4;        // rows in flight a block, one a warp
constexpr int LNB_CHUNK = 256;      // columns of one 16-byte load a lane
constexpr int LNB_MAX_CHUNKS = 4;   // C <= 1024
constexpr int COLSUM_X = 32, COLSUM_Y = 8;  // threads: column groups x rows
constexpr int COLSUM_COLS = 8 * COLSUM_X;   // columns a block
constexpr int COLSUM_UNROLL = 4;            // rows' loads in flight a thread

struct NormArgs {
  const bf16* x;
  const float* gamma;
  const float* dy;
  const bf16* dres;
  bf16* dx;
  float* part;  // [groups, 3 * cols]
  int rows, cols, rows_per_group;
  float eps;
};

__device__ __forceinline__ void unpack8(const uint4& u, float (&f)[8]) {
  f[0] = ptx::bf16_lo(u.x);
  f[1] = ptx::bf16_hi(u.x);
  f[2] = ptx::bf16_lo(u.y);
  f[3] = ptx::bf16_hi(u.y);
  f[4] = ptx::bf16_lo(u.z);
  f[5] = ptx::bf16_hi(u.z);
  f[6] = ptx::bf16_lo(u.w);
  f[7] = ptx::bf16_hi(u.w);
}

__device__ __forceinline__ void load8(const float* p, float (&f)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  f[0] = a.x;
  f[1] = a.y;
  f[2] = a.z;
  f[3] = a.w;
  f[4] = b.x;
  f[5] = b.y;
  f[6] = b.z;
  f[7] = b.w;
}

__device__ __forceinline__ void warp_sum2(float& a, float& b) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
}

template <int CH>
__global__ void __launch_bounds__(LNB_WARPS * 32, CH <= 3 ? 3 : 2)
layernorm_bwd_kernel(const NormArgs a) {
  // gamma while the rows are walked, then the warps' column partials
  __shared__ __align__(16) float red[LNB_WARPS][3][CH * LNB_CHUNK];
  float* gam = red[0][0];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int cols = a.cols;
  for (int c = threadIdx.x; c < CH * LNB_CHUNK; c += LNB_WARPS * 32)
    gam[c] = c < cols ? a.gamma[c] : 0.f;
  float acc_g[CH][8], acc_b[CH][8], acc_r[CH][8];
#pragma unroll
  for (int j = 0; j < CH; ++j)
#pragma unroll
    for (int i = 0; i < 8; ++i) acc_g[j][i] = acc_b[j][i] = acc_r[j][i] = 0.f;
  __syncthreads();
  const float inv_cols = 1.0f / (float)cols;
  const int r0 = blockIdx.x * a.rows_per_group;
  const int r1 = min(a.rows, r0 + a.rows_per_group);
  for (int row = r0 + warp; row < r1; row += LNB_WARPS) {
    const size_t base = (size_t)row * cols;
    // the row's loads, all issued before the first use
    uint4 xv[CH], rv[CH];
    float xf[CH][8], d[CH][8];
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      const int c = 8 * lane + LNB_CHUNK * j;
      if (c < cols) {
        xv[j] = *reinterpret_cast<const uint4*>(a.x + base + c);
        rv[j] = *reinterpret_cast<const uint4*>(a.dres + base + c);
        load8(a.dy + base + c, d[j]);
      } else {
        xv[j] = rv[j] = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
        for (int i = 0; i < 8; ++i) d[j][i] = 0.f;
      }
    }
    float s = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      unpack8(xv[j], xf[j]);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        s += xf[j][i];
        s2 += xf[j][i] * xf[j][i];
      }
    }
    warp_sum2(s, s2);
    const float mean = s / (float)cols;
    const float var = fmaxf(
        __fsub_rn(s2 / (float)cols, __fmul_rn(mean, mean)), 0.f);
    const float rstd = rsqrtf(var + a.eps);
    // xf becomes xhat and d, once added into the column sums, dy * gamma;
    // columns past C have dy = gamma = 0 and add nothing
    float sg = 0.f, sgx = 0.f;
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      float g[8];
      load8(gam + 8 * lane + LNB_CHUNK * j, g);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        xf[j][i] = __fmul_rn(__fsub_rn(xf[j][i], mean), rstd);
        acc_g[j][i] += d[j][i] * xf[j][i];
        acc_b[j][i] += d[j][i];
        d[j][i] *= g[i];
        sg += d[j][i];
        sgx += d[j][i] * xf[j][i];
      }
    }
    warp_sum2(sg, sgx);
    const float mean_dyg = sg * inv_cols, mean_dyg_xhat = sgx * inv_cols;
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      const int c = 8 * lane + LNB_CHUNK * j;
      if (c >= cols) continue;
      float rf[8], out[8];
      unpack8(rv[j], rf);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        out[i] = rf[i] +
                 rstd * (d[j][i] - mean_dyg - xf[j][i] * mean_dyg_xhat);
        acc_r[j][i] += rf[i];
      }
      *reinterpret_cast<uint4*>(a.dx + base + c) =
          make_uint4(ptx::pack_bf16(out[0], out[1]),
                     ptx::pack_bf16(out[2], out[3]),
                     ptx::pack_bf16(out[4], out[5]),
                     ptx::pack_bf16(out[6], out[7]));
    }
  }
  // the block's partials: its warps' added in warp order
  __syncthreads();
#pragma unroll
  for (int j = 0; j < CH; ++j)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = 8 * lane + LNB_CHUNK * j + i;
      red[warp][0][c] = acc_g[j][i];
      red[warp][1][c] = acc_b[j][i];
      red[warp][2][c] = acc_r[j][i];
    }
  __syncthreads();
  float* out = a.part + (size_t)blockIdx.x * 3 * cols;
  for (int k = threadIdx.x; k < 3 * cols; k += LNB_WARPS * 32) {
    const int which = k / cols, c = k - which * cols;
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < LNB_WARPS; ++w) t += red[w][which][c];
    out[k] = t;
  }
}

// part[chunk, c] = sum over the chunk's rows of f32(in[r, c]); block
// (x, chunk) covers COLSUM_COLS columns.
__global__ void __launch_bounds__(COLSUM_X * COLSUM_Y)
colsum_kernel(const bf16* __restrict__ in, float* __restrict__ part,
              int rows, int cols, int rows_per_chunk) {
  __shared__ __align__(16) float red[COLSUM_Y][COLSUM_COLS];
  const int c = blockIdx.x * COLSUM_COLS + 8 * threadIdx.x;
  const int r1 = min(rows, (int)blockIdx.y * rows_per_chunk + rows_per_chunk);
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (c < cols) {
    const bf16* p = in + c;
    int r = blockIdx.y * rows_per_chunk + threadIdx.y;
    for (; r + (COLSUM_UNROLL - 1) * COLSUM_Y < r1;
         r += COLSUM_UNROLL * COLSUM_Y) {
      uint4 v[COLSUM_UNROLL];
#pragma unroll
      for (int u = 0; u < COLSUM_UNROLL; ++u)
        v[u] = *reinterpret_cast<const uint4*>(
            p + (size_t)(r + u * COLSUM_Y) * cols);
#pragma unroll
      for (int u = 0; u < COLSUM_UNROLL; ++u) {
        float f[8];
        unpack8(v[u], f);
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i] += f[i];
      }
    }
    for (; r < r1; r += COLSUM_Y) {
      float f[8];
      unpack8(*reinterpret_cast<const uint4*>(p + (size_t)r * cols), f);
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] += f[i];
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) red[threadIdx.y][8 * threadIdx.x + i] = acc[i];
  __syncthreads();
  // one column a thread: the row lanes added in order
  const int t = threadIdx.y * COLSUM_X + threadIdx.x;
  const int col = blockIdx.x * COLSUM_COLS + t;
  if (col < cols) {
    float s = 0.f;
#pragma unroll
    for (int y = 0; y < COLSUM_Y; ++y) s += red[y][t];
    part[(size_t)blockIdx.y * cols + col] = s;
  }
}

// The launch sequences, over a launcher (StreamRun below on a CUDA stream;
// the host emulation runs the same ones).

// The LayerNorm backward over `groups` runs of rows_per_group rows, then
// out [3 * cols] = [dgamma | dbeta | db_res], the partials summed in order.
template <class Run>
int norm_sequence(Run& run, const NormArgs& a, int groups, float* out) {
  const int chunks = (a.cols + LNB_CHUNK - 1) / LNB_CHUNK;
  const int err = run.norm(chunks, groups, a);
  return err ? err
             : run.sums(a.part, out, nullptr, groups, 3 * a.cols, 3 * a.cols);
}

// out [cols] = the column sums of in [rows, cols] over `chunks` runs of
// rows_per_chunk rows (partials in part [chunks, cols]), summed in order.
template <class Run>
int colsum_sequence(Run& run, const bf16* in, float* part, float* out,
                    int rows, int cols, int rows_per_chunk, int chunks) {
  const dim3 grid((cols + COLSUM_COLS - 1) / COLSUM_COLS, chunks);
  const int err = run.colsum(grid, in, part, rows, cols, rows_per_chunk);
  return err ? err : run.sums(part, out, nullptr, chunks, cols, cols);
}

// Host side: launches.

template <int CH>
cudaError_t launch_norm(int groups, const NormArgs& a, cudaStream_t s) {
  layernorm_bwd_kernel<CH><<<groups, LNB_WARPS * 32, 0, s>>>(a);
  return cudaGetLastError();
}

struct StreamRun {
  cudaStream_t s;
  int norm(int chunks, int groups, const NormArgs& a) {
    switch (chunks) {
      case 1: return (int)launch_norm<1>(groups, a, s);
      case 2: return (int)launch_norm<2>(groups, a, s);
      case 3: return (int)launch_norm<3>(groups, a, s);
      case 4: return (int)launch_norm<4>(groups, a, s);
    }
    return (int)cudaErrorInvalidValue;
  }
  int colsum(dim3 grid, const bf16* in, float* part, int rows, int cols,
             int rows_per_chunk) {
    colsum_kernel<<<grid, dim3(COLSUM_X, COLSUM_Y), 0, s>>>(
        in, part, rows, cols, rows_per_chunk);
    return (int)cudaGetLastError();
  }
  int sums(const float* part, float* lo, float* hi, int groups, int cols,
           int half) {
    return (int)sum_groups(part, lo, hi, groups, cols, half, s);
  }
};

// A split of `rows` into `groups` runs of `per` rows, none empty.
bool bad_split(int rows, int per, int groups) {
  return rows < 1 || per < 1 || groups < 1 || (rows + per - 1) / per != groups;
}

}  // namespace

extern "C" {

// dx [rows, cols] bf16 and out [3, cols] f32 = (dgamma, dbeta, db_res) from
// x (bf16), gamma (f32), dy (f32) and dres (bf16, the gradient reaching the
// block output), all contiguous and 16-byte aligned; cols a multiple of 8,
// at most 1024. Block b takes rows [b * rows_per_group, (b + 1) *
// rows_per_group); groups = ceil(rows / rows_per_group); scratch: f32
// [groups, 3 * cols].
int ag_layernorm_bwd_bf16(const void* x, const void* gamma, const void* dy,
                          const void* dres, void* dx, void* scratch,
                          void* out, int rows, int cols, float eps,
                          int rows_per_group, int groups, void* stream) {
  if (bad_split(rows, rows_per_group, groups) || cols < 8 || cols % 8 ||
      cols > LNB_MAX_CHUNKS * LNB_CHUNK)
    return (int)cudaErrorInvalidValue;
  StreamRun run{(cudaStream_t)stream};
  const NormArgs a{(const bf16*)x,   (const float*)gamma, (const float*)dy,
                   (const bf16*)dres, (bf16*)dx,          (float*)scratch,
                   rows,             cols,                rows_per_group,
                   eps};
  return norm_sequence(run, a, groups, (float*)out);
}

// out[c] = sum_r f32(in[r, c]) for bf16 in [rows, cols] (contiguous, 16-byte
// aligned, cols a multiple of 8) over `chunks` runs of rows_per_chunk rows;
// scratch: f32 [chunks, cols].
int ag_colsum_bf16(const void* in, void* scratch, void* out, int rows,
                   int cols, int rows_per_chunk, int chunks, void* stream) {
  if (bad_split(rows, rows_per_chunk, chunks) || chunks > 65535 || cols < 8 ||
      cols % 8)
    return (int)cudaErrorInvalidValue;
  StreamRun run{(cudaStream_t)stream};
  return colsum_sequence(run, (const bf16*)in, (float*)scratch, (float*)out,
                         rows, cols, rows_per_chunk, chunks);
}

}  // extern "C"
