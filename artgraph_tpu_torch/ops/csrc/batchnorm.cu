// The BatchNorm chain of the ResNet trunk (models/resnet.py MixedBatchNorm
// and the bottleneck's tail), train and eval, forward and backward
// (ops/batchnorm.py).
//
// Replaces no Pallas kernel: the JAX package leaves MixedBatchNorm to XLA,
// which fuses its elementwise passes. On the card PyTorch ran them as ~20
// ATen kernels a layer each way. These kernels compute the same function
// with the same rounding points, so kernel and plain version
// (MixedBatchNorm's expressions under autograd) differ only in the order of
// accumulation of the sums:
//   statistics: s1 = sum_rows f32(x), s2 = sum_rows f32(x)^2
//   finishing:  mean = s1 / n, diff = s2 / n - mean^2, var = max(diff, 0)
//               (/ n as PyTorch divides on the card, per_row),
//               rstd = rsqrt(var + eps), a = bf16(w rstd),
//               b = bf16(bias - (mean w) rstd); the running statistics with
//               momentum and the unbiased n / (n - 1); eval: mean and var
//               the running ones
//   apply:      y = bf16(bf16(x a) + b), optionally ReLU; the bottleneck's
//               tail bf16(relu(f32(y3) + f32(yd or the identity)))
//   backward:   gm = g masked by the saved output's ReLU; the column sums
//               da = bf16(sum_rows bf16(gm x)), db = bf16(sum_rows gm);
//               their finishing into dgamma, dbeta and the statistics'
//               c1 = dmean / n, c2 = dmsq / n (autograd's own formulas,
//               operation by operation, no FMA); and the elementwise
//               dx = bf16(bf16(gm a) + bf16(c1 + c2 (2 x))), the identity's
//               gradient gm
// on x [M, C] bf16, the rows of a channels-last activation (M = B*H*W).
//
// What bounds them on an H100: device memory. A ResNet50 step at batch 32
// holds 355.6 M BatchNorm elements, 0.71 GB a bf16 pass; each kernel reads
// and writes each element once and keeps every intermediate in registers.
// The design, for that bound:
//   * The streaming kernels (statistics, apply, column sums, dx) share one
//     layout: a block of 256 threads covers a tile of up to 256 channels,
//     a thread 8 consecutive channels (one 16-byte load or store a row) of
//     every `step`-th row of the block's fixed run of rows (step = 256 /
//     threads along the tile: 8 at C >= 256, 32 at C = 64), UNROLL rows'
//     loads in flight before their first use. The grid is channel tiles x
//     runs, at most TARGET_BLOCKS blocks (ops/batchnorm.py row_chunks), so
//     that layer4's small tensors (1568 x 2048) still spread over the SMs
//     without a block per 16 rows.
//   * The sums (statistics, column sums) go through f32 registers, the
//     block's row lanes added in order through shared memory into one
//     partial row a run, and the partial rows added in run order by the
//     finishing kernel that reads them (merge2): no atomics, so every sum
//     is bit-identical from call to call.
//   * Finishing is a small launch a BatchNorm each way (a block of 32
//     channels x 16 lanes merges the partials, its first lane finishes). It
//     stays apart from the statistics so that a data-parallel step can sum
//     the raw sums over the ranks in between (FIN_MERGE writes them).
//   * The statistics' backward (c1 + c2 2x) and the ReLU mask (from the
//     saved output) ride in the elementwise pass; the tail's two
//     BatchNorms share one column-sum pass and one dx pass.
//   * No allocation, no attribute call (static shared memory, at most 24
//     KB): the launches are safe to capture in a CUDA graph on PyTorch's
//     current stream.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ptx_helpers.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;       // a streaming kernel's block
constexpr int MAX_LANES = 32;      // threads along C: tiles of 256 channels
constexpr int UNROLL = 4;          // rows' loads in flight a thread
constexpr int MERGE_X = 32, MERGE_Y = 16;  // finishing: channels x lanes

// Finishing modes: the merged raw sums (and n) only, for a data-parallel
// all-reduce; moments -> coefficients and running statistics; the running
// statistics -> coefficients.
enum FinishMode { FIN_MERGE = 0, FIN_TRAIN = 1, FIN_EVAL = 2 };

// The operands of the streaming kernels; the branches are the BatchNorms
// that one launch covers (two in the bottleneck's tail with a downsample).
struct Ew {
  const bf16* x[2];    // the BatchNorms' inputs [M, C]
  const bf16* a[2];    // their scale and shift [C] (dx: a null adds g
  const bf16* b[2];    //   unscaled, the coefficients' own backward)
  const float* cs[2];  // dx: [2, C] (c1, c2) of a branch's statistics
  const bf16* id;      // apply: the identity added before the ReLU
  const bf16* g;       // column sums, dx: the output's gradient (dx: may
                       //   be null, zero)
  const bf16* o;       // column sums, dx: the saved output, whose ReLU
                       //   mask applies to g (null: no ReLU)
  bf16* out;           // apply: the output
  bf16* dx[2];         // dx: the branches' input gradients
  bf16* did;           // dx: the identity's gradient
  float* part;         // statistics, column sums: [runs, S * C]
  int M, C, rows_per_chunk, relu;
};

// The finishing kernels' operands, forward and backward.
struct Fin {
  const float* p1;     // sums to merge: sum_g p1[g * stride + c], the
  const float* p2;     //   same of p2 (s1, s2; backward: da, db)
  int groups, stride;
  const bf16* da;      // backward: the unit's bf16 da, db in place of
  const bf16* db;      //   the sums (null: the sums)
  const float* n_dev;  // the row count on the device (data parallel), or
  float n_host;        //   null and this
  const float* w;
  const float* bias;
  float* rm;           // running mean and variance, updated in place
  float* rv;
  long long* nbt;      // num_batches_tracked (null: its owner adds)
  bf16* a;             // forward: the coefficients [C]
  bf16* b;
  float* saved;        // [3, C]: mean, rstd, s2 / n - mean^2
  float* sums;         // FIN_MERGE: [2C + 1] = s1, s2, n
  float* dw;           // backward: dgamma, dbeta [C]
  float* dbias;
  float* cs;           // backward: [2, C] (c1, c2), train only
  int C, mode;
  float eps, momentum, keep;
};

__device__ __forceinline__ float bf16r(float v) {  // rounded to bf16
  return __bfloat162float(__float2bfloat16(v));
}

// v / n as PyTorch divides on the card: by a host number as v * (1 / n)
// (the f32 reciprocal), by a tensor on the device exactly.
__device__ __forceinline__ float per_row(float v, const Fin& f) {
  return f.n_dev ? __fdiv_rn(v, *f.n_dev)
                 : __fmul_rn(v, __fdiv_rn(1.f, f.n_host));
}

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

__device__ __forceinline__ uint4 pack8(const float (&f)[8]) {
  return make_uint4(ptx::pack_bf16(f[0], f[1]), ptx::pack_bf16(f[2], f[3]),
                    ptx::pack_bf16(f[4], f[5]), ptx::pack_bf16(f[6], f[7]));
}

__device__ __forceinline__ uint4 load16(const bf16* p, int r, int C, int c) {
  return *reinterpret_cast<const uint4*>(p + (size_t)r * C + c);
}

__device__ __forceinline__ void store16(bf16* p, int r, int C, int c,
                                        const float (&f)[8]) {
  *reinterpret_cast<uint4*>(p + (size_t)r * C + c) = pack8(f);
}

__device__ __forceinline__ void load_coef(const bf16* p, int c,
                                          float (&f)[8]) {
  unpack8(*reinterpret_cast<const uint4*>(p + c), f);
}

__device__ __forceinline__ void load_f32(const float* p, float (&f)[8]) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  const float4 v = *reinterpret_cast<const float4*>(p + 4);
  f[0] = u.x;
  f[1] = u.y;
  f[2] = u.z;
  f[3] = u.w;
  f[4] = v.x;
  f[5] = v.y;
  f[6] = v.z;
  f[7] = v.w;
}

// A streaming thread's place: channels [c, c + 8) of the block's tile, rows
// r0 + row, r0 + row + step, ... < r1 of the block's run.
struct Lane {
  int c, row, step, r0, r1;
  bool live;
};

__device__ __forceinline__ Lane lane_of(const Ew& e) {
  const int lanes = min(e.C / 8, MAX_LANES);
  const int step = THREADS / lanes;
  const int l = threadIdx.x % lanes, row = threadIdx.x / lanes;
  const int c = 8 * (blockIdx.x * lanes + l);
  const int r0 = blockIdx.y * e.rows_per_chunk;
  return {c, row, step, r0, min(e.M, r0 + e.rows_per_chunk),
          row < step && c < e.C};
}

// The block's partial row of S column sums: acc[j][i] is this thread's sum
// j of channel c + i; the row lanes are added in order, and sum j of
// channel c goes to part[blockIdx.y][j * C + c]. Every thread calls it.
template <int S>
__device__ void block_partials(const float (&acc)[S][8], float* red,
                               const Ew& e) {
  const int lanes = min(e.C / 8, MAX_LANES), width = 8 * lanes;
  const int step = THREADS / lanes;
  const int l = threadIdx.x % lanes, row = threadIdx.x / lanes;
  if (row < step)
#pragma unroll
    for (int j = 0; j < S; ++j)
#pragma unroll
      for (int i = 0; i < 8; ++i)
        red[(row * S + j) * width + 8 * l + i] = acc[j][i];
  __syncthreads();
  for (int k = threadIdx.x; k < S * width; k += THREADS) {
    float t = 0.f;
    for (int y = 0; y < step; ++y) t += red[y * S * width + k];
    const int j = k / width, c = blockIdx.x * width + k % width;
    if (c < e.C) e.part[(size_t)blockIdx.y * S * e.C + j * e.C + c] = t;
  }
}

// part[run] = (sum f32(x), sum f32(x)^2) over the run's rows.
__global__ void __launch_bounds__(THREADS) bn_stats_kernel(const Ew e) {
  __shared__ float red[2 * 8 * THREADS];
  const Lane ln = lane_of(e);
  float acc[2][8] = {};
  if (ln.live)
    for (int r = ln.r0 + ln.row; r < ln.r1; r += UNROLL * ln.step) {
      uint4 v[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        if (r + u * ln.step < ln.r1)
          v[u] = load16(e.x[0], r + u * ln.step, e.C, ln.c);
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (r + u * ln.step >= ln.r1) break;
        float f[8];
        unpack8(v[u], f);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          acc[0][i] += f[i];
          acc[1][i] += __fmul_rn(f[i], f[i]);
        }
      }
    }
  block_partials<2>(acc, red, e);
}

// out = bf16(bf16(x0 a0) + b0) [+ the second branch's or the identity, in
// f32] [ReLU], rounded once more to bf16.
template <int NB>
__global__ void __launch_bounds__(THREADS) bn_apply_kernel(const Ew e) {
  const Lane ln = lane_of(e);
  if (!ln.live) return;
  float a[NB][8], b[NB][8];
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    load_coef(e.a[j], ln.c, a[j]);
    load_coef(e.b[j], ln.c, b[j]);
  }
  const bf16* second = NB == 2 ? e.x[1] : e.id;
  for (int r = ln.r0 + ln.row; r < ln.r1; r += UNROLL * ln.step) {
    uint4 v0[UNROLL], v1[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int ru = r + u * ln.step;
      if (ru < ln.r1) {
        v0[u] = load16(e.x[0], ru, e.C, ln.c);
        if (second) v1[u] = load16(second, ru, e.C, ln.c);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int ru = r + u * ln.step;
      if (ru >= ln.r1) break;
      float y[8], f[8];
      unpack8(v0[u], f);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        y[i] = bf16r(__fadd_rn(bf16r(__fmul_rn(f[i], a[0][i])), b[0][i]));
      if (second) {
        unpack8(v1[u], f);
#pragma unroll
        for (int i = 0; i < 8; ++i)
          y[i] = __fadd_rn(
              y[i], NB == 2 ? bf16r(__fadd_rn(
                                  bf16r(__fmul_rn(f[i], a[NB - 1][i])),
                                  b[NB - 1][i]))
                            : f[i]);
      }
      if (e.relu)
#pragma unroll
        for (int i = 0; i < 8; ++i) y[i] = y[i] <= 0.f ? 0.f : y[i];
      store16(e.out, ru, e.C, ln.c, y);
    }
  }
}

// g masked by the ReLU of the saved output o (torch's threshold_backward:
// zero where o <= 0).
__device__ __forceinline__ void masked(const uint4& g, const uint4* o,
                                       float (&gm)[8]) {
  unpack8(g, gm);
  if (o) {
    float f[8];
    unpack8(*o, f);
#pragma unroll
    for (int i = 0; i < 8; ++i) gm[i] = f[i] <= 0.f ? 0.f : gm[i];
  }
}

// part[run] = (sum bf16(gm x0) [, sum bf16(gm x1)], sum gm) over the run.
template <int NB>
__global__ void __launch_bounds__(THREADS) bn_colsum_kernel(const Ew e) {
  __shared__ float red[(NB + 1) * 8 * THREADS];
  const Lane ln = lane_of(e);
  float acc[NB + 1][8] = {};
  if (ln.live)
    for (int r = ln.r0 + ln.row; r < ln.r1; r += UNROLL * ln.step) {
      uint4 g[UNROLL], o[UNROLL], x[NB][UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int ru = r + u * ln.step;
        if (ru < ln.r1) {
          g[u] = load16(e.g, ru, e.C, ln.c);
          if (e.o) o[u] = load16(e.o, ru, e.C, ln.c);
#pragma unroll
          for (int j = 0; j < NB; ++j) x[j][u] = load16(e.x[j], ru, e.C, ln.c);
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (r + u * ln.step >= ln.r1) break;
        float gm[8], f[8];
        masked(g[u], e.o ? &o[u] : nullptr, gm);
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          unpack8(x[j][u], f);
#pragma unroll
          for (int i = 0; i < 8; ++i) acc[j][i] += bf16r(__fmul_rn(gm[i], f[i]));
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[NB][i] += gm[i];
      }
    }
  block_partials<NB + 1>(acc, red, e);
}

// dx_j = bf16(bf16(gm a_j) + bf16(c1_j + c2_j (2 x_j))) (the first term gm
// unscaled where a_j is null, the second where the branch has no
// statistics of its own), did = gm.
template <int NB>
__global__ void __launch_bounds__(THREADS) bn_dx_kernel(const Ew e) {
  const Lane ln = lane_of(e);
  if (!ln.live) return;
  float a[NB][8], c1[NB][8], c2[NB][8];
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    if (e.a[j]) load_coef(e.a[j], ln.c, a[j]);
    if (e.cs[j]) {
      load_f32(e.cs[j] + ln.c, c1[j]);
      load_f32(e.cs[j] + e.C + ln.c, c2[j]);
    }
  }
  for (int r = ln.r0 + ln.row; r < ln.r1; r += UNROLL * ln.step) {
    uint4 g[UNROLL], o[UNROLL], x[NB][UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int ru = r + u * ln.step;
      if (ru < ln.r1) {
        g[u] = e.g ? load16(e.g, ru, e.C, ln.c) : make_uint4(0u, 0u, 0u, 0u);
        if (e.o) o[u] = load16(e.o, ru, e.C, ln.c);
#pragma unroll
        for (int j = 0; j < NB; ++j)
          if (e.cs[j]) x[j][u] = load16(e.x[j], ru, e.C, ln.c);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int ru = r + u * ln.step;
      if (ru >= ln.r1) break;
      float gm[8];
      masked(g[u], e.o ? &o[u] : nullptr, gm);
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        float d[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          d[i] = e.a[j] ? bf16r(__fmul_rn(gm[i], a[j][i])) : gm[i];
        if (e.cs[j]) {
          float f[8];
          unpack8(x[j][u], f);
#pragma unroll
          for (int i = 0; i < 8; ++i)
            d[i] = bf16r(__fadd_rn(
                d[i], bf16r(__fadd_rn(c1[j][i],
                                      __fmul_rn(c2[j][i], 2.f * f[i])))));
        }
        store16(e.dx[j], ru, e.C, ln.c, d);
      }
      if (e.did) store16(e.did, ru, e.C, ln.c, gm);
    }
  }
}

// s1 = sum_g p1[g * stride + c], s2 the same of p2, for the block's
// channel c: each of the MERGE_Y lanes adds every MERGE_Y-th group, then
// the first adds the lanes in order (lane 0 holds the result). Every
// thread calls it.
__device__ void merge2(const Fin& f, int c, float& s1, float& s2) {
  __shared__ float red[2][MERGE_Y][MERGE_X + 1];
  float a = 0.f, b = 0.f;
  if (c < f.C)
    for (int g = threadIdx.y; g < f.groups; g += MERGE_Y) {
      a += f.p1[(size_t)g * f.stride + c];
      b += f.p2[(size_t)g * f.stride + c];
    }
  red[0][threadIdx.y][threadIdx.x] = a;
  red[1][threadIdx.y][threadIdx.x] = b;
  __syncthreads();
  s1 = s2 = 0.f;
  if (threadIdx.y == 0)
    for (int y = 0; y < MERGE_Y; ++y) {
      s1 += red[0][y][threadIdx.x];
      s2 += red[1][y][threadIdx.x];
    }
}

// Moments -> a, b and the running statistics (FIN_TRAIN), the running
// statistics -> a, b (FIN_EVAL), or the merged sums alone (FIN_MERGE);
// MixedBatchNorm.forward's expressions in its order of operations.
__global__ void __launch_bounds__(MERGE_X * MERGE_Y)
bn_finish_kernel(const Fin f) {
  const int c = blockIdx.x * MERGE_X + threadIdx.x;
  float s1 = 0.f, s2 = 0.f;
  if (f.mode != FIN_EVAL) merge2(f, c, s1, s2);
  if (threadIdx.y != 0 || c >= f.C) return;
  if (f.mode == FIN_MERGE) {
    f.sums[c] = s1;
    f.sums[f.C + c] = s2;
    if (c == 0) f.sums[2 * f.C] = f.n_host;
    return;
  }
  float mean, var, diff = 0.f;
  if (f.mode == FIN_TRAIN) {
    mean = per_row(s1, f);
    diff = __fsub_rn(per_row(s2, f), __fmul_rn(mean, mean));
    var = diff < 0.f ? 0.f : diff;  // torch.clamp(min=0): NaN stays
    const double nd = f.n_dev ? *f.n_dev : f.n_host;
    const float unbiased = (float)(nd / fmax(nd - 1.0, 1.0));
    f.rm[c] = __fadd_rn(__fmul_rn(f.keep, f.rm[c]),
                        __fmul_rn(f.momentum, mean));
    f.rv[c] = __fadd_rn(__fmul_rn(f.keep, f.rv[c]),
                        __fmul_rn(f.momentum, __fmul_rn(var, unbiased)));
    if (c == 0 && f.nbt) *f.nbt += 1;
  } else {
    mean = f.rm[c];
    var = f.rv[c];
  }
  const float rstd = rsqrtf(__fadd_rn(var, f.eps));
  f.a[c] = __float2bfloat16(__fmul_rn(f.w[c], rstd));
  f.b[c] = __float2bfloat16(
      __fsub_rn(f.bias[c], __fmul_rn(__fmul_rn(mean, f.w[c]), rstd)));
  f.saved[c] = mean;
  f.saved[f.C + c] = rstd;
  f.saved[2 * f.C + c] = diff;
}

// (da, db) -> dgamma, dbeta and, in training, the statistics' (c1, c2):
// autograd's backward of bn_finish_kernel's expressions, node by node.
__global__ void __launch_bounds__(MERGE_X * MERGE_Y)
bn_finish_bwd_kernel(const Fin f) {
  const int c = blockIdx.x * MERGE_X + threadIdx.x;
  float s1 = 0.f, s2 = 0.f;
  if (!f.da) merge2(f, c, s1, s2);
  if (threadIdx.y != 0 || c >= f.C) return;
  const float da = f.da ? __bfloat162float(f.da[c]) : bf16r(s1);
  const float db = f.db ? __bfloat162float(f.db[c]) : bf16r(s2);
  const float mean = f.saved[c], rstd = f.saved[f.C + c], w = f.w[c];
  // b = bias - (mean w) rstd, a = w rstd
  const float du = __fmul_rn(-db, rstd);
  const float drstd = __fadd_rn(__fmul_rn(-db, __fmul_rn(mean, w)),
                                __fmul_rn(da, w));
  f.dw[c] = __fadd_rn(__fmul_rn(du, mean), __fmul_rn(da, rstd));
  f.dbias[c] = db;
  if (f.mode != FIN_TRAIN) return;
  // rstd = rsqrt(var + eps): -0.5 grad rstd^3; var = clamp(diff, min=0)
  const float dvar = __fmul_rn(__fmul_rn(-0.5f, drstd),
                               __fmul_rn(__fmul_rn(rstd, rstd), rstd));
  const float ddiff = f.saved[2 * f.C + c] >= 0.f ? dvar : 0.f;
  // diff = msq - mean^2; mean is also in u = mean w
  const float dmean = __fadd_rn(__fmul_rn(du, w),
                                __fmul_rn(-ddiff, 2.f * mean));
  f.cs[c] = per_row(dmean, f);
  f.cs[f.C + c] = per_row(ddiff, f);
}

// The entry points' checks, arguments and grids, over a launcher:
// run.go(kernel, grid, block, args) launches kernel<<<grid, block>>>(args)
// (StreamRun below on a CUDA stream; the host emulation runs the same
// ones). Each returns 0 or an error code. Every pointer: contiguous device
// memory, the bf16 ones 16-byte aligned.

inline dim3 stream_grid(int C, int chunks) {
  const int width = 8 * (C / 8 < MAX_LANES ? C / 8 : MAX_LANES);
  return dim3((C + width - 1) / width, chunks);
}

inline dim3 finish_grid(int C) { return dim3((C + MERGE_X - 1) / MERGE_X); }

// rows [M, C] in `chunks` runs of rows_per_chunk rows, none empty; C a
// positive multiple of 8.
inline bool bad_rows(int M, int C, int rows_per_chunk, int chunks) {
  return M < 1 || C < 8 || C % 8 || rows_per_chunk < 1 || chunks < 1 ||
         chunks > 65535 || (M + rows_per_chunk - 1) / rows_per_chunk != chunks;
}

inline Ew rows_args(int M, int C, int rows_per_chunk) {
  Ew e = {};
  e.M = M;
  e.C = C;
  e.rows_per_chunk = rows_per_chunk;
  return e;
}

// part [chunks, 2C] f32 = (sum x, sum x^2) of each run of bf16 x [M, C].
template <class Run>
int stats_entry(Run& run, const void* x, void* part, int M, int C,
                int rows_per_chunk, int chunks) {
  if (bad_rows(M, C, rows_per_chunk, chunks) || !x || !part)
    return (int)cudaErrorInvalidValue;
  Ew e = rows_args(M, C, rows_per_chunk);
  e.x[0] = (const bf16*)x;
  e.part = (float*)part;
  return run.go(bn_stats_kernel, stream_grid(C, chunks), dim3(THREADS), e);
}

// mode FIN_TRAIN: a, b [C] bf16, saved [3, C] f32 and the running mean,
// variance (f32 [C]) and num_batches_tracked (int64; null: not) updated,
// from the sums
// sum_g p1[g * stride + c] and sum_g p2[g * stride + c] over n rows (n_dev
// if given, else n_host); FIN_EVAL: a, b and saved from the running
// statistics; FIN_MERGE: sums [2C + 1] = (s1, s2, n_host) only.
template <class Run>
int finish_entry(Run& run, const void* p1, const void* p2, int groups,
                 int stride, const void* n_dev, float n_host, const void* w,
                 const void* bias, void* rm, void* rv, void* nbt, void* a,
                 void* b, void* saved, void* sums, int C, int mode, float eps,
                 float momentum, float keep) {
  const bool merges = mode != FIN_EVAL;
  if (C < 1 || mode < FIN_MERGE || mode > FIN_EVAL ||
      (merges && (!p1 || !p2 || groups < 1 || stride < C)) ||
      (mode == FIN_MERGE ? !sums
                         : (!w || !bias || !rm || !rv || !a || !b || !saved)))
    return (int)cudaErrorInvalidValue;
  const Fin f{(const float*)p1, (const float*)p2, groups, stride, nullptr,
              nullptr, (const float*)n_dev, n_host, (const float*)w,
              (const float*)bias, (float*)rm, (float*)rv, (long long*)nbt,
              (bf16*)a, (bf16*)b, (float*)saved, (float*)sums, nullptr,
              nullptr, nullptr, C, mode, eps, momentum, keep};
  return run.go(bn_finish_kernel, finish_grid(C), dim3(MERGE_X, MERGE_Y), f);
}

// out [M, C] = bf16(bf16(x0 a0) + b0), plus in f32 the second branch's
// bf16(bf16(x1 a1) + b1) or the identity id (x1, id null: neither), then
// ReLU if relu, rounded to bf16.
template <class Run>
int apply_entry(Run& run, const void* x0, const void* a0, const void* b0,
                const void* x1, const void* a1, const void* b1,
                const void* id, void* out, int M, int C, int relu,
                int rows_per_chunk, int chunks) {
  if (bad_rows(M, C, rows_per_chunk, chunks) || !x0 || !a0 || !b0 || !out ||
      (x1 && (!a1 || !b1 || id)))
    return (int)cudaErrorInvalidValue;
  Ew e = rows_args(M, C, rows_per_chunk);
  e.x[0] = (const bf16*)x0;
  e.a[0] = (const bf16*)a0;
  e.b[0] = (const bf16*)b0;
  e.x[1] = (const bf16*)x1;
  e.a[1] = (const bf16*)a1;
  e.b[1] = (const bf16*)b1;
  e.id = (const bf16*)id;
  e.out = (bf16*)out;
  e.relu = relu;
  const dim3 grid = stream_grid(C, chunks);
  return x1 ? run.go(bn_apply_kernel<2>, grid, dim3(THREADS), e)
            : run.go(bn_apply_kernel<1>, grid, dim3(THREADS), e);
}

// part [chunks, S C] f32 = (sum bf16(gm x0) [, sum bf16(gm x1)], sum gm)
// over each run, S = 2 or 3; gm = g masked where the saved output o <= 0
// (o null: g).
template <class Run>
int colsum_entry(Run& run, const void* g, const void* o, const void* x0,
                 const void* x1, void* part, int M, int C,
                 int rows_per_chunk, int chunks) {
  if (bad_rows(M, C, rows_per_chunk, chunks) || !g || !x0 || !part)
    return (int)cudaErrorInvalidValue;
  Ew e = rows_args(M, C, rows_per_chunk);
  e.g = (const bf16*)g;
  e.o = (const bf16*)o;
  e.x[0] = (const bf16*)x0;
  e.x[1] = (const bf16*)x1;
  e.part = (float*)part;
  const dim3 grid = stream_grid(C, chunks);
  return x1 ? run.go(bn_colsum_kernel<2>, grid, dim3(THREADS), e)
            : run.go(bn_colsum_kernel<1>, grid, dim3(THREADS), e);
}

// dgamma, dbeta [C] f32 and, if train, cs [2, C] = (c1, c2) from
// da = bf16(sum_g p1[g * stride + c]), db = bf16(sum_g p2[...]), or from
// the bf16 da, db [C] where given; saved [3, C] and the row count as
// finish_entry takes them.
template <class Run>
int finish_bwd_entry(Run& run, const void* p1, const void* p2, int groups,
                     int stride, const void* da, const void* db,
                     const void* saved, const void* w, const void* n_dev,
                     float n_host, void* dw, void* dbias, void* cs, int C,
                     int train) {
  if (C < 1 || !saved || !w || !dw || !dbias || (train && !cs) ||
      (!da != !db) || (!da && (!p1 || !p2 || groups < 1 || stride < C)))
    return (int)cudaErrorInvalidValue;
  const Fin f{(const float*)p1, (const float*)p2, groups, stride,
              (const bf16*)da, (const bf16*)db, (const float*)n_dev, n_host,
              (const float*)w, nullptr, nullptr, nullptr, nullptr, nullptr,
              nullptr, (float*)saved, nullptr, (float*)dw, (float*)dbias,
              (float*)cs, C, train ? FIN_TRAIN : FIN_EVAL, 0.f, 0.f, 0.f};
  return run.go(bn_finish_bwd_kernel, finish_grid(C), dim3(MERGE_X, MERGE_Y),
                f);
}

// dx_j [M, C] = bf16(bf16(gm a_j) + bf16(c1_j + c2_j (2 x_j))) for each
// branch j (dx1 null: one; a_j null: gm unscaled; cs_j null: no statistics
// term, x_j not read), did = gm where given; gm = g masked where the saved
// output o <= 0 (o null: g; g null: zero).
template <class Run>
int dx_entry(Run& run, const void* g, const void* o, const void* x0,
             const void* a0, const void* cs0, const void* x1, const void* a1,
             const void* cs1, void* dx0, void* dx1, void* did, int M, int C,
             int rows_per_chunk, int chunks) {
  if (bad_rows(M, C, rows_per_chunk, chunks) || !dx0 || (cs0 && !x0) ||
      (!dx1 && (x1 || a1 || cs1)) || (cs1 && !x1))
    return (int)cudaErrorInvalidValue;
  Ew e = rows_args(M, C, rows_per_chunk);
  e.g = (const bf16*)g;
  e.o = (const bf16*)o;
  e.x[0] = (const bf16*)x0;
  e.a[0] = (const bf16*)a0;
  e.cs[0] = (const float*)cs0;
  e.x[1] = (const bf16*)x1;
  e.a[1] = (const bf16*)a1;
  e.cs[1] = (const float*)cs1;
  e.dx[0] = (bf16*)dx0;
  e.dx[1] = (bf16*)dx1;
  e.did = (bf16*)did;
  const dim3 grid = stream_grid(C, chunks);
  return dx1 ? run.go(bn_dx_kernel<2>, grid, dim3(THREADS), e)
             : run.go(bn_dx_kernel<1>, grid, dim3(THREADS), e);
}

// Host side: launches.

struct StreamRun {
  cudaStream_t s;
  template <class A>
  int go(void (*kernel)(const A), dim3 grid, dim3 block, const A& args) {
    kernel<<<grid, block, 0, s>>>(args);
    return (int)cudaGetLastError();
  }
};

}  // namespace

extern "C" {

int ag_bn_stats_bf16(const void* x, void* part, int M, int C,
                     int rows_per_chunk, int chunks, void* stream) {
  StreamRun run{(cudaStream_t)stream};
  return stats_entry(run, x, part, M, C, rows_per_chunk, chunks);
}

int ag_bn_finish(const void* p1, const void* p2, int groups, int stride,
                 const void* n_dev, float n_host, const void* w,
                 const void* bias, void* rm, void* rv, void* nbt, void* a,
                 void* b, void* saved, void* sums, int C, int mode, float eps,
                 float momentum, float keep, void* stream) {
  StreamRun run{(cudaStream_t)stream};
  return finish_entry(run, p1, p2, groups, stride, n_dev, n_host, w, bias, rm,
                      rv, nbt, a, b, saved, sums, C, mode, eps, momentum,
                      keep);
}

int ag_bn_apply_bf16(const void* x0, const void* a0, const void* b0,
                     const void* x1, const void* a1, const void* b1,
                     const void* id, void* out, int M, int C, int relu,
                     int rows_per_chunk, int chunks, void* stream) {
  StreamRun run{(cudaStream_t)stream};
  return apply_entry(run, x0, a0, b0, x1, a1, b1, id, out, M, C, relu,
                     rows_per_chunk, chunks);
}

int ag_bn_colsum_bf16(const void* g, const void* o, const void* x0,
                      const void* x1, void* part, int M, int C,
                      int rows_per_chunk, int chunks, void* stream) {
  StreamRun run{(cudaStream_t)stream};
  return colsum_entry(run, g, o, x0, x1, part, M, C, rows_per_chunk, chunks);
}

int ag_bn_finish_bwd(const void* p1, const void* p2, int groups, int stride,
                     const void* da, const void* db, const void* saved,
                     const void* w, const void* n_dev, float n_host,
                     void* dw, void* dbias, void* cs, int C, int train,
                     void* stream) {
  StreamRun run{(cudaStream_t)stream};
  return finish_bwd_entry(run, p1, p2, groups, stride, da, db, saved, w,
                          n_dev, n_host, dw, dbias, cs, C, train);
}

int ag_bn_dx_bf16(const void* g, const void* o, const void* x0,
                  const void* a0, const void* cs0, const void* x1,
                  const void* a1, const void* cs1, void* dx0, void* dx1,
                  void* did, int M, int C, int rows_per_chunk, int chunks,
                  void* stream) {
  StreamRun run{(cudaStream_t)stream};
  return dx_entry(run, g, o, x0, a0, cs0, x1, a1, cs1, dx0, dx1, did, M, C,
                  rows_per_chunk, chunks);
}

}  // extern "C"
