// The fixed-order second pass of the port's reductions across an unordered
// grid (conv_bn.cu: the column sums of the unit and its weight gradient's
// chunks; block_gemm.cu: the split-K weight gradients): f32 partials
// part[g][c] written by the blocks of the first pass, added here over g in
// an order that does not depend on the schedule, so every result is
// bit-identical from call to call. No atomics.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int SUM_X = 32, SUM_Y = 16;   // two-level pass: columns x groups
constexpr int SUM_SEQ_THREADS = 256;    // in-order pass: one column a thread
// The in-order pass takes up to this many groups, over at least this many
// columns (enough threads to keep device memory busy).
constexpr int SUM_SEQ_MAX_GROUPS = 64, SUM_SEQ_MIN_COLS = 16384;

// Which pass sums `groups` partial rows of `cols` columns.
inline bool sum_in_order(int groups, int cols) {
  return groups <= SUM_SEQ_MAX_GROUPS && cols >= SUM_SEQ_MIN_COLS;
}

// out[c] = sum_g part[g][c]: each of SUM_Y threads of a column adds every
// SUM_Y-th group, then one adds the SUM_Y sums in order. Columns below
// `half` go to lo[c], the rest to hi[c - half]. No group: zeros.
__global__ void __launch_bounds__(SUM_X * SUM_Y)
sum_groups_kernel(const float* __restrict__ part, float* __restrict__ lo,
                  float* __restrict__ hi, int groups, int cols, int half) {
  __shared__ float sm[SUM_Y][SUM_X];
  const int c = blockIdx.x * SUM_X + threadIdx.x;
  float s = 0.f;
  if (c < cols)
    for (int g = threadIdx.y; g < groups; g += SUM_Y)
      s += part[(size_t)g * cols + c];
  sm[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && c < cols) {
    float t = 0.f;
#pragma unroll
    for (int y = 0; y < SUM_Y; ++y) t += sm[y][threadIdx.x];
    if (c < half)
      lo[c] = t;
    else
      hi[c - half] = t;
  }
}

// The same for fewer groups (split-K partials, many columns): one thread a
// column adds the groups in order 0, 1, ...
__global__ void __launch_bounds__(SUM_SEQ_THREADS)
sum_groups_seq_kernel(const float* __restrict__ part, float* __restrict__ lo,
                      float* __restrict__ hi, int groups, int cols,
                      int half) {
  const int c = blockIdx.x * SUM_SEQ_THREADS + threadIdx.x;
  if (c >= cols) return;
  float t = 0.f;
  for (int g = 0; g < groups; ++g) t += part[(size_t)g * cols + c];
  if (c < half)
    lo[c] = t;
  else
    hi[c - half] = t;
}

// Launches the pass on stream s: part [groups, cols] f32 (not read when
// groups == 0, which writes zeros), lo [half], hi [cols - half].
inline cudaError_t sum_groups(const float* part, float* lo, float* hi,
                              int groups, int cols, int half,
                              cudaStream_t s) {
  if (sum_in_order(groups, cols))
    sum_groups_seq_kernel<<<(cols + SUM_SEQ_THREADS - 1) / SUM_SEQ_THREADS,
                            SUM_SEQ_THREADS, 0, s>>>(part, lo, hi, groups,
                                                     cols, half);
  else
    sum_groups_kernel<<<(cols + SUM_X - 1) / SUM_X, dim3(SUM_X, SUM_Y), 0,
                        s>>>(part, lo, hi, groups, cols, half);
  return cudaGetLastError();
}

}  // namespace
