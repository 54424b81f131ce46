// CSR segment reductions over destination-sorted edges, f32: the message
// passing of the GNN stage.
//
// Replaces the four Pallas kernels of artgraph_tpu/ops/csr_segment.py:
//   mode kSum of csr_chunk_kernel      <- _sum_kernel      (csr_segment_sum /
//                                         _mean, the backward of csr_gather
//                                         on 2-D cotangents)
//   mode kWeighted                     <- _weighted_kernel (csr_weighted_
//                                         segment_sum)
//   mode kSoftmax                      <- _softmax_kernel  (_csr_softmax_raw,
//                                         GATConv)
//   csr_scalar_chunk_kernel and        <- _scalar_kernel   (csr_scalar_
//   csr_scalar_merge_kernel                               segment_sum, the
//                                         backward of csr_gather on 1-D
//                                         cotangents)
//
// The edges of a relation are sorted by segment once, on the host, so each
// segment's edge rows are one contiguous run. None of the TPU mechanics carry
// over (64-segment output blocks, 1024-edge DMA chunks, the one-hot
// [64, 1024] matmul, F padded to 128): those exist to tile VMEM and feed the
// MXU.
//
// What bounds them on an H100: device memory. Each edge row is read once and
// each output row written once, with one add (or one FMA and an exp) per
// element. The row kernels run over a host-built plan (ops/csr_segment.py,
// `_plan`) that cuts every segment into chunks of at most CHUNK = 256
// edges; an empty segment gets one empty chunk. One warp reduces one chunk,
// 8 chunks to a 256-thread block: the lanes run across the features, four
// floats each (one 16-byte load) when F % 4 == 0 and the rows are 16-byte
// aligned, else one float each (F = 18); F > 128 walks the chunk once per
// 128 columns. A
// warp walks its chunk's edges in order and issues the loads of kUnroll
// edges before it adds them, so that many loads are in flight; the adds stay
// in edge order. A segment of one chunk is written straight to the output. A
// longer one (the hubs: the 32 `style` nodes hold ~31K edges each in the
// benchmark graph) writes one partial per chunk to a scratch slot, and a
// second kernel merges each such segment's partials in chunk order, one warp
// per segment. So a hub costs ~120 warps instead of one, and its sum is a
// two-level sum of <= 256 terms per level, not one serial sum of 31K.
//
// The scalar sum (4 bytes an edge) walks the same plan, since one warp per
// segment would put a hub's 31K edges on one warp, and the 32 hubs on 4 of
// the 132 SMs, each lane waiting out ~250 load latencies in a row. Here a
// group of G lanes reduces one chunk: each lane issues kScalarLoads loads
// (edges e0 + lane + G k) before it adds them in k order, then a shuffle
// tree of fixed order sums the group. G is 4, 16 or 32, the fewest lanes
// whose one round of loads covers the CSR's mean chunk (the wrapper picks it
// once per CSR): the reverse relations' ~10-edge segments would leave most
// of a warp idle, and 4 lanes a chunk put 8 chunks in a warp. A hub's
// chunks write partials to the scratch, and one warp per hub adds them the
// same way, lanes strided over the slots. So the order of the adds is a
// function of the shape alone. There are no atomics: every result is
// bit-identical from call to call.
//
// The softmax mode keeps the running max m of the chunk's logits. For each
// batch of kUnroll edges it raises m to the batch's max, rescales the
// numerator and the denominator by exp(m_old - m_new), and adds
// exp(min(l - m, 0)) * row: the exact per-segment shift of _softmax_kernel
// (:395-416) in one pass. The merge takes M = max of the chunks' m and sums
// num_i * exp(m_i - M), the algebra of the edge-sharded merge
// (csr_segment.py:736-745). An empty segment gives numerator 0, m = -inf and
// den = 0.
//
// Offsets edge * F and slot * F are 64-bit.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;     // chunks (or merged segments) per 256 threads
constexpr int kUnroll = 8;    // edges whose loads are issued together

enum Mode { kSum, kWeighted, kSoftmax };

template <int V>
__device__ __forceinline__ void load_row(const float* __restrict__ p,
                                         float (&r)[V]) {
  if constexpr (V == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    r[0] = q.x;
    r[1] = q.y;
    r[2] = q.z;
    r[3] = q.w;
  } else {
    r[0] = __ldg(p);
  }
}

template <int V>
__device__ __forceinline__ void store_row(float* __restrict__ p,
                                          const float (&r)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(r[0], r[1], r[2], r[3]);
  } else {
    p[0] = r[0];
  }
}

__device__ __forceinline__ int warp_item() {
  return blockIdx.x * kWarps + (threadIdx.x >> 5);
}

// The plan, one int32 buffer (see _plan in ops/csr_segment.py):
//   chunk_edge [C+1]  chunk c covers edges chunk_edge[c] .. chunk_edge[c+1]
//   chunk_seg  [C]    its segment
//   chunk_slot [C]    -1: the segment's only chunk, written to the output;
//                     else its partial's row in the scratch
//   merge_seg  [M]    the segments of more than one chunk
//   merge_ptr  [M+1]  their partials' slots merge_ptr[i] .. merge_ptr[i+1]
struct Plan {
  const int* chunk_edge;
  const int* chunk_seg;
  const int* chunk_slot;
  const int* merge_seg;
  const int* merge_ptr;
};

__host__ __device__ inline Plan make_plan(const int* p, int C, int M) {
  return {p, p + C + 1, p + 2 * C + 1, p + 3 * C + 1, p + 3 * C + 1 + M};
}

// Pass 1: one warp per chunk. kSum: out = sum of rows. kWeighted: out = sum
// of w * row, den = sum of w. kSoftmax: out = sum of exp(l - m) * row,
// m = max of l, den = sum of exp(l - m). A multi-chunk segment's chunk writes
// to its scratch slot (part rows, part_m, part_den) instead.
template <int V, Mode kMode>
__global__ void __launch_bounds__(256)
csr_chunk_kernel(const float* __restrict__ data, const float* __restrict__ w,
                 Plan plan, int C, float* __restrict__ part,
                 float* __restrict__ part_m, float* __restrict__ part_den,
                 float* __restrict__ out, float* __restrict__ m_out,
                 float* __restrict__ den_out, int F) {
  const int c = warp_item();
  if (c >= C) return;
  const int lane = threadIdx.x & 31;
  const int e0 = plan.chunk_edge[c], e1 = plan.chunk_edge[c + 1];
  const int slot = plan.chunk_slot[c];
  const int64_t row = slot < 0 ? plan.chunk_seg[c] : slot;
  float* __restrict__ o = slot < 0 ? out : part;
  float* __restrict__ om = slot < 0 ? m_out : part_m;
  float* __restrict__ od = slot < 0 ? den_out : part_den;
  for (int f = lane * V; f < F; f += 32 * V) {
    float acc[V] = {};
    float m = -INFINITY, den = 0.f;
    for (int e = e0; e < e1; e += kUnroll) {
      const int n = min(kUnroll, e1 - e);
      float x[kUnroll][V], s[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (u < n) {
          if constexpr (kMode != kSum) s[u] = __ldg(w + e + u);
          load_row<V>(data + (int64_t)(e + u) * F + f, x[u]);
        }
      }
      if constexpr (kMode == kSoftmax) {
        float mc = -INFINITY;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          if (u < n) mc = fmaxf(mc, s[u]);
        if (mc > m) {
          // raise the running max; from m = -inf (nothing yet) the scale is
          // exp(-inf) = 0, which multiplies zeros
          const float scale = expf(m - mc);
          den *= scale;
#pragma unroll
          for (int j = 0; j < V; ++j) acc[j] *= scale;
          m = mc;
        }
        // all logits -inf so far: shift by 0, as _softmax_kernel does
        const float ms = (m == -INFINITY) ? 0.f : m;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          if (u < n) s[u] = expf(fminf(s[u] - ms, 0.f));
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (u < n) {
          if constexpr (kMode == kSum) {
#pragma unroll
            for (int j = 0; j < V; ++j) acc[j] += x[u][j];
          } else {
            den += s[u];
#pragma unroll
            for (int j = 0; j < V; ++j) acc[j] += s[u] * x[u][j];
          }
        }
      }
    }
    store_row<V>(o + row * F + f, acc);
    if (f == 0) {
      if constexpr (kMode == kSoftmax) om[row] = m;
      if constexpr (kMode != kSum) od[row] = den;
    }
  }
}

// Pass 2: one warp per multi-chunk segment merges its partials in slot
// (= edge) order.
template <int V, Mode kMode>
__global__ void __launch_bounds__(256)
csr_merge_kernel(Plan plan, int M, const float* __restrict__ part,
                 const float* __restrict__ part_m,
                 const float* __restrict__ part_den, float* __restrict__ out,
                 float* __restrict__ m_out, float* __restrict__ den_out,
                 int F) {
  const int i = warp_item();
  if (i >= M) return;
  const int lane = threadIdx.x & 31;
  const int64_t seg = plan.merge_seg[i];
  const int s0 = plan.merge_ptr[i], s1 = plan.merge_ptr[i + 1];
  float mx = -INFINITY;
  if constexpr (kMode == kSoftmax)
    for (int s = s0; s < s1; ++s) mx = fmaxf(mx, part_m[s]);
  for (int f = lane * V; f < F; f += 32 * V) {
    float acc[V] = {};
    float den = 0.f;
    for (int s = s0; s < s1; ++s) {
      float x[V];
      load_row<V>(part + (int64_t)s * F + f, x);
      float scale = 1.f;
      if constexpr (kMode == kSoftmax) {
        const float ms = part_m[s];
        scale = (ms == -INFINITY) ? 0.f : expf(ms - mx);
      }
      if constexpr (kMode != kSum) den += scale * part_den[s];
#pragma unroll
      for (int j = 0; j < V; ++j) acc[j] += scale * x[j];
    }
    store_row<V>(out + seg * F + f, acc);
    if (f == 0) {
      if constexpr (kMode == kSoftmax) m_out[seg] = mx;
      if constexpr (kMode != kSum) den_out[seg] = den;
    }
  }
}

// The scalar sum over the plan. kScalarLoads loads a lane issues before it
// adds them: with G = 32 one round covers a whole chunk (CHUNK = 256).
constexpr int kScalarLoads = 8;

// The sum over a group of G lanes (G a power of two, groups aligned in the
// warp) in a fixed tree; lane 0 of the group holds it. Every lane of the
// warp takes part.
template <int G>
__device__ __forceinline__ float group_sum(float acc) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  return acc;
}

// The sum of x[i0 .. i1) in the order of the whole path: lane l of a group
// of G adds x[i0 + l + G k] for k = 0, 1, ... (kScalarLoads loads in flight
// before each round's adds), then group_sum<G>.
template <int G>
__device__ __forceinline__ float strided_sum(const float* __restrict__ x,
                                             int i0, int i1, int lane) {
  float acc = 0.f;
  for (int base = i0; base < i1; base += kScalarLoads * G) {
    float v[kScalarLoads];
#pragma unroll
    for (int k = 0; k < kScalarLoads; ++k) {
      const int i = base + lane + G * k;
      v[k] = i < i1 ? __ldg(x + i) : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kScalarLoads; ++k) acc += v[k];
  }
  return group_sum<G>(acc);
}

// Pass 1: a group of G lanes per chunk, 256 / G chunks to a block. A
// segment of one chunk (an empty one included: its sum is 0) is written to
// out; a hub's chunk to its scratch slot.
template <int G>
__global__ void __launch_bounds__(256)
csr_scalar_chunk_kernel(const float* __restrict__ w, Plan plan, int C,
                        float* __restrict__ part, float* __restrict__ out) {
  const int c = (int)(((int64_t)blockIdx.x * 256 + threadIdx.x) / G);
  const int lane = threadIdx.x % G;
  // a group past C sums nothing but stays for its warp's shuffles
  int e0 = 0, e1 = 0, slot = -1, seg = 0;
  if (c < C) {
    e0 = plan.chunk_edge[c];
    e1 = plan.chunk_edge[c + 1];
    slot = plan.chunk_slot[c];
    seg = plan.chunk_seg[c];
  }
  const float acc = strided_sum<G>(w, e0, e1, lane);
  if (c < C && lane == 0) {
    if (slot < 0)
      out[seg] = acc;
    else
      part[slot] = acc;
  }
}

// Pass 2: one warp per hub adds its partials, slots in edge order.
__global__ void __launch_bounds__(256)
csr_scalar_merge_kernel(Plan plan, int M, const float* __restrict__ part,
                        float* __restrict__ out) {
  const int i = warp_item();
  if (i >= M) return;  // uniform across the warp: the shuffles stay full
  const int lane = threadIdx.x & 31;
  const float acc = strided_sum<32>(part, plan.merge_ptr[i],
                                    plan.merge_ptr[i + 1], lane);
  if (lane == 0) out[plan.merge_seg[i]] = acc;
}

inline int blocks_for(int n) { return (n + kWarps - 1) / kWarps; }

// The scalar sum's launch sequence over a launcher (StreamRun below on a
// CUDA stream; the host emulation runs the same one): pass 1 over the C
// chunks with groups of `lanes` lanes, pass 2 over the M hubs.
template <class Run>
int scalar_sequence(Run& run, const float* w, const Plan& plan, int C, int M,
                    float* part, float* out, int lanes) {
  int err = 0;
  if (C > 0)
    err = run.scalar_chunks(lanes, (int)(((int64_t)C * lanes + 255) / 256), w,
                            plan, C, part, out);
  if (!err && M > 0) err = run.scalar_merge(blocks_for(M), plan, M, part, out);
  return err;
}

// Host side: launches.

struct StreamRun {
  cudaStream_t s;
  template <int G>
  int chunks(int blocks, const float* w, const Plan& plan, int C,
             float* part, float* out) {
    csr_scalar_chunk_kernel<G><<<blocks, 256, 0, s>>>(w, plan, C, part, out);
    return (int)cudaGetLastError();
  }
  int scalar_chunks(int lanes, int blocks, const float* w, const Plan& plan,
                    int C, float* part, float* out) {
    switch (lanes) {
      case 4: return chunks<4>(blocks, w, plan, C, part, out);
      case 16: return chunks<16>(blocks, w, plan, C, part, out);
      case 32: return chunks<32>(blocks, w, plan, C, part, out);
    }
    return (int)cudaErrorInvalidValue;
  }
  int scalar_merge(int blocks, const Plan& plan, int M, const float* part,
                   float* out) {
    csr_scalar_merge_kernel<<<blocks, 256, 0, s>>>(plan, M, part, out);
    return (int)cudaGetLastError();
  }
};

template <int V, Mode kMode>
int launch_rows(const float* data, const float* w, const int* plan_buf,
                int C, int M, int slots, float* scratch, float* out,
                float* m, float* den, int F, cudaStream_t st) {
  const Plan plan = make_plan(plan_buf, C, M);
  float* part = scratch;
  float* part_m = scratch + (int64_t)slots * F;
  float* part_den = part_m + slots;
  if (C > 0)
    csr_chunk_kernel<V, kMode><<<blocks_for(C), 256, 0, st>>>(
        data, w, plan, C, part, part_m, part_den, out, m, den, F);
  if (M > 0)
    csr_merge_kernel<V, kMode><<<blocks_for(M), 256, 0, st>>>(
        plan, M, part, part_m, part_den, out, m, den, F);
  return (int)cudaGetLastError();
}

template <Mode kMode>
int rows_entry(const void* data, const void* w, const void* plan, int C,
               int M, int slots, void* scratch, void* out, void* m, void* den,
               int F, int vec, void* stream) {
  if (C < 0 || M < 0 || slots < 0 || F <= 0 || (vec && F % 4))
    return (int)cudaErrorInvalidValue;
  auto run = vec ? launch_rows<4, kMode> : launch_rows<1, kMode>;
  return run((const float*)data, (const float*)w, (const int*)plan, C, M,
             slots, (float*)scratch, (float*)out, (float*)m, (float*)den, F,
             (cudaStream_t)stream);
}

}  // namespace

extern "C" {

// scratch: slots * (F + 2) floats (partial rows, then m, then den)
int ag_csr_sum_f32(const void* data, const void* plan, int C, int M,
                   int slots, void* scratch, void* out, int F, int vec,
                   void* stream) {
  return rows_entry<kSum>(data, nullptr, plan, C, M, slots, scratch, out,
                          nullptr, nullptr, F, vec, stream);
}

int ag_csr_weighted_sum_f32(const void* data, const void* w, const void* plan,
                            int C, int M, int slots, void* scratch, void* out,
                            void* den, int F, int vec, void* stream) {
  return rows_entry<kWeighted>(data, w, plan, C, M, slots, scratch, out,
                               nullptr, den, F, vec, stream);
}

int ag_csr_softmax_f32(const void* data, const void* logits, const void* plan,
                       int C, int M, int slots, void* scratch, void* num,
                       void* m, void* den, int F, int vec, void* stream) {
  return rows_entry<kSoftmax>(data, logits, plan, C, M, slots, scratch, num,
                              m, den, F, vec, stream);
}

// out [S] = the per-segment sums of w [E] over the plan (C chunks, M hubs,
// `slots` partials), pass 1 in groups of `lanes` (4, 16 or 32) lanes;
// scratch: `slots` floats.
int ag_csr_scalar_sum_f32(const void* w, const void* plan, int C, int M,
                          int slots, void* scratch, void* out, int lanes,
                          void* stream) {
  if (C < 0 || M < 0 || slots < 0 || (M > 0) != (slots > 0))
    return (int)cudaErrorInvalidValue;
  StreamRun run{(cudaStream_t)stream};
  return scalar_sequence(run, (const float*)w,
                         make_plan((const int*)plan, C, M), C, M,
                         (float*)scratch, (float*)out, lanes);
}

}  // extern "C"
