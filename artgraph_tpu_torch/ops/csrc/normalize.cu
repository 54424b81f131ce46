// uint8 NHWC image batch -> f32 NHWC, out = x * alpha[c] + beta[c] per RGB
// channel, with alpha = 1/(255 std) and beta = -mean/std.
//
// Replaces the Pallas kernel artgraph_tpu/ops/preprocess.py:
// normalize_images_pallas (_normalize_kernel). Like it, the result is
// bit-identical to the plain x.float() * alpha + beta: the multiply and the
// add are rounded separately (__fmul_rn, __fadd_rn), so nvcc cannot contract
// them into one FMA.
//
// What bounds it on an H100: device memory. It reads 1 byte and writes 4 per
// element, with no arithmetic to speak of. Each thread moves 4 consecutive
// bytes in one 4-byte load and writes one 16-byte float4, so a warp issues
// full 128-byte and 512-byte transactions. The channel of an element is its
// flat index mod 3 (NHWC with C = 3), so no per-pixel index math beyond that.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Coeffs {
  float a0, a1, a2, b0, b1, b2;
};

__device__ __forceinline__ float norm1(uint8_t x, int c, const Coeffs& k) {
  const float a = c == 0 ? k.a0 : (c == 1 ? k.a1 : k.a2);
  const float b = c == 0 ? k.b0 : (c == 1 ? k.b1 : k.b2);
  return __fadd_rn(__fmul_rn((float)x, a), b);
}

__global__ void normalize_u8_kernel(const uint8_t* __restrict__ in,
                                    float* __restrict__ out, int n,
                                    Coeffs k) {
  const int n4 = n / 4;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += gridDim.x * blockDim.x) {
    const uchar4 v = reinterpret_cast<const uchar4*>(in)[i];
    const int c = (4 * i) % 3;
    float4 o;
    o.x = norm1(v.x, c, k);
    o.y = norm1(v.y, (c + 1) % 3, k);
    o.z = norm1(v.z, (c + 2) % 3, k);
    o.w = norm1(v.w, c, k);  // (c + 3) % 3
    reinterpret_cast<float4*>(out)[i] = o;
  }
  // tail of n % 4 elements
  if (blockIdx.x == 0 && (int)threadIdx.x < n - 4 * n4) {
    const int j = 4 * n4 + threadIdx.x;
    out[j] = norm1(in[j], j % 3, k);
  }
}

}  // namespace

extern "C" int ag_normalize_u8(const void* in, void* out, int n, float a0,
                               float a1, float a2, float b0, float b1,
                               float b2, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  int blocks = (n / 4 + threads - 1) / threads;
  if (blocks < 1) blocks = 1;
  if (blocks > 65535) blocks = 65535;
  const Coeffs k{a0, a1, a2, b0, b1, b2};
  normalize_u8_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)in, (float*)out, n, k);
  return (int)cudaGetLastError();
}
