// int8_quant: blockwise max-abs int8 quantization on Hopper (sm_90a), one
// warp per 256-element block.
//
// Replaces: src/repro/kernels/int8_quant.py : int8_quantize / _quant_kernel,
// the Pallas TPU kernel (a (rows, 256) tile a grid step, the reduction,
// scale and rounding in VMEM).  The function is the same: for each block of
// 256 elements of the flattened input, the tail read as 0,
//   scale = max(max|x| / 127, 1e-12),   q = clip(round(x / scale), -127, 127)
// with IEEE division (no fast math: the build's flags have none) and round
// half to even (rintf).  Two cases the reference defines on the CPU are kept
// on purpose, where fmaxf/fminf would silently drop them:
//   - a block holding a NaN gets scale NaN, one holding an inf scale inf
//     (the max is taken over the bit patterns of |x|, whose unsigned order
//     is the float order with NaN above inf, and the 1e-12 floor is a
//     comparison that a NaN fails);
//   - q is 0 wherever x / scale is NaN (inf / inf, anything / NaN).
//
// What bounds it on this card: bytes.  It reads 4 bytes and writes
// 1 + 4/256 bytes an element, and does a handful of operations on each:
// for recurrentgemma-2b's embedding gradient (655 360 000 elements) that is
// 3.29 GB, 0.98 ms at 3.35 TB/s.
//
// What the design does about it: a warp owns a block, so the max is one
// warp shuffle reduction and no shared memory or barrier is needed.  Each
// lane loads two float4s (elements 4l..4l+3 and 128+4l..128+4l+3), so a
// warp's loads are two coalesced 512-byte lines, and stores its eight
// codes as two 4-byte words, two coalesced 128-byte lines; lane 0 writes the
// scale.  256 threads (8 blocks of 256 elements) a CTA keep enough loads in
// flight to cover the memory's latency.  Only the last, partial block reads
// element by element, masked at n.  Counts and offsets are 64-bit: a whole
// gradient tree can hold more than 2^31 elements.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;           // elements a quantization block
constexpr int kWarpsPerCta = 8;
constexpr int kThreads = 32 * kWarpsPerCta;

__device__ __forceinline__ int8_t code(float x, float scale) {
  const float r = x / scale;
  if (isnan(r)) return 0;
  const float c = fminf(fmaxf(rintf(r), -127.0f), 127.0f);
  return (int8_t)(int)c;
}

__device__ __forceinline__ uint32_t pack(float4 v, float scale) {
  return (uint32_t)(uint8_t)code(v.x, scale)
       | ((uint32_t)(uint8_t)code(v.y, scale) << 8)
       | ((uint32_t)(uint8_t)code(v.z, scale) << 16)
       | ((uint32_t)(uint8_t)code(v.w, scale) << 24);
}

__device__ __forceinline__ uint32_t abs_bits(float v) {
  return __float_as_uint(fabsf(v));
}

__global__ void __launch_bounds__(kThreads)
int8_quant_kernel(const float* __restrict__ x, int8_t* __restrict__ q,
                  float* __restrict__ scales, long long n, long long nb) {
  const long long b =
      (long long)blockIdx.x * kWarpsPerCta + (threadIdx.x >> 5);
  if (b >= nb) return;  // whole warps leave together: no barrier below
  const int lane = threadIdx.x & 31;
  const long long base = b * kBlock;
  float4 lo, hi;
  if (base + kBlock <= n) {
    const float4* xb = reinterpret_cast<const float4*>(x + base);
    lo = __ldg(xb + lane);
    hi = __ldg(xb + 32 + lane);
  } else {  // the last block: the tail past n reads as 0
    float v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int off = i < 4 ? 4 * lane + i : 128 + 4 * lane + (i - 4);
      const long long idx = base + off;
      v[i] = idx < n ? x[idx] : 0.0f;
    }
    lo = make_float4(v[0], v[1], v[2], v[3]);
    hi = make_float4(v[4], v[5], v[6], v[7]);
  }
  uint32_t m = max(max(max(abs_bits(lo.x), abs_bits(lo.y)),
                       max(abs_bits(lo.z), abs_bits(lo.w))),
                   max(max(abs_bits(hi.x), abs_bits(hi.y)),
                       max(abs_bits(hi.z), abs_bits(hi.w))));
  m = __reduce_max_sync(0xffffffffu, m);
  float scale = __uint_as_float(m) / 127.0f;
  if (scale < 1e-12f) scale = 1e-12f;  // NaN stays NaN
  uint32_t* qb = reinterpret_cast<uint32_t*>(q + base);
  qb[lane] = pack(lo, scale);
  qb[32 + lane] = pack(hi, scale);
  if (lane == 0) scales[b] = scale;
}

}  // namespace

// x: n float32, contiguous, 16-byte aligned; q: (nb, 256) int8; scales: (nb,)
// float32, with nb = ceil(n / 256).  Launches on `stream` and returns the
// cudaError_t of the launch.
extern "C" int int8_quant_launch(const float* x, int8_t* q, float* scales,
                                 long long n, void* stream) {
  if (n <= 0 || ((uintptr_t)x & 15) != 0 || ((uintptr_t)q & 3) != 0)
    return (int)cudaErrorInvalidValue;
  const long long nb = (n + kBlock - 1) / kBlock;
  const long long ctas = (nb + kWarpsPerCta - 1) / kWarpsPerCta;
  if (ctas > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  int8_quant_kernel<<<(unsigned)ctas, kThreads, 0, (cudaStream_t)stream>>>(
      x, q, scales, n, nb);
  return (int)cudaGetLastError();
}
