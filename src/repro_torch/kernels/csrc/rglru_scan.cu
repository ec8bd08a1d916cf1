// rglru_scan: the RG-LRU linear recurrence h_t = exp(log_a_t) * h_{t-1} + b_t
// from h_0 = 0, on Hopper (sm_90a), one thread per (batch, feature).
//
// Replaces: src/repro/kernels/rglru_scan.py : rglru_scan / _rglru_kernel,
// the Pallas TPU kernel (feature tiles in VMEM, time the innermost
// sequential grid axis, the carry in VMEM scratch).
//
// What bounds it on this card: bytes.  It reads log_a and b and writes h,
// 12 bytes a (b, t, r) element, and does 3 operations on each: at the
// serve shape (4, 3000, 2560) that is 369 MB, 0.11 ms at 3.35 TB/s.  But
// the recurrence is a chain of S dependent multiply-adds per feature, and
// only B * R threads exist to walk it (10 240 at the serve shape, about
// 2.4 warps an SM), so the kernel is bound by how many loads it keeps in
// flight, not by the memory's rate.
//
// What the design does about it: grid = (ceil(R / 256), B), one thread a
// feature, so a warp's loads of one time step are one coalesced 128-byte
// line of each input and its stores one line of h.  No load depends on h,
// so the thread walks time in chunks of kAhead steps and issues the next
// chunk's 2 * kAhead loads (and their expf) before it runs the current
// chunk's chain: the chain then waits on arithmetic, and each warp keeps
// 2 * kAhead loads in flight.  A chunked two-pass scan across blocks (to
// put more threads on the time axis) is later work.  expf, not __expf:
// the reference's exp is the accurate one.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // features per block
constexpr int kAhead = 16;     // time steps loaded ahead of the chain

__device__ __forceinline__ void load_chunk(const float* __restrict__ la,
                                           const float* __restrict__ bb,
                                           int t0, int S, int R,
                                           float (&a)[kAhead],
                                           float (&b)[kAhead]) {
#pragma unroll
  for (int i = 0; i < kAhead; ++i) {
    const int t = t0 + i;
    // past the end: a = exp(0) = 1, b = 0 leaves h as it is
    const bool in = t < S;
    a[i] = in ? expf(__ldg(la + (size_t)t * R)) : 1.0f;
    b[i] = in ? __ldg(bb + (size_t)t * R) : 0.0f;
  }
}

__global__ void __launch_bounds__(kThreads)
rglru_kernel(const float* __restrict__ log_a, const float* __restrict__ b,
             float* __restrict__ h_out, int S, int R) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= R) return;  // no barrier below: each thread owns its feature
  const size_t base = (size_t)blockIdx.y * S * R + r;
  const float* la = log_a + base;
  const float* bb = b + base;
  float* out = h_out + base;

  float a_cur[kAhead], b_cur[kAhead], a_next[kAhead], b_next[kAhead];
  load_chunk(la, bb, 0, S, R, a_cur, b_cur);
  float h = 0.0f;
  for (int t0 = 0; t0 < S; t0 += kAhead) {
    const bool more = t0 + kAhead < S;
    if (more) load_chunk(la, bb, t0 + kAhead, S, R, a_next, b_next);
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      h = h * a_cur[i] + b_cur[i];
      if (t0 + i < S) out[(size_t)(t0 + i) * R] = h;
    }
    if (more) {
#pragma unroll
      for (int i = 0; i < kAhead; ++i) {
        a_cur[i] = a_next[i];
        b_cur[i] = b_next[i];
      }
    }
  }
}

}  // namespace

// log_a, b, h: (B, S, R) float32, contiguous, on one device.  Launches on
// `stream` and returns the cudaError_t of the launch.
extern "C" int rglru_scan_launch(const float* log_a, const float* b,
                                 float* h, int B, int S, int R,
                                 void* stream) {
  if (B <= 0 || S <= 0 || R <= 0) return (int)cudaErrorInvalidValue;
  if (B > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((R + kThreads - 1) / kThreads, B);
  rglru_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(log_a, b, h, S, R);
  return (int)cudaGetLastError();
}
