// rglru_scan: the RG-LRU linear recurrence h_t = exp(log_a_t) * h_{t-1} + b_t
// from h_0 = 0, on Hopper (sm_90a), as a single-pass chunked scan across
// time, the carry passed from tile to tile; and its gradient
// (rglru_bwd_kernel, the same scan walking time backwards).
//
// Replaces: src/repro/kernels/rglru_scan.py : rglru_scan / _rglru_kernel,
// the Pallas TPU kernel (feature tiles in VMEM, time the innermost
// sequential grid axis, the carry in VMEM scratch).
//
// What bounds it on this card: bytes.  It reads log_a and b and writes h,
// 12 bytes a (b, t, r) element, and does 3 operations on each: at the
// serve shape (4, 3000, 2560) that is 369 MB, 0.11 ms at 3.35 TB/s.  To
// reach that rate the card needs megabytes of loads in flight, but the
// recurrence is a chain along time: one thread walking the whole time axis
// of a feature leaves only B * R threads (10 240 at the serve shape, 2.4
// warps an SM) to keep loads in flight.
//
// What the design does about it: threads go on the time axis too.  One
// block of 256 threads per tile of kT = 64 time steps x kF = 64 features
// (two 32-feature strips) of one batch row; at the serve shape that is
// 7520 blocks, about 6 resident an SM, each with its whole 32 KB tile of
// log_a and b in flight at once.
// - The tile is staged into shared memory with cp.async, each warp's
//   copies 128-byte lines along the features (16 bytes a thread; 4-byte
//   copies when R or a pointer is not 16-byte aligned), zero-filled past S
//   and R (log_a = 0, b = 0 leaves h as it is).
// - Pass 1: each thread scans one sub-chunk of kL = 16 steps of one
//   feature from 0, storing a = expf(log_a) back in place, and leaves the
//   sub-chunk's pair (A = prod a, H = its end state from 0); the first
//   kSub = 4 threads of a feature fold them into the tile's pair.
// - The carry: each of the first kF threads waits for the state after the
//   tile before (one 64-bit word a feature, the float and a published
//   flag together, read with ld.acquire), and publishes the state after
//   its own tile, A * carry + H, with st.release.  The hop from tile to
//   tile is one L2 round trip, and pass 1 of the tiles in flight overlaps
//   it.  A decoupled look-back, which composes the pairs of tiles whose
//   states are not yet published, would shorten that chain but round as
//   the timing falls, so two runs of the same inputs could differ; a
//   served prefill must repeat bit for bit (chip_smoke.py phase 5 runs it
//   twice), so the carry is always the predecessor's state, in one fixed
//   order.  Tiles take their place in time from an atomic ticket,
//   time-major, so a block only ever waits on a block that holds an
//   earlier ticket and so is running or done: no block waits on one that
//   was never scheduled.
// - Pass 2: each thread runs the recurrence over its 16 steps again from
//   shared memory, starting from its carry-in (the tile's carry through
//   the sub-chunks before it), and writes h once, 128-byte lines a warp.
// Global traffic: log_a and b read once, h written once, plus 8 bytes a
// (tile, feature) of state, zeroed, written and read once (2% at the
// serve shape).  One wrapper call runs one memset (the states and the
// ticket) and one kernel.
// expf, not __expf: the reference's exp is the accurate one.  The carry is
// reassociated (a product of a's times a state): within 1e-5 of the
// sequential recurrence.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kF = 64;              // features a tile
constexpr int kT = 64;              // time steps a tile
constexpr int kSub = 4;             // sub-chunks a tile
constexpr int kL = kT / kSub;       // time steps a sub-chunk
constexpr int kThreads = kF * kSub;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp16(float* dst, const float* src,
                                     bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp4(float* dst, const float* src,
                                    bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ unsigned long long load_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.b64 %0, [%1];\n"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}
__device__ __forceinline__ void store_release(unsigned long long* p,
                                              unsigned long long v) {
  asm volatile("st.release.gpu.global.b64 [%0], %1;\n" ::"l"(p), "l"(v)
               : "memory");
}

struct Scratch {
  int* ticket;               // (1,)
  // (chains * tiles, kF): the state after a tile, as one word a feature,
  // its float's bits below and 1 above once published (0 before)
  unsigned long long* state;
};

template <bool kAligned>
__global__ void __launch_bounds__(kThreads)
rglru_kernel(const float* __restrict__ log_a, const float* __restrict__ b,
             float* __restrict__ h_out, Scratch sc, int B, int S, int R) {
  __shared__ __align__(16) float a_s[kT][kF];
  __shared__ __align__(16) float b_s[kT][kF];
  __shared__ float sub_a[kSub][kF], sub_h[kSub][kF];
  __shared__ float carry_s[kF];
  __shared__ int ticket_s;

  const int tid = threadIdx.x;
  if (tid == 0) ticket_s = atomicAdd(sc.ticket, 1);
  __syncthreads();
  const int strips = (R + kF - 1) / kF;
  const int tiles = (S + kT - 1) / kT;
  const int chains = B * strips;
  const int ticket = ticket_s;
  const int tile = ticket / chains, chain = ticket - tile * chains;
  const int bi = chain / strips, f0 = (chain - bi * strips) * kF;
  const int t0 = tile * kT;
  const size_t base = (size_t)bi * S * R;

  // ---- stage the tile
  if (kAligned) {
    for (int ch = tid; ch < kT * kF / 4; ch += kThreads) {
      const int row = ch / (kF / 4), col = 4 * (ch % (kF / 4));
      const int t = t0 + row, f = f0 + col;
      const bool ok = t < S && f < R;  // R % 4 == 0: f < R covers f + 3
      const size_t off = ok ? base + (size_t)t * R + f : 0;
      cp16(&a_s[row][col], log_a + off, ok);
      cp16(&b_s[row][col], b + off, ok);
    }
  } else {
    for (int e = tid; e < kT * kF; e += kThreads) {
      const int row = e / kF, col = e % kF;
      const int t = t0 + row, f = f0 + col;
      const bool ok = t < S && f < R;
      const size_t off = ok ? base + (size_t)t * R + f : 0;
      cp4(&a_s[row][col], log_a + off, ok);
      cp4(&b_s[row][col], b + off, ok);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();

  // ---- pass 1: thread (sub-chunk s, feature f) from 0
  const int f = tid % kF, s = tid / kF;
  {
    float A = 1.0f, H = 0.0f;
#pragma unroll
    for (int i = 0; i < kL; ++i) {
      const int row = s * kL + i;
      const float a = expf(a_s[row][f]);
      a_s[row][f] = a;
      H = fmaf(H, a, b_s[row][f]);
      A *= a;
    }
    sub_a[s][f] = A;
    sub_h[s][f] = H;
  }
  __syncthreads();

  // ---- the tile's pair, its carry-in from the tile before (spinning on
  // that tile's word), its own state published for the tile after
  if (tid < kF) {
    float At = 1.0f, Ht = 0.0f;
#pragma unroll
    for (int q = 0; q < kSub; ++q) {
      Ht = fmaf(sub_a[q][f], Ht, sub_h[q][f]);
      At *= sub_a[q][f];
    }
    const size_t idx = (size_t)chain * tiles + tile;
    float carry = 0.0f;
    if (tile > 0) {
      const unsigned long long* prev = sc.state + (idx - 1) * kF + f;
      unsigned long long word;
      while (((word = load_acquire(prev)) >> 32) == 0) __nanosleep(20);
      carry = __uint_as_float((unsigned)word);
    }
    carry_s[f] = carry;
    store_release(sc.state + idx * kF + f,
                  (1ull << 32) | __float_as_uint(fmaf(At, carry, Ht)));
  }
  __syncthreads();

  // ---- pass 2: the recurrence again from the carry-in, h written once
  float hv = carry_s[f];
  for (int q = 0; q < s; ++q) hv = fmaf(sub_a[q][f], hv, sub_h[q][f]);
  const bool f_ok = f0 + f < R;
  float* out = h_out + base + f0 + f;
#pragma unroll
  for (int i = 0; i < kL; ++i) {
    const int row = s * kL + i;
    hv = fmaf(hv, a_s[row][f], b_s[row][f]);
    const int t = t0 + row;
    if (f_ok && t < S) out[(size_t)t * R] = hv;
  }
}

// ---------------------------------------------------------- backward
// The gradient of the scan, written for this port (the JAX package trains
// through associative_scan and has no backward kernel).  With h the
// forward's output and dh its gradient, the reverse recurrence
//   g_t = dh_t + a_{t+1} g_{t+1}   (g past the end is 0)
// gives d_b_t = g_t and d_log_a_t = g_t a_t h_{t-1} (h_{-1} = 0).  It is
// the forward's chunked scan walking time backwards: one block per tile of
// kT steps x kF features, tiles taking their place from the same ticket
// but from the last tile of each chain back to the first; the carry a tile
// passes to the one before it is c = a_{t0} g_{t0} at its first step t0.
// log_a and dh are staged into shared memory with cp.async; h_{t-1} is
// read from global memory in pass 2 (one load a step, 128-byte lines a
// warp).  Bound: bytes, 20 an element (log_a, h and dh read once, d_log_a
// and d_b written once), 154 MB at (1, 3000, 2560).
template <bool kAligned>
__global__ void __launch_bounds__(kThreads)
rglru_bwd_kernel(const float* __restrict__ log_a, const float* __restrict__ h,
                 const float* __restrict__ dh, float* __restrict__ d_log_a,
                 float* __restrict__ d_b, Scratch sc, int B, int S, int R) {
  __shared__ __align__(16) float a_s[kT][kF];
  __shared__ __align__(16) float g_s[kT][kF];
  __shared__ float sub_a[kSub][kF], sub_c[kSub][kF];
  __shared__ float carry_s[kF];
  __shared__ int ticket_s;

  const int tid = threadIdx.x;
  if (tid == 0) ticket_s = atomicAdd(sc.ticket, 1);
  __syncthreads();
  const int strips = (R + kF - 1) / kF;
  const int tiles = (S + kT - 1) / kT;
  const int chains = B * strips;
  const int ticket = ticket_s;
  const int rev = ticket / chains, chain = ticket - rev * chains;
  const int tile = tiles - 1 - rev;
  const int bi = chain / strips, f0 = (chain - bi * strips) * kF;
  const int t0 = tile * kT;
  const size_t base = (size_t)bi * S * R;

  // ---- stage log_a and dh (zeros past S and R: a = 1, dh = 0 are inert)
  if (kAligned) {
    for (int ch = tid; ch < kT * kF / 4; ch += kThreads) {
      const int row = ch / (kF / 4), col = 4 * (ch % (kF / 4));
      const int t = t0 + row, f = f0 + col;
      const bool ok = t < S && f < R;
      const size_t off = ok ? base + (size_t)t * R + f : 0;
      cp16(&a_s[row][col], log_a + off, ok);
      cp16(&g_s[row][col], dh + off, ok);
    }
  } else {
    for (int e = tid; e < kT * kF; e += kThreads) {
      const int row = e / kF, col = e % kF;
      const int t = t0 + row, f = f0 + col;
      const bool ok = t < S && f < R;
      const size_t off = ok ? base + (size_t)t * R + f : 0;
      cp4(&a_s[row][col], log_a + off, ok);
      cp4(&g_s[row][col], dh + off, ok);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();

  // ---- pass 1: thread (sub-chunk s, feature f), from its last step down,
  // from a carry of 0: the sub-chunk's map c_out = A c_in + C
  const int f = tid % kF, s = tid / kF;
  {
    float A = 1.0f, c = 0.0f;
#pragma unroll
    for (int i = kL - 1; i >= 0; --i) {
      const int row = s * kL + i;
      const float a = expf(a_s[row][f]);
      a_s[row][f] = a;
      c = a * (g_s[row][f] + c);
      A *= a;
    }
    sub_a[s][f] = A;
    sub_c[s][f] = c;
  }
  __syncthreads();

  // ---- the tile's map, its carry-in from the tile after it (spinning on
  // that tile's word), its own carry published for the tile before
  if (tid < kF) {
    float At = 1.0f, Ct = 0.0f;
#pragma unroll
    for (int q = kSub - 1; q >= 0; --q) {
      Ct = fmaf(sub_a[q][f], Ct, sub_c[q][f]);
      At *= sub_a[q][f];
    }
    const size_t idx = (size_t)chain * tiles + tile;
    float carry = 0.0f;
    if (tile < tiles - 1) {
      const unsigned long long* next = sc.state + (idx + 1) * kF + f;
      unsigned long long word;
      while (((word = load_acquire(next)) >> 32) == 0) __nanosleep(20);
      carry = __uint_as_float((unsigned)word);
    }
    carry_s[f] = carry;
    store_release(sc.state + idx * kF + f,
                  (1ull << 32) | __float_as_uint(fmaf(At, carry, Ct)));
  }
  __syncthreads();

  // ---- pass 2: the reverse recurrence again from the carry-in, both
  // gradients written once
  float c = carry_s[f];
  for (int q = kSub - 1; q > s; --q) c = fmaf(sub_a[q][f], c, sub_c[q][f]);
  const bool f_ok = f0 + f < R;
  const size_t col = base + f0 + f;
#pragma unroll
  for (int i = kL - 1; i >= 0; --i) {
    const int row = s * kL + i;
    const int t = t0 + row;
    const float a = a_s[row][f];
    const float g = g_s[row][f] + c;
    c = a * g;
    if (f_ok && t < S) {
      const float hp = t > 0 ? __ldg(h + col + (size_t)(t - 1) * R) : 0.0f;
      d_b[col + (size_t)t * R] = g;
      d_log_a[col + (size_t)t * R] = g * a * hp;
    }
  }
}

// byte offsets of the scratch's parts: ticket, states, end
void scratch_layout(int B, int S, int R, size_t off[3]) {
  const size_t n = (size_t)B * ((R + kF - 1) / kF) * ((S + kT - 1) / kT);
  off[0] = 0;
  off[1] = 16;
  off[2] = off[1] + n * kF * sizeof(unsigned long long);
}

}  // namespace

// Bytes of scratch rglru_scan_launch needs at (B, S, R).
extern "C" long long rglru_scan_scratch_bytes(int B, int S, int R) {
  size_t off[3];
  scratch_layout(B, S, R, off);
  return (long long)off[2];
}

// log_a, b, h: (B, S, R) float32, contiguous, on one device; scratch:
// rglru_scan_scratch_bytes(B, S, R) bytes, 16-byte aligned.  Zeroes the
// scratch (the ticket and every tile's state word) and launches the
// kernel, both on `stream`; returns the cudaError_t of the two.
extern "C" int rglru_scan_launch(const float* log_a, const float* b,
                                 float* h, void* scratch, int B, int S,
                                 int R, void* stream) {
  if (B <= 0 || S <= 0 || R <= 0 || scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)B * ((R + kF - 1) / kF) *
                           ((S + kT - 1) / kT);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  size_t off[3];
  scratch_layout(B, S, R, off);
  char* base = static_cast<char*>(scratch);
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(base, 0, off[2], st);
  if (err != cudaSuccess) return (int)err;
  Scratch sc{reinterpret_cast<int*>(base + off[0]),
             reinterpret_cast<unsigned long long*>(base + off[1])};
  const bool aligned = R % 4 == 0 &&
                       reinterpret_cast<uintptr_t>(log_a) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(b) % 16 == 0;
  if (aligned)
    rglru_kernel<true><<<(unsigned)blocks, kThreads, 0, st>>>(log_a, b, h, sc,
                                                              B, S, R);
  else
    rglru_kernel<false><<<(unsigned)blocks, kThreads, 0, st>>>(log_a, b, h,
                                                               sc, B, S, R);
  return (int)cudaGetLastError();
}

// log_a, h, dh, d_log_a, d_b: (B, S, R) float32, contiguous, on one
// device (h the forward's output, dh its gradient); scratch:
// rglru_scan_scratch_bytes(B, S, R) bytes, 16-byte aligned.  Zeroes the
// scratch and launches the backward kernel, both on `stream`; returns the
// cudaError_t of the two.
extern "C" int rglru_scan_bwd_launch(const float* log_a, const float* h,
                                     const float* dh, float* d_log_a,
                                     float* d_b, void* scratch, int B, int S,
                                     int R, void* stream) {
  if (B <= 0 || S <= 0 || R <= 0 || scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)B * ((R + kF - 1) / kF) *
                           ((S + kT - 1) / kT);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  size_t off[3];
  scratch_layout(B, S, R, off);
  char* base = static_cast<char*>(scratch);
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(base, 0, off[2], st);
  if (err != cudaSuccess) return (int)err;
  Scratch sc{reinterpret_cast<int*>(base + off[0]),
             reinterpret_cast<unsigned long long*>(base + off[1])};
  const bool aligned = R % 4 == 0 &&
                       reinterpret_cast<uintptr_t>(log_a) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(dh) % 16 == 0;
  if (aligned)
    rglru_bwd_kernel<true><<<(unsigned)blocks, kThreads, 0, st>>>(
        log_a, h, dh, d_log_a, d_b, sc, B, S, R);
  else
    rglru_bwd_kernel<false><<<(unsigned)blocks, kThreads, 0, st>>>(
        log_a, h, dh, d_log_a, d_b, sc, B, S, R);
  return (int)cudaGetLastError();
}
