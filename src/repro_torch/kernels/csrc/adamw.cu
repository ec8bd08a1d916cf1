// adamw: AdamW's update of one leaf of the training state on Hopper
// (sm_90a), in place, and the gradient norm the update clips by.
//
// Replaces no TPU kernel.  The reference's update (src/repro/optim/adamw.py
// adamw_update) is plain jnp, which XLA fuses into one pass over each leaf.
// The port's plain update (src/repro_torch/optim/adamw.py _update) runs it
// as some twenty elementwise kernels over each slice of each leaf, with
// float32 temporaries between them, and takes the norm from a float32
// square of every gradient leaf: 180-230 bytes of traffic an element.
//
// What bounds it on this card: bytes.  An element's update reads p, g, m
// and v and writes p, m and v: 28 bytes with float32 p and g, 26 with a
// bf16 gradient; the norm reads g once more (4 or 2 bytes).  That is 28-32
// bytes against a few dozen operations.  A population of four
// granite-moe-3b-a800m-d4 trials holds 1.91 G elements: 61 GB a step, 18.3
// ms at 3.35 TB/s.
//
// What the design does about it: one pass over each leaf, no temporaries.
// - adamw_sumsq_kernel: each block sums the squares of its share of one
//   trial's gradient, in float within a 16-byte load and in double across
//   them, and writes the block's sum into a scratch row at a fixed column.
//   adamw_finalize_kernel, one block a trial, adds the trial's columns in
//   one fixed order and writes the norm, the clip scale and the bias
//   corrections c1 and c2.  No atomics: two runs on the same gradients give
//   the same bits.
// - adamw_update_kernel: each thread moves 8 elements an iteration, with
//   16-byte loads and stores (two for a float32 array, one for bf16), and
//   takes element by element the head and tail where a trial's elements do
//   not start or end on an 8-element boundary (all of them where a pointer
//   is not 16-byte aligned).  p, m and v are written where they were read.
// - A population's trials are one launch of each kernel over their stacked
//   (P, ...) leaf: blockIdx.y is the trial, whose lr, decay, clip scale, c1
//   and c2 each block reads once.
// The update is the plain one's, operation by operation, in float32: the
// round-to-nearest intrinsics keep nvcc from fusing a multiply and an add,
// division and square root are IEEE, and the constants come rounded to
// float32 from the doubles Python computes.  So the kernel gives the plain
// update's bits from the same clip scale and corrections; the norm differs
// from the plain one in its order of summation alone.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 8;  // elements a thread moves an iteration
// blocks of the update kernel, over all trials, past which threads loop
constexpr long long kUpdateBlocks = 4096;

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static __device__ __forceinline__ void load8(const float* p,
                                               float (&x)[kVec]) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
    x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
  }
  static __device__ __forceinline__ void store8(float* p,
                                                const float (&x)[kVec]) {
    reinterpret_cast<float4*>(p)[0] = make_float4(x[0], x[1], x[2], x[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(x[4], x[5], x[6], x[7]);
  }
  static __device__ __forceinline__ float load1(const float* p) { return *p; }
  static __device__ __forceinline__ void store1(float* p, float x) { *p = x; }
  static __device__ __forceinline__ float round(float x) { return x; }
};

template <>
struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ void load8(const __nv_bfloat16* p,
                                               float (&x)[kVec]) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < kVec / 2; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void store8(__nv_bfloat16* p,
                                                const float (&x)[kVec]) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < kVec / 2; ++i)
      h[i] = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
  static __device__ __forceinline__ float load1(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16_rn(x);
  }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
};

// One trial's n elements, from global element `base`: element by element
// up to the first multiple of kVec ([0, head)), whole vectors of kVec from
// there, element by element again from tail0.  vec == 0: every element one
// at a time.
struct Span {
  long long head, nvec, tail0, nscalar;
  __device__ Span(long long base, long long n, int vec) {
    head = vec ? min(n, (kVec - base % kVec) % kVec) : n;
    nvec = (n - head) / kVec;
    tail0 = head + nvec * kVec;
    nscalar = head + (n - tail0);
  }
  // the i-th element taken one at a time
  __device__ long long scalar(long long i) const {
    return i < head ? i : tail0 + (i - head);
  }
};

// The block's sum of v, in one fixed order; thread 0 holds it.
__device__ __forceinline__ double block_sum(double v) {
  __shared__ double warp_sums[kWarps];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  double total = 0.0;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += warp_sums[w];
  }
  return total;
}

// partials[trial, col0 + blockIdx.x] = the sum of g^2 over this block's
// share of the trial's n elements (grid-stride over gridDim.x blocks).
template <typename TG>
__global__ void __launch_bounds__(kThreads)
adamw_sumsq_kernel(const TG* __restrict__ g, long long n,
                   double* __restrict__ partials, int ncols, int col0,
                   int vec) {
  const long long base = (long long)blockIdx.y * n;
  const TG* gt = g + base;
  const Span s(base, n, vec);
  const long long t0 = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kThreads;
  double acc = 0.0;
  for (long long i = t0; i < s.nvec; i += stride) {
    float x[kVec];
    Elem<TG>::load8(gt + s.head + i * kVec, x);
    float q = 0.0f;
#pragma unroll
    for (int k = 0; k < kVec; ++k) q = __fmaf_rn(x[k], x[k], q);
    acc += (double)q;
  }
  for (long long i = t0; i < s.nscalar; i += stride) {
    const float x = Elem<TG>::load1(gt + s.scalar(i));
    acc += (double)__fmul_rn(x, x);
  }
  acc = block_sum(acc);
  if (threadIdx.x == 0)
    partials[(long long)blockIdx.y * ncols + col0 + blockIdx.x] = acc;
}

// One block a trial: the norm of its gradient, sqrt of its ncols partial
// sums added in one fixed order, and coef[trial] = (clip scale, c1, c2) of the
// step `step[trial * step_stride]`, as the plain update computes them:
// scale = min(reciprocal(max(norm, 1e-9)) * clip, 1), NaN kept; c = 1 - b^s.
__global__ void __launch_bounds__(kThreads)
adamw_finalize_kernel(const double* __restrict__ partials, int ncols,
                      const int* __restrict__ step, int step_stride,
                      float* __restrict__ gnorm, float* __restrict__ coef,
                      int has_clip, float clip, float b1, float b2) {
  const int trial = blockIdx.x;
  double acc = 0.0;
  for (int j = threadIdx.x; j < ncols; j += kThreads)
    acc += partials[(long long)trial * ncols + j];
  acc = block_sum(acc);
  if (threadIdx.x != 0) return;
  const float norm = __fsqrt_rn((float)acc);
  float scale = 1.0f;
  if (has_clip) {
    const float c = isnan(norm) ? norm : fmaxf(norm, 1e-9f);
    const float r = __fmul_rn(__fdiv_rn(1.0f, c), clip);
    scale = isnan(r) ? r : fminf(r, 1.0f);
  }
  const float s = (float)step[trial * step_stride];
  gnorm[trial] = norm;
  coef[3 * trial] = scale;
  coef[3 * trial + 1] = __fsub_rn(1.0f, powf(b1, s));
  coef[3 * trial + 2] = __fsub_rn(1.0f, powf(b2, s));
}

struct Hyper {
  float b1, omb1, b2, omb2, eps, wd;  // omb: 1 - b, rounded from double
  int has_wd;
};

struct Trial {
  float scale, c1, c2, lr, lr_decay;
  int has_decay;
};

// One element: m and v updated in place, the new parameter returned, in
// the plain update's order of operations.
template <typename TP>
__device__ __forceinline__ float adamw_elem(float g, float& m, float& v,
                                            float p32, const Hyper& h,
                                            const Trial& t) {
  g = __fmul_rn(g, t.scale);
  m = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(h.omb1, g));
  v = __fadd_rn(__fmul_rn(h.b2, v), __fmul_rn(h.omb2, __fmul_rn(g, g)));
  float delta = __fdiv_rn(__fdiv_rn(m, t.c1),
                          __fadd_rn(__fsqrt_rn(__fdiv_rn(v, t.c2)), h.eps));
  if (h.has_wd) delta = __fadd_rn(delta, __fmul_rn(h.wd, p32));
  float np = Elem<TP>::round(__fsub_rn(p32, __fmul_rn(t.lr, delta)));
  if (t.has_decay)
    np = Elem<TP>::round(__fsub_rn(np, __fmul_rn(t.lr_decay, p32)));
  return np;
}

template <typename TP, typename TG>
__global__ void __launch_bounds__(kThreads)
adamw_update_kernel(TP* __restrict__ p, const TG* __restrict__ g,
                    float* __restrict__ m, float* __restrict__ v, long long n,
                    const float* __restrict__ coef,
                    const float* __restrict__ lr, int lr_stride,
                    float lr_value, const float* __restrict__ decay,
                    int decay_stride, Hyper h, int vec) {
  const int trial = blockIdx.y;
  const long long base = (long long)trial * n;
  Trial t;
  t.scale = coef[3 * trial];
  t.c1 = coef[3 * trial + 1];
  t.c2 = coef[3 * trial + 2];
  t.lr = lr != nullptr ? lr[trial * lr_stride] : lr_value;
  t.has_decay = decay != nullptr;
  t.lr_decay = t.has_decay ? __fmul_rn(t.lr, decay[trial * decay_stride])
                           : 0.0f;
  TP* pt = p + base;
  const TG* gt = g + base;
  float* mt = m + base;
  float* vt = v + base;
  const Span s(base, n, vec);
  const long long t0 = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = t0; i < s.nvec; i += stride) {
    const long long e = s.head + i * kVec;
    float pv[kVec], gv[kVec], mv[kVec], vv[kVec];
    Elem<TP>::load8(pt + e, pv);
    Elem<TG>::load8(gt + e, gv);
    Elem<float>::load8(mt + e, mv);
    Elem<float>::load8(vt + e, vv);
#pragma unroll
    for (int k = 0; k < kVec; ++k)
      pv[k] = adamw_elem<TP>(gv[k], mv[k], vv[k], pv[k], h, t);
    Elem<TP>::store8(pt + e, pv);
    Elem<float>::store8(mt + e, mv);
    Elem<float>::store8(vt + e, vv);
  }
  for (long long i = t0; i < s.nscalar; i += stride) {
    const long long e = s.scalar(i);
    float mv = mt[e], vv = vt[e];
    const float np = adamw_elem<TP>(Elem<TG>::load1(gt + e), mv, vv,
                                    Elem<TP>::load1(pt + e), h, t);
    Elem<TP>::store1(pt + e, np);
    mt[e] = mv;
    vt[e] = vv;
  }
}

template <typename TP, typename TG>
cudaError_t launch_update(void* p, const void* g, float* m, float* v,
                          long long n, int trials, const float* coef,
                          const float* lr, int lr_stride, float lr_value,
                          const float* decay, int decay_stride,
                          const Hyper& h, int vec, cudaStream_t st) {
  const long long need = (n + (long long)kThreads * kVec - 1) /
                         ((long long)kThreads * kVec);
  const long long cap = kUpdateBlocks / trials > 0 ? kUpdateBlocks / trials
                                                   : 1;
  const dim3 grid((unsigned)(need < cap ? need : cap), (unsigned)trials);
  adamw_update_kernel<TP, TG><<<grid, kThreads, 0, st>>>(
      static_cast<TP*>(p), static_cast<const TG*>(g), m, v, n, coef, lr,
      lr_stride, lr_value, decay, decay_stride, h, vec);
  return cudaGetLastError();
}

}  // namespace

// g: (trials, n) float32 (g_bf16 = 0) or bf16 (1), contiguous; partials:
// (trials, ncols) float64.  Writes columns [col0, col0 + blocks) of every
// trial's row.  vec: g is 16-byte aligned.  Returns the cudaError_t of the
// launch.
extern "C" int adamw_sumsq_launch(const void* g, int g_bf16, long long n,
                                  int trials, double* partials, int ncols,
                                  int col0, int blocks, int vec,
                                  void* stream) {
  if (n <= 0 || trials <= 0 || trials > 65535 || blocks <= 0 ||
      col0 < 0 || col0 + blocks > ncols)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, (unsigned)trials);
  cudaStream_t st = (cudaStream_t)stream;
  if (g_bf16)
    adamw_sumsq_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(g), n, partials, ncols, col0, vec);
  else
    adamw_sumsq_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(g), n, partials, ncols, col0, vec);
  return (int)cudaGetLastError();
}

// partials: (trials, ncols) float64 (ncols may be 0); step: int32, trial
// t's at step[t * step_stride]; gnorm: (trials,) float32; coef: (trials, 3)
// float32.  Returns the cudaError_t of the launch.
extern "C" int adamw_finalize_launch(const double* partials, int ncols,
                                     int trials, const int* step,
                                     int step_stride, float* gnorm,
                                     float* coef, int has_clip, float clip,
                                     float b1, float b2, void* stream) {
  if (trials <= 0 || ncols < 0 || step == nullptr)
    return (int)cudaErrorInvalidValue;
  adamw_finalize_kernel<<<trials, kThreads, 0, (cudaStream_t)stream>>>(
      partials, ncols, step, step_stride, gnorm, coef, has_clip, clip, b1,
      b2);
  return (int)cudaGetLastError();
}

// p: (trials, n) float32 (p_bf16 = 0) or bf16 (1); g: the same shape,
// float32 or bf16; m, v: float32; all contiguous, written in place.  coef:
// (trials, 3) float32 (clip scale, c1, c2).  lr: trial t's at
// lr[t * lr_stride], or lr_value where lr is null; decay likewise, none
// where null.  vec: p, g, m and v are 16-byte aligned.  Returns the
// cudaError_t of the launch.
extern "C" int adamw_update_launch(void* p, int p_bf16, const void* g,
                                   int g_bf16, float* m, float* v,
                                   long long n, int trials, const float* coef,
                                   const float* lr, int lr_stride,
                                   float lr_value, const float* decay,
                                   int decay_stride, float b1, float omb1,
                                   float b2, float omb2, float eps,
                                   int has_wd, float wd, int vec,
                                   void* stream) {
  if (n <= 0 || trials <= 0 || trials > 65535 || coef == nullptr)
    return (int)cudaErrorInvalidValue;
  const Hyper h{b1, omb1, b2, omb2, eps, wd, has_wd};
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (p_bf16 && g_bf16)
    err = launch_update<__nv_bfloat16, __nv_bfloat16>(
        p, g, m, v, n, trials, coef, lr, lr_stride, lr_value, decay,
        decay_stride, h, vec, st);
  else if (p_bf16)
    err = launch_update<__nv_bfloat16, float>(
        p, g, m, v, n, trials, coef, lr, lr_stride, lr_value, decay,
        decay_stride, h, vec, st);
  else if (g_bf16)
    err = launch_update<float, __nv_bfloat16>(
        p, g, m, v, n, trials, coef, lr, lr_stride, lr_value, decay,
        decay_stride, h, vec, st);
  else
    err = launch_update<float, float>(
        p, g, m, v, n, trials, coef, lr, lr_stride, lr_value, decay,
        decay_stride, h, vec, st);
  return (int)err;
}
