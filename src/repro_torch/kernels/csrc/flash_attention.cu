// flash_attention: forward softmax attention on Hopper (sm_90a), causal
// and/or sliding window, optional tanh softcap, grouped-query heads, with
// an online softmax over tiles of keys.
//
// Replaces: src/repro/kernels/flash_attention.py : flash_attention /
// _flash_kernel, the Pallas TPU kernel (grid (B, H, Sq/bq, Skv/bk) with
// the KV axis innermost and sequential, (m, l, acc) carried across it in
// VMEM scratch, masked tiles skipped with pl.when).
//
// Semantics copied from _flash_kernel: scores in float32 whatever the
// input type; scale 1/sqrt(D) before the softcap, the softcap before the
// mask; masked scores take -2^30, not -inf; rows past Sq and keys past Skv
// are masked; query and key positions both count from 0 (also when
// Sq != Skv); l is clamped at 1e-30 before the division; out in the input
// type.
//
// What bounds it on this card: operations.  The work is 4*D multiply-adds
// a visible (query, key) pair a head (Q.K and P.V), 166 GFLOP at the serve
// shape (B 4, S 3000, H 10, K 1, D 256, window 2048): 0.17 ms at the 989
// TFLOP/s of bf16 tensor cores, against 0.06 ms for the bytes of q, k, v
// and o.  This first kernel does not reach the tensor cores: it runs the
// products as float32 multiply-adds on the CUDA cores (67 TFLOP/s at the
// most), from shared memory.  wgmma tiles fed by TMA are the later step.
//
// What the design does about it: one block of 256 threads per (q head,
// 64-row q tile, batch), with the heads fastest in the grid so the H/K
// query heads that share a KV head run side by side and read its tiles
// from L2.  The block walks only the KV tiles of its visible band, from
// max(0, q0 - window + 1) to min(q1, Skv) rounded out to whole 64-key
// tiles (a partly visible tile is masked element by element, never
// skipped).  Q, K and V tiles sit in dynamic shared memory as float32 (213
// KB at D = 256, so the launcher raises the block's limit), Q and K rows
// padded by one float so a warp's reads of 16 different rows fall in 16
// banks.  Thread t owns rows 4(t/16) .. 4(t/16)+3 of the tile, for the
// scores at columns t%16 + 16j and for the accumulator at columns
// t%16 + 16c, so the row statistics (m, l) and the rescaling of its part
// of the accumulator stay in its registers; a row's max and sum reduce
// over the 16 lanes that share it with warp shuffles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBQ = 64;        // query rows a block
constexpr int kBK = 64;        // keys a tile
constexpr int kThreads = 256;  // 16 row groups of 4 rows x 16 column lanes
constexpr int kPStride = kBK + 4;  // P rows of two row groups 16 banks apart
constexpr float kNegInf = -1073741824.0f;  // -2^30, as the reference
constexpr size_t kMaxSmem = 227 * 1024;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f(float x, float* dst) { *dst = x; }
__device__ __forceinline__ void from_f(float x, __nv_bfloat16* dst) {
  *dst = __float2bfloat16(x);  // round to nearest even, as torch's cast
}

template <int D>
struct Layout {
  static constexpr int kQKStride = D + 1;  // padded rows of the Q, K tiles
  static constexpr size_t kFloats = (size_t)kBQ * kQKStride +
                                    (size_t)kBK * kQKStride +
                                    (size_t)kBK * D + (size_t)kBQ * kPStride;
  static constexpr size_t kBytes = kFloats * sizeof(float);
};

// Rows [row0, row0 + kRows) of head `head` of x (B, S, nh, D) into a tile
// of floats with row stride `stride`; rows past S are zeros.
template <typename T, int D, int kRows>
__device__ __forceinline__ void load_tile(float* dst, int stride,
                                          const T* __restrict__ x, int b,
                                          int row0, int S, int nh,
                                          int head) {
  for (int i = threadIdx.x; i < kRows * D; i += kThreads) {
    const int r = i / D, c = i % D;
    const int s = row0 + r;
    dst[r * stride + c] =
        s < S ? to_f(x[(((size_t)b * S + s) * nh + head) * D + c]) : 0.0f;
  }
}

__device__ __forceinline__ float reduce16_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float reduce16_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int Sq, int Skv,
             int H, int K, float scale, int causal, int window,
             float softcap) {
  using L = Layout<D>;
  constexpr int kCols = D / 16;  // accumulator columns a thread
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kBQ * L::kQKStride;
  float* vs = ks + kBK * L::kQKStride;
  float* ps = vs + kBK * D;

  const int h = blockIdx.x, b = blockIdx.z;
  const int kvh = h / (H / K);
  const int q0 = blockIdx.y * kBQ;
  const int q1 = min(q0 + kBQ, Sq);
  const int g = threadIdx.x / 16;   // rows 4g .. 4g+3 of the tile
  const int col = threadIdx.x % 16;

  // the band of keys any row of this tile may see, in whole tiles
  const int kv_lo = window ? max(0, q0 - window + 1) : 0;
  const int kv_hi = causal ? min(q1, Skv) : Skv;
  const int t_lo = kv_lo / kBK;
  const int t_hi = (kv_hi + kBK - 1) / kBK;

  load_tile<T, D, kBQ>(qs, L::kQKStride, q, b, q0, Sq, H, h);

  float acc[4][kCols];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.0f;
  }

  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the last tile's readers are done with K, V and P
    load_tile<T, D, kBK>(ks, L::kQKStride, k, b, k0, Skv, K, kvh);
    load_tile<T, D, kBK>(vs, D, v, b, k0, Skv, K, kvh);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(4 * g + i) * L::kQKStride + d];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = ks[(col + 16 * j) * L::kQKStride + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + 4 * g + i;
      float tmax = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + col + 16 * j;
        float x = s[i][j] * scale;
        if (softcap != 0.0f) x = tanhf(x / softcap) * softcap;
        bool ok = kp < Skv && qp < Sq;
        if (causal) ok = ok && qp >= kp;
        if (window) ok = ok && (qp - kp) < window;
        s[i][j] = ok ? x : kNegInf;
        tmax = fmaxf(tmax, s[i][j]);
      }
      const float m_new = fmaxf(m[i], reduce16_max(tmax));
      const float alpha = expf(m[i] - m_new);
      float rsum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        rsum += p;
        ps[(4 * g + i) * kPStride + col + 16 * j] = p;
      }
      l[i] = l[i] * alpha + reduce16_sum(rsum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(4 * g + i) * kPStride + c];
#pragma unroll
      for (int cc = 0; cc < kCols; ++cc) {
        const float vv = vs[c * D + col + 16 * cc];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][cc] = fmaf(pv[i], vv, acc[i][cc]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + 4 * g + i;
    if (qp >= Sq) continue;
    const float lc = fmaxf(l[i], 1e-30f);
    T* row = o + (((size_t)b * Sq + qp) * H + h) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c) from_f(acc[i][c] / lc, row + col + 16 * c);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Skv, int H, int K, int causal, int window,
           float softcap, cudaStream_t stream) {
  constexpr size_t smem = Layout<D>::kBytes;
  static_assert(smem <= kMaxSmem, "tiles exceed a block's shared memory");
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(H, (Sq + kBQ - 1) / kBQ, B);
  flash_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, Sq, Skv, H, K,
      1.0f / sqrtf((float)D), causal, window, softcap);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o, int B,
             int Sq, int Skv, int H, int K, int D, int causal, int window,
             float softcap, cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, o, B, Sq, Skv, H, K, causal, window,
                           softcap, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, B, Sq, Skv, H, K, causal, window,
                           softcap, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, Sq, Skv, H, K, causal, window,
                            softcap, stream);
    case 256:
      return launch<T, 256>(q, k, v, o, B, Sq, Skv, H, K, causal, window,
                            softcap, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, o: (B, Sq, H, D); k, v: (B, Skv, K, D); contiguous, on one device, all
// float32 (dtype 0) or all bfloat16 (dtype 1); K divides H; D one of 16,
// 64, 128, 256; window 0 means none, softcap 0 means none.  Launches on
// `stream` and returns the cudaError_t of the launch.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int Sq,
                                      int Skv, int H, int K, int D, int dtype,
                                      int causal, int window, float softcap,
                                      void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || K <= 0 || H % K != 0 || window < 0)
    return (int)cudaErrorInvalidValue;
  if (B > 65535 || (Sq + kBQ - 1) / kBQ > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_d<float>(q, k, v, o, B, Sq, Skv, H, K, D, causal, window,
                           softcap, s);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(q, k, v, o, B, Sq, Skv, H, K, D, causal,
                                   window, softcap, s);
  return (int)cudaErrorInvalidValue;
}
