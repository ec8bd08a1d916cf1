// flash_attention: forward softmax attention on Hopper (sm_90a), causal
// and/or sliding window, optional tanh softcap, grouped-query heads, with
// an online softmax over tiles of keys; and its gradient (namespace bwd,
// at the end of the file).
//
// Replaces: src/repro/kernels/flash_attention.py : flash_attention /
// _flash_kernel, the Pallas TPU kernel (grid (B, H, Sq/bq, Skv/bk) with
// the KV axis innermost and sequential, (m, l, acc) carried across it in
// VMEM scratch, masked tiles skipped with pl.when).
//
// Semantics copied from _flash_kernel: scores in float32 whatever the
// input type; the scale (the caller's, _flash_kernel's 1/sqrt(D)) before
// the softcap, the softcap before the mask; masked scores take -2^30, not
// -inf; rows past Sq and keys past Skv are masked; key positions count
// from 0 and query row i sits at position q_offset + i (q_offset 0, the
// Pallas kernel's, also when Sq != Skv: a caller holding one shard of a
// sequence's queries passes the shard's first position); l is clamped at
// 1e-30 before the division; out in the input type.
//
// What bounds it on this card: operations.  The work is 4*D multiply-adds
// a visible (query, key) pair a head (Q.K and P.V), 166 GFLOP at the serve
// shape (B 4, S 3000, H 10, K 1, D 256, window 2048): 0.17 ms at the 989
// TFLOP/s of bf16 tensor cores, against 0.06 ms for the bytes of q, k, v
// and o.
//
// Two kernels, chosen by the input type (never on failure):
//
// bfloat16 — `tc::flash_tc_kernel`, on the tensor cores.  One block of
// three warpgroups per (q head, 128 query rows, batch), the heads fastest
// in the grid so the H/K query heads that share a KV head run side by side
// and read its tiles from L2.
//  * Warp specialisation: warpgroup 0 is the producer (`setmaxnreg` down to
//    24 registers); one of its threads issues every TMA load.  Warpgroups 1
//    and 2 are consumers (`setmaxnreg` up to 240), each owning 64 query rows:
//    its O accumulator (64 x D float32, D/2 registers a thread) and its row
//    statistics (m, l) live in registers.
//  * TMA: one tensor map per tensor over (D, heads, S, B), boxes of 64
//    bf16 columns x 64 rows, 128-byte swizzled (32-byte at D = 16, a box
//    as wide as the head); a 256-wide head takes four boxes.  Q is loaded
//    once per block; K and V tiles of 64 keys stream through a ring of 2
//    stages guarded by `mbarrier`s (full: the producer's expected bytes;
//    empty: all 256 consumer threads).  TMA's zero fill past Skv takes the
//    place of reading the ragged tail; those keys are masked.
//  * S = Q.K^T: D/16 `wgmma` m64n64k16 per tile, both operands K-major in
//    shared memory, bf16 in and float32 sums (bf16 products are exact in
//    float32, so the scores equal float32 scores of the same inputs up to
//    the order of the sums).
//  * O += P.V: P stays in registers as the A operand, split in two bf16
//    parts, P_hi = bf16(P) and P_lo = bf16(P - P_hi), so each tile issues
//    4 k-steps x 2 `wgmma` m64nDk16 with V MN-major in shared memory
//    (V in bf16 is exact).  P keeps about 16 bits.  One bf16 rounding of P
//    would put an error of about 2^-9/sqrt(3) = 1.1e-3 of the row's rms on
//    each output element, over the 2^-10 share of the row's rms that the
//    element-wise limit of chip_smoke.py allows where |ref| is small; the
//    split costs 1.5x the minimal tensor work (about 0.25 ms at the serve
//    shape).  l sums the float32 P.
//  * The band walk: a block visits only the 64-key tiles of its causal /
//    window band; a consumer computes only on the tiles of its own rows'
//    band (it still waits for and releases the others), and applies the
//    element mask only on tiles that the band, or the end of the keys,
//    cuts.
//  * Budget at D = 256: shared memory Q 64 KB + 2 stages x (K 32 KB +
//    V 32 KB) = 192 KB (plus 1 KB of alignment slack and the barriers), one
//    block an SM; registers 2 x 128 x 240 + 128 x 24 = 64 512 of 65 536.
//
// Both kernels can write the float32 row log-sum-exp m + log(max(l,
// 1e-30)) of each (b, h, q) row to an optional (B, H, Sq) output: the
// backward below recomputes P = exp(s - lse) from it.  A null pointer
// writes nothing.
//
// float32 — `f32::flash_kernel`, off the serve path, on the CUDA cores:
// one block of 256 threads per (q head, 64-row q tile, batch), Q, K and V
// tiles in dynamic shared memory as float32 (213 KB at D = 256), Q and K
// rows padded by one float; thread t owns rows 4(t/16) .. 4(t/16)+3 of the
// tile, for the scores at columns t%16 + 16j and for the accumulator at
// columns t%16 + 16c, and the row statistics reduce over the 16 lanes that
// share a row with warp shuffles.  Products are float32 multiply-adds.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1073741824.0f;  // -2^30, as the reference
constexpr size_t kMaxSmem = 227 * 1024;

// ------------------------------------------------------------ float32
namespace f32 {

constexpr int kBQ = 64;        // query rows a block
constexpr int kBK = 64;        // keys a tile
constexpr int kThreads = 256;  // 16 row groups of 4 rows x 16 column lanes
constexpr int kPStride = kBK + 4;  // P rows of two row groups 16 banks apart

template <int D>
struct Layout {
  static constexpr int kQKStride = D + 1;  // padded rows of the Q, K tiles
  static constexpr size_t kFloats = (size_t)kBQ * kQKStride +
                                    (size_t)kBK * kQKStride +
                                    (size_t)kBK * D + (size_t)kBQ * kPStride;
  static constexpr size_t kBytes = kFloats * sizeof(float);
};

// Rows [row0, row0 + kRows) of head `head` of x (B, S, nh, D) into a tile
// with row stride `stride`; rows past S are zeros.
template <int D, int kRows>
__device__ __forceinline__ void load_tile(float* dst, int stride,
                                          const float* __restrict__ x, int b,
                                          int row0, int S, int nh,
                                          int head) {
  for (int i = threadIdx.x; i < kRows * D; i += kThreads) {
    const int r = i / D, c = i % D;
    const int s = row0 + r;
    dst[r * stride + c] =
        s < S ? x[(((size_t)b * S + s) * nh + head) * D + c] : 0.0f;
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

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ o,
             float* __restrict__ lse, int Sq, int Skv, int H, int K,
             float scale, int causal, int window, int qo, float softcap) {
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

  // the band of keys any row of this tile may see, in whole tiles (row
  // r at position qo + r)
  const int kv_lo = window ? max(0, qo + q0 - window + 1) : 0;
  const int kv_hi = causal ? min(qo + q1, Skv) : Skv;
  const int t_lo = kv_lo / kBK;
  const int t_hi = (kv_hi + kBK - 1) / kBK;

  load_tile<D, kBQ>(qs, L::kQKStride, q, b, q0, Sq, H, h);

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
    load_tile<D, kBK>(ks, L::kQKStride, k, b, k0, Skv, K, kvh);
    load_tile<D, kBK>(vs, D, v, b, k0, Skv, K, kvh);
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
        if (causal) ok = ok && qo + qp >= kp;
        if (window) ok = ok && (qo + qp - kp) < window;
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
    float* row = o + (((size_t)b * Sq + qp) * H + h) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c) row[col + 16 * c] = acc[i][c] / lc;
    if (lse != nullptr && col == 0)
      lse[((size_t)b * H + h) * Sq + qp] = m[i] + logf(lc);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int Sq, int Skv, int H, int K, int causal, int window,
           int qo, float softcap, float scale, cudaStream_t stream) {
  constexpr size_t smem = Layout<D>::kBytes;
  static_assert(smem <= kMaxSmem, "tiles exceed a block's shared memory");
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(H, (Sq + kBQ - 1) / kBQ, B);
  flash_kernel<D><<<grid, kThreads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, lse, Sq,
      Skv, H, K, scale, causal, window, qo, softcap);
  return (int)cudaGetLastError();
}

}  // namespace f32

// ----------------------------------------------------------- bfloat16
namespace tc {

// D[64 x 64] (+)= A[64 x 16] . B[64 x 16]^T: A and B K-major in shared
// memory (descriptors), f32 accumulators in the m64n64 fragment layout;
// scale_d 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, "
      "%11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, "
      "%22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 16] += A[64 x 16] . B[16 x 16]: A in registers (the bf16
// m64k16 fragment, 4 words a thread), B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n16(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 64] += A[64 x 16] . B[16 x 64]: A in registers (the bf16
// m64k16 fragment, 4 words a thread), B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, "
      "%11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, "
      "%22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 128] += A[64 x 16] . B[16 x 128]: A in registers (the bf16
// m64k16 fragment, 4 words a thread), B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, "
      "%11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, "
      "%22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, "
      "%33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, "
      "%55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]),
        "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]),
        "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 256] += A[64 x 16] . B[16 x 256]: A in registers (the bf16
// m64k16 fragment, 4 words a thread), B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n256(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, "
      "%11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, "
      "%22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, "
      "%33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, "
      "%55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, "
      "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, "
      "%77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, "
      "%99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, "
      "%121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]),
        "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]),
        "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]),
        "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]),
        "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),
        "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]),
        "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]),
        "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]),
        "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]),
        "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]),
        "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


constexpr int kRows = 64;        // query rows a consumer; keys a tile
constexpr int kConsumers = 2;    // consumer warpgroups a block
constexpr int kStages = 2;       // K/V ring depth
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;

template <int D>
struct Cfg {
  static constexpr int kBoxCols = D < 64 ? D : 64;  // bf16 columns a box
  static constexpr int kBoxes = D / kBoxCols;
  static constexpr int kRowBytes = 2 * kBoxCols;    // 128, or 32 at D = 16
  static constexpr int kBoxBytes = kRows * kRowBytes;
  static constexpr int kTileBytes = kBoxes * kBoxBytes;  // 64 rows x D
  // wgmma descriptor layout type: 1 = 128-byte swizzle, 3 = 32-byte
  static constexpr uint32_t kLayout = kRowBytes == 128 ? 1u : 3u;
  static constexpr int kQOff = 0;
  static constexpr int kKOff = kConsumers * kTileBytes;
  static constexpr int kVOff = kKOff + kStages * kTileBytes;
  static constexpr int kBarOff = kVOff + kStages * kTileBytes;
  // + the barriers (Q, full and empty per stage) + slack to align to 1 KB
  static constexpr size_t kBytes = kBarOff + 8 * (1 + 2 * kStages) + 1024;
  static_assert(kRowBytes == 128 || kRowBytes == 32, "box width");
  static_assert(kBytes <= kMaxSmem, "tiles exceed a block's shared memory");
};

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Spin until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 4-D tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units), swizzle layout type.
__device__ __forceinline__ uint64_t sdesc(uint32_t addr, uint32_t lbo,
                                          uint32_t sbo, uint32_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)layout << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keep the compiler from moving reads or writes of registers that an
// asynchronous wgmma owns across its issue and its wait.
template <int N>
__device__ __forceinline__ void hold(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void hold(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float* o, const uint32_t* a,
                                         uint64_t db) {
  if constexpr (D == 16) wgmma_rs_n16(o, a, db);
  if constexpr (D == 64) wgmma_rs_n64(o, a, db);
  if constexpr (D == 128) wgmma_rs_n128(o, a, db);
  if constexpr (D == 256) wgmma_rs_n256(o, a, db);
}

// Two floats to packed bf16: hi = bf16(x), lo = bf16(x - hi), the lower
// column in the low half as the wgmma A fragment wants it.
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v,
                __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int Sq,
                int Skv, int H, int K, float scale, int causal, int window,
                int qo, float softcap) {
  using C = Cfg<D>;
  extern __shared__ unsigned char smem_raw[];
  // swizzle atoms want 1 KB alignment
  const uint32_t base =
      ((uint32_t)__cvta_generic_to_shared(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base + C::kQOff, sk = base + C::kKOff,
                 sv = base + C::kVOff, bar_q = base + C::kBarOff;
  const uint32_t bar_full = bar_q + 8, bar_empty = bar_q + 8 * (1 + kStages);

  const int h = blockIdx.x, b = blockIdx.z;
  const int kvh = h / (H / K);
  const int q0 = blockIdx.y * (kConsumers * kRows);
  const int q1 = min(q0 + kConsumers * kRows, Sq);
  // the band of keys any row of this block may see, in whole tiles (row
  // r at position qo + r)
  const int kv_lo = window ? max(0, qo + q0 - window + 1) : 0;
  const int kv_hi = causal ? min(qo + q1, Skv) : Skv;
  const int t_lo = kv_lo / kRows;
  const int t_hi = max(t_lo, (kv_hi + kRows - 1) / kRows);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, kConsumers * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      int q_rows = 0;  // consumers with rows inside Sq
      for (int c = 0; c < kConsumers; ++c) q_rows += q0 + c * kRows < Sq;
      mbar_expect_tx(bar_q, q_rows * C::kTileBytes);
      for (int c = 0; c < q_rows; ++c)
        for (int x = 0; x < C::kBoxes; ++x)
          tma_load(sq + c * C::kTileBytes + x * C::kBoxBytes, &tm_q, bar_q,
                   x * C::kBoxCols, h, q0 + c * kRows, b);
      for (int t = t_lo; t < t_hi; ++t) {
        const int i = t - t_lo, s = i % kStages;
        const uint32_t full = bar_full + 8 * s;
        mbar_wait(bar_empty + 8 * s, ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(full, 2 * C::kTileBytes);
        for (int x = 0; x < C::kBoxes; ++x) {
          const uint32_t off = s * C::kTileBytes + x * C::kBoxBytes;
          tma_load(sk + off, &tm_k, full, x * C::kBoxCols, kvh, t * kRows, b);
          tma_load(sv + off, &tm_v, full, x * C::kBoxCols, kvh, t * kRows, b);
        }
      }
    }
  } else {
    // ---- consumer: 64 query rows, O and (m, l) in registers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int cw = wg - 1;
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int r0 = q0 + cw * kRows;
    const int row = r0 + 16 * warp + lane / 4;  // and row + 8
    const int colq = 2 * (lane % 4);
    // the tiles this consumer's rows may see
    int c_lo = t_hi, c_hi = t_hi;
    if (r0 < Sq) {
      const int lo = window ? max(0, qo + r0 - window + 1) : 0;
      const int hi = causal ? min(qo + min(r0 + kRows, Sq), Skv) : Skv;
      c_lo = max(t_lo, lo / kRows);
      c_hi = min(t_hi, (hi + kRows - 1) / kRows);
    }
    const uint32_t q_tile = sq + cw * C::kTileBytes;
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.0f, l1 = 0.0f;
    if (c_lo < c_hi) mbar_wait(bar_q, 0);

    for (int t = t_lo; t < t_hi; ++t) {
      const int i = t - t_lo, s = i % kStages;
      mbar_wait(bar_full + 8 * s, (i / kStages) & 1);
      if (t >= c_lo && t < c_hi) {
        const uint32_t k_tile = sk + s * C::kTileBytes;
        const uint32_t v_tile = sv + s * C::kTileBytes;
        float sc[32];
#pragma unroll
        for (int j = 0; j < 32; ++j) sc[j] = 0.0f;
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t off = (kk * 16) / C::kBoxCols * C::kBoxBytes +
                               (kk * 16) % C::kBoxCols * 2;
          wgmma_ss_n64(
              sc, sdesc(q_tile + off, 16, 8 * C::kRowBytes, C::kLayout),
              sdesc(k_tile + off, 16, 8 * C::kRowBytes, C::kLayout), kk > 0);
        }
        wg_commit();
        wg_wait_all();
        hold<32>(sc);

        // scale, softcap, mask (only where the band or Skv cuts the tile)
        const int k0 = t * kRows;
        const bool cut = k0 + kRows > Skv ||
                         (causal && k0 + kRows - 1 > qo + r0) ||
                         (window && qo + r0 + kRows - 1 - k0 >= window);
        float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = sc[4 * j + e] * scale;
            if (softcap != 0.0f) x = tanhf(x / softcap) * softcap;
            if (cut) {
              const int qp = row + (e >= 2 ? 8 : 0);
              const int kp = k0 + 8 * j + colq + (e & 1);
              bool ok = kp < Skv && qp < Sq;
              if (causal) ok = ok && qo + qp >= kp;
              if (window) ok = ok && (qo + qp - kp) < window;
              x = ok ? x : kNegInf;
            }
            sc[4 * j + e] = x;
            if (e < 2)
              mx0 = fmaxf(mx0, x);
            else
              mx1 = fmaxf(mx1, x);
          }
        }
        const float mn0 = fmaxf(m0, quad_max(mx0));
        const float mn1 = fmaxf(m1, quad_max(mx1));
        const float a0 = expf(m0 - mn0), a1 = expf(m1 - mn1);
        m0 = mn0;
        m1 = mn1;
        // P in two bf16 parts, as the A fragments of 4 k-steps of 16 keys
        uint32_t phi[16], plo[16];
        float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float p0 = expf(sc[4 * j] - mn0);
          const float p1 = expf(sc[4 * j + 1] - mn0);
          const float p2 = expf(sc[4 * j + 2] - mn1);
          const float p3 = expf(sc[4 * j + 3] - mn1);
          s0 += p0 + p1;
          s1 += p2 + p3;
          const int r = 4 * (j / 2) + 2 * (j % 2);
          split2(p0, p1, phi[r], plo[r]);
          split2(p2, p3, phi[r + 1], plo[r + 1]);
        }
        l0 = l0 * a0 + s0;
        l1 = l1 * a1 + s1;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          acc[4 * j] *= a0;
          acc[4 * j + 1] *= a0;
          acc[4 * j + 2] *= a1;
          acc[4 * j + 3] *= a1;
        }
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t dv =
              sdesc(v_tile + kk * 16 * C::kRowBytes, C::kBoxBytes,
                    8 * C::kRowBytes, C::kLayout);
          wgmma_pv<D>(acc, phi + 4 * kk, dv);
          wgmma_pv<D>(acc, plo + 4 * kk, dv);
        }
        wg_commit();
        wg_wait_all();
        hold<D / 2>(acc);
        hold<16>(phi);
        hold<16>(plo);
      }
      mbar_arrive(bar_empty + 8 * s);
    }

    // each thread summed its own columns of l; the quad holds the row
    const float lc0 = fmaxf(quad_sum(l0), 1e-30f);
    const float lc1 = fmaxf(quad_sum(l1), 1e-30f);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int qp = row + 8 * half;
      if (qp >= Sq) continue;
      const float lc = half ? lc1 : lc0;
      if (lse != nullptr && colq == 0)
        lse[((size_t)b * H + h) * Sq + qp] = (half ? m1 : m0) + logf(lc);
      __nv_bfloat16* dst = o + (((size_t)b * Sq + qp) * H + h) * D + colq;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
            __floats2bfloat162_rn(acc[4 * j + 2 * half] / lc,
                                  acc[4 * j + 2 * half + 1] / lc);
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver function: reach it through the
// runtime, so the library links against nothing but cudart.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// Tensor map of x (B, S, nh, D) bf16 as (D, nh, S, B), boxes of
// (kBoxCols, 1, 64, 1); zeros past the edges.
template <int D>
bool make_map(CUtensorMap* map, const void* x, int B, int S, int nh) {
  using C = Cfg<D>;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)nh, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)nh * D * 2,
                                 (cuuint64_t)S * nh * D * 2};
  const cuuint32_t box[4] = {(cuuint32_t)C::kBoxCols, 1, kRows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x),
                dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                C::kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                    : CU_TENSOR_MAP_SWIZZLE_32B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int Sq, int Skv, int H, int K, int causal, int window,
           int qo, float softcap, float scale, cudaStream_t stream) {
  constexpr size_t smem = Cfg<D>::kBytes;
  CUtensorMap mq, mk, mv;
  if (!make_map<D>(&mq, q, B, Sq, H) || !make_map<D>(&mk, k, B, Skv, K) ||
      !make_map<D>(&mv, v, B, Skv, K))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(H, (Sq + kConsumers * kRows - 1) / (kConsumers * kRows), B);
  flash_tc_kernel<D><<<grid, kThreads, smem, stream>>>(
      mq, mk, mv, (__nv_bfloat16*)o, lse, Sq, Skv, H, K,
      scale, causal, window, qo, softcap);
  return (int)cudaGetLastError();
}

}  // namespace tc

template <bool kBf16, int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int Sq, int Skv, int H, int K, int causal, int window,
           int qo, float softcap, float scale, cudaStream_t stream) {
  if constexpr (kBf16)
    return tc::launch<D>(q, k, v, o, lse, B, Sq, Skv, H, K, causal, window,
                         qo, softcap, scale, stream);
  else
    return f32::launch<D>(q, k, v, o, lse, B, Sq, Skv, H, K, causal, window,
                          qo, softcap, scale, stream);
}

template <bool kBf16>
int launch_d(const void* q, const void* k, const void* v, void* o, float* lse,
             int B, int Sq, int Skv, int H, int K, int D, int causal,
             int window, int qo, float softcap, float scale,
             cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch<kBf16, 16>(q, k, v, o, lse, B, Sq, Skv, H, K, causal,
                               window, qo, softcap, scale, stream);
    case 64:
      return launch<kBf16, 64>(q, k, v, o, lse, B, Sq, Skv, H, K, causal,
                               window, qo, softcap, scale, stream);
    case 128:
      return launch<kBf16, 128>(q, k, v, o, lse, B, Sq, Skv, H, K, causal,
                                window, qo, softcap, scale, stream);
    case 256:
      return launch<kBf16, 256>(q, k, v, o, lse, B, Sq, Skv, H, K, causal,
                                window, qo, softcap, scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// ----------------------------------------------------------- backward
// The gradient of the forward above, written for this port: the Pallas
// kernel has no backward (the JAX package trains through XLA attention).
// dS = P (dP - D) (1 - tanh^2 under a softcap) scale, P = exp(s - lse)
// from the forward's row log-sum-exp, masked pairs P = 0; dV = P^T.dO,
// dK = dS^T.Q, dQ = dS.K; dK and dV summed over the H/K query heads of
// each KV head.  Three steps, the kernels chosen by the input type (never
// on failure):
//
//  * D_i = rowsum(dO_i * O_i), float32, by `dot_kernel`: one warp a
//    (b, q, h) row, into (B, H, Sq).  Bytes-bound, both types.
//
// bfloat16 — on the tensor cores, `wgmma` fed by TMA, with the forward's
// tensor maps, descriptors, fences and `mbarrier` rings (namespace tc).
// What bounds it: operations, 10*D multiply-adds a visible (query, key)
// pair a head at the least (S, dP, dV, dK, dQ; 2.5x the forward's).
//  * dK, dV by `dkdv_tc_kernel`: one block of three warpgroups per (64
//    keys, query head, batch), the heads fastest in the grid (the G = H/K
//    heads of a KV head read its K and V tiles from L2 side by side).  At
//    the train shape (S 3000, H 10, K 1) that is 47 x 10 = 470 blocks on
//    132 SMs, where one block per (keys, KV head) walking its G heads in
//    series would give 47.  Warpgroup 0 is the producer (24 registers):
//    K and V of the block's keys once, then Q and dO of each 64-row query
//    tile of the keys' causal/window band through a ring of 2 stages.
//    The products are transposed, keys as wgmma's M, so that P^T and
//    dS^T come out of the accumulator as the next product's A fragment:
//    warpgroup 1 computes S^T = K.Q^T (`ss`), P^T, and dV += P^T.dO
//    (`rs`, dO read MN-major from the tile S^T read K-major); warpgroup 2
//    computes dP^T = V.dO^T (`ss`), and dK += dS^T.Q (`rs`).  Warpgroup 1
//    hands P^T (1 - tanh^2) / sqrt(D) to warpgroup 2 through 16 KB of
//    shared memory (each thread's 32 values, at the same fragment
//    positions in both warpgroups; an `mbarrier` pair guards it).  Each
//    block writes float32 partial dK and dV of its head into (B, Skv, K,
//    G, D) scratch; `sum_splits_kernel` sums the G heads in a fixed order
//    (so a run repeats bit for bit) and casts to bf16.
//  * dQ by `dq_tc_kernel`: one block of three warpgroups per (query head,
//    2 x 64 query rows, batch), as the forward: Q and dO of both
//    consumers' rows resident; K tiles through a ring of 2 stages and V
//    tiles through one of 2 (1 at D = 256).  Each consumer computes
//    S = Q.K^T and dP = dO.V^T (`ss`), dS in registers, and dQ += dS.K
//    (`rs`, K read MN-major from the tile S read K-major); it releases V
//    as soon as dP is done.
//  * Numerics: Q, K, V and dO are bf16, so S and dP are exact products
//    summed in float32.  P and dS are float32 and go into the second
//    products split in two bf16 parts (`split2`, about 16 bits): one bf16
//    rounding of them breaks the element-wise limit chip_smoke.py holds
//    the gradients to, in every case of the CPU emulation in
//    tests/test_torch_kernels_lm.py, which holds the split within it.  The
//    split doubles dV, dK and dQ, so the two kernels issue 2 + 4 + 2 + 2
//    = 10 units of D-wide product work a tile pair against the minimum
//    of 5: twice the bound's work.  The band walk visits only tiles of
//    the causal/window band and masks element by element only on tiles
//    that the band or the ends of Sq and Skv cut; TMA's zero fill stands
//    in for the ragged tails.
//  * Budget at D = 256.  dK/dV: shared memory K 32 KB + V 32 KB + 2
//    stages x (Q 32 KB + dO 32 KB) + the 16 KB hand-over = 208 KB (+1 KB
//    alignment slack, barriers); registers a consumer thread: its 64 x
//    256 float32 accumulator (dV or dK, one warpgroup each: 128), the 64
//    x 64 scores (32), their bf16 hi/lo fragments (32) and the 16
//    per-query lse or D values.  dQ: Q 2 x 32 KB + dO 2 x 32 KB + K 2 x
//    32 KB + V 1 x 32 KB = 224 KB; registers: the dQ accumulator (128),
//    S and dP (64), the fragments (32), 16 short of the cap for the rest
//    (ptxas spills 32 bytes a thread there; none at D <= 128, none in
//    dK/dV).  Consumers `setmaxnreg` to 240, the producer to 24:
//    2 x 128 x 240 + 128 x 24 = 64 512 of 65 536.
//
// float32 — on the CUDA cores, off the train path: `dkdv_kernel` one
// block per (tile of kB keys, KV head, batch) walking the H/K query heads
// of its KV head and the query tiles of its band, dK and dV in registers
// (no atomics, no scratch); `dq_kernel` one block per (kB query rows,
// query head, batch).  Tiles float32 in shared memory, rows padded by one
// float; thread t owns rows 2(t/16), 2(t/16)+1 of a tile and columns
// t%16 + 16j.
namespace bwd {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// D_i = sum_d dO[i, d] O[i, d] for every row i = (b, q, h), into
// dvec (B, H, Sq).
template <typename T>
__global__ void __launch_bounds__(256)
dot_kernel(const T* __restrict__ o, const T* __restrict__ dout,
           float* __restrict__ dvec, long long rows, int Sq, int H, int D) {
  const long long row = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const T* a = o + row * D;
  const T* g = dout + row * D;
  float sum = 0.0f;
  for (int d = lane; d < D; d += 32) sum = fmaf(to_f(a[d]), to_f(g[d]), sum);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) {
    const int h = (int)(row % H);
    const long long bq = row / H;
    const int qp = (int)(bq % Sq);
    const long long b = bq / Sq;
    dvec[(b * H + h) * Sq + qp] = sum;
  }
}

// Whether query row qp (at position qo + qp) sees key kp.
__device__ __forceinline__ bool visible(int qp, int kp, int Sq, int Skv,
                                        int causal, int window, int qo) {
  bool ok = qp < Sq && kp < Skv;
  if (causal) ok = ok && qo + qp >= kp;
  if (window) ok = ok && (qo + qp - kp) < window;
  return ok;
}

// ------------------------------------------------- bfloat16, tensor cores
constexpr int kRows = tc::kRows;  // keys or query rows a tile: 64
constexpr int kXFloats = 32 * 128;  // the hand-over: 32 values a thread

// acc[64 x 64] = A[64 x D] . B[64 x D]^T, both tiles K-major (TMA's
// layout of 64 rows of D): D/16 `wgmma` m64n64k16.
template <int D>
__device__ __forceinline__ void mma_ss(float* acc, uint32_t a_tile,
                                      uint32_t b_tile) {
  using C = tc::Cfg<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk * 16) / C::kBoxCols * C::kBoxBytes +
                         (kk * 16) % C::kBoxCols * 2;
    tc::wgmma_ss_n64(acc,
                     tc::sdesc(a_tile + off, 16, 8 * C::kRowBytes, C::kLayout),
                     tc::sdesc(b_tile + off, 16, 8 * C::kRowBytes, C::kLayout),
                     kk > 0);
  }
}

// acc[64 x D] += (hi + lo)[64 x 64] . B[64 x D]: the A fragments of 4
// k-steps of 16, B read MN-major from a tile of 64 rows of D.
template <int D>
__device__ __forceinline__ void mma_rs(float* acc, const uint32_t* hi,
                                      const uint32_t* lo, uint32_t b_tile) {
  using C = tc::Cfg<D>;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t db = tc::sdesc(b_tile + kk * 16 * C::kRowBytes,
                                  C::kBoxBytes, 8 * C::kRowBytes, C::kLayout);
    tc::wgmma_pv<D>(acc, hi + 4 * kk, db);
    tc::wgmma_pv<D>(acc, lo + 4 * kk, db);
  }
}

// A m64n64 float32 accumulator as the bf16 A fragments of 4 k-steps of
// 16 columns, each value split in hi = bf16(x) and lo = bf16(x - hi).
__device__ __forceinline__ void to_frags(const float* x, uint32_t* hi,
                                         uint32_t* lo) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int r = 4 * (j / 2) + 2 * (j % 2);
    tc::split2(x[4 * j], x[4 * j + 1], hi[r], lo[r]);
    tc::split2(x[4 * j + 2], x[4 * j + 3], hi[r + 1], lo[r + 1]);
  }
}

template <int D>
struct KvCfg {
  using C = tc::Cfg<D>;
  static constexpr int kStages = 2;  // Q/dO ring depth
  static constexpr int kKOff = 0;
  static constexpr int kVOff = C::kTileBytes;
  static constexpr int kQOff = 2 * C::kTileBytes;
  static constexpr int kDoOff = kQOff + kStages * C::kTileBytes;
  static constexpr int kXOff = kDoOff + kStages * C::kTileBytes;
  static constexpr int kBarOff = kXOff + kXFloats * 4;
  // + the barriers (K/V, full and empty per stage, hand-over full and
  // empty) + slack to align to 1 KB
  static constexpr size_t kBytes = kBarOff + 8 * (3 + 2 * kStages) + 1024;
  static_assert(kBytes <= kMaxSmem, "tiles exceed a block's shared memory");
};

template <int D>
struct QCfg {
  using C = tc::Cfg<D>;
  static constexpr int kKStages = 2;
  static constexpr int kVStages = D == 256 ? 1 : 2;
  static constexpr int kQOff = 0;  // both consumers' Q, then their dO
  static constexpr int kDoOff = tc::kConsumers * C::kTileBytes;
  static constexpr int kKOff = 2 * tc::kConsumers * C::kTileBytes;
  static constexpr int kVOff = kKOff + kKStages * C::kTileBytes;
  static constexpr int kBarOff = kVOff + kVStages * C::kTileBytes;
  // + the barriers (Q/dO, K full and empty, V full and empty) + slack
  static constexpr size_t kBytes =
      kBarOff + 8 * (1 + 2 * kKStages + 2 * kVStages) + 1024;
  static_assert(kBytes <= kMaxSmem, "tiles exceed a block's shared memory");
};

template <int D>
__global__ void __launch_bounds__(tc::kThreads, 1)
dkdv_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
               const __grid_constant__ CUtensorMap tm_k,
               const __grid_constant__ CUtensorMap tm_v,
               const __grid_constant__ CUtensorMap tm_do,
               const float* __restrict__ lse, const float* __restrict__ dvec,
               float* __restrict__ dk_part, float* __restrict__ dv_part,
               int Sq, int Skv, int H, int K, float scale, int causal,
               int window, int qo, float softcap) {
  using C = tc::Cfg<D>;
  using L = KvCfg<D>;
  constexpr int kStages = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sk = base + L::kKOff, sv = base + L::kVOff,
                 sq = base + L::kQOff, sdo = base + L::kDoOff;
  float* xbuf = reinterpret_cast<float*>(smem_raw + (base - raw) + L::kXOff);
  const uint32_t bar_kv = base + L::kBarOff, bar_full = bar_kv + 8,
                 bar_empty = bar_full + 8 * kStages,
                 bar_xfull = bar_empty + 8 * kStages, bar_xempty = bar_xfull + 8;

  const int h = blockIdx.x, b = blockIdx.z;
  const int G = H / K, kvh = h / G, g = h % G;
  const int k0 = blockIdx.y * kRows, k1 = min(k0 + kRows, Skv);
  // the query rows that may see any of these keys, in whole tiles (row r
  // at position qo + r)
  const int q_lo = causal ? max(0, k0 - qo) : 0;
  const int q_hi = window ? min(Sq, k1 - 1 + window - qo) : Sq;
  const int t_lo = q_lo / kRows;
  const int t_hi = q_lo < q_hi ? (q_hi + kRows - 1) / kRows : t_lo;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    tc::mbar_init(bar_kv, 1);
    for (int s = 0; s < kStages; ++s) {
      tc::mbar_init(bar_full + 8 * s, 1);
      tc::mbar_init(bar_empty + 8 * s, tc::kConsumers * 128);
    }
    tc::mbar_init(bar_xfull, 128);
    tc::mbar_init(bar_xempty, 128);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        tc::kProducerRegs));
    if (threadIdx.x == 0 && t_lo < t_hi) {
      tc::mbar_expect_tx(bar_kv, 2 * C::kTileBytes);
      for (int x = 0; x < C::kBoxes; ++x) {
        tc::tma_load(sk + x * C::kBoxBytes, &tm_k, bar_kv, x * C::kBoxCols,
                     kvh, k0, b);
        tc::tma_load(sv + x * C::kBoxBytes, &tm_v, bar_kv, x * C::kBoxCols,
                     kvh, k0, b);
      }
      for (int t = t_lo; t < t_hi; ++t) {
        const int i = t - t_lo, s = i % kStages;
        const uint32_t full = bar_full + 8 * s;
        tc::mbar_wait(bar_empty + 8 * s, ((i / kStages) & 1) ^ 1);
        tc::mbar_expect_tx(full, 2 * C::kTileBytes);
        for (int x = 0; x < C::kBoxes; ++x) {
          const uint32_t off = s * C::kTileBytes + x * C::kBoxBytes;
          tc::tma_load(sq + off, &tm_q, full, x * C::kBoxCols, h, t * kRows,
                       b);
          tc::tma_load(sdo + off, &tm_do, full, x * C::kBoxCols, h,
                       t * kRows, b);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup 1 owns dV of the block's 64 keys,
    // warpgroup 2 dK, each a 64 x D float32 accumulator in registers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        tc::kConsumerRegs));
    const bool owns_dv = wg == 1;
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int key = k0 + 16 * warp + lane / 4;  // and key + 8
    const int colq = 2 * (lane % 4);
    // per query row: lse for P (warpgroup 1), D for dS (warpgroup 2)
    const float* rowvec = (owns_dv ? lse : dvec) + ((size_t)b * H + h) * Sq;
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
    if (t_lo < t_hi) tc::mbar_wait(bar_kv, 0);

    for (int t = t_lo; t < t_hi; ++t) {
      const int i = t - t_lo, s = i % kStages;
      const int q0 = t * kRows;
      const uint32_t q_tile = sq + s * C::kTileBytes;
      const uint32_t do_tile = sdo + s * C::kTileBytes;
      float rv[16];  // the row values of this thread's 16 query columns
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qp = q0 + 8 * j + colq + e;
          rv[2 * j + e] = qp < Sq ? rowvec[qp] : 0.0f;
        }
      tc::mbar_wait(bar_full + 8 * s, (i / kStages) & 1);
      // S^T = K.Q^T (warpgroup 1) or dP^T = V.dO^T (warpgroup 2)
      float sc[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) sc[j] = 0.0f;
      tc::wg_fence();
      if (owns_dv)
        mma_ss<D>(sc, sk, q_tile);
      else
        mma_ss<D>(sc, sv, do_tile);
      tc::wg_commit();
      tc::wg_wait_all();
      tc::hold<32>(sc);

      if (owns_dv) {
        // P^T; P^T (1 - tanh^2) / sqrt(D) to warpgroup 2
        const bool cut = q0 + kRows > Sq || k0 + kRows > Skv ||
                         (causal && qo + q0 < k0 + kRows - 1) ||
                         (window && qo + q0 + kRows - 1 - k0 >= window);
        tc::mbar_wait(bar_xempty, (i & 1) ^ 1);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = sc[4 * j + e] * scale, dcap = 1.0f;
            if (softcap != 0.0f) {
              const float th = tanhf(x / softcap);
              x = th * softcap;
              dcap = 1.0f - th * th;
            }
            bool ok = true;
            if (cut)
              ok = visible(q0 + 8 * j + colq + (e & 1),
                           key + (e >= 2 ? 8 : 0), Sq, Skv, causal, window,
                           qo);
            const float p = ok ? expf(x - rv[2 * j + (e & 1)]) : 0.0f;
            sc[4 * j + e] = p;
            xbuf[(4 * j + e) * 128 + tid] = p * dcap * scale;
          }
        }
        tc::mbar_arrive(bar_xfull);
      } else {
        // dS^T = P^T (dP^T - D) (1 - tanh^2) / sqrt(D)
        tc::mbar_wait(bar_xfull, i & 1);
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sc[4 * j + e] = xbuf[(4 * j + e) * 128 + tid] *
                            (sc[4 * j + e] - rv[2 * j + (e & 1)]);
        tc::mbar_arrive(bar_xempty);
      }
      // dV += P^T.dO or dK += dS^T.Q, the A operand split in two parts
      uint32_t hi[16], lo[16];
      to_frags(sc, hi, lo);
      tc::wg_fence();
      mma_rs<D>(acc, hi, lo, owns_dv ? do_tile : q_tile);
      tc::wg_commit();
      tc::wg_wait_all();
      tc::hold<D / 2>(acc);
      tc::hold<16>(hi);
      tc::hold<16>(lo);
      tc::mbar_arrive(bar_empty + 8 * s);
    }

    // this head's share of dV or dK: (B, Skv, K, G, D) float32
    float* part = owns_dv ? dv_part : dk_part;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int kp = key + 8 * half;
      if (kp >= Skv) continue;
      float* dst =
          part + ((((size_t)b * Skv + kp) * K + kvh) * G + g) * D + colq;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<float2*>(dst + 8 * j) =
            make_float2(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
    }
  }
}

// out (rows, D) bf16 = the sum over g of part (rows, G, D), g in order.
__global__ void __launch_bounds__(256)
sum_splits_kernel(const float* __restrict__ part,
                  __nv_bfloat16* __restrict__ out, long long pairs, int G,
                  int D) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < pairs; i += stride) {
    const long long row = i / (D / 2);
    const int c = 2 * (int)(i % (D / 2));
    const float* src = part + row * G * D + c;
    float2 sum = *reinterpret_cast<const float2*>(src);
    for (int g = 1; g < G; ++g) {
      const float2 x = *reinterpret_cast<const float2*>(src + (size_t)g * D);
      sum.x += x.x;
      sum.y += x.y;
    }
    *reinterpret_cast<__nv_bfloat162*>(out + row * D + c) =
        __floats2bfloat162_rn(sum.x, sum.y);
  }
}

template <int D>
__global__ void __launch_bounds__(tc::kThreads, 1)
dq_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
             const __grid_constant__ CUtensorMap tm_k,
             const __grid_constant__ CUtensorMap tm_v,
             const __grid_constant__ CUtensorMap tm_do,
             const float* __restrict__ lse, const float* __restrict__ dvec,
             __nv_bfloat16* __restrict__ dq, int Sq, int Skv, int H, int K,
             float scale, int causal, int window, int qo, float softcap) {
  using C = tc::Cfg<D>;
  using L = QCfg<D>;
  constexpr int kKS = L::kKStages, kVS = L::kVStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base =
      ((uint32_t)__cvta_generic_to_shared(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base + L::kQOff, sdo = base + L::kDoOff,
                 sk = base + L::kKOff, sv = base + L::kVOff;
  const uint32_t bar_q = base + L::kBarOff, k_full = bar_q + 8,
                 k_empty = k_full + 8 * kKS, v_full = k_empty + 8 * kKS,
                 v_empty = v_full + 8 * kVS;

  const int h = blockIdx.x, b = blockIdx.z;
  const int kvh = h / (H / K);
  const int q0 = blockIdx.y * (tc::kConsumers * kRows);
  const int q1 = min(q0 + tc::kConsumers * kRows, Sq);
  // the band of keys any row of this block may see, in whole tiles (row
  // r at position qo + r)
  const int kv_lo = window ? max(0, qo + q0 - window + 1) : 0;
  const int kv_hi = causal ? min(qo + q1, Skv) : Skv;
  const int t_lo = kv_lo / kRows;
  const int t_hi = max(t_lo, (kv_hi + kRows - 1) / kRows);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    tc::mbar_init(bar_q, 1);
    for (int s = 0; s < kKS; ++s) {
      tc::mbar_init(k_full + 8 * s, 1);
      tc::mbar_init(k_empty + 8 * s, tc::kConsumers * 128);
    }
    for (int s = 0; s < kVS; ++s) {
      tc::mbar_init(v_full + 8 * s, 1);
      tc::mbar_init(v_empty + 8 * s, tc::kConsumers * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        tc::kProducerRegs));
    if (threadIdx.x == 0) {
      int q_rows = 0;  // consumers with rows inside Sq
      for (int c = 0; c < tc::kConsumers; ++c) q_rows += q0 + c * kRows < Sq;
      tc::mbar_expect_tx(bar_q, 2 * q_rows * C::kTileBytes);
      for (int c = 0; c < q_rows; ++c)
        for (int x = 0; x < C::kBoxes; ++x) {
          const uint32_t off = c * C::kTileBytes + x * C::kBoxBytes;
          tc::tma_load(sq + off, &tm_q, bar_q, x * C::kBoxCols, h,
                       q0 + c * kRows, b);
          tc::tma_load(sdo + off, &tm_do, bar_q, x * C::kBoxCols, h,
                       q0 + c * kRows, b);
        }
      for (int t = t_lo; t < t_hi; ++t) {
        const int i = t - t_lo, ks = i % kKS, vs = i % kVS;
        tc::mbar_wait(k_empty + 8 * ks, ((i / kKS) & 1) ^ 1);
        tc::mbar_expect_tx(k_full + 8 * ks, C::kTileBytes);
        for (int x = 0; x < C::kBoxes; ++x)
          tc::tma_load(sk + ks * C::kTileBytes + x * C::kBoxBytes, &tm_k,
                       k_full + 8 * ks, x * C::kBoxCols, kvh, t * kRows, b);
        tc::mbar_wait(v_empty + 8 * vs, ((i / kVS) & 1) ^ 1);
        tc::mbar_expect_tx(v_full + 8 * vs, C::kTileBytes);
        for (int x = 0; x < C::kBoxes; ++x)
          tc::tma_load(sv + vs * C::kTileBytes + x * C::kBoxBytes, &tm_v,
                       v_full + 8 * vs, x * C::kBoxCols, kvh, t * kRows, b);
      }
    }
  } else {
    // ---- consumer: 64 query rows, dQ in registers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        tc::kConsumerRegs));
    const int cw = wg - 1;
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int r0 = q0 + cw * kRows;
    const int row = r0 + 16 * warp + lane / 4;  // and row + 8
    const int colq = 2 * (lane % 4);
    // the tiles this consumer's rows may see
    int c_lo = t_hi, c_hi = t_hi;
    if (r0 < Sq) {
      const int lo = window ? max(0, qo + r0 - window + 1) : 0;
      const int hi = causal ? min(qo + min(r0 + kRows, Sq), Skv) : Skv;
      c_lo = max(t_lo, lo / kRows);
      c_hi = min(t_hi, (hi + kRows - 1) / kRows);
    }
    const size_t rows = ((size_t)b * H + h) * Sq;
    const float lse0 = row < Sq ? lse[rows + row] : 0.0f;
    const float lse1 = row + 8 < Sq ? lse[rows + row + 8] : 0.0f;
    const float dv0 = row < Sq ? dvec[rows + row] : 0.0f;
    const float dv1 = row + 8 < Sq ? dvec[rows + row + 8] : 0.0f;
    const uint32_t q_tile = sq + cw * C::kTileBytes;
    const uint32_t do_tile = sdo + cw * C::kTileBytes;
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
    if (r0 < Sq) tc::mbar_wait(bar_q, 0);

    for (int t = t_lo; t < t_hi; ++t) {
      const int i = t - t_lo, ks = i % kKS, vs = i % kVS;
      const uint32_t k_tile = sk + ks * C::kTileBytes;
      const uint32_t v_tile = sv + vs * C::kTileBytes;
      const bool own = t >= c_lo && t < c_hi;
      tc::mbar_wait(k_full + 8 * ks, (i / kKS) & 1);
      tc::mbar_wait(v_full + 8 * vs, (i / kVS) & 1);
      float sc[32], dp[32];
      if (own) {
#pragma unroll
        for (int j = 0; j < 32; ++j) sc[j] = dp[j] = 0.0f;
        tc::wg_fence();
        mma_ss<D>(sc, q_tile, k_tile);   // S = Q.K^T
        mma_ss<D>(dp, do_tile, v_tile);  // dP = dO.V^T
        tc::wg_commit();
        tc::wg_wait_all();
        tc::hold<32>(sc);
        tc::hold<32>(dp);
      }
      tc::mbar_arrive(v_empty + 8 * vs);
      if (own) {
        const int k0 = t * kRows;
        const bool cut = k0 + kRows > Skv ||
                         (causal && k0 + kRows - 1 > qo + r0) ||
                         (window && qo + r0 + kRows - 1 - k0 >= window);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = sc[4 * j + e] * scale, dcap = 1.0f;
            if (softcap != 0.0f) {
              const float th = tanhf(x / softcap);
              x = th * softcap;
              dcap = 1.0f - th * th;
            }
            bool ok = true;
            if (cut)
              ok = visible(row + (e >= 2 ? 8 : 0), k0 + 8 * j + colq + (e & 1),
                           Sq, Skv, causal, window, qo);
            const float p = ok ? expf(x - (e >= 2 ? lse1 : lse0)) : 0.0f;
            dp[4 * j + e] =
                p * (dp[4 * j + e] - (e >= 2 ? dv1 : dv0)) * dcap * scale;
          }
        }
        // dQ += dS.K, dS split in two parts, K read MN-major
        uint32_t hi[16], lo[16];
        to_frags(dp, hi, lo);
        tc::wg_fence();
        mma_rs<D>(acc, hi, lo, k_tile);
        tc::wg_commit();
        tc::wg_wait_all();
        tc::hold<D / 2>(acc);
        tc::hold<16>(hi);
        tc::hold<16>(lo);
      }
      tc::mbar_arrive(k_empty + 8 * ks);
    }

#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int qp = row + 8 * half;
      if (qp >= Sq) continue;
      __nv_bfloat16* dst = dq + (((size_t)b * Sq + qp) * H + h) * D + colq;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
            __floats2bfloat162_rn(acc[4 * j + 2 * half],
                                  acc[4 * j + 2 * half + 1]);
    }
  }
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, const void* o,
              const void* dout, const float* lse, float* dvec, float* part,
              void* dq, void* dk, void* dv, int B, int Sq, int Skv, int H,
              int K, int causal, int window, int qo, float softcap,
              float scale, cudaStream_t stream) {
  if (part == nullptr) return (int)cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv, mdo;
  if (!tc::make_map<D>(&mq, q, B, Sq, H) ||
      !tc::make_map<D>(&mk, k, B, Skv, K) ||
      !tc::make_map<D>(&mv, v, B, Skv, K) ||
      !tc::make_map<D>(&mdo, dout, B, Sq, H))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      dkdv_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)KvCfg<D>::kBytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dq_tc_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)QCfg<D>::kBytes);
  if (err != cudaSuccess) return (int)err;
  const long long rows = (long long)B * Sq * H;
  dot_kernel<__nv_bfloat16><<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(
      (const __nv_bfloat16*)o, (const __nv_bfloat16*)dout, dvec, rows, Sq, H,
      D);
  const size_t n_part = (size_t)B * Skv * H * D;
  dkdv_tc_kernel<D><<<dim3(H, (Skv + kRows - 1) / kRows, B), tc::kThreads,
                      KvCfg<D>::kBytes, stream>>>(
      mq, mk, mv, mdo, lse, dvec, part, part + n_part, Sq, Skv, H, K, scale,
      causal, window, qo, softcap);
  const long long pairs = (long long)B * Skv * K * D / 2;
  const long long want = (pairs + 255) / 256;
  const unsigned blocks = (unsigned)(want < 132 * 16 ? want : 132 * 16);
  sum_splits_kernel<<<blocks, 256, 0, stream>>>(
      part, (__nv_bfloat16*)dk, pairs, H / K, D);
  sum_splits_kernel<<<blocks, 256, 0, stream>>>(
      part + n_part, (__nv_bfloat16*)dv, pairs, H / K, D);
  dq_tc_kernel<D><<<dim3(H, (Sq + tc::kConsumers * kRows - 1) /
                                (tc::kConsumers * kRows), B),
                    tc::kThreads, QCfg<D>::kBytes, stream>>>(
      mq, mk, mv, mdo, lse, dvec, (__nv_bfloat16*)dq, Sq, Skv, H, K, scale,
      causal, window, qo, softcap);
  return (int)cudaGetLastError();
}

// ------------------------------------------------- float32, CUDA cores
constexpr int kB = 32;         // query rows or keys a tile
constexpr int kThreads = 256;  // 16 row pairs x 16 column lanes

template <int D>
struct Smem {
  static constexpr int kStride = D + 1;               // padded tile rows
  static constexpr int kTile = kB * kStride;          // floats a D-wide tile
  static constexpr int kScore = kB * (kB + 1);        // floats a score tile
  // Q, dO, K, V tiles, P and dS, lse and D of the query rows
  static constexpr size_t kBytes =
      (4 * (size_t)kTile + 2 * kScore + 2 * kB) * sizeof(float);
  static_assert(kBytes <= kMaxSmem, "tiles exceed a block's shared memory");
};

// Rows [row0, row0 + kB) of head `head` of x (B, S, nh, D) into a padded
// tile; rows past S are zeros.
template <int D>
__device__ __forceinline__ void load_rows(float* dst,
                                          const float* __restrict__ x, int b,
                                          int row0, int S, int nh, int head) {
  for (int i = threadIdx.x; i < kB * D; i += kThreads) {
    const int r = i / D, c = i % D;
    const int s = row0 + r;
    dst[r * Smem<D>::kStride + c] =
        s < S ? x[(((size_t)b * S + s) * nh + head) * D + c] : 0.0f;
  }
}

// For the query tile at q0 and the key tile at k0 (both in shared
// memory): P (when ps is given) and dS, each [query row][key], from
// S = Q.K^T and dP = dO.V^T.
template <int D>
__device__ __forceinline__ void grad_scores(
    float* ps, float* dss, const float* qs, const float* dos,
    const float* ks, const float* vs, const float* lse_s, const float* d_s,
    int q0, int k0, int Sq, int Skv, float scale, int causal, int window,
    int qo, float softcap) {
  constexpr int S = Smem<D>::kStride;
  const int r0 = 2 * (threadIdx.x / 16), c0 = threadIdx.x % 16;
  float s[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
  float dp[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    const float q0v = qs[r0 * S + d], q1v = qs[(r0 + 1) * S + d];
    const float g0v = dos[r0 * S + d], g1v = dos[(r0 + 1) * S + d];
    const float k0v = ks[c0 * S + d], k1v = ks[(c0 + 16) * S + d];
    const float v0v = vs[c0 * S + d], v1v = vs[(c0 + 16) * S + d];
    s[0][0] = fmaf(q0v, k0v, s[0][0]);
    s[0][1] = fmaf(q0v, k1v, s[0][1]);
    s[1][0] = fmaf(q1v, k0v, s[1][0]);
    s[1][1] = fmaf(q1v, k1v, s[1][1]);
    dp[0][0] = fmaf(g0v, v0v, dp[0][0]);
    dp[0][1] = fmaf(g0v, v1v, dp[0][1]);
    dp[1][0] = fmaf(g1v, v0v, dp[1][0]);
    dp[1][1] = fmaf(g1v, v1v, dp[1][1]);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + i;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = c0 + 16 * j;
      float x = s[i][j] * scale, dcap = 1.0f;
      if (softcap != 0.0f) {
        const float t = tanhf(x / softcap);
        x = t * softcap;
        dcap = 1.0f - t * t;
      }
      const float p = visible(q0 + r, k0 + c, Sq, Skv, causal, window, qo)
                          ? expf(x - lse_s[r])
                          : 0.0f;
      if (ps != nullptr) ps[r * (kB + 1) + c] = p;
      dss[r * (kB + 1) + c] = p * (dp[i][j] - d_s[r]) * dcap * scale;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ dvec,
            float* __restrict__ dk, float* __restrict__ dv, int Sq, int Skv, int H,
            int K, float scale, int causal, int window, int qo, float softcap) {
  using L = Smem<D>;
  constexpr int kCols = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + L::kTile;
  float* ks = dos + L::kTile;
  float* vs = ks + L::kTile;
  float* ps = vs + L::kTile;
  float* dss = ps + L::kScore;
  float* lse_s = dss + L::kScore;
  float* d_s = lse_s + kB;

  const int kvh = blockIdx.y, b = blockIdx.z;
  const int k0 = blockIdx.x * kB, k1 = min(k0 + kB, Skv);
  const int G = H / K;
  const int r0 = 2 * (threadIdx.x / 16), c0 = threadIdx.x % 16;
  // the query rows that may see any of these keys, in whole tiles (row r
  // at position qo + r)
  const int q_lo = causal ? max(0, k0 - qo) : 0;
  const int q_hi = window ? min(Sq, k1 - 1 + window - qo) : Sq;
  const int t_lo = q_lo / kB, t_hi = q_lo < q_hi ? (q_hi + kB - 1) / kB : 0;

  load_rows<D>(ks, k, b, k0, Skv, K, kvh);
  load_rows<D>(vs, v, b, k0, Skv, K, kvh);
  float dk_acc[2][kCols], dv_acc[2][kCols];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.0f;

  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    for (int t = t_lo; t < t_hi; ++t) {
      const int q0 = t * kB;
      __syncthreads();  // the last tile's readers are done
      load_rows<D>(qs, q, b, q0, Sq, H, h);
      load_rows<D>(dos, dout, b, q0, Sq, H, h);
      if (threadIdx.x < kB) {
        const int qp = q0 + threadIdx.x;
        const size_t idx = ((size_t)b * H + h) * Sq + qp;
        lse_s[threadIdx.x] = qp < Sq ? lse[idx] : 0.0f;
        d_s[threadIdx.x] = qp < Sq ? dvec[idx] : 0.0f;
      }
      __syncthreads();
      grad_scores<D>(ps, dss, qs, dos, ks, vs, lse_s, d_s, q0, k0, Sq, Skv,
                     scale, causal, window, qo, softcap);
      __syncthreads();
      // dV[key] += sum_q P[q][key] dO[q];  dK[key] += sum_q dS[q][key] Q[q]
#pragma unroll 4
      for (int j = 0; j < kB; ++j) {
        const float p0 = ps[j * (kB + 1) + r0], p1 = ps[j * (kB + 1) + r0 + 1];
        const float s0 = dss[j * (kB + 1) + r0],
                    s1 = dss[j * (kB + 1) + r0 + 1];
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const float gv = dos[j * L::kStride + c0 + 16 * c];
          const float qv = qs[j * L::kStride + c0 + 16 * c];
          dv_acc[0][c] = fmaf(p0, gv, dv_acc[0][c]);
          dv_acc[1][c] = fmaf(p1, gv, dv_acc[1][c]);
          dk_acc[0][c] = fmaf(s0, qv, dk_acc[0][c]);
          dk_acc[1][c] = fmaf(s1, qv, dk_acc[1][c]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kp = k0 + r0 + i;
    if (kp >= Skv) continue;
    const size_t base = (((size_t)b * Skv + kp) * K + kvh) * D + c0;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      dk[base + 16 * c] = dk_acc[i][c];
      dv[base + 16 * c] = dv_acc[i][c];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ dvec,
          float* __restrict__ dq, int Sq, int Skv, int H, int K, float scale,
          int causal, int window, int qo, float softcap) {
  using L = Smem<D>;
  constexpr int kCols = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + L::kTile;
  float* ks = dos + L::kTile;
  float* vs = ks + L::kTile;
  float* dss = vs + L::kTile;
  float* lse_s = dss + 2 * L::kScore;
  float* d_s = lse_s + kB;

  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / K);
  const int q0 = blockIdx.x * kB, q1 = min(q0 + kB, Sq);
  const int r0 = 2 * (threadIdx.x / 16), c0 = threadIdx.x % 16;
  // the band of keys any row of this tile may see, in whole tiles (row r
  // at position qo + r)
  const int kv_lo = window ? max(0, qo + q0 - window + 1) : 0;
  const int kv_hi = causal ? min(qo + q1, Skv) : Skv;
  const int t_lo = kv_lo / kB;
  const int t_hi = kv_lo < kv_hi ? (kv_hi + kB - 1) / kB : 0;

  load_rows<D>(qs, q, b, q0, Sq, H, h);
  load_rows<D>(dos, dout, b, q0, Sq, H, h);
  if (threadIdx.x < kB) {
    const int qp = q0 + threadIdx.x;
    const size_t idx = ((size_t)b * H + h) * Sq + qp;
    lse_s[threadIdx.x] = qp < Sq ? lse[idx] : 0.0f;
    d_s[threadIdx.x] = qp < Sq ? dvec[idx] : 0.0f;
  }
  float acc[2][kCols];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.0f;

  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * kB;
    __syncthreads();  // the last tile's readers are done
    load_rows<D>(ks, k, b, k0, Skv, K, kvh);
    load_rows<D>(vs, v, b, k0, Skv, K, kvh);
    __syncthreads();
    grad_scores<D>(nullptr, dss, qs, dos, ks, vs, lse_s, d_s, q0, k0, Sq,
                   Skv, scale, causal, window, qo, softcap);
    __syncthreads();
    // dQ[q] += sum_key dS[q][key] K[key]
#pragma unroll 4
    for (int j = 0; j < kB; ++j) {
      const float s0 = dss[r0 * (kB + 1) + j], s1 = dss[(r0 + 1) * (kB + 1) + j];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float kv = ks[j * L::kStride + c0 + 16 * c];
        acc[0][c] = fmaf(s0, kv, acc[0][c]);
        acc[1][c] = fmaf(s1, kv, acc[1][c]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qp = q0 + r0 + i;
    if (qp >= Sq) continue;
    const size_t base = (((size_t)b * Sq + qp) * H + h) * D + c0;
#pragma unroll
    for (int c = 0; c < kCols; ++c) dq[base + 16 * c] = acc[i][c];
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* dvec, void* dq,
           void* dk, void* dv, int B, int Sq, int Skv, int H, int K,
           int causal, int window, int qo, float softcap, float scale,
           cudaStream_t stream) {
  constexpr size_t smem = Smem<D>::kBytes;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        dkdv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(dq_kernel<D>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long rows = (long long)B * Sq * H;
  dot_kernel<float><<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(
      (const float*)o, (const float*)dout, dvec, rows, Sq, H, D);
  dkdv_kernel<D><<<dim3((Skv + kB - 1) / kB, K, B), kThreads, smem,
                      stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout, lse, dvec,
      (float*)dk, (float*)dv, Sq, Skv, H, K, scale, causal, window, qo,
      softcap);
  dq_kernel<D><<<dim3((Sq + kB - 1) / kB, H, B), kThreads, smem,
                    stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout, lse, dvec,
      (float*)dq, Sq, Skv, H, K, scale, causal, window, qo, softcap);
  return (int)cudaGetLastError();
}

// Both types: the tensor-core kernels for bfloat16, the CUDA-core ones
// for float32.
template <int D>
int launch_any(int bf16, const void* q, const void* k, const void* v,
               const void* o, const void* dout, const float* lse, float* dvec,
               float* part, void* dq, void* dk, void* dv, int B, int Sq,
               int Skv, int H, int K, int causal, int window, int qo,
               float softcap, float scale, cudaStream_t stream) {
  if (bf16)
    return launch_tc<D>(q, k, v, o, dout, lse, dvec, part, dq, dk, dv, B, Sq,
                        Skv, H, K, causal, window, qo, softcap, scale, stream);
  return launch<D>(q, k, v, o, dout, lse, dvec, dq, dk, dv, B, Sq, Skv, H, K,
                   causal, window, qo, softcap, scale, stream);
}

int launch_d(int bf16, const void* q, const void* k, const void* v,
             const void* o, const void* dout, const float* lse, float* dvec,
             float* part, void* dq, void* dk, void* dv, int B, int Sq,
             int Skv, int H, int K, int D, int causal, int window, int qo,
             float softcap, float scale, cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch_any<16>(bf16, q, k, v, o, dout, lse, dvec, part, dq, dk,
                            dv, B, Sq, Skv, H, K, causal, window, qo, softcap,
                            scale, stream);
    case 64:
      return launch_any<64>(bf16, q, k, v, o, dout, lse, dvec, part, dq, dk,
                            dv, B, Sq, Skv, H, K, causal, window, qo, softcap,
                            scale, stream);
    case 128:
      return launch_any<128>(bf16, q, k, v, o, dout, lse, dvec, part, dq, dk,
                             dv, B, Sq, Skv, H, K, causal, window, qo, softcap,
                             scale, stream);
    case 256:
      return launch_any<256>(bf16, q, k, v, o, dout, lse, dvec, part, dq, dk,
                             dv, B, Sq, Skv, H, K, causal, window, qo, softcap,
                             scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace bwd

}  // namespace

// q, o: (B, Sq, H, D); k, v: (B, Skv, K, D); contiguous, on one device, all
// float32 (dtype 0, the CUDA-core kernel) or all bfloat16 (dtype 1, the
// tensor-core kernel); K divides H; D one of 16, 64, 128, 256; window 0
// means none, softcap 0 means none; q_offset >= 0 is the position of query
// row 0 (key j sits at j; 0 for a whole sequence, a shard's first position
// for a shard of its queries); scale multiplies every score before
// the softcap (1/sqrt(D) for plain attention; a caller whose head is
// zero-padded to D passes that of its own width).  lse, when not null:
// (B, H, Sq) float32, the row log-sum-exp m + log(max(l, 1e-30)) of the
// scores the softmax normalised.  Launches on `stream` and returns the
// cudaError_t of the launch.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, float* lse,
                                      int B, int Sq, int Skv, int H, int K,
                                      int D, int dtype, int causal,
                                      int window, int q_offset, float softcap,
                                      float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || K <= 0 || H % K != 0 || window < 0 ||
      q_offset < 0)
    return (int)cudaErrorInvalidValue;
  if (B > 65535 || (Sq + f32::kBQ - 1) / f32::kBQ > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_d<false>(q, k, v, o, lse, B, Sq, Skv, H, K, D, causal,
                           window, q_offset, softcap, scale, s);
  if (dtype == 1)
    return launch_d<true>(q, k, v, o, lse, B, Sq, Skv, H, K, D, causal,
                          window, q_offset, softcap, scale, s);
  return (int)cudaErrorInvalidValue;
}

// The gradient of flash_attention_launch's output: dq (B, Sq, H, D), dk
// and dv (B, Skv, K, D) from q, k, v, the forward's o and lse, and dout,
// the gradient of o; dvec: (B, H, Sq) float32 scratch (D = rowsum(dO * O));
// part: for bfloat16, (2, B, Skv, H, D) float32 scratch (each query head's
// share of dk, then of dv), null for float32.  Types, shapes and options as
// flash_attention_launch's: dtype 1 (bfloat16) runs on the tensor cores
// (four kernels: D, dk/dv partials, their sum over the heads of a KV head,
// dq), dtype 0 (float32) on the CUDA cores (three: D, dk/dv, dq).
// Launches on `stream` and returns the cudaError_t of the launches.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* dvec, float* part, void* dq,
    void* dk, void* dv, int B, int Sq, int Skv, int H, int K, int D,
    int dtype, int causal, int window, int q_offset, float softcap,
    float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || K <= 0 || H % K != 0 || window < 0 ||
      q_offset < 0)
    return (int)cudaErrorInvalidValue;
  if (B > 65535 || H > 65535) return (int)cudaErrorInvalidValue;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  return bwd::launch_d(dtype, q, k, v, o, dout, lse, dvec, part, dq, dk, dv,
                       B, Sq, Skv, H, K, D, causal, window, q_offset, softcap,
                       scale, (cudaStream_t)stream);
}
