// gp_ei: batched expected improvement over per-lane GP posteriors on
// Hopper (sm_90a), the candidates of a tile solved together as the columns
// of one blocked triangular solve with many right-hand sides.
//
// Replaces: src/repro/kernels/gp.py : gp_ei / _ei_kernel, the Pallas TPU
// kernel (which solves all candidates of a lane at once, as a matrix
// right-hand side, in _fwd_solve).
//
// What bounds it on this card: per lane the work is the forward
// substitution V = L^-1 kq^T over the m candidates (m b^2 FLOPs), the
// b x m Matern block kq (m b (3d + 10) FLOPs) and the closed form; the
// bytes (chol, x, cand, ei) are microseconds at 3.35 TB/s, and the
// operations at the 67 TFLOP/s float32 peak are 5 us at the main path's
// k = 1, b = 512, m = 1280.  What bounds it in practice is latency: the
// substitution is a chain of b / 32 panels, each waiting on the one
// before through block barriers, and at that shape an SM holds one or two
// blocks, two to four warps a scheduler, too few to hide the latencies of
// shared memory and shuffles inside a panel.  Float32 on the CUDA cores, not TF32 on the tensor
// cores: TF32's 10-bit mantissa cannot hold V at the condition numbers
// the GP reaches (~1e6), where the float32 paths already differ by 1e-4.
//
// What the design does about it:
// - One block of 8 warps per (tile of kTC = 8 candidates, lane): at k = 1,
//   m = 1280 that is 160 blocks, more than the 132 SMs, where one thread
//   a candidate gave 40 warps.  kTC = 8 is the widest tile that still
//   gives every SM a block at that shape.
// - kq once: each thread builds whole rows of the tile's b x kTC block of
//   kq from the scaled candidates (exp(log_ls) and cand / ls once a
//   block, in shared memory), each x row scaled once, into the tile's V
//   buffer (kq's columns are overwritten by V's as panels are solved); mu
//   is a block reduction, summed at the end.
// - Panels of 32 rows, left-looking.  Panel p first subtracts
//   L[p, :p] V[:p, tile], a 32 x 8 product with a long inner dimension.
//   Warp w owns rows 4w .. 4w + 3 of the panel, so a warp's L is 4
//   contiguous rows, and lane l takes the inner indices k = l mod 32: per
//   k one value of L for each of the 4 rows and one of V for each of the
//   8 candidates, 12 shared-memory loads for 32 multiply-adds into a 4 x 8
//   register tile (with one output a lane, each multiply-add would read
//   two values and shared memory would bound the update).
//   At the end of the panel the 32 partial sums of each output meet in a
//   reduce-scatter over the lanes (31 shuffles), which leaves output j in
//   lane j.  The warp streams its rows in chunks of 4 rows x 64 columns,
//   two 16-byte cp.async a lane (eight 128-byte lines), through its own
//   4-deep ring in shared memory, issued ahead across panel boundaries (L
//   does not depend on V), so it needs only __syncwarp and no block
//   barrier per chunk.  L is 1 MB a lane at b = 512 and stays
//   L2-resident.
// - The diagonal blocks: substituting row by row would put a chain of b
//   dependent steps (a shuffle, a multiply and a multiply-add each) on
//   the panels' critical path.  So a first, small
//   kernel inverts every 32 x 32 diagonal block of every lane once (one
//   warp a block, a lane a column), into scratch, and a panel's last chunk
//   is the warp's rows of L_pp^-1.  Then V_p = L_pp^-1 (kq_p - update) is
//   a 32-term dot product a lane, one candidate a warp.  The inverse's
//   error is bounded by cond(L_pp) <= sqrt(32 amp^2 / noise^2): the
//   diagonal block of a Cholesky factor is conditioned by one 32-point
//   block of the covariance, not by the whole.  sum V^2 accumulates as the
//   panels go.  Two block barriers a panel.
// - V's tile is b x kTC floats: in shared memory through b = 5984 at d = 3
//   (64 KB at b = 2048).  Past that the same code keeps V in the global
//   scratch (gp_ei_scratch_floats), one slice a block.
// - Buckets of one panel (b <= 32, the smallest buckets): there is no
//   update to split, and a block of 8 warps a tile with its 34 KB ring,
//   and the inverses' launch before it, cost more than the solve itself.
//   So small_kernel solves them in one launch, one thread a candidate,
//   substituting row by row against L in shared memory: a chain of at
//   most 32 rows, kq and V in registers.
// - Ragged edges: rows and columns past b are zero-filled by cp.async, and
//   the inverse treats rows past b as identity, so they solve to 0; the
//   last tile's missing candidates repeat the last one and are not
//   written; a bucket whose rows are not 16-byte aligned (b not a multiple
//   of 4) stages L with 4-byte copies.
// One wrapper call launches one kernel (small_kernel) for b <= 32, and two
// past it: the diagonal inverses, then EI.

#include <cuda_runtime.h>
#include <math.h>

#include <cstdint>

namespace {

constexpr int kTC = 8;          // candidates (columns of V) a block
constexpr int kWarps = 8;       // each owns 4 rows of a panel
constexpr int kThreads = 32 * kWarps;
constexpr int kPanel = 32;      // rows of L a panel
constexpr int kRows = kPanel / kWarps;  // rows a warp owns
constexpr int kStages = 4;      // chunks of L in flight per warp
constexpr int kChunkCols = 2 * kPanel;  // columns of L a chunk
constexpr int kChunkStride = kChunkCols + 4;  // a staged row, padded
constexpr int kChunkFloats = kRows * kChunkStride;  // 4 rows x 64 columns
constexpr int kRingFloats = kWarps * kStages * kChunkFloats;  // 34 KB
constexpr int kDiagStride = kPanel + 1;
constexpr int kDiagFloats = kPanel * kDiagStride;
constexpr int kRhsStride = kPanel + 4;
constexpr int kRhsFloats = kTC * kRhsStride;
constexpr size_t kMaxSmem = 227 * 1024;

__host__ __device__ inline int padded_rows(int b) {
  return (b + kPanel - 1) / kPanel * kPanel;
}
// a candidate's V column, padded so that columns start on distinct banks
__host__ __device__ inline int v_stride(int b) { return padded_rows(b) + 4; }
__host__ __device__ inline int fixed_floats(int d) {
  // ring, L_pp^-1, the panel's updated right-hand sides, ls (d), the
  // candidates raw and scaled (kTC d each), |cand|^2 (kTC), each warp's
  // partial mu (kWarps kTC)
  return (kRingFloats + kDiagFloats + kRhsFloats + d + 2 * kTC * d + kTC +
          kWarps * kTC + 3) / 4 * 4;
}
size_t smem_bytes(int b, int d, bool v_global) {
  return sizeof(float) *
         ((size_t)fixed_floats(d) + (v_global ? 0 : (size_t)kTC * v_stride(b)));
}
// floats of the scratch's inverses: k lanes x P blocks of 32 x 32
size_t inv_floats(int k, int b) { return (size_t)k * padded_rows(b) * kPanel; }

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
// 16 bytes global -> shared, zero-filled when !valid (src not read)
__device__ __forceinline__ void cp16(float* dst, const float* src,
                                     bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp4(float* dst, const float* src,
                                    bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// L_pp^-1 of diagonal block p of lane blockIdx.y, one warp: lane j solves
// L_pp x = e_j column by column (division by the pivot, as substitution
// does).  Rows past b are identity.  linv: (k, P, 32, 32) row-major.
__global__ void __launch_bounds__(32)
inv_kernel(const float* __restrict__ chol, float* __restrict__ linv, int b) {
  __shared__ float Ls[kPanel][kDiagStride];
  const int p = blockIdx.x, lane_k = blockIdx.y, l = threadIdx.x;
  const int r0 = p * kPanel;
  const float* Ll = chol + (size_t)lane_k * b * b;
#pragma unroll 4
  for (int i = 0; i < kPanel; ++i) {
    const int gr = r0 + i, gc = r0 + l;
    Ls[i][l] = gr < b ? (gc < b ? __ldg(Ll + (size_t)gr * b + gc) : 0.0f)
                      : (i == l ? 1.0f : 0.0f);
  }
  __syncwarp();
  float s[kPanel];
#pragma unroll
  for (int i = 0; i < kPanel; ++i) s[i] = i == l ? 1.0f : 0.0f;
#pragma unroll
  for (int t = 0; t < kPanel; ++t) {
    s[t] = s[t] / Ls[t][t];
#pragma unroll
    for (int i = t + 1; i < kPanel; ++i) s[i] = fmaf(-Ls[i][t], s[t], s[i]);
  }
  float* out = linv + ((size_t)lane_k * gridDim.x + p) * kPanel * kPanel + l;
#pragma unroll
  for (int i = 0; i < kPanel; ++i) out[i * kPanel] = s[i];
}

// The L chunks of panel p: ceil(p / 2) of 64 columns cover its update's
// 32p; the chunk after them is the diagonal block's inverse.
__device__ __forceinline__ int l_chunks(int p) { return (p + 1) >> 1; }

// Stage chunk (p, u) of warp w, its rows 32p + 4w .. + 3, into a ring
// slot (4 rows of kChunkStride floats): for u < l_chunks(p) columns
// 64u .. 64u + 63 of L, two 16-byte pieces a lane, zero-filled past b and
// past the update's 32p columns; for u == l_chunks(p) the same rows of
// L_pp^-1, one piece a lane.
template <bool kAligned>
__device__ __forceinline__ void stage_chunk(float* slot, const float* Ll,
                                            const float* Il, int b, int p,
                                            int u, int w, int l) {
  if (u == l_chunks(p)) {
    const int row = l >> 3, col = 4 * (l & 7);
    cp16(slot + row * kChunkStride + col,
         Il + ((size_t)p * kPanel + kRows * w + row) * kPanel + col, true);
    return;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int pc = l + 32 * h, row = pc >> 4, col = 4 * (pc & 15);
    const int gr = p * kPanel + kRows * w + row, gc = u * kChunkCols + col;
    const bool valid = gr < b && gc < p * kPanel;  // covers gc + 3 too
    float* dst = slot + row * kChunkStride + col;
    if (kAligned) {
      cp16(dst, Ll + (valid ? (size_t)gr * b + gc : 0), valid);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        cp4(dst + e, Ll + (valid ? (size_t)gr * b + gc + e : 0), valid);
    }
  }
}

// One step of a reduce-scatter over the lanes: lanes whose bit H is set
// keep the upper H of their 2H partial sums, the others the lower H, each
// adding its partner's (lane ^ H) sums of the half it keeps.  After the
// steps 16, 8, 4, 2, 1 lane j holds the whole sum of value j.  H is a
// template argument so every index is a constant and a stays in registers.
template <int H>
__device__ __forceinline__ void rs_step(float (&a)[kRows * kTC], bool upper) {
#pragma unroll
  for (int t = 0; t < H; ++t) {
    const float keep = upper ? a[t + H] : a[t];
    const float send = upper ? a[t] : a[t + H];
    a[t] = keep + __shfl_xor_sync(0xffffffffu, send, H);
  }
}

// The chunk after (p, u) in every warp's sequence: (p, 0 .. l_chunks(p))
// for p = 0 .. P-1.  False past the end.
__device__ __forceinline__ bool next_chunk(int& p, int& u, int P) {
  if (++u > l_chunks(p)) {
    ++p;
    u = 0;
  }
  return p < P;
}

template <bool kAligned, bool kVGlobal>
__global__ void __launch_bounds__(kThreads, 2)
ei_kernel(const float* __restrict__ log_ls, const float* __restrict__ log_amp,
          const float* __restrict__ x, const float* __restrict__ mask,
          const float* __restrict__ chol, const float* __restrict__ alpha,
          const float* __restrict__ y_mean, const float* __restrict__ y_std,
          const float* __restrict__ cand, const float* __restrict__ best,
          const float* __restrict__ linv, float* __restrict__ ei,
          float* vscratch, int b, int d, int m, float xi) {
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;
  float* lpp = ring + kRingFloats;  // the panel's L_pp^-1
  float* rhs = lpp + kDiagFloats;   // (kTC, 32) L[p, :p] V[:p]
  float* ls_s = rhs + kRhsFloats;
  float* craw = ls_s + d;     // (kTC, d) candidates
  float* cs = craw + kTC * d;  // (kTC, d) candidates / ls
  float* cc = cs + kTC * d;    // (kTC,) |cand / ls|^2
  float* mu_p = cc + kTC;      // (kWarps, kTC) each warp's rows of kq . alpha
  const int vs = v_stride(b);
  // V (and kq before it): kTC columns of vs floats, candidate-major.  Not
  // __restrict__: written and read back by other threads of the block.
  float* vt = kVGlobal ? vscratch + ((size_t)blockIdx.y * gridDim.x +
                                     blockIdx.x) * kTC * vs
                       : smem + fixed_floats(d);

  const int lane_k = blockIdx.y;
  const int c0 = blockIdx.x * kTC;
  const int tid = threadIdx.x, w = tid >> 5, l = tid & 31;
  const int bp = padded_rows(b), P = bp / kPanel;
  const float* xl = x + (size_t)lane_k * b * d;
  const float* ml = mask + (size_t)lane_k * b;
  const float* Ll = chol + (size_t)lane_k * b * b;
  const float* Il = linv + (size_t)lane_k * bp * kPanel;
  const float* al = alpha + (size_t)lane_k * b;
  const float* ll = log_ls + (size_t)lane_k * d;
  const float amp2 = expf(2.0f * log_amp[lane_k]);

  // The ring's first kStages - 1 chunks go out first: L does not wait
  // on kq.
  float* my_ring = ring + w * kStages * kChunkFloats;
  int ip = 0, iu = 0, issued = 0;
  bool more = true;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (more) {
      stage_chunk<kAligned>(my_ring + s * kChunkFloats, Ll, Il, b, ip, iu, w,
                            l);
      more = next_chunk(ip, iu, P);
    }
    cp_commit();
    ++issued;
  }

  // ---- kq: exp(log_ls) and the scaled candidates once a block (their
  // loads issued together, two barriers)
  for (int u = tid; u < d; u += kThreads) ls_s[u] = expf(ll[u]);
  for (int e = tid; e < kTC * d; e += kThreads) {
    const int c = e / d, u = e - c * d;
    const int ci = min(c0 + c, m - 1);  // the ragged tail repeats the last
    craw[e] = cand[((size_t)lane_k * m + ci) * d + u];
  }
  __syncthreads();
  for (int e = tid; e < kTC * d; e += kThreads) cs[e] = craw[e] / ls_s[e % d];
  if (tid >= kThreads - kTC) {
    const int c = tid - (kThreads - kTC);
    float s = 0.0f;
    for (int u = 0; u < d; ++u) {
      const float a = craw[c * d + u] / ls_s[u];
      s += a * a;
    }
    cc[c] = s;
  }
  __syncthreads();
  const float sqrt5 = sqrtf(5.0f);
  float mu[kTC];
#pragma unroll
  for (int c = 0; c < kTC; ++c) mu[c] = 0.0f;
  for (int j = tid; j < bp; j += kThreads) {
    if (j >= b) {
#pragma unroll
      for (int c = 0; c < kTC; ++c) vt[c * vs + j] = 0.0f;
      continue;
    }
    float xx = 0.0f, cx[kTC];
#pragma unroll
    for (int c = 0; c < kTC; ++c) cx[c] = 0.0f;
    for (int u = 0; u < d; ++u) {
      const float xs = __ldg(xl + (size_t)j * d + u) / ls_s[u];
      xx += xs * xs;
#pragma unroll
      for (int c = 0; c < kTC; ++c) cx[c] += cs[c * d + u] * xs;
    }
    const float mj = __ldg(ml + j), aj = __ldg(al + j);
#pragma unroll
    for (int c = 0; c < kTC; ++c) {
      const float sq = fmaxf(cc[c] - 2.0f * cx[c] + xx, 0.0f);
      const float r = sqrtf(sq + 1e-12f);
      const float s5r = sqrt5 * r;
      const float kq = amp2 * (1.0f + s5r + (5.0f / 3.0f) * r * r) *
                       expf(-s5r) * mj;
      mu[c] += kq * aj;
      vt[c * vs + j] = kq;
    }
  }
  // (summed over the warps at the end, behind the panels' barriers)
#pragma unroll
  for (int c = 0; c < kTC; ++c) {
    float s = mu[c];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (l == 0) mu_p[w * kTC + c] = s;
  }

  // ---- the panels
  int consumed = 0;
  float ss = 0.0f;  // warp w: sum V^2 of candidate w
  for (int p = 0; p < P; ++p) {
    // (i) the warp's 4 rows of L[p, :p] V[:p] for the kTC candidates,
    // lane l taking k = l mod 32: a 4 x kTC register tile of partial sums
    float acc[kRows * kTC];
#pragma unroll
    for (int o = 0; o < kRows * kTC; ++o) acc[o] = 0.0f;
    for (int u = 0; u <= l_chunks(p); ++u) {
      cp_wait<kStages - 2>();
      __syncwarp();
      // refill the slot the warp finished with last
      if (more) {
        stage_chunk<kAligned>(my_ring + (issued % kStages) * kChunkFloats,
                              Ll, Il, b, ip, iu, w, l);
        more = next_chunk(ip, iu, P);
      }
      cp_commit();
      ++issued;
      const float* C = my_ring + (consumed % kStages) * kChunkFloats;
      ++consumed;
      if (u == l_chunks(p)) {  // the warp's rows of L_pp^-1
        const int r = l >> 3, c4 = 4 * (l & 7);
        const float4 t =
            *reinterpret_cast<const float4*>(C + r * kChunkStride + c4);
        float* dst = lpp + (kRows * w + r) * kDiagStride + c4;
        dst[0] = t.x; dst[1] = t.y; dst[2] = t.z; dst[3] = t.w;
        break;
      }
      // k = 64u + l, then 64u + 32 + l where that is still below 32p
      const int k0 = u * kChunkCols + l;
      const bool two = k0 + kPanel < p * kPanel;  // the same for the warp
      float lk[2][kRows], vk[2][kTC];
#pragma unroll
      for (int i = 0; i < kRows; ++i) lk[0][i] = C[i * kChunkStride + l];
#pragma unroll
      for (int c = 0; c < kTC; ++c) vk[0][c] = vt[c * vs + k0];
      if (two) {
#pragma unroll
        for (int i = 0; i < kRows; ++i)
          lk[1][i] = C[i * kChunkStride + kPanel + l];
#pragma unroll
        for (int c = 0; c < kTC; ++c) vk[1][c] = vt[c * vs + k0 + kPanel];
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int c = 0; c < kTC; ++c)
          acc[i * kTC + c] = fmaf(lk[0][i], vk[0][c], acc[i * kTC + c]);
      if (two) {
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int c = 0; c < kTC; ++c)
            acc[i * kTC + c] = fmaf(lk[1][i], vk[1][c], acc[i * kTC + c]);
      }
    }
    // reduce-scatter the 32 partial sums over the lanes, halving each
    // step: lane j ends with the whole sum of output j = kTC i + c
    rs_step<16>(acc, l & 16);
    rs_step<8>(acc, l & 8);
    rs_step<4>(acc, l & 4);
    rs_step<2>(acc, l & 2);
    rs_step<1>(acc, l & 1);
    rhs[(l % kTC) * kRhsStride + kRows * w + l / kTC] = acc[0];
    __syncthreads();

    // (ii) warp w: candidate w's V_p = L_pp^-1 (kq_p - update), lane = row
    const int row = p * kPanel + l;
    const float rr = vt[w * vs + row] - rhs[w * kRhsStride + l];
    float v0 = 0.0f, v1 = 0.0f, v2 = 0.0f, v3 = 0.0f;
    const float* li = lpp + l * kDiagStride;
#pragma unroll
    for (int j = 0; j < kPanel; j += 4) {
      v0 = fmaf(li[j], __shfl_sync(0xffffffffu, rr, j), v0);
      v1 = fmaf(li[j + 1], __shfl_sync(0xffffffffu, rr, j + 1), v1);
      v2 = fmaf(li[j + 2], __shfl_sync(0xffffffffu, rr, j + 2), v2);
      v3 = fmaf(li[j + 3], __shfl_sync(0xffffffffu, rr, j + 3), v3);
    }
    const float v = (v0 + v1) + (v2 + v3);
    vt[w * vs + row] = v;
    ss = fmaf(v, v, ss);
    __syncthreads();
  }
  cp_wait<0>();

  // ---- the closed form, one candidate a warp
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  const int ci = c0 + w;
  if (l == 0 && ci < m) {
    const float var = fmaxf(amp2 - ss, 1e-12f);
    const float ystd = y_std[lane_k];
    float mu_w = 0.0f;
    for (int ww = 0; ww < kWarps; ++ww) mu_w += mu_p[ww * kTC + w];
    const float mean = mu_w * ystd + y_mean[lane_k];
    const float sd = sqrtf(var) * ystd;
    const float imp = mean - best[lane_k] - xi;
    const float z = imp / sd;
    const float ncdf = 0.5f * (1.0f + erff(z / sqrtf(2.0f)));
    const float npdf = expf(-0.5f * z * z) / sqrtf(2.0f * 3.14159265358979f);
    ei[(size_t)lane_k * m + ci] = imp * ncdf + sd * npdf;
  }
}

constexpr int kSmallThreads = 128;  // candidates a small_kernel block
// small_kernel's dynamic shared memory: ls (d) and the scaled points (b d)
size_t small_smem_bytes(int b, int d) {
  return sizeof(float) * (size_t)d * (b + 1);
}
// One panel: b <= 32 and the scaled points fit the default 48 KB.
bool one_panel(int b, int d) {
  return b <= kPanel && small_smem_bytes(b, d) <= 48 * 1024;
}

// Buckets of one panel: thread t of block (x, y) is candidate
// kSmallThreads x + t of lane y.  kq into registers, mu, then
// V = L^-1 kq row by row (division by the pivot, as substitution does).
__global__ void __launch_bounds__(kSmallThreads)
small_kernel(const float* __restrict__ log_ls,
             const float* __restrict__ log_amp, const float* __restrict__ x,
             const float* __restrict__ mask, const float* __restrict__ chol,
             const float* __restrict__ alpha,
             const float* __restrict__ y_mean,
             const float* __restrict__ y_std, const float* __restrict__ cand,
             const float* __restrict__ best, float* __restrict__ ei, int b,
             int d, int m, float xi) {
  __shared__ float Ls[kPanel][kDiagStride];
  __shared__ float xx[kPanel], ms[kPanel], as[kPanel];
  extern __shared__ float dyn[];
  float* ls_s = dyn;       // (d,) exp(log_ls)
  float* xs = dyn + d;     // (b, d) x / ls
  const int lane_k = blockIdx.y, tid = threadIdx.x;
  const float* Ll = chol + (size_t)lane_k * b * b;
  for (int u = tid; u < d; u += kSmallThreads)
    ls_s[u] = expf(log_ls[(size_t)lane_k * d + u]);
  for (int e = tid; e < b * b; e += kSmallThreads)
    Ls[e / b][e % b] = __ldg(Ll + e);
  if (tid < b) {
    ms[tid] = mask[(size_t)lane_k * b + tid];
    as[tid] = alpha[(size_t)lane_k * b + tid];
  }
  __syncthreads();
  for (int e = tid; e < b * d; e += kSmallThreads)
    xs[e] = __ldg(x + (size_t)lane_k * b * d + e) / ls_s[e % d];
  __syncthreads();
  if (tid < b) {
    float s = 0.0f;
    for (int u = 0; u < d; ++u) s += xs[tid * d + u] * xs[tid * d + u];
    xx[tid] = s;
  }
  __syncthreads();
  const int ci = blockIdx.x * kSmallThreads + tid;
  if (ci >= m) return;  // no barrier below

  // cx_j = cand/ls . x_j/ls, each candidate coordinate scaled once
  const float* cl = cand + ((size_t)lane_k * m + ci) * d;
  float v[kPanel], cc = 0.0f;
#pragma unroll
  for (int j = 0; j < kPanel; ++j) v[j] = 0.0f;
  for (int u = 0; u < d; ++u) {
    const float c = __ldg(cl + u) / ls_s[u];
    cc += c * c;
#pragma unroll
    for (int j = 0; j < kPanel; ++j)
      if (j < b) v[j] = fmaf(c, xs[j * d + u], v[j]);
  }
  const float amp2 = expf(2.0f * log_amp[lane_k]);
  const float sqrt5 = sqrtf(5.0f);
  float mu = 0.0f;
#pragma unroll
  for (int j = 0; j < kPanel; ++j) {
    if (j < b) {
      const float sq = fmaxf(cc - 2.0f * v[j] + xx[j], 0.0f);
      const float r = sqrtf(sq + 1e-12f);
      const float s5r = sqrt5 * r;
      v[j] = amp2 * (1.0f + s5r + (5.0f / 3.0f) * r * r) * expf(-s5r) *
             ms[j];
      mu = fmaf(v[j], as[j], mu);
    }
  }
  float ss = 0.0f;
#pragma unroll
  for (int i = 0; i < kPanel; ++i) {
    if (i < b) {
      float t = v[i];
#pragma unroll
      for (int j = 0; j < i; ++j) t = fmaf(-Ls[i][j], v[j], t);
      v[i] = t / Ls[i][i];
      ss = fmaf(v[i], v[i], ss);
    }
  }
  const float var = fmaxf(amp2 - ss, 1e-12f);
  const float ystd = y_std[lane_k];
  const float mean = mu * ystd + y_mean[lane_k];
  const float sd = sqrtf(var) * ystd;
  const float imp = mean - best[lane_k] - xi;
  const float z = imp / sd;
  const float ncdf = 0.5f * (1.0f + erff(z / sqrtf(2.0f)));
  const float npdf = expf(-0.5f * z * z) / sqrtf(2.0f * 3.14159265358979f);
  ei[(size_t)lane_k * m + ci] = imp * ncdf + sd * npdf;
}

bool v_in_global(int b, int d) { return smem_bytes(b, d, false) > kMaxSmem; }

template <bool kAligned, bool kVGlobal>
cudaError_t launch(dim3 grid, size_t smem, cudaStream_t stream,
                   const float* log_ls, const float* log_amp, const float* x,
                   const float* mask, const float* chol, const float* alpha,
                   const float* y_mean, const float* y_std, const float* cand,
                   const float* best, const float* linv, float* ei,
                   float* vscratch, int b, int d, int m, float xi) {
  auto kern = ei_kernel<kAligned, kVGlobal>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kern<<<grid, kThreads, smem, stream>>>(log_ls, log_amp, x, mask, chol,
                                         alpha, y_mean, y_std, cand, best,
                                         linv, ei, vscratch, b, d, m, xi);
  return cudaGetLastError();
}

}  // namespace

// Floats of global scratch gp_ei_launch needs at these shapes: none for
// a bucket of one panel; else the diagonal blocks' inverses,
// k * (padded b) * 32, and past what a block's shared memory holds every
// block's V tile, k * ceil(m / kTC) * kTC * (padded b + 4).
extern "C" long long gp_ei_scratch_floats(int k, int b, int d, int m) {
  if (one_panel(b, d)) return 0;
  long long n = (long long)inv_floats(k, b);
  if (v_in_global(b, d))
    n += (long long)k * ((m + kTC - 1) / kTC) * kTC * v_stride(b);
  return n;
}

// Shapes (all float32, contiguous, on one device): log_ls (k,d),
// log_amp (k,), x (k,b,d), mask (k,b), chol (k,b,b), alpha (k,b),
// y_mean (k,), y_std (k,), cand (k,m,d), best (k,) -> ei (k,m).
// scratch: gp_ei_scratch_floats(k, b, d, m) floats, 16-byte aligned (may
// be null when that is 0).  Launches one kernel (b <= 32) or two on
// `stream` and returns the first cudaError_t that is not success.
extern "C" int gp_ei_launch(const float* log_ls, const float* log_amp,
                            const float* x, const float* mask,
                            const float* chol, const float* alpha,
                            const float* y_mean, const float* y_std,
                            const float* cand, const float* best, float* ei,
                            float* scratch, int k, int b, int d, int m,
                            float xi, void* stream) {
  if (k <= 0 || b <= 0 || d <= 0 || m <= 0 || k > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (one_panel(b, d)) {
    small_kernel<<<dim3((m + kSmallThreads - 1) / kSmallThreads, k),
                   kSmallThreads, small_smem_bytes(b, d), st>>>(
        log_ls, log_amp, x, mask, chol, alpha, y_mean, y_std, cand, best, ei,
        b, d, m, xi);
    return (int)cudaGetLastError();
  }
  if (scratch == nullptr) return (int)cudaErrorInvalidValue;
  const bool global = v_in_global(b, d);
  const size_t smem = smem_bytes(b, d, global);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;  // d too large
  const bool aligned =
      b % 4 == 0 && reinterpret_cast<uintptr_t>(chol) % 16 == 0;
  float* linv = scratch;
  float* vscratch = global ? scratch + inv_floats(k, b) : nullptr;
  inv_kernel<<<dim3(padded_rows(b) / kPanel, k), 32, 0, st>>>(chol, linv, b);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 grid((m + kTC - 1) / kTC, k);
#define GP_EI_ARGS                                                        \
  grid, smem, st, log_ls, log_amp, x, mask, chol, alpha, y_mean, y_std,   \
      cand, best, linv, ei, vscratch, b, d, m, xi
  if (aligned)
    err = global ? launch<true, true>(GP_EI_ARGS)
                 : launch<true, false>(GP_EI_ARGS);
  else
    err = global ? launch<false, true>(GP_EI_ARGS)
                 : launch<false, false>(GP_EI_ARGS);
#undef GP_EI_ARGS
  return (int)err;
}
