// gp_nll_chol: fused, masked, lane-batched GP negative log marginal
// likelihood on Hopper (sm_90a), a cluster of 8 CTAs per lane.
//
// Replaces: src/repro/kernels/gp.py : gp_nll_chol / _nll_kernel (with its
// helpers _masked_cov_block, _chol_loop, _fwd_solve), the Pallas TPU
// kernel.
//
// What bounds it on this card: the factorization is a chain of b
// dependent column steps.  The arithmetic, about
// k*(b^3/3 + b^2 + b^2/2*(3d + 10)) FLOPs (the factorization, the solve
// and the covariance's lower triangle), takes microseconds at the
// 67 TFLOP/s f32 (non-tensor) peak, and the bytes (inputs plus the
// k*b*b*4 factor written out) take about as long at 3.35 TB/s; the kernel
// is bound by neither but by the latency of that chain.  Float32 on the
// CUDA cores, as the reference computes it (no TF32).
//
// What the design does about it: a right-looking Cholesky blocked in
// panels of 32 columns, each lane's matrix shared by a cluster of 8 CTAs
// (8 is the portable cluster size; 16 lanes fill 128 SMs), so the chain
// is b/32 panel steps of two cluster-wide barriers instead of b column
// steps in one CTA.  The matrix lives in the L output buffer in global
// memory, where it stays L2-resident (1 MB a lane at b = 512); every read
// of it goes through L2 (ld.global.cg), since another CTA of the cluster
// may have written it, and `cluster.sync()` (release / acquire at cluster
// scope) orders the phases.  Shared memory: 21 KB static (the diagonal
// block, a 128-row staging buffer) plus the lane's scaled points (up to
// 64 KB) for the covariance.
//   0. All 8 CTAs build the masked covariance (lower triangle, zeros
//      above, padded rows an identity block), a warp a row, and the
//      right-hand side y*m, which z overwrites in place as the solve
//      advances.  cluster.sync().
//   Then for each panel of w <= 32 columns j0 .. j0+w-1:
//   1. Every CTA loads the panel's diagonal block and one warp factors it
//      in registers (a lane a row, the scaled column shuffled across),
//      with that block's part of the forward solve.  (Factoring it in
//      every CTA spares a cluster barrier.)
//   2. The rows below it (TRSM), in equal chunks over the 8 CTAs, staged
//      through shared memory so global memory is read and written a row
//      at a time, four lanes a row: L_ic = (A_ic - sum_{t<c} L_it L_ct) /
//      sqrt(max(A_cc, 1e-10)), and the right-hand side's update
//      z_i -= sum_c L_ic z_c beside it.  cluster.sync().  Then CTA 0
//      writes the factored block and its z back, and adds to the log-det
//      and |z|^2.
//   3. The trailing lower triangle (SYRK) in 64x64 tiles dealt round-robin
//      to the 8 CTAs: both panel slices staged in shared memory (the next
//      tile's fetched into registers while this one computes), 4x4
//      register blocks a thread, only tiles on or below the diagonal, and
//      in the diagonal tiles only elements on or below it; each element
//      is updated by a reduction in L2 (atomicAdd of -sum, one thread an
//      element, so A - sum rounds once as a load and a store would),
//      which no thread waits on.  cluster.sync().
// Each panel's critical path is the one-warp factor and the row solves,
// each a chain of 32 dependent divisions and shuffles; the trailing
// update is the rest.  The wrapper still counts one launch a call.
//
// Semantics mirror the reference exactly: pivot clamp max(A_jj, 1e-10),
// L_ij = A_ij / sqrt(max(A_jj, 1e-10)) for i >= j (the diagonal included),
// explicit zeros above the diagonal, padded rows an identity block,
// z = L^-1 (y*m), NLL = |z|^2/2 + sum log L_jj + sum(m) log(2 pi)/2.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;    // CTAs a lane
constexpr int kThreads = 256;  // a CTA
constexpr int kNB = 32;        // panel width
constexpr int kPad = kNB + 1;  // shared rows a bank apart
constexpr int kTile = 64;      // trailing-update tile
constexpr int kChunk = 2 * kTile;  // panel rows a CTA solves at a time
constexpr int kRowLanes = 4;       // lanes that share a panel row
constexpr int kSlice = kTile * kNB / kThreads;  // a tile slice's values a
                                                // thread stages
constexpr int kStagedFloats = 16384;  // scaled points staged up to 64 KB
constexpr float kLog2Pi = 1.8378770664093453f;

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
nll_kernel(const float* __restrict__ log_ls, const float* __restrict__ log_amp,
           const float* __restrict__ log_noise, const float* __restrict__ x,
           const float* __restrict__ y, const float* __restrict__ mask,
           float* __restrict__ nll, float* __restrict__ L,
           float* __restrict__ z, int b, int d) {
  __shared__ float diag[kNB][kPad];  // the panel's diagonal block
  __shared__ float sd[kNB];          // sqrt(max(pivot, 1e-10)) a column
  __shared__ float zseg[kNB];        // z of the panel's columns
  // panel rows being solved (2.), or the panel slices of a trailing
  // tile's rows and columns (3.)
  __shared__ float stage[kChunk][kPad];
  float(*pr)[kPad] = stage;
  float(*pc)[kPad] = stage + kTile;
  extern __shared__ float ls_s[];    // the lane's d lengthscales, then
  float* xs = ls_s + d;              // its b x d scaled points (staged)

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int lane = blockIdx.x / kCluster;
  const int tid = threadIdx.x;
  const int gtid = rank * kThreads + tid;
  constexpr int kAll = kCluster * kThreads;
  const float* xl = x + (size_t)lane * b * d;
  const float* ml = mask + (size_t)lane * b;
  const float* ll = log_ls + (size_t)lane * d;
  float* A = L + (size_t)lane * b * b;
  float* zl = z + (size_t)lane * b;

  const float amp2 = expf(2.0f * log_amp[lane]);
  const float noise2 = expf(2.0f * log_noise[lane]) + 1e-5f;
  const float sqrt5 = sqrtf(5.0f);

  // 0. masked Matern-5/2 covariance, lower triangle; zeros above it.  The
  // scaled points x/ls are staged in shared memory when they fit
  // (kStagedFloats), else each entry divides its own.
  const bool staged = b * d <= kStagedFloats;
  for (int t = tid; t < d; t += kThreads) ls_s[t] = expf(ll[t]);
  __syncthreads();
  if (staged)
    for (int idx = tid; idx < b * d; idx += kThreads)
      xs[idx] = xl[idx] / ls_s[idx % d];
  __syncthreads();
  const int warp = tid / 32, lane32 = tid % 32;
  for (int i = rank * (kThreads / 32) + warp; i < b; i += kAll / 32) {
    const float mi = ml[i];
    for (int j = lane32; j < b; j += 32) {
      float v = 0.0f;
      if (j <= i) {
        float si = 0.0f, sj = 0.0f, dot = 0.0f;
        for (int t = 0; t < d; ++t) {
          const float a = staged ? xs[i * d + t] : xl[i * d + t] / ls_s[t];
          const float c = staged ? xs[j * d + t] : xl[j * d + t] / ls_s[t];
          si += a * a;
          sj += c * c;
          dot += a * c;
        }
        const float sq = fmaxf(si - 2.0f * dot + sj, 0.0f);
        const float r = sqrtf(sq + 1e-12f);
        const float s5r = sqrt5 * r;
        v = amp2 * (1.0f + s5r + (5.0f / 3.0f) * r * r) * expf(-s5r);
        if (i == j) v += noise2;
        v *= mi * ml[j];
        if (i == j) v += 1.0f - mi;
      }
      A[(size_t)i * b + j] = v;
    }
  }
  for (int i = gtid; i < b; i += kAll) zl[i] = y[(size_t)lane * b + i] * ml[i];
  cluster.sync();

  float quad = 0.0f, logdet = 0.0f;  // thread 0 of CTA 0 accumulates both
  for (int j0 = 0; j0 < b; j0 += kNB) {
    const int w = min(kNB, b - j0), j1 = j0 + w;

    // 1. the diagonal block, a lane a row in registers, the column being
    // scaled passed along by shuffles, with its part of the solve; lane
    // roles are selects, not branches, so the shuffles never wait for a
    // divergent warp to reconverge
    if (tid < 32) {
      const int i = tid;
      float row[kNB];
#pragma unroll
      for (int t = 0; t < kNB; ++t)
        row[t] = (i < w && t <= i)
                     ? __ldcg(&A[(size_t)(j0 + i) * b + j0 + t])
                     : 0.0f;
      float rz = i < w ? __ldcg(&zl[j0 + i]) : 0.0f;  // running rhs of row i
      float my_sd = 1.0f, my_z = 0.0f;  // lane c keeps column c's
#pragma unroll
      for (int c = 0; c < kNB; ++c) {
        if (c < w) {
          const float a = __shfl_sync(0xffffffffu, row[c], c);
          const float s = sqrtf(fmaxf(a, 1e-10f));
          const float lcc = a / s;
          const float zc = __shfl_sync(0xffffffffu, rz, c) / lcc;
          const float lic = i > c ? row[c] / s : 0.0f;  // L_ic below c
          row[c] = i == c ? lcc : (i > c ? lic : row[c]);
          rz = i > c ? rz - lic * zc : rz;
          my_sd = i == c ? s : my_sd;
          my_z = i == c ? zc : my_z;
#pragma unroll
          for (int t = c + 1; t < kNB; ++t) {
            const float ltc = __shfl_sync(0xffffffffu, lic, t);
            row[t] = t <= i ? row[t] - lic * ltc : row[t];
          }
        }
      }
#pragma unroll
      for (int t = 0; t < kNB; ++t) diag[i][t] = row[t];
      sd[i] = my_sd;  // 1 and 0 past a short last panel: inert columns
      zseg[i] = my_z;
    }
    __syncthreads();

    // 2. the panel rows below the block, and the right-hand side: the
    // rows dealt to the cluster in equal chunks (at most kChunk at a time),
    // staged through shared memory so global memory is read and written a
    // row at a time (coalesced).  Four lanes share a row, lane q holding
    // columns q, q+4, ...: at column c its owner divides by the column's
    // scale and shuffles the value to the other three, which take it out
    // of their columns right of c.  The chain a row waits on is one
    // division, one shuffle and one multiply-add a column.
    const int per = min(kChunk, ((b - j1 + kCluster - 1) / kCluster + 63) /
                                    64 * 64);
    for (int r0 = j1 + per * rank; r0 < b; r0 += per * kCluster) {
      const int rows = min(per, b - r0);
      __syncthreads();  // the last chunk's writers are done
      for (int idx = tid; idx < rows * kNB; idx += kThreads) {
        const int r = idx / kNB, c = idx % kNB;
        stage[r][c] =
            c < w ? __ldcg(&A[(size_t)(r0 + r) * b + j0 + c]) : 0.0f;
      }
      __syncthreads();
      const int q = tid % kRowLanes;
      // whole warps step together (the shuffles), past-the-end rows idle
      for (int rb = 0; rb < rows; rb += kThreads / kRowLanes) {
        const int r = rb + tid / kRowLanes;
        const bool live = r < rows;
        float xv[kNB / kRowLanes];  // columns q + kRowLanes * u
#pragma unroll
        for (int u = 0; u < kNB / kRowLanes; ++u)
          xv[u] = live ? stage[r][q + kRowLanes * u] : 0.0f;
        float zi = live && q == 0 ? __ldcg(&zl[r0 + r]) : 0.0f;
#pragma unroll
        for (int c = 0; c < kNB; ++c) {
          const int owner = c % kRowLanes, uc = c / kRowLanes;
          const float xc = __shfl_sync(0xffffffffu, xv[uc] / sd[c], owner,
                                       kRowLanes);
          xv[uc] = q == owner ? xc : xv[uc];
          zi -= xc * zseg[c];  // lane 0's sum, in column order
#pragma unroll
          for (int u = 0; u < kNB / kRowLanes; ++u) {
            const int t = q + kRowLanes * u;
            xv[u] = t > c ? xv[u] - xc * diag[t][c] : xv[u];
          }
        }
        if (live) {
#pragma unroll
          for (int u = 0; u < kNB / kRowLanes; ++u)
            stage[r][q + kRowLanes * u] = xv[u];
          if (q == 0) zl[r0 + r] = zi;
        }
      }
      __syncthreads();
      for (int idx = tid; idx < rows * kNB; idx += kThreads) {
        const int r = idx / kNB, c = idx % kNB;
        if (c < w) A[(size_t)(r0 + r) * b + j0 + c] = stage[r][c];
      }
    }
    cluster.sync();

    // every CTA has read the block and its right-hand side: CTA 0 writes
    // the factored block and its z over them
    if (rank == 0) {
      for (int idx = tid; idx < w * w; idx += kThreads) {
        const int r = idx / w, c = idx % w;
        if (c <= r) A[(size_t)(j0 + r) * b + j0 + c] = diag[r][c];
      }
      for (int c = tid; c < w; c += kThreads) zl[j0 + c] = zseg[c];
      if (tid == 0)
        for (int c = 0; c < w; ++c) {
          quad += zseg[c] * zseg[c];
          logdet += logf(diag[c][c]);
        }
    }

    // 3. the trailing lower triangle, 64x64 tiles over the cluster
    const int n = b - j1;
    const int nt = (n + kTile - 1) / kTile;
    const int ty = tid / 16, tx = tid % 16;
    const int ntiles = nt * (nt + 1) / 2;
    // the next tile's panel slices, fetched into registers while this
    // tile computes (each thread its kSlice values of each)
    float nr[kSlice], nc[kSlice];
    auto fetch = [&](int tix) {
      int ti = 0;  // tile (ti, tc), tc <= ti, row by row
      while ((ti + 1) * (ti + 2) / 2 <= tix) ++ti;
      const int tc = tix - ti * (ti + 1) / 2;
      const int i0 = j1 + ti * kTile, c0 = j1 + tc * kTile;
#pragma unroll
      for (int u = 0; u < kSlice; ++u) {
        const int idx = tid + u * kThreads;
        const int r = idx / kNB, c = idx % kNB;
        nr[u] = (i0 + r < b && c < w)
                    ? __ldcg(&A[(size_t)(i0 + r) * b + j0 + c])
                    : 0.0f;
        nc[u] = (c0 + r < b && c < w)
                    ? __ldcg(&A[(size_t)(c0 + r) * b + j0 + c])
                    : 0.0f;
      }
    };
    if (rank < ntiles) fetch(rank);
    for (int tix = rank; tix < ntiles; tix += kCluster) {
      int ti = 0;
      while ((ti + 1) * (ti + 2) / 2 <= tix) ++ti;
      const int tc = tix - ti * (ti + 1) / 2;
      const int i0 = j1 + ti * kTile, c0 = j1 + tc * kTile;
      __syncthreads();  // the last tile's readers are done
#pragma unroll
      for (int u = 0; u < kSlice; ++u) {
        const int idx = tid + u * kThreads;
        pr[idx / kNB][idx % kNB] = nr[u];
        pc[idx / kNB][idx % kNB] = nc[u];
      }
      __syncthreads();
      if (tix + kCluster < ntiles) fetch(tix + kCluster);
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;
#pragma unroll 8
      for (int t = 0; t < kNB; ++t) {
        float a[4], bc[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) a[r] = pr[4 * ty + r][t];
#pragma unroll
        for (int c = 0; c < 4; ++c) bc[c] = pc[tx + 16 * c][t];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a[r], bc[c], acc[r][c]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + 4 * ty + r;
        if (i >= b) continue;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int col = c0 + tx + 16 * c;
          if (col > i) continue;
          // a reduction in L2, not a load and a store: nothing waits on
          // it, and A - acc still rounds once (one thread an element)
          atomicAdd(&A[(size_t)i * b + col], -acc[r][c]);
        }
      }
    }
    cluster.sync();
  }

  if (rank == 0 && tid == 0) {
    float msum = 0.0f;
    for (int i = 0; i < b; ++i) msum += ml[i];
    nll[lane] = 0.5f * quad + logdet + 0.5f * msum * kLog2Pi;
  }
}

}  // namespace

// Shapes (all float32, contiguous, on one device): log_ls (k,d),
// log_amp (k,), log_noise (k,), x (k,b,d), y (k,b), mask (k,b) ->
// nll (k,), L (k,b,b), z (k,b).  Returns the cudaError_t of the launch.
extern "C" int gp_nll_launch(const float* log_ls, const float* log_amp,
                             const float* log_noise, const float* x,
                             const float* y, const float* mask, float* nll,
                             float* L, float* z, int k, int b, int d,
                             void* stream) {
  if (k <= 0 || b <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem =
      ((size_t)d + ((size_t)b * d <= kStagedFloats ? (size_t)b * d : 0)) *
      sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      nll_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  nll_kernel<<<k * kCluster, kThreads, smem, (cudaStream_t)stream>>>(
      log_ls, log_amp, log_noise, x, y, mask, nll, L, z, b, d);
  return (int)cudaGetLastError();
}
