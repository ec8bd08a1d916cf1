// gp_nll_chol: fused, masked, lane-batched GP negative log marginal
// likelihood on Hopper (sm_90a), one CTA per lane.
//
// Replaces: src/repro/kernels/gp.py : gp_nll_chol / _nll_kernel (with its
// helpers _masked_cov_block, _chol_loop, _fwd_solve), the Pallas TPU
// kernel.
//
// What bounds it on this card: the factorization is a chain of b
// dependent column steps.  The arithmetic, about
// k*(b^3/3 + b^2 + b^2/2*(3d + 10)) FLOPs (the factorization, the solve
// and the covariance's lower triangle), takes microseconds at the
// 67 TFLOP/s f32 (non-tensor) peak, and
// the bytes (inputs plus the k*b*b*4 factor written out) take about as
// long at 3.35 TB/s; the kernel is bound by neither but by latency: each
// column step is two block-wide barriers plus one pass over the trailing
// lower triangle, which is L2-resident (1 MB per lane at b = 512), and
// only k of the 132 SMs have work.
//
// What the design does about it: it stays simple and right first.  The
// masked covariance is built straight into the L output buffer in global
// memory and factored there in place (right-looking, column by column, one
// __syncthreads() between phases), so no b is too large for shared
// memory; the scaled pivot column, the right-hand side, the solve
// accumulator and z live in dynamic shared memory (4*b floats).  The
// forward solve z = L^-1 (y*m) rides inside the same column loop, so the
// factor is never re-read, and the NLL is reduced in the same CTA.
// Blocked panels, several CTAs per lane and tensor-core updates are later
// work.
//
// Semantics mirror the reference exactly: pivot clamp max(A_jj, 1e-10),
// L_ij = A_ij / sqrt(max(A_jj, 1e-10)) for i >= j (the diagonal included),
// explicit zeros above the diagonal, padded rows an identity block.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 512;
constexpr float kLog2Pi = 1.8378770664093453f;

__global__ void __launch_bounds__(kThreads)
nll_kernel(const float* __restrict__ log_ls, const float* __restrict__ log_amp,
           const float* __restrict__ log_noise, const float* __restrict__ x,
           const float* __restrict__ y, const float* __restrict__ mask,
           float* __restrict__ nll, float* __restrict__ L,
           float* __restrict__ z, int b, int d) {
  extern __shared__ float smem[];
  float* col = smem;          // scaled pivot column j (rows >= j)
  float* rhs = smem + b;      // y * m
  float* acc = smem + 2 * b;  // sum_{c<j} L_ic z_c
  float* zs = smem + 3 * b;   // z

  const int lane = blockIdx.x;
  const int tid = threadIdx.x;
  const float* xl = x + (size_t)lane * b * d;
  const float* ml = mask + (size_t)lane * b;
  const float* ll = log_ls + (size_t)lane * d;
  float* A = L + (size_t)lane * b * b;

  const float amp2 = expf(2.0f * log_amp[lane]);
  const float noise2 = expf(2.0f * log_noise[lane]) + 1e-5f;
  const float sqrt5 = sqrtf(5.0f);

  // 1. masked Matern-5/2 covariance, lower triangle; zeros above it
  for (int idx = tid; idx < b * b; idx += blockDim.x) {
    const int i = idx / b, j = idx % b;
    float v = 0.0f;
    if (j <= i) {
      float si = 0.0f, sj = 0.0f, dot = 0.0f;
      for (int t = 0; t < d; ++t) {
        const float ls = expf(ll[t]);
        const float a = xl[i * d + t] / ls, c = xl[j * d + t] / ls;
        si += a * a;
        sj += c * c;
        dot += a * c;
      }
      const float sq = fmaxf(si - 2.0f * dot + sj, 0.0f);
      const float r = sqrtf(sq + 1e-12f);
      const float s5r = sqrt5 * r;
      v = amp2 * (1.0f + s5r + (5.0f / 3.0f) * r * r) * expf(-s5r);
      if (i == j) v += noise2;
      v *= ml[i] * ml[j];
      if (i == j) v += 1.0f - ml[i];
    }
    A[idx] = v;
  }
  for (int i = tid; i < b; i += blockDim.x) {
    rhs[i] = y[(size_t)lane * b + i] * ml[i];
    acc[i] = 0.0f;
  }
  __syncthreads();

  // 2. right-looking Cholesky in place, with the forward solve for z
  float quad = 0.0f, logdet = 0.0f;  // thread 0 accumulates both
  for (int j = 0; j < b; ++j) {
    // phase A: scale column j.  A_jj is read by every thread and written
    // (as L_jj) only in phase B, after the barrier.
    const float dj = fmaxf(A[j * b + j], 1e-10f);
    const float sd = sqrtf(dj);
    for (int i = j + tid; i < b; i += blockDim.x) {
      const float v = A[i * b + j] / sd;
      col[i] = v;
      if (i > j) A[i * b + j] = v;
    }
    __syncthreads();
    // phase B: z_j, the diagonal, the trailing update and the solve
    // accumulator — all read col[], none reads column j of A again
    const float ljj = col[j];
    const float zj = (rhs[j] - acc[j]) / ljj;
    if (tid == 0) {
      A[j * b + j] = ljj;
      zs[j] = zj;
      quad += zj * zj;
      logdet += logf(ljj);
    }
    const int n = b - j - 1;
    for (int idx = tid; idx < n * n; idx += blockDim.x) {
      const int i = j + 1 + idx / n, c = j + 1 + idx % n;
      if (c <= i) A[i * b + c] -= col[i] * col[c];
    }
    for (int i = j + 1 + tid; i < b; i += blockDim.x) acc[i] += col[i] * zj;
    __syncthreads();
  }

  // 3. outputs
  float* zl = z + (size_t)lane * b;
  for (int i = tid; i < b; i += blockDim.x) zl[i] = zs[i];
  if (tid == 0) {
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
  const size_t smem = 4 * (size_t)b * sizeof(float);
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(nll_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  nll_kernel<<<k, kThreads, smem, (cudaStream_t)stream>>>(
      log_ls, log_amp, log_noise, x, y, mask, nll, L, z, b, d);
  return (int)cudaGetLastError();
}
