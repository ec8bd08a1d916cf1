// gp_ei: batched expected improvement over per-lane GP posteriors on
// Hopper (sm_90a), one thread per candidate.
//
// Replaces: src/repro/kernels/gp.py : gp_ei / _ei_kernel, the Pallas TPU
// kernel.
//
// What bounds it on this card: per candidate the forward substitution
// v = L^-1 kq is a chain of b dependent rows, b^2 FLOPs a candidate (b^2/2
// multiply-adds), plus the b Matern entries of kq (k*m*(b^2 + b*(3d + 12))
// in all, microseconds at the 67 TFLOP/s f32 peak), and the bytes (chol,
// cand and ei) take microseconds at 3.35 TB/s.  The kernel is bound by
// neither but by the serial chain each thread walks: b^2/2 multiply-adds
// one after another, with only ceil(m/32) warps per lane in flight (40 at
// the main path's m = 1280).
//
// What the design does about it: grid = (k, ceil(m/T)), T = 32 candidates
// per block, one thread each.  A thread builds its kq entries on the fly
// from x, log_ls and mask (no (m,b) cross-covariance ever reaches device
// memory), accumulates mu = kq.alpha and sum v^2 as it substitutes, and
// writes EI.  Its v column lives in dynamic shared memory, laid out
// v[row*T + thread] so a warp's accesses hit 32 distinct banks; at
// b = 512 that is 64 KB a block, above the 48 KB default, so the launcher
// raises the block's limit with cudaFuncSetAttribute.  Past the 227 KB a
// block may hold (b >= 2048) v spills to a global scratch buffer of
// k*ceil(m/T)*b*T floats the caller passes in, in the same layout, so a
// warp's accesses stay one coalesced 128-byte line (gp_ei_scratch_floats
// says how large).  The rows of L are read from global memory
// (L2-resident), the same address across the warp, i.e. one broadcast
// load.  Four partial sums break the dependent multiply-add chain of each
// row.  Splitting a candidate's row sums across a warp is later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTile = 32;  // candidates (threads) per block
constexpr size_t kMaxSmem = 227 * 1024;  // dynamic shared memory a block may hold

size_t smem_bytes(int b) { return (size_t)b * kTile * sizeof(float); }

template <bool kSpill>
__global__ void __launch_bounds__(kTile)
ei_kernel(const float* __restrict__ log_ls, const float* __restrict__ log_amp,
          const float* __restrict__ x, const float* __restrict__ mask,
          const float* __restrict__ chol, const float* __restrict__ alpha,
          const float* __restrict__ y_mean, const float* __restrict__ y_std,
          const float* __restrict__ cand, const float* __restrict__ best,
          float* __restrict__ ei, float* __restrict__ scratch, int b, int d,
          int m, float xi) {
  extern __shared__ float smem[];
  const int lane = blockIdx.x;
  const int t = threadIdx.x;
  const int ci = blockIdx.y * kTile + t;
  if (ci >= m) return;  // no barrier below: each thread owns its column
  // v (b, kTile): this block's tile of shared memory, or of the scratch
  float* vs = kSpill ? scratch + ((size_t)lane * gridDim.y + blockIdx.y) *
                                     (size_t)b * kTile
                     : smem;

  const float* xl = x + (size_t)lane * b * d;
  const float* ml = mask + (size_t)lane * b;
  const float* Ll = chol + (size_t)lane * b * b;
  const float* al = alpha + (size_t)lane * b;
  const float* ll = log_ls + (size_t)lane * d;
  const float* cq = cand + ((size_t)lane * m + ci) * d;

  const float amp2 = expf(2.0f * log_amp[lane]);
  const float sqrt5 = sqrtf(5.0f);
  float cc = 0.0f;
  for (int u = 0; u < d; ++u) {
    const float a = cq[u] / expf(ll[u]);
    cc += a * a;
  }

  float mu = 0.0f, ss = 0.0f;
  for (int j = 0; j < b; ++j) {
    float xx = 0.0f, cx = 0.0f;
    for (int u = 0; u < d; ++u) {
      const float ls = expf(__ldg(ll + u));
      const float a = cq[u] / ls, c = __ldg(xl + j * d + u) / ls;
      xx += c * c;
      cx += a * c;
    }
    const float sq = fmaxf(cc - 2.0f * cx + xx, 0.0f);
    const float r = sqrtf(sq + 1e-12f);
    const float s5r = sqrt5 * r;
    const float kq = amp2 * (1.0f + s5r + (5.0f / 3.0f) * r * r) *
                     expf(-s5r) * __ldg(ml + j);
    mu += kq * __ldg(al + j);

    const float* row = Ll + (size_t)j * b;
    float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
    int c = 0;
    for (; c + 3 < j; c += 4) {
      s0 += __ldg(row + c) * vs[c * kTile + t];
      s1 += __ldg(row + c + 1) * vs[(c + 1) * kTile + t];
      s2 += __ldg(row + c + 2) * vs[(c + 2) * kTile + t];
      s3 += __ldg(row + c + 3) * vs[(c + 3) * kTile + t];
    }
    for (; c < j; ++c) s0 += __ldg(row + c) * vs[c * kTile + t];
    const float vj = (kq - ((s0 + s1) + (s2 + s3))) / __ldg(row + j);
    vs[j * kTile + t] = vj;
    ss += vj * vj;
  }

  const float var = fmaxf(amp2 - ss, 1e-12f);
  const float ystd = y_std[lane];
  const float mean = mu * ystd + y_mean[lane];
  const float sd = sqrtf(var) * ystd;
  const float imp = mean - best[lane] - xi;
  const float z = imp / sd;
  const float ncdf = 0.5f * (1.0f + erff(z / sqrtf(2.0f)));
  const float npdf = expf(-0.5f * z * z) / sqrtf(2.0f * 3.14159265358979f);
  ei[(size_t)lane * m + ci] = imp * ncdf + sd * npdf;
}

}  // namespace

// Shapes (all float32, contiguous, on one device): log_ls (k,d),
// log_amp (k,), x (k,b,d), mask (k,b), chol (k,b,b), alpha (k,b),
// y_mean (k,), y_std (k,), cand (k,m,d), best (k,) -> ei (k,m).
// scratch: gp_ei_scratch_floats(k, b, m) floats, or null when that is 0.
// Returns the cudaError_t of the launch.
extern "C" int gp_ei_launch(const float* log_ls, const float* log_amp,
                            const float* x, const float* mask,
                            const float* chol, const float* alpha,
                            const float* y_mean, const float* y_std,
                            const float* cand, const float* best, float* ei,
                            float* scratch, int k, int b, int d, int m,
                            float xi, void* stream) {
  dim3 grid(k, (m + kTile - 1) / kTile);
  const size_t smem = smem_bytes(b);
  if (smem > kMaxSmem) {
    if (scratch == nullptr) return (int)cudaErrorInvalidValue;
    ei_kernel<true><<<grid, kTile, 0, (cudaStream_t)stream>>>(
        log_ls, log_amp, x, mask, chol, alpha, y_mean, y_std, cand, best, ei,
        scratch, b, d, m, xi);
    return (int)cudaGetLastError();
  }
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        ei_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  ei_kernel<false><<<grid, kTile, smem, (cudaStream_t)stream>>>(
      log_ls, log_amp, x, mask, chol, alpha, y_mean, y_std, cand, best, ei,
      nullptr, b, d, m, xi);
  return (int)cudaGetLastError();
}

// Floats of global scratch gp_ei_launch needs at these shapes: 0 while a
// block's v fits in shared memory, k*ceil(m/T)*b*T past that.
extern "C" long long gp_ei_scratch_floats(int k, int b, int m) {
  if (smem_bytes(b) <= kMaxSmem) return 0;
  return (long long)k * ((m + kTile - 1) / kTile) * b * kTile;
}
