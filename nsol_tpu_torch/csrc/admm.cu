// Hopper (sm_90a) kernels of the 3-D TV-L2 ADMM deconvolution path.
//
// Counterparts of the TPU Pallas kernels
//   nsol_tpu/ops/pallas/blocked.py::make_blocked_normal_operator  (:402)
//   nsol_tpu/ops/pallas/blocked.py::make_blocked_cg_step          (:988)
//   nsol_tpu/ops/pallas/fused.py::make_fused_admm_solver          (:382, linear)
// computing the same f32 results, not their block structure.
//
// Volumes are (Z, Y, X) float32, X contiguous. Four kernel units, each a
// short sequence of launches on the caller's stream:
//
//   normal_apply  q = N_z N_y N_x v + rho * sum_ax (1/h_ax^2) D_ax^T D_ax v
//                 (self-correlated separable wrap blur + zero-boundary
//                 Laplacian). One pass per axis through two scratch volumes;
//                 the z pass adds the Laplacian and an epilogue (plain q, or
//                 the CG residual rhs - q with the partial sums of its square).
//   cg_step       p' = r + beta p formed on the fly inside the x pass, then
//                 q = M p' and the partial sums of p'.q; second stage
//                 a = gamma / pq.
//   cg_update     x += a p', r -= a q and the partial sums of r^2; second
//                 stage beta = gamma' / gamma, gamma = gamma'.
//   admm_tail     clip x >= 0, t = grad x / h + w, grouped shrink at
//                 tau = alpha / rho, v, w updates; then the next
//                 rhs = A^T b + rho div(v - w) (two passes: the divergence
//                 needs neighbours of v - w).
//
// What bounds them on the H100: memory traffic, at a few flops per byte.
// At 64^3 (1 MiB a volume) the whole state sits in the 50 MB L2 and a
// solve is ~3300 short launches, so launches and their host enqueue bound
// it; at 256^3 (64 MiB a volume) the elementwise passes run near HBM
// bandwidth and the per-axis stencil passes, which read every tap through
// L2, at a fraction of it. The design keeps the passes simple (all loads
// coalesced along X, no shared-memory tiles yet) and keeps every CG scalar
// on the device, so nothing waits for the host inside a solve. The per-axis
// passes and the CG update live in stencil.cuh, shared with robust.cu.
//
// Reductions are deterministic: each block reduces its grid-stride slice
// in double in a fixed order, writes one partial, and a one-block second
// stage sums the partials in a fixed order. No atomics, so a run repeats
// bit for bit.

#include <cuda_runtime.h>

#include "stencil.cuh"

namespace {

// Kernel units, the indices of the launch counts handed back to Python.
enum Unit { kNormalApply = 0, kCgStep = 1, kCgUpdate = 2, kAdmmTail = 3 };
// Epilogues of the z pass.
enum Epilogue { kPlain = 0, kDot = 1, kResidual = 2 };

__device__ __forceinline__ float clip0(float u) { return u < 0.f ? 0.f : u; }

// z-pass epilogue of the normal operator: q = conv_z + rho * lap(v), then
// plain q, the CG residual rhs - q with its square summed, or q with v.q
// summed.
struct NormalEpi {
  const float* v;
  const float* rhs;
  float* out;
  float rho;
  Spacing sp;
  int mode;
  __device__ double operator()(long long i, float conv, Coord c, Dims d) const {
    const float q = fmaf(rho, laplacian(Load{v}, i, c, sp, d), conv);
    if (mode == kResidual) {
      const float res = rhs[i] - q;
      out[i] = res;
      return (double)res * res;
    }
    // v[i] is read before the store: the compiler cannot tell that out
    // does not alias v, and a load after the store waits for it.
    const double dot = mode == kDot ? (double)__ldg(v + i) * q : 0.0;
    out[i] = q;
    return dot;
  }
};

// ADMM prox/dual update (fused.py:651-667). init: v = grad x (unclipped),
// w = 0 (fused.py:579-580).
__global__ void admm_shrink_kernel(const float* __restrict__ x, float* __restrict__ v,
                                   float* __restrict__ w, Spacing sp, float tau, int init,
                                   Dims d) {
  auto xc = [&](long long k) { return init ? x[k] : clip0(x[k]); };
  const long long n = d.n(), plane = d.plane();
  GRID_STRIDE(i, n) {
    const int ix = (int)(i % d.X);
    const int iy = (int)((i / d.X) % d.Y);
    const int iz = (int)(i / plane);
    const float c = xc(i);
    const float gx = ((ix + 1 < d.X ? xc(i + 1) : 0.f) - c) * sp.ihx;
    const float gy = ((iy + 1 < d.Y ? xc(i + d.X) : 0.f) - c) * sp.ihy;
    const float gz = ((iz + 1 < d.Z ? xc(i + plane) : 0.f) - c) * sp.ihz;
    if (init) {
      v[i] = gx;
      v[n + i] = gy;
      v[2 * n + i] = gz;
      w[i] = 0.f;
      w[n + i] = 0.f;
      w[2 * n + i] = 0.f;
      continue;
    }
    const float tx = gx + w[i], ty = gy + w[n + i], tz = gz + w[2 * n + i];
    const float norm = sqrtf(tx * tx + ty * ty + tz * tz);
    const float scale = norm > tau ? fmaxf(norm - tau, 0.f) / norm : 0.f;
    const float vx = tx * scale, vy = ty * scale, vz = tz * scale;
    v[i] = vx;
    v[n + i] = vy;
    v[2 * n + i] = vz;
    w[i] = tx - vx;
    w[n + i] = ty - vy;
    w[2 * n + i] = tz - vz;
  }
}

// rhs = A^T b + rho * sum_k D_k^T (v_k - w_k) / h_k (fused.py:645), and
// x = max(x, 0) in place when clip is set (fused.py:651).
__global__ void admm_rhs_kernel(float* __restrict__ x, const float* __restrict__ v,
                                const float* __restrict__ w, const float* __restrict__ atb,
                                float* __restrict__ rhs, Spacing sp, float rho, int clip,
                                Dims d) {
  const long long n = d.n(), plane = d.plane();
  auto dvw = [&](int k, long long j) { return v[k * n + j] - w[k * n + j]; };
  GRID_STRIDE(i, n) {
    const int ix = (int)(i % d.X);
    const int iy = (int)((i / d.X) % d.Y);
    const int iz = (int)(i / plane);
    const float dx = (ix > 0 ? dvw(0, i - 1) : 0.f) - dvw(0, i);
    const float dy = (iy > 0 ? dvw(1, i - d.X) : 0.f) - dvw(1, i);
    const float dz = (iz > 0 ? dvw(2, i - plane) : 0.f) - dvw(2, i);
    const float div = dx * sp.ihx + dy * sp.ihy + dz * sp.ihz;
    rhs[i] = fmaf(rho, div, atb[i]);
    if (clip) x[i] = clip0(x[i]);
  }
}

// ---------------------------------------------------------------- units --

cudaError_t normal_apply(const float* v, float* out, float* t1, float* t2, const float* rhs,
                         double* partials, double* scal, Taps tp, float rho, Spacing sp,
                         Dims d, cudaStream_t s) {
  const NormalEpi epi{v, rhs, out, rho, sp, rhs != nullptr ? kResidual : kPlain};
  blur_chain(Load{v}, nullptr, epi, rhs != nullptr ? partials : nullptr, t1, t2, tp, d, s);
  if (rhs != nullptr)
    reduce_kernel<<<1, kReduceThreads, 0, s>>>(partials, grid_for(d.n()), scal, kReduceRR0);
  return cudaGetLastError();
}

cudaError_t cg_step(const float* r, const float* p, float* p_new, float* q, float* t1,
                    float* t2, double* partials, double* scal, int first, Taps tp, float rho,
                    Spacing sp, Dims d, cudaStream_t s) {
  const Direction dir{r, p, nullptr, scal, first, 0.f};
  blur_chain(dir, p_new, NormalEpi{p_new, nullptr, q, rho, sp, kDot}, partials, t1, t2, tp, d,
             s);
  reduce_kernel<<<1, kReduceThreads, 0, s>>>(partials, grid_for(d.n()), scal, kReducePQ);
  return cudaGetLastError();
}

cudaError_t admm_tail(float* x, float* v, float* w, const float* atb, float* rhs, Spacing sp,
                      float tau, float rho, int init, Dims d, cudaStream_t s) {
  const int g = grid_for(d.n());
  admm_shrink_kernel<<<g, kThreads, 0, s>>>(x, v, w, sp, tau, init, d);
  admm_rhs_kernel<<<g, kThreads, 0, s>>>(x, v, w, atb, rhs, sp, rho, init ? 0 : 1, d);
  return cudaGetLastError();
}

}  // namespace

// ------------------------------------------------------------ C interface --
// Every function enqueues on `stream`, never synchronizes, allocates
// nothing, adds one to counts[unit] per unit it launches, and returns
// cudaGetLastError() (0 on success).

extern "C" {

int nsol_max_blocks() { return kMaxBlocks; }

int nsol_normal_apply(const float* v, float* out, float* t1, float* t2, const float* rhs,
                      double* partials, double* scal, const float* taps, int kz, int ky, int kx,
                      float rho, float ih2x, float ih2y, float ih2z, int Z, int Y, int X,
                      void* stream, long long* counts) {
  const Spacing sp{0.f, 0.f, 0.f, ih2x, ih2y, ih2z};
  cudaError_t e = normal_apply(v, out, t1, t2, rhs, partials, scal, make_taps(taps, kz, ky, kx),
                               rho, sp, Dims{Z, Y, X}, (cudaStream_t)stream);
  counts[kNormalApply] += 1;
  return (int)e;
}

int nsol_cg_step(const float* r, const float* p, float* p_new, float* q, float* t1, float* t2,
                 double* partials, double* scal, int first, const float* taps, int kz, int ky,
                 int kx, float rho, float ih2x, float ih2y, float ih2z, int Z, int Y, int X,
                 void* stream, long long* counts) {
  const Spacing sp{0.f, 0.f, 0.f, ih2x, ih2y, ih2z};
  cudaError_t e = cg_step(r, p, p_new, q, t1, t2, partials, scal, first,
                          make_taps(taps, kz, ky, kx), rho, sp, Dims{Z, Y, X},
                          (cudaStream_t)stream);
  counts[kCgStep] += 1;
  return (int)e;
}

int nsol_cg_update(float* x, float* r, const float* p, const float* q, double* partials,
                   double* scal, long long n, void* stream, long long* counts) {
  cudaError_t e = cg_update(x, r, p, q, partials, scal, n, (cudaStream_t)stream);
  counts[kCgUpdate] += 1;
  return (int)e;
}

int nsol_admm_tail(float* x, float* v, float* w, const float* atb, float* rhs, float ihx,
                   float ihy, float ihz, float tau, float rho, int init, int Z, int Y, int X,
                   void* stream, long long* counts) {
  const Spacing sp{ihx, ihy, ihz, 0.f, 0.f, 0.f};
  cudaError_t e = admm_tail(x, v, w, atb, rhs, sp, tau, rho, init, Dims{Z, Y, X},
                            (cudaStream_t)stream);
  counts[kAdmmTail] += 1;
  return (int)e;
}

// The whole linear ADMM TV-L2 solve (fused.py:382, linear branch), enqueued
// on `stream`. x holds x0 on entry and the result on exit. As in the fused
// TPU kernel, x0 is not clipped on entry (tikhonov.py:130 clips it; the two
// agree for x0 = b >= 0).
int nsol_admm_solve(const float* b, float* x, float* v, float* w, float* atb, float* rhs,
                    float* r, float* p0, float* p1, float* q, float* t1, float* t2,
                    double* partials, double* scal, const float* taps_a, int kaz, int kay,
                    int kax, const float* taps_n, int knz, int kny, int knx, float ihx,
                    float ihy, float ihz, float ih2x, float ih2y, float ih2z, float tau,
                    float rho, int iterations, int iter_max, int Z, int Y, int X,
                    void* stream, long long* counts) {
  const cudaStream_t s = (cudaStream_t)stream;
  const Dims d{Z, Y, X};
  const Spacing sp{ihx, ihy, ihz, ih2x, ih2y, ih2z};
  const Taps ta = make_taps(taps_a, kaz, kay, kax);
  const Taps tn = make_taps(taps_n, knz, kny, knx);
#define UNIT(idx, call) NSOL_UNIT(counts, idx, call)
  // A^T b = A b once (A symmetric, fused.py:576), then v0 = grad x0, w0 = 0
  // and the first rhs.
  UNIT(kNormalApply, normal_apply(b, atb, t1, t2, nullptr, partials, scal, ta, 0.f, sp, d, s));
  UNIT(kAdmmTail, admm_tail(x, v, w, atb, rhs, sp, tau, rho, 1, d, s));
  for (int it = 0; it < iterations; ++it) {
    // warm-started CG on M x = rhs: r = rhs - M x, gamma = |r|^2
    UNIT(kNormalApply, normal_apply(x, r, t1, t2, rhs, partials, scal, tn, rho, sp, d, s));
    float* p_prev = p0;
    float* p_cur = p1;
    for (int k = 0; k < iter_max; ++k) {
      UNIT(kCgStep, cg_step(r, p_prev, p_cur, q, t1, t2, partials, scal, k == 0, tn, rho, sp,
                            d, s));
      UNIT(kCgUpdate, cg_update(x, r, p_cur, q, partials, scal, d.n(), s));
      float* tmp = p_prev;
      p_prev = p_cur;
      p_cur = tmp;
    }
    UNIT(kAdmmTail, admm_tail(x, v, w, atb, rhs, sp, tau, rho, 0, d, s));
  }
#undef UNIT
  return 0;
}

}  // extern "C"
