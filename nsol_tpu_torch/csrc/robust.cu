// Hopper (sm_90a) kernels of the robust (IRLS) TV deconvolution path.
//
// Counterparts of the TPU Pallas kernels
//   nsol_tpu/ops/pallas/robust.py::make_blocked_blur_operator            (:161)
//   nsol_tpu/ops/pallas/robust.py::make_blocked_weighted_normal_operator  (:264)
//   nsol_tpu/ops/pallas/fused.py::make_fused_admm_solver                  (:382, robust)
// computing the same f32 results, not their block structure. A 2-D image
// runs as a (1, Y, X) volume with z taps [1] and 1/h_z^2 = 0, so every z
// term is an exact +0.
//
// Four kernel units, each a short launch sequence on the caller's stream,
// built from the per-axis passes of stencil.cuh:
//
//   blur_apply      out = A y (blur taps); with u, + rho D^T D u. Its
//                   gradient form opens an IRLS sweep: g = A y + rho D^T D x
//                   for y = wts r, the active set free = !(x <= 0 && g > 0)
//                   as a {0, 1} float field, rk = -free g, then
//                   gamma = sum rk^2, beta = 0 (second stage).
//   irls_head       r = A x - b, wts = rho'_C(r^2) (loss by id, C at run
//                   time), y = wts r: the weights frozen for one sweep.
//   weighted_apply  p' = r + beta p (p' = r on the first trip), pf = free p',
//                   s = wts A pf, q = free (A s + rho D^T D pf) + (p' - pf),
//                   partial sums of p'.q; second stage a = gamma / pq.
//   irls_step       x = max(x + xk, 0).
// Between applies the masked CG runs stencil.cuh's cg_update (admm.cu's
// unit): xk += a p', rk -= a q, gamma' = |rk|^2, beta.
//
// What bounds them on the H100: bytes, as in admm.cu. weighted_apply, the
// CG's hot op, is two blur chains (six stencil passes) with the weight
// applied between them, where the TPU kernel kept the first chain's rows
// in VMEM. The design reuses the linear path's passes with new prologues
// (the masked CG direction) and epilogues (weights, active set, masked
// apply), keeps every CG scalar on the device, and leaves the TV prox/dual
// chain of the outer ADMM loop out of the C solve: with a robust loss the
// x-update ignores v - w (the reference's b_reg-ignoring quirk,
// nsol_tpu/solvers/tikhonov.py:222-249), so no output depends on it.

#include <cuda_runtime.h>

#include "stencil.cuh"

namespace {

// Kernel units, the indices of the launch counts handed back to Python.
enum Unit { kBlurApply = 0, kIrlsHead = 1, kWeightedApply = 2, kIrlsStep = 3, kCgUpdate = 4 };
// Losses, in the order of nsol_tpu/ops/losses.py LOSSES.
enum Loss { kLinear = 0, kSoftL1 = 1, kHuber = 2, kCauchy = 3, kArctan = 4 };

// Huber's transition (losses.py HUBER_GAMMA) and its square, squared in
// double and rounded once, as the reference's Python float is.
constexpr float kHuberGamma = 1.345f;
constexpr float kHuberGamma2 = (float)(1.345 * 1.345);

// rho'_C(f2) = rho'(f2 / C^2) (nsol_tpu/ops/losses.py:43-90): f2 / C^2 is a
// division, not a multiply by a reciprocal, and every step is rounded as
// the reference writes it (no contraction).
__device__ __forceinline__ float loss_weight(float f2, float fs2, int loss) {
  const float t = __fdiv_rn(f2, fs2);
  switch (loss) {
    case kSoftL1:
      return __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(1.f, t)));
    case kHuber:
      return t < kHuberGamma2 ? 1.f : __fdiv_rn(kHuberGamma, __fsqrt_rn(t));
    case kCauchy:
      return __fdiv_rn(1.f, __fadd_rn(1.f, t));
    case kArctan:
      return __fdiv_rn(1.f, __fadd_rn(1.f, __fmul_rn(t, t)));
    default:
      return 1.f;
  }
}

// irls_head's z epilogue: r = A x - b, wts = rho'_C(r^2), y = wts r.
struct WeightsEpi {
  const float* b;
  float* wts;
  float* y;
  float fs2;
  int loss;
  __device__ double operator()(long long i, float conv, Coord, Dims) const {
    const float r = __fsub_rn(conv, __ldg(b + i));
    const float w = loss_weight(__fmul_rn(r, r), fs2, loss);
    wts[i] = w;
    y[i] = __fmul_rn(w, r);
    return 0.0;
  }
};

// blur_apply's z epilogue: g = conv (+ rho lap(u)) into out; the gradient
// form (free given, u = x) writes the active set and rk = -free g instead
// and sums rk^2.
struct BlurEpi {
  const float* u;
  float* out;
  float* free;
  float* rk;
  float rho;
  Spacing sp;
  __device__ double operator()(long long i, float conv, Coord c, Dims d) const {
    const float g = u != nullptr ? fmaf(rho, laplacian(Load{u}, i, c, sp, d), conv) : conv;
    if (free == nullptr) {
      out[i] = g;
      return 0.0;
    }
    const bool active = __ldg(u + i) <= 0.f && g > 0.f;
    const float r = active ? 0.f : -g;
    free[i] = active ? 0.f : 1.f;
    rk[i] = r;
    return (double)r * r;
  }
};

// weighted_apply's first z epilogue: s = wts * A pf.
struct ScaleEpi {
  const float* wts;
  float* s;
  __device__ double operator()(long long i, float conv, Coord, Dims) const {
    s[i] = __fmul_rn(__ldg(wts + i), conv);
    return 0.0;
  }
};

// weighted_apply's second z epilogue: core = A s + rho lap(pf),
// q = free core + (p' - pf) (q = core when every voxel is free), p'.q
// summed. The frozen coordinates keep q = p', so pq counts them.
struct MaskedEpi {
  const float* dir;  // p'
  const float* free;
  float* q;
  float rho;
  Spacing sp;
  __device__ double operator()(long long i, float conv, Coord c, Dims d) const {
    const float* const dp = dir;
    const float* const fp = free;
    const auto pf = [dp, fp](long long k) {  // pf = free * p'
      const float v = __ldg(dp + k);
      return fp != nullptr ? __ldg(fp + k) * v : v;
    };
    const float core = fmaf(rho, laplacian(pf, i, c, sp, d), conv);
    const float p = __ldg(dir + i);
    float qi = core;
    if (free != nullptr) {
      const float f = __ldg(free + i);
      qi = __fadd_rn(__fmul_rn(f, core), __fsub_rn(p, __fmul_rn(f, p)));
    }
    q[i] = qi;
    return (double)p * qi;
  }
};

__global__ void irls_step_kernel(float* __restrict__ x, const float* __restrict__ xk,
                                 long long n) {
  GRID_STRIDE(i, n) x[i] = fmaxf(__fadd_rn(x[i], xk[i]), 0.f);
}

// ---------------------------------------------------------------- units --

cudaError_t blur_apply(const float* y, const float* u, float* out, float* free, float* rk,
                       float* t1, float* t2, double* partials, double* scal, Taps tp, float rho,
                       Spacing sp, Dims d, cudaStream_t s) {
  const bool grad = free != nullptr;
  blur_chain(Load{y}, nullptr, BlurEpi{u, out, free, rk, rho, sp}, grad ? partials : nullptr,
             t1, t2, tp, d, s);
  if (grad)
    reduce_kernel<<<1, kReduceThreads, 0, s>>>(partials, grid_for(d.n()), scal, kReduceRR0);
  return cudaGetLastError();
}

cudaError_t irls_head(const float* x, const float* b, float* wts, float* y, float* t1,
                      float* t2, Taps tp, int loss, float scale, Dims d, cudaStream_t s) {
  blur_chain(Load{x}, nullptr, WeightsEpi{b, wts, y, scale * scale, loss}, nullptr, t1, t2, tp,
             d, s);
  return cudaGetLastError();
}

// Two chains: x(p') -> t1 -> t2 -> s in t1; then x(s) -> t2 -> t1 -> q.
cudaError_t weighted_apply(const float* r, const float* p, float* p_new, float* q,
                           const float* free, const float* wts, float* t1, float* t2,
                           double* partials, double* scal, int first, Taps tp, float rho,
                           Spacing sp, Dims d, cudaStream_t s) {
  if (free != nullptr)
    blur_chain(MaskedDirection{r, p, free, scal, first, 0.f}, p_new, ScaleEpi{wts, t1}, nullptr,
               t1, t2, tp, d, s);
  else
    blur_chain(Direction{r, p, nullptr, scal, first, 0.f}, p_new, ScaleEpi{wts, t1}, nullptr, t1,
               t2, tp, d, s);
  blur_chain(Load{t1}, nullptr, MaskedEpi{p_new, free, q, rho, sp}, partials, t2, t1, tp, d, s);
  reduce_kernel<<<1, kReduceThreads, 0, s>>>(partials, grid_for(d.n()), scal, kReducePQ);
  return cudaGetLastError();
}

cudaError_t irls_step(float* x, const float* xk, long long n, cudaStream_t s) {
  irls_step_kernel<<<grid_for(n), kThreads, 0, s>>>(x, xk, n);
  return cudaGetLastError();
}

}  // namespace

// ------------------------------------------------------------ C interface --
// Every function enqueues on `stream`, never synchronizes, allocates
// nothing, adds one to counts[unit] per unit it launches, and returns
// cudaGetLastError() (0 on success). Spacing enters as 1/h^2 in (x, y, z)
// order; loss is an index of the Loss enum.

extern "C" {

int nsol_blur_apply(const float* y, const float* u, float* out, float* free, float* rk,
                    float* t1, float* t2, double* partials, double* scal, const float* taps,
                    int kz, int ky, int kx, float rho, float ih2x, float ih2y, float ih2z, int Z,
                    int Y, int X, void* stream, long long* counts) {
  const Spacing sp{0.f, 0.f, 0.f, ih2x, ih2y, ih2z};
  cudaError_t e = blur_apply(y, u, out, free, rk, t1, t2, partials, scal,
                             make_taps(taps, kz, ky, kx), rho, sp, Dims{Z, Y, X},
                             (cudaStream_t)stream);
  counts[kBlurApply] += 1;
  return (int)e;
}

int nsol_irls_head(const float* x, const float* b, float* wts, float* y, float* t1, float* t2,
                   const float* taps, int kz, int ky, int kx, int loss, float scale, int Z, int Y,
                   int X, void* stream, long long* counts) {
  cudaError_t e = irls_head(x, b, wts, y, t1, t2, make_taps(taps, kz, ky, kx), loss, scale,
                            Dims{Z, Y, X}, (cudaStream_t)stream);
  counts[kIrlsHead] += 1;
  return (int)e;
}

int nsol_weighted_apply(const float* r, const float* p, float* p_new, float* q,
                        const float* free, const float* wts, float* t1, float* t2,
                        double* partials, double* scal, int first, const float* taps, int kz,
                        int ky, int kx, float rho, float ih2x, float ih2y, float ih2z, int Z,
                        int Y, int X, void* stream, long long* counts) {
  const Spacing sp{0.f, 0.f, 0.f, ih2x, ih2y, ih2z};
  cudaError_t e = weighted_apply(r, p, p_new, q, free, wts, t1, t2, partials, scal, first,
                                 make_taps(taps, kz, ky, kx), rho, sp, Dims{Z, Y, X},
                                 (cudaStream_t)stream);
  counts[kWeightedApply] += 1;
  return (int)e;
}

int nsol_irls_step(float* x, const float* xk, long long n, void* stream, long long* counts) {
  cudaError_t e = irls_step(x, xk, n, (cudaStream_t)stream);
  counts[kIrlsStep] += 1;
  return (int)e;
}

// The whole robust ADMM solve (fused.py:382 robust branch, robust.py:406):
// iterations x iter_max IRLS sweeps, each irls_head, blur_apply's gradient
// form, cg_iters x (weighted_apply, cg_update) from xk = 0, and irls_step.
// x holds x0 on entry and the result on exit; as in both TPU kernels x0 is
// not clipped on entry (tikhonov.py:130 clips it).
int nsol_robust_admm_solve(const float* b, float* x, float* wts, float* free, float* rk,
                           float* p0, float* p1, float* q, float* xk, float* t1, float* t2,
                           double* partials, double* scal, const float* taps, int kz, int ky,
                           int kx, float rho, float ih2x, float ih2y, float ih2z, int loss,
                           float scale, int iterations, int iter_max, int cg_iters, int Z, int Y,
                           int X, void* stream, long long* counts) {
  const cudaStream_t s = (cudaStream_t)stream;
  const Dims d{Z, Y, X};
  const Spacing sp{0.f, 0.f, 0.f, ih2x, ih2y, ih2z};
  const Taps tp = make_taps(taps, kz, ky, kx);
#define UNIT(idx, call) NSOL_UNIT(counts, idx, call)
  for (int it = 0; it < iterations; ++it) {
    for (int sweep = 0; sweep < iter_max; ++sweep) {
      // q holds y = wts r until the first apply of the sweep overwrites it
      UNIT(kIrlsHead, irls_head(x, b, wts, q, t1, t2, tp, loss, scale, d, s));
      UNIT(kBlurApply,
           blur_apply(q, x, nullptr, free, rk, t1, t2, partials, scal, tp, rho, sp, d, s));
      const cudaError_t e = cudaMemsetAsync(xk, 0, d.n() * sizeof(float), s);
      if (e != cudaSuccess) return (int)e;
      float* p_prev = p0;
      float* p_cur = p1;
      for (int k = 0; k < cg_iters; ++k) {
        UNIT(kWeightedApply, weighted_apply(rk, p_prev, p_cur, q, free, wts, t1, t2, partials,
                                            scal, k == 0, tp, rho, sp, d, s));
        UNIT(kCgUpdate, cg_update(xk, rk, p_cur, q, partials, scal, d.n(), s));
        float* tmp = p_prev;
        p_prev = p_cur;
        p_cur = tmp;
      }
      UNIT(kIrlsStep, irls_step(x, xk, d.n(), s));
    }
  }
#undef UNIT
  return 0;
}

}  // extern "C"
