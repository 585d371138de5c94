// Hopper (sm_90a) kernels of the Tikhonov (TK0/TK1) deconvolution path.
//
// Counterpart of the TPU Pallas kernel
//   nsol_tpu/ops/pallas/fused.py::make_fused_tikhonov_solver  (:716)
// computing the same f32 result, not its block structure: the whole
// Tikhonov solve of min 1/2 sum rho_C((Ax - b)^2) + alpha/2 |Bx|^2 with
// b_reg = 0 and the box (0, inf), for a batch of (alpha, C) configurations.
//
// The solve reuses the units of admm.cu and robust.cu with the runtime
// coefficient rho set to alpha and the regulariser B^T B a template
// parameter of their epilogues (the Laplacian for TK1, the identity for
// TK0; see stencil.cuh reg_normal). This file adds one kernel unit:
//
//   tik_clip  out = max(in, 0): the box projection of x0 on entry
//             (fused.py:812, which the ADMM kernels do not do) and of the
//             CG solution on exit (fused.py:877).
//
// nsol_tikhonov_solve enqueues every configuration's solve back to back on
// the caller's stream, with alpha and C passed in per configuration and
// every CG scalar on the device (reset per solve): the linear loss runs
// A^T b once, then per configuration the clip, the residual, iter_max
// warm-started CG steps and the exit clip; a robust loss runs the clip and
// iter_max IRLS sweeps (robust.cu nsol_irls_sweep). No host sync.
//
// What bounds it on the H100: as admm.cu, bytes at 256^3 (tik_clip moves
// two volumes) and launches at 256^2, where one CG-10 solve is ~67 short
// launches and their host enqueue.

#include <cuda_runtime.h>

#include "losses.cuh"
#include "stencil.cuh"

namespace {

// Kernel units of this file, the indices of its launch counts.
enum Unit { kTikClip = 0 };

// in place when out == in (the exit clip), so no __restrict__
__global__ void clip_kernel(float* out, const float* in, long long n) {
  GRID_STRIDE(i, n) out[i] = fmaxf(in[i], 0.f);
}

cudaError_t tik_clip(float* out, const float* in, long long n, cudaStream_t s) {
  clip_kernel<<<grid_for(n), kThreads, 0, s>>>(out, in, n);
  return cudaGetLastError();
}

}  // namespace

// ------------------------------------------------------------ C interface --
// Every function enqueues on `stream`, never synchronizes, allocates
// nothing, adds one to counts[unit] per unit it launches, and returns
// cudaGetLastError() (0 on success).

extern "C" {

// Units of admm.cu and robust.cu, each adding to its own source's counts.
int nsol_normal_apply(const float* v, float* out, float* t1, float* t2, const float* rhs,
                      double* partials, double* scal, const float* taps, int kz, int ky, int kx,
                      float rho, int reg, float ih2x, float ih2y, float ih2z, int Z, int Y, int X,
                      void* stream, long long* counts);
int nsol_cg_step(const float* r, const float* p, float* p_new, float* q, float* t1, float* t2,
                 double* partials, double* scal, int first, const float* taps, int kz, int ky,
                 int kx, float rho, int reg, float ih2x, float ih2y, float ih2z, int Z, int Y,
                 int X, void* stream, long long* counts);
int nsol_cg_update(float* x, float* r, const float* p, const float* q, double* partials,
                   double* scal, long long n, void* stream, long long* counts);
int nsol_irls_sweep(const float* b, float* x, float* wts, float* free, float* rk, float* p0,
                    float* p1, float* q, float* xk, float* t1, float* t2, double* partials,
                    double* scal, const float* taps, int kz, int ky, int kx, float rho, int reg,
                    float ih2x, float ih2y, float ih2z, int loss, float scale, int cg_iters,
                    int Z, int Y, int X, void* stream, long long* counts);

int nsol_tik_clip(float* out, const float* in, long long n, void* stream, long long* counts) {
  cudaError_t e = tik_clip(out, in, n, (cudaStream_t)stream);
  counts[kTikClip] += 1;
  return (int)e;
}

// nconf whole Tikhonov solves from x0 into x_out[k * n] (k < nconf), the
// k-th at alphas[k] (and the robust loss's C at scales[k]; both host
// arrays). reg is a RegKind (kRegLap for TK1, kRegIdentity for TK0), loss
// a Loss; the linear loss runs iter_max CG iterations on the normal taps,
// a robust one iter_max IRLS sweeps of cg_iters CG iterations on the blur
// taps. Scratch: atb (linear only), r, p0, p1, q, t1, t2, and wts, free,
// xk (robust only). Counts: admm.cu's (normal_apply, cg_step, cg_update),
// robust.cu's (blur_apply, irls_head, weighted_apply, irls_step,
// cg_update) and this file's (tik_clip).
int nsol_tikhonov_solve(const float* b, const float* x0, float* x_out, float* atb, float* r,
                        float* p0, float* p1, float* q, float* t1, float* t2, float* wts,
                        float* free, float* xk, double* partials, double* scal,
                        const float* taps_a, int kaz, int kay, int kax, const float* taps_n,
                        int knz, int kny, int knx, float ih2x, float ih2y, float ih2z, int reg,
                        int loss, const float* alphas, const float* scales, int nconf,
                        int iter_max, int cg_iters, int Z, int Y, int X, void* stream,
                        long long* admm_counts, long long* robust_counts,
                        long long* counts) {
  const cudaStream_t s = (cudaStream_t)stream;
  const long long n = (long long)Z * Y * X;
  int e;
#define CALL(call)             \
  if ((e = (call)) != 0) return e;
  if (loss == kLinear)  // A^T b = A b once (A symmetric, fused.py:857)
    CALL(nsol_normal_apply(b, atb, t1, t2, nullptr, partials, scal, taps_a, kaz, kay, kax, 0.f,
                           kRegLap, ih2x, ih2y, ih2z, Z, Y, X, stream, admm_counts));
  for (int k = 0; k < nconf; ++k) {
    float* x = x_out + k * n;
    const float alpha = alphas[k];
    // a fresh CG state per configuration: nothing of the last one leaks
    CALL((int)cudaMemsetAsync(scal, 0, 4 * sizeof(double), s));
    CALL((int)tik_clip(x, x0, n, s));
    counts[kTikClip] += 1;
    if (loss != kLinear) {
      for (int sweep = 0; sweep < iter_max; ++sweep)
        CALL(nsol_irls_sweep(b, x, wts, free, r, p0, p1, q, xk, t1, t2, partials, scal, taps_a,
                             kaz, kay, kax, alpha, reg, ih2x, ih2y, ih2z, loss, scales[k],
                             cg_iters, Z, Y, X, stream, robust_counts));
      continue;
    }
    // warm-started CG on (A^T A + alpha B^T B) x = A^T b (_cg_inkernel)
    CALL(nsol_normal_apply(x, r, t1, t2, atb, partials, scal, taps_n, knz, kny, knx, alpha, reg,
                           ih2x, ih2y, ih2z, Z, Y, X, stream, admm_counts));
    float* p_prev = p0;
    float* p_cur = p1;
    for (int it = 0; it < iter_max; ++it) {
      CALL(nsol_cg_step(r, p_prev, p_cur, q, t1, t2, partials, scal, it == 0, taps_n, knz, kny,
                        knx, alpha, reg, ih2x, ih2y, ih2z, Z, Y, X, stream, admm_counts));
      CALL(nsol_cg_update(x, r, p_cur, q, partials, scal, n, stream, admm_counts));
      float* tmp = p_prev;
      p_prev = p_cur;
      p_cur = tmp;
    }
    CALL((int)tik_clip(x, x, n, s));
    counts[kTikClip] += 1;
  }
#undef CALL
  return 0;
}

}  // extern "C"
