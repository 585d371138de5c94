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
//   tik_clip  out = max(in, 0), a NaN kept as jnp.maximum keeps it: the box
//             projection of x0 on entry (fused.py:812, which the ADMM
//             kernels do not do) and of the CG solution on exit
//             (fused.py:877). Its kernel is stream.cuh's stream_clip: bound
//             by bytes (it moves two volumes), it moves them in 16-byte
//             accesses, one chunk a thread (see the note there), legal in
//             place.
//
// nsol_tikhonov_solve enqueues every configuration's solve back to back on
// the caller's stream, with alpha and C passed in per configuration and
// every CG scalar on the device (reset per solve): the linear loss runs
// A^T b once, then per configuration the clip, the residual, iter_max
// warm-started CG steps and the exit clip; a robust loss runs the clip and
// iter_max IRLS sweeps (robust.cu nsol_irls_sweep). No host sync. Under
// compact (the reference's compact_dirs, fused.py:783-797) the CG
// directions are bfloat16: the linear CG's storage kStoreQf32 and the IRLS
// sweep's kRobustDirs, the TK0/TK1 instances of the ADMM's units.
//
// What bounds it on the H100: as admm.cu, bytes at 256^3 (tik_clip moves
// two volumes) and launches at 256^2, where one CG-10 solve is ~67 short
// launches and their host enqueue. So the linear loss runs this sequence
// only past tikhonov_persistent.cu's rule (nsol_tikhonov_persistent_route:
// more than 2^20 voxels, or a unit of the sequence on its march, as at
// 256^3, or storage other than exact and qf32): on the Lena and 64^3
// sweeps the whole batch is one cooperative launch there, the same bits.
// The robust losses run it past irls_persistent.cu's rule
// (nsol_robust_persistent_route), their batch one cooperative launch
// within it. normal_apply, cg_step, irls_head,
// blur_apply and weighted_apply take the march or the chain by
// march.cuh's vol_route, as their C entries do.

#include <cuda_runtime.h>

#include "losses.cuh"
#include "stencil.cuh"
#include "stream.cuh"

namespace {

// Kernel units of this file, the indices of its launch counts; slot 1 is
// tikhonov_persistent.cu's one-launch batch (kTikPersistent).
enum Unit { kTikClip = 0 };

}  // namespace

// ------------------------------------------------------------ C interface --
// Every function enqueues on `stream`, never synchronizes, allocates
// nothing, adds one to counts[unit] per unit it launches, and returns
// cudaGetLastError() (0 on success).

extern "C" {

// Units of admm.cu and robust.cu, each adding to its own source's counts.
// (float storage: io 0, storage 0)
int nsol_normal_apply(const void* v, void* out, float* t1, float* t2, const float* rhs,
                      double* partials, double* scal, const float* taps, int kz, int ky, int kx,
                      float rho, int reg, int io, int route, float ih2x, float ih2y, float ih2z,
                      int Z, int Y, int X, void* stream, long long* counts);
int nsol_cg_step(const void* r, const void* p, void* p_new, void* q, float* t1, float* t2,
                 double* partials, double* scal, int first, const float* taps, int kz, int ky,
                 int kx, float rho, int reg, int storage, int route, float ih2x, float ih2y,
                 float ih2z, int Z, int Y, int X, void* stream, long long* counts);
int nsol_cg_update(float* x, void* r, const void* p, const void* q, double* partials,
                   double* scal, long long n, int storage, int store_r, void* stream,
                   long long* counts);
int nsol_irls_sweep(const float* b, float* x, float* wts, float* free, float* rk, void* p0,
                    void* p1, float* q, float* xk, float* t1, float* t2, double* partials,
                    double* scal, const float* taps, int kz, int ky, int kx, float rho, int reg,
                    int storage, float ih2x, float ih2y, float ih2z, int loss, float scale,
                    int cg_iters, int Z, int Y, int X, void* stream, long long* counts);

int nsol_tik_clip(float* out, const float* in, long long n, void* stream, long long* counts) {
  cudaError_t e = stream_clip(out, in, n, (cudaStream_t)stream);
  counts[kTikClip] += 1;
  return (int)e;
}

// nconf whole Tikhonov solves from x0 into x_out[k * n] (k < nconf), the
// k-th at alphas[k] (and the robust loss's C at scales[k]; both host
// arrays). reg is a RegKind (kRegLap for TK1, kRegIdentity for TK0), loss
// a Loss; the linear loss runs iter_max CG iterations on the normal taps,
// a robust one iter_max IRLS sweeps of cg_iters CG iterations on the blur
// taps. Scratch: atb (linear only), r, p0, p1, q, t1, t2, and wts, free,
// xk (robust only). compact 1 (the reference's compact_dirs,
// fused.py:783-797): the CG directions p0, p1 are bfloat16, rounded where
// each is formed (the linear CG's storage kStoreQf32, the IRLS sweep's
// kRobustDirs); r, q, x and every sum stay float. The linear solve's
// normal_apply and cg_step and the sweeps' irls_head, blur_apply and
// weighted_apply take march.cuh's route (march or chain), so partials
// holds max(nsol_tiled_blocks, nsol_max_blocks) doubles. Counts: admm.cu's
// 9 (normal_apply, cg_step, cg_update, ..., cg_step's and normal_apply's
// marches), robust.cu's 11 (blur_apply, irls_head, weighted_apply,
// irls_step, cg_update, ..., the marches of weighted_apply, blur_apply
// and irls_head, blur_apply_prepadded's window) and this file's
// (tik_clip).
int nsol_tikhonov_solve(const float* b, const float* x0, float* x_out, float* atb, float* r,
                        void* p0, void* p1, float* q, float* t1, float* t2, float* wts,
                        float* free, float* xk, double* partials, double* scal,
                        const float* taps_a, int kaz, int kay, int kax, const float* taps_n,
                        int knz, int kny, int knx, float ih2x, float ih2y, float ih2z, int reg,
                        int loss, const float* alphas, const float* scales, int nconf,
                        int iter_max, int cg_iters, int compact, int Z, int Y, int X,
                        void* stream, long long* admm_counts, long long* robust_counts,
                        long long* counts) {
  const cudaStream_t s = (cudaStream_t)stream;
  const long long n = (long long)Z * Y * X;
  const int storage = compact ? kStoreQf32 : kStoreExact;
  const int robust_storage = compact ? kRobustDirs : kRobustExact;
  int e;
#define CALL(call)             \
  if ((e = (call)) != 0) return e;
  if (loss == kLinear)  // A^T b = A b once (A symmetric, fused.py:857)
    CALL(nsol_normal_apply(b, atb, t1, t2, nullptr, partials, scal, taps_a, kaz, kay, kax, 0.f,
                           kRegLap, 0, kRouteRule, ih2x, ih2y, ih2z, Z, Y, X, stream,
                           admm_counts));
  for (int k = 0; k < nconf; ++k) {
    float* x = x_out + k * n;
    const float alpha = alphas[k];
    // a fresh CG state per configuration: nothing of the last one leaks
    CALL((int)cudaMemsetAsync(scal, 0, 4 * sizeof(double), s));
    CALL((int)stream_clip(x, x0, n, s));
    counts[kTikClip] += 1;
    if (loss != kLinear) {
      for (int sweep = 0; sweep < iter_max; ++sweep)
        CALL(nsol_irls_sweep(b, x, wts, free, r, p0, p1, q, xk, t1, t2, partials, scal, taps_a,
                             kaz, kay, kax, alpha, reg, robust_storage, ih2x, ih2y, ih2z, loss,
                             scales[k], cg_iters, Z, Y, X, stream, robust_counts));
      continue;
    }
    // warm-started CG on (A^T A + alpha B^T B) x = A^T b (_cg_inkernel)
    CALL(nsol_normal_apply(x, r, t1, t2, atb, partials, scal, taps_n, knz, kny, knx, alpha, reg,
                           0, kRouteRule, ih2x, ih2y, ih2z, Z, Y, X, stream, admm_counts));
    void* p_prev = p0;
    void* p_cur = p1;
    for (int it = 0; it < iter_max; ++it) {
      CALL(nsol_cg_step(r, p_prev, p_cur, q, t1, t2, partials, scal, it == 0, taps_n, knz, kny,
                        knx, alpha, reg, storage, kRouteRule, ih2x, ih2y, ih2z, Z, Y, X, stream,
                        admm_counts));
      CALL(nsol_cg_update(x, r, p_cur, q, partials, scal, n, storage, 1, stream, admm_counts));
      void* tmp = p_prev;
      p_prev = p_cur;
      p_cur = tmp;
    }
    CALL((int)stream_clip(x, x, n, s));
    counts[kTikClip] += 1;
  }
#undef CALL
  return 0;
}

}  // extern "C"
