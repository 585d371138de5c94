// Hopper (sm_90a) kernels of the robust (IRLS) TV deconvolution path.
//
// Counterparts of the TPU Pallas kernels
//   nsol_tpu/ops/pallas/robust.py::make_blocked_blur_operator            (:161)
//   nsol_tpu/ops/pallas/robust.py::make_blocked_weighted_normal_operator  (:264)
//   nsol_tpu/ops/pallas/fused.py::make_fused_admm_solver                  (:382, robust)
// and, through tikhonov.cu, the robust branch of
//   nsol_tpu/ops/pallas/fused.py::make_fused_tikhonov_solver              (:716)
// computing the same f32 results, not their block structure. A 2-D image
// runs as a (1, Y, X) volume with z taps [1] and 1/h_z^2 = 0, so every z
// term is an exact +0.
//
// Four kernel units, each a short launch sequence on the caller's stream,
// built from the per-axis passes of stencil.cuh, of which blur_apply,
// irls_head and weighted_apply run as one-pass marches (march.cuh)
// instead wherever march.cuh's vol_route takes the taps and the shape (a
// volume past the fused solves' volumes, deep enough for the march's z
// halo, whose taps fit a block), with no scratch volume and the same
// outputs bit for bit; the sweeps (here and in tikhonov.cu) take the same
// rule:
//
//   blur_apply      out = A y (blur taps); with u, + rho B^T B u (B^T B the
//                   Laplacian D^T D, or the identity for Tikhonov TK0, a
//                   template parameter as in admm.cu). Its gradient form
//                   opens an IRLS sweep: g = A y + rho B^T B x
//                   for y = wts r, the active set free = !(x <= 0 && g > 0)
//                   as a {0, 1} float field, rk = -free g, then
//                   gamma = sum rk^2, beta = 0 (second stage). Its march
//                   is blur_march.cu's.
//   irls_head       r = A x - b, wts = rho'_C(r^2) (loss by id, C at run
//                   time), y = wts r: the weights frozen for one sweep.
//                   Its march is blur_march.cu's head form.
//   weighted_apply  p' = r + beta p (p' = r on the first trip), pf = free p',
//                   s = wts A pf, q = free (A s + rho B^T B pf) + (p' - pf),
//                   partial sums of p'.q; second stage a = gamma / pq. Its
//                   march (weighted_march.cu) replaces the six passes
//                   below.
//   irls_step       x = max(x + xk, 0), a NaN kept as jnp.maximum keeps it
//                   (fused.py:622; common.cuh clip0).
// and two per-shard units of the sharded path, the prepadded=True forms of
// the two TPU kernels above (robust.py:184,240-257 and :286-401), on a
// z-window whose halo planes the ring halo exchange has attached:
//   blur_apply_prepadded      out = A y (+ rho D^T D u) on the Zl centre
//                   planes of y_ext, u_ext (halo h = max(r_a, 1), r_a the
//                   blur taps' half-width); the Laplacian's z neighbours
//                   come from the halo rows, its zero-boundary rows only at
//                   global rows 0 and z_total - 1. Where its taps fit a
//                   block the wrapper takes blur_march.cu's window march
//                   (no scratch volumes, the C entry handing it on).
//   weighted_apply_prepadded  out = A (w * A v) + rho D^T D v on the centre
//                   of v_ext, w_ext (halo r = max(2 r_a, 1)): the first
//                   chain gives A v on the Zl + 2 r_a rows the second one
//                   needs, w is read there, the second chain and the
//                   Laplacian give the Zl centre rows. Its io instance (the
//                   reference's prepadded io_dtype=bfloat16,
//                   parallel/blocked_halo.py:115-119, K10b.6) reads v_ext and
//                   w_ext as bfloat16 and stores out in bfloat16, rounded
//                   once; the arithmetic and the scratch stay float.
// Both run stencil.cuh's window chain (x and y passes on every plane of the
// window, a z pass with no wrap) and GlobalRows only where their taps do
// not fit a block of their march: blur_march.cu's window for the first,
// tiled.cu's weighted march for the second, which the wrapper takes
// otherwise (no scratch volumes, the C entry handing it on).
//
// Storage (the reference's compact_dirs / io_dtype, stencil.cuh's
// RobustStorage): weighted_apply and the sweep take a mode. kRobustDirs
// (the fused solves' compact_dirs, fused.py:583-622 with _cg_inkernel's
// round_dir) stores p' in bfloat16, rounded where it is formed; the
// weights, q, x, r and every sum stay float. kRobustIo
// (blocked_robust_admm_solve's compact_dirs, robust.py:469-548, the
// weighted operator's io_dtype) also reads the weights as bfloat16 (the
// reference's wts16, here rounded as they are read rather than copied)
// and rounds the core A (w A pf) + rho B^T B pf to bfloat16 before q is
// formed in float; the head, the gradient (with the float weights) and the
// step stay float. The masked CG's update then reads a bfloat16 p'.
// Between applies the masked CG runs stencil.cuh's cg_update (admm.cu's
// unit): xk += a p', rk -= a q, gamma' = |rk|^2, beta. The sweep is a
// template: its tiled instance (nsol_robust_admm_solve_zy, the 512-wide-
// plane route) runs tiled.cu's one-pass blur_apply_zy and
// weighted_apply_zy in place of irls_head, blur_apply and weighted_apply.
//
// The units' pass bodies (their epilogues, irls_step's voxel) live in
// robust_units.cuh, which irls_persistent.cu runs too:
// where its rule (nsol_robust_persistent_route) takes the shape, the
// robust solves run every sweep of this sequence as one cooperative
// launch instead, the same bits.
//
// What bounds the chains on the H100: bytes, as in admm.cu. The chain of
// weighted_apply, the CG's hot op, is two blur chains (six stencil
// passes) with the weight applied between them, where the TPU kernel kept
// the first chain's rows in VMEM. The design reuses the linear path's
// passes with new prologues (the masked CG direction) and epilogues
// (weights, active set, masked apply), keeps every CG scalar on the
// device, and leaves the TV prox/dual
// chain of the outer ADMM loop out of the C solve: with a robust loss the
// x-update ignores v - w (the reference's b_reg-ignoring quirk,
// nsol_tpu/solvers/tikhonov.py:222-249), so no output depends on it.

#include <cuda_runtime.h>

#include "losses.cuh"
#include "robust_units.cuh"
#include "stencil.cuh"

namespace {

// Kernel units, the indices of the launch counts handed back to Python.
enum Unit {
  kBlurApply = 0,
  kIrlsHead = 1,
  kWeightedApply = 2,
  kIrlsStep = 3,
  kCgUpdate = 4,
  kBlurApplyPre = 5,
  kWeightedApplyPre = 6,
  kWeightedApplyMarch = 7,  // weighted_apply on weighted_march.cu's march
  kBlurApplyMarch = 8,      // blur_apply on blur_march.cu's march
  kIrlsHeadMarch = 9,       // irls_head on blur_march.cu's march
  kBlurApplyPreMarch = 10   // blur_apply_prepadded on blur_march.cu's window
};
// Slot 11 is irls_persistent.cu's one-launch sweep (kIrlsPersistent).

// weighted_apply_prepadded's second z epilogue: out = conv + rho D^T D v
// on the window's centre, v read and out stored as T (bfloat16 under the
// io storage, rounded once).
template <class T>
struct WindowOutEpi {
  const T* v;  // the window's centre planes
  T* out;
  float rho;
  Spacing sp;
  __device__ double operator()(long long i, float conv, Coord c, Dims d) const {
    out[i] = store_as<T>(fmaf(rho, reg_normal<kRegLap>(LoadT<T>{v}, i, c, sp, d), conv));
    return 0.0;
  }
};

__global__ void irls_step_kernel(float* __restrict__ x, const float* __restrict__ xk,
                                 long long n) {
  GRID_STRIDE(i, n) irls_step_voxel(x, xk, i);
}

// ---------------------------------------------------------------- units --

cudaError_t blur_apply(const float* y, const float* u, float* out, float* free, float* rk,
                       float* t1, float* t2, double* partials, double* scal, Taps tp, float rho,
                       int reg, Spacing sp, Dims d, cudaStream_t s) {
  const bool grad = free != nullptr;
  double* parts = grad ? partials : nullptr;
  if (reg == kRegIdentity)
    blur_chain(Load{y}, nullptr, BlurEpi<kRegIdentity>{u, out, free, rk, rho, sp}, parts, t1, t2,
               tp, d, s);
  else
    blur_chain(Load{y}, nullptr, BlurEpi<kRegLap>{u, out, free, rk, rho, sp}, parts, t1, t2, tp,
               d, s);
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
// S (RobustT): p, p' stored as S::P, the weights read at S::W, the core
// rounded with S::kIo.
template <class S>
void weighted_apply_t(const float* r, const typename S::P* p, typename S::P* p_new, float* q,
                      const float* free, const float* wts, float* t1, float* t2,
                      double* partials, double* scal, int first, Taps tp, float rho, int reg,
                      Spacing sp, Dims d, cudaStream_t s) {
  using P = typename S::P;
  const ScaleEpi<typename S::W> scale{wts, t1};
  if (free != nullptr)
    blur_chain(DirectionT<true, float, P>{r, p, free, scal, first, 0.f}, p_new, scale, nullptr,
               t1, t2, tp, d, s);
  else
    blur_chain(DirectionT<false, float, P>{r, p, nullptr, scal, first, 0.f}, p_new, scale,
               nullptr, t1, t2, tp, d, s);
  if (reg == kRegIdentity)
    blur_chain(Load{t1}, nullptr, MaskedEpi<kRegIdentity, P, S::kIo>{p_new, free, q, rho, sp},
               partials, t2, t1, tp, d, s);
  else
    blur_chain(Load{t1}, nullptr, MaskedEpi<kRegLap, P, S::kIo>{p_new, free, q, rho, sp},
               partials, t2, t1, tp, d, s);
}

// p and p' stored as the RobustStorage mode `storage` says.
cudaError_t weighted_apply_chain(const float* r, const void* p, void* p_new, float* q,
                                 const float* free, const float* wts, float* t1, float* t2,
                                 double* partials, double* scal, int first, Taps tp, float rho,
                                 int reg, int storage, Spacing sp, Dims d, cudaStream_t s) {
  const cudaError_t e = with_robust_storage(storage, [&](auto st) {
    using S = decltype(st);
    using P = typename S::P;
    weighted_apply_t<S>(r, static_cast<const P*>(p), static_cast<P*>(p_new), q, free, wts, t1,
                        t2, partials, scal, first, tp, rho, reg, sp, d, s);
    return cudaSuccess;
  });
  if (e != cudaSuccess) return e;
  reduce_kernel<<<1, kReduceThreads, 0, s>>>(partials, grid_for(d.n()), scal, kReducePQ);
  return cudaGetLastError();
}

// The masked CG's update: xk += a p' (p' stored as the storage mode says),
// rk -= a q, gamma' = |rk|^2, beta.
cudaError_t robust_cg_update(float* xk, float* rk, const void* p, const float* q,
                             double* partials, double* scal, long long n, int storage,
                             cudaStream_t s) {
  if (storage == kRobustExact)
    return cg_update_t(xk, rk, static_cast<const float*>(p), q, partials, scal, n, 1, s);
  return cg_update_t(xk, rk, static_cast<const bf16*>(p), q, partials, scal, n, 1, s);
}

// out = A y (+ rho D^T D u, u_ext given) on a z-window: y_ext, u_ext hold
// Zl + 2 h planes, out the Zl centre ones; global rows start at row0.
cudaError_t blur_apply_prepadded(const float* y_ext, const float* u_ext, float* out, float* t1,
                                 float* t2, Taps tp, float rho, int h, int row0, int z_total,
                                 Spacing sp, Dims d, cudaStream_t s) {
  const float* u = u_ext != nullptr ? u_ext + (long long)h * d.plane() : nullptr;
  const BlurEpi<kRegLap> epi{u, out, nullptr, nullptr, rho, sp};
  blur_chain_slab(Load{y_ext}, GlobalRows<BlurEpi<kRegLap>>{epi, row0, z_total}, nullptr, t1,
                  t2, tp, d, h, s);
  return cudaGetLastError();
}

// out = A (w * A v) + rho D^T D v on a z-window of halo r >= r_a (r_a the
// blur taps' half-width): x(v_ext) -> t1 -> t2 -> s = w * A v on the
// Zl + 2 r_a rows in t1; then x(s) -> t2 -> t1 -> out with the Laplacian
// of v's centre. v_ext, w_ext and out are stored as T; t1, t2 are float.
template <class T>
void weighted_apply_prepadded_t(const T* v_ext, const T* w_ext, T* out, float* t1, float* t2,
                                Taps tp, float rho, int r, int row0, int z_total, Spacing sp,
                                Dims d, cudaStream_t s) {
  const int ra = tp.kz / 2;
  const long long plane = d.plane();
  const Dims mid{d.Z + 2 * ra, d.Y, d.X};
  blur_chain_slab(LoadT<T>{v_ext},
                  ScaleEpi<float, T>{w_ext + (long long)(r - ra) * plane, t1}, nullptr, t1,
                  t2, tp, mid, r - ra, s);
  const WindowOutEpi<T> epi{v_ext + (long long)r * plane, out, rho, sp};
  blur_chain_slab(Load{t1}, GlobalRows<WindowOutEpi<T>>{epi, row0, z_total}, nullptr, t2, t1,
                  tp, d, ra, s);
}

// The window's volumes are float, or bfloat16 with `io`.
cudaError_t weighted_apply_prepadded(const void* v_ext, const void* w_ext, void* out, float* t1,
                                     float* t2, Taps tp, float rho, int r, int row0,
                                     int z_total, int io, Spacing sp, Dims d, cudaStream_t s) {
  if (io)
    weighted_apply_prepadded_t(static_cast<const bf16*>(v_ext), static_cast<const bf16*>(w_ext),
                               static_cast<bf16*>(out), t1, t2, tp, rho, r, row0, z_total, sp,
                               d, s);
  else
    weighted_apply_prepadded_t(static_cast<const float*>(v_ext),
                               static_cast<const float*>(w_ext), static_cast<float*>(out), t1,
                               t2, tp, rho, r, row0, z_total, sp, d, s);
  return cudaGetLastError();
}

cudaError_t irls_step(float* x, const float* xk, long long n, cudaStream_t s) {
  irls_step_kernel<<<grid_for(n), kThreads, 0, s>>>(x, xk, n);
  return cudaGetLastError();
}

}  // namespace

extern "C" {
// weighted_march.cu's weighted_apply and blur_march.cu's blur_apply,
// irls_head and blur window, which add to no count.
int nsol_blur_apply_march(const float* y, const float* u, float* out, float* free, float* rk,
                          const float* b, float* wts, float* yout, double* partials,
                          double* scal, const float* taps, int kz, int ky, int kx, float rho,
                          int reg, int loss, float scale, float ih2x, float ih2y, float ih2z,
                          int Z, int Y, int X, void* stream);
int nsol_blur_apply_window_march(const float* y_ext, const float* u_ext, float* out,
                                 const float* taps, int kz, int ky, int kx, float rho, float ih2x,
                                 float ih2y, float ih2z, int halo, int row0, int z_total, int Zl,
                                 int Y, int X, void* stream);
int nsol_weighted_apply_march(const float* r, const void* p, void* p_new, float* q,
                              const float* free, const float* wts, double* partials,
                              double* scal, int first, const float* taps, int kz, int ky,
                              int kx, float rho, int reg, int storage, float ih2x, float ih2y,
                              float ih2z, int Z, int Y, int X, void* stream);
}

namespace {

// One whole-volume blur_apply by `route`: the march (counted as
// kBlurApplyMarch) or the three passes through t1, t2 (kBlurApply).
int blur_apply_routed(const float* y, const float* u, float* out, float* free, float* rk,
                      float* t1, float* t2, double* partials, double* scal, const float* taps,
                      int kz, int ky, int kx, float rho, int reg, int route, float ih2x,
                      float ih2y, float ih2z, int Z, int Y, int X, void* stream,
                      long long* counts) {
  if (takes_march(route, kVolBlurApply, kz, ky, kx, Z, Y, X)) {
    counts[kBlurApplyMarch] += 1;
    return nsol_blur_apply_march(y, u, out, free, rk, nullptr, nullptr, nullptr, partials, scal,
                                 taps, kz, ky, kx, rho, reg, 0, 1.f, ih2x, ih2y, ih2z, Z, Y, X,
                                 stream);
  }
  counts[kBlurApply] += 1;
  if (t1 == nullptr || t2 == nullptr) return (int)cudaErrorInvalidValue;
  const Spacing sp{0.f, 0.f, 0.f, ih2x, ih2y, ih2z};
  return (int)blur_apply(y, u, out, free, rk, t1, t2, partials, scal,
                         make_taps(taps, kz, ky, kx), rho, reg, sp, Dims{Z, Y, X},
                         (cudaStream_t)stream);
}

// One whole-volume irls_head by `route`: the march (kIrlsHeadMarch) or
// the three passes through t1, t2 (kIrlsHead).
int irls_head_routed(const float* x, const float* b, float* wts, float* y, float* t1, float* t2,
                     const float* taps, int kz, int ky, int kx, int loss, float scale, int route,
                     int Z, int Y, int X, void* stream, long long* counts) {
  if (takes_march(route, kVolIrlsHead, kz, ky, kx, Z, Y, X)) {
    counts[kIrlsHeadMarch] += 1;
    return nsol_blur_apply_march(x, nullptr, nullptr, nullptr, nullptr, b, wts, y, nullptr,
                                 nullptr, taps, kz, ky, kx, 0.f, kRegLap, loss, scale, 0.f, 0.f,
                                 0.f, Z, Y, X, stream);
  }
  counts[kIrlsHead] += 1;
  if (t1 == nullptr || t2 == nullptr) return (int)cudaErrorInvalidValue;
  return (int)irls_head(x, b, wts, y, t1, t2, make_taps(taps, kz, ky, kx), loss, scale,
                        Dims{Z, Y, X}, (cudaStream_t)stream);
}

// One whole-volume weighted_apply by `route` (stencil.cuh's Route): the
// march (counted as kWeightedApplyMarch) or the six passes through t1, t2
// (kWeightedApply).
int weighted_apply(const float* r, const void* p, void* p_new, float* q, const float* free,
                   const float* wts, float* t1, float* t2, double* partials, double* scal,
                   int first, const float* taps, int kz, int ky, int kx, float rho, int reg,
                   int storage, int route, float ih2x, float ih2y, float ih2z, int Z, int Y,
                   int X, void* stream, long long* counts) {
  if (takes_march(route, kVolWeightedApply, kz, ky, kx, Z, Y, X)) {
    counts[kWeightedApplyMarch] += 1;
    return nsol_weighted_apply_march(r, first ? nullptr : p, p_new, q, free, wts, partials, scal,
                                     first, taps, kz, ky, kx, rho, reg, storage, ih2x, ih2y,
                                     ih2z, Z, Y, X, stream);
  }
  counts[kWeightedApply] += 1;
  if (t1 == nullptr || t2 == nullptr) return (int)cudaErrorInvalidValue;
  const Spacing sp{0.f, 0.f, 0.f, ih2x, ih2y, ih2z};
  return (int)weighted_apply_chain(r, p, p_new, q, free, wts, t1, t2, partials, scal, first,
                                   make_taps(taps, kz, ky, kx), rho, reg, storage, sp,
                                   Dims{Z, Y, X}, (cudaStream_t)stream);
}

}  // namespace

// ------------------------------------------------------------ C interface --
// Every function enqueues on `stream`, never synchronizes, allocates
// nothing, adds one to counts[unit] per unit it launches, and returns
// cudaGetLastError() (0 on success). Spacing enters as 1/h^2 in (x, y, z)
// order; loss is an index of the Loss enum, reg one of the RegKind enum.

extern "C" {

// admm.cu's record unit, which adds to its own counts (admm_record's slot).
int nsol_admm_record(const float* x, const float* b, float* t1, float* t2, double* rec_partials,
                     double* reg, double* data, int t, const float* taps, int kz, int ky, int kx,
                     int loss, float scale, float ihx, float ihy, float ihz, int Z, int Y, int X,
                     void* stream, long long* counts);

// `route` a Route: the rule (t1, t2 may be null where it takes the
// march), the chain (t1, t2 given) or the march. Counts kBlurApply or
// kBlurApplyMarch by the route taken; partials (the gradient form's)
// holds max(nsol_tiled_blocks(Z, Y, X), nsol_max_blocks()) doubles.
int nsol_blur_apply(const float* y, const float* u, float* out, float* free, float* rk,
                    float* t1, float* t2, double* partials, double* scal, const float* taps,
                    int kz, int ky, int kx, float rho, int reg, int route, float ih2x,
                    float ih2y, float ih2z, int Z, int Y, int X, void* stream,
                    long long* counts) {
  return blur_apply_routed(y, u, out, free, rk, t1, t2, partials, scal, taps, kz, ky, kx, rho,
                           reg, route, ih2x, ih2y, ih2z, Z, Y, X, stream, counts);
}

// `route` as nsol_blur_apply takes it; counts kIrlsHead or kIrlsHeadMarch.
int nsol_irls_head(const float* x, const float* b, float* wts, float* y, float* t1, float* t2,
                   const float* taps, int kz, int ky, int kx, int loss, float scale, int route,
                   int Z, int Y, int X, void* stream, long long* counts) {
  return irls_head_routed(x, b, wts, y, t1, t2, taps, kz, ky, kx, loss, scale, route, Z, Y, X,
                          stream, counts);
}

// p, p_new stored as the RobustStorage mode `storage` says; `route` a
// Route: the rule (t1, t2 may be null where it takes the march), the
// chain (t1, t2 given) or the march. Counts kWeightedApply or
// kWeightedApplyMarch by the route taken; partials holds
// max(nsol_tiled_blocks(Z, Y, X), nsol_max_blocks()) doubles.
int nsol_weighted_apply(const float* r, const void* p, void* p_new, float* q,
                        const float* free, const float* wts, float* t1, float* t2,
                        double* partials, double* scal, int first, const float* taps, int kz,
                        int ky, int kx, float rho, int reg, int storage, int route, float ih2x,
                        float ih2y, float ih2z, int Z, int Y, int X, void* stream,
                        long long* counts) {
  return weighted_apply(r, p, p_new, q, free, wts, t1, t2, partials, scal, first, taps, kz, ky,
                        kx, rho, reg, storage, route, ih2x, ih2y, ih2z, Z, Y, X, stream, counts);
}

int nsol_irls_step(float* x, const float* xk, long long n, void* stream, long long* counts) {
  cudaError_t e = irls_step(x, xk, n, (cudaStream_t)stream);
  counts[kIrlsStep] += 1;
  return (int)e;
}

// y_ext, u_ext (u_ext may be null): (Zl + 2 halo, Y, X); out: (Zl, Y, X);
// t1, t2: Zl + 2 halo planes, or both null for the one-pass window march
// (blur_march.cu), which the wrapper takes where its shared memory holds
// the taps. Counts kBlurApplyPre (the chain) or kBlurApplyPreMarch.
int nsol_blur_apply_prepadded(const float* y_ext, const float* u_ext, float* out, float* t1,
                              float* t2, const float* taps, int kz, int ky, int kx, float rho,
                              float ih2x, float ih2y, float ih2z, int halo, int row0,
                              int z_total, int Zl, int Y, int X, void* stream,
                              long long* counts) {
  if (t1 == nullptr) {
    counts[kBlurApplyPreMarch] += 1;
    return nsol_blur_apply_window_march(y_ext, u_ext, out, taps, kz, ky, kx, rho, ih2x, ih2y,
                                        ih2z, halo, row0, z_total, Zl, Y, X, stream);
  }
  const Spacing sp{0.f, 0.f, 0.f, ih2x, ih2y, ih2z};
  cudaError_t e = blur_apply_prepadded(y_ext, u_ext, out, t1, t2, make_taps(taps, kz, ky, kx),
                                       rho, halo, row0, z_total, sp, Dims{Zl, Y, X},
                                       (cudaStream_t)stream);
  counts[kBlurApplyPre] += 1;
  return (int)e;
}

// tiled.cu's weighted march over a window.
int nsol_weighted_apply_window_zy(const void* v_ext, const void* w_ext, void* out,
                                  const float* taps, int kz, int ky, int kx, float rho,
                                  float ih2x, float ih2y, float ih2z, int halo, int row0,
                                  int z_total, int Zl, int Y, int X, int io, void* stream);

// v_ext, w_ext: (Zl + 2 halo, Y, X) with halo >= kz / 2; out: (Zl, Y, X);
// all three float, or bfloat16 with `io`; t1, t2: Zl + 2 halo float planes,
// or both null for the one-pass weighted march (tiled.cu), which the
// wrapper takes where its shared memory holds the taps (halo 2 (kz / 2),
// kz >= 3).
int nsol_weighted_apply_prepadded(const void* v_ext, const void* w_ext, void* out, float* t1,
                                  float* t2, const float* taps, int kz, int ky, int kx,
                                  float rho, float ih2x, float ih2y, float ih2z, int halo,
                                  int row0, int z_total, int Zl, int Y, int X, int io,
                                  void* stream, long long* counts) {
  const Spacing sp{0.f, 0.f, 0.f, ih2x, ih2y, ih2z};
  const int e =
      t1 == nullptr
          ? nsol_weighted_apply_window_zy(v_ext, w_ext, out, taps, kz, ky, kx, rho, ih2x, ih2y,
                                          ih2z, halo, row0, z_total, Zl, Y, X, io, stream)
          : (int)weighted_apply_prepadded(v_ext, w_ext, out, t1, t2,
                                          make_taps(taps, kz, ky, kx), rho, halo, row0,
                                          z_total, io, sp, Dims{Zl, Y, X},
                                          (cudaStream_t)stream);
  counts[kWeightedApplyPre] += 1;
  return e;
}

// The tiled units of tiled.cu (the 512-wide-plane route), which add to
// their own counts (tiled.cu's TiledUnit enum).
int nsol_blur_apply_zy(const float* y, const float* u, float* out, float* free, float* rk,
                       const float* b, float* wts, float* yout, double* partials, double* scal,
                       const float* taps, int kz, int ky, int kx, float rho, int loss,
                       float scale, float ih2x, float ih2y, float ih2z, int Z, int Y, int X,
                       void* stream, long long* counts);
int nsol_weighted_apply_zy(const float* r, const void* p, void* p_new, float* q,
                           const float* free, const float* wts, double* partials, double* scal,
                           int first, const float* taps, int kz, int ky, int kx, float rho,
                           int storage, float ih2x, float ih2y, float ih2z, int Z, int Y, int X,
                           void* stream, long long* counts);

}  // extern "C"

namespace {

// One IRLS sweep (fused.py:583-622 with rho, :825-853 with alpha):
// the weights (irls_head), the gradient (blur_apply's gradient form),
// cg_iters x (weighted_apply, cg_update) from xk = 0, and irls_step. q
// holds y = wts r until the first apply overwrites it. kTiled swaps in
// tiled.cu's one-pass units (Laplacian only; their counts go to
// tiled_counts): blur_apply_zy's head and gradient forms and
// weighted_apply_zy, which need no scratch volumes. The directions p0, p1
// are stored as the RobustStorage mode `storage` says; the head, the
// gradient and the step stay float in every mode (robust.py:469-548).
template <bool kTiled>
int irls_sweep(const float* b, float* x, float* wts, float* free, float* rk, void* p0, void* p1,
               float* q, float* xk, float* t1, float* t2, double* partials, double* scal,
               const float* taps, int kz, int ky, int kx, float rho, int reg, int storage,
               float ih2x, float ih2y, float ih2z, int loss, float scale, int cg_iters, int Z,
               int Y, int X, void* stream, long long* counts, long long* tiled_counts) {
  const cudaStream_t s = (cudaStream_t)stream;
  const Dims d{Z, Y, X};
  int e;
#define UNIT(idx, call) NSOL_UNIT(counts, idx, call)
#define CALL(call)                  \
  if ((e = (int)(call)) != 0) return e;
  if (kTiled) {
    CALL(nsol_blur_apply_zy(x, nullptr, nullptr, nullptr, nullptr, b, wts, q, partials, scal,
                            taps, kz, ky, kx, rho, loss, scale, ih2x, ih2y, ih2z, Z, Y, X, stream,
                            tiled_counts));
    CALL(nsol_blur_apply_zy(q, x, nullptr, free, rk, nullptr, nullptr, nullptr, partials, scal,
                            taps, kz, ky, kx, rho, loss, scale, ih2x, ih2y, ih2z, Z, Y, X, stream,
                            tiled_counts));
  } else {
    CALL(irls_head_routed(x, b, wts, q, t1, t2, taps, kz, ky, kx, loss, scale, kRouteRule, Z, Y,
                          X, stream, counts));
    CALL(blur_apply_routed(q, x, nullptr, free, rk, t1, t2, partials, scal, taps, kz, ky, kx, rho,
                           reg, kRouteRule, ih2x, ih2y, ih2z, Z, Y, X, stream, counts));
  }
  CALL(cudaMemsetAsync(xk, 0, d.n() * sizeof(float), s));
  void* p_prev = p0;
  void* p_cur = p1;
  for (int k = 0; k < cg_iters; ++k) {
    if (kTiled) {
      CALL(nsol_weighted_apply_zy(rk, p_prev, p_cur, q, free, wts, partials, scal, k == 0, taps,
                                  kz, ky, kx, rho, storage, ih2x, ih2y, ih2z, Z, Y, X, stream,
                                  tiled_counts));
    } else {
      CALL(weighted_apply(rk, p_prev, p_cur, q, free, wts, t1, t2, partials, scal, k == 0, taps,
                          kz, ky, kx, rho, reg, storage, kRouteRule, ih2x, ih2y, ih2z, Z, Y, X,
                          stream, counts));
    }
    UNIT(kCgUpdate, robust_cg_update(xk, rk, p_cur, q, partials, scal, d.n(), storage, s));
    void* tmp = p_prev;
    p_prev = p_cur;
    p_cur = tmp;
  }
  UNIT(kIrlsStep, irls_step(x, xk, d.n(), s));
#undef CALL
#undef UNIT
  return 0;
}

// iterations x iter_max IRLS sweeps at rho with the Laplacian; with
// reg != nullptr, the records of x0 and of every outer iterate.
template <bool kTiled>
int robust_solve(const float* b, float* x, float* wts, float* free, float* rk, void* p0,
                 void* p1, float* q, float* xk, float* t1, float* t2, double* partials,
                 double* scal, const float* taps, int kz, int ky, int kx, float rho, float ihx,
                 float ihy, float ihz, float ih2x, float ih2y, float ih2z, int loss, float scale,
                 int iterations, int iter_max, int cg_iters, int storage, double* reg,
                 double* data, double* rec_partials, float rec_scale, int Z, int Y, int X,
                 void* stream, long long* counts, long long* rec_counts,
                 long long* tiled_counts) {
  int e;
#define RECORD(t)                                                                            \
  if (reg != nullptr &&                                                                      \
      (e = nsol_admm_record(x, b, t1, t2, rec_partials, reg, data, (t), taps, kz, ky, kx,    \
                            loss, rec_scale, ihx, ihy, ihz, Z, Y, X, stream, rec_counts)) != 0) \
    return e;
  RECORD(0)
  for (int it = 0; it < iterations; ++it) {
    for (int sweep = 0; sweep < iter_max; ++sweep) {
      e = irls_sweep<kTiled>(b, x, wts, free, rk, p0, p1, q, xk, t1, t2, partials, scal, taps,
                             kz, ky, kx, rho, kRegLap, storage, ih2x, ih2y, ih2z, loss, scale,
                             cg_iters, Z, Y, X, stream, counts, tiled_counts);
      if (e != 0) return e;
    }
    RECORD(it + 1)
  }
#undef RECORD
  return 0;
}

}  // namespace

extern "C" {

// One IRLS sweep with the whole-volume units (robust.cu's counts, 11; its
// irls_head, blur_apply and weighted_apply by march.cuh's route); p0, p1
// stored as the RobustStorage mode `storage` says.
int nsol_irls_sweep(const float* b, float* x, float* wts, float* free, float* rk, void* p0,
                    void* p1, float* q, float* xk, float* t1, float* t2, double* partials,
                    double* scal, const float* taps, int kz, int ky, int kx, float rho, int reg,
                    int storage, float ih2x, float ih2y, float ih2z, int loss, float scale,
                    int cg_iters, int Z, int Y, int X, void* stream, long long* counts) {
  return irls_sweep<false>(b, x, wts, free, rk, p0, p1, q, xk, t1, t2, partials, scal, taps, kz,
                           ky, kx, rho, reg, storage, ih2x, ih2y, ih2z, loss, scale, cg_iters, Z,
                           Y, X, stream, counts, nullptr);
}

// The whole robust ADMM solve (fused.py:382 robust branch, robust.py:406):
// iterations x iter_max IRLS sweeps at rho with the Laplacian. x holds x0
// on entry and the result on exit; as in both TPU kernels x0 is not
// clipped on entry (tikhonov.py:130 clips it). With reg != nullptr the
// solve records row 0 (x0) and one row per outer iteration through
// admm.cu's admm_record (its count goes to rec_counts); Reg reads only x,
// so the records need no TV prox/dual chain. 1/h enters for the records.
// The directions p0, p1 are stored as the RobustStorage mode `storage`
// says (kRobustDirs: the fused solve's compact_dirs; kRobustIo:
// blocked_robust_admm_solve's). irls_head, blur_apply and weighted_apply
// take march.cuh's route, so partials holds max(nsol_tiled_blocks,
// nsol_max_blocks) doubles; counts: 11 (this file's units).
int nsol_robust_admm_solve(const float* b, float* x, float* wts, float* free, float* rk,
                           void* p0, void* p1, float* q, float* xk, float* t1, float* t2,
                           double* partials, double* scal, const float* taps, int kz, int ky,
                           int kx, float rho, float ihx, float ihy, float ihz, float ih2x,
                           float ih2y, float ih2z, int loss, float scale, int iterations,
                           int iter_max, int cg_iters, int storage, double* reg, double* data,
                           double* rec_partials, float rec_scale, int Z, int Y, int X,
                           void* stream, long long* counts, long long* rec_counts) {
  return robust_solve<false>(b, x, wts, free, rk, p0, p1, q, xk, t1, t2, partials, scal, taps,
                             kz, ky, kx, rho, ihx, ihy, ihz, ih2x, ih2y, ih2z, loss, scale,
                             iterations, iter_max, cg_iters, storage, reg, data, rec_partials,
                             rec_scale, Z, Y, X, stream, counts, rec_counts, nullptr);
}

// The same launch sequence with tiled.cu's one-pass units in place of
// irls_head, blur_apply and weighted_apply (blocked_robust_admm_solve at
// 512-wide planes, robust.py:432-491); t1 and t2 serve only the records.
// partials holds max(nsol_tiled_blocks, nsol_max_blocks) doubles.
int nsol_robust_admm_solve_zy(const float* b, float* x, float* wts, float* free, float* rk,
                              void* p0, void* p1, float* q, float* xk, float* t1, float* t2,
                              double* partials, double* scal, const float* taps, int kz, int ky,
                              int kx, float rho, float ihx, float ihy, float ihz, float ih2x,
                              float ih2y, float ih2z, int loss, float scale, int iterations,
                              int iter_max, int cg_iters, int storage, double* reg, double* data,
                              double* rec_partials, float rec_scale, int Z, int Y, int X,
                              void* stream, long long* counts, long long* rec_counts,
                              long long* tiled_counts) {
  return robust_solve<true>(b, x, wts, free, rk, p0, p1, q, xk, t1, t2, partials, scal, taps,
                            kz, ky, kx, rho, ihx, ihy, ihz, ih2x, ih2y, ih2z, loss, scale,
                            iterations, iter_max, cg_iters, storage, reg, data, rec_partials,
                            rec_scale, Z, Y, X, stream, counts, rec_counts, tiled_counts);
}

}  // extern "C"
