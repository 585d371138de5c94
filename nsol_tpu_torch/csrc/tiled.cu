// Hopper (sm_90a) one-pass tiled kernels of the 512-wide-plane scale path.
//
// Counterparts of the (z, y)-blocked TPU Pallas kernels
//   nsol_tpu/ops/pallas/blocked.py::make_blocked_normal_operator_2d          (:754)
//   nsol_tpu/ops/pallas/blocked.py::make_blocked_cg_step_2d                  (:878)
//   nsol_tpu/ops/pallas/robust.py::make_blocked_blur_operator_2d             (:734)
//   nsol_tpu/ops/pallas/robust.py::make_blocked_weighted_normal_operator_2d  (:564)
// and of the CG solve around them, blocked.py::blocked_admm_solve (:1293,
// modes "apply" and "step2d"). Same f32 results as the per-axis units of
// admm.cu / robust.cu; what they add is the TPU kernels' one-pass design.
//
// Volumes are (Z, Y, X) float32, X contiguous. Four kernel units:
//
//   normal_apply_zy    q = N_z N_y N_x v + rho D^T D v (13 normal taps a side
//                      at sigma = 1); plain q, the CG residual rhs - q with
//                      sum (rhs - q)^2, or q with sum v.q (a = gamma / pq).
//   cg_step_zy         p' = r + beta p formed in the tile and written once,
//                      q = M p', sum p'.q; second stage a = gamma / pq (the
//                      float TV instance of step_march.cu's whole-volume
//                      cg_step).
//   blur_apply_zy      A y (7 blur taps a side at sigma = 1); with u,
//                      A y + rho D^T D u; the IRLS gradient form (active set
//                      free, rk = -free g, gamma = |rk|^2); the IRLS head form
//                      (r = A x - b, wts = rho'_C(r^2), y = wts r).
//   weighted_apply_zy  p' = r + beta p, pf = free p', s = wts A pf on the tile
//                      extended by the blur halo in z, y and x, then
//                      q = free (A s + rho D^T D pf) + (p' - pf) on the centre,
//                      sum p'.q. No volume holds A pf (the TV instances of
//                      weighted_march.cu's whole-volume weighted_apply).
// plus cg_direction (p = r + beta p, the "apply" mode's CG direction),
// whose kernel is stream.cuh's stream_direction: bound by bytes, it moves
// them in 16-byte accesses (see the note there).
//
// Storage (blocked.py:1293's compact_dirs and state_dtype, "apply" mode):
// normal_apply_zy has bfloat16 instances (v and q in bf16, its dot taking
// the rounded q; the residual form reading x as bf16 and writing r and
// the first direction p = r in bf16). cg_direction has typed instances and,
// under bf16 state, a deferred form that forms r' = r - a q again from
// the unrounded values (stream.cuh). weighted_apply_zy takes robust.cu's
// storage modes (stencil.cuh's RobustStorage): p and p' in bf16, the
// weights read as bf16 and the core rounded under kRobustIo
// (robust.py:564's io_dtype).
//
// The window units. normal_apply_prepadded (admm.cu's C entry, the sharded
// path's blocked.py:478) is the normal apply's march over the Zl + 2 hd
// planes of a z-window, and weighted_apply_prepadded (robust.cu's C entry,
// robust.py:264 with prepadded=True) the weighted march's over the Zl +
// 4 hz planes of v_ext and w_ext (no direction, mask or dot; v, w and out
// float, or bfloat16 with the arithmetic in float): plane k of the march
// is plane k of the window, with no z wrap; x and y wrap as in the whole
// volume, and the Laplacian takes its zero-boundary z rows only at global
// rows 0 and z_total - 1 (stencil.cuh's GlobalRows rule). Where their taps
// do not fit a block (ops/cuda/tiled.py::smem_bytes, blocked.py::
// window_route), the windows keep stencil.cuh's three-pass chains.
//
// The marches themselves (their design, what bounds them, the z tile
// rule) are in march.cuh; the whole-volume cg_step and weighted_apply
// instances of admm.cu and robust.cu are in step_march.cu and
// weighted_march.cu, which this file's cg_step_zy and weighted_apply_zy
// call.

#include <cuda_runtime.h>

#include "losses.cuh"
#include "march.cuh"
#include "stream.cuh"

extern "C" {
// The whole-volume march instances (step_march.cu, weighted_march.cu),
// which add to no count.
int nsol_cg_step_march(const void* r, const void* p, void* p_new, void* q, double* partials,
                       double* scal, int first, const float* taps, int kz, int ky, int kx,
                       float rho, int reg, int storage, float ih2x, float ih2y, float ih2z,
                       int Z, int Y, int X, void* stream);
int nsol_weighted_apply_march(const float* r, const void* p, void* p_new, float* q,
                              const float* free, const float* wts, double* partials,
                              double* scal, int first, const float* taps, int kz, int ky,
                              int kx, float rho, int reg, int storage, float ih2x, float ih2y,
                              float ih2z, int Z, int Y, int X, void* stream);
}

namespace {

// Kernel units, the indices of the launch counts handed back to Python.
enum TiledUnit {
  kNormalApplyZy = 0,
  kCgStepZy = 1,
  kBlurApplyZy = 2,
  kWeightedApplyZy = 3,
  kCgDirection = 4
};

// ---------------------------------------------------------- epilogues --

// q = conv + rho lap stored as O; plain q, the residual rhs - q (q rounded
// to O first; summed squared, stored as O, and as the first CG direction
// p_out of type P when given), or q with centre.q summed (centre: v, or
// p'; q after its rounding, as the reference's "apply" CG reads it back).
enum NormalMode { kNormalPlain = 0, kNormalResidual = 1, kNormalDot = 2 };

template <int kMode, class O = float, class P = float>
struct NormalZyEpi {
  const float* rhs;
  O* out;
  P* p_out;
  float rho;
  __device__ double operator()(long long i, float conv, float lap, float centre) const {
    const float q = fmaf(rho, lap, conv);
    if (kMode == kNormalResidual) {
      const float res = rhs[i] - round_as<O>(q);
      out[i] = store_as<O>(res);
      if (p_out != nullptr) p_out[i] = store_as<P>(res);
      return (double)res * res;
    }
    out[i] = store_as<O>(q);
    return kMode == kNormalDot ? (double)centre * round_as<O>(q) : 0.0;
  }
};

// blur_apply_zy: g = conv (+ rho lap u) into out.
struct BlurZyEpi {
  float* out;
  float rho;
  int lap;
  __device__ double operator()(long long i, float conv, float l, float) const {
    out[i] = lap ? fmaf(rho, l, conv) : conv;
    return 0.0;
  }
};

// The IRLS gradient (centre = x): free = !(x <= 0 && g > 0), rk = -free g.
struct GradZyEpi {
  float* free;
  float* rk;
  float rho;
  __device__ double operator()(long long i, float conv, float l, float x) const {
    const float g = fmaf(rho, l, conv);
    const bool active = x <= 0.f && g > 0.f;
    const float r = active ? 0.f : -g;
    free[i] = active ? 0.f : 1.f;
    rk[i] = r;
    return (double)r * r;
  }
};

// The IRLS head: r = A x - b, wts = rho'_C(r^2), y = wts r.
struct HeadZyEpi {
  const float* b;
  float* wts;
  float* y;
  float fs2;
  int loss;
  __device__ double operator()(long long i, float conv, float, float) const {
    const float r = __fsub_rn(conv, __ldg(b + i));
    const float w = loss_weight(__fmul_rn(r, r), fs2, loss);
    wts[i] = w;
    y[i] = __fmul_rn(w, r);
    return 0.0;
  }
};

// ---------------------------------------------------------------- units --

// The residual form: x read at O's precision, r stored as O and, when p_out
// is given, the first CG direction p = r as P.
template <class O, class P>
cudaError_t normal_residual_zy(const float* x, O* out, P* p_out, const float* rhs,
                               double* partials, double* scal, Taps tp, float rho, Spacing sp,
                               Dims d, cudaStream_t s) {
  const StencilArgs<float, O> a{x, nullptr, nullptr, scal, 1, tp, sp, d, partials};
  const cudaError_t e = launch_stencil<kNormalK, kSrcOne, true>(
      a, 1, NormalZyEpi<kNormalResidual, O, P>{rhs, out, p_out, rho}, s);
  if (e != cudaSuccess) return e;
  reduce_kernel<<<1, kReduceThreads, 0, s>>>(partials, stencil_grid(d, tp).blocks(), scal,
                                             kReduceRR0);
  return cudaGetLastError();
}

// v and q stored as T: plain q, or (scal given) q with pq = sum v.q.
template <class T>
cudaError_t normal_apply_zy_t(const T* v, T* out, double* partials, double* scal, Taps tp,
                              float rho, Spacing sp, Dims d, cudaStream_t s) {
  StencilArgs<T> a{v, nullptr, nullptr, scal, 1, tp, sp, d, nullptr};
  cudaError_t e;
  if (scal != nullptr) {
    a.partials = partials;
    e = launch_stencil<kNormalK, kSrcOne, true>(
        a, 1, NormalZyEpi<kNormalDot, T>{nullptr, out, nullptr, rho}, s);
    if (e != cudaSuccess) return e;
    reduce_kernel<<<1, kReduceThreads, 0, s>>>(partials, stencil_grid(d, tp).blocks(), scal,
                                               kReducePQ);
  } else {
    e = launch_stencil<kNormalK, kSrcOne, true>(
        a, 1, NormalZyEpi<kNormalPlain, T>{nullptr, out, nullptr, rho}, s);
    if (e != cudaSuccess) return e;
  }
  return cudaGetLastError();
}

// io 0: float v and out; io 1: bfloat16 out, and v bfloat16 (plain and dot
// forms) or a float x read as bfloat16 (residual form). p_out (residual
// form): float when p_bf16 is 0, else bfloat16.
cudaError_t normal_apply_zy(const void* v, void* out, const float* rhs, void* p_out, int p_bf16,
                            double* partials, double* scal, Taps tp, float rho, int io,
                            Spacing sp, Dims d, cudaStream_t s) {
  if (rhs != nullptr) {
    const float* x = static_cast<const float*>(v);
    if (io) {
      if (!p_bf16 && p_out != nullptr) return cudaErrorInvalidValue;
      return normal_residual_zy(x, static_cast<bf16*>(out), static_cast<bf16*>(p_out), rhs,
                                partials, scal, tp, rho, sp, d, s);
    }
    if (p_bf16)
      return normal_residual_zy(x, static_cast<float*>(out), static_cast<bf16*>(p_out), rhs,
                                partials, scal, tp, rho, sp, d, s);
    return normal_residual_zy(x, static_cast<float*>(out), static_cast<float*>(p_out), rhs,
                              partials, scal, tp, rho, sp, d, s);
  }
  if (io)
    return normal_apply_zy_t(static_cast<const bf16*>(v), static_cast<bf16*>(out), partials, scal,
                             tp, rho, sp, d, s);
  return normal_apply_zy_t(static_cast<const float*>(v), static_cast<float*>(out), partials, scal,
                           tp, rho, sp, d, s);
}

// Forms by the pointers given: head (b: wts, yout from A x - b), gradient
// (free: free, rk from A y + rho D^T D x, gamma), with u (A y + rho D^T D u),
// or plain A y.
cudaError_t blur_apply_zy(const float* y, const float* u, float* out, float* free, float* rk,
                          const float* b, float* wts, float* yout, double* partials,
                          double* scal, Taps tp, float rho, int loss, float scale, Spacing sp,
                          Dims d, cudaStream_t s) {
  StencilArgs<> a{y, u, nullptr, scal, 1, tp, sp, d, nullptr};
  cudaError_t e;
  if (b != nullptr) {
    e = launch_stencil<kBlurK, kSrcOne, false>(a, 1, HeadZyEpi{b, wts, yout, scale * scale, loss}, s);
  } else if (free != nullptr) {
    a.partials = partials;
    e = launch_stencil<kBlurK, kSrcTwo, true>(a, 2, GradZyEpi{free, rk, rho}, s);
    if (e != cudaSuccess) return e;
    reduce_kernel<<<1, kReduceThreads, 0, s>>>(partials, stencil_grid(d, tp).blocks(), scal,
                                               kReduceRR0);
  } else if (u != nullptr) {
    e = launch_stencil<kBlurK, kSrcTwo, true>(a, 2, BlurZyEpi{out, rho, 1}, s);
  } else {
    e = launch_stencil<kBlurK, kSrcOne, false>(a, 1, BlurZyEpi{out, rho, 0}, s);
  }
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// out = A (w * A v) + rho D^T D v on the Zl centre planes of a z-window of
// halo 2 hz (v_ext, w_ext, out stored as T; the arithmetic in float).
template <class T>
cudaError_t weighted_window_zy(const T* v_ext, const T* w_ext, T* out, Taps tp, float rho,
                               int halo, int row0, int z_total, Spacing sp, Dims d,
                               cudaStream_t s) {
  const long long c = (long long)halo * d.plane();
  const WeightedArgs<T, float, T, T> a{v_ext + c, nullptr, nullptr, w_ext + c, nullptr,
                                       out,       nullptr, 1,       rho,       tp,
                                       sp,        d,       nullptr, row0,      z_total};
  return launch_weighted_taps<kRegLap, true, false, RobustT<float, false>, T>(a, s);
}

}  // namespace

// ------------------------------------------------------------ C interface --
// Every function enqueues on `stream`, never synchronizes, allocates
// nothing, adds one to counts[unit] per unit it launches, and returns
// cudaGetLastError() (0 on success; cudaErrorInvalidValue when a stencil
// is too long for the tile's shared memory). Spacing enters as 1/h^2 in
// (x, y, z) order. partials holds nsol_tiled_blocks(Z, Y, X) doubles.
// A march's grid follows march.cuh's z tile rule (nsol_march_tile_z).

extern "C" {

// admm.cu's units, which add to their own counts (admm.cu's Unit enum).
int nsol_cg_update(float* x, void* r, const void* p, const void* q, double* partials,
                   double* scal, long long n, int storage, int store_r, void* stream,
                   long long* counts);
int nsol_admm_tail(float* x, float* v, float* w, const float* atb, float* rhs, float ihx,
                   float ihy, float ihz, float tau, float rho, int init, int Z, int Y, int X,
                   void* stream, long long* counts);

// The partials any march unit's grid may need at (Z, Y, X): the blocks of
// its shortest z tile.
int nsol_tiled_blocks(int Z, int Y, int X) { return march_max_blocks(Dims{Z, Y, X}); }

// Planes a block of the single-stencil march (weighted 0, z taps kz) or of
// the weighted march (weighted 1, blur z taps kz) marches through at
// (Z, Y, X) on the current device: march.cuh's rule, which
// ops/cuda/tiled.py::tile_z mirrors.
int nsol_march_tile_z(int Z, int Y, int X, int kz, int weighted) {
  const Taps tp{nullptr, nullptr, nullptr, kz, kz, kz};
  const Dims d{Z, Y, X};
  return weighted ? weighted_grid(d, tp).tz : stencil_grid(d, tp).tz;
}

// Whether the whole-volume unit (0: cg_step at the normal taps, 1:
// weighted_apply at the blur taps (kz, ky, kx)) takes its march at
// (Z, Y, X): march.cuh's vol_route, which ops/cuda/tiled.py::vol_route
// mirrors.
int nsol_vol_route(int unit, int kz, int ky, int kx, int Z, int Y, int X) {
  return vol_route(unit, Taps{nullptr, nullptr, nullptr, kz, ky, kx}, Dims{Z, Y, X}) ? 1 : 0;
}

// Bytes of shared memory one block takes for stencils of lengths (kz, ky,
// kx): weighted_apply_zy's (weighted != 0), or a single-stencil unit's over
// nin input windows with (lap != 0) or without the Laplacian's ring, its
// windows' x margins those of bfloat16 windows with two_byte. A launch
// past kMaxSmem returns cudaErrorInvalidValue; ops/cuda/tiled.py computes
// the same sizes to route such stencils before any launch.
int nsol_tiled_smem(int kz, int ky, int kx, int nin, int lap, int weighted, int two_byte) {
  const Taps tp{nullptr, nullptr, nullptr, kz, ky, kx};
  const size_t b = weighted ? (size_t)weighted_geo(tp, false).words * 4
                            : stencil_smem(stencil_geo(tp, nin, two_byte != 0), lap != 0, true);
  return b > 0x7fffffffu ? 0x7fffffff : (int)b;
}

// io and p_out, p_bf16 as normal_apply_zy above takes them.
int nsol_normal_apply_zy(const void* v, void* out, const float* rhs, void* p_out, int p_bf16,
                         double* partials, double* scal, const float* taps, int kz, int ky,
                         int kx, float rho, int io, float ih2x, float ih2y, float ih2z, int Z,
                         int Y, int X, void* stream, long long* counts) {
  const Spacing sp{0.f, 0.f, 0.f, ih2x, ih2y, ih2z};
  const cudaError_t e = normal_apply_zy(v, out, rhs, p_out, p_bf16, partials, scal,
                                        make_taps(taps, kz, ky, kx), rho, io, sp, Dims{Z, Y, X},
                                        (cudaStream_t)stream);
  counts[kNormalApplyZy] += 1;
  return (int)e;
}

// normal_apply_prepadded's one-pass form (admm.cu's
// nsol_normal_apply_prepadded takes it when given no scratch volumes): the
// march over the Zl + 2 halo planes of v_ext, halo the z taps' half-width
// (at least 1); q = A^T A v + rho D^T D v on the Zl centre planes, whose
// Laplacian takes its zero-boundary rows only at global rows 0 and
// z_total - 1 (row0 the window's first global row). Adds to no count.
int nsol_normal_apply_window_zy(const float* v_ext, float* out, const float* taps, int kz, int ky,
                                int kx, float rho, float ih2x, float ih2y, float ih2z, int halo,
                                int row0, int z_total, int Zl, int Y, int X, void* stream) {
  if (halo != halo_of(kz)) return (int)cudaErrorInvalidValue;
  const Spacing sp{0.f, 0.f, 0.f, ih2x, ih2y, ih2z};
  const StencilArgs<> a{v_ext, nullptr,        nullptr, nullptr, 1,      make_taps(taps, kz, ky, kx),
                        sp,    Dims{Zl, Y, X}, nullptr, row0,    z_total};
  return (int)launch_stencil<kNormalK, kSrcOne, true, true>(
      a, 1, NormalZyEpi<kNormalPlain>{nullptr, out, nullptr, rho}, (cudaStream_t)stream);
}

// weighted_apply_prepadded's one-pass form (robust.cu's
// nsol_weighted_apply_prepadded takes it when given no scratch volumes):
// the weighted march over the Zl + 2 halo planes of v_ext and w_ext (halo
// twice the z taps' half-width, kz >= 3); out = A (w * A v) + rho D^T D v
// on the Zl centre planes, whose Laplacian takes its zero-boundary rows
// only at global rows 0 and z_total - 1. v_ext, w_ext and out float, or
// bfloat16 with `io`. Adds to no count.
int nsol_weighted_apply_window_zy(const void* v_ext, const void* w_ext, void* out,
                                  const float* taps, int kz, int ky, int kx, float rho,
                                  float ih2x, float ih2y, float ih2z, int halo, int row0,
                                  int z_total, int Zl, int Y, int X, int io, void* stream) {
  if (kz < 3 || halo != 2 * halo_of(kz)) return (int)cudaErrorInvalidValue;
  const Spacing sp{0.f, 0.f, 0.f, ih2x, ih2y, ih2z};
  const Taps tp = make_taps(taps, kz, ky, kx);
  const Dims d{Zl, Y, X};
  const cudaStream_t s = (cudaStream_t)stream;
  if (io)
    return (int)weighted_window_zy(static_cast<const bf16*>(v_ext), static_cast<const bf16*>(w_ext),
                                   static_cast<bf16*>(out), tp, rho, halo, row0, z_total, sp, d, s);
  return (int)weighted_window_zy(static_cast<const float*>(v_ext), static_cast<const float*>(w_ext),
                                 static_cast<float*>(out), tp, rho, halo, row0, z_total, sp, d, s);
}

int nsol_cg_step_zy(const float* r, const float* p, float* p_new, float* q, double* partials,
                    double* scal, int first, const float* taps, int kz, int ky, int kx,
                    float rho, float ih2x, float ih2y, float ih2z, int Z, int Y, int X,
                    void* stream, long long* counts) {
  const int e = nsol_cg_step_march(r, p, p_new, q, partials, scal, first, taps, kz, ky, kx, rho,
                                   kRegLap, kStoreExact, ih2x, ih2y, ih2z, Z, Y, X, stream);
  counts[kCgStepZy] += 1;
  return e;
}

int nsol_blur_apply_zy(const float* y, const float* u, float* out, float* free, float* rk,
                       const float* b, float* wts, float* yout, double* partials, double* scal,
                       const float* taps, int kz, int ky, int kx, float rho, int loss,
                       float scale, float ih2x, float ih2y, float ih2z, int Z, int Y, int X,
                       void* stream, long long* counts) {
  const Spacing sp{0.f, 0.f, 0.f, ih2x, ih2y, ih2z};
  const cudaError_t e = blur_apply_zy(y, u, out, free, rk, b, wts, yout, partials, scal,
                                      make_taps(taps, kz, ky, kx), rho, loss, scale, sp,
                                      Dims{Z, Y, X}, (cudaStream_t)stream);
  counts[kBlurApplyZy] += 1;
  return (int)e;
}

// p, p_new stored as the RobustStorage mode `storage` says.
int nsol_weighted_apply_zy(const float* r, const void* p, void* p_new, float* q,
                           const float* free, const float* wts, double* partials, double* scal,
                           int first, const float* taps, int kz, int ky, int kx, float rho,
                           int storage, float ih2x, float ih2y, float ih2z, int Z, int Y, int X,
                           void* stream, long long* counts) {
  const int e = nsol_weighted_apply_march(r, p, p_new, q, free, wts, partials, scal, first, taps,
                                          kz, ky, kx, rho, kRegLap, storage, ih2x, ih2y, ih2z, Z,
                                          Y, X, stream);
  counts[kWeightedApplyZy] += 1;
  return e;
}

// q given: the deferred form (r' = r - a q first); p, r, q stored as
// `storage` says.
int nsol_cg_direction(void* p, void* r, const void* q, const double* scal, long long n,
                      int storage, void* stream, long long* counts) {
  const cudaError_t e = stream_direction(p, r, q, scal, n, storage, (cudaStream_t)stream);
  counts[kCgDirection] += 1;
  return (int)e;
}

// The whole linear ADMM TV-L2 solve of blocked.py::blocked_admm_solve
// (:1293) for mode 0 ("apply": CG around normal_apply_zy, with the CG
// direction update of cg_direction) or 1 ("step2d": cg_step_zy, float
// storage only). A^T b is blur_apply_zy of b (A symmetric); the outer
// prox/dual chain is admm.cu's admm_tail and the CG update its cg_update
// (counted in admm_counts). x holds x0 on entry and the result on exit.
// r (R), p0, p1 (P) and q (Q) are stored as `storage` says (kStoreExact,
// kStoreDirs or kStoreState): the outer residual reads x in float, or as
// bfloat16 under kStoreState, and writes the first direction p0 = r
// beside r; the CG applies read p and write q in bfloat16 under the two
// compact modes, whose dot takes the rounded q.
int nsol_blocked_admm_solve(const float* b, float* x, float* v, float* w, float* atb,
                            float* rhs, void* r, void* p0, void* p1, void* q, double* partials,
                            double* scal, const float* taps_a, int kaz, int kay, int kax,
                            const float* taps_n, int knz, int kny, int knx, float ihx, float ihy,
                            float ihz, float ih2x, float ih2y, float ih2z, float tau, float rho,
                            int iterations, int iter_max, int mode, int storage, int Z, int Y,
                            int X, void* stream, long long* counts, long long* admm_counts) {
  const cudaStream_t s = (cudaStream_t)stream;
  const Dims d{Z, Y, X};
  const Spacing sp{ihx, ihy, ihz, ih2x, ih2y, ih2z};
  const Taps ta = make_taps(taps_a, kaz, kay, kax);
  const Taps tn = make_taps(taps_n, knz, kny, knx);
  const long long n = d.n();
  if (storage != kStoreExact && (mode != 0 || storage == kStoreQf32))
    return (int)cudaErrorInvalidValue;
  const int compact = storage != kStoreExact, state = storage == kStoreState;
  int e;
#define UNIT(idx, call) NSOL_UNIT(counts, idx, call)
#define CALL(call)                  \
  if ((e = (int)(call)) != 0) return e;
  UNIT(kBlurApplyZy, blur_apply_zy(b, nullptr, atb, nullptr, nullptr, nullptr, nullptr, nullptr,
                                   nullptr, nullptr, ta, 0.f, 0, 1.f, sp, d, s));
  CALL(nsol_admm_tail(x, v, w, atb, rhs, ihx, ihy, ihz, tau, rho, 1, Z, Y, X, stream,
                      admm_counts));
  for (int it = 0; it < iterations; ++it) {
    // warm-started CG on M x = rhs: r = rhs - M x, gamma = |r|^2
    if (mode == 0) {
      // and the first direction p0 = r
      UNIT(kNormalApplyZy, normal_apply_zy(x, r, rhs, p0, compact, partials, scal, tn, rho, state,
                                           sp, d, s));
      for (int k = 0; k < iter_max; ++k) {
        UNIT(kNormalApplyZy, normal_apply_zy(p0, q, nullptr, nullptr, 0, partials, scal, tn, rho,
                                             compact, sp, d, s));
        CALL(nsol_cg_update(x, r, p0, q, partials, scal, n, storage, !state, stream,
                            admm_counts));
        if (k + 1 < iter_max)
          UNIT(kCgDirection, stream_direction(p0, r, state ? q : nullptr, scal, n, storage, s));
      }
    } else {
      UNIT(kNormalApplyZy, normal_apply_zy(x, r, rhs, nullptr, 0, partials, scal, tn, rho, 0, sp,
                                           d, s));
      float* p_prev = static_cast<float*>(p0);
      float* p_cur = static_cast<float*>(p1);
      float* rf = static_cast<float*>(r);
      float* qf = static_cast<float*>(q);
      for (int k = 0; k < iter_max; ++k) {
        CALL(nsol_cg_step_zy(rf, p_prev, p_cur, qf, partials, scal, k == 0, taps_n, knz, kny, knx,
                             rho, ih2x, ih2y, ih2z, Z, Y, X, stream, counts));
        CALL(nsol_cg_update(x, rf, p_cur, qf, partials, scal, n, kStoreExact, 1, stream,
                            admm_counts));
        float* tmp = p_prev;
        p_prev = p_cur;
        p_cur = tmp;
      }
    }
    // clips x, then the shrink, the dual update and the next rhs
    CALL(nsol_admm_tail(x, v, w, atb, rhs, ihx, ihy, ihz, tau, rho, 0, Z, Y, X, stream,
                        admm_counts));
  }
#undef CALL
#undef UNIT
  return 0;
}

}  // extern "C"
