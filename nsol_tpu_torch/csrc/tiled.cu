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
// rule) are in march.cuh; their whole-volume instances, which admm.cu's
// and robust.cu's C entries take by march.cuh's vol_route, are in
// normal_march.cu (normal_apply, and the normal window), step_march.cu
// (cg_step), blur_march.cu (blur_apply and irls_head, and the blur
// window) and weighted_march.cu (weighted_apply): this file's
// normal_apply_zy, cg_step_zy, blur_apply_zy and weighted_apply_zy are
// their TV instances, which the 512-wide-plane route always takes.

#include <cuda_runtime.h>

#include "march.cuh"
#include "stream.cuh"

extern "C" {
// The whole-volume march instances (step_march.cu, weighted_march.cu,
// normal_march.cu, blur_march.cu), which add to no count.
int nsol_normal_apply_march(const void* v, void* out, const float* rhs, void* p_out, int p_bf16,
                            double* partials, double* scal, const float* taps, int kz, int ky,
                            int kx, float rho, int reg, int io, float ih2x, float ih2y,
                            float ih2z, int Z, int Y, int X, void* stream);
int nsol_blur_apply_march(const float* y, const float* u, float* out, float* free, float* rk,
                          const float* b, float* wts, float* yout, double* partials,
                          double* scal, const float* taps, int kz, int ky, int kx, float rho,
                          int reg, int loss, float scale, float ih2x, float ih2y, float ih2z,
                          int Z, int Y, int X, void* stream);
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

// ---------------------------------------------------------------- units --

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
int nsol_admm_tail(float* x, float* v, const float* w, float* w_out, const float* atb,
                   float* rhs, float ihx, float ihy, float ihz, float tau, float rho, int init,
                   int ncomp, int Z, int Y, int X, void* stream, long long* counts);

// The partials any march unit's grid may need at (Z, Y, X): the blocks of
// its shortest z tile.
int nsol_tiled_blocks(int Z, int Y, int X) { return march_max_blocks(Dims{Z, Y, X}); }

// Planes a block of the single-stencil march (march 0, z taps kz), of the
// weighted march (march 1, blur z taps kz) or of the single-stencil
// march's sweep instance (march 2, three blocks an SM) marches through at
// (Z, Y, X) on the current device: march.cuh's rule, which
// ops/cuda/tiled.py::tile_z mirrors.
int nsol_march_tile_z(int Z, int Y, int X, int kz, int march) {
  const Taps tp{nullptr, nullptr, nullptr, kz, kz, kz};
  const Dims d{Z, Y, X};
  if (march == 1) return weighted_grid(d, tp).tz;
  return stencil_grid(d, tp, march == 2 ? kSweepResident : kStencilResident).tz;
}

// Whether the whole-volume unit (stencil.cuh's VolUnit, at the taps (kz,
// ky, kx)) takes its march at (Z, Y, X): march.cuh's vol_route, which
// ops/cuda/tiled.py::vol_route mirrors.
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

// io and p_out, p_bf16 as normal_march.cu's nsol_normal_apply_march takes
// them (the Laplacian).
int nsol_normal_apply_zy(const void* v, void* out, const float* rhs, void* p_out, int p_bf16,
                         double* partials, double* scal, const float* taps, int kz, int ky,
                         int kx, float rho, int io, float ih2x, float ih2y, float ih2z, int Z,
                         int Y, int X, void* stream, long long* counts) {
  const int e = nsol_normal_apply_march(v, out, rhs, p_out, p_bf16, partials, scal, taps, kz, ky,
                                        kx, rho, kRegLap, io, ih2x, ih2y, ih2z, Z, Y, X, stream);
  counts[kNormalApplyZy] += 1;
  return e;
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
  const int e = nsol_blur_apply_march(y, u, out, free, rk, b, wts, yout, partials, scal, taps, kz,
                                      ky, kx, rho, kRegLap, loss, scale, ih2x, ih2y, ih2z, Z, Y,
                                      X, stream);
  counts[kBlurApplyZy] += 1;
  return e;
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
// prox/dual chain is admm_tail.cu's admm_tail, w and w' alternating between
// the volumes w and v (no v is written), and the CG update its cg_update
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
  const long long n = Dims{Z, Y, X}.n();
  if (storage != kStoreExact && (mode != 0 || storage == kStoreQf32))
    return (int)cudaErrorInvalidValue;
  const int compact = storage != kStoreExact, state = storage == kStoreState;
  int e;
#define UNIT(idx, call) NSOL_UNIT(counts, idx, call)
#define CALL(call)                  \
  if ((e = (int)(call)) != 0) return e;
  CALL(nsol_blur_apply_zy(b, nullptr, atb, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                          nullptr, taps_a, kaz, kay, kax, 0.f, 0, 1.f, ih2x, ih2y, ih2z, Z, Y, X,
                          stream, counts));
  float* w_cur = w;
  float* w_next = v;
  CALL(nsol_admm_tail(x, nullptr, w_cur, w_cur, atb, rhs, ihx, ihy, ihz, tau, rho, 1, 3, Z, Y, X,
                      stream, admm_counts));
  for (int it = 0; it < iterations; ++it) {
    // warm-started CG on M x = rhs: r = rhs - M x, gamma = |r|^2
    if (mode == 0) {
      // and the first direction p0 = r
      CALL(nsol_normal_apply_zy(x, r, rhs, p0, compact, partials, scal, taps_n, knz, kny, knx,
                                rho, state, ih2x, ih2y, ih2z, Z, Y, X, stream, counts));
      for (int k = 0; k < iter_max; ++k) {
        CALL(nsol_normal_apply_zy(p0, q, nullptr, nullptr, 0, partials, scal, taps_n, knz, kny,
                                  knx, rho, compact, ih2x, ih2y, ih2z, Z, Y, X, stream, counts));
        CALL(nsol_cg_update(x, r, p0, q, partials, scal, n, storage, !state, stream,
                            admm_counts));
        if (k + 1 < iter_max)
          UNIT(kCgDirection, stream_direction(p0, r, state ? q : nullptr, scal, n, storage, s));
      }
    } else {
      CALL(nsol_normal_apply_zy(x, r, rhs, nullptr, 0, partials, scal, taps_n, knz, kny, knx, rho,
                                0, ih2x, ih2y, ih2z, Z, Y, X, stream, counts));
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
    CALL(nsol_admm_tail(x, nullptr, w_cur, w_next, atb, rhs, ihx, ihy, ihz, tau, rho, 0, 3, Z, Y,
                        X, stream, admm_counts));
    float* tmp = w_cur;
    w_cur = w_next;
    w_next = tmp;
  }
#undef CALL
#undef UNIT
  return 0;
}

}  // extern "C"
