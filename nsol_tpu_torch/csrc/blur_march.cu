// Hopper (sm_90a) blur operator on march.cuh's single-stencil march.
//
// Counterpart of the TPU Pallas kernels
//   nsol_tpu/ops/pallas/robust.py::make_blocked_blur_operator     (:161)
//   nsol_tpu/ops/pallas/robust.py::make_blocked_blur_operator_2d  (:734)
// g = A y (blur taps), with u A y + rho B^T B u (B^T B the zero-boundary
// Laplacian of TV and TK1, or the identity of TK0), in each form the IRLS
// sweep runs:
//   plain     A y;
//   with u    A y + rho B^T B u;
//   gradient  g = A y + rho B^T B x (u = x, y = wts r): the active set
//             free = !(x <= 0 && g > 0) as a {0, 1} float field,
//             rk = -free g, gamma = |rk|^2, beta = 0;
//   head      r = A x - b, wts = rho'_C(r^2) (every loss of losses.cuh, C
//             at run time), y = wts r (robust.py:508, no Laplacian);
// and the window form (the sharded path's blur_apply_prepadded,
// prepadded=True): the march over the Zl + 2 h planes of y_ext (and
// u_ext) with no z wrap, with u its Laplacian's zero-boundary z rows only
// at global rows 0 and z_total - 1, without u no Laplacian.
// robust.cu's C entries blur_apply and irls_head take the whole-volume
// march wherever march.cuh's vol_route says (the sweeps of robust.cu and
// tikhonov.cu with it), tiled.cu's blur_apply_zy always (TK1), and
// robust.cu's blur_apply_prepadded takes the window form where its taps
// fit.
//
// Design: march.cuh's single-stencil march over one input window (y, or
// x for the head) or two (y and u, whose centre tiles fill the
// Laplacian's raw ring); the epilogues write g, the active set, rk, the
// weights and y, and the gradient's sum is one float64 partial a block.
// Each output takes the three-pass chain's taps in the same order with
// the same roundings, so every output equals robust.cu's chain bit for
// bit; gamma sums in another order. What bounds it on the H100:
// instruction issue and shared-memory accesses, as the march (march.cuh);
// bytes would bound the gradient form at 256^3 at 0.08 ms (y, x read,
// free, rk written once) (PERF.md).

#include <cuda_runtime.h>

#include "losses.cuh"
#include "march.cuh"

namespace {

// g = conv (+ rho B^T B u, lap set) into out; B^T B the Laplacian, or u
// itself (kRegIdentity: the raw ring's centre).
template <int kReg>
struct BlurZyEpi {
  float* out;
  float rho;
  int lap;
  __device__ double operator()(long long i, float conv, float l, float u) const {
    out[i] = lap ? fmaf(rho, kReg == kRegIdentity ? u : l, conv) : conv;
    return 0.0;
  }
};

// The IRLS gradient (centre = x): g = conv + rho B^T B x,
// free = !(x <= 0 && g > 0), rk = -free g.
template <int kReg>
struct GradZyEpi {
  float* free;
  float* rk;
  float rho;
  __device__ double operator()(long long i, float conv, float l, float x) const {
    const float g = fmaf(rho, kReg == kRegIdentity ? x : l, conv);
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

// The gradient and with-u forms (two windows and the Laplacian's raw
// ring) by the regulariser.
template <int kReg>
cudaError_t blur_two(StencilArgs<> a, float* out, float* free, float* rk, double* partials,
                     double* scal, float rho, cudaStream_t s) {
  if (free == nullptr)
    return launch_stencil<kBlurK, kSrcTwo, true>(a, 2, BlurZyEpi<kReg>{out, rho, 1}, s);
  a.partials = partials;
  const cudaError_t e =
      launch_stencil<kBlurK, kSrcTwo, true>(a, 2, GradZyEpi<kReg>{free, rk, rho}, s);
  if (e != cudaSuccess) return e;
  reduce_kernel<<<1, kReduceThreads, 0, s>>>(partials, stencil_grid(a.d, a.tp).blocks(), scal,
                                             kReduceRR0);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The forms by the pointers given: head (b: wts, yout from A y - b, y = x),
// gradient (free: free, rk from A y + rho B^T B u, u = x, gamma into
// scal), with u (A y + rho B^T B u into out), or plain A y into out. reg a
// RegKind (the with-u and gradient forms), loss a Loss with its scale C
// (the head). partials holds nsol_tiled_blocks(Z, Y, X) doubles.
// Enqueues on `stream`, adds to no count, returns the launch's error
// (cudaErrorInvalidValue where the taps do not fit a block).
int nsol_blur_apply_march(const float* y, const float* u, float* out, float* free, float* rk,
                          const float* b, float* wts, float* yout, double* partials,
                          double* scal, const float* taps, int kz, int ky, int kx, float rho,
                          int reg, int loss, float scale, float ih2x, float ih2y, float ih2z,
                          int Z, int Y, int X, void* stream) {
  const Spacing sp{0.f, 0.f, 0.f, ih2x, ih2y, ih2z};
  const StencilArgs<> a{y, u, nullptr, scal, 1, make_taps(taps, kz, ky, kx), sp, Dims{Z, Y, X},
                        nullptr};
  const cudaStream_t s = (cudaStream_t)stream;
  if (b != nullptr)
    return (int)launch_stencil<kBlurK, kSrcOne, false>(
        a, 1, HeadZyEpi{b, wts, yout, scale * scale, loss}, s);
  if (free != nullptr && (u == nullptr || scal == nullptr)) return (int)cudaErrorInvalidValue;
  if (u == nullptr)
    return (int)launch_stencil<kBlurK, kSrcOne, false>(a, 1, BlurZyEpi<kRegLap>{out, rho, 0}, s);
  return (int)(reg == kRegIdentity
                   ? blur_two<kRegIdentity>(a, out, free, rk, partials, scal, rho, s)
                   : blur_two<kRegLap>(a, out, free, rk, partials, scal, rho, s));
}

// The window form: the march over the Zl + 2 halo planes of y_ext (and
// u_ext, which may be null), halo the z taps' half-width (at least 1);
// out = A y (+ rho D^T D u) on the Zl centre planes, the Laplacian's
// zero-boundary rows only at global rows 0 and z_total - 1 (row0 the
// window's first global row). Adds to no count.
int nsol_blur_apply_window_march(const float* y_ext, const float* u_ext, float* out,
                                 const float* taps, int kz, int ky, int kx, float rho, float ih2x,
                                 float ih2y, float ih2z, int halo, int row0, int z_total, int Zl,
                                 int Y, int X, void* stream) {
  if (halo != halo_of(kz)) return (int)cudaErrorInvalidValue;
  const Spacing sp{0.f, 0.f, 0.f, ih2x, ih2y, ih2z};
  const StencilArgs<> a{y_ext, u_ext, nullptr, nullptr, 1, make_taps(taps, kz, ky, kx),
                        sp, Dims{Zl, Y, X}, nullptr, row0, z_total};
  const cudaStream_t s = (cudaStream_t)stream;
  if (u_ext == nullptr)
    return (int)launch_stencil<kBlurK, kSrcOne, false, true>(a, 1,
                                                             BlurZyEpi<kRegLap>{out, rho, 0}, s);
  return (int)launch_stencil<kBlurK, kSrcTwo, true, true>(a, 2, BlurZyEpi<kRegLap>{out, rho, 1},
                                                          s);
}

}  // extern "C"
