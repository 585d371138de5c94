// Hopper (sm_90a) normal apply on march.cuh's single-stencil march.
//
// Counterpart of the TPU Pallas kernels
//   nsol_tpu/ops/pallas/blocked.py::make_blocked_normal_operator             (:402)
//   nsol_tpu/ops/pallas/blocked.py::make_blocked_normal_operator_2d          (:754)
//   nsol_tpu/ops/pallas/blocked.py::make_blocked_normal_operator_prepadded   (:478)
// q = N_z N_y N_x v + rho B^T B v (B^T B the zero-boundary Laplacian of TV
// and TK1, or the identity of TK0), in each form a solve runs:
//   plain     q stored as v is (float, or bfloat16 io); A^T b is this form
//             at the blur taps with rho = 0;
//   residual  r = rhs - q with gamma = |r|^2 (q rounded to r's storage
//             first; a bfloat16 residual reads x as bfloat16 and stores r
//             in bfloat16, gamma from the unrounded r), and, given p_out,
//             the first CG direction p = r beside it;
//   dot       q with pq = sum v.q from the rounded q (TK1 only: the
//             "apply" CG of the 512-wide-plane route);
// and the window form (the sharded path's normal_apply_prepadded): the
// march over the Zl + 2 h planes of a z-window with no z wrap, its
// Laplacian's zero-boundary z rows only at global rows 0 and z_total - 1.
// admm.cu's C entry normal_apply takes the whole-volume march wherever
// march.cuh's vol_route says (the solves of admm.cu and tikhonov.cu with
// it), tiled.cu's normal_apply_zy always; admm.cu's
// normal_apply_prepadded takes the window form where its taps fit.
//
// Design: march.cuh's single-stencil march over one input window (float,
// or bfloat16 copied in 16-byte groups and widened where the taps read
// it), with the Laplacian's raw ring; q and the residual are its
// epilogue, and the residual's and the dot's sums one float64 partial a
// block. Each output takes the three-pass chain's taps in the same order
// with the same roundings (the Laplacian's, or the identity's raw-ring
// centre, v read at its storage's precision), so q and r equal admm.cu's
// chain bit for bit; gamma and pq sum in another order. What bounds it on
// the H100: instruction issue and shared-memory accesses, as the march
// (march.cuh); bytes would bound it at 256^3 at 0.04-0.05 ms (v read, q
// written once; the residual also reads rhs) (PERF.md).

#include <cuda_runtime.h>

#include "march.cuh"

namespace {

enum NormalMode { kNormalPlain = 0, kNormalResidual = 1, kNormalDot = 2 };

// q = conv + rho B^T B v stored as O; plain q, the residual rhs - q (q
// rounded to O first; summed squared, stored as O, and as the first CG
// direction p_out of type P when given), or q with centre.q summed (q
// after its rounding, as the reference's "apply" CG reads it back). B^T B:
// the Laplacian, or v itself (kRegIdentity), the raw ring's centre read
// at O's precision as the chain's v is.
template <int kMode, int kReg, class O = float, class P = float>
struct NormalZyEpi {
  const float* rhs;
  O* out;
  P* p_out;
  float rho;
  __device__ double operator()(long long i, float conv, float lap, float centre) const {
    const float q = fmaf(rho, kReg == kRegIdentity ? centre : lap, conv);
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

// The residual form: x read at O's precision, r stored as O and, when p_out
// is given, the first CG direction p = r as P.
template <int kReg, class O, class P>
cudaError_t normal_residual(const float* x, O* out, P* p_out, const float* rhs, double* partials,
                            double* scal, Taps tp, float rho, Spacing sp, Dims d,
                            cudaStream_t s) {
  const StencilArgs<float, O> a{x, nullptr, nullptr, scal, 1, tp, sp, d, partials};
  const cudaError_t e = launch_stencil<kNormalK, kSrcOne, true>(
      a, 1, NormalZyEpi<kNormalResidual, kReg, O, P>{rhs, out, p_out, rho}, s);
  if (e != cudaSuccess) return e;
  reduce_kernel<<<1, kReduceThreads, 0, s>>>(partials, stencil_grid(d, tp).blocks(), scal,
                                             kReduceRR0);
  return cudaGetLastError();
}

// v and q stored as T: plain q, or (scal given, TK1) q with pq = sum v.q.
template <int kReg, class T>
cudaError_t normal_plain(const T* v, T* out, double* partials, double* scal, Taps tp, float rho,
                         Spacing sp, Dims d, cudaStream_t s) {
  StencilArgs<T> a{v, nullptr, nullptr, scal, 1, tp, sp, d, nullptr};
  if (scal == nullptr)
    return launch_stencil<kNormalK, kSrcOne, true>(
        a, 1, NormalZyEpi<kNormalPlain, kReg, T>{nullptr, out, nullptr, rho}, s);
  if (kReg != kRegLap) return cudaErrorInvalidValue;
  a.partials = partials;
  const cudaError_t e = launch_stencil<kNormalK, kSrcOne, true>(
      a, 1, NormalZyEpi<kNormalDot, kRegLap, T>{nullptr, out, nullptr, rho}, s);
  if (e != cudaSuccess) return e;
  reduce_kernel<<<1, kReduceThreads, 0, s>>>(partials, stencil_grid(d, tp).blocks(), scal,
                                             kReducePQ);
  return cudaGetLastError();
}

template <int kReg>
cudaError_t normal_march(const void* v, void* out, const float* rhs, void* p_out, int p_bf16,
                         double* partials, double* scal, Taps tp, float rho, int io, Spacing sp,
                         Dims d, cudaStream_t s) {
  if (rhs == nullptr) {
    if (io)
      return normal_plain<kReg>(static_cast<const bf16*>(v), static_cast<bf16*>(out), partials,
                                scal, tp, rho, sp, d, s);
    return normal_plain<kReg>(static_cast<const float*>(v), static_cast<float*>(out), partials,
                              scal, tp, rho, sp, d, s);
  }
  if (scal == nullptr) return cudaErrorInvalidValue;
  const float* x = static_cast<const float*>(v);
  if constexpr (kReg == kRegIdentity) {  // the solves' form: no direction beside r
    if (p_out != nullptr) return cudaErrorInvalidValue;
    if (io)
      return normal_residual<kReg>(x, static_cast<bf16*>(out), static_cast<bf16*>(nullptr), rhs,
                                   partials, scal, tp, rho, sp, d, s);
    return normal_residual<kReg>(x, static_cast<float*>(out), static_cast<float*>(nullptr), rhs,
                                 partials, scal, tp, rho, sp, d, s);
  } else {
    if (io) {
      if (!p_bf16 && p_out != nullptr) return cudaErrorInvalidValue;
      return normal_residual<kReg>(x, static_cast<bf16*>(out), static_cast<bf16*>(p_out), rhs,
                                   partials, scal, tp, rho, sp, d, s);
    }
    if (p_bf16)
      return normal_residual<kReg>(x, static_cast<float*>(out), static_cast<bf16*>(p_out), rhs,
                                   partials, scal, tp, rho, sp, d, s);
    return normal_residual<kReg>(x, static_cast<float*>(out), static_cast<float*>(p_out), rhs,
                                 partials, scal, tp, rho, sp, d, s);
  }
}

}  // namespace

extern "C" {

// The forms by the pointers given: rhs (and scal): the residual; scal
// alone: the dot (reg kRegLap only); else plain. io 0: v and out float;
// io 1: out bfloat16, and v bfloat16 (plain and dot) or a float x read as
// bfloat16 (residual). p_out (residual, kRegLap only; may be null): float
// when p_bf16 is 0, else bfloat16 (a bfloat16 residual takes a bfloat16
// one).
// partials holds nsol_tiled_blocks(Z, Y, X) doubles. Enqueues on
// `stream`, adds to no count, returns the launch's error
// (cudaErrorInvalidValue where the taps do not fit a block).
int nsol_normal_apply_march(const void* v, void* out, const float* rhs, void* p_out, int p_bf16,
                            double* partials, double* scal, const float* taps, int kz, int ky,
                            int kx, float rho, int reg, int io, float ih2x, float ih2y,
                            float ih2z, int Z, int Y, int X, void* stream) {
  const Spacing sp{0.f, 0.f, 0.f, ih2x, ih2y, ih2z};
  const Taps tp = make_taps(taps, kz, ky, kx);
  const Dims d{Z, Y, X};
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)(reg == kRegIdentity
                   ? normal_march<kRegIdentity>(v, out, rhs, p_out, p_bf16, partials, scal, tp,
                                                rho, io, sp, d, s)
                   : normal_march<kRegLap>(v, out, rhs, p_out, p_bf16, partials, scal, tp, rho,
                                           io, sp, d, s));
}

// The window form: the march over the Zl + 2 halo planes of v_ext, halo
// the z taps' half-width (at least 1); q = A^T A v + rho D^T D v on the Zl
// centre planes, whose Laplacian takes its zero-boundary rows only at
// global rows 0 and z_total - 1 (row0 the window's first global row).
// Adds to no count.
int nsol_normal_apply_window_zy(const float* v_ext, float* out, const float* taps, int kz, int ky,
                                int kx, float rho, float ih2x, float ih2y, float ih2z, int halo,
                                int row0, int z_total, int Zl, int Y, int X, void* stream) {
  if (halo != halo_of(kz)) return (int)cudaErrorInvalidValue;
  const Spacing sp{0.f, 0.f, 0.f, ih2x, ih2y, ih2z};
  const StencilArgs<> a{v_ext, nullptr, nullptr, nullptr, 1, make_taps(taps, kz, ky, kx),
                        sp, Dims{Zl, Y, X}, nullptr, row0, z_total};
  return (int)launch_stencil<kNormalK, kSrcOne, true, true>(
      a, 1, NormalZyEpi<kNormalPlain, kRegLap>{nullptr, out, nullptr, rho}, (cudaStream_t)stream);
}

}  // extern "C"
