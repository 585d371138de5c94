// The linear ADMM units' device code that csrc/admm.cu's kernels and
// csrc/admm_persistent.cu's one-launch solve both run: the normal
// operator's z epilogue (q, the CG residual, the CG dot) and admm_record's
// data epilogue and TV pass.

#pragma once

#include "losses.cuh"
#include "stencil.cuh"

namespace {

// Epilogues of the z pass.
enum Epilogue { kPlain = 0, kDot = 1, kResidual = 2 };

// z-pass epilogue of the normal operator: q = conv_z + rho * B^T B v (v read
// through V, which may round it), then q stored as O, the CG residual
// rhs - q (q rounded to O first, as the reference's apply stores it) with
// its square summed and stored as O, or q stored as O with v.q summed (q
// before its rounding: the reference's step takes pq from the float q).
template <int kReg, class V = Load, class O = float>
struct NormalEpi {
  V v;
  const float* rhs;
  O* out;
  float rho;
  Spacing sp;
  int mode;
  __device__ double operator()(long long i, float conv, Coord c, Dims d) const {
    const float q = fmaf(rho, reg_normal<kReg>(v, i, c, sp, d), conv);
    if (mode == kResidual) {
      const float res = rhs[i] - round_as<O>(q);
      out[i] = store_as<O>(res);
      return (double)res * res;
    }
    // v is read before the store: the compiler cannot tell that out does
    // not alias it, and a load after the store waits for it.
    const double dot = mode == kDot ? (double)v(i) * q : 0.0;
    out[i] = store_as<O>(q);
    return dot;
  }
};

// admm_record's z epilogue: r = A x - b, rho_C(r^2) summed. kNc: b read
// through the read-only path.
template <bool kNc = true>
struct DataEpiT {
  const float* b;
  float fs2;
  int loss;
  __device__ double operator()(long long i, float conv, Coord, Dims) const {
    const float r = __fsub_rn(conv, load_f<kNc>(b + i));
    return (double)loss_value(__fmul_rn(r, r), fs2, loss);
  }
};
using DataEpi = DataEpiT<true>;

// TV of x, sum sqrt(sum_ax (D_ax x / h_ax)^2), zero-boundary forward
// differences, one partial per block (fused.py:627-631); idx and Team as
// stencil.cuh's pass bodies take them.
template <class Team = BlockTeam, class Idx>
__device__ __forceinline__ void record_tv_body(const float* x, double* partials, Spacing sp,
                                               Dims d, const Idx& idx, int vb, int G) {
  const long long n = d.n(), plane = d.plane();
  double acc = 0.0;
  BLOCK_STRIDE(i, n, vb, G, Team::tid()) {
    const Coord at = idx.at(i);
    const int ix = at.x, iy = at.y, iz = at.z;
    const float c = x[i];
    const float gx = ((ix + 1 < d.X ? x[i + 1] : 0.f) - c) * sp.ihx;
    const float gy = ((iy + 1 < d.Y ? x[i + d.X] : 0.f) - c) * sp.ihy;
    const float gz = ((iz + 1 < d.Z ? x[i + plane] : 0.f) - c) * sp.ihz;
    acc += (double)__fsqrt_rn(__fadd_rn(__fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy)),
                                        __fmul_rn(gz, gz)));
  }
  const double s = Team::sum(acc);
  if (Team::tid() == 0) partials[vb] = s;
}

}  // namespace
