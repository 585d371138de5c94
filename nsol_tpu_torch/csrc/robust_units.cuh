// The robust (IRLS) units' device code that csrc/robust.cu's launch
// sequence and csrc/irls_persistent.cu's one-launch sweep both run: the z
// epilogues of irls_head (the loss weights of losses.cuh), of blur_apply
// (its gradient form with the free mask and rk) and of the weighted
// apply's two chains (the weights, the mask, in every RobustStorage mode)
// and irls_step's voxel.
//
// kNc: the epilogues' loads take the read-only (non-coherent) path, as the
// sequence's kernels read volumes nothing writes while they run; the
// persistent sweep reads volumes other blocks wrote earlier in the launch
// and takes plain loads (kNc false; persistent.cuh). The two give the same
// values.

#pragma once

#include <cuda_runtime.h>

#include "losses.cuh"
#include "stencil.cuh"

namespace {

// irls_head's z epilogue: r = A x - b, wts = rho'_C(r^2), y = wts r.
template <bool kNc = true>
struct WeightsEpiT {
  const float* b;
  float* wts;
  float* y;
  float fs2;
  int loss;
  __device__ double operator()(long long i, float conv, Coord, Dims) const {
    const float r = __fsub_rn(conv, load_f<kNc>(b + i));
    const float w = loss_weight(__fmul_rn(r, r), fs2, loss);
    wts[i] = w;
    y[i] = __fmul_rn(w, r);
    return 0.0;
  }
};
using WeightsEpi = WeightsEpiT<true>;

// blur_apply's z epilogue: g = conv (+ rho B^T B u) into out; the gradient
// form (free given, u = x) writes the active set and rk = -free g instead
// and sums rk^2.
template <int kReg, bool kNc = true>
struct BlurEpi {
  const float* u;
  float* out;
  float* free;
  float* rk;
  float rho;
  Spacing sp;
  __device__ double operator()(long long i, float conv, Coord c, Dims d) const {
    const float g =
        u != nullptr ? fmaf(rho, reg_normal<kReg>(LoadT<float, float, kNc>{u}, i, c, sp, d), conv)
                     : conv;
    if (free == nullptr) {
      out[i] = g;
      return 0.0;
    }
    const bool active = load_f<kNc>(u + i) <= 0.f && g > 0.f;
    const float r = active ? 0.f : -g;
    free[i] = active ? 0.f : 1.f;
    rk[i] = r;
    return (double)r * r;
  }
};

// weighted_apply's first z epilogue: s = wts * A pf, the weights stored
// as WT and read at W's precision (bfloat16 under kRobustIo, the
// reference's wts16).
template <class W = float, class WT = float, bool kNc = true>
struct ScaleEpi {
  const WT* wts;
  float* s;
  __device__ double operator()(long long i, float conv, Coord, Dims) const {
    s[i] = __fmul_rn(round_as<W>(load_f<kNc>(wts + i)), conv);
    return 0.0;
  }
};

// weighted_apply's second z epilogue: core = A s + rho B^T B pf (rounded to
// bfloat16 with kIo, as the reference's bf16 io apply stores it),
// q = free core + (p' - pf) (q = core when every voxel is free), p'.q
// summed. The frozen coordinates keep q = p', so pq counts them. p' is
// read as stored (P).
template <int kReg, class P = float, bool kIo = false, bool kNc = true>
struct MaskedEpi {
  const P* dir;  // p'
  const float* free;
  float* q;
  float rho;
  Spacing sp;
  __device__ double operator()(long long i, float conv, Coord c, Dims d) const {
    const P* const dp = dir;
    const float* const fp = free;
    const auto pf = [dp, fp](long long k) {  // pf = free * p'
      const float v = load_f<kNc>(dp + k);
      return fp != nullptr ? load_f<kNc>(fp + k) * v : v;
    };
    float core = fmaf(rho, reg_normal<kReg>(pf, i, c, sp, d), conv);
    if (kIo) core = round_as<bf16>(core);
    const float p = load_f<kNc>(dir + i);
    float qi = core;
    if (free != nullptr) {
      const float f = load_f<kNc>(free + i);
      qi = __fadd_rn(__fmul_rn(f, core), __fsub_rn(p, __fmul_rn(f, p)));
    }
    q[i] = qi;
    return (double)p * qi;
  }
};

// irls_step at voxel i: x = max(x + xk, 0), a NaN kept (common.cuh clip0).
__device__ __forceinline__ void irls_step_voxel(float* x, const float* xk, long long i) {
  x[i] = clip0(__fadd_rn(x[i], xk[i]));
}

}  // namespace
