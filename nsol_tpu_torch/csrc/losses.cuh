// The data losses of nsol_tpu/ops/losses.py on the device, shared by
// robust.cu (the IRLS weights rho'_C) and admm.cu (the records' values
// rho_C). Every step is rounded as the reference writes it: f2 / C^2 is a
// division, not a multiply by a reciprocal, and nothing is contracted.

#pragma once

#include <cuda_runtime.h>

namespace {

// Losses, in the order of nsol_tpu/ops/losses.py LOSSES.
enum Loss { kLinear = 0, kSoftL1 = 1, kHuber = 2, kCauchy = 3, kArctan = 4 };

// Huber's transition (losses.py HUBER_GAMMA), its square and its double,
// each computed in double and rounded once, as the reference's Python
// floats are.
constexpr float kHuberGamma = 1.345f;
constexpr float kHuberGamma2 = (float)(1.345 * 1.345);
constexpr float kTwoHuberGamma = (float)(2.0 * 1.345);

// rho'_C(f2) = rho'(f2 / C^2) (nsol_tpu/ops/losses.py:43-90).
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

// rho_C(f2) = C^2 rho(f2 / C^2); the linear loss is f2 at any C.
__device__ __forceinline__ float loss_value(float f2, float fs2, int loss) {
  const float t = __fdiv_rn(f2, fs2);
  float v;
  switch (loss) {
    case kSoftL1:
      v = __fmul_rn(2.f, __fsub_rn(__fsqrt_rn(__fadd_rn(1.f, t)), 1.f));
      break;
    case kHuber:
      v = t < kHuberGamma2 ? t : __fsub_rn(__fmul_rn(kTwoHuberGamma, __fsqrt_rn(t)), kHuberGamma2);
      break;
    case kCauchy:
      v = log1pf(t);
      break;
    case kArctan:
      v = atanf(t);
      break;
    default:
      return f2;
  }
  return __fmul_rn(v, fs2);
}

}  // namespace
