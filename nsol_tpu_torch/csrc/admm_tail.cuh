// admm_tail's device code (the note at the top of csrc/admm_tail.cu),
// shared by admm_tail.cu's kernel and csrc/admm_persistent.cu's one-launch
// solve: its arguments, the shrink and one voxel's tail.

#pragma once

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

// admm_tail's volumes and scalars (admm_tail.cu's C entry).
struct TailArgs {
  float* x;          // clipped in place (not by the init form)
  const float* w;    // (ncomp, Z, Y, X), read (not by the init form)
  float* w_out;      // w', another volume than w
  float* v;          // v, or null: not written
  const float* atb;  // A^T b
  float* rhs;
  float ihx, ihy, ihz, tau, rho;
  int Z, Y, X;
  long long n;  // Z Y X, the stride of a component
  int y0, z0;   // the launch's first row and plane
};

// The value of x the gradients read: clip0 of it, which is idempotent, so
// a read racing the owner's in-place clip sees the same value.
template <bool kInit>
__device__ __forceinline__ float xval(float u) {
  return kInit ? u : clip0(u);
}

// One voxel's shrink from its clipped x (c), its +1 neighbours in x, y, z
// and w: v and w'. Init: v = grad x / h, w' = 0.
template <bool kInit>
__device__ __forceinline__ void shrink(float c, float xx, float xy, float xz, float wx, float wy,
                                       float wz, const TailArgs& a, float (&v)[3],
                                       float (&wn)[3]) {
  const float gx = __fsub_rn(xx, c), gy = __fsub_rn(xy, c), gz = __fsub_rn(xz, c);
  if (kInit) {
    v[0] = __fmul_rn(gx, a.ihx);
    v[1] = __fmul_rn(gy, a.ihy);
    v[2] = __fmul_rn(gz, a.ihz);
    wn[0] = wn[1] = wn[2] = 0.f;
    return;
  }
  const float t[3] = {__fmaf_rn(gx, a.ihx, wx), __fmaf_rn(gy, a.ihy, wy),
                      __fmaf_rn(gz, a.ihz, wz)};
  const float norm =
      __fsqrt_rn(__fmaf_rn(t[2], t[2], __fmaf_rn(t[0], t[0], __fmul_rn(t[1], t[1]))));
  const float scale = norm > a.tau ? __fdiv_rn(fmaxf(__fsub_rn(norm, a.tau), 0.f), norm) : 0.f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    v[k] = __fmul_rn(t[k], scale);
    wn[k] = __fsub_rn(t[k], v[k]);
  }
}

// One voxel (ix, iy, iz) of the tail (admm_tail.cu's note): the shrink at
// it and at its lower neighbours. kZ: three components (a volume, the (1,
// Y, X) view included); else two (a 2-D image, Z = 1). kNc: w and A^T b
// read through the read-only path (common.cuh's load_f).
template <bool kInit, bool kZ, bool kNc>
__device__ __forceinline__ void tail_voxel(const TailArgs& a, int ix, int iy, int iz) {
  const long long plane = (long long)a.Y * a.X;
  // v - w' at voxel j of coordinates (jx, jy, jz), and its v, w'
  const auto at = [&](long long j, int jx, int jy, int jz, float (&v)[3], float (&wn)[3]) {
    const float c = xval<kInit>(a.x[j]);
    const float xx = jx + 1 < a.X ? xval<kInit>(a.x[j + 1]) : 0.f;
    const float xy = jy + 1 < a.Y ? xval<kInit>(a.x[j + a.X]) : 0.f;
    const float xz = kZ && jz + 1 < a.Z ? xval<kInit>(a.x[j + plane]) : 0.f;
    if (kInit)
      shrink<true>(c, xx, xy, xz, 0.f, 0.f, 0.f, a, v, wn);
    else
      shrink<false>(c, xx, xy, xz, load_f<kNc>(a.w + j), load_f<kNc>(a.w + a.n + j),
                    kZ ? load_f<kNc>(a.w + 2 * a.n + j) : 0.f, a, v, wn);
    return c;
  };
  const long long i = iz * plane + (long long)iy * a.X + ix;
  float v[3], wn[3], vb[3], wb[3];
  const float c = at(i, ix, iy, iz, v, wn);
  float lx = 0.f, ly = 0.f, lz = 0.f;
  if (ix > 0) {
    at(i - 1, ix - 1, iy, iz, vb, wb);
    lx = __fsub_rn(vb[0], wb[0]);
  }
  if (iy > 0) {
    at(i - a.X, ix, iy - 1, iz, vb, wb);
    ly = __fsub_rn(vb[1], wb[1]);
  }
  if (kZ && iz > 0) {
    at(i - plane, ix, iy, iz - 1, vb, wb);
    lz = __fsub_rn(vb[2], wb[2]);
  }
  const float ddx = __fsub_rn(lx, __fsub_rn(v[0], wn[0]));
  const float ddy = __fsub_rn(ly, __fsub_rn(v[1], wn[1]));
  const float ddz = __fsub_rn(lz, __fsub_rn(v[2], wn[2]));
  const float div = __fmaf_rn(ddz, a.ihz, __fmaf_rn(ddx, a.ihx, __fmul_rn(ddy, a.ihy)));
  a.rhs[i] = __fmaf_rn(div, a.rho, load_f<kNc>(a.atb + i));
  if (!kInit) a.x[i] = c;
  const int nc = kZ ? 3 : 2;
  for (int k = 0; k < nc; ++k) {
    a.w_out[k * a.n + i] = wn[k];
    if (a.v != nullptr) a.v[k * a.n + i] = v[k];
  }
}

}  // namespace
