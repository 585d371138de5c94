// The per-axis wrap-convolution passes shared by admm.cu and robust.cu, and
// the CG update they both run.
//
// A separable blur of a (Z, Y, X) float32 volume is three passes, one per
// axis, through two scratch volumes: conv_x_pass reads its input through a
// source functor (a prologue: a plain load, or a CG direction formed on the
// fly), conv_y_kernel is a plain pass, and conv_z_pass hands every
// convolved value to an epilogue functor (the Laplacian, a residual, IRLS
// weights, an active set, ...) that may return a term of a deterministic
// block reduction. One stencil, many prologues and epilogues.
//
// A source functor has `prepare()` (run once per thread, before any load:
// it reads device scalars), `operator()(k)` (the value the x pass
// convolves) and `dir(k)` (the value the x pass may store beside it). An
// epilogue functor has `operator()(i, conv, c, d)` (c the voxel's
// coordinates) returning a double to sum (0 when it reduces nothing).

#pragma once

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

// Device scalar slots of the CG state (double).
enum Slot { kGamma = 0, kPQ = 1, kA = 2, kBeta = 3 };
// Second-stage reductions.
enum Reduce { kReducePQ = 0, kReduceRR = 1, kReduceRR0 = 2 };

struct Dims {
  int Z, Y, X;
  __host__ __device__ long long n() const { return (long long)Z * Y * X; }
  __host__ __device__ long long plane() const { return (long long)Y * X; }
};

struct Taps {  // per-array-axis stencils, contiguous in one device buffer
  const float* z;
  const float* y;
  const float* x;
  int kz, ky, kx;
};

struct Spacing {  // 1/h and 1/h^2 in spatial (x, y, z) order
  float ihx, ihy, ihz, ih2x, ih2y, ih2z;
};

struct Coord {  // a voxel's array coordinates
  int x, y, z;
};

inline Taps make_taps(const float* buf, int kz, int ky, int kx) {
  return Taps{buf, buf + kz, buf + kz + ky, kz, ky, kx};
}

inline int grid_for(long long n) {
  long long b = (n + kThreads - 1) / kThreads;
  if (b < 1) b = 1;
  return (int)(b < kMaxBlocks ? b : kMaxBlocks);
}

// Enqueue one kernel unit inside a C solve function: count it, and return
// its launch error from the enclosing function if there is one.
#define NSOL_UNIT(counts, idx, call)      \
  do {                                    \
    const cudaError_t e_ = (call);        \
    (counts)[idx] += 1;                   \
    if (e_ != cudaSuccess) return (int)e_; \
  } while (0)

#define GRID_STRIDE(i, n)                                                  \
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;     \
       i < (n); i += (long long)gridDim.x * blockDim.x)

// scipy.ndimage wrap convolution along one axis:
// y[i] = sum_j k[j] u[(i + c - j) mod n], c = K / 2. The index walks down
// with wrap, so a stencil longer than the axis wraps as often as it must.
template <typename Fn>
__device__ __forceinline__ float wrap_conv(const Fn& load, long long base, int coord, int n,
                                           long long stride, const float* __restrict__ taps,
                                           int K) {
  int m = (coord + K / 2) % n;
  float acc = 0.f;
  for (int j = 0; j < K; ++j) {
    acc = fmaf(__ldg(taps + j), load(base + (long long)m * stride), acc);
    m = (m == 0) ? n - 1 : m - 1;
  }
  return acc;
}

// Zero-boundary D^T D along one axis: (u[i] - u[i-1]) [i > 0] + u[i] - u[i+1]
// with u[n] := 0, i.e. x[0] - x[1] on the first row and 2x[n-1] - x[n-2] on
// the last (nsol_tpu/ops/grad.py::gradient_normal).
template <typename Fn>
__device__ __forceinline__ float lap_axis(const Fn& u, long long i, int coord, int n,
                                          long long stride) {
  const float c = u(i);
  const float lo = coord > 0 ? c - u(i - stride) : 0.f;
  const float hi = c - (coord + 1 < n ? u(i + stride) : 0.f);
  return lo + hi;
}

// sum_ax (1/h_ax^2) D_ax^T D_ax u at voxel i (c its coordinates).
template <typename Fn>
__device__ __forceinline__ float laplacian(const Fn& u, long long i, Coord c, Spacing sp,
                                           Dims d) {
  return sp.ih2x * lap_axis(u, i, c.x, d.X, 1) + sp.ih2y * lap_axis(u, i, c.y, d.Y, d.X) +
         sp.ih2z * lap_axis(u, i, c.z, d.Z, d.plane());
}

// The regulariser's normal operator B^T B in the epilogues: the
// zero-boundary Laplacian D^T D (TV, TK1) or the identity (TK0). It is a
// template parameter, so no instance tests it per voxel, and the identity
// reads neither neighbours nor coordinates (the compiler drops them).
enum RegKind { kRegLap = 0, kRegIdentity = 1 };

template <int kReg, typename Fn>
__device__ __forceinline__ float reg_normal(const Fn& u, long long i, Coord c, Spacing sp,
                                            Dims d) {
  if (kReg == kRegIdentity) return u(i);
  return laplacian(u, i, c, sp, d);
}

// ------------------------------------------------------------- sources --

// A volume read as it is.
struct Load {
  const float* p;
  __device__ void prepare() {}
  __device__ float operator()(long long k) const { return __ldg(p + k); }
  __device__ float dir(long long k) const { return __ldg(p + k); }
};

// The CG direction p' = r + beta p (p' = r on the first trip), with beta
// read once from the device scalars. Masked, the x pass convolves
// free * p' (the active-set CG of IRLS); the mask is a template parameter
// so that the unmasked tap loop tests nothing per tap.
template <bool kMasked>
struct DirectionT {
  const float* r;
  const float* p;
  const float* free;
  const double* scal;
  int first;
  float beta;
  __device__ void prepare() { beta = first ? 0.f : (float)scal[kBeta]; }
  __device__ float dir(long long k) const {
    const float rk = __ldg(r + k);  // one address computation for both cases
    return first ? rk : __fmaf_rn(beta, __ldg(p + k), rk);
  }
  __device__ float operator()(long long k) const {
    const float v = dir(k);
    return kMasked ? __ldg(free + k) * v : v;
  }
};
using Direction = DirectionT<false>;
using MaskedDirection = DirectionT<true>;

// -------------------------------------------------------------- passes --

// x pass: out = wrap conv of src along x; dir_out = src.dir when given.
template <class Src>
__global__ void conv_x_pass(Src src, float* __restrict__ out, float* __restrict__ dir_out,
                            const float* __restrict__ taps, int K, Dims d) {
  src.prepare();
  const long long n = d.n();
  GRID_STRIDE(i, n) {
    const int ix = (int)(i % d.X);
    const float conv = wrap_conv(src, i - ix, ix, d.X, 1, taps, K);
    if (dir_out != nullptr) dir_out[i] = src.dir(i);  // loads before the store to out
    out[i] = conv;
  }
}

__global__ void conv_y_kernel(const float* __restrict__ in, float* __restrict__ out,
                              const float* __restrict__ taps, int K, Dims d) {
  const Load src{in};
  const long long n = d.n();
  GRID_STRIDE(i, n) {
    const int iy = (int)((i / d.X) % d.Y);
    out[i] = wrap_conv(src, i - (long long)iy * d.X, iy, d.Y, d.X, taps, K);
  }
}

// z pass: the epilogue gets every value of the wrap conv of t along z; what
// it returns is summed per block into partials[blockIdx.x] when partials
// is given (uniform across the block). The coordinates are computed before
// the taps are read, so their integer divisions overlap the loads; an
// epilogue that reads none of them lets the compiler drop them.
template <class Epi>
__global__ void conv_z_pass(const float* __restrict__ t, Epi epi, double* __restrict__ partials,
                            const float* __restrict__ taps, int K, Dims d) {
  const Load src{t};
  const long long n = d.n(), plane = d.plane();
  double acc = 0.0;
  GRID_STRIDE(i, n) {
    const Coord c{(int)(i % d.X), (int)((i / d.X) % d.Y), (int)(i / plane)};
    acc += epi(i, wrap_conv(src, i - (long long)c.z * plane, c.z, d.Z, plane, taps, K), c, d);
  }
  if (partials != nullptr) {
    const double s = block_sum(acc);
    if (threadIdx.x == 0) partials[blockIdx.x] = s;
  }
}

// The three passes of one blur chain: t1 = conv_x(src), t2 = conv_y(t1),
// then conv_z(t2) into the epilogue.
template <class Src, class Epi>
void blur_chain(Src src, float* dir_out, Epi epi, double* partials, float* t1, float* t2,
                Taps tp, Dims d, cudaStream_t s) {
  const int g = grid_for(d.n());
  conv_x_pass<<<g, kThreads, 0, s>>>(src, t1, dir_out, tp.x, tp.kx, d);
  conv_y_kernel<<<g, kThreads, 0, s>>>(t1, t2, tp.y, tp.ky, d);
  conv_z_pass<<<g, kThreads, 0, s>>>(t2, epi, partials, tp.z, tp.kz, d);
}

// ------------------------------------------------------------------ CG --

// Second stage: sum the partials in a fixed order and update the CG
// scalars with the reference's guards (fused.py:365-374, cg.py:86-92).
__global__ void reduce_kernel(const double* __restrict__ partials, int nparts,
                              double* __restrict__ scal, int mode) {
  double acc = 0.0;
  for (int k = threadIdx.x; k < nparts; k += blockDim.x) acc += partials[k];
  const double s = block_sum(acc);
  if (threadIdx.x != 0) return;
  if (mode == kReducePQ) {
    scal[kPQ] = s;
    scal[kA] = s > 0.0 ? scal[kGamma] / s : 0.0;
  } else if (mode == kReduceRR) {
    const double g = scal[kGamma];
    scal[kBeta] = g > 0.0 ? s / g : 0.0;
    scal[kGamma] = s;
  } else {
    scal[kGamma] = s;
    scal[kBeta] = 0.0;
  }
}

__global__ void cg_update_kernel(float* __restrict__ x, float* __restrict__ r,
                                 const float* __restrict__ p, const float* __restrict__ q,
                                 const double* __restrict__ scal, double* __restrict__ partials,
                                 long long n) {
  const float a = (float)scal[kA];
  double acc = 0.0;
  GRID_STRIDE(i, n) {
    x[i] = fmaf(a, p[i], x[i]);
    const float ri = fmaf(-a, q[i], r[i]);
    r[i] = ri;
    acc += (double)ri * ri;
  }
  const double s = block_sum(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = s;
}

// x += a p, r -= a q, then beta = |r|^2 / gamma (guarded), gamma = |r|^2.
inline cudaError_t cg_update(float* x, float* r, const float* p, const float* q,
                             double* partials, double* scal, long long n, cudaStream_t s) {
  const int g = grid_for(n);
  cg_update_kernel<<<g, kThreads, 0, s>>>(x, r, p, q, scal, partials, n);
  reduce_kernel<<<1, kReduceThreads, 0, s>>>(partials, g, scal, kReduceRR);
  return cudaGetLastError();
}

}  // namespace
