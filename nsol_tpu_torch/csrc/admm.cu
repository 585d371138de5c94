// Hopper (sm_90a) kernels of the 3-D TV-L2 ADMM deconvolution path.
//
// Counterparts of the TPU Pallas kernels
//   nsol_tpu/ops/pallas/blocked.py::make_blocked_normal_operator  (:402)
//   nsol_tpu/ops/pallas/blocked.py::make_blocked_cg_step          (:988)
//   nsol_tpu/ops/pallas/fused.py::make_fused_admm_solver          (:382, linear)
// computing the same f32 results, not their block structure.
//
// Volumes are (Z, Y, X) float32, X contiguous. Four kernel units, each a
// short sequence of launches on the caller's stream:
//
//   normal_apply  q = N_z N_y N_x v + rho * sum_ax (1/h_ax^2) D_ax^T D_ax v
//                 (self-correlated separable wrap blur + zero-boundary
//                 Laplacian). One pass per axis through two scratch volumes;
//                 the z pass adds the Laplacian and an epilogue (plain q, or
//                 the CG residual rhs - q with the partial sums of its square).
//   cg_step       p' = r + beta p formed on the fly inside the x pass, then
//                 q = M p' and the partial sums of p'.q; second stage
//                 a = gamma / pq.
//   cg_update     x += a p', r -= a q and the partial sums of r^2; second
//                 stage beta = gamma' / gamma, gamma = gamma'.
//   admm_tail     clip x >= 0, t = grad x / h + w, grouped shrink at
//                 tau = alpha / rho, v, w updates; then the next
//                 rhs = A^T b + rho div(v - w) (two passes: the divergence
//                 needs neighbours of v - w).
//
// What bounds them on the H100: memory traffic, at a few flops per byte.
// At 64^3 (1 MiB a volume) the whole state sits in the 50 MB L2 and a
// solve is ~3300 short launches, so launches and their host enqueue bound
// it; at 256^3 (64 MiB a volume) the elementwise passes run near HBM
// bandwidth and the per-axis stencil passes, which read every tap through
// L2, at a fraction of it. The design keeps the passes simple (all loads
// coalesced along X, no shared-memory tiles yet) and keeps every CG scalar
// on the device, so nothing waits for the host inside a solve.
//
// Reductions are deterministic: each block reduces its grid-stride slice
// in double in a fixed order, writes one partial, and a one-block second
// stage sums the partials in a fixed order. No atomics, so a run repeats
// bit for bit.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

// Device scalar slots of the CG state (double).
enum Slot { kGamma = 0, kPQ = 1, kA = 2, kBeta = 3 };
// Kernel units, the indices of the launch counts handed back to Python.
enum Unit { kNormalApply = 0, kCgStep = 1, kCgUpdate = 2, kAdmmTail = 3 };
// Epilogues of the z pass.
enum Epilogue { kPlain = 0, kDot = 1, kResidual = 2 };
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

int grid_for(long long n) {
  long long b = (n + kThreads - 1) / kThreads;
  if (b < 1) b = 1;
  return (int)(b < kMaxBlocks ? b : kMaxBlocks);
}

#define GRID_STRIDE(i, n)                                                  \
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;     \
       i < (n); i += (long long)gridDim.x * blockDim.x)

// scipy.ndimage wrap convolution along one axis:
// y[i] = sum_j k[j] u[(i + c - j) mod n], c = K / 2. The index walks down
// with wrap, so a stencil longer than the axis wraps as often as it must.
template <typename Load>
__device__ __forceinline__ float wrap_conv(Load load, long long base, int coord, int n,
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
__device__ __forceinline__ float lap_axis(const float* __restrict__ u, long long i, int coord,
                                          int n, long long stride) {
  const float c = u[i];
  const float lo = coord > 0 ? c - u[i - stride] : 0.f;
  const float hi = c - (coord + 1 < n ? u[i + stride] : 0.f);
  return lo + hi;
}

__device__ __forceinline__ float clip0(float u) { return u < 0.f ? 0.f : u; }

// x pass. src = r, or the CG direction p' = r + beta p (p' = r on the
// first trip), written to p_new when p_new is given.
__global__ void conv_x_kernel(const float* __restrict__ r, const float* __restrict__ p,
                              const double* __restrict__ scal, int first,
                              float* __restrict__ p_new, float* __restrict__ out,
                              const float* __restrict__ taps, int K, Dims d) {
  const bool blend = p_new != nullptr && !first;
  const float beta = blend ? (float)scal[kBeta] : 0.f;
  auto src = [&](long long k) { return blend ? __fmaf_rn(beta, p[k], r[k]) : r[k]; };
  const long long n = d.n();
  GRID_STRIDE(i, n) {
    const int ix = (int)(i % d.X);
    out[i] = wrap_conv(src, i - ix, ix, d.X, 1, taps, K);
    if (p_new != nullptr) p_new[i] = src(i);
  }
}

__global__ void conv_y_kernel(const float* __restrict__ in, float* __restrict__ out,
                              const float* __restrict__ taps, int K, Dims d) {
  auto src = [&](long long k) { return in[k]; };
  const long long n = d.n();
  GRID_STRIDE(i, n) {
    const int iy = (int)((i / d.X) % d.Y);
    out[i] = wrap_conv(src, i - (long long)iy * d.X, iy, d.Y, d.X, taps, K);
  }
}

// z pass: q = conv_z(t) + rho * lap(v), then the epilogue.
__global__ void conv_z_lap_kernel(const float* __restrict__ t, const float* __restrict__ v,
                                  const float* __restrict__ rhs, float* __restrict__ out,
                                  double* __restrict__ partials, const float* __restrict__ taps,
                                  int K, float rho, Spacing sp, int epilogue, Dims d) {
  auto src = [&](long long k) { return t[k]; };
  const long long n = d.n(), plane = d.plane();
  double acc = 0.0;
  GRID_STRIDE(i, n) {
    const int ix = (int)(i % d.X);
    const int iy = (int)((i / d.X) % d.Y);
    const int iz = (int)(i / plane);
    const float conv = wrap_conv(src, i - (long long)iz * plane, iz, d.Z, plane, taps, K);
    const float lap = sp.ih2x * lap_axis(v, i, ix, d.X, 1) +
                      sp.ih2y * lap_axis(v, i, iy, d.Y, d.X) +
                      sp.ih2z * lap_axis(v, i, iz, d.Z, plane);
    const float q = fmaf(rho, lap, conv);
    if (epilogue == kResidual) {
      const float res = rhs[i] - q;
      out[i] = res;
      acc += (double)res * res;
    } else {
      out[i] = q;
      if (epilogue == kDot) acc += (double)v[i] * q;
    }
  }
  if (epilogue != kPlain) {  // uniform across the block
    const double s = block_sum(acc);
    if (threadIdx.x == 0) partials[blockIdx.x] = s;
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

// ADMM prox/dual update (fused.py:651-667). init: v = grad x (unclipped),
// w = 0 (fused.py:579-580).
__global__ void admm_shrink_kernel(const float* __restrict__ x, float* __restrict__ v,
                                   float* __restrict__ w, Spacing sp, float tau, int init,
                                   Dims d) {
  auto xc = [&](long long k) { return init ? x[k] : clip0(x[k]); };
  const long long n = d.n(), plane = d.plane();
  GRID_STRIDE(i, n) {
    const int ix = (int)(i % d.X);
    const int iy = (int)((i / d.X) % d.Y);
    const int iz = (int)(i / plane);
    const float c = xc(i);
    const float gx = ((ix + 1 < d.X ? xc(i + 1) : 0.f) - c) * sp.ihx;
    const float gy = ((iy + 1 < d.Y ? xc(i + d.X) : 0.f) - c) * sp.ihy;
    const float gz = ((iz + 1 < d.Z ? xc(i + plane) : 0.f) - c) * sp.ihz;
    if (init) {
      v[i] = gx;
      v[n + i] = gy;
      v[2 * n + i] = gz;
      w[i] = 0.f;
      w[n + i] = 0.f;
      w[2 * n + i] = 0.f;
      continue;
    }
    const float tx = gx + w[i], ty = gy + w[n + i], tz = gz + w[2 * n + i];
    const float norm = sqrtf(tx * tx + ty * ty + tz * tz);
    const float scale = norm > tau ? fmaxf(norm - tau, 0.f) / norm : 0.f;
    const float vx = tx * scale, vy = ty * scale, vz = tz * scale;
    v[i] = vx;
    v[n + i] = vy;
    v[2 * n + i] = vz;
    w[i] = tx - vx;
    w[n + i] = ty - vy;
    w[2 * n + i] = tz - vz;
  }
}

// rhs = A^T b + rho * sum_k D_k^T (v_k - w_k) / h_k (fused.py:645), and
// x = max(x, 0) in place when clip is set (fused.py:651).
__global__ void admm_rhs_kernel(float* __restrict__ x, const float* __restrict__ v,
                                const float* __restrict__ w, const float* __restrict__ atb,
                                float* __restrict__ rhs, Spacing sp, float rho, int clip,
                                Dims d) {
  const long long n = d.n(), plane = d.plane();
  auto dvw = [&](int k, long long j) { return v[k * n + j] - w[k * n + j]; };
  GRID_STRIDE(i, n) {
    const int ix = (int)(i % d.X);
    const int iy = (int)((i / d.X) % d.Y);
    const int iz = (int)(i / plane);
    const float dx = (ix > 0 ? dvw(0, i - 1) : 0.f) - dvw(0, i);
    const float dy = (iy > 0 ? dvw(1, i - d.X) : 0.f) - dvw(1, i);
    const float dz = (iz > 0 ? dvw(2, i - plane) : 0.f) - dvw(2, i);
    const float div = dx * sp.ihx + dy * sp.ihy + dz * sp.ihz;
    rhs[i] = fmaf(rho, div, atb[i]);
    if (clip) x[i] = clip0(x[i]);
  }
}

// ---------------------------------------------------------------- units --

cudaError_t normal_apply(const float* v, float* out, float* t1, float* t2, const float* rhs,
                         double* partials, double* scal, Taps tp, float rho, Spacing sp,
                         Dims d, cudaStream_t s) {
  const int g = grid_for(d.n());
  conv_x_kernel<<<g, kThreads, 0, s>>>(v, nullptr, nullptr, 0, nullptr, t1, tp.x, tp.kx, d);
  conv_y_kernel<<<g, kThreads, 0, s>>>(t1, t2, tp.y, tp.ky, d);
  conv_z_lap_kernel<<<g, kThreads, 0, s>>>(t2, v, rhs, out, partials, tp.z, tp.kz, rho, sp,
                                           rhs != nullptr ? kResidual : kPlain, d);
  if (rhs != nullptr) reduce_kernel<<<1, kReduceThreads, 0, s>>>(partials, g, scal, kReduceRR0);
  return cudaGetLastError();
}

cudaError_t cg_step(const float* r, const float* p, float* p_new, float* q, float* t1,
                    float* t2, double* partials, double* scal, int first, Taps tp, float rho,
                    Spacing sp, Dims d, cudaStream_t s) {
  const int g = grid_for(d.n());
  conv_x_kernel<<<g, kThreads, 0, s>>>(r, p, scal, first, p_new, t1, tp.x, tp.kx, d);
  conv_y_kernel<<<g, kThreads, 0, s>>>(t1, t2, tp.y, tp.ky, d);
  conv_z_lap_kernel<<<g, kThreads, 0, s>>>(t2, p_new, nullptr, q, partials, tp.z, tp.kz, rho,
                                           sp, kDot, d);
  reduce_kernel<<<1, kReduceThreads, 0, s>>>(partials, g, scal, kReducePQ);
  return cudaGetLastError();
}

cudaError_t cg_update(float* x, float* r, const float* p, const float* q, double* partials,
                      double* scal, long long n, cudaStream_t s) {
  const int g = grid_for(n);
  cg_update_kernel<<<g, kThreads, 0, s>>>(x, r, p, q, scal, partials, n);
  reduce_kernel<<<1, kReduceThreads, 0, s>>>(partials, g, scal, kReduceRR);
  return cudaGetLastError();
}

cudaError_t admm_tail(float* x, float* v, float* w, const float* atb, float* rhs, Spacing sp,
                      float tau, float rho, int init, Dims d, cudaStream_t s) {
  const int g = grid_for(d.n());
  admm_shrink_kernel<<<g, kThreads, 0, s>>>(x, v, w, sp, tau, init, d);
  admm_rhs_kernel<<<g, kThreads, 0, s>>>(x, v, w, atb, rhs, sp, rho, init ? 0 : 1, d);
  return cudaGetLastError();
}

Taps make_taps(const float* buf, int kz, int ky, int kx) {
  return Taps{buf, buf + kz, buf + kz + ky, kz, ky, kx};
}

}  // namespace

// ------------------------------------------------------------ C interface --
// Every function enqueues on `stream`, never synchronizes, allocates
// nothing, adds one to counts[unit] per unit it launches, and returns
// cudaGetLastError() (0 on success).

extern "C" {

int nsol_max_blocks() { return kMaxBlocks; }

int nsol_normal_apply(const float* v, float* out, float* t1, float* t2, const float* rhs,
                      double* partials, double* scal, const float* taps, int kz, int ky, int kx,
                      float rho, float ih2x, float ih2y, float ih2z, int Z, int Y, int X,
                      void* stream, long long* counts) {
  const Spacing sp{0.f, 0.f, 0.f, ih2x, ih2y, ih2z};
  cudaError_t e = normal_apply(v, out, t1, t2, rhs, partials, scal, make_taps(taps, kz, ky, kx),
                               rho, sp, Dims{Z, Y, X}, (cudaStream_t)stream);
  counts[kNormalApply] += 1;
  return (int)e;
}

int nsol_cg_step(const float* r, const float* p, float* p_new, float* q, float* t1, float* t2,
                 double* partials, double* scal, int first, const float* taps, int kz, int ky,
                 int kx, float rho, float ih2x, float ih2y, float ih2z, int Z, int Y, int X,
                 void* stream, long long* counts) {
  const Spacing sp{0.f, 0.f, 0.f, ih2x, ih2y, ih2z};
  cudaError_t e = cg_step(r, p, p_new, q, t1, t2, partials, scal, first,
                          make_taps(taps, kz, ky, kx), rho, sp, Dims{Z, Y, X},
                          (cudaStream_t)stream);
  counts[kCgStep] += 1;
  return (int)e;
}

int nsol_cg_update(float* x, float* r, const float* p, const float* q, double* partials,
                   double* scal, long long n, void* stream, long long* counts) {
  cudaError_t e = cg_update(x, r, p, q, partials, scal, n, (cudaStream_t)stream);
  counts[kCgUpdate] += 1;
  return (int)e;
}

int nsol_admm_tail(float* x, float* v, float* w, const float* atb, float* rhs, float ihx,
                   float ihy, float ihz, float tau, float rho, int init, int Z, int Y, int X,
                   void* stream, long long* counts) {
  const Spacing sp{ihx, ihy, ihz, 0.f, 0.f, 0.f};
  cudaError_t e = admm_tail(x, v, w, atb, rhs, sp, tau, rho, init, Dims{Z, Y, X},
                            (cudaStream_t)stream);
  counts[kAdmmTail] += 1;
  return (int)e;
}

// The whole linear ADMM TV-L2 solve (fused.py:382, linear branch), enqueued
// on `stream`. x holds x0 on entry and the result on exit. As in the fused
// TPU kernel, x0 is not clipped on entry (tikhonov.py:130 clips it; the two
// agree for x0 = b >= 0).
int nsol_admm_solve(const float* b, float* x, float* v, float* w, float* atb, float* rhs,
                    float* r, float* p0, float* p1, float* q, float* t1, float* t2,
                    double* partials, double* scal, const float* taps_a, int kaz, int kay,
                    int kax, const float* taps_n, int knz, int kny, int knx, float ihx,
                    float ihy, float ihz, float ih2x, float ih2y, float ih2z, float tau,
                    float rho, int iterations, int iter_max, int Z, int Y, int X,
                    void* stream, long long* counts) {
  const cudaStream_t s = (cudaStream_t)stream;
  const Dims d{Z, Y, X};
  const Spacing sp{ihx, ihy, ihz, ih2x, ih2y, ih2z};
  const Taps ta = make_taps(taps_a, kaz, kay, kax);
  const Taps tn = make_taps(taps_n, knz, kny, knx);
  cudaError_t e;

#define UNIT(idx, call)        \
  do {                         \
    e = (call);                \
    counts[idx] += 1;          \
    if (e != cudaSuccess) return (int)e; \
  } while (0)

  // A^T b = A b once (A symmetric, fused.py:576), then v0 = grad x0, w0 = 0
  // and the first rhs.
  UNIT(kNormalApply, normal_apply(b, atb, t1, t2, nullptr, partials, scal, ta, 0.f, sp, d, s));
  UNIT(kAdmmTail, admm_tail(x, v, w, atb, rhs, sp, tau, rho, 1, d, s));
  for (int it = 0; it < iterations; ++it) {
    // warm-started CG on M x = rhs: r = rhs - M x, gamma = |r|^2
    UNIT(kNormalApply, normal_apply(x, r, t1, t2, rhs, partials, scal, tn, rho, sp, d, s));
    float* p_prev = p0;
    float* p_cur = p1;
    for (int k = 0; k < iter_max; ++k) {
      UNIT(kCgStep, cg_step(r, p_prev, p_cur, q, t1, t2, partials, scal, k == 0, tn, rho, sp,
                            d, s));
      UNIT(kCgUpdate, cg_update(x, r, p_cur, q, partials, scal, d.n(), s));
      float* tmp = p_prev;
      p_prev = p_cur;
      p_cur = tmp;
    }
    UNIT(kAdmmTail, admm_tail(x, v, w, atb, rhs, sp, tau, rho, 0, d, s));
  }
#undef UNIT
  return 0;
}

}  // extern "C"
