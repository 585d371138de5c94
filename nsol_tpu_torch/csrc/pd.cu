// Hopper (sm_90a) kernels of the primal-dual (Chambolle–Pock) denoising path.
//
// Counterpart of the TPU Pallas kernel
//   nsol_tpu/ops/pallas/fused.py::make_fused_pd_denoise_solver  (:957)
// computing the same f32 iteration (fused.py:1122-1166), not its blocks: the
// minor-axis difference matmuls of the TPU form are plain f32 differences
// here, with the spacing applied as a multiply by 1/h.
//
// Images are 2-D (Y, X) or 3-D (Z, Y, X) float32, X contiguous, batched over
// alpha: x, x_mean are (B, *shape), the dual p is (B, ndim, *shape) with the
// x component first, b and x0 are one (*shape) image shared by the batch. A
// 2-D image runs with ndim = 2 and Z = 1, never as a (1, Y, X) volume: the
// zero-padded forward difference along a length-1 z axis is -x, not 0. The
// step schedules sigma_t, tau_t, tau_t*lambda, theta_t sit in one float32
// device array (4, B, iterations), indexed by t.
//
// Three kernel units, each a launch (or two) on the caller's stream:
//
//   pd_dual    p_i <- proj(p_i + sigma_t D_i x_mean / h_i), proj(q) =
//              q / max(1, |q|) componentwise (Huber types: q / (1 + sigma_t
//              gamma) first). Reads x_mean (with its +1 neighbours) and p,
//              writes p: ~(1 + 2 ndim) volumes moved per image.
//   pd_primal  z = x - tau_t sum_i D_i^T p_i / h_i with the new p, then the
//              l1 shifted soft-threshold or the l2 closed form at ft_t with
//              x0 = b, then x_mean = x_new + theta_t (x_new - x), x = x_new.
//              Reads p, x, b, writes x, x_mean: ~(ndim + 4) volumes.
//   pd_record  Reg (isotropic TV, or 1/2 sum huber(|grad x|^2, gamma_rec))
//              and Data (sum |x - b| or sum (x - b)^2) of the current x:
//              per-block float64 partials, then a one-block-per-image second
//              stage that sums them in a fixed order into (B, iterations+1).
//              Reads x and b: ~2 volumes. No float atomics: a run repeats
//              bit for bit.
//
// The primal step needs the new p at the lower neighbours, a grid-wide
// dependency, so each iteration is two passes (the TPU kernel holds the whole
// state in VMEM; one SM's shared memory cannot hold even a 1024^2 image).
// What bounds the units is memory traffic at a few flops per byte: at Man
// 1024^2 x 64 alphas one iteration moves ~11-12 volumes x 4 MiB x 64 ~ 3 GiB
// (~0.9 ms at the 3.35 TB/s peak); at 256^3 ~14 volumes x 64 MiB. A small
// image (Lena 256^2, 256 KiB) is bound by its ~100-150 launches per solve.
// Index arithmetic is 32-bit (the wrapper checks B * ndim * n < 2^31).
// nsol_pd_solve enqueues a whole solve; nothing syncs with the host inside it.
//
// Storage (the reference's compact=True, fused.py:1091-1167, K10b.4): every
// unit is a template over the state's type T, float or bfloat16. With
// bfloat16, x, x_mean and every p_i are stored in 2 bytes and read as their
// exact float upcasts; all arithmetic is float, and a value is rounded to
// bfloat16 (to nearest, ties to even, as JAX's astype) exactly where the
// reference rounds it: the fresh dual before the primal step reads it, the
// new x before the measures and the over-relaxation see it, and x_mean; b
// stays float. The initial state round(x0) and the output's upcast are made
// by the wrapper. Each operation is written with an _rn intrinsic in the
// reference's order, so that nvcc contracts nothing into an FMA: one fused
// rounding less would flip a bfloat16 rounding now and then, and the flip
// propagates. The state then moves ~half the bytes (~7 byte-volumes a voxel
// and iteration instead of ~12 at Man 1024^2).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

// Kernel units, the indices of the launch counts handed back to Python.
enum PdUnit { kPdDual = 0, kPdPrimal = 1, kPdRecord = 2 };
// Rows of the schedule array (4, B, iterations).
enum Sched { kSigma = 0, kTau = 1, kFt = 2, kTheta = 3 };
// Blocks in flight over the whole batch (~8 resident 256-thread blocks on
// each of 132 SMs, two waves).
constexpr int kPdBlocks = 2048;

struct PdDims {
  int ndim, B, Z, Y, X;
  __host__ __device__ int n() const { return Z * Y * X; }
  __host__ __device__ int plane() const { return Y * X; }
};

struct InvH {  // 1/h in spatial (x, y, z) order; z unused in 2-D
  float x, y, z;
};

// A state value as float, stored as T, and rounded to T's precision.
__device__ __forceinline__ float ld(const float* p, int i) { return p[i]; }
__device__ __forceinline__ float ld(const bf16* p, int i) { return __bfloat162float(p[i]); }
__device__ __forceinline__ void st(float* p, int i, float v) { p[i] = v; }
__device__ __forceinline__ void st(bf16* p, int i, float v) { p[i] = __float2bfloat16_rn(v); }
template <class T>
__device__ __forceinline__ float rnd(float v) {
  return sizeof(T) == sizeof(float) ? v : __bfloat162float(__float2bfloat16_rn(v));
}

// (next - c) / h along one axis, 0 past the last row: the forward difference.
__device__ __forceinline__ float fdiff(float next, float c, float ih) {
  return __fmul_rn(__fsub_rn(next, c), ih);
}

// Blocks along x of the launch grid; grid.y is the batch.
int pd_grid(int B, int n) {
  int per = kPdBlocks / B;
  if (per < 1) per = 1;
  const int need = (n + kThreads - 1) / kThreads;
  return need < per ? need : per;
}

#define PD_STRIDE(i, n) \
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < (n); i += gridDim.x * blockDim.x)

__device__ __forceinline__ float sched_at(const float* __restrict__ sched, int row, int bi,
                                          int t, int iters, int B) {
  return sched[(row * B + bi) * iters + t];
}

template <class T>
__global__ void pd_dual_kernel(const T* __restrict__ xm, T* __restrict__ p,
                               const float* __restrict__ sched, int t, int iters, int huber,
                               float gamma, PdDims d, InvH ih) {
  const int bi = blockIdx.y;
  const int n = d.n(), plane = d.plane();
  const float s = sched_at(sched, kSigma, bi, t, iters, d.B);
  const float shrink = __fadd_rn(1.f, __fmul_rn(s, gamma));
  const T* __restrict__ x = xm + bi * n;
  T* __restrict__ pb = p + bi * d.ndim * n;
  PD_STRIDE(i, n) {
    const int ix = i % d.X, iy = (i / d.X) % d.Y, iz = i / plane;
    const float c = ld(x, i);
    auto update = [&](int k, float g) {
      float q = __fadd_rn(ld(pb, k * n + i), __fmul_rn(s, g));
      if (huber) q = __fdiv_rn(q, shrink);
      st(pb, k * n + i, __fdiv_rn(q, fmaxf(1.f, fabsf(q))));
    };
    update(0, fdiff(ix + 1 < d.X ? ld(x, i + 1) : 0.f, c, ih.x));
    update(1, fdiff(iy + 1 < d.Y ? ld(x, i + d.X) : 0.f, c, ih.y));
    if (d.ndim == 3) update(2, fdiff(iz + 1 < d.Z ? ld(x, i + plane) : 0.f, c, ih.z));
  }
}

template <class T>
__global__ void pd_primal_kernel(T* __restrict__ x, T* __restrict__ xm,
                                 const T* __restrict__ p, const float* __restrict__ b,
                                 const float* __restrict__ sched, int t, int iters, int ell1,
                                 PdDims d, InvH ih) {
  const int bi = blockIdx.y;
  const int n = d.n(), plane = d.plane();
  const float tau = sched_at(sched, kTau, bi, t, iters, d.B);
  const float ft = sched_at(sched, kFt, bi, t, iters, d.B);
  const float theta = sched_at(sched, kTheta, bi, t, iters, d.B);
  const float one_ft = __fadd_rn(1.f, ft);
  T* __restrict__ xb = x + bi * n;
  T* __restrict__ mb = xm + bi * n;
  const T* __restrict__ p0 = p + bi * d.ndim * n;
  const T* __restrict__ p1 = p0 + n;
  const T* __restrict__ p2 = p1 + n;
  PD_STRIDE(i, n) {
    const int ix = i % d.X, iy = (i / d.X) % d.Y, iz = i / plane;
    // sum_i D_i^T p_i / h_i, x first: (p[i-1] - p[i]) / h, p[-1] = 0
    float div = fdiff(ix > 0 ? ld(p0, i - 1) : 0.f, ld(p0, i), ih.x);
    div = __fadd_rn(div, fdiff(iy > 0 ? ld(p1, i - d.X) : 0.f, ld(p1, i), ih.y));
    if (d.ndim == 3)
      div = __fadd_rn(div, fdiff(iz > 0 ? ld(p2, i - plane) : 0.f, ld(p2, i), ih.z));
    const float xo = ld(xb, i), bv = b[i];
    const float z = __fsub_rn(xo, __fmul_rn(tau, div));
    float xn;
    if (ell1) {
      const float dz = __fsub_rn(z, bv);
      const float m = fmaxf(__fsub_rn(fabsf(dz), ft), 0.f);
      xn = __fadd_rn(bv, dz > 0.f ? m : (dz < 0.f ? -m : 0.f));
    } else {
      xn = __fdiv_rn(__fadd_rn(z, __fmul_rn(ft, bv)), one_ft);
    }
    xn = rnd<T>(xn);  // the stored iterate, which x_mean and the records see
    st(mb, i, __fadd_rn(xn, __fmul_rn(theta, __fsub_rn(xn, xo))));
    st(xb, i, xn);
  }
}

template <class T>
__global__ void pd_record_kernel(const T* __restrict__ x, const float* __restrict__ b,
                                 double* __restrict__ partials, int ell1, int huber, float gr,
                                 PdDims d, InvH ih) {
  const int bi = blockIdx.y;
  const int n = d.n(), plane = d.plane();
  const float gr2 = __fmul_rn(gr, gr);
  const T* __restrict__ xb = x + bi * n;
  double acc_r = 0.0, acc_d = 0.0;
  PD_STRIDE(i, n) {
    const int ix = i % d.X, iy = (i / d.X) % d.Y, iz = i / plane;
    const float c = ld(xb, i);
    const float gx = fdiff(ix + 1 < d.X ? ld(xb, i + 1) : 0.f, c, ih.x);
    const float gy = fdiff(iy + 1 < d.Y ? ld(xb, i + d.X) : 0.f, c, ih.y);
    float g2 = __fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy));
    if (d.ndim == 3) {
      const float gz = fdiff(iz + 1 < d.Z ? ld(xb, i + plane) : 0.f, c, ih.z);
      g2 = __fadd_rn(g2, __fmul_rn(gz, gz));
    }
    const float r = huber ? (g2 < gr2 ? g2 : __fsub_rn(__fmul_rn(2.f * gr, sqrtf(g2)), gr2))
                          : sqrtf(g2);
    const float dv = __fsub_rn(c, b[i]);
    acc_r += (double)r;
    acc_d += ell1 ? (double)fabsf(dv) : (double)__fmul_rn(dv, dv);
  }
  const double sr = block_sum(acc_r);
  __syncthreads();
  const double sd = block_sum(acc_d);
  if (threadIdx.x == 0) {
    const int k = bi * gridDim.x + blockIdx.x;
    partials[2 * k] = sr;
    partials[2 * k + 1] = sd;
  }
}

// Second stage: block bi sums image bi's partials in a fixed order.
__global__ void pd_record_reduce_kernel(const double* __restrict__ partials, int nparts, int t,
                                        int cols, double* __restrict__ reg,
                                        double* __restrict__ data, int huber) {
  const int bi = blockIdx.x;
  const double* __restrict__ pp = partials + 2 * bi * nparts;
  double ar = 0.0, ad = 0.0;
  for (int k = threadIdx.x; k < nparts; k += blockDim.x) {
    ar += pp[2 * k];
    ad += pp[2 * k + 1];
  }
  const double sr = block_sum(ar);
  __syncthreads();
  const double sd = block_sum(ad);
  if (threadIdx.x == 0) {
    reg[bi * cols + t] = huber ? 0.5 * sr : sr;
    data[bi * cols + t] = sd;
  }
}

// ---------------------------------------------------------------- units --
// The state pointers are void: float, or bfloat16 with `compact`.

template <class T>
cudaError_t pd_dual_t(const void* xm, void* p, const float* sched, int t, int iters, int huber,
                      float gamma, PdDims d, InvH ih, cudaStream_t s) {
  const dim3 grid(pd_grid(d.B, d.n()), d.B);
  pd_dual_kernel<T><<<grid, kThreads, 0, s>>>(static_cast<const T*>(xm), static_cast<T*>(p),
                                              sched, t, iters, huber, gamma, d, ih);
  return cudaGetLastError();
}

template <class T>
cudaError_t pd_primal_t(void* x, void* xm, const void* p, const float* b, const float* sched,
                        int t, int iters, int ell1, PdDims d, InvH ih, cudaStream_t s) {
  const dim3 grid(pd_grid(d.B, d.n()), d.B);
  pd_primal_kernel<T><<<grid, kThreads, 0, s>>>(static_cast<T*>(x), static_cast<T*>(xm),
                                                static_cast<const T*>(p), b, sched, t, iters,
                                                ell1, d, ih);
  return cudaGetLastError();
}

template <class T>
cudaError_t pd_record_t(const void* x, const float* b, double* partials, double* reg,
                        double* data, int t, int cols, int ell1, int huber, float gr, PdDims d,
                        InvH ih, cudaStream_t s) {
  const int gx = pd_grid(d.B, d.n());
  pd_record_kernel<T><<<dim3(gx, d.B), kThreads, 0, s>>>(static_cast<const T*>(x), b, partials,
                                                          ell1, huber, gr, d, ih);
  pd_record_reduce_kernel<<<d.B, kReduceThreads, 0, s>>>(partials, gx, t, cols, reg, data,
                                                         huber);
  return cudaGetLastError();
}

cudaError_t pd_dual(const void* xm, void* p, const float* sched, int t, int iters, int huber,
                    float gamma, int compact, PdDims d, InvH ih, cudaStream_t s) {
  return compact ? pd_dual_t<bf16>(xm, p, sched, t, iters, huber, gamma, d, ih, s)
                 : pd_dual_t<float>(xm, p, sched, t, iters, huber, gamma, d, ih, s);
}

cudaError_t pd_primal(void* x, void* xm, const void* p, const float* b, const float* sched,
                      int t, int iters, int ell1, int compact, PdDims d, InvH ih,
                      cudaStream_t s) {
  return compact ? pd_primal_t<bf16>(x, xm, p, b, sched, t, iters, ell1, d, ih, s)
                 : pd_primal_t<float>(x, xm, p, b, sched, t, iters, ell1, d, ih, s);
}

cudaError_t pd_record(const void* x, const float* b, double* partials, double* reg,
                      double* data, int t, int cols, int ell1, int huber, float gr, int compact,
                      PdDims d, InvH ih, cudaStream_t s) {
  return compact ? pd_record_t<bf16>(x, b, partials, reg, data, t, cols, ell1, huber, gr, d, ih,
                                     s)
                 : pd_record_t<float>(x, b, partials, reg, data, t, cols, ell1, huber, gr, d,
                                      ih, s);
}

}  // namespace

// ------------------------------------------------------------ C interface --
// Every function enqueues on `stream`, never synchronizes, allocates
// nothing, adds one to counts[unit] per unit it launches, and returns
// cudaGetLastError() (0 on success). `compact`: the state (x, x_mean, p) is
// bfloat16, else float.

extern "C" {

// Blocks along x of every launch over (B, n): the record partials hold
// 2 * B * nsol_pd_grid(B, n) doubles.
int nsol_pd_grid(int B, int n) { return pd_grid(B, n); }

int nsol_pd_dual(const void* xm, void* p, const float* sched, int t, int iters, int huber,
                 float gamma, int compact, int ndim, int B, int Z, int Y, int X, float ihx,
                 float ihy, float ihz, void* stream, long long* counts) {
  cudaError_t e = pd_dual(xm, p, sched, t, iters, huber, gamma, compact,
                          PdDims{ndim, B, Z, Y, X}, InvH{ihx, ihy, ihz}, (cudaStream_t)stream);
  counts[kPdDual] += 1;
  return (int)e;
}

int nsol_pd_primal(void* x, void* xm, const void* p, const float* b, const float* sched, int t,
                   int iters, int ell1, int compact, int ndim, int B, int Z, int Y, int X,
                   float ihx, float ihy, float ihz, void* stream, long long* counts) {
  cudaError_t e = pd_primal(x, xm, p, b, sched, t, iters, ell1, compact,
                            PdDims{ndim, B, Z, Y, X}, InvH{ihx, ihy, ihz},
                            (cudaStream_t)stream);
  counts[kPdPrimal] += 1;
  return (int)e;
}

int nsol_pd_record(const void* x, const float* b, double* partials, double* reg, double* data,
                   int t, int cols, int ell1, int huber, float gamma_rec, int compact, int ndim,
                   int B, int Z, int Y, int X, float ihx, float ihy, float ihz, void* stream,
                   long long* counts) {
  cudaError_t e = pd_record(x, b, partials, reg, data, t, cols, ell1, huber, gamma_rec, compact,
                            PdDims{ndim, B, Z, Y, X}, InvH{ihx, ihy, ihz},
                            (cudaStream_t)stream);
  counts[kPdRecord] += 1;
  return (int)e;
}

// The whole denoising solve (fused.py:957), enqueued on `stream`: x and
// x_mean start at x0 in every batch slot (x0 already stored as the state's
// type: round(x0) under `compact`) and p at 0; then record(0) and
// iterations x (dual, primal[, record(t+1)]). reg/data are (B, iterations+1)
// doubles, used (with partials) only when `record` is set.
int nsol_pd_solve(const float* b, const void* x0, void* x, void* xm, void* p,
                  const float* sched, double* partials, double* reg, double* data, int record,
                  float gamma_rec, int ell1, int huber, float gamma, int compact,
                  int iterations, int ndim, int B, int Z, int Y, int X, float ihx, float ihy,
                  float ihz, void* stream, long long* counts) {
  const cudaStream_t s = (cudaStream_t)stream;
  const PdDims d{ndim, B, Z, Y, X};
  const InvH ih{ihx, ihy, ihz};
  const size_t bytes = (size_t)d.n() * (compact ? sizeof(bf16) : sizeof(float));
  char* const xc = static_cast<char*>(x);
  char* const mc = static_cast<char*>(xm);
  cudaError_t e;
  for (int k = 0; k < B; ++k) {
    if ((e = cudaMemcpyAsync(xc + k * bytes, x0, bytes, cudaMemcpyDeviceToDevice, s)) !=
            cudaSuccess ||
        (e = cudaMemcpyAsync(mc + k * bytes, x0, bytes, cudaMemcpyDeviceToDevice, s)) !=
            cudaSuccess)
      return (int)e;
  }
  if ((e = cudaMemsetAsync(p, 0, bytes * B * ndim, s)) != cudaSuccess) return (int)e;

#define UNIT(idx, call)                    \
  do {                                     \
    e = (call);                            \
    counts[idx] += 1;                      \
    if (e != cudaSuccess) return (int)e;   \
  } while (0)

  const int cols = iterations + 1;
  if (record)
    UNIT(kPdRecord, pd_record(x, b, partials, reg, data, 0, cols, ell1, huber, gamma_rec,
                              compact, d, ih, s));
  for (int t = 0; t < iterations; ++t) {
    UNIT(kPdDual, pd_dual(xm, p, sched, t, iterations, huber, gamma, compact, d, ih, s));
    UNIT(kPdPrimal, pd_primal(x, xm, p, b, sched, t, iterations, ell1, compact, d, ih, s));
    if (record)
      UNIT(kPdRecord, pd_record(x, b, partials, reg, data, t + 1, cols, ell1, huber, gamma_rec,
                                compact, d, ih, s));
  }
#undef UNIT
  return 0;
}

}  // extern "C"
