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

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

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

__global__ void pd_dual_kernel(const float* __restrict__ xm, float* __restrict__ p,
                               const float* __restrict__ sched, int t, int iters, int huber,
                               float gamma, PdDims d, InvH ih) {
  const int bi = blockIdx.y;
  const int n = d.n(), plane = d.plane();
  const float s = sched_at(sched, kSigma, bi, t, iters, d.B);
  const float shrink = 1.f + s * gamma;
  const float* __restrict__ x = xm + bi * n;
  float* __restrict__ pb = p + bi * d.ndim * n;
  PD_STRIDE(i, n) {
    const int ix = i % d.X, iy = (i / d.X) % d.Y, iz = i / plane;
    const float c = x[i];
    auto update = [&](int k, float g) {
      float q = pb[k * n + i] + s * g;
      if (huber) q = q / shrink;
      pb[k * n + i] = q / fmaxf(1.f, fabsf(q));
    };
    update(0, ((ix + 1 < d.X ? x[i + 1] : 0.f) - c) * ih.x);
    update(1, ((iy + 1 < d.Y ? x[i + d.X] : 0.f) - c) * ih.y);
    if (d.ndim == 3) update(2, ((iz + 1 < d.Z ? x[i + plane] : 0.f) - c) * ih.z);
  }
}

__global__ void pd_primal_kernel(float* __restrict__ x, float* __restrict__ xm,
                                 const float* __restrict__ p, const float* __restrict__ b,
                                 const float* __restrict__ sched, int t, int iters, int ell1,
                                 PdDims d, InvH ih) {
  const int bi = blockIdx.y;
  const int n = d.n(), plane = d.plane();
  const float tau = sched_at(sched, kTau, bi, t, iters, d.B);
  const float ft = sched_at(sched, kFt, bi, t, iters, d.B);
  const float theta = sched_at(sched, kTheta, bi, t, iters, d.B);
  const float one_ft = 1.f + ft;
  float* __restrict__ xb = x + bi * n;
  float* __restrict__ mb = xm + bi * n;
  const float* __restrict__ p0 = p + bi * d.ndim * n;
  const float* __restrict__ p1 = p0 + n;
  const float* __restrict__ p2 = p1 + n;
  PD_STRIDE(i, n) {
    const int ix = i % d.X, iy = (i / d.X) % d.Y, iz = i / plane;
    float div = ((ix > 0 ? p0[i - 1] : 0.f) - p0[i]) * ih.x;
    div += ((iy > 0 ? p1[i - d.X] : 0.f) - p1[i]) * ih.y;
    if (d.ndim == 3) div += ((iz > 0 ? p2[i - plane] : 0.f) - p2[i]) * ih.z;
    const float xo = xb[i], bv = b[i];
    const float z = xo - tau * div;
    float xn;
    if (ell1) {
      const float dz = z - bv;
      const float m = fmaxf(fabsf(dz) - ft, 0.f);
      xn = bv + (dz > 0.f ? m : (dz < 0.f ? -m : 0.f));
    } else {
      xn = (z + ft * bv) / one_ft;
    }
    mb[i] = xn + theta * (xn - xo);
    xb[i] = xn;
  }
}

__global__ void pd_record_kernel(const float* __restrict__ x, const float* __restrict__ b,
                                 double* __restrict__ partials, int ell1, int huber, float gr,
                                 PdDims d, InvH ih) {
  const int bi = blockIdx.y;
  const int n = d.n(), plane = d.plane();
  const float gr2 = gr * gr;
  const float* __restrict__ xb = x + bi * n;
  double acc_r = 0.0, acc_d = 0.0;
  PD_STRIDE(i, n) {
    const int ix = i % d.X, iy = (i / d.X) % d.Y, iz = i / plane;
    const float c = xb[i];
    const float gx = ((ix + 1 < d.X ? xb[i + 1] : 0.f) - c) * ih.x;
    const float gy = ((iy + 1 < d.Y ? xb[i + d.X] : 0.f) - c) * ih.y;
    float g2 = gx * gx + gy * gy;
    if (d.ndim == 3) {
      const float gz = ((iz + 1 < d.Z ? xb[i + plane] : 0.f) - c) * ih.z;
      g2 += gz * gz;
    }
    const float r = huber ? (g2 < gr2 ? g2 : 2.f * gr * sqrtf(g2) - gr2) : sqrtf(g2);
    const float dv = c - b[i];
    acc_r += (double)r;
    acc_d += ell1 ? (double)fabsf(dv) : (double)(dv * dv);
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

cudaError_t pd_dual(const float* xm, float* p, const float* sched, int t, int iters, int huber,
                    float gamma, PdDims d, InvH ih, cudaStream_t s) {
  const dim3 grid(pd_grid(d.B, d.n()), d.B);
  pd_dual_kernel<<<grid, kThreads, 0, s>>>(xm, p, sched, t, iters, huber, gamma, d, ih);
  return cudaGetLastError();
}

cudaError_t pd_primal(float* x, float* xm, const float* p, const float* b, const float* sched,
                      int t, int iters, int ell1, PdDims d, InvH ih, cudaStream_t s) {
  const dim3 grid(pd_grid(d.B, d.n()), d.B);
  pd_primal_kernel<<<grid, kThreads, 0, s>>>(x, xm, p, b, sched, t, iters, ell1, d, ih);
  return cudaGetLastError();
}

cudaError_t pd_record(const float* x, const float* b, double* partials, double* reg,
                      double* data, int t, int cols, int ell1, int huber, float gr, PdDims d,
                      InvH ih, cudaStream_t s) {
  const int gx = pd_grid(d.B, d.n());
  pd_record_kernel<<<dim3(gx, d.B), kThreads, 0, s>>>(x, b, partials, ell1, huber, gr, d, ih);
  pd_record_reduce_kernel<<<d.B, kReduceThreads, 0, s>>>(partials, gx, t, cols, reg, data,
                                                         huber);
  return cudaGetLastError();
}

}  // namespace

// ------------------------------------------------------------ C interface --
// Every function enqueues on `stream`, never synchronizes, allocates
// nothing, adds one to counts[unit] per unit it launches, and returns
// cudaGetLastError() (0 on success).

extern "C" {

// Blocks along x of every launch over (B, n): the record partials hold
// 2 * B * nsol_pd_grid(B, n) doubles.
int nsol_pd_grid(int B, int n) { return pd_grid(B, n); }

int nsol_pd_dual(const float* xm, float* p, const float* sched, int t, int iters, int huber,
                 float gamma, int ndim, int B, int Z, int Y, int X, float ihx, float ihy,
                 float ihz, void* stream, long long* counts) {
  cudaError_t e = pd_dual(xm, p, sched, t, iters, huber, gamma, PdDims{ndim, B, Z, Y, X},
                          InvH{ihx, ihy, ihz}, (cudaStream_t)stream);
  counts[kPdDual] += 1;
  return (int)e;
}

int nsol_pd_primal(float* x, float* xm, const float* p, const float* b, const float* sched,
                   int t, int iters, int ell1, int ndim, int B, int Z, int Y, int X, float ihx,
                   float ihy, float ihz, void* stream, long long* counts) {
  cudaError_t e = pd_primal(x, xm, p, b, sched, t, iters, ell1, PdDims{ndim, B, Z, Y, X},
                            InvH{ihx, ihy, ihz}, (cudaStream_t)stream);
  counts[kPdPrimal] += 1;
  return (int)e;
}

int nsol_pd_record(const float* x, const float* b, double* partials, double* reg, double* data,
                   int t, int cols, int ell1, int huber, float gamma_rec, int ndim, int B, int Z,
                   int Y, int X, float ihx, float ihy, float ihz, void* stream,
                   long long* counts) {
  cudaError_t e = pd_record(x, b, partials, reg, data, t, cols, ell1, huber, gamma_rec,
                            PdDims{ndim, B, Z, Y, X}, InvH{ihx, ihy, ihz},
                            (cudaStream_t)stream);
  counts[kPdRecord] += 1;
  return (int)e;
}

// The whole denoising solve (fused.py:957), enqueued on `stream`: x and
// x_mean start at x0 in every batch slot and p at 0; then record(0) and
// iterations x (dual, primal[, record(t+1)]). reg/data are (B, iterations+1)
// doubles, used (with partials) only when `record` is set.
int nsol_pd_solve(const float* b, const float* x0, float* x, float* xm, float* p,
                  const float* sched, double* partials, double* reg, double* data, int record,
                  float gamma_rec, int ell1, int huber, float gamma, int iterations, int ndim,
                  int B, int Z, int Y, int X, float ihx, float ihy, float ihz, void* stream,
                  long long* counts) {
  const cudaStream_t s = (cudaStream_t)stream;
  const PdDims d{ndim, B, Z, Y, X};
  const InvH ih{ihx, ihy, ihz};
  const size_t bytes = (size_t)d.n() * sizeof(float);
  cudaError_t e;
  for (int k = 0; k < B; ++k) {
    if ((e = cudaMemcpyAsync(x + (size_t)k * d.n(), x0, bytes, cudaMemcpyDeviceToDevice, s)) !=
            cudaSuccess ||
        (e = cudaMemcpyAsync(xm + (size_t)k * d.n(), x0, bytes, cudaMemcpyDeviceToDevice, s)) !=
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
    UNIT(kPdRecord, pd_record(x, b, partials, reg, data, 0, cols, ell1, huber, gamma_rec, d, ih, s));
  for (int t = 0; t < iterations; ++t) {
    UNIT(kPdDual, pd_dual(xm, p, sched, t, iterations, huber, gamma, d, ih, s));
    UNIT(kPdPrimal, pd_primal(x, xm, p, b, sched, t, iterations, ell1, d, ih, s));
    if (record)
      UNIT(kPdRecord,
           pd_record(x, b, partials, reg, data, t + 1, cols, ell1, huber, gamma_rec, d, ih, s));
  }
#undef UNIT
  return 0;
}

}  // extern "C"
