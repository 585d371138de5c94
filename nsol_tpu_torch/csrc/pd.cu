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
//              bit for bit. A register march (the note at
//              pd_record_kernel): no voxel divides, 16-byte loads.
//
// The primal step needs the new p at the lower neighbours, a grid-wide
// dependency, so each iteration is two passes (the TPU kernel holds the whole
// state in VMEM; one SM's shared memory cannot hold even a 1024^2 image).
// What bounds the units is memory traffic at a few flops per byte: at Man
// 1024^2 x 64 alphas one iteration moves ~11-12 volumes x 4 MiB x 64 ~ 3 GiB
// (~0.9 ms at the 3.35 TB/s peak); at 256^3 ~14 volumes x 64 MiB. A small
// image (Lena 256^2, 256 KiB) is bound by its ~100-150 launches per solve:
// where csrc/pd_persistent.cu's rule (nsol_pd_persistent_route) takes the
// batch, the solve runs instead as its one cooperative launch, the units'
// device code (csrc/pd_units.cuh, shared with these kernels) as phases
// between grid barriers; nsol_pd_solve is its bit reference.
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
#include "pd_units.cuh"

namespace {

// Kernel units, the indices of the launch counts handed back to Python;
// pd_persistent.cu's one-launch solve counts in kPdPersistent.
enum PdUnit { kPdDual = 0, kPdPrimal = 1, kPdRecord = 2, kPdPersistent = 3 };

#define PD_STRIDE(i, n) \
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < (n); i += gridDim.x * blockDim.x)

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
    pd_dual_voxel<T>(x, pb, false, i, i % d.X, (i / d.X) % d.Y, i / plane, s, shrink,
                           huber, d, ih);
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
  PD_STRIDE(i, n) {
    pd_primal_voxel<T>(xb, xb, mb, p0, p0 + n, p0 + 2 * n, b, i, i % d.X, (i / d.X) % d.Y,
                       i / plane, tau, ft, one_ft, theta, ell1, d, ih);
  }
}

// pd_record's blocks (pd_units.cuh's pd_record_block), a CUDA block each.
struct PdBlock {
  __device__ static int tid() { return threadIdx.x; }
  __device__ static double sum(double v) { return block_sum(v); }
  __device__ static void sync() { __syncthreads(); }
};

template <class T, int kND, bool kWide>
__global__ void __launch_bounds__(kRecThreads)
    pd_record_kernel(const T* __restrict__ x, const float* __restrict__ b,
                     double* __restrict__ partials, int ell1, int huber, float gr, RecGrid g,
                     PdDims d, InvH ih) {
  const int bi = blockIdx.y;
  pd_record_block<T, kND, kWide, true, PdBlock>(x + bi * (long long)d.n(), b, partials, ell1,
                                                huber, gr, g, d, ih, blockIdx.x, bi);
}

// Second stage: block bi sums image bi's partials in a fixed order.
__global__ void pd_record_reduce_kernel(const double* __restrict__ partials, int nparts, int t,
                                        int cols, double* __restrict__ reg,
                                        double* __restrict__ data, int huber) {
  pd_reduce_body(partials, nparts, t, cols, reg, data, huber, blockIdx.x);
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

// The blocks of the record march an SM holds at once (the fewer of its
// two instances'), read once.
template <class T, int kND>
int rec_resident() {
  static int resident = 0;
  if (resident <= 0) {
    int a = 0, b = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&a, pd_record_kernel<T, kND, true>,
                                                  kRecThreads, 0);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, pd_record_kernel<T, kND, false>,
                                                  kRecThreads, 0);
    resident = a < b ? a : b;
  }
  return resident > 0 ? resident : 1;
}

// The record march's grid over one image: the most chunks along the walked
// axis whose blocks, over the batch, the card holds at once (one wave: a
// second, partial one would double the time), at least one.
template <class T, int kND>
RecGrid rec_grid(PdDims d) {
  constexpr int W = 16 / sizeof(T);
  constexpr int R = rec_rows<T, kND>();
  RecGrid g;
  g.ngx = (d.X + kRecLanes * W - 1) / (kRecLanes * W);
  g.nstrips = kND == 3 ? (d.Y + R - 1) / R : 1;
  g.S = kND == 3 ? d.Z : d.Y;
  const long long units = (long long)g.ngx * g.nstrips;  // warps a chunk, an image
  const long long slots = (long long)device_sms() * rec_resident<T, kND>();
  int nch = 1;
  while (nch < g.S &&
         (long long)d.B * ((units * (nch + 1) + kRecWarps - 1) / kRecWarps) <= slots)
    ++nch;
  g.chunk = (g.S + nch - 1) / nch;
  g.nchunks = (g.S + g.chunk - 1) / g.chunk;
  g.warps = g.ngx * g.nstrips * g.nchunks;
  g.blocks = (g.warps + kRecWarps - 1) / kRecWarps;
  return g;
}

RecGrid record_grid(int compact, PdDims d) {
  if (compact) return d.ndim == 3 ? rec_grid<bf16, 3>(d) : rec_grid<bf16, 2>(d);
  return d.ndim == 3 ? rec_grid<float, 3>(d) : rec_grid<float, 2>(d);
}

template <class T, int kND>
void launch_record(const T* x, const float* b, double* partials, int ell1, int huber, float gr,
                   RecGrid g, PdDims d, InvH ih, cudaStream_t s) {
  // 16-byte rows: X a multiple of W and every image's base aligned
  const bool wide = d.X % (16 / sizeof(T)) == 0 && ((size_t)x & 15) == 0 &&
                    ((size_t)b & 15) == 0;
  const dim3 grid(g.blocks, d.B);
  if (wide)
    pd_record_kernel<T, kND, true>
        <<<grid, kRecThreads, 0, s>>>(x, b, partials, ell1, huber, gr, g, d, ih);
  else
    pd_record_kernel<T, kND, false>
        <<<grid, kRecThreads, 0, s>>>(x, b, partials, ell1, huber, gr, g, d, ih);
}

template <class T>
cudaError_t pd_record_t(const void* x, const float* b, double* partials, double* reg,
                        double* data, int t, int cols, int ell1, int huber, float gr, PdDims d,
                        InvH ih, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const RecGrid g = d.ndim == 3 ? rec_grid<T, 3>(d) : rec_grid<T, 2>(d);
  if (d.ndim == 3)
    launch_record<T, 3>(xt, b, partials, ell1, huber, gr, g, d, ih, s);
  else
    launch_record<T, 2>(xt, b, partials, ell1, huber, gr, g, d, ih, s);
  pd_record_reduce_kernel<<<d.B, kReduceThreads, 0, s>>>(partials, g.blocks, t, cols, reg, data,
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

// pd_record's march over a batch of (ndim, B, Z, Y, X), the state float
// (compact 0) or bfloat16: out[0..6] its RecGrid (column strips, row
// strips, chunks, steps a chunk, walked length, warps and blocks an
// image), which pd_persistent.cu's one-launch solve walks; the record
// partials hold 2 * B * out[6] doubles.
int nsol_pd_record_grid(int ndim, int compact, int B, int Z, int Y, int X, int* out) {
  const RecGrid g = record_grid(compact, PdDims{ndim, B, Z, Y, X});
  const int v[7] = {g.ngx, g.nstrips, g.nchunks, g.chunk, g.S, g.warps, g.blocks};
  for (int k = 0; k < 7; ++k) out[k] = v[k];
  return 0;
}

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
