// Hopper (sm_90a) one-launch primal-dual (Chambolle-Pock) denoise: the
// whole solve of pd.cu's nsol_pd_solve (4 types, 3 schedules, 2-D and
// 3-D, anisotropic spacing, float or the bfloat16 `compact` state, any
// batch of alphas, the Reg/Data records on or off) as one persistent
// cooperative kernel.
//
// Counterpart of the TPU Pallas kernel
//   nsol_tpu/ops/pallas/fused.py::make_fused_pd_denoise_solver  (:957)
// which runs every iteration inside one VMEM-resident program because "the
// XLA PD path is launch-overhead-bound at denoising sizes" (its docstring,
// fused.py:966-972). Here one cooperative launch runs the solve,
// computing x, x_mean, p and the records bit for bit as the launch
// sequence does.
//
// What bounds it on the H100. The launch sequence it replaces enqueues 2 B
// copies and a memset, then pd_dual and pd_primal for each iteration and,
// with records, pd_record's march and its reduce 51 times over: ~100-250
// launches a 50-iteration solve. On a 256^2 image (256 KiB) or the 64^3
// phantom each is a few microseconds of work, and the sequence spent its
// time in launch ramps, grid drains and host gaps (a Lena solve at 40 %
// device busy, PERF.md). The state sits in the 50 MB L2, so its bytes set
// no floor: barriers, L2 traffic and the passes' latency bound it.
//
// Design. persistent.cuh's machinery, as the other persistent solves run
// it: each of the sequence's units a phase between grid barriers, every
// phase walking the sequence's blocks (pd_grid(B, n) x B for the dual and
// the primal step, the record march's RecGrid x B, which pd.cu sizes and
// this entry reads from it) through the sequence's device code
// (pd_units.cuh, plain loads), up to kPdMaxTeams of them side by side in
// a CUDA block (GroupTeam); so every float64 partial of the records is
// the sequence's, summed in its order, and the one-block-per-image reduce
// runs in blocks 0..B-1 with pd_record_reduce_kernel's tree
// (pd_reduce_body). Phases merge where neither reads what the other
// writes, which takes the barriers a solve from the sequence's launches
// down to 2 an iteration:
//   - the entry: the first dual step reads x_mean from x0 and p as the 0
//     the memset leaves, the first primal step x from x0, the first record
//     x0 (no copies, no memset; a solve of 0 iterations writes them);
//   - record row t (of x_t) runs beside dual step t, which reads x_mean
//     and p and writes p; its reduce runs in primal step t, whose blocks
//     0..B-1 form it first; row `iterations` has a phase and a barrier of
//     its own.
// The barriers: 2 iterations - 1 without records, 2 iterations + 1 with
// (fused.py's pd_persistent_barriers). The state type's roundings are
// pd_units.cuh's _rn intrinsics in the reference's order, as the
// sequence's.
//
// Coherence: every load is a plain one (persistent.cuh; pd_units.cuh's
// bodies through plain pointers, the record's kNc false), even of b, x0
// and the schedules, which nothing writes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "pd_units.cuh"
#include "persistent.cuh"

extern "C" int nsol_pd_record_grid(int ndim, int compact, int B, int Z, int Y, int X, int* out);

namespace {

// pd.cu's PdUnit slots continue here: the one launch of a solve
// (ops/cuda/fused.py's PD_PERSISTENT_SLOT).
constexpr int kPdPersistent = 3;
// The most of the sequence's blocks a CUDA block runs side by side: the
// record march's registers (its rows of x in flight) cap the block at 512
// threads.
constexpr int kPdMaxTeams = 2;

struct PdArgs {
  const float* b;
  const void* x0;  // one image, of the state's type
  void* x;         // B images each, of the state's type
  void* xm;
  void* p;  // B x ndim images
  const float* sched;
  double* partials;  // 2 B rg.blocks: one record row's
  double* reg;       // (B, iterations + 1), or null
  double* data;
  float gamma_rec, gamma;
  int ell1, huber, iterations, wide;  // wide: the record's 16-byte loads
  PdDims d;
  InvH ih;
  FastIndex idx;
  int gx;       // the sequence's blocks an image of pd_dual and pd_primal
  RecGrid rg;   // pd_record's march
  long long* stamps;  // (time, Phase) pairs of a traced solve, or null
  int stamp_cap;
};

// kRec: 0 without records, else the image's dimensions (the record
// march's instance).
template <class T, int kRec>
struct PdPersistent {
  const PdArgs& a;
  Phases ph;
  int first = 0, stride = 0;  // this team's first of the sequence's blocks, the teams

  __device__ T* vol(void* v) const { return static_cast<T*>(v); }
  __device__ const T* x0() const { return static_cast<const T*>(a.x0); }

  // pd_dual at t over the sequence's gx x B blocks; at t = 0 x_mean is x0
  // and p the memset's 0.
  __device__ void dual(int t) {
    const int n = a.d.n(), nb = a.gx * a.d.B;
    for (int vb = first; vb < nb; vb += stride) {
      const int bi = vb / a.gx, bx = vb - bi * a.gx;
      const float s = sched_at(a.sched, kSigma, bi, t, a.iterations, a.d.B);
      const float shrink = __fadd_rn(1.f, __fmul_rn(s, a.gamma));
      const T* src = t == 0 ? x0() : vol(a.xm) + bi * n;
      T* pb = vol(a.p) + bi * a.d.ndim * n;
      for (int i = bx * kThreads + GroupTeam::tid(); i < n; i += a.gx * kThreads) {
        const Coord c = a.idx.at(i);
        pd_dual_voxel<T>(src, pb, t == 0, i, c.x, c.y, c.z, s, shrink, a.huber, a.d,
                                a.ih);
      }
    }
  }

  // pd_primal at t over the same blocks; at t = 0 x is x0.
  __device__ void primal(int t) {
    const int n = a.d.n(), nb = a.gx * a.d.B;
    for (int vb = first; vb < nb; vb += stride) {
      const int bi = vb / a.gx, bx = vb - bi * a.gx;
      const float tau = sched_at(a.sched, kTau, bi, t, a.iterations, a.d.B);
      const float ft = sched_at(a.sched, kFt, bi, t, a.iterations, a.d.B);
      const float theta = sched_at(a.sched, kTheta, bi, t, a.iterations, a.d.B);
      const float one_ft = __fadd_rn(1.f, ft);
      T* xb = vol(a.x) + bi * n;
      T* mb = vol(a.xm) + bi * n;
      const T* p0 = vol(a.p) + bi * a.d.ndim * n;
      const T* x_old = t == 0 ? x0() : xb;
      for (int i = bx * kThreads + GroupTeam::tid(); i < n; i += a.gx * kThreads) {
        const Coord c = a.idx.at(i);
        pd_primal_voxel<T>(x_old, xb, mb, p0, p0 + n, p0 + 2 * n, a.b, i, c.x, c.y, c.z,
                                  tau, ft, one_ft, theta, a.ell1, a.d, a.ih);
      }
    }
  }

  // Record row t's partials over the march's rg.blocks x B blocks (of x0
  // at t = 0).
  template <bool kWide>
  __device__ void record_blocks(int t) {
    if constexpr (kRec != 0) {
      const int n = a.d.n(), nb = a.rg.blocks * a.d.B;
      for (int vb = first; vb < nb; vb += stride) {
        const int bi = vb / a.rg.blocks, bx = vb - bi * a.rg.blocks;
        const T* xb = t == 0 ? x0() : vol(a.x) + bi * n;
        pd_record_block<T, kRec, kWide, false, GroupTeam>(xb, a.b, a.partials, a.ell1, a.huber,
                                                          a.gamma_rec, a.rg, a.d, a.ih, bx, bi);
        GroupTeam::sync();  // the team's sums before its next block's
      }
    }
  }

  __device__ void record(int t) {
    if (a.wide)
      record_blocks<true>(t);
    else
      record_blocks<false>(t);
  }

  // Row t's second stage, image bi in CUDA block bi (and bi + grid, ...).
  __device__ void reduce(int t) {
    for (int bi = blockIdx.x; bi < a.d.B; bi += gridDim.x)
      pd_reduce_body(a.partials, a.rg.blocks, t, a.iterations + 1, a.reg, a.data, a.huber, bi);
  }

  // A solve of no iteration: the sequence's copies and memset, and row 0.
  __device__ void entry_only() {
    const long long n = a.d.n(), all = n * a.d.B;
    const long long t0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const long long step = (long long)gridDim.x * blockDim.x;
    for (long long k = t0; k < all; k += step) {
      vol(a.x)[k] = x0()[k % n];
      vol(a.xm)[k] = x0()[k % n];
    }
    for (long long k = t0; k < all * a.d.ndim; k += step) st(vol(a.p), (int)k, 0.f);
    if (kRec != 0) {
      record(0);
      ph.sync(kRecordRow);
      reduce(0);
    }
  }

  __device__ void run() {
    const int teams = blockDim.x / kThreads;
    first = (int)blockIdx.x * teams + GroupTeam::team();
    stride = (int)gridDim.x * teams;
    ph.stamp(kStart);
    const int its = a.iterations;
    if (its == 0) entry_only();
    for (int t = 0; t < its; ++t) {
      if (kRec != 0) record(t);
      dual(t);
      ph.sync(kDual);
      if (kRec != 0) reduce(t);
      primal(t);
      if (kRec != 0 || t + 1 < its) ph.sync(kPrimal);
    }
    if (kRec != 0 && its > 0) {
      record(its);
      ph.sync(kRecordRow);
      reduce(its);
    }
    ph.stamp(kEnd);
  }
};

// Two blocks an SM (64 registers a thread) but with a volume's records,
// whose march holds its rows of x in 126 registers and spills at 64: the
// occupancy the solves' device times liked best (two blocks made Lena x 8
// with records 29 % faster; one kept the 64^3 solve with records ahead;
// three or four without records slowed 64^3; PERF.md,
// tests/torch_pd_occupancy_probe.py).
template <class T, int kRec>
__global__ void __launch_bounds__(kThreads * kPdMaxTeams, kRec == 3 ? 1 : 2)
    pd_persistent_kernel(const __grid_constant__ PdArgs a) {
  PdPersistent<T, kRec>{a, Phases{cg::this_grid(), a.stamps, a.stamp_cap}}.run();
}

// The instance for the state (compact: bfloat16) and the records (rec: 0,
// or the image's dimensions).
const void* kernel_of(int compact, int rec) {
  if (compact)
    return rec == 3   ? (const void*)pd_persistent_kernel<bf16, 3>
           : rec == 2 ? (const void*)pd_persistent_kernel<bf16, 2>
                      : (const void*)pd_persistent_kernel<bf16, 0>;
  return rec == 3   ? (const void*)pd_persistent_kernel<float, 3>
         : rec == 2 ? (const void*)pd_persistent_kernel<float, 2>
                    : (const void*)pd_persistent_kernel<float, 0>;
}

// The launch's arguments for a batch of (ndim, B, Z, Y, X) and its grids;
// the record's RecGrid only with records.
cudaError_t grids_of(int ndim, int compact, int record, int B, int Z, int Y, int X, int* gx,
                     RecGrid* rg) {
  *gx = pd_grid(B, Z * Y * X);
  *rg = RecGrid{0, 0, 0, 0, 0, 0, 0};
  if (!record) return cudaSuccess;
  int g[7];
  const int e = nsol_pd_record_grid(ndim, compact, B, Z, Y, X, g);
  *rg = RecGrid{g[0], g[1], g[2], g[3], g[4], g[5], g[6]};
  return (cudaError_t)e;
}

// The launch shape over the larger of a phase's walks (the dual and primal
// steps' gx B blocks, the record's rg.blocks B).
cudaError_t pd_shape(int compact, int record, int ndim, int B, int gx, const RecGrid& rg,
                     Shape* sh) {
  const long long work = (long long)B * (gx > rg.blocks ? gx : rg.blocks);
  return shape_of(kernel_of(compact, record ? ndim : 0), work, sh, kPdMaxTeams);
}

// The dimensions the kernel takes: 2-D with Z = 1, or 3-D; 32-bit indices
// over the batch's dual volumes, as the sequence's.
bool valid(int ndim, int B, int Z, int Y, int X) {
  return (ndim == 2 || ndim == 3) && (ndim == 3 || Z == 1) && B >= 1 && Z >= 1 && Y >= 1 &&
         X >= 1 && (long long)B * ndim * Z * Y * X < (1LL << 31);
}

}  // namespace

extern "C" {

// Whether the denoising solve of a batch of B images of (Z, Y, X) voxels
// (ndim 2 with Z = 1, or 3), its state float (compact 0) or bfloat16,
// runs as this kernel's one launch rather than as nsol_pd_solve's launch
// sequence (the rule; ops/cuda/fused.py reads it, no copy of it lives in
// Python): at most kPersistentMaxVoxels an image, and the batch's state —
// x, x_mean and the ndim dual volumes at the state's width, and b — within
// kSideBySideBytes, so that it stays in the 50 MB L2 (Lena 256^2 x 1 or x
// 8, the 64^3 phantom; not Man 1024^2 x 64 or 256^3, whose units move
// their bytes at half their bound or better, PERF.md). A shape decision,
// never a fallback.
int nsol_pd_persistent_route(int ndim, int compact, int B, int Z, int Y, int X) {
  if (!valid(ndim, B, Z, Y, X)) return 0;
  const long long n = (long long)Z * Y * X;
  const long long state = n * ((long long)B * (2 + ndim) * (compact ? 2 : 4) + 4);
  return n <= kPersistentMaxVoxels && state <= kSideBySideBytes;
}

// The launch shape of the solve of a batch of (ndim, B, Z, Y, X), state
// float or bfloat16 (compact), with records or not: out[0] the blocks an
// SM holds, out[1] the grid, out[2] the sequence's blocks of a dual or
// primal phase (pd_grid x B), out[3] the threads a block, out[4] the
// record march's blocks (x B; 0 without records).
int nsol_pd_persistent_shape(int ndim, int compact, int record, int B, int Z, int Y, int X,
                             int* out) {
  if (!valid(ndim, B, Z, Y, X)) return (int)cudaErrorInvalidValue;
  int gx = 0;
  RecGrid rg;
  Shape sh{0, 0, 0, 0};
  cudaError_t e = grids_of(ndim, compact, record, B, Z, Y, X, &gx, &rg);
  if (e == cudaSuccess) e = pd_shape(compact, record, ndim, B, gx, rg, &sh);
  out[0] = sh.per_sm;
  out[1] = sh.grid;
  out[2] = gx * B;
  out[3] = sh.threads;
  out[4] = rg.blocks * B;
  return (int)e;
}

// nsol_pd_solve's solve, its arguments and its x, x_mean, p and records
// bit for bit, as one cooperative launch on `stream`: x0 one image of the
// state's type (round(x0) under compact); partials 2 B blocks
// (nsol_pd_record_grid's out[6]) doubles, reg and data (B, iterations + 1),
// used only with `record`. A launch the card refuses
// (cudaErrorCooperativeLaunchTooLarge, ...) returns its error and runs
// nothing. counts[kPdPersistent] += 1 where the kernel was launched.
int nsol_pd_solve_persistent(const float* b, const void* x0, void* x, void* xm, void* p,
                             const float* sched, double* partials, double* reg, double* data,
                             int record, float gamma_rec, int ell1, int huber, float gamma,
                             int compact, int iterations, int ndim, int B, int Z, int Y, int X,
                             float ihx, float ihy, float ihz, void* stream, long long* counts) {
  if (!valid(ndim, B, Z, Y, X) || iterations < 0 ||
      (record && (partials == nullptr || reg == nullptr || data == nullptr)))
    return (int)cudaErrorInvalidValue;
  int gx = 0;
  RecGrid rg;
  cudaError_t e = grids_of(ndim, compact, record, B, Z, Y, X, &gx, &rg);
  if (e != cudaSuccess) return (int)e;
  Shape sh;
  if ((e = pd_shape(compact, record, ndim, B, gx, rg, &sh)) != cudaSuccess) return (int)e;
  const size_t w = compact ? 8 : 4;  // values of a 16-byte load
  const bool wide = X % w == 0 && ((size_t)x & 15) == 0 && ((size_t)x0 & 15) == 0 &&
                    ((size_t)b & 15) == 0;
  PdArgs a{b,
           x0,
           x,
           xm,
           p,
           sched,
           partials,
           reg,
           data,
           gamma_rec,
           gamma,
           ell1,
           huber,
           iterations,
           (int)wide,
           PdDims{ndim, B, Z, Y, X},
           InvH{ihx, ihy, ihz},
           FastIndex{FastDiv::of(X), FastDiv::of(Y)},
           gx,
           rg,
           g_persistent_stamps,
           g_persistent_stamp_cap};
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel(kernel_of(compact, record ? ndim : 0), dim3(sh.grid),
                                  dim3(sh.threads), args, 0, (cudaStream_t)stream);
  if (e == cudaSuccess) counts[kPdPersistent] += 1;
  return (int)e;
}

}  // extern "C"
