// Hopper (sm_90a) one-launch robust IRLS solves: robust.cu's
// nsol_robust_admm_solve (storage "exact" and "dirs", records on or off)
// and the robust losses of tikhonov.cu's nsol_tikhonov_solve (a whole
// alpha batch, exact or compact), each as one persistent cooperative
// kernel that runs every IRLS sweep of the solve.
//
// Counterparts of the TPU Pallas kernels
//   nsol_tpu/ops/pallas/fused.py::make_fused_admm_solver      (:382, robust
//   branch :583-643; record=True; compact_dirs)
//   nsol_tpu/ops/pallas/fused.py::make_fused_tikhonov_solver  (:716, robust
//   losses :825-855; compact_dirs)
// which hold one solve in VMEM, jax.vmap batching the Tikhonov solve over
// the alphas. Here one cooperative launch runs the solve or the batch,
// computing every configuration's x (and the records) bit for bit as the
// launch sequence does.
//
// What bounds it on the H100. The launch sequence it replaces enqueues
// about 60 short launches a sweep (irls_head's chain, the gradient's chain
// and its reduce, the memset of xk, cg_iters x (the weighted apply's six
// passes and its reduce, cg_update and its reduce), irls_step): on a 256^2
// image or a 64^3 volume each is a few microseconds of work, and the
// sequence spent its time in launch ramps, grid drains and host gaps (a
// Lena robust solve, ~1800 launches, at 44 % device busy, PERF.md). The
// solves' bytes and operations bound them well under a millisecond, their
// volumes sitting in the 50 MB L2. Here the phases are separated by grid
// barriers (1440 a Lena 10 x 3 x 6 solve): barriers, L2 traffic and the
// passes' latency bound it, 1.5-2.4 us a phase on Lena (chip_smoke.py
// phase 47).
//
// Design. persistent.cuh's machinery, as admm_persistent.cu and
// tikhonov_persistent.cu run it: each unit of the sweep a phase between
// grid barriers, every phase walking the sequence's blocks through the
// sequence's pass bodies (stencil.cuh, robust_units.cuh; the records'
// admm_units.cuh), so that every partial sum is the sequence's, in its
// order; every block forms the one-block reduces itself, into its own CG
// scalars. Folded steps: the memset of xk runs beside irls_head's x pass;
// irls_step runs on each thread's own voxels of the last cg_update, which
// no barrier separates from it, and that cg_update's reduce, which nothing
// reads, is not formed. A Tikhonov batch runs its configurations side by
// side on disjoint groups of blocks in equal turns (persistent.cuh's
// batch_width over a slot's ten volumes: x, wts, free, rk, p0, p1, q, xk,
// t1, t2), the entry clip the source of its first sweep's first pass; the
// ADMM solve is a batch of one with admm_record's rows (record_row).
//
// Coherence: every load is a plain one (persistent.cuh; the epilogues'
// kNc false), even of b, x0, the alphas and the taps, which nothing writes.

#include <cuda_runtime.h>

#include "losses.cuh"
#include "persistent.cuh"
#include "robust_units.cuh"

namespace {

// robust.cu's Unit slots continue here: the one launch of a solve or a
// batch (ops/cuda/robust.py's PERSISTENT_SLOT).
constexpr int kIrlsPersistent = 11;

// Compile-time lengths of the blur's taps (kB an axis, kBz along z; 0 at
// run time): persistent.cuh's TapLens of a solve with one chain.
template <int kB, int kBz>
struct BlurLens {
  static constexpr int bx = kB, by = kB, bz = kBz;
  // the floats the taps take in shared memory (1 at run time)
  static constexpr int shared = kB > 0 ? 2 * kB + kBz : 1;
};

// f(BlurLens<...>{}) for the blur taps' lengths: the main paths' sigma = 1
// blur on a volume or a 2-D image unrolled, else at run time.
template <class F>
cudaError_t with_blur_lens(const Taps& ta, F&& f) {
  if (ta.ky == 7 && ta.kx == 7 && ta.kz == 7) return f(BlurLens<7, 7>{});
  if (ta.ky == 7 && ta.kx == 7 && ta.kz == 1) return f(BlurLens<7, 1>{});
  return f(BlurLens<0, 0>{});
}

// f(RobustT<...>{}) for the storage modes the persistent sweep runs:
// "exact" and "dirs" (stencil.cuh's with_robust_storage, two instances).
template <class F>
cudaError_t with_irls_storage(int storage, F&& f) {
  if (storage == kRobustExact) return f(RobustT<float, false>{});
  if (storage == kRobustDirs) return f(RobustT<bf16, false>{});
  return cudaErrorInvalidValue;
}

struct IrlsArgs {
  const float* b;
  const float* x0;  // a batch's x0, clipped on entry; null: x holds x0
  float* x;         // nconf volumes
  float* wts;       // wts, free, rk, p0, p1, q, xk, t1, t2: a volume a slot
  float* free;
  float* rk;
  void* p[2];  // the directions, in the storage's type
  float* q;
  float* xk;
  float* t1;
  float* t2;
  double* partials;     // two sets of kMaxBlocks a slot
  const float* alphas;  // configuration c's rho and C: alphas[c] and
  const float* scales;  // scales[c] (a batch), or rho and scale (null)
  float rho, scale;
  double* reg;  // the records (the ADMM solve), or null
  double* data;
  double* rec_partials;  // 2 * kMaxBlocks: the data, then the TV partials
  float rec_fs2;
  Taps ta;
  Spacing sp;
  int nconf, width, iterations, iter_max, cg_iters, loss;
  Dims d;
  FastIndex idx;
  int G;              // the launch sequence's blocks, grid_for(n)
  long long* stamps;  // (time, Phase) pairs of a traced solve, or null
  int stamp_cap;
};

// The memset of xk beside irls_head's x pass (chain's Beside), each thread
// on the voxels its cg_update writes.
struct ZeroBeside {
  float* xk;
  long long n;
  int G;
  __device__ void operator()(int vb) const {
    BLOCK_STRIDE(i, n, vb, G, GroupTeam::tid()) { xk[i] = 0.f; }
  }
};

template <class S, int kReg, class L>
struct IrlsPersistent {
  using P = typename S::P;
  using Vol = LoadT<float, float, false>;
  // a slot's scratch
  struct Slot {
    float* wts;
    float* free;
    float* rk;
    P* p[2];
    float* q;
    float* xk;
    float* t1;
    float* t2;
  };
  const IrlsArgs& a;
  Phases ph;
  double* sc;   // this block's configuration's CG scalars (shared memory)
  float* tsh;   // room for the taps in shared memory (fixed lengths)
  Taps ta;      // the blur taps, where the passes read them
  int set = 0;  // the partials set the next reduced pass writes (CgSums')

  // The one-block second stage of the pass that wrote sums.parts(),
  // formed by every block of the configuration's group, then the next set.
  __device__ void reduce(CgSums& sums, int mode) {
    sums.reduce(a.G, mode);
    ph.stamp(kReduce);
  }

  // One IRLS sweep (robust.cu's irls_sweep) of x at rho and C^2 = fs2
  // through slot v, its blocks walking wk; with clip, x = max(x0, 0) is
  // irls_head's source and stored beside its x pass (the entry clip).
  __device__ void sweep(const Walk& wk, const Slot& v, CgSums& sums, float* x, float rho,
                        float fs2, bool clip) {
    const long long n = a.d.n();
    // irls_head: r = A x - b, wts = rho'_C(r^2), y = wts r into q; xk = 0
    const WeightsEpiT<false> head{a.b, v.wts, v.q, fs2, a.loss};
    const ZeroBeside zero{v.xk, n, a.G};
    if (clip)
      chain<L::bx, L::by, L::bz>(wk, ph, kHeadX, ClipSrc{a.x0}, x, head, nullptr, ta, v.t1, v.t2,
                                 zero);
    else
      chain<L::bx, L::by, L::bz>(wk, ph, kHeadX, Vol{x}, nullptr, head, nullptr, ta, v.t1, v.t2,
                                 zero);
    // the gradient: g = A y + rho B^T B x, free, rk = -free g, |rk|^2
    chain<L::bx, L::by, L::bz>(wk, ph, kGradX, Vol{v.q}, nullptr,
                               BlurEpi<kReg, false>{x, nullptr, v.free, v.rk, rho, a.sp},
                               sums.parts(), ta, v.t1, v.t2);
    reduce(sums, kReduceRR0);
    int pc = 1;  // p' into p[pc], p from p[1 - pc]
    for (int k = 0; k < a.cg_iters; ++k) {
      // the weighted apply: s = wts A (free p') into t1; q, p'.q
      const DirectionT<true, float, P, false> dir{
          v.rk, v.p[1 - pc], v.free, nullptr, k == 0, k == 0 ? 0.f : (float)sc[kBeta]};
      chain<L::bx, L::by, L::bz>(wk, ph, kWeightX, dir, v.p[pc],
                                 ScaleEpi<float, float, false>{v.wts, v.t1}, nullptr, ta, v.t1,
                                 v.t2);
      chain<L::bx, L::by, L::bz>(wk, ph, kMaskX, Vol{v.t1}, nullptr,
                                 MaskedEpi<kReg, P, false, false>{v.p[pc], v.free, v.q, rho, a.sp},
                                 sums.parts(), ta, v.t2, v.t1);
      reduce(sums, kReducePQ);
      const float am = (float)sc[kA];
      const bool last = k + 1 == a.cg_iters;
      for (int vb = wk.first; vb < a.G; vb += wk.stride) {
        cg_update_body<GroupTeam>(am, v.xk, v.rk, v.p[pc], v.q, sums.parts(), n, 1, vb, a.G);
        GroupTeam::sync();
        // irls_step on the voxels this thread's cg_update wrote
        if (last) BLOCK_STRIDE(i, n, vb, a.G, GroupTeam::tid()) { irls_step_voxel(x, v.xk, i); }
      }
      if (last) {
        ph.sync(kStep);
      } else {
        ph.sync(kUpdate);
        reduce(sums, kReduceRR);
      }
      pc = 1 - pc;
    }
    if (a.cg_iters == 0) {
      for (int vb = wk.first; vb < a.G; vb += wk.stride)
        BLOCK_STRIDE(i, n, vb, a.G, GroupTeam::tid()) { irls_step_voxel(x, v.xk, i); }
      ph.sync(kStep);
    }
  }

  // Configuration c on slot j, its blocks walking wk: the records of x0
  // and of every outer iterate (where asked), iterations x iter_max
  // sweeps.
  __device__ void solve(const Walk& wk, int j, int c) {
    const long long n = a.d.n(), o = j * n;
    float* x = a.x + c * n;
    const Slot v{a.wts + o,
                 a.free + o,
                 a.rk + o,
                 {static_cast<P*>(a.p[0]) + o, static_cast<P*>(a.p[1]) + o},
                 a.q + o,
                 a.xk + o,
                 a.t1 + o,
                 a.t2 + o};
    // slot j's partials and this block's scalars, their sets alternating
    // in step with every other configuration's
    CgSums sums{a.partials + 2LL * j * kMaxBlocks, sc, set};
    const float rho = a.alphas != nullptr ? a.alphas[c] : a.rho;
    const float scale = a.scales != nullptr ? a.scales[c] : a.scale;
    const float fs2 = __fmul_rn(scale, scale);
    bool clip = a.x0 != nullptr;
    if (a.reg != nullptr) record(wk, v, x, 0);
    for (int it = 0; it < a.iterations; ++it) {
      for (int s = 0; s < a.iter_max; ++s) {
        sweep(wk, v, sums, x, rho, fs2, clip);
        clip = false;
      }
      if (a.reg != nullptr) record(wk, v, x, it + 1);
    }
    if (clip)  // no sweep ran: the entry clip alone
      for (int vb = wk.first; vb < a.G; vb += wk.stride)
        BLOCK_STRIDE(i, n, vb, a.G, GroupTeam::tid()) { x[i] = clip0(a.x0[i]); }
    set = sums.set;
  }

  __device__ void record(const Walk& wk, const Slot& v, const float* x, int t) {
    record_row<L::bx, L::by, L::bz>(wk, ph, x, a.b, a.rec_fs2, a.loss, a.rec_partials, a.reg,
                                    a.data, t, ta, v.t1, v.t2, a.sp);
  }

  __device__ void run() {
    ta = a.ta;
    if (L::bx > 0) {  // the taps at fixed lengths into shared memory
      constexpr int na = L::bz + L::by + L::bx;
      for (int k = threadIdx.x; k < na; k += blockDim.x) tsh[k] = a.ta.z[k];
      ta = make_taps(tsh, L::bz, L::by, L::bx);
    }
    __syncthreads();
    ph.stamp(kStart);
    side_by_side(a.nconf, a.width, a.G, a.d, a.idx,
                 [this](const Walk& wk, int j, int c) { solve(wk, j, c); });
  }
};

template <class S, int kReg, class L>
__global__ void __launch_bounds__(kThreads * kMaxTeams, 1)
    irls_persistent_kernel(const __grid_constant__ IrlsArgs a) {
  __shared__ double sc[4];
  __shared__ float tsh[L::shared];
  IrlsPersistent<S, kReg, L>{a, Phases{cg::this_grid(), a.stamps, a.stamp_cap}, sc, tsh}.run();
}

// f(kernel) for the instance of storage `storage`, regulariser reg and the
// blur taps' lengths.
template <class F>
cudaError_t with_kernel(int storage, int reg, const Taps& ta, F&& f) {
  return with_irls_storage(storage, [&](auto st) {
    return with_reg(reg, [&](auto rg) {
      return with_blur_lens(ta, [&](auto lens) {
        return f((const void*)irls_persistent_kernel<decltype(st), decltype(rg)::value,
                                                     decltype(lens)>);
      });
    });
  });
}

// The bytes a configuration side by side holds: x, wts, free, rk, q, xk,
// t1, t2 in float and the directions p0, p1 in the storage's type, n
// voxels each.
long long conf_bytes(int storage, long long n) {
  return n * (8 * 4 + 2 * (storage == kRobustDirs ? 2 : 4));
}

// One cooperative launch of the batch a on `stream` (its width set here),
// `slots` at least the configurations side by side.
cudaError_t launch(IrlsArgs a, int storage, int reg, int slots, cudaStream_t stream) {
  return with_kernel(storage, reg, a.ta, [&](const void* fn) {
    Shape sh;
    int w = 0;
    const cudaError_t e = batch_shape(fn, a.nconf, conf_bytes(storage, a.d.n()), a.G, &sh, &w);
    if (e != cudaSuccess) return e;
    if (w > slots) return cudaErrorInvalidValue;
    a.width = w;
    void* args[] = {&a};
    return cudaLaunchCooperativeKernel(fn, dim3(sh.grid), dim3(sh.threads), args, 0, stream);
  });
}

// FastIndex's indices, with the last block's grid-stride overshoot.
bool valid(int Z, int Y, int X) {
  return Z >= 1 && Y >= 1 && X >= 1 && (long long)Z * Y * X <= (1LL << 30);
}

}  // namespace

extern "C" {

// Whether the IRLS sweeps of a solve take this kernel (the rule;
// ops/cuda/tiled.py's irls_persistent_fits mirrors it): storage
// kRobustExact or kRobustDirs, at most kPersistentMaxVoxels voxels, where none
// of the sweep's irls_head, blur_apply or weighted_apply takes its march
// (march.cuh's vol_route at the blur taps), whose partial sums the
// kernel's chain blocks would not reproduce.
int nsol_robust_persistent_route(int storage, int kz, int ky, int kx, int Z, int Y, int X) {
  if (storage != kRobustExact && storage != kRobustDirs) return 0;
  if ((long long)Z * Y * X > kPersistentMaxVoxels) return 0;
  return !nsol_vol_route(kVolIrlsHead, kz, ky, kx, Z, Y, X) &&
         !nsol_vol_route(kVolBlurApply, kz, ky, kx, Z, Y, X) &&
         !nsol_vol_route(kVolWeightedApply, kz, ky, kx, Z, Y, X);
}

// The launch shape of nconf configurations of Z Y X voxels in `storage`
// (a RobustStorage) and regulariser `reg` at the blur taps' lengths:
// out[0] the blocks an SM holds, out[1] the grid, out[2] the launch
// sequence's blocks a volume (grid_for), out[3] the threads a block,
// out[4] the configurations side by side (the slots of scratch
// nsol_irls_batch_persistent takes; 1 for a solve).
int nsol_robust_persistent_shape(int storage, int reg, int kz, int ky, int kx, int nconf, int Z,
                                 int Y, int X, int* out) {
  const Taps ta{nullptr, nullptr, nullptr, kz, ky, kx};
  const int g = grid_for((long long)Z * Y * X);
  Shape sh{0, 0, 0, 0};
  int width = 0;
  const cudaError_t e = with_kernel(storage, reg, ta, [&](const void* fn) {
    return batch_shape(fn, nconf, conf_bytes(storage, (long long)Z * Y * X), g, &sh, &width);
  });
  out[0] = sh.per_sm;
  out[1] = sh.grid;
  out[2] = g;
  out[3] = sh.threads;
  out[4] = width;
  return (int)e;
}

// nsol_robust_admm_solve's solve, its arguments and its x and records bit
// for bit, as one cooperative launch on `stream` (its arguments less the
// sequence's scal and rec_counts): storage kRobustExact or kRobustDirs
// (else cudaErrorInvalidValue), partials 2 * nsol_max_blocks() doubles.
// A launch the card refuses
// (cudaErrorCooperativeLaunchTooLarge, ...) returns its error and runs
// nothing. counts[kIrlsPersistent] += 1 where the kernel was launched.
int nsol_robust_admm_solve_persistent(const float* b, float* x, float* wts, float* free,
                                      float* rk, void* p0, void* p1, float* q, float* xk,
                                      float* t1, float* t2, double* partials, const float* taps,
                                      int kz, int ky, int kx, float rho, float ihx, float ihy,
                                      float ihz, float ih2x, float ih2y, float ih2z, int loss,
                                      float scale, int iterations, int iter_max, int cg_iters,
                                      int storage, double* reg, double* data,
                                      double* rec_partials, float rec_scale, int Z, int Y, int X,
                                      void* stream, long long* counts) {
  if (!valid(Z, Y, X) || iterations < 0 || iter_max < 0 || cg_iters < 0)
    return (int)cudaErrorInvalidValue;
  const Dims d{Z, Y, X};
  const IrlsArgs a{b,
                   nullptr,
                   x,
                   wts,
                   free,
                   rk,
                   {p0, p1},
                   q,
                   xk,
                   t1,
                   t2,
                   partials,
                   nullptr,
                   nullptr,
                   rho,
                   scale,
                   reg,
                   data,
                   rec_partials,
                   rec_scale * rec_scale,
                   make_taps(taps, kz, ky, kx),
                   Spacing{ihx, ihy, ihz, ih2x, ih2y, ih2z},
                   1,
                   1,
                   iterations,
                   iter_max,
                   cg_iters,
                   loss,
                   d,
                   FastIndex{FastDiv::of(X), FastDiv::of(Y)},
                   grid_for(d.n()),
                   g_persistent_stamps,
                   g_persistent_stamp_cap};
  const cudaError_t e = launch(a, storage, kRegLap, 1, (cudaStream_t)stream);
  if (e == cudaSuccess) counts[kIrlsPersistent] += 1;
  return (int)e;
}

// The robust losses of nsol_tikhonov_solve (loss != kLinear) for nconf
// configurations from x0 into x_out[k * n], the k-th at alphas[k] and
// scales[k] (device arrays), as one cooperative launch on `stream`: the
// entry clip and iter_max IRLS sweeps of cg_iters CG iterations on the
// blur taps, no exit clip. reg a RegKind, storage kRobustExact or
// kRobustDirs (compact: bf16 directions). Scratch: wts, free, r, p0, p1,
// q, xk, t1, t2 `slots` volumes each (p0, p1 of the storage's direction
// type), slots at least the configurations side by side
// (nsol_robust_persistent_shape's out[4], else cudaErrorInvalidValue);
// partials 2 * nsol_max_blocks() doubles a slot. The same x bit for bit;
// a launch the card refuses returns its error and runs nothing.
// counts[kIrlsPersistent] += 1 where the kernel was launched.
int nsol_irls_batch_persistent(const float* b, const float* x0, float* x_out, float* wts,
                               float* free, float* r, void* p0, void* p1, float* q, float* xk,
                               float* t1, float* t2, double* partials, const float* alphas,
                               const float* scales, int nconf, int slots, const float* taps,
                               int kz, int ky, int kx, float ih2x, float ih2y, float ih2z,
                               int reg, int loss, int iter_max, int cg_iters, int storage, int Z,
                               int Y, int X, void* stream, long long* counts) {
  if (!valid(Z, Y, X) || nconf < 1 || iter_max < 0 || cg_iters < 0 || loss == kLinear)
    return (int)cudaErrorInvalidValue;
  const Dims d{Z, Y, X};
  const IrlsArgs a{b,
                   x0,
                   x_out,
                   wts,
                   free,
                   r,
                   {p0, p1},
                   q,
                   xk,
                   t1,
                   t2,
                   partials,
                   alphas,
                   scales,
                   0.f,
                   1.f,
                   nullptr,
                   nullptr,
                   nullptr,
                   1.f,
                   make_taps(taps, kz, ky, kx),
                   Spacing{0.f, 0.f, 0.f, ih2x, ih2y, ih2z},
                   nconf,
                   0,
                   1,
                   iter_max,
                   cg_iters,
                   loss,
                   d,
                   FastIndex{FastDiv::of(X), FastDiv::of(Y)},
                   grid_for(d.n()),
                   g_persistent_stamps,
                   g_persistent_stamp_cap};
  const cudaError_t e = launch(a, storage, reg, slots, (cudaStream_t)stream);
  if (e == cudaSuccess) counts[kIrlsPersistent] += 1;
  return (int)e;
}

}  // extern "C"
