// Hopper (sm_90a) one-launch linear Tikhonov (TK0/TK1) batch solve: the
// linear loss of tikhonov.cu's nsol_tikhonov_solve (storage "exact" and
// "qf32", the reference's compact_dirs) for a whole batch of alpha
// configurations as one persistent cooperative kernel.
//
// Counterpart of the TPU Pallas kernel
//   nsol_tpu/ops/pallas/fused.py::make_fused_tikhonov_solver  (:716,
//   linear loss; compact_dirs)
// which holds one solve in VMEM, jax.vmap batching it over the alphas.
// Here one cooperative launch runs the batch, computing every
// configuration's x bit for bit as the launch sequence does.
//
// What bounds it on the H100. The launch sequence it replaces enqueues
// ~67 short launches a configuration (A^T b once, then the clips, the
// residual, 10 x (cg_step, cg_update) and their one-block reduces): on a
// 256^2 image each is a few microseconds of work, and the sequence spent
// its time in launch ramps, grid drains and host gaps (a Lena TK1L2 x 64
// sweep 14-20 ms, device busy ~50 %, PERF.md). Here the phases are
// separated by grid barriers and the configurations run side by side, so
// that a phase is the work of many configurations and the barriers are a
// few solves', not 64: barriers, L2 traffic and the passes' latency bound
// it (2.2 ms of device time for the Lena sweep; its bytes and operations
// bound it at 0.05 ms, PERF.md).
//
// Design. persistent.cuh's machinery, as admm_persistent.cu runs it: each
// unit of the sequence a phase, every phase walking the sequence's blocks
// through the sequence's pass bodies (stencil.cuh, admm_units.cuh), so
// that every partial sum is the sequence's. A launch runs `width`
// configurations side by side, each on its own slot of scratch (r, p0,
// p1, q, t1, t2; the directions bf16 under compact), its own partials and
// its own CG scalars, on a disjoint group of CUDA blocks (blocks [j nb /
// w, (j + 1) nb / w) run slot j), so that a block forms the one-block
// reduces of its own configuration only (every block forming all 64 of
// Lena's took 1.7x as long); the batch runs in equal turns of as many as
// keep their x and scratch in kSideBySideBytes of the L2 (16 on Lena, 4
// at 64^3: faster than 64 or 8 past the L2, and than the configurations
// one after another, 3.8x slower on Lena; PERF.md). A^T b runs once, over
// the whole grid. The entry clip is the residual's x pass's source (x =
// max(x0, 0), a NaN kept, stored beside the pass); the exit clip runs on
// each thread's own voxels of the last cg_update, which no barrier
// separates from it; the last cg_update's reduce, which nothing reads, is
// not formed.
//
// Coherence: every load is a plain one (persistent.cuh), even of b, x0,
// the alphas and the taps, which nothing writes.

#include <cuda_runtime.h>

#include "admm_units.cuh"
#include "losses.cuh"
#include "persistent.cuh"

extern "C" int nsol_admm_persistent_route(int storage, int sweep, int kaz, int kay, int kax,
                                          int knz, int kny, int knx, int Z, int Y, int X);
extern "C" int nsol_robust_persistent_route(int storage, int kz, int ky, int kx, int Z, int Y,
                                            int X);

namespace {

// tikhonov.cu's Unit slots continue here: the one launch of a batch
// (ops/cuda/tikhonov.py's COUNTS).
constexpr int kTikPersistent = 1;

template <class S>
struct TikArgs {
  using R = typename S::R;
  using P = typename S::P;
  using Q = typename S::Q;
  const float* b;
  const float* x0;
  float* x;  // nconf volumes
  float* atb;
  R* r;  // r, p, q, t1, t2: a volume a slot
  P* p[2];
  Q* q;
  float* t1;
  float* t2;
  double* partials;  // two sets of kMaxBlocks a slot
  const float* alphas;
  Taps ta, tn;
  Spacing sp;
  int nconf, width, iter_max;  // width: the configurations side by side
  Dims d;
  FastIndex idx;
  int G;  // the launch sequence's blocks, grid_for(n)
  long long* stamps;  // (time, Phase) pairs of a traced solve, or null
  int stamp_cap;
};

template <class S, int kReg, class L>
struct TikPersistent {
  using R = typename S::R;
  using P = typename S::P;
  using Q = typename S::Q;
  using Vol = LoadT<float, float, false>;
  const TikArgs<S>& a;
  Phases ph;
  double* sc;   // this block's configuration's CG scalars (shared memory)
  float* tsh;   // room for the taps in shared memory (fixed lengths)
  Taps ta, tn;  // the blur's and the normal taps, where the passes read them
  int set = 0;  // the partials set the next reduced pass writes (CgSums')

  // Configuration c on slot j, its blocks walking wk: the sequence's
  // clip, residual, iter_max CG steps and exit clip.
  __device__ void solve(const Walk& wk, int j, int c) {
    const long long n = a.d.n(), o = j * n;
    float* x = a.x + c * n;
    R* r = a.r + o;
    P* p[2] = {a.p[0] + o, a.p[1] + o};
    Q* q = a.q + o;
    float* t1 = a.t1 + o;
    float* t2 = a.t2 + o;
    // slot j's partials and this block's scalars, their sets alternating
    // in step with every other configuration's
    CgSums sums{a.partials + 2LL * j * kMaxBlocks, sc, set};
    const float alpha = a.alphas[c];
    // r = A^T b - (A^T A + alpha B^T B) x of x = max(x0, 0), which the x
    // pass stores (the entry clip)
    const Vol xs{x};
    chain<L::nx, L::ny, L::nz>(
        wk, ph, kApplyX, ClipSrc{a.x0}, x,
        NormalEpi<kReg, Vol, R>{xs, a.atb, r, alpha, a.sp, kResidual}, sums.parts(), tn, t1,
        t2);
    reduce(sums, kReduceRR0);
    int pc = 1;  // p' into p[pc], p from p[1 - pc]
    for (int k = 0; k < a.iter_max; ++k) {
      const DirectionT<false, R, P, false> dir{
          r, p[1 - pc], nullptr, nullptr, k == 0, k == 0 ? 0.f : (float)sc[kBeta]};
      const LoadT<P, P, false> pn{p[pc]};
      chain<L::nx, L::ny, L::nz>(
          wk, ph, kStepX, dir, p[pc],
          NormalEpi<kReg, LoadT<P, P, false>, Q>{pn, nullptr, q, alpha, a.sp, kDot},
          sums.parts(), tn, t1, t2);
      reduce(sums, kReducePQ);
      const float am = (float)sc[kA];
      for (int vb = wk.first; vb < a.G; vb += wk.stride) {
        cg_update_body<GroupTeam>(am, x, r, p[pc], q, sums.parts(), n, 1, vb, a.G);
        GroupTeam::sync();
      }
      if (k + 1 < a.iter_max) {
        ph.sync(kUpdate);
        reduce(sums, kReduceRR);
      }
      pc = 1 - pc;
    }
    // the exit clip, each thread on the voxels it last wrote
    for (int vb = wk.first; vb < a.G; vb += wk.stride)
      BLOCK_STRIDE(i, n, vb, a.G, GroupTeam::tid()) { x[i] = clip0(x[i]); }
    set = sums.set;
    ph.stamp(kClip);
  }

  // The one-block second stage of the pass that wrote sums.parts(),
  // formed by every block of the configuration's group, then the next set.
  __device__ void reduce(CgSums& sums, int mode) {
    sums.reduce(a.G, mode);
    ph.stamp(kReduce);
  }

  __device__ void run() {
    ta = a.ta;
    tn = a.tn;
    taps_to_shared<L>(tsh, ta, tn);
    __syncthreads();
    ph.stamp(kStart);
    const int teams = blockDim.x / kThreads, team = GroupTeam::team(), nb = gridDim.x;
    // A^T b = A b (rho 0) once, over the whole grid, through slot 0's t1, t2
    const Vol bs{a.b};
    chain<L::bx, L::by, L::bz>(
        Walk{(int)blockIdx.x * teams + team, nb * teams, a.G, a.d, a.idx}, ph, kApplyX, bs,
        nullptr, NormalEpi<kRegLap, Vol, float>{bs, nullptr, a.atb, 0.f, a.sp, kPlain}, nullptr,
        ta, a.t1, a.t2);
    side_by_side(a.nconf, a.width, a.G, a.d, a.idx,
                 [this](const Walk& wk, int j, int c) { solve(wk, j, c); });
  }
};

template <class S, int kReg, class L>
__global__ void __launch_bounds__(kThreads * kMaxTeams, 1)
    tikhonov_persistent_kernel(const __grid_constant__ TikArgs<S> a) {
  __shared__ double sc[4];
  __shared__ float tsh[L::shared];
  TikPersistent<S, kReg, L>{a, Phases{cg::this_grid(), a.stamps, a.stamp_cap}, sc, tsh}.run();
}

// f(kernel, lens) for the instance of storage S, regulariser reg and the
// taps' lengths.
template <class S, class F>
cudaError_t with_kernel(int reg, const Taps& ta, const Taps& tn, F&& f) {
  const int la[3] = {ta.kz, ta.ky, ta.kx}, ln[3] = {tn.kz, tn.ky, tn.kx};
  return with_reg(reg, [&](auto rg) {
    return with_lens(la, ln, [&](auto lens) {
      return f((const void*)tikhonov_persistent_kernel<S, decltype(rg)::value, decltype(lens)>);
    });
  });
}

// The bytes a configuration side by side holds: x, r, q, t1, t2 in float
// and the directions p0, p1 in the storage's type, n voxels each.
long long conf_bytes(int storage, long long n) {
  return n * (5 * 4 + 2 * (storage == kStoreQf32 ? 2 : 4));
}

}  // namespace

extern "C" {

// Whether the fused Tikhonov solve runs its batch as one cooperative
// launch (the rule; ops/cuda/tikhonov.py's tikhonov_persistent_route
// mirrors it): the linear loss on this kernel where admm_persistent.cu's
// rule without the sweep takes the shape (storage "exact" or "qf32", at
// most 2^20 voxels, where no unit of the sequence marches: A^T b's
// normal_apply at the blur taps, the residual's at the normal taps,
// cg_step at the normal taps); a robust loss on irls_persistent.cu's
// nsol_irls_batch_persistent where its rule takes the shape at the blur
// taps (storage "exact", or "qf32" as the sweep's "dirs").
int nsol_tikhonov_persistent_route(int loss, int storage, int kaz, int kay, int kax, int knz,
                                   int kny, int knx, int Z, int Y, int X) {
  if (loss == kLinear)
    return nsol_admm_persistent_route(storage, 0, kaz, kay, kax, knz, kny, knx, Z, Y, X);
  return (storage == kStoreExact || storage == kStoreQf32) &&
         nsol_robust_persistent_route(storage == kStoreQf32 ? kRobustDirs : kRobustExact, kaz,
                                      kay, kax, Z, Y, X);
}

// The launch shape of a batch of nconf configurations of Z Y X voxels in
// `storage` and regulariser `reg` at the blur taps' and the normal taps'
// lengths: out[0] the blocks an SM holds, out[1] the grid, out[2] the
// launch sequence's blocks a volume (grid_for), out[3] the threads a
// block, out[4] the configurations side by side (the slots of scratch
// nsol_tikhonov_solve_persistent takes).
int nsol_tikhonov_persistent_shape(int storage, int reg, int kaz, int kay, int kax, int knz,
                                   int kny, int knx, int nconf, int Z, int Y, int X,
                                   int* out) {
  const Taps ta{nullptr, nullptr, nullptr, kaz, kay, kax}, tn{nullptr, nullptr, nullptr, knz, kny, knx};
  const int g = grid_for((long long)Z * Y * X);
  Shape sh{0, 0, 0, 0};
  int width = 0;
  const cudaError_t e = with_solve_storage(storage, [&](auto st) {
    return with_kernel<decltype(st)>(reg, ta, tn, [&](const void* fn) {
      return batch_shape(fn, nconf, conf_bytes(storage, (long long)Z * Y * X), g, &sh,
                         &width);
    });
  });
  out[0] = sh.per_sm;
  out[1] = sh.grid;
  out[2] = g;
  out[3] = sh.threads;
  out[4] = width;
  return (int)e;
}

// nsol_tikhonov_solve's linear solves (loss kLinear) of nconf
// configurations from x0 into x_out[k * n], the k-th at alphas[k] (a
// device array), as one cooperative launch on `stream`. reg a RegKind,
// storage kStoreExact or kStoreQf32 (compact: bf16 directions). Scratch:
// atb one volume; r, p0, p1, q, t1, t2 `slots` volumes each (p0, p1 of
// the storage's direction type), slots at least the configurations side
// by side (nsol_tikhonov_persistent_shape's out[4], else
// cudaErrorInvalidValue); partials 2 * nsol_max_blocks() doubles a slot.
// The same x bit for bit, on any shape; a
// launch the card refuses (cudaErrorCooperativeLaunchTooLarge, ...)
// returns its error and runs nothing. counts[kTikPersistent] += 1 where
// the kernel was launched.
int nsol_tikhonov_solve_persistent(const float* b, const float* x0, float* x_out, float* atb,
                                   void* r, void* p0, void* p1, void* q, float* t1, float* t2,
                                   double* partials, const float* alphas, int nconf, int slots,
                                   const float* taps_a, int kaz, int kay, int kax,
                                   const float* taps_n, int knz, int kny, int knx, float ih2x,
                                   float ih2y, float ih2z, int reg, int iter_max, int storage,
                                   int Z, int Y, int X, void* stream, long long* counts) {
  const Dims d{Z, Y, X};
  // FastIndex's indices, with the last block's grid-stride overshoot
  if (Z < 1 || Y < 1 || X < 1 || d.n() > (1LL << 30) || nconf < 1 || iter_max < 0)
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = with_solve_storage(storage, [&](auto st) {
    using S = decltype(st);
    TikArgs<S> a{b,
                 x0,
                 x_out,
                 atb,
                 static_cast<typename S::R*>(r),
                 {static_cast<typename S::P*>(p0), static_cast<typename S::P*>(p1)},
                 static_cast<typename S::Q*>(q),
                 t1,
                 t2,
                 partials,
                 alphas,
                 make_taps(taps_a, kaz, kay, kax),
                 make_taps(taps_n, knz, kny, knx),
                 Spacing{0.f, 0.f, 0.f, ih2x, ih2y, ih2z},
                 nconf,
                 0,
                 iter_max,
                 d,
                 FastIndex{FastDiv::of(X), FastDiv::of(Y)},
                 grid_for(d.n()),
                 g_persistent_stamps,
                 g_persistent_stamp_cap};
    return with_kernel<S>(reg, a.ta, a.tn, [&](const void* fn) {
      Shape sh;
      int w = 0;
      const cudaError_t e2 = batch_shape(fn, nconf, conf_bytes(storage, d.n()), a.G, &sh, &w);
      if (e2 != cudaSuccess) return e2;
      if (w > slots) return cudaErrorInvalidValue;
      a.width = w;
      void* args[] = {&a};
      return cudaLaunchCooperativeKernel(fn, dim3(sh.grid), dim3(sh.threads), args, 0,
                                         (cudaStream_t)stream);
    });
  });
  if (e == cudaSuccess) counts[kTikPersistent] += 1;
  return (int)e;
}

}  // extern "C"
