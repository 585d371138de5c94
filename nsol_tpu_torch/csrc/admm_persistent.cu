// Hopper (sm_90a) one-launch linear ADMM TV-L2 solve: the whole solve of
// admm.cu's nsol_admm_solve (the fused route's "exact" and "qf32" storage,
// records on or off) as one persistent cooperative kernel.
//
// Counterpart of the TPU Pallas kernel
//   nsol_tpu/ops/pallas/fused.py::make_fused_admm_solver  (:382, linear
//   branch; record=True; compact_dirs)
// which holds the whole solve in one program with every volume in VMEM.
// Here one cooperative launch holds it, its ~17 volumes in device memory
// (17 MiB at 64^3: they stay in the 50 MB L2), computing the same f32
// values as the launch sequence bit for bit.
//
// What bounds it on the H100. Not bytes: a 64^3 solve's units move ~1.8
// ms of bytes at HBM rate (PERF.md) and its volumes sit in L2. The launch
// sequence it replaces (~3300 launches, nsol_admm_solve) spent its time in
// launch ramps, grid drains and host gaps (device busy 75 % at 64^3, 54 %
// on a 256^2 image). Here the phases are separated by grid barriers
// (cooperative_groups grid.sync, 2203 a 50 x 10 solve), and at 64^3 and
// on a 256^2 image a phase is a few microseconds of L2 traffic: barriers
// and L2 latency bound it. A barrier costs ~1.1 us at the 132 blocks of
// 64^3 (chip_smoke.py phase 45, PERF.md): about a fifth of the 64^3
// solve, nearly half of the 256^2 one; the passes take the rest, at 64
// registers (1024 threads an SM), the sequence's 1024 blocks at 64^3 in
// two rounds.
//
// Design (its machinery in persistent.cuh, shared with
// tikhonov_persistent.cu). A CUDA block runs up to kMaxTeams of the
// sequence's blocks of kThreads threads side by side (teams, GroupTeam),
// as many CUDA blocks as the card holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor x the SMs; shape_of), so
// that few blocks arrive at each barrier. Each
// phase is one of the sequence's kernels: a team runs the sequence's
// blocks vb = its first, + its stride, ... in turn, each with the
// sequence's threads on the sequence's voxels (stencil.cuh's
// BLOCK_STRIDE) and the same device code (the pass bodies of stencil.cuh,
// admm_units.cuh and admm_tail.cuh), its block sums over its own threads
// (a named barrier a team), so that every partial sum is the sequence's,
// in its order. A one-block reduce (stencil.cuh's reduce_kernel,
// kReduceThreads threads) is formed with the same shuffle tree by every
// CUDA block redundantly (reduce_sum; the CG scalars then live in each
// block's shared memory and no barrier follows: block 0 alone and a
// barrier after it was slower, PERF.md); the partials alternate between
// two sets so that a redundant reduce still reading one set never meets
// the next pass writing it. The records'
// reduce runs in block 0 alone: nothing in the solve reads them. Phases
// merge only where the later reads nothing another block wrote since the
// last barrier: the records' TV with their blur's x pass, the first tail
// with the next residual's x pass. The main paths' sigma = 1 taps (13
// normal, 7 blur an axis) are compile-time lengths, their tap loops
// unrolled and the taps read from shared memory; a voxel's coordinates
// come from multiplies and shifts (FastIndex), not the sequence's 64-bit
// divisions (the same integers; 1 ms of the 64^3 solve's 12.3, PERF.md).
//
// Coherence: every load is a plain one (persistent.cuh), even of b and the
// taps, which nothing writes; chip_smoke.py checks the kernel's SASS for
// constant-cache loads.

#include <cuda_runtime.h>

#include "admm_tail.cuh"
#include "admm_units.cuh"
#include "persistent.cuh"

long long* g_persistent_stamps = nullptr;
int g_persistent_stamp_cap = 0;

namespace {

// admm.cu's Unit slots continue here: the one launch of this solve
// (ops/cuda/blocked.py's COUNTS).
constexpr int kAdmmPersistent = 11;

template <class S>
struct SolveArgs {
  using R = typename S::R;
  using P = typename S::P;
  using Q = typename S::Q;
  const float* b;
  float* x;
  float* w[2];  // w and w' alternate (nsol_admm_solve's w and v)
  float* atb;
  float* rhs;
  R* r;
  P* p[2];
  Q* q;
  float* t1;
  float* t2;
  double* partials;  // two sets of kMaxBlocks
  double* scal;      // the CG scalars: the start and the end state
  double* reg;       // the records, or null
  double* data;
  double* rec_partials;  // 2 * kMaxBlocks: the data, then the TV partials
  Taps ta, tn;
  Spacing sp;
  float tau, rho, fs2;
  int iterations, iter_max, loss;
  Dims d;
  FastIndex idx;
  int G;  // the launch sequence's blocks, grid_for(n)
  long long* stamps;  // (time, Phase) pairs of a traced solve, or null
  int stamp_cap;
};

template <class S, class L>
struct Persistent {
  using R = typename S::R;
  using P = typename S::P;
  using Q = typename S::Q;
  using Vol = LoadT<float, float, false>;
  const SolveArgs<S>& a;
  Phases ph;
  CgSums sums;
  float* tsh;   // room for the taps in shared memory (fixed lengths)
  Walk w;       // the whole volume: this team's first block and stride
  Taps ta, tn;  // the blur's and the normal taps, where the passes read them

  // The one-block second stage of the pass that wrote sums.parts(), formed
  // by every block into its own scalars, then the next set.
  __device__ void reduce(int mode) {
    sums.reduce(a.G, mode);
    ph.stamp(kReduce);
  }

  // admm_tail over the volume (three components: nsol_admm_solve runs a
  // 2-D image as its (1, Y, X) view), w read from w[wr], w' into w[ww].
  template <bool kInit>
  __device__ void tail(int wr, int ww) {
    const Dims d = a.d;
    const long long n = d.n();
    const TailArgs t{a.x, a.w[wr], a.w[ww], nullptr, a.atb, a.rhs, a.sp.ihx, a.sp.ihy,
                     a.sp.ihz, a.tau, a.rho, d.Z, d.Y, d.X, n, 0, 0};
    for (int vb = w.first; vb < a.G; vb += w.stride)
      BLOCK_STRIDE(i, n, vb, a.G, GroupTeam::tid()) {
        const Coord c = a.idx.at(i);
        tail_voxel<kInit, true, false>(t, c.x, c.y, c.z);
      }
  }

  // Row t of the records (admm.cu's admm_record): the blur chain of x at
  // the blur taps with the data epilogue, the TV beside its x pass, and
  // block 0's second stage.
  __device__ void record(int t) {
    record_row<L::bx, L::by, L::bz>(w, ph, a.x, a.b, a.fs2, a.loss, a.rec_partials, a.reg,
                                    a.data, t, ta, a.t1, a.t2, a.sp);
  }

  // nsol_admm_solve's sequence (sweep 0), phase by phase.
  __device__ void run() {
    const bool records = a.reg != nullptr;
    if (threadIdx.x < 4) sums.sc[threadIdx.x] = a.scal[threadIdx.x];
    ta = a.ta;
    tn = a.tn;
    taps_to_shared<L>(tsh, ta, tn);
    __syncthreads();
    ph.stamp(kStart);
    if (records) record(0);
    // A^T b = A b (rho 0), then the init tail; the first residual's x
    // pass reads x, which the init tail does not write: no barrier
    const Vol bs{a.b};
    chain<L::bx, L::by, L::bz>(
        w, ph, kApplyX, bs, nullptr,
        NormalEpi<kRegLap, Vol, float>{bs, nullptr, a.atb, 0.f, a.sp, kPlain}, nullptr, ta, a.t1,
        a.t2);
    tail<true>(0, 0);
    int wc = 0;
    for (int it = 0; it < a.iterations; ++it) {
      const Vol xs{a.x};
      chain<L::nx, L::ny, L::nz>(
          w, ph, kApplyX, xs, nullptr,
          NormalEpi<kRegLap, Vol, R>{xs, a.rhs, a.r, a.rho, a.sp, kResidual}, sums.parts(), tn,
          a.t1, a.t2);
      reduce(kReduceRR0);
      int pc = 1;  // p' into p[pc], p from p[1 - pc]
      for (int k = 0; k < a.iter_max; ++k) {
        const DirectionT<false, R, P, false> dir{
            a.r, a.p[1 - pc], nullptr, nullptr, k == 0, k == 0 ? 0.f : (float)sums.sc[kBeta]};
        const LoadT<P, P, false> pn{a.p[pc]};
        chain<L::nx, L::ny, L::nz>(
            w, ph, kStepX, dir, a.p[pc],
            NormalEpi<kRegLap, LoadT<P, P, false>, Q>{pn, nullptr, a.q, a.rho, a.sp, kDot},
            sums.parts(), tn, a.t1, a.t2);
        reduce(kReducePQ);
        const float alpha = (float)sums.sc[kA];
        for (int vb = w.first; vb < a.G; vb += w.stride) {
          cg_update_body<GroupTeam>(alpha, a.x, a.r, a.p[pc], a.q, sums.parts(), a.d.n(), 1, vb,
                                    a.G);
          GroupTeam::sync();
        }
        ph.sync(kUpdate);
        reduce(kReduceRR);
        pc = 1 - pc;
      }
      tail<false>(wc, 1 - wc);
      wc = 1 - wc;
      ph.sync(kTail);
      if (records) record(it + 1);
    }
    if (blockIdx.x == 0 && threadIdx.x < 4) a.scal[threadIdx.x] = sums.sc[threadIdx.x];
  }
};

template <class S, class L>
__global__ void __launch_bounds__(kThreads * kMaxTeams, 1)
    admm_persistent_kernel(const __grid_constant__ SolveArgs<S> a) {
  __shared__ double sc[4];
  __shared__ float tsh[L::shared];
  const int teams = blockDim.x / kThreads;
  const Walk w{(int)blockIdx.x * teams + GroupTeam::team(), (int)gridDim.x * teams, a.G, a.d,
               a.idx};
  Persistent<S, L>{a, Phases{cg::this_grid(), a.stamps, a.stamp_cap}, CgSums{a.partials, sc},
                   tsh, w}
      .run();
}

// n grid barriers and nothing else, at the solve's block shape: what the
// barriers alone cost (nsol_admm_persistent_barriers).
__global__ void __launch_bounds__(kThreads * kMaxTeams, 1) barriers_kernel(int n) {
  cg::grid_group grid = cg::this_grid();
  for (int k = 0; k < n; ++k) grid.sync();
}

template <class S, class L>
const void* kernel_of() {
  return (const void*)admm_persistent_kernel<S, L>;
}

template <class S>
cudaError_t launch_solve(SolveArgs<S> a, cudaStream_t s) {
  const int la[3] = {a.ta.kz, a.ta.ky, a.ta.kx}, ln[3] = {a.tn.kz, a.tn.ky, a.tn.kx};
  return with_lens(la, ln, [&](auto lens) {
    const void* fn = kernel_of<S, decltype(lens)>();
    Shape sh;
    const cudaError_t e = shape_of(fn, a.G, &sh);
    if (e != cudaSuccess) return e;
    void* args[] = {&a};
    return cudaLaunchCooperativeKernel(fn, dim3(sh.grid), dim3(sh.threads), args, 0, s);
  });
}

}  // namespace

extern "C" {

// Whether the fused route's solve takes this kernel (the rule; fused.py's
// persistent_route mirrors it): storage "exact" or "qf32", no sweep, at
// most kPersistentMaxVoxels voxels, where no unit of the launch sequence
// takes its march (march.cuh's vol_route: A^T b's normal_apply at the blur
// taps, the residual's at the normal taps, cg_step at the normal taps),
// whose partial sums the kernel's chain blocks would not reproduce.
int nsol_admm_persistent_route(int storage, int sweep, int kaz, int kay, int kax, int knz,
                               int kny, int knx, int Z, int Y, int X) {
  if (sweep || (storage != kStoreExact && storage != kStoreQf32)) return 0;
  if ((long long)Z * Y * X > kPersistentMaxVoxels) return 0;
  return !nsol_vol_route(kVolNormalApply, kaz, kay, kax, Z, Y, X) &&
         !nsol_vol_route(kVolNormalApply, knz, kny, knx, Z, Y, X) &&
         !nsol_vol_route(kVolCgStep, knz, kny, knx, Z, Y, X);
}

// The launch shape of a solve of Z Y X voxels in `storage` at the blur
// taps' and the normal taps' lengths: out[0] the blocks an SM holds,
// out[1] the grid, out[2] the launch sequence's blocks (grid_for),
// out[3] the threads a block.
int nsol_admm_persistent_shape(int storage, int kaz, int kay, int kax, int knz, int kny,
                               int knx, int Z, int Y, int X, int* out) {
  const int la[3] = {kaz, kay, kax}, ln[3] = {knz, kny, knx};
  const int g = grid_for((long long)Z * Y * X);
  Shape sh{0, 0, 0, 0};
  const cudaError_t e = with_solve_storage(storage, [&](auto st) {
    return with_lens(la, ln, [&](auto lens) {
      return shape_of(kernel_of<decltype(st), decltype(lens)>(), g, &sh);
    });
  });
  out[0] = sh.per_sm;
  out[1] = sh.grid;
  out[2] = g;
  out[3] = sh.threads;
  return (int)e;
}

// One cooperative launch of `grid` blocks of `threads` threads that takes
// n grid barriers and does nothing else, on `stream`.
int nsol_admm_persistent_barriers(int n, int grid, int threads, void* stream) {
  void* args[] = {&n};
  return (int)cudaLaunchCooperativeKernel((const void*)barriers_kernel, dim3(grid),
                                          dim3(threads), args, 0, (cudaStream_t)stream);
}

// Trace the next solves: each writes the end of its first `capacity`
// phases into stamps as (globaltimer ns, Phase) pairs, by block 0; null
// stops tracing.
int nsol_admm_persistent_trace(long long* stamps, int capacity) {
  g_persistent_stamps = stamps;
  g_persistent_stamp_cap = stamps != nullptr ? capacity : 0;
  return 0;
}

// nsol_admm_solve's solve (its arguments but sweep; r1 and q1 unused, may
// be null) as one cooperative launch on `stream`: storage kStoreExact or
// kStoreQf32 (else cudaErrorInvalidValue), partials 2 * nsol_max_blocks()
// doubles, scal 4. The same x and records bit for bit, on any shape; a
// launch the card refuses (cudaErrorCooperativeLaunchTooLarge, ...)
// returns its error and runs nothing. counts[kAdmmPersistent] += 1 where
// the kernel was launched.
int nsol_admm_solve_persistent(const float* b, float* x, float* v, float* w, float* atb,
                               float* rhs, void* r0, void* r1, void* p0, void* p1, void* q,
                               void* q1, float* t1, float* t2, double* partials, double* scal,
                               const float* taps_a, int kaz, int kay, int kax,
                               const float* taps_n, int knz, int kny, int knx, float ihx,
                               float ihy, float ihz, float ih2x, float ih2y, float ih2z,
                               float tau, float rho, int iterations, int iter_max, int storage,
                               double* reg, double* data, double* rec_partials, int rec_loss,
                               float rec_scale, int Z, int Y, int X, void* stream,
                               long long* counts) {
  (void)r1;
  (void)q1;
  const Dims d{Z, Y, X};
  // FastIndex's indices, with the last block's grid-stride overshoot
  if (Z < 1 || Y < 1 || X < 1 || d.n() > (1LL << 30)) return (int)cudaErrorInvalidValue;
  const cudaError_t e = with_solve_storage(storage, [&](auto st) {
    using S = decltype(st);
    SolveArgs<S> a{b,
                   x,
                   {w, v},
                   atb,
                   rhs,
                   static_cast<typename S::R*>(r0),
                   {static_cast<typename S::P*>(p0), static_cast<typename S::P*>(p1)},
                   static_cast<typename S::Q*>(q),
                   t1,
                   t2,
                   partials,
                   scal,
                   reg,
                   data,
                   rec_partials,
                   make_taps(taps_a, kaz, kay, kax),
                   make_taps(taps_n, knz, kny, knx),
                   Spacing{ihx, ihy, ihz, ih2x, ih2y, ih2z},
                   tau,
                   rho,
                   rec_scale * rec_scale,
                   iterations,
                   iter_max,
                   rec_loss,
                   d,
                   FastIndex{FastDiv::of(X), FastDiv::of(Y)},
                   grid_for(d.n()),
                   g_persistent_stamps,
                   g_persistent_stamp_cap};
    return launch_solve(a, (cudaStream_t)stream);
  });
  if (e == cudaSuccess) counts[kAdmmPersistent] += 1;
  return (int)e;
}

}  // extern "C"
