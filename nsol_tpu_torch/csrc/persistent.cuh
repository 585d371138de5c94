// The machinery of the one-launch (persistent cooperative) solves:
// admm_persistent.cu's ADMM solve, tikhonov_persistent.cu's Tikhonov
// batch, irls_persistent.cu's IRLS sweeps and pd_persistent.cu's
// primal-dual denoise. Each runs a launch sequence
// of csrc/ as phases between grid barriers, every phase walking the
// sequence's blocks of kThreads threads through the sequence's pass bodies
// (stencil.cuh, admm_units.cuh, robust_units.cuh, pd_units.cuh), so that
// every partial sum is the sequence's, in its order.
//
// Here: the teams that run several of the sequence's blocks side by side
// in one CUDA block (GroupTeam), the division-free voxel coordinates
// (FastIndex), the taps' lengths at compile time (TapLens, with_lens), the
// walk of a phase over the sequence's blocks (Walk) and of a blur chain
// (chain), the grid barrier and a traced solve's global-timer stamps
// (Phases), the one-block reduce every CUDA block forms itself
// (reduce_sum, CgSums), a record row of admm_record (record_row), the
// entry clip of a batch (ClipSrc), the launch shape (shape_of) and a
// batch's configurations side by side (batch_width, batch_shape,
// side_by_side).
//
// Coherence. A volume written earlier in the launch by another block must
// not be read through the non-coherent read-only path, so every load of a
// persistent kernel is a plain one (load_f<false>, no const __restrict__
// pointer); chip_smoke.py checks their SASS for constant-cache loads.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "admm_units.cuh"
#include "stencil.cuh"

// Where a traced solve writes its phases' ends (nsol_admm_persistent_trace,
// admm_persistent.cu): both persistent solves read it at launch.
extern long long* g_persistent_stamps;
extern int g_persistent_stamp_cap;

namespace {

namespace cg = cooperative_groups;

// A CUDA block runs up to kMaxTeams of the launch sequence's blocks side
// by side (GroupTeam; shape_of picks how many): fewer blocks arrive at
// each grid barrier (chip_smoke.py phase 45 times the barriers alone at
// the solves' grids). The register cap: kMaxTeams x kThreads threads an
// SM.
constexpr int kMaxTeams = 4;

// The most voxels the persistent solves' routes take (their rules,
// nsol_admm_persistent_route and nsol_robust_persistent_route; the
// Tikhonov batch's takes theirs): the fused route's scope (16 volumes in
// 64 MiB), within which every shape timed beat the launch sequence
// (chip_smoke.py phases 45 and 47, PERF.md). At sigma = 1 the marches'
// boundary (vol_route) binds first, at 2^19 voxels.
constexpr long long kPersistentMaxVoxels = 1LL << 20;

// The phases a traced solve stamps (fused.py's PERSISTENT_PHASES): the
// end of each, after its barrier (a reduce, the Tikhonov exit clip: block
// 0's own end).
enum Phase {
  kStart = 0,
  kStepX = 1, kStepY = 2, kStepZ = 3,        // cg_step's chain
  kApplyX = 4, kApplyY = 5, kApplyZ = 6,     // A^T b's and the residuals'
  kRecordX = 7, kRecordY = 8, kRecordZ = 9,  // the records' (and their TV)
  kReduce = 10,
  kUpdate = 11,
  kTail = 12,
  kClip = 13,
  kHeadX = 14, kHeadY = 15, kHeadZ = 16,        // irls_head's chain
  kGradX = 17, kGradY = 18, kGradZ = 19,        // blur_apply's gradient chain
  kWeightX = 20, kWeightY = 21, kWeightZ = 22,  // weighted_apply's first chain
  kMaskX = 23, kMaskY = 24, kMaskZ = 25,        // its second (the mask, p'.q)
  kStep = 26,                                   // the last cg_update and irls_step
  kDual = 27, kPrimal = 28, kRecordRow = 29,  // pd_persistent.cu's phases
  kEnd = 30                                   // and block 0's own end
};

static_assert(kMaxBlocks <= kReduceThreads, "reduce_sum takes one partial a thread");

// Compile-time tap lengths of a solve's two chains, the normal taps' (kN
// an axis, kNz along z) and the blur's (kB, kBz), 0 at run time: the main
// paths' sigma = 1 blur (7 taps an axis, 13 normal taps) on a volume or a
// 2-D image (z taps 1) unrolls every tap loop (wrap_conv's kK).
template <int kN, int kB, int kNz, int kBz>
struct TapLens {
  static constexpr int nx = kN, ny = kN, nz = kNz, bx = kB, by = kB, bz = kBz;
  // the floats taps_to_shared copies to shared memory (1 at run time)
  static constexpr int shared = kN > 0 ? 2 * kB + kBz + 2 * kN + kNz : 1;
};
using RuntimeLens = TapLens<0, 0, 0, 0>;
using Sigma1Volume = TapLens<13, 7, 13, 7>;
using Sigma1Image = TapLens<13, 7, 1, 1>;

// f(TapLens<...>{}) for the taps' lengths.
template <class F>
cudaError_t with_lens(const int* a, const int* n, F&& f) {
  const bool blur7 = a[1] == 7 && a[2] == 7, normal13 = n[1] == 13 && n[2] == 13;
  if (blur7 && normal13 && a[0] == 7 && n[0] == 13) return f(Sigma1Volume{});
  if (blur7 && normal13 && a[0] == 1 && n[0] == 1) return f(Sigma1Image{});
  return f(RuntimeLens{});
}

// The taps of a solve's two chains where its pass bodies read them: in
// shared memory (tsh of L::shared floats, z y x, the blur's first) at
// fixed lengths, else in device memory. Every thread of the block calls
// it; a __syncthreads() must follow before the taps are read.
template <class L>
__device__ void taps_to_shared(float* tsh, Taps& ta, Taps& tn) {
  if (L::nx == 0) return;
  constexpr int na = L::bz + L::by + L::bx, nn = L::nz + L::ny + L::nx;
  for (int k = threadIdx.x; k < na + nn; k += blockDim.x)
    tsh[k] = k < na ? ta.z[k] : tn.z[k - na];
  ta = make_taps(tsh, L::bz, L::by, L::bx);
  tn = make_taps(tsh + na, L::nz, L::ny, L::nx);
}

// Division by a positive int d < 2^31 of a dividend 0 <= i < 2^31 by a
// multiply and a shift (CUTLASS's FastDivmod): q = umulhi(i, m) >> s, m =
// ceil(2^p / d), p = 31 + ceil(log2 d).
struct FastDiv {
  int d;
  unsigned m;
  int s;
  static FastDiv of(int d) {
    if (d == 1) return FastDiv{1, 0u, 0};
    int l = 0;
    while ((1LL << l) < d) ++l;
    const int p = 31 + l;
    return FastDiv{d, (unsigned)(((1ULL << p) + (unsigned long long)d - 1) / d), p - 32};
  }
  __device__ __forceinline__ int div(int i) const {
    return d == 1 ? i : (int)(__umulhi((unsigned)i, m) >> s);
  }
};

// stencil.cuh's DivIndex without a division: the coordinates of a voxel
// of a volume of fewer than 2^31 voxels by FastDiv.
struct FastIndex {
  FastDiv fx, fy;
  __device__ __forceinline__ int x(long long i) const {
    return (int)i - fx.div((int)i) * fx.d;
  }
  __device__ __forceinline__ int y(long long i) const {
    const int r = fx.div((int)i);
    return r - fy.div(r) * fy.d;
  }
  __device__ __forceinline__ Coord at(long long i) const {
    const int r = fx.div((int)i), z = fy.div(r);
    return Coord{(int)i - r * fx.d, r - z * fy.d, z};
  }
};

// stencil.cuh's BlockTeam for the team team() of a CUDA block of up to
// kMaxTeams teams of kThreads threads (the launch sequence's blocks run
// side by side): its thread, its own named barrier (1 + team()) and
// block_sum's tree over its kThreads threads (valid in tid() 0; a sync()
// between two calls).
struct GroupTeam {
  __device__ static int team() { return threadIdx.x / kThreads; }
  __device__ static int tid() { return threadIdx.x % kThreads; }
  __device__ static void sync() {
    asm volatile("bar.sync %0, %1;" ::"r"(1 + team()), "r"(kThreads) : "memory");
  }
  __device__ static double sum(double v) {
    __shared__ double warp_sums[kMaxTeams][kThreads / 32];
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    const int lane = threadIdx.x & 31, warp = tid() >> 5;
    if (lane == 0) warp_sums[team()][warp] = v;
    sync();
    if (warp == 0) {
      v = lane < kThreads / 32 ? warp_sums[team()][lane] : 0.0;
      for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    }
    return v;
  }
};

// The sum that reduce_kernel's one block of kReduceThreads threads forms
// of partials[0, nparts), nparts <= kReduceThreads (one partial a thread
// there: 0.0 + its partial, or 0.0), formed by this CUDA block (kThreads
// to kReduceThreads threads): each warp takes the reduce block's warps
// warp, warp + its block's warps, ..., their partials loaded at once,
// each summed with block_sum's shuffle tree; then warp 0 sums their sums
// as block_sum does. Valid in thread 0; every thread of the block calls
// it.
__device__ double reduce_sum(const double* partials, int nparts) {
  constexpr int kWarps = kReduceThreads / 32, kTurns = kReduceThreads / kThreads;
  __shared__ double warp_sums[kWarps];
  __syncthreads();  // a previous call's reads of warp_sums
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  double v[kTurns];
#pragma unroll
  for (int j = 0; j < kTurns; ++j) {
    const int vw = warp + j * nw, k = vw * 32 + lane;
    v[j] = vw < kWarps && k < nparts ? 0.0 + partials[k] : 0.0;
  }
#pragma unroll
  for (int j = 0; j < kTurns; ++j) {
    for (int off = 16; off > 0; off >>= 1) v[j] += __shfl_down_sync(0xffffffffu, v[j], off);
    if (lane == 0 && warp + j * nw < kWarps) warp_sums[warp + j * nw] = v[j];
  }
  __syncthreads();
  double s = 0.0;
  if (warp == 0) {
    s = warp_sums[lane];
    for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
  }
  return s;
}

// The CG's partial sums, alternating between two sets of kMaxBlocks so
// that a block still forming one set's sum never meets the next pass
// writing it, and the CG scalars each block keeps in its shared memory.
struct CgSums {
  double* partials;  // two sets of kMaxBlocks
  double* sc;        // this block's CG scalars (shared memory)
  int set = 0;       // the set the next reduced pass writes
  __device__ double* parts() const { return partials + set * kMaxBlocks; }
  // The one-block second stage of the pass that wrote parts() (its G
  // blocks), formed by this block into its own scalars; then the next set.
  // No barrier follows: every block forms it.
  __device__ void reduce(int G, int mode) {
    const double s = reduce_sum(parts(), G);
    set ^= 1;
    if (threadIdx.x == 0) update_scalars(sc, s, mode);
    __syncthreads();
  }
};

// What a team walks in a phase: the launch sequence's G blocks of a
// volume of d (stencil.cuh's BLOCK_STRIDE within each), from its first by
// its stride, the voxels' coordinates by idx.
struct Walk {
  int first, stride, G;
  Dims d;
  FastIndex idx;
};

// The grid barrier after a phase, and a traced solve's stamp of its end:
// (globaltimer ns, Phase) pairs by block 0, into at most cap.
struct Phases {
  cg::grid_group grid;
  long long* stamps;
  int cap;
  int n = 0;

  __device__ void stamp(int phase) {
    if (stamps == nullptr || blockIdx.x != 0 || threadIdx.x != 0 || n >= cap) return;
    long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    stamps[2 * n] = t;
    stamps[2 * n + 1] = phase;
    ++n;
  }

  __device__ void sync(int phase) {
    grid.sync();
    stamp(phase);
  }
};

// Nothing beside a chain's x pass.
struct NoBeside {
  __device__ void operator()(int) const {}
};

// One blur chain through t1, t2 (stencil.cuh's blur_chain) over the walk
// w: x pass, y pass, z pass into the epilogue, a barrier after each
// (phase, + 1, + 2); beside(vb) after each of the x pass's blocks.
// kX, kY, kZ: the taps' lengths at compile time, or 0.
template <int kX, int kY, int kZ, class Src, class Epi, class Beside = NoBeside>
__device__ void chain(const Walk& w, Phases& ph, int phase, const Src& src,
                      typename Src::Dir* dir_out, const Epi& epi, double* partials,
                      const Taps& tp, float* t1, float* t2, const Beside& beside = Beside{}) {
  for (int vb = w.first; vb < w.G; vb += w.stride) {
    conv_x_body<false, kX, GroupTeam>(src, t1, dir_out, tp.x, tp.kx, w.d, w.idx, vb, w.G);
    beside(vb);
  }
  ph.sync(phase);
  for (int vb = w.first; vb < w.G; vb += w.stride)
    conv_y_body<false, kY, GroupTeam>(t1, t2, tp.y, tp.ky, w.d, w.idx, vb, w.G);
  ph.sync(phase + 1);
  for (int vb = w.first; vb < w.G; vb += w.stride) {
    conv_z_body<false, false, kZ, GroupTeam>(t2, epi, partials, tp.z, tp.kz, w.d, 0, w.idx, vb,
                                             w.G);
    GroupTeam::sync();
  }
  ph.sync(phase + 2);
}

// admm_record's TV partials of x beside the records' x pass (chain's
// Beside).
struct RecordTv {
  const float* x;
  double* partials;
  Spacing sp;
  Dims d;
  FastIndex idx;
  int G;
  __device__ void operator()(int vb) const {
    record_tv_body<GroupTeam>(x, partials, sp, d, idx, vb, G);
    GroupTeam::sync();
  }
};

// Row t of the records (admm.cu's admm_record) of x over the walk w: the
// blur chain of x at the blur taps ta (lengths kX, kY, kZ at compile time,
// or 0) with the data epilogue (rho_C at C^2 = fs2 by loss), the TV beside
// its x pass, and block 0's second stage into reg[t] and data[t].
// rec_partials: the data partials, then at kMaxBlocks the TV partials.
template <int kX, int kY, int kZ>
__device__ void record_row(const Walk& w, Phases& ph, const float* x, const float* b, float fs2,
                           int loss, double* rec_partials, double* reg, double* data, int t,
                           const Taps& ta, float* t1, float* t2, Spacing sp) {
  chain<kX, kY, kZ>(w, ph, kRecordX, LoadT<float, float, false>{x}, nullptr,
                    DataEpiT<false>{b, fs2, loss}, rec_partials, ta, t1, t2,
                    RecordTv{x, rec_partials + kMaxBlocks, sp, w.d, w.idx, w.G});
  if (blockIdx.x != 0) return;
  const double tv = reduce_sum(rec_partials + kMaxBlocks, w.G);
  const double ds = reduce_sum(rec_partials, w.G);
  if (threadIdx.x == 0) {
    reg[t] = tv;
    data[t] = 0.5 * ds;
  }
}

// The entry clip of a batch as the first x pass's source: x0 clipped as
// tik_clip clips it, stored as x beside the pass (dir).
struct ClipSrc {
  using Dir = float;
  const float* x0;
  __device__ float operator()(long long k) const { return clip0(x0[k]); }
  __device__ float dir(long long k) const { return (*this)(k); }
};

// f(StoreT<...>{}) for the storage modes the persistent solves run:
// "exact" and "qf32" (stencil.cuh's with_storage, the two instances only).
template <class F>
cudaError_t with_solve_storage(int storage, F&& f) {
  if (storage == kStoreExact) return f(StoreT<float, float, float>{});
  if (storage == kStoreQf32) return f(StoreT<float, bf16, float>{});
  return cudaErrorInvalidValue;
}

// f(std::integral_constant<int, reg>{}) for the regulariser reg (a
// RegKind).
template <class F>
cudaError_t with_reg(int reg, F&& f) {
  if (reg == kRegLap) return f(std::integral_constant<int, kRegLap>{});
  if (reg == kRegIdentity) return f(std::integral_constant<int, kRegIdentity>{});
  return cudaErrorInvalidValue;
}

// The launch shape of a solve: the launch sequence's blocks a CUDA block
// runs side by side (teams), its threads, the blocks an SM holds, the grid.
struct Shape {
  int teams, threads, per_sm, grid;
};

// The shape of the kernel fn over `work` of the launch sequence's blocks
// a phase: the most teams (max_teams, halved) whose blocks still reach
// 7/8 of the SMs, and a grid of as many blocks as the card holds at once,
// capped at what the teams need. PERF.md has 1, 2 and 4 teams timed at
// 64^3 (1024 blocks: the rule takes 4) and on a 256^2 image (256 blocks:
// 2; 4 would leave half the SMs idle).
cudaError_t shape_of(const void* fn, long long work, Shape* out, int max_teams = kMaxTeams) {
  const int sms = device_sms();
  int teams = max_teams;
  while (teams > 1 && (work + teams - 1) / teams * 8 < sms * 7) teams /= 2;
  int per_sm = 0;
  const cudaError_t e =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, teams * kThreads, 0);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  const long long need = (work + teams - 1) / teams;
  *out = Shape{teams, teams * kThreads, per_sm,
               (int)((long long)per_sm * sms < need ? (long long)per_sm * sms : need)};
  return cudaSuccess;
}

// The bytes a batch's configurations side by side may hold, their x and
// their scratch (batch_width): inside the 50 MB L2, where side by side the
// Tikhonov batch ran faster than past it (chip_smoke.py phase 46,
// PERF.md).
constexpr long long kSideBySideBytes = 32LL << 20;

// The configurations of a batch of nconf, per_conf bytes each, that run
// side by side on a grid of `grid` blocks: as many as kSideBySideBytes
// holds, at least 1 and at most one a block, in turns of equal size.
int batch_width(int nconf, long long per_conf, int grid) {
  long long w = kSideBySideBytes / per_conf;
  if (w > grid) w = grid;
  if (w > nconf) w = nconf;
  if (w < 1) w = 1;
  const long long turns = (nconf + w - 1) / w;
  return (int)((nconf + turns - 1) / turns);
}

// The launch shape of the kernel fn over a batch of nconf configurations
// of per_conf bytes each at G of the sequence's blocks a volume, and the
// configurations it runs side by side (batch_width).
cudaError_t batch_shape(const void* fn, int nconf, long long per_conf, int G, Shape* sh,
                        int* width) {
  const int w = batch_width(nconf, per_conf, 1 << 30);
  const cudaError_t e = shape_of(fn, (long long)w * G, sh);
  *width = batch_width(nconf, per_conf, sh->grid);
  return e;
}

// f(walk, j, c) for each configuration c of a batch of nconf, `width` side
// by side in turns: in a turn of w, blocks [j nb / w, (j + 1) nb / w) of
// the grid's nb run configuration c0 + j on slot j, their teams walking
// the sequence's G blocks of a volume of d.
template <class F>
__device__ void side_by_side(int nconf, int width, int G, Dims d, FastIndex idx, F&& f) {
  const int teams = blockDim.x / kThreads, team = GroupTeam::team(), nb = gridDim.x;
  for (int c0 = 0; c0 < nconf; c0 += width) {
    const int w = min(width, nconf - c0);
    const int j = (int)(((long long)blockIdx.x + 1) * w - 1) / nb;
    const int b0 = (int)((long long)j * nb / w), b1 = (int)(((long long)j + 1) * nb / w);
    f(Walk{((int)blockIdx.x - b0) * teams + team, (b1 - b0) * teams, G, d, idx}, j, c0 + j);
  }
}

}  // namespace
