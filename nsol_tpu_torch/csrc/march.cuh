// The two one-pass marches of csrc/tiled.cu, shared by the kernel sources
// that instance them: the single-stencil march (stencil_zy_kernel) and the
// weighted march (weighted_zy_kernel), their geometry, their launchers, the
// rule that sizes their z tile and the rule that routes a whole-volume
// cg_step or weighted_apply to them.
//
// Design of the single-stencil march (normal_apply_zy, cg_step_zy,
// blur_apply_zy and the window unit). A block of 128 threads owns an
// output tile of kTileY rows x kTileX columns over up to kTileZ planes
// and marches through z; each thread owns a column strip of kStrip = 4
// outputs of the tile. For each input plane it copies the halo-extended
// (y, x) window into shared memory with cp.async, double-buffered (the
// next plane's copy is in flight while this one is computed; a third
// buffer gained nothing on the card): 16-byte
// copies wherever the volume's rows are 16-byte aligned (the window's x
// margin is rounded up to 16 bytes, and no 16-byte group straddles a wrap
// of x), so a bfloat16 window is copied as asynchronously as a float one
// and widened where the taps read it. Then, with two barriers a plane:
//   x taps over the window's rows into xt, four neighbouring outputs a
//     thread from K + 3 values read in 16-byte loads (each value read once
//     for four outputs, not once per tap);
//   y taps of the thread's strip, four outputs from K + 3 values of a
//     column of xt;
//   z taps from a ring of the strip's last K xy-blurred values held in
//     registers, and the epilogue.
// The taps are compile-time constants for the lengths the main paths run
// (13 normal and 7 blur taps an axis at sigma = 1); every other length
// takes the same march with runtime lengths, one shared-memory load per
// tap and the z ring in shared memory (each thread reading back only what
// it wrote). Each output's chain is unchanged: the same taps in the same
// order with fmaf, each axis rounded to float where the three-pass units
// round it, so the march equals them bit for bit. The raw centre tiles
// (with a one-voxel halo) ride in a second ring for the Laplacian, whose
// two global boundary rows per axis come from the voxel's coordinates
// (grad.py::gradient_normal), not from the wrapped window. The weighted
// unit has its own march of two stencils in one block (the note at
// weighted_zy_kernel): the first blurs pf onto the tile extended by the
// blur halo and multiplies by wts there, the second blurs that back to
// the centre, a plane behind.
//
// What bounds them on the H100. Bytes would bound normal_apply_zy at 512^3
// at 0.32 ms (v read once, q written once); the march takes about 1.2 ms
// there (PERF.md). It does about 60 multiply-adds and 30 shared-memory
// accesses an output, so instruction issue bounds it, spread over the x
// and y taps, the Laplacian (its raw ring and seven loads an output) and
// the copy, the two barriers a plane, the z ring and the stores; with a
// bfloat16 window the window's L2 traffic (2.6 times the output) weighs
// less. Registers (110-128 a thread: the z ring holds 52) leave four
// blocks, 16 warps, an SM; capping them for five blocks gained nothing,
// for six it spills. Each unit reads its inputs once from device memory
// up to its halo (z: (kTileZ + 2h) / kTileZ; y, x: the neighbouring
// tiles' halos mostly hit the 50 MB L2) and writes each output once; no
// intermediate volume reaches device memory. No wgmma, TMA or warp
// specialisation.
//
// Reductions are deterministic: one float64 partial per block (four for
// the sweep's dots), summed in a fixed order by stencil.cuh's
// reduce_kernel (sweep_reduce_kernel).
//
// The sweep's instance (kSrcSweep, cg_sweep_march_t) reads three windows,
// r, q and p, and forms r' = r - a q and p' = r' + beta p in them; it keeps
// r' of the tile's own planes in a third ring (the raw ring's depth) for
// the epilogue's r'.q', so its block holds about 72 KB at the 13 normal
// taps: three blocks an SM (kSweepResident), which its z tile counts.
//
// The z tile (march_tile_z, the one rule for every instance of both
// marches). A block re-reads a z halo of its tile, (tile + extra) / tile
// of its planes (extra 2 hd for the single-stencil march, 12 at the 13
// normal taps; 4 hz + 1 steps for the weighted one, 13 at 7 blur taps), so
// a long tile reads least; but a tile that leaves fewer blocks than the
// card holds at once (SMs x the resident blocks an SM: 4 of the
// single-stencil march, 2 of the weighted one) leaves SMs idle. The rule
// takes, of kMaxTile, kMaxTile / 2, ..., kMinTileZ planes, the tile with
// the least (waves of the grid) x (steps a block); ties keep the longer
// tile. 512^3 keeps its 128 / 256 planes (2048 / 1024 blocks, four
// waves); 256^3 takes 64 / 128 (512 / 256 blocks, one wave each).
//
// The whole-volume route (vol_route). The whole-volume cg_step, normal_apply,
// cg_sweep (admm.cu), weighted_apply, blur_apply and irls_head (robust.cu)
// take the march on a volume past the fused solves' fit (more than
// kMarchMinVoxels = 2^20 voxels, 16 volumes in 64 MiB; 2^19 for the
// lighter normal_apply, blur_apply and irls_head) deep enough that a block
// takes at most 2.5 steps a plane it writes (4 for normal_apply and
// irls_head: at sigma = 1, Z >= 8 for cg_step and cg_sweep, 9 for
// weighted_apply, 4 for normal_apply and blur_apply, 2 for irls_head)
// where a block's shared memory holds the
// taps (the runtime-length instance's size, as ops/cuda/tiled.py::
// route_fits measures it), and else the three passes of stencil.cuh.
// Timed by device time in turns on the H100 (chip_smoke.py phase 37,
// PERF.md): the march takes a third (cg_step) to two fifths
// (weighted_apply) of the chain's time at 256^3 and half of it on a
// 136 x 240 x 200 volume, but twice the chain's at 64^3 and on a 256^2
// image, whose passes sit in the 50 MB L2 while the march's few blocks
// (64 at 64^3) leave the card idle, and 1.1-3.5x the chain's on stacks
// of 2-4 planes (weighted: 2-8), which march 12 (13) halo steps beside
// their own planes. normal_apply, blur_apply and irls_head take a third
// to a half of the chain's time at 256^3 and win from 88^3 and on 4-plane
// stacks (irls_head from 2). The rule is fixed by the taps and the
// shape before any launch and does not fall back.

#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "stencil.cuh"

namespace {

constexpr int kTileY = 16;
constexpr int kTileX = 32;  // one warp across a tile row
constexpr int kTileZ = 128;  // the most planes a block marches through
constexpr int kMinTileZ = 8;  // the fewest (march_tile_z)
// the fewest voxels a whole-volume unit marches over (vol_route): past
// the fused solves' fit, 16 volumes in 64 MiB, for cg_step and
// weighted_apply; past 2^19 for normal_apply, blur_apply and irls_head,
// whose marches beat their chains from 88^3 (not at 80^3) on the H100
constexpr long long kMarchMinVoxels = 1LL << 20;
constexpr long long kLightMinVoxels = 1LL << 19;
constexpr int kMaxSmem = 232448;  // 227 KB, the most a block may use
// the raw centre tiles carry a one-voxel halo for the Laplacian
constexpr int kRawW = kTileX + 2;
constexpr int kRawN = (kTileY + 2) * kRawW;
constexpr int kOutN = kTileY * kTileX;

// A row width and its reciprocal for a division-free split of a linear
// index e < 2^32 / n into (e / n, e % n): e / n = umulhi(e, ceil(2^32 / n)).
struct Width {
  int n;
  unsigned m;
  __device__ __forceinline__ int row(int e) const { return (int)__umulhi((unsigned)e, m); }
};

__host__ __device__ constexpr Width width_of(int n) {
  return Width{n, (unsigned)((0x100000000ull + (unsigned long long)n - 1) / (unsigned)n)};
}

__device__ __forceinline__ int wrap_index(int i, int n) {
  i %= n;
  return i < 0 ? i + n : i;
}

// The ring slot n steps behind slot (n <= depth): ring slots advance by
// one a step, so no step divides.
__device__ __forceinline__ int slot_back(int slot, int n, int depth) {
  const int s = slot - n;
  return s < 0 ? s + depth : s;
}

__device__ __forceinline__ int slot_next(int slot, int depth) {
  return slot + 1 == depth ? 0 : slot + 1;
}

__device__ __forceinline__ int thread_rank() { return threadIdx.y * blockDim.x + threadIdx.x; }

// Sum of one double per thread over a (kTileX, rows) block in a fixed
// order; valid in thread (0, 0).
__device__ double tile_sum(double v) {
  __shared__ double row_sums[32];
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  if (threadIdx.x == 0) row_sums[threadIdx.y] = v;
  __syncthreads();
  if (threadIdx.y == 0) {
    v = threadIdx.x < blockDim.y ? row_sums[threadIdx.x] : 0.0;
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

__device__ __forceinline__ int block_index() {
  return blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
}

// sum_ax (1/h_ax^2) D_ax^T D_ax u at the centre voxel o of three raw tiles
// (planes z - 1, z, z + 1; rows of rw values); the zero boundary comes from the coordinates
// c, as stencil.cuh's lap_axis has it. Its roundings are stencil.cuh's
// laplacian's, written out with the same intrinsics in the same order
// (ih2z az + (ih2x ax + ih2y ay), both sums fused), so that no choice of
// the compiler's contraction sets the two apart.
__device__ __forceinline__ float ring_laplacian(const float* zm, const float* zc, const float* zp,
                                                int o, Coord c, Spacing sp, Dims d,
                                                int rw = kRawW) {
  const float u = zc[o];
  const auto axis = [u](float lo_v, float hi_v, int coord, int n) {
    const float lo = coord > 0 ? __fsub_rn(u, lo_v) : 0.f;
    const float hi = __fsub_rn(u, coord + 1 < n ? hi_v : 0.f);
    return __fadd_rn(lo, hi);
  };
  const float ax = axis(zc[o - 1], zc[o + 1], c.x, d.X);
  const float ay = axis(zc[o - rw], zc[o + rw], c.y, d.Y);
  const float az = axis(zm[o], zp[o], c.z, d.Z);
  return __fmaf_rn(sp.ih2z, az, __fmaf_rn(sp.ih2x, ax, __fmul_rn(sp.ih2y, ay)));
}

// ---------------------------------------------------------------- march --

// How a window of the inputs becomes the convolved plane and the Laplacian's
// source: one volume for both; the CG direction p' = r + beta p for both
// (written out on the tile's own planes); a second volume u for the
// Laplacian; or the sweep's direction p' = (r - a q) + beta p for both,
// with r' = r - a q and x += a p on the tile's own planes.
enum SrcKind { kSrcOne = 0, kSrcDirection = 1, kSrcTwo = 2, kSrcSweep = 3 };

// In: the storage of in0 (a single-input unit may read bfloat16), As the
// precision it is read at; P: the storage of in1, the CG direction's (p
// and p', float or bfloat16) or float u, and of the sweep's q, p (in1,
// in2), r' and p'. A window unit (the sharded path's) reads d.Z + 2 hd
// planes of in0 with no z wrap, and its Laplacian takes the global rows
// row0 + z of a volume of z_total rows.
template <class In = float, class As = In, class P = float>
struct StencilArgs {
  const In* in0;  // v, r, y or x
  const P* in1;   // p (kSrcDirection), q (kSrcSweep; neither on the first
                  // trip) or u (kSrcTwo)
  P* dir_out;     // p' (kSrcDirection, kSrcSweep)
  const double* scal;
  int first;
  Taps tp;
  Spacing sp;
  Dims d;
  double* partials;
  int row0, z_total;       // window units only
  const P* in2 = nullptr;  // p (kSrcSweep, not on the first trip)
  P* res_out = nullptr;    // r' (kSrcSweep)
  float* x = nullptr;      // x += a p in place (kSrcSweep)
};

// The sweep's four dots, summed per thread and per block in a fixed order:
// g = r'.r', pq = p'.q', rq = r'.q', qq = q'.q'.
struct Dots4 {
  double v[4];
};

__device__ __forceinline__ Dots4& operator+=(Dots4& a, const Dots4& b) {
#pragma unroll
  for (int k = 0; k < 4; ++k) a.v[k] += b.v[k];
  return a;
}

// A thread owns a column strip of kStrip outputs of the tile: blockDim is
// (kTileX, kTileY / kStrip).
constexpr int kStrip = 4;
constexpr int kStencilRows = kTileY / kStrip;
constexpr int kStencilThreads = kTileX * kStencilRows;
// blocks an SM holds at once (the launch bound: registers, PERF.md); the
// sweep's instance: shared memory (three windows and the r' ring)
constexpr int kStencilResident = 4;
constexpr int kSweepResident = 3;

template <int kSrc>
__host__ __device__ constexpr int stencil_resident() {
  return kSrc == kSrcSweep ? kSweepResident : kStencilResident;
}
// The window's x margin: the x halo rounded up to 16 bytes of the input,
// so that its rows start on 16-byte boundaries of the volume: 8 values for
// a single-input unit (which may read bfloat16) and for two inputs of
// which one is bfloat16 (two_byte: a cg_step of a compact storage), 4 for
// two float ones.
__host__ __device__ constexpr int align_x(int nin, bool two_byte = false) {
  return nin == 1 || two_byte ? 8 : 4;
}

__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }
__host__ __device__ constexpr int halo_of(int k) { return k / 2 > 1 ? k / 2 : 1; }

struct StencilGeo {
  int hy, hd;      // y and z halos (>= 1)
  int ax;          // the window's x margin
  int wy, wx;      // window rows kTileY + 2 hy and columns kTileX + 2 ax
  int ring_raw;    // planes of the Laplacian's raw ring, hd + 2
  int ring_z;      // slots of the z ring of runtime-length taps, 2 hd + 1
  int nin;         // input windows
  int ty, tx, tab;  // offsets (words) of the y and x taps (z at 0) and the tables
  int win;         // offset (words) of the windows
  int tz;          // planes a block marches through (march_tile_z)
  __host__ __device__ int win_n() const { return wy * wx; }
};

inline StencilGeo stencil_geo(Taps tp, int nin, bool two_byte = false) {
  StencilGeo g;
  g.hy = halo_of(tp.ky);
  g.hd = halo_of(tp.kz);
  g.ax = round_up(halo_of(tp.kx), align_x(nin, two_byte));
  g.wy = kTileY + 2 * g.hy;
  g.wx = kTileX + 2 * g.ax;
  g.ring_raw = g.hd + 2;
  g.ring_z = 2 * g.hd + 1;
  g.nin = nin;
  g.ty = round_up(tp.kz, 4);
  g.tx = g.ty + round_up(tp.ky, 4);
  g.tab = g.tx + round_up(tp.kx, 4);
  g.win = g.tab + round_up(g.wy + g.wx, 4);
  g.tz = kTileZ;
  return g;
}

// Taps (each axis 16-byte aligned), the row and column tables, the windows
// [2][nin][wy x wx], the x-blurred rows (wy x kTileX), the raw ring (lap),
// the z ring (runtime-length taps, ring_z) and the sweep's r' ring (res:
// the tile's own values, as deep as the raw ring).
inline size_t stencil_smem(const StencilGeo& g, bool lap, bool ring_z, bool res = false) {
  const size_t words = (size_t)g.win + 2 * (size_t)g.nin * g.win_n() + (size_t)g.wy * kTileX +
                       (lap ? (size_t)g.ring_raw * kRawN : 0) +
                       (ring_z ? (size_t)g.ring_z * kOutN : 0) +
                       (res ? (size_t)g.ring_raw * kOutN : 0);
  return words * 4;
}

// One window plane's copy. Where the volume's rows are 16-byte aligned (X
// a multiple of V = 16 / sizeof(T) values and the volume 16-byte aligned)
// it goes in 16-byte cp.async, V columns each: x0 and the window's margin
// are multiples of V, and so are the wrap points of x, so no group of V
// window columns straddles a wrap, not even on an edge tile or where X is
// narrower than the window. Otherwise one element at a time.
struct CopyPlan {
  int n;  // copies a window row
  Width w;
  bool vec;
};

template <class T>
__device__ CopyPlan copy_plan(const T* src, int wx, int X, bool aligned = true) {
  constexpr int V = 16 / (int)sizeof(T);
  const bool vec =
      aligned && X % V == 0 && (reinterpret_cast<unsigned long long>(src) & 15) == 0;
  const int n = vec ? wx / V : wx;
  return CopyPlan{n, width_of(n), vec};
}

// Start the copy of one plane's (wy x wx) window into dst. A bfloat16
// element has no 2-byte cp.async: where the rows are not aligned, each is
// loaded and stored at once.
template <class T>
__device__ __forceinline__ void copy_plane(T* dst, const T* __restrict__ plane, const int* rows,
                                           const int* cols, const CopyPlan& p, int wy, int wx) {
  constexpr int V = 16 / (int)sizeof(T);
  const int nt = blockDim.x * blockDim.y;
  for (int e = thread_rank(); e < wy * p.n; e += nt) {
    const int r = p.w.row(e);
    const int c = (e - r * p.n) * (p.vec ? V : 1);
    if (p.vec)
      __pipeline_memcpy_async(dst + r * wx + c, plane + rows[r] + cols[c], 16);
    else if constexpr (sizeof(T) == 4)
      __pipeline_memcpy_async(dst + r * wx + c, plane + rows[r] + cols[c], 4);
    else
      dst[r * wx + c] = plane[rows[r] + cols[c]];
  }
}

// Four neighbouring window values from a 16-byte (float) or 8-byte
// (bfloat16) aligned address, read at As's precision.
template <class As>
__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  v[0] = round_as<As>(f.x), v[1] = round_as<As>(f.y), v[2] = round_as<As>(f.z),
  v[3] = round_as<As>(f.w);
}

template <class As>
__device__ __forceinline__ void load4(const bf16* p, float* v) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(u.x << 16), v[1] = __uint_as_float(u.x & 0xffff0000u);
  v[2] = __uint_as_float(u.y << 16), v[3] = __uint_as_float(u.y & 0xffff0000u);
}

// K taps from a 16-byte aligned buffer (padded to a multiple of 4) into
// registers.
template <int K>
__device__ __forceinline__ void load_taps(const float* t, float (&k)[K]) {
#pragma unroll
  for (int q = 0; q < (K + 3) / 4; ++q) {
    const float4 f = reinterpret_cast<const float4*>(t)[q];
    const float f4[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
    for (int m = 0; m < 4; ++m)
      if (4 * q + m < K) k[4 * q + m] = f4[m];
  }
}

// The march. Step k copies input plane k + 1 of the block's z range (z0 -
// hd + k + 1, wrapped; a window unit's plane z0 + k + 1) into window
// buffer (k + 1) & 1 while plane k's is computed; forms the x taps of the
// window's rows into xt (and the Laplacian's raw tile, and p' on the
// tile's own planes);
// then each thread takes the y taps of its column strip, pushes the
// xy-blurred values into its z ring and, hd steps on, forms the z taps of
// output plane z0 + k - 2 hd and hands each value to the epilogue:
// epi(i, conv, lap, centre) returns a term of the block's reduction (the
// Laplacian and the centre value of its source are 0 when kLap is false).
// kK > 0: every axis has kK taps, known to the compiler (a strip of four x
// outputs from 16-byte window loads, the y taps of a strip from K + 3
// loads, the z ring in registers); kK = 0: the taps' runtime lengths (one
// load per tap, the z ring in shared memory). The taps and their order are
// the same: each output's chain is the three-pass units' chain. The
// direction (kSrcDirection) is p' = r + beta p rounded to P (stencil.cuh's
// DirectionT: product and sum rounded apart for bfloat16), formed from r
// read as In and p as P; it is what the taps convolve, the Laplacian's
// source and what is written out. The sweep's (kSrcSweep) is admm.cu's
// SweepDir: r' = r - a q, then p' = r' + beta p rounded to P, from r, q, p
// read as P; on the tile's own planes it also writes r' (as P), x += a p
// (the old p) and keeps r' in the r' ring, whose value at the output voxel
// its epilogue takes as a fifth argument, and it sums g = r'.r' there into
// the first of its four dots (Dots4), the epilogue's three the others.
template <int kK, int kSrc, bool kLap, bool kWindow, class In, class As, class P, class Epi>
__global__ void __launch_bounds__(kStencilThreads,
                                  kSrc == kSrcSweep ? kSweepResident : kStencilResident)
    stencil_zy_kernel(StencilArgs<In, As, P> a, StencilGeo g, Epi epi) {
  static_assert(kSrc != kSrcTwo || (sizeof(In) == 4 && sizeof(P) == 4),
                "the two-volume form is float");
  static_assert(kSrc != kSrcSweep || std::is_same<In, P>::value,
                "the sweep stores r, q, p alike");
  constexpr bool kSweep = kSrc == kSrcSweep;
  constexpr bool kDirected = kSrc == kSrcDirection || kSweep;  // p' formed and written
  constexpr bool kTwoByte = kSrc != kSrcOne && (sizeof(In) == 2 || sizeof(P) == 2);
  constexpr int kAx = align_x(kSrc == kSrcOne ? 1 : 2, kTwoByte);
  using Acc = typename std::conditional<kSweep, Dots4, double>::type;
  extern __shared__ __align__(16) float smem[];
  const Dims d = a.d;
  const int kz = kK ? kK : a.tp.kz, ky = kK ? kK : a.tp.ky, kx = kK ? kK : a.tp.kx;
  const int ax = kK ? round_up(halo_of(kK), kAx) : g.ax;
  const int hy = kK ? halo_of(kK) : g.hy, hd = kK ? halo_of(kK) : g.hd;
  const int wn = g.win_n(), nt = kStencilThreads, tid = thread_rank();
  float* tz = smem;
  float* ty = smem + g.ty;
  float* tx = smem + g.tx;
  int* rows = reinterpret_cast<int*>(smem + g.tab);
  int* cols = rows + g.wy;
  float* win = smem + g.win;                 // [2][nin][wn]: in0 as In, in1 as P
  float* xt = win + 2 * g.nin * wn;          // x taps of the window rows, wy x kTileX
  float* ring_raw = xt + g.wy * kTileX;      // Laplacian source, halo 1
  float* ring_z = ring_raw + (kLap ? g.ring_raw * kRawN : 0);  // runtime taps only
  float* ring_r = ring_z + (kK ? 0 : g.ring_z * kOutN);        // r' (kSrcSweep)
  const int x0 = blockIdx.x * kTileX, y0 = blockIdx.y * kTileY, z0 = blockIdx.z * g.tz;
  const int nz = min(g.tz, d.Z - z0);
  const int np = nz + 2 * hd;
  const bool dir = kDirected && !a.first;
  const bool has_in1 = kSrc == kSrcTwo || dir;
  const float beta = dir ? (float)a.scal[kBeta] : 0.f;
  const float alpha = kSweep && dir ? (float)a.scal[kA] : 0.f;
  for (int i = tid; i < kz; i += nt) tz[i] = a.tp.z[i];
  for (int i = tid; i < ky; i += nt) ty[i] = a.tp.y[i];
  for (int i = tid; i < kx; i += nt) tx[i] = a.tp.x[i];
  for (int i = tid; i < g.wy; i += nt) rows[i] = wrap_index(y0 - hy + i, d.Y) * d.X;
  for (int i = tid; i < g.wx; i += nt) cols[i] = wrap_index(x0 - ax + i, d.X);
  const CopyPlan plan0 = copy_plan(a.in0, g.wx, d.X);
  const CopyPlan plan1 = copy_plan(a.in1, g.wx, d.X);
  const CopyPlan plan2 = copy_plan(a.in2, g.wx, d.X);
  __syncthreads();

  auto start_copy = [&](int k) {
    const int pz = kWindow ? z0 + k : wrap_index(z0 - hd + k, d.Z);
    const long long off = (long long)pz * d.plane();
    float* dst = win + (k & 1) * g.nin * wn;
    copy_plane(reinterpret_cast<In*>(dst), a.in0 + off, rows, cols, plan0, g.wy, g.wx);
    if (has_in1)
      copy_plane(reinterpret_cast<P*>(dst + wn), a.in1 + off, rows, cols, plan1, g.wy, g.wx);
    if (kSweep && dir)
      copy_plane(reinterpret_cast<P*>(dst + 2 * wn), a.in2 + off, rows, cols, plan2, g.wy, g.wx);
  };

  // the thread's column strip: outputs (y0 + kStrip s + m, x0 + c)
  const int c = threadIdx.x, s = threadIdx.y;
  constexpr int kD = kK ? kK + halo_of(kK) - kK / 2 : 1;  // z ring depth in registers
  float zr[kStrip][kD];                                   // zr[m][t]: step k - t
  Acc acc{};
  start_copy(0);
  __pipeline_commit();
  // kr, kq: the slots of step k in the raw and the z ring
  for (int k = 0, kr = 0, kq = 0; k < np;
       ++k, kr = slot_next(kr, g.ring_raw), kq = slot_next(kq, g.ring_z)) {
    if (k + 1 < np) start_copy(k + 1);
    __pipeline_commit();
    __pipeline_wait_prior(1);
    __syncthreads();
    const In* w0 = reinterpret_cast<const In*>(win + (k & 1) * g.nin * wn);
    const P* w1 = reinterpret_cast<const P*>(win + (k & 1) * g.nin * wn + wn);
    const P* w2 = reinterpret_cast<const P*>(win + (k & 1) * g.nin * wn + 2 * wn);
    // the sweep's r' = r - a q (r on the first trip), unrounded
    const auto res_src = [&](int e) {
      const float v = to_float(w0[e]);
      return dir ? axpy_as<P>(-alpha, to_float(w1[e]), v) : v;
    };
    // the value the x taps convolve (p' = r + beta p rounded to P, where
    // a direction is formed; the sweep's p' = r' + beta p), and the
    // Laplacian's source
    const auto conv_src = [&](int e) {
      if (kSweep) return round_as<P>(dir ? axpy_as<P>(beta, to_float(w2[e]), res_src(e))
                                         : res_src(e));
      const float v = round_as<As>(to_float(w0[e]));
      if (kSrc != kSrcDirection) return v;
      return round_as<P>(dir ? axpy_as<P>(beta, to_float(w1[e]), v) : v);
    };
    const auto lap_src = [&](int e) {
      return kSrc == kSrcTwo ? to_float(w1[e]) : conv_src(e);
    };
    // x taps: xt[r][c] = sum_j kx[j] window[r][c + ax + kx/2 - j]
    if constexpr (kK > 0) {
      constexpr int K = kK, AX = round_up(halo_of(K), kAx);
      // a strip's K + 3 values start at window column c0 + 4 F0 + O
      constexpr int OFF = AX + K / 2 - (K - 1), F0 = OFF / 4, O = OFF % 4;
      constexpr int NF = (O + K + 3 + 3) / 4;
      float kxr[K];
      load_taps<K>(tx, kxr);
      for (int e = tid; e < g.wy * (kTileX / 4); e += nt) {
        const int r = e / (kTileX / 4), c0 = (e % (kTileX / 4)) * 4;
        const int base = r * g.wx + c0 + 4 * F0;
        float v[4 * NF];
#pragma unroll
        for (int f = 0; f < NF; ++f) {
          load4<As>(w0 + base + 4 * f, v + 4 * f);
          if (kSrc == kSrcDirection && dir) {
            float p[4];
            load4<P>(w1 + base + 4 * f, p);
#pragma unroll
            for (int t = 0; t < 4; ++t) v[4 * f + t] = axpy_as<P>(beta, p[t], v[4 * f + t]);
          }
          if (kSweep && dir) {
            float q[4], p[4];
            load4<P>(w1 + base + 4 * f, q);
            load4<P>(w2 + base + 4 * f, p);
#pragma unroll
            for (int t = 0; t < 4; ++t)
              v[4 * f + t] = axpy_as<P>(beta, p[t], axpy_as<P>(-alpha, q[t], v[4 * f + t]));
          }
          if (kDirected && sizeof(P) == 2) {
#pragma unroll
            for (int t = 0; t < 4; ++t) v[4 * f + t] = round_as<P>(v[4 * f + t]);
          }
        }
        float o[4];
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          float sum = 0.f;
#pragma unroll
          for (int j = 0; j < K; ++j) sum = fmaf(kxr[j], v[O + m + K - 1 - j], sum);
          o[m] = sum;
        }
        *reinterpret_cast<float4*>(xt + r * kTileX + c0) = make_float4(o[0], o[1], o[2], o[3]);
      }
    } else {
      for (int e = tid; e < g.wy * kTileX; e += nt) {
        const int r = e / kTileX, cc = e % kTileX;
        const int base = r * g.wx + cc + ax + kx / 2;
        float sum = 0.f;
        for (int j = 0; j < kx; ++j) sum = fmaf(tx[j], conv_src(base - j), sum);
        xt[e] = sum;
      }
    }
    if (kLap) {
      float* raw = ring_raw + kr * kRawN;
      for (int e = tid; e < kRawN; e += nt) {
        const int r = e / kRawW, cc = e % kRawW;
        raw[e] = lap_src((r - 1 + hy) * g.wx + cc - 1 + ax);
      }
    }
    if (kDirected && k >= hd && k < hd + nz) {  // p' on the block's own planes
      const long long pz = z0 - hd + k;
      for (int e = tid; e < kOutN; e += nt) {
        const int oy = e / kTileX, ox = e % kTileX, y = y0 + oy, x = x0 + ox;
        if (y >= d.Y || x >= d.X) continue;
        const int we = (oy + hy) * g.wx + ox + ax;
        const long long i = pz * d.plane() + (long long)y * d.X + x;
        if constexpr (kSweep) {  // r', the old p's x += a p, g
          const float rn = res_src(we);
          if (dir) a.x[i] = __fmaf_rn(alpha, to_float(w2[we]), a.x[i]);
          a.res_out[i] = store_as<P>(rn);
          ring_r[kr * kOutN + e] = rn;
          acc.v[0] += (double)rn * rn;
        }
        a.dir_out[i] = store_as<P>(conv_src(we));
      }
    }
    __syncthreads();
    // y taps of the strip: xy[m] = sum_j ky[j] xt[kStrip s + m + hy + ky/2 - j][c]
    float xy[kStrip];
    if constexpr (kK > 0) {
      constexpr int K = kK, OY = halo_of(K) + K / 2 - (K - 1);
      float kyr[K], col[K + kStrip - 1];
      load_taps<K>(ty, kyr);
#pragma unroll
      for (int t = 0; t < K + kStrip - 1; ++t) col[t] = xt[(kStrip * s + OY + t) * kTileX + c];
#pragma unroll
      for (int m = 0; m < kStrip; ++m) {
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < K; ++j) sum = fmaf(kyr[j], col[m + K - 1 - j], sum);
        xy[m] = sum;
      }
    } else {
      for (int m = 0; m < kStrip; ++m) {
        const int base = (kStrip * s + m + hy + ky / 2) * kTileX + c;
        float sum = 0.f;
        for (int j = 0; j < ky; ++j) sum = fmaf(ty[j], xt[base - j * kTileX], sum);
        xy[m] = sum;
      }
    }
    // into the z ring (in registers, shifted by one a step: a ring whose
    // slot turned with k took longer on the card)
    if constexpr (kK > 0) {
#pragma unroll
      for (int m = 0; m < kStrip; ++m) {
#pragma unroll
        for (int t = kD - 1; t > 0; --t) zr[m][t] = zr[m][t - 1];
        zr[m][0] = xy[m];
      }
    } else {
      for (int m = 0; m < kStrip; ++m) ring_z[kq * kOutN + (kStrip * s + m) * kTileX + c] = xy[m];
    }
    if (k < 2 * hd) continue;
    // output plane z, whose z neighbourhood is in the ring: z taps,
    // conv = sum_j kz[j] xy(z + kz/2 - j), xy(step k - t) at t = hd - kz/2 + j
    const int z = z0 + k - 2 * hd;
    const float* zm = ring_raw + slot_back(kr, hd + 1, g.ring_raw) * kRawN;
    const float* zc = ring_raw + slot_back(kr, hd, g.ring_raw) * kRawN;
    const float* zp = ring_raw + slot_back(kr, hd - 1, g.ring_raw) * kRawN;
    float kzr[kK ? kK : 1];
    if constexpr (kK > 0) load_taps<kK>(tz, kzr);
#pragma unroll
    for (int m = 0; m < kStrip; ++m) {
      float conv = 0.f;
      if constexpr (kK > 0) {
#pragma unroll
        for (int j = 0; j < kK; ++j) conv = fmaf(kzr[j], zr[m][halo_of(kK) - kK / 2 + j], conv);
      } else {
        const int e = (kStrip * s + m) * kTileX + c;
        for (int j = 0; j < kz; ++j)
          conv = fmaf(tz[j], ring_z[slot_back(kq, hd - kz / 2 + j, g.ring_z) * kOutN + e], conv);
      }
      const int oy = kStrip * s + m;
      const Coord cd{x0 + c, y0 + oy, kWindow ? a.row0 + z : z};
      if (cd.y >= d.Y || cd.x >= d.X) continue;
      float lap = 0.f, centre = 0.f;
      if (kLap) {
        const int o = (oy + 1) * kRawW + c + 1;
        lap = ring_laplacian(zm, zc, zp, o, cd, a.sp,
                             Dims{kWindow ? a.z_total : d.Z, d.Y, d.X});
        centre = zc[o];
      }
      const long long i = (long long)z * d.plane() + (long long)cd.y * d.X + cd.x;
      if constexpr (kSweep)
        acc += epi(i, conv, lap, centre,
                   ring_r[slot_back(kr, hd, g.ring_raw) * kOutN + oy * kTileX + c]);
      else
        acc += epi(i, conv, lap, centre);
    }
  }
  if (a.partials == nullptr) return;
  if constexpr (kSweep) {  // partials[k * blocks + block], k = g, pq, rq, qq
    const int nb = (int)(gridDim.x * gridDim.y * gridDim.z);
    for (int q = 0; q < 4; ++q) {
      const double sum = tile_sum(acc.v[q]);
      if (tid == 0) a.partials[q * nb + block_index()] = sum;
      __syncthreads();
    }
  } else {
    const double sum = tile_sum(acc);
    if (tid == 0) a.partials[block_index()] = sum;
  }
}

// ------------------------------------------------------------ the grid --

// The z tile of a march (the note at the top): of max_tile, max_tile / 2,
// ..., kMinTileZ planes, the tile with the least (waves of its grid) x
// (steps a block), a wave being the blocks the card holds at once (sms x
// resident) and a block taking min(tile, Z) + extra steps; ties keep the
// longer tile. ops/cuda/tiled.py::tile_z mirrors it.
inline int march_tile_z(Dims d, int max_tile, int extra, int resident, int sms) {
  const long long cols =
      (long long)((d.X + kTileX - 1) / kTileX) * ((d.Y + kTileY - 1) / kTileY);
  const long long slots = (long long)(sms > 0 ? sms : 1) * resident;
  int best = max_tile;
  long long best_cost = -1;
  for (int tz = max_tile; tz >= kMinTileZ; tz /= 2) {
    const long long blocks = cols * ((d.Z + tz - 1) / tz);
    const long long cost = (blocks + slots - 1) / slots * ((tz < d.Z ? tz : d.Z) + extra);
    if (best_cost < 0 || cost < best_cost) best = tz, best_cost = cost;
  }
  return best;
}

struct MarchGrid {
  dim3 grid;
  int tz;  // planes a block marches through
  int blocks() const { return (int)(grid.x * grid.y * grid.z); }
};

inline MarchGrid march_grid(Dims d, int max_tile, int extra, int resident) {
  const int tz = march_tile_z(d, max_tile, extra, resident, device_sms());
  return MarchGrid{dim3((d.X + kTileX - 1) / kTileX, (d.Y + kTileY - 1) / kTileY,
                        (d.Z + tz - 1) / tz),
                   tz};
}

// The most blocks a grid of either march takes at d (its shortest tile):
// the partials a unit's reduction may need.
inline int march_max_blocks(Dims d) {
  return ((d.X + kTileX - 1) / kTileX) * ((d.Y + kTileY - 1) / kTileY) *
         ((d.Z + kMinTileZ - 1) / kMinTileZ);
}

// The steps of z halo a block of the single-stencil march (2 hd) or of the
// weighted one (4 hz + 1) takes at the z taps kz, beside its own planes.
inline int march_halo_steps(int kz, bool weighted) {
  return weighted ? 4 * halo_of(kz) + 1 : 2 * halo_of(kz);
}

// The single-stencil march's grid at the taps tp, for an instance that
// holds `resident` blocks an SM (the sweep's: kSweepResident).
inline MarchGrid stencil_grid(Dims d, Taps tp, int resident = kStencilResident) {
  return march_grid(d, kTileZ, march_halo_steps(tp.kz, false), resident);
}

template <int kK, int kSrc, bool kLap, bool kWindow, class In, class As, class P, class Epi>
cudaError_t launch_march(const StencilArgs<In, As, P>& a, StencilGeo g, Epi epi,
                         cudaStream_t s) {
  const size_t smem = stencil_smem(g, kLap, kK == 0, kSrc == kSrcSweep);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = stencil_zy_kernel<kK, kSrc, kLap, kWindow, In, As, P, Epi>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  const MarchGrid mg = stencil_grid(a.d, a.tp, stencil_resident<kSrc>());
  g.tz = mg.tz;
  kernel<<<mg.grid, dim3(kTileX, kStencilRows), smem, s>>>(a, g, epi);
  return cudaGetLastError();
}

// The taps of a unit at sigma = 1 (alpha_cut 3): 13 normal taps an axis, 7
// blur taps. Those lengths on every axis take the march's instance with
// compile-time taps, every other length its runtime-length instance.
constexpr int kNormalK = 13;
constexpr int kBlurK = 7;

template <int kKc, int kSrc, bool kLap, bool kWindow = false, class In, class As, class P,
          class Epi>
cudaError_t launch_stencil(const StencilArgs<In, As, P>& a, int nin, Epi epi, cudaStream_t s) {
  const StencilGeo g =
      stencil_geo(a.tp, nin, kSrc != kSrcOne && (sizeof(In) == 2 || sizeof(P) == 2));
  if (a.tp.kz == kKc && a.tp.ky == kKc && a.tp.kx == kKc)
    return launch_march<kKc, kSrc, kLap, kWindow>(a, g, epi, s);
  return launch_march<0, kSrc, kLap, kWindow>(a, g, epi, s);
}

// ------------------------------------------------------------- weighted --

// The weighted march: a block of 256 threads, blockDim (kTileX,
// kWeightedRows); in the second stage each thread owns kWStrip outputs of
// a column of the tile.
constexpr int kWeightedThreads = 256;
constexpr int kWeightedRows = kWeightedThreads / kTileX;
constexpr int kWStrip = kTileY / kWeightedRows;
// the most planes a block marches through: twice the other units' kTileZ,
// which cuts the two-stage z halo's share of the steps (4 hz + 1 of them a
// block)
constexpr int kWeightedTileZ = 2 * kTileZ;
// blocks an SM holds at once (the launch bound: registers and the fixed
// instance's shared memory)
constexpr int kWeightedResident = 2;

// The weighted march's grid at the blur taps tp: 4 hz + 1 steps of z halo
// a block.
inline MarchGrid weighted_grid(Dims d, Taps tp) {
  return march_grid(d, kWeightedTileZ, march_halo_steps(tp.kz, true), kWeightedResident);
}

// The march's storage: the whole-volume unit (r float, p and p' as S::P,
// the weights float read at S::W, q float) or a z-window (v, the weights
// and out as T, no direction and no mask).
template <bool kWindow, class S, class T>
struct WeightedIo {
  using V = typename std::conditional<kWindow, T, float>::type;       // r or v
  using P = typename S::P;                                            // p, p'
  using WT = typename std::conditional<kWindow, T, float>::type;      // weights as stored
  using W = typename std::conditional<kWindow, T, typename S::W>::type;  // read at
  using O = typename std::conditional<kWindow, T, float>::type;       // q or out
};

// The thread's 16-byte groups of a (wy x wx) window of T (16 / sizeof(T)
// values a group), at most two a thread, found once a launch: (source
// offset in a plane, window offset); a source offset of -1 marks none.
struct CopyGroups {
  int src[2], dst[2];
};

template <class T>
__device__ CopyGroups copy_groups(const int* rows, const int* cols, int wy, int wx) {
  constexpr int V = 16 / (int)sizeof(T);
  const int nq = wx / V;
  CopyGroups q;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int e = thread_rank() + i * kWeightedThreads, r = e / nq, c = (e - r * nq) * V;
    q.src[i] = r < wy ? rows[r] + cols[c] : -1;
    q.dst[i] = r * wx + c;
  }
  return q;
}

template <class T>
__device__ __forceinline__ void copy_groups_async(T* dst, const T* plane, const CopyGroups& q) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
    if (q.src[i] >= 0) __pipeline_memcpy_async(dst + q.dst[i], plane + q.src[i], 16);
}

// A window's r, wts and q point at its first centre plane (plane 0 of the
// march); its planes -2 hz .. Zl + 2 hz - 1 lie in the window.
template <class V, class P, class WT, class O>
struct WeightedArgs {
  const V* r;
  const P* p;  // not on the first trip
  const float* free;
  const WT* wts;
  P* p_new;
  O* q;
  const double* scal;
  int first;
  float rho;
  Taps tp;
  Spacing sp;
  Dims d;
  double* partials;
  int row0, z_total;  // window only
};

// The two-stage halo of the weighted march, by instance. The compile-time
// instance ("fixed") rounds the extended tile's x margin to 4 and its width
// to whole 4-column groups, and the input windows' x margin to 16 bytes of
// a bfloat16 row (so that every copy goes in 16-byte groups that straddle
// no wrap of x); it double-buffers the input windows two planes ahead and
// holds the weights' window. The runtime-length instance keeps the plain
// margins, copies element by element into one buffer a plane ahead and
// reads the weights from device memory, so that it holds every stencil the
// older kernel of two shared-memory marches held.
struct WeightedGeo {
  int hy, hx, hz;      // blur halos (>= 1)
  int axw, axe, axq;   // x margins of the input window, the extended tile, the weights
  int wy, wx;          // input window: kTileY + 4 hy rows
  int ey, ex;          // extended tile: kTileY + 2 hy rows
  int qx;              // weights window columns (ey rows; 0: none)
  int d1, d2, draw;    // depths of the z rings and of the Laplacian's raw ring
  int raww, rawn, rawx;  // the raw tile's row width, size (kTileY + 2 rows), column of x0
  // offsets (words): taps (z, y, x, each 16-byte aligned) at 0, the row
  // and column tables, the input windows [buffers][3][wy x wx] (r, p,
  // free), pf on the window (wy x wx), the weights [2][ey x qx], the
  // x-blurred window rows (wy x ex), s on the extended tile (ey x ex), its
  // x-blurred rows (ey x kTileX), the first z ring, the second z ring of
  // the runtime-length taps, the raw ring
  int tab, win, pf, wwin, xt1, sext, xt2, ring1, ring2, raw, words;
  int tz;  // planes a block marches through (march_tile_z)
};

constexpr WeightedGeo weighted_geo(Taps tp, bool fixed) {
  WeightedGeo g{};
  g.hy = halo_of(tp.ky);
  g.hx = halo_of(tp.kx);
  g.hz = halo_of(tp.kz);
  g.wy = kTileY + 4 * g.hy;
  g.ey = kTileY + 2 * g.hy;
  if (fixed) {
    g.axe = round_up(g.hx, 4);
    g.ex = round_up(g.axe + kTileX + g.hx, 4);
    g.axw = round_up(2 * g.hx, 8);
    g.wx = round_up(g.axw + g.ex - g.axe + g.hx, 8);
    g.axq = round_up(g.hx, 8);
    g.qx = round_up(g.axq + g.ex - g.axe, 8);
  } else {
    g.axe = g.hx;
    g.ex = kTileX + 2 * g.hx;
    g.axw = 2 * g.hx;
    g.wx = kTileX + 4 * g.hx;
    g.axq = 0;
    g.qx = 0;
  }
  g.d1 = g.d2 = g.hz - tp.kz / 2 + tp.kz;
  g.draw = 2 * g.hz + 4;
  // the fixed instance stores whole 4-column groups of its raw tile: window
  // columns axw - 4 .. axw + kTileX + 3
  g.raww = fixed ? kTileX + 8 : kRawW;
  g.rawn = (kTileY + 2) * g.raww;
  g.rawx = fixed ? 4 : 1;
  const int wn = g.wy * g.wx, en = g.ey * g.ex;
  g.tab = round_up(tp.kz, 4) + round_up(tp.ky, 4) + round_up(tp.kx, 4);
  g.win = g.tab + round_up(g.wy + g.wx, 4);
  g.pf = g.win + (fixed ? 2 : 1) * 3 * wn;
  g.wwin = g.pf + wn;
  g.xt1 = g.wwin + 2 * g.ey * g.qx;
  g.sext = g.xt1 + g.wy * g.ex;
  g.xt2 = g.sext + en;
  g.ring1 = g.xt2 + g.ey * kTileX;
  g.ring2 = g.ring1 + g.d1 * en;
  g.raw = g.ring2 + (fixed ? 0 : g.d2 * kOutN);
  g.words = g.raw + g.draw * g.rawn;
  g.tz = kWeightedTileZ;
  return g;
}

// The weighted march. Two stencils in one block, the second stage one plane
// behind the first, so that each plane takes two barriers:
//   step k, after the first barrier: start the copy of the input windows
//     (r, p, free; a window: v) of plane k + 2 (the runtime-length
//     instance: k + 1) and of the weights of the next step;
//     x taps of pf over the rows of plane k's pf window, a strip of four
//     extended-tile columns a thread from K + 3 values read in 16-byte
//     loads, into xt1; x taps of s (the extended tile of the previous
//     step) into xt2; wait for plane k + 1's windows;
//   after the second barrier: pf = free p' of plane k + 1 on its window
//     (formed once a value, from 16-byte loads of r, p and free), its raw
//     tile (halo 1) into the Laplacian's ring and p' out on the block's
//     own planes;
//     y taps of a 4-column group of xt1 (a row of the extended tile, K
//     16-byte loads), into the first z ring; hz steps on, the z taps and
//     s = wts A pf of plane k - hz, into sext;
//     y taps of the thread's column strip of xt2 into its second z ring;
//     hz steps on, the z taps of output plane k - 2 hz - 1, the Laplacian
//     of the raw ring and the masked apply (p' read back from device
//     memory, where the block wrote it).
// The first z ring is in shared memory, each thread reading back only the
// 4-column groups it wrote (in registers the whole-volume instances
// spilled); the second ring is in registers, shifted a place a step, in
// the fixed instance (kK taps on every axis), and in shared memory in the
// runtime-length one, which takes one shared-memory load a tap. Each
// output's chain is the three-pass units': the taps in the same order with
// fmaf, each axis rounded to float where they round it, s = w A pf with w
// read at W, the core rounded to bfloat16 under kIo, q = free core +
// (p' - free p'), and one float64 partial of sum p'.q a block. B^T B is
// the Laplacian or, kReg = kRegIdentity (Tikhonov TK0), pf itself, the
// raw ring's centre.
//
// Its block: 256 threads on the 16 x 32 output tile of the other units,
// over up to kWeightedTileZ planes (march_tile_z); registers
// (ptxas: under the 128 that two blocks allow, no spills; PERF.md) leave
// two blocks, 16 warps, an SM, and the fixed instance's shared memory
// (two buffers of input windows, the weights' window, the first z ring,
// the raw ring) fits two. What bounds it: bytes would bound
// weighted_apply_zy at 512^3 at 0.96 ms (r, p, free, wts read, p' and q
// written, float); the march takes about four times that. Dropping one
// part at a time in development (PERF.md) put the window copies first
// (about a quarter of the time: the r, p and free windows carry a 2.6x
// x-y halo from the 50 MB L2), then the second stage with the Laplacian,
// the first stage's y and z taps, the x taps and the pf pass; with 16
// warps an SM the latency of those loads and the two barriers a plane,
// not the taps' arithmetic, set the time. Device memory sees each input
// about (kWeightedTileZ + 4 hz) / kWeightedTileZ times and each output
// once.
template <int kK, int kReg, bool kWindow, bool kMasked, class S, class T>
__global__ void __launch_bounds__(kWeightedThreads, kWeightedResident) weighted_zy_kernel(
    WeightedArgs<typename WeightedIo<kWindow, S, T>::V, typename WeightedIo<kWindow, S, T>::P,
                 typename WeightedIo<kWindow, S, T>::WT, typename WeightedIo<kWindow, S, T>::O>
        a,
    WeightedGeo g) {
  using Io = WeightedIo<kWindow, S, T>;
  using V = typename Io::V;
  using P = typename Io::P;
  using WT = typename Io::WT;
  using W = typename Io::W;
  static_assert(kK == 0 || kK >= 3, "a compile-time length has a halo of K / 2");
  static_assert(!(kWindow && kMasked), "a window has no mask");
  constexpr int kLead = kK > 0 ? 2 : 1;  // input window buffers, planes copied ahead
  extern __shared__ __align__(16) float smem[];
  const Dims d = a.d;
  const int kz = kK ? kK : a.tp.kz, ky = kK ? kK : a.tp.ky, kx = kK ? kK : a.tp.kx;
  const int hy = g.hy, hz = g.hz;
  const int tid = thread_rank(), nt = kWeightedThreads;
  float* tz = smem;
  float* ty = tz + round_up(a.tp.kz, 4);
  float* tx = ty + round_up(a.tp.ky, 4);
  int* rows = reinterpret_cast<int*>(smem + g.tab);
  int* cols = rows + g.wy;
  const int wn = g.wy * g.wx, en = g.ey * g.ex;
  float* pfw = smem + g.pf;
  float* xt1 = smem + g.xt1;
  float* sext = smem + g.sext;
  float* xt2 = smem + g.xt2;
  float* ring1 = smem + g.ring1;
  float* ring2 = smem + g.ring2;
  float* raw = smem + g.raw;
  const int x0 = blockIdx.x * kTileX, y0 = blockIdx.y * kTileY, z0 = blockIdx.z * g.tz;
  const int nz = min(g.tz, d.Z - z0);
  const int pstart = z0 - 2 * hz, nin = nz + 4 * hz;  // input planes; nin + 1 steps
  const bool first = kWindow || a.first;
  const float beta = first ? 0.f : (float)a.scal[kBeta];
  for (int i = tid; i < a.tp.kz; i += nt) tz[i] = a.tp.z[i];
  for (int i = tid; i < a.tp.ky; i += nt) ty[i] = a.tp.y[i];
  for (int i = tid; i < a.tp.kx; i += nt) tx[i] = a.tp.x[i];
  for (int i = tid; i < g.wy; i += nt) rows[i] = wrap_index(y0 - 2 * hy + i, d.Y) * d.X;
  for (int i = tid; i < g.wx; i += nt) cols[i] = wrap_index(x0 - g.axw + i, d.X);
  const bool aligned = kK > 0;
  const CopyPlan plan_r = copy_plan(a.r, g.wx, d.X, aligned);
  const CopyPlan plan_p = copy_plan(a.p, g.wx, d.X, aligned);
  const CopyPlan plan_f = copy_plan(a.free, g.wx, d.X, aligned);
  const CopyPlan plan_w = kK > 0 ? copy_plan(a.wts, g.qx, d.X) : CopyPlan{};
  __syncthreads();
  // the fixed instance's windows in 16-byte groups found once, where every
  // volume's rows are 16-byte aligned
  constexpr bool kTwoSizes = sizeof(V) != sizeof(P) && !kWindow;  // a bfloat16 p
  const bool groups = kK > 0 && plan_r.vec && (first || plan_p.vec) &&
                      (!kMasked || plan_f.vec) && plan_w.vec;
  CopyGroups gv{}, gp{}, gw{};
  if (groups) {
    gv = copy_groups<V>(rows, cols, g.wy, g.wx);
    if (kTwoSizes) gp = copy_groups<P>(rows, cols, g.wy, g.wx);
    gw = copy_groups<WT>(rows + hy, cols + g.axw - g.axq, g.ey, g.qx);
  }

  const auto plane_of = [&](int pz) { return kWindow ? pz : wrap_index(pz, d.Z); };
  const auto window = [&](int kk, int i) {
    return smem + g.win + ((kLead == 2 ? kk & 1 : 0) * 3 + i) * wn;
  };
  // the input windows of plane pstart + kk
  const auto start_copy = [&](int kk) {
    const long long off = (long long)plane_of(pstart + kk) * d.plane();
    if (groups) {
      copy_groups_async(reinterpret_cast<V*>(window(kk, 0)), a.r + off, gv);
      if (!first)
        copy_groups_async(reinterpret_cast<P*>(window(kk, 1)), a.p + off, kTwoSizes ? gp : gv);
      if (kMasked) copy_groups_async(window(kk, 2), a.free + off, gv);
      return;
    }
    copy_plane(reinterpret_cast<V*>(window(kk, 0)), a.r + off, rows, cols, plan_r, g.wy, g.wx);
    if (!first)
      copy_plane(reinterpret_cast<P*>(window(kk, 1)), a.p + off, rows, cols, plan_p, g.wy, g.wx);
    if (kMasked) copy_plane(window(kk, 2), a.free + off, rows, cols, plan_f, g.wy, g.wx);
  };
  // p' = r + beta p rounded to P (product and sum apart for bfloat16), and
  // the value the first stage convolves: pf = free p' (a window: v)
  const auto dir_of = [&](float rv, float pv) {
    return round_as<P>(first ? rv : axpy_as<P>(beta, pv, rv));
  };
  // pf of plane pstart + kk on its window, into pfw; its raw tile into
  // slot `slot` of the raw ring; p' out on the block's own planes
  const auto pf_pass = [&](int kk, int slot) {
    const V* wr = reinterpret_cast<const V*>(window(kk, 0));
    const P* wp = reinterpret_cast<const P*>(window(kk, 1));
    const float* wf = window(kk, 2);
    float* rp = raw + slot * g.rawn;
    const int pz = pstart + kk;
    const bool own = !kWindow && pz >= z0 && pz < z0 + nz;
    if constexpr (kK > 0) {
      const int nq = g.wx / 4;
      for (int t = tid; t < g.wy * nq; t += nt) {
        const int r = t / nq, c0 = (t - r * nq) * 4, e = r * g.wx + c0;
        float rv[4], pv[4] = {0.f, 0.f, 0.f, 0.f}, fv[4] = {1.f, 1.f, 1.f, 1.f}, dv[4], pf[4];
        load4<V>(wr + e, rv);
        if (!first) load4<P>(wp + e, pv);
        if (kMasked) load4<float>(wf + e, fv);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          dv[u] = dir_of(rv[u], pv[u]);
          pf[u] = kWindow ? rv[u] : kMasked ? fv[u] * dv[u] : dv[u];
        }
        *reinterpret_cast<float4*>(pfw + e) = make_float4(pf[0], pf[1], pf[2], pf[3]);
        // the raw tile's row and column of the group; p' out on own planes
        const int rr = r - 2 * hy + 1, qc = c0 - g.axw + g.rawx;
        if ((unsigned)rr >= kTileY + 2 || (unsigned)qc >= (unsigned)g.raww) continue;
        *reinterpret_cast<float4*>(rp + rr * g.raww + qc) = make_float4(pf[0], pf[1], pf[2], pf[3]);
        const int y = y0 + rr - 1, x = x0 + qc - g.rawx;
        if (!own || (unsigned)(rr - 1) >= kTileY || (unsigned)(x - x0) >= kTileX || y >= d.Y)
          continue;
        const long long i = (long long)pz * d.plane() + (long long)y * d.X + x;
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (x + u < d.X) a.p_new[i + u] = store_as<P>(dv[u]);
      }
    } else {
      for (int e = tid; e < wn; e += nt) {
        const int r = e / g.wx, c = e - r * g.wx;
        const float rv = to_float(wr[e]);
        const float dv = dir_of(rv, first ? 0.f : to_float(wp[e]));
        const float pf = kWindow ? rv : kMasked ? wf[e] * dv : dv;
        pfw[e] = pf;
        const int rr = r - 2 * hy + 1, cc = c - g.axw + g.rawx;  // the raw tile's
        if ((unsigned)rr >= kTileY + 2 || (unsigned)cc >= kRawW) continue;
        rp[rr * kRawW + cc] = pf;
        const int y = y0 + rr - 1, x = x0 + cc - g.rawx;
        if (own && (unsigned)(rr - 1) < kTileY && (unsigned)(x - x0) < kTileX && y < d.Y &&
            x < d.X)
          a.p_new[(long long)pz * d.plane() + (long long)y * d.X + x] = store_as<P>(dv);
      }
    }
  };

  // the thread's second-stage outputs: column c2, rows kWStrip s2 + m
  const int c2 = threadIdx.x, s2 = threadIdx.y;
  constexpr int kD = kK ? kK + halo_of(kK) - kK / 2 : 1;  // register z ring depth
  float zr2[kWStrip][kD];  // [m][t]: step k - t
  const int nq1 = g.ex / 4;  // 4-column groups of an extended-tile row
  double acc = 0.0;
  for (int kk = 0; kk < kLead; ++kk) {
    start_copy(kk);
    __pipeline_commit();
  }
  __pipeline_wait_prior(kLead - 1);
  __syncthreads();
  pf_pass(0, 0);
  // kr, kq: the slots of step k in the raw ring and in the z rings
  for (int k = 0, kr = 0, kq = 0; k <= nin;
       ++k, kr = slot_next(kr, g.draw), kq = slot_next(kq, g.d1)) {
    __syncthreads();
    if (k + kLead < nin) start_copy(k + kLead);
    if (kK > 0 && k + 1 >= 2 * hz && k + 1 < nin) {  // the weights of step k + 1
      WT* dst = reinterpret_cast<WT*>(smem + g.wwin + ((k + 1) & 1) * g.ey * g.qx);
      const WT* src = a.wts + (long long)plane_of(pstart + k + 1 - hz) * d.plane();
      if (groups)
        copy_groups_async(dst, src, gw);
      else
        copy_plane(dst, src, rows + hy, cols + g.axw - g.axq, plan_w, g.ey, g.qx);
    }
    __pipeline_commit();
    const bool stage1 = k < nin, stage2 = k > 2 * hz;
    // ---- x taps of both stages
    if constexpr (kK > 0) {
      constexpr int K = kK, H = halo_of(K);
      constexpr int AXE = round_up(H, 4), AXW = round_up(2 * H, 8);
      // a strip's K + 3 values start at column e0 + 4 F + O of its row
      constexpr int OFF1 = AXW - AXE + K / 2 - (K - 1), F1 = OFF1 / 4, O1 = OFF1 % 4;
      constexpr int NF1 = (O1 + K + 3 + 3) / 4;
      constexpr int OFF2 = AXE + K / 2 - (K - 1), F2 = OFF2 / 4, O2 = OFF2 % 4;
      constexpr int NF2 = (O2 + K + 3 + 3) / 4;
      static_assert(OFF1 >= 0 && OFF2 >= 0, "the x taps start inside the row");
      float kxr[K];
      load_taps<K>(tx, kxr);
      const int n1 = stage1 ? g.wy * nq1 : 0, n2 = stage2 ? g.ey * (kTileX / 4) : 0;
      for (int t = tid; t < n1 + n2; t += nt) {
        const float* src;
        float* dst;
        if (t < n1) {  // first stage: xt1[r][e0..e0 + 3]
          const int r = t / nq1, e0 = (t - r * nq1) * 4;
          src = pfw + r * g.wx + e0 + 4 * F1;
          dst = xt1 + r * g.ex + e0;
        } else {  // second stage: xt2[r][c0..c0 + 3]
          const int u = t - n1, r = u / (kTileX / 4), c0 = (u - r * (kTileX / 4)) * 4;
          src = sext + r * g.ex + c0 + 4 * F2;
          dst = xt2 + r * kTileX + c0;
        }
        static_assert(NF1 == NF2 && O1 == O2, "both stages read K + 3 values alike");
        float v[4 * NF1], o[4];
#pragma unroll
        for (int f = 0; f < NF1; ++f) load4<float>(src + 4 * f, v + 4 * f);
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          float sum = 0.f;
#pragma unroll
          for (int j = 0; j < K; ++j) sum = fmaf(kxr[j], v[O1 + m + K - 1 - j], sum);
          o[m] = sum;
        }
        *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
      }
    } else {
      if (stage1)
        for (int e = tid; e < g.wy * g.ex; e += nt) {
          const int r = e / g.ex, c = e - r * g.ex;
          const int base = r * g.wx + c + g.axw - g.axe + kx / 2;
          float sum = 0.f;
          for (int j = 0; j < kx; ++j) sum = fmaf(tx[j], pfw[base - j], sum);
          xt1[e] = sum;
        }
      if (stage2)
        for (int e = tid; e < g.ey * kTileX; e += nt) {
          const int r = e / kTileX, c = e - r * kTileX;
          const int base = r * g.ex + c + g.axe + kx / 2;
          float sum = 0.f;
          for (int j = 0; j < kx; ++j) sum = fmaf(tx[j], sext[base - j], sum);
          xt2[e] = sum;
        }
    }
    __pipeline_wait_prior(kLead - 1);  // plane k + 1's windows, step k's weights
    __syncthreads();
    // ---- pf of the next plane; y and z taps of both stages, the epilogue
    if (k + 1 < nin) pf_pass(k + 1, slot_next(kr, g.draw));
    const bool out = k > 4 * hz;  // output plane z = pstart + k - 2 hz - 1
    const int z = pstart + k - 2 * hz - 1;
    // the outputs' p' (written by this block 2 hz + 2 steps before, so read
    // coherently) and free, loaded before the taps hide their latency
    float cp[kWStrip], cf[kWStrip];
#pragma unroll
    for (int m = 0; m < kWStrip; ++m) {
      const int y = y0 + kWStrip * s2 + m, x = x0 + c2;
      cp[m] = 0.f, cf[m] = 1.f;
      if (kWindow || !out || y >= d.Y || x >= d.X) continue;
      const long long i = (long long)z * d.plane() + (long long)y * d.X + x;
      cp[m] = to_float(a.p_new[i]);
      if (kMasked) cf[m] = __ldg(a.free + i);
    }
    if (stage1) {
      const bool scale = k >= 2 * hz;  // s of plane pstart + k - hz
      if constexpr (kK > 0) {
        constexpr int K = kK, H = halo_of(K), AXE = round_up(H, 4), AXQ = round_up(H, 8);
        if (tid < g.ey * nq1) {
          const int r = tid / nq1, e0 = (tid - r * nq1) * 4, e = r * g.ex + e0;
          float kyr[K], col[K][4], o[4];
          load_taps<K>(ty, kyr);
#pragma unroll
          for (int t = 0; t < K; ++t) load4<float>(xt1 + (r + t) * g.ex + e0, col[t]);
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            float sum = 0.f;
#pragma unroll
            for (int j = 0; j < K; ++j) sum = fmaf(kyr[j], col[K - 1 - j][m], sum);
            o[m] = sum;
          }
          *reinterpret_cast<float4*>(ring1 + kq * en + e) = make_float4(o[0], o[1], o[2], o[3]);
          if (scale) {
            float kzr[K], wv[4], zv[K][4];
            load_taps<K>(tz, kzr);
#pragma unroll
            for (int j = 0; j < K; ++j)
              load4<float>(ring1 + slot_back(kq, H - K / 2 + j, g.d1) * en + e, zv[j]);
            load4<W>(reinterpret_cast<const WT*>(smem + g.wwin + (k & 1) * g.ey * g.qx) +
                         r * g.qx + e0 + AXQ - AXE,
                     wv);
#pragma unroll
            for (int m = 0; m < 4; ++m) {
              float conv = 0.f;
#pragma unroll
              for (int j = 0; j < K; ++j) conv = fmaf(kzr[j], zv[j][m], conv);
              o[m] = __fmul_rn(wv[m], conv);
            }
            *reinterpret_cast<float4*>(sext + e) = make_float4(o[0], o[1], o[2], o[3]);
          }
        }
      } else {
        const long long woff = (long long)plane_of(pstart + k - hz) * d.plane();
        for (int e = tid; e < en; e += nt) {
          const int r = e / g.ex, c = e - r * g.ex;
          const int base = (r + hy + ky / 2) * g.ex + c;
          float sum = 0.f;
          for (int j = 0; j < ky; ++j) sum = fmaf(ty[j], xt1[base - j * g.ex], sum);
          ring1[kq * en + e] = sum;
          if (!scale) continue;
          float conv = 0.f;
          for (int j = 0; j < kz; ++j)
            conv = fmaf(tz[j], ring1[slot_back(kq, hz - kz / 2 + j, g.d1) * en + e], conv);
          const float w = round_as<W>(ldg(a.wts + woff + rows[r + hy] + cols[c + g.axw - g.axe]));
          sext[e] = __fmul_rn(w, conv);
        }
      }
    }
    if (!stage2) continue;
    // xy-blurred s of plane pstart + k - hz - 1 into the second z ring
    float conv[kWStrip];
    if constexpr (kK > 0) {
      constexpr int K = kK, H = halo_of(K);
      float kyr[K], col[K + kWStrip - 1];
      load_taps<K>(ty, kyr);
#pragma unroll
      for (int t = 0; t < K + kWStrip - 1; ++t) col[t] = xt2[(kWStrip * s2 + t) * kTileX + c2];
#pragma unroll
      for (int m = 0; m < kWStrip; ++m) {
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < K; ++j) sum = fmaf(kyr[j], col[m + K - 1 - j], sum);
#pragma unroll
        for (int t = kD - 1; t > 0; --t) zr2[m][t] = zr2[m][t - 1];
        zr2[m][0] = sum;
      }
      if (!out) continue;
      float kzr[K];
      load_taps<K>(tz, kzr);
#pragma unroll
      for (int m = 0; m < kWStrip; ++m) {
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < K; ++j) sum = fmaf(kzr[j], zr2[m][H - K / 2 + j], sum);
        conv[m] = sum;
      }
    } else {
      for (int m = 0; m < kWStrip; ++m) {
        const int e = (kWStrip * s2 + m) * kTileX + c2;
        const int base = (kWStrip * s2 + m + hy + ky / 2) * kTileX + c2;
        float sum = 0.f;
        for (int j = 0; j < ky; ++j) sum = fmaf(ty[j], xt2[base - j * kTileX], sum);
        ring2[kq * kOutN + e] = sum;
        if (!out) continue;
        sum = 0.f;
        for (int j = 0; j < kz; ++j)
          sum = fmaf(tz[j], ring2[slot_back(kq, hz - kz / 2 + j, g.d2) * kOutN + e], sum);
        conv[m] = sum;
      }
      if (!out) continue;
    }
    const float* zm = raw + slot_back(kr, 2 * hz + 2, g.draw) * g.rawn;
    const float* zc = raw + slot_back(kr, 2 * hz + 1, g.draw) * g.rawn;
    const float* zp = raw + slot_back(kr, 2 * hz, g.draw) * g.rawn;
    const Dims ld{kWindow ? a.z_total : d.Z, d.Y, d.X};
#pragma unroll
    for (int m = 0; m < kWStrip; ++m) {
      const int oy = kWStrip * s2 + m;
      const Coord c{x0 + c2, y0 + oy, kWindow ? a.row0 + z : z};
      if (c.y >= d.Y || c.x >= d.X) continue;
      const int o = (oy + 1) * g.raww + c2 + g.rawx;
      const float reg =
          kReg == kRegIdentity ? zc[o] : ring_laplacian(zm, zc, zp, o, c, a.sp, ld, g.raww);
      float core = fmaf(a.rho, reg, conv[m]);
      const long long i = (long long)z * d.plane() + (long long)c.y * d.X + c.x;
      if (kWindow) {
        a.q[i] = store_as<typename Io::O>(core);
        continue;
      }
      if (S::kIo) core = round_as<bf16>(core);
      const float p = cp[m];
      float qi = core;
      if (kMasked) qi = __fadd_rn(__fmul_rn(cf[m], core), __fsub_rn(p, __fmul_rn(cf[m], p)));
      a.q[i] = qi;
      acc += (double)p * qi;
    }
  }
  if (!kWindow) {
    const double s = tile_sum(acc);
    if (tid == 0) a.partials[block_index()] = s;
  }
}

// The compile-time instance's block fits: ops/cuda/tiled.py routes by the
// runtime-length instance's size, which nsol_tiled_smem reports.
constexpr WeightedGeo kFixedGeo =
    weighted_geo(Taps{nullptr, nullptr, nullptr, kBlurK, kBlurK, kBlurK}, true);
static_assert(kFixedGeo.words * 4 <= kMaxSmem,
              "the weighted march's compile-time instance fits a block");
static_assert(kFixedGeo.wy * kFixedGeo.wx / 4 <= 2 * kWeightedThreads &&
                  kFixedGeo.ey * kFixedGeo.qx / 4 <= 2 * kWeightedThreads,
              "its windows take at most two 16-byte groups a thread");

template <int kK, int kReg, bool kWindow, bool kMasked, class S, class T, class A>
cudaError_t launch_weighted(const A& a, cudaStream_t s) {
  WeightedGeo g = weighted_geo(a.tp, kK > 0);
  const size_t smem = (size_t)g.words * 4;
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = weighted_zy_kernel<kK, kReg, kWindow, kMasked, S, T>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const MarchGrid mg = weighted_grid(a.d, a.tp);
  g.tz = mg.tz;
  kernel<<<mg.grid, dim3(kTileX, kWeightedRows), smem, s>>>(a, g);
  return cudaGetLastError();
}

// kBlurK taps on every axis take the weighted march's compile-time
// instance, every other length its runtime-length instance.
template <int kReg, bool kWindow, bool kMasked, class S, class T, class A>
cudaError_t launch_weighted_taps(const A& a, cudaStream_t s) {
  if (a.tp.kz == kBlurK && a.tp.ky == kBlurK && a.tp.kx == kBlurK)
    return launch_weighted<kBlurK, kReg, kWindow, kMasked, S, T>(a, s);
  return launch_weighted<0, kReg, kWindow, kMasked, S, T>(a, s);
}

// --------------------------------------------------- whole-volume units --

// The shared memory a block of the whole-volume unit's march takes at the
// taps tp, in its runtime-length instance (the larger): cg_step's and
// cg_sweep's with the bfloat16 windows' margins and blur_apply's with u (the
// gradient's), so that every storage mode and form of a unit takes one
// route.
inline size_t vol_smem(int unit, Taps tp) {
  switch (unit) {
    case kVolCgStep:
      return stencil_smem(stencil_geo(tp, 2, true), true, true);
    case kVolWeightedApply:
      return (size_t)weighted_geo(tp, false).words * 4;
    case kVolNormalApply:
      return stencil_smem(stencil_geo(tp, 1), true, true);
    case kVolBlurApply:
      return stencil_smem(stencil_geo(tp, 2), true, true);
    case kVolCgSweep:  // three windows with bfloat16 margins and the r' ring
      return stencil_smem(stencil_geo(tp, 3, true), true, true, true);
    default:  // kVolIrlsHead: one window, no Laplacian
      return stencil_smem(stencil_geo(tp, 1), false, true);
  }
}

// The most steps a block of the whole-volume unit's march may take a plane
// it writes, (Z + halo steps) / Z, as a ratio: 2.5 where the march lost
// to the chain on thinner stacks (cg_step, weighted_apply, blur_apply's
// gradient form; cg_sweep takes cg_step's), 4 for the lighter
// normal_apply (one window; it won at 4 planes of 13 taps, 4 steps a
// plane) and irls_head (one window, no Laplacian; it won at 2 planes of 7
// taps). Timed by device time in turns on the H100 (chip_smoke.py phases
// 37 and 40, PERF.md).
struct StepsPerPlane {
  int num, den;
};

inline StepsPerPlane vol_steps(int unit) {
  return unit == kVolNormalApply || unit == kVolIrlsHead ? StepsPerPlane{4, 1}
                                                         : StepsPerPlane{5, 2};
}

// The fewest voxels the whole-volume unit's march takes (exclusive).
inline long long vol_min_voxels(int unit) {
  return unit == kVolCgStep || unit == kVolWeightedApply || unit == kVolCgSweep
             ? kMarchMinVoxels
             : kLightMinVoxels;
}

// Whether the whole-volume unit (VolUnit: cg_step, normal_apply and
// cg_sweep at the normal taps, weighted_apply, blur_apply and irls_head at
// the blur taps) takes its march at the taps tp on the volume d, else
// stencil.cuh's three-pass chain: the march on a volume of more than
// vol_min_voxels voxels, deep enough that a block takes at most
// vol_steps(unit) steps a plane it writes (so no 2-D view), where a
// block's shared memory holds the taps (vol_smem). ops/cuda/tiled.py::
// vol_route mirrors it.
inline bool vol_route(int unit, Taps tp, Dims d) {
  if (d.n() <= vol_min_voxels(unit)) return false;
  const StepsPerPlane sp = vol_steps(unit);
  const long long steps = (long long)d.Z + march_halo_steps(tp.kz, unit == kVolWeightedApply);
  if (steps * sp.den > (long long)sp.num * d.Z) return false;
  return vol_smem(unit, tp) <= (size_t)kMaxSmem;
}

// cg_step's epilogue: q = conv + rho B^T B p' stored as Q, and p'.q summed
// from the rounded p' (the centre) and the float q, as admm.cu's chain
// takes them (its NormalEpi dot). B^T B: the Laplacian, or p' itself
// (kRegIdentity, Tikhonov TK0).
template <int kReg, class Q>
struct StepZyEpi {
  Q* out;
  float rho;
  __device__ double operator()(long long i, float conv, float lap, float centre) const {
    const float q = fmaf(rho, kReg == kRegIdentity ? centre : lap, conv);
    out[i] = store_as<Q>(q);
    return (double)centre * q;
  }
};

// The whole-volume cg_step on the single-stencil march: p' = r + beta p
// (r read as S::R, p and p' stored as S::P) formed in the tile and written
// once, q = M p' stored as S::Q, pq = sum p'.q and a = gamma / pq.
template <int kReg, class S>
cudaError_t cg_step_march_t(const void* r, const void* p, void* p_new, void* q, double* partials,
                            double* scal, int first, Taps tp, float rho, Spacing sp, Dims d,
                            cudaStream_t s) {
  using R = typename S::R;
  using P = typename S::P;
  using Q = typename S::Q;
  const StencilArgs<R, R, P> a{static_cast<const R*>(r),
                               first ? nullptr : static_cast<const P*>(p),
                               static_cast<P*>(p_new),
                               scal,
                               first,
                               tp,
                               sp,
                               d,
                               partials,
                               0,
                               0};
  const cudaError_t e = launch_stencil<kNormalK, kSrcDirection, true>(
      a, 2, StepZyEpi<kReg, Q>{static_cast<Q*>(q), rho}, s);
  if (e != cudaSuccess) return e;
  reduce_kernel<<<1, kReduceThreads, 0, s>>>(partials, stencil_grid(d, tp).blocks(), scal,
                                             kReducePQ);
  return cudaGetLastError();
}

// cg_sweep's epilogue: q' = conv + rho D^T D p' stored as T into another
// volume than q (a block's halo reads its neighbours' q while they write
// q'), and the dots p'.q' (the rounded p', the centre), r'.q' (r' before
// its rounding, from the r' ring) and q'.q' (q' before its rounding), as
// admm.cu's sweep_z_kernel takes them; g is the kernel's own.
template <class T>
struct SweepZyEpi {
  T* out;
  float rho;
  __device__ Dots4 operator()(long long i, float conv, float lap, float centre,
                              float rn) const {
    const float q = __fmaf_rn(rho, lap, conv);
    out[i] = store_as<T>(q);
    return Dots4{{0.0, (double)centre * q, (double)rn * q, (double)q * q}};
  }
};

// The whole CG iteration of cg_sweep on the single-stencil march: r' = r -
// a q, p' = r' + beta p (r', p' written once), q' = (A^T A + rho D^T D) p'
// into q_new, x += a p (the old p, in place), the four dots and the
// recurrence's a, beta (sweep_reduce_kernel); r, q, p, r', p', q' stored as
// T, a = beta = 0 and no q, p read on the first trip. partials holds 4 x
// the grid's blocks.
template <class T>
cudaError_t cg_sweep_march_t(float* x, const T* r, const T* p, const T* q, T* q_new, T* r_new,
                             T* p_new, double* partials, double* scal, int first, Taps tp,
                             float rho, Spacing sp, Dims d, cudaStream_t s) {
  StencilArgs<T, T, T> a{r,        first ? nullptr : q,
                         p_new,    scal,
                         first,    tp,
                         sp,       d,
                         partials, 0,
                         0};
  a.in2 = first ? nullptr : p;
  a.res_out = r_new;
  a.x = x;
  const cudaError_t e =
      launch_stencil<kNormalK, kSrcSweep, true>(a, 3, SweepZyEpi<T>{q_new, rho}, s);
  if (e != cudaSuccess) return e;
  const int nb = stencil_grid(d, tp, kSweepResident).blocks();
  sweep_reduce_kernel<<<1, kReduceThreads, 0, s>>>(partials, nb, nb, scal);
  return cudaGetLastError();
}

// The whole-volume weighted_apply on the weighted march: p' = r + beta p
// (stored as S::P), pf = free p', q = free (A (wts A pf) + rho B^T B pf) +
// (p' - pf) (free null: every voxel free), pq = sum p'.q and a = gamma /
// pq.
template <int kReg, class S>
cudaError_t weighted_march_t(const float* r, const void* p, void* p_new, float* q,
                             const float* free, const float* wts, double* partials, double* scal,
                             int first, Taps tp, float rho, Spacing sp, Dims d, cudaStream_t s) {
  using P = typename S::P;
  const WeightedArgs<float, P, float, float> a{
      r,   first ? nullptr : static_cast<const P*>(p), free, wts, static_cast<P*>(p_new), q,
      scal, first, rho, tp, sp, d, partials, 0, 0};
  const cudaError_t e = free != nullptr
                            ? launch_weighted_taps<kReg, false, true, S, float>(a, s)
                            : launch_weighted_taps<kReg, false, false, S, float>(a, s);
  if (e != cudaSuccess) return e;
  reduce_kernel<<<1, kReduceThreads, 0, s>>>(partials, weighted_grid(d, tp).blocks(), scal,
                                             kReducePQ);
  return cudaGetLastError();
}

}  // namespace
