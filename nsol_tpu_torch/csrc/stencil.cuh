// The per-axis wrap-convolution passes shared by admm.cu and robust.cu, and
// the CG update they both run.
//
// A separable blur of a (Z, Y, X) float32 volume is three passes, one per
// axis, through two scratch volumes: conv_x_pass reads its input through a
// source functor (a prologue: a plain load, or a CG direction formed on the
// fly), conv_y_kernel is a plain pass, and conv_z_pass hands every
// convolved value to an epilogue functor (the Laplacian, a residual, IRLS
// weights, an active set, ...) that may return a term of a deterministic
// block reduction. One stencil, many prologues and epilogues.
//
// A source functor has `prepare()` (run once per thread, before any load:
// it reads device scalars), `operator()(k)` (the value the x pass
// convolves) and `dir(k)` (the value the x pass may store beside it). An
// epilogue functor has `operator()(i, conv, c, d)` (c the voxel's
// coordinates) returning a double to sum (0 when it reduces nothing).
//
// A z-window (the per-shard units of the sharded path, whose slab arrives
// with its z halos attached by the neighbours): blur_chain_slab runs the x
// and y passes on every plane of the window and conv_z_pass<Epi, true>
// reads it contiguously, with no wrap; GlobalRows hands the epilogue the
// voxel's row in the global volume, so the Laplacian takes its
// zero-boundary rows only at the global ends.
//
// Storage. A CG work vector may be stored as float or as bfloat16 (the TPU
// kernels' io_dtype / compact_dirs / state_dtype modes); every sum and
// every stencil runs in float, and a value is rounded to bfloat16 (to
// nearest, ties to even, as JAX's astype) only where the reference stores
// it. A source's `Dir` is the type of the direction it hands the x pass.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "common.cuh"

// march.cuh's whole-volume route (tiled.cu's C entry): whether a VolUnit
// takes its march at the taps (kz, ky, kx) on a (Z, Y, X) volume.
extern "C" int nsol_vol_route(int unit, int kz, int ky, int kx, int Z, int Y, int X);

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }
// A read-only load, as float.
__device__ __forceinline__ float ldg(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldg(const bf16* p) { return __bfloat162float(__ldg(p)); }
// common.cuh's load_f of a bfloat16 value, as float.
template <bool kNc>
__device__ __forceinline__ float load_f(const bf16* p) {
  return __bfloat162float(kNc ? __ldg(p) : *p);
}

// v stored as T, and v rounded to T's precision (read back as float).
template <class T>
__device__ __forceinline__ T store_as(float v);
template <>
__device__ __forceinline__ float store_as<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ bf16 store_as<bf16>(float v) {
  return __float2bfloat16_rn(v);
}
template <class T>
__device__ __forceinline__ float round_as(float v) {
  return to_float(store_as<T>(v));
}

// r + s u for a value stored as T: one fused rounding when T is float; the
// product and the sum rounded apart when T is bfloat16, as the reference
// (and the plain version) forms it, so that both round the same float to
// bfloat16.
template <class T>
__device__ __forceinline__ float axpy_as(float s, float u, float r) {
  if (std::is_same<T, bf16>::value) return __fadd_rn(r, __fmul_rn(s, u));
  return __fmaf_rn(s, u, r);
}

// Storage modes of the CG vectors (r, p, q), by the reference option that
// sets them: exact float; compact_dirs="qf32" (the fused solve's
// compact_dirs); compact_dirs=True; state_dtype=bfloat16.
enum Storage { kStoreExact = 0, kStoreQf32 = 1, kStoreDirs = 2, kStoreState = 3 };

template <class R_, class P_, class Q_>
struct StoreT {
  using R = R_;
  using P = P_;
  using Q = Q_;
};

// f(StoreT<R, P, Q>{}) for the storage mode `storage`.
template <class F>
cudaError_t with_storage(int storage, F&& f) {
  switch (storage) {
    case kStoreExact:
      return f(StoreT<float, float, float>{});
    case kStoreQf32:
      return f(StoreT<float, bf16, float>{});
    case kStoreDirs:
      return f(StoreT<float, bf16, bf16>{});
    case kStoreState:
      return f(StoreT<bf16, bf16, bf16>{});
  }
  return cudaErrorInvalidValue;
}

// Storage modes of the masked (IRLS) CG, by the reference option that sets
// them: exact float; kRobustDirs (the fused solves' compact_dirs): the
// direction p' stored as bfloat16; kRobustIo (blocked_robust_admm_solve's
// compact_dirs, the weighted apply's io_dtype=bfloat16): p' stored as
// bfloat16, the weights read as bfloat16, and the apply's core
// A^T (w A pf) + rho B^T B pf rounded to bfloat16 before q is formed. r, q,
// x and every sum stay float.
enum RobustStorage { kRobustExact = 0, kRobustDirs = 1, kRobustIo = 2 };

template <class P_, bool kIo_>
struct RobustT {
  using P = P_;                   // the direction's storage
  using W = typename std::conditional<kIo_, bf16, float>::type;  // the weights' precision
  static constexpr bool kIo = kIo_;
};

// f(RobustT<P, kIo>{}) for the robust storage mode `storage`.
template <class F>
cudaError_t with_robust_storage(int storage, F&& f) {
  switch (storage) {
    case kRobustExact:
      return f(RobustT<float, false>{});
    case kRobustDirs:
      return f(RobustT<bf16, false>{});
    case kRobustIo:
      return f(RobustT<bf16, true>{});
  }
  return cudaErrorInvalidValue;
}

// The whole-volume units that take a march or the three-pass chain
// (march.cuh's vol_route), and the route their C entries take: the rule,
// the chain whatever the rule says (the bit reference the march is held
// to), or the march whatever it says.
enum VolUnit {
  kVolCgStep = 0,
  kVolWeightedApply = 1,
  kVolNormalApply = 2,
  kVolBlurApply = 3,
  kVolIrlsHead = 4,
  kVolCgSweep = 5
};
enum Route { kRouteRule = 0, kRouteChain = 1, kRouteMarch = 2 };

// Whether a whole-volume unit takes its march by `route`: the rule's
// answer, or the route forced.
inline bool takes_march(int route, int unit, int kz, int ky, int kx, int Z, int Y, int X) {
  return route == kRouteMarch ||
         (route == kRouteRule && nsol_vol_route(unit, kz, ky, kx, Z, Y, X));
}

// Device scalar slots of the CG state (double); the sweep adds r.q and q.q.
enum Slot { kGamma = 0, kPQ = 1, kA = 2, kBeta = 3, kRQ = 4, kQQ = 5 };
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

struct Coord {  // a voxel's array coordinates
  int x, y, z;
};

// How a pass body splits a voxel's linear index into its coordinates:
// here by 64-bit division, as the standalone kernels do (admm_persistent.cu
// has a division-free policy of the same interface).
struct DivIndex {
  Dims d;
  __device__ int x(long long i) const { return (int)(i % d.X); }
  __device__ int y(long long i) const { return (int)((i / d.X) % d.Y); }
  __device__ Coord at(long long i) const {
    return Coord{(int)(i % d.X), (int)((i / d.X) % d.Y), (int)(i / d.plane())};
  }
};

__host__ __device__ inline Taps make_taps(const float* buf, int kz, int ky, int kx) {
  return Taps{buf, buf + kz, buf + kz + ky, kz, ky, kx};
}

inline int grid_for(long long n) {
  long long b = (n + kThreads - 1) / kThreads;
  if (b < 1) b = 1;
  return (int)(b < kMaxBlocks ? b : kMaxBlocks);
}

// Enqueue one kernel unit inside a C solve function: count it, and return
// its launch error from the enclosing function if there is one.
#define NSOL_UNIT(counts, idx, call)      \
  do {                                    \
    const cudaError_t e_ = (call);        \
    (counts)[idx] += 1;                   \
    if (e_ != cudaSuccess) return (int)e_; \
  } while (0)

#define GRID_STRIDE(i, n)                                                  \
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;     \
       i < (n); i += (long long)gridDim.x * blockDim.x)

// The voxels of block vb of a grid of G blocks of kThreads threads, as
// GRID_STRIDE walks them in that launch, thread t's: the pass bodies below
// take the block as an argument, so that a kernel launched with
// grid_for(n) blocks runs one (its own) and admm_persistent.cu's
// persistent blocks run each of the chain's blocks in turn, with the same
// threads on the same voxels.
#define BLOCK_STRIDE(i, n, vb, G, t)                                        \
  for (long long i = (long long)(vb) * kThreads + (t); i < (n);             \
       i += (long long)(G) * kThreads)

// Who runs a pass body's block of kThreads threads: here a whole CUDA
// block of kThreads (the standalone kernels), its thread t and block_sum's
// sum over it (valid in t = 0; a __syncthreads() between two calls).
// admm_persistent.cu's GroupTeam runs several in one CUDA block.
struct BlockTeam {
  __device__ static int tid() { return threadIdx.x; }
  __device__ static double sum(double v) { return block_sum(v); }
};

// scipy.ndimage wrap convolution along one axis:
// y[i] = sum_j k[j] u[(i + c - j) mod n], c = K / 2. The index walks down
// with wrap, so a stencil longer than the axis wraps as often as it must.
// kNc: the taps read through the read-only path (common.cuh's load_f).
// kK > 0: K = kK known at compile time, the tap loop unrolled (the same
// sums in the same order, every load issued at once).
template <bool kNc = true, int kK = 0, typename Fn>
__device__ __forceinline__ float wrap_conv(const Fn& load, long long base, int coord, int n,
                                           long long stride, const float* taps, int K) {
  if (kK > 0) {
    int m = (coord + kK / 2) % n;
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < kK; ++j) {
      acc = fmaf(load_f<kNc>(taps + j), load(base + (long long)m * stride), acc);
      m = (m == 0) ? n - 1 : m - 1;
    }
    return acc;
  }
  int m = (coord + K / 2) % n;
  float acc = 0.f;
  for (int j = 0; j < K; ++j) {
    acc = fmaf(load_f<kNc>(taps + j), load(base + (long long)m * stride), acc);
    m = (m == 0) ? n - 1 : m - 1;
  }
  return acc;
}

// The same convolution over a slab that carries its own halo, read with no
// wrap: y = sum_j k[j] u[base - j stride], base the address of the first
// tap's plane (the taps walk down as wrap_conv's do).
template <typename Fn>
__device__ __forceinline__ float slab_conv(const Fn& load, long long base, long long stride,
                                           const float* __restrict__ taps, int K) {
  float acc = 0.f;
  for (int j = 0; j < K; ++j) acc = fmaf(__ldg(taps + j), load(base - (long long)j * stride), acc);
  return acc;
}

// Zero-boundary D^T D along one axis: (u[i] - u[i-1]) [i > 0] + u[i] - u[i+1]
// with u[n] := 0, i.e. x[0] - x[1] on the first row and 2x[n-1] - x[n-2] on
// the last (nsol_tpu/ops/grad.py::gradient_normal).
template <typename Fn>
__device__ __forceinline__ float lap_axis(const Fn& u, long long i, int coord, int n,
                                          long long stride) {
  const float c = u(i);
  const float lo = coord > 0 ? __fsub_rn(c, u(i - stride)) : 0.f;
  const float hi = __fsub_rn(c, coord + 1 < n ? u(i + stride) : 0.f);
  return __fadd_rn(lo, hi);
}

// sum_ax (1/h_ax^2) D_ax^T D_ax u at voxel i (c its coordinates). The
// roundings are written out, ih2z az + (ih2x ax + ih2y ay) with both sums
// fused, so that every kernel that inlines it, and tiled.cu's
// ring_laplacian, give the same bits whatever the compiler would contract.
template <typename Fn>
__device__ __forceinline__ float laplacian(const Fn& u, long long i, Coord c, Spacing sp,
                                           Dims d) {
  const float ax = lap_axis(u, i, c.x, d.X, 1);
  const float ay = lap_axis(u, i, c.y, d.Y, d.X);
  const float az = lap_axis(u, i, c.z, d.Z, d.plane());
  return __fmaf_rn(sp.ih2z, az, __fmaf_rn(sp.ih2x, ax, __fmul_rn(sp.ih2y, ay)));
}

// The regulariser's normal operator B^T B in the epilogues: the
// zero-boundary Laplacian D^T D (TV, TK1) or the identity (TK0). It is a
// template parameter, so no instance tests it per voxel, and the identity
// reads neither neighbours nor coordinates (the compiler drops them).
enum RegKind { kRegLap = 0, kRegIdentity = 1 };

template <int kReg, typename Fn>
__device__ __forceinline__ float reg_normal(const Fn& u, long long i, Coord c, Spacing sp,
                                            Dims d) {
  if (kReg == kRegIdentity) return u(i);
  return laplacian(u, i, c, sp, d);
}

// ------------------------------------------------------------- sources --

// A volume of T read as float, rounded to As's precision (As = bf16 reads
// a float volume as the reference's astype(bfloat16) does).
// kNc: read through the read-only path (common.cuh's load_f).
template <class T, class As = T, bool kNc = true>
struct LoadT {
  using Dir = T;
  const T* p;
  __device__ void prepare() {}
  __device__ float operator()(long long k) const { return round_as<As>(load_f<kNc>(p + k)); }
  __device__ float dir(long long k) const { return (*this)(k); }
};
using Load = LoadT<float>;

// The CG direction p' = r + beta p (p' = r on the first trip), with beta
// read once from the device scalars, rounded to P (the direction's
// storage). Masked, the x pass convolves free * p' (the active-set CG of
// IRLS); the mask is a template parameter so that the unmasked tap loop
// tests nothing per tap. kNc: read through the read-only path.
template <bool kMasked, class R = float, class P = float, bool kNc = true>
struct DirectionT {
  using Dir = P;
  const R* r;
  const P* p;
  const float* free;
  const double* scal;
  int first;
  float beta;
  __device__ void prepare() { beta = first ? 0.f : (float)scal[kBeta]; }
  __device__ float dir(long long k) const {
    const float rk = load_f<kNc>(r + k);  // one address computation for both cases
    return round_as<P>(first ? rk : axpy_as<P>(beta, load_f<kNc>(p + k), rk));
  }
  __device__ float operator()(long long k) const {
    const float v = dir(k);
    return kMasked ? load_f<kNc>(free + k) * v : v;
  }
};
using Direction = DirectionT<false>;
using MaskedDirection = DirectionT<true>;

// -------------------------------------------------------------- passes --

// x pass: out = wrap conv of src along x; dir_out = src.dir when given.
// kK: the taps' length at compile time, or 0 (wrap_conv's); idx: how the
// voxels' coordinates are formed (DivIndex's interface); Team: who runs
// the block (BlockTeam's interface).
template <bool kNc, int kK = 0, class Team = BlockTeam, class Src, class Idx>
__device__ __forceinline__ void conv_x_body(const Src& src, float* out,
                                            typename Src::Dir* dir_out, const float* taps,
                                            int K, Dims d, const Idx& idx, int vb, int G) {
  const long long n = d.n();
  BLOCK_STRIDE(i, n, vb, G, Team::tid()) {
    const int ix = idx.x(i);
    const float conv = wrap_conv<kNc, kK>(src, i - ix, ix, d.X, 1, taps, K);
    // loads before the store to out; src.dir is already rounded to Dir
    if (dir_out != nullptr) dir_out[i] = store_as<typename Src::Dir>(src.dir(i));
    out[i] = conv;
  }
}

template <class Src>
__global__ void conv_x_pass(Src src, float* __restrict__ out,
                            typename Src::Dir* __restrict__ dir_out,
                            const float* __restrict__ taps, int K, Dims d) {
  src.prepare();
  conv_x_body<true>(src, out, dir_out, taps, K, d, DivIndex{d}, blockIdx.x, gridDim.x);
}

template <bool kNc, int kK = 0, class Team = BlockTeam, class Idx>
__device__ __forceinline__ void conv_y_body(const float* in, float* out, const float* taps, int K,
                                            Dims d, const Idx& idx, int vb, int G) {
  const LoadT<float, float, kNc> src{in};
  const long long n = d.n();
  BLOCK_STRIDE(i, n, vb, G, Team::tid()) {
    const int iy = idx.y(i);
    out[i] = wrap_conv<kNc, kK>(src, i - (long long)iy * d.X, iy, d.Y, d.X, taps, K);
  }
}

__global__ void conv_y_kernel(const float* __restrict__ in, float* __restrict__ out,
                              const float* __restrict__ taps, int K, Dims d) {
  conv_y_body<true>(in, out, taps, K, d, DivIndex{d}, blockIdx.x, gridDim.x);
}

// z pass: the epilogue gets every value of the wrap conv of t along z; what
// it returns is summed per block into partials[vb] when partials is given
// (uniform across the block). The coordinates are computed before the taps
// are read, so their integer divisions overlap the loads; an epilogue that
// reads none of them lets the compiler drop them. With kSlab, t is a
// window of d.Z + 2 h planes around the d.Z output planes (h >= K / 2),
// read with no wrap: out plane k takes t's planes k + h + K/2 - j.
template <bool kNc, bool kSlab, int kK = 0, class Team = BlockTeam, class Epi, class Idx>
__device__ __forceinline__ void conv_z_body(const float* t, const Epi& epi, double* partials,
                                            const float* taps, int K, Dims d, int h,
                                            const Idx& idx, int vb, int G) {
  const LoadT<float, float, kNc> src{t};
  const long long n = d.n(), plane = d.plane();
  double acc = 0.0;
  BLOCK_STRIDE(i, n, vb, G, Team::tid()) {
    const Coord c = idx.at(i);
    const float conv =
        kSlab ? slab_conv(src, i + (long long)(h + K / 2) * plane, plane, taps, K)
              : wrap_conv<kNc, kK>(src, i - (long long)c.z * plane, c.z, d.Z, plane, taps, K);
    acc += epi(i, conv, c, d);
  }
  if (partials != nullptr) {
    const double s = Team::sum(acc);
    if (Team::tid() == 0) partials[vb] = s;
  }
}

template <class Epi, bool kSlab = false>
__global__ void conv_z_pass(const float* __restrict__ t, Epi epi, double* __restrict__ partials,
                            const float* __restrict__ taps, int K, Dims d, int h) {
  conv_z_body<true, kSlab>(t, epi, partials, taps, K, d, h, DivIndex{d}, blockIdx.x, gridDim.x);
}

// The three passes of one blur chain: t1 = conv_x(src), t2 = conv_y(t1),
// then conv_z(t2) into the epilogue.
template <class Src, class Epi>
void blur_chain(Src src, typename Src::Dir* dir_out, Epi epi, double* partials, float* t1,
                float* t2, Taps tp, Dims d, cudaStream_t s) {
  const int g = grid_for(d.n());
  conv_x_pass<<<g, kThreads, 0, s>>>(src, t1, dir_out, tp.x, tp.kx, d);
  conv_y_kernel<<<g, kThreads, 0, s>>>(t1, t2, tp.y, tp.ky, d);
  conv_z_pass<<<g, kThreads, 0, s>>>(t2, epi, partials, tp.z, tp.kz, d, 0);
}

// The chain over a z-window: src holds d.Z + 2 h planes (the d.Z output
// planes and h halo planes on each side); the x and y passes run on all of
// them (t1, t2 hold as many), the z pass reads t2 with no wrap.
template <class Src, class Epi>
void blur_chain_slab(Src src, Epi epi, double* partials, float* t1, float* t2, Taps tp, Dims d,
                     int h, cudaStream_t s) {
  const Dims ext{d.Z + 2 * h, d.Y, d.X};
  const int ge = grid_for(ext.n());
  conv_x_pass<<<ge, kThreads, 0, s>>>(src, t1, nullptr, tp.x, tp.kx, ext);
  conv_y_kernel<<<ge, kThreads, 0, s>>>(t1, t2, tp.y, tp.ky, ext);
  conv_z_pass<Epi, true><<<grid_for(d.n()), kThreads, 0, s>>>(t2, epi, partials, tp.z, tp.kz, d,
                                                              h);
}

// An epilogue of a z-window that starts at global row row0 of a volume of
// z_total rows: Epi sees the voxel's global z and the global extent (so
// reg_normal's D_z^T D_z reads the halo rows as neighbours and takes the
// zero boundary only at global rows 0 and z_total - 1), and the local index
// i, by which it reads and writes the window's centre.
template <class Epi>
struct GlobalRows {
  Epi epi;
  int row0, z_total;
  __device__ double operator()(long long i, float conv, Coord c, Dims d) const {
    return epi(i, conv, Coord{c.x, c.y, row0 + c.z}, Dims{z_total, d.Y, d.X});
  }
};

// ------------------------------------------------------------------ CG --

// The CG scalars' update by a second stage's sum s (the reference's
// guards, fused.py:365-374, cg.py:86-92): scal[kGamma..kBeta] by the mode.
__device__ __forceinline__ void update_scalars(double* scal, double s, int mode) {
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

// Second stage: sum the partials in a fixed order and update the CG
// scalars.
__global__ void reduce_kernel(const double* __restrict__ partials, int nparts,
                              double* __restrict__ scal, int mode) {
  double acc = 0.0;
  for (int k = threadIdx.x; k < nparts; k += blockDim.x) acc += partials[k];
  const double s = block_sum(acc);
  if (threadIdx.x == 0) update_scalars(scal, s, mode);
}

// The sweep's scalar recurrence (blocked.py:1505-1509): a = g / pq,
// gamma = max(g - 2 a rq + a^2 qq, 0), beta = gamma / g (zero-guarded),
// beside the four dots, whose nparts partials each lie at partials[k *
// stride], k = g, pq, rq, qq (admm.cu's chain: stride kMaxBlocks; the
// march: its grid's blocks).
__global__ void sweep_reduce_kernel(const double* __restrict__ partials, int nparts, int stride,
                                    double* __restrict__ scal) {
  double dots[4];
  for (int k = 0; k < 4; ++k) {
    double acc = 0.0;
    for (int j = threadIdx.x; j < nparts; j += blockDim.x) acc += partials[k * stride + j];
    dots[k] = block_sum(acc);
    __syncthreads();
  }
  if (threadIdx.x != 0) return;
  const double g = dots[0], pq = dots[1], rq = dots[2], qq = dots[3];
  const double a = pq > 0.0 ? g / pq : 0.0;
  const double t = g - 2.0 * a * rq + a * a * qq;
  const double gn = t < 0.0 ? 0.0 : t;  // a NaN kept, as jnp.maximum keeps it
  scal[kGamma] = g;
  scal[kPQ] = pq;
  scal[kRQ] = rq;
  scal[kQQ] = qq;
  scal[kA] = a;
  scal[kBeta] = g > 0.0 ? gn / g : 0.0;
}

// x += a p; unless r is null, r' = r - a q (float, summed squared) and r
// = r' stored unless store_r is 0 (the "apply" CG under bf16 state forms
// its direction from the unrounded r' in cg_direction).
template <class Team = BlockTeam, class R, class P, class Q>
__device__ __forceinline__ void cg_update_body(float a, float* x, R* r, const P* p, const Q* q,
                                               double* partials, long long n, int store_r,
                                               int vb, int G) {
  double acc = 0.0;
  BLOCK_STRIDE(i, n, vb, G, Team::tid()) {
    x[i] = fmaf(a, to_float(p[i]), x[i]);
    if (r == nullptr) continue;
    const float ri = axpy_as<R>(-a, to_float(q[i]), to_float(r[i]));
    if (store_r) r[i] = store_as<R>(ri);
    acc += (double)ri * ri;
  }
  if (r == nullptr) return;
  const double s = Team::sum(acc);
  if (Team::tid() == 0) partials[vb] = s;
}

template <class R, class P, class Q>
__global__ void cg_update_kernel(float* __restrict__ x, R* __restrict__ r,
                                 const P* __restrict__ p, const Q* __restrict__ q,
                                 const double* __restrict__ scal, double* __restrict__ partials,
                                 long long n, int store_r) {
  cg_update_body((float)scal[kA], x, r, p, q, partials, n, store_r, blockIdx.x, gridDim.x);
}

// x += a p, r -= a q, then beta = |r|^2 / gamma (guarded), gamma = |r|^2;
// with r null, x += a p alone (the sweep's owed update).
template <class R, class P, class Q>
cudaError_t cg_update_t(float* x, R* r, const P* p, const Q* q, double* partials, double* scal,
                        long long n, int store_r, cudaStream_t s) {
  const int g = grid_for(n);
  cg_update_kernel<R, P, Q><<<g, kThreads, 0, s>>>(x, r, p, q, scal, partials, n, store_r);
  if (r != nullptr) reduce_kernel<<<1, kReduceThreads, 0, s>>>(partials, g, scal, kReduceRR);
  return cudaGetLastError();
}

inline cudaError_t cg_update(float* x, float* r, const float* p, const float* q,
                             double* partials, double* scal, long long n, cudaStream_t s) {
  return cg_update_t(x, r, p, q, partials, scal, n, 1, s);
}

}  // namespace
