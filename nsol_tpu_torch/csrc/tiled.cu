// Hopper (sm_90a) one-pass tiled kernels of the 512-wide-plane scale path.
//
// Counterparts of the (z, y)-blocked TPU Pallas kernels
//   nsol_tpu/ops/pallas/blocked.py::make_blocked_normal_operator_2d          (:754)
//   nsol_tpu/ops/pallas/blocked.py::make_blocked_cg_step_2d                  (:878)
//   nsol_tpu/ops/pallas/robust.py::make_blocked_blur_operator_2d             (:734)
//   nsol_tpu/ops/pallas/robust.py::make_blocked_weighted_normal_operator_2d  (:564)
// and of the CG solve around them, blocked.py::blocked_admm_solve (:1293,
// modes "apply" and "step2d"). Same f32 results as the per-axis units of
// admm.cu / robust.cu; what they add is the TPU kernels' one-pass design.
//
// Volumes are (Z, Y, X) float32, X contiguous. Four kernel units:
//
//   normal_apply_zy    q = N_z N_y N_x v + rho D^T D v (13 normal taps a side
//                      at sigma = 1); plain q, the CG residual rhs - q with
//                      sum (rhs - q)^2, or q with sum v.q (a = gamma / pq).
//   cg_step_zy         p' = r + beta p formed in the tile and written once,
//                      q = M p', sum p'.q; second stage a = gamma / pq.
//   blur_apply_zy      A y (7 blur taps a side at sigma = 1); with u,
//                      A y + rho D^T D u; the IRLS gradient form (active set
//                      free, rk = -free g, gamma = |rk|^2); the IRLS head form
//                      (r = A x - b, wts = rho'_C(r^2), y = wts r).
//   weighted_apply_zy  p' = r + beta p, pf = free p', s = wts A pf on the tile
//                      extended by the blur halo in z, y and x, then
//                      q = free (A s + rho D^T D pf) + (p' - pf) on the centre,
//                      sum p'.q. No volume holds A pf.
// plus cg_direction (p = r + beta p, the "apply" mode's CG direction),
// whose kernel is stream.cuh's stream_direction: bound by bytes, it moves
// them in 16-byte accesses (see the note there).
//
// Storage (blocked.py:1293's compact_dirs and state_dtype, "apply" mode):
// normal_apply_zy has bfloat16 instances (v and q in bf16, its dot taking
// the rounded q; the residual form reading x as bf16 and writing r and
// the first direction p = r in bf16). A bf16 window has no 2-byte
// cp.async: it is loaded, widened and stored into the float window at
// once, without the copy's overlap. cg_direction has typed instances and,
// under bf16 state, a deferred form that forms r' = r - a q again from
// the unrounded values (stream.cuh). weighted_apply_zy takes robust.cu's
// storage modes (stencil.cuh's RobustStorage): p and p' in bf16, the
// weights read as bf16 and the core rounded under kRobustIo
// (robust.py:564's io_dtype).
//
// Design. A thread block owns an output tile of kTileY rows x kTileX columns
// over up to kTileZ planes and marches through z. For each input plane it
// copies the halo-extended (y, x) window from device memory into shared
// memory with cp.async (double-buffered: the next plane's copy is in
// flight while this one is computed), does the x and y taps there, and
// pushes the xy-blurred plane into a ring of 2h+1 planes; once the ring
// holds a plane's z neighbourhood it applies the z taps and hands the value
// to an epilogue. The raw centre tiles (with a one-voxel halo) ride in a
// second ring for the Laplacian, whose two global boundary rows per axis
// come from the voxel's coordinates (grad.py::gradient_normal), not from
// the wrapped window. Wrap halos are indices taken modulo each axis, so a
// stencil longer than an axis wraps as often as it must. The weighted unit
// runs two such marches in one block: the first blurs pf onto the
// extended tile and multiplies by wts there, the second blurs that back to
// the centre.
//
// What bounds them on the H100: bytes. Each unit reads its inputs once from
// device memory up to its halo (z: (kTileZ + 2h) / kTileZ; y, x: the
// neighbouring tiles' halos mostly hit the 50 MB L2) and writes each output
// once; no intermediate volume reaches device memory. The tiles are far
// smaller than the TPU's (32, 128, 512) slab: shared memory holds 227 KB a
// block, and the card needs several blocks on each of its 132 SMs. No
// wgmma, TMA or warp specialisation yet: a simple kernel that is right.
//
// Reductions are deterministic: one float64 partial per block, summed in a
// fixed order by stencil.cuh's reduce_kernel.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "losses.cuh"
#include "stencil.cuh"
#include "stream.cuh"

namespace {

// Kernel units, the indices of the launch counts handed back to Python.
enum TiledUnit {
  kNormalApplyZy = 0,
  kCgStepZy = 1,
  kBlurApplyZy = 2,
  kWeightedApplyZy = 3,
  kCgDirection = 4
};

constexpr int kTileY = 16;
constexpr int kTileX = 32;  // one warp across a tile row
constexpr int kTileZ = 128;
constexpr int kStencilRows = 8;    // blockDim (kTileX, kStencilRows)
constexpr int kWeightedRows = kTileY;  // blockDim (kTileX, kWeightedRows)
constexpr int kStencilThreads = kTileX * kStencilRows;
constexpr int kWeightedThreads = kTileX * kWeightedRows;
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

// A (rows x w.n) loop over the linear index of the whole block: neighbouring
// threads take neighbouring elements, every lane busy.
#define TILE_LOOP(r, c, rows, w)                                                     \
  for (int e_ = thread_rank(), r = 0, c = 0; e_ < (rows) * (w).n;                   \
       e_ += blockDim.x * blockDim.y)                                                \
    if (r = (w).row(e_), c = e_ - r * (w).n, true)

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

// The block's constants in shared memory, once: the taps (z, y, x, one
// buffer) and the wrapped window's row offsets (y X) and columns, so that
// no loop over a plane divides.
__device__ void block_tables(float* taps, Taps tp, int* rows, int* cols, int y0, int x0, int hy,
                             int hx, int wy, int wx, Dims d) {
  const int nt = blockDim.x * blockDim.y;
  for (int i = thread_rank(); i < tp.kz + tp.ky + tp.kx; i += nt) taps[i] = tp.z[i];
  for (int i = thread_rank(); i < wy; i += nt) rows[i] = wrap_index(y0 - hy + i, d.Y) * d.X;
  for (int i = thread_rank(); i < wx; i += nt) cols[i] = wrap_index(x0 - hx + i, d.X);
}

// Start the asynchronous copy of one plane's (wy x wx) window into dst. A
// bfloat16 volume (or a float one read as bfloat16, As) has no 2-byte
// asynchronous copy: it is loaded, widened (rounded) and stored at once.
template <class T, class As = T>
__device__ __forceinline__ void copy_window(float* dst, const T* __restrict__ src,
                                             long long plane_off, const int* rows,
                                             const int* cols, int wy, Width w) {
  const T* plane = src + plane_off;
  if constexpr (std::is_same<T, float>::value && std::is_same<As, float>::value) {
    TILE_LOOP(r, c, wy, w)
    __pipeline_memcpy_async(dst + r * w.n + c, plane + rows[r] + cols[c], sizeof(float));
  } else {
    TILE_LOOP(r, c, wy, w) dst[r * w.n + c] = round_as<As>(ldg(plane + rows[r] + cols[c]));
  }
}

// A stencil over a (rows x w.n) tile: out(r, c, sum_j k[j] tap(r, c, j)).
// Each thread takes kR elements at once (its linear index + m threads), so
// that kR independent tap chains hide the shared-memory latency; elements
// past the tile read its last one and are not written.
template <int kR, class Tap, class Out>
__device__ __forceinline__ void row_taps(int rows, Width w, const float* k, int K, const Tap& tap,
                                         const Out& out) {
  const int nt = blockDim.x * blockDim.y, n = rows * w.n;
  for (int e0 = thread_rank(); e0 < n; e0 += kR * nt) {
    int r[kR], c[kR];
    float acc[kR];
#pragma unroll
    for (int m = 0; m < kR; ++m) {
      const int e = min(e0 + m * nt, n - 1);
      r[m] = w.row(e);
      c[m] = e - r[m] * w.n;
      acc[m] = 0.f;
    }
    for (int j = 0; j < K; ++j) {
      const float kj = k[j];
#pragma unroll
      for (int m = 0; m < kR; ++m) acc[m] = fmaf(kj, tap(r[m], c[m], j), acc[m]);
    }
#pragma unroll
    for (int m = 0; m < kR; ++m)
      if (e0 + m * nt < n) out(r[m], c[m], acc[m]);
  }
}

// x taps along the rows of a window: out[r][c] = sum_j k[j] in[r][c + off + cx - j]
// for r < rows, c < w.n (scipy.ndimage wrap convolution, the window
// holding the wrapped neighbours).
template <int kR>
__device__ __forceinline__ void taps_x(const float* in, int win_w, float* out, int rows, Width w,
                                       int off, const float* k, int K) {
  const int shift = off + K / 2, cols = w.n;
  row_taps<kR>(rows, w, k, K,
               [=](int r, int c, int j) { return in[r * win_w + c + shift - j]; },
               [=](int r, int c, float v) { out[r * cols + c] = v; });
}

// y taps down the columns: out[r][c] = sum_j k[j] in[r + off + cy - j][c].
template <int kR>
__device__ __forceinline__ void taps_y(const float* in, float* out, int rows, Width w, int off,
                                       const float* k, int K) {
  const int shift = off + K / 2, cols = w.n;
  row_taps<kR>(rows, w, k, K,
               [=](int r, int c, int j) { return in[(r + shift - j) * cols + c]; },
               [=](int r, int c, float v) { out[r * cols + c] = v; });
}

// z taps over a ring of planes of (rows x w.n) floats, fed to out:
// sum_j k[j] plane(step + cz - j), plane(s) in slot s % depth, s0 the slot
// of step + cz.
template <int kR, class Out>
__device__ __forceinline__ void taps_z(const float* ring, int depth, int rows, Width w, int s0,
                                       const float* k, int K, const Out& out) {
  const int cols = w.n, n = rows * cols;
  row_taps<kR>(rows, w, k, K,
               [=](int r, int c, int j) {
                 const int s = s0 - j;
                 return ring[(s < 0 ? s + depth : s) * n + r * cols + c];
               },
               out);
}

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
// (planes z - 1, z, z + 1); the zero boundary comes from the coordinates
// c, as stencil.cuh's lap_axis has it.
__device__ __forceinline__ float ring_laplacian(const float* zm, const float* zc, const float* zp,
                                                int o, Coord c, Spacing sp, Dims d) {
  const float u = zc[o];
  const auto axis = [u](float lo_v, float hi_v, int coord, int n) {
    const float lo = coord > 0 ? u - lo_v : 0.f;
    const float hi = u - (coord + 1 < n ? hi_v : 0.f);
    return lo + hi;
  };
  return sp.ih2x * axis(zc[o - 1], zc[o + 1], c.x, d.X) +
         sp.ih2y * axis(zc[o - kRawW], zc[o + kRawW], c.y, d.Y) +
         sp.ih2z * axis(zm[o], zp[o], c.z, d.Z);
}

// ------------------------------------------------------- single stencil --

// How a window of the inputs becomes the convolved plane and the Laplacian's
// source: one volume for both; the CG direction p' = r + beta p for both
// (written out on the tile's own planes); or a second volume u for the
// Laplacian.
enum SrcKind { kSrcOne = 0, kSrcDirection = 1, kSrcTwo = 2 };

// In: the storage of in0 (a single-input unit may read bfloat16), As the
// precision it is read at.
template <class In = float, class As = In>
struct StencilArgs {
  const In* in0;     // v, r, y or x
  const float* in1;  // p (kSrcDirection, not on the first trip) or u (kSrcTwo)
  float* dir_out;    // p' (kSrcDirection)
  const double* scal;
  int first;
  Taps tp;
  Spacing sp;
  Dims d;
  double* partials;
};

struct StencilGeo {
  int hy, hx, wy, wx, hd, ring_xy, ring_raw, nin;
  Width win;  // the window's row width wx
  __host__ __device__ int win_n() const { return wy * wx; }
};

inline StencilGeo stencil_geo(Taps tp, int nin) {
  StencilGeo g;
  g.hy = tp.ky / 2 > 1 ? tp.ky / 2 : 1;
  g.hx = tp.kx / 2 > 1 ? tp.kx / 2 : 1;
  g.hd = tp.kz / 2 > 1 ? tp.kz / 2 : 1;
  g.wy = kTileY + 2 * g.hy;
  g.wx = kTileX + 2 * g.hx;
  g.ring_xy = 2 * g.hd + 1;
  g.ring_raw = g.hd + 2;
  g.nin = nin;
  g.win = width_of(g.wx);
  return g;
}

inline size_t stencil_smem(const StencilGeo& g, Taps tp, bool lap) {
  const size_t words = (size_t)tp.kz + tp.ky + tp.kx + g.wy + g.wx +
                       2 * (size_t)g.nin * g.win_n() + g.win_n() + (size_t)g.wy * kTileX +
                       (size_t)g.ring_xy * kOutN + (lap ? (size_t)g.ring_raw * kRawN : 0);
  return words * 4;
}

// The march: epi(i, conv, lap, centre) returns a term of the block's
// reduction (the Laplacian and the centre value of its source are 0 when
// kLap is false).
template <int kSrc, bool kLap, class In, class As, class Epi>
__global__ void __launch_bounds__(kStencilThreads)
    stencil_zy_kernel(StencilArgs<In, As> a, StencilGeo g, Epi epi) {
  extern __shared__ float smem[];
  const Dims d = a.d;
  const int wn = g.win_n();
  const int nk = a.tp.kz + a.tp.ky + a.tp.kx;
  float* tz = smem;  // taps: z, y, x
  const float* ty = tz + a.tp.kz;
  const float* tx = ty + a.tp.ky;
  int* rows = reinterpret_cast<int*>(smem + nk);
  int* cols = rows + g.wy;
  float* win = reinterpret_cast<float*>(cols + g.wx);  // [2][nin][wn], cp.async targets
  float* cwin = win + 2 * g.nin * wn;                   // p' on the window
  float* xt = cwin + wn;                                // x taps, wy x kTileX
  float* ring_xy = xt + g.wy * kTileX;                  // xy-blurred planes
  float* ring_raw = ring_xy + g.ring_xy * kOutN;        // Laplacian source, halo 1
  const int x0 = blockIdx.x * kTileX, y0 = blockIdx.y * kTileY, z0 = blockIdx.z * kTileZ;
  const int nz = min(kTileZ, d.Z - z0);
  const int pstart = z0 - g.hd, np = nz + 2 * g.hd;
  const bool dir = kSrc == kSrcDirection && !a.first;
  const bool has_in1 = kSrc == kSrcTwo || dir;
  const float beta = dir ? (float)a.scal[kBeta] : 0.f;
  block_tables(tz, a.tp, rows, cols, y0, x0, g.hy, g.hx, g.wy, g.wx, d);
  __syncthreads();

  auto start_copy = [&](int k) {
    const long long off = (long long)wrap_index(pstart + k, d.Z) * d.plane();
    float* dst = win + (k & 1) * g.nin * wn;
    copy_window<In, As>(dst, a.in0, off, rows, cols, g.wy, g.win);
    if (has_in1) copy_window(dst + wn, a.in1, off, rows, cols, g.wy, g.win);
  };

  double acc = 0.0;
  start_copy(0);
  __pipeline_commit();
  // kr, kx: the slots of step k in the raw and the xy ring
  for (int k = 0, kr = 0, kx = 0; k < np;
       ++k, kr = slot_next(kr, g.ring_raw), kx = slot_next(kx, g.ring_xy)) {
    if (k + 1 < np) start_copy(k + 1);
    __pipeline_commit();
    __pipeline_wait_prior(1);
    __syncthreads();
    const float* w0 = win + (k & 1) * g.nin * wn;
    const float* w1 = w0 + wn;
    const int pz = pstart + k;
    // the convolved source (p' formed once), the Laplacian's raw tile, p' out
    if (dir) TILE_LOOP(r, c, g.wy, g.win) cwin[e_] = __fmaf_rn(beta, w1[e_], w0[e_]);
    if (kLap) {
      float* raw = ring_raw + kr * kRawN;
      TILE_LOOP(r, c, kTileY + 2, width_of(kRawW)) {
        const int we = (r - 1 + g.hy) * g.wx + c - 1 + g.hx;
        raw[e_] = kSrc == kSrcTwo ? w1[we] : dir ? __fmaf_rn(beta, w1[we], w0[we])
                                                            : w0[we];
      }
    }
    if (kSrc == kSrcDirection && pz >= z0 && pz < z0 + nz) {
      TILE_LOOP(oy, ox, kTileY, width_of(kTileX)) {
        const int y = y0 + oy, x = x0 + ox;
        if (y >= d.Y || x >= d.X) continue;
        const int we = (oy + g.hy) * g.wx + ox + g.hx;
        a.dir_out[(long long)pz * d.plane() + (long long)y * d.X + x] =
            dir ? __fmaf_rn(beta, w1[we], w0[we]) : w0[we];
      }
    }
    __syncthreads();
    taps_x<4>(dir ? cwin : w0, g.wx, xt, g.wy, width_of(kTileX), g.hx, tx, a.tp.kx);
    __syncthreads();
    taps_y<2>(xt, ring_xy + kx * kOutN, kTileY, width_of(kTileX), g.hy, ty, a.tp.ky);
    __syncthreads();
    if (k < 2 * g.hd) continue;
    // output plane z = pstart + k - hd, whose z neighbourhood is in the ring
    const int step = k - g.hd;
    const int z = pstart + step;
    const int s0 = slot_back(kx, g.hd - a.tp.kz / 2, g.ring_xy);
    const float* zm = ring_raw + slot_back(kr, g.hd + 1, g.ring_raw) * kRawN;
    const float* zc = ring_raw + slot_back(kr, g.hd, g.ring_raw) * kRawN;
    const float* zp = ring_raw + slot_back(kr, g.hd - 1, g.ring_raw) * kRawN;
    taps_z<2>(ring_xy, g.ring_xy, kTileY, width_of(kTileX), s0, tz, a.tp.kz,
              [&](int oy, int ox, float conv) {
                const Coord c{x0 + ox, y0 + oy, z};
                if (c.y >= d.Y || c.x >= d.X) return;
                float lap = 0.f, centre = 0.f;
                if (kLap) {
                  const int o = (oy + 1) * kRawW + ox + 1;
                  lap = ring_laplacian(zm, zc, zp, o, c, a.sp, d);
                  centre = zc[o];
                }
                const long long i = (long long)z * d.plane() + (long long)c.y * d.X + c.x;
                acc += epi(i, conv, lap, centre);
              });
  }
  if (a.partials != nullptr) {
    const double s = tile_sum(acc);
    if (thread_rank() == 0) a.partials[block_index()] = s;
  }
}

// ---------------------------------------------------------- epilogues --

// q = conv + rho lap stored as O; plain q, the residual rhs - q (q rounded
// to O first; summed squared, stored as O, and as the first CG direction
// p_out of type P when given), or q with centre.q summed (centre: v, or
// p'; q after its rounding, as the reference's "apply" CG reads it back).
enum NormalMode { kNormalPlain = 0, kNormalResidual = 1, kNormalDot = 2 };

template <int kMode, class O = float, class P = float>
struct NormalZyEpi {
  const float* rhs;
  O* out;
  P* p_out;
  float rho;
  __device__ double operator()(long long i, float conv, float lap, float centre) const {
    const float q = fmaf(rho, lap, conv);
    if (kMode == kNormalResidual) {
      const float res = rhs[i] - round_as<O>(q);
      out[i] = store_as<O>(res);
      if (p_out != nullptr) p_out[i] = store_as<P>(res);
      return (double)res * res;
    }
    out[i] = store_as<O>(q);
    return kMode == kNormalDot ? (double)centre * round_as<O>(q) : 0.0;
  }
};

// blur_apply_zy: g = conv (+ rho lap u) into out.
struct BlurZyEpi {
  float* out;
  float rho;
  int lap;
  __device__ double operator()(long long i, float conv, float l, float) const {
    out[i] = lap ? fmaf(rho, l, conv) : conv;
    return 0.0;
  }
};

// The IRLS gradient (centre = x): free = !(x <= 0 && g > 0), rk = -free g.
struct GradZyEpi {
  float* free;
  float* rk;
  float rho;
  __device__ double operator()(long long i, float conv, float l, float x) const {
    const float g = fmaf(rho, l, conv);
    const bool active = x <= 0.f && g > 0.f;
    const float r = active ? 0.f : -g;
    free[i] = active ? 0.f : 1.f;
    rk[i] = r;
    return (double)r * r;
  }
};

// The IRLS head: r = A x - b, wts = rho'_C(r^2), y = wts r.
struct HeadZyEpi {
  const float* b;
  float* wts;
  float* y;
  float fs2;
  int loss;
  __device__ double operator()(long long i, float conv, float, float) const {
    const float r = __fsub_rn(conv, __ldg(b + i));
    const float w = loss_weight(__fmul_rn(r, r), fs2, loss);
    wts[i] = w;
    y[i] = __fmul_rn(w, r);
    return 0.0;
  }
};

inline dim3 tiled_grid(Dims d) {
  return dim3((d.X + kTileX - 1) / kTileX, (d.Y + kTileY - 1) / kTileY,
              (d.Z + kTileZ - 1) / kTileZ);
}

inline int tiled_blocks(Dims d) {
  const dim3 g = tiled_grid(d);
  return (int)(g.x * g.y * g.z);
}

template <int kSrc, bool kLap, class In, class As, class Epi>
cudaError_t launch_stencil(const StencilArgs<In, As>& a, int nin, Epi epi, cudaStream_t s) {
  const StencilGeo g = stencil_geo(a.tp, nin);
  const size_t smem = stencil_smem(g, a.tp, kLap);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = stencil_zy_kernel<kSrc, kLap, In, As, Epi>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  kernel<<<tiled_grid(a.d), dim3(kTileX, kStencilRows), smem, s>>>(a, g, epi);
  return cudaGetLastError();
}

// ------------------------------------------------------------- weighted --

struct WeightedArgs {
  const float* r;
  const void* p;  // stored as the storage mode's P
  const float* free;
  const float* wts;
  void* p_new;
  float* q;
  const double* scal;
  int first;
  float rho;
  Taps tp;
  Spacing sp;
  Dims d;
  double* partials;
};

struct WeightedGeo {
  int hy, hx, hd;     // blur halo (>= 1)
  int ey, ex;         // the extended tile: kTile + 2 h
  int wy, wx;         // the input window: kTile + 4 h
  int ring1, ring2, ring_pf;
  Width win, ext;  // row widths wx and ex
};

inline WeightedGeo weighted_geo(Taps tp) {
  WeightedGeo g;
  g.hy = tp.ky / 2 > 1 ? tp.ky / 2 : 1;
  g.hx = tp.kx / 2 > 1 ? tp.kx / 2 : 1;
  g.hd = tp.kz / 2 > 1 ? tp.kz / 2 : 1;
  g.ey = kTileY + 2 * g.hy;
  g.ex = kTileX + 2 * g.hx;
  g.wy = kTileY + 4 * g.hy;
  g.wx = kTileX + 4 * g.hx;
  g.ring1 = 2 * g.hd + 1;
  g.ring2 = 2 * g.hd + 1;
  g.ring_pf = 2 * g.hd + 2;
  g.win = width_of(g.wx);
  g.ext = width_of(g.ex);
  return g;
}

inline size_t weighted_smem(const WeightedGeo& g, Taps tp) {
  const size_t wn = (size_t)g.wy * g.wx, en = (size_t)g.ey * g.ex;
  const size_t words = (size_t)tp.kz + tp.ky + tp.kx + g.wy + g.wx + 2 * 3 * wn + 2 * en + wn +
                       (size_t)g.wy * g.ex + g.ring1 * en + (size_t)g.ring2 * kOutN +
                       (size_t)g.ring_pf * kRawN;
  return words * 4;
}

// Two marches in one block. Step k loads plane pstart + k of r, p and free
// (window halo 2h) and forms pf = free p'; the first stage blurs pf in x
// and y onto the extended tile (halo h) and, hd planes later, in z, then
// multiplies by wts there (s = wts A pf, never in device memory); the
// second stage blurs s in x and y onto the centre and, hd planes later, in
// z, then forms q = free (A s + rho D^T D pf) + (p' - pf). The centre p'
// and free of the output plane are read again from device memory (an L2
// hit: the block read them 2 hd planes before) rather than held in rings.
// S (RobustT): p and p' stored as S::P (a bfloat16 p is loaded without
// cp.async), p' = r + beta p rounded to S::P where it is formed, the
// weights read at S::W and, with S::kIo, the core rounded to bfloat16.
template <bool kMasked, class S>
__global__ void __launch_bounds__(kWeightedThreads) weighted_zy_kernel(WeightedArgs a,
                                                                       WeightedGeo g) {
  using P = typename S::P;
  extern __shared__ float smem[];
  const Dims d = a.d;
  const int wn = g.wy * g.wx, en = g.ey * g.ex;
  const int nk = a.tp.kz + a.tp.ky + a.tp.kx;
  float* tz = smem;  // taps: z, y, x
  const float* ty = tz + a.tp.kz;
  const float* tx = ty + a.tp.ky;
  int* rows = reinterpret_cast<int*>(smem + nk);
  int* cols = rows + g.wy;
  float* win = reinterpret_cast<float*>(cols + g.wx);  // [2][3][wn]: r, p, free
  float* wwin = win + 6 * wn;                           // [2][en]: wts on the extended tile
  float* cwin = wwin + 2 * en;                          // pf; later A s in x (ey x kTileX)
  float* xt1 = cwin + wn;                               // wy x ex; later s on the extended tile
  float* ring1 = xt1 + g.wy * g.ex;                     // A pf in x, y: [ring1][en]
  float* ring2 = ring1 + g.ring1 * en;                  // A s in x, y: [ring2][kOutN]
  float* ring_pf = ring2 + g.ring2 * kOutN;             // pf with halo 1
  float* sext = xt1;
  float* xt2 = cwin;
  const int x0 = blockIdx.x * kTileX, y0 = blockIdx.y * kTileY, z0 = blockIdx.z * kTileZ;
  const int nz = min(kTileZ, d.Z - z0);
  const int pstart = z0 - 2 * g.hd, np = nz + 4 * g.hd;
  const float beta = a.first ? 0.f : (float)a.scal[kBeta];
  block_tables(tz, a.tp, rows, cols, y0, x0, 2 * g.hy, 2 * g.hx, g.wy, g.wx, d);
  __syncthreads();

  // step k loads plane pstart + k of r, p, free and, for the first stage's
  // output at step k, the weights of plane pstart + k - hd
  auto start_copy = [&](int k) {
    const long long off = (long long)wrap_index(pstart + k, d.Z) * d.plane();
    float* dst = win + (k & 1) * 3 * wn;
    copy_window(dst, a.r, off, rows, cols, g.wy, g.win);
    if (!a.first) copy_window(dst + wn, static_cast<const P*>(a.p), off, rows, cols, g.wy, g.win);
    if (kMasked) copy_window(dst + 2 * wn, a.free, off, rows, cols, g.wy, g.win);
    if (k >= 2 * g.hd)
      copy_window<float, typename S::W>(wwin + (k & 1) * en, a.wts,
                                        (long long)wrap_index(pstart + k - g.hd, d.Z) * d.plane(),
                                        rows + g.hy, cols + g.hx, g.ey, g.ext);
  };
  // p' = r + beta p, rounded to P (product and sum apart for bfloat16)
  const auto dir_of = [&](float rv, float pv) {
    return round_as<P>(a.first ? rv : axpy_as<P>(beta, pv, rv));
  };
  const auto pf_of = [&](const float* wr, const float* wp, const float* wf, int e) {
    const float v = dir_of(wr[e], a.first ? 0.f : wp[e]);
    return kMasked ? wf[e] * v : v;
  };

  // the centre r, p and free of the output plane of step kk, read from
  // device memory one step ahead (an L2 hit: the block read them 2 hd
  // planes before) so that their latency hides behind a step
  const int oy = threadIdx.y, ox = threadIdx.x;  // one output a thread
  const bool own = y0 + oy < d.Y && x0 + ox < d.X;
  const auto fetch = [&](int kk, float& r_out, float& p_out, float& f_out) {
    if (kk < 4 * g.hd || kk >= np || !own) return;
    const long long i = (long long)(pstart + kk - 2 * g.hd) * d.plane() +
                        (long long)(y0 + oy) * d.X + x0 + ox;
    r_out = __ldg(a.r + i);
    if (!a.first) p_out = ldg(static_cast<const P*>(a.p) + i);
    if (kMasked) f_out = __ldg(a.free + i);
  };
  float rv = 0.f, pv = 0.f, f = 1.f, rv_next = 0.f, pv_next = 0.f, f_next = 1.f;

  double acc = 0.0;
  start_copy(0);
  __pipeline_commit();
  // kf, k1: the slots of step k in the pf ring and in rings 1 and 2
  for (int k = 0, kf = 0, k1 = 0; k < np;
       ++k, kf = slot_next(kf, g.ring_pf), k1 = slot_next(k1, g.ring1)) {
    if (k + 1 < np) start_copy(k + 1);
    __pipeline_commit();
    rv = rv_next, pv = pv_next, f = f_next;
    fetch(k + 1, rv_next, pv_next, f_next);
    __pipeline_wait_prior(1);
    __syncthreads();
    const float* wr = win + (k & 1) * 3 * wn;
    const float* wp = wr + wn;
    const float* wf = wr + 2 * wn;
    const int pz = pstart + k;
    // pf on the window and its centre tile (halo 1); p' out on own planes
    TILE_LOOP(r, c, g.wy, g.win) cwin[e_] = pf_of(wr, wp, wf, e_);
    float* rp = ring_pf + kf * kRawN;
    TILE_LOOP(r, c, kTileY + 2, width_of(kRawW))
    rp[e_] = pf_of(wr, wp, wf, (r - 1 + 2 * g.hy) * g.wx + c - 1 + 2 * g.hx);
    if (pz >= z0 && pz < z0 + nz) {
      TILE_LOOP(oy, ox, kTileY, width_of(kTileX)) {
        const int y = y0 + oy, x = x0 + ox;
        if (y >= d.Y || x >= d.X) continue;
        const int we = (oy + 2 * g.hy) * g.wx + ox + 2 * g.hx;
        static_cast<P*>(a.p_new)[(long long)pz * d.plane() + (long long)y * d.X + x] =
            store_as<P>(dir_of(wr[we], a.first ? 0.f : wp[we]));
      }
    }
    __syncthreads();
    // first stage: A pf in x and y on the extended tile
    taps_x<3>(cwin, g.wx, xt1, g.wy, g.ext, g.hx, tx, a.tp.kx);
    __syncthreads();
    taps_y<2>(xt1, ring1 + k1 * en, g.ey, g.ext, g.hy, ty, a.tp.ky);
    __syncthreads();
    if (k < 2 * g.hd) continue;
    // z taps: s = wts A pf of plane pstart + k - hd on the extended tile
    const float* ww = wwin + (k & 1) * en;
    const int s1 = slot_back(k1, g.hd - a.tp.kz / 2, g.ring1);
    const int ex = g.ex;
    taps_z<2>(ring1, g.ring1, g.ey, g.ext, s1, tz, a.tp.kz, [=](int r, int c, float conv) {
      sext[r * ex + c] = __fmul_rn(ww[r * ex + c], conv);
    });
    __syncthreads();
    // second stage: A s in x and y onto the centre
    taps_x<2>(sext, g.ex, xt2, g.ey, width_of(kTileX), g.hx, tx, a.tp.kx);
    __syncthreads();
    taps_y<1>(xt2, ring2 + k1 * kOutN, kTileY, width_of(kTileX), g.hy, ty, a.tp.ky);
    __syncthreads();
    if (k < 4 * g.hd) continue;
    // output plane z = pstart + k - 2 hd: z taps of A s, the masked apply
    const int step = k - 2 * g.hd;
    const int z = pstart + step;
    const int s2 = slot_back(k1, g.hd - a.tp.kz / 2, g.ring2);
    const float* pm = ring_pf + slot_back(kf, 2 * g.hd + 1, g.ring_pf) * kRawN;
    const float* pc = ring_pf + slot_back(kf, 2 * g.hd, g.ring_pf) * kRawN;
    const float* pp = ring_pf + slot_back(kf, 2 * g.hd - 1, g.ring_pf) * kRawN;
    if (!own) continue;
    const Coord c{x0 + ox, y0 + oy, z};
    const long long i = (long long)z * d.plane() + (long long)c.y * d.X + c.x;
    const int e = oy * kTileX + ox;
    float conv = 0.f;
    for (int j = 0, sl = s2; j < a.tp.kz; ++j, sl = sl == 0 ? g.ring2 - 1 : sl - 1)
      conv = fmaf(tz[j], ring2[sl * kOutN + e], conv);
    float core =
        fmaf(a.rho, ring_laplacian(pm, pc, pp, (oy + 1) * kRawW + ox + 1, c, a.sp, d), conv);
    if (S::kIo) core = round_as<bf16>(core);
    const float p = dir_of(rv, pv);
    float qi = core;
    if (kMasked) qi = __fadd_rn(__fmul_rn(f, core), __fsub_rn(p, __fmul_rn(f, p)));
    a.q[i] = qi;
    acc += (double)p * qi;
  }
  const double s = tile_sum(acc);
  if (thread_rank() == 0) a.partials[block_index()] = s;
}

// ---------------------------------------------------------------- units --

// The residual form: x read at O's precision, r stored as O and, when p_out
// is given, the first CG direction p = r as P.
template <class O, class P>
cudaError_t normal_residual_zy(const float* x, O* out, P* p_out, const float* rhs,
                               double* partials, double* scal, Taps tp, float rho, Spacing sp,
                               Dims d, cudaStream_t s) {
  const StencilArgs<float, O> a{x, nullptr, nullptr, scal, 1, tp, sp, d, partials};
  const cudaError_t e = launch_stencil<kSrcOne, true>(
      a, 1, NormalZyEpi<kNormalResidual, O, P>{rhs, out, p_out, rho}, s);
  if (e != cudaSuccess) return e;
  reduce_kernel<<<1, kReduceThreads, 0, s>>>(partials, tiled_blocks(d), scal, kReduceRR0);
  return cudaGetLastError();
}

// v and q stored as T: plain q, or (scal given) q with pq = sum v.q.
template <class T>
cudaError_t normal_apply_zy_t(const T* v, T* out, double* partials, double* scal, Taps tp,
                              float rho, Spacing sp, Dims d, cudaStream_t s) {
  StencilArgs<T> a{v, nullptr, nullptr, scal, 1, tp, sp, d, nullptr};
  cudaError_t e;
  if (scal != nullptr) {
    a.partials = partials;
    e = launch_stencil<kSrcOne, true>(a, 1, NormalZyEpi<kNormalDot, T>{nullptr, out, nullptr, rho},
                                      s);
    if (e != cudaSuccess) return e;
    reduce_kernel<<<1, kReduceThreads, 0, s>>>(partials, tiled_blocks(d), scal, kReducePQ);
  } else {
    e = launch_stencil<kSrcOne, true>(a, 1,
                                      NormalZyEpi<kNormalPlain, T>{nullptr, out, nullptr, rho}, s);
    if (e != cudaSuccess) return e;
  }
  return cudaGetLastError();
}

// io 0: float v and out; io 1: bfloat16 out, and v bfloat16 (plain and dot
// forms) or a float x read as bfloat16 (residual form). p_out (residual
// form): float when p_bf16 is 0, else bfloat16.
cudaError_t normal_apply_zy(const void* v, void* out, const float* rhs, void* p_out, int p_bf16,
                            double* partials, double* scal, Taps tp, float rho, int io,
                            Spacing sp, Dims d, cudaStream_t s) {
  if (rhs != nullptr) {
    const float* x = static_cast<const float*>(v);
    if (io) {
      if (!p_bf16 && p_out != nullptr) return cudaErrorInvalidValue;
      return normal_residual_zy(x, static_cast<bf16*>(out), static_cast<bf16*>(p_out), rhs,
                                partials, scal, tp, rho, sp, d, s);
    }
    if (p_bf16)
      return normal_residual_zy(x, static_cast<float*>(out), static_cast<bf16*>(p_out), rhs,
                                partials, scal, tp, rho, sp, d, s);
    return normal_residual_zy(x, static_cast<float*>(out), static_cast<float*>(p_out), rhs,
                              partials, scal, tp, rho, sp, d, s);
  }
  if (io)
    return normal_apply_zy_t(static_cast<const bf16*>(v), static_cast<bf16*>(out), partials, scal,
                             tp, rho, sp, d, s);
  return normal_apply_zy_t(static_cast<const float*>(v), static_cast<float*>(out), partials, scal,
                           tp, rho, sp, d, s);
}

cudaError_t cg_step_zy(const float* r, const float* p, float* p_new, float* q, double* partials,
                       double* scal, int first, Taps tp, float rho, Spacing sp, Dims d,
                       cudaStream_t s) {
  const StencilArgs<> a{r, first ? nullptr : p, p_new, scal, first, tp, sp, d, partials};
  const cudaError_t e = launch_stencil<kSrcDirection, true>(
      a, 2, NormalZyEpi<kNormalDot>{nullptr, q, nullptr, rho}, s);
  if (e != cudaSuccess) return e;
  reduce_kernel<<<1, kReduceThreads, 0, s>>>(partials, tiled_blocks(d), scal, kReducePQ);
  return cudaGetLastError();
}

// Forms by the pointers given: head (b: wts, yout from A x - b), gradient
// (free: free, rk from A y + rho D^T D x, gamma), with u (A y + rho D^T D u),
// or plain A y.
cudaError_t blur_apply_zy(const float* y, const float* u, float* out, float* free, float* rk,
                          const float* b, float* wts, float* yout, double* partials,
                          double* scal, Taps tp, float rho, int loss, float scale, Spacing sp,
                          Dims d, cudaStream_t s) {
  StencilArgs<> a{y, u, nullptr, scal, 1, tp, sp, d, nullptr};
  cudaError_t e;
  if (b != nullptr) {
    e = launch_stencil<kSrcOne, false>(a, 1, HeadZyEpi{b, wts, yout, scale * scale, loss}, s);
  } else if (free != nullptr) {
    a.partials = partials;
    e = launch_stencil<kSrcTwo, true>(a, 2, GradZyEpi{free, rk, rho}, s);
    if (e != cudaSuccess) return e;
    reduce_kernel<<<1, kReduceThreads, 0, s>>>(partials, tiled_blocks(d), scal, kReduceRR0);
  } else if (u != nullptr) {
    e = launch_stencil<kSrcTwo, true>(a, 2, BlurZyEpi{out, rho, 1}, s);
  } else {
    e = launch_stencil<kSrcOne, false>(a, 1, BlurZyEpi{out, rho, 0}, s);
  }
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <bool kMasked, class S>
cudaError_t launch_weighted(const WeightedArgs& a, const WeightedGeo& g, size_t smem,
                            cudaStream_t s) {
  const cudaError_t e = cudaFuncSetAttribute(weighted_zy_kernel<kMasked, S>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)smem);
  if (e != cudaSuccess) return e;
  weighted_zy_kernel<kMasked, S><<<tiled_grid(a.d), dim3(kTileX, kWeightedRows), smem, s>>>(a,
                                                                                           g);
  return cudaGetLastError();
}

// p and p_new stored as the RobustStorage mode `storage` says.
cudaError_t weighted_apply_zy(const float* r, const void* p, void* p_new, float* q,
                              const float* free, const float* wts, double* partials,
                              double* scal, int first, Taps tp, float rho, int storage,
                              Spacing sp, Dims d, cudaStream_t s) {
  const WeightedArgs a{r, p, free, wts, p_new, q, scal, first, rho, tp, sp, d, partials};
  const WeightedGeo g = weighted_geo(tp);
  const bool masked = free != nullptr;
  const size_t smem = weighted_smem(g, tp);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t e = with_robust_storage(storage, [&](auto st) {
    using S = decltype(st);
    return masked ? launch_weighted<true, S>(a, g, smem, s)
                  : launch_weighted<false, S>(a, g, smem, s);
  });
  if (e != cudaSuccess) return e;
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  reduce_kernel<<<1, kReduceThreads, 0, s>>>(partials, tiled_blocks(d), scal, kReducePQ);
  return cudaGetLastError();
}


}  // namespace

// ------------------------------------------------------------ C interface --
// Every function enqueues on `stream`, never synchronizes, allocates
// nothing, adds one to counts[unit] per unit it launches, and returns
// cudaGetLastError() (0 on success; cudaErrorInvalidValue when a stencil
// is too long for the tile's shared memory). Spacing enters as 1/h^2 in
// (x, y, z) order. partials holds nsol_tiled_blocks(Z, Y, X) doubles.

extern "C" {

// admm.cu's units, which add to their own counts (admm.cu's Unit enum).
int nsol_cg_update(float* x, void* r, const void* p, const void* q, double* partials,
                   double* scal, long long n, int storage, int store_r, void* stream,
                   long long* counts);
int nsol_admm_tail(float* x, float* v, float* w, const float* atb, float* rhs, float ihx,
                   float ihy, float ihz, float tau, float rho, int init, int Z, int Y, int X,
                   void* stream, long long* counts);

int nsol_tiled_blocks(int Z, int Y, int X) { return tiled_blocks(Dims{Z, Y, X}); }

// Bytes of shared memory one block takes for stencils of lengths (kz, ky,
// kx): weighted_apply_zy's (weighted != 0), or a single-stencil unit's over
// nin input windows with (lap != 0) or without the Laplacian's ring. A
// launch past kMaxSmem returns cudaErrorInvalidValue; ops/cuda/tiled.py
// computes the same sizes to route such stencils before any launch.
int nsol_tiled_smem(int kz, int ky, int kx, int nin, int lap, int weighted) {
  const Taps tp{nullptr, nullptr, nullptr, kz, ky, kx};
  const size_t b = weighted ? weighted_smem(weighted_geo(tp), tp)
                            : stencil_smem(stencil_geo(tp, nin), tp, lap != 0);
  return b > 0x7fffffffu ? 0x7fffffff : (int)b;
}

// io and p_out, p_bf16 as normal_apply_zy above takes them.
int nsol_normal_apply_zy(const void* v, void* out, const float* rhs, void* p_out, int p_bf16,
                         double* partials, double* scal, const float* taps, int kz, int ky,
                         int kx, float rho, int io, float ih2x, float ih2y, float ih2z, int Z,
                         int Y, int X, void* stream, long long* counts) {
  const Spacing sp{0.f, 0.f, 0.f, ih2x, ih2y, ih2z};
  const cudaError_t e = normal_apply_zy(v, out, rhs, p_out, p_bf16, partials, scal,
                                        make_taps(taps, kz, ky, kx), rho, io, sp, Dims{Z, Y, X},
                                        (cudaStream_t)stream);
  counts[kNormalApplyZy] += 1;
  return (int)e;
}

int nsol_cg_step_zy(const float* r, const float* p, float* p_new, float* q, double* partials,
                    double* scal, int first, const float* taps, int kz, int ky, int kx,
                    float rho, float ih2x, float ih2y, float ih2z, int Z, int Y, int X,
                    void* stream, long long* counts) {
  const Spacing sp{0.f, 0.f, 0.f, ih2x, ih2y, ih2z};
  const cudaError_t e = cg_step_zy(r, p, p_new, q, partials, scal, first,
                                   make_taps(taps, kz, ky, kx), rho, sp, Dims{Z, Y, X},
                                   (cudaStream_t)stream);
  counts[kCgStepZy] += 1;
  return (int)e;
}

int nsol_blur_apply_zy(const float* y, const float* u, float* out, float* free, float* rk,
                       const float* b, float* wts, float* yout, double* partials, double* scal,
                       const float* taps, int kz, int ky, int kx, float rho, int loss,
                       float scale, float ih2x, float ih2y, float ih2z, int Z, int Y, int X,
                       void* stream, long long* counts) {
  const Spacing sp{0.f, 0.f, 0.f, ih2x, ih2y, ih2z};
  const cudaError_t e = blur_apply_zy(y, u, out, free, rk, b, wts, yout, partials, scal,
                                      make_taps(taps, kz, ky, kx), rho, loss, scale, sp,
                                      Dims{Z, Y, X}, (cudaStream_t)stream);
  counts[kBlurApplyZy] += 1;
  return (int)e;
}

// p, p_new stored as the RobustStorage mode `storage` says.
int nsol_weighted_apply_zy(const float* r, const void* p, void* p_new, float* q,
                           const float* free, const float* wts, double* partials, double* scal,
                           int first, const float* taps, int kz, int ky, int kx, float rho,
                           int storage, float ih2x, float ih2y, float ih2z, int Z, int Y, int X,
                           void* stream, long long* counts) {
  const Spacing sp{0.f, 0.f, 0.f, ih2x, ih2y, ih2z};
  const cudaError_t e = weighted_apply_zy(r, first ? nullptr : p, p_new, q, free, wts, partials,
                                          scal, first, make_taps(taps, kz, ky, kx), rho, storage,
                                          sp, Dims{Z, Y, X}, (cudaStream_t)stream);
  counts[kWeightedApplyZy] += 1;
  return (int)e;
}

// q given: the deferred form (r' = r - a q first); p, r, q stored as
// `storage` says.
int nsol_cg_direction(void* p, void* r, const void* q, const double* scal, long long n,
                      int storage, void* stream, long long* counts) {
  const cudaError_t e = stream_direction(p, r, q, scal, n, storage, (cudaStream_t)stream);
  counts[kCgDirection] += 1;
  return (int)e;
}

// The whole linear ADMM TV-L2 solve of blocked.py::blocked_admm_solve
// (:1293) for mode 0 ("apply": CG around normal_apply_zy, with the CG
// direction update of cg_direction) or 1 ("step2d": cg_step_zy, float
// storage only). A^T b is blur_apply_zy of b (A symmetric); the outer
// prox/dual chain is admm.cu's admm_tail and the CG update its cg_update
// (counted in admm_counts). x holds x0 on entry and the result on exit.
// r (R), p0, p1 (P) and q (Q) are stored as `storage` says (kStoreExact,
// kStoreDirs or kStoreState): the outer residual reads x in float, or as
// bfloat16 under kStoreState, and writes the first direction p0 = r
// beside r; the CG applies read p and write q in bfloat16 under the two
// compact modes, whose dot takes the rounded q.
int nsol_blocked_admm_solve(const float* b, float* x, float* v, float* w, float* atb,
                            float* rhs, void* r, void* p0, void* p1, void* q, double* partials,
                            double* scal, const float* taps_a, int kaz, int kay, int kax,
                            const float* taps_n, int knz, int kny, int knx, float ihx, float ihy,
                            float ihz, float ih2x, float ih2y, float ih2z, float tau, float rho,
                            int iterations, int iter_max, int mode, int storage, int Z, int Y,
                            int X, void* stream, long long* counts, long long* admm_counts) {
  const cudaStream_t s = (cudaStream_t)stream;
  const Dims d{Z, Y, X};
  const Spacing sp{ihx, ihy, ihz, ih2x, ih2y, ih2z};
  const Taps ta = make_taps(taps_a, kaz, kay, kax);
  const Taps tn = make_taps(taps_n, knz, kny, knx);
  const long long n = d.n();
  if (storage != kStoreExact && (mode != 0 || storage == kStoreQf32))
    return (int)cudaErrorInvalidValue;
  const int compact = storage != kStoreExact, state = storage == kStoreState;
  int e;
#define UNIT(idx, call) NSOL_UNIT(counts, idx, call)
#define CALL(call)                  \
  if ((e = (int)(call)) != 0) return e;
  UNIT(kBlurApplyZy, blur_apply_zy(b, nullptr, atb, nullptr, nullptr, nullptr, nullptr, nullptr,
                                   nullptr, nullptr, ta, 0.f, 0, 1.f, sp, d, s));
  CALL(nsol_admm_tail(x, v, w, atb, rhs, ihx, ihy, ihz, tau, rho, 1, Z, Y, X, stream,
                      admm_counts));
  for (int it = 0; it < iterations; ++it) {
    // warm-started CG on M x = rhs: r = rhs - M x, gamma = |r|^2
    if (mode == 0) {
      // and the first direction p0 = r
      UNIT(kNormalApplyZy, normal_apply_zy(x, r, rhs, p0, compact, partials, scal, tn, rho, state,
                                           sp, d, s));
      for (int k = 0; k < iter_max; ++k) {
        UNIT(kNormalApplyZy, normal_apply_zy(p0, q, nullptr, nullptr, 0, partials, scal, tn, rho,
                                             compact, sp, d, s));
        CALL(nsol_cg_update(x, r, p0, q, partials, scal, n, storage, !state, stream,
                            admm_counts));
        if (k + 1 < iter_max)
          UNIT(kCgDirection, stream_direction(p0, r, state ? q : nullptr, scal, n, storage, s));
      }
    } else {
      UNIT(kNormalApplyZy, normal_apply_zy(x, r, rhs, nullptr, 0, partials, scal, tn, rho, 0, sp,
                                           d, s));
      float* p_prev = static_cast<float*>(p0);
      float* p_cur = static_cast<float*>(p1);
      float* rf = static_cast<float*>(r);
      float* qf = static_cast<float*>(q);
      for (int k = 0; k < iter_max; ++k) {
        UNIT(kCgStepZy, cg_step_zy(rf, p_prev, p_cur, qf, partials, scal, k == 0, tn, rho, sp, d,
                                   s));
        CALL(nsol_cg_update(x, rf, p_cur, qf, partials, scal, n, kStoreExact, 1, stream,
                            admm_counts));
        float* tmp = p_prev;
        p_prev = p_cur;
        p_cur = tmp;
      }
    }
    // clips x, then the shrink, the dual update and the next rhs
    CALL(nsol_admm_tail(x, v, w, atb, rhs, ihx, ihy, ihz, tau, rho, 0, Z, Y, X, stream,
                        admm_counts));
  }
#undef CALL
#undef UNIT
  return 0;
}

}  // extern "C"
