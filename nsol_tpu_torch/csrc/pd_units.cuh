// The primal-dual units' device code that csrc/pd.cu's launch sequence
// and csrc/pd_persistent.cu's one-launch solve both run: pd_dual's and
// pd_primal's voxel, a block of pd_record's register march and its
// one-block-per-image reduce, with the sizes and the grids both take
// (pd_grid; the march's RecGrid, which pd.cu sizes).
//
// Loads. The sequence's kernels take their volumes as const T* __restrict__
// arguments, through which the compiler may read by the read-only
// (non-coherent) path: nothing writes them while the kernel runs. The
// persistent solve reads volumes other blocks wrote earlier in the launch
// and passes plain pointers (persistent.cuh), so the same plain loads here
// stay coherent there; the record march's explicit 16-byte __ldg loads
// become plain ones with kNc false. The two give the same values.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

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

// A state value as float, stored as T, and rounded to T's precision.
__device__ __forceinline__ float ld(const float* p, int i) { return p[i]; }
__device__ __forceinline__ float ld(const bf16* p, int i) { return __bfloat162float(p[i]); }
__device__ __forceinline__ void st(float* p, int i, float v) { p[i] = v; }
__device__ __forceinline__ void st(bf16* p, int i, float v) { p[i] = __float2bfloat16_rn(v); }
template <class T>
__device__ __forceinline__ float rnd(float v) {
  return sizeof(T) == sizeof(float) ? v : __bfloat162float(__float2bfloat16_rn(v));
}
// (next - c) / h along one axis, 0 past the last row: the forward difference.
__device__ __forceinline__ float fdiff(float next, float c, float ih) {
  return __fmul_rn(__fsub_rn(next, c), ih);
}

// Blocks along x of pd_dual's and pd_primal's launch grid; grid.y is the
// batch.
inline int pd_grid(int B, int n) {
  int per = kPdBlocks / B;
  if (per < 1) per = 1;
  const int need = (n + kThreads - 1) / kThreads;
  return need < per ? need : per;
}

__device__ __forceinline__ float sched_at(const float* sched, int row, int bi, int t, int iters,
                                          int B) {
  return sched[(row * B + bi) * iters + t];
}

// pd_dual at voxel i (coordinates ix, iy, iz) of one image: x its x_mean
// (or what holds the same values), pb its ndim dual volumes; `fresh`: p
// read as the 0 the sequence's memset leaves there. sigma_t = s, shrink =
// 1 + s gamma.
template <class T>
__device__ __forceinline__ void pd_dual_voxel(const T* x, T* pb, bool fresh, int i, int ix,
                                              int iy, int iz, float s, float shrink, int huber,
                                              const PdDims& d, const InvH& ih) {
  const int n = d.n(), plane = d.plane();
  const float c = ld(x, i);
  auto update = [&](int k, float g) {
    float q = __fadd_rn(fresh ? 0.f : ld(pb, k * n + i), __fmul_rn(s, g));
    if (huber) q = __fdiv_rn(q, shrink);
    st(pb, k * n + i, __fdiv_rn(q, fmaxf(1.f, fabsf(q))));
  };
  update(0, fdiff(ix + 1 < d.X ? ld(x, i + 1) : 0.f, c, ih.x));
  update(1, fdiff(iy + 1 < d.Y ? ld(x, i + d.X) : 0.f, c, ih.y));
  if (d.ndim == 3) update(2, fdiff(iz + 1 < d.Z ? ld(x, i + plane) : 0.f, c, ih.z));
}

// pd_primal at voxel i of one image: x_old its x before the step (the
// volume xb itself in the sequence), the new x into xb and x_mean into mb,
// p0..p2 its dual volumes, b the shared image. one_ft = 1 + ft.
template <class T>
__device__ __forceinline__ void pd_primal_voxel(const T* x_old, T* xb, T* mb, const T* p0,
                                                const T* p1, const T* p2, const float* b, int i,
                                                int ix, int iy, int iz, float tau, float ft,
                                                float one_ft, float theta, int ell1,
                                                const PdDims& d, const InvH& ih) {
  const int plane = d.plane();
  // sum_i D_i^T p_i / h_i, x first: (p[i-1] - p[i]) / h, p[-1] = 0
  float div = fdiff(ix > 0 ? ld(p0, i - 1) : 0.f, ld(p0, i), ih.x);
  div = __fadd_rn(div, fdiff(iy > 0 ? ld(p1, i - d.X) : 0.f, ld(p1, i), ih.y));
  if (d.ndim == 3)
    div = __fadd_rn(div, fdiff(iz > 0 ? ld(p2, i - plane) : 0.f, ld(p2, i), ih.z));
  const float xo = ld(x_old, i), bv = b[i];
  const float z = __fsub_rn(xo, __fmul_rn(tau, div));
  float xn;
  if (ell1) {
    // max(|dz| - ft, 0) sign(dz) as fused.py:1151 forms it: a NaN dz (a
    // NaN neighbour through p) gives NaN, as jnp.maximum and jnp.sign do
    const float dz = __fsub_rn(z, bv);
    const float m = clip0(__fsub_rn(fabsf(dz), ft));
    xn = __fadd_rn(bv, dz > 0.f ? m : (dz < 0.f ? -m : __fmul_rn(m, dz)));
  } else {
    xn = __fdiv_rn(__fadd_rn(z, __fmul_rn(ft, bv)), one_ft);
  }
  xn = rnd<T>(xn);  // the stored iterate, which x_mean and the records see
  st(mb, i, __fadd_rn(xn, __fmul_rn(theta, __fsub_rn(xn, xo))));
  st(xb, i, xn);
}

// pd_record as a register march (the TPU kernel's write_measures,
// fused.py:1099-1120). Each warp owns a strip of columns, kRecLanes x W
// wide (W values of T a 16-byte load: 4 float or 8 bfloat16), and walks
// a chunk of the slowest axis: y of a 2-D image, z of a volume, where a
// thread also owns rec_rows() rows of y. The +1 neighbour along the walked
// axis is the next step's load, kept in registers; along y (3-D) the
// thread's next row, one extra row a step; along x the lane to the
// right's first value by a warp shuffle, and one scalar load a row for
// lane 31. What bounded the grid-stride form was instruction issue and
// load latency, not bytes (its bf16 state took the f32 one's time): five
// 2-4-byte loads, a division and two modulos a voxel. Here a voxel takes
// no division and a quarter to an eighth of a 16-byte load of x; the bytes
// are x once (and its chunk's last +1 row again) and b once a batch image
// (from L2 after the first). Each voxel's f32 term is
// the grid-stride form's, in the same _rn order; only the order of the
// float64 sums differs (each thread's voxels, then the block's threads in
// a fixed order: a run repeats bit for bit).
constexpr int kRecLanes = 32;
constexpr int kRecWarps = 8;  // a block of 256 threads
constexpr int kRecThreads = kRecLanes * kRecWarps;
static_assert(kRecThreads == kThreads, "a team of the persistent solve runs a record block");

// Rows of y a thread owns: 1 for a 2-D image (no middle axis), else 4 (2
// for a bfloat16 state, whose rows hold twice the values).
template <class T, int kND>
__host__ __device__ constexpr int rec_rows() {
  return kND == 2 ? 1 : (sizeof(T) == sizeof(float) ? 4 : 2);
}

// The warps' work over one image: ngx column strips x nstrips row strips
// (3-D) x nchunks chunks of `chunk` steps along the walked axis (length S),
// `blocks` blocks of kRecWarps warps an image.
struct RecGrid {
  int ngx, nstrips, nchunks, chunk, S, warps, blocks;
};

// W values of a row from `col` on, as float (0 past X): one 16-byte load,
// or scalar loads for rows that are no multiple of 16 bytes.
template <class T, bool kWide, bool kNc>
__device__ __forceinline__ void rec_load(const T* row, int col, int X, bool ok,
                                         float (&o)[16 / sizeof(T)]) {
  constexpr int W = 16 / sizeof(T);
  if (kWide) {
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (ok && col < X) {
      const uint4* src = reinterpret_cast<const uint4*>(row + col);
      u = kNc ? __ldg(src) : *src;
    }
    const unsigned w4[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (sizeof(T) == sizeof(float)) {
        o[k] = __uint_as_float(w4[k]);
      } else {
        o[2 * k] = __uint_as_float(w4[k] << 16);
        o[2 * k + 1] = __uint_as_float(w4[k] & 0xffff0000u);
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < W; ++j) o[j] = ok && col + j < X ? ld(row, col + j) : 0.f;
  }
}

template <bool kWide, bool kNc>
__device__ __forceinline__ void rec_load_b(const float* row, int col, int X, bool ok, float* o,
                                           int W) {
  if (kWide) {
    for (int k = 0; k < W; k += 4) {
      float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
      if (ok && col < X) {
        const float4* src = reinterpret_cast<const float4*>(row + col + k);
        t = kNc ? __ldg(src) : *src;
      }
      o[k] = t.x, o[k + 1] = t.y, o[k + 2] = t.z, o[k + 3] = t.w;
    }
  } else {
    for (int j = 0; j < W; ++j) o[j] = ok && col + j < X ? load_f<kNc>(row + col + j) : 0.f;
  }
}

// Block bx of image bi (its x at xb) of the record march's g.blocks
// blocks an image, run by the kRecThreads threads of Team (tid(), sum(),
// sync()): its float64 Reg and Data partials into partials[2 k], [2 k +
// 1], k = bi * g.blocks + bx.
template <class T, int kND, bool kWide, bool kNc, class Team>
__device__ __forceinline__ void pd_record_block(const T* xb, const float* b, double* partials,
                                                int ell1, int huber, float gr, const RecGrid& g,
                                                const PdDims& d, const InvH& ih, int bx,
                                                int bi) {
  constexpr int W = 16 / sizeof(T);
  constexpr int R = rec_rows<T, kND>();
  const int tid = Team::tid();
  const int lane = tid & (kRecLanes - 1);
  const int wi = bx * kRecWarps + (tid >> 5);
  const float gr2 = __fmul_rn(gr, gr);
  const long long plane = (long long)d.plane();
  double acc_r = 0.0, acc_d = 0.0;
  if (wi < g.warps) {
    // the warp's strip: column strip, row strip (3-D) and chunk
    const int sx = wi % g.ngx, rest = wi / g.ngx;
    const int sy = rest % g.nstrips, sc = rest / g.nstrips;
    const int x0 = sx * kRecLanes * W, col = x0 + lane * W;
    const bool right = x0 + kRecLanes * W < d.X;
    const int y0 = sy * R;
    const int s0 = sc * g.chunk, s1 = min(g.S, s0 + g.chunk);
    // the rows a step reads: the thread's R rows and, in 3-D, the row
    // below them (the y + 1 neighbour of its last row)
    constexpr int RL = kND == 3 ? R + 1 : 1;
    // row r of step s: its offset, and whether it lies in the image
    const auto row_of = [&](int s, int r, long long& off) {
      const int y = kND == 3 ? y0 + r : s;
      off = kND == 3 ? s * plane + (long long)y * d.X : (long long)y * d.X;
      return (kND == 3 ? y < d.Y : true) && s < g.S;
    };
    float cur[RL][W], nxt[RL][W];
#pragma unroll
    for (int r = 0; r < RL; ++r) {
      long long off;
      const bool ok = row_of(s0, r, off);
      rec_load<T, kWide, kNc>(xb + off, col, d.X, ok, cur[r]);
    }
    for (int s = s0; s < s1; ++s) {
#pragma unroll
      for (int r = 0; r < RL; ++r) {
        long long off;
        const bool ok = row_of(s + 1, r, off);
        rec_load<T, kWide, kNc>(xb + off, col, d.X, ok, nxt[r]);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        long long off;
        const bool ok = row_of(s, r, off);
        float bv[W];
        rec_load_b<kWide, kNc>(b + off, col, d.X, ok, bv, W);
        const float xr =
            lane == kRecLanes - 1 && right && ok ? ld(xb + off, x0 + kRecLanes * W) : 0.f;
        const float sh = __shfl_down_sync(0xffffffffu, cur[r][0], 1);
        const float xn = lane == kRecLanes - 1 ? xr : sh;
#pragma unroll
        for (int j = 0; j < W; ++j) {
          if (!ok || col + j >= d.X) continue;
          const float c = cur[r][j];
          const float gx = fdiff(j + 1 < W ? cur[r][j + 1] : xn, c, ih.x);
          // 2-D: the walked axis is y; 3-D: y is the next row, z the walk
          const float gy = fdiff(kND == 3 ? cur[r + 1 < RL ? r + 1 : r][j] : nxt[0][j], c, ih.y);
          float g2 = __fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy));
          if (kND == 3) {
            const float gz = fdiff(nxt[r][j], c, ih.z);
            g2 = __fadd_rn(g2, __fmul_rn(gz, gz));
          }
          const float rv = huber ? (g2 < gr2 ? g2 : __fsub_rn(__fmul_rn(2.f * gr, sqrtf(g2)), gr2))
                                 : sqrtf(g2);
          const float dv = __fsub_rn(c, bv[j]);
          acc_r += (double)rv;
          acc_d += ell1 ? (double)fabsf(dv) : (double)__fmul_rn(dv, dv);
        }
      }
#pragma unroll
      for (int r = 0; r < RL; ++r)
#pragma unroll
        for (int j = 0; j < W; ++j) cur[r][j] = nxt[r][j];
    }
  }
  const double sr = Team::sum(acc_r);
  Team::sync();
  const double sd = Team::sum(acc_d);
  if (tid == 0) {
    const long long k = (long long)bi * g.blocks + bx;
    partials[2 * k] = sr;
    partials[2 * k + 1] = sd;
  }
}

// pd_record's second stage for image bi: its nparts partial pairs summed
// as a block of kReduceThreads threads sums them (thread k: 0.0 + partial
// k + partial k + kReduceThreads + ..., then block_sum's tree), by a block
// of any multiple of 32 threads up to kReduceThreads, each of its warps in
// turn taking the larger block's warps; into reg[bi * cols + t] (half the
// sum with huber) and data[bi * cols + t]. Every thread of the block calls
// it.
__device__ __forceinline__ void pd_reduce_body(const double* partials, int nparts, int t,
                                               int cols, double* reg, double* data, int huber,
                                               int bi) {
  constexpr int kWarps = kReduceThreads / 32;
  __shared__ double warp_sums[2][kWarps];
  const double* pp = partials + 2LL * bi * nparts;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  __syncthreads();  // a previous call's reads of warp_sums
  for (int vw = warp; vw < kWarps; vw += nw) {
    double ar = 0.0, ad = 0.0;
    for (int k = vw * 32 + lane; k < nparts; k += kReduceThreads) {
      ar += pp[2 * k];
      ad += pp[2 * k + 1];
    }
    for (int off = 16; off > 0; off >>= 1) {
      ar += __shfl_down_sync(0xffffffffu, ar, off);
      ad += __shfl_down_sync(0xffffffffu, ad, off);
    }
    if (lane == 0) {
      warp_sums[0][vw] = ar;
      warp_sums[1][vw] = ad;
    }
  }
  __syncthreads();
  if (warp == 0) {
    double sr = warp_sums[0][lane], sd = warp_sums[1][lane];
    for (int off = 16; off > 0; off >>= 1) {
      sr += __shfl_down_sync(0xffffffffu, sr, off);
      sd += __shfl_down_sync(0xffffffffu, sd, off);
    }
    if (lane == 0) {
      reg[bi * cols + t] = huber ? 0.5 * sr : sr;
      data[bi * cols + t] = sd;
    }
  }
}

}  // namespace
