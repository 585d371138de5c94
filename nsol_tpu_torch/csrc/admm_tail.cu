// Hopper (sm_90a) one-pass ADMM prox/dual tail: admm_tail.
//
// Counterpart of the outer step of the TPU Pallas kernel
//   nsol_tpu/ops/pallas/fused.py::make_fused_admm_solver  (:382, linear
//   branch: the clip :651, the grouped shrink and the dual update :656-667,
//   and the next right-hand side :645)
// computing the same f32 values, not its blocks. In one pass over the
// volume it clips x >= 0 in place, forms t = grad x / h + w, shrinks t at
// tau = alpha / rho, writes w' = t - v (and v, where asked) and the next
// CG right-hand side rhs = A^T b + rho sum_k D_k^T (v_k - w'_k) / h_k. The
// init form (fused.py:579-580) takes v = grad x / h unclipped, w' = 0 and
// does not clip.
//
// What bounds it on the H100: bytes. It reads x, w (3 volumes) and A^T b
// and writes x, w' (3), rhs, and v (3) where asked: 13 volumes with v, 10
// without (the C solves, where nothing reads v: the next shrink reads w
// alone and the next rhs forms v - w' again), at ~60 flops a voxel. The
// two-pass unit it replaces wrote v and w and read them back for the
// divergence (20 volumes) and split each voxel's linear index by 64-bit
// divisions.
//
// Design. One thread a voxel, a block of 64 threads along x; the grid is
// (X / 64, Y, Z), launched in slabs of at most 65535 rows and planes, so
// no voxel divides. The divergence needs v - w' one voxel lower in x, y
// and z: the thread computes the shrink again at those three neighbours
// (it couples the three components, so each takes x there, its +1
// neighbours and w's three components), reading every value through
// L1/L2, where the neighbouring threads' reads of the same lines hit. It
// holds 24-40 registers (50-64 warps an SM) and hides the loads' latency
// by occupancy. A march over z that kept the plane behind's v - w' in
// registers and moved x and w in 16-byte accesses (100-128 registers, 16
// warps an SM) was timed against it by device time on the H100
// (chip_smoke.py phase 39, PERF.md): 1.5-2.4x slower at 64^3-96^3 and on
// a 256^2 image, a tie at 128^3 and 256^3, 1.1x slower at 512^3; faster
// only on a 1024^2 image (1.33x) and a 136 x 240 x 200 volume (1.06x),
// shapes no default solve runs, so it was not kept.
//
// Hazards. w' goes to another volume than w (the C solves swap the two),
// since a thread reads w at its lower neighbours while their threads
// write theirs. x is clipped in place although the neighbours' threads
// read it: every read of x takes clip0 of what it reads, and clip0 is
// idempotent (common.cuh: u < 0 ? 0 : u keeps -0 and NaN), so a read sees
// the same value whether the owner has clipped it yet or not.
//
// Rounding. Every operation is written with its _rn intrinsic in the order
// the two-pass unit's compiled code took (nvcc contracted t = fma(x' - x,
// 1/h, w), |t|^2 = fma(t_z, t_z, fma(t_x, t_x, t_y t_y)), the divergence
// fma(dd_z, 1/h_z, fma(dd_x, 1/h_x, dd_y / h_y)) and rhs = fma(div, rho,
// A^T b); the init form's v = (x' - x) / h unfused), so that the one-pass
// unit gives the same bits in x, w', v and rhs, signed zeros and NaN
// included. A 2-D image (two components) takes its z terms as the exact
// values the two-pass unit's zero-padded z component gave: t_z = fma(0 -
// x, 0, 0), v_z - w'_z and its divergence term, with nothing read or
// written.

#include <cuda_runtime.h>

#include "admm_tail.cuh"

namespace {

constexpr int kTailThreads = 64;  // a block, along x
constexpr int kMaxGrid = 65535;   // the grid's y and z extent
constexpr int kAdmmTail = 3;      // admm.cu's Unit slot of admm_tail

// The tail (the note at the top): one thread a voxel, a block of
// kTailThreads along x.
template <bool kInit, bool kZ>
__global__ void __launch_bounds__(kTailThreads) admm_tail_kernel(TailArgs a) {
  const int ix = blockIdx.x * kTailThreads + threadIdx.x;
  if (ix >= a.X) return;
  tail_voxel<kInit, kZ, true>(a, ix, a.y0 + blockIdx.y, a.z0 + blockIdx.z);
}

// One launch a slab of at most kMaxGrid rows and planes (one launch
// below that).
template <bool kInit, bool kZ>
cudaError_t launch_tail(TailArgs a, cudaStream_t s) {
  for (a.z0 = 0; a.z0 < a.Z; a.z0 += kMaxGrid)
    for (a.y0 = 0; a.y0 < a.Y; a.y0 += kMaxGrid) {
      const int ny = a.Y - a.y0 < kMaxGrid ? a.Y - a.y0 : kMaxGrid;
      const int nz = a.Z - a.z0 < kMaxGrid ? a.Z - a.z0 : kMaxGrid;
      const dim3 grid((a.X + kTailThreads - 1) / kTailThreads, ny, nz);
      admm_tail_kernel<kInit, kZ><<<grid, kTailThreads, 0, s>>>(a);
      const cudaError_t e = cudaGetLastError();
      if (e != cudaSuccess) return e;
    }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// The one-pass admm_tail over a (Z, Y, X) volume (ncomp 3) or a 2-D image
// (ncomp 2, Z = 1), enqueued on `stream`: x clipped in place (not with
// init), w' into w_out (another volume than w; w is not read with init,
// where w_out may be w), v where v is not null, rhs. 1/h in (x, y, z)
// order. counts: admm.cu's units (the solves' and the wrapper's).
int nsol_admm_tail(float* x, float* v, const float* w, float* w_out, const float* atb,
                   float* rhs, float ihx, float ihy, float ihz, float tau, float rho, int init,
                   int ncomp, int Z, int Y, int X, void* stream, long long* counts) {
  if ((ncomp != 2 && ncomp != 3) || (ncomp == 2 && Z != 1) || (!init && w == w_out))
    return (int)cudaErrorInvalidValue;
  const TailArgs a{x, w, w_out, v, atb, rhs, ihx, ihy, ihz, tau, rho, Z, Y, X,
                   (long long)Z * Y * X, 0, 0};
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  if (init)
    e = ncomp == 3 ? launch_tail<true, true>(a, s) : launch_tail<true, false>(a, s);
  else
    e = ncomp == 3 ? launch_tail<false, true>(a, s) : launch_tail<false, false>(a, s);
  counts[kAdmmTail] += 1;
  return (int)e;
}

}  // extern "C"
