// Hopper (sm_90a) whole-volume cg_sweep on march.cuh's single-stencil march.
//
// Counterpart of the TPU Pallas kernel
//   nsol_tpu/ops/pallas/blocked.py::make_blocked_cg_sweep  (:1139)
// in both storages the sweep takes: float r, p, q (exact) and bfloat16 r,
// p, q (state_dtype). admm.cu's C entry cg_sweep takes it wherever
// march.cuh's vol_route says (the linear solve's "sweep" mode with it).
//
// Design: march.cuh's single-stencil march over three input windows (r, q,
// p), double-buffered in shared memory and copied in 16-byte cp.async
// groups; r' = r - a q and p' = r' + beta p are formed in the tile with
// admm.cu's SweepDir roundings, p' is convolved, fed to the Laplacian's raw
// ring and written once on the block's own planes, where r' is written
// too, kept in an r' ring for the epilogue, and x += a p (the old p) is
// done in place; q' = (A^T A + rho D^T D) p' goes to a second q volume (a
// block's halo reads its neighbours' q while they write q'), and the
// block's four float64 partials (g = r'.r', pq = p'.q', rq = r'.q', qq =
// q'.q') are summed by stencil.cuh's sweep_reduce_kernel, which runs the
// recurrence. Each output takes the three-pass chain's taps in the same
// order with the same roundings, so x', r', p' and q' equal admm.cu's
// chain bit for bit; the dots sum in another order. Two launches a CG
// iteration instead of four, and no scratch volume.
// What bounds it on the H100: instruction issue and shared-memory
// accesses, as the march (march.cuh); bytes would bound it at 256^3 at
// 0.160 ms in float (r, q, p, x read, x', r', p', q' written once) and
// 0.100 ms in bfloat16 (PERF.md). Its block holds ~72 KB of shared memory
// at the 13 normal taps, so three blocks an SM.

#include <cuda_runtime.h>

#include "march.cuh"

extern "C" {

// One CG sweep on the march: q' into q_new (not q), x += a p in place,
// r', p' into r_new, p_new; bf16_io 1 stores r, p, q and the new ones as
// bfloat16. partials holds 4 * nsol_tiled_blocks(Z, Y, X) doubles; scal:
// 6. Enqueues on `stream`, adds to no count, returns the launch's error
// (cudaErrorInvalidValue where the taps do not fit a block).
int nsol_cg_sweep_march(float* x, const void* r, const void* p, const void* q, void* q_new,
                        void* r_new, void* p_new, double* partials, double* scal, int first,
                        const float* taps, int kz, int ky, int kx, float rho, int bf16_io,
                        float ih2x, float ih2y, float ih2z, int Z, int Y, int X, void* stream) {
  const Spacing sp{0.f, 0.f, 0.f, ih2x, ih2y, ih2z};
  const Taps tp = make_taps(taps, kz, ky, kx);
  const Dims d{Z, Y, X};
  const cudaStream_t s = (cudaStream_t)stream;
  if (bf16_io)
    return (int)cg_sweep_march_t(x, static_cast<const bf16*>(r), static_cast<const bf16*>(p),
                                 static_cast<const bf16*>(q), static_cast<bf16*>(q_new),
                                 static_cast<bf16*>(r_new), static_cast<bf16*>(p_new), partials,
                                 scal, first, tp, rho, sp, d, s);
  return (int)cg_sweep_march_t(x, static_cast<const float*>(r), static_cast<const float*>(p),
                               static_cast<const float*>(q), static_cast<float*>(q_new),
                               static_cast<float*>(r_new), static_cast<float*>(p_new), partials,
                               scal, first, tp, rho, sp, d, s);
}

}  // extern "C"
