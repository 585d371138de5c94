// Hopper (sm_90a) whole-volume cg_step on march.cuh's single-stencil march.
//
// Counterpart of the TPU Pallas kernel
//   nsol_tpu/ops/pallas/blocked.py::make_blocked_cg_step  (:988)
// in every storage mode of stencil.cuh's Storage (exact; qf32: p, p'
// bfloat16; dirs: p, p', q bfloat16; state: r, p, p', q bfloat16) and for
// both regularisers (the Laplacian of TV and TK1, the identity of TK0).
// admm.cu's C entry cg_step takes it wherever march.cuh's vol_route says
// (the solves of admm.cu and tikhonov.cu with it), and tiled.cu's
// cg_step_zy is its float TV instance.
//
// Design: march.cuh's single-stencil march over two input windows (r, p),
// double-buffered in shared memory and copied in 16-byte cp.async groups
// (bfloat16 windows too, widened where the taps read them); p' = r + beta
// p is formed in the tile, rounded to its storage, convolved, fed to the
// Laplacian's raw ring and written once on the block's own planes; q and
// the block's float64 partial of p'.q are the epilogue. Each output takes
// the three-pass chain's taps in the same order with the same roundings,
// so p' and q equal admm.cu's chain bit for bit; pq sums in another order.
// What bounds it on the H100: instruction issue and shared-memory
// accesses, as the march (march.cuh); bytes would bound it at 256^3 at
// 0.04-0.08 ms by storage (r, p read, p', q written once) (PERF.md).

#include <cuda_runtime.h>

#include "march.cuh"

extern "C" {

// p' = r + beta p (p' = r when first), q = (A^T A + rho B^T B) p', pq =
// sum p'.q and a = gamma / pq into scal; r, p, p', q stored as the Storage
// mode `storage` says, B^T B by the RegKind `reg`. partials holds
// nsol_tiled_blocks(Z, Y, X) doubles. Enqueues on `stream`, adds to no
// count, returns the launch's error (cudaErrorInvalidValue where the taps
// do not fit a block).
int nsol_cg_step_march(const void* r, const void* p, void* p_new, void* q, double* partials,
                       double* scal, int first, const float* taps, int kz, int ky, int kx,
                       float rho, int reg, int storage, float ih2x, float ih2y, float ih2z,
                       int Z, int Y, int X, void* stream) {
  const Spacing sp{0.f, 0.f, 0.f, ih2x, ih2y, ih2z};
  const Taps tp = make_taps(taps, kz, ky, kx);
  const Dims d{Z, Y, X};
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)with_storage(storage, [&](auto st) {
    using S = decltype(st);
    return reg == kRegIdentity
               ? cg_step_march_t<kRegIdentity, S>(r, p, p_new, q, partials, scal, first, tp, rho,
                                                  sp, d, s)
               : cg_step_march_t<kRegLap, S>(r, p, p_new, q, partials, scal, first, tp, rho, sp,
                                             d, s);
  });
}

}  // extern "C"
