// Hopper (sm_90a) whole-volume weighted_apply on march.cuh's weighted
// march.
//
// Counterpart of the TPU Pallas kernel
//   nsol_tpu/ops/pallas/robust.py::make_blocked_weighted_normal_operator  (:264)
// (and of the fused solves' in-kernel apply_W, fused.py:593-597) in every
// storage mode of stencil.cuh's RobustStorage (exact; dirs: p, p'
// bfloat16; io: also the weights read as bfloat16 and the core rounded to
// bfloat16), masked or not, and for both regularisers (the Laplacian of TV
// and TK1, the identity of TK0). robust.cu's C entry weighted_apply takes
// it wherever march.cuh's vol_route says (the IRLS sweeps of robust.cu and
// tikhonov.cu with it), and tiled.cu's weighted_apply_zy is its TV
// instance.
//
// Design: march.cuh's weighted march, two stencils in one block: pf =
// free p' is blurred onto the tile extended by the blur halo and scaled by
// the weights there, and that is blurred back onto the centre a plane
// behind, beside the Laplacian's raw ring of pf; no volume holds A pf.
// Each output takes the two three-pass chains' taps in the same order with
// the same roundings, so p' and q equal robust.cu's six passes bit for
// bit; pq sums in another order. What bounds it on the H100: the latency
// of its window loads and its two barriers a plane (march.cuh); bytes
// would bound it at 256^3 at 0.10-0.12 ms by storage (r, p, free, wts
// read, p', q written once) (PERF.md).

#include <cuda_runtime.h>

#include "march.cuh"

extern "C" {

// p' = r + beta p (p' = r when first), pf = free p', q = free (A (wts A
// pf) + rho B^T B pf) + (p' - pf) (free null: every voxel free), pq = sum
// p'.q and a = gamma / pq into scal; p, p' stored as the RobustStorage
// mode `storage` says, B^T B by the RegKind `reg`. partials holds
// nsol_tiled_blocks(Z, Y, X) doubles. Enqueues on `stream`, adds to no
// count, returns the launch's error (cudaErrorInvalidValue where the taps
// do not fit a block).
int nsol_weighted_apply_march(const float* r, const void* p, void* p_new, float* q,
                              const float* free, const float* wts, double* partials,
                              double* scal, int first, const float* taps, int kz, int ky,
                              int kx, float rho, int reg, int storage, float ih2x, float ih2y,
                              float ih2z, int Z, int Y, int X, void* stream) {
  const Spacing sp{0.f, 0.f, 0.f, ih2x, ih2y, ih2z};
  const Taps tp = make_taps(taps, kz, ky, kx);
  const Dims d{Z, Y, X};
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)with_robust_storage(storage, [&](auto st) {
    using S = decltype(st);
    return reg == kRegIdentity
               ? weighted_march_t<kRegIdentity, S>(r, p, p_new, q, free, wts, partials, scal,
                                                   first, tp, rho, sp, d, s)
               : weighted_march_t<kRegLap, S>(r, p, p_new, q, free, wts, partials, scal, first,
                                              tp, rho, sp, d, s);
  });
}

}  // extern "C"
