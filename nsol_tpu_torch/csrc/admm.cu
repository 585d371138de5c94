// Hopper (sm_90a) kernels of the TV-L2 ADMM deconvolution path.
//
// Counterparts of the TPU Pallas kernels
//   nsol_tpu/ops/pallas/blocked.py::make_blocked_normal_operator  (:402)
//   nsol_tpu/ops/pallas/blocked.py::make_blocked_cg_step          (:988)
//   nsol_tpu/ops/pallas/blocked.py::make_blocked_cg_sweep         (:1139)
//   nsol_tpu/ops/pallas/blocked.py::make_blocked_normal_operator_prepadded
//                                                                  (:478)
//   nsol_tpu/ops/pallas/fused.py::make_fused_admm_solver          (:382, linear;
//                                                                  record=True,
//                                                                  compact_dirs)
// computing the same f32 results, not their block structure.
//
// Volumes are (Z, Y, X) float32, X contiguous; a 2-D image runs as a
// (1, Y, X) volume with z taps [1], 1/h_z = 1/h_z^2 = 0, so every z term
// (the Laplacian's, the z gradient, its shrink and its divergence) is an
// exact zero. Seven kernel units, each a short sequence of launches on the
// caller's stream:
//
//   normal_apply  q = N_z N_y N_x v + rho * B^T B v (self-correlated
//                 separable wrap blur + the regulariser: the zero-boundary
//                 Laplacian sum_ax (1/h_ax^2) D_ax^T D_ax, or the identity
//                 for Tikhonov TK0). One pass per axis through two scratch
//                 volumes; the z pass adds the regulariser and an epilogue
//                 (plain q, or the CG residual rhs - q with the partial sums
//                 of its square). Where march.cuh's vol_route takes the
//                 taps and the shape, the C entry runs it as
//                 normal_march.cu's one-pass march instead (every form:
//                 float and bfloat16, plain and residual, TK1 and TK0,
//                 A^T b at the blur taps with rho = 0), with no scratch
//                 volume and the same q and r bit for bit; the solves (here
//                 and in tikhonov.cu) take the same rule.
//   cg_step       p' = r + beta p formed on the fly inside the x pass, then
//                 q = M p' and the partial sums of p'.q; second stage
//                 a = gamma / pq. Where march.cuh's vol_route takes the
//                 taps and the shape (a volume past 2^20 voxels deep enough
//                 for the march's z halo, whose taps a block's shared
//                 memory holds), the C entry runs it as
//                 step_march.cu's one-pass march instead, which reads r
//                 and p once, allocates no scratch volume and gives the
//                 same p' and q bit for bit; the solves (here and in
//                 tikhonov.cu) take the same rule.
//   cg_update     x += a p', r -= a q and the partial sums of r^2; second
//                 stage beta = gamma' / gamma, gamma = gamma'.
//   admm_tail     clip x >= 0, t = grad x / h + w, grouped shrink at
//                 tau = alpha / rho, v, w updates and the next
//                 rhs = A^T b + rho div(v - w): one pass, admm_tail.cu
//                 (w' into a second volume; the solves swap the two and
//                 write no v).
//   cg_sweep      one whole CG iteration (blocked.py:1193-1231): the x pass
//                 forms r' = r - a q and p' = r' + beta p from the old
//                 vectors at every tap, stores r', p' and x += a p and sums
//                 |r'|^2; the z pass forms q' = M p' into a second q
//                 volume and sums p'.q', r'.q', q'.q'; a one-block stage
//                 runs the scalar recurrence a = g/pq, beta = max(g - 2a rq
//                 + a^2 qq, 0)/g. Where march.cuh's vol_route takes the
//                 taps and the shape, the C entry runs it as
//                 sweep_march.cu's one-pass march instead (no scratch
//                 volume, the same x', r', p', q' bit for bit); the solve
//                 takes the same rule and swaps its two q volumes.
//   normal_apply_prepadded
//                 normal_apply on a z-window of a sharded volume
//                 (blocked.py::make_blocked_normal_operator_prepadded, :478):
//                 v_ext holds the Zl local planes with r halo planes on each
//                 side (r >= 1, at least the normal taps' half-width, put
//                 there by the ring halo exchange), q the Zl planes; the
//                 z taps read the window with no wrap, and the Laplacian
//                 takes its z neighbours from the halo rows, with the
//                 zero-boundary rows only at global rows 0 and z_total - 1
//                 (row0 the window's first global row). Where a block's
//                 shared memory holds its taps (ops/cuda/tiled.py's rule,
//                 sigma up to 4) the C entry hands it to normal_march.cu's
//                 one-pass march over the Zl + 2r planes, which reads v_ext
//                 once and allocates nothing; else it runs the three
//                 passes here, whose x and y passes cover all Zl + 2r
//                 planes through two scratch volumes. The two give the
//                 same bits.
//   admm_record   the L-curve records of one iterate (fused.py:624-638):
//                 Reg = sum sqrt(sum_ax (D_ax x / h_ax)^2) and
//                 Data = 1/2 sum rho_C(r^2), r = A x - b (one blur chain
//                 whose z epilogue forms r), partials in double, a
//                 one-block second stage writing row t of two float64
//                 records.
//
// What bounds them on the H100: memory traffic, at a few flops per byte.
// At 64^3 (1 MiB a volume) the whole state sits in the 50 MB L2 and a
// solve is ~3300 short launches, so launches and their host enqueue bound
// it (where admm_persistent.cu's rule takes the shape, the fused route
// runs that sequence as one cooperative launch instead, the same bits); at 256^3 (64 MiB a volume) the elementwise passes run near HBM
// bandwidth and the per-axis stencil passes, which read every tap through
// L2, at a fraction of it (which is why normal_apply and cg_step march
// there; the records' blur chain still runs the passes). The design keeps
// the passes simple (all loads coalesced along X, no shared-memory tiles)
// and keeps every CG scalar on the device, so nothing waits for the host
// inside a solve. The per-axis
// passes and the CG update live in stencil.cuh, shared with robust.cu and
// tikhonov.cu.
//
// Storage. The CG vectors r, p, q are float, or bfloat16 where the
// reference stores them so (stencil.cuh's Storage: the fused solve's
// compact_dirs rounds p alone, the blocked compact_dirs p and q, its
// state_dtype r, p and q); scratch, x and every sum stay float. The
// bfloat16 traffic bounds a unit no better than its two float scratch
// volumes allow: the saving is the stored vectors' share.
//
// Reductions are deterministic: each block reduces its grid-stride slice
// in double in a fixed order, writes one partial, and a one-block second
// stage sums the partials in a fixed order. No atomics, so a run repeats
// bit for bit.

#include <cuda_runtime.h>

#include "admm_units.cuh"

namespace {

// Kernel units, the indices of the launch counts handed back to Python.
enum Unit {
  kNormalApply = 0,
  kCgStep = 1,
  kCgUpdate = 2,
  kAdmmTail = 3,
  kAdmmRecord = 4,
  kCgSweep = 5,
  kNormalApplyPre = 6,
  kCgStepMarch = 7,       // cg_step on step_march.cu's march
  kNormalApplyMarch = 8,  // normal_apply on normal_march.cu's march
  kCgSweepMarch = 9       // cg_sweep on sweep_march.cu's march
};

// The sweep's x-pass source (blocked.py:1206-1208): from the old r, q, p
// (T), r' = r - a q and the direction p' = r' + beta p rounded to T, with
// a, beta read once from the device scalars (0, 0 on the first trip, where
// r' = p' = r).
template <class T>
struct SweepDir {
  using Dir = T;
  const T* r;
  const T* q;
  const T* p;
  const double* scal;
  int first;
  float a, beta;
  __device__ void prepare() {
    a = first ? 0.f : (float)scal[kA];
    beta = first ? 0.f : (float)scal[kBeta];
  }
  __device__ float res(long long k) const {
    const float rk = ldg(r + k);
    return first ? rk : axpy_as<T>(-a, ldg(q + k), rk);
  }
  __device__ float dir(long long k) const {
    const float rn = res(k);
    return round_as<T>(first ? rn : axpy_as<T>(beta, ldg(p + k), rn));
  }
  __device__ float operator()(long long k) const { return dir(k); }
};

__global__ void record_tv_kernel(const float* __restrict__ x, double* __restrict__ partials,
                                 Spacing sp, Dims d) {
  record_tv_body(x, partials, sp, d, DivIndex{d}, blockIdx.x, gridDim.x);
}

// Second stage of admm_record: reg[t] = sum of the TV partials,
// data[t] = 1/2 sum of the data partials, each in a fixed order.
__global__ void record_reduce_kernel(const double* __restrict__ tv_parts,
                                     const double* __restrict__ data_parts, int nparts,
                                     double* __restrict__ reg, double* __restrict__ data, int t) {
  double acc = 0.0;
  for (int k = threadIdx.x; k < nparts; k += blockDim.x) acc += tv_parts[k];
  const double tv = block_sum(acc);
  __syncthreads();
  acc = 0.0;
  for (int k = threadIdx.x; k < nparts; k += blockDim.x) acc += data_parts[k];
  const double dsum = block_sum(acc);
  if (threadIdx.x != 0) return;
  reg[t] = tv;
  data[t] = 0.5 * dsum;
}

// ---------------------------------------------------------------- units --

// The normal apply with v stored as In and q as O; the residual form reads
// a float v through O (the reference's apply casts x to its io dtype).
template <int kReg, class In, class O>
void normal_apply_t(const In* v, O* out, float* t1, float* t2, const float* rhs,
                    double* partials, Taps tp, float rho, Spacing sp, Dims d, cudaStream_t s) {
  const LoadT<In, O> src{v};
  const NormalEpi<kReg, LoadT<In, O>, O> epi{src, rhs, out, rho, sp,
                                             rhs != nullptr ? kResidual : kPlain};
  blur_chain(src, nullptr, epi, rhs != nullptr ? partials : nullptr, t1, t2, tp, d, s);
}

// io 0: float in and out; io 1: bfloat16 (the plain form takes a bf16 v;
// the residual form a float x, read as bf16, and writes a bf16 residual).
template <class In, class O>
cudaError_t normal_apply_io(const void* v, void* out, float* t1, float* t2, const float* rhs,
                            double* partials, double* scal, Taps tp, float rho, int reg,
                            Spacing sp, Dims d, cudaStream_t s) {
  const In* vi = static_cast<const In*>(v);
  O* o = static_cast<O*>(out);
  if (reg == kRegIdentity)
    normal_apply_t<kRegIdentity>(vi, o, t1, t2, rhs, partials, tp, rho, sp, d, s);
  else
    normal_apply_t<kRegLap>(vi, o, t1, t2, rhs, partials, tp, rho, sp, d, s);
  if (rhs != nullptr)
    reduce_kernel<<<1, kReduceThreads, 0, s>>>(partials, grid_for(d.n()), scal, kReduceRR0);
  return cudaGetLastError();
}

cudaError_t normal_apply(const void* v, void* out, float* t1, float* t2, const float* rhs,
                         double* partials, double* scal, Taps tp, float rho, int reg, int io,
                         Spacing sp, Dims d, cudaStream_t s) {
  if (io == 0)
    return normal_apply_io<float, float>(v, out, t1, t2, rhs, partials, scal, tp, rho, reg, sp,
                                         d, s);
  if (rhs != nullptr)
    return normal_apply_io<float, bf16>(v, out, t1, t2, rhs, partials, scal, tp, rho, reg, sp,
                                        d, s);
  return normal_apply_io<bf16, bf16>(v, out, t1, t2, rhs, partials, scal, tp, rho, reg, sp, d,
                                     s);
}

// q = A^T A v + rho D^T D v on a z-window: v_ext holds Zl + 2 r planes,
// q the Zl centre ones; global rows start at row0 of z_total.
cudaError_t normal_apply_prepadded(const float* v_ext, float* out, float* t1, float* t2, Taps tp,
                                   float rho, int r, int row0, int z_total, Spacing sp, Dims d,
                                   cudaStream_t s) {
  const Load centre{v_ext + (long long)r * d.plane()};
  const NormalEpi<kRegLap> epi{centre, nullptr, out, rho, sp, kPlain};
  blur_chain_slab(Load{v_ext}, GlobalRows<NormalEpi<kRegLap>>{epi, row0, z_total}, nullptr, t1,
                  t2, tp, d, r, s);
  return cudaGetLastError();
}

// p' = r + beta p stored as P (pq taken from the rounded p' and the float
// q), q = M p' stored as Q; r read as R.
template <class R, class P, class Q>
cudaError_t cg_step_t(const R* r, const P* p, P* p_new, Q* q, float* t1, float* t2,
                      double* partials, double* scal, int first, Taps tp, float rho, int reg,
                      Spacing sp, Dims d, cudaStream_t s) {
  const DirectionT<false, R, P> dir{r, p, nullptr, scal, first, 0.f};
  const LoadT<P> pn{p_new};
  if (reg == kRegIdentity)
    blur_chain(dir, p_new, NormalEpi<kRegIdentity, LoadT<P>, Q>{pn, nullptr, q, rho, sp, kDot},
               partials, t1, t2, tp, d, s);
  else
    blur_chain(dir, p_new, NormalEpi<kRegLap, LoadT<P>, Q>{pn, nullptr, q, rho, sp, kDot},
               partials, t1, t2, tp, d, s);
  reduce_kernel<<<1, kReduceThreads, 0, s>>>(partials, grid_for(d.n()), scal, kReducePQ);
  return cudaGetLastError();
}

cudaError_t cg_step_chain(const void* r, const void* p, void* p_new, void* q, float* t1,
                          float* t2, double* partials, double* scal, int first, Taps tp,
                          float rho, int reg, int storage, Spacing sp, Dims d, cudaStream_t s) {
  return with_storage(storage, [&](auto st) {
    using S = decltype(st);
    return cg_step_t(static_cast<const typename S::R*>(r), static_cast<const typename S::P*>(p),
                     static_cast<typename S::P*>(p_new), static_cast<typename S::Q*>(q), t1, t2,
                     partials, scal, first, tp, rho, reg, sp, d, s);
  });
}

cudaError_t cg_update_s(float* x, void* r, const void* p, const void* q, double* partials,
                        double* scal, long long n, int storage, int store_r, cudaStream_t s) {
  return with_storage(storage, [&](auto st) {
    using S = decltype(st);
    return cg_update_t(x, static_cast<typename S::R*>(r), static_cast<const typename S::P*>(p),
                       static_cast<const typename S::Q*>(q), partials, scal, n, store_r, s);
  });
}

// ---------------------------------------------------------------- sweep --

// The sweep's x pass: t1 = x taps of p', and on each voxel's own slot the
// deferred updates x += a p (the old p), r' and p' stored as T, with
// |r'|^2 (r' before rounding) summed into partials[block].
template <class T>
__global__ void sweep_x_kernel(SweepDir<T> src, float* __restrict__ t1, T* __restrict__ p_new,
                               T* __restrict__ r_new, float* __restrict__ x,
                               double* __restrict__ partials, const float* __restrict__ taps,
                               int K, Dims d) {
  src.prepare();
  const long long n = d.n();
  double acc = 0.0;
  GRID_STRIDE(i, n) {
    const int ix = (int)(i % d.X);
    const float conv = wrap_conv(src, i - ix, ix, d.X, 1, taps, K);
    const float rn = src.res(i);
    const float pn = src.dir(i);
    if (!src.first) x[i] = fmaf(src.a, ldg(src.p + i), x[i]);
    r_new[i] = store_as<T>(rn);
    p_new[i] = store_as<T>(pn);
    t1[i] = conv;
    acc += (double)rn * rn;
  }
  const double s = block_sum(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = s;
}

// The sweep's z pass: q' = conv_z + rho D^T D p' stored as T into q_new
// (the old q read to form r' again exactly as the x pass did), and the
// partial sums of p'.q', r'.q', q'.q' (p' rounded, r' and q' before
// rounding; blocked.py:1227-1231) into partials[k * kMaxBlocks + block],
// k = 1, 2, 3.
template <class T>
__global__ void sweep_z_kernel(const float* __restrict__ t2, const T* __restrict__ r,
                               const T* __restrict__ q, T* __restrict__ q_new,
                               const T* __restrict__ p_new, const double* __restrict__ scal,
                               int first, float rho, Spacing sp, double* __restrict__ partials,
                               const float* __restrict__ taps, int K, Dims d) {
  const Load src{t2};
  const LoadT<T> pn{p_new};
  const float a = first ? 0.f : (float)scal[kA];
  const long long n = d.n(), plane = d.plane();
  double pq = 0.0, rq = 0.0, qq = 0.0;
  GRID_STRIDE(i, n) {
    const Coord c{(int)(i % d.X), (int)((i / d.X) % d.Y), (int)(i / plane)};
    const float conv = wrap_conv(src, i - (long long)c.z * plane, c.z, d.Z, plane, taps, K);
    const float qn = fmaf(rho, laplacian(pn, i, c, sp, d), conv);
    const float rk = ldg(r + i);
    const float rn = first ? rk : axpy_as<T>(-a, to_float(q[i]), rk);
    q_new[i] = store_as<T>(qn);
    pq += (double)pn(i) * qn;
    rq += (double)rn * qn;
    qq += (double)qn * qn;
  }
  double sums[3] = {pq, rq, qq};
  for (int k = 0; k < 3; ++k) {
    const double s = block_sum(sums[k]);
    if (threadIdx.x == 0) partials[(k + 1) * kMaxBlocks + blockIdx.x] = s;
    __syncthreads();
  }
}

// One whole CG iteration (blocked.py::make_blocked_cg_sweep) as three
// passes and a reduce: r' = r - a q, p' = r' + beta p, q' = M p' (into
// q_new), x += a p, the four dots and the recurrence's a, beta for the next
// sweep. partials: 4 * kMaxBlocks.
template <class T>
cudaError_t cg_sweep_t(float* x, const T* r, const T* p, const T* q, T* q_new, T* r_new,
                       T* p_new, float* t1, float* t2, double* partials, double* scal, int first,
                       Taps tp, float rho, Spacing sp, Dims d, cudaStream_t s) {
  const int g = grid_for(d.n());
  const SweepDir<T> src{r, q, p, scal, first, 0.f, 0.f};
  sweep_x_kernel<T><<<g, kThreads, 0, s>>>(src, t1, p_new, r_new, x, partials, tp.x, tp.kx, d);
  conv_y_kernel<<<g, kThreads, 0, s>>>(t1, t2, tp.y, tp.ky, d);
  sweep_z_kernel<T><<<g, kThreads, 0, s>>>(t2, r, q, q_new, p_new, scal, first, rho, sp,
                                           partials, tp.z, tp.kz, d);
  sweep_reduce_kernel<<<1, kReduceThreads, 0, s>>>(partials, g, kMaxBlocks, scal);
  return cudaGetLastError();
}

// bf16 0: float vectors; 1: bfloat16 (state_dtype).
cudaError_t cg_sweep_chain(float* x, const void* r, const void* p, const void* q, void* q_new,
                           void* r_new, void* p_new, float* t1, float* t2, double* partials,
                           double* scal, int first, Taps tp, float rho, int bf16_io, Spacing sp,
                           Dims d, cudaStream_t s) {
  if (bf16_io)
    return cg_sweep_t(x, static_cast<const bf16*>(r), static_cast<const bf16*>(p),
                      static_cast<const bf16*>(q), static_cast<bf16*>(q_new),
                      static_cast<bf16*>(r_new), static_cast<bf16*>(p_new), t1, t2, partials,
                      scal, first, tp, rho, sp, d, s);
  return cg_sweep_t(x, static_cast<const float*>(r), static_cast<const float*>(p),
                    static_cast<const float*>(q), static_cast<float*>(q_new),
                    static_cast<float*>(r_new), static_cast<float*>(p_new), t1, t2, partials,
                    scal, first, tp, rho, sp, d, s);
}

// rec_partials holds 2 * kMaxBlocks doubles: the data partials, then the
// TV partials.
cudaError_t admm_record(const float* x, const float* b, float* t1, float* t2,
                        double* rec_partials, double* reg, double* data, int t, Taps ta,
                        int loss, float scale, Spacing sp, Dims d, cudaStream_t s) {
  const int g = grid_for(d.n());
  blur_chain(Load{x}, nullptr, DataEpi{b, scale * scale, loss}, rec_partials, t1, t2, ta, d,
             s);
  record_tv_kernel<<<g, kThreads, 0, s>>>(x, rec_partials + kMaxBlocks, sp, d);
  record_reduce_kernel<<<1, kReduceThreads, 0, s>>>(rec_partials + kMaxBlocks, rec_partials, g,
                                                    reg, data, t);
  return cudaGetLastError();
}

}  // namespace

extern "C" {
// step_march.cu's cg_step and normal_march.cu's normal_apply, which add to
// no count.
int nsol_normal_apply_march(const void* v, void* out, const float* rhs, void* p_out, int p_bf16,
                            double* partials, double* scal, const float* taps, int kz, int ky,
                            int kx, float rho, int reg, int io, float ih2x, float ih2y,
                            float ih2z, int Z, int Y, int X, void* stream);
int nsol_cg_step_march(const void* r, const void* p, void* p_new, void* q, double* partials,
                       double* scal, int first, const float* taps, int kz, int ky, int kx,
                       float rho, int reg, int storage, float ih2x, float ih2y, float ih2z,
                       int Z, int Y, int X, void* stream);
// sweep_march.cu's cg_sweep, which adds to no count.
int nsol_cg_sweep_march(float* x, const void* r, const void* p, const void* q, void* q_new,
                        void* r_new, void* p_new, double* partials, double* scal, int first,
                        const float* taps, int kz, int ky, int kx, float rho, int bf16_io,
                        float ih2x, float ih2y, float ih2z, int Z, int Y, int X, void* stream);
// admm_tail.cu's one-pass admm_tail, counted in counts[kAdmmTail].
int nsol_admm_tail(float* x, float* v, const float* w, float* w_out, const float* atb,
                   float* rhs, float ihx, float ihy, float ihz, float tau, float rho, int init,
                   int ncomp, int Z, int Y, int X, void* stream, long long* counts);
}

namespace {

// One whole-volume normal_apply by `route`: the march (counted as
// kNormalApplyMarch) or the three passes through t1, t2 (kNormalApply).
// scal is read only by the residual form (rhs given).
int normal_apply_routed(const void* v, void* out, float* t1, float* t2, const float* rhs,
                        double* partials, double* scal, const float* taps, int kz, int ky,
                        int kx, float rho, int reg, int io, int route, float ih2x, float ih2y,
                        float ih2z, int Z, int Y, int X, void* stream, long long* counts) {
  if (takes_march(route, kVolNormalApply, kz, ky, kx, Z, Y, X)) {
    counts[kNormalApplyMarch] += 1;
    return nsol_normal_apply_march(v, out, rhs, nullptr, 0, partials,
                                   rhs != nullptr ? scal : nullptr, taps, kz, ky, kx, rho, reg,
                                   io, ih2x, ih2y, ih2z, Z, Y, X, stream);
  }
  counts[kNormalApply] += 1;
  if (t1 == nullptr || t2 == nullptr) return (int)cudaErrorInvalidValue;
  const Spacing sp{0.f, 0.f, 0.f, ih2x, ih2y, ih2z};
  return (int)normal_apply(v, out, t1, t2, rhs, partials, scal, make_taps(taps, kz, ky, kx), rho,
                           reg, io, sp, Dims{Z, Y, X}, (cudaStream_t)stream);
}

// One whole-volume cg_step by `route` (stencil.cuh's Route): the march
// (counted as kCgStepMarch) or the three passes through t1, t2 (kCgStep).
int cg_step(const void* r, const void* p, void* p_new, void* q, float* t1, float* t2,
            double* partials, double* scal, int first, const float* taps, int kz, int ky,
            int kx, float rho, int reg, int storage, int route, float ih2x, float ih2y,
            float ih2z, int Z, int Y, int X, void* stream, long long* counts) {
  if (takes_march(route, kVolCgStep, kz, ky, kx, Z, Y, X)) {
    counts[kCgStepMarch] += 1;
    return nsol_cg_step_march(r, p, p_new, q, partials, scal, first, taps, kz, ky, kx, rho, reg,
                              storage, ih2x, ih2y, ih2z, Z, Y, X, stream);
  }
  counts[kCgStep] += 1;
  if (t1 == nullptr || t2 == nullptr) return (int)cudaErrorInvalidValue;
  const Spacing sp{0.f, 0.f, 0.f, ih2x, ih2y, ih2z};
  return (int)cg_step_chain(r, p, p_new, q, t1, t2, partials, scal, first,
                            make_taps(taps, kz, ky, kx), rho, reg, storage, sp, Dims{Z, Y, X},
                            (cudaStream_t)stream);
}

// One whole-volume cg_sweep by `route`: the march (counted as
// kCgSweepMarch) or the three passes through t1, t2 (kCgSweep). q' goes to
// q_new, never over q (the march's blocks read their neighbours' q).
int cg_sweep(float* x, const void* r, const void* p, const void* q, void* q_new, void* r_new,
             void* p_new, float* t1, float* t2, double* partials, double* scal, int first,
             const float* taps, int kz, int ky, int kx, float rho, int bf16_io, int route,
             float ih2x, float ih2y, float ih2z, int Z, int Y, int X, void* stream,
             long long* counts) {
  if (q_new == nullptr || q_new == q) return (int)cudaErrorInvalidValue;
  if (takes_march(route, kVolCgSweep, kz, ky, kx, Z, Y, X)) {
    counts[kCgSweepMarch] += 1;
    return nsol_cg_sweep_march(x, r, p, q, q_new, r_new, p_new, partials, scal, first, taps, kz,
                               ky, kx, rho, bf16_io, ih2x, ih2y, ih2z, Z, Y, X, stream);
  }
  counts[kCgSweep] += 1;
  if (t1 == nullptr || t2 == nullptr) return (int)cudaErrorInvalidValue;
  const Spacing sp{0.f, 0.f, 0.f, ih2x, ih2y, ih2z};
  return (int)cg_sweep_chain(x, r, p, q, q_new, r_new, p_new, t1, t2, partials, scal, first,
                             make_taps(taps, kz, ky, kx), rho, bf16_io, sp, Dims{Z, Y, X},
                             (cudaStream_t)stream);
}

}  // namespace

// ------------------------------------------------------------ C interface --
// Every function enqueues on `stream`, never synchronizes, allocates
// nothing, adds one to counts[unit] per unit it launches, and returns
// cudaGetLastError() (0 on success). A CG vector passed as void* is stored
// as the storage mode (or io flag) beside it says: float or bfloat16.

extern "C" {

int nsol_max_blocks() { return kMaxBlocks; }

// io 0: v and out float; io 1: bfloat16 out, and v bfloat16 (plain form)
// or a float x read as bfloat16 (residual form, rhs given). `route` a
// Route: the rule (t1, t2 may be null where it takes the march), the chain
// (t1, t2 given) or the march. Counts kNormalApply or kNormalApplyMarch by
// the route taken; partials holds max(nsol_tiled_blocks(Z, Y, X),
// nsol_max_blocks()) doubles.
int nsol_normal_apply(const void* v, void* out, float* t1, float* t2, const float* rhs,
                      double* partials, double* scal, const float* taps, int kz, int ky, int kx,
                      float rho, int reg, int io, int route, float ih2x, float ih2y, float ih2z,
                      int Z, int Y, int X, void* stream, long long* counts) {
  return normal_apply_routed(v, out, t1, t2, rhs, partials, scal, taps, kz, ky, kx, rho, reg, io,
                             route, ih2x, ih2y, ih2z, Z, Y, X, stream, counts);
}

// normal_march.cu's march over a window.
int nsol_normal_apply_window_zy(const float* v_ext, float* out, const float* taps, int kz, int ky,
                                int kx, float rho, float ih2x, float ih2y, float ih2z, int halo,
                                int row0, int z_total, int Zl, int Y, int X, void* stream);

// v_ext: (Zl + 2 halo, Y, X); out: (Zl, Y, X); t1, t2: Zl + 2 halo planes,
// or both null for the one-pass tiled march (tiled.cu), which the wrapper
// takes where its shared memory holds the taps.
int nsol_normal_apply_prepadded(const float* v_ext, float* out, float* t1, float* t2,
                                const float* taps, int kz, int ky, int kx, float rho, float ih2x,
                                float ih2y, float ih2z, int halo, int row0, int z_total, int Zl,
                                int Y, int X, void* stream, long long* counts) {
  const Spacing sp{0.f, 0.f, 0.f, ih2x, ih2y, ih2z};
  const int e =
      t1 == nullptr
          ? nsol_normal_apply_window_zy(v_ext, out, taps, kz, ky, kx, rho, ih2x, ih2y, ih2z, halo,
                                        row0, z_total, Zl, Y, X, stream)
          : (int)normal_apply_prepadded(v_ext, out, t1, t2, make_taps(taps, kz, ky, kx), rho,
                                        halo, row0, z_total, sp, Dims{Zl, Y, X},
                                        (cudaStream_t)stream);
  counts[kNormalApplyPre] += 1;
  return e;
}

// r, p, p_new, q stored as the Storage mode `storage` says; `route` a
// Route: the rule (t1, t2 may be null where it takes the march), the
// chain (t1, t2 given) or the march. Counts kCgStep or kCgStepMarch by the
// route taken; partials holds max(nsol_tiled_blocks(Z, Y, X),
// nsol_max_blocks()) doubles.
int nsol_cg_step(const void* r, const void* p, void* p_new, void* q, float* t1, float* t2,
                 double* partials, double* scal, int first, const float* taps, int kz, int ky,
                 int kx, float rho, int reg, int storage, int route, float ih2x, float ih2y,
                 float ih2z, int Z, int Y, int X, void* stream, long long* counts) {
  return cg_step(r, p, p_new, q, t1, t2, partials, scal, first, taps, kz, ky, kx, rho, reg,
                 storage, route, ih2x, ih2y, ih2z, Z, Y, X, stream, counts);
}

// r null: x += a p alone. store_r 0: r' is summed but not stored.
int nsol_cg_update(float* x, void* r, const void* p, const void* q, double* partials,
                   double* scal, long long n, int storage, int store_r, void* stream,
                   long long* counts) {
  cudaError_t e = cg_update_s(x, r, p, q, partials, scal, n, storage, store_r,
                              (cudaStream_t)stream);
  counts[kCgUpdate] += 1;
  return (int)e;
}

// One CG sweep: q' into q_new (not q: cudaErrorInvalidValue), bf16_io 1
// stores r, p, q, q_new, r_new, p_new as bfloat16. `route` a Route: the
// rule (t1, t2 may be null where it takes the march), the chain (t1, t2
// given) or the march. Counts kCgSweep or kCgSweepMarch by the route taken;
// partials holds 4 * max(nsol_tiled_blocks(Z, Y, X), nsol_max_blocks())
// doubles; scal: 6.
int nsol_cg_sweep(float* x, const void* r, const void* p, const void* q, void* q_new,
                  void* r_new, void* p_new, float* t1, float* t2, double* partials, double* scal,
                  int first, const float* taps, int kz, int ky, int kx, float rho, int bf16_io,
                  int route, float ih2x, float ih2y, float ih2z, int Z, int Y, int X,
                  void* stream, long long* counts) {
  return cg_sweep(x, r, p, q, q_new, r_new, p_new, t1, t2, partials, scal, first, taps, kz, ky, kx,
                  rho, bf16_io, route, ih2x, ih2y, ih2z, Z, Y, X, stream, counts);
}

// Records row t of x into reg[t], data[t] (float64 device buffers): the
// blur taps of A, 1/h in (x, y, z) order, the loss by its index and its
// scale C at run time. counts[4] is admm_record's.
int nsol_admm_record(const float* x, const float* b, float* t1, float* t2, double* rec_partials,
                     double* reg, double* data, int t, const float* taps, int kz, int ky, int kx,
                     int loss, float scale, float ihx, float ihy, float ihz, int Z, int Y, int X,
                     void* stream, long long* counts) {
  const Spacing sp{ihx, ihy, ihz, 0.f, 0.f, 0.f};
  cudaError_t e = admm_record(x, b, t1, t2, rec_partials, reg, data, t,
                              make_taps(taps, kz, ky, kx), loss, scale, sp, Dims{Z, Y, X},
                              (cudaStream_t)stream);
  counts[kAdmmRecord] += 1;
  return (int)e;
}

// The whole linear ADMM TV-L2 solve (fused.py:382, linear branch; and
// blocked.py::blocked_admm_solve's "step" and "sweep" modes, :1293),
// enqueued on `stream`. x holds x0 on entry and the result on exit. As in
// the fused TPU kernel, x0 is not clipped on entry (tikhonov.py:130 clips
// it; the two agree for x0 = b >= 0). The CG vectors r0, r1 (R), p0, p1 (P)
// and q, q1 (Q) are stored as `storage` says; the outer residual reads x as
// bfloat16 under kStoreState and in float otherwise (compact_dirs keeps an
// exact apply for it, blocked.py:1430-1446). sweep 0: iter_max x (cg_step,
// cg_update), q1 unused (may be null); sweep 1 (kStoreExact or
// kStoreState): iter_max x cg_sweep, q' into the other of q and q1 (the
// solve swaps them), then the owed x += a p (cg_update on x alone),
// partials 4 * max(nsol_max_blocks(), nsol_tiled_blocks), else
// max(nsol_tiled_blocks, nsol_max_blocks) (the marches'). normal_apply
// (A^T b, each outer residual), cg_step and cg_sweep take march.cuh's
// route, march or chain. With
// reg != nullptr the solve also records row 0 (x0) and one row per outer
// iteration (the clipped iterate) into reg/data (fused.py:637-654), the
// Data loss by rec_loss at the scale rec_scale. admm_tail writes w' into
// the other of the two volumes w and v (3 components each) and no v: the
// solve swaps them. counts: 10 (admm.cu's units).
int nsol_admm_solve(const float* b, float* x, float* v, float* w, float* atb, float* rhs,
                    void* r0, void* r1, void* p0, void* p1, void* q, void* q1, float* t1, float* t2,
                    double* partials, double* scal, const float* taps_a, int kaz, int kay,
                    int kax, const float* taps_n, int knz, int kny, int knx, float ihx,
                    float ihy, float ihz, float ih2x, float ih2y, float ih2z, float tau,
                    float rho, int iterations, int iter_max, int storage, int sweep, double* reg,
                    double* data, double* rec_partials, int rec_loss, float rec_scale, int Z,
                    int Y, int X, void* stream, long long* counts) {
  const cudaStream_t s = (cudaStream_t)stream;
  const Dims d{Z, Y, X};
  const Spacing sp{ihx, ihy, ihz, ih2x, ih2y, ih2z};
  const Taps ta = make_taps(taps_a, kaz, kay, kax);
  const bool record = reg != nullptr;
  const int io_r0 = storage == kStoreState ? 1 : 0;
  if (sweep && storage != kStoreExact && storage != kStoreState) return (int)cudaErrorInvalidValue;
  int e;
#define UNIT(idx, call) NSOL_UNIT(counts, idx, call)
#define CALL(call)                  \
  if ((e = (call)) != 0) return e;
  if (record)
    UNIT(kAdmmRecord, admm_record(x, b, t1, t2, rec_partials, reg, data, 0, ta, rec_loss,
                                  rec_scale, sp, d, s));
  // A^T b = A b once (A symmetric, fused.py:576), then v0 = grad x0, w0 = 0
  // and the first rhs.
  CALL(normal_apply_routed(b, atb, t1, t2, nullptr, partials, scal, taps_a, kaz, kay, kax, 0.f,
                           kRegLap, 0, kRouteRule, ih2x, ih2y, ih2z, Z, Y, X, stream, counts));
  // w and w' alternate between the volumes w and v (nothing reads v)
  float* w_cur = w;
  float* w_next = v;
  CALL(nsol_admm_tail(x, nullptr, w_cur, w_cur, atb, rhs, ihx, ihy, ihz, tau, rho, 1, 3, Z, Y, X,
                      stream, counts));
  for (int it = 0; it < iterations; ++it) {
    // warm-started CG on M x = rhs: r = rhs - M x, gamma = |r|^2
    CALL(normal_apply_routed(x, r0, t1, t2, rhs, partials, scal, taps_n, knz, kny, knx, rho,
                             kRegLap, io_r0, kRouteRule, ih2x, ih2y, ih2z, Z, Y, X, stream,
                             counts));
    void* r_cur = r0;
    void* r_next = r1;
    void* p_prev = p0;
    void* p_cur = p1;
    void* q_cur = q;
    void* q_next = q1;
    for (int k = 0; k < iter_max; ++k) {
      if (sweep) {
        CALL(cg_sweep(x, r_cur, p_prev, q_cur, q_next, r_next, p_cur, t1, t2, partials, scal,
                      k == 0, taps_n, knz, kny, knx, rho, storage == kStoreState, kRouteRule,
                      ih2x, ih2y, ih2z, Z, Y, X, stream, counts));
        void* tmp = r_cur;
        r_cur = r_next;
        r_next = tmp;
        tmp = q_cur;
        q_cur = q_next;
        q_next = tmp;
      } else {
        CALL(cg_step(r_cur, p_prev, p_cur, q, t1, t2, partials, scal, k == 0, taps_n, knz, kny,
                     knx, rho, kRegLap, storage, kRouteRule, ih2x, ih2y, ih2z, Z, Y, X, stream,
                     counts));
        UNIT(kCgUpdate, cg_update_s(x, r_cur, p_cur, q, partials, scal, d.n(), storage, 1, s));
      }
      void* tmp = p_prev;
      p_prev = p_cur;
      p_cur = tmp;
    }
    // the last sweep's still-owed x += a p' (blocked.py:1515-1516)
    if (sweep && iter_max > 0)
      UNIT(kCgUpdate, cg_update_s(x, nullptr, p_prev, nullptr, partials, scal, d.n(), storage, 1,
                                  s));
    // clips x, then the shrink, the dual update and the next rhs
    CALL(nsol_admm_tail(x, nullptr, w_cur, w_next, atb, rhs, ihx, ihy, ihz, tau, rho, 0, 3, Z, Y,
                        X, stream, counts));
    float* tmp = w_cur;
    w_cur = w_next;
    w_next = tmp;
    if (record)
      UNIT(kAdmmRecord, admm_record(x, b, t1, t2, rec_partials, reg, data, it + 1, ta, rec_loss,
                                    rec_scale, sp, d, s));
  }
#undef CALL
#undef UNIT
  return 0;
}

}  // extern "C"
