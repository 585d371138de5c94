// Hopper (sm_90a) stream kernels: the elementwise units that move bytes and
// do next to no arithmetic, launched by tiled.cu and tikhonov.cu.
//
//   stream_direction  p = r + beta p stored as P; in the deferred form (q
//                     given: the "apply" CG under bfloat16 state, whose
//                     cg_update left r alone) r' = r - a q first, stored
//                     back to r as R, and p = r' + beta p from the
//                     unrounded r'. The "apply" CG's direction update
//                     (tiled.cu cg_direction, enqueued by
//                     nsol_blocked_admm_solve), which the JAX package leaves
//                     to XLA (nsol_tpu/ops/pallas/blocked.py:1535-1541): no
//                     TPU kernel.
//   stream_clip       out = in < 0 ? 0 : in, so a NaN stays NaN as under
//                     jnp.maximum: tikhonov.cu tik_clip, the box projection
//                     of nsol_tpu/ops/pallas/fused.py::
//                     make_fused_tikhonov_solver (:716; the clips at
//                     fused.py:812 and :877).
//
// What bounds them on the H100: bytes. At 512^3 the direction moves 12
// bytes a voxel (float), 8 (bfloat16 p) or 10 (the deferred bfloat16
// state): 1.07-1.61 GB a call, far past the 50 MB L2, each byte touched
// once; the clip moves 8. What the design does about it:
//   - A thread takes a chunk of N voxels of every stream: N = 8 where every
//     stream is bfloat16 (one 16-byte uint4 a stream, unpacked and packed as
//     __nv_bfloat162 pairs), else N = 4 (one 16-byte float4 of a float
//     stream, one 8-byte uint2 of a bfloat16 one beside it). Neighbouring
//     threads take neighbouring chunks, so that every access of a warp
//     covers whole 32-byte sectors: 512 contiguous bytes of a stream (256 of
//     a bfloat16 one beside float ones). All of a chunk's loads are issued
//     before its first store.
//   - Blocks of kStreamThreads = 128 threads, one chunk a thread, the grid
//     launched from the work as PyTorch's own elementwise kernels are. Two
//     chunks a thread, a grid of what the card holds resident striding over
//     the chunks, and evict-first loads and stores (__ldcs/__stcs) each
//     measured no faster on the H100 (PERF.md).
//   - The vector path runs when every pointer is 16-byte aligned; the
//     scalar body (one element a thread) then runs the tail n mod N. A
//     misaligned view runs the scalar body on every element. One kernel
//     takes its path by the addresses it is given.
// The per-element arithmetic is the scalar kernels' own (stencil.cuh's
// axpy_as and store_as, common.cuh's clip0), so both paths give the same
// bits.
//
// Each launch enqueues one kernel on `s`, never synchronizes, allocates
// nothing and returns cudaGetLastError(); it counts nothing (its caller
// counts the launch as its own unit).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>
#include <type_traits>

#include "stencil.cuh"

namespace {

constexpr int kStreamThreads = 128;

// chunk c (voxels N c .. N c + N - 1) of a stream, as float
template <int N>
__device__ __forceinline__ void load_chunk(const float* base, long long c, float (&v)[N]) {
  const float4* q = reinterpret_cast<const float4*>(base) + (N / 4) * c;
#pragma unroll
  for (int h = 0; h < N / 4; ++h) {
    const float4 f = q[h];
    v[4 * h] = f.x, v[4 * h + 1] = f.y, v[4 * h + 2] = f.z, v[4 * h + 3] = f.w;
  }
}

template <int N>
__device__ __forceinline__ void load_chunk(const bf16* base, long long c, float (&v)[N]) {
  __nv_bfloat162 h[N / 2];
  if constexpr (N == 8) {
    const uint4 u = reinterpret_cast<const uint4*>(base)[c];
    memcpy(h, &u, sizeof(u));
  } else {
    const uint2 u = reinterpret_cast<const uint2*>(base)[c];
    memcpy(h, &u, sizeof(u));
  }
#pragma unroll
  for (int k = 0; k < N / 2; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    v[2 * k] = f.x, v[2 * k + 1] = f.y;
  }
}

// chunk c of a stream, each value stored as the stream's type (store_as)
template <int N>
__device__ __forceinline__ void store_chunk(float* base, long long c, const float (&v)[N]) {
  float4* q = reinterpret_cast<float4*>(base) + (N / 4) * c;
#pragma unroll
  for (int h = 0; h < N / 4; ++h)
    q[h] = make_float4(v[4 * h], v[4 * h + 1], v[4 * h + 2], v[4 * h + 3]);
}

template <int N>
__device__ __forceinline__ void store_chunk(bf16* base, long long c, const float (&v)[N]) {
  __nv_bfloat162 h[N / 2];
#pragma unroll
  for (int k = 0; k < N / 2; ++k)
    h[k] = __halves2bfloat162(store_as<bf16>(v[2 * k]), store_as<bf16>(v[2 * k + 1]));
  if constexpr (N == 8) {
    uint4 u;
    memcpy(&u, h, sizeof(u));
    reinterpret_cast<uint4*>(base)[c] = u;
  } else {
    uint2 u;
    memcpy(&u, h, sizeof(u));
    reinterpret_cast<uint2*>(base)[c] = u;
  }
}

// Thread t takes chunk t (chunk(t)) and, below n mod N, the tail element
// N nc + t (one(i)); without vec, element t. The grid covers the work.
template <int N, class Chunk, class One>
__device__ __forceinline__ void stream_loop(long long n, int vec, Chunk chunk, One one) {
  const long long t = (long long)blockIdx.x * kStreamThreads + threadIdx.x;
  if (!vec) {
    if (t < n) one(t);
    return;
  }
  const long long nc = n / N;
  if (t < nc) chunk(t);
  if (t < n - nc * N) one(nc * N + t);
}

// one voxel of the direction update, in float: r' (deferred form) and p'
template <class R, class P, bool kDeferred>
__device__ __forceinline__ void direction(float& r, float& p, float q, float a, float beta) {
  if (kDeferred) r = axpy_as<R>(-a, q, r);
  p = axpy_as<P>(beta, p, r);
}

template <class R, class P, class Q, bool kDeferred, int N>
__global__ void __launch_bounds__(kStreamThreads)
    direction_kernel(P* __restrict__ p, R* __restrict__ r, const Q* __restrict__ q,
                     const double* __restrict__ scal, long long n, int vec) {
  const float beta = (float)scal[kBeta];
  const float a = (float)scal[kA];
  auto chunk = [&](long long c) {
    float pv[N], rv[N], qv[N];
    load_chunk<N>(p, c, pv);
    load_chunk<N>(r, c, rv);
    if constexpr (kDeferred) load_chunk<N>(q, c, qv);
#pragma unroll
    for (int k = 0; k < N; ++k)
      direction<R, P, kDeferred>(rv[k], pv[k], kDeferred ? qv[k] : 0.f, a, beta);
    if constexpr (kDeferred) store_chunk<N>(r, c, rv);
    store_chunk<N>(p, c, pv);
  };
  auto one = [&](long long i) {
    float ri = to_float(r[i]), pi = to_float(p[i]);
    direction<R, P, kDeferred>(ri, pi, kDeferred ? to_float(q[i]) : 0.f, a, beta);
    if (kDeferred) r[i] = store_as<R>(ri);
    p[i] = store_as<P>(pi);
  };
  stream_loop<N>(n, vec, chunk, one);
}

// legal in place (out == in), so no __restrict__
__global__ void __launch_bounds__(kStreamThreads)
    clip_kernel(float* out, const float* in, long long n, int vec) {
  auto chunk = [&](long long c) {
    float v[4];
    load_chunk<4>(in, c, v);
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = clip0(v[k]);
    store_chunk<4>(out, c, v);
  };
  stream_loop<4>(n, vec, chunk, [&](long long i) { out[i] = clip0(in[i]); });
}

inline bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

// Blocks of a call over n elements: a thread a chunk of N (at least one
// block, for the tail), or a thread an element on the scalar path; 0 past
// the grid's limit (never for a tensor that fits the card).
inline unsigned stream_blocks(long long n, bool vec, int N) {
  const long long per_block = vec ? (long long)kStreamThreads * N : kStreamThreads;
  const long long b = n > 0 ? (n + per_block - 1) / per_block : 1;
  return b <= 0x7fffffff ? (unsigned)b : 0u;
}

template <class R, class P, class Q, bool kDeferred>
cudaError_t launch_direction(P* p, R* r, const Q* q, const double* scal, long long n,
                             cudaStream_t s) {
  constexpr int N = std::is_same<R, bf16>::value && std::is_same<P, bf16>::value &&
                            (!kDeferred || std::is_same<Q, bf16>::value)
                        ? 8
                        : 4;
  const bool vec = aligned16(p) && aligned16(r) && (!kDeferred || aligned16(q));
  const unsigned grid = stream_blocks(n, vec, N);
  if (grid == 0) return cudaErrorInvalidValue;
  direction_kernel<R, P, Q, kDeferred, N><<<grid, kStreamThreads, 0, s>>>(p, r, q, scal, n, vec);
  return cudaGetLastError();
}

// p, r and q (null: the plain form) stored as the Storage mode `storage`
// says (stencil.cuh); beta = scal[kBeta], a = scal[kA].
inline cudaError_t stream_direction(void* p, void* r, const void* q, const double* scal,
                                    long long n, int storage, cudaStream_t s) {
  return with_storage(storage, [&](auto st) {
    using S = decltype(st);
    using R = typename S::R;
    using P = typename S::P;
    using Q = typename S::Q;
    P* pp = static_cast<P*>(p);
    R* rr = static_cast<R*>(r);
    const Q* qq = static_cast<const Q*>(q);
    return qq != nullptr ? launch_direction<R, P, Q, true>(pp, rr, qq, scal, n, s)
                         : launch_direction<R, P, Q, false>(pp, rr, qq, scal, n, s);
  });
}

inline cudaError_t stream_clip(float* out, const float* in, long long n, cudaStream_t s) {
  const bool vec = aligned16(out) && aligned16(in);
  const unsigned grid = stream_blocks(n, vec, 4);
  if (grid == 0) return cudaErrorInvalidValue;
  clip_kernel<<<grid, kStreamThreads, 0, s>>>(out, in, n, vec);
  return cudaGetLastError();
}

}  // namespace
