// Hopper (sm_90a) kernels of the shard probes: the stand-alone Pallas
// kernels of benchmarks/shard_pallas_diag*.py, which timed a kernel under
// plain jit against the same kernel inside a 1-device shard_map on the TPU.
// They lie on no solve path; nsol_tpu_torch/parallel/shard_probe.py runs
// them plain and on a "space" mesh of nsol_tpu_torch.parallel.
//
//   probe_scale         out = s * x over z-blocks of zb planes
//     replaces shard_pallas_diag.py::main.triv_kernel (:68 -> :71),
//     shard_pallas_diag2.py::triv (:45 -> :49), shard_pallas_diag3.py::
//     main.k (:48 -> :51) and shard_pallas_diag4.py::main.bspec_kernel
//     (:89 -> :93): the BlockSpec-pipelined "trivial" kernels.
//     Bound: bytes, one read and one write of the volume (256^3 f32:
//     2 x 67.1 MB / 3.35 TB/s = 0.040 ms). What holds such a stream below
//     it is how evenly the SMs share the memory to the end. So the blocks
//     are launched from the work, as PyTorch's elementwise kernels are (no
//     grid-stride loop, whose last trip some threads take alone):
//     blockIdx.y is the z-block, blockIdx.x a part of 256 16-byte columns
//     of it, one a thread, and the hardware hands the next part to
//     whichever SM frees up. s is an immediate or read from device memory.
//     Two or four columns a thread with all loads first, evict-first loads
//     and stores, and the plane ring below at halo 0 were timed no faster
//     on the H100 (PERF.md).
//
//   probe_window_scale  for each z-block of zb output planes, its window
//     of zb + 2 halo planes of a prepadded input copied into shared memory,
//     then the centre planes written scaled
//     replaces shard_pallas_diag4.py::dma_kernel (:46 -> :67; halo 0, the
//     factor an immediate or, as its SMEM input, read from device memory),
//     shard_pallas_diag5.py::main.body (:68 -> :76; halo 6, one slot) and
//     the window DMA of shard_pallas_diag6.py::make_variant (:48 -> :105;
//     one slot or two, its two semaphores).
//     The TPU held a whole (44, 256, 256) window in VMEM (11.5 MB); a block
//     here has at most 227 KB of shared memory. So each block owns a tile of
//     T4 16-byte columns of the (Y, X) plane and walks the z-blocks: it
//     copies the window's tile with cp.async (16 bytes a copy) into a ring
//     of one or two slots, and with two the next window's copy is in flight
//     while this one's centre is stored. The tile is as wide as spreads the
//     plane over one wave of blocks (one a SM), at most what the ring's
//     slots hold in 227 KB.
//     Bound: bytes, what the output needs, one read of the centre planes
//     and one write (256^3: 2 x 67.1 MB / 3.35 TB/s = 0.040 ms, K1's). The
//     kernel itself reads every window, (zb + 2 halo) / zb of the volume
//     (zb 32, halo 6: 2.375 x 67.1 MB = 0.048 ms at the memory rate); the
//     halo re-reads come from L2, not DRAM. A ring of planes, each copied
//     once a tile by a TMA bulk copy, was timed slower on the H100 at halo
//     0 and with two slots, and tied with one (PERF.md).
//
//   probe_block_matmul  out[z] = P[z] m (the x side; P[z] m^T with trans) or
//     m^T P[z] (the y side; m P[z] with trans) for every (Y, X) plane P[z]
//     replaces shard_pallas_diag7.py::pallas_matmul (:46 -> :52; the x side)
//     and the matrix products of shard_pallas_diag6.py::make_variant
//     (:53-66: per matrix m the y side, then the x side, both with trans).
//     The TPU's diag6 program runs the window and the eight products in one
//     kernel over a VMEM-resident (32, 256, 256) block; a 256 x 256 f32
//     plane is 256 KB and fits no block's shared memory, so here the window
//     unit and the eight products are nine launches (fusing them is later
//     work). Two precisions, two kernels:
//
//     "HIGHEST" (probe_sgemm_kernel): full float32 sums, each output one
//     chain of fmaf_rn over k = 0 .. K - 1 from 0. Bound: operations, 2 Y X
//     K a plane (256^3: 8.59 GFLOP / 67 TFLOP/s = 0.128 ms). A register-
//     blocked FMA product: 128 x 128 block tiles, two blocks an SM, 8 x 8
//     outputs a thread read as 16-byte fragments from k-major slots, 16 k a
//     slot through a 4-slot cp.async ring with one barrier a slot (the next
//     slots load while this one's FMAs run). The operand whose k is its unit
//     stride (x on the x side, m under trans) goes into its k-major slot by
//     4-byte copies, transposed on the way; the other by 16-byte ones. One
//     instance a layout (strides compile-time); blocks whose tiles all lie
//     in bounds run without checks, the ragged edge with masked copies and
//     stores.
//
//     "DEFAULT" (probe_mma_stream_kernel): what DEFAULT means on the TPU's
//     matrix unit, x and m rounded to bf16 (nearest even), the products
//     summed in float32 by mma.sync m16n8k16 over k in ascending chunks of
//     16 from 0. Bound: bytes, x read once and out written once (256^3:
//     0.040 ms); the products are 9 us at the bf16 tensor rate. So the
//     kernel is a stream over x with m resident: one block an SM, in
//     clusters of two, rounds the matrix once into shared memory (256 rows
//     x all k in bf16, 128 KB at 256; the pair splits the reads from L2 and
//     writes each other's copy through distributed shared memory), applying
//     trans there, in a swizzled layout that ldmatrix reads without bank
//     conflicts; then walks its bands of x (64 rows of the volume as (Z Y,
//     X) rows on the x side, 64 columns of a plane on the y side) through a
//     cp.async ring of 9-11 slots of 32 k, converting its fragments of the
//     band to bf16 in registers (cvt.rn.bf16x2.f32) and storing float32
//     results in 8-byte streaming stores. A matrix past the resident budget
//     (n > 256: 256 rows of it at a time; n > 384: k in parts of 384, the
//     sums read back from out between parts) goes through the same kernel.
//
// None calls a library kernel: the products are the kernels above.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <stdint.h>

#include <algorithm>

#include "common.cuh"

namespace {

// Kernel units of this file, the indices of its launch counts.
enum Unit { kScale = 0, kWindow = 1, kMatmulHighest = 2, kMatmulDefault = 3 };

constexpr int kMaxSmem = 232448;  // a block's shared memory on the H100

__device__ __forceinline__ float4 scale4(float f, float4 v) {
  v.x = __fmul_rn(f, v.x);
  v.y = __fmul_rn(f, v.y);
  v.z = __fmul_rn(f, v.z);
  v.w = __fmul_rn(f, v.w);
  return v;
}

// out = f x, f = *s_dev where given, else s. blockIdx.y is the z-block of
// block4 16-byte columns (the last may be shorter), blockIdx.x its part of
// kThreads columns, one a thread.
__global__ void __launch_bounds__(kThreads)
    probe_scale_kernel(const float4* __restrict__ x, float4* __restrict__ out, float s,
                       const float* __restrict__ s_dev, long long block4, long long total4) {
  const long long base = (long long)blockIdx.y * block4;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= min(block4, total4 - base)) return;
  const float f = s_dev ? __ldg(s_dev) : s;
  out[base + i] = scale4(f, x[base + i]);
}

// out[z] = f x_ext[z + halo] for the Z output planes of a (Z + 2 halo)-plane
// input, P4 16-byte columns a plane. The block owns columns t0 .. t0 + T4 - 1
// and walks the z-blocks; kSlots 2 copies window b + 1 while storing b.
template <int kSlots>
__global__ void __launch_bounds__(kThreads)
    probe_window_kernel(const float4* __restrict__ x, float4* __restrict__ out, float s,
                        const float* __restrict__ s_dev, int Z, int P4, int zb, int halo, int T4) {
  extern __shared__ float4 ring[];  // kSlots x (zb + 2 halo) x T4
  const float f = s_dev ? __ldg(s_dev) : s;
  const int t0 = blockIdx.x * T4, tw = min(T4, P4 - t0);
  const int span = zb + 2 * halo, nblk = (Z + zb - 1) / zb;
  auto fetch = [&](int b, int slot) {
    const int planes = min(zb, Z - b * zb) + 2 * halo;
    float4* dst = ring + (size_t)slot * span * T4;
    const float4* src = x + (size_t)b * zb * P4 + t0;
    for (int e = threadIdx.x; e < planes * tw; e += blockDim.x) {
      const int j = e / tw, i = e - j * tw;
      __pipeline_memcpy_async(dst + j * T4 + i, src + (size_t)j * P4 + i, 16);
    }
    __pipeline_commit();
  };
  if (kSlots == 2) fetch(0, 0);
  for (int b = 0; b < nblk; ++b) {
    const int slot = kSlots == 2 ? (b & 1) : 0;
    if (kSlots == 1) {
      fetch(b, 0);
      __pipeline_wait_prior(0);
    } else if (b + 1 < nblk) {
      fetch(b + 1, slot ^ 1);  // read last at b - 1, before its closing barrier
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();
    const float4* win = ring + ((size_t)slot * span + halo) * T4;
    float4* dst = out + (size_t)b * zb * P4 + t0;
    const int zl = min(zb, Z - b * zb);
    for (int e = threadIdx.x; e < zl * tw; e += blockDim.x) {
      const int k = e / tw, i = e - k * tw;
      dst[(size_t)k * P4 + i] = scale4(f, win[k * T4 + i]);
    }
    __syncthreads();
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}

// 4 bytes, or 4 zero bytes where !ok (src is then not read)
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// cp_async_wait<n>() for a runtime n (a ring's slots less 2; past 10 it waits for 10)
__device__ __forceinline__ void cp_async_wait_n(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    case 7: cp_async_wait<7>(); break;
    case 8: cp_async_wait<8>(); break;
    case 9: cp_async_wait<9>(); break;
    default: cp_async_wait<10>(); break;
  }
}

// ------------------------------------------------- K3 "HIGHEST", by FMA --

constexpr int kSgTile = 128;                  // M and N of the block tile
constexpr int kSgDepth = 16;                  // k of a ring slot
constexpr int kSgStages = 4;                  // slots of the cp.async ring
constexpr int kSgPitch = kSgTile + 4;         // floats a k row of a slot
constexpr int kSgSlot = kSgDepth * kSgPitch;  // floats of one operand's slot
constexpr int kSgSmem = 2 * kSgStages * kSgSlot * (int)sizeof(float);

// C[z] = A[z] B[z] for z = blockIdx.z: A (M, K), B (K, N), C (M, N) in rows
// of ldc. Element (i, k) of A at a + z a_bs + i lda + k where k is its unit
// stride (kAK of the kernel), else + k lda + i; (k, j) of B at b + z b_bs +
// j ldb + k where kBK, else + k ldb + j. *_vec: 16-byte copies (the operand
// whose unit stride is along M or N) and stores allowed.
struct Gemm {
  const float* a;
  const float* b;
  float* c;
  int M, N, K;
  long long a_bs, b_bs, c_bs;
  int lda, ldb, ldc;
  bool a_vec, b_vec, c_vec;
};

// One operand's slot, k-major ([k][mn], kSgDepth x kSgTile, rows kSgPitch
// apart), of its tile at (mn0, k0). Where k is the unit stride (kKMajor):
// 4-byte copies, a warp's along 8 k of 4 rows (four 32-byte runs),
// transposed on the way; copy q of a thread is k = tid % 8 + 8 (q / 4), mn
// = tid / 8 + 32 (q % 4). Else 16-byte copies along mn (copy q: k = tid /
// 32 + 8 q, mn = 4 (tid % 32)). kWhole: the block's every tile lies in
// bounds (and the mn-major operand is 16-byte aligned); else 4-byte copies,
// zeros out of bounds.
template <bool kKMajor, bool kWhole>
__device__ __forceinline__ void sg_fill(float* slot, const float* src, int ld, int mn0, int k0,
                                        int MN, int K) {
  constexpr int kT = kSgTile, kPitch = kSgPitch;
  const int tid = threadIdx.x;
  if (kKMajor) {
    const int kl = tid & 7, ml = tid >> 3;
    const float* p = src + (long long)(mn0 + ml) * ld + k0 + kl;
    float* d = slot + kl * kPitch + ml;
#pragma unroll
    for (int q = 0; q < kT * kSgDepth / kThreads; ++q) {
      const int k = 8 * (q / (kT / 32)), mn = 32 * (q % (kT / 32));
      const bool ok = kWhole || (mn0 + ml + mn < MN && k0 + kl + k < K);
      cp_async4(d + k * kPitch + mn, ok ? p + (long long)mn * ld + k : src, ok);
    }
  } else if (kWhole) {
    constexpr int kRowStep = kThreads * 4 / kT;
    const int kl = tid / (kT / 4), c = (tid % (kT / 4)) * 4;
    const float* p = src + (long long)(k0 + kl) * ld + mn0 + c;
    float* d = slot + kl * kPitch + c;
#pragma unroll
    for (int q = 0; q < kT * kSgDepth / 4 / kThreads; ++q)
      cp_async16(d + kRowStep * q * kPitch, p + (long long)(kRowStep * q) * ld);
  } else {
#pragma unroll
    for (int q = 0; q < kT * kSgDepth / kThreads; ++q) {
      const int e = tid + q * kThreads;
      const int k = e / kT, mn = e % kT;
      const bool ok = mn0 + mn < MN && k0 + k < K;
      cp_async4(slot + k * kPitch + mn, ok ? src + (long long)(k0 + k) * ld + mn0 + mn : src,
                ok);
    }
  }
}

// acc[i][j] = fma(a[i], b[j], acc[i][j]) for one k: a the thread's 8 rows of
// A's k row (4 at a, 4 at a + 64), b its 8 columns (4 at b, 4 at b + 64),
// each 4 one 16-byte load.
__device__ __forceinline__ void sg_step(float (&acc)[8][8], const float* a, const float* b) {
  const float4 a0 = *reinterpret_cast<const float4*>(a);
  const float4 a1 = *reinterpret_cast<const float4*>(a + kSgTile / 2);
  const float4 b0 = *reinterpret_cast<const float4*>(b);
  const float4 b1 = *reinterpret_cast<const float4*>(b + kSgTile / 2);
  const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
  const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = __fmaf_rn(av[i], bv[j], acc[i][j]);
}

// The block's tile at (m0, n0) of product blockIdx.z (kWhole: every k tile
// whole, no bounds checks, 16-byte stores). A thread computes rows ty 4 +
// {0..3} and 64 + ty 4 + {0..3} by columns tx 4 + {0..3} and 64 + tx 4 +
// {0..3} (tx = tid % 16, ty = tid / 16), so that a warp's A loads hit two
// addresses and its B loads 256 contiguous bytes.
template <bool kAK, bool kBK, bool kWhole>
__device__ __forceinline__ void sg_tile(const Gemm& g, float* As, float* Bs, int m0, int n0) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const float* A = g.a + blockIdx.z * g.a_bs;
  const float* B = g.b + blockIdx.z * g.b_bs;
  const int tiles = (g.K + kSgDepth - 1) / kSgDepth;
  auto fill = [&](int t) {
    const int s = t % kSgStages;
    sg_fill<kAK, kWhole>(As + s * kSgSlot, A, g.lda, m0, t * kSgDepth, g.M, g.K);
    sg_fill<kBK, kWhole>(Bs + s * kSgSlot, B, g.ldb, n0, t * kSgDepth, g.N, g.K);
  };
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
#pragma unroll
  for (int t = 0; t < kSgStages - 1; ++t) {
    if (t < tiles) fill(t);
    cp_async_commit();
  }
  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<kSgStages - 2>();
    __syncthreads();  // slot t landed for every thread; slot t - 1 read by all
    if (t + kSgStages - 1 < tiles) fill(t + kSgStages - 1);
    cp_async_commit();
    const float* as = As + (t % kSgStages) * kSgSlot + ty * 4;
    const float* bs = Bs + (t % kSgStages) * kSgSlot + tx * 4;
    const int kn = kWhole ? kSgDepth : min(kSgDepth, g.K - t * kSgDepth);
    if (kn == kSgDepth) {
#pragma unroll
      for (int k = 0; k < kSgDepth; ++k) sg_step(acc, as + k * kSgPitch, bs + k * kSgPitch);
    } else {
      for (int k = 0; k < kn; ++k) sg_step(acc, as + k * kSgPitch, bs + k * kSgPitch);
    }
  }
  float* C = g.c + blockIdx.z * g.c_bs;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = m0 + ty * 4 + (i & 3) + (i >> 2) * (kSgTile / 2);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = n0 + tx * 4 + h * (kSgTile / 2);
      float* p = C + (long long)r * g.ldc + c;
      if (kWhole) {
        __stcs(reinterpret_cast<float4*>(p),
               make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]));
      } else if (r < g.M) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c + j < g.N) p[j] = acc[i][4 * h + j];
      }
    }
  }
}

// "HIGHEST": float32 FMA sums over k = 0 .. K - 1 in order from 0. A block
// computes a 128 x 128 tile (blockIdx.x: its N tile, fastest, then its M
// tile), a thread 8 x 8 of it (sg_tile), its k tiles through a
// kSgStages-slot cp.async ring with one barrier a tile; two blocks an SM.
// A block whose tiles all lie in bounds takes the path without checks.
template <bool kAK, bool kBK>
__global__ void __launch_bounds__(kThreads, 2) probe_sgemm_kernel(Gemm g) {
  extern __shared__ __align__(16) float sg[];
  float* As = sg;
  float* Bs = sg + kSgStages * kSgSlot;
  const int nt = (g.N + kSgTile - 1) / kSgTile;
  const int m0 = (blockIdx.x / nt) * kSgTile, n0 = (blockIdx.x % nt) * kSgTile;
  const bool whole = m0 + kSgTile <= g.M && n0 + kSgTile <= g.N && g.K % kSgDepth == 0 &&
                     (kAK || g.a_vec) && (kBK || g.b_vec) && g.c_vec;
  if (whole)
    sg_tile<kAK, kBK, true>(g, As, Bs, m0, n0);
  else
    sg_tile<kAK, kBK, false>(g, As, Bs, m0, n0);
}

// ------------------------------------------ K3 "DEFAULT", by bf16 mma.sync --

constexpr int kMmBand = 64;              // rows of an x-side band, columns of a y-side one
constexpr int kMmRows = 256;             // rows of the resident part of the matrix (R)
constexpr int kMmK = 32;                 // k of a ring slot
constexpr int kMmXPitch = kMmK + 8;      // floats a band row of an x-side slot
constexpr int kMmYPitch = kMmBand + 4;   // floats a k row of a y-side slot
constexpr int kMmXSlot = kMmBand * kMmXPitch * (int)sizeof(float);  // bytes
constexpr int kMmYSlot = kMmK * kMmYPitch * (int)sizeof(float);
constexpr int kMmMaxStages = 12;
constexpr int kMmCluster = 2;  // blocks that round the resident part between them

// x (Z, Y, X) times the n x n matrix m (n = X on the x side, Y on the y
// side); R = m with trans, else m^T; the resident part R[r0 .. r0 + 255][k0
// .. k0 + kp - 1] in bf16; the ring's slots.
struct Stream {
  const float* x;
  const float* m;
  float* out;
  int Z, Y, X;
  int trans;
  int x_vec;  // x's rows in 16-byte copies (X % 4 == 0, x 16-byte aligned)
  int m_vec;  // m's rows in 16-byte loads
  int o_vec;  // out in 8-byte stores
  int kp;     // k of R's part, a multiple of 64
  int stages;
};

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // cvt.rn.bf16x2.f32
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t bf16x2(const float* p) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  return bf16x2(v.x, v.y);
}

// d += a b for one m16n8k16 tile: bf16 inputs, float32 accumulator.
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* d, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
               : "r"((unsigned)__cvta_generic_to_shared(p)));
}

// R[r][k] = bf16(m[r0 + r][k0 + k]) with trans, bf16(m[k0 + k][r0 + r])
// without, for r < kMmRows and k < kp; zero past n. 16-byte chunks of 8 k,
// chunk c of row r at c ^ (r & 7), so that the 8 rows of an ldmatrix land
// in 8 distinct bank groups. The blocks of a cluster share the work: a
// block rounds every kMmCluster-th batch of 8 chunks a thread and stores
// each chunk into every block's R (Rs, through distributed shared memory),
// so that m is read from L2 once a cluster. Without trans a warp reads 32
// consecutive r of one row of m; with it, 16-byte loads along the row. A
// thread's loads go out 8 chunks at a time before any is stored.
__device__ void mm_resident(uint4* const* Rs, int rank, const Stream& s, int n, int r0, int k0) {
  const int cpr = s.kp / 8, total = kMmRows * cpr;
  // each cluster starts at its own place in m, so that the SMs' first reads
  // spread over L2 rather than all asking for the same lines
  const int rot = (int)((blockIdx.x / kMmCluster) % cpr) * kThreads;
  auto chunk = [&](int e, int* r, int* c) {
    e = e + rot < total ? e + rot : e + rot - total;
    *r = s.trans ? e / cpr : e % kMmRows;
    *c = s.trans ? e % cpr : e / kMmRows;
  };
  for (int e0 = threadIdx.x + rank * 8 * kThreads; e0 < total;
       e0 += kMmCluster * 8 * kThreads) {
    float v[8][8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      int r, c;
      chunk(e0 + j * kThreads, &r, &c);
      const int gr = r0 + r, gk = k0 + 8 * c;
      if (s.trans && s.m_vec && gr < n && gk + 8 <= n) {
        const float4* p = reinterpret_cast<const float4*>(s.m + (long long)gr * n + gk);
        const float4 lo = __ldg(p), hi = __ldg(p + 1);
        v[j][0] = lo.x, v[j][1] = lo.y, v[j][2] = lo.z, v[j][3] = lo.w;
        v[j][4] = hi.x, v[j][5] = hi.y, v[j][6] = hi.z, v[j][7] = hi.w;
      } else {
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          const int k = gk + t;
          v[j][t] = gr < n && k < n
                        ? __ldg(s.m + (s.trans ? (long long)gr * n + k : (long long)k * n + gr))
                        : 0.f;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      int r, c;
      chunk(e0 + j * kThreads, &r, &c);
      const uint4 u = make_uint4(bf16x2(v[j][0], v[j][1]), bf16x2(v[j][2], v[j][3]),
                                 bf16x2(v[j][4], v[j][5]), bf16x2(v[j][6], v[j][7]));
#pragma unroll
      for (int b = 0; b < kMmCluster; ++b) Rs[b][r * cpr + (c ^ (r & 7))] = u;
    }
  }
}

// One ring slot: the kRows x kCols floats at src (rows ld apart), of which
// rows_in x cols_in lie in bounds, into [kRows][kPitch]; 16-byte copies where
// the tile is whole and aligned, else 4-byte ones, zeros out of bounds
// (`any`: a valid address for those).
template <int kRows, int kCols, int kPitch>
__device__ __forceinline__ void mm_fill(float* slot, const float* src, long long ld, int rows_in,
                                        int cols_in, bool vec, const float* any) {
  if (vec && rows_in == kRows && cols_in == kCols) {
#pragma unroll
    for (int q = 0; q < kRows * kCols / 4 / kThreads; ++q) {
      const int e = threadIdx.x + q * kThreads;
      const int r = e / (kCols / 4), c = e % (kCols / 4) * 4;
      cp_async16(slot + r * kPitch + c, src + r * ld + c);
    }
  } else {
    for (int e = threadIdx.x; e < kRows * kCols; e += kThreads) {
      const int r = e / kCols, c = e % kCols;
      const bool ok = r < rows_in && c < cols_in;
      cp_async4(slot + r * kPitch + c, ok ? src + r * ld + c : any, ok);
    }
  }
}

// "DEFAULT": x and m rounded to bf16 (nearest even), float32 sums by
// mma.sync m16n8k16 in ascending chunks of 16 k from 0. One block an SM
// (persistent), in clusters of kMmCluster: for each 256-row part of R (more
// than one only past n = 256) and each k part that fits beside the ring
// (more than one only past n = 384), the cluster rounds the part once into
// each block's shared memory (mm_resident), then each block streams
// its bands of x (bands blockIdx.x, + gridDim.x, ...) through the ring, 32
// k a slot, one barrier a slot. x side (kSide 0): a band is 64 rows of the
// volume as (Z Y, X) rows; warp w computes band rows (w / 4) 32 .. + 31 by
// R rows (the output columns) (w % 4) 64 .. + 63, its A fragments read
// from the slot in float32 and rounded in registers, its B fragments by
// ldmatrix from R. y side: a band is 64 columns of one plane (all its k =
// Y rows); warp w computes R rows (the output rows) (w / 2) 64 .. + 63 by
// band columns (w % 2) 32 .. + 31, A by ldmatrix from R, B read and
// rounded in registers. Past the first k part each output's sum is read
// back from out, where the last part left it.
template <int kSide>
__global__ void __cluster_dims__(kMmCluster, 1, 1) __launch_bounds__(kThreads, 1)
    probe_mma_stream_kernel(Stream s) {
  constexpr int kSlot = (kSide == 0 ? kMmXSlot : kMmYSlot) / (int)sizeof(float);
  extern __shared__ __align__(128) unsigned char mm[];
  uint4* R = reinterpret_cast<uint4*>(mm);
  float* ring = reinterpret_cast<float*>(mm + (size_t)kMmRows * s.kp * 2);
  const int n = kSide == 0 ? s.X : s.Y;
  const long long plane = (long long)s.Y * s.X, rows = (long long)s.Z * s.Y;
  const int xb = (s.X + kMmBand - 1) / kMmBand;  // y side: bands a plane
  const int bands = kSide == 0 ? (int)((rows + kMmBand - 1) / kMmBand) : s.Z * xb;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3, q = lane >> 3, lr = lane & 7;
  // the warp's tile: x side rows wm 32 of the band by R rows wn 64; y side
  // R rows wm 64 by band columns wn 32
  const int wm = kSide == 0 ? warp >> 2 : warp >> 1, wn = kSide == 0 ? warp & 3 : warp & 1;
  const int cpr = s.kp / 8;
  const int mine = (int)blockIdx.x < bands ? (bands - 1 - (int)blockIdx.x) / gridDim.x + 1 : 0;
  namespace cg = cooperative_groups;
  const cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  uint4* Rs[kMmCluster];
#pragma unroll
  for (int b = 0; b < kMmCluster; ++b) Rs[b] = cluster.map_shared_rank(R, b);
  for (int r0 = 0; r0 < n; r0 += kMmRows)
    for (int k0 = 0; k0 < n; k0 += s.kp) {
      const int kn = min(s.kp, n - k0);
      const int kt_n = (kn + kMmK - 1) / kMmK;
      const int T = mine * kt_n;
      // the next slot to fill: band fb of this block, its k tile fk, ring slot fs
      int fb = blockIdx.x, fk = 0, fs = 0;
      auto fill_next = [&]() {
        float* slot = ring + fs * kSlot;
        const int kk = k0 + fk * kMmK;
        if (kSide == 0) {
          const long long row = (long long)fb * kMmBand;
          const int rows_in = rows - row < kMmBand ? (int)(rows - row) : kMmBand;
          mm_fill<kMmBand, kMmK, kMmXPitch>(slot, s.x + row * s.X + kk, s.X, rows_in,
                                            min(kMmK, n - kk), s.x_vec, s.x);
        } else {
          const int z = fb / xb, j0 = (fb - z * xb) * kMmBand;
          mm_fill<kMmK, kMmBand, kMmYPitch>(slot, s.x + z * plane + (long long)kk * s.X + j0,
                                            s.X, min(kMmK, n - kk), min(kMmBand, s.X - j0),
                                            s.x_vec, s.x);
        }
        if (++fk == kt_n) fk = 0, fb += gridDim.x;
        if (++fs == s.stages) fs = 0;
      };
      // this thread's first output in band `band` (its pair (f, h) lies
      // row_off(f, h) rows and col_off(f) columns on), and whether all the
      // band's outputs of this part lie in bounds
      auto first = [&](int band, long long* off, bool* whole) {
        if (kSide == 0) {
          const long long row = (long long)band * kMmBand;
          *off = (row + wm * 32 + gid) * s.X + r0 + wn * 64 + 2 * tig;
          *whole = s.o_vec && row + kMmBand <= rows && r0 + kMmRows <= n;
        } else {
          const int z = band / xb, j0 = (band - z * xb) * kMmBand;
          *off = z * plane + (long long)(r0 + wm * 64 + gid) * s.X + j0 + wn * 32 + 2 * tig;
          *whole = s.o_vec && r0 + kMmRows <= n && j0 + kMmBand <= s.X;
        }
      };
      auto row_off = [](int f, int h) { return (kSide == 0 ? f >> 3 : f >> 2) * 16 + 8 * h; };
      auto col_off = [](int f) { return (kSide == 0 ? f & 7 : f & 3) * 8; };
      // bounds of the pair (f, h) where the band is not whole
      auto in_rows = [&](int band, int f, int h) {
        if (kSide == 0)
          return (long long)band * kMmBand + wm * 32 + row_off(f, h) + gid < rows;
        return r0 + wm * 64 + row_off(f, h) + gid < n;
      };
      auto col0 = [&](int band, int f) {
        const int j0 = kSide == 0 ? r0 + wn * 64 : (band - band / xb * xb) * kMmBand + wn * 32;
        return j0 + col_off(f) + 2 * tig;
      };
#pragma unroll 1
      for (int t = 0; t < s.stages - 1; ++t) {
        if (t < T) fill_next();
        cp_async_commit();
      }
      cluster.sync();  // every block of the cluster running and done with its last R
      mm_resident(Rs, rank, s, n, r0, k0);  // while the ring's first slots land
      cluster.sync();  // R whole in every block
      float acc[16][4];
      int band = blockIdx.x, kt = 0, cs = 0;  // the slot taken: band, k tile, ring slot
      for (int t = 0; t < T; ++t) {
        cp_async_wait_n(s.stages - 2);
        __syncthreads();  // slot t (and at t = 0 R) ready; slot t - 1 read by all
        if (t + s.stages - 1 < T) fill_next();
        cp_async_commit();
        if (kt == 0) {
#pragma unroll
          for (int f = 0; f < 16; ++f)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[f][e] = 0.f;
          if (k0 > 0) {  // the sums so far, where the last k part left them
            long long off;
            bool whole;
            first(band, &off, &whole);
#pragma unroll
            for (int f = 0; f < 16; ++f)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const float* p = s.out + off + (long long)row_off(f, h) * s.X + col_off(f);
                const int c = col0(band, f);
                if (whole || in_rows(band, f, h)) {
                  if (whole || c < s.X) acc[f][2 * h] = p[0];
                  if (whole || c + 1 < s.X) acc[f][2 * h + 1] = p[1];
                }
              }
          }
        }
        const float* slot = ring + cs * kSlot;
        const int kc0 = kt * kMmK / 8;  // R's chunk of the slot's first k
        auto step = [&](int ks) {
          const int kc = kc0 + 2 * ks;
          if (kSide == 0) {
            uint32_t af[2][4];
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
              const float* a = slot + (wm * 32 + mt * 16 + gid) * kMmXPitch + ks * 16 + 2 * tig;
              af[mt][0] = bf16x2(a);
              af[mt][1] = bf16x2(a + 8 * kMmXPitch);
              af[mt][2] = bf16x2(a + 8);
              af[mt][3] = bf16x2(a + 8 * kMmXPitch + 8);
            }
#pragma unroll
            for (int np = 0; np < 4; ++np) {
              const int r = wn * 64 + np * 16 + lr + ((q >> 1) << 3);
              uint32_t b[4];
              ldmatrix_x4(b, R + r * cpr + ((kc + (q & 1)) ^ (r & 7)));
#pragma unroll
              for (int mt = 0; mt < 2; ++mt) {
                mma_bf16(acc[mt * 8 + 2 * np], af[mt], b);
                mma_bf16(acc[mt * 8 + 2 * np + 1], af[mt], b + 2);
              }
            }
          } else {
            uint32_t af[4][4];
#pragma unroll
            for (int mt = 0; mt < 4; ++mt) {
              const int r = wm * 64 + mt * 16 + lr + ((q & 1) << 3);
              ldmatrix_x4(af[mt], R + r * cpr + ((kc + (q >> 1)) ^ (r & 7)));
            }
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
              const float* b = slot + (ks * 16 + 2 * tig) * kMmYPitch + wn * 32 + nt * 8 + gid;
              const uint32_t bf[2] = {bf16x2(b[0], b[kMmYPitch]),
                                      bf16x2(b[8 * kMmYPitch], b[9 * kMmYPitch])};
#pragma unroll
              for (int mt = 0; mt < 4; ++mt) mma_bf16(acc[mt * 4 + nt], af[mt], bf);
            }
          }
        };
        const int steps = (min(kMmK, kn - kt * kMmK) + 15) / 16;
        if (steps == kMmK / 16) {
#pragma unroll
          for (int ks = 0; ks < kMmK / 16; ++ks) step(ks);
        } else {
          for (int ks = 0; ks < steps; ++ks) step(ks);
        }
        if (kt == kt_n - 1) {
          long long off;
          bool whole;
          first(band, &off, &whole);
          if (whole) {
#pragma unroll
            for (int f = 0; f < 16; ++f)
#pragma unroll
              for (int h = 0; h < 2; ++h)
                __stcs(reinterpret_cast<float2*>(s.out + off + (long long)row_off(f, h) * s.X +
                                                 col_off(f)),
                       make_float2(acc[f][2 * h], acc[f][2 * h + 1]));
          } else {
#pragma unroll
            for (int f = 0; f < 16; ++f)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                float* p = s.out + off + (long long)row_off(f, h) * s.X + col_off(f);
                const int c = col0(band, f);
                if (in_rows(band, f, h)) {
                  if (c < s.X) p[0] = acc[f][2 * h];
                  if (c + 1 < s.X) p[1] = acc[f][2 * h + 1];
                }
              }
          }
        }
        if (++kt == kt_n) kt = 0, band += gridDim.x;
        if (++cs == s.stages) cs = 0;
      }
      cp_async_wait<0>();
      __syncthreads();  // R and the ring free for the next part
    }
}

}  // namespace

// ------------------------------------------------------------ C interface --
// Every function enqueues on `stream`, never synchronizes, allocates
// nothing, adds one to counts[unit] per launch, and returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for a shape
// it does not take (the wrappers check first). Volumes are contiguous
// float32, (Y X) a multiple of 4 and 16-byte aligned for the two streams.

extern "C" {

// out (Z, Y, X) = s x, or *s_dev x where s_dev is not null.
int nsol_probe_scale(const float* x, float* out, float s, const float* s_dev, int Z, int Y, int X,
                     int zb, void* stream, long long* counts) {
  const long long P4 = (long long)Y * X / 4;
  if (Z < 1 || zb < 1 || P4 < 1) return (int)cudaErrorInvalidValue;
  const int nblk = (Z + zb - 1) / zb;
  const long long block4 = (long long)std::min(zb, Z) * P4;
  const dim3 grid((unsigned)((block4 + kThreads - 1) / kThreads), nblk);
  probe_scale_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float4*)x, (float4*)out, s, s_dev, block4, (long long)Z * P4);
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) counts[kScale] += 1;
  return (int)err;
}

// out (Z, Y, X) = s x_ext[halo : halo + Z] of x_ext (Z + 2 halo, Y, X),
// window by window (zb + 2 halo planes), through a ring of `slots` (1 or 2).
int nsol_probe_window_scale(const float* x_ext, float* out, float s, const float* s_dev, int Z,
                            int Y, int X, int zb, int halo, int slots, void* stream,
                            long long* counts) {
  const long long P4 = (long long)Y * X / 4;
  if (Z < 1 || zb < 1 || halo < 0 || P4 < 1 || P4 > (1LL << 30) || (slots != 1 && slots != 2))
    return (int)cudaErrorInvalidValue;
  const long long slot_col = (long long)(zb + 2 * halo) * sizeof(float4);  // a column of a slot
  const int max_t4 = (int)(kMaxSmem / (slots * slot_col)) / 32 * 32;
  if (max_t4 < 32) return (int)cudaErrorInvalidValue;
  const int sms = device_sms();
  int t4 = (int)((P4 + sms - 1) / sms + 31) / 32 * 32;
  t4 = std::min(t4, max_t4);
  const int grid = (int)((P4 + t4 - 1) / t4);
  const int smem = (int)(slots * slot_col * t4);
  const cudaStream_t st = (cudaStream_t)stream;
  if (slots == 1) {
    cudaFuncSetAttribute(probe_window_kernel<1>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem);
    probe_window_kernel<1><<<grid, kThreads, smem, st>>>(
        (const float4*)x_ext, (float4*)out, s, s_dev, Z, (int)P4, zb, halo, t4);
  } else {
    cudaFuncSetAttribute(probe_window_kernel<2>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem);
    probe_window_kernel<2><<<grid, kThreads, smem, st>>>(
        (const float4*)x_ext, (float4*)out, s, s_dev, Z, (int)P4, zb, halo, t4);
  }
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) counts[kWindow] += 1;
  return (int)err;
}

// out[z] of every (Y, X) plane x[z]: side 0 (x) x[z] m, or x[z] m^T with
// trans, m (X, X); side 1 (y) m^T x[z], or m x[z] with trans, m (Y, Y).
// precision 0 "HIGHEST" (float32 sums), 1 "DEFAULT" (bf16 inputs, float32
// sums). Any shape and alignment: the kernels mask and copy in 4 bytes
// where 16 do not fit.
int nsol_probe_block_matmul(const float* x, const float* m, float* out, int Z, int Y, int X,
                            int side, int trans, int precision, void* stream, long long* counts) {
  if (Z < 1 || Y < 1 || X < 1 || (side != 0 && side != 1) || (precision != 0 && precision != 1))
    return (int)cudaErrorInvalidValue;
  auto aligned = [](const void* p, int bytes) { return (uintptr_t)p % bytes == 0; };
  const long long plane = (long long)Y * X;
  const cudaStream_t st = (cudaStream_t)stream;
  if (precision == 0) {
    Gemm g;
    g.c = out, g.c_bs = plane, g.M = Y, g.N = X, g.ldc = X;
    g.c_vec = X % 4 == 0 && aligned(out, 16);
    if (side == 0) {  // A = x[z], B = m (or m^T: k its unit stride)
      g.a = x, g.a_bs = plane, g.lda = X, g.a_vec = false, g.K = X;
      g.b = m, g.b_bs = 0, g.ldb = X, g.b_vec = X % 4 == 0 && aligned(m, 16);
    } else {  // A = m^T (i its unit stride) or m, B = x[z]
      g.a = m, g.a_bs = 0, g.lda = Y, g.a_vec = Y % 4 == 0 && aligned(m, 16), g.K = Y;
      g.b = x, g.b_bs = plane, g.ldb = X, g.b_vec = X % 4 == 0 && aligned(x, 16);
    }
    const dim3 grid(((Y + kSgTile - 1) / kSgTile) * ((X + kSgTile - 1) / kSgTile), 1, Z);
    auto launch = [&](auto kernel) {
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSgSmem);
      kernel<<<grid, kThreads, kSgSmem, st>>>(g);
    };
    if (side == 0 && !trans) launch(probe_sgemm_kernel<true, false>);
    else if (side == 0) launch(probe_sgemm_kernel<true, true>);
    else if (!trans) launch(probe_sgemm_kernel<false, false>);
    else launch(probe_sgemm_kernel<true, false>);
    counts[kMatmulHighest] += 1;
    return (int)cudaGetLastError();
  }
  const int n = side == 0 ? X : Y;
  Stream s;
  s.x = x, s.m = m, s.out = out, s.Z = Z, s.Y = Y, s.X = X, s.trans = trans ? 1 : 0;
  s.x_vec = X % 4 == 0 && aligned(x, 16);
  s.m_vec = n % 4 == 0 && aligned(m, 16);
  s.o_vec = X % 2 == 0 && aligned(out, 8);
  // R's k part: all of n where 256 rows of it fit beside a ring of 3 slots,
  // a multiple of 64 (8 chunks a row, the swizzle's span)
  const int slot = side == 0 ? kMmXSlot : kMmYSlot;
  const int cap = (kMaxSmem - 3 * slot) / (kMmRows * 2) / 64 * 64;
  s.kp = std::min((n + 63) / 64 * 64, cap);
  const int resident = kMmRows * s.kp * 2;
  s.stages = std::min(kMmMaxStages, (kMaxSmem - resident) / slot);
  const int smem = resident + s.stages * slot;
  const long long bands = side == 0 ? (Z * (long long)Y + kMmBand - 1) / kMmBand
                                    : Z * (long long)((X + kMmBand - 1) / kMmBand);
  if (bands > (1LL << 30)) return (int)cudaErrorInvalidValue;
  // whole clusters (a block with no band still rounds its share of R)
  const int grid = (int)std::max<long long>(
      kMmCluster, std::min<long long>(bands, device_sms()) / kMmCluster * kMmCluster);
  auto launch = [&](auto kernel) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    kernel<<<grid, kThreads, smem, st>>>(s);
  };
  if (side == 0) launch(probe_mma_stream_kernel<0>);
  else launch(probe_mma_stream_kernel<1>);
  counts[kMatmulDefault] += 1;
  return (int)cudaGetLastError();
}

}  // extern "C"
