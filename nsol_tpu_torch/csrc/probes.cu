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
//     2 x 67.1 MB / 3.35 TB/s = 0.040 ms). A 16-byte load and store a
//     thread and step, a grid of z-blocks (blockIdx.y) by a grid-stride
//     over each block's planes; s an immediate or read from device memory.
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
//     (zb 32, halo 6: 2.375 x 67.1 MB = 0.048 ms at the memory rate).
//
//   probe_block_matmul  out[z] = P[z] m (the x side; P[z] m^T with trans) or
//     m^T P[z] (the y side; m P[z] with trans) for every (Y, X) plane P[z]
//     replaces shard_pallas_diag7.py::pallas_matmul (:46 -> :52; the x side)
//     and the matrix products of shard_pallas_diag6.py::make_variant
//     (:53-66: per matrix m the y side, then the x side, both with trans).
//     Two precisions. "HIGHEST": full float32 sums, a tiled FMA product
//     (128 x 128 tiles, 8 deep, 8 x 8 outputs a thread); bound by
//     operations: 2 Y X K a plane, 256^3 at K = 256 is 8.59 GFLOP / 67
//     TFLOP/s = 0.128 ms. "DEFAULT": what DEFAULT means on the TPU's matrix
//     unit, each input rounded to bfloat16 (nearest even) and the products
//     summed in float32, by bf16 mma.sync (m16n8k16, f32 accumulator; 128 x
//     128 tiles, 32 deep, 64 x 32 a warp); bound by bytes (0.040 ms at
//     256^3). The TPU's diag6 program runs the window and the eight
//     products in one kernel over a VMEM-resident (32, 256, 256) block; a
//     256 x 256 f32 plane is 256 KB and fits no block's shared memory, so
//     here the window unit and the eight products are nine launches (fusing
//     them is later work).
//
// None calls a library kernel: the products are the tiles above.

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
constexpr int kGemmTile = 128;    // M and N of a product's block tile
constexpr int kFmaDepth = 8;      // K of the FMA tile
constexpr int kMmaDepth = 32;     // K of the mma tile
constexpr int kMmaPad = 8;        // bf16 pad of an mma tile row (no bank conflict)

__device__ __forceinline__ float4 scale4(float f, float4 v) {
  v.x = __fmul_rn(f, v.x);
  v.y = __fmul_rn(f, v.y);
  v.z = __fmul_rn(f, v.z);
  v.w = __fmul_rn(f, v.w);
  return v;
}

// out = f x, f = *s_dev where given, else s; blockIdx.y is the z-block of
// block4 16-byte columns (the last may be shorter), blockIdx.x strides over it.
__global__ void __launch_bounds__(kThreads)
    probe_scale_kernel(const float4* __restrict__ x, float4* __restrict__ out, float s,
                       const float* __restrict__ s_dev, long long block4, long long total4) {
  const float f = s_dev ? __ldg(s_dev) : s;
  const long long base = (long long)blockIdx.y * block4;
  const long long len = min(block4, total4 - base);
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < len;
       i += (long long)gridDim.x * blockDim.x)
    out[base + i] = scale4(f, __ldg(x + base + i));
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

// C[z] = A[z] B[z]: element (i, k) of A[z] at a + z a_bs + i a_ri + k a_ci,
// (k, j) of B[z] likewise, (i, j) of C[z] at c + z c_bs + i ldc + j.
struct Gemm {
  const float* a;
  const float* b;
  float* c;
  int M, N, K;
  long long a_bs, b_bs, c_bs;
  int a_ri, a_ci, b_ri, b_ci, ldc;
};

// Element e of a rows x cols tile, walked along whichever index is unit
// stride in device memory (so a warp's loads are contiguous); returns (row, col).
__device__ __forceinline__ int2 tile_index(int e, int rows, int cols, bool col_fast) {
  return col_fast ? make_int2(e / cols, e % cols) : make_int2(e % rows, e / rows);
}

__device__ __forceinline__ float load_or_zero(const float* p, int i, int k, int ni, int nk,
                                              int ri, int ci) {
  return (i < ni && k < nk) ? __ldg(p + (long long)i * ri + (long long)k * ci) : 0.f;
}

// "HIGHEST": float32 FMA sums over k in order, 8 x 8 outputs a thread
// (rows ty + 16 i, columns tx + 16 j of the block's 128 x 128 tile).
__global__ void __launch_bounds__(kThreads) probe_gemm_f32_kernel(Gemm g) {
  __shared__ float As[kFmaDepth][kGemmTile + 4];
  __shared__ float Bs[kFmaDepth][kGemmTile + 4];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * kGemmTile, n0 = blockIdx.x * kGemmTile;
  const float* A = g.a + blockIdx.z * g.a_bs;
  const float* B = g.b + blockIdx.z * g.b_bs;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < g.K; k0 += kFmaDepth) {
#pragma unroll
    for (int q = 0; q < kGemmTile * kFmaDepth / kThreads; ++q) {
      const int e = tid + q * kThreads;
      const int2 a = tile_index(e, kGemmTile, kFmaDepth, g.a_ci == 1);  // (i, k)
      As[a.y][a.x] = load_or_zero(A, m0 + a.x, k0 + a.y, g.M, g.K, g.a_ri, g.a_ci);
      const int2 b = tile_index(e, kFmaDepth, kGemmTile, g.b_ci == 1);  // (k, j)
      Bs[b.x][b.y] = load_or_zero(B, n0 + b.y, k0 + b.x, g.N, g.K, g.b_ci, g.b_ri);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kFmaDepth; ++k) {
      float a[8], b[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = As[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = Bs[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = __fmaf_rn(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* C = g.c + blockIdx.z * g.c_bs;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = m0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = n0 + tx + 16 * j;
      if (r < g.M && c < g.N) C[(long long)r * g.ldc + c] = acc[i][j];
    }
  }
}

__device__ __forceinline__ uint32_t pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// d += a b for one m16n8k16 tile: bf16 inputs, float32 accumulator.
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// "DEFAULT": A and B rounded to bf16 on their way into shared memory (As
// row-major by i, Bs by j, k contiguous in both), float32 sums by mma.sync.
// Warp w computes rows (w / 4) 64 .. + 63 and columns (w % 4) 32 .. + 31.
__global__ void __launch_bounds__(kThreads) probe_gemm_bf16_kernel(Gemm g) {
  __shared__ __align__(16) __nv_bfloat16 As[kGemmTile][kMmaDepth + kMmaPad];
  __shared__ __align__(16) __nv_bfloat16 Bs[kGemmTile][kMmaDepth + kMmaPad];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int m0 = blockIdx.y * kGemmTile, n0 = blockIdx.x * kGemmTile;
  const float* A = g.a + blockIdx.z * g.a_bs;
  const float* B = g.b + blockIdx.z * g.b_bs;
  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;
  for (int k0 = 0; k0 < g.K; k0 += kMmaDepth) {
#pragma unroll 4
    for (int q = 0; q < kGemmTile * kMmaDepth / kThreads; ++q) {
      const int e = tid + q * kThreads;
      const int2 a = tile_index(e, kGemmTile, kMmaDepth, g.a_ci == 1);  // (i, k)
      As[a.x][a.y] = __float2bfloat16_rn(
          load_or_zero(A, m0 + a.x, k0 + a.y, g.M, g.K, g.a_ri, g.a_ci));
      const int2 b = tile_index(e, kMmaDepth, kGemmTile, g.b_ci == 1);  // (k, j)
      Bs[b.y][b.x] = __float2bfloat16_rn(
          load_or_zero(B, n0 + b.y, k0 + b.x, g.N, g.K, g.b_ci, g.b_ri));
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kMmaDepth; ks += 16) {
      uint32_t af[4][4], bf[4][2];
      const int kc = ks + 2 * tig;
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int r = wm + mi * 16 + gid;
        af[mi][0] = pair(&As[r][kc]);
        af[mi][1] = pair(&As[r + 8][kc]);
        af[mi][2] = pair(&As[r][kc + 8]);
        af[mi][3] = pair(&As[r + 8][kc + 8]);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int c = wn + ni * 8 + gid;
        bf[ni][0] = pair(&Bs[c][kc]);
        bf[ni][1] = pair(&Bs[c][kc + 8]);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], af[mi], bf[ni]);
    }
    __syncthreads();
  }
  float* C = g.c + blockIdx.z * g.c_bs;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + wm + mi * 16 + gid + 8 * h;
        const int c = n0 + wn + ni * 8 + 2 * tig;
        if (r >= g.M) continue;
        if (c < g.N) C[(long long)r * g.ldc + c] = acc[mi][ni][2 * h];
        if (c + 1 < g.N) C[(long long)r * g.ldc + c + 1] = acc[mi][ni][2 * h + 1];
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
  const long long block4 = (long long)zb * P4;
  const long long want = (block4 + kThreads - 1) / kThreads;
  const long long cap = std::max(1, 8 * device_sms() / nblk);
  const dim3 grid((unsigned)std::min(want, cap), nblk);
  probe_scale_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float4*)x, (float4*)out, s, s_dev, block4, (long long)Z * P4);
  counts[kScale] += 1;
  return (int)cudaGetLastError();
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
  counts[kWindow] += 1;
  return (int)cudaGetLastError();
}

// out[z] of every (Y, X) plane x[z]: side 0 (x) x[z] m, or x[z] m^T with
// trans, m (X, X); side 1 (y) m^T x[z], or m x[z] with trans, m (Y, Y).
// precision 0 "HIGHEST" (float32 sums), 1 "DEFAULT" (bf16 inputs, float32
// sums).
int nsol_probe_block_matmul(const float* x, const float* m, float* out, int Z, int Y, int X,
                            int side, int trans, int precision, void* stream, long long* counts) {
  if (Z < 1 || Y < 1 || X < 1 || (side != 0 && side != 1) || (precision != 0 && precision != 1))
    return (int)cudaErrorInvalidValue;
  const long long plane = (long long)Y * X;
  Gemm g;
  g.c = out;
  g.M = Y;
  g.N = X;
  g.c_bs = plane;
  g.ldc = X;
  if (side == 0) {  // A = x[z] (Y, X), B = m or m^T (X, X)
    g.a = x, g.a_bs = plane, g.a_ri = X, g.a_ci = 1;
    g.b = m, g.b_bs = 0, g.b_ri = trans ? 1 : X, g.b_ci = trans ? X : 1;
    g.K = X;
  } else {  // A = m^T or m (Y, Y), B = x[z] (Y, X)
    g.a = m, g.a_bs = 0, g.a_ri = trans ? Y : 1, g.a_ci = trans ? 1 : Y;
    g.b = x, g.b_bs = plane, g.b_ri = X, g.b_ci = 1;
    g.K = Y;
  }
  const dim3 grid((X + kGemmTile - 1) / kGemmTile, (Y + kGemmTile - 1) / kGemmTile, Z);
  if (precision == 0) {
    probe_gemm_f32_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(g);
    counts[kMatmulHighest] += 1;
  } else {
    probe_gemm_bf16_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(g);
    counts[kMatmulDefault] += 1;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
