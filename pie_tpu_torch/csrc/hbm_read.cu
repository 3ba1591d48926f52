// B7: the device-memory read probe. Streams a contiguous 4-byte array
// x[R, n] (R a multiple of 8, n of 4) once and folds it into
//   out[r, c] = sum_i f32_bits(x[8i + r, c])            (out [8, n] f32)
// so that every byte of x is read exactly once and feeds the result.
//
// Replaces the TPU kernel benchmarks/hbm_peak.py stream_read
// (_stream_kernel). There the BlockSpec DMA moves each whole block of
// `rows` rows into VMEM whatever the body touches, and the body adds the
// block's first 8 rows into an [8, n] accumulator; its traffic is the
// whole array. On a GPU nothing moves a byte the kernel does not load, so
// the port computes the function at rows = 8, where every row counts.
//
// Bound on the H100: bytes. One f32 add per 4 bytes read is ~0.25
// operations a byte, far below the ~20 f32 operations a byte where the
// CUDA cores would be the limit: the least time is R * n * 4 bytes over
// 3.35 TB/s (a 4 GiB buffer: 1.282 ms). The probe is there to measure how
// much of that rate a plain read reaches.
//
// Little's law sizes both paths: ~3.35 TB/s x ~0.6-0.8 us of DRAM latency
// is ~2-2.7 MB in flight over 132 SMs, ~16-20 KB an SM.
//
// The array as [S = R / 8 slabs, C4 = 2n float4 columns]: out is the sum
// of the slabs, column by column. Both paths cut the columns into tiles
// (blockIdx.x) and deal the slabs over slab groups (blockIdx.y); a block
// writes its tile's f32 partial [C4] of its slab group, and a second small
// launch (hbm_read_sum) adds the groups' partials in group order. No float
// atomics: a call's result does not depend on the order blocks ran in.
//
// (a) Register loads (hbm_read_ldg). 8 warps a block; a warp reads one
//     slab's 128 float4 columns of the tile (4 x 512 contiguous bytes,
//     16-byte vector loads through the non-coherent path that allocates no
//     L1 line: ld.global.nc.L1::no_allocate.v4), U slabs at once, so each
//     thread keeps 4 U loads in flight before it adds any; the warps of a
//     block take different slabs (a grid-stride over 8-row slabs), each
//     accumulates in registers, and the block sums its 8 warps' columns in
//     shared memory in warp order. In flight: 256 threads x 4 U x 16 bytes
//     a block (U = 2: 32 KB).
// (b) TMA bulk copies (hbm_read_tma). A producer thread keeps a ring of
//     `stages` chunks in flight: each chunk is one slab's tile of 16 or 32
//     KB (CHUNK float4), one 1-D cp.async.bulk global -> shared copy that
//     completes on its stage's mbarrier (complete_tx; no tensor map). 256
//     consumer threads fold each chunk into registers (CHUNK / 256 float4
//     each) and free the stage. This is what the TPU kernel measures, a DMA
//     into on-chip memory, and how K1, K2 and K4 stream their weights. In
//     flight: up to `stages` chunks a block (4 x 16 KB: 64 KB).

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using pie::mbar_arrive;
using pie::mbar_expect_tx;
using pie::mbar_init;
using pie::mbar_wait;
using pie::smem_u32;

constexpr int kLdgWarps = 8;
constexpr int kLdgV = 4;                  // float4 columns a lane reads per slab
constexpr int kLdgTile = 32 * kLdgV;      // float4 columns of a block's tile
constexpr int kTmaConsumers = 256;        // consumer threads; one producer warp more
constexpr int kTmaMaxStages = 8;
constexpr int kSumThreads = 256;

__device__ __forceinline__ float4 ld_stream(const float4* p) {
  float4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "l"(p));
  return v;
}

__device__ __forceinline__ void add4(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

template <int U>
__global__ void __launch_bounds__(kLdgWarps * 32)
    hbm_read_ldg(const float4* __restrict__ x, float4* __restrict__ part, long long slabs,
                 int c4, int groups) {
  __shared__ float4 red[kLdgWarps][kLdgTile];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c0 = blockIdx.x * kLdgTile + lane;
  bool ok[kLdgV];
#pragma unroll
  for (int v = 0; v < kLdgV; ++v) ok[v] = c0 + 32 * v < c4;
  float4 acc[kLdgV];
#pragma unroll
  for (int v = 0; v < kLdgV; ++v) acc[v] = make_float4(0.f, 0.f, 0.f, 0.f);

  const long long step = (long long)groups * kLdgWarps;  // slabs between a warp's slabs
  long long s = (long long)blockIdx.y * kLdgWarps + warp;
  for (; s + (U - 1) * step < slabs; s += U * step) {
    float4 buf[U][kLdgV];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float4* row = x + (s + u * step) * c4 + c0;
#pragma unroll
      for (int v = 0; v < kLdgV; ++v)
        buf[u][v] = ok[v] ? ld_stream(row + 32 * v) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int v = 0; v < kLdgV; ++v) add4(acc[v], buf[u][v]);
  }
  for (; s < slabs; s += step) {
    const float4* row = x + s * c4 + c0;
#pragma unroll
    for (int v = 0; v < kLdgV; ++v)
      if (ok[v]) add4(acc[v], ld_stream(row + 32 * v));
  }

#pragma unroll
  for (int v = 0; v < kLdgV; ++v) red[warp][lane + 32 * v] = acc[v];
  __syncthreads();
  if (threadIdx.x < kLdgTile) {
    float4 t = red[0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < kLdgWarps; ++w) add4(t, red[w][threadIdx.x]);
    const int c = blockIdx.x * kLdgTile + threadIdx.x;
    if (c < c4) part[(long long)blockIdx.y * c4 + c] = t;
  }
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// CHUNK float4 columns a chunk (one slab's tile); block: 256 consumers + 1 producer warp
template <int CHUNK>
__global__ void __launch_bounds__(kTmaConsumers + 32)
    hbm_read_tma(const float4* __restrict__ x, float4* __restrict__ part, long long slabs,
                 int c4, int groups, int stages) {
  constexpr int kPer = CHUNK / kTmaConsumers;
  extern __shared__ __align__(128) unsigned char smem[];
  const float4* ring = reinterpret_cast<const float4*>(smem);
  const uint32_t ring0 = smem_u32(smem);
  const uint32_t full0 = ring0 + stages * CHUNK * 16, empty0 = full0 + 8 * kTmaMaxStages;
  const int col0 = blockIdx.x * CHUNK;
  const int width = min(CHUNK, c4 - col0);  // float4 columns of this tile
  const long long gs = blockIdx.y;
  const long long chunks = gs < slabs ? (slabs - 1 - gs) / groups + 1 : 0;

  if (threadIdx.x == 0) {
    for (int st = 0; st < stages; ++st) {
      mbar_init(full0 + 8 * st, 1);
      mbar_init(empty0 + 8 * st, kTmaConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kTmaConsumers) {  // the producer warp: one thread issues every copy
    if (threadIdx.x == kTmaConsumers) {
      const uint32_t bytes = (uint32_t)width * 16;
      for (long long k = 0; k < chunks; ++k) {
        const int st = (int)(k % stages);
        const long long round = k / stages;
        if (round > 0) mbar_wait(empty0 + 8 * st, (uint32_t)((round - 1) & 1));
        mbar_expect_tx(full0 + 8 * st, bytes);
        bulk_load(ring0 + st * CHUNK * 16, x + (gs + k * groups) * c4 + col0, bytes,
                  full0 + 8 * st);
      }
    }
    return;
  }

  float4 acc[kPer];
#pragma unroll
  for (int p = 0; p < kPer; ++p) acc[p] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (long long k = 0; k < chunks; ++k) {
    const int st = (int)(k % stages);
    mbar_wait(full0 + 8 * st, (uint32_t)((k / stages) & 1));
    const float4* chunk = ring + st * CHUNK;
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      const int c = threadIdx.x + kTmaConsumers * p;
      if (c < width) add4(acc[p], chunk[c]);
    }
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(empty0 + 8 * st);
  }
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    const int c = threadIdx.x + kTmaConsumers * p;
    if (c < width) part[gs * c4 + col0 + c] = acc[p];
  }
}

// out[c] = sum over groups, in group order, of part[g][c]
__global__ void hbm_read_sum(const float4* __restrict__ part, float4* __restrict__ out, int c4,
                             int groups) {
  const int c = blockIdx.x * kSumThreads + threadIdx.x;
  if (c >= c4) return;
  float4 t = part[c];
  for (int g = 1; g < groups; ++g) add4(t, part[(long long)g * c4 + c]);
  out[c] = t;
}

size_t tma_smem(int chunk, int stages) {
  return (size_t)stages * chunk * 16 + 2 * 8 * kTmaMaxStages;
}

template <int U>
cudaError_t launch_ldg(const float4* x, float4* part, long long slabs, int c4, int groups,
                       cudaStream_t st) {
  const dim3 grid((c4 + kLdgTile - 1) / kLdgTile, groups);
  hbm_read_ldg<U><<<grid, kLdgWarps * 32, 0, st>>>(x, part, slabs, c4, groups);
  return cudaGetLastError();
}

template <int CHUNK>
cudaError_t launch_tma(const float4* x, float4* part, long long slabs, int c4, int groups,
                       int stages, cudaStream_t st) {
  const size_t smem = tma_smem(CHUNK, stages);
  const cudaError_t e =
      cudaFuncSetAttribute(hbm_read_tma<CHUNK>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((c4 + CHUNK - 1) / CHUNK, groups);
  hbm_read_tma<CHUNK><<<grid, kTmaConsumers + 32, smem, st>>>(x, part, slabs, c4, groups, stages);
  return cudaGetLastError();
}

template <int CHUNK>
cudaError_t tma_blocks_per_sm(int stages, int* out) {
  const size_t smem = tma_smem(CHUNK, stages);
  const cudaError_t e =
      cudaFuncSetAttribute(hbm_read_tma<CHUNK>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, hbm_read_tma<CHUNK>, kTmaConsumers + 32,
                                                       smem);
}

}  // namespace

// x [rows, n] 4-byte elements; part [groups, 2n] float4; out [8, n] f32.
// path 0: register loads with `unroll` slabs a warp (1, 2, 4 or 8) over a
// grid of [ceil(2n / 128), groups]; path 1: TMA bulk copies of `chunk_kb`
// KB chunks (16 or 32) through a ring of `stages` (2-8) over a grid of
// [ceil(2n / chunk), groups]. Returns cudaGetLastError() after the second
// launch.
extern "C" int pie_hbm_read(const void* x, void* part, void* out, long long rows, int n, int path,
                            int unroll, int chunk_kb, int stages, int groups, void* stream) {
  if (rows < 8 || rows % 8 != 0 || n < 4 || n % 4 != 0 || n > (1 << 28) || groups < 1 ||
      (path == 1 && (stages < 2 || stages > kTmaMaxStages)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long slabs = rows / 8;
  const int c4 = 2 * n;
  const float4* xs = static_cast<const float4*>(x);
  float4* ps = static_cast<float4*>(part);
  cudaError_t e = cudaErrorInvalidValue;
  if (path == 0 && unroll == 1) e = launch_ldg<1>(xs, ps, slabs, c4, groups, st);
  if (path == 0 && unroll == 2) e = launch_ldg<2>(xs, ps, slabs, c4, groups, st);
  if (path == 0 && unroll == 4) e = launch_ldg<4>(xs, ps, slabs, c4, groups, st);
  if (path == 0 && unroll == 8) e = launch_ldg<8>(xs, ps, slabs, c4, groups, st);
  if (path == 1 && chunk_kb == 16) e = launch_tma<1024>(xs, ps, slabs, c4, groups, stages, st);
  if (path == 1 && chunk_kb == 32) e = launch_tma<2048>(xs, ps, slabs, c4, groups, stages, st);
  if (e != cudaSuccess) return (int)e;
  hbm_read_sum<<<(c4 + kSumThreads - 1) / kSumThreads, kSumThreads, 0, st>>>(
      ps, static_cast<float4*>(out), c4, groups);
  return (int)cudaGetLastError();
}

// Blocks of one path's kernel resident per SM, into *out.
extern "C" int pie_hbm_read_blocks_per_sm(int path, int unroll, int chunk_kb, int stages,
                                          int* out) {
  const int threads = kLdgWarps * 32;
  if (path == 0 && unroll == 1)
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, hbm_read_ldg<1>, threads, 0);
  if (path == 0 && unroll == 2)
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, hbm_read_ldg<2>, threads, 0);
  if (path == 0 && unroll == 4)
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, hbm_read_ldg<4>, threads, 0);
  if (path == 0 && unroll == 8)
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, hbm_read_ldg<8>, threads, 0);
  if (path != 1 || stages < 2 || stages > kTmaMaxStages) return (int)cudaErrorInvalidValue;
  if (chunk_kb == 16) return (int)tma_blocks_per_sm<1024>(stages, out);
  if (chunk_kb == 32) return (int)tma_blocks_per_sm<2048>(stages, out);
  return (int)cudaErrorInvalidValue;
}
