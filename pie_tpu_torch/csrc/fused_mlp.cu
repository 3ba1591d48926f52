// K4: the decode MLP block of a decoder layer in one launch, for M <= 8 rows
// and group-wise affine INT4/INT8 weights stacked over layers.
//
// Replaces the TPU kernel pie_tpu/ops/fused_mlp_pallas.py fused_mlp_stacked
// (_mlp_kernel). Computes, with the reference's rounding points:
//   h2  = h_in + bf16(attn @ wo)                     (the add in bf16)
//   xg  = bf16(f32(h2) * rsqrt(sum f32(h2)^2 / d + eps) * f32(ln2_w))
//   gu  = bf16(xg @ wgu);  g = gu[:, :di], u = gu[:, di:]
//   act = bf16(f32(g) * sigmoid(f32(g)) * f32(u))
//   out = h2 + bf16(act @ wd)
// each dot in f32 with the group-affine math of K1 (quant_tile.cuh).
//
// Bound on the H100: bytes. At M <= 8 each packed word feeds at most 64
// multiply-adds, far below the ~295 operations per byte where the tensor
// cores would be the limit, so the least time is one layer's packed words
// plus scales and biases of wo, wgu and wd over 3.35 TB/s (Llama-3.2-1B,
// INT4 g64: 30.67 MB, 9.2 us).
//
// Design: every output of a phase needs the whole previous phase (the norm
// needs all of h2, wgu all of xg, wd all of act), and a GPU grid carries
// nothing between blocks without a barrier. So one cooperative launch
// (cudaLaunchCooperativeKernel: every block resident, or the launch fails)
// walks three weight-streaming split-K GEMV phases with grid-wide barriers
// between them. A phase's tasks are (32-column range, K range) pairs taken
// grid-stride, each streaming its weights once through K1's tile loop
// (quant_tile.cuh) and writing f32 partial sums to a workspace; after the
// barrier the grid reduces the partials elementwise and applies the
// rounding above. h2 and act live in the workspace too (under 0.5 MB at
// M = 8, held in L2). Every block recomputes the norm statistic from h2,
// which saves a barrier.
//
// Five grid barriers per call: after the wo partials, after h2, after the
// wgu partials, after act, after the wd partials. Each is one atomic
// arrival per block on one counter and a spin on a generation word, about
// a microsecond or two each at a few hundred blocks: together they are of
// the order of the byte bound itself, the first thing to cut when this
// kernel is made fast. The counters are zero on the first call and left so
// by every call (the generation only grows), so no memset runs per call.
//
// Reads of data that other blocks wrote during this launch go through L2
// (__ldcg), never through the non-coherent L1 / read-only path.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "quant_tile.cuh"

namespace {

using pie::kSums;
using pie::kThreads;
using pie::kTileK;
using pie::kWarps;

// at most this many resident blocks per SM take part (the rest of the
// occupancy would only lengthen each barrier)
constexpr int kBlocksPerSm = 4;

struct QW {
  const uint32_t* packed;  // [K / ep, N] this layer's words
  const void* scales;      // [K / g, N], bf16 (or f32 when Args::f32s)
  const void* biases;      // [K / g, N], as scales
};

struct Args {
  const __nv_bfloat16* attn;  // [M, d_attn]
  const __nv_bfloat16* h_in;  // [M, d]
  const __nv_bfloat16* lnw;   // [d] this layer's ln2 row
  QW wo, wgu, wd;
  __nv_bfloat16* out;         // [M, d]
  float* part_o;              // [s_o, M, d] split-K partial sums
  float* part_g;              // [s_g, M, 2 di]
  float* part_d;              // [s_d, M, d]
  __nv_bfloat16* h2;          // [M, d]
  __nv_bfloat16* act;         // [M, di]
  unsigned int* bar;          // [2]: arrivals, generation
  int M, d_attn, d, di, g;
  int s_o, s_g, s_d;          // K splits of the three phases
  float eps;
  bool f32s;                  // f32 scales and biases
};

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float ld_bf16_l2(const __nv_bfloat16* p) {
  return __bfloat162float(
      __ushort_as_bfloat16(__ldcg(reinterpret_cast<const unsigned short*>(p))));
}

// All blocks of the (cooperatively launched, so resident) grid meet here;
// writes before it are visible to every block after it.
__device__ __forceinline__ void grid_barrier(unsigned int* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned int* gen = bar + 1;
    const unsigned int mine = *gen;
    __threadfence();
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      atomicExch(bar, 0u);  // arrivals back to zero for the next barrier
      __threadfence();
      atomicAdd(bar + 1, 1u);  // release
    } else {
      while (*gen == mine) __nanosleep(32);
    }
    __threadfence();
  }
  __syncthreads();
}

// Partial sums part[split, m, n] of x @ W over the K range of each split;
// load8 stages x (see pie::stage_x).
template <int BITS, int MT, class Load8>
__device__ void gemv_phase(const QW& w, bool f32s, int K, int N, int splits, int g,
                           float* part, int M, float* smem, Load8 load8) {
  float* xs = smem;                 // [MT][kTileK]
  float* xsum = xs + MT * kTileK;   // [MT][kSums]
  float* red = xs;                  // [kWarps][MT][32], reused
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nblk = N / 32, tiles = K / kTileK;
  const int per = (tiles + splits - 1) / splits;
  for (int task = blockIdx.x; task < nblk * splits; task += gridDim.x) {
    const int cb = task % nblk, sp = task / nblk;
    const int col = cb * 32 + lane;
    const int t0 = sp * per, t1 = min(tiles, t0 + per);
    float acc[MT];
#pragma unroll
    for (int m = 0; m < MT; ++m) acc[m] = 0.f;
    pie::WarpTile<BITS> cur, nxt;
    pie::load_warp_tile(cur, w.packed, w.scales, w.biases, f32s, N, col, true, t0, warp,
                        g);
    for (int t = t0; t < t1; ++t) {
      __syncthreads();  // the previous tile's (or task's) x reads are done
      pie::stage_x<MT>(xs, xsum, t, M, load8);
      __syncthreads();
      if (t + 1 < t1)
        pie::load_warp_tile(nxt, w.packed, w.scales, w.biases, f32s, N, col, true, t + 1,
                            warp, g);
      pie::accum_warp_tile<BITS, MT>(cur, xs, xsum, warp, g, acc);
      if (t + 1 < t1) cur = nxt;
    }
    __syncthreads();
#pragma unroll
    for (int m = 0; m < MT; ++m) red[(warp * MT + m) * 32 + lane] = acc[m];
    __syncthreads();
    for (int m = warp; m < M; m += kWarps) {
      float v = 0.f;
#pragma unroll
      for (int i = 0; i < kWarps; ++i) v += red[(i * MT + m) * 32 + lane];
      part[((size_t)sp * M + m) * N + col] = v;
    }
  }
}

__device__ __forceinline__ void bf16x8(const uint4& raw, float* v) {
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = __bfloat162float(h[i]);
}

template <int BITS, int MT>
__global__ void __launch_bounds__(kThreads) fused_mlp_kernel(Args a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  __shared__ float inv[MT];
  const int M = a.M, d = a.d, di = a.di;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gtid = blockIdx.x * kThreads + threadIdx.x;
  const int gstride = gridDim.x * kThreads;

  // phase 1: partial sums of attn @ wo
  gemv_phase<BITS, MT>(a.wo, a.f32s, a.d_attn, d, a.s_o, a.g, a.part_o, M, smem,
                       [&](int m, int k0, float* v) {
    bf16x8(__ldg(reinterpret_cast<const uint4*>(a.attn + (size_t)m * a.d_attn + k0)), v);
  });
  grid_barrier(a.bar);

  // h2 = h_in + bf16(attn @ wo)
  for (int i = gtid; i < M * d; i += gstride) {
    float s = 0.f;
    for (int sp = 0; sp < a.s_o; ++sp) s += __ldcg(a.part_o + (size_t)sp * M * d + i);
    a.h2[i] = __float2bfloat16_rn(__bfloat162float(a.h_in[i]) + bf16r(s));
  }
  grid_barrier(a.bar);

  // the rms statistic of every row of h2, in every block
  for (int m = warp; m < M; m += kWarps) {
    const uint4* row = reinterpret_cast<const uint4*>(a.h2 + (size_t)m * d);
    float ss = 0.f;
    for (int c = lane; c < d / 8; c += 32) {
      float v[8];
      bf16x8(__ldcg(row + c), v);
#pragma unroll
      for (int i = 0; i < 8; ++i) ss += v[i] * v[i];
    }
    ss = pie::warp_sum(ss);
    if (lane == 0) inv[m] = rsqrtf(ss / (float)d + a.eps);
  }
  __syncthreads();

  // phase 2: partial sums of xg @ wgu, xg = bf16(h2 * inv * ln2_w) staged
  gemv_phase<BITS, MT>(a.wgu, a.f32s, d, 2 * di, a.s_g, a.g, a.part_g, M, smem,
                       [&](int m, int k0, float* v) {
    float w[8];
    bf16x8(__ldcg(reinterpret_cast<const uint4*>(a.h2 + (size_t)m * d + k0)), v);
    bf16x8(__ldg(reinterpret_cast<const uint4*>(a.lnw + k0)), w);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = bf16r(v[i] * inv[m] * w[i]);
  });
  grid_barrier(a.bar);

  // act = bf16(silu(g) * u) with g, u rounded to bf16
  for (int i = gtid; i < M * di; i += gstride) {
    const int m = i / di, j = i - m * di;
    float sg = 0.f, su = 0.f;
    for (int sp = 0; sp < a.s_g; ++sp) {
      const float* row = a.part_g + ((size_t)sp * M + m) * 2 * di;
      sg += __ldcg(row + j);
      su += __ldcg(row + di + j);
    }
    const float gf = bf16r(sg), uf = bf16r(su);
    const float sig = 1.f / (1.f + expf(-gf));
    a.act[i] = __float2bfloat16_rn(gf * sig * uf);
  }
  grid_barrier(a.bar);

  // phase 3: partial sums of act @ wd
  gemv_phase<BITS, MT>(a.wd, a.f32s, di, d, a.s_d, a.g, a.part_d, M, smem,
                       [&](int m, int k0, float* v) {
    bf16x8(__ldcg(reinterpret_cast<const uint4*>(a.act + (size_t)m * di + k0)), v);
  });
  grid_barrier(a.bar);

  // out = h2 + bf16(act @ wd)
  for (int i = gtid; i < M * d; i += gstride) {
    float s = 0.f;
    for (int sp = 0; sp < a.s_d; ++sp) s += __ldcg(a.part_d + (size_t)sp * M * d + i);
    a.out[i] = __float2bfloat16_rn(ld_bf16_l2(a.h2 + i) + bf16r(s));
  }
}

// K splits of a phase with nblk column ranges and `tiles` 512-row tiles on
// `grid` blocks: the fewest tiles for the busiest block, then the fewest
// splits. Every split is non-empty.
int pick_splits(int nblk, int tiles, int grid) {
  int best = 1;
  long best_cost = -1;
  for (int s = 1; s <= tiles; ++s) {
    const int per = (tiles + s - 1) / s;
    const int real = (tiles + per - 1) / per;
    const long rounds = ((long)nblk * real + grid - 1) / grid;
    const long cost = rounds * per;
    if (best_cost < 0 || cost < best_cost) {
      best_cost = cost;
      best = real;
    }
  }
  return best;
}

template <int BITS, int MT>
cudaError_t launch(Args a, cudaStream_t stream) {
  auto kern = fused_mlp_kernel<BITS, MT>;
  const size_t smem = sizeof(float) * (MT * kTileK + MT * kSums);
  static int grid = 0;  // resident blocks: occupancy x SMs, found once
  if (grid == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, smem);
    if (e != cudaSuccess) return e;
    if (per_sm < 1) return cudaErrorLaunchOutOfResources;
    grid = (per_sm < kBlocksPerSm ? per_sm : kBlocksPerSm) * sms;
  }
  a.s_o = pick_splits(a.d / 32, a.d_attn / kTileK, grid);
  a.s_g = pick_splits(2 * a.di / 32, a.d / kTileK, grid);
  a.s_d = pick_splits(a.d / 32, a.di / kTileK, grid);
  void* params[] = {&a};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(kern), dim3(grid), dim3(kThreads), params, smem, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <int BITS>
cudaError_t dispatch_rows(const Args& a, cudaStream_t st) {
  if (a.M <= 1) return launch<BITS, 1>(a, st);
  if (a.M <= 2) return launch<BITS, 2>(a, st);
  if (a.M <= 4) return launch<BITS, 4>(a, st);
  return launch<BITS, 8>(a, st);
}

}  // namespace

// out[M, d] = the decode MLP block above, for one layer whose weights and
// ln2 row the pointers already point at. ws: workspace of at least
// 4 * M * (d_attn/512 * d + d/512 * 2*di + di/512 * d) + 2 * M * (d + di)
// bytes (ws_bytes); bar: two zeroed words kept between calls. Scales and
// biases are bf16, or f32 when scale_f32 != 0. Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for arguments
// the kernel does not take).
extern "C" int pie_fused_mlp(const void* attn, const void* h_in, const void* lnw,
                             const void* wo_p, const void* wo_s, const void* wo_b,
                             const void* wgu_p, const void* wgu_s, const void* wgu_b,
                             const void* wd_p, const void* wd_s, const void* wd_b,
                             void* out, void* ws, void* bar, int M, int d_attn, int d,
                             int di, int bits, int group_size, int scale_f32,
                             float eps, long long ws_bytes, void* stream) {
  if (M < 1 || M > 8 || d_attn < kTileK || d < kTileK || di < kTileK ||
      d_attn % kTileK || d % kTileK || di % kTileK ||
      (group_size != 32 && group_size != 64 && group_size != 128) ||
      (bits != 4 && bits != 8))
    return (int)cudaErrorInvalidValue;
  const size_t po = (size_t)(d_attn / kTileK) * M * d;
  const size_t pg = (size_t)(d / kTileK) * M * 2 * di;
  const size_t pd = (size_t)(di / kTileK) * M * d;
  const size_t need = 4 * (po + pg + pd) + 2 * (size_t)M * (d + di);
  if (ws == nullptr || bar == nullptr || ws_bytes < (long long)need)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.attn = static_cast<const __nv_bfloat16*>(attn);
  a.h_in = static_cast<const __nv_bfloat16*>(h_in);
  a.lnw = static_cast<const __nv_bfloat16*>(lnw);
  a.wo = {static_cast<const uint32_t*>(wo_p), wo_s, wo_b};
  a.wgu = {static_cast<const uint32_t*>(wgu_p), wgu_s, wgu_b};
  a.wd = {static_cast<const uint32_t*>(wd_p), wd_s, wd_b};
  a.out = static_cast<__nv_bfloat16*>(out);
  float* f = static_cast<float*>(ws);
  a.part_o = f;
  a.part_g = f + po;
  a.part_d = f + po + pg;
  a.h2 = reinterpret_cast<__nv_bfloat16*>(f + po + pg + pd);
  a.act = a.h2 + (size_t)M * d;
  a.bar = static_cast<unsigned int*>(bar);
  a.M = M;
  a.d_attn = d_attn;
  a.d = d;
  a.di = di;
  a.g = group_size;
  a.eps = eps;
  a.f32s = scale_f32 != 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bits == 4) return (int)dispatch_rows<4>(a, st);
  return (int)dispatch_rows<8>(a, st);
}
