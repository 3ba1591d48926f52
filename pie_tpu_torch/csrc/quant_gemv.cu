// K1: decode GEMV with group-wise affine INT4/INT8 weights, for M <= 32 rows.
//
// Replaces the decode branch of the TPU kernel in
// pie_tpu/ops/quant_matmul_pallas.py (quant_matmul_stacked and
// quant_matmul_pallas -> _kernel -> _accum_block with post_scale, the
// rms-norm prologue of _kernel and _rope_epilogue).
//
// Computes, for every output column n and row m,
//   y[m, n] = sum_g ( s[g,n] * sum_{k in g} xh[m,k] q[k,n] + b[g,n] * sum_{k in g} xh[m,k] )
// in f32, where xh = x, or with the prologue xh = bf16(x * rsqrt(mean(x^2) + eps) * ln_w)
// over the logical K; the optional epilogue rotates dh-sized head groups,
// y*cos + roll_half(y)*sin, with the cos/sin rows of rope_qkv_cs.
//
// Bound on the H100: bytes. At M = 1 each packed weight word is used for
// 8 (INT4) or 4 (INT8) multiply-adds per row, far below the ~295 operations
// per byte where the tensor cores would be the limit, so the least time is
// the packed words plus scales and biases over 3.35 TB/s.
//
// Design against that bound:
// - Storage is natural K-major words ([Kp/ep, N], LSB first): the 32 lanes of
//   a warp read 32 columns of one word row, 128 contiguous bytes.
// - A block owns 32 columns and a range of K. Its 8 warps split each
//   512-row tile of K (64 rows each: split-K inside the block), so a block
//   keeps 8 warps x 8..16 word loads in flight, and the next tile's words
//   are loaded into registers while the current tile is multiplied. The
//   warps' partial sums are reduced through shared memory.
// - Where N gives too few 32-column blocks to fill the card (wo, wd, wqkv
//   at the 8B widths), K is also split across blocks (gridDim.y): each
//   block writes its partial sums to an f32 workspace, and the last block
//   of a column range to arrive (an atomic counter, reset by that block)
//   adds them up and runs the epilogue.
// - The rows of x for the current tile (normalized when the prologue is on)
//   are staged once per block in shared memory as f32 together with their
//   32-row sums, so every lane reads x by broadcast and the bias term costs
//   one multiply-add per group.
// - A code becomes the exact float 1 + q/2^bits with one shift and one
//   logic op (it lands in the top mantissa bits of 1.0): no int-to-float
//   conversion. sum x*(1 + q/2^bits) - sum x = sum x*q / 2^bits, so the group
//   scale applies as 2^bits*s to that difference. The tile loads, the x
//   staging and this accumulation live in quant_tile.cuh, shared with K4.
// - For the rope epilogue a block's 32 columns are 16 columns of a head's
//   first half and the 16 partner columns dh/2 further on: the rotation
//   partner of lane l is lane l^16 of the same block, so the epilogue needs
//   no other block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "quant_tile.cuh"

namespace {

using pie::kSums;
using pie::kThreads;
using pie::kTileK;
using pie::kWarps;
using pie::warp_sum;

// Output column of lane `lane` in column block `blk`.
__device__ __forceinline__ int column_of(int blk, int lane, int rope_dim) {
  if (rope_dim == 0) return blk * 32 + lane;
  const int per_head = rope_dim / 32;
  const int head = blk / per_head, p = blk % per_head;
  return head * rope_dim + p * 16 + (lane & 15) + (lane >> 4) * (rope_dim / 2);
}

template <int BITS, int MT>
__global__ void __launch_bounds__(kThreads) gemv_kernel(
    const __nv_bfloat16* __restrict__ x,       // [M, Kp]
    const uint32_t* __restrict__ packed,       // [Kp / ep, N]
    const void* __restrict__ scales,           // [Kp / g, N] bf16 or f32
    const void* __restrict__ biases,           // [Kp / g, N] as scales
    const __nv_bfloat16* __restrict__ lnw,     // [K] or null
    const float* __restrict__ cosv,            // [M, N] or null
    const float* __restrict__ sinv,            // [M, N] or null
    __nv_bfloat16* __restrict__ y,             // [M, N]
    float* __restrict__ ws,                    // [gridDim.y, M, N] when split
    int* __restrict__ counters,                // [gridDim.x], zero between calls
    int M, int K, int Kp, int N, int g, int rope_dim, float eps,
    int tiles_per_split, bool f32s) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);   // [MT][kTileK]
  float* xsum = xs + MT * kTileK;                // [MT][kSums]
  float* inv = xsum + MT * kSums;                // [MT]
  float* red = xs;                               // [kWarps][MT][32], reused

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int col = column_of(blockIdx.x, lane, rope_dim);
  const bool col_ok = col < N;
  const int m_cnt = min(MT, M);

  const int t_begin = blockIdx.y * tiles_per_split;
  const int t_end = min(Kp / kTileK, t_begin + tiles_per_split);

  pie::WarpTile<BITS> cur, nxt;
  // in flight during the prologue
  pie::load_warp_tile(cur, packed, scales, biases, f32s, N, col, col_ok, t_begin, warp,
                      g);

  if (lnw != nullptr) {  // prologue: per-row rms statistic over logical K
    for (int m = 0; m < m_cnt; ++m) {
      const __nv_bfloat16* xr = x + (size_t)m * Kp;
      float ss = 0.f;
      for (int c = threadIdx.x; c < K / 8; c += kThreads) {
        const uint4 raw = *reinterpret_cast<const uint4*>(xr + c * 8);
        const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float v = __bfloat162float(h[i]);
          ss += v * v;
        }
      }
      for (int k = K / 8 * 8 + threadIdx.x; k < K; k += kThreads) {
        const float v = __bfloat162float(xr[k]);
        ss += v * v;
      }
      ss = warp_sum(ss);
      if (lane == 0) xs[warp * MT + m] = ss;  // x staging area as scratch
    }
    __syncthreads();
    if (threadIdx.x < m_cnt) {
      float ss = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) ss += xs[w * MT + threadIdx.x];
      inv[threadIdx.x] = rsqrtf(ss / (float)K + eps);
    }
  }

  // x (normalized under the prologue) as f32 values of bf16
  auto load8 = [&](int m, int k0, float* v) {
    const uint4 raw = *reinterpret_cast<const uint4*>(x + (size_t)m * Kp + k0);
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      v[i] = __bfloat162float(h[i]);
      if (lnw != nullptr) {
        const float w = k0 + i < K ? __bfloat162float(lnw[k0 + i]) : 0.f;
        v[i] = __bfloat162float(__float2bfloat16_rn(v[i] * inv[m] * w));
      }
    }
  };

  float acc[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) acc[m] = 0.f;

  for (int t = t_begin; t < t_end; ++t) {
    __syncthreads();  // inv ready; previous tile's x reads done
    pie::stage_x<MT>(xs, xsum, t, m_cnt, load8);
    __syncthreads();
    if (t + 1 < t_end)
      pie::load_warp_tile(nxt, packed, scales, biases, f32s, N, col, col_ok, t + 1, warp,
                          g);
    pie::accum_warp_tile<BITS, MT>(cur, xs, xsum, warp, g, acc);
    if (t + 1 < t_end) cur = nxt;
  }

  // split-K reduction across the block's warps
  __syncthreads();
#pragma unroll
  for (int m = 0; m < MT; ++m) red[(warp * MT + m) * 32 + lane] = acc[m];
  __syncthreads();
  const int splits = gridDim.y;
  if (splits > 1) {  // partial sums of this K range -> workspace
    for (int m = warp; m < m_cnt; m += kWarps) {
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) v += red[(w * MT + m) * 32 + lane];
      if (col_ok) ws[((size_t)blockIdx.y * M + m) * N + col] = v;
    }
    __threadfence();
    __syncthreads();
    __shared__ int last;
    if (threadIdx.x == 0) {
      last = atomicAdd(&counters[blockIdx.x], 1) == splits - 1;
      if (last) counters[blockIdx.x] = 0;  // ready for the next call
    }
    __syncthreads();
    if (!last) return;
    __threadfence();
  }
  // epilogue: rope rotation with the partner lane's column, bf16 output
  const int pcol = column_of(blockIdx.x, lane ^ 16, rope_dim);
  for (int m = warp; m < m_cnt; m += kWarps) {
    float v = 0.f, vp = 0.f;
    if (splits > 1) {
      for (int sp = 0; sp < splits; ++sp) {
        const float* part = ws + (size_t)sp * M * N + (size_t)m * N;
        if (col_ok) v += __ldcg(part + col);
        if (rope_dim != 0 && pcol < N) vp += __ldcg(part + pcol);
      }
    } else {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        v += red[(w * MT + m) * 32 + lane];
        vp += red[(w * MT + m) * 32 + (lane ^ 16)];
      }
    }
    if (!col_ok) continue;
    const size_t o = (size_t)m * N + col;
    if (rope_dim != 0) v = v * cosv[o] + vp * sinv[o];
    y[o] = __float2bfloat16_rn(v);
  }
}

template <int BITS, int MT>
cudaError_t launch(const void* x, const void* packed, const void* scales,
                   const void* biases, const void* lnw, const void* cosv,
                   const void* sinv, void* y, void* ws, void* counters,
                   int splits, int M, int K, int Kp, int N, int g,
                   int rope_dim, float eps, bool f32s, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (MT * kTileK + MT * kSums + MT);
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        gemv_kernel<BITS, MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const int n_tiles = Kp / kTileK;
  const int per_split = (n_tiles + splits - 1) / splits;
  const dim3 grid(rope_dim ? N / 32 : (N + 31) / 32, (n_tiles + per_split - 1) / per_split);
  gemv_kernel<BITS, MT><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint32_t*>(packed),
      scales, biases, static_cast<const __nv_bfloat16*>(lnw),
      static_cast<const float*>(cosv), static_cast<const float*>(sinv),
      static_cast<__nv_bfloat16*>(y), static_cast<float*>(ws),
      static_cast<int*>(counters), M, K, Kp, N, g, rope_dim, eps, per_split, f32s);
  return cudaGetLastError();
}

template <int BITS>
cudaError_t dispatch_rows(const void* x, const void* packed, const void* scales,
                          const void* biases, const void* lnw, const void* cosv,
                          const void* sinv, void* y, void* ws, void* counters,
                          int splits, int M, int K, int Kp, int N, int g,
                          int rope_dim, float eps, bool f32s, cudaStream_t st) {
#define PIE_GEMV_ROWS(MT)                                                     \
  if (M <= MT)                                                                \
    return launch<BITS, MT>(x, packed, scales, biases, lnw, cosv, sinv, y, ws, \
                            counters, splits, M, K, Kp, N, g, rope_dim, eps,    \
                            f32s, st);
  PIE_GEMV_ROWS(1)
  PIE_GEMV_ROWS(2)
  PIE_GEMV_ROWS(4)
  PIE_GEMV_ROWS(8)
  PIE_GEMV_ROWS(16)
  PIE_GEMV_ROWS(32)
#undef PIE_GEMV_ROWS
  return cudaErrorInvalidValue;
}

}  // namespace

// y[M, N] = xh[M, Kp] @ dequant(W), K split over `splits` blocks per
// column range (ws: [splits, M, N] f32 scratch and counters: one zeroed int
// per column block, both needed only when splits > 1); scales and biases
// are bf16, or f32 when scale_f32 != 0; returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for arguments
// the kernel does not take).
extern "C" int pie_quant_gemv(const void* x, const void* packed,
                              const void* scales, const void* biases,
                              const void* lnw, const void* cosv,
                              const void* sinv, void* y, void* ws,
                              void* counters, int splits, int M, int K, int Kp,
                              int N, int bits, int group_size, int scale_f32,
                              int rope_dim, float eps, void* stream) {
  if (M < 1 || M > 32 || Kp % kTileK != 0 || K > Kp || splits < 1 ||
      (splits > 1 && (ws == nullptr || counters == nullptr)) ||
      (group_size != 32 && group_size != 64 && group_size != 128) ||
      (rope_dim != 0 && (rope_dim % 32 != 0 || N % rope_dim != 0)) ||
      ((rope_dim != 0) != (cosv != nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bits == 4)
    return (int)dispatch_rows<4>(x, packed, scales, biases, lnw, cosv, sinv, y,
                                 ws, counters, splits, M, K, Kp, N, group_size,
                                 rope_dim, eps, scale_f32 != 0, st);
  if (bits == 8)
    return (int)dispatch_rows<8>(x, packed, scales, biases, lnw, cosv, sinv, y,
                                 ws, counters, splits, M, K, Kp, N, group_size,
                                 rope_dim, eps, scale_f32 != 0, st);
  return (int)cudaErrorInvalidValue;
}
