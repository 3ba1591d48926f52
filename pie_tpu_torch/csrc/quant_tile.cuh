// The weight-streaming GEMV pieces of K4 (fused_mlp.cu): the tile geometry,
// the exact code-to-float conversion, one warp's slice of a 512-row weight
// tile held in registers, the staging of x with its 32-row sums, and the
// group-affine accumulation over a tile.
//
// The math (K1's, see quant_gemv.cu): for column n,
//   y[m, n] = sum_g ( s[g,n] * sum_{k in g} x[m,k] q[k,n] + b[g,n] * sum_{k in g} x[m,k] )
// in f32. A code becomes the exact float 1 + q/2^bits with one shift and one
// logic op, so sum x*(1 + q/2^bits) - sum x = sum x*q / 2^bits and the group
// scale applies as 2^bits * s to that difference.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace pie {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTileK = 512;                      // K rows per block iteration
constexpr int kRowsPerWarp = kTileK / kWarps;    // 64
constexpr int kSums = kTileK / 32;               // 32-row x sums per tile

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Exact float 1 + q / 2^BITS for code i of word w.
template <int BITS, int I>
__device__ __forceinline__ float code_plus_one(uint32_t w) {
  constexpr int sh = 23 - BITS - BITS * I;
  constexpr uint32_t mask = ((1u << BITS) - 1u) << (23 - BITS);
  const uint32_t v = sh >= 0 ? (w << (sh >= 0 ? sh : 0)) : (w >> (sh < 0 ? -sh : 0));
  return __uint_as_float((v & mask) | 0x3F800000u);
}

// A group scale or bias stored as bf16, or as f32 (a tied head quantized
// from the f32 transpose of the embedding keeps f32 ones, as in the JAX
// package).
__device__ __forceinline__ float load_affine(const void* p, size_t i, bool f32) {
  return f32 ? static_cast<const float*>(p)[i]
             : __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
}

// One warp's 64 rows of a 512-row weight tile for one column: the packed
// words, and the scale and bias of the (one or two) groups they cover.
template <int BITS>
struct WarpTile {
  static constexpr int kWords = kRowsPerWarp / (32 / BITS);
  uint32_t w[kWords];
  float s[2], b[2];
};

// Rows per sub-group of a warp's 64 rows (a group, or the warp's share of
// a 128-row group) and the number of sub-groups (1 or 2).
__device__ __forceinline__ int sub_rows(int g) { return g < kRowsPerWarp ? g : kRowsPerWarp; }

template <int BITS>
__device__ __forceinline__ void load_warp_tile(
    WarpTile<BITS>& t, const uint32_t* __restrict__ packed, const void* scales,
    const void* biases, bool f32s, int N, int col, bool col_ok, int tile, int warp,
    int g) {
  constexpr int EP = 32 / BITS;
  const int r0 = tile * kTileK + warp * kRowsPerWarp;
  const int sg = sub_rows(g), nsub = kRowsPerWarp / sg;
#pragma unroll
  for (int j = 0; j < WarpTile<BITS>::kWords; ++j)
    t.w[j] = col_ok ? __ldg(packed + (size_t)(r0 / EP + j) * N + col) : 0u;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    t.s[q] = 0.f;
    t.b[q] = 0.f;
    if (q < nsub && col_ok) {
      const size_t gi = (size_t)((r0 + q * sg) / g) * N + col;
      t.s[q] = load_affine(scales, gi, f32s);
      t.b[q] = load_affine(biases, gi, f32s);
    }
  }
}

// Stage rows [tile*512, tile*512 + 512) of MT rows of x into xs ([MT][512]
// f32) with their 32-row sums in xsum ([MT][16]). load8(m, k0, v) fills the
// 8 values of row m from column k0, already rounded as the caller wants;
// rows m >= m_cnt are zero. Call between __syncthreads().
template <int MT, class Load8>
__device__ __forceinline__ void stage_x(float* xs, float* xsum, int tile, int m_cnt,
                                        Load8 load8) {
  const int lane = threadIdx.x & 31;
  for (int idx = threadIdx.x; idx < MT * (kTileK / 8); idx += kThreads) {
    const int m = idx / (kTileK / 8), c8 = idx % (kTileK / 8);
    float v[8];
    if (m < m_cnt) {
      load8(m, tile * kTileK + c8 * 8, v);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = 0.f;
    }
    float4* dst = reinterpret_cast<float4*>(xs + m * kTileK + c8 * 8);
    dst[0] = make_float4(v[0], v[1], v[2], v[3]);
    dst[1] = make_float4(v[4], v[5], v[6], v[7]);
    // four neighbouring threads hold one 32-row group
    float p = ((v[0] + v[1]) + (v[2] + v[3])) + ((v[4] + v[5]) + (v[6] + v[7]));
    p += __shfl_xor_sync(0xffffffffu, p, 1);
    p += __shfl_xor_sync(0xffffffffu, p, 2);
    if ((lane & 3) == 0) xsum[m * kSums + c8 / 4] = p;
  }
}

// acc[m] += this warp's 64 rows of the staged tile times its weight slice.
template <int BITS, int MT>
__device__ __forceinline__ void accum_warp_tile(const WarpTile<BITS>& t,
                                                const float* xs, const float* xsum,
                                                int warp, int g, float (&acc)[MT]) {
  constexpr int EP = 32 / BITS;
  constexpr int WROWS = WarpTile<BITS>::kWords;
  const int sg = sub_rows(g), nsub = kRowsPerWarp / sg;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    if (q >= nsub) break;
    const int kl0 = warp * kRowsPerWarp + q * sg;  // first tile row of the sub-group
    const int j0 = q * sg / EP, j1 = j0 + sg / EP;
    float ag[MT];
#pragma unroll
    for (int m = 0; m < MT; ++m) ag[m] = 0.f;
#pragma unroll
    for (int j = 0; j < WROWS; ++j) {
      if (j < j0 || j >= j1) continue;
      const uint32_t w = t.w[j];
      float c[EP];
      if constexpr (BITS == 4) {
        c[0] = code_plus_one<4, 0>(w); c[1] = code_plus_one<4, 1>(w);
        c[2] = code_plus_one<4, 2>(w); c[3] = code_plus_one<4, 3>(w);
        c[4] = code_plus_one<4, 4>(w); c[5] = code_plus_one<4, 5>(w);
        c[6] = code_plus_one<4, 6>(w); c[7] = code_plus_one<4, 7>(w);
      } else {
        c[0] = code_plus_one<8, 0>(w); c[1] = code_plus_one<8, 1>(w);
        c[2] = code_plus_one<8, 2>(w); c[3] = code_plus_one<8, 3>(w);
      }
      const int kl = warp * kRowsPerWarp + j * EP;
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const float4* xr = reinterpret_cast<const float4*>(xs + m * kTileK + kl);
#pragma unroll
        for (int h = 0; h < EP / 4; ++h) {
          const float4 xv = xr[h];
          ag[m] = fmaf(xv.x, c[4 * h + 0], ag[m]);
          ag[m] = fmaf(xv.y, c[4 * h + 1], ag[m]);
          ag[m] = fmaf(xv.z, c[4 * h + 2], ag[m]);
          ag[m] = fmaf(xv.w, c[4 * h + 3], ag[m]);
        }
      }
    }
    const float s = t.s[q] * (float)(1 << BITS), b = t.b[q];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      float sx = xsum[m * kSums + kl0 / 32];
      if (sg == 64) sx += xsum[m * kSums + kl0 / 32 + 1];
      acc[m] = fmaf(s, ag[m] - sx, fmaf(b, sx, acc[m]));
    }
  }
}

}  // namespace pie
