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
// each dot in f32 with the decode branch's per-group post-scale,
//   sum_g ( s * (x . q) + b * sum(x) ).
//
// Bound on the H100: bytes. At M <= 8 each packed word feeds at most 64
// multiply-adds, far below the ~295 operations per byte where the tensor
// cores would be the limit, so the least time is one layer's packed words
// plus scales and biases of wo, wgu and wd over 3.35 TB/s (Llama-3.2-1B,
// INT4 g64: 30.67 MB, 9.2 us).
//
// Design. Every output of a phase needs the whole previous phase (the norm
// needs all of h2, wgu all of xg, wd all of act), and a GPU grid carries
// nothing between blocks without a barrier, so one cooperative launch
// (every block resident, or the launch fails) runs three split-K GEMV
// phases on K1's machinery (gemv_tile.cuh): mma.sync m16n8k16 on the exact
// codes in the transposed form y^T = W^T x^T (M <= 8 is one n8 tile, so
// M = 8 costs what M = 1 does), the f32 post-scale per group, 128-feature
// tiles and 128-row ring stages filled by TMA behind mbarriers.
// - Tasks: phase p has tiles x splits tasks (a tile's K range split into
//   whole stages, mlp_plan in ops/fused_mlp.py), dealt to the blocks
//   round-robin. A wgu tile is the g features [64j, 64j + 64) and the u
//   features [di + 64j, di + 64j + 64), so the tile that finishes them can
//   write act[:, 64j:64j + 64] itself, as the reference runs silu*mul for
//   g-tile j as soon as u-tile j lands.
// - Split-K: every split but the first writes its f32 partial, adds one to
//   the tile's counter (a release, no round trip) and goes on to its next
//   task; split 0's block owns the tile: it waits until the counter shows
//   every partial, resets it, sums the partials in split order onto its own
//   and runs the phase's epilogue: h2 (and each row's sum of squares over
//   the tile), act, or out. Sums run in a fixed order, so a second call
//   gives the same bits. A split phase has at most one task per block
//   (mlp_plan), so no owner waits on a block that waits on it.
// - Two grid barriers: after h2 (the norm needs all of it) and after act.
//   The block that writes a tile's h2 (act) arrives; the last of the
//   phase's tiles opens the barrier. Only a block's x warp waits, before it
//   reads the next phase's x. The weights
//   do not depend on any activation, so the producer walks the block's
//   whole task list over the three phases without stopping: while the grid
//   finishes wo, every block's ring already holds its first wgu stages, and
//   its wd stages while wgu ends (the JAX kernel parks the next weight
//   block in flight the same way).
// - x: the x warp copies each stage's rows of x (attn, h2, act) into its
//   swizzled boxes with cp.async, a batch of up to a ring of stages in
//   flight at once; the consumer warps then prepare the batch together, one
//   warp a stage: xg = bf16(h2 * inv * ln2) in place (inv from the wo
//   tiles' sums of squares, summed in a fixed tree order) and each 32-row
//   chunk's x sum for the bias term. h2, act and the sums of squares were
//   written by other blocks of this launch with generic stores, so they are
//   read through L2 (cp.async.cg, ld.global.cg) after an acquire of the
//   barrier's generation, never through TMA or L1.
// The barrier words and split counters are zero on the first call and left
// so by every call (a barrier's generation only grows), so the call
// captures into a CUDA graph and no memset runs per call.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemv_tile.cuh"
#include "hopper.cuh"

namespace {

using pie::bf16_pair;
using pie::int8_pair_w;
using pie::mma_16816;
using pie::prmt;
using pie::cp_async16;
using pie::cp_async_commit;
using pie::cp_async_wait;
using pie::encode_3d;
using pie::mbar_arrive;
using pie::mbar_expect_tx;
using pie::mbar_init;
using pie::mbar_wait;
using pie::smem_u32;
using pie::tma_load_3d;
using pie::gemv::BF;
using pie::gemv::consumer_sync;
using pie::gemv::int4_pair_w;
using pie::gemv::CP;
using pie::gemv::KS;
using pie::gemv::kBarBytes;
using pie::gemv::kConsumers;
using pie::gemv::kMaxStages;
using pie::gemv::kThreads;
using pie::gemv::sb_bytes;
using pie::gemv::sum8;
using pie::gemv::words_bytes;

constexpr int MP = 8;                    // token rows of a stage: M <= 8, one n8 tile
constexpr int kTileBytes = MP * CP * 4;  // the f32 epilogue tile
constexpr int kCounters = 4;             // two grid barriers: arrivals, generation
constexpr int kMaxD = 4096;              // the ln2 row is kept in shared memory

struct Maps {
  CUtensorMap m[9];  // wo, wgu, wd: words, scales, biases, each [L, rows, N]
};

struct Phase {
  int tiles, stages, splits, per;  // per: stages of a split
};

struct Args {
  const __nv_bfloat16* attn;  // [M, d_attn]
  const __nv_bfloat16* h_in;  // [M, d]
  const __nv_bfloat16* lnw;   // [d] this layer's ln2 row
  __nv_bfloat16* out;         // [M, d]
  float* part[3];             // per phase with splits: [tiles][splits][M][BF] f32
  float* ss;                  // [d / BF][M]: sum of f32(h2)^2 over each wo tile
  __nv_bfloat16* h2;          // [M, d]
  __nv_bfloat16* act;         // [M, di]
  unsigned int* counters;     // barriers (tile arrivals, generation) x 2, then split arrivals per tile
  Phase ph[3];
  int M, layer, d_attn, d, di;
  float eps;
};

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xFFFF0000u); }

__device__ __forceinline__ unsigned int ld_acquire(const unsigned int* p) {
  unsigned int v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// An arrival: releases what this block wrote before it (ordered by the
// block's barrier), acquires what the earlier arrivals released.
__device__ __forceinline__ unsigned int arrive_acq_rel(unsigned int* p) {
  unsigned int old;
  asm volatile("atom.add.acq_rel.gpu.global.u32 %0, [%1], 1;\n" : "=r"(old) : "l"(p) : "memory");
  return old;
}

__device__ __forceinline__ void open_release(unsigned int* p) {
  asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(p) : "memory");
}

// Visit the block's tasks in order: phase, tile, split, first stage and
// stage count. Task T of a phase goes to block T mod grid.
template <class F>
__device__ __forceinline__ void walk(const Args& a, F f) {
#pragma unroll 1
  for (int p = 0; p < 3; ++p) {
    const Phase& ph = a.ph[p];
#pragma unroll 1
    for (int task = blockIdx.x; task < ph.tiles * ph.splits; task += gridDim.x) {
      const int tile = task % ph.tiles, split = task / ph.tiles;
      const int s0 = split * ph.per;
      f(p, tile, split, s0, min(ph.stages, s0 + ph.per) - s0);
    }
  }
}

// The weight column of local feature f (a multiple of 32) of a tile.
__device__ __forceinline__ int feature(const Args& a, int p, int tile, int f) {
  if (p == 1) return f < 64 ? tile * 64 + f : a.di + tile * 64 + (f - 64);
  return tile * BF + f;
}

// One consumer warp's pass over a full stage st, K1's consumer loop
// (quant_gemv.cu) at one n8 token tile: features fl, fl + 1 (the warp's mma
// rows r4 and r4 + 8). The products x.q of each group go to part on the
// tensor cores; at the group's end acc += s * part + b * sum(x). The scale
// and bias rows are two 64-feature halves: feature fl of group q is element
// sfl + 64 q.
template <int BITS, bool F32S, int G>
__device__ __forceinline__ void consume_stage(const unsigned char* st, int fl, int sfl, int r4,
                                              int t, float (&acc)[4], float (&part)[4]) {
  constexpr int EP = 32 / BITS, GQ = G / 32;  // 32-row steps (and x-sum chunks) per group
  using L = pie::gemv::Stage<BITS, F32S, G, MP>;
  const float* sums = reinterpret_cast<const float*>(st + L::offSum);
  // words of features fl, fl + 1 in word row r of the stage (four boxes of
  // [KS / EP][32] words, 128-byte swizzle)
  auto word_pair = [&](int r) {
    const unsigned char* box = st + L::offW + (fl >> 5) * (KS / EP) * 128;
    return *reinterpret_cast<const uint2*>(box + r * 128 + ((((fl & 31) >> 2) ^ (r & 7)) << 4) +
                                           ((fl & 3) << 2));
  };
#pragma unroll
  for (int kq = 0; kq < KS / 32; ++kq) {  // 32 rows: two k16 steps, rows permuted
    // rc: the 8-row chunk quad thread t takes whole (K1's order, free of
    // bank conflicts); step 0 pairs its rows (0, 4) and (1, 5), step 1 rows
    // (2, 6) and (3, 7), in A and B alike
    const int rc = G == 32 ? 4 * kq + t : 8 * (kq >> 1) + 2 * t + (kq & 1);
    uint32_t a[2][4];
    if constexpr (BITS == 4) {
      const uint2 w = word_pair(rc);
      a[0][0] = int4_pair_w(w.x, 0);
      a[0][1] = int4_pair_w(w.y, 0);
      a[0][2] = int4_pair_w(w.x, 4);
      a[0][3] = int4_pair_w(w.y, 4);
      a[1][0] = int4_pair_w(w.x, 8);
      a[1][1] = int4_pair_w(w.y, 8);
      a[1][2] = int4_pair_w(w.x, 12);
      a[1][3] = int4_pair_w(w.y, 12);
    } else {  // chunk t is word rows 2t (rows 0-3) and 2t + 1 (rows 4-7)
      const uint2 w0 = word_pair(2 * rc);
      const uint2 w1 = word_pair(2 * rc + 1);
      a[0][0] = int8_pair_w(w0.x, w1.x, 0);
      a[0][1] = int8_pair_w(w0.y, w1.y, 0);
      a[0][2] = int8_pair_w(w0.x, w1.x, 1);
      a[0][3] = int8_pair_w(w0.y, w1.y, 1);
      a[1][0] = int8_pair_w(w0.x, w1.x, 2);
      a[1][1] = int8_pair_w(w0.y, w1.y, 2);
      a[1][2] = int8_pair_w(w0.x, w1.x, 3);
      a[1][3] = int8_pair_w(w0.y, w1.y, 3);
    }
    const uint4 v = *reinterpret_cast<const uint4*>(st + (rc >> 3) * MP * 128 + r4 * 128 +
                                                    (((rc & 7) ^ (r4 & 7)) * 16));
    mma_16816(part, a[0], prmt(v.x, v.z, 0x5410u), prmt(v.x, v.z, 0x7632u));
    mma_16816(part, a[1], prmt(v.y, v.w, 0x5410u), prmt(v.y, v.w, 0x7632u));
    if ((kq + 1) % GQ == 0) {  // a group ends: acc += s * part + b * sum(x)
      const int q = kq / GQ;
      float s0, s1, b0, b1;
      if constexpr (F32S) {
        const float2 sv = *reinterpret_cast<const float2*>(st + L::offS + (q * 64 + sfl) * 4);
        const float2 bv = *reinterpret_cast<const float2*>(st + L::offB + (q * 64 + sfl) * 4);
        s0 = sv.x; s1 = sv.y; b0 = bv.x; b1 = bv.y;
      } else {
        const uint32_t sv = *reinterpret_cast<const uint32_t*>(st + L::offS + (q * 64 + sfl) * 2);
        const uint32_t bv = *reinterpret_cast<const uint32_t*>(st + L::offB + (q * 64 + sfl) * 2);
        s0 = __uint_as_float(sv << 16); s1 = __uint_as_float(sv & 0xFFFF0000u);
        b0 = __uint_as_float(bv << 16); b1 = __uint_as_float(bv & 0xFFFF0000u);
      }
      float2 sx = make_float2(0.f, 0.f);
#pragma unroll
      for (int c = 0; c < GQ; ++c) {
        const float2 v2 = *reinterpret_cast<const float2*>(sums + (q * GQ + c) * MP + 2 * t);
        sx.x += v2.x;
        sx.y += v2.y;
      }
      acc[0] = fmaf(s0, part[0], fmaf(b0, sx.x, acc[0]));
      acc[1] = fmaf(s0, part[1], fmaf(b0, sx.y, acc[1]));
      acc[2] = fmaf(s1, part[2], fmaf(b1, sx.x, acc[2]));
      acc[3] = fmaf(s1, part[3], fmaf(b1, sx.y, acc[3]));
#pragma unroll
      for (int r = 0; r < 4; ++r) part[r] = 0.f;
    }
  }
}

// Byte offset in a stage of piece c (8 columns) of 32-row chunk q of token
// row n: two 64-column boxes [MP][64] bf16 with the 128-byte swizzle, as a
// TMA copy would lay them out (what consume_stage reads).
__device__ __forceinline__ int x_piece(int n, int q, int c) {
  const int chunk = 4 * q + c;
  return (chunk >> 3) * MP * 128 + n * 128 + (((chunk & 7) ^ (n & 7)) * 16);
}

template <int BITS, bool F32S, int G>
__global__ void __launch_bounds__(kThreads, 2)
    fused_mlp_kernel(const __grid_constant__ Maps maps, const __grid_constant__ Args a) {
  using L = pie::gemv::Stage<BITS, F32S, G, MP>;
  constexpr int EP = 32 / BITS, ES = F32S ? 4 : 2;
  constexpr int sbytes = L::bytes, stages = L::stages;
  constexpr uint32_t wtx = words_bytes(BITS) + 2 * sb_bytes(G, F32S);
  extern __shared__ unsigned char smem_raw[];
  __shared__ float red[MP * (BF / 8)];
  __shared__ unsigned int gen_seen[2];
  __shared__ float inv_s[MP];  // rsqrt(mean(h2^2) + eps) per row
  const uint32_t raw0 = smem_u32(smem_raw);
  const uint32_t base = (raw0 + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw0);
  float* Ct = reinterpret_cast<float*>(smem + stages * sbytes);  // [MP][CP]
  const uint32_t full0 = base + stages * sbytes + kTileBytes, ready0 = full0 + 8 * kMaxStages,
                 empty0 = ready0 + 8 * kMaxStages;
  // this layer's ln2 row [d] bf16
  unsigned char* lns = smem + stages * sbytes + kTileBytes + kBarBytes;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int M = a.M;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(ready0 + 8 * s, 32);
      mbar_init(empty0 + 8 * s, kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    // nobody in this block has arrived yet, so neither barrier has opened
    gen_seen[0] = ld_acquire(a.counters + 1);
    gen_seen[1] = ld_acquire(a.counters + 3);
  }
  __syncthreads();

  if (warp == kConsumers / 32) {  // producer: one thread issues every weight copy
    if (lane == 0) {
      int i = 0, last_p = 0;
      walk(a, [&](int p, int tile, int, int s0, int n) {
        // the phase on the grid's critical path first: the next phase's
        // copies start once this block's copies of the earlier one landed
        if (p != last_p && i > 0) mbar_wait(full0 + 8 * ((i - 1) % stages), ((i - 1) / stages) & 1);
        last_p = p;
        const CUtensorMap* mw = &maps.m[3 * p];
        for (int k = 0; k < n; ++k, ++i) {
          const int slot = i % stages;
          if (i >= stages) mbar_wait(empty0 + 8 * slot, ((i / stages) - 1) & 1);
          const uint32_t st = base + slot * sbytes, bar = full0 + 8 * slot;
          const int k0 = (s0 + k) * KS;
          mbar_expect_tx(bar, wtx);
          for (int b = 0; b < BF / 32; ++b)  // four 32-feature boxes, 128-byte swizzle
            tma_load_3d(st + L::offW + b * (KS / EP) * 128, mw, bar, feature(a, p, tile, 32 * b),
                        k0 / EP, a.layer);
          for (int h = 0; h < 2; ++h) {  // scale and bias rows, two 64-feature halves
            const int c = feature(a, p, tile, 64 * h);
            tma_load_3d(st + L::offS + h * (KS / G) * 64 * ES, mw + 1, bar, c, k0 / G, a.layer);
            tma_load_3d(st + L::offB + h * (KS / G) * 64 * ES, mw + 2, bar, c, k0 / G, a.layer);
          }
        }
      });
    }
    return;
  }

  if (warp == kConsumers / 32 + 1) {  // x warp: copies the rows of x into the stages
    for (int c = lane; c < a.d / 8; c += 32)
      reinterpret_cast<uint4*>(lns)[c] = __ldg(reinterpret_cast<const uint4*>(a.lnw) + c);
    // lane: token row n, 32-row chunk q of a stage (four 16-byte pieces)
    const int n = lane >> 2, q = lane & 3;
    int opened = 0;  // grid barriers waited for
    bool need_inv = false;
    int i = 0;
    walk(a, [&](int p, int, int, int s0, int cnt) {
      if (opened < p) {  // the phase reads what the grid wrote before barrier p
        if (lane == 0)
          while (ld_acquire(a.counters + 2 * (p - 1) + 1) == gen_seen[p - 1]) __nanosleep(64);
        __syncwarp();
        need_inv = p == 1;
        opened = p;
      }
      const __nv_bfloat16* row = p == 0 ? a.attn + (size_t)n * a.d_attn
                                 : p == 1 ? a.h2 + (size_t)n * a.d
                                          : a.act + (size_t)n * a.di;
      // a batch of stages (at most the ring) at a time, every copy in flight
      // at once; the consumers then prepare the batch together
      for (int b0 = 0; b0 < cnt; b0 += stages) {
        const int nb = min(stages, cnt - b0);
        for (int k = 0; k < nb; ++k, ++i) {
          if (i >= stages) mbar_wait(empty0 + 8 * (i % stages), ((i / stages) - 1) & 1);
          unsigned char* st = smem + (i % stages) * sbytes;
          const int kr = (s0 + b0 + k) * KS + 32 * q;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            unsigned char* dst = st + x_piece(n, q, c);
            if (n < M)
              cp_async16(dst, row + kr + 8 * c);
            else
              *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
          }
        }
        cp_async_commit();
        if (need_inv) {  // inv of each row from the wo tiles' sums of squares (lane = tile)
          float v[MP];
#pragma unroll
          for (int m = 0; m < MP; ++m)
            v[m] = lane < a.ph[0].tiles && m < M ? __ldcg(a.ss + lane * M + m) : 0.f;
#pragma unroll
          for (int m = 0; m < MP; ++m) {
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) v[m] += __shfl_xor_sync(0xffffffffu, v[m], o);
            if (lane == 0) inv_s[m] = rsqrtf(v[m] / (float)a.d + a.eps);
          }
          need_inv = false;
        }
        cp_async_wait<0>();
        for (int k = nb; k > 0; --k) mbar_arrive(ready0 + 8 * ((i - k) % stages));
      }
    });
    return;
  }

  // consumers: warp w owns tile features 16w..16w+15; mma row r4 is feature
  // fl = 16w + 2 r4 and row r4 + 8 is fl + 1
  const int r4 = lane >> 2, t = lane & 3;
  const int fl = warp * 16 + 2 * r4;
  const int sfl = (fl >> 6) * (KS / G) * 64 + (fl & 63);  // in the two scale halves
  const int ct = threadIdx.x;
  int i = 0;
  walk(a, [&](int p, int tile, int split, int s0, int n) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f}, part[4] = {0.f, 0.f, 0.f, 0.f};
    for (int b0 = 0; b0 < n; b0 += stages) {  // the x warp's batches
      const int nb = min(stages, n - b0);
      if (warp < nb) {  // warp w prepares stage b0 + w: xg rounding, 32-row x sums
        const int j = i + warp, xn = lane >> 2, q = lane & 3;
        unsigned char* st = smem + (j % stages) * sbytes;
        mbar_wait(ready0 + 8 * (j % stages), (j / stages) & 1);
        float sum = 0.f;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          uint4* x = reinterpret_cast<uint4*>(st + x_piece(xn, q, c));
          uint4 v = *x;
          if (p == 1 && xn < M) {  // xg = bf16(h2 * inv * ln2)
            const float inv = inv_s[xn];
            const uint4 wv =
                reinterpret_cast<const uint4*>(lns)[(s0 + b0 + warp) * (KS / 8) + 4 * q + c];
            const uint32_t hw[4] = {v.x, v.y, v.z, v.w}, ww[4] = {wv.x, wv.y, wv.z, wv.w};
            uint32_t o[4];
#pragma unroll
            for (int e = 0; e < 4; ++e)
              o[e] = bf16_pair(bf16_lo(hw[e]) * inv * bf16_lo(ww[e]),
                               bf16_hi(hw[e]) * inv * bf16_hi(ww[e]));
            v = make_uint4(o[0], o[1], o[2], o[3]);
            *x = v;
          }
          sum += sum8(v);
        }
        reinterpret_cast<float*>(st + L::offSum)[q * MP + xn] = sum;
      }
      consumer_sync();
      for (int k = 0; k < nb; ++k, ++i) {
        const int s = i % stages;
        mbar_wait(full0 + 8 * s, (i / stages) & 1);
        consume_stage<BITS, F32S, G>(smem + s * sbytes, fl, sfl, r4, t, acc, part);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty0 + 8 * s);
      }
    }
    // the tile's f32 sums -> Ct[token][feature]
    *reinterpret_cast<float2*>(Ct + (2 * t) * CP + fl) = make_float2(acc[0], acc[2]);
    *reinterpret_cast<float2*>(Ct + (2 * t + 1) * CP + fl) = make_float2(acc[1], acc[3]);
    consumer_sync();
    // the residual row this thread adds (h_in, or h2 for out), loaded early
    const int er = ct / (BF / 8), ec = (ct % (BF / 8)) * 8;
    uint4 res = make_uint4(0u, 0u, 0u, 0u);
    if (p != 1 && ct < M * (BF / 8)) {
      const size_t o = (size_t)er * a.d + tile * BF + ec;
      res = p == 0 ? __ldg(reinterpret_cast<const uint4*>(a.h_in + o))
                   : __ldcg(reinterpret_cast<const uint4*>(a.h2 + o));
    }
    const int splits = a.ph[p].splits;
    if (splits > 1) {  // split-K: split 0's block owns the tile and sums the partials
      float* tp = a.part[p] + (size_t)tile * splits * M * BF;
      unsigned int* cnt = a.counters + kCounters + (p > 0 ? a.ph[0].tiles : 0) +
                          (p > 1 ? a.ph[1].tiles : 0) + tile;
      if (split > 0) {  // write the partial, signal, and go on without waiting
        for (int e = ct; e < M * (BF / 4); e += kConsumers) {
          const int r = e / (BF / 4), c = (e % (BF / 4)) * 4;
          *reinterpret_cast<float4*>(tp + ((size_t)split * M + r) * BF + c) =
              *reinterpret_cast<const float4*>(Ct + r * CP + c);
        }
        consumer_sync();
        if (ct == 0) open_release(cnt);
        return;
      }
      if (ct == 0) {  // the owner: every other split's partial has landed
        while (ld_acquire(cnt) < (unsigned int)splits - 1) __nanosleep(32);
        *cnt = 0u;  // ready for the next call
      }
      consumer_sync();
      for (int e = ct; e < M * (BF / 4); e += kConsumers) {
        const int r = e / (BF / 4), c = (e % (BF / 4)) * 4;
        float4* own = reinterpret_cast<float4*>(Ct + r * CP + c);
        float4 v = *own;
        for (int sp = 1; sp < splits; ++sp) {  // in split order
          const float4 pv =
              __ldcg(reinterpret_cast<const float4*>(tp + ((size_t)sp * M + r) * BF + c));
          v.x += pv.x; v.y += pv.y; v.z += pv.z; v.w += pv.w;
        }
        *own = v;
      }
      consumer_sync();
    }
    if (p == 0) {  // h2 = h_in + bf16(y), and each row's sum of squares over the tile
      if (ct < M * (BF / 8)) {
        const uint32_t hw[4] = {res.x, res.y, res.z, res.w};
        const float* y = Ct + er * CP + ec;
        uint32_t o[4];
        float sq = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          o[j] = bf16_pair(bf16_lo(hw[j]) + bf16r(y[2 * j]), bf16_hi(hw[j]) + bf16r(y[2 * j + 1]));
          const float lo = bf16_lo(o[j]), hi = bf16_hi(o[j]);
          sq += lo * lo + hi * hi;
        }
        *reinterpret_cast<uint4*>(a.h2 + (size_t)er * a.d + tile * BF + ec) =
            make_uint4(o[0], o[1], o[2], o[3]);
        red[ct] = sq;
      }
      consumer_sync();
      if (ct < M) {
        float s = 0.f;
        for (int j = 0; j < BF / 8; ++j) s += red[ct * (BF / 8) + j];
        a.ss[tile * M + ct] = s;
      }
    } else if (p == 1) {  // act = bf16(silu(g) * u) for the tile's 64 features
      for (int e = ct; e < M * 8; e += kConsumers) {
        const int r = e / 8, f = (e % 8) * 8;
        const float* g = Ct + r * CP + f;
        uint32_t o[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float v[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float gf = bf16r(g[2 * j + h]), uf = bf16r(g[64 + 2 * j + h]);
            v[h] = gf * (1.f / (1.f + expf(-gf))) * uf;
          }
          o[j] = bf16_pair(v[0], v[1]);
        }
        *reinterpret_cast<uint4*>(a.act + (size_t)r * a.di + tile * 64 + f) =
            make_uint4(o[0], o[1], o[2], o[3]);
      }
    } else if (ct < M * (BF / 8)) {  // out = h2 + bf16(y)
      const uint32_t hw[4] = {res.x, res.y, res.z, res.w};
      const float* y = Ct + er * CP + ec;
      uint32_t o[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        o[j] = bf16_pair(bf16_lo(hw[j]) + bf16r(y[2 * j]), bf16_hi(hw[j]) + bf16r(y[2 * j + 1]));
      *reinterpret_cast<uint4*>(a.out + (size_t)er * a.d + tile * BF + ec) =
          make_uint4(o[0], o[1], o[2], o[3]);
    }
    consumer_sync();  // the tile is written; Ct and red are free again
    if (p < 2 && ct == 0) {  // grid barrier p: the phase's tiles arrive, the last opens it
      unsigned int* cnt = a.counters + 2 * p;
      if (arrive_acq_rel(cnt) == (unsigned int)a.ph[p].tiles - 1) {
        *cnt = 0u;  // arrivals back to zero for the next call
        open_release(cnt + 1);
      }
    }
  });
}

// -- host side ------------------------------------------------------------------

// dynamic shared memory: alignment slack, the ring, the f32 epilogue tile,
// the mbarriers, the ln2 row
constexpr int smem_bytes(int bits, bool f32s, int g, int d) {
  return 1024 + pie::gemv::ring_stages(bits, f32s, g, MP) * pie::gemv::stage_bytes(bits, f32s, g, MP) +
         kTileBytes + kBarBytes + 2 * d;
}

// The kernel's shared-memory attributes, set once (room for the widest ln2
// row it takes).
template <int BITS, bool F32S, int G>
cudaError_t prepare() {
  static bool done = false;
  if (done) return cudaSuccess;
  auto kern = fused_mlp_kernel<BITS, F32S, G>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       smem_bytes(BITS, F32S, G, kMaxD));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  done = e == cudaSuccess;
  return e;
}

// Resident blocks per SM at the shared memory of width d (occupancy query).
template <int BITS, bool F32S, int G>
cudaError_t blocks_per_sm(int d, int* out) {
  cudaError_t e = prepare<BITS, F32S, G>();
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, fused_mlp_kernel<BITS, F32S, G>,
                                                       kThreads, smem_bytes(BITS, F32S, G, d));
}

// One cooperative launch: the grid must be resident (the plan asks the
// occupancy query; a larger grid is refused by the launch).
template <int BITS, bool F32S, int G>
cudaError_t launch(const Maps& maps, const Args& a, int grid, int ring, cudaStream_t stream) {
  if (ring != pie::gemv::ring_stages(BITS, F32S, G, MP) || grid < 1) return cudaErrorInvalidValue;
  cudaError_t e = prepare<BITS, F32S, G>();
  if (e != cudaSuccess) return e;
  void* params[] = {const_cast<Maps*>(&maps), const_cast<Args*>(&a)};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(fused_mlp_kernel<BITS, F32S, G>),
                                  dim3(grid), dim3(kThreads), params,
                                  smem_bytes(BITS, F32S, G, a.d), stream);
  return e != cudaSuccess ? e : cudaGetLastError();
}

#define PIE_K4_FORMATS(X) \
  X(4, false, 32) X(4, false, 64) X(4, false, 128) X(4, true, 32) X(4, true, 64) X(4, true, 128) \
  X(8, false, 32) X(8, false, 64) X(8, false, 128) X(8, true, 32) X(8, true, 64) X(8, true, 128)

bool ok_format(int bits, int g) {
  return (bits == 4 || bits == 8) && (g == 32 || g == 64 || g == 128);
}

// Workspace bytes of a plan: the split phases' f32 partials, the sums of
// squares (rounded up to 16 bytes), h2 and act (ops/fused_mlp.py
// MlpPlan.workspace_bytes).
size_t workspace_need(const Phase (&ph)[3], int M, int d, int di) {
  size_t floats = 0;
  for (const Phase& p : ph)
    if (p.splits > 1) floats += (size_t)p.tiles * p.splits * M * BF;
  floats += ((size_t)ph[0].tiles * M + 3) / 4 * 4;
  return 4 * floats + 2 * (size_t)M * (d + di);
}

}  // namespace

// Encode the three tensor maps of one stacked quantized weight once:
// words [L, K/ep, N] int32 (box [1, 128/ep, 32], 128-byte swizzle), scales
// and biases [L, K/g, N] (box [1, 128/g, 64]), layer strides in bytes.
// out: 3 x 128 bytes of host memory (CUtensorMap words, scales, biases),
// 64-byte aligned. Returns 0, or cudaErrorInvalidValue.
extern "C" int pie_fused_mlp_encode(const void* packed, const void* scales, const void* biases,
                                    int layers, long long packed_layer_bytes,
                                    long long sb_layer_bytes, int K, int N, int bits,
                                    int group_size, int scale_f32, void* out) {
  if (!ok_format(bits, group_size) || layers < 1 || K < KS || K % KS || N < BF / 2 ||
      N % (BF / 2) || reinterpret_cast<uintptr_t>(out) % 64)
    return (int)cudaErrorInvalidValue;
  const int ep = 32 / bits, es = scale_f32 ? 4 : 2;
  const CUtensorMapDataType st =
      scale_f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap* m = static_cast<CUtensorMap*>(out);
  const bool ok =
      encode_3d(&m[0], CU_TENSOR_MAP_DATA_TYPE_INT32, packed, N, K / ep, layers, (uint64_t)N * 4,
                packed_layer_bytes, 32, KS / ep, CU_TENSOR_MAP_SWIZZLE_128B) &&
      encode_3d(&m[1], st, scales, N, K / group_size, layers, (uint64_t)N * es, sb_layer_bytes,
                BF / 2, KS / group_size, CU_TENSOR_MAP_SWIZZLE_NONE) &&
      encode_3d(&m[2], st, biases, N, K / group_size, layers, (uint64_t)N * es, sb_layer_bytes,
                BF / 2, KS / group_size, CU_TENSOR_MAP_SWIZZLE_NONE);
  return ok ? 0 : (int)cudaErrorInvalidValue;
}

// Resident blocks per SM of the K4 kernel for one weight format and model
// width d (sets its shared-memory attributes first), or a negative CUDA
// error.
extern "C" int pie_fused_mlp_blocks_per_sm(int bits, int group_size, int scale_f32, int d) {
  int per_sm = 0;
  cudaError_t e = cudaErrorInvalidValue;
  if (d < BF || d > kMaxD || d % BF) return -(int)e;
#define PIE_K4_BLOCKS(B, F, G) \
  if (bits == B && (scale_f32 != 0) == F && group_size == G) e = blocks_per_sm<B, F, G>(d, &per_sm);
  PIE_K4_FORMATS(PIE_K4_BLOCKS)
#undef PIE_K4_BLOCKS
  return e == cudaSuccess ? per_sm : -(int)e;
}

// out[M, d] = the decode MLP block above for layer `layer`: maps_o,
// maps_g, maps_d are the weights' encoded maps (pie_fused_mlp_encode), lnw
// this layer's ln2 row. The plan (ops/fused_mlp.py mlp_plan): each phase's
// K splits and stages per split, the grid (at most the resident blocks)
// and the ring stages. ws: at least workspace_need bytes; counters:
// 4 + d/128 + di/64 + d/128 zeroed words kept between calls. Scales and
// biases are bf16, or f32 when scale_f32 != 0. Returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue for arguments the kernel does not
// take).
extern "C" int pie_fused_mlp(const void* attn, const void* h_in, const void* lnw,
                             const void* maps_o, const void* maps_g, const void* maps_d,
                             void* out, void* ws, void* counters, int M, int layer, int d_attn,
                             int d, int di, int bits, int group_size, int scale_f32,
                             int s_o, int per_o, int s_g, int per_g, int s_d, int per_d,
                             int grid, int ring, float eps, long long ws_bytes, void* stream) {
  if (M < 1 || M > MP || !ok_format(bits, group_size) || layer < 0 || d_attn < KS ||
      d_attn % KS || d < BF || d > kMaxD || d % BF || di < BF || di % BF || attn == nullptr ||
      h_in == nullptr || lnw == nullptr || maps_o == nullptr || maps_g == nullptr ||
      maps_d == nullptr || out == nullptr || ws == nullptr || counters == nullptr)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.ph[0] = {d / BF, d_attn / KS, s_o, per_o};
  a.ph[1] = {di / (BF / 2), d / KS, s_g, per_g};
  a.ph[2] = {d / BF, di / KS, s_d, per_d};
  for (const Phase& p : a.ph)  // a split phase: at most one task per block
    if (p.splits < 1 || p.per < 1 || (p.splits - 1) * p.per >= p.stages ||
        p.splits * p.per < p.stages || (p.splits > 1 && p.tiles * p.splits > grid))
      return (int)cudaErrorInvalidValue;
  if (ws_bytes < 0 || (size_t)ws_bytes < workspace_need(a.ph, M, d, di))
    return (int)cudaErrorInvalidValue;
  a.attn = static_cast<const __nv_bfloat16*>(attn);
  a.h_in = static_cast<const __nv_bfloat16*>(h_in);
  a.lnw = static_cast<const __nv_bfloat16*>(lnw);
  a.out = static_cast<__nv_bfloat16*>(out);
  float* f = static_cast<float*>(ws);
  for (int p = 0; p < 3; ++p) {
    a.part[p] = f;
    if (a.ph[p].splits > 1) f += (size_t)a.ph[p].tiles * a.ph[p].splits * M * BF;
  }
  a.ss = f;
  f += ((size_t)a.ph[0].tiles * M + 3) / 4 * 4;
  a.h2 = reinterpret_cast<__nv_bfloat16*>(f);
  a.act = a.h2 + (size_t)M * d;
  a.counters = static_cast<unsigned int*>(counters);
  a.M = M;
  a.layer = layer;
  a.d_attn = d_attn;
  a.d = d;
  a.di = di;
  a.eps = eps;
  Maps maps;
  const void* src[3] = {maps_o, maps_g, maps_d};
  for (int w = 0; w < 3; ++w)
    for (int j = 0; j < 3; ++j) maps.m[3 * w + j] = static_cast<const CUtensorMap*>(src[w])[j];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PIE_K4_LAUNCH(B, F, G)                                          \
  if (bits == B && (scale_f32 != 0) == F && group_size == G)            \
    return (int)launch<B, F, G>(maps, a, grid, ring, st);
  PIE_K4_FORMATS(PIE_K4_LAUNCH)
#undef PIE_K4_LAUNCH
  return (int)cudaErrorInvalidValue;
}
