// K3: paged decode attention over the layer-stacked KV pool.
//
// Replaces both TPU kernels of pie_tpu/ops/paged_attention.py:
// paged_attention_decode (_decode_kernel over one layer's pool) and
// paged_attention_decode_stacked (the layer applied inside each page DMA).
// Here the layer is a pointer offset, tile = (layer * P + page) * Hkv + head,
// so one kernel serves both and no layer is ever sliced out of the pool.
//
// Computes, for lane b and query head hq (kv head h = hq / rep), one query
// against the 64-token pages its block table names (-1 pads read page 0):
//   s_t = (q . k_t) * scale (f32), times k_scale[t] for INT8;
//   s_t = NEG_INF (-0.7 * f32 max) unless lo <= t < ctx, lo = max(ctx - window, 0)
//   when window > 0, else 0; only pages [lo / 64, ceil(ctx / 64)) are walked;
//   online softmax in f32, l sums the unscaled probabilities, the INT8 V scale
//   multiplies the probabilities for the PV product only;
//   out = acc / max(l, 1e-30), bf16.
//
// Bound on the H100: bytes. Each walked page-head is read once and used for
// rep (4 at the Llama-3 geometries) dot products per token, a few operations
// per byte. The least time is the sum over lanes of walked pages x Hkv x 64 x
// D x (bytes of K + V), plus 512 B of scales per page-head for INT8, over
// 3.35 TB/s: 8 lanes x 2,048 tokens at the 8B heads is 34.6 MB (INT8), 10 us.
//
// Design against that bound:
// - One block serves the rep query heads that share a kv head, so every K/V
//   page tile is read from device memory exactly once per call. A lane's
//   page walk is split across blocks (gridDim.x, page_splits in
//   ops/paged_attention.py) until the grid is one wave of resident blocks.
//   Each block writes its (acc, m, l) to an f32 workspace and the last block
//   of a (lane, head) to arrive (an atomic counter, reset by that block, as
//   K1 does) merges the partial softmaxes in split order.
// - Inside a block the pages are dealt to the warps in turn (warp w takes
//   pb + w, pb + w + W, ...). Each warp walks its pages alone: its own
//   double buffer of K tile, V tile and 2 x 64 scales in shared memory,
//   filled with 16-byte cp.async copies (page i + 1 in flight while page i
//   is multiplied; cp.async.wait_group + __syncwarp, no block barrier in
//   the loop), and its own online-softmax state in registers. Rows are
//   padded by 16 bytes so the ldmatrix reads below hit distinct banks.
//   After the walk the warps merge their (acc, m, l) through shared memory
//   (one __syncthreads), with the formula of the split merge.
// - QK on the tensor cores: mma.sync m16n8k16, bf16 in, f32 out. The rep
//   query heads are the rows of A (padded to 16; two m16 tiles when
//   rep > 16, at D 64 only), loaded once into registers, unscaled and exact;
//   the page's 64 tokens are N (eight n8 tiles), B is K[token][d] read with
//   ldmatrix. scale * k_scale[token] multiplies the f32 C fragment.
// - PV on the tensor cores: the C fragments of score tiles 2s and 2s + 1
//   are the A fragment of PV step s (tokens 16s..16s + 15), so the
//   probabilities never leave registers. They are multiplied by
//   v_scale[token] in f32 and rounded for the bf16 mma as two terms,
//   hi = bf16(p) and lo = bf16(p - hi), two mma per step, which keeps P to
//   f32 rounding (tests/test_torch_k3_numerics.py). B is V[token][d] read
//   with ldmatrix.trans.
// - INT8 codes become bf16 operands with no integer-to-float conversion:
//   two lop3 and one bf16x2 subtraction per pair (pie::s8_pair_02/_13),
//   exact, since every int8 is a bf16. ldmatrix hands a lane four bytes of
//   a row; the pairs (byte 0, byte 2) and (byte 1, byte 3) are the
//   operands, so QK's d order within each 16-byte chunk is permuted (q's
//   registers are loaded in the same order), and PV takes the even and odd
//   d columns of a chunk as two n8 tiles. bf16 pages feed the mma directly.
// - Head dim 256 (Gemma-3): a whole page's K and V stage at D 256 is 35 KB
//   (INT8) or 68 KB (bf16), so four warps' double buffers would not fit the
//   227 KB a block may have, and the A fragments of q (64 registers) beside
//   the 128 f32 accumulators of one m16 tile's PV would spill. So at D 256 a
//   stage holds half a page (32 tokens): the walk goes in half-page units
//   (unit u is tokens 32u..32u + 31, the same split and mask rules), with
//   four warps for INT8 pages (149,760 B) and two for bf16 (144,640 B); and
//   q waits in shared memory (16 padded rows, loaded once per block, in the
//   INT8 d order), whence each QK k-step reads its A fragment with ldmatrix.
//   The QK loop runs over k-steps outside and token tiles inside, so each A
//   fragment is read once per unit. At D 64 / 128 nothing changes: a stage
//   is a page and q stays in registers.
// Not done: a TMA page ring, a persistent grid, a cluster (DSMEM) merge of
// the split partials.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using pie::bf16_pair;
using pie::cp_async16;
using pie::cp_async_commit;
using pie::cp_async_wait;
using pie::ldmatrix_x4;
using pie::ldmatrix_x4_trans;
using pie::mma_16816;
using pie::prmt;
using pie::s8_pair_02;
using pie::s8_pair_13;
using pie::smem_u32;

constexpr int kPage = 64;
constexpr int kStages = 2;  // cp.async stages per warp
constexpr float kNegInf = -0.7f * 3.40282346638528859812e+38f;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) { return exp2f(x * kLog2e); }

// Geometry of a block for pages of T at head dim D.
template <typename T, int D>
struct Geo {
  static constexpr bool kQ8 = sizeof(T) == 1;
  static constexpr int kChunks = D * (int)sizeof(T) / 16;  // 16-byte chunks per row
  static constexpr int kRow = D * (int)sizeof(T) + 16;     // padded shared-memory row
  // tokens per stage: a page, or half a page at D 256
  static constexpr int kTok = D == 256 ? kPage / 2 : kPage;
  static constexpr int kUnits = kPage / kTok;  // stages (walk units) per page
  static constexpr int kTile = kTok * kRow;
  static constexpr int kStage = 2 * kTile + 2 * kTok * 4;  // K, V, K and V scales
  // bf16 pages at D 128 / 256 have twice the bytes per stage: two warps
  static constexpr int kWarps = (!kQ8 && D >= 128) ? 2 : 4;
  static constexpr int kThreads = 32 * kWarps;
  // q in shared memory at D 256: 16 rows of D bf16, padded by 16 bytes
  static constexpr bool kQSmem = D == 256;
  static constexpr int kQRow = 2 * D + 16;
  static constexpr int kSmem = kWarps * kStages * kStage + (kQSmem ? 16 * kQRow : 0);
};

// MT: m16 tiles of query heads (rep <= 16 * MT).
template <typename T, int D, int MT>
__global__ void __launch_bounds__(Geo<T, D>::kThreads) paged_attention_kernel(
    const __nv_bfloat16* __restrict__ q,  // [B, Hq, D]
    const T* __restrict__ pool_k,         // [L, Ptot, Hkv, 64, D]
    const T* __restrict__ pool_v,
    const float* __restrict__ k_scale,  // [L, Ptot, Hkv, 64] (INT8 only)
    const float* __restrict__ v_scale,
    const int* __restrict__ tables,    // [B, maxP], -1 pad
    const int* __restrict__ ctx_lens,  // [B]
    __nv_bfloat16* __restrict__ out,   // [B, Hq, D]
    float* __restrict__ ws,            // [B, Hkv, splits, rep, D + 2] when split
    int* __restrict__ counters,        // [B * Hkv], zero between calls
    int hq, int hkv, int ptot, int maxp, int layer, int window, float scale) {
  using G = Geo<T, D>;
  constexpr bool kQ8 = G::kQ8;
  constexpr int kW = G::kWarps;
  constexpr int kTok = G::kTok;
  constexpr int KS = D / 16;    // k16 steps of QK
  constexpr int NO = D / 8;     // n8 tiles of the output
  constexpr int NJ = kTok / 8;  // n8 tiles of a stage's scores
  constexpr int E = kQ8 ? 4 : 2;  // k16 steps per four 16-byte chunks of a row
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int last;

  const int split = blockIdx.x, h = blockIdx.y, bi = blockIdx.z;
  const int splits = gridDim.x;
  const int rep = hq / hkv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  // the walk in units of kTok tokens (a page, or half a page at D 256)
  const int ctx = ctx_lens[bi];
  const int lo = window > 0 ? max(ctx - window, 0) : 0;
  const int u_lo = lo / kTok;
  const int u_hi = min(ctx > 0 ? (ctx + kTok - 1) / kTok : 0, maxp * G::kUnits);
  const int per = (max(u_hi - u_lo, 0) + splits - 1) / splits;
  const int ub = u_lo + split * per;
  const int ue = min(u_hi, ub + per);

  unsigned char* wbuf = smem + warp * kStages * G::kStage;  // this warp's stages

  // q as A fragments: a[0] row g, a[1] row g + 8 (first k pair), a[2], a[3]
  // the second pair. bf16 pages: the k16 step's natural d order. INT8 pages:
  // d 16c + 4t + {0, 2} then {1, 3}, the order the code pairs come in. At
  // D 256 the rows go to shared memory in that order, where ldmatrix gives
  // each lane the same fragments.
  const __nv_bfloat16* qb = q + ((size_t)bi * hq + (size_t)h * rep) * D;
  const unsigned char* qsm = smem + kW * kStages * G::kStage;
  uint32_t qa[MT][G::kQSmem ? 1 : KS][4];
  if constexpr (G::kQSmem) {
    __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem + kW * kStages * G::kStage);
    for (int idx = tid; idx < 16 * D; idx += G::kThreads) {
      const int r = idx / D, col = idx % D, x = col & 15;
      int d = col;
      if constexpr (kQ8)
        d = (col & ~15) + (x < 8 ? 4 * (x >> 1) + 2 * (x & 1) : 4 * ((x - 8) >> 1) + 1 + 2 * (x & 1));
      qs[r * (G::kQRow / 2) + col] = r < rep ? qb[r * D + d] : __float2bfloat16_rn(0.f);
    }
    __syncthreads();
  } else {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = 16 * mt + g + 8 * half;
#pragma unroll
        for (int c = 0; c < KS; ++c) {
          uint32_t x = 0, y = 0;
          if (r < rep) {
            if constexpr (kQ8) {
              const uint2 v = *reinterpret_cast<const uint2*>(qb + r * D + 16 * c + 4 * t);
              x = prmt(v.x, v.y, 0x5410u);
              y = prmt(v.x, v.y, 0x7632u);
            } else {
              x = *reinterpret_cast<const uint32_t*>(qb + r * D + 16 * c + 2 * t);
              y = *reinterpret_cast<const uint32_t*>(qb + r * D + 16 * c + 8 + 2 * t);
            }
          }
          qa[mt][c][half] = x;
          qa[mt][c][2 + half] = y;
        }
      }
  }

  float m[MT][2], l[MT][2], o[MT][NO][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    m[mt][0] = m[mt][1] = kNegInf;
    l[mt][0] = l[mt][1] = 0.f;
#pragma unroll
    for (int n = 0; n < NO; ++n) o[mt][n][0] = o[mt][n][1] = o[mt][n][2] = o[mt][n][3] = 0.f;
  }

  // unit u: tokens kTok * u .. + kTok - 1, of page u / kUnits
  auto issue = [&](int u, int stage) {
    const int tb = tables[(size_t)bi * maxp + u / G::kUnits];
    const size_t tile = ((size_t)layer * ptot + (tb < 0 ? 0 : tb)) * hkv + h;
    const size_t tok0 = tile * kPage + (size_t)(u % G::kUnits) * kTok;
    const unsigned char* gk =
        reinterpret_cast<const unsigned char*>(pool_k) + tok0 * D * sizeof(T);
    const unsigned char* gv =
        reinterpret_cast<const unsigned char*>(pool_v) + tok0 * D * sizeof(T);
    unsigned char* sk = wbuf + stage * G::kStage;
    unsigned char* sv = sk + G::kTile;
#pragma unroll 4
    for (int c = lane; c < kTok * G::kChunks; c += 32) {
      const int off = (c / G::kChunks) * G::kRow + (c % G::kChunks) * 16;
      cp_async16(sk + off, gk + (size_t)c * 16);
      cp_async16(sv + off, gv + (size_t)c * 16);
    }
    if constexpr (kQ8) {  // kTok K scales, kTok V scales: kTok / 4 chunks each
      constexpr int n = kTok / 4;
      if (lane < 2 * n) {
        const float* gs = (lane < n ? k_scale : v_scale) + tok0;
        cp_async16(sv + G::kTile + (lane / n) * kTok * 4 + (lane % n) * 16, gs + (lane % n) * 4);
      }
    }
  };

  // one commit group per unit slot (empty past the last unit), so unit i
  // has landed once all but the newest kStages - 1 groups have
  const int first = ub + warp;
  const int mine = first < ue ? (ue - first + kW - 1) / kW : 0;
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) {
    if (k < mine) issue(first + k * kW, k);
    cp_async_commit();
  }
  for (int i = 0; i < mine; ++i) {
    const int u = first + i * kW;
    if (i + kStages - 1 < mine)  // into the stage of unit i - 1, released below
      issue(u + (kStages - 1) * kW, (i + kStages - 1) % kStages);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncwarp();
    const unsigned char* sk = wbuf + (i % kStages) * G::kStage;
    const uint32_t ka = smem_u32(sk), va = ka + G::kTile;
    const float* sks = reinterpret_cast<const float*>(sk + 2 * G::kTile);
    const float* svs = sks + kTok;

    // scores: tile j holds tokens 8j..8j+7; this lane's are 8j + 2t, +1.
    // The k16 steps of four chunks outside (their A fragments fetched once),
    // the token tiles inside.
    float s[MT][NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) s[mt][j][0] = s[mt][j][1] = s[mt][j][2] = s[mt][j][3] = 0.f;
#pragma unroll
    for (int cq = 0; cq < G::kChunks / 4; ++cq) {
      uint32_t af[MT][E][4];  // A fragments of k16 steps E cq .. E cq + E - 1
#pragma unroll
      for (int e = 0; e < E; ++e)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          if constexpr (G::kQSmem) {
            ldmatrix_x4(af[mt][e], smem_u32(qsm) + (lane & 15) * G::kQRow +
                                       (2 * (E * cq + e) + (lane >> 4)) * 16);
          } else {
#pragma unroll
            for (int r = 0; r < 4; ++r) af[mt][e][r] = qa[mt][E * cq + e][r];
          }
        }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        uint32_t b[4];  // chunks 4cq..4cq+3 of tokens 8j..8j+7
        ldmatrix_x4(b, ka + (8 * j + (lane & 7)) * G::kRow + (4 * cq + (lane >> 3)) * 16);
        if constexpr (kQ8) {  // a 16-byte chunk is one k16 step
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const uint32_t b0 = s8_pair_02(b[e]), b1 = s8_pair_13(b[e]);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) mma_16816(s[mt][j], af[mt][e], b0, b1);
          }
        } else {  // two chunks per k16 step
#pragma unroll
          for (int e = 0; e < 2; ++e)
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
              mma_16816(s[mt][j], af[mt][e], b[2 * e], b[2 * e + 1]);
        }
      }
    }

    // scale, mask, online softmax per row (the quad of a row shares m)
    const int base = u * kTok;
    const bool full = base >= lo && base + kTok <= ctx;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int tok = 8 * j + 2 * t;
      float f0 = scale, f1 = scale;
      if constexpr (kQ8) {
        const float2 ks = *reinterpret_cast<const float2*>(sks + tok);
        f0 *= ks.x;
        f1 *= ks.y;
      }
      const bool ok0 = full || (base + tok >= lo && base + tok < ctx);
      const bool ok1 = full || (base + tok + 1 >= lo && base + tok + 1 < ctx);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        s[mt][j][0] = ok0 ? s[mt][j][0] * f0 : kNegInf;
        s[mt][j][1] = ok1 ? s[mt][j][1] * f1 : kNegInf;
        s[mt][j][2] = ok0 ? s[mt][j][2] * f0 : kNegInf;
        s[mt][j][3] = ok1 ? s[mt][j][3] * f1 : kNegInf;
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float mx = m[mt][half];
#pragma unroll
        for (int j = 0; j < NJ; ++j) mx = fmaxf(mx, fmaxf(s[mt][j][2 * half], s[mt][j][2 * half + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float alpha = ex2(m[mt][half] - mx);
        m[mt][half] = mx;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float e0 = ex2(s[mt][j][2 * half] - mx), e1 = ex2(s[mt][j][2 * half + 1] - mx);
          s[mt][j][2 * half] = e0;
          s[mt][j][2 * half + 1] = e1;
          sum += e0 + e1;
        }
        l[mt][half] = l[mt][half] * alpha + sum;
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          o[mt][n][2 * half] *= alpha;
          o[mt][n][2 * half + 1] *= alpha;
        }
      }

    // PV: step ks takes tokens 16ks..16ks+15, A from score tiles 2ks, 2ks+1
#pragma unroll
    for (int ks = 0; ks < kTok / 16; ++ks) {
      uint32_t ahi[MT][4], alo[MT][4];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int j = 2 * ks + u;
        float v0 = 1.f, v1 = 1.f;
        if constexpr (kQ8) {
          const float2 vs = *reinterpret_cast<const float2*>(svs + 8 * j + 2 * t);
          v0 = vs.x;
          v1 = vs.y;
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            float x0 = s[mt][j][2 * half], x1 = s[mt][j][2 * half + 1];
            if constexpr (kQ8) {
              x0 *= v0;
              x1 *= v1;
            }
            const uint32_t hi = bf16_pair(x0, x1);
            ahi[mt][2 * u + half] = hi;
            alo[mt][2 * u + half] =
                bf16_pair(x0 - __uint_as_float(hi << 16), x1 - __uint_as_float(hi & 0xFFFF0000u));
          }
      }
#pragma unroll
      for (int cq = 0; cq < G::kChunks / 2; ++cq) {
        uint32_t r[4];  // (tokens 0-7, 8-15) x chunks 2cq, 2cq + 1 of the step
        ldmatrix_x4_trans(r, va + (16 * ks + (lane & 15)) * G::kRow + (2 * cq + (lane >> 4)) * 16);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 2 * cq + e;
          if constexpr (kQ8) {  // even and odd d of chunk c: tiles 2c and 2c + 1
            const uint32_t b0e = s8_pair_02(r[2 * e]), b1e = s8_pair_02(r[2 * e + 1]);
            const uint32_t b0o = s8_pair_13(r[2 * e]), b1o = s8_pair_13(r[2 * e + 1]);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              mma_16816(o[mt][2 * c], ahi[mt], b0e, b1e);
              mma_16816(o[mt][2 * c], alo[mt], b0e, b1e);
              mma_16816(o[mt][2 * c + 1], ahi[mt], b0o, b1o);
              mma_16816(o[mt][2 * c + 1], alo[mt], b0o, b1o);
            }
          } else {  // chunk c is tile c
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              mma_16816(o[mt][c], ahi[mt], r[2 * e], r[2 * e + 1]);
              mma_16816(o[mt][c], alo[mt], r[2 * e], r[2 * e + 1]);
            }
          }
        }
      }
    }
    __syncwarp();  // this stage is free for unit i + kStages
  }
  cp_async_wait<0>();  // the empty groups: nothing is in flight below

  // this warp's partial -> its own stage memory: [rep][D + 2] (acc, m, l)
  float* part = reinterpret_cast<float*>(wbuf);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float lq = l[mt][half];
      lq += __shfl_xor_sync(0xffffffffu, lq, 1);
      lq += __shfl_xor_sync(0xffffffffu, lq, 2);
      const int r = 16 * mt + g + 8 * half;
      if (r >= rep) continue;
      float* row = part + r * (D + 2);
#pragma unroll
      for (int n = 0; n < NO; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int d = kQ8 ? 16 * (n >> 1) + 4 * t + (n & 1) + 2 * e : 8 * n + 2 * t + e;
          row[d] = o[mt][n][2 * half + e];
        }
      if (t == 0) {
        row[D] = m[mt][half];
        row[D + 1] = lq;
      }
    }
  __syncthreads();

  // merge the warps in order; one block of the (lane, head): the output,
  // else this block's partial to the workspace
  __nv_bfloat16* ob = out + ((size_t)bi * hq + (size_t)h * rep) * D;
  const size_t unit = (size_t)rep * (D + 2);
  float* wsb = ws + ((size_t)(bi * hkv + h) * splits + split) * unit;
  for (int idx = tid; idx < rep * D; idx += G::kThreads) {
    const int r = idx / D, d = idx % D;
    float mm = kNegInf;
#pragma unroll
    for (int w = 0; w < kW; ++w)
      mm = fmaxf(mm, reinterpret_cast<const float*>(smem + w * kStages * G::kStage)[r * (D + 2) + D]);
    float ll = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kW; ++w) {
      const float* e = reinterpret_cast<const float*>(smem + w * kStages * G::kStage) + r * (D + 2);
      const float wt = expf(e[D] - mm);
      ll = fmaf(e[D + 1], wt, ll);
      a = fmaf(e[d], wt, a);
    }
    if (splits == 1) {
      ob[r * D + d] = __float2bfloat16_rn(a / fmaxf(ll, 1e-30f));
    } else {
      wsb[r * (D + 2) + d] = a;
      if (d == 0) {
        wsb[r * (D + 2) + D] = mm;
        wsb[r * (D + 2) + D + 1] = ll;
      }
    }
  }
  if (splits == 1) return;

  // the last block of the (lane, head) to arrive merges the splits in order
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int slot = bi * hkv + h;
    last = atomicAdd(&counters[slot], 1) == splits - 1;
    if (last) counters[slot] = 0;  // ready for the next call
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const float* wl = ws + (size_t)(bi * hkv + h) * splits * unit;
  for (int idx = tid; idx < rep * D; idx += G::kThreads) {
    const int r = idx / D, d = idx % D;
    float mm = kNegInf;
    for (int s = 0; s < splits; ++s) mm = fmaxf(mm, __ldcg(wl + s * unit + r * (D + 2) + D));
    float ll = 0.f, a = 0.f;
    for (int s = 0; s < splits; ++s) {
      const float* e = wl + s * unit + r * (D + 2);
      const float w = expf(__ldcg(e + D) - mm);
      ll = fmaf(__ldcg(e + D + 1), w, ll);
      a = fmaf(__ldcg(e + d), w, a);
    }
    ob[r * D + d] = __float2bfloat16_rn(a / fmaxf(ll, 1e-30f));
  }
}

// Allows the kernel its dynamic shared memory (once per instantiation).
template <typename T, int D, int MT>
cudaError_t prepare() {
  static bool done = false;
  if (!done) {
    const cudaError_t e =
        cudaFuncSetAttribute(paged_attention_kernel<T, D, MT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, Geo<T, D>::kSmem);
    if (e != cudaSuccess) return e;
    done = true;
  }
  return cudaSuccess;
}

template <typename T, int D, int MT>
cudaError_t launch(const void* q, const void* pool_k, const void* pool_v,
                   const void* k_scale, const void* v_scale, const void* tables,
                   const void* ctx_lens, void* out, void* ws, void* counters, int B,
                   int hq, int hkv, int ptot, int maxp, int layer, int window,
                   float scale, int splits, cudaStream_t stream) {
  using G = Geo<T, D>;
  const cudaError_t e = prepare<T, D, MT>();
  if (e != cudaSuccess) return e;
  const dim3 grid(splits, hkv, B);
  paged_attention_kernel<T, D, MT><<<grid, G::kThreads, G::kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const T*>(pool_k),
      static_cast<const T*>(pool_v), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(tables),
      static_cast<const int*>(ctx_lens), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(ws), static_cast<int*>(counters), hq, hkv, ptot, maxp,
      layer, window, scale);
  return cudaGetLastError();
}

// geo = {warps per block, cp.async stages per warp, resident blocks per SM}
template <typename T, int D, int MT>
cudaError_t geometry(int* geo) {
  using G = Geo<T, D>;
  cudaError_t e = prepare<T, D, MT>();
  if (e != cudaSuccess) return e;
  geo[0] = G::kWarps;
  geo[1] = kStages;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &geo[2], paged_attention_kernel<T, D, MT>, G::kThreads, G::kSmem);
}

// MT for rep query heads per kv head: one m16 tile up to 16, two up to 32
// at D 64; 0 for what K3 does not take
template <int D>
constexpr int tiles_for(int rep) {
  return rep <= 16 ? 1 : (D == 64 && rep <= 32 ? 2 : 0);
}

template <typename T, int D>
cudaError_t dispatch(int rep, const void* q, const void* pool_k, const void* pool_v,
                     const void* k_scale, const void* v_scale, const void* tables,
                     const void* ctx_lens, void* out, void* ws, void* counters, int B,
                     int hq, int hkv, int ptot, int maxp, int layer, int window,
                     float scale, int splits, cudaStream_t st) {
  if (tiles_for<D>(rep) == 1)
    return launch<T, D, 1>(q, pool_k, pool_v, k_scale, v_scale, tables, ctx_lens, out, ws,
                           counters, B, hq, hkv, ptot, maxp, layer, window, scale, splits, st);
  if constexpr (D == 64)
    if (tiles_for<D>(rep) == 2)
      return launch<T, D, 2>(q, pool_k, pool_v, k_scale, v_scale, tables, ctx_lens, out, ws,
                             counters, B, hq, hkv, ptot, maxp, layer, window, scale, splits,
                             st);
  return cudaErrorInvalidValue;
}

template <typename T, int D>
cudaError_t dispatch_geometry(int rep, int* geo) {
  if (tiles_for<D>(rep) == 1) return geometry<T, D, 1>(geo);
  if constexpr (D == 64)
    if (tiles_for<D>(rep) == 2) return geometry<T, D, 2>(geo);
  return cudaErrorInvalidValue;
}

}  // namespace

// out[B, Hq, D] = paged decode attention of q over layer `layer` of the pool
// (semantics at the top of this file), the page walk of each (lane, kv head)
// split over `splits` blocks (ws: [B * Hkv * splits, rep, D + 2] f32 scratch
// and counters: one zeroed int per (lane, kv head), both needed only when
// splits > 1). Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for arguments the kernel does not take).
extern "C" int pie_paged_attention(const void* q, const void* pool_k,
                                   const void* pool_v, const void* k_scale,
                                   const void* v_scale, const void* tables,
                                   const void* ctx_lens, void* out, void* ws,
                                   void* counters, int B, int hq, int hkv, int d,
                                   int ptot, int maxp, int layer, int quantized,
                                   int window, float scale, int splits,
                                   void* stream) {
  if (B < 1 || hkv < 1 || hq < hkv || hq % hkv != 0 || ptot < 1 || maxp < 1 ||
      layer < 0 || splits < 1 ||
      (splits > 1 && (ws == nullptr || counters == nullptr)) ||
      (quantized && (k_scale == nullptr || v_scale == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rep = hq / hkv;
#define PIE_K3_ARGS                                                              \
  rep, q, pool_k, pool_v, k_scale, v_scale, tables, ctx_lens, out, ws, counters, \
      B, hq, hkv, ptot, maxp, layer, window, scale, splits, st
  if (d == 256)
    return quantized ? (int)dispatch<int8_t, 256>(PIE_K3_ARGS)
                     : (int)dispatch<__nv_bfloat16, 256>(PIE_K3_ARGS);
  if (d == 128)
    return quantized ? (int)dispatch<int8_t, 128>(PIE_K3_ARGS)
                     : (int)dispatch<__nv_bfloat16, 128>(PIE_K3_ARGS);
  if (d == 64)
    return quantized ? (int)dispatch<int8_t, 64>(PIE_K3_ARGS)
                     : (int)dispatch<__nv_bfloat16, 64>(PIE_K3_ARGS);
#undef PIE_K3_ARGS
  return (int)cudaErrorInvalidValue;
}

// geo[3] = {warps per block, cp.async stages per warp, blocks resident per
// SM} of the kernel pie_paged_attention launches for these arguments.
extern "C" int pie_paged_attention_geometry(int d, int quantized, int rep, int* geo) {
  if (d == 256)
    return quantized ? (int)dispatch_geometry<int8_t, 256>(rep, geo)
                     : (int)dispatch_geometry<__nv_bfloat16, 256>(rep, geo);
  if (d == 128)
    return quantized ? (int)dispatch_geometry<int8_t, 128>(rep, geo)
                     : (int)dispatch_geometry<__nv_bfloat16, 128>(rep, geo);
  if (d == 64)
    return quantized ? (int)dispatch_geometry<int8_t, 64>(rep, geo)
                     : (int)dispatch_geometry<__nv_bfloat16, 64>(rep, geo);
  return (int)cudaErrorInvalidValue;
}
