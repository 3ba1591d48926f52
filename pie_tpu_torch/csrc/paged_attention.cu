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
// - Head dim 256 (Gemma-3) has a kernel of its own, paged_attention_d256
//   below: a block-wide TMA page ring, each page's tokens dealt to the
//   warps in 16-token slices, and the query heads on the n side of the mma.
// Not done here: a TMA page ring, a persistent grid, a cluster (DSMEM)
// merge of the split partials.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using pie::bf16_pair;
using pie::bulk_load;
using pie::cp_async16;
using pie::cp_async_commit;
using pie::cp_async_wait;
using pie::encode_2d;
using pie::ldmatrix_x4;
using pie::ldmatrix_x4_trans;
using pie::mbar_arrive;
using pie::mbar_expect_tx;
using pie::mbar_init;
using pie::mbar_wait;
using pie::mma_16816;
using pie::movmatrix_trans;
using pie::prmt;
using pie::s8_pair_02;
using pie::s8_pair_13;
using pie::smem_u32;
using pie::tma_load_2d;

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
  static constexpr int kTile = kPage * kRow;
  static constexpr int kStage = 2 * kTile + 2 * kPage * 4;  // K, V, K and V scales
  // bf16 pages at D 128 have twice the bytes per stage: two warps
  static constexpr int kWarps = (!kQ8 && D == 128) ? 2 : 4;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kSmem = kWarps * kStages * kStage;
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
  constexpr int KS = D / 16;       // k16 steps of QK
  constexpr int NO = D / 8;        // n8 tiles of the output
  constexpr int NJ = kPage / 8;    // n8 tiles of a page's scores
  constexpr int E = kQ8 ? 4 : 2;  // k16 steps per four 16-byte chunks of a row
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int last;

  const int split = blockIdx.x, h = blockIdx.y, bi = blockIdx.z;
  const int splits = gridDim.x;
  const int rep = hq / hkv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  const int ctx = ctx_lens[bi];
  const int lo = window > 0 ? max(ctx - window, 0) : 0;
  const int p_lo = lo / kPage;
  const int p_hi = min(ctx > 0 ? (ctx + kPage - 1) / kPage : 0, maxp);
  const int per = (max(p_hi - p_lo, 0) + splits - 1) / splits;
  const int pb = p_lo + split * per;
  const int pe = min(p_hi, pb + per);

  unsigned char* wbuf = smem + warp * kStages * G::kStage;  // this warp's stages

  // q as A fragments: a[0] row g, a[1] row g + 8 (first k pair), a[2], a[3]
  // the second pair. bf16 pages: the k16 step's natural d order. INT8 pages:
  // d 16c + 4t + {0, 2} then {1, 3}, the order the code pairs come in.
  const __nv_bfloat16* qb = q + ((size_t)bi * hq + (size_t)h * rep) * D;
  uint32_t qa[MT][KS][4];
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

  float m[MT][2], l[MT][2], o[MT][NO][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    m[mt][0] = m[mt][1] = kNegInf;
    l[mt][0] = l[mt][1] = 0.f;
#pragma unroll
    for (int n = 0; n < NO; ++n) o[mt][n][0] = o[mt][n][1] = o[mt][n][2] = o[mt][n][3] = 0.f;
  }

  auto issue = [&](int p, int stage) {
    const int tb = tables[(size_t)bi * maxp + p];
    const size_t tile = ((size_t)layer * ptot + (tb < 0 ? 0 : tb)) * hkv + h;
    const unsigned char* gk =
        reinterpret_cast<const unsigned char*>(pool_k) + tile * kPage * D * sizeof(T);
    const unsigned char* gv =
        reinterpret_cast<const unsigned char*>(pool_v) + tile * kPage * D * sizeof(T);
    unsigned char* sk = wbuf + stage * G::kStage;
    unsigned char* sv = sk + G::kTile;
#pragma unroll 4
    for (int c = lane; c < kPage * G::kChunks; c += 32) {
      const int off = (c / G::kChunks) * G::kRow + (c % G::kChunks) * 16;
      cp_async16(sk + off, gk + (size_t)c * 16);
      cp_async16(sv + off, gv + (size_t)c * 16);
    }
    if constexpr (kQ8) {  // 64 K scales, 64 V scales: 16 chunks each
      const float* gs = (lane < 16 ? k_scale : v_scale) + tile * kPage;
      cp_async16(sv + G::kTile + (lane >> 4) * kPage * 4 + (lane & 15) * 16,
                 gs + (lane & 15) * 4);
    }
  };

  // one commit group per page slot (empty past the last page), so page i
  // has landed once all but the newest kStages - 1 groups have
  const int first = pb + warp;
  const int mine = first < pe ? (pe - first + kW - 1) / kW : 0;
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) {
    if (k < mine) issue(first + k * kW, k);
    cp_async_commit();
  }
  for (int i = 0; i < mine; ++i) {
    const int p = first + i * kW;
    if (i + kStages - 1 < mine)  // into the stage of page i - 1, released below
      issue(p + (kStages - 1) * kW, (i + kStages - 1) % kStages);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncwarp();
    const unsigned char* sk = wbuf + (i % kStages) * G::kStage;
    const uint32_t ka = smem_u32(sk), va = ka + G::kTile;
    const float* sks = reinterpret_cast<const float*>(sk + 2 * G::kTile);
    const float* svs = sks + kPage;

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
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int r = 0; r < 4; ++r) af[mt][e][r] = qa[mt][E * cq + e][r];
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
    const int base = p * kPage;
    const bool full = base >= lo && base + kPage <= ctx;
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
    for (int ks = 0; ks < kPage / 16; ++ks) {
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
    __syncwarp();  // this stage is free for page i + kStages
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

// geo[3], geo[4] = registers a thread and local (spill) bytes a thread
template <typename K>
cudaError_t attributes(K* kernel, int* geo) {
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, kernel);
  if (e != cudaSuccess) return e;
  geo[3] = a.numRegs;
  geo[4] = (int)a.localSizeBytes;
  return cudaSuccess;
}

// geo = {warps per block, cp.async stages per warp, resident blocks per SM,
// registers a thread, local bytes a thread}
template <typename T, int D, int MT>
cudaError_t geometry(int* geo) {
  using G = Geo<T, D>;
  cudaError_t e = prepare<T, D, MT>();
  if (e != cudaSuccess) return e;
  geo[0] = G::kWarps;
  geo[1] = kStages;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &geo[2], paged_attention_kernel<T, D, MT>, G::kThreads, G::kSmem);
  if (e != cudaSuccess) return e;
  return attributes(paged_attention_kernel<T, D, MT>, geo);
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

// -- B8: head dim 256 ---------------------------------------------------------
//
// Gemma-3's heads (D 256, 1-16 query heads a kv head; rep 2 at 4B, 12B and
// 27B, 4 at 1B). Same contract and bound as above; at the 4B heads, 8
// lanes x 2,048 tokens, a call walks 17.0 MB (window 1,024) or 34.1 MB, 5.1
// or 10.2 us at 3.35 TB/s. A page-head is 33 KB of INT8 K, V and scales
// (64 KB bf16), so per-warp double buffers keep little of it in flight, and
// a call's time beside its bytes is fixed cost: the launch, the block's
// prologue, the first page's latency and the merges (measured on the H100
// with tools/k3_sweep.py: PERF.md). Here:
// - A block-wide ring of whole pages in shared memory, fed by TMA: one
//   thread of a producer warp issues each page's copies (per 128 bytes of
//   a K or V row one 2-D tensor copy of [64 tokens, 128 bytes] with the
//   128-byte swizzle, plus one 1-D bulk copy per 64 INT8 scales) on the
//   stage's full mbarrier: the ring's pages at block start, the next as
//   soon as the consumers release a stage (its empty mbarrier). The ring
//   holds kRingStages pages, three of bf16 (what 227 KB hold): one block
//   an SM, and page_splits gives one wave of blocks, so a windowed call has
//   every page of a block in flight from its start. Fewer, larger blocks
//   beat two blocks an SM: each split adds a partial to merge. The swizzle
//   puts the 16-byte chunk c of token row r at c ^ (r % 8) of its 128-byte
//   row, so ldmatrix over 8 tokens hits 8 distinct bank groups (a 1-D copy
//   of the 256-byte rows would put all 8 on the same 4 banks). The producer
//   warp reads the first 128 entries of the lane's table row while
//   ctx_lens is in flight, so the first copy waits on one load, not two.
// - The consumer warps split each page by 16-token slices: slice k of the
//   block's walk goes to warp k % kConsumerWarps, which keeps its own
//   online-softmax state (the warps' (acc, m, l) merge after the walk, as
//   above). A warp's work per slice is independent of the other warps', so
//   the loop has no block barrier. With more consumer warps than slices a
//   page, each ring slot must serve one group of warps (Ring::kReaders).
// - Query heads on the n side of the mma ("swap AB"): S^T = K q^T with a
//   16-token K tile as A (ldmatrix; INT8 codes made exact bf16 with two lop3
//   and a bf16x2 subtraction, in the permuted d order of the kernel above)
//   and the heads as the n8 columns (two n8 tiles above 8 heads), q^T in
//   registers, the even and odd k16 steps in two accumulators; O^T +=
//   V^T P^T with V^T read by ldmatrix.trans as A (INT8: a tile's rows g and
//   g + 8 are the even and odd d of one 16-byte chunk) and P^T as B. The
//   scores' C fragment holds (token, head) pairs; times v_scale[token],
//   rounded as bf16 hi + lo, and transposed across the warp by movmatrix it
//   is the B fragment of PV, so P never leaves registers. Per 16 tokens: 16
//   QK and 2 x 16 PV mma (48), against 96 with the heads as m16 rows; a
//   thread holds 64 f32 accumulators (128 above 8 heads).
// - After the walk (one __syncthreads: the ring is free) the warps'
//   partials go to the ring's memory and merge in warp order into the
//   workspace; the last block of a (lane, head) to arrive merges the
//   splits in split order, four outputs a thread with the loads of up to
//   eight splits in flight at once (one round of loads). A cluster of the
//   splits merging through distributed shared memory was slower on the
//   H100: the cluster launch cost more than the workspace round trip.

constexpr int kD256 = 256;
constexpr int kRingStages = 4;     // ring stages a block (pages), as many as fit
constexpr int kConsumerWarps = 4;  // consumer warps a block (and one producer warp)
constexpr int kRingThreads = 32 * (kConsumerWarps + 1);

// A stage is one page (64 tokens) of K and V (and their INT8 scales).
template <typename T>
struct Ring {
  static constexpr bool kQ8 = sizeof(T) == 1;
  static constexpr int kSlices = kPage / 16;  // 16-token slices a stage
  static constexpr int kRowBytes = kD256 * (int)sizeof(T);
  static constexpr int kChunks = kRowBytes / 16;  // 16-byte chunks a token row
  static constexpr int kBox = kPage * 128;        // one [64 tokens, 128 B] tensor copy
  static constexpr int kTile = (kRowBytes / 128) * kBox;                // K (or V) of a page
  static constexpr int kBytes = 2 * kTile + (kQ8 ? 2 * kPage * 4 : 0);  // what lands a stage
  static constexpr int kStage = (kBytes + 1023) / 1024 * 1024;  // 1,024-aligned (swizzle)
  // kRingStages pages, or as many as fit a block's 227 KB (three of bf16)
  static constexpr int kFit = (232448 - 2048) / kStage;
  static constexpr int kStages = kRingStages < kFit ? kRingStages : kFit;
  // consumer warps that read each stage (the count of its empty mbarrier);
  // more consumer warps than slices form groups that take whole stages in
  // turn, and each ring slot must then always serve one group, which waits
  // on its mbarrier's phases in order (a parity wait cannot tell phase p
  // from p + 2)
  static constexpr int kReaders = kConsumerWarps < kSlices ? kConsumerWarps : kSlices;
  static_assert(kStages % (kConsumerWarps / kReaders) == 0,
                "each ring slot must serve one group of consumer warps");
  // the ring, or the warps' partials at 16 heads if larger, + alignment slack
  static constexpr int kPartials = kConsumerWarps * 16 * (kD256 + 2) * 4;
  static constexpr int kSmem =
      (kStages * kStage > kPartials ? kStages * kStage : kPartials) + 1024;
};

// NT: n8 tiles of query heads (rep <= 8 NT)
template <typename T, int NT>
__global__ void __launch_bounds__(kRingThreads, (NT == 1 && kConsumerWarps <= 4) ? 2 : 1)
    paged_attention_d256(
        const __grid_constant__ CUtensorMap map_k,  // the layer's K as [P Hkv 64, 256]
        const __grid_constant__ CUtensorMap map_v,
        const __nv_bfloat16* __restrict__ q,  // [B, Hq, 256]
        const float* __restrict__ k_scale,    // the layer's [P, Hkv, 64] (INT8 only)
        const float* __restrict__ v_scale, const int* __restrict__ tables,
        const int* __restrict__ ctx_lens, __nv_bfloat16* __restrict__ out,
        float* __restrict__ ws, int* __restrict__ counters, int hq, int hkv, int maxp,
        int window, float scale) {
  using R = Ring<T>;
  constexpr bool kQ8 = R::kQ8;
  constexpr int D = kD256;
  constexpr int MT = D / 16;  // m16 tiles of O^T: 16 d each
  constexpr int kW = kConsumerWarps;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * kRingStages];
  __shared__ int last;
  const uint32_t raw0 = smem_u32(smem_raw);
  const uint32_t ring0 = (raw0 + 1023u) & ~1023u;
  unsigned char* ring = smem_raw + (ring0 - raw0);
  const uint32_t full0 = smem_u32(bars), empty0 = full0 + 8 * R::kStages;

  const int split = blockIdx.x, h = blockIdx.y, bi = blockIdx.z;
  const int splits = gridDim.x;
  const int rep = hq / hkv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  // the producer warp reads the lane's table entries lane + 32k (k < 4) of
  // the row while ctx_lens[bi] is in flight
  int row4[4] = {0, 0, 0, 0};
  if (warp == kW) {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (lane + 32 * k < maxp) row4[k] = tables[(size_t)bi * maxp + lane + 32 * k];
  }
  // the walk in pages
  const int ctx = ctx_lens[bi];
  const int lo = window > 0 ? max(ctx - window, 0) : 0;
  const int p_lo = lo / kPage;
  const int p_hi = min(ctx > 0 ? (ctx + kPage - 1) / kPage : 0, maxp);
  const int per = (max(p_hi - p_lo, 0) + splits - 1) / splits;
  const int pb = p_lo + split * per;
  const int n = max(min(p_hi, pb + per) - pb, 0);  // pages this block walks

  if (tid == 0) {
    for (int s = 0; s < R::kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, R::kReaders);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  float m[NT][2], l[NT][2], o[MT][NT][4];  // m, l of heads 2t + 8nt, + 1
  if (warp == kW) {
    // the producer warp: each lane takes one page's table entry (from the
    // lanes' first 128, or read now), lane 0 issues the copies in order
    for (int i0 = 0; i0 < n; i0 += 32) {
      const int p = pb + i0 + lane;
      int tb = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int v = __shfl_sync(0xffffffffu, row4[k], p & 31);
        if (p >> 5 == k) tb = v;
      }
      if (i0 + lane >= n) tb = 0;
      else if (p >= 128) tb = tables[(size_t)bi * maxp + p];
      tb = max(tb, 0);
      for (int k = 0; k < min(32, n - i0); ++k) {
        const int page = __shfl_sync(0xffffffffu, tb, k);
        const int i = i0 + k, s = i % R::kStages;
        if (lane == 0) {
          if (i >= R::kStages) mbar_wait(empty0 + 8 * s, (uint32_t)((i / R::kStages - 1) & 1));
          const uint32_t bar = full0 + 8 * s, dst = ring0 + s * R::kStage;
          const int row = (page * hkv + h) * kPage;
          mbar_expect_tx(bar, R::kBytes);
#pragma unroll
          for (int b = 0; b < R::kRowBytes / 128; ++b) {
            const int col = b * 128 / (int)sizeof(T);
            tma_load_2d(dst + b * R::kBox, &map_k, bar, col, row);
            tma_load_2d(dst + R::kTile + b * R::kBox, &map_v, bar, col, row);
          }
          if constexpr (kQ8) {
            bulk_load(dst + 2 * R::kTile, k_scale + row, kPage * 4, bar);
            bulk_load(dst + 2 * R::kTile + kPage * 4, v_scale + row, kPage * 4, bar);
          }
        }
      }
    }
  } else {
    // q^T as B fragments: qf[nt][c][0] = q[head 8nt + g][k 2t, 2t + 1 of
    // k16 step c], [1] = k 2t + 8, 2t + 9; d order as in the kernel above
    const __nv_bfloat16* qb = q + ((size_t)bi * hq + (size_t)h * rep) * D;
    uint32_t qf[NT][D / 16][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int r = 8 * nt + g;
#pragma unroll
      for (int c = 0; c < D / 16; ++c) {
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
        qf[nt][c][0] = x;
        qf[nt][c][1] = y;
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      m[nt][0] = m[nt][1] = kNegInf;
      l[nt][0] = l[nt][1] = 0.f;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) o[mt][nt][0] = o[mt][nt][1] = o[mt][nt][2] = o[mt][nt][3] = 0.f;
    }

    // this lane's ldmatrix row: token (lane & 15) of the slice, chunk
    // 2cp + (lane >> 4), at its swizzled place (the row's token % 8 = lane % 8)
    const int xr = lane & 7, hi = lane >> 4;
    const int total = n * R::kSlices;
    for (int gs = warp; gs < total; gs += kW) {
      const int i = gs / R::kSlices, j = gs % R::kSlices, s = i % R::kStages;
      mbar_wait(full0 + 8 * s, (uint32_t)((i / R::kStages) & 1));
      const uint32_t kb = ring0 + s * R::kStage + (16 * j + (lane & 15)) * 128;
      const uint32_t vb = kb + R::kTile;
      const float* ksc = reinterpret_cast<const float*>(ring + s * R::kStage + 2 * R::kTile);
      const float* vsc = ksc + kPage;

      // S^T = K q^T: this lane's scores are tokens g, g + 8 of the slice
      // (c[0..1], c[2..3]) for heads 2t + 8nt, + 1; even and odd k16 steps
      // go to two accumulators (two dependent mma chains of 8, not one of 16)
      float sc[NT][4], s2[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int x = 0; x < 4; ++x) sc[nt][x] = s2[nt][x] = 0.f;
#pragma unroll
      for (int cp = 0; cp < R::kChunks / 2; ++cp) {
        const int c = 2 * cp + hi;
        uint32_t r[4];  // tokens 0-7, 8-15 of chunk 2cp, then of chunk 2cp + 1
        ldmatrix_x4(r, kb + (c >> 3) * R::kBox + (((c & 7) ^ xr) << 4));
        if constexpr (kQ8) {  // a chunk is one k16 step
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const uint32_t a[4] = {s8_pair_02(r[2 * e]), s8_pair_02(r[2 * e + 1]),
                                   s8_pair_13(r[2 * e]), s8_pair_13(r[2 * e + 1])};
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
              mma_16816(e ? s2[nt] : sc[nt], a, qf[nt][2 * cp + e][0], qf[nt][2 * cp + e][1]);
          }
        } else {  // two chunks a k16 step
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
            mma_16816((cp & 1) ? s2[nt] : sc[nt], r, qf[nt][cp][0], qf[nt][cp][1]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int x = 0; x < 4; ++x) sc[nt][x] += s2[nt][x];

      // scale, mask, online softmax per head over the slice's 16 tokens
      const int p0 = (pb + i) * kPage + 16 * j + g, p1 = p0 + 8;
      float f0 = scale, f1 = scale, v0 = 1.f, v1 = 1.f;
      if constexpr (kQ8) {
        f0 *= ksc[16 * j + g];
        f1 *= ksc[16 * j + g + 8];
        v0 = vsc[16 * j + g];
        v1 = vsc[16 * j + g + 8];
      }
      const bool ok0 = p0 >= lo && p0 < ctx, ok1 = p1 >= lo && p1 < ctx;
      uint32_t bh[NT][2], bl[NT][2];  // P's B fragments: tokens 0-7, 8-15
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float s0 = ok0 ? sc[nt][e] * f0 : kNegInf;
          const float s1 = ok1 ? sc[nt][2 + e] * f1 : kNegInf;
          float mx = fmaxf(m[nt][e], fmaxf(s0, s1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
          const float alpha = ex2(m[nt][e] - mx);
          m[nt][e] = mx;
          sc[nt][e] = ex2(s0 - mx);
          sc[nt][2 + e] = ex2(s1 - mx);
          l[nt][e] = l[nt][e] * alpha + (sc[nt][e] + sc[nt][2 + e]);  // this lane's tokens
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            o[mt][nt][e] *= alpha;
            o[mt][nt][2 + e] *= alpha;
          }
        }
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float x0 = sc[nt][2 * half], x1 = sc[nt][2 * half + 1];
          if constexpr (kQ8) {
            x0 *= half ? v1 : v0;
            x1 *= half ? v1 : v0;
          }
          const uint32_t ph = bf16_pair(x0, x1);
          const uint32_t pl =
              bf16_pair(x0 - __uint_as_float(ph << 16), x1 - __uint_as_float(ph & 0xFFFF0000u));
          bh[nt][half] = movmatrix_trans(ph);
          bl[nt][half] = movmatrix_trans(pl);
        }
      }

      // O^T += V^T P^T over the slice's 16 tokens
#pragma unroll
      for (int cp = 0; cp < R::kChunks / 2; ++cp) {
        const int c = 2 * cp + hi;
        uint32_t r[4];
        ldmatrix_x4_trans(r, vb + (c >> 3) * R::kBox + (((c & 7) ^ xr) << 4));
        if constexpr (kQ8) {  // tile c: rows g, g + 8 are d 16c + 2g, + 1
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const uint32_t a[4] = {s8_pair_02(r[2 * e]), s8_pair_13(r[2 * e]),
                                   s8_pair_02(r[2 * e + 1]), s8_pair_13(r[2 * e + 1])};
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
              mma_16816(o[2 * cp + e][nt], a, bh[nt][0], bh[nt][1]);
              mma_16816(o[2 * cp + e][nt], a, bl[nt][0], bl[nt][1]);
            }
          }
        } else {  // tile cp: rows g, g + 8 are d 16cp + g, + 8
          const uint32_t a[4] = {r[0], r[2], r[1], r[3]};
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            mma_16816(o[cp][nt], a, bh[nt][0], bh[nt][1]);
            mma_16816(o[cp][nt], a, bl[nt][0], bl[nt][1]);
          }
        }
      }

      // this warp's last slice of the stage releases it
      if (gs + kW >= total || (gs + kW) / R::kSlices != i) {
        __syncwarp();
        if (lane == 0) mbar_arrive(empty0 + 8 * s);
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        l[nt][e] += __shfl_xor_sync(0xffffffffu, l[nt][e], 4);
        l[nt][e] += __shfl_xor_sync(0xffffffffu, l[nt][e], 8);
        l[nt][e] += __shfl_xor_sync(0xffffffffu, l[nt][e], 16);
      }
  }
  __syncthreads();  // every stage consumed: the ring is free

  // each consumer warp's partial -> [warp][rep][D + 2] (acc, m, l)
  float* part = reinterpret_cast<float*>(ring);
  const size_t unit = (size_t)rep * (D + 2);
  if (warp < kW) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = 8 * nt + 2 * t + e;
        if (r >= rep) continue;
        float* row = part + warp * unit + r * (D + 2);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int half = 0; half < 2; ++half)
            row[kQ8 ? 16 * mt + 2 * g + half : 16 * mt + 8 * half + g] = o[mt][nt][2 * half + e];
        if (g == 0) {
          row[D] = m[nt][e];
          row[D + 1] = l[nt][e];
        }
      }
  }
  __syncthreads();

  // merge the warps in order: the output when the walk is not split, else
  // this block's partial to the workspace, [rep][D] acc then [rep] (m, l),
  // a block of rep (D + 2) floats rounded up to 4 (16-byte rows)
  __nv_bfloat16* ob = out + ((size_t)bi * hq + (size_t)h * rep) * D;
  const size_t wunit = ((size_t)rep * (D + 2) + 3) & ~(size_t)3;
  float* wsb = ws + ((size_t)(bi * hkv + h) * splits + split) * wunit;
  for (int idx = tid; idx < rep * D; idx += kRingThreads) {
    const int r = idx / D, d = idx % D;
    float mm = kNegInf;
#pragma unroll
    for (int w = 0; w < kW; ++w) mm = fmaxf(mm, part[w * unit + r * (D + 2) + D]);
    float ll = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kW; ++w) {
      const float* e = part + w * unit + r * (D + 2);
      const float wt = expf(e[D] - mm);
      ll = fmaf(e[D + 1], wt, ll);
      a = fmaf(e[d], wt, a);
    }
    if (splits == 1) {
      ob[r * D + d] = __float2bfloat16_rn(a / fmaxf(ll, 1e-30f));
    } else {
      wsb[r * D + d] = a;
      if (d == 0) {
        wsb[rep * D + 2 * r] = mm;
        wsb[rep * D + 2 * r + 1] = ll;
      }
    }
  }
  if (splits == 1) return;

  // the last block of the (lane, head) to arrive merges the splits in
  // order, w_s = exp(m_s - max m); a thread takes four outputs of a row and
  // keeps the loads of kBatch splits in flight at once. One thread fences
  // the block's workspace writes (ordered before it by the barrier) and
  // counts the arrival, as a cooperative grid barrier does.
  __syncthreads();
  if (tid == 0) {
    const int slot = bi * hkv + h;
    __threadfence();
    last = atomicAdd(&counters[slot], 1) == splits - 1;
    if (last) counters[slot] = 0;  // ready for the next call
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  constexpr int kBatch = 8;
  const float* wl = ws + (size_t)(bi * hkv + h) * splits * wunit;
  for (int q4 = tid; q4 < rep * D / 4; q4 += kRingThreads) {
    const int r = q4 / (D / 4), d = 4 * (q4 % (D / 4));
    const float* mlr = wl + rep * D + 2 * r;  // split s: mlr + s wunit
    float2 mlb[kBatch];  // (m, l) and the four accumulators of kBatch splits
    float4 ab[kBatch];
    auto load = [&](int s0) {
#pragma unroll
      for (int k = 0; k < kBatch; ++k)
        if (s0 + k < splits) {
          mlb[k] = __ldcg(reinterpret_cast<const float2*>(mlr + (s0 + k) * wunit));
          ab[k] = __ldcg(reinterpret_cast<const float4*>(wl + (s0 + k) * wunit + r * D + d));
        }
    };
    load(0);
    float mm = kNegInf;
    if (splits <= kBatch) {  // one round of loads
#pragma unroll
      for (int k = 0; k < kBatch; ++k)
        if (k < splits) mm = fmaxf(mm, mlb[k].x);
    } else {
      for (int s0 = 0; s0 < splits; s0 += kBatch) {
        float mb[kBatch];
#pragma unroll
        for (int k = 0; k < kBatch; ++k)
          mb[k] = s0 + k < splits ? __ldcg(mlr + (s0 + k) * wunit) : kNegInf;
#pragma unroll
        for (int k = 0; k < kBatch; ++k) mm = fmaxf(mm, mb[k]);
      }
    }
    float ll = 0.f;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s0 = 0; s0 < splits; s0 += kBatch) {
      if (s0 > 0) load(s0);
#pragma unroll
      for (int k = 0; k < kBatch; ++k)
        if (s0 + k < splits) {
          const float w = expf(mlb[k].x - mm);
          ll = fmaf(mlb[k].y, w, ll);
          a.x = fmaf(ab[k].x, w, a.x);
          a.y = fmaf(ab[k].y, w, a.y);
          a.z = fmaf(ab[k].z, w, a.z);
          a.w = fmaf(ab[k].w, w, a.w);
        }
    }
    const float den = fmaxf(ll, 1e-30f);
    *reinterpret_cast<uint2*>(ob + r * D + d) =
        make_uint2(bf16_pair(a.x / den, a.y / den), bf16_pair(a.z / den, a.w / den));
  }
}

template <typename T, int NT>
cudaError_t prepare_d256() {
  static bool done = false;
  if (!done) {
    const cudaError_t e =
        cudaFuncSetAttribute(paged_attention_d256<T, NT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, Ring<T>::kSmem);
    if (e != cudaSuccess) return e;
    done = true;
  }
  return cudaSuccess;
}

template <typename T, int NT>
cudaError_t launch_d256(const void* q, const void* pool_k, const void* pool_v,
                        const void* k_scale, const void* v_scale, const void* tables,
                        const void* ctx_lens, void* out, void* ws, void* counters, int B,
                        int hq, int hkv, int ptot, int maxp, int layer, int window,
                        float scale, int splits, cudaStream_t stream) {
  using R = Ring<T>;
  const cudaError_t e = prepare_d256<T, NT>();
  if (e != cudaSuccess) return e;
  // the layer's K and V as [P Hkv 64 rows, 256] (a pointer offset), read in
  // [64, 128 B] boxes with the 128-byte swizzle
  const uint64_t rows = (uint64_t)ptot * hkv * kPage;
  if (rows >= (1ull << 31)) return cudaErrorInvalidValue;
  const size_t layer_elems = (size_t)layer * rows * kD256;
  const CUtensorMapDataType type =
      R::kQ8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap mk, mv;
  if (!encode_2d(&mk, type, static_cast<const T*>(pool_k) + layer_elems, kD256, rows,
                 (uint64_t)R::kRowBytes, 128 / sizeof(T), kPage, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_2d(&mv, type, static_cast<const T*>(pool_v) + layer_elems, kD256, rows,
                 (uint64_t)R::kRowBytes, 128 / sizeof(T), kPage, CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  const size_t layer_scales = (size_t)layer * rows;
  const float* ks = R::kQ8 ? static_cast<const float*>(k_scale) + layer_scales : nullptr;
  const float* vs = R::kQ8 ? static_cast<const float*>(v_scale) + layer_scales : nullptr;
  const dim3 grid(splits, hkv, B);
  paged_attention_d256<T, NT><<<grid, kRingThreads, R::kSmem, stream>>>(
      mk, mv, static_cast<const __nv_bfloat16*>(q), ks, vs, static_cast<const int*>(tables),
      static_cast<const int*>(ctx_lens), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(ws), static_cast<int*>(counters), hq, hkv, maxp, window, scale);
  return cudaGetLastError();
}

template <typename T, int NT>
cudaError_t geometry_d256(int* geo) {
  cudaError_t e = prepare_d256<T, NT>();
  if (e != cudaSuccess) return e;
  geo[0] = kConsumerWarps + 1;
  geo[1] = Ring<T>::kStages;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&geo[2], paged_attention_d256<T, NT>,
                                                    kRingThreads, Ring<T>::kSmem);
  if (e != cudaSuccess) return e;
  return attributes(paged_attention_d256<T, NT>, geo);
}

template <typename T>
cudaError_t dispatch_d256(int rep, const void* q, const void* pool_k, const void* pool_v,
                          const void* k_scale, const void* v_scale, const void* tables,
                          const void* ctx_lens, void* out, void* ws, void* counters, int B,
                          int hq, int hkv, int ptot, int maxp, int layer, int window,
                          float scale, int splits, cudaStream_t st) {
  if (rep <= 8)
    return launch_d256<T, 1>(q, pool_k, pool_v, k_scale, v_scale, tables, ctx_lens, out, ws,
                             counters, B, hq, hkv, ptot, maxp, layer, window, scale, splits, st);
  if (rep <= 16)
    return launch_d256<T, 2>(q, pool_k, pool_v, k_scale, v_scale, tables, ctx_lens, out, ws,
                             counters, B, hq, hkv, ptot, maxp, layer, window, scale, splits, st);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch_geometry_d256(int rep, int* geo) {
  if (rep <= 8) return geometry_d256<T, 1>(geo);
  if (rep <= 16) return geometry_d256<T, 2>(geo);
  return cudaErrorInvalidValue;
}

}  // namespace

// out[B, Hq, D] = paged decode attention of q over layer `layer` of the pool
// (semantics at the top of this file), the page walk of each (lane, kv head)
// split over `splits` blocks (ws: f32 scratch of B * Hkv * splits blocks of
// rep * (D + 2) floats each rounded up to 4, and counters: one zeroed int
// per (lane, kv head), both needed only when splits > 1). Returns cudaGetLastError() after the launch
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
    return quantized ? (int)dispatch_d256<int8_t>(PIE_K3_ARGS)
                     : (int)dispatch_d256<__nv_bfloat16>(PIE_K3_ARGS);
  if (d == 128)
    return quantized ? (int)dispatch<int8_t, 128>(PIE_K3_ARGS)
                     : (int)dispatch<__nv_bfloat16, 128>(PIE_K3_ARGS);
  if (d == 64)
    return quantized ? (int)dispatch<int8_t, 64>(PIE_K3_ARGS)
                     : (int)dispatch<__nv_bfloat16, 64>(PIE_K3_ARGS);
#undef PIE_K3_ARGS
  return (int)cudaErrorInvalidValue;
}

// geo[5] = {warps per block, stages (per warp at D 64 / 128, per block at
// D 256), blocks resident per SM, registers a thread, local (spill) bytes a
// thread} of the kernel pie_paged_attention launches for these arguments.
extern "C" int pie_paged_attention_geometry(int d, int quantized, int rep, int* geo) {
  if (d == 256)
    return quantized ? (int)dispatch_geometry_d256<int8_t>(rep, geo)
                     : (int)dispatch_geometry_d256<__nv_bfloat16>(rep, geo);
  if (d == 128)
    return quantized ? (int)dispatch_geometry<int8_t, 128>(rep, geo)
                     : (int)dispatch_geometry<__nv_bfloat16, 128>(rep, geo);
  if (d == 64)
    return quantized ? (int)dispatch_geometry<int8_t, 64>(rep, geo)
                     : (int)dispatch_geometry<__nv_bfloat16, 64>(rep, geo);
  return (int)cudaErrorInvalidValue;
}
