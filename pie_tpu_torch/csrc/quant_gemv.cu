// K1: decode GEMV with group-wise affine INT4/INT8 weights, for M <= 32 rows.
//
// Replaces the decode branch of the TPU kernel in
// pie_tpu/ops/quant_matmul_pallas.py (quant_matmul_stacked and
// quant_matmul_pallas -> _kernel -> _accum_block with post_scale, the
// rms-norm prologue of _kernel and _rope_epilogue).
//
// Computes, for every output feature n and row m,
//   y[m, n] = sum_g ( s[g,n] * sum_{k in g} xh[m,k] q[k,n] + b[g,n] * sum_{k in g} xh[m,k] )
// in f32, where xh = x, or with the prologue xh = bf16(x * rsqrt(mean(x^2) + eps) * ln_w)
// over the logical K; the optional epilogue rotates dh-sized head groups,
// y*cos + roll_half(y)*sin, with the cos/sin rows of rope_qkv_cs.
//
// Bound on the H100: bytes at every M <= 32 (at M = 32 an INT4 byte feeds
// 128 operations, under the ~295 per byte where the tensor cores would
// set the time), so the least time is the packed words plus scales and
// biases over 3.35 TB/s.
//
// Design, as the TPU kernel does it on its matrix unit:
// - Tensor cores: mma.sync m16n8k16 (bf16 in, f32 out) in the transposed
//   form y^T = W^T x^T. The codes are the A operand (16 features x 16 k),
//   exact in bf16 (q, 0-15 or 0-255); x is B (16 k x 8 tokens; M <= 8, 16
//   and 32 take 1, 2 or 4 n8 tiles, each reusing the A fragment). Each
//   group's partial sum x.q is accumulated on the tensor cores in f32, then
//   folded into the running sum as s * partial + b * sum(x) in f32: the
//   decode branch's single rounding, no bf16 dequantization.
// - Codes to operands: a thread's A fragment is features f, f+1 (mma rows
//   r, r+8, so their words are neighbours: one 8-byte shared load). The
//   k order inside two k16 steps is permuted (in A and B alike, so the
//   product is the same): each of a quad's four threads takes one 8-row
//   chunk of 32 rows whole, and nibbles i and i+4 of its word form one
//   bf16x2 operand with one shift and one lop3 (bf16 128 + q) and one
//   bf16x2 fma (exactly q). B is one 16-byte load of the same 8 rows of x
//   per token and four prmt. Words arrive in 32-feature boxes with the
//   128-byte swizzle, and the chunks are dealt so that both loads are free
//   of bank conflicts. An INT8 code goes through the f32 2^23 + q trick and
//   one cvt. The group size is a template parameter, so the fold points
//   are fixed at compile time.
// - Bytes in flight: a producer warp keeps a ring of shared-memory stages
//   filled with TMA copies behind mbarriers. A stage is 128 rows of K: the
//   packed words of the block's 128 features, the stage's scale and bias
//   rows and the rows of x (two 64-column boxes, 128-byte swizzle). 8
//   consumer warps (16 features each) read them; one more warp sums each
//   32-row chunk of x per token for the bias term once per stage, for all 8.
// - Split-K: where the 128-feature tiles give too few blocks to fill the
//   card (gemv_plan in ops/quant_matmul_cuda.py), blockIdx.y takes a range
//   of stages, writes its f32 partial to a workspace, and the last block
//   of the tile to arrive (an atomic counter it resets) sums the partials
//   in split order and runs the epilogue.
// - The ln prologue is a rows-only pre-pass (ln_rows_kernel, one block per
//   row, launched by the same entry point): the normalized bf16 rows go to
//   a scratch [M, Kp] that the main kernel reads with TMA, so the
//   statistic is computed once per row instead of once per block. The main
//   kernel is launched as its programmatic dependent: its first stages'
//   weights are copied while the pre-pass runs, and only the copies of x
//   wait for it (griddepcontrol.wait).
// - Epilogue: the accumulators go to shared memory as an f32 tile
//   [token][feature]; with rope_dim != 0 a head and its partners dh/2
//   further on lie in the tile (dh | 128), as in K2; 16-byte bf16 stores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemv_tile.cuh"
#include "hopper.cuh"

namespace {

using pie::bf16_pair;
using pie::bf16x2_fma;
using pie::encode_2d;
using pie::mbar_arrive;
using pie::mbar_expect_tx;
using pie::mbar_init;
using pie::int8_pair_w;
using pie::mbar_wait;
using pie::mma_16816;
using pie::prmt;
using pie::smem_u32;
using pie::tma_load_2d;
using pie::gemv::BF;
using pie::gemv::consumer_sync;
using pie::gemv::CP;
using pie::gemv::int4_pair_w;
using pie::gemv::KS;
using pie::gemv::kBarBytes;
using pie::gemv::kConsumers;
using pie::gemv::kMaxStages;
using pie::gemv::kRingBudget;
using pie::gemv::kThreads;
using pie::gemv::ring_stages;
using pie::gemv::stage_bytes;
using pie::gemv::sum8;
using pie::gemv::tx_bytes;
using pie::gemv::warp_sum;

constexpr int kSmem = 1024 + kRingBudget + kBarBytes;
static_assert(32 * CP * 4 <= 2 * stage_bytes(4, false, 128, 32), "epilogue tile must fit");

// Prologue: xn[m] = bf16(x[m] * rsqrt(mean(x[m, :K]^2) + eps) * lnw), zero
// past K. One block per row.
__global__ void __launch_bounds__(256) ln_rows_kernel(const __nv_bfloat16* __restrict__ x,
                                                      const __nv_bfloat16* __restrict__ lnw,
                                                      __nv_bfloat16* __restrict__ xn, int K,
                                                      int Kp, float eps) {
  __shared__ float red[8];
  __shared__ float inv_s;
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const __nv_bfloat16* xr = x + (size_t)blockIdx.x * Kp;
  __nv_bfloat16* out = xn + (size_t)blockIdx.x * Kp;
  float ss = 0.f;
  for (int c = threadIdx.x; c < K / 8; c += 256) {
    const uint4 raw = *reinterpret_cast<const uint4*>(xr + c * 8);
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float v = __bfloat162float(h[i]);
      ss += v * v;
    }
  }
  for (int k = K / 8 * 8 + threadIdx.x; k < K; k += 256) {
    const float v = __bfloat162float(xr[k]);
    ss += v * v;
  }
  ss = warp_sum(ss);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = ss;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < 8; ++w) t += red[w];
    inv_s = rsqrtf(t / (float)K + eps);
  }
  __syncthreads();
  const float inv = inv_s;
  for (int c = threadIdx.x; c < Kp / 8; c += 256) {
    const uint4 raw = *reinterpret_cast<const uint4*>(xr + c * 8);
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
    float v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int k = c * 8 + i;
      v[i] = k < K ? __bfloat162float(h[i]) * inv * __bfloat162float(lnw[k]) : 0.f;
    }
    *reinterpret_cast<uint4*>(out + c * 8) = make_uint4(
        bf16_pair(v[0], v[1]), bf16_pair(v[2], v[3]), bf16_pair(v[4], v[5]), bf16_pair(v[6], v[7]));
  }
}

template <int BITS, bool F32S, int NT, int G>
__global__ void __launch_bounds__(kThreads, 2) gemv_kernel(
    const __grid_constant__ CUtensorMap map_x,  // x [M, Kp] bf16, box [8 NT, 64], 128B swizzle
    const __grid_constant__ CUtensorMap map_w,  // words [Kp/ep, N], box [KS/ep, 32], 128B swizzle
    const __grid_constant__ CUtensorMap map_s,  // scales [Kp/g, N], box [KS/g, 128]
    const __grid_constant__ CUtensorMap map_b,  // biases, as scales
    const float* __restrict__ cosv, const float* __restrict__ sinv,
    __nv_bfloat16* __restrict__ y, float* __restrict__ ws, int* __restrict__ counters,
    int M, int N, int nstages, int per_split, int rope_dim) {
  constexpr int MP = NT * 8, EP = 32 / BITS, g = G;
  using L = pie::gemv::Stage<BITS, F32S, G, MP>;
  constexpr int offW = L::offW, offS = L::offS, offB = L::offB, offSum = L::offSum;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw0 = smem_u32(smem_raw);
  const uint32_t base = (raw0 + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw0);
  constexpr int sbytes = L::bytes, stages = L::stages;
  const uint32_t full0 = base + stages * sbytes, ready0 = full0 + 8 * kMaxStages,
                 empty0 = ready0 + 8 * kMaxStages;
  int* flag = reinterpret_cast<int*>(smem + stages * sbytes + 24 * kMaxStages);

  const int col0 = blockIdx.x * BF;
  const int s_begin = blockIdx.y * per_split;
  const int nk = min(nstages, s_begin + per_split) - s_begin;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(ready0 + 8 * s, 32);
      mbar_init(empty0 + 8 * s, kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers / 32) {  // producer: one thread issues every copy
    if (lane == 0) {
      const uint32_t tx = tx_bytes(BITS, F32S, g, MP);
      auto weights = [&](int i) {  // stage i's words, scale and bias rows
        const uint32_t st = base + (i % stages) * sbytes, bar = full0 + 8 * (i % stages);
        const int k0 = (s_begin + i) * KS;
        mbar_expect_tx(bar, tx);
        for (int b = 0; b < BF / 32; ++b)  // four 32-feature boxes, 128-byte swizzle
          tma_load_2d(st + offW + b * (KS / EP) * 128, &map_w, bar, col0 + 32 * b, k0 / EP);
        tma_load_2d(st + offS, &map_s, bar, col0, k0 / g);
        tma_load_2d(st + offB, &map_b, bar, col0, k0 / g);
      };
      auto rows = [&](int i) {  // stage i's rows of x
        const uint32_t st = base + (i % stages) * sbytes, bar = full0 + 8 * (i % stages);
        const int k0 = (s_begin + i) * KS;
        tma_load_2d(st, &map_x, bar, k0, 0);
        tma_load_2d(st + MP * 128, &map_x, bar, k0 + 64, 0);
      };
      // the first stages' weights do not depend on the kernel before (the
      // ln pre-pass, launched as this one's programmatic dependency):
      // they are in flight while it finishes
      const int pre = min(nk, stages);
      for (int i = 0; i < pre; ++i) weights(i);
      asm volatile("griddepcontrol.wait;\n" ::: "memory");
      for (int i = 0; i < pre; ++i) rows(i);
      for (int i = pre; i < nk; ++i) {
        mbar_wait(empty0 + 8 * (i % stages), ((i / stages) - 1) & 1);
        weights(i);
        rows(i);
      }
    }
    return;
  }
  if (warp == kConsumers / 32 + 1) {  // x sums: 32-row chunk q of token n, for all warps
    for (int i = 0; i < nk; ++i) {
      const int s = i % stages;
      mbar_wait(full0 + 8 * s, (i / stages) & 1);
      unsigned char* st = smem + s * sbytes;
      float* sums = reinterpret_cast<float*>(st + offSum);  // [4][MP]
      for (int e = lane; e < 4 * MP; e += 32) {
        const int q = e / MP, n = e % MP;
        const unsigned char* row = st + (q >> 1) * MP * 128 + n * 128;
        float v = 0.f;
#pragma unroll
        for (int c = 0; c < 4; ++c)
          v += sum8(*reinterpret_cast<const uint4*>(row + ((((q & 1) * 4 + c) ^ (n & 7)) * 16)));
        sums[e] = v;
      }
      mbar_arrive(ready0 + 8 * s);
    }
    return;
  }

  // consumers: warp w owns features 16w..16w+15; mma row r4 is feature
  // fl = 16w + 2 r4 and row r4 + 8 is fl + 1
  const int r4 = lane >> 2, t = lane & 3;
  const int fl = warp * 16 + 2 * r4;
  constexpr int GQ = G / 32;  // 32-row steps (and x-sum chunks) per group
  float acc[NT][4], part[NT][4];
  // rc[kq]: the 8-row chunk of the stage that thread t takes in 32-row step
  // kq. With g >= 64 the two steps of a 64-row block take the even and the
  // odd chunks, so the four t lanes' word rows and x chunks differ in the
  // bits the 128-byte swizzle XORs in: no bank conflicts. With g = 32 a
  // step is one group and takes its four chunks.
  int rc[KS / 32];
#pragma unroll
  for (int kq = 0; kq < KS / 32; ++kq)
    rc[kq] = g == 32 ? 4 * kq + t : 8 * (kq >> 1) + 2 * t + (kq & 1);
  // words of features fl, fl + 1 in word row r of the stage (four boxes of
  // [KS / EP][32] words, 128-byte swizzle)
  auto word_pair = [&](const uint32_t* W, int r) {
    const unsigned char* box = reinterpret_cast<const unsigned char*>(W) + (fl >> 5) * (KS / EP) * 128;
    return *reinterpret_cast<const uint2*>(box + r * 128 + ((((fl & 31) >> 2) ^ (r & 7)) << 4) +
                                           ((fl & 3) << 2));
  };
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[j][r] = part[j][r] = 0.f;

  for (int i = 0; i < nk; ++i) {
    const int s = i % stages;
    const uint32_t ph = (i / stages) & 1;
    mbar_wait(full0 + 8 * s, ph);
    mbar_wait(ready0 + 8 * s, ph);
    const unsigned char* st = smem + s * sbytes;
    const uint32_t* W = reinterpret_cast<const uint32_t*>(st + offW);
    const float* sums = reinterpret_cast<const float*>(st + offSum);
#pragma unroll
    for (int kq = 0; kq < KS / 32; ++kq) {  // 32 rows: two k16 steps, rows permuted
      // thread t takes the 8-row chunk rc[kq] whole: step 0 pairs its rows
      // (0, 4) and (1, 5), step 1 rows (2, 6) and (3, 7), in A and B alike
      uint32_t a[2][4];
      if constexpr (BITS == 4) {
        const uint2 w = word_pair(W, rc[kq]);
        a[0][0] = int4_pair_w(w.x, 0);
        a[0][1] = int4_pair_w(w.y, 0);
        a[0][2] = int4_pair_w(w.x, 4);
        a[0][3] = int4_pair_w(w.y, 4);
        a[1][0] = int4_pair_w(w.x, 8);
        a[1][1] = int4_pair_w(w.y, 8);
        a[1][2] = int4_pair_w(w.x, 12);
        a[1][3] = int4_pair_w(w.y, 12);
      } else {  // chunk t is word rows 2t (rows 0-3) and 2t + 1 (rows 4-7)
        const uint2 w0 = word_pair(W, 2 * rc[kq]);
        const uint2 w1 = word_pair(W, 2 * rc[kq] + 1);
        a[0][0] = int8_pair_w(w0.x, w1.x, 0);
        a[0][1] = int8_pair_w(w0.y, w1.y, 0);
        a[0][2] = int8_pair_w(w0.x, w1.x, 1);
        a[0][3] = int8_pair_w(w0.y, w1.y, 1);
        a[1][0] = int8_pair_w(w0.x, w1.x, 2);
        a[1][1] = int8_pair_w(w0.y, w1.y, 2);
        a[1][2] = int8_pair_w(w0.x, w1.x, 3);
        a[1][3] = int8_pair_w(w0.y, w1.y, 3);
      }
      const unsigned char* xb = st + (rc[kq] >> 3) * MP * 128;  // the 64-column box
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = 8 * j + r4;
        const uint4 v = *reinterpret_cast<const uint4*>(
            xb + n * 128 + (((rc[kq] & 7) ^ (n & 7)) * 16));
        mma_16816(part[j], a[0], prmt(v.x, v.z, 0x5410u), prmt(v.x, v.z, 0x7632u));
        mma_16816(part[j], a[1], prmt(v.y, v.w, 0x5410u), prmt(v.y, v.w, 0x7632u));
      }
      if ((kq + 1) % GQ == 0) {  // a group ends: acc += s * part + b * sum(x)
        const int q = kq / GQ;
        float s0, s1, b0, b1;
        if constexpr (F32S) {
          const float2 sv = *reinterpret_cast<const float2*>(st + offS + (q * BF + fl) * 4);
          const float2 bv = *reinterpret_cast<const float2*>(st + offB + (q * BF + fl) * 4);
          s0 = sv.x; s1 = sv.y; b0 = bv.x; b1 = bv.y;
        } else {
          const uint32_t sv = *reinterpret_cast<const uint32_t*>(st + offS + (q * BF + fl) * 2);
          const uint32_t bv = *reinterpret_cast<const uint32_t*>(st + offB + (q * BF + fl) * 2);
          s0 = __uint_as_float(sv << 16); s1 = __uint_as_float(sv & 0xFFFF0000u);
          b0 = __uint_as_float(bv << 16); b1 = __uint_as_float(bv & 0xFFFF0000u);
        }
        const int c32 = q * GQ;  // the group's first 32-row chunk
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          float2 sx = make_float2(0.f, 0.f);
#pragma unroll
          for (int c = 0; c < GQ; ++c) {
            const float2 v = *reinterpret_cast<const float2*>(sums + (c32 + c) * MP + 8 * j + 2 * t);
            sx.x += v.x;
            sx.y += v.y;
          }
          acc[j][0] = fmaf(s0, part[j][0], fmaf(b0, sx.x, acc[j][0]));
          acc[j][1] = fmaf(s0, part[j][1], fmaf(b0, sx.y, acc[j][1]));
          acc[j][2] = fmaf(s1, part[j][2], fmaf(b1, sx.x, acc[j][2]));
          acc[j][3] = fmaf(s1, part[j][3], fmaf(b1, sx.y, acc[j][3]));
#pragma unroll
          for (int r = 0; r < 4; ++r) part[j][r] = 0.f;
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * s);
  }
  consumer_sync();  // every consumer is done with the ring

  // epilogue: accumulators -> f32 tile Ct[token][feature]
  float* Ct = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int n = 8 * j + 2 * t;
    *reinterpret_cast<float2*>(Ct + n * CP + fl) = make_float2(acc[j][0], acc[j][2]);
    *reinterpret_cast<float2*>(Ct + (n + 1) * CP + fl) = make_float2(acc[j][1], acc[j][3]);
  }
  consumer_sync();
  const int ct = threadIdx.x;
  const int splits = gridDim.y;
  if (splits > 1) {
    float* partial = ws + (size_t)blockIdx.y * M * N;
    for (int e = ct; e < M * (BF / 4); e += kConsumers) {
      const int r = e / (BF / 4), c = (e % (BF / 4)) * 4;
      if (col0 + c < N)
        *reinterpret_cast<float4*>(partial + (size_t)r * N + col0 + c) =
            *reinterpret_cast<const float4*>(Ct + r * CP + c);
    }
    __threadfence();
    consumer_sync();
    if (ct == 0) {
      const int last = atomicAdd(&counters[blockIdx.x], 1) == splits - 1;
      if (last) counters[blockIdx.x] = 0;  // ready for the next call
      *flag = last;
    }
    consumer_sync();
    if (!*flag) return;
    __threadfence();
    for (int e = ct; e < M * (BF / 4); e += kConsumers) {
      const int r = e / (BF / 4), c = (e % (BF / 4)) * 4;
      if (col0 + c >= N) continue;
      float4* own = reinterpret_cast<float4*>(Ct + r * CP + c);
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int sp = 0; sp < splits; ++sp) {
        const float4 p = sp == (int)blockIdx.y
                             ? *own
                             : __ldcg(reinterpret_cast<const float4*>(
                                   ws + ((size_t)sp * M + r) * N + col0 + c));
        v.x += p.x; v.y += p.y; v.z += p.z; v.w += p.w;
      }
      *own = v;
    }
    consumer_sync();
  }
  const int half = rope_dim >> 1;
  for (int e = ct; e < M * (BF / 8); e += kConsumers) {
    const int r = e / (BF / 8), c = (e % (BF / 8)) * 8;
    if (col0 + c >= N) continue;
    const float* src = Ct + r * CP + c;
    float v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = src[i];
    const size_t o = (size_t)r * N + col0 + c;
    if (rope_dim != 0) {
      const float* partner = Ct + r * CP + ((c % rope_dim) < half ? c + half : c - half);
      const float4 c0 = *reinterpret_cast<const float4*>(cosv + o);
      const float4 c1 = *reinterpret_cast<const float4*>(cosv + o + 4);
      const float4 s0 = *reinterpret_cast<const float4*>(sinv + o);
      const float4 s1 = *reinterpret_cast<const float4*>(sinv + o + 4);
      const float cs[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
      const float sn[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = v[i] * cs[i] + partner[i] * sn[i];
    }
    *reinterpret_cast<uint4*>(y + o) = make_uint4(bf16_pair(v[0], v[1]), bf16_pair(v[2], v[3]),
                                                  bf16_pair(v[4], v[5]), bf16_pair(v[6], v[7]));
  }
}

// -- host side: tensor maps and the launch ------------------------------------

struct Maps {
  CUtensorMap x, w, s, b;
};

bool encode_maps(Maps* m, const void* x, const void* packed, const void* scales,
                 const void* biases, int M, int Kp, int N, int bits, int g, bool f32s, int mp) {
  const int ep = 32 / bits, es = f32s ? 4 : 2;
  const CUtensorMapDataType st =
      f32s ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  return encode_2d(&m->x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, Kp, M, (uint64_t)Kp * 2, 64, mp,
                   CU_TENSOR_MAP_SWIZZLE_128B) &&
         encode_2d(&m->w, CU_TENSOR_MAP_DATA_TYPE_INT32, packed, N, Kp / ep, (uint64_t)N * 4, 32,
                   KS / ep, CU_TENSOR_MAP_SWIZZLE_128B) &&
         encode_2d(&m->s, st, scales, N, Kp / g, (uint64_t)N * es, BF, KS / g,
                   CU_TENSOR_MAP_SWIZZLE_NONE) &&
         encode_2d(&m->b, st, biases, N, Kp / g, (uint64_t)N * es, BF, KS / g,
                   CU_TENSOR_MAP_SWIZZLE_NONE);
}

template <int BITS, bool F32S, int NT, int G>
cudaError_t launch(const void* x, const void* packed, const void* scales, const void* biases,
                   const void* cosv, const void* sinv, void* y, void* ws, void* counters,
                   int splits, int per_split, int M, int Kp, int N, int rope_dim,
                   bool after_prepass, cudaStream_t stream) {
  Maps m;
  if (!encode_maps(&m, x, packed, scales, biases, M, Kp, N, BITS, G, F32S, 8 * NT))
    return cudaErrorInvalidValue;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        gemv_kernel<BITS, F32S, NT, G>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (e == cudaSuccess)  // room for two rings per SM
      e = cudaFuncSetAttribute(gemv_kernel<BITS, F32S, NT, G>,
                               cudaFuncAttributePreferredSharedMemoryCarveout, 100);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const int smem =
      1024 + ring_stages(BITS, F32S, G, 8 * NT) * stage_bytes(BITS, F32S, G, 8 * NT) + kBarBytes;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + BF - 1) / BF, splits);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = after_prepass ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, gemv_kernel<BITS, F32S, NT, G>, m.x, m.w, m.s, m.b, static_cast<const float*>(cosv),
      static_cast<const float*>(sinv), static_cast<__nv_bfloat16*>(y), static_cast<float*>(ws),
      static_cast<int*>(counters), M, N, Kp / KS, per_split, rope_dim);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <int BITS, bool F32S>
cudaError_t dispatch_rows(const void* x, const void* packed, const void* scales,
                          const void* biases, const void* cosv, const void* sinv, void* y,
                          void* ws, void* counters, int splits, int per_split, int M, int Kp,
                          int N, int g, int rope_dim, bool after_prepass, cudaStream_t st) {
#define PIE_GEMV_ROWS(NT, G)                                                                   \
  if (M <= 8 * NT && g == G)                                                                   \
    return launch<BITS, F32S, NT, G>(x, packed, scales, biases, cosv, sinv, y, ws, counters,   \
                                     splits, per_split, M, Kp, N, rope_dim, after_prepass, st);
  PIE_GEMV_ROWS(1, 32)
  PIE_GEMV_ROWS(1, 64)
  PIE_GEMV_ROWS(1, 128)
  PIE_GEMV_ROWS(2, 32)
  PIE_GEMV_ROWS(2, 64)
  PIE_GEMV_ROWS(2, 128)
  PIE_GEMV_ROWS(4, 32)
  PIE_GEMV_ROWS(4, 64)
  PIE_GEMV_ROWS(4, 128)
#undef PIE_GEMV_ROWS
  return cudaErrorInvalidValue;
}

}  // namespace

// The ln prologue alone: xn[M, Kp] = bf16(rms_norm(x[:, :K]) * lnw), zero
// past K (x [M, Kp] bf16). Returns cudaGetLastError() after the launch.
extern "C" int pie_gemv_ln_rows(const void* x, const void* lnw, void* xn, int M, int K, int Kp,
                                float eps, void* stream) {
  if (M < 1 || K < 1 || K > Kp || Kp % 8 != 0 || lnw == nullptr || xn == nullptr)
    return (int)cudaErrorInvalidValue;
  ln_rows_kernel<<<M, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(lnw),
      static_cast<__nv_bfloat16*>(xn), K, Kp, eps);
  return (int)cudaGetLastError();
}

// y[M, N] = xh[M, Kp] @ dequant(W) (+ the rope epilogue when rope_dim != 0:
// cos/sin [M, N] f32, 32 | dh, dh | 128, dh | N), M <= 32. With lnw != null
// the prologue first writes xh = bf16(rms_norm(x) * lnw) into xn ([M, Kp]
// bf16 scratch), else xh = x. K is split into `splits` ranges of
// `per_split` 128-row stages; with splits > 1, ws is [splits, M, N] f32
// scratch and counters one zeroed int per 128-feature tile. N must be a
// multiple of 8 (TMA's 16-byte rows). Scales and biases are bf16, or f32
// when scale_f32 != 0. Returns cudaGetLastError() after the launches
// (cudaErrorInvalidValue for arguments the kernel does not take).
extern "C" int pie_quant_gemv(const void* x, void* xn, const void* packed, const void* scales,
                              const void* biases, const void* lnw, const void* cosv,
                              const void* sinv, void* y, void* ws, void* counters, int splits,
                              int per_split, int M, int K, int Kp, int N, int bits,
                              int group_size, int scale_f32, int rope_dim, float eps,
                              void* stream) {
  const int nstages = Kp / KS;
  if (M < 1 || M > 32 || N < 8 || N % 8 != 0 || Kp < KS || Kp % KS != 0 || K < 1 || K > Kp ||
      (bits != 4 && bits != 8) ||
      (group_size != 32 && group_size != 64 && group_size != 128) || splits < 1 ||
      per_split < 1 || (splits - 1) * per_split >= nstages || splits * per_split < nstages ||
      (splits > 1 && (ws == nullptr || counters == nullptr)) ||
      (lnw != nullptr && xn == nullptr) ||
      (rope_dim != 0 && (rope_dim % 32 != 0 || BF % rope_dim != 0 || N % rope_dim != 0 ||
                         cosv == nullptr || sinv == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (lnw != nullptr) {
    const int e = pie_gemv_ln_rows(x, lnw, xn, M, K, Kp, eps, stream);
    if (e != 0) return e;
    x = xn;
  }
#define PIE_GEMV_LAUNCH(B, F)                                                                  \
  return (int)dispatch_rows<B, F>(x, packed, scales, biases, cosv, sinv, y, ws, counters,      \
                                  splits, per_split, M, Kp, N, group_size, rope_dim,       \
                                  lnw != nullptr, st)
  if (bits == 4) {
    if (scale_f32) PIE_GEMV_LAUNCH(4, true);
    PIE_GEMV_LAUNCH(4, false);
  }
  if (scale_f32) PIE_GEMV_LAUNCH(8, true);
  PIE_GEMV_LAUNCH(8, false);
#undef PIE_GEMV_LAUNCH
}
