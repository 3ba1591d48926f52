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
//   qs = q * scale (f32); s_t = qs . k_t (f32), times k_scale[t] for INT8;
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
//   page tile is read from device memory exactly once per call.
// - A lane's page walk is split across blocks (gridDim.x) until the grid has
//   about 4 blocks per SM: 8 lanes x 8 kv heads alone would be 64 blocks for
//   132 SMs. Each block writes its (acc, m, l) to an f32 workspace and the
//   last block of a (lane, head) to arrive (an atomic counter, reset by that
//   block, as K1 does) merges the partial softmaxes.
// - Each page's K and V tiles (64 x D) and their scales go to shared memory
//   with 16-byte cp.async copies, double-buffered: page p + 1 is in flight
//   while page p is multiplied. Rows are padded by 16 bytes so the 16-byte
//   row reads of the score loop hit distinct banks.
// - Scores: one thread per (head, token), q broadcast from shared memory.
//   Softmax: one warp per head. PV: D is split across threads, each thread
//   keeping the accumulators of its column for its heads in registers.
// Not yet done: TMA, a persistent walk, and tensor-core dots.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kPage = 64;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -0.7f * 3.40282346638528859812e+38f;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <typename T, int D>
struct Tile {
  static constexpr int kElem = sizeof(T);
  static constexpr int kChunks = D * kElem / 16;  // 16-byte chunks per row
  static constexpr int kRow = D * kElem + 16;     // padded shared-memory row
  static constexpr int kBytes = kPage * kRow;
};

// Shared memory of one block: two stages of K and V tiles, two stages of K
// and V scales, then q, the page's scores and the softmax state.
template <typename T, int D>
size_t smem_bytes(int rep) {
  return 4 * (size_t)Tile<T, D>::kBytes + 4 * kPage * sizeof(float) +
         ((size_t)rep * D + (size_t)rep * kPage + 3 * (size_t)rep) * sizeof(float);
}

// HPT: heads whose accumulators one thread keeps (rep <= HPT * kThreads / D).
template <typename T, int D, int HPT>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(
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
  using TL = Tile<T, D>;
  constexpr bool kQ8 = std::is_same<T, int8_t>::value;
  constexpr int kStep = kThreads / D;  // heads between a thread's accumulators
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int last;

  const int split = blockIdx.x, h = blockIdx.y, bi = blockIdx.z;
  const int splits = gridDim.x;
  const int rep = hq / hkv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  unsigned char* tiles = smem;                                        // [2][K, V]
  float* sc = reinterpret_cast<float*>(smem + 4 * TL::kBytes);         // [2][K, V][64]
  float* qs = sc + 4 * kPage;                                          // [rep][D]
  float* ps = qs + rep * D;                                            // [rep][64]
  float* alpha = ps + rep * kPage;                                     // [rep]
  float* mrun = alpha + rep;                                           // [rep]
  float* lrun = mrun + rep;                                            // [rep]

  const int ctx = ctx_lens[bi];
  const int lo = window > 0 ? max(ctx - window, 0) : 0;
  const int p_lo = lo / kPage;
  const int p_hi = min(ctx > 0 ? (ctx + kPage - 1) / kPage : 0, maxp);
  const int per = (max(p_hi - p_lo, 0) + splits - 1) / splits;
  const int pb = p_lo + split * per;
  const int pe = min(p_hi, pb + per);

  const __nv_bfloat16* qb = q + ((size_t)bi * hq + (size_t)h * rep) * D;
  for (int i = tid; i < rep * D; i += kThreads) qs[i] = __bfloat162float(qb[i]) * scale;
  for (int r = tid; r < rep; r += kThreads) {
    mrun[r] = kNegInf;
    lrun[r] = 0.f;
  }

  auto issue = [&](int p, int stage) {
    const int t = tables[(size_t)bi * maxp + p];
    const size_t tile = ((size_t)layer * ptot + (t < 0 ? 0 : t)) * hkv + h;
    const unsigned char* gk =
        reinterpret_cast<const unsigned char*>(pool_k) + tile * kPage * D * TL::kElem;
    const unsigned char* gv =
        reinterpret_cast<const unsigned char*>(pool_v) + tile * kPage * D * TL::kElem;
    unsigned char* sk = tiles + 2 * stage * TL::kBytes;
    unsigned char* sv = sk + TL::kBytes;
    for (int c = tid; c < kPage * TL::kChunks; c += kThreads) {
      const int off = (c / TL::kChunks) * TL::kRow + (c % TL::kChunks) * 16;
      cp_async16(sk + off, gk + (size_t)c * 16);
      cp_async16(sv + off, gv + (size_t)c * 16);
    }
    if (kQ8 && tid < 32) {  // 64 K scales, 64 V scales: 16 chunks each
      const float* gs = (tid < 16 ? k_scale : v_scale) + tile * kPage;
      cp_async16(sc + (2 * stage + (tid >> 4)) * kPage + (tid & 15) * 4, gs + (tid & 15) * 4);
    }
    cp_async_commit();
  };

  float acc[HPT];
#pragma unroll
  for (int k = 0; k < HPT; ++k) acc[k] = 0.f;
  const int dcol = tid % D, r0 = tid / D;

  if (pb < pe) issue(pb, 0);
  __syncthreads();  // qs and the softmax state are ready
  for (int p = pb; p < pe; ++p) {
    const int stage = (p - pb) & 1;
    if (p + 1 < pe) {
      issue(p + 1, stage ^ 1);  // the other stage was released by the last barrier
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const unsigned char* sk = tiles + 2 * stage * TL::kBytes;
    const unsigned char* sv = sk + TL::kBytes;
    const float* sks = sc + 2 * stage * kPage;
    const float* svs = sks + kPage;
    const int base = p * kPage;

    // scores: one (head, token) per thread; a warp shares its head, so q is
    // read by broadcast
    for (int idx = tid; idx < rep * kPage; idx += kThreads) {
      const int r = idx / kPage, j = idx % kPage;
      const float* qr = qs + r * D;
      const unsigned char* kr = sk + j * TL::kRow;
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < TL::kChunks; ++c) {
        const uint4 raw = *reinterpret_cast<const uint4*>(kr + c * 16);
        if constexpr (kQ8) {
          const int8_t* e = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
          for (int i = 0; i < 16; ++i) s = fmaf(qr[c * 16 + i], (float)e[i], s);
        } else {
          const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
          for (int i = 0; i < 8; ++i) s = fmaf(qr[c * 8 + i], __bfloat162float(e[i]), s);
        }
      }
      if (kQ8) s *= sks[j];
      const int pos = base + j;
      ps[idx] = (pos < ctx && pos >= lo) ? s : kNegInf;
    }
    __syncthreads();

    // online softmax: one warp per head
    for (int r = warp; r < rep; r += kWarps) {
      const float a = ps[r * kPage + lane], b = ps[r * kPage + lane + 32];
      const float m_old = mrun[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(a, b)));
      float ea = expf(a - m_new), eb = expf(b - m_new);
      const float sum = warp_sum(ea + eb);
      if (kQ8) {
        ea *= svs[lane];
        eb *= svs[lane + 32];
      }
      ps[r * kPage + lane] = ea;
      ps[r * kPage + lane + 32] = eb;
      if (lane == 0) {
        const float al = expf(m_old - m_new);
        alpha[r] = al;
        lrun[r] = lrun[r] * al + sum;
        mrun[r] = m_new;
      }
    }
    __syncthreads();

    // PV: column dcol of heads r0, r0 + kStep, ...
#pragma unroll
    for (int k = 0; k < HPT; ++k) {
      const int r = r0 + k * kStep;
      if (r < rep) acc[k] *= alpha[r];
    }
#pragma unroll 8
    for (int j = 0; j < kPage; ++j) {
      float v;
      if constexpr (kQ8)
        v = (float)reinterpret_cast<const int8_t*>(sv + j * TL::kRow)[dcol];
      else
        v = __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(sv + j * TL::kRow)[dcol]);
#pragma unroll
      for (int k = 0; k < HPT; ++k) {
        const int r = r0 + k * kStep;
        if (r < rep) acc[k] = fmaf(ps[r * kPage + j], v, acc[k]);
      }
    }
    __syncthreads();  // this stage's tiles and ps are free again
  }

  __nv_bfloat16* ob = out + ((size_t)bi * hq + (size_t)h * rep) * D;
  if (splits == 1) {
#pragma unroll
    for (int k = 0; k < HPT; ++k) {
      const int r = r0 + k * kStep;
      if (r < rep) ob[r * D + dcol] = __float2bfloat16_rn(acc[k] / fmaxf(lrun[r], 1e-30f));
    }
    return;
  }

  // partial softmax of this block's pages -> workspace; the last block of
  // the (lane, head) to arrive merges them
  const size_t unit = (size_t)rep * (D + 2);
  float* wsb = ws + ((size_t)(bi * hkv + h) * splits + split) * unit;
#pragma unroll
  for (int k = 0; k < HPT; ++k) {
    const int r = r0 + k * kStep;
    if (r < rep) wsb[r * (D + 2) + dcol] = acc[k];
  }
  for (int r = tid; r < rep; r += kThreads) {
    wsb[r * (D + 2) + D] = mrun[r];
    wsb[r * (D + 2) + D + 1] = lrun[r];
  }
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
#pragma unroll
  for (int k = 0; k < HPT; ++k) {
    const int r = r0 + k * kStep;
    if (r >= rep) continue;
    float m = kNegInf;
    for (int s = 0; s < splits; ++s) m = fmaxf(m, __ldcg(wl + s * unit + r * (D + 2) + D));
    float l = 0.f, a = 0.f;
    for (int s = 0; s < splits; ++s) {
      const float* e = wl + s * unit + r * (D + 2);
      const float w = expf(__ldcg(e + D) - m);
      l = fmaf(__ldcg(e + D + 1), w, l);
      a = fmaf(__ldcg(e + dcol), w, a);
    }
    ob[r * D + dcol] = __float2bfloat16_rn(a / fmaxf(l, 1e-30f));
  }
}

template <typename T, int D, int HPT>
cudaError_t launch(const void* q, const void* pool_k, const void* pool_v,
                   const void* k_scale, const void* v_scale, const void* tables,
                   const void* ctx_lens, void* out, void* ws, void* counters, int B,
                   int hq, int hkv, int ptot, int maxp, int layer, int window,
                   float scale, int splits, cudaStream_t stream) {
  const size_t smem = smem_bytes<T, D>(hq / hkv);
  static size_t attr = 0;  // dynamic shared memory the kernel is allowed
  if (smem > attr) {
    cudaError_t e = cudaFuncSetAttribute(paged_attention_kernel<T, D, HPT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return e;
    attr = smem;
  }
  const dim3 grid(splits, hkv, B);
  paged_attention_kernel<T, D, HPT><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const T*>(pool_k),
      static_cast<const T*>(pool_v), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(tables),
      static_cast<const int*>(ctx_lens), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(ws), static_cast<int*>(counters), hq, hkv, ptot, maxp,
      layer, window, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t dispatch_heads(const void* q, const void* pool_k, const void* pool_v,
                           const void* k_scale, const void* v_scale,
                           const void* tables, const void* ctx_lens, void* out,
                           void* ws, void* counters, int B, int hq, int hkv,
                           int ptot, int maxp, int layer, int window, float scale,
                           int splits, cudaStream_t st) {
  const int per_thread = (hq / hkv + kThreads / D - 1) / (kThreads / D);
#define PIE_K3_HEADS(HPT)                                                        \
  if (per_thread <= HPT)                                                         \
    return launch<T, D, HPT>(q, pool_k, pool_v, k_scale, v_scale, tables,        \
                             ctx_lens, out, ws, counters, B, hq, hkv, ptot, maxp, \
                             layer, window, scale, splits, st);
  PIE_K3_HEADS(1)
  PIE_K3_HEADS(2)
  PIE_K3_HEADS(4)
  PIE_K3_HEADS(8)
  PIE_K3_HEADS(16)
#undef PIE_K3_HEADS
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
#define PIE_K3_ARGS                                                              \
  q, pool_k, pool_v, k_scale, v_scale, tables, ctx_lens, out, ws, counters, B,   \
      hq, hkv, ptot, maxp, layer, window, scale, splits, st
  if (d == 128)
    return quantized ? (int)dispatch_heads<int8_t, 128>(PIE_K3_ARGS)
                     : (int)dispatch_heads<__nv_bfloat16, 128>(PIE_K3_ARGS);
  if (d == 64)
    return quantized ? (int)dispatch_heads<int8_t, 64>(PIE_K3_ARGS)
                     : (int)dispatch_heads<__nv_bfloat16, 64>(PIE_K3_ARGS);
#undef PIE_K3_ARGS
  return (int)cudaErrorInvalidValue;
}
