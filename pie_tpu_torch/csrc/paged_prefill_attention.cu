// K5: paged prefill attention over the INT8 KV pool at head dim 128.
//
// Replaces no TPU kernel: the JAX package runs a prefill chunk's attention
// as plain XLA ops (its pages gathered to dense K/V, then a masked f32
// attention), and the port did the same (gathered_attention in
// models/llama.py). On the H100 that plain form was half of the card's time
// in a prefill burst: every chunk gathered its lane's whole block table
// (66 pages in the Qwen cells), scored every query row against every slot
// on f32 SIMT GEMMs and made five or six f32 passes over the score tensor
// (PERF.md). K5 is that attention as one hand-written kernel.
//
// Computes, for lane b, token t of the chunk and query head hq (kv head
// h = hq / G, G = Hq / Hkv), attention over key slots s of the pages that
// the lane's block table names:
//   row (t, hq) attends slot s iff s < ctx, s <= positions[t] and the
//   table's page for s is not -1 (attention_mask over _paged_kv_positions);
//   score = (bf16 q . K codes widened exactly to bf16, f32 accumulation)
//           * (scale * k_scale[s]) in f32;
//   online softmax in f32; the probabilities times v_scale[s], rounded once
//   to bf16, times the V codes (exact bf16), f32 accumulation;
//   out = acc / max(l, 1e-30), rounded once to bf16; a pad row
//   (positions[t] = -1) attends nothing and gets zeros.
//
// Bound on the H100: bytes at the first chunk of a prompt (a 256-token
// chunk at positions 0-255 needs 4 pages of K and V a head but reads and
// writes 28 x 256 x 128 q and output values: 0.033 ms over 28 Qwen layers),
// operations past about 1k of context (the causal work, 4 x Hq x 128 x
// sum(positions + 1) a layer: 408 GFLOP, 0.412 ms at 989 TFLOP/s, for the
// chunk at positions 3,840-4,095).
//
// Design against that bound:
// - Rows: each kv head's G query heads and the chunk's T tokens are packed
//   into the M side, row m = t * G + r (no padding of the group), 128 rows
//   a block: two consumer warpgroups of 64 (wgmma's M). Each INT8 page is
//   loaded once a block and serves every query head that reads it.
// - A block walks only the pages its rows can see: [0, ceil(min(ctx, the
//   largest position of its rows + 1) / 64)), read from the device buffers,
//   so the grid is fixed by shapes and one CUDA graph a chunk bucket serves
//   every context. Rows of a page wholly visible to both of a thread's rows
//   take no mask. Where the row tiles do not fill one wave of the card
//   (short chunks, and kv heads x tiles under 132), the page walk is split
//   across blocks (gridDim.x = tiles x splits) into ranges of at least four
//   pages (a shorter walk drops the splits it leaves empty); each block
//   writes its (acc, m, l) to a workspace and the last block of a row tile
//   to arrive merges the splits in split order, four outputs a thread with
//   the loads of every split in flight.
// - Loads: warpgroup 0 is the producer. One thread keeps kRing INT8 pages
//   in flight with 1-D bulk copies (8 KB of K, 8 KB of V, 256 B of each
//   scale; the walk's table entries read once into shared memory) on an
//   mbarrier ring; the warpgroup's 128 threads turn each
//   landed page into bf16 operands in shared memory: K as two [64 keys, 64 d]
//   tiles, V transposed as one [128 d, 64 keys] tile, each row 128 bytes in
//   the 128-byte swizzle wgmma reads (chunk c of row r at c ^ (r % 8)), in
//   a ring of kBufs buffers guarded by full and empty mbarriers. INT8 codes
//   become bf16 without an integer-to-float conversion: two lop3 and one
//   bf16x2 subtraction a pair (pie::s8_pair_02 / _13), exact. Converting
//   once a block, not once a warp, costs the page's 16 K values once per
//   128 rows.
// - Products on wgmma: S[64 rows, 64 keys] = Q K^T, eight m64n64k16 steps
//   with q's A fragments in registers (loaded once, unscaled) and K from
//   shared memory; O[64, 128] += P V, four m64n128k16 steps with P's A
//   fragments built in registers from S's accumulators (times v_scale,
//   rounded once to bf16) and V^T from shared memory. A warpgroup issues
//   page i's QK, rescales O and issues page i - 1's PV, then runs page i's
//   softmax while that PV runs (FlashAttention-3's order). Issuing page
//   i + 1's QK before page i's softmax instead made ptxas serialize every
//   wgmma (its C7515 warning); the two warpgroups taking turns to issue, or
//   a second converter warpgroup, ran no faster on the H100.
// - Where the time goes (copies of this source with a part taken out, a
//   256-token Qwen chunk at positions 3,840-4,095 on the H100, 2.17 ms over
//   28 layers, PERF.md): launch, prologue and split merge 0.32 ms; the
//   consumers' softmax 0.63, their per-page waits 0.36, the products 0.24
//   beyond those; the conversion, repeated by each of a kv head's 28
//   blocks, 0.62 on the same issue slots.
// - Launch name: prefill_attention_kernel, which none of the benchmark's
//   K1 / K2 / K3 kernel patterns matches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using pie::bf16_pair;
using pie::bulk_load;
using pie::mbar_arrive;
using pie::mbar_expect_tx;
using pie::mbar_init;
using pie::mbar_wait;
using pie::prmt;
using pie::s8_pair_02;
using pie::s8_pair_13;
using pie::smem_u32;

constexpr int kPage = 64, kD = 128;
constexpr int kRows = 128;  // query rows a block: two consumer warpgroups of 64
constexpr int kConvThreads = 128;  // warpgroup 0 loads and converts
constexpr int kThreads = kConvThreads + 256;  // warpgroups 1 and 2 multiply
// registers a thread: the launch gives each 65,536 / kThreads; the converters
// give back kConvThreads x (that - kConvRegs), which covers what the
// consumers take, 256 x (kMathRegs - that): an increase beyond the block's
// pool never returns
constexpr int kLaunchRegs = 65536 / kThreads / 8 * 8;
constexpr int kConvRegs = 64, kMathRegs = 216;
static_assert(kConvThreads * (kLaunchRegs - kConvRegs) >= 256 * (kMathRegs - kLaunchRegs),
              "the consumers' registers must come from the converters'");
constexpr int kRing = 6;       // INT8 pages in flight
constexpr int kBufs = 3;       // bf16 pages
constexpr int kMaxWalk = 1024;  // pages of a walk whose table entries shared memory holds
constexpr int kMinPagesPerSplit = 4;
constexpr float kNegInf = -0.7f * 3.40282346638528859812e+38f;
constexpr float kLog2e = 1.4426950408889634f;

// shared memory, from a 1024-aligned base
constexpr int kKTile = kPage * 128;        // bf16 K, d 0-63 or 64-127: [64 keys][128 B]
constexpr int kVTile = kD * 128;           // bf16 V^T: [128 d][128 B]
constexpr int kBuf = 2 * kKTile + kVTile;  // 32 KB
constexpr int kScales = 2 * kPage * 4;     // f32 k and v scales of a page
constexpr int kStage = 2 * kPage * kD + kScales;  // INT8 K, V, scales as the pool holds them
constexpr int kOffScale = kBufs * kBuf;
constexpr int kOffStage = kOffScale + kBufs * kScales;
constexpr int kOffPages = kOffStage + kRing * kStage;  // the walk's pool pages
constexpr int kOffBar = kOffPages + kMaxWalk * 4;
constexpr int kBars = kRing + 2 * kBufs;
constexpr int kSmem = kOffBar + 8 * kBars + 1024;  // + alignment slack
// a block's partial: acc [kRows][kD], then m [kRows], then l [kRows]
constexpr int kUnit = kRows * (kD + 2);

// wgmma shared-memory descriptor of a K-major tile with the 128-byte
// swizzle: rows of 64 bf16 (128 B), 8-row atoms 1024 B apart
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// byte offset of 16-byte chunk c of row r in a 128-byte-swizzled tile
__device__ __forceinline__ uint32_t sw128(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}

template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// 2^x (MUFU.EX2; 2^-huge = +0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// d[64 x 64] (+)= A[64 x 16] B[16 x 64]: A from registers in the m64k16
// fragment layout, B K-major in shared memory (128-byte swizzle); acc = 0
// overwrites d
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], const uint32_t (&a)[4],
                                                uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// d[64 x 128] (+)= A[64 x 16] B[16 x 128]: A from registers in the m64k16
// fragment layout, B K-major in shared memory (128-byte swizzle); acc = 0
// overwrites d
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], const uint32_t (&a)[4],
                                                uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// One landed INT8 page (stage) -> bf16 operands (buffer) and its scales;
// c is the thread's index among the converters.
__device__ __forceinline__ void convert_page(const unsigned char* stage, unsigned char* buf,
                                             float* scales, int c) {
  // K: thread c takes 16-byte chunks u = c + kConvThreads j (key u / 8, d
  // 16 (u % 8) .. + 15) and writes them as two bf16 chunks of its key's row
#pragma unroll
  for (int j = 0; j < kPage * 8 / kConvThreads; ++j) {
    const int u = c + kConvThreads * j, key = u >> 3, ch = u & 7;
    const uint4 w = *reinterpret_cast<const uint4*>(stage + key * kD + ch * 16);
    const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
    uint32_t r[8];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const uint32_t x = prmt(ws[e], 0u, 0x3120u);  // bytes (0, 2, 1, 3): pairs (d, d + 1)
      r[2 * e] = s8_pair_02(x);
      r[2 * e + 1] = s8_pair_13(x);
    }
    unsigned char* tile = buf + (ch >> 2) * kKTile;
    *reinterpret_cast<uint4*>(tile + sw128(key, (2 * ch) & 7)) = make_uint4(r[0], r[1], r[2], r[3]);
    *reinterpret_cast<uint4*>(tile + sw128(key, (2 * ch + 1) & 7)) =
        make_uint4(r[4], r[5], r[6], r[7]);
  }
  // V^T: the warps take the groups of 8 keys in turn, lane l the d 4 l ..
  // 4 l + 3; a group is one 16-byte chunk of each of the 4 V^T rows
  constexpr int kGroups = kPage / 8 / (kConvThreads / 32);  // a warp's groups
  const unsigned char* sv = stage + kPage * kD;
  unsigned char* vt = buf + 2 * kKTile;
  const int d0 = 4 * (c & 31);
#pragma unroll
  for (int grp = 0; grp < kGroups; ++grp) {
    const int kg = kGroups * (c >> 5) + grp;  // keys 8 kg .. 8 kg + 7
    uint32_t wv[8];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      wv[k] = *reinterpret_cast<const uint32_t*>(sv + (8 * kg + k) * kD + d0);
    uint32_t r[4][4];  // [d0 + dd][key pair]
#pragma unroll
    for (int kp = 0; kp < 4; ++kp) {
      const uint32_t x = prmt(wv[2 * kp], wv[2 * kp + 1], 0x5410u);  // d0, d0 + 1
      const uint32_t y = prmt(wv[2 * kp], wv[2 * kp + 1], 0x7632u);  // d0 + 2, d0 + 3
      r[0][kp] = s8_pair_02(x);
      r[1][kp] = s8_pair_13(x);
      r[2][kp] = s8_pair_02(y);
      r[3][kp] = s8_pair_13(y);
    }
#pragma unroll
    for (int dd = 0; dd < 4; ++dd)
      *reinterpret_cast<uint4*>(vt + sw128(d0 + dd, kg)) =
          make_uint4(r[dd][0], r[dd][1], r[dd][2], r[dd][3]);
  }
  if (c < 32)  // 64 K scales then 64 V scales
    reinterpret_cast<float4*>(scales)[c] =
        reinterpret_cast<const float4*>(stage + 2 * kPage * kD)[c];
}

__global__ void __launch_bounds__(kThreads, 1) prefill_attention_kernel(
    const __nv_bfloat16* __restrict__ q,  // [B, T, Hq, 128] (batch, token strides given)
    const int8_t* __restrict__ pool_k,    // [L, Ptot, Hkv, 64, 128]
    const int8_t* __restrict__ pool_v,
    const float* __restrict__ k_scale,  // [L, Ptot, Hkv, 64]
    const float* __restrict__ v_scale,
    const int* __restrict__ tables,     // [B, maxP], -1 pad
    const int* __restrict__ positions,  // [B, T], -1 pad row
    const int* __restrict__ ctx_lens,   // [B]
    __nv_bfloat16* __restrict__ out,    // [B, T, Hq, 128]
    float* __restrict__ ws,             // [B, Hkv, tiles, splits, kRows, 130] when split
    int* __restrict__ counters,         // [B * Hkv * tiles], zero between calls
    long long q_sb, long long q_st, int T, int hq, int hkv, int ptot, int maxp, int layer,
    int splits, float scale) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw0 = smem_u32(smem_raw);
  const uint32_t base = (raw0 + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw0);
  const uint32_t full8 = base + kOffBar, full16 = full8 + 8 * kRing, empty16 = full16 + 8 * kBufs;
  __shared__ int s_hi, s_last;

  const int tid = threadIdx.x;
  const int split = blockIdx.x % splits, tile = blockIdx.x / splits, tiles = gridDim.x / splits;
  const int h = blockIdx.y, bi = blockIdx.z;
  const int G = hq / hkv, rows = T * G, row0 = tile * kRows;
  const int ctx = ctx_lens[bi];
  const int* pos_b = positions + (size_t)bi * T;

  if (tid == 0) {
    s_hi = 0;
    for (int i = 0; i < kRing; ++i) mbar_init(full8 + 8 * i, 1);
    for (int i = 0; i < kBufs; ++i) {
      mbar_init(full16 + 8 * i, 1);
      mbar_init(empty16 + 8 * i, 8);  // the consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // the walk: pages [0, ceil(min(ctx, largest position of the rows + 1) / 64))
  const int t_first = row0 / G, t_last = (min(row0 + kRows, rows) - 1) / G;
  for (int t = t_first + tid; t <= t_last; t += kThreads) {
    const int p = pos_b[t];
    if (p >= 0) atomicMax(&s_hi, min(ctx, p + 1));
  }
  __syncthreads();
  const int npages = min((s_hi + kPage - 1) / kPage, maxp);
  const int eff = min(splits, max(1, npages / kMinPagesPerSplit));  // splits that walk
  if (split >= eff) return;
  const int per = (npages + eff - 1) / eff;
  const int pb = split * per;
  const int n = max(0, min(npages, pb + per) - pb);
  const int* table = tables + (size_t)bi * maxp + pb;  // the walk's entries
  int* pages = reinterpret_cast<int*>(smem + kOffPages);
  for (int i = tid; i < min(n, kMaxWalk); i += kThreads) pages[i] = table[i];
  __syncthreads();
  // the pool page of walk step i (-1: unmapped)
  auto page_of = [&](int i) { return i < kMaxWalk ? pages[i] : table[i]; };

  if (tid < kConvThreads) {  // the producer warpgroups: loads and conversion
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kConvRegs) : "memory");
    auto issue = [&](int i) {  // page pb + i -> stage i % kRing
      const int pg = max(page_of(i), 0);
      const size_t ph = ((size_t)layer * ptot + pg) * hkv + h;  // page-head
      const uint32_t st = base + kOffStage + (i % kRing) * kStage, bar = full8 + 8 * (i % kRing);
      mbar_expect_tx(bar, kStage);
      bulk_load(st, pool_k + ph * kPage * kD, kPage * kD, bar);
      bulk_load(st + kPage * kD, pool_v + ph * kPage * kD, kPage * kD, bar);
      bulk_load(st + 2 * kPage * kD, k_scale + ph * kPage, kPage * 4, bar);
      bulk_load(st + 2 * kPage * kD + kPage * 4, v_scale + ph * kPage, kPage * 4, bar);
    };
    if (tid == 0)
      for (int i = 0; i < min(n, kRing); ++i) issue(i);
    for (int i = 0; i < n; ++i) {
      const int s = i % kRing, nb = i % kBufs;
      mbar_wait(full8 + 8 * s, (i / kRing) & 1);
      if (i >= kBufs) mbar_wait(empty16 + 8 * nb, ((i / kBufs) - 1) & 1);
      convert_page(smem + kOffStage + s * kStage, smem + nb * kBuf,
                   reinterpret_cast<float*>(smem + kOffScale + nb * kScales), tid);
      // the generic-proxy writes become visible to wgmma (the async proxy)
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync 1, %0;\n" ::"n"(kConvThreads) : "memory");  // stage read: refill
      if (tid == 0) {
        mbar_arrive(full16 + 8 * nb);
        if (i + kRing < n) issue(i + kRing);
      }
    }
  } else {  // two consumer warpgroups of 64 rows
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kMathRegs) : "memory");
    const int ct = tid - kConvThreads, wg = ct >> 7, warp = (ct >> 5) & 3, lane = ct & 31;
    const int g = lane >> 2, t = lane & 3;
    // this thread's rows g and g + 8 of its warp: token, head, visible keys
    int lim[2], rowi[2];
    const __nv_bfloat16* qrow[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = row0 + wg * 64 + warp * 16 + g + 8 * hf;
      rowi[hf] = r;
      lim[hf] = 0;
      qrow[hf] = nullptr;
      if (r < rows) {
        const int tok = r / G, head = h * G + r % G;
        const int p = pos_b[tok];
        lim[hf] = p >= 0 ? min(ctx, p + 1) : 0;
        qrow[hf] = q + bi * q_sb + tok * q_st + (size_t)head * kD;
      }
    }
    // q as A fragments: qa[kk] = {(row g, d 16kk + 2t), (row g + 8, same),
    // (row g, d 16kk + 8 + 2t), (row g + 8, same)}, pairs of d
    uint32_t qa[8][4];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const __nv_bfloat16* qr = qrow[e & 1];
        qa[kk][e] = qr ? *reinterpret_cast<const uint32_t*>(qr + 16 * kk + 8 * (e >> 1) + 2 * t)
                       : 0u;
      }
    const float f = scale * kLog2e;  // scores in log2 units: exp2 below
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    float o[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) o[i] = 0.f;
    float s[32], alpha[2] = {1.f, 1.f};
    uint32_t pa[4][4];
    // S = Q K^T of page i, issued (it waits for the page's buffer)
    auto qk = [&](int i) {
      const int nb = i % kBufs;
      mbar_wait(full16 + 8 * nb, (i / kBufs) & 1);
      const uint32_t kb = base + nb * kBuf;
      const uint64_t d0 = sw128_desc(kb), d1 = sw128_desc(kb + kKTile);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        wgmma_m64n64k16(s, qa[kk], (kk < 4 ? d0 : d1) + 2 * (kk & 3), kk);
      wgmma_commit();
    };
    // O = alpha O + P V of page i, issued
    auto pv = [&](int i) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        o[4 * j] *= alpha[0];
        o[4 * j + 1] *= alpha[0];
        o[4 * j + 2] *= alpha[1];
        o[4 * j + 3] *= alpha[1];
      }
      const uint64_t dv = sw128_desc(base + (i % kBufs) * kBuf + 2 * kKTile);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_m64n128k16(o, pa[kk], dv + 2 * kk, 1);
      wgmma_commit();
    };
    // page i's scores (landed in s) -> its probabilities in s, alpha, l
    auto softmax = [&](int i) {
      const float* sc = reinterpret_cast<const float*>(smem + kOffScale + (i % kBufs) * kScales);
      const int key0 = (pb + i) * kPage;
      const bool page_ok = page_of(i) >= 0;
      const bool full = page_ok && key0 + kPage <= min(lim[0], lim[1]);
      // scale, mask: tile j holds keys 8j + 2t, + 1
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 ks = *reinterpret_cast<const float2*>(sc + 8 * j + 2 * t);
        const float f0 = f * ks.x, f1 = f * ks.y;
        const int key = key0 + 8 * j + 2 * t;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          float& x0 = s[4 * j + 2 * hf];
          float& x1 = s[4 * j + 2 * hf + 1];
          x0 *= f0;
          x1 *= f1;
          if (!full) {
            if (!page_ok || key >= lim[hf]) x0 = kNegInf;
            if (!page_ok || key + 1 >= lim[hf]) x1 = kNegInf;
          }
        }
      }
      // online softmax per row (a row's quad shares m)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float mx = m[hf];
#pragma unroll
        for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(s[4 * j + 2 * hf], s[4 * j + 2 * hf + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        alpha[hf] = ex2(m[hf] - mx);
        m[hf] = mx;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float e0 = ex2(s[4 * j + 2 * hf] - mx), e1 = ex2(s[4 * j + 2 * hf + 1] - mx);
          s[4 * j + 2 * hf] = e0;
          s[4 * j + 2 * hf + 1] = e1;
          sum += e0 + e1;
        }
        l[hf] = l[hf] * alpha[hf] + sum;
      }
    };
    // page i's probabilities times v_scale, rounded once, as PV's A
    // fragments: step kk takes keys 16kk .. 16kk + 15, the tiles 2kk, 2kk + 1
    auto make_pa = [&](int i) {
      const float* sc = reinterpret_cast<const float*>(smem + kOffScale + (i % kBufs) * kScales);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int j = 2 * kk + u;
          const float2 vs = *reinterpret_cast<const float2*>(sc + kPage + 8 * j + 2 * t);
          pa[kk][2 * u] = bf16_pair(s[4 * j] * vs.x, s[4 * j + 1] * vs.y);
          pa[kk][2 * u + 1] = bf16_pair(s[4 * j + 2] * vs.x, s[4 * j + 3] * vs.y);
        }
    };
    auto release = [&](int i) {  // this warp is done with page i's buffer
      __syncwarp();
      if (lane == 0) mbar_arrive(empty16 + 8 * (i % kBufs));
    };
    // page i's QK is issued before page i - 1's PV, and page i's softmax
    // runs while that PV does
    if (n > 0) {
      qk(0);
      wgmma_wait_all();
      fence_acc(s);
      softmax(0);
      make_pa(0);
    }
    for (int i = 1; i < n; ++i) {
      qk(i);
      pv(i - 1);
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");  // the QK
      fence_acc(s);
      softmax(i);
      wgmma_wait_all();
      fence_acc(o);
      release(i - 1);
      make_pa(i);
    }
    if (n > 0) {
      pv(n - 1);
      wgmma_wait_all();
      fence_acc(o);
      release(n - 1);
    }

#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 1);
      l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 2);
    }
    if (eff == 1) {  // the output: o / l, zeros for a pad row
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = rowi[hf];
        if (r >= rows) continue;
        const int tok = r / G, head = h * G + r % G;
        uint32_t* orow =
            reinterpret_cast<uint32_t*>(out + (((size_t)bi * T + tok) * hq + head) * kD);
        const float inv = lim[hf] > 0 ? 1.f / fmaxf(l[hf], 1e-30f) : 0.f;
#pragma unroll
        for (int j = 0; j < 16; ++j)
          orow[4 * j + t] = bf16_pair(o[4 * j + 2 * hf] * inv, o[4 * j + 2 * hf + 1] * inv);
      }
      return;
    }
    // this block's partial
    float* wsb = ws + ((((size_t)bi * hkv + h) * tiles + tile) * splits + split) * kUnit;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int lr = wg * 64 + warp * 16 + g + 8 * hf;
#pragma unroll
      for (int j = 0; j < 16; ++j)
        *reinterpret_cast<float2*>(wsb + lr * kD + 8 * j + 2 * t) =
            make_float2(o[4 * j + 2 * hf], o[4 * j + 2 * hf + 1]);
      if (t == 0) {
        wsb[kRows * kD + lr] = m[hf];
        wsb[kRows * kD + kRows + lr] = l[hf];
      }
    }
  }
  if (eff == 1) return;

  // the last block of the row tile to arrive merges the splits in order
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int slot = (bi * hkv + h) * tiles + tile;
    s_last = atomicAdd(&counters[slot], 1) == eff - 1;
    if (s_last) counters[slot] = 0;  // ready for the next call
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const float* wl = ws + (((size_t)bi * hkv + h) * tiles + tile) * splits * kUnit;
  // each row's weight a split, over the row's sum (0 for a row that sees
  // nothing), into the drained ring: coef[s][row]
  float* coef = reinterpret_cast<float*>(smem + kOffStage);
  if (tid < kRows) {
    const int r = row0 + tid;
    float mm = kNegInf;
    for (int s = 0; s < eff; ++s) mm = fmaxf(mm, __ldcg(wl + s * kUnit + kRows * kD + tid));
    float ll = 0.f;
    for (int s = 0; s < eff; ++s) {
      const float* e = wl + s * kUnit + kRows * kD;
      const float w = ex2(__ldcg(e + tid) - mm);
      coef[s * kRows + tid] = w;
      ll = fmaf(__ldcg(e + kRows + tid), w, ll);
    }
    const bool seen = r < rows && min(ctx, pos_b[r / G] + 1) > 0;
    const float inv = seen ? 1.f / fmaxf(ll, 1e-30f) : 0.f;
    for (int s = 0; s < eff; ++s) coef[s * kRows + tid] *= inv;
  }
  __syncthreads();
  // the output, four values an item, four items a thread in flight
  constexpr int kItems = kRows * kD / 4;
  for (int i0 = tid; i0 < kItems; i0 += 4 * kThreads) {
    float4 acc[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) acc[u] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s = 0; s < eff; ++s) {
      const float4* part = reinterpret_cast<const float4*>(wl + s * kUnit);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int it = i0 + u * kThreads;
        if (it < kItems) {
          const float4 a = __ldcg(part + it);
          const float c = coef[s * kRows + it / (kD / 4)];
          acc[u].x = fmaf(a.x, c, acc[u].x);
          acc[u].y = fmaf(a.y, c, acc[u].y);
          acc[u].z = fmaf(a.z, c, acc[u].z);
          acc[u].w = fmaf(a.w, c, acc[u].w);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int it = i0 + u * kThreads, lr = it / (kD / 4), r = row0 + lr;
      if (it >= kItems || r >= rows) continue;
      const int tok = r / G, head = h * G + r % G, d = 4 * (it % (kD / 4));
      *reinterpret_cast<uint2*>(out + (((size_t)bi * T + tok) * hq + head) * kD + d) =
          make_uint2(bf16_pair(acc[u].x, acc[u].y), bf16_pair(acc[u].z, acc[u].w));
    }
  }
}

cudaError_t prepare() {
  static bool done = false;
  if (!done) {
    const cudaError_t e = cudaFuncSetAttribute(
        prefill_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (e != cudaSuccess) return e;
    done = true;
  }
  return cudaSuccess;
}

}  // namespace

// K5 on the current stream; returns cudaGetLastError() after the launch.
// splits > 1 needs ws and counters; the grid is (tiles x splits, Hkv, B).
extern "C" int pie_prefill_attention(const void* q, const void* pool_k, const void* pool_v,
                                     const void* k_scale, const void* v_scale,
                                     const void* tables, const void* positions,
                                     const void* ctx_lens, void* out, void* ws, void* counters,
                                     long long q_sb, long long q_st, int B, int T, int hq,
                                     int hkv, int ptot, int maxp, int layer, int splits,
                                     float scale, void* stream) {
  if (B < 1 || T < 1 || hkv < 1 || hq < hkv || hq % hkv != 0 || ptot < 1 || maxp < 1 ||
      layer < 0 || splits < 1 || (splits > 1 && (ws == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = prepare();
  if (e != cudaSuccess) return (int)e;
  const int tiles = (T * (hq / hkv) + kRows - 1) / kRows;
  const dim3 grid(tiles * splits, hkv, B);
  prefill_attention_kernel<<<grid, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const int8_t*>(pool_k),
      static_cast<const int8_t*>(pool_v), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(tables),
      static_cast<const int*>(positions), static_cast<const int*>(ctx_lens),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(ws), static_cast<int*>(counters),
      q_sb, q_st, T, hq, hkv, ptot, maxp, layer, splits, scale);
  return (int)cudaGetLastError();
}

// geo = {registers a thread, local (spill) bytes a thread, dynamic shared
// memory bytes, resident blocks an SM}
extern "C" int pie_prefill_attention_geometry(int* geo) {
  cudaError_t e = prepare();
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes a;
  e = cudaFuncGetAttributes(&a, prefill_attention_kernel);
  if (e != cudaSuccess) return (int)e;
  geo[0] = a.numRegs;
  geo[1] = (int)a.localSizeBytes;
  geo[2] = kSmem;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&geo[3], prefill_attention_kernel,
                                                           kThreads, kSmem);
}
