// K2: prefill dequant GEMM with group-wise affine INT4/INT8 weights, M > 32.
//
// Replaces the prefill branch of the TPU kernel in
// pie_tpu/ops/quant_matmul_pallas.py (quant_matmul_stacked and
// quant_matmul_pallas -> _kernel -> _accum_block, the `prep` dequantization
// followed by one deep MXU dot per 512-row tile).
//
// Computes y = x @ W with W[k, n] = q*s + b dequantized to bf16, f32
// accumulation on the tensor cores and a bf16 output. Every weight rounds
// once, as the plain version's bf16(q*s + b) does: bf16(fma(1 + q/2^bits,
// 2^bits*s, b - 2^bits*s)) in f32, K1's arithmetic. With bf16 scales the
// product and b - 2^bits*s are exact in f32, so the weights equal the plain
// version's bit for bit (tests/test_torch_k2_numerics.py); with f32 scales
// (a tied head) q*s itself may round in the plain version. The JAX prefill
// branch rounds once too (codes times bf16 16s, the bias through a
// separate f32 dot).
//
// Bound on the H100: operations from M ~ 300 up (2*M*K*N over 989 TFLOP/s
// bf16 against one read of the packed weights), bytes below that.
//
// Design (Hopper: TMA, an mbarrier ring, wgmma with A in registers). An
// earlier wmma design ran 76.44 ms per 8B 512-token prefill; its five
// faults and what this one does:
// 1. Old tensor-core path -> wgmma.mma_async m64n256k16 in the transposed
//    form y^T = W^T x^T: the dequantized weights are the A operand, in
//    registers (64 output features per consumer warpgroup), x the B operand
//    from shared memory (256 tokens, K-major with the 128-byte swizzle, as
//    TMA writes it). A block owns 128 features x 256 tokens.
// 2. No copy/compute overlap -> warp specialisation: one producer thread
//    keeps a ring of stages in flight with TMA copies (the x tile
//    [256, 64], the packed words [64/ep, 128] and the step's scale and bias
//    rows), each guarded by a full mbarrier (TMA transaction bytes) and an
//    empty one (the consumers' release). Each consumer thread builds its A
//    fragments for step k+1 in a second register set while step k's wgmma
//    runs; the two warpgroups never wait for each other inside the loop.
//    setmaxnreg moves registers from the producer warpgroup to the
//    consumers' 128 accumulators and two fragment sets.
// 3. Expensive dequantization -> a thread needs codes 2t, 2t+1 of its
//    features' words (t = lane % 4), byte t of each: the two codes are or'ed
//    into the mantissa of f32 1.0 (1 + q/2^bits, exact), one f32 fma each
//    with the step's 2^bits*s and b - 2^bits*s, one bf16x2 pack. (An
//    earlier bf16x2-fma form rounded INT4 weights twice, bf16(bf16(q*s) +
//    b).) The weights go from shared memory to registers with no B tile
//    written or read back, and each is dequantized once per 256 tokens
//    (once per 128 with a B tile in shared memory). A step's scale and bias
//    are prepared once per thread.
// 4. Grid under-fills the card at small M -> split-K: where the output
//    tiles fill at most half of the SMs, blockIdx.z takes a range of K steps
//    (on group boundaries), writes f32 partials to a workspace, and the last
//    block of the tile to arrive (an atomic counter, reset by that block)
//    sums them in split order and runs the epilogue. The split is chosen by
//    gemm_plan in ops/quant_matmul_cuda.py. One call is one launch.
// 5. Low occupancy -> one block of 384 threads per SM with ~185 KB of
//    ring; latency is hidden by the ring, not by more blocks. Blocks
//    sharing a weight tile are launched together (token tiles vary
//    fastest), so a weight tile comes from HBM once and from L2 after.
// Tensor maps are encoded on the host for every call (about 0.4 us for the
// four, so no cache), on the layer's own pointer. Open: at M <= 64 the
// 256-token tile multiplies mostly zero rows.
//
// Epilogue: the accumulators ([feature][token]) go to shared memory as an
// f32 tile [token][feature] (aliasing the drained ring); with rope_dim != 0
// each dh-sized head group rotates exactly as K1's epilogue does,
// y*cos + roll_half(y)*sin with the cos/sin rows of rope_qkv_cs (dh | 128,
// so a head and its partners dh/2 further on lie in the tile); then
// 16-byte bf16 row stores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <chrono>

#include "hopper.cuh"

namespace {

// A block owns BF = 128 output features (two consumer warpgroups of 64,
// the wgmma M) and BT = 256 tokens (the wgmma N), in 64-row K steps.
constexpr int BT = 256, BF = 128, BK = 64;
constexpr int kConsumers = 256;
constexpr int kThreads = 128 + kConsumers;
constexpr int CP = BF + 4;                      // f32 epilogue row length (per token)

// A stage: the x tile ([BT][BK] bf16, 128B swizzle), the packed words
// ([BK/ep][BF]), the step's scale and bias rows ([BK/g or 1][BF]); sized for
// its bit width, scale type and group size, as many as fit (5 here).
constexpr int kOffA = 0, kOffW = BT * BK * 2;
constexpr int kMaxRawStages = 5;
constexpr int kBarBytes = 16 * kMaxRawStages + 16;
constexpr int kSmemLimit = 232448;
constexpr int kAlignSlack = 1024;

__host__ __device__ constexpr int words_bytes(int bits) { return (BK * bits / 32) * BF * 4; }
__host__ __device__ constexpr int sb_rows(int g) { return g < BK ? BK / g : 1; }
__host__ __device__ constexpr int raw_bytes(int bits, bool f32s, int g) {
  return (kOffW + words_bytes(bits) + 2 * sb_rows(g) * BF * (f32s ? 4 : 2) + 1023) / 1024 * 1024;
}
__host__ __device__ constexpr int raw_stages(int bits, bool f32s, int g) {
  return (kSmemLimit - kAlignSlack - kBarBytes) / raw_bytes(bits, f32s, g) < kMaxRawStages
             ? (kSmemLimit - kAlignSlack - kBarBytes) / raw_bytes(bits, f32s, g)
             : kMaxRawStages;
}
static_assert(BT * CP * 4 <= raw_stages(8, true, 32) * raw_bytes(8, true, 32),
              "epilogue tile must fit in the ring");

using pie::bf16_pair;
using pie::encode_2d;
using pie::mbar_arrive;
using pie::mbar_expect_tx;
using pie::mbar_init;
using pie::mbar_wait;
using pie::smem_u32;
using pie::tma_load_2d;

// the two consumer warpgroups only (barrier 0 is __syncthreads)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

__device__ __forceinline__ void fence_regs(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// wgmma shared-memory descriptor of a K-major tile with the 128-byte
// swizzle: rows of 64 bf16 (128 B), 8-row atoms 1024 B apart
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void fence_acc(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 256] += A[64 x 16] * B[16 x 256]: A (weights) from registers in
// the m64k16 fragment layout, B (x) K-major in shared memory
__device__ __forceinline__ void wgmma_rs_m64n256k16(float (&d)[128], const uint32_t (&a)[4],
                                                    uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <bool F32S>
__device__ __forceinline__ float affine(const unsigned char* row, int n) {
  return F32S ? reinterpret_cast<const float*>(row)[n]
              : __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(row)[n]);
}

// One step's A fragments for this thread: features f0 and f0 + 8 (of the
// block's 128), k pairs 2t, 2t+1 of each 8-row chunk (t = lane % 4), slice
// kk of 16 rows: a[kk] = {(f0, chunk 2kk), (f0+8, 2kk), (f0, 2kk+1), (f0+8, 2kk+1)}.
template <int BITS, bool F32S>
__device__ __forceinline__ void build_frags(const unsigned char* raw, uint32_t (&a)[4][4],
                                            int f0, int t, int g) {
  constexpr int ES = F32S ? 4 : 2;
  const uint32_t* W = reinterpret_cast<const uint32_t*>(raw + kOffW);
  const unsigned char* srows = raw + kOffW + words_bytes(BITS);
  const unsigned char* brows = srows + sb_rows(g) * BF * ES;
  const int row1 = g == 32 ? BF * ES : 0;  // chunks 4-7's scale row
  constexpr float P = (float)(1 << BITS);
  float sp[2][2], be[2][2];
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int f = f0 + 8 * h;
      sp[q][h] = affine<F32S>(srows + q * row1, f) * P;
      be[q][h] = affine<F32S>(brows + q * row1, f) - sp[q][h];
    }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int c = 2 * kk + (r >> 1), h = r & 1, q = c >> 2;
      float lo, hi;
      if constexpr (BITS == 4) {
        const uint32_t w = W[c * BF + f0 + 8 * h] >> (8 * t);  // codes 2t, 2t+1 at bits 0-7
        lo = __uint_as_float(((w & 0xFu) << 19) | 0x3F800000u);
        hi = __uint_as_float(((w & 0xF0u) << 15) | 0x3F800000u);
      } else {  // word row 2c + t/2 holds rows 8c + 4(t/2) .. +3; ours are bytes 2(t%2), +1
        const uint32_t w = W[(2 * c + (t >> 1)) * BF + f0 + 8 * h] >> (16 * (t & 1));
        lo = __uint_as_float(((w & 0xFFu) << 15) | 0x3F800000u);
        hi = __uint_as_float(((w & 0xFF00u) << 7) | 0x3F800000u);
      }
      a[kk][r] = bf16_pair(fmaf(lo, sp[q][h], be[q][h]), fmaf(hi, sp[q][h], be[q][h]));
    }
}

template <int BITS, bool F32S>
__global__ void __launch_bounds__(kThreads, 1) gemm_kernel(
    const __grid_constant__ CUtensorMap map_x,  // x [M, Kp] bf16, box [256, 64]
    const __grid_constant__ CUtensorMap map_w,  // words [Kp/ep, N], box [64/ep, 128]
    const __grid_constant__ CUtensorMap map_s,  // scales [Kp/g, N], box [rows, 128]
    const __grid_constant__ CUtensorMap map_b,  // biases, as scales
    const float* __restrict__ cosv, const float* __restrict__ sinv,
    __nv_bfloat16* __restrict__ y, float* __restrict__ ws, int* __restrict__ counters,
    int M, int N, int g, int nsteps, int per_split, int rope_dim) {
  constexpr int EP = 32 / BITS;
  constexpr int ES = F32S ? 4 : 2;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw0 = smem_u32(smem_raw);
  const uint32_t base = (raw0 + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw0);
  const int rbytes = raw_bytes(BITS, F32S, g), stages = raw_stages(BITS, F32S, g);
  const int bars = stages * rbytes;
  const uint32_t full0 = base + bars, empty0 = full0 + 8 * kMaxRawStages;
  int* flag = reinterpret_cast<int*>(smem + bars + 16 * kMaxRawStages);

  const int row0 = blockIdx.x * BT, col0 = blockIdx.y * BF;  // tokens, features
  const int k_begin = blockIdx.z * per_split;
  const int nk = min(nsteps, k_begin + per_split) - k_begin;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer warpgroup: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      const uint32_t tx = BT * BK * 2 + words_bytes(BITS) + 2 * sb_rows(g) * BF * ES;
      const uint32_t off_s = kOffW + words_bytes(BITS), off_b = off_s + sb_rows(g) * BF * ES;
      for (int i = 0; i < nk; ++i) {
        const int s = i % stages;
        if (i >= stages) mbar_wait(empty0 + 8 * s, ((i / stages) - 1) & 1);
        const uint32_t st = base + s * rbytes, bar = full0 + 8 * s;
        const int ks = k_begin + i;
        mbar_expect_tx(bar, tx);
        tma_load_2d(st + kOffA, &map_x, bar, ks * BK, row0);
        tma_load_2d(st + kOffW, &map_w, bar, col0, ks * (BK / EP));
        tma_load_2d(st + off_s, &map_s, bar, col0, ks * BK / g);
        tma_load_2d(st + off_b, &map_b, bar, col0, ks * BK / g);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int ct = threadIdx.x - 128;
  const int wg = ct >> 7, warp = (ct >> 5) & 3, lane = ct & 31;
  const int f0 = wg * 64 + warp * 16 + (lane >> 2), t = lane & 3;
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  uint32_t fa[4][4], fb[4][4];

  // one step: multiply step i with `cur`, then build step i + 1 into `nxt`
  // (last read by step i - 1's wgmma, which the wait below retires)
  auto step = [&](int i, uint32_t (&cur)[4][4], uint32_t (&nxt)[4][4]) {
    const int s = i % stages;
    const uint64_t db = sw128_desc(base + s * rbytes + kOffA);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) wgmma_rs_m64n256k16(acc, cur[kk], db + 2 * kk);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    fence_acc(acc);
    fence_regs(nxt);
    if (i > 0 && lane == 0) mbar_arrive(empty0 + 8 * ((i - 1) % stages));
    if (i + 1 < nk) {
      const int s1 = (i + 1) % stages;
      mbar_wait(full0 + 8 * s1, ((i + 1) / stages) & 1);
      build_frags<BITS, F32S>(smem + s1 * rbytes, nxt, f0, t, g);
    }
  };
  mbar_wait(full0, 0);
  build_frags<BITS, F32S>(smem, fa, f0, t, g);
  for (int i = 0; i < nk; i += 2) {
    step(i, fa, fb);
    if (i + 1 < nk) step(i + 1, fb, fa);
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_acc(acc);
  fence_regs(fa);
  fence_regs(fb);
  consumer_sync();  // every wgmma has read its operands: the ring is free

  // epilogue: accumulators [feature][token] -> f32 tile Ct[token][feature]
  float* Ct = reinterpret_cast<float*>(smem);
  {
    const int fl = wg * 64 + warp * 16 + (lane >> 2);
#pragma unroll
    for (int j = 0; j < BT / 8; ++j) {
      const int n = 8 * j + 2 * t;
      Ct[n * CP + fl] = acc[4 * j];
      Ct[(n + 1) * CP + fl] = acc[4 * j + 1];
      Ct[n * CP + fl + 8] = acc[4 * j + 2];
      Ct[(n + 1) * CP + fl + 8] = acc[4 * j + 3];
    }
  }
  consumer_sync();
  const int rows = min(BT, M - row0);
  const int splits = gridDim.z;
  if (splits > 1) {
    float* part = ws + (size_t)blockIdx.z * M * N;
    for (int e = ct; e < rows * (BF / 4); e += kConsumers) {
      const int r = e / (BF / 4), c = (e % (BF / 4)) * 4;
      if (col0 + c < N)
        *reinterpret_cast<float4*>(part + (size_t)(row0 + r) * N + col0 + c) =
            *reinterpret_cast<const float4*>(Ct + r * CP + c);
    }
    __threadfence();
    consumer_sync();
    if (ct == 0) {
      int* cnt = counters + blockIdx.y * gridDim.x + blockIdx.x;
      const int last = atomicAdd(cnt, 1) == splits - 1;
      if (last) *cnt = 0;
      *flag = last;
    }
    consumer_sync();
    if (!*flag) return;
    __threadfence();
    for (int e = ct; e < rows * (BF / 4); e += kConsumers) {
      const int r = e / (BF / 4), c = (e % (BF / 4)) * 4;
      if (col0 + c >= N) continue;
      float4* own = reinterpret_cast<float4*>(Ct + r * CP + c);
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int sp = 0; sp < splits; ++sp) {
        const float4 p = sp == (int)blockIdx.z
                             ? *own
                             : __ldcg(reinterpret_cast<const float4*>(
                                   ws + ((size_t)sp * M + row0 + r) * N + col0 + c));
        v.x += p.x; v.y += p.y; v.z += p.z; v.w += p.w;
      }
      *own = v;
    }
    consumer_sync();
  }
  const int half = rope_dim >> 1;
  for (int e = ct; e < rows * (BF / 8); e += kConsumers) {
    const int r = e / (BF / 8), c = (e % (BF / 8)) * 8;
    if (col0 + c >= N) continue;
    const float* src = Ct + r * CP + c;
    float v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = src[i];
    const size_t o = (size_t)(row0 + r) * N + col0 + c;
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
                 const void* biases, int M, int Kp, int N, int bits, int g, bool f32s) {
  const int ep = 32 / bits, es = f32s ? 4 : 2;
  const CUtensorMapDataType st =
      f32s ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  return encode_2d(&m->x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, Kp, M, (uint64_t)Kp * 2, BK, BT,
                   CU_TENSOR_MAP_SWIZZLE_128B) &&
         encode_2d(&m->w, CU_TENSOR_MAP_DATA_TYPE_INT32, packed, N, Kp / ep, (uint64_t)N * 4, BF,
                   BK / ep, CU_TENSOR_MAP_SWIZZLE_NONE) &&
         encode_2d(&m->s, st, scales, N, Kp / g, (uint64_t)N * es, BF, sb_rows(g),
                   CU_TENSOR_MAP_SWIZZLE_NONE) &&
         encode_2d(&m->b, st, biases, N, Kp / g, (uint64_t)N * es, BF, sb_rows(g),
                   CU_TENSOR_MAP_SWIZZLE_NONE);
}

template <int BITS, bool F32S>
cudaError_t launch(const Maps& m, const void* cosv, const void* sinv, void* y, void* ws,
                   void* counters, int splits, int per_split, int M, int Kp, int N, int g,
                   int rope_dim, cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        gemm_kernel<BITS, F32S>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const int smem = kAlignSlack + raw_stages(BITS, F32S, g) * raw_bytes(BITS, F32S, g) + kBarBytes;
  const dim3 grid((M + BT - 1) / BT, (N + BF - 1) / BF, splits);
  gemm_kernel<BITS, F32S><<<grid, kThreads, smem, stream>>>(
      m.x, m.w, m.s, m.b, static_cast<const float*>(cosv), static_cast<const float*>(sinv),
      static_cast<__nv_bfloat16*>(y), static_cast<float*>(ws), static_cast<int*>(counters), M, N,
      g, Kp / BK, per_split, rope_dim);
  return cudaGetLastError();
}

bool valid(int M, int Kp, int N, int bits, int g) {
  return M >= 1 && N >= 8 && N % 8 == 0 && Kp >= BK && Kp % BK == 0 && (bits == 4 || bits == 8) &&
         (g == 32 || g == 64 || g == 128);
}

}  // namespace

// y[M, N] = x[M, Kp] @ bf16(dequant(W)) (+ the rope epilogue when
// rope_dim != 0: cos/sin [M, N] f32, 32 | dh, dh | 128, dh | N). K is
// split into `splits` ranges of `per_split` 64-row steps (a multiple of
// g / 64 steps); with splits > 1, ws is [splits, M, N] f32 scratch and
// counters one zeroed int per output tile. N must be a multiple of
// 8 (TMA's 16-byte row strides). Scales and biases are bf16, or f32 when
// scale_f32 != 0. Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for arguments the kernel does not take).
extern "C" int pie_quant_gemm(const void* x, const void* packed, const void* scales,
                              const void* biases, const void* cosv, const void* sinv, void* y,
                              void* ws, void* counters, int splits, int per_split, int M,
                              int Kp, int N, int bits, int group_size, int scale_f32,
                              int rope_dim, void* stream) {
  const int nsteps = Kp / BK, unit = group_size > BK ? group_size / BK : 1;
  if (!valid(M, Kp, N, bits, group_size) || splits < 1 || per_split < 1 ||
      per_split % unit != 0 || (splits - 1) * per_split >= nsteps ||
      splits * per_split < nsteps ||
      (splits > 1 && (ws == nullptr || counters == nullptr)) ||
      (rope_dim != 0 && (rope_dim % 32 != 0 || BF % rope_dim != 0 || N % rope_dim != 0 ||
                         cosv == nullptr || sinv == nullptr)))
    return (int)cudaErrorInvalidValue;
  Maps m;
  if (!encode_maps(&m, x, packed, scales, biases, M, Kp, N, bits, group_size, scale_f32 != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PIE_GEMM_LAUNCH(B, F)                                                                  \
  return (int)launch<B, F>(m, cosv, sinv, y, ws, counters, splits, per_split, M, Kp, N,        \
                           group_size, rope_dim, st)
  if (bits == 4) {
    if (scale_f32) PIE_GEMM_LAUNCH(4, true);
    PIE_GEMM_LAUNCH(4, false);
  }
  if (scale_f32) PIE_GEMM_LAUNCH(8, true);
  PIE_GEMM_LAUNCH(8, false);
#undef PIE_GEMM_LAUNCH
}

// Mean host nanoseconds to encode the four tensor maps of one call, over
// `reps` encodings (what a call adds on the host before its launch); -1 if
// the maps do not encode.
extern "C" int pie_quant_gemm_encode_ns(const void* x, const void* packed, const void* scales,
                                        const void* biases, int M, int Kp, int N, int bits,
                                        int group_size, int scale_f32, int reps) {
  if (!valid(M, Kp, N, bits, group_size) || reps < 1) return -1;
  Maps m;
  const auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < reps; ++i)
    if (!encode_maps(&m, x, packed, scales, biases, M, Kp, N, bits, group_size, scale_f32 != 0))
      return -1;
  const auto t1 = std::chrono::steady_clock::now();
  return (int)(std::chrono::duration_cast<std::chrono::nanoseconds>(t1 - t0).count() / reps);
}
