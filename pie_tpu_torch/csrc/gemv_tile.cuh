// The decode GEMV pieces shared by K1 (quant_gemv.cu) and K4 (fused_mlp.cu):
// the geometry and byte layout of a ring stage, the conversion of packed
// INT4 codes into exact bf16 mma operands, the x sums, the consumer
// barrier. quant_gemv.cu describes the design. Each kernel keeps its own
// copy of the consumer loop over a stage: compiled through a shared
// function, K1's loop came out ten instructions longer per stage and K1 ran
// 1.6-1.8 % slower on the H100 (tools/decode_ab.py).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace pie {
namespace gemv {

constexpr int BF = 128;                   // output features per block tile
constexpr int KS = 128;                   // K rows per ring stage
constexpr int kConsumers = 256;           // 8 warps of 16 features
constexpr int kThreads = kConsumers + 64; // + the TMA warp and the x warp
constexpr int CP = BF + 4;                // f32 epilogue row length (per token)
constexpr int kMaxStages = 8;
constexpr int kRingBudget = 100 * 1024;   // two blocks per SM
constexpr int kBarBytes = 3 * 8 * kMaxStages + 16;

// A stage: x boxes [mp][64] bf16 x 2 | words 4 x [KS/ep][32] | scale rows
// [KS/g][BF] (K1) or two [KS/g][64] halves (K4) | bias rows, as scales |
// 32-row x sums [4][mp] f32.
__host__ __device__ constexpr int words_bytes(int bits) { return KS * bits / 32 * BF * 4; }
__host__ __device__ constexpr int sb_bytes(int g, bool f32s) { return KS / g * BF * (f32s ? 4 : 2); }
__host__ __device__ constexpr int tx_bytes(int bits, bool f32s, int g, int mp) {
  return 2 * mp * 128 + words_bytes(bits) + 2 * sb_bytes(g, f32s);
}
__host__ __device__ constexpr int stage_bytes(int bits, bool f32s, int g, int mp) {
  return (tx_bytes(bits, f32s, g, mp) + 4 * mp * 4 + 1023) / 1024 * 1024;
}
__host__ __device__ constexpr int ring_stages(int bits, bool f32s, int g, int mp) {
  return kRingBudget / stage_bytes(bits, f32s, g, mp) < kMaxStages
             ? kRingBudget / stage_bytes(bits, f32s, g, mp)
             : kMaxStages;
}
static_assert(ring_stages(8, true, 32, 32) >= 2, "ring too small");

// Byte offsets inside a stage of mp = 8 NT tokens.
template <int BITS, bool F32S, int G, int MP>
struct Stage {
  static constexpr int offW = 2 * MP * 128;
  static constexpr int offS = offW + words_bytes(BITS);
  static constexpr int offB = offS + sb_bytes(G, F32S);
  static constexpr int offSum = offB + sb_bytes(G, F32S);
  static constexpr int bytes = stage_bytes(BITS, F32S, G, MP);
  static constexpr int stages = ring_stages(BITS, F32S, G, MP);
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the 8 consumer warps only (barrier 0 is __syncthreads)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// bf16x2 (q_i, q_{i+4}), exact, of the INT4 codes in nibbles i and i + 4
// of w, sh = 4i: one shift and one lop3 give 128 + q, one fma q
__device__ __forceinline__ uint32_t int4_pair_w(uint32_t w, int sh) {
  uint32_t v;
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;\n" : "=r"(v) : "r"(w >> sh), "r"(0x000F000Fu),
      "r"(0x43004300u));
  return bf16x2_fma(v, 0x3F803F80u, 0xC300C300u);
}

// sum of the 8 bf16 values of v, in f32
__device__ __forceinline__ float sum8(uint4 v) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    s += __uint_as_float(w[i] << 16) + __uint_as_float(w[i] & 0xFFFF0000u);
  return s;
}

}  // namespace gemv
}  // namespace pie
