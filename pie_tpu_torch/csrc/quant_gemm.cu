// K2: prefill dequant GEMM with group-wise affine INT4/INT8 weights, M > 32.
//
// Replaces the prefill branch of the TPU kernel in
// pie_tpu/ops/quant_matmul_pallas.py (quant_matmul_stacked and
// quant_matmul_pallas -> _kernel -> _accum_block, the `prep` per-element
// dequantization followed by one deep MXU dot per 512-row tile).
//
// Computes y = x @ bf16(q * s + b) with f32 accumulation and a bf16 output.
// Each weight is dequantized exactly as the plain PyTorch version does it:
// q * s rounded to f32, plus b rounded to f32, then rounded to bf16 (the
// _rn intrinsics keep nvcc from contracting the two into one fma), so the
// weights agree bit for bit and only the order of the f32 sums differs.
//
// Bound on the H100: operations. A 512-token prefill does 2*M*K*N flops
// against one read of the packed weights, hundreds of operations per byte,
// above the ~295 where the bf16 tensor cores (989 TFLOP/s) become the limit.
//
// First design: a 128x128 output tile per block of 8 warps, K in steps of
// 64 rows. Each step dequantizes the 64x128 weight tile from its packed
// words into a bf16 shared-memory tile beside the x tile, and the warps
// multiply on the tensor cores with nvcuda::wmma (bf16 16x16x16, f32
// accumulators; each warp owns 64x32 of the output). Two shared-memory
// stages and a register prefetch overlap the next step's global loads
// with this step's multiplies (one barrier per step). Ragged M and N edges
// are masked on load and store. Not yet done: TMA, wgmma and warp
// specialisation, which the full tensor-core rate needs.
//
// Epilogue: the block's 128x128 f32 tile goes through shared memory (the
// operand stages are free by then) and leaves as coalesced bf16 rows. With
// rope_dim != 0 it first rotates each dh-sized head group exactly as K1's
// epilogue does, y*cos + roll_half(y)*sin with the cos/sin rows of
// rope_qkv_cs: dh divides 128, so a head and its rotation partners dh/2
// further on lie in the same tile (the mixed continuous-batching step fuses
// rope into its QKV projection at M = lanes + rider).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "quant_tile.cuh"

namespace {

using namespace nvcuda;

constexpr int BM = 128, BN = 128, BK = 64;
constexpr int kThreads = 256;
constexpr int AP = BK + 8;  // padded smem row lengths (bf16 elements)
constexpr int BP = BN + 8;
constexpr int CP = BN + 4;  // f32 epilogue tile row length

constexpr int kStageBytes = 2 * (BM * AP + BK * BP) * 2;  // two operand stages
constexpr int kTileBytes = BM * CP * 4;                   // epilogue tile, aliased
constexpr int kSmemBytes = kStageBytes > kTileBytes ? kStageBytes : kTileBytes;

template <int BITS>
__global__ void __launch_bounds__(kThreads) gemm_kernel(
    const __nv_bfloat16* __restrict__ x,       // [M, Kp]
    const uint32_t* __restrict__ packed,       // [Kp / ep, N]
    const void* __restrict__ scales,           // [Kp / g, N] bf16 or f32
    const void* __restrict__ biases,           // [Kp / g, N] as scales
    const float* __restrict__ cosv,            // [M, N] or null
    const float* __restrict__ sinv,            // [M, N] or null
    __nv_bfloat16* __restrict__ y,             // [M, N]
    int M, int Kp, int N, int g, int rope_dim, bool f32s) {
  constexpr int EP = 32 / BITS;
  constexpr uint32_t MASK = (1u << BITS) - 1u;
  constexpr int A_LOADS = BM * BK / 8 / kThreads;    // 16-byte x loads per thread
  constexpr int W_LOADS = BK / EP / (kThreads / BN);  // packed words per thread
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);  // [2][BM * AP]
  __nv_bfloat16* Bs = As + 2 * BM * AP;                        // [2][BK * BP]
  float* Ct = reinterpret_cast<float*>(smem);                  // [BM * CP], after the loop

  const int tid = threadIdx.x, warp = tid >> 5;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int wm = warp >> 2, wn = warp & 3;  // warp tile: rows wm*64, cols wn*32

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int bn = tid % BN, bj = tid / BN;  // weight-tile column, word-row phase
  const int gcol = col0 + bn;
  const bool col_ok = gcol < N;

  // registers holding the next step's tiles while this step multiplies
  uint4 ra[A_LOADS];
  uint32_t rw[W_LOADS];
  float rs[2], rb[2];  // scale/bias of the step's rows [0, 32) and [32, 64)

  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < A_LOADS; ++i) {
      const int idx = tid + i * kThreads;
      const int r = idx / (BK / 8), c = (idx % (BK / 8)) * 8;
      ra[i] = row0 + r < M
                  ? *reinterpret_cast<const uint4*>(x + (size_t)(row0 + r) * Kp + k0 + c)
                  : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int j = 0; j < W_LOADS; ++j)
      rw[j] = col_ok ? __ldg(packed + (size_t)(k0 / EP + bj + j * (kThreads / BN)) * N + gcol)
                     : 0u;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      rs[h] = rb[h] = 0.f;
      if (col_ok) {
        const size_t gi = (size_t)((k0 + h * (BK / 2)) / g) * N + gcol;
        rs[h] = pie::load_affine(scales, gi, f32s);
        rb[h] = pie::load_affine(biases, gi, f32s);
      }
    }
  };

  auto store = [&](int stage) {
    __nv_bfloat16* as = As + stage * BM * AP;
    __nv_bfloat16* bs = Bs + stage * BK * BP;
#pragma unroll
    for (int i = 0; i < A_LOADS; ++i) {
      const int idx = tid + i * kThreads;
      const int r = idx / (BK / 8), c = (idx % (BK / 8)) * 8;
      *reinterpret_cast<uint4*>(as + r * AP + c) = ra[i];
    }
#pragma unroll
    for (int j = 0; j < W_LOADS; ++j) {
      const int k = (bj + j * (kThreads / BN)) * EP;  // first tile row of the word
      const float s = rs[k / (BK / 2)], b = rb[k / (BK / 2)];
#pragma unroll
      for (int i = 0; i < EP; ++i) {
        const float q = (float)((rw[j] >> (BITS * i)) & MASK);
        bs[(k + i) * BP + bn] = __float2bfloat16_rn(__fadd_rn(__fmul_rn(q, s), b));
      }
    }
  };

  const int nk = Kp / BK;
  load(0);
  store(0);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) load((kt + 1) * BK);  // global loads in flight ...
    const __nv_bfloat16* as = As + (kt & 1) * BM * AP;
    const __nv_bfloat16* bs = Bs + (kt & 1) * BK * BP;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {  // ... while the tensor cores work
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(fa[i], as + (wm * 64 + i * 16) * AP + kk, AP);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], bs + kk * BP + wn * 32 + j * 16, BP);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    // the other stage was last read before the previous barrier
    if (kt + 1 < nk) store((kt + 1) & 1);
    __syncthreads();
  }

  // epilogue: the f32 tile through shared memory (the last barrier of the
  // loop released the operand stages), rope, bf16 rows
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Ct + (wm * 64 + i * 16) * CP + wn * 32 + j * 16, acc[i][j],
                              CP, wmma::mem_row_major);
  __syncthreads();
  const int half = rope_dim / 2;
  for (int e = tid; e < BM * BN; e += kThreads) {
    const int r = e / BN, c = e % BN;
    const int gr = row0 + r, gc = col0 + c;
    if (gr >= M || gc >= N) continue;
    float v = Ct[r * CP + c];
    const size_t o = (size_t)gr * N + gc;
    if (rope_dim != 0) {
      const int pc = c % rope_dim < half ? c + half : c - half;  // partner column
      v = v * cosv[o] + Ct[r * CP + pc] * sinv[o];
    }
    y[o] = __float2bfloat16_rn(v);
  }
}

template <int BITS>
cudaError_t launch(const void* x, const void* packed, const void* scales,
                   const void* biases, const void* cosv, const void* sinv, void* y,
                   int M, int Kp, int N, int g, int rope_dim, bool f32s,
                   cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        gemm_kernel<BITS>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  gemm_kernel<BITS><<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint32_t*>(packed),
      scales, biases, static_cast<const float*>(cosv), static_cast<const float*>(sinv),
      static_cast<__nv_bfloat16*>(y), M, Kp, N, g, rope_dim, f32s);
  return cudaGetLastError();
}

}  // namespace

// y[M, N] = x[M, Kp] @ bf16(dequant(W)) (+ the rope epilogue when
// rope_dim != 0: cos/sin [M, N] f32, dh in {32, 64, 128}, dh | N); returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for arguments
// the kernel does not take). Scales and biases are bf16, or f32 when
// scale_f32 != 0.
extern "C" int pie_quant_gemm(const void* x, const void* packed,
                              const void* scales, const void* biases,
                              const void* cosv, const void* sinv, void* y,
                              int M, int Kp, int N, int bits, int group_size,
                              int scale_f32, int rope_dim, void* stream) {
  if (M < 1 || N < 1 || Kp % BK != 0 ||
      (group_size != 32 && group_size != 64 && group_size != 128) ||
      (rope_dim != 0 && (rope_dim % 32 != 0 || BN % rope_dim != 0 ||
                         N % rope_dim != 0 || cosv == nullptr || sinv == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bits == 4)
    return (int)launch<4>(x, packed, scales, biases, cosv, sinv, y, M, Kp, N, group_size,
                          rope_dim, scale_f32 != 0, st);
  if (bits == 8)
    return (int)launch<8>(x, packed, scales, biases, cosv, sinv, y, M, Kp, N, group_size,
                          rope_dim, scale_f32 != 0, st);
  return (int)cudaErrorInvalidValue;
}
