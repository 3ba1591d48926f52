// Hopper building blocks shared by K1 (quant_gemv.cu), K2 (quant_gemm.cu),
// K3 (paged_attention.cu), K4 (fused_mlp.cu) and B7 (hbm_read.cu):
// mbarriers, cp.async, 1-D bulk copies, TMA tensor copies and the host
// encoding of their tensor maps (2-D, and 3-D with the layer as a
// coordinate), the bf16x2 bit operations that turn packed codes into exact
// bf16 operands, and the mma.sync / ldmatrix / movmatrix fragments of K1,
// K3 and K4.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace pie {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}

// 16 bytes global -> shared through L2 (cp.async.cg: not the L1 or the
// read-only path, so data other blocks wrote during the launch is seen)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(smem)),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// bytes (a multiple of 16) global -> shared in one 1-D bulk copy, counted
// on the mbarrier bar
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t sel) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
  return d;
}

__device__ __forceinline__ uint32_t bf16x2_fma(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d[16 x 8] += A[16 x 16] B[16 x 8], bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// bf16x2 (byte i of w0, byte i of w1) of unsigned 8-bit codes (0-255), exact:
// the f32 2^23 + q trick, then one cvt
__device__ __forceinline__ uint32_t int8_pair_w(uint32_t w0, uint32_t w1, int i) {
  const float lo = __uint_as_float(prmt(w0, 0x4B000000u, 0x7440u | i)) - 8388608.f;
  const float hi = __uint_as_float(prmt(w1, 0x4B000000u, 0x7440u | i)) - 8388608.f;
  return bf16_pair(lo, hi);
}

// bf16x2 (byte 0, byte 2) of w as signed int8 values, exact, with no
// integer-to-float conversion: b = (b & 0x7F) - (b & 0x80), so the bf16
// (128 + (b & 0x7F)) minus the bf16 (128 or 256), both built with one lop3
__device__ __forceinline__ uint32_t s8_pair_02(uint32_t w) {
  uint32_t x, y, d;
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;\n" : "=r"(x) : "r"(w), "r"(0x007F007Fu), "r"(0x43004300u));
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;\n" : "=r"(y) : "r"(w), "r"(0x00800080u), "r"(0x43004300u));
  asm("sub.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(x), "r"(y));
  return d;
}

// bf16x2 (byte 1, byte 3) of w as signed int8 values, exact
__device__ __forceinline__ uint32_t s8_pair_13(uint32_t w) { return s8_pair_02(w >> 8); }

// four 8 x 8 b16 matrices from shared memory; lanes 8i..8i+7 give the row
// addresses of matrix i, and lane l receives element (l / 4, 2 (l % 4) + {0, 1})
// of each (with .trans: elements (2 (l % 4) + {0, 1}, l / 4))
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// the 8 x 8 b16 matrix whose element (l / 4, 2 (l % 4) + {0, 1}) lane l
// holds, transposed across the warp: lane l receives (2 (l % 4) + {0, 1}, l / 4)
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t a) {
  uint32_t d;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(d) : "r"(a));
  return d;
}

// -- host side ----------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded, so the
// library needs no -lcuda
inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A row-major [outer, inner] array read in boxes of [box_outer, box_inner]
// (zero fill outside it).
inline bool encode_2d(CUtensorMap* map, CUtensorMapDataType type, const void* ptr, uint64_t inner,
                      uint64_t outer, uint64_t row_bytes, uint32_t box_inner, uint32_t box_outer,
                      CUtensorMapSwizzle swizzle) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {row_bytes};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t step[2] = {1, 1};
  return enc(map, type, 2, const_cast<void*>(ptr), dims, strides, box, step,
             CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A stack of `layers` row-major [outer, inner] arrays, layer_bytes apart,
// read in boxes of [1, box_outer, box_inner] (the layer is a coordinate).
inline bool encode_3d(CUtensorMap* map, CUtensorMapDataType type, const void* ptr, uint64_t inner,
                      uint64_t outer, uint64_t layers, uint64_t row_bytes, uint64_t layer_bytes,
                      uint32_t box_inner, uint32_t box_outer, CUtensorMapSwizzle swizzle) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[3] = {inner, outer, layers};
  const cuuint64_t strides[2] = {row_bytes, layer_bytes};
  const cuuint32_t box[3] = {box_inner, box_outer, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return enc(map, type, 3, const_cast<void*>(ptr), dims, strides, box, step,
             CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace pie
