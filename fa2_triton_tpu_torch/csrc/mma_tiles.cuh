// Tensor-core building blocks shared by the 16-bit kernels: the forward
// (flash_fwd.cu), the backward (bwd_mma.cuh) and decode (decode.cuh). PTX
// wrappers for cp.async (16- and 4-byte global -> shared copies that
// zero-fill without reading), ldmatrix (plain and transposed), movmatrix
// (an 8 x 8 fragment transposed in registers), mma.sync.m16n8k16 with fp32
// accumulation (bf16 or fp16 operands), the fp32 -> 16-bit pair pack that
// turns accumulators into A fragments, and the tile loader on top of them.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace fa2 {

// ---- PTX ------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (4) bytes global -> shared; ok == false zero-fills without reading.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// The 8 x 8 matrix of 16-bit elements whose fragment (lane 4 i + t: row i,
// columns 2 t, 2 t + 1) is x, transposed: the same fragment of its transpose.
__device__ __forceinline__ uint32_t movmatrix_t(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

// c += a (16 x 16, row) . b (16 x 8, col), fp32 accumulation.
template <typename T>
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  if constexpr (std::is_same<T, __half>::value) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
        "{%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
        "{%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

// Two floats rounded to T, the first in the low half.
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same<T, __half>::value) {
    __half2 h = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  } else {
    __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  }
}

// The two T of a packed pair, as floats (low half first).
template <typename T>
__device__ __forceinline__ float2 unpack2(uint32_t x) {
  if constexpr (std::is_same<T, __half>::value) {
    return __half22float2(*reinterpret_cast<__half2*>(&x));
  } else {
    return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&x));
  }
}

// ---- tiles ------------------------------------------------------------------

// rows [row0, row0 + rows) of a [*, D] operand (row stride ss) into shared
// memory with pitch C::P, by the C::NW warps of the block; rows at or past
// `valid` are zero (the tensor cores give 0 x NaN = NaN, so padding that may
// hold NaN never reaches an mma).
template <class C, typename T>
__device__ __forceinline__ void cp_rows(T* dst, const T* src, long long ss, int row0, int rows,
                                        int valid) {
  constexpr int CH = C::D / 8;
  for (int i = threadIdx.x; i < rows * CH; i += C::NW * 32) {
    const int r = i / CH, c = (i % CH) * 8;
    const bool ok = row0 + r < valid;
    cp_async16(dst + r * C::P + c, ok ? src + (long long)(row0 + r) * ss + c : src, ok);
  }
}

}  // namespace fa2
