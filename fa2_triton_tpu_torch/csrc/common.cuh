// Shared helpers for the hand-written Hopper kernels of fa2_triton_tpu_torch.
// Built by ops/_build.py with nvcc for sm_90a into one shared library with a
// plain C interface (loaded through ctypes; no PyTorch headers).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace fa2 {

// Finite mask floor for the running max, in the log2 domain: exp2 of
// (anything masked) - m underflows to 0, and (m - m) is never NaN. Masked
// scores themselves are -inf so their probability is exactly 0 even in a
// row that has seen no valid column yet.
constexpr float MASK_LOG2 = -1e30f;
constexpr float LOG2E = 1.44269504088896340736f;

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000u); }

// dtype codes shared with the Python wrappers.
enum DType : int { kF32 = 0, kF16 = 1, kBF16 = 2 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
// Quantized KV caches: both conversions are exact (e4m3 by the hardware cvt).
__device__ __forceinline__ float to_f(int8_t x) { return static_cast<float>(x); }
__device__ __forceinline__ float to_f(__nv_fp8_e4m3 x) { return static_cast<float>(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __half from_f<__half>(float x) { return __float2half_rn(x); }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Load N consecutive elements of T (N * sizeof(T) bytes, a power of two) as
// one or more vector loads and widen them to fp32. `ptr` must be aligned to
// min(N * sizeof(T), 16) bytes; the wrappers check base pointers and strides.
template <typename T, int N>
__device__ __forceinline__ void load_vec(const T* ptr, float (&out)[N]) {
  constexpr int BYTES = N * (int)sizeof(T);
  const char* p = reinterpret_cast<const char*>(ptr);
  if constexpr (BYTES >= 16) {
    static_assert(BYTES % 16 == 0, "vector width");
    constexpr int PER = 16 / (int)sizeof(T);
#pragma unroll
    for (int c = 0; c < BYTES / 16; ++c) {
      uint4 raw = *reinterpret_cast<const uint4*>(p + 16 * c);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < PER; ++i) out[c * PER + i] = to_f(e[i]);
    }
  } else if constexpr (BYTES == 8) {
    uint2 raw = *reinterpret_cast<const uint2*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = to_f(e[i]);
  } else if constexpr (BYTES == 4) {
    uint32_t raw = *reinterpret_cast<const uint32_t*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = to_f(e[i]);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = to_f(ptr[i]);
  }
}

// One element of a tensor whose dtype is known only at run time (the
// additive bias and its gradient may differ in dtype from q/k/v).
__device__ __forceinline__ float load_any(const void* p, int dtype, long long i) {
  switch (dtype) {
    case kF16: return __half2float(static_cast<const __half*>(p)[i]);
    case kBF16: return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
    default: return static_cast<const float*>(p)[i];
  }
}

__device__ __forceinline__ void store_any(void* p, int dtype, long long i, float x) {
  switch (dtype) {
    case kF16: static_cast<__half*>(p)[i] = __float2half_rn(x); break;
    case kBF16: static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(x); break;
    default: static_cast<float*>(p)[i] = x; break;
  }
}

// Positional mask shared by the forward and backward kernels. r / c are
// local row / column indices of this call; lens are global, q_off / kv_off
// place the call in the global frame, and causal / window masks are
// bottom-right aligned on (q_len, kv_len).
__device__ __forceinline__ bool keep_at(int r, int c, int Sq, int Sk, int q_off, int kv_off,
                                        int q_len, int kv_len, int causal, int wl, int wr) {
  const int rg = q_off + r, cg = kv_off + c, shift = kv_len - q_len;
  bool keep = r < Sq && c < Sk && rg < q_len && cg < kv_len;
  if (causal) {
    keep = keep && (cg <= rg + shift);
  } else if (wr >= 0) {
    keep = keep && (cg <= rg + shift + wr);
  }
  if (wl >= 0) keep = keep && (cg >= rg + shift - wl);
  return keep;
}

// keep_at's mask of one row: keep_at(r, c, ...) iff lo <= c < hi (x = lo,
// y = hi; empty when lo >= hi), for local columns c >= 0.
__device__ __forceinline__ int2 keep_span(int r, int Sq, int Sk, int q_off, int kv_off, int q_len,
                                          int kv_len, int causal, int wl, int wr) {
  const int rg = q_off + r, shift = kv_len - q_len;
  int lo = 0, hi = min(Sk, kv_len - kv_off);
  if (r >= Sq || rg >= q_len) hi = 0;
  if (causal) {
    hi = min(hi, rg + shift + 1 - kv_off);
  } else if (wr >= 0) {
    hi = min(hi, rg + shift + wr + 1 - kv_off);
  }
  if (wl >= 0) lo = max(lo, rg + shift - wl - kv_off);
  return make_int2(lo, hi);
}

// Keys of the q tile at local row q0 (rows of it, global lengths q_len /
// kv_len), in local key indices: [lo, hi) is what its live rows need (past
// the causal / right limit of the last live row, past kv_len, or left of
// the first row's window nothing is loaded); [free_lo, free_hi) is what
// every live row keeps (inside the real keys, at or below the first row's
// diagonal or right window edge, at or right of the last row's left window
// edge); kv_valid counts the local keys that are real. With leaf = T > 0
// (the split schedule's diag) both ranges are also cut to the tile's own
// leaf, local keys [T * (q0 / T), + T): the tile must lie in one leaf, and
// key tiles that are a divisor of T never straddle a leaf edge, so the
// leaf needs no mask test of its own.
struct KeyRange {
  int lo, hi, free_lo, free_hi, kv_valid;
};

template <class Params>
__device__ __forceinline__ KeyRange key_range(const Params& p, int q0, int rows, int q_len,
                                              int kv_len, int leaf = 0) {
  const int shift = kv_len - q_len;
  const int row_lo = p.q_off + q0;
  const int row_hi = min(p.q_off + min(q0 + rows, p.Sq), q_len) - 1;  // inclusive
  KeyRange r;
  r.kv_valid = min(p.Sk, kv_len - p.kv_off);
  r.hi = r.free_hi = r.kv_valid;
  if (p.causal) {
    r.hi = min(r.hi, row_hi + shift + 1 - p.kv_off);
    r.free_hi = min(r.free_hi, row_lo + shift + 1 - p.kv_off);
  } else if (p.wr >= 0) {
    r.hi = min(r.hi, row_hi + shift + p.wr + 1 - p.kv_off);
    r.free_hi = min(r.free_hi, row_lo + shift + p.wr + 1 - p.kv_off);
  }
  if (row_hi < row_lo) r.hi = 0;
  r.lo = p.wl >= 0 ? max(0, row_lo + shift - p.wl - p.kv_off) : 0;
  r.free_lo = p.wl >= 0 ? row_hi + shift - p.wl - p.kv_off : 0;
  if (leaf > 0) {
    const int l0 = (q0 / leaf) * leaf;
    r.lo = max(r.lo, l0);
    r.hi = min(r.hi, l0 + leaf);
    r.free_hi = min(r.free_hi, l0 + leaf);
  }
  return r;
}

// Counter-hash dropout (utils/rng.py; JAX fa2_triton_tpu/utils/rng.py): a
// lowbias32-style mixer of a uint32 counter and the seed, in native uint32
// arithmetic (wrapping mod 2^32). Every kernel draws its bits through the
// helpers below, and an element is kept iff its bits >= the threshold
// min(p * 2^32, 2^32 - 1).
__device__ __forceinline__ uint32_t counter_hash_u32(uint32_t seed, uint32_t counter) {
  uint32_t x = counter * 0x9E3779B9u;
  x += seed;
  x ^= x >> 16;
  x *= 0x21F0AAADu;
  x ^= x >> 15;
  x *= 0x735A2D97u;
  x ^= x >> 15;
  return x;
}

// Dense stream: counter ((b * Hq + h) * Sq_real + row_g) * Sk_real + col_g
// mod 2^32, with h the q head and row_g / col_g global positions.
__device__ __forceinline__ bool dropout_keep(uint32_t seed, uint32_t threshold, int b, int h,
                                             int row_g, int col_g, int Hq, int Sq_real,
                                             int Sk_real) {
  const uint32_t flat =
      (((uint32_t)b * (uint32_t)Hq + (uint32_t)h) * (uint32_t)Sq_real + (uint32_t)row_g) *
          (uint32_t)Sk_real +
      (uint32_t)col_g;
  return counter_hash_u32(seed, flat) >= threshold;
}

// Packed stream (varlen / block-sparse): hash(hash(hash(seed, h), row), col)
// over GLOBAL packed row and column; `seed_h` is hash(seed, h), hoisted
// out of the tile loops by the caller.
__device__ __forceinline__ bool packed_dropout_keep(uint32_t seed_h, uint32_t threshold, int row,
                                                    int col) {
  return counter_hash_u32(counter_hash_u32(seed_h, (uint32_t)row), (uint32_t)col) >= threshold;
}

// Dropout arguments shared by every attention kernel. `on` is 0 when
// dropout_p == 0 (the bits are then never drawn), `scale` = 1 / (1 - p).
struct Dropout {
  int on;
  uint32_t seed;
  uint32_t threshold;
  float scale;
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

}  // namespace fa2
