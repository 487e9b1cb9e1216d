// Single-token decode attention over a contiguous or paged KV cache, stored
// in the compute type or quantized (int8 / fp8 e4m3), for Hopper (sm_90a),
// written by hand in CUDA C++. One kernel template serves every variant; it
// is instantiated once per cache type, in decode.cu (the compute type),
// decode_int8.cu and decode_fp8.cu, so the three compile in parallel.
//
// Replaces: fa2_triton_tpu/ops/decode.py:_decode_kernel (B5, l.74) with its
// three launch forms _decode_kernel_noquant (l.158, contiguous),
// _decode_kernel_paged (l.273) and _decode_kernel_paged_noquant (l.280, B6).
// The TPU variants share one body and differ only in where a cache row lives
// and in the dequant; so do these:
//   * the address of logical row s of (slot b, KV head hk), in rows of D:
//       contiguous [slots, Hkv, S_max, D]:
//         (b * Hkv + hk) * S_max + s
//       paged [n_pages, Hkv, page, D] through tables [B, max_pages]:
//         (tables[b * max_pages + s / page] * Hkv + hk) * page + s % page
//     and the scale of that row ([.., Hkv, 1, S_max] / [.., Hkv, 1, page])
//     sits at the same index with D = 1;
//   * the dequant: int8 -> float is exact, and so is the hardware e4m3 ->
//     float conversion (the TPU's integer bit-twiddle, decode.py:42-71, was
//     a v5e workaround with the same output). The k scale multiplies each
//     row's score and the v scale that row's probability in the PV sum, as
//     the TPU kernel folds them (decode.py:117-119, 141-144), while the
//     softmax denominator sums the unscaled probabilities. The dequantized
//     K/V is never written anywhere.
//
// Function: for each slot b and KV head hk, the G = Hq / Hkv query heads of
// that group attend to logical rows [first, kv_len), first = kv_len - 1 -
// window_left when a window is set, with a base-2 online softmax (softcap
// applied in natural units) and fp32 accumulators. A row with no valid key
// yields 0. kv_len is clamped to S_max (contiguous) or max_pages * page
// (paged). q and o are [B, Hq, D]; everything is contiguous.
//
// Bound on the H100: memory. Each (slot, KV head) reads 2 * kv_len * D
// bytes of K/V per cache byte width (+ 8 bytes of scales per row when
// quantized) for about 4 * G * kv_len * D flops: a few flops per byte, far
// under the ~295 flop/byte ridge, so the roof is 3.35 TB/s of HBM. The
// design against that bound:
//   * one block per (KV head, slot), holding the whole GQA query group, so
//     every K/V byte is read from HBM once and used by all G query heads;
//   * 16 warps stream disjoint runs of ROWS consecutive logical rows; each
//     lane reads a contiguous D/32-element slice of a row as one vector load
//     (4 bytes of an int8/fp8 row at D 128), so a warp reads whole rows
//     coalesced and keeps ROWS rows in flight;
//   * rows outside [first, kv_len) are never read: not past a slot's length,
//     not a page released behind the window, not a table entry past the last
//     live page (those point at the reserved page 0), so NaN there cannot
//     reach the output;
//   * each warp keeps its own (m, l, acc) per query head; the 16 partial
//     states merge once at the end through shared memory.
// Paged and contiguous assign the same logical rows to the same warps in the
// same order and do the same arithmetic, so on the same rows they give the
// same output bit for bit.
// With 8 slots x 8 KV heads the grid is 64 blocks on 132 SMs; splitting
// long caches across blocks (split-KV) is later work.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace fa2 {
namespace dec {

constexpr int DEC_WARPS = 16;
constexpr int DEC_THREADS = DEC_WARPS * 32;
constexpr int ROWS = 4;  // consecutive logical cache rows per warp per step

// Cache kinds of the C entry point (`_CACHE_KINDS` in ops/decode.py).
enum CacheKind : int { kDense = 0, kInt8 = 1, kFp8 = 2 };

struct DecParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const int* kv_lens;     // [B]
  const float* k_scale;   // quantized caches only, else null
  const float* v_scale;
  const int* tables;      // paged only: [B, max_pages], else null
  int Hq, Hkv, rows, max_pages, wl;  // rows: S_max (contiguous) or the page size
  float scale_log2;  // softmax_scale * log2(e)
  float softcap;     // natural units; 0 = off
};

template <typename C>
constexpr bool kQuant = std::is_same<C, int8_t>::value || std::is_same<C, __nv_fp8_e4m3>::value;

// Index, in rows of D, of logical row s of (slot b, KV head hk).
template <bool PAGED>
__device__ __forceinline__ long long row_index(const DecParams& p, int b, int hk, int s) {
  if constexpr (PAGED) {
    const int page = p.tables[(long long)b * p.max_pages + s / p.rows];
    return ((long long)page * p.Hkv + hk) * p.rows + s % p.rows;
  } else {
    return ((long long)b * p.Hkv + hk) * p.rows + s;
  }
}

// T: type of q and o; C: cache element type (T, int8_t or __nv_fp8_e4m3).
template <typename T, typename C, bool PAGED, int D, int G>
__global__ void __launch_bounds__(DEC_THREADS) decode_kernel(const DecParams p) {
  constexpr int EPL = D / 32;  // elements of a row per lane
  constexpr bool QUANT = kQuant<C>;
  __shared__ float red_m[DEC_WARPS][G];
  __shared__ float red_l[DEC_WARPS][G];
  __shared__ float red_acc[DEC_WARPS][D];

  const int hk = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int cap = PAGED ? p.max_pages * p.rows : p.rows;
  const int kv_len = min(p.kv_lens[b], cap);
  const int first = p.wl >= 0 ? max(0, kv_len - 1 - p.wl) : 0;
  const C* kp = static_cast<const C*>(p.k) + lane * EPL;
  const C* vp = static_cast<const C*>(p.v) + lane * EPL;

  float q[G][EPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    load_vec<T, EPL>(static_cast<const T*>(p.q) + ((long long)b * p.Hq + hk * G + g) * D + lane * EPL,
                     q[g]);
#pragma unroll
    for (int e = 0; e < EPL; ++e) q[g][e] *= p.scale_log2;
  }
  float m[G], l[G], acc[G][EPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = MASK_LOG2;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;
  }

  for (int s0 = first + warp * ROWS; s0 < kv_len; s0 += DEC_WARPS * ROWS) {
    float kr[ROWS][EPL], vr[ROWS][EPL], ks[ROWS], vs[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      ks[r] = vs[r] = 0.f;
      if (s0 + r < kv_len) {
        const long long row = row_index<PAGED>(p, b, hk, s0 + r);
        load_vec<C, EPL>(kp + row * D, kr[r]);
        load_vec<C, EPL>(vp + row * D, vr[r]);
        if constexpr (QUANT) {
          ks[r] = p.k_scale[row];
          vs[r] = p.v_scale[row];
        }
      } else {
#pragma unroll
        for (int e = 0; e < EPL; ++e) kr[r][e] = vr[r][e] = 0.f;
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float sc[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) d = fmaf(q[g][e], kr[r][e], d);
        sc[r] = warp_sum(d);
        if constexpr (QUANT) sc[r] *= ks[r];
      }
      float mx = m[g];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        if (p.softcap > 0.f) sc[r] = p.softcap * tanhf(sc[r] * (1.f / LOG2E) / p.softcap) * LOG2E;
        if (s0 + r >= kv_len) sc[r] = neg_inf();
        mx = fmaxf(mx, sc[r]);
      }
      const float alpha = exp2f(m[g] - mx);
      float pr[ROWS], sum = 0.f;
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        pr[r] = exp2f(sc[r] - mx);
        sum += pr[r];
      }
      l[g] = l[g] * alpha + sum;
      m[g] = mx;
      if constexpr (QUANT) {
#pragma unroll
        for (int r = 0; r < ROWS; ++r) pr[r] *= vs[r];
      }
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        float a = acc[g][e] * alpha;
#pragma unroll
        for (int r = 0; r < ROWS; ++r) a = fmaf(pr[r], vr[r][e], a);
        acc[g][e] = a;
      }
    }
  }

  // Merge the 16 warps' partial states, one query head at a time.
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      red_m[warp][g] = m[g];
      red_l[warp][g] = l[g];
    }
  }
  T* op = static_cast<T*>(p.o) + ((long long)b * p.Hq + hk * G) * D;
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int e = 0; e < EPL; ++e) red_acc[warp][lane * EPL + e] = acc[g][e];
    __syncthreads();
    for (int d = threadIdx.x; d < D; d += DEC_THREADS) {
      float M = MASK_LOG2;
#pragma unroll
      for (int w = 0; w < DEC_WARPS; ++w) M = fmaxf(M, red_m[w][g]);
      float L = 0.f, O = 0.f;
#pragma unroll
      for (int w = 0; w < DEC_WARPS; ++w) {
        const float sc = exp2f(red_m[w][g] - M);
        L = fmaf(red_l[w][g], sc, L);
        O = fmaf(red_acc[w][d], sc, O);
      }
      op[g * D + d] = from_f<T>(L > 0.f ? O / L : 0.f);
    }
    __syncthreads();
  }
}

template <typename T, typename C, bool PAGED, int D, int G>
cudaError_t launch(const DecParams& p, int B, cudaStream_t stream) {
  dim3 grid(p.Hkv, B);
  decode_kernel<T, C, PAGED, D, G><<<grid, DEC_THREADS, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, typename C, bool PAGED, int D>
cudaError_t launch_g(const DecParams& p, int B, int G, cudaStream_t stream) {
  switch (G) {
    case 1: return launch<T, C, PAGED, D, 1>(p, B, stream);
    case 2: return launch<T, C, PAGED, D, 2>(p, B, stream);
    case 4: return launch<T, C, PAGED, D, 4>(p, B, stream);
    case 8: return launch<T, C, PAGED, D, 8>(p, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, typename C, bool PAGED>
cudaError_t launch_dg(const DecParams& p, int B, int D, int G, cudaStream_t stream) {
  switch (D) {
    case 64: return launch_g<T, C, PAGED, 64>(p, B, G, stream);
    case 128: return launch_g<T, C, PAGED, 128>(p, B, G, stream);
    case 256: return launch_g<T, C, PAGED, 256>(p, B, G, stream);
    default: return cudaErrorInvalidValue;
  }
}

// Cache type for compute type T: Q, or T itself when Q is void.
template <typename Q, typename T>
using cache_t = typename std::conditional<std::is_void<Q>::value, T, Q>::type;

// Every (compute dtype, layout, D, G) of one cache kind Q (void = dense).
template <typename Q>
cudaError_t run(int dtype, const DecParams& p, int B, int D, int G, cudaStream_t s) {
  const bool paged = p.tables != nullptr;
  switch (dtype) {
    case kF32:
      return paged ? launch_dg<float, cache_t<Q, float>, true>(p, B, D, G, s)
                   : launch_dg<float, cache_t<Q, float>, false>(p, B, D, G, s);
    case kF16:
      return paged ? launch_dg<__half, cache_t<Q, __half>, true>(p, B, D, G, s)
                   : launch_dg<__half, cache_t<Q, __half>, false>(p, B, D, G, s);
    case kBF16:
      return paged ? launch_dg<__nv_bfloat16, cache_t<Q, __nv_bfloat16>, true>(p, B, D, G, s)
                   : launch_dg<__nv_bfloat16, cache_t<Q, __nv_bfloat16>, false>(p, B, D, G, s);
    default: return cudaErrorInvalidValue;
  }
}

// One per translation unit: decode.cu, decode_int8.cu, decode_fp8.cu.
cudaError_t run_dense(int dtype, const DecParams& p, int B, int D, int G, cudaStream_t s);
cudaError_t run_int8(int dtype, const DecParams& p, int B, int D, int G, cudaStream_t s);
cudaError_t run_fp8(int dtype, const DecParams& p, int B, int D, int G, cudaStream_t s);

}  // namespace dec
}  // namespace fa2
