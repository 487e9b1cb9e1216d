// Decode attention past head dim 512, at any multiple of 128 (D a run-time
// argument): B5, B5 quant and B6 (fa2_triton_tpu/ops/decode.py:
// _decode_kernel, _decode_kernel_noquant, _decode_kernel_paged(_noquant)),
// over a contiguous or paged cache in the compute type, int8 or fp8 e4m3,
// with decode.cuh's params (DecParams), grid (n_chunks, Hkv, B) (chunks of
// ANY_CHUNK logical rows), row addressing, window, softcap, dequant rule and
// split-KV merge (each chunk's partial (m, l, acc[D]) to fp32 scratch; the
// last block to arrive merges them in chunk order). Instantiated in
// decode_any.cu, decode_any_int8.cu and decode_any_fp8.cu.
//
// decode.cuh's ring holds whole rows of K and V per warp and q (or O^T) in
// registers; past 512 neither fits (a 16-row stage of K and V at D 1024 in
// bf16 is 66 KB). So a block takes its chunk in three phases, each over
// the whole D in slices, with nothing of D's width held anywhere:
//   1. scores: a warp per row (rows warp, warp + 8, ...), a lane per 8
//      columns of a 256-column slice; q's slice (times scale * log2 e) sits
//      in registers, each K row's piece is one vector load, and the G dot
//      products are warp sums, added into s[row][head] in shared memory
//      (ANY_CHUNK x 8 fp32) slice by slice;
//   2. the softmax of the chunk's rows, a warp per head: k scale, softcap,
//      the chunk's max m and sum l of the undropped p, and p (times the v
//      scale) back into s;
//   3. values: a thread per 4 columns of a 1024-column pass, summing p V
//      over the chunk's rows (one vector load a row, G FMAs a column).
// Every K and V byte of the live rows is read once; rows outside [first,
// kv_len) are never read. All in fp32 on the CUDA cores (the cache bytes,
// not the FMAs, bound decode: 4 G flops per 2 cache bytes against the
// H100's 20 fp32 flops per HBM byte), p unrounded.
#pragma once

#include "decode.cuh"

namespace fa2 {
namespace dec {

// Logical rows of a block's chunk: half of decode.cuh's CHUNK, so that 8
// slots x 4096 rows of one KV head fill 128 blocks (ops/decode.py mirrors
// it: ANY_CHUNK).
constexpr int ANY_CHUNK = 256;
constexpr int ANY_NW = 8;                 // warps of a block
constexpr int ANY_NT = ANY_NW * 32;
constexpr int ANY_QW = 256;               // columns of a score slice: 8 a lane
constexpr int ANY_VW = ANY_NT * 4;        // columns of a value pass: 4 a thread

// One block an SM as the floor: with none ptxas capped G 4 at 64 registers
// and spilled.
template <typename T, typename C, bool PAGED, int G>
__global__ void __launch_bounds__(ANY_NT, 1) decode_any_kernel(const DecParams p, int D) {
  constexpr bool QUANT = kQuant<C>;
  __shared__ float s[ANY_CHUNK * HP];          // [row of the chunk][head]: scores, then p
  __shared__ long long ridx[ANY_CHUNK];        // cache row of each live row of the chunk
  __shared__ float stat_m[HP], stat_l[HP];
  __shared__ int last;

  const int c = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int cap = PAGED ? p.max_pages * p.rows : p.rows;
  const int kv_len = min(max(p.kv_lens[b], 0), cap);
  const int first = p.wl >= 0 ? max(0, kv_len - 1 - p.wl) : 0;
  const int c_first = first / ANY_CHUNK;
  const int n_live = kv_len > first ? (kv_len - 1) / ANY_CHUNK - c_first + 1 : 0;
  T* op = static_cast<T*>(p.o) + ((long long)b * p.Hq + hk * G) * D;
  if (n_live == 0) {  // no valid key: o = 0, written by chunk 0
    if (c == 0) {
      for (int i = threadIdx.x; i < G * D; i += ANY_NT) op[i] = from_f<T>(0.f);
    }
    return;
  }
  if (c < c_first || c >= c_first + n_live) return;
  const int c0 = c * ANY_CHUNK;
  const int lo = max(first, c0), hi = min(kv_len, c0 + ANY_CHUNK);
  for (int r = lo + threadIdx.x; r < hi; r += ANY_NT) {
    if constexpr (PAGED) {
      const long long page = p.tables[(long long)b * p.max_pages + r / p.rows];
      ridx[r - c0] = (page * p.Hkv + hk) * p.rows + r % p.rows;
    } else {
      ridx[r - c0] = ((long long)b * p.Hkv + hk) * p.rows + r;
    }
  }
  __syncthreads();

  // 1. Scores of the chunk's live rows, slice by slice.
  const C* ks = static_cast<const C*>(p.k);
  const C* vs = static_cast<const C*>(p.v);
  const T* qg = static_cast<const T*>(p.q) + ((long long)b * p.Hq + hk * G) * D;
  for (int d0 = 0; d0 < D; d0 += ANY_QW) {
    const int dl = d0 + lane * 8;
    const bool on = dl < D;
    float qv[G][8];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (on) {
        load_vec<T, 8>(qg + (long long)g * D + dl, qv[g]);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) qv[g][e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) qv[g][e] *= p.scale_log2;
    }
#pragma unroll 8
    for (int r = lo + warp; r < hi; r += ANY_NW) {
      float kv[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (on) load_vec<C, 8>(ks + ridx[r - c0] * D + dl, kv);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float x = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) x = fmaf(qv[g][e], kv[e], x);
        x = warp_sum(x);
        if (lane == g) s[(r - c0) * HP + g] = d0 == 0 ? x : s[(r - c0) * HP + g] + x;
      }
    }
  }
  __syncthreads();

  // 2. The chunk's softmax, a warp per head: m, l, and p (times the v scale).
  if (warp < G) {
    const int g = warp;
    float mx = MASK_LOG2;
    for (int r = lo + lane; r < hi; r += 32) {
      float x = s[(r - c0) * HP + g];
      if constexpr (QUANT) x *= p.k_scale[ridx[r - c0]];
      if (p.softcap > 0.f) x = p.softcap * tanhf(x * (1.f / LOG2E) / p.softcap) * LOG2E;
      s[(r - c0) * HP + g] = x;
      mx = fmaxf(mx, x);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float l = 0.f;
    for (int r = lo + lane; r < hi; r += 32) {
      const float pr = exp2f(s[(r - c0) * HP + g] - mx);
      l += pr;
      s[(r - c0) * HP + g] = QUANT ? pr * p.v_scale[ridx[r - c0]] : pr;
    }
    l = warp_sum(l);
    if (lane == 0) {
      stat_m[g] = mx;
      stat_l[g] = l;
    }
  }
  __syncthreads();

  // 3. acc = sum over the chunk's rows of p V, pass by pass; o itself when
  // the slot has one live chunk, else this chunk's partial.
  const long long slot_part = ((long long)b * p.Hkv + hk) * gridDim.x;  // partial rows / G
  for (int d0 = 0; d0 < D; d0 += ANY_VW) {
    const int dl = d0 + threadIdx.x * 4;
    if (dl >= D) continue;
    float acc[G][4];
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[g][e] = 0.f;
#pragma unroll 8
    for (int r = lo; r < hi; ++r) {
      float vv[4];
      load_vec<C, 4>(vs + ridx[r - c0] * D + dl, vv);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float pr = s[(r - c0) * HP + g];
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[g][e] = fmaf(pr, vv[e], acc[g][e]);
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (n_live == 1) {
        const float L = stat_l[g], inv = L > 0.f ? 1.f / L : 0.f;
#pragma unroll
        for (int e = 0; e < 4; ++e) op[(long long)g * D + dl + e] = from_f<T>(acc[g][e] * inv);
      } else {
        float* pp = p.part + ((slot_part + c) * G + g) * (D + 2);
#pragma unroll
        for (int e = 0; e < 4; ++e) pp[dl + e] = acc[g][e];
        if (dl == 0) {
          pp[D] = stat_m[g];
          pp[D + 1] = stat_l[g];
        }
      }
    }
  }
  if (n_live == 1) return;

  // The last block of the slot's live chunks merges them, in chunk order
  // (decode.cuh's merge).
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(p.counters + b * p.Hkv + hk, 1) == n_live - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const long long CS = (long long)G * (D + 2);  // floats from one chunk's partial to the next
  for (int i = threadIdx.x; i < G * D; i += ANY_NT) {
    const int g = i / D, d = i % D;
    const float* pp = p.part + ((slot_part + c_first) * G + g) * (D + 2);
    float M = MASK_LOG2;
    for (int k = 0; k < n_live; ++k) M = fmaxf(M, __ldcg(pp + k * CS + D));
    float L = 0.f, O = 0.f;
    for (int k = 0; k < n_live; ++k) {
      const float sc = exp2f(__ldcg(pp + k * CS + D) - M);
      L = fmaf(__ldcg(pp + k * CS + D + 1), sc, L);
      O = fmaf(__ldcg(pp + k * CS + d), sc, O);
    }
    op[i] = from_f<T>(L > 0.f ? O / L : 0.f);
  }
  if (threadIdx.x == 0) p.counters[b * p.Hkv + hk] = 0;
}

template <typename T, typename C, bool PAGED>
cudaError_t launch_any_g(const DecParams& p, int B, int n_chunks, int D, int G,
                         cudaStream_t stream) {
  const dim3 grid(n_chunks, p.Hkv, B);
  switch (G) {
    case 1: decode_any_kernel<T, C, PAGED, 1><<<grid, ANY_NT, 0, stream>>>(p, D); break;
    case 2: decode_any_kernel<T, C, PAGED, 2><<<grid, ANY_NT, 0, stream>>>(p, D); break;
    case 4: decode_any_kernel<T, C, PAGED, 4><<<grid, ANY_NT, 0, stream>>>(p, D); break;
    case 8: decode_any_kernel<T, C, PAGED, 8><<<grid, ANY_NT, 0, stream>>>(p, D); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// Every (compute dtype, layout, G) of one cache kind Q (void = dense) past
// D 512.
template <typename Q>
cudaError_t run_any(int dtype, const DecParams& p, int B, int n_chunks, int D, int G,
                    cudaStream_t s) {
  if (D <= 512 || D % 128 != 0) return cudaErrorInvalidValue;
  const bool paged = p.tables != nullptr;
  switch (dtype) {
    case kF32:
      return paged ? launch_any_g<float, cache_t<Q, float>, true>(p, B, n_chunks, D, G, s)
                   : launch_any_g<float, cache_t<Q, float>, false>(p, B, n_chunks, D, G, s);
    case kF16:
      return paged ? launch_any_g<__half, cache_t<Q, __half>, true>(p, B, n_chunks, D, G, s)
                   : launch_any_g<__half, cache_t<Q, __half>, false>(p, B, n_chunks, D, G, s);
    case kBF16: {
      using C = cache_t<Q, __nv_bfloat16>;
      return paged ? launch_any_g<__nv_bfloat16, C, true>(p, B, n_chunks, D, G, s)
                   : launch_any_g<__nv_bfloat16, C, false>(p, B, n_chunks, D, G, s);
    }
    default: return cudaErrorInvalidValue;
  }
}

// One per translation unit: decode_any.cu, decode_any_int8.cu,
// decode_any_fp8.cu.
cudaError_t run_dense_any(int dtype, const DecParams& p, int B, int n_chunks, int D, int G,
                          cudaStream_t s);
cudaError_t run_int8_any(int dtype, const DecParams& p, int B, int n_chunks, int D, int G,
                         cudaStream_t s);
cudaError_t run_fp8_any(int dtype, const DecParams& p, int B, int n_chunks, int D, int G,
                        cudaStream_t s);

}  // namespace dec
}  // namespace fa2
