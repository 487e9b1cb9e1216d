// Single-token decode attention over a contiguous KV cache, for Hopper
// (sm_90a), written by hand in CUDA C++.
//
// Replaces: fa2_triton_tpu/ops/decode.py:_decode_kernel_noquant (B5, the
// no-quant variant of _decode_kernel). The int8/fp8 variant is not ported.
//
// Function: for each slot b and KV head hk, the G = Hq / Hkv query heads of
// that group attend to cache rows [first, kv_len), first = kv_len - 1 -
// window_left when a window is set, with a base-2 online softmax (softcap
// applied in natural units) and fp32 accumulators. A row with no valid key
// yields 0. Cache layout [slots, Hkv, S_max, D] (the JAX layout without its
// 128-lane pad), q and o [B, Hq, D]; all contiguous.
//
// Bound on the H100: memory. Each (slot, KV head) reads 2 * kv_len * D *
// sizeof(T) bytes of K/V (1 MiB at kv_len 2048, D 128, bf16) for about
// 4 * G * kv_len * D flops: ~G flops per byte, far under the ~295 flop/byte
// ridge, so the roof is 3.35 TB/s of HBM. The design against that bound:
//   * one block per (KV head, slot), holding the whole GQA query group, so
//     every K/V byte is read from HBM once and used by all G query heads;
//   * 16 warps stream disjoint runs of ROWS consecutive rows; each lane
//     reads a contiguous D/32-element slice of a row as one vector load, so
//     a warp reads whole rows coalesced and keeps ROWS rows in flight;
//   * rows outside [first, kv_len) are never read (ragged slots read only
//     live bytes);
//   * each warp keeps its own (m, l, acc) per query head; the 16 partial
//     states merge once at the end through shared memory.
// With 8 slots x 8 KV heads the grid is 64 blocks on 132 SMs; splitting
// long caches across blocks (split-KV) is later work.
#include "common.cuh"

namespace fa2 {
namespace {

constexpr int DEC_WARPS = 16;
constexpr int DEC_THREADS = DEC_WARPS * 32;
constexpr int ROWS = 4;  // consecutive cache rows per warp per step

struct DecParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const int* kv_lens;  // [B]
  int Hq, Hkv, S_max, wl;
  float scale_log2;  // softmax_scale * log2(e)
  float softcap;     // natural units; 0 = off
};

template <typename T, int D, int G>
__global__ void __launch_bounds__(DEC_THREADS) decode_kernel(const DecParams p) {
  constexpr int EPL = D / 32;  // elements of a row per lane
  __shared__ float red_m[DEC_WARPS][G];
  __shared__ float red_l[DEC_WARPS][G];
  __shared__ float red_acc[DEC_WARPS][D];

  const int hk = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kv_len = min(p.kv_lens[b], p.S_max);
  const int first = p.wl >= 0 ? max(0, kv_len - 1 - p.wl) : 0;
  const long long head = ((long long)b * p.Hkv + hk) * p.S_max * D + lane * EPL;
  const T* kp = static_cast<const T*>(p.k) + head;
  const T* vp = static_cast<const T*>(p.v) + head;

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
    float kr[ROWS][EPL], vr[ROWS][EPL];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (s0 + r < kv_len) {
        load_vec<T, EPL>(kp + (long long)(s0 + r) * D, kr[r]);
        load_vec<T, EPL>(vp + (long long)(s0 + r) * D, vr[r]);
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

template <typename T, int D, int G>
cudaError_t launch(const DecParams& p, int B, cudaStream_t stream) {
  dim3 grid(p.Hkv, B);
  decode_kernel<T, D, G><<<grid, DEC_THREADS, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_g(const DecParams& p, int B, int G, cudaStream_t stream) {
  switch (G) {
    case 1: return launch<T, D, 1>(p, B, stream);
    case 2: return launch<T, D, 2>(p, B, stream);
    case 4: return launch<T, D, 4>(p, B, stream);
    case 8: return launch<T, D, 8>(p, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_dg(const DecParams& p, int B, int D, int G, cudaStream_t stream) {
  switch (D) {
    case 64: return launch_g<T, 64>(p, B, G, stream);
    case 128: return launch_g<T, 128>(p, B, G, stream);
    case 256: return launch_g<T, 256>(p, B, G, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace fa2

extern "C" int fa2_decode(
    int dtype, int B, int Hq, int Hkv, int S_max, int D,
    const void* q, const void* k_cache, const void* v_cache, void* o, const int* kv_lens,
    int window_left, float softmax_scale, float softcap, void* stream) {
  fa2::DecParams p;
  p.q = q; p.k = k_cache; p.v = v_cache; p.o = o; p.kv_lens = kv_lens;
  p.Hq = Hq; p.Hkv = Hkv; p.S_max = S_max; p.wl = window_left;
  p.scale_log2 = softmax_scale * fa2::LOG2E;
  p.softcap = softcap;
  const int G = Hq / Hkv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case fa2::kF32: return (int)fa2::launch_dg<float>(p, B, D, G, s);
    case fa2::kF16: return (int)fa2::launch_dg<__half>(p, B, D, G, s);
    case fa2::kBF16: return (int)fa2::launch_dg<__nv_bfloat16>(p, B, D, G, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
