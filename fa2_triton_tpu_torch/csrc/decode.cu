// Decode attention over a cache stored in the compute type (B5 no-quant and
// B6 no-quant), and the C entry point of every decode variant. The kernel
// and its design are in decode.cuh; the int8 and fp8 caches are instantiated
// in decode_int8.cu and decode_fp8.cu.
#include "decode.cuh"

namespace fa2 {
namespace dec {

cudaError_t run_dense(int dtype, const DecParams& p, int B, int n_chunks, int D, int G,
                      cudaStream_t s) {
  return run<void>(dtype, p, B, n_chunks, D, G, s);
}

}  // namespace dec
}  // namespace fa2

// cache_kind: fa2::dec::CacheKind. tables == null: contiguous caches
// [B, Hkv, rows, D]; else paged pools [n_pages, Hkv, rows, D] read through
// tables [B, max_pages]. k_scale / v_scale: null, or the fp32 scales of a
// quantized cache laid out [.., Hkv, 1, rows]. n_chunks: blocks per (slot,
// KV head), ceil(cap / CHUNK) for cap = rows (contiguous) or max_pages *
// rows (paged). With
// n_chunks > 1, partials is fp32 scratch [B, Hkv, n_chunks, G, D + 2] and
// counters int32 [B * Hkv], zero before the launch and zero after it.
extern "C" int fa2_decode(
    int dtype, int cache_kind, int B, int Hq, int Hkv, int D,
    const void* q, const void* k_cache, const void* v_cache, void* o, const int* kv_lens,
    const float* k_scale, const float* v_scale, const int* tables,
    int max_pages, int rows, int window_left, float softmax_scale, float softcap,
    int n_chunks, float* partials, int* counters, void* stream) {
  constexpr int CHUNK = fa2::dec::CHUNK;
  const long long cap = tables ? (long long)max_pages * rows : rows;
  if (n_chunks != (cap > CHUNK ? (cap + CHUNK - 1) / CHUNK : 1) ||
      (tables && rows % fa2::dec::RUN != 0) ||
      (n_chunks > 1 && (!partials || !counters)) || B > 65535 || Hkv > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  fa2::dec::DecParams p;
  p.q = q; p.k = k_cache; p.v = v_cache; p.o = o; p.kv_lens = kv_lens;
  p.k_scale = k_scale; p.v_scale = v_scale; p.tables = tables;
  p.part = partials; p.counters = counters;
  p.Hq = Hq; p.Hkv = Hkv; p.rows = rows; p.max_pages = max_pages; p.wl = window_left;
  p.scale_log2 = softmax_scale * fa2::LOG2E;
  p.softcap = softcap;
  const int G = Hq / Hkv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cache_kind) {
    case fa2::dec::kDense: return (int)fa2::dec::run_dense(dtype, p, B, n_chunks, D, G, s);
    case fa2::dec::kInt8: return (int)fa2::dec::run_int8(dtype, p, B, n_chunks, D, G, s);
    case fa2::dec::kFp8: return (int)fa2::dec::run_fp8(dtype, p, B, n_chunks, D, G, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
