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
//   * the dequant: int8 and e4m3 values are exact in fp32, bf16 and fp16
//     (the TPU's integer bit-twiddle, decode.py:42-71, was a v5e workaround
//     with the same output). The k scale multiplies each row's score and the
//     v scale that row's probability in the PV sum, as the TPU kernel folds
//     them (decode.py:117-119, 141-144), while the softmax denominator sums
//     the unscaled probabilities. The dequantized K/V never leaves the block.
//
// Function: for each slot b and KV head hk, the G = Hq / Hkv query heads of
// that group attend to logical rows [first, kv_len), first = kv_len - 1 -
// window_left when a window is set, with a base-2 online softmax (softcap
// applied in natural units) and fp32 accumulators. A row with no valid key
// yields 0. kv_len is clamped to cap = S_max (contiguous) or max_pages *
// page (paged). q and o are [B, Hq, D]; everything is contiguous.
//
// Bound on the H100: memory. Each (slot, KV head) reads 2 * kv_len * D
// bytes of K/V per cache byte width (+ 8 bytes of scales per row when
// quantized) for about 4 * G * kv_len * D flops: a few flops per byte, far
// under the ~295 flop/byte ridge, so the roof is 3.35 TB/s of HBM, and the
// card reaches it only with every SM streaming. The design against that:
//   * split-KV on a grid fixed by shapes the host knows: (n_chunks = ceil(cap
//     / CHUNK), Hkv, B) blocks, each (slot, KV head) cut into chunks of
//     CHUNK = 512 logical rows (a multiple of 128, measured faster than 256
//     at 8 slots x 4096; the host never reads kv_lens).
//     A block whose chunk holds no row of [first, kv_len) exits at once, so
//     the short slots cost nothing and the longest one is spread over its
//     cap / CHUNK blocks. A block holds the whole GQA group, so every K/V
//     byte is read from HBM once and used by all G query heads;
//   * a deterministic merge: a slot with one live chunk writes o from its
//     block. Otherwise each block writes its partial (m, l, acc[D]) per head
//     to fp32 scratch [B, Hkv, n_chunks, G, D + 2], and the block that
//     arrives last at the (slot, KV head)'s int32 counter (fence, atomicAdd;
//     the counter counts the live chunks and is reset to 0 by that block)
//     merges the partials in chunk order, so arrival order changes no bit;
//     no accumulator is ever updated atomically;
//   * a pipelined row stream: each of the 4 warps (2 at D 384 / 512, whose
//     four rings would need 301-399 KB of shared memory) walks its own
//     16-row groups of the chunk (8 for fp32 caches) through a 3-stage ring
//     in shared memory filled by 16-byte cp.async copies (4-byte for the
//     scales), so two groups are in flight while one is computed. Rows
//     outside [first, kv_len) are zero-filled without being read: no row
//     past a length, no page released behind the window, no table entry
//     past the last live page, so NaN there cannot reach the output;
//   * one table read per page run: CHUNK and the page are multiples of 128, so
//     each 128-row run of a chunk lies in one page; one thread per run reads
//     its table entry (or computes the contiguous base) into shared memory,
//     and a row's index is that base + (s & 127), with no per-row division;
//   * scores on the tensor cores for 16-bit q (bf16 / fp16): with the GQA
//     group as the 8 columns of mma.sync m16n8k16, S^T = K Q^T takes K rows
//     by ldmatrix and q from registers (from shared memory at D 384 / 512,
//     where O^T alone takes 96-128 registers a thread), and O^T = V^T P^T
//     takes V by ldmatrix.trans and P^T by movmatrix.trans of the packed
//     scores; the softmax's row max is three shuffles per head and 16 rows.
//     8-bit rows are first widened to the compute type in shared memory
//     (exact, by bit operations). P is rounded to the compute type, as in
//     the forwards; over a quantized cache p times the v scale goes in as
//     two 16-bit terms (hi + lo), so its rounding stays under the output's
//     own.
//     fp32 q keeps FMA: each lane holds D / 32 elements of q (read from
//     shared memory at D 384 / 512) and a score is a warp sum.
// Paged and contiguous give the same chunks, groups, row-to-thread map and
// order on the same rows, so they give the same output bit for bit; a pool
// whose max_pages * page exceeds S_max only adds chunks with no live row.
#pragma once

#include <type_traits>

#include "mma_tiles.cuh"

namespace fa2 {
namespace dec {

constexpr int RUN = 128;                  // rows of a page run (the page-size multiple)
constexpr int CHUNK = 512;                // logical rows per block (ops/decode.py mirrors it)
constexpr int RUNS = CHUNK / RUN;         // page runs of a chunk
static_assert(CHUNK % RUN == 0, "each page run of a chunk lies in one page");
constexpr int NS = 3;                     // ring stages of a warp
constexpr int HP = 8;                     // query heads of a group, padded (mma N)

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
  float* part;            // [B, Hkv, n_chunks, G, D + 2] partials (n_chunks > 1), else null
  int* counters;          // [B * Hkv] arrival counters, 0 between launches (n_chunks > 1)
  int Hq, Hkv, rows, max_pages, wl;  // rows: S_max (contiguous) or the page size
  float scale_log2;       // softmax_scale * log2(e)
  float softcap;          // natural units; 0 = off
};

template <typename C>
constexpr bool kQuant = std::is_same<C, int8_t>::value || std::is_same<C, __nv_fp8_e4m3>::value;

// Shared-memory plan of one instantiation. Each of the NW warps owns NS
// stages of GR rows of K then V (row pitch RP elements of C; the 16-bit ring
// is padded by 8 elements so ldmatrix's 8 row addresses fall in distinct
// bank groups), the rows' scales when quantized, and, for 8-bit rows on the
// tensor cores, one stage widened to T (pitch WP). Past D 256 (QS) the
// group's q follows the rings: [HP][D + 8] of T for the tensor cores, [HP][D]
// fp32 times scale * log2 e for FMA. After the row loop the rings hold the
// warps' states for the block's merge (RED_P: padded pitch).
template <typename T, typename C, int D>
struct Cfg {
  static constexpr bool MMA = !std::is_same<T, float>::value;
  static constexpr bool QUANT = kQuant<C>;
  static constexpr bool WIDEN = MMA && QUANT;
  static constexpr bool QS = D > 256;                  // q in shared memory
  static constexpr int NW = D > 256 ? 2 : 4;           // warps of a block
  static constexpr int NT = NW * 32;
  static constexpr int GR = (MMA || sizeof(C) < 4) ? 16 : 8;
  static constexpr int RP = (MMA && !QUANT) ? D + 8 : D;
  static constexpr int WP = D + 8;
  static constexpr int STAGE = 2 * GR * RP * (int)sizeof(C);
  static constexpr int SCALES = QUANT ? 2 * GR * 4 : 0;
  static constexpr int WARP_BYTES = NS * (STAGE + SCALES) + (WIDEN ? 2 * GR * WP * 2 : 0);
  static constexpr int QP = D + 8;                     // the staged q's row pitch (MMA)
  static constexpr int Q_BYTES = QS ? (MMA ? HP * QP * 2 : HP * D * 4) : 0;
  static constexpr int RED_P = D + 4;
  static constexpr int RED_BYTES = NW * HP * (RED_P + 2) * 4;
  static constexpr int LOOP_BYTES = NW * WARP_BYTES + Q_BYTES;
  static constexpr int SMEM = LOOP_BYTES > RED_BYTES ? LOOP_BYTES : RED_BYTES;
  static_assert(STAGE % 16 == 0 && SCALES % 16 == 0, "16-byte aligned regions");
  static_assert(RUN % GR == 0, "a group lies in one page run");
};

// ---- 8-bit rows widened to 16 bits, exactly -----------------------------

// Four cache values (one 32-bit word, first in the low byte) as two pairs of
// T, exactly. int8 -> fp16: 0x64uu is 1024 + uu, so (x ^ 0x80) placed there
// minus 1152 is x. int8 -> bf16 and e4m3 -> bf16 go through an exact fp32
// (2^23 + uu minus 2^23 + 128; e4m3's bits placed in fp32's fields, times
// 2^120, subnormals included), whose high half is the bf16 (at most 8
// significant bits). e4m3 -> fp16: the bits in fp16's fields, times 2^8.
template <typename T, typename C>
__device__ __forceinline__ uint2 widen4(uint32_t w) {
  constexpr bool HALF = std::is_same<T, __half>::value;
  if constexpr (std::is_same<C, int8_t>::value) {
    const uint32_t u = w ^ 0x80808080u;
    if constexpr (HALF) {
      const __half2 bias = __half2half2(__ushort_as_half(0x6480));  // 1152
      uint32_t lo = __byte_perm(u, 0x64646464u, 0x4140), hi = __byte_perm(u, 0x64646464u, 0x4342);
      __half2 a = __hsub2(*reinterpret_cast<__half2*>(&lo), bias);
      __half2 b = __hsub2(*reinterpret_cast<__half2*>(&hi), bias);
      return make_uint2(*reinterpret_cast<uint32_t*>(&a), *reinterpret_cast<uint32_t*>(&b));
    } else {
      uint32_t f[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        f[i] = __float_as_uint(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 | i)) -
                               8388736.f);
      }
      return make_uint2(__byte_perm(f[0], f[1], 0x7632), __byte_perm(f[2], f[3], 0x7632));
    }
  } else {
    if constexpr (HALF) {
      const __half2 two8 = __half2half2(__ushort_as_half(0x5C00));  // 256
      uint32_t h[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const uint32_t t = __byte_perm(w, 0u, i == 0 ? 0x1404 : 0x3424);  // bytes at bits 8 / 24
        uint32_t bits = ((t >> 1) & 0x3F803F80u) | (t & 0x80008000u);
        __half2 x = __hmul2(*reinterpret_cast<__half2*>(&bits), two8);
        h[i] = *reinterpret_cast<uint32_t*>(&x);
      }
      return make_uint2(h[0], h[1]);
    } else {
      uint32_t f[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t y = __byte_perm(w, 0u, 0x0444 | (i << 12));  // byte i at bits 24..31
        const uint32_t bits = ((y >> 4) & 0x07F00000u) | (y & 0x80000000u);
        f[i] = __float_as_uint(__uint_as_float(bits) * __uint_as_float(0x7B800000u));  // x 2^120
      }
      return make_uint2(__byte_perm(f[0], f[1], 0x7632), __byte_perm(f[2], f[3], 0x7632));
    }
  }
}

// ---- the row stream ---------------------------------------------------------

// Copies of group j of the chunk at logical row c0 (rows c0 + j GR ..) into
// stage `st` of the warp's ring; the group lies in one 128-row run, whose
// first row's index in the cache is run_base[run - run0]. Rows outside
// [lo, hi) are zero-filled without a read. Not committed.
template <class Cf, typename C, int D>
__device__ __forceinline__ void issue_group(const DecParams& p, unsigned char* wbase, int st,
                                            int c0, int j, const long long* run_base, int run0,
                                            int lo, int hi) {
  constexpr int PER = 16 / (int)sizeof(C);  // elements of a 16-byte piece
  constexpr int CPR = D / PER;              // pieces of a row
  const int lane = threadIdx.x % 32;
  const int row0 = c0 + j * Cf::GR;
  const long long rbase = run_base[row0 / RUN - run0] + row0 % RUN;
  C* kd = reinterpret_cast<C*>(wbase + st * Cf::STAGE);
  C* vd = kd + Cf::GR * Cf::RP;
  const C* ks = static_cast<const C*>(p.k);
  const C* vs = static_cast<const C*>(p.v);
#pragma unroll
  for (int i = lane; i < Cf::GR * CPR; i += 32) {
    const int r = i / CPR, col = (i % CPR) * PER;
    const bool ok = row0 + r >= lo && row0 + r < hi;
    const long long off = (rbase + r) * D + col;
    cp_async16(kd + r * Cf::RP + col, ok ? ks + off : ks, ok);
    cp_async16(vd + r * Cf::RP + col, ok ? vs + off : vs, ok);
  }
  if constexpr (Cf::QUANT) {
    if (lane < 2 * Cf::GR) {
      const int r = lane % Cf::GR;
      const bool ok = row0 + r >= lo && row0 + r < hi;
      const float* src = lane < Cf::GR ? p.k_scale : p.v_scale;
      float* dst = reinterpret_cast<float*>(wbase + NS * Cf::STAGE + st * Cf::SCALES);
      cp_async4(dst + lane, ok ? src + rbase + r : src, ok);
    }
  }
}

// The 8-bit K and V rows of a landed stage, widened to T into the warp's
// widen buffer (pitch WP), by the warp's lanes.
template <class Cf, typename T, typename C, int D>
__device__ __forceinline__ void widen_stage(const unsigned char* src, T* dst) {
  constexpr int PR = D / 16;  // 16-byte pieces of an 8-bit row
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int i = lane; i < 2 * Cf::GR * PR; i += 32) {
    const int r = i / PR, col = (i % PR) * 16;  // r: row of K (< GR) then V
    const uint4 raw = *reinterpret_cast<const uint4*>(src + r * D + col);
    const uint2 a = widen4<T, C>(raw.x), b = widen4<T, C>(raw.y);
    const uint2 c = widen4<T, C>(raw.z), d = widen4<T, C>(raw.w);
    T* out = dst + r * Cf::WP + col;
    *reinterpret_cast<uint4*>(out) = make_uint4(a.x, a.y, b.x, b.y);
    *reinterpret_cast<uint4*>(out + 8) = make_uint4(c.x, c.y, d.x, d.y);
  }
}

// ---- one group on the tensor cores (16-bit q) ------------------------------

// Lane (4 i + t) holds heads 2 t, 2 t + 1 of the group: their running max
// (warp-uniform over i), a partial sum over its own rows (reduced across i at
// the end), and O^T's accumulators acc[md] = rows d = 16 md + i (+ 8) of
// those two heads. qb(kk, b0, b1) gives Q^T's B fragments of k-step kk
// (head i, d pairs 2 t (+ 8)).
template <class Cf, typename T, int D, class QFrag>
__device__ __forceinline__ void mma_group(const DecParams& p, const T* Ks, const T* Vs,
                                          const float* ksc, const float* vsc, int row0, int lo,
                                          int hi, const QFrag& qb, float (&m_run)[2],
                                          float (&l_run)[2], float (&acc)[D / 16][4]) {
  constexpr int P = Cf::WIDEN ? Cf::WP : Cf::RP;
  constexpr int MB = Cf::GR / 16;
  const int lane = threadIdx.x % 32, i4 = lane / 4;
  float s[MB][4];
#pragma unroll
  for (int mb = 0; mb < MB; ++mb) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[mb][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, Ks + (mb * 16 + lane % 16) * P + kk * 16 + (lane / 16) * 8);
      uint32_t b0, b1;
      qb(kk, b0, b1);
      mma16816<T>(s[mb], a, b0, b1);
    }
  }
  // Element e of m-block mb: row mb * 16 + i4 + 8 (e / 2), head 2 t + e % 2.
  float mx[2] = {MASK_LOG2, MASK_LOG2};
#pragma unroll
  for (int mb = 0; mb < MB; ++mb)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = mb * 16 + i4 + 8 * (e / 2);
      float x = s[mb][e] * p.scale_log2;
      if constexpr (Cf::QUANT) x *= ksc[r];
      if (p.softcap > 0.f) x = p.softcap * tanhf(x * (1.f / LOG2E) / p.softcap) * LOG2E;
      if (row0 + r < lo || row0 + r >= hi) x = neg_inf();
      s[mb][e] = x;
      mx[e % 2] = fmaxf(mx[e % 2], x);
    }
  float alpha[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], o));
    const float m_new = fmaxf(m_run[h], mx[h]);
    alpha[h] = exp2f(m_run[h] - m_new);
    m_run[h] = m_new;
    l_run[h] *= alpha[h];
  }
#pragma unroll
  for (int md = 0; md < D / 16; ++md)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[md][e] *= alpha[e % 2];
#pragma unroll
  for (int mb = 0; mb < MB; ++mb) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float pr = exp2f(s[mb][e] - m_run[e % 2]);  // masked: exp2(-inf) = 0
      l_run[e % 2] += pr;
      s[mb][e] = Cf::QUANT ? pr * vsc[mb * 16 + i4 + 8 * (e / 2)] : pr;
    }
    // P^T's B fragments: the packed 8 x 8 blocks of S^T, transposed. A
    // quantized cache's p v_scale goes in as two 16-bit terms, hi + lo (its
    // error ~2^-17 relative): V is exact in T, and one rounding of p v_scale
    // costs as much as the output's own rounding.
    uint32_t hi[2] = {pack2<T>(s[mb][0], s[mb][1]), pack2<T>(s[mb][2], s[mb][3])};
    uint32_t lo[2] = {0u, 0u};
    if constexpr (Cf::QUANT) {
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const float2 h = unpack2<T>(hi[x]);
        lo[x] = movmatrix_t(pack2<T>(s[mb][2 * x] - h.x, s[mb][2 * x + 1] - h.y));
      }
    }
#pragma unroll
    for (int x = 0; x < 2; ++x) hi[x] = movmatrix_t(hi[x]);
#pragma unroll
    for (int md = 0; md < D / 16; ++md) {
      uint32_t a[4];
      ldsm_x4_t(a, Vs + (mb * 16 + (lane / 16) * 8 + lane % 8) * P + md * 16 +
                       ((lane / 8) % 2) * 8);
      mma16816<T>(acc[md], a, hi[0], hi[1]);
      if constexpr (Cf::QUANT) mma16816<T>(acc[md], a, lo[0], lo[1]);
    }
  }
}

// ---- one group by FMA (fp32 q) ----------------------------------------------

// Lane l holds elements [l EPL, (l + 1) EPL) of q (times scale * log2 e;
// q(g, e) reads them) and of each head's accumulator; m and l are
// warp-uniform. A softmax step takes FMA_ROWS rows (2 at D 256, where 4
// rows of K and V in registers spill; 1 past it).
template <class Cf, typename C, int D, int G, class QElem>
__device__ __forceinline__ void fma_group(const DecParams& p, const C* Ks, const C* Vs,
                                          const float* ksc, const float* vsc, int row0, int lo,
                                          int hi, const QElem& q, float (&m)[G], float (&l)[G],
                                          float (&acc)[G][D / 32]) {
  constexpr int EPL = D / 32;
  constexpr int FMA_ROWS = D > 256 ? 1 : D == 256 ? 2 : 4;
  const int lane = threadIdx.x % 32;
#pragma unroll 1
  for (int r0 = 0; r0 < Cf::GR; r0 += FMA_ROWS) {
    if (row0 + r0 + FMA_ROWS <= lo || row0 + r0 >= hi) continue;
    float kr[FMA_ROWS][EPL], vr[FMA_ROWS][EPL];
#pragma unroll
    for (int r = 0; r < FMA_ROWS; ++r) {
      load_vec<C, EPL>(Ks + (r0 + r) * Cf::RP + lane * EPL, kr[r]);
      load_vec<C, EPL>(Vs + (r0 + r) * Cf::RP + lane * EPL, vr[r]);
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float sc[FMA_ROWS];
#pragma unroll
      for (int r = 0; r < FMA_ROWS; ++r) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) d = fmaf(q(g, e), kr[r][e], d);
        sc[r] = warp_sum(d);
        if constexpr (Cf::QUANT) sc[r] *= ksc[r0 + r];
      }
      float mx = m[g];
#pragma unroll
      for (int r = 0; r < FMA_ROWS; ++r) {
        if (p.softcap > 0.f) sc[r] = p.softcap * tanhf(sc[r] * (1.f / LOG2E) / p.softcap) * LOG2E;
        if (row0 + r0 + r < lo || row0 + r0 + r >= hi) sc[r] = neg_inf();
        mx = fmaxf(mx, sc[r]);
      }
      const float alpha = exp2f(m[g] - mx);
      float pr[FMA_ROWS], sum = 0.f;
#pragma unroll
      for (int r = 0; r < FMA_ROWS; ++r) {
        pr[r] = exp2f(sc[r] - mx);
        sum += pr[r];
      }
      l[g] = l[g] * alpha + sum;
      m[g] = mx;
      if constexpr (Cf::QUANT) {
#pragma unroll
        for (int r = 0; r < FMA_ROWS; ++r) pr[r] *= vsc[r0 + r];
      }
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        float a = acc[g][e] * alpha;
#pragma unroll
        for (int r = 0; r < FMA_ROWS; ++r) a = fmaf(pr[r], vr[r][e], a);
        acc[g][e] = a;
      }
    }
  }
}

// ---- the kernel -----------------------------------------------------------

// T: type of q and o; C: cache element type (T, int8_t or __nv_fp8_e4m3).
// Block (chunk c, KV head hk, slot b).
template <typename T, typename C, bool PAGED, int D, int G>
__global__ void __launch_bounds__(Cfg<T, C, D>::NT) decode_kernel(const DecParams p) {
  using Cf = Cfg<T, C, D>;
  constexpr int NW = Cf::NW, NT = Cf::NT;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ long long run_base[RUNS];
  __shared__ int last;

  const int c = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int cap = PAGED ? p.max_pages * p.rows : p.rows;
  const int kv_len = min(max(p.kv_lens[b], 0), cap);
  const int first = p.wl >= 0 ? max(0, kv_len - 1 - p.wl) : 0;
  const int c_first = first / CHUNK;
  const int n_live = kv_len > first ? (kv_len - 1) / CHUNK - c_first + 1 : 0;
  T* op = static_cast<T*>(p.o) + ((long long)b * p.Hq + hk * G) * D;
  if (n_live == 0) {  // no valid key: o = 0, written by chunk 0
    if (c == 0) {
      for (int i = threadIdx.x; i < G * D; i += NT) op[i] = from_f<T>(0.f);
    }
    return;
  }
  if (c < c_first || c >= c_first + n_live) return;
  const int c0 = c * CHUNK;
  const int lo = max(first, c0), hi = min(kv_len, c0 + CHUNK);

  // One table read (or base) per 128-row run of the chunk's live rows.
  const int run0 = lo / RUN;
  if (threadIdx.x <= (hi - 1) / RUN - run0) {
    const int r = run0 + threadIdx.x;
    if constexpr (PAGED) {
      const int rpp = p.rows / RUN;
      const long long page = p.tables[(long long)b * p.max_pages + r / rpp];
      run_base[threadIdx.x] = (page * p.Hkv + hk) * p.rows + (r % rpp) * RUN;
    } else {
      run_base[threadIdx.x] = ((long long)b * p.Hkv + hk) * p.rows + (long long)r * RUN;
    }
  }
  // Past D 256 the group's q goes to shared memory once, for every warp:
  // rows h >= G of the tensor cores' [HP][QP] are zero; FMA's [G][D] is
  // scaled by scale * log2 e.
  T* q_mma = reinterpret_cast<T*>(smem + Cf::NW * Cf::WARP_BYTES);
  float* q_fma = reinterpret_cast<float*>(smem + Cf::NW * Cf::WARP_BYTES);
  if constexpr (Cf::QS) {
    const T* qg = static_cast<const T*>(p.q) + ((long long)b * p.Hq + hk * G) * D;
    for (int i = threadIdx.x; i < HP * D; i += NT) {
      const int h = i / D, d = i % D;
      if constexpr (Cf::MMA) {
        q_mma[h * Cf::QP + d] = h < G ? qg[i] : from_f<T>(0.f);
      } else if (h < G) {
        q_fma[i] = to_f(qg[i]) * p.scale_log2;
      }
    }
  }
  __syncthreads();

  // The warp's groups: j = j_lo + warp, + NW, ... up to j_hi, each GR rows
  // from c0 + j GR.
  unsigned char* wbase = smem + warp * Cf::WARP_BYTES;
  const int j_lo = (lo - c0) / Cf::GR, j_hi = (hi - 1 - c0) / Cf::GR;

  // Per-warp state: the tensor-core layout (MMA) or the FMA layout; q in
  // registers up to D 256, else read from shared memory where it is used.
  constexpr int EPL = D / 32;
  constexpr bool QR = !Cf::QS;
  uint32_t qb[Cf::MMA && QR ? D / 16 : 1][2];
  float qf[!Cf::MMA && QR ? G : 1][!Cf::MMA && QR ? EPL : 1];
  float m2[2], l2[2], acc2[Cf::MMA ? D / 16 : 1][4];
  float mG[Cf::MMA ? 1 : G], lG[Cf::MMA ? 1 : G], accG[Cf::MMA ? 1 : G][Cf::MMA ? 1 : EPL];
  if constexpr (Cf::MMA) {
    const int h = lane / 4, t = lane % 4;
    const T* qrow = static_cast<const T*>(p.q) + ((long long)b * p.Hq + hk * G + h) * D;
    if constexpr (QR) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        qb[kk][0] = h < G ? *reinterpret_cast<const uint32_t*>(qrow + kk * 16 + 2 * t) : 0u;
        qb[kk][1] = h < G ? *reinterpret_cast<const uint32_t*>(qrow + kk * 16 + 2 * t + 8) : 0u;
      }
    }
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      m2[h2] = MASK_LOG2;
      l2[h2] = 0.f;
    }
#pragma unroll
    for (int md = 0; md < D / 16; ++md)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc2[md][e] = 0.f;
  } else {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if constexpr (QR) {
        load_vec<T, EPL>(static_cast<const T*>(p.q) + ((long long)b * p.Hq + hk * G + g) * D +
                             lane * EPL,
                         qf[g]);
#pragma unroll
        for (int e = 0; e < EPL; ++e) qf[g][e] *= p.scale_log2;
      }
      mG[g] = MASK_LOG2;
      lG[g] = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) accG[g][e] = 0.f;
    }
  }

  // The warp's row stream: groups it + 1 .. it + NS - 1 in flight while group it computes.
  const int j0 = j_lo + warp;
#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (j0 + s * NW <= j_hi) {
      issue_group<Cf, C, D>(p, wbase, s, c0, j0 + s * NW, run_base, run0, lo, hi);
    }
    cp_async_commit();
  }
#pragma unroll 1
  for (int j = j0, it = 0; j <= j_hi; j += NW, ++it) {
    if (j + (NS - 1) * NW <= j_hi) {
      issue_group<Cf, C, D>(p, wbase, (it + NS - 1) % NS, c0, j + (NS - 1) * NW, run_base, run0,
                            lo, hi);
    }
    cp_async_commit();
    cp_async_wait<NS - 1>();
    __syncwarp();
    const int st = it % NS, row0 = c0 + j * Cf::GR;
    const C* Kst = reinterpret_cast<const C*>(wbase + st * Cf::STAGE);
    const float* ksc = reinterpret_cast<const float*>(wbase + NS * Cf::STAGE + st * Cf::SCALES);
    const float* vsc = ksc + Cf::GR;
    if constexpr (Cf::MMA) {
      const T *Ks, *Vs;
      if constexpr (Cf::WIDEN) {
        T* wid = reinterpret_cast<T*>(wbase + NS * (Cf::STAGE + Cf::SCALES));
        widen_stage<Cf, T, C, D>(reinterpret_cast<const unsigned char*>(Kst), wid);
        __syncwarp();
        Ks = wid;
        Vs = wid + Cf::GR * Cf::WP;
      } else {
        Ks = reinterpret_cast<const T*>(Kst);
        Vs = Ks + Cf::GR * Cf::RP;
      }
      auto q_frag = [&](int kk, uint32_t& b0, uint32_t& b1) {
        if constexpr (QR) {
          b0 = qb[kk][0];
          b1 = qb[kk][1];
        } else {
          const T* qr = q_mma + (lane / 4) * Cf::QP + kk * 16 + 2 * (lane % 4);
          b0 = *reinterpret_cast<const uint32_t*>(qr);
          b1 = *reinterpret_cast<const uint32_t*>(qr + 8);
        }
      };
      mma_group<Cf, T, D>(p, Ks, Vs, ksc, vsc, row0, lo, hi, q_frag, m2, l2, acc2);
    } else {
      auto q_elem = [&](int g, int e) {
        if constexpr (QR) {
          return qf[g][e];
        } else {
          return q_fma[g * D + lane * EPL + e];
        }
      };
      fma_group<Cf, C, D, G>(p, Kst, Kst + Cf::GR * Cf::RP, ksc, vsc, row0, lo, hi, q_elem, mG,
                             lG, accG);
    }
    __syncwarp();
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with its ring: the merge reuses it

  // The warps' states into shared memory: red_acc[w][h][RED_P], red_m / red_l [w][h].
  float* red_acc = reinterpret_cast<float*>(smem);
  float* red_m = red_acc + NW * HP * Cf::RED_P;
  float* red_l = red_m + NW * HP;
  if constexpr (Cf::MMA) {
    const int i4 = lane / 4, t = lane % 4;
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) l2[h2] += __shfl_xor_sync(0xffffffffu, l2[h2], o);
      if (i4 == 0) {
        red_m[warp * HP + 2 * t + h2] = m2[h2];
        red_l[warp * HP + 2 * t + h2] = l2[h2];
      }
    }
#pragma unroll
    for (int md = 0; md < D / 16; ++md)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = 2 * t + e % 2, d = md * 16 + i4 + 8 * (e / 2);
        red_acc[(warp * HP + h) * Cf::RED_P + d] = acc2[md][e];
      }
  } else {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (lane == 0) {
        red_m[warp * HP + g] = mG[g];
        red_l[warp * HP + g] = lG[g];
      }
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        red_acc[(warp * HP + g) * Cf::RED_P + lane * EPL + e] = accG[g][e];
      }
    }
  }
  __syncthreads();

  // The block's state per (head, d): o itself when the slot has one live
  // chunk, else this chunk's partial.
  const long long slot_part = ((long long)b * p.Hkv + hk) * gridDim.x;  // partial rows / G
  for (int i = threadIdx.x; i < G * D; i += NT) {
    const int g = i / D, d = i % D;
    float M = MASK_LOG2;
#pragma unroll
    for (int w = 0; w < NW; ++w) M = fmaxf(M, red_m[w * HP + g]);
    float L = 0.f, O = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float sc = exp2f(red_m[w * HP + g] - M);
      L = fmaf(red_l[w * HP + g], sc, L);
      O = fmaf(red_acc[(w * HP + g) * Cf::RED_P + d], sc, O);
    }
    if (n_live == 1) {
      op[i] = from_f<T>(L > 0.f ? O / L : 0.f);
    } else {
      float* pp = p.part + ((slot_part + c) * G + g) * (D + 2);
      pp[d] = O;
      if (d == 0) {
        pp[D] = M;
        pp[D + 1] = L;
      }
    }
  }
  if (n_live == 1) return;

  // The last block of the slot's live chunks merges them, in chunk order.
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(p.counters + b * p.Hkv + hk, 1) == n_live - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int i = threadIdx.x; i < G * D; i += NT) {
    const int g = i / D, d = i % D;
    const float* pp = p.part + ((slot_part + c_first) * G + g) * (D + 2);
    constexpr int CS = G * (D + 2);  // floats from one chunk's partial to the next
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

// The shared-memory attribute is set once per instantiation and device: the
// decode step is host-bound, and this launch runs once per layer per step.
template <typename T, typename C, bool PAGED, int D, int G>
cudaError_t launch(const DecParams& p, int B, int n_chunks, cudaStream_t stream) {
  using Cf = Cfg<T, C, D>;
  static unsigned long long smem_set = 0;  // bit d: set on device d
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 64 || !(smem_set >> dev & 1ull)) {
    e = cudaFuncSetAttribute(decode_kernel<T, C, PAGED, D, G>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, Cf::SMEM);
    if (e != cudaSuccess) return e;
    if (dev < 64) smem_set |= 1ull << dev;
  }
  dim3 grid(n_chunks, p.Hkv, B);
  decode_kernel<T, C, PAGED, D, G><<<grid, Cf::NT, Cf::SMEM, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, typename C, bool PAGED, int D>
cudaError_t launch_g(const DecParams& p, int B, int n_chunks, int G, cudaStream_t stream) {
  switch (G) {
    case 1: return launch<T, C, PAGED, D, 1>(p, B, n_chunks, stream);
    case 2: return launch<T, C, PAGED, D, 2>(p, B, n_chunks, stream);
    case 4: return launch<T, C, PAGED, D, 4>(p, B, n_chunks, stream);
    case 8: return launch<T, C, PAGED, D, 8>(p, B, n_chunks, stream);
    default: return cudaErrorInvalidValue;
  }
}

// The head dims of one translation unit: 64 / 128 / 256, or (WIDE) 384 / 512,
// each set compiled apart so that the two build in parallel.
template <typename T, typename C, bool PAGED, bool WIDE>
cudaError_t launch_dg(const DecParams& p, int B, int n_chunks, int D, int G, cudaStream_t stream) {
  if constexpr (WIDE) {
    switch (D) {
      case 384: return launch_g<T, C, PAGED, 384>(p, B, n_chunks, G, stream);
      case 512: return launch_g<T, C, PAGED, 512>(p, B, n_chunks, G, stream);
      default: return cudaErrorInvalidValue;
    }
  } else {
    switch (D) {
      case 64: return launch_g<T, C, PAGED, 64>(p, B, n_chunks, G, stream);
      case 128: return launch_g<T, C, PAGED, 128>(p, B, n_chunks, G, stream);
      case 256: return launch_g<T, C, PAGED, 256>(p, B, n_chunks, G, stream);
      default: return cudaErrorInvalidValue;
    }
  }
}

// Cache type for compute type T: Q, or T itself when Q is void.
template <typename Q, typename T>
using cache_t = typename std::conditional<std::is_void<Q>::value, T, Q>::type;

// Every (compute dtype, layout, D, G) of one cache kind Q (void = dense) and
// one set of head dims.
template <typename Q, bool WIDE>
cudaError_t run(int dtype, const DecParams& p, int B, int n_chunks, int D, int G, cudaStream_t s) {
  const bool paged = p.tables != nullptr;
  switch (dtype) {
    case kF32:
      return paged ? launch_dg<float, cache_t<Q, float>, true, WIDE>(p, B, n_chunks, D, G, s)
                   : launch_dg<float, cache_t<Q, float>, false, WIDE>(p, B, n_chunks, D, G, s);
    case kF16:
      return paged ? launch_dg<__half, cache_t<Q, __half>, true, WIDE>(p, B, n_chunks, D, G, s)
                   : launch_dg<__half, cache_t<Q, __half>, false, WIDE>(p, B, n_chunks, D, G, s);
    case kBF16: {
      using C = cache_t<Q, __nv_bfloat16>;
      return paged ? launch_dg<__nv_bfloat16, C, true, WIDE>(p, B, n_chunks, D, G, s)
                   : launch_dg<__nv_bfloat16, C, false, WIDE>(p, B, n_chunks, D, G, s);
    }
    default: return cudaErrorInvalidValue;
  }
}

// One per translation unit: decode.cu, decode_int8.cu, decode_fp8.cu (D 64 /
// 128 / 256) and decode_wide.cu, decode_int8_wide.cu, decode_fp8_wide.cu
// (D 384 / 512).
cudaError_t run_dense(int dtype, const DecParams& p, int B, int n_chunks, int D, int G,
                      cudaStream_t s);
cudaError_t run_int8(int dtype, const DecParams& p, int B, int n_chunks, int D, int G,
                     cudaStream_t s);
cudaError_t run_fp8(int dtype, const DecParams& p, int B, int n_chunks, int D, int G,
                    cudaStream_t s);
cudaError_t run_dense_wide(int dtype, const DecParams& p, int B, int n_chunks, int D, int G,
                           cudaStream_t s);
cudaError_t run_int8_wide(int dtype, const DecParams& p, int B, int n_chunks, int D, int G,
                          cudaStream_t s);
cudaError_t run_fp8_wide(int dtype, const DecParams& p, int B, int n_chunks, int D, int G,
                         cudaStream_t s);

}  // namespace dec
}  // namespace fa2
