// Tensor-core tile math of the forward for 16-bit inputs (bf16, fp16),
// shared by flash_fwd.cu's flash_fwd_mma_kernel (the dense forward, its
// causal schedules and the split's merge) and varlen.cu's
// varlen_mma_fwd_kernel (the packed forward). Each kernel walks its own kv
// tiles and hands every tile to `fwd_mma_tile` with its element rule; both
// end in `fwd_mma_store`.
//
// A block of 4 warps owns a 64-row q tile, each warp 16 q rows for the
// whole kv loop, so a row's softmax state (m, l) stays in one warp's
// registers: row max and row sum are quad shuffles, with no shared memory
// and no barrier. Past D 256 (384, 512) O alone would take 192-256
// registers a thread, so 8 warps share the tile: two per 16 rows, each
// holding half of O's columns and each computing the rows' whole S and
// softmax (the same instructions on the same operands, so the pair's m and
// l agree bit for bit). S costs twice its tensor work there (a forward
// 1.5x the products of one S per row); no shared memory or barrier joins
// the pair until the store. q, k and v stay 16-bit in shared memory (rows
// padded by 8 elements, so the 8 row addresses of every ldmatrix fall in
// distinct bank groups). Q's A fragments are loaded once and kept in
// registers at D 64 / 128 (reloaded from shared memory per kv tile from D
// 256, where O alone takes 128 registers a thread). K / V tiles of BKV
// rows (64, 32 from D 256) arrive
// by 16-byte cp.async copies, double-buffered by the caller's loop; rows
// past the valid keys and q rows past the live ones are zero-filled on load
// (0 x NaN = NaN in an mma). Per tile:
//   * S = Q K^T with m16n8k16 (fp32 accumulation); scale * log2(e) is
//     applied to the fp32 accumulator, not folded into a rounded q (a fold
//     into a rounded q moves lse by ~2^-9 relative);
//   * the score epilogue at each accumulator element's (row, column) — the
//     caller's rule: mask, and in the dense kernel softcap and bias — unless
//     the caller knows every live row keeps the whole tile (`free_tile`);
//   * the online softmax in base 2; with dropout the caller's keep rule
//     drops p from the P V product only (l sums the undropped p);
//   * P rounded to the input dtype (as the TPU kernels round p to v's dtype
//     before P V) and repacked from S's accumulators into A fragments in
//     registers; O += P V with V by ldmatrix.trans.
#pragma once

#include "attn_tiles.cuh"
#include "mma_tiles.cuh"

namespace fa2 {

template <int D_>
struct FwdMmaCfg {
  static constexpr int D = D_;
  static constexpr int BQ = TM;                   // q rows of a block, 16 per row group
  static constexpr int RG = BQ / 16;              // row groups: warp w owns rows 16 (w % RG)
  static constexpr int WD = D <= 256 ? 1 : 2;     // warps of a row group, along O's columns
  static constexpr int NW = RG * WD;              // 4 warps (8 past D 256)
  static constexpr int BKV = D <= 128 ? 64 : 32;  // kv rows of a streamed K / V tile
  static constexpr int P = D + 8;                 // shared row pitch, elements
  static constexpr int NT_S = BKV / 8;            // n-tiles of a warp's S
  static constexpr int DO = D / WD;               // O columns of a warp: DO (w / RG) on
  static constexpr int NT_O = DO / 8;             // n-tiles of a warp's O
  static constexpr int KQ = D / 16;               // k-steps of Q K^T
  static constexpr bool Q_REGS = D <= 128;        // Q's A fragments held in registers
  static constexpr int SMEM_BYTES = (BQ + 4 * BKV) * P * 2;  // Q; K and V double-buffered
};

// Q's A fragments of rows g / g + 8 (and the 8-column halves) of the warp's
// 16 rows, kept in registers at D <= 128 (one unused slot otherwise).
template <class C>
using QFrags = uint32_t[C::Q_REGS ? C::KQ : 1][4];

// K and V rows [k0, k0 + BKV) into one buffer (K, then V BKV rows on);
// rows at or past `valid` are zero. Issues cp.async copies (not committed).
template <class C, typename T>
__device__ __forceinline__ void fwd_load_kv(T* dst, const T* kp, long long k_ss, const T* vp,
                                            long long v_ss, int k0, int valid) {
  cp_rows<C>(dst, kp, k_ss, k0, C::BKV, valid);
  cp_rows<C>(dst + C::BKV * C::P, vp, v_ss, k0, C::BKV, valid);
}

// Zero output accumulator and the running max / sum of rows g and g + 8.
template <class C>
__device__ __forceinline__ void fwd_mma_init(float (&o)[C::NT_O][4], float (&m_run)[2],
                                             float (&l_run)[2]) {
#pragma unroll
  for (int n = 0; n < C::NT_O; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    m_run[hr] = MASK_LOG2;
    l_run[hr] = 0.f;
  }
}

// Q's A fragments from the staged Q (Q_REGS only), after Q's copies landed
// and a barrier.
template <class C, typename T>
__device__ __forceinline__ void fwd_mma_load_q(QFrags<C>& qf, const T* Qs) {
  if constexpr (C::Q_REGS) {
    const int lane = threadIdx.x % 32, wr = threadIdx.x / 32 % C::RG;
#pragma unroll
    for (int kk = 0; kk < C::KQ; ++kk) {
      ldsm_x4(qf[kk], Qs + (wr * 16 + lane % 16) * C::P + kk * 16 + (lane / 16) * 8);
    }
  }
}

// The score epilogue and the online softmax of one tile's S (the warp's 16
// rows x NT_S * 8 keys, raw accumulators): s leaves as P (dropped elements 0
// with DROP; l sums the undropped p), m_run / l_run move on, and O is
// rescaled. score / keep as fwd_mma_tile's.
template <class C, bool DROP, class Score, class Keep>
__device__ __forceinline__ void fwd_mma_softmax(float (&s)[C::NT_S][4], float scale_log2,
                                                bool free_tile, const Score& score,
                                                const Keep& keep, float (&o)[C::NT_O][4],
                                                float (&m_run)[2], float (&l_run)[2]) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int w = threadIdx.x / 32 % C::RG;
  // The score epilogue at each element's (row r, column c) of the tile
  // (accumulator element e: row g + 8 (e / 2), column 2 t + e % 2).
  float mx[2] = {MASK_LOG2, MASK_LOG2};
#pragma unroll
  for (int n = 0; n < C::NT_S; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = w * 16 + g + (e / 2) * 8, c = n * 8 + 2 * t + (e % 2);
      float x = s[n][e] * scale_log2;
      if (!free_tile) x = score(r, c, x);
      s[n][e] = x;
      mx[e / 2] = fmaxf(mx[e / 2], x);
    }

  // Online softmax of rows g and g + 8: the quad of lanes 4 g .. 4 g + 3
  // holds a row's columns.
  float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
    mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
    const float m_new = fmaxf(m_run[hr], mx[hr]);
    alpha[hr] = exp2f(m_run[hr] - m_new);
    m_run[hr] = m_new;
  }
#pragma unroll
  for (int n = 0; n < C::NT_S; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float pr = exp2f(s[n][e] - m_run[e / 2]);  // masked: exp2(-inf) = 0
      rs[e / 2] += pr;
      if constexpr (DROP) {
        const int r = w * 16 + g + (e / 2) * 8, c = n * 8 + 2 * t + (e % 2);
        s[n][e] = keep(r, c, e / 2) ? pr : 0.f;
      } else {
        s[n][e] = pr;
      }
    }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    rs[hr] += __shfl_xor_sync(0xffffffffu, rs[hr], 1);
    rs[hr] += __shfl_xor_sync(0xffffffffu, rs[hr], 2);
    l_run[hr] = l_run[hr] * alpha[hr] + rs[hr];
  }
#pragma unroll
  for (int n = 0; n < C::NT_O; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] *= alpha[e / 2];
}

// One K / V tile against the warp's 16 q rows. score(r, c, x) returns the
// score in log2 units of tile row r (0..63) and tile column c after the
// caller's epilogue (-inf where the element is masked), called only when
// !free_tile; keep(r, c, hr) is the dropout rule (DROP only; hr = r's half,
// 0 for row g, 1 for g + 8).
template <class C, typename T, bool DROP, class Score, class Keep>
__device__ __forceinline__ void fwd_mma_tile(const QFrags<C>& qf, const T* Qs, const T* Ks,
                                             const T* Vs, float scale_log2, bool free_tile,
                                             const Score& score, const Keep& keep,
                                             float (&o)[C::NT_O][4], float (&m_run)[2],
                                             float (&l_run)[2]) {
  const int lane = threadIdx.x % 32;
  const int w = threadIdx.x / 32 % C::RG, od = threadIdx.x / 32 / C::RG * C::DO;

  // S = Q K^T: the warp's 16 rows x BKV keys.
  float s[C::NT_S][4];
#pragma unroll
  for (int n = 0; n < C::NT_S; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < C::KQ; ++kk) {
    uint32_t a[4];
    if constexpr (C::Q_REGS) {
#pragma unroll
      for (int j = 0; j < 4; ++j) a[j] = qf[kk][j];
    } else {
      ldsm_x4(a, Qs + (w * 16 + lane % 16) * C::P + kk * 16 + (lane / 16) * 8);
    }
#pragma unroll
    for (int np = 0; np < C::NT_S / 2; ++np) {
      uint32_t bk[4];
      ldsm_x4(bk, Ks + (np * 16 + lane % 8 + (lane / 16) * 8) * C::P + kk * 16 +
                      ((lane / 8) % 2) * 8);
      mma16816<T>(s[2 * np], a, bk[0], bk[1]);
      mma16816<T>(s[2 * np + 1], a, bk[2], bk[3]);
    }
  }

  fwd_mma_softmax<C, DROP>(s, scale_log2, free_tile, score, keep, o, m_run, l_run);

  // O += P V: P rounded to T and repacked from S's accumulators into A
  // fragments, V by ldmatrix.trans.
#pragma unroll
  for (int kk = 0; kk < C::BKV / 16; ++kk) {
    const uint32_t a[4] = {pack2<T>(s[2 * kk][0], s[2 * kk][1]),
                           pack2<T>(s[2 * kk][2], s[2 * kk][3]),
                           pack2<T>(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                           pack2<T>(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
    for (int np = 0; np < C::NT_O / 2; ++np) {
      uint32_t bv[4];
      ldsm_x4_t(bv, Vs + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * C::P + od + np * 16 +
                        (lane / 16) * 8);
      mma16816<T>(o[2 * np], a, bv[0], bv[1]);
      mma16816<T>(o[2 * np + 1], a, bv[2], bv[3]);
    }
  }
}

// Store: o = acc / l * out_scale (1 / (1 - p_drop) with dropout) and lse =
// m + log2 l of the tile's rows r < `rows` (o and lse: the tile's row 0, o
// with row stride o_ss); rows r >= `live` (free tiles gave them a sum) or
// that kept nothing get o = 0 and lse = -inf. A warp's o rows go through its
// own rows of `stage` (shared, pitch P: the staged Q, which no other warp
// reads; past D 256 each warp of a row pair moves its own columns, after a
// barrier, since both read all of Q), then out as 16-byte stores. MERGE
// (the split's rectangle) first reads the previous o and lse of those
// rows, then writes
//   m = max(lse_p, lse), w1 = 2^(lse_p - m), w2 = 2^(lse - m),
//   o = (o_p w1 + o w2) / (w1 + w2), lse = m + log2(w1 + w2)
// in their place (both dead: weights 0, o = 0, lse = -inf, no NaN).
template <class C, typename T, bool MERGE>
__device__ __forceinline__ void fwd_mma_store(const float (&o)[C::NT_O][4],
                                              const float (&m_run)[2], const float (&l_run)[2],
                                              T* stage, T* op, long long o_ss, float* lse,
                                              int live, int rows, float out_scale) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int w = threadIdx.x / 32 % C::RG, od = threadIdx.x / 32 / C::RG * C::DO;
  constexpr int CH = C::DO / 8;  // 16-byte chunks of a warp's part of a row
  float lse_p[2] = {0.f, 0.f};  // the previous lse of rows g and g + 8 (MERGE)
  if constexpr (C::WD > 1) {
    __syncthreads();  // the row pair is done reading Q
  } else {
    __syncwarp();
  }
  if constexpr (MERGE) {
    for (int i = lane; i < 16 * CH; i += 32) {
      const int r = w * 16 + i / CH, c = od + (i % CH) * 8;
      if (r < rows) {
        *reinterpret_cast<uint4*>(stage + r * C::P + c) =
            *reinterpret_cast<const uint4*>(op + (long long)r * o_ss + c);
      }
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = w * 16 + g + 8 * hr;
      lse_p[hr] = r < rows ? lse[r] : neg_inf();
    }
    // Every lane (past D 256: of both warps of the pair) has read its
    // previous o and lse before any is written.
    if constexpr (C::WD > 1) {
      __syncthreads();
    } else {
      __syncwarp();
    }
  }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = w * 16 + g + 8 * hr;
    const bool ok = r < live && l_run[hr] > 0.f;
    const float inv = ok ? 1.f / l_run[hr] * out_scale : 0.f;
    float lse_r = ok ? m_run[hr] + log2f(l_run[hr]) : neg_inf();
    float w1 = 0.f, w2 = 1.f, inv_t = 1.f;  // the merge's weights (none without MERGE)
    if constexpr (MERGE) {
      const float m_t = fmaxf(lse_p[hr], lse_r);
      const float m_safe = isfinite(m_t) ? m_t : 0.f;
      w1 = exp2f(lse_p[hr] - m_safe);
      w2 = exp2f(lse_r - m_safe);
      const float l_t = w1 + w2;
      inv_t = l_t > 0.f ? 1.f / l_t : 0.f;
      lse_r = l_t > 0.f ? m_safe + log2f(l_t) : neg_inf();
    }
#pragma unroll
    for (int n = 0; n < C::NT_O; ++n) {
      T* dst = stage + r * C::P + od + n * 8 + 2 * t;
      float o0 = o[n][2 * hr] * inv, o1 = o[n][2 * hr + 1] * inv;
      if constexpr (MERGE) {
        o0 = (to_f(dst[0]) * w1 + o0 * w2) * inv_t;
        o1 = (to_f(dst[1]) * w1 + o1 * w2) * inv_t;
      }
      *reinterpret_cast<uint32_t*>(dst) = pack2<T>(o0, o1);
    }
    if (t == 0 && od == 0 && r < rows) lse[r] = lse_r;
  }
  __syncwarp();
  for (int i = lane; i < 16 * CH; i += 32) {
    const int r = w * 16 + i / CH, c = od + (i % CH) * 8;
    if (r < rows) {
      *reinterpret_cast<uint4*>(op + (long long)r * o_ss + c) =
          *reinterpret_cast<const uint4*>(stage + r * C::P + c);
    }
  }
}

}  // namespace fa2
