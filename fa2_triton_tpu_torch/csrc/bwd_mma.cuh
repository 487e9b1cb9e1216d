// Tensor-core tile math of the backward for 16-bit inputs (bf16, fp16): the
// fused 5-product q step, shared by flash_bwd_tri.cu (B13 tri-square and
// diag) and flash_bwd_wl.cu (B14 work list); flash_bwd.cu's dkdv_mma_kernel
// and varlen.cu's varlen_mma_dkdv_kernel run the same q step without dS^T
// and dQ (each with its own element rule: the scale on the fp32 scores, and
// bias and softcap, or the packed masks), on the q loop `mma_q_loop`. The
// dq kernels' tiles (flash_bwd.cu's dq_mma_kernel, varlen.cu's
// varlen_mma_dq_kernel) close the file; their S / dP half (sdp_mma_tile) is
// also flash_bwd.cu's dbias_mma_kernel's. fp32 inputs keep bwd_fused.cuh's
// and attn_tiles.cuh's FMA tiles.
//
// A block of 8 warps owns a kv tile of BKV rows (128 at D 64 / 128, 64 at
// D 256, 32 at D 384 / 512) and streams q tiles of BQ rows (64; 32 past D
// 256) through shared memory. At D 128 / 256 a warp's dK and dV take 128 of
// its 255 registers, so S^T / dP^T go in passes of QH = 16 q columns (32 at
// D 64) and dQ in passes of QP = 32 columns: ptxas then spills nothing at
// D 128 / 256 (with passes of 32 / 64
// it spilled 20-48 bytes; the work list at D 64 spilled 16-32 bytes with
// one 64-column pass). All
// operands stay 16-bit in shared memory, rows padded by 8 elements (16
// bytes) so that the 8 row addresses of every ldmatrix fall in distinct
// bank groups. Tiles arrive by 16-byte cp.async copies that zero-fill rows
// past the lengths (the tensor cores give 0 x NaN = NaN, so padding that
// holds NaN must never reach an mma); q, do, lse and delta are
// double-buffered, so the next q tile loads while this one computes. K comes
// prescaled (k * scale * log2e rounded to its dtype, the TPU kernels' fold
// at fa2_triton_tpu/ops/flash_bwd.py:911-912), folded here when k_mul != 0.
//
// Per q tile, with mma.sync.m16n8k16 (fp32 accumulation) fed by ldmatrix:
//   S^T  = K_p Q^T and dP^T = V dO^T   warp w: kv rows 16 (w % KW), all BQ
//                                      q columns (A from K / V, B from Q /
//                                      dO, both non-transposed);
//   p, ds in registers                 grad_plain's rules: the mask, dropout
//                                      and dead rows, per accumulator
//                                      element at its (kv row, q row);
//   dV  += P^T dO, dK += dS^T Q        P^T / dS^T rounded to the input dtype
//                                      (JAX l.944-954) and repacked from
//                                      accumulator into A fragments in
//                                      registers; B by ldmatrix.trans;
//   dQ  += dS K_p                      dS^T written once to shared memory as
//                                      16-bit, A and B by ldmatrix.trans;
//                                      warp w: q rows 16 (w % 4), half of D;
//                                      added in fp32 to a device-memory
//                                      accumulator by the one thread that
//                                      owns each element.
// dK and dV of the block's kv rows stay in registers over every q row the
// block walks (a warp owns 16 kv rows and D / WD columns; at D 256 two warps
// share the kv rows, each recomputing S^T / dP^T, and split D; past D 256
// four do, and dQ goes to D / 4 columns a warp).
//
// Past D 256 (384, 512) a 64-row kv tile with 64-row q tiles would need
// 311,296 / 409,600 B of shared memory, above the 227 KB of a block, and a
// warp's dK and dV over half of D 192-256 registers. So 32 kv rows, 32-row
// q tiles and dS^T kept (153,600 / 202,752 B, one block an SM), 8 warps as 2
// along the kv rows x 4 along D: a warp holds dK and dV of 16 kv rows x D /
// 4 columns (96-128 registers, as at D 256), and the 4 warps of a kv row
// group each recompute its S^T and dP^T (4x their tensor work: a q step does
// 2 x 4 + 3 = 11 products' worth of mma where one pass would do 5).
#pragma once

#include "bwd_fused.cuh"
#include "mma_tiles.cuh"

namespace fa2 {

// The fused kernels' and the dense dk/dv kernel's tiles: q rows of a
// streamed tile and kv rows of a block, what ops/flash_bwd.py counts the
// partitions in (fused_q_tile, fused_kv_tile).
template <int D>
struct FusedKv {
  static constexpr int BQ = D <= 256 ? 64 : 32;
  static constexpr int BKV = D <= 128 ? 128 : D <= 256 ? 64 : 32;
};

// BKV_, NW_, DS_ and BQ_ default to the fused kernels' layout; varlen.cu's
// dk/dv kernel takes 64 kv rows (4 warps at D <= 128) and keeps no dS^T
// (DS_ false: no shared memory for it), and so does the dense dk/dv kernel
// past D 256 (DkdvMmaCfg).
template <int D_, int BKV_ = FusedKv<D_>::BKV, int NW_ = THREADS / 32, bool DS_ = true,
          int BQ_ = FusedKv<D_>::BQ>
struct MmaCfg {
  static constexpr int D = D_;
  static constexpr int BKV = BKV_;                 // kv rows of a block's tile
  static constexpr int BQ = BQ_;                   // q rows of a streamed tile
  static constexpr int NW = NW_;                   // warps of a block
  static constexpr int KW = BKV / 16;              // warps along the kv rows
  static constexpr int WD = NW / KW;               // warps along D for dK / dV
  static constexpr int DKV = D / WD;               // dK / dV columns of a warp
  static constexpr int NT_KV = DKV / 8;
  static constexpr int QH = D <= 64 ? 32 : 16;     // q columns of S^T / dP^T per pass
  static constexpr int NT_S = QH / 8;              // n-tiles of S^T / dP^T in a pass
  static constexpr int QW = BQ / 16;               // warps along the q rows of dQ
  static constexpr int DQ = D / (NW / QW);         // dQ columns of a warp
  static constexpr int QP = DQ < 32 ? DQ : 32;     // dQ columns per pass
  static constexpr int NT_Q = QP / 8;
  static constexpr int P = D + 8;                  // shared row pitch, elements
  static constexpr int SP = BQ + 8;                // dS^T row pitch
  static constexpr int DS_ROWS = DS_ ? BKV : 0;    // dS^T rows in shared memory
  static constexpr int SMEM_BYTES = (2 * BKV * P + 4 * BQ * P + DS_ROWS * SP) * 2 + 4 * BQ * 4;
  static_assert(KW * WD == NW && NT_KV % 2 == 0 && NT_Q % 2 == 0 && QH % 16 == 0 &&
                DQ % QP == 0, "warp layout");
};

// The dense dk/dv kernel's layout (flash_bwd.cu dkdv_mma_kernel): the fused
// kernels', without dS^T past D 256 (150,528 and 199,680 B; dk/dv there
// does 2.5x the products of one S^T, dP^T per row).
template <int D>
using DkdvMmaCfg = MmaCfg<D, FusedKv<D>::BKV, THREADS / 32, D <= 256>;

// Buffer b of the double-buffered tiles starts b tiles past its base (plain
// pointers, not arrays: an array indexed by the run-time buffer would live in
// local memory).
template <typename T>
struct MmaSmem {
  T* K;          // [BKV][P] k * scale * log2e
  T* V;          // [BKV][P]
  T* Q;          // [2][BQ][P]
  T* dO;         // [2][BQ][P]
  T* dS;         // [BKV][SP] dS^T of the current q tile
  float* lse;    // [2][BQ]
  float* delta;  // [2][BQ]
};

template <class C, typename T>
__device__ __forceinline__ MmaSmem<T> mma_smem(unsigned char* raw) {
  MmaSmem<T> s;
  T* t = reinterpret_cast<T*>(raw);
  s.K = t; t += C::BKV * C::P;
  s.V = t; t += C::BKV * C::P;
  s.Q = t; t += 2 * C::BQ * C::P;
  s.dO = t; t += 2 * C::BQ * C::P;
  s.dS = t; t += C::DS_ROWS * C::SP;
  s.lse = reinterpret_cast<float*>(t);
  s.delta = s.lse + 2 * C::BQ;
  return s;
}

// ---- tiles ------------------------------------------------------------------

// The kv tile at k0: K (folded by k_mul and rounded to T when k_mul != 0)
// and V, rows at or past `valid` zero. Issues cp.async copies (not
// committed); the fold is stored directly.
template <class C, typename T>
__device__ __forceinline__ void mma_load_kv(const FusedBwdParams& p, const MmaSmem<T>& s,
                                            const T* kp, const T* vp, int k0, int valid) {
  cp_rows<C>(s.V, vp, p.v_ss, k0, C::BKV, valid);
  if (p.k_mul == 0.f) {
    cp_rows<C>(s.K, kp, p.k_ss, k0, C::BKV, valid);
    return;
  }
  constexpr int CH = C::D / 8;
  for (int i = threadIdx.x; i < C::BKV * CH; i += THREADS) {
    const int r = i / CH, c = (i % CH) * 8;
    uint4 out = make_uint4(0u, 0u, 0u, 0u);
    if (k0 + r < valid) {
      float x[8];
      load_vec<T, 8>(kp + (long long)(k0 + r) * p.k_ss + c, x);
      uint32_t* o = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
      for (int j = 0; j < 4; ++j) o[j] = pack2<T>(x[2 * j] * p.k_mul, x[2 * j + 1] * p.k_mul);
    }
    *reinterpret_cast<uint4*>(s.K + r * C::P + c) = out;
  }
}

// q tile rows [r0, r0 + BQ) into buffer `buf`: q, do (row strides q_ss,
// do_ss), lse and delta (q, dout, lse, delta: the head's first row), zero
// at or past `valid`.
template <class C, typename T>
__device__ __forceinline__ void mma_load_q_rows(const MmaSmem<T>& s, int buf, const T* q,
                                                long long q_ss, const T* dout, long long do_ss,
                                                const float* lse, const float* delta, int r0,
                                                int valid) {
  cp_rows<C>(s.Q + buf * C::BQ * C::P, q, q_ss, r0, C::BQ, valid);
  cp_rows<C>(s.dO + buf * C::BQ * C::P, dout, do_ss, r0, C::BQ, valid);
  for (int i = threadIdx.x; i < 2 * C::BQ; i += C::NW * 32) {
    const int r = i % C::BQ;
    const bool ok = r0 + r < valid;
    const float* src = (i < C::BQ ? lse : delta) + (ok ? r0 + r : 0);
    cp_async4((i < C::BQ ? s.lse : s.delta) + buf * C::BQ + r, src, ok);
  }
}

// The same for batch row b and head h of a [B, H, S, D] call.
template <class C, typename T, class Params>
__device__ __forceinline__ void mma_load_q(const Params& p, const MmaSmem<T>& s, int buf,
                                           int b, int h, int r0, int valid, const float* lse_h,
                                           const float* delta_h) {
  mma_load_q_rows<C, T>(s, buf, static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh, p.q_ss,
                        static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh, p.do_ss,
                        lse_h, delta_h, r0, valid);
}

// The dk/dv kernels' q loop over n tiles, double-buffered: issue(i) copies
// q tile i into buffer i & 1 (not committed; the first call joins whatever
// the caller issued before the loop), step(i) consumes buffer i & 1.
template <class Issue, class Step>
__device__ __forceinline__ void mma_q_loop(int n, const Issue& issue, const Step& step) {
  issue(0);
  cp_async_commit();
#pragma unroll 1
  for (int i = 0; i < n; ++i) {
    if (i + 1 < n) {
      issue(i + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    step(i);
    __syncthreads();  // buffer i & 1 fully consumed before tile i + 2 lands in it
  }
}

// The fused kernels' element rule for mma_q_step: the scores come in log2
// units (k prescaled); elements at kv column >= c_lim or outside keep_at's
// mask get p = ds = 0, a `free_tile` keeps every element.
template <bool DROP>
__device__ __forceinline__ auto fused_elem(const FusedBwdParams& p, int b, int h, int r0, int k0,
                                           int c_lim, bool free_tile, int q_len, int kv_len) {
  return [=, &p](int kr, int qr, float lse, float delta, float& sc, float& dp) {
    const int r = r0 + qr, c = k0 + kr;
    const bool keep = free_tile || (c < c_lim && keep_at(r, c, p.Sq, p.Sk, p.q_off, p.kv_off,
                                                         q_len, kv_len, p.causal, p.wl, p.wr));
    float pr, ds;
    grad_plain(sc, dp, lse, delta, keep, fused_drop<DROP>(p, b, h, r, c), pr, ds);
    sc = pr;
    dp = ds;
  };
}

// One q tile (in buffer `buf`) against the staged kv tile: dk += ds^T q and
// dv += p^T do in registers, and with DQ ds^T (rounded to T) into s.dS for
// mma_dq_step. elem(kv row, q row, lse, delta, s, dp) of the tile turns each
// accumulator element's score s and dp into dv's operand p and ds in place.
// The q columns go in passes of QH, each ending in its dV / dK products, so
// that only one pass's S^T and dP^T occupy registers beside dK and dV.
template <class C, typename T, bool DQ, class Elem>
__device__ __forceinline__ void mma_q_step(const MmaSmem<T>& s, int buf, const Elem& elem,
                                           float (&dk)[C::NT_KV][4], float (&dv)[C::NT_KV][4]) {
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const int wr = (w % C::KW) * 16, wd = w / C::KW;
  const int g = lane / 4, t = lane % 4;
  const T* Qs = s.Q + buf * C::BQ * C::P;
  const T* dOs = s.dO + buf * C::BQ * C::P;
  const float* lse_s = s.lse + buf * C::BQ;
  const float* delta_s = s.delta + buf * C::BQ;
#pragma unroll 1
  for (int qh = 0; qh < C::BQ; qh += C::QH) {
    float sc[C::NT_S][4], dp[C::NT_S][4];
#pragma unroll
    for (int n = 0; n < C::NT_S; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < C::D / 16; ++kk) {
      uint32_t ak[4], av[4];
      const int a_off = (wr + lane % 16) * C::P + kk * 16 + (lane / 16) * 8;
      ldsm_x4(ak, s.K + a_off);
      ldsm_x4(av, s.V + a_off);
#pragma unroll
      for (int np = 0; np < C::NT_S / 2; ++np) {
        const int off = (qh + np * 16 + lane % 8 + (lane / 16) * 8) * C::P + kk * 16 +
                        ((lane / 8) % 2) * 8;
        uint32_t bq[4], bo[4];
        ldsm_x4(bq, Qs + off);
        ldsm_x4(bo, dOs + off);
        mma16816<T>(sc[2 * np], ak, bq[0], bq[1]);
        mma16816<T>(sc[2 * np + 1], ak, bq[2], bq[3]);
        mma16816<T>(dp[2 * np], av, bo[0], bo[1]);
        mma16816<T>(dp[2 * np + 1], av, bo[2], bo[3]);
      }
    }
#pragma unroll
    for (int n = 0; n < C::NT_S; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kr = wr + g + (e / 2) * 8, qr = qh + n * 8 + 2 * t + (e % 2);
        elem(kr, qr, lse_s[qr], delta_s[qr], sc[n][e], dp[n][e]);
      }
    if (DQ && wd == 0) {
#pragma unroll
      for (int n = 0; n < C::NT_S; ++n) {
        T* row = s.dS + (wr + g) * C::SP + qh + n * 8 + 2 * t;
        *reinterpret_cast<uint32_t*>(row) = pack2<T>(dp[n][0], dp[n][1]);
        *reinterpret_cast<uint32_t*>(row + 8 * C::SP) = pack2<T>(dp[n][2], dp[n][3]);
      }
    }
#pragma unroll
    for (int kk = 0; kk < C::QH / 16; ++kk) {
      const uint32_t ap[4] = {pack2<T>(sc[2 * kk][0], sc[2 * kk][1]),
                              pack2<T>(sc[2 * kk][2], sc[2 * kk][3]),
                              pack2<T>(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                              pack2<T>(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
      const uint32_t as[4] = {pack2<T>(dp[2 * kk][0], dp[2 * kk][1]),
                              pack2<T>(dp[2 * kk][2], dp[2 * kk][3]),
                              pack2<T>(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
                              pack2<T>(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < C::NT_KV / 2; ++np) {
        const int off = (qh + kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * C::P + wd * C::DKV +
                        np * 16 + (lane / 16) * 8;
        uint32_t bo[4], bq[4];
        ldsm_x4_t(bo, dOs + off);
        ldsm_x4_t(bq, Qs + off);
        mma16816<T>(dv[2 * np], ap, bo[0], bo[1]);
        mma16816<T>(dv[2 * np + 1], ap, bo[2], bo[3]);
        mma16816<T>(dk[2 * np], as, bq[0], bq[1]);
        mma16816<T>(dk[2 * np + 1], as, bq[2], bq[3]);
      }
    }
  }
}

// dq rows [r0, r0 + BQ) (< Sq) of one head (`dqh`: its row 0, pitch D) +=
// dS K_p from s.dS and s.K, in passes of QP columns; `first` stores instead
// of adding.
template <class C, typename T>
__device__ __forceinline__ void mma_dq_step(const MmaSmem<T>& s, float* dqh, int r0, int Sq,
                                            bool first) {
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const int mt = w % C::QW, g = lane / 4, t = lane % 4;
#pragma unroll 1
  for (int nd = (w / C::QW) * C::DQ; nd < (w / C::QW + 1) * C::DQ; nd += C::QP) {
    float acc[C::NT_Q][4];
#pragma unroll
    for (int n = 0; n < C::NT_Q; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < C::BKV / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4_t(a, s.dS + (kk * 16 + lane % 8 + (lane / 16) * 8) * C::SP + mt * 16 +
                       ((lane / 8) % 2) * 8);
#pragma unroll
      for (int np = 0; np < C::NT_Q / 2; ++np) {
        uint32_t bk[4];
        ldsm_x4_t(bk, s.K + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * C::P + nd + np * 16 +
                          (lane / 16) * 8);
        mma16816<T>(acc[2 * np], a, bk[0], bk[1]);
        mma16816<T>(acc[2 * np + 1], a, bk[2], bk[3]);
      }
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + mt * 16 + g + 8 * half;
      if (r >= Sq) continue;
      float* row = dqh + (long long)r * C::D + nd + 2 * t;
#pragma unroll
      for (int n = 0; n < C::NT_Q; ++n) {
        float2* ptr = reinterpret_cast<float2*>(row + n * 8);
        float2 v = make_float2(acc[n][2 * half], acc[n][2 * half + 1]);
        if (!first) {
          const float2 o = *ptr;
          v.x += o.x;
          v.y += o.y;
        }
        *ptr = v;
      }
    }
  }
}

// A warp's dK or dV accumulator rows (local kv rows < `rows`) times `mul`:
// rounded to T into `out` (row pitch ss), or as fp32 into `part` (pitch D).
template <class C, typename T>
__device__ __forceinline__ void mma_store_kv(const float (&acc)[C::NT_KV][4], T* out, long long ss,
                                             int rows, float mul) {
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const int wr = (w % C::KW) * 16, wd = w / C::KW, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = wr + g + 8 * half;
    if (r >= rows) continue;
#pragma unroll
    for (int n = 0; n < C::NT_KV; ++n) {
      *reinterpret_cast<uint32_t*>(out + r * ss + wd * C::DKV + n * 8 + 2 * t) =
          pack2<T>(acc[n][2 * half] * mul, acc[n][2 * half + 1] * mul);
    }
  }
}

template <class C>
__device__ __forceinline__ void mma_store_kv_f32(const float (&acc)[C::NT_KV][4], float* part,
                                                 int rows) {
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const int wr = (w % C::KW) * 16, wd = w / C::KW, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = wr + g + 8 * half;
    if (r >= rows) continue;
#pragma unroll
    for (int n = 0; n < C::NT_KV; ++n) {
      *reinterpret_cast<float2*>(part + (long long)r * C::D + wd * C::DKV + n * 8 + 2 * t) =
          make_float2(acc[n][2 * half], acc[n][2 * half + 1]);
    }
  }
}

template <class C>
__device__ __forceinline__ void mma_zero_kv(float (&dk)[C::NT_KV][4], float (&dv)[C::NT_KV][4]) {
#pragma unroll
  for (int n = 0; n < C::NT_KV; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
}

// ---- the dq kernels' tiles (flash_bwd.cu dq_mma_kernel, varlen.cu) ------
//
// One block of 4 warps owns a 64-row q tile for the whole kv loop, each
// warp 16 q rows (the forward's shape). Q and dO are staged once and read by
// ldmatrix per k-step (held in registers they would leave no room beside dQ,
// S and dP at D 128); K / V tiles of BKV rows arrive double-buffered by
// cp.async, zero past the valid keys. Past D 256 (384, 512) dQ alone would
// take 192-256 registers a thread, so 8 warps share the tile, two per 16
// rows, each holding half of dQ's columns and each computing the rows'
// whole S and dP (the forward's pairs: S and dP cost twice their tensor
// work); the K / V tiles shrink to 32 rows (16 at D 512) so that Q, dO and
// the two K / V buffers fit the 227 KB of a block (200,704 and 199,680 B).

template <int D_>
struct DqMmaCfg {
  static constexpr int D = D_;
  static constexpr int BQ = TM;                   // q rows of a block, 16 per row group
  static constexpr int RG = BQ / 16;              // row groups: warp w owns rows 16 (w % RG)
  static constexpr int WD = D <= 256 ? 1 : 2;     // warps of a row group, along dQ's columns
  static constexpr int NW = RG * WD;              // 4 warps (8 past D 256)
  static constexpr int BKV = D <= 128 ? 64 : D <= 384 ? 32 : 16;  // kv rows of a K / V tile
  static constexpr int P = D + 8;                 // shared row pitch, elements
  static constexpr int NT_S = BKV / 8;            // n-tiles of a warp's S and dP
  static constexpr int DQ = D / WD;               // dQ columns of a warp: DQ (w / RG) on
  static constexpr int NT_D = DQ / 8;             // n-tiles of a warp's dQ
  static constexpr int SMEM_BYTES = (2 * BQ + 4 * BKV) * P * 2;  // Q, dO; K and V double-buffered
  static_assert(NT_S % 2 == 0 && NT_D % 2 == 0, "n-tiles in pairs");
};

// The K / V loop over n tiles in kv_s (buffer j: K at 2 j BKV rows, V BKV
// rows on): load(i, K, V) issues tile i's copies (not committed), step(i,
// Ks, Vs) consumes them. The caller has issued and committed tile 0, with
// Q and dO.
template <class C, typename T, class Load, class Step>
__device__ __forceinline__ void dq_kv_loop(T* kv_s, int n, const Load& load, const Step& step) {
#pragma unroll 1
  for (int i = 0; i < n; ++i) {
    cp_async_wait<0>();
    __syncthreads();  // tile i has landed; every warp is done with tile i - 1
    if (i + 1 < n) {
      T* nxt = kv_s + ((i + 1) & 1) * 2 * C::BKV * C::P;
      load(i + 1, nxt, nxt + C::BKV * C::P);
      cp_async_commit();
    }
    const T* Ks = kv_s + (i & 1) * 2 * C::BKV * C::P;
    step(i, Ks, Ks + C::BKV * C::P);
  }
}

// S = Q K^T and dP = dO V^T of one warp's 16 rows (Qw, dOw: its first
// row of the staged Q and dO) against NT * 8 keys (Kw, Vw: its first key of
// the staged K and V), pitch C::P: accumulator element e of n-tile n is row
// g + 8 (e / 2), key n * 8 + 2 t + e % 2. Shared by the dq kernels and
// flash_bwd.cu's dbias_mma_kernel.
template <class C, typename T, int NT>
__device__ __forceinline__ void sdp_mma_tile(const T* Qw, const T* dOw, const T* Kw, const T* Vw,
                                             float (&sc)[NT][4], float (&dp)[NT][4]) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[n][e] = dp[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < C::D / 16; ++kk) {
    uint32_t aq[4], ao[4];
    const int a_off = (lane % 16) * C::P + kk * 16 + (lane / 16) * 8;
    ldsm_x4(aq, Qw + a_off);
    ldsm_x4(ao, dOw + a_off);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      const int off = (np * 16 + lane % 8 + (lane / 16) * 8) * C::P + kk * 16 +
                      ((lane / 8) % 2) * 8;
      uint32_t bk[4], bv[4];
      ldsm_x4(bk, Kw + off);
      ldsm_x4(bv, Vw + off);
      mma16816<T>(sc[2 * np], aq, bk[0], bk[1]);
      mma16816<T>(sc[2 * np + 1], aq, bk[2], bk[3]);
      mma16816<T>(dp[2 * np], ao, bv[0], bv[1]);
      mma16816<T>(dp[2 * np + 1], ao, bv[2], bv[3]);
    }
  }
}

// One K / V tile against the staged Q and dO: S and dP (sdp_mma_tile);
// elem(row, key, half, s, dp) turns each accumulator element (tile row
// w * 16 + g + 8 half, key 2 t + e % 2 of n-tile n) into ds in place of dp;
// dQ += dS K, dS rounded to T and repacked from the accumulators into A
// fragments, K by ldmatrix.trans.
template <class C, typename T, class Elem>
__device__ __forceinline__ void dq_mma_tile(const T* Qs, const T* dOs, const T* Ks, const T* Vs,
                                            const Elem& elem, float (&dq)[C::NT_D][4]) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int w = threadIdx.x / 32 % C::RG, od = threadIdx.x / 32 / C::RG * C::DQ;
  float sc[C::NT_S][4], dp[C::NT_S][4];
  sdp_mma_tile<C, T>(Qs + w * 16 * C::P, dOs + w * 16 * C::P, Ks, Vs, sc, dp);
#pragma unroll
  for (int n = 0; n < C::NT_S; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      elem(w * 16 + g + (e / 2) * 8, n * 8 + 2 * t + (e % 2), e / 2, sc[n][e], dp[n][e]);
    }
#pragma unroll
  for (int kk = 0; kk < C::BKV / 16; ++kk) {
    const uint32_t a[4] = {pack2<T>(dp[2 * kk][0], dp[2 * kk][1]),
                           pack2<T>(dp[2 * kk][2], dp[2 * kk][3]),
                           pack2<T>(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
                           pack2<T>(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
#pragma unroll
    for (int np = 0; np < C::NT_D / 2; ++np) {
      uint32_t bk[4];
      ldsm_x4_t(bk, Ks + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * C::P + od + np * 16 +
                        (lane / 16) * 8);
      mma16816<T>(dq[2 * np], a, bk[0], bk[1]);
      mma16816<T>(dq[2 * np + 1], a, bk[2], bk[3]);
    }
  }
}

// dq = mul * acc in T for the tile's first `rows` rows of `out` (row 0 of
// the tile, row stride ss): a warp's rows go through its own 16 rows of
// `stage` (shared, pitch P; no other warp reads them; past D 256 each warp
// of a row pair moves its own columns, after a barrier, since both read all
// of the staged Q), then out as 16-byte stores.
template <class C, typename T>
__device__ __forceinline__ void dq_mma_store(const float (&dq)[C::NT_D][4], T* stage, T* out,
                                             long long ss, int rows, float mul) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int w = threadIdx.x / 32 % C::RG, od = threadIdx.x / 32 / C::RG * C::DQ;
  if constexpr (C::WD > 1) {
    __syncthreads();  // the row pair is done reading Q
  } else {
    __syncwarp();
  }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = w * 16 + g + 8 * hr;
#pragma unroll
    for (int n = 0; n < C::NT_D; ++n) {
      *reinterpret_cast<uint32_t*>(stage + r * C::P + od + n * 8 + 2 * t) =
          pack2<T>(dq[n][2 * hr] * mul, dq[n][2 * hr + 1] * mul);
    }
  }
  __syncwarp();
  constexpr int CH = C::DQ / 8;  // 16-byte chunks of a warp's part of a row
  for (int i = lane; i < 16 * CH; i += 32) {
    const int r = w * 16 + i / CH, c = od + (i % CH) * 8;
    if (r < rows) {
      *reinterpret_cast<uint4*>(out + (long long)r * ss + c) =
          *reinterpret_cast<const uint4*>(stage + r * C::P + c);
    }
  }
}

// Grid of a grid-stride kernel over n work items, THREADS per block.
inline int stride_blocks(long long n, int per_block = THREADS) {
  const long long want = (n + per_block - 1) / per_block, cap = 132 * 16;
  return (int)(want < 1 ? 1 : (want < cap ? want : cap));
}

}  // namespace fa2
