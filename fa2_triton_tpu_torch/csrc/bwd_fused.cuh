// The fused 5-product backward shared by flash_bwd_tri.cu (B13 tri-square
// and its diag leaves) and flash_bwd_wl.cu (B14 work list): their
// parameters, numerics and, for fp32 inputs, the steps on attn_tiles.cuh's
// FMA tile math (16-bit inputs take bwd_mma.cuh's tensor-core tiles).
//
// The TPU kernels (fa2_triton_tpu/ops/flash_bwd.py:_bwd_tri_square_kernel
// l.845, _bwd_fused_wl_kernel l.1849) recompute each (q tile, kv tile) pair
// once and feed all three gradients from it: s, dp, then dv += p^T do,
// dk += ds^T q and dq += ds k (5 products where the dq and dk/dv pair of
// flash_bwd.cu needs 7). On the GPU a block owns a set of 64-row kv tiles of
// one (batch row, kv head): dk / dv accumulate in registers over the q rows
// of the whole GQA group, as in flash_bwd.cu's dk/dv kernel, and each q
// tile's ds k is added into an fp32 dq accumulator in device memory that
// no other block writes. Every element of that accumulator (and of the work
// list's dk / dv strip accumulators) is read and written by one thread only,
// always in the same order: no atomics, and bitwise-repeatable results.
//
// Numerics are the TPU kernels': k is multiplied by scale * log2e and
// rounded to the input dtype (in the kernel, or by the host for the split
// and the multi-strip work list), so s = q k_p^T is in log2 units and
// p = exp2(s - lse); a dead row (lse = -inf) gets p = 0, as JAX's lse
// sanitised to +1e30 does; delta = rowsum(o * do) - dlse * log2e (in the
// kernel from o, or given); dq = acc / log2e, dk = acc * scale, dv = acc,
// each rounded once to the output dtype. Dropout regenerates the forward's
// mask from the dense counter of common.cuh (q head hk * group + g, global
// rows and columns, the real lengths): ds = p (keep ? dp / (1 - p) : 0 -
// delta) and dv's operand keep ? p / (1 - p) : 0.
#pragma once

#include "attn_tiles.cuh"

namespace fa2 {

// The work list's step flags (fa2_triton_tpu/ops/flash_bwd.py:1776-1777).
constexpr int WL_INIT_DQ = 1, WL_WRITE_DQ = 2, WL_COMPUTE = 4, WL_MASK_GEN = 8;
constexpr int WL_INIT_KV = 16, WL_WRITE_KV = 32, WL_MASK_TRI = 64;

struct FusedBwdParams {
  const void* q;
  const void* k;        // k, or k * scale * log2e rounded to its dtype (k_mul == 0)
  const void* v;
  const void* dout;
  const void* o;        // non-null: delta = rowsum(o * do) - adj, computed in the kernel
  const float* lse;     // [B, Hq, Sq] fp32, base 2
  const float* delta;   // o == nullptr: delta [B, Hq, Sq]; else adj (nullptr = 0)
  float* delta_buf;     // [B, Hq, Sq]: the in-kernel delta
  float* dq_acc;        // fp32 dq accumulators [parts][B][Hq][Sq][D]
  float* dk_acc;        // work list: fp32 [B][Hkv][Sk][D] strip accumulators
  float* dv_acc;
  void* dq;
  void* dk;
  void* dv;
  const int* lens;      // [B, 2] (q_len, kv_len)
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  long long do_sb, do_sh, do_ss, o_sb, o_sh, o_ss;
  long long dq_sb, dq_sh, dq_ss, dk_sb, dk_sh, dk_ss, dv_sb, dv_sh, dv_ss;
  int B, Hq, Hkv, Sq, Sk;
  int q_off, kv_off, causal, wl, wr;
  float scale;          // softmax scale: dk = scale * sum ds^T q
  float k_mul;          // scale * log2e: fold k in the kernel; 0: k comes prescaled
  Dropout drop;
  int Sq_real, Sk_real; // the dropout counter's lengths
  int leaf;             // tri: the diag leaf length T (0 = one triangle over all)
  const int* table;     // work list: [nsteps][8] (g, iq, ws, flags, strip, 0, 0, 0)
  const int* starts;    // work list: first step of each strip, then nsteps
  int sub, strip_cols, dq_whole;
  // 16-bit kernels' block partition (ops/flash_bwd.py): tri: [leaves * nparts
  // + 1] tile starts per block, then the tiles' first kv rows; work list:
  // [nparts + 1] chunk step starts, [strips + 1] first chunk per strip, then
  // [strips][nq] flags of the q-row blocks each strip's steps cover.
  const int* part;
  int nparts;
  int tile_q, tile_kv;  // the q and kv tile rows the host partition assumes
};

// The 24 strides of an entry point, in elements: q, k, v, do, o, dq, dk, dv
// (batch, head, row each).
inline void fill_strides(FusedBwdParams& p, const long long* s) {
  p.q_sb = s[0]; p.q_sh = s[1]; p.q_ss = s[2];
  p.k_sb = s[3]; p.k_sh = s[4]; p.k_ss = s[5];
  p.v_sb = s[6]; p.v_sh = s[7]; p.v_ss = s[8];
  p.do_sb = s[9]; p.do_sh = s[10]; p.do_ss = s[11];
  p.o_sb = s[12]; p.o_sh = s[13]; p.o_ss = s[14];
  p.dq_sb = s[15]; p.dq_sh = s[16]; p.dq_ss = s[17];
  p.dk_sb = s[18]; p.dk_sh = s[19]; p.dk_ss = s[20];
  p.dv_sb = s[21]; p.dv_sh = s[22]; p.dv_ss = s[23];
}

template <bool DROP>
__device__ __forceinline__ float fused_drop(const FusedBwdParams& p, int b, int h, int r, int c) {
  if constexpr (DROP) {
    return dropout_keep(p.drop.seed, p.drop.threshold, b, h, p.q_off + r, p.kv_off + c, p.Hq,
                        p.Sq_real, p.Sk_real)
               ? p.drop.scale
               : 0.f;
  } else {
    return 1.f;
  }
}

// The fp32 dq accumulator rows of (b, h) in accumulator set `base`.
template <int D>
__device__ __forceinline__ float* dq_head(const FusedBwdParams& p, float* base, int b, int h) {
  return base + ((long long)b * p.Hq + h) * p.Sq * D;
}

// Stage a 64-row K tile: k * k_mul rounded to T (the TPU kernels' fold,
// l.911-912), or k as given when it comes prescaled.
template <typename T, int D>
__device__ __forceinline__ void stage_k(const FusedBwdParams& p, float* dst, const T* kp, int k0,
                                        int valid) {
  if (p.k_mul == 0.f) {
    stage<T, D>(dst, kp, p.k_ss, k0, TM, valid, 1.f);
    return;
  }
  constexpr int D4 = D / 4;
  for (int i = threadIdx.x; i < TM * D4; i += THREADS) {
    const int r = i / D4, d = (i % D4) * 4;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (k0 + r < valid) load_vec<T, 4>(kp + (long long)(k0 + r) * p.k_ss + d, x);
#pragma unroll
    for (int j = 0; j < 4; ++j) dst[r * (D + 1) + d + j] = to_f(from_f<T>(x[j] * p.k_mul));
  }
}

// In-kernel delta of rows [r0, r1) of (b, h): rowsum(o * do) - adj, one warp
// per row (a fixed shuffle order).
template <typename T, int D>
__device__ __forceinline__ void delta_rows(const FusedBwdParams& p, int b, int h, int r0, int r1) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const T* op = static_cast<const T*>(p.o) + b * p.o_sb + h * p.o_sh;
  const T* dop = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const long long row0 = ((long long)b * p.Hq + h) * p.Sq;
  for (int r = r0 + warp; r < r1; r += THREADS / 32) {
    float acc = 0.f;
    for (int d = lane; d < D; d += 32) {
      acc = fmaf(to_f(op[r * p.o_ss + d]), to_f(dop[r * p.do_ss + d]), acc);
    }
    acc = warp_sum(acc);
    if (lane == 0) p.delta_buf[row0 + r] = acc - (p.delta != nullptr ? p.delta[row0 + r] : 0.f);
  }
}

// The dq accumulator in the q-tile mapping: thread (tx, ty) owns rows ty and
// ty + 16 of a 32-row tile and columns tx + 16 j. Zero, add ds k, and write
// acc / log2e in T, for local rows r < rows.
template <int D>
__device__ __forceinline__ void dq_tile_zero(float* acc, int rows) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = ty + 16 * i;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc[r * D + tx + 16 * j] = 0.f;
  }
}

// acc[r][d] += sum_c dS^T[c][r] * K[c][d] over the 64 kv rows c: dSs is the
// dk/dv tile's [64][TN + 1] ds^T, Ks its [64][D + 1] prescaled k.
template <int D>
__device__ __forceinline__ void dq_tile_add(const float* dSs, const float* Ks, float* acc,
                                            int rows) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  constexpr int JC = 4;
#pragma unroll
  for (int j0 = 0; j0 < D / 16; j0 += JC) {
    float a[2][JC];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int jj = 0; jj < JC; ++jj) a[i][jj] = 0.f;
#pragma unroll 4
    for (int c = 0; c < TM; ++c) {
      const float s0 = dSs[c * (TN + 1) + ty], s1 = dSs[c * (TN + 1) + ty + 16];
#pragma unroll
      for (int jj = 0; jj < JC; ++jj) {
        const float kk = Ks[c * (D + 1) + tx + 16 * (j0 + jj)];
        a[0][jj] = fmaf(s0, kk, a[0][jj]);
        a[1][jj] = fmaf(s1, kk, a[1][jj]);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = ty + 16 * i;
      if (r >= rows) continue;
#pragma unroll
      for (int jj = 0; jj < JC; ++jj) acc[r * D + tx + 16 * (j0 + jj)] += a[i][jj];
    }
  }
}

template <typename T, int D>
__device__ __forceinline__ void dq_tile_write(const float* acc, T* out, long long ss, int rows) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = ty + 16 * i;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      out[r * ss + tx + 16 * j] = from_f<T>(acc[r * D + tx + 16 * j] * (1.f / LOG2E));
    }
  }
}

// Local q rows [r_lo, r_hi) that can see a live column of the kv tile at k0
// whose live columns end at c_lim (flash_bwd.cu's dk/dv rule: causal,
// window, lengths); r_hi = 0 when it has none.
__device__ __forceinline__ void kv_tile_rows(const FusedBwdParams& p, int k0, int c_lim, int shift,
                                             int q_valid, int& r_lo, int& r_hi) {
  const int col_lo = p.kv_off + k0;
  const int col_hi = p.kv_off + c_lim - 1;  // inclusive
  r_lo = 0;
  r_hi = q_valid;
  if (p.causal) {
    r_lo = max(0, col_lo - shift - p.q_off);
  } else if (p.wr >= 0) {
    r_lo = max(0, col_lo - shift - p.wr - p.q_off);
  }
  if (p.wl >= 0) r_hi = min(r_hi, col_hi - shift + p.wl - p.q_off + 1);
  if (col_hi < col_lo) r_hi = 0;
}

// The q rows [ra, rb) of head h (ra a multiple of TN) against the 64-row kv
// tile at k0, whose K (prescaled) and V are staged: dk_acc += ds^T q,
// dv_acc += p^T do, and dq += ds k into the head's fp32 accumulator `dqh`.
// A q tile for which is_free(r0) holds keeps every element (below the
// diagonal, inside the window and the lengths) and skips the mask test.
template <typename T, int D, bool DROP, typename FreeFn>
__device__ __forceinline__ void fused_rows(const FusedBwdParams& p, const DkdvSmem& s, int b,
                                           int h, int k0, int ra, int rb, int q_len, int kv_len,
                                           int q_valid, FreeFn is_free, float* dqh,
                                           float (&dk_acc)[4][D / 16],
                                           float (&dv_acc)[4][D / 16]) {
  const long long row0 = ((long long)b * p.Hq + h) * p.Sq;
  const T* qp = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* dop = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const float* delta = (p.o != nullptr ? p.delta_buf : p.delta) + row0;
  for (int r0 = ra; r0 < rb; r0 += TN) {
    if (is_free(r0)) {
      auto pds = [&](int kr, int qr, float s2, float dp, float& pr, float& ds) {
        grad_plain(s2, dp, s.lse_s[qr], s.delta_s[qr], true,
                   fused_drop<DROP>(p, b, h, r0 + qr, k0 + kr), pr, ds);
      };
      dkdv_q_step<T, D>(s, qp, p.q_ss, dop, p.do_ss, p.lse + row0, delta, r0, q_valid, pds,
                        dk_acc, dv_acc);
    } else {
      auto pds = [&](int kr, int qr, float s2, float dp, float& pr, float& ds) {
        const bool keep = keep_at(r0 + qr, k0 + kr, p.Sq, p.Sk, p.q_off, p.kv_off, q_len, kv_len,
                                  p.causal, p.wl, p.wr);
        grad_plain(s2, dp, s.lse_s[qr], s.delta_s[qr], keep,
                   fused_drop<DROP>(p, b, h, r0 + qr, k0 + kr), pr, ds);
      };
      dkdv_q_step<T, D>(s, qp, p.q_ss, dop, p.do_ss, p.lse + row0, delta, r0, q_valid, pds,
                        dk_acc, dv_acc);
    }
    dq_tile_add<D>(s.dSs, s.Ks, dqh + (long long)r0 * D, min(TN, p.Sq - r0));
  }
}

}  // namespace fa2
