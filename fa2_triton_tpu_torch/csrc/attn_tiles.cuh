// Tile math shared by the attention kernels (flash_fwd.cu, flash_bwd.cu,
// varlen.cu): the kernels differ in how they find their tiles (a dense
// [B, H, S, D] grid, or a host work list) and share what they do with them.
//
// A block of 256 threads (a 16 x 16 grid) owns an M-row output tile and
// streams N-row tiles of the other operand through shared memory, staged
// as fp32 with rows padded by one float against bank conflicts: M x N = 64
// x 32 up to D 256, 32 x 16 at D 384 / 512 (FmaTile), where 64 x 32 tiles
// would need 271-403 KB of shared memory, above the 227 KB of a Hopper
// block, and dk/dv's 2 x 4 x D / 16 accumulators a thread would not fit its
// registers.
// In each M x N product, thread (tx, ty) = (tid % 16, tid / 16) owns rows
// ty + 16 i (i < M / 16) and columns tx + 16 j (j < N / 16), and
// accumulator columns tx + 16 j (j < D / 16) of the output rows it owns.
// All math is fp32 FMAs on the CUDA cores, in a fixed order: results are
// bitwise repeatable.
#pragma once

#include "common.cuh"

namespace fa2 {

constexpr int THREADS = 256;  // a 16 x 16 grid of threads
constexpr int TM = 64;        // rows of the tile a block owns
constexpr int TN = 32;        // rows of a streamed tile

// The tiles of the FMA kernels at head dim D: TM x TN up to D 256, 32 x 16
// past it. The host still counts q tiles in TM rows (a multiple of M).
template <int D>
struct FmaTile {
  static constexpr int M = D <= 256 ? TM : 32;  // rows of the owned tile
  static constexpr int N = D <= 256 ? TN : 16;  // rows of a streamed tile
  static constexpr int RI = M / 16;             // owned rows of a thread
  static constexpr int RJ = N / 16;             // streamed rows (score columns) of a thread
  static constexpr int TPR = THREADS / M;       // threads of one softmax row (forward)
  static constexpr int CPT = N / TPR;           // its columns a thread
  static_assert(TM % M == 0 && TPR <= 32 && CPT >= 1, "FMA tile layout");
};

// An accumulator tile a thread holds: RI rows x D / 16 columns.
template <int D>
using FmaAcc = float[FmaTile<D>::RI][D / 16];

// Stage `rows` rows of a [*, D] operand (row stride `ss`, first row `row0`)
// into shared memory with row pitch P, times `mul`. Rows at or past `valid`
// are zero: padding may hold NaN, and 0 * NaN would leak into the sums.
template <typename T, int D, int P = D + 1>
__device__ __forceinline__ void stage(float* dst, const T* src, long long ss, int row0, int rows,
                                      int valid, float mul) {
  constexpr int D4 = D / 4;
  for (int i = threadIdx.x; i < rows * D4; i += THREADS) {
    const int r = i / D4, d = (i % D4) * 4;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (row0 + r < valid) load_vec<T, 4>(src + (long long)(row0 + r) * ss + d, x);
#pragma unroll
    for (int j = 0; j < 4; ++j) dst[r * P + d + j] = x[j] * mul;
  }
}

// Per-row lse and delta of `rows` rows starting at `row0` (-inf / 0 at or
// past `valid`).
__device__ __forceinline__ void stage_rows(float* lse_s, float* delta_s, const float* lse,
                                           const float* delta, int row0, int rows, int valid) {
  for (int r = threadIdx.x; r < rows; r += THREADS) {
    const bool ok = row0 + r < valid;
    lse_s[r] = ok ? lse[row0 + r] : neg_inf();
    delta_s[r] = ok ? delta[row0 + r] : 0.f;
  }
}

template <int D>
__device__ __forceinline__ void zero_acc(FmaAcc<D>& acc) {
#pragma unroll
  for (int i = 0; i < FmaTile<D>::RI; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc[i][j] = 0.f;
}

// A thread's score tile: RI rows x RJ columns.
template <int D>
using FmaScores = float[FmaTile<D>::RI][FmaTile<D>::RJ];

// s[i][j] = A[ty + 16 i] . B[tx + 16 j] over D (A M rows, B N rows, both
// pitch D + 1).
template <int D>
__device__ __forceinline__ void dot_tile(const float* A, const float* B, FmaScores<D>& s) {
  constexpr int RI = FmaTile<D>::RI, RJ = FmaTile<D>::RJ;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < RJ; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float a[RI], c[RJ];
#pragma unroll
    for (int i = 0; i < RI; ++i) a[i] = A[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
    for (int j = 0; j < RJ; ++j) c[j] = B[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < RJ; ++j) s[i][j] = fmaf(a[i], c[j], s[i][j]);
  }
}

// Two such products in one pass over D: s = A . B and s2 = A2 . B2 (the
// backward's scores and dp).
template <int D>
__device__ __forceinline__ void dot_tile2(const float* A, const float* B, const float* A2,
                                          const float* B2, FmaScores<D>& s, FmaScores<D>& s2) {
  constexpr int RI = FmaTile<D>::RI, RJ = FmaTile<D>::RJ;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < RJ; ++j) s[i][j] = s2[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float a[RI], a2[RI], c[RJ], c2[RJ];
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      a[i] = A[(ty + 16 * i) * (D + 1) + d];
      a2[i] = A2[(ty + 16 * i) * (D + 1) + d];
    }
#pragma unroll
    for (int j = 0; j < RJ; ++j) {
      c[j] = B[(tx + 16 * j) * (D + 1) + d];
      c2[j] = B2[(tx + 16 * j) * (D + 1) + d];
    }
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < RJ; ++j) {
        s[i][j] = fmaf(a[i], c[j], s[i][j]);
        s2[i][j] = fmaf(a2[i], c2[j], s2[i][j]);
      }
  }
}

// acc[i][j] += sum_c S[ty + 16 i][c] * B[c][tx + 16 j]: S is M x N with
// pitch N + 1, B N rows with pitch P.
template <int D, int P>
__device__ __forceinline__ void acc_tile(const float* S, const float* B, FmaAcc<D>& acc) {
  constexpr int RI = FmaTile<D>::RI, N = FmaTile<D>::N;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll 4
  for (int c = 0; c < N; ++c) {
    float sv[RI];
#pragma unroll
    for (int i = 0; i < RI; ++i) sv[i] = S[(ty + 16 * i) * (N + 1) + c];
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      const float b = B[c * P + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RI; ++i) acc[i][j] = fmaf(sv[i], b, acc[i][j]);
    }
  }
}

// Two such sums in one pass: acc += S . B and acc2 += S2 . B2 (dk and dv).
template <int D>
__device__ __forceinline__ void acc_tile2(const float* S, const float* B, const float* S2,
                                          const float* B2, FmaAcc<D>& acc, FmaAcc<D>& acc2) {
  constexpr int RI = FmaTile<D>::RI, N = FmaTile<D>::N;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll 4
  for (int c = 0; c < N; ++c) {
    float sv[RI], sv2[RI];
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      sv[i] = S[(ty + 16 * i) * (N + 1) + c];
      sv2[i] = S2[(ty + 16 * i) * (N + 1) + c];
    }
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      const float b = B[c * (D + 1) + tx + 16 * j];
      const float b2 = B2[c * (D + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        acc[i][j] = fmaf(sv[i], b, acc[i][j]);
        acc2[i][j] = fmaf(sv2[i], b2, acc2[i][j]);
      }
    }
  }
}

// p and ds of one backward element without softcap or bias: s2 is the
// score in log2 units, lse the row's base-2 lse. Masked elements, and rows
// with lse = -inf (no valid column), get exactly 0. `drop` is the element's
// dropout factor (1 without dropout, 1 / (1 - p) kept, 0 dropped): dp and
// the returned p (dv's operand) are scaled by it, and ds = p (dp - delta)
// keeps the undropped p.
__device__ __forceinline__ void grad_plain(float s2, float dp, float lse, float delta, bool keep,
                                           float drop, float& pr, float& ds) {
  keep = keep && isfinite(lse);
  const float pu = keep ? exp2f(s2 - lse) : 0.f;
  ds = keep ? pu * (dp * drop - delta) : 0.f;
  pr = pu * drop;
}

// ----------------------------------------------------------------------------
// Forward: an M-row q tile (q * scale * log2e staged once) against N-row
// K/V tiles, with a base-2 online softmax. Masked scores are -inf under a
// finite MASK_LOG2 floor of the running max, so a row with no kept column
// ends with l = 0: o = 0 and lse = -inf, never an average of v.

template <int D>
constexpr int fwd_smem_floats() {
  constexpr int M = FmaTile<D>::M, N = FmaTile<D>::N;
  return M * (D + 1) + N * (D + 1) + N * D + M * (N + 1) + 2 * M;
}

struct FwdSmem {
  float* Qs;       // [M][D+1]  q * scale * log2e
  float* Ks;       // [N][D+1]
  float* Vs;       // [N][D]
  float* Ss;       // [M][N+1] scores, then probabilities
  float* alpha_s;  // [M] per-row rescale of this tile
  float* l_s;      // [M] final row sums
};

template <int D>
__device__ __forceinline__ FwdSmem fwd_smem(float* smem) {
  constexpr int M = FmaTile<D>::M, N = FmaTile<D>::N;
  FwdSmem s;
  s.Qs = smem;
  s.Ks = s.Qs + M * (D + 1);
  s.Vs = s.Ks + N * (D + 1);
  s.Ss = s.Vs + N * D;
  s.alpha_s = s.Ss + M * (N + 1);
  s.l_s = s.alpha_s + M;
  return s;
}

// The rest of a KV tile once its raw scores sc (log2 units) are formed:
// score(r, c, x) of each element into s.Ss, the rows' online softmax, and
// acc += P V with V staged in s.Vs (pitch D). Shared by fwd_kv_step and
// flash_fwd_any.cu's FMA forward, which forms sc over slices of D.
template <int D, typename ScoreFn, typename DropFn>
__device__ __forceinline__ void fwd_fold(const FwdSmem& s, const FmaScores<D>& sc, ScoreFn score,
                                         DropFn drop, float& m_run, float& l_run,
                                         FmaAcc<D>& acc) {
  using F = FmaTile<D>;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
#pragma unroll
  for (int i = 0; i < F::RI; ++i)
#pragma unroll
    for (int j = 0; j < F::RJ; ++j) {
      const int r = ty + 16 * i, c = tx + 16 * j;
      s.Ss[r * (F::N + 1) + c] = score(r, c, sc[i][j]);
    }
  __syncthreads();

  {
    const int srow = tid / F::TPR, scol = (tid % F::TPR) * F::CPT;
    float* row = s.Ss + srow * (F::N + 1) + scol;
    float mx = MASK_LOG2;
#pragma unroll
    for (int c = 0; c < F::CPT; ++c) mx = fmaxf(mx, row[c]);
#pragma unroll
    for (int o = 1; o < F::TPR; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float m_new = fmaxf(m_run, mx);
    const float alpha = exp2f(m_run - m_new);
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < F::CPT; ++c) {
      const float pr = exp2f(row[c] - m_new);  // masked: exp2(-inf) = 0
      sum += pr;
      row[c] = drop(srow, scol + c, pr);
    }
#pragma unroll
    for (int o = 1; o < F::TPR; o <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    l_run = l_run * alpha + sum;
    m_run = m_new;
    if ((tid % F::TPR) == 0) s.alpha_s[srow] = alpha;
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < F::RI; ++i) {
    const float al = s.alpha_s[ty + 16 * i];
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc[i][j] *= al;
  }
  acc_tile<D, D>(s.Ss, s.Vs, acc);
}

// One KV tile: stage K/V rows [k0, k0 + N) of kp / vp (zero at or past
// kv_valid), score them against the staged q tile, pass each raw score x
// (log2 units) of local row r, column c through score(r, c, x) (which
// returns -inf to drop it), and fold the tile into (m_run, l_run, acc).
// TPR neighbouring lanes own one softmax row, CPT columns each (4 x 8 at
// 64 x 32 tiles): m_run and l_run are the running max and sum of row
// tid / TPR. Dropout: l sums the
// undropped p, and only the P V product sees drop(r, c, p) (p, or 0 where
// the element is dropped); fwd_store applies 1 / (1 - p_drop).
template <typename T, int D, typename ScoreFn, typename DropFn>
__device__ __forceinline__ void fwd_kv_step(const FwdSmem& s, const T* kp, long long k_ss,
                                            const T* vp, long long v_ss, int k0, int kv_valid,
                                            ScoreFn score, DropFn drop, float& m_run,
                                            float& l_run, FmaAcc<D>& acc) {
  using F = FmaTile<D>;
  __syncthreads();  // q staged / previous tile fully consumed
  stage<T, D>(s.Ks, kp, k_ss, k0, F::N, kv_valid, 1.f);
  stage<T, D, D>(s.Vs, vp, v_ss, k0, F::N, kv_valid, 1.f);
  __syncthreads();

  FmaScores<D> sc;
  dot_tile<D>(s.Qs, s.Ks, sc);
  fwd_fold<D>(s, sc, score, drop, m_run, l_run, acc);
}

// Write the tile's base-2 lse (lse[r] for local rows r < rows) and
// o = acc / l * out_scale (row r at op + r * o_ss; out_scale is dropout's
// 1 / (1 - p), else 1); rows that kept nothing get lse = -inf and o = 0.
template <typename T, int D>
__device__ __forceinline__ void fwd_store(const FwdSmem& s, float m_run, float l_run,
                                          const FmaAcc<D>& acc, float* lse, T* op,
                                          long long o_ss, int rows, float out_scale) {
  using F = FmaTile<D>;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16, srow = tid / F::TPR;
  if ((tid % F::TPR) == 0) {
    s.l_s[srow] = l_run;
    if (srow < rows) lse[srow] = l_run > 0.f ? m_run + log2f(l_run) : neg_inf();
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < F::RI; ++i) {
    const int r = ty + 16 * i;
    if (r >= rows) continue;
    const float l = s.l_s[r];
    const float inv = l > 0.f ? 1.f / l * out_scale : 0.f;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) op[r * o_ss + tx + 16 * j] = from_f<T>(acc[i][j] * inv);
  }
}

// ----------------------------------------------------------------------------
// Backward. The softmax scale is folded as in the TPU's B2 kernel: scale *
// log2e rides on the staged q (dq) or k (dk/dv) for the recompute, and the
// ds * scale factor is applied once to the dq / dk accumulators, so v, do
// and delta stay unscaled and dp - delta cancels exactly.

template <int D>
constexpr int dq_smem_floats() {
  constexpr int M = FmaTile<D>::M, N = FmaTile<D>::N;
  return 2 * M * (D + 1) + 2 * N * (D + 1) + M * (N + 1) + 2 * M;
}

struct DqSmem {
  float* Qs;       // [M][D+1] q * scale * log2e
  float* dOs;      // [M][D+1]
  float* Ks;       // [N][D+1]
  float* Vs;       // [N][D+1]
  float* Ss;       // [M][N+1] ds
  float* lse_s;    // [M]
  float* delta_s;  // [M]
};

template <int D>
__device__ __forceinline__ DqSmem dq_smem(float* smem) {
  constexpr int M = FmaTile<D>::M, N = FmaTile<D>::N;
  DqSmem s;
  s.Qs = smem;
  s.dOs = s.Qs + M * (D + 1);
  s.Ks = s.dOs + M * (D + 1);
  s.Vs = s.Ks + N * (D + 1);
  s.Ss = s.Vs + N * (D + 1);
  s.lse_s = s.Ss + M * (N + 1);
  s.delta_s = s.lse_s + M;
  return s;
}

// Stage the q side of a dq tile: q rows [q0, q0 + M) times scale * log2e,
// do, and the rows' lse and delta (lse / delta indexed by row from the
// head's first row), all zero / -inf at or past `valid`.
template <typename T, int D>
__device__ __forceinline__ void dq_stage_q(const DqSmem& s, const T* qp, long long q_ss,
                                           const T* dop, long long do_ss, const float* lse,
                                           const float* delta, int q0, int valid,
                                           float scale_log2) {
  constexpr int M = FmaTile<D>::M;
  stage<T, D>(s.Qs, qp, q_ss, q0, M, valid, scale_log2);
  stage<T, D>(s.dOs, dop, do_ss, q0, M, valid, 1.f);
  stage_rows(s.lse_s, s.delta_s, lse, delta, q0, M, valid);
}

// One KV tile of dq: stage K/V rows [k0, k0 + N) (zero at or past
// kv_valid), recompute s and dp, let ds_of(r, c, s2, dp) give each
// element's ds, and add ds . k to acc.
template <typename T, int D, typename DsFn>
__device__ __forceinline__ void dq_kv_step(const DqSmem& s, const T* kp, long long k_ss,
                                           const T* vp, long long v_ss, int k0, int kv_valid,
                                           DsFn ds_of, FmaAcc<D>& acc) {
  using F = FmaTile<D>;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  __syncthreads();  // q side staged / previous tile fully consumed
  stage<T, D>(s.Ks, kp, k_ss, k0, F::N, kv_valid, 1.f);
  stage<T, D>(s.Vs, vp, v_ss, k0, F::N, kv_valid, 1.f);
  __syncthreads();
  FmaScores<D> sc, dp;
  dot_tile2<D>(s.Qs, s.Ks, s.dOs, s.Vs, sc, dp);
#pragma unroll
  for (int i = 0; i < F::RI; ++i)
#pragma unroll
    for (int j = 0; j < F::RJ; ++j) {
      const int r = ty + 16 * i, c = tx + 16 * j;
      s.Ss[r * (F::N + 1) + c] = ds_of(r, c, sc[i][j], dp[i][j]);
    }
  __syncthreads();
  acc_tile<D, D + 1>(s.Ss, s.Ks, acc);
}

// Write acc * mul to rows r < rows of an M-row tile (row r at p + r * ss).
template <typename T, int D>
__device__ __forceinline__ void store_tile(const FmaAcc<D>& acc, T* p, long long ss, int rows,
                                           float mul) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < FmaTile<D>::RI; ++i) {
    const int r = ty + 16 * i;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) p[r * ss + tx + 16 * j] = from_f<T>(acc[i][j] * mul);
  }
}

template <int D>
constexpr int dkdv_smem_floats() {
  constexpr int M = FmaTile<D>::M, N = FmaTile<D>::N;
  return 2 * M * (D + 1) + 2 * N * (D + 1) + 2 * M * (N + 1) + 2 * N;
}

struct DkdvSmem {
  float* Ks;       // [M][D+1] k * scale * log2e
  float* Vs;       // [M][D+1]
  float* Qs;       // [N][D+1]
  float* dOs;      // [N][D+1]
  float* Ps;       // [M][N+1] p^T
  float* dSs;      // [M][N+1] ds^T
  float* lse_s;    // [N]
  float* delta_s;  // [N]
};

template <int D>
__device__ __forceinline__ DkdvSmem dkdv_smem(float* smem) {
  constexpr int M = FmaTile<D>::M, N = FmaTile<D>::N;
  DkdvSmem s;
  s.Ks = smem;
  s.Vs = s.Ks + M * (D + 1);
  s.Qs = s.Vs + M * (D + 1);
  s.dOs = s.Qs + N * (D + 1);
  s.Ps = s.dOs + N * (D + 1);
  s.dSs = s.Ps + M * (N + 1);
  s.lse_s = s.dSs + M * (N + 1);
  s.delta_s = s.lse_s + N;
  return s;
}

// One q tile of dk/dv: stage q / do rows [r0, r0 + N) and their lse /
// delta (zero / -inf at or past q_valid; lse and delta indexed by row from
// the head's first row), recompute s^T and dp^T of the M x N (kv rows x
// q rows) tile, let pds_of(kr, qr, s2, dp, p, ds) give each element's p and
// ds, and add ds^T . q to dk_acc and p^T . do to dv_acc.
template <typename T, int D, typename PdsFn>
__device__ __forceinline__ void dkdv_q_step(const DkdvSmem& s, const T* qp, long long q_ss,
                                            const T* dop, long long do_ss, const float* lse,
                                            const float* delta, int r0, int q_valid,
                                            PdsFn pds_of, FmaAcc<D>& dk_acc, FmaAcc<D>& dv_acc) {
  using F = FmaTile<D>;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  __syncthreads();  // K/V staged / previous q tile fully consumed
  stage<T, D>(s.Qs, qp, q_ss, r0, F::N, q_valid, 1.f);
  stage<T, D>(s.dOs, dop, do_ss, r0, F::N, q_valid, 1.f);
  stage_rows(s.lse_s, s.delta_s, lse, delta, r0, F::N, q_valid);
  __syncthreads();
  FmaScores<D> sc, dp;
  dot_tile2<D>(s.Ks, s.Qs, s.Vs, s.dOs, sc, dp);
#pragma unroll
  for (int i = 0; i < F::RI; ++i)
#pragma unroll
    for (int j = 0; j < F::RJ; ++j) {
      const int kr = ty + 16 * i, qr = tx + 16 * j;
      float pr, ds;
      pds_of(kr, qr, sc[i][j], dp[i][j], pr, ds);
      s.Ps[kr * (F::N + 1) + qr] = pr;
      s.dSs[kr * (F::N + 1) + qr] = ds;
    }
  __syncthreads();
  acc_tile2<D>(s.dSs, s.Qs, s.Ps, s.dOs, dk_acc, dv_acc);
}

}  // namespace fa2
