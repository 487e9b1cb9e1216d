// The dq and dk/dv kernels of flash_bwd.cu past head dim 512, at any
// multiple of 128 (D a run-time argument): B12 (the strip), B2 (fused), B3
// (two-pass, bias / softcap) and B13 rect (region mode) as the dq + dk/dv
// pair computes them (fa2_triton_tpu/ops/flash_bwd.py: _bwd_causal_strip_
// kernel, _bwd_fused_kernel, _dq_kernel / _dkdv_kernel, flash_attn_backward_
// rect), with flash_bwd.cu's params (BwdParams), element rules (pair_elem,
// grad_elem: masks, dropout, bias, softcap, dead rows) and folds, on
// any_tiles.cuh's column split. No atomics: bitwise repeatable.
//
// Bound on the H100: compute, the 7 S S D products of a head's backward
// (dq: s, dp, dq; dk/dv: s, dp, dv, dk) on the tensor cores. The split
// forms S and dP once per chunk: dq does (2 n_chunks + 1) / 3 times its
// products (3x at D 1024), dk/dv (2 n_chunks + 2) / 4 (2.5x), the pair
// (4 n_chunks + 3) / 7 (2.71x), and q / do / k / v slices are re-read
// from L2 once per chunk and tile.
//
// Both 16-bit kernels run 8 warps in two phases a tile: the scores, split
// so that no two warps form the same element, with ds (and p) rounded to
// T into shared memory; then each warp's products over its own columns of
// the chunk (64 fp32 accumulators each for dQ, and for dK and dV).
//
// dq_any_mma_kernel, bf16 / fp16: a 64-row q tile and a chunk of DC = 256
// dQ columns. Per 64-row kv tile, (q, do, k, v) slices of 64 columns stream
// into S = Q K^T and dP = dO V^T (warp: 16 rows x 32 keys), ds per element
// (pair_elem) into shared memory, then dQ += dS K over the chunk's K
// columns (warp: 16 rows x 128 columns), staged with the tile's second
// slice.
//
// dkdv_any_mma_kernel, bf16 / fp16: 32 kv rows and a chunk of DC columns of
// dK and dV; per 64-row q tile of each q head of the GQA group, (k, v, q,
// do) slices stream into S^T = K Q^T and dP^T = V dO^T (warp: 16 kv rows x
// 16 q rows), p and ds into shared memory, then dV += P^T dO and dK += dS^T
// Q over the chunk's q / do columns (warp: 16 kv rows x 64 columns),
// staged with the tile's second slice together with its lse and delta.
//
// fp32 (no TF32): attn_tiles.cuh's 64 x 32 FMA tiles, S and dP summed over
// staged slices (dot_tile2), the chunk's columns staged per tile.
#define FA2_ANY
#include "flash_bwd.cu"

namespace fa2 {
namespace {

// Both 16-bit kernels use 8 warps in two phases per tile. First the scores:
// the tile's S and dP (S^T and dP^T) split over the warps with no two
// forming the same element; ds (and p) per element, rounded to T into
// shared memory. Then the products: each warp applies the whole tile's dS
// (P^T, dS^T) to its own columns of the chunk. A warp so holds a quarter to
// a half of the chunk's accumulators (64 fp32 registers), and S and dP are
// formed once per chunk.

struct DqAnyCfg {
  static constexpr int BQ = TM;              // q rows of a block
  static constexpr int BKV = 64;             // kv rows of a tile
  static constexpr int RG = BQ / 16;         // row groups of 16
  static constexpr int WK = 2;               // warps of a row group: along the keys, then the chunk
  static constexpr int NW = RG * WK;
  static constexpr int NT_S = BKV / WK / 8;  // n-tiles of a warp's S and dP (32 keys)
  static constexpr int DQC = any::DC / WK;   // dQ columns of a warp
  static constexpr int NT_D = DQC / 8;
  static constexpr int DP = BKV + 8;         // dS's shared row pitch
  static constexpr int SLICE = (2 * BQ + 2 * BKV) * any::SP;   // q, do, k, v slices
  static constexpr int SMEM_BYTES = (2 * SLICE + BKV * any::CP + BQ * DP) * 2;
};

struct DkdvAnyCfg {
  static constexpr int BKV = 32;                 // kv rows of a block
  static constexpr int BQ = 64;                  // q rows of a streamed tile
  static constexpr int KW = BKV / 16;            // row groups of 16 kv rows
  static constexpr int QW = 4;                   // warps of a row group: along q, then the chunk
  static constexpr int NW = KW * QW;
  static constexpr int NT_S = BQ / QW / 8;       // n-tiles of a warp's S^T and dP^T (16 q rows)
  static constexpr int DKV = any::DC / QW;       // dK / dV columns of a warp
  static constexpr int NT_KV = DKV / 8;
  static constexpr int PP = BQ + 8;              // P^T's and dS^T's shared row pitch
  static constexpr int SLICE = (2 * BKV + 2 * BQ) * any::SP;   // k, v, q, do slices
  static constexpr int CHUNKS = 2 * BQ * any::CP;               // the q tile's q, do columns
  static constexpr int SMEM_BYTES = (2 * SLICE + CHUNKS + 2 * BKV * PP) * 2 + 2 * BQ * 4;
};

// The warp's accumulators x (rows g, g + 8 of 16; NT n-tiles from column 0)
// rounded to T into a row-major tile at dst (the warp's row 0 and first
// column; pitch P).
template <typename T, int NT, int P>
__device__ __forceinline__ void frags_to_smem(const float (&x)[NT][4], T* dst) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    *reinterpret_cast<uint32_t*>(dst + g * P + n * 8 + 2 * t) = pack2<T>(x[n][0], x[n][1]);
    *reinterpret_cast<uint32_t*>(dst + (g + 8) * P + n * 8 + 2 * t) = pack2<T>(x[n][2], x[n][3]);
  }
}

// acc[n] += A . B with A 16 rows x KT * 16 of a row-major shared tile
// (pitch PA, read by ldmatrix) and B KT * 16 rows x NO * 8 columns
// (pitch PB, ldmatrix.trans).
template <typename T, int KT, int NO, int PA, int PB>
__device__ __forceinline__ void mma_sb(float (&acc)[NO][4], const T* A, const T* B) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    uint32_t a[1][4];
    ldsm_x4(a[0], A + (lane % 16) * PA + kk * 16 + (lane / 16) * 8);
    any::mma_ab<T, 1, NO, PB>(acc, a, B + kk * 16 * PB);
  }
}

// dq: one block of 8 warps per (64-row q tile x column chunk, q head, batch
// row); per 64-row kv tile, warp (row group w % 4, key half w / 4) forms S
// and dP of its 16 rows x 32 keys over D's slices, ds into shared memory;
// then dQ of its 16 rows x 128 columns of the chunk += dS K.
template <typename T, bool DROP, bool EXTRA>
__global__ void __launch_bounds__(DqAnyCfg::NW * 32, 1) dq_any_mma_kernel(const BwdParams p) {
  using C = DqAnyCfg;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sl = reinterpret_cast<T*>(smem_raw);  // slice buffer j: q, do [BQ][SP], k, v [BKV][SP]
  T* kb = sl + 2 * C::SLICE;               // the tile's K chunk columns [BKV][CP]
  T* ds_s = kb + C::BKV * any::CP;         // dS [BQ][DP]
  const int chunk = blockIdx.x % p.n_dc, bh = blockIdx.x / p.n_dc;
  const int h = bh % p.Hq, b = bh / p.Hq;
  const int q0 = (p.causal ? (int)(gridDim.y - 1 - blockIdx.y) : (int)blockIdx.y) * C::BQ;
  const int hk = h / (p.Hq / p.Hkv);
  const int q_len = p.lens[2 * b], kv_len = p.lens[2 * b + 1];
  const int q_valid = min(p.Sq, q_len - p.q_off);
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32, g = lane / 4, t = lane % 4;
  const int rg = w % C::RG, wk = w / C::RG;
  const int d0 = chunk * any::DC;

  const T* qp = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* dop = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const T* kp = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vp = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  const KeyRange kr = key_range(p, q0, C::BQ, q_len, kv_len);
  const int k_begin = (kr.lo / C::BKV) * C::BKV;
  const int n_tiles = kr.hi > k_begin ? (kr.hi - k_begin + C::BKV - 1) / C::BKV : 0;
  const int n_slices = p.D / any::KS;

  // lse and delta of rows g and g + 8 of the warp's 16 (-inf / 0 past q_valid).
  float lse[2], delta[2];
  const long long row0 = ((long long)b * p.Hq + h) * p.Sq + q0;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = rg * 16 + g + 8 * hr;
    const bool ok = q0 + r < q_valid;
    lse[hr] = ok ? p.lse[row0 + r] : neg_inf();
    delta[hr] = ok ? p.delta[row0 + r] : 0.f;
  }
  float dq[C::NT_D][4], sc[C::NT_S][4], dp[C::NT_S][4];
  any::zero_frags(dq);
  any::slice_loop(
      n_tiles, n_slices,
      [&](int i, int sl_i, int buf) {
        const int k0 = k_begin + i * C::BKV, c = sl_i * any::KS;
        T* dst = sl + buf * C::SLICE;
        constexpr int NT = C::NW * 32;
        any::cp_tile<C::BQ, any::KS, any::SP, NT>(dst, qp, p.q_ss, q0, q_valid, c, p.D);
        any::cp_tile<C::BQ, any::KS, any::SP, NT>(dst + C::BQ * any::SP, dop, p.do_ss, q0, q_valid,
                                                  c, p.D);
        any::cp_tile<C::BKV, any::KS, any::SP, NT>(dst + 2 * C::BQ * any::SP, kp, p.k_ss, k0,
                                                   kr.kv_valid, c, p.D);
        any::cp_tile<C::BKV, any::KS, any::SP, NT>(dst + (2 * C::BQ + C::BKV) * any::SP, vp,
                                                   p.v_ss, k0, kr.kv_valid, c, p.D);
        // The chunk's K columns with the second slice: the last tile's dQ
        // products, which read them, are behind this step's barrier.
        if (sl_i == 1) {
          any::cp_tile<C::BKV, any::DC, any::CP, NT>(kb, kp, p.k_ss, k0, kr.kv_valid, d0, p.D);
        }
      },
      [&](int i, int sl_i, int buf) {
        const T* src = sl + buf * C::SLICE;
        if (sl_i == 0) {
          any::zero_frags(sc);
          any::zero_frags(dp);
        }
        const int kw = wk * (C::BKV / C::WK);   // the warp's first key of the tile
        any::mma_abt<T, C::NT_S, any::SP>(sc, src + rg * 16 * any::SP,
                                          src + (2 * C::BQ + kw) * any::SP);
        any::mma_abt<T, C::NT_S, any::SP>(dp, src + (C::BQ + rg * 16) * any::SP,
                                          src + (2 * C::BQ + C::BKV + kw) * any::SP);
        if (sl_i + 1 < n_slices) return;
        const int k0 = k_begin + i * C::BKV;
        const bool free_tile = !EXTRA && k0 >= kr.free_lo && k0 + C::BKV <= kr.free_hi;
#pragma unroll
        for (int n = 0; n < C::NT_S; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            pair_elem<DROP, EXTRA>(p, b, h, q0 + rg * 16 + g + (e / 2) * 8,
                                   k0 + kw + n * 8 + 2 * t + (e % 2), q_len, kv_len, free_tile,
                                   lse[e / 2], delta[e / 2], sc[n][e], dp[n][e]);
          }
        frags_to_smem<T, C::NT_S, C::DP>(dp, ds_s + rg * 16 * C::DP + kw);
        __syncthreads();  // the tile's dS (and its K columns) in shared memory
        mma_sb<T, C::BKV / 16, C::NT_D, C::DP, any::CP>(dq, ds_s + rg * 16 * C::DP,
                                                        kb + wk * C::DQC);
      });
  any::store_frags<T, C::NT_D>(
      dq, static_cast<T*>(p.dq) + b * p.dq_sb + h * p.dq_sh + (long long)(q0 + rg * 16) * p.dq_ss +
              d0 + wk * C::DQC,
      p.dq_ss, p.Sq - q0 - rg * 16, min(any::DC, p.D - d0) - wk * C::DQC, p.dq_mul);
}

// dk/dv: one block of 8 warps per (32 kv rows x column chunk, kv head, batch
// row) walks every 64-row q tile of every q head of the GQA group that can
// see them; per q tile, warp (row group w % 2, q quarter w / 2) forms S^T
// and dP^T of its 16 kv rows x 16 q rows over D's slices, p and ds into
// shared memory; then dV += P^T dO and dK += dS^T Q over its 64 columns of
// the chunk, staged with the tile's second slice with the rows' lse and
// delta.
template <typename T, bool DROP, bool EXTRA>
__global__ void __launch_bounds__(DkdvAnyCfg::NW * 32, 1) dkdv_any_mma_kernel(const BwdParams p) {
  using C = DkdvAnyCfg;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sl = reinterpret_cast<T*>(smem_raw);  // slice buffer j: k, v [BKV][SP], q, do [BQ][SP]
  T* cb = sl + 2 * C::SLICE;               // the q tile's q, do chunk columns [BQ][CP] each
  T* pt_s = cb + C::CHUNKS;                // P^T [BKV][PP]
  T* dst_s = pt_s + C::BKV * C::PP;        // dS^T [BKV][PP]
  float* lb = reinterpret_cast<float*>(dst_s + C::BKV * C::PP);  // lse [BQ], delta [BQ]
  const int chunk = blockIdx.x % p.n_dc, bh = blockIdx.x / p.n_dc;
  const int hk = bh % p.Hkv, b = bh / p.Hkv, k0 = blockIdx.y * C::BKV;
  const int group = p.Hq / p.Hkv;
  const int q_len = p.lens[2 * b], kv_len = p.lens[2 * b + 1];
  const int shift = kv_len - q_len;
  const int q_valid = min(p.Sq, q_len - p.q_off);
  const int kv_valid = min(p.Sk, kv_len - p.kv_off);
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32, g = lane / 4, t = lane % 4;
  const int wr = (w % C::KW) * 16, wq = w / C::KW;
  const int d0 = chunk * any::DC;

  // dkdv_mma_kernel's q rows: [r_lo, r_hi) can see a live column of the tile.
  const int col_lo = p.kv_off + k0;
  const int col_hi = p.kv_off + min(k0 + C::BKV, kv_valid) - 1;  // inclusive
  int r_lo = 0, r_hi = q_valid;
  if (p.causal) {
    r_lo = max(0, col_lo - shift - p.q_off);
  } else if (p.wr >= 0) {
    r_lo = max(0, col_lo - shift - p.wr - p.q_off);
  }
  if (p.wl >= 0) r_hi = min(r_hi, col_hi - shift + p.wl - p.q_off + 1);
  if (col_hi < col_lo) r_hi = 0;
  auto all_kept = [&](int r0) {
    const int row_lo = p.q_off + r0 + shift, row_hi = row_lo + C::BQ - 1;
    return !EXTRA && r0 + C::BQ <= q_valid && k0 + C::BKV <= kv_valid &&
           (p.causal ? col_hi <= row_lo : p.wr < 0 || col_hi <= row_lo + p.wr) &&
           (p.wl < 0 || col_lo >= row_hi - p.wl);
  };
  const int ra = (r_lo / C::BQ) * C::BQ;
  const int nqt = r_hi > r_lo ? (r_hi - ra + C::BQ - 1) / C::BQ : 0;
  const int n_slices = p.D / any::KS;
  const T* kp = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vp = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;

  float dk[C::NT_KV][4], dv[C::NT_KV][4], sc[C::NT_S][4], dp[C::NT_S][4];
  any::zero_frags(dk);
  any::zero_frags(dv);
  any::slice_loop(
      group * nqt, n_slices,
      [&](int i, int sl_i, int buf) {
        const int h = hk * group + i / nqt, r0 = ra + (i % nqt) * C::BQ, c = sl_i * any::KS;
        const T* qp = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
        const T* dop = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
        T* dst = sl + buf * C::SLICE;
        constexpr int NT = C::NW * 32;
        any::cp_tile<C::BKV, any::KS, any::SP, NT>(dst, kp, p.k_ss, k0, kv_valid, c, p.D);
        any::cp_tile<C::BKV, any::KS, any::SP, NT>(dst + C::BKV * any::SP, vp, p.v_ss, k0,
                                                   kv_valid, c, p.D);
        any::cp_tile<C::BQ, any::KS, any::SP, NT>(dst + 2 * C::BKV * any::SP, qp, p.q_ss, r0,
                                                  q_valid, c, p.D);
        any::cp_tile<C::BQ, any::KS, any::SP, NT>(dst + (2 * C::BKV + C::BQ) * any::SP, dop,
                                                  p.do_ss, r0, q_valid, c, p.D);
        // The chunk's q / do columns, lse and delta with the second slice: the
        // last tile's products, which read them, are behind this step's barrier.
        if (sl_i == 1) {
          any::cp_tile<C::BQ, any::DC, any::CP, NT>(cb, qp, p.q_ss, r0, q_valid, d0, p.D);
          any::cp_tile<C::BQ, any::DC, any::CP, NT>(cb + C::BQ * any::CP, dop, p.do_ss, r0,
                                                    q_valid, d0, p.D);
          if (threadIdx.x < 2 * C::BQ) {  // lse, then delta, of the tile's rows
            const int r = threadIdx.x % C::BQ;
            const bool ok = r0 + r < q_valid;
            const long long at = ((long long)b * p.Hq + h) * p.Sq + (ok ? r0 + r : 0);
            cp_async4(lb + threadIdx.x, (threadIdx.x < C::BQ ? p.lse : p.delta) + at, ok);
          }
        }
      },
      [&](int i, int sl_i, int buf) {
        const T* src = sl + buf * C::SLICE;
        if (sl_i == 0) {
          any::zero_frags(sc);
          any::zero_frags(dp);
        }
        const int qw = wq * (C::BQ / C::QW);   // the warp's first q row of the tile
        any::mma_abt<T, C::NT_S, any::SP>(sc, src + wr * any::SP,
                                          src + (2 * C::BKV + qw) * any::SP);
        any::mma_abt<T, C::NT_S, any::SP>(dp, src + (C::BKV + wr) * any::SP,
                                          src + (2 * C::BKV + C::BQ + qw) * any::SP);
        if (sl_i + 1 < n_slices) return;
        const int h = hk * group + i / nqt, r0 = ra + (i % nqt) * C::BQ;
        const bool free_tile = all_kept(r0);
        // Element e of n-tile n: kv row wr + g + 8 (e / 2), q row qw + n * 8 +
        // 2 t + e % 2; h is the q head of this group member (the forward's
        // counter).
#pragma unroll
        for (int n = 0; n < C::NT_S; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qr = qw + n * 8 + 2 * t + (e % 2);
            pair_elem<DROP, EXTRA>(p, b, h, r0 + qr, k0 + wr + g + (e / 2) * 8, q_len, kv_len,
                                   free_tile, lb[qr], lb[C::BQ + qr], sc[n][e], dp[n][e]);
          }
        frags_to_smem<T, C::NT_S, C::PP>(sc, pt_s + wr * C::PP + qw);
        frags_to_smem<T, C::NT_S, C::PP>(dp, dst_s + wr * C::PP + qw);
        __syncthreads();  // the tile's P^T and dS^T in shared memory
        mma_sb<T, C::BQ / 16, C::NT_KV, C::PP, any::CP>(dv, pt_s + wr * C::PP,
                                                        cb + C::BQ * any::CP + wq * C::DKV);
        mma_sb<T, C::BQ / 16, C::NT_KV, C::PP, any::CP>(dk, dst_s + wr * C::PP,
                                                        cb + wq * C::DKV);
      });
  const int rows = p.Sk - k0 - wr, cols = min(any::DC, p.D - d0) - wq * C::DKV;
  const long long at = (long long)(k0 + wr);
  any::store_frags<T, C::NT_KV>(
      dk, static_cast<T*>(p.dk) + b * p.dk_sb + hk * p.dk_sh + at * p.dk_ss + d0 + wq * C::DKV,
      p.dk_ss, rows, cols, p.scale);
  any::store_frags<T, C::NT_KV>(
      dv, static_cast<T*>(p.dv) + b * p.dv_sb + hk * p.dv_sh + at * p.dv_ss + d0 + wq * C::DKV,
      p.dv_ss, rows, cols, 1.f);
}

// ---- fp32 inputs --------------------------------------------------------------

using AnyFma = FmaTile<any::DC>;  // 64 x 32 tiles, 4 x 16 accumulators a thread
constexpr int FP = any::KS + 1;   // a staged slice's pitch, floats

// acc * mul to rows r < rows, columns c < cols of an M-row tile (row r at
// out + r * ss, the chunk's first column).
template <typename T>
__device__ __forceinline__ void store_cols(const FmaAcc<any::DC>& acc, T* out, long long ss,
                                           int rows, int cols, float mul) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < AnyFma::RI; ++i) {
    const int r = ty + 16 * i;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < any::DC / 16; ++j) {
      if (tx + 16 * j < cols) out[r * ss + tx + 16 * j] = from_f<T>(acc[i][j] * mul);
    }
  }
}

constexpr int dq_any_fma_floats() {
  constexpr int M = AnyFma::M, N = AnyFma::N;
  return 2 * (M + N) * FP + N * any::DC + M * (N + 1) + 2 * M;
}

template <typename T, bool DROP>
__global__ void __launch_bounds__(THREADS) dq_any_fma_kernel(const BwdParams p) {
  using F = AnyFma;
  extern __shared__ float smem[];
  float* Qs = smem;                 // [M][FP] a slice of q * s_mul
  float* dOs = Qs + F::M * FP;      // [M][FP]
  float* Ks = dOs + F::M * FP;      // [N][FP]
  float* Vs = Ks + F::N * FP;       // [N][FP]
  float* Kc = Vs + F::N * FP;       // [N][DC] the chunk's columns of k
  float* Ss = Kc + F::N * any::DC;  // [M][N + 1] ds
  float* lse_s = Ss + F::M * (F::N + 1);
  float* delta_s = lse_s + F::M;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int chunk = blockIdx.x % p.n_dc, bh = blockIdx.x / p.n_dc;
  const int h = bh % p.Hq, b = bh / p.Hq, q0 = blockIdx.y * F::M;
  const int hk = h / (p.Hq / p.Hkv);
  const int q_len = p.lens[2 * b], kv_len = p.lens[2 * b + 1];
  const int q_valid = min(p.Sq, q_len - p.q_off);
  const int d0 = chunk * any::DC;
  const T* qp = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* dop = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const T* kp = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vp = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  const long long row0 = ((long long)b * p.Hq + h) * p.Sq;
  stage_rows(lse_s, delta_s, p.lse + row0, p.delta + row0, q0, F::M, q_valid);
  const KeyRange kr = key_range(p, q0, F::M, q_len, kv_len);

  FmaAcc<any::DC> acc;
  zero_acc<any::DC>(acc);
  for (int k0 = (kr.lo / F::N) * F::N; k0 < kr.hi; k0 += F::N) {
    FmaScores<any::DC> sc, dp;
#pragma unroll
    for (int i = 0; i < F::RI; ++i)
#pragma unroll
      for (int j = 0; j < F::RJ; ++j) sc[i][j] = dp[i][j] = 0.f;
    for (int c = 0; c < p.D; c += any::KS) {
      __syncthreads();  // the previous slice (or tile) fully consumed
      any::stage_cols<T, any::KS, FP>(Qs, qp, p.q_ss, q0, F::M, q_valid, c, p.D, p.s_mul);
      any::stage_cols<T, any::KS, FP>(dOs, dop, p.do_ss, q0, F::M, q_valid, c, p.D, 1.f);
      any::stage_cols<T, any::KS, FP>(Ks, kp, p.k_ss, k0, F::N, kr.kv_valid, c, p.D, 1.f);
      any::stage_cols<T, any::KS, FP>(Vs, vp, p.v_ss, k0, F::N, kr.kv_valid, c, p.D, 1.f);
      __syncthreads();
      FmaScores<any::KS> s1, s2;
      dot_tile2<any::KS>(Qs, Ks, dOs, Vs, s1, s2);
#pragma unroll
      for (int i = 0; i < F::RI; ++i)
#pragma unroll
        for (int j = 0; j < F::RJ; ++j) {
          sc[i][j] += s1[i][j];
          dp[i][j] += s2[i][j];
        }
    }
    any::stage_cols<T, any::DC, any::DC>(Kc, kp, p.k_ss, k0, F::N, kr.kv_valid, d0, p.D, 1.f);
#pragma unroll
    for (int i = 0; i < F::RI; ++i)
#pragma unroll
      for (int j = 0; j < F::RJ; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        const bool keep = keep_at(q0 + r, k0 + c, p.Sq, p.Sk, p.q_off, p.kv_off, q_len, kv_len,
                                  p.causal, p.wl, p.wr);
        float pr, ds, ds_pre;
        grad_elem(p, sc[i][j], dp[i][j], lse_s[r], delta_s[r],
                  bias_at(p, b, h, q0 + r, k0 + c, keep), keep,
                  drop_at<DROP>(p, b, h, q0 + r, k0 + c), pr, ds, ds_pre);
        Ss[r * (F::N + 1) + c] = ds;
      }
    __syncthreads();
    acc_tile<any::DC, any::DC>(Ss, Kc, acc);
  }
  store_cols<T>(acc, static_cast<T*>(p.dq) + b * p.dq_sb + h * p.dq_sh + q0 * p.dq_ss + d0,
                p.dq_ss, min(F::M, p.Sq - q0), min(any::DC, p.D - d0), p.dq_mul);
}

constexpr int dkdv_any_fma_floats() {
  constexpr int M = AnyFma::M, N = AnyFma::N;
  return 2 * (M + N) * FP + 2 * N * (any::DC + 1) + 2 * M * (N + 1) + 2 * N;
}

template <typename T, bool DROP>
__global__ void __launch_bounds__(THREADS) dkdv_any_fma_kernel(const BwdParams p) {
  using F = AnyFma;
  extern __shared__ float smem[];
  float* Ks = smem;                  // [M][FP] a slice of k * s_mul
  float* Vs = Ks + F::M * FP;        // [M][FP]
  float* Qs = Vs + F::M * FP;        // [N][FP]
  float* dOs = Qs + F::N * FP;       // [N][FP]
  float* Qc = dOs + F::N * FP;       // [N][DC + 1] the chunk's columns of q
  float* dOc = Qc + F::N * (any::DC + 1);  // [N][DC + 1]
  float* Ps = dOc + F::N * (any::DC + 1);  // [M][N + 1] p^T
  float* dSs = Ps + F::M * (F::N + 1);     // [M][N + 1] ds^T
  float* lse_s = dSs + F::M * (F::N + 1);
  float* delta_s = lse_s + F::N;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int chunk = blockIdx.x % p.n_dc, bh = blockIdx.x / p.n_dc;
  const int hk = bh % p.Hkv, b = bh / p.Hkv, k0 = blockIdx.y * F::M;
  const int group = p.Hq / p.Hkv;
  const int q_len = p.lens[2 * b], kv_len = p.lens[2 * b + 1];
  const int shift = kv_len - q_len;
  const int q_valid = min(p.Sq, q_len - p.q_off);
  const int kv_valid = min(p.Sk, kv_len - p.kv_off);
  const int d0 = chunk * any::DC;
  const T* kp = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vp = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;

  // dkdv_kernel's q rows [r_lo, r_hi) that can see a live column of the tile.
  const int col_lo = p.kv_off + k0;
  const int col_hi = p.kv_off + min(k0 + F::M, kv_valid) - 1;  // inclusive
  int r_lo = 0, r_hi = q_valid;
  if (p.causal) {
    r_lo = max(0, col_lo - shift - p.q_off);
  } else if (p.wr >= 0) {
    r_lo = max(0, col_lo - shift - p.wr - p.q_off);
  }
  if (p.wl >= 0) r_hi = min(r_hi, col_hi - shift + p.wl - p.q_off + 1);
  if (col_hi < col_lo) r_hi = 0;

  FmaAcc<any::DC> dk_acc, dv_acc;
  zero_acc<any::DC>(dk_acc);
  zero_acc<any::DC>(dv_acc);
  for (int gi = 0; gi < group; ++gi) {
    const int h = hk * group + gi;
    const long long row0 = ((long long)b * p.Hq + h) * p.Sq;
    const T* qp = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
    const T* dop = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
    for (int r0 = (r_lo / F::N) * F::N; r0 < r_hi; r0 += F::N) {
      FmaScores<any::DC> sc, dp;
#pragma unroll
      for (int i = 0; i < F::RI; ++i)
#pragma unroll
        for (int j = 0; j < F::RJ; ++j) sc[i][j] = dp[i][j] = 0.f;
      for (int c = 0; c < p.D; c += any::KS) {
        __syncthreads();  // the previous slice (or tile) fully consumed
        any::stage_cols<T, any::KS, FP>(Ks, kp, p.k_ss, k0, F::M, kv_valid, c, p.D, p.s_mul);
        any::stage_cols<T, any::KS, FP>(Vs, vp, p.v_ss, k0, F::M, kv_valid, c, p.D, 1.f);
        any::stage_cols<T, any::KS, FP>(Qs, qp, p.q_ss, r0, F::N, q_valid, c, p.D, 1.f);
        any::stage_cols<T, any::KS, FP>(dOs, dop, p.do_ss, r0, F::N, q_valid, c, p.D, 1.f);
        __syncthreads();
        FmaScores<any::KS> s1, s2;
        dot_tile2<any::KS>(Ks, Qs, Vs, dOs, s1, s2);
#pragma unroll
        for (int i = 0; i < F::RI; ++i)
#pragma unroll
          for (int j = 0; j < F::RJ; ++j) {
            sc[i][j] += s1[i][j];
            dp[i][j] += s2[i][j];
          }
      }
      any::stage_cols<T, any::DC, any::DC + 1>(Qc, qp, p.q_ss, r0, F::N, q_valid, d0, p.D, 1.f);
      any::stage_cols<T, any::DC, any::DC + 1>(dOc, dop, p.do_ss, r0, F::N, q_valid, d0, p.D,
                                               1.f);
      stage_rows(lse_s, delta_s, p.lse + row0, p.delta + row0, r0, F::N, q_valid);
      __syncthreads();
#pragma unroll
      for (int i = 0; i < F::RI; ++i)
#pragma unroll
        for (int j = 0; j < F::RJ; ++j) {
          const int kr = ty + 16 * i, qr = tx + 16 * j;
          const bool keep = keep_at(r0 + qr, k0 + kr, p.Sq, p.Sk, p.q_off, p.kv_off, q_len,
                                    kv_len, p.causal, p.wl, p.wr);
          float pr, ds, ds_pre;
          grad_elem(p, sc[i][j], dp[i][j], lse_s[qr], delta_s[qr],
                    bias_at(p, b, h, r0 + qr, k0 + kr, keep), keep,
                    drop_at<DROP>(p, b, h, r0 + qr, k0 + kr), pr, ds, ds_pre);
          Ps[kr * (F::N + 1) + qr] = pr;
          dSs[kr * (F::N + 1) + qr] = ds;
        }
      __syncthreads();
      acc_tile2<any::DC>(dSs, Qc, Ps, dOc, dk_acc, dv_acc);
    }
  }
  const int rows = min(F::M, p.Sk - k0), cols = min(any::DC, p.D - d0);
  store_cols<T>(dk_acc, static_cast<T*>(p.dk) + b * p.dk_sb + hk * p.dk_sh + k0 * p.dk_ss + d0,
                p.dk_ss, rows, cols, p.scale);
  store_cols<T>(dv_acc, static_cast<T*>(p.dv) + b * p.dv_sb + hk * p.dv_sh + k0 * p.dv_ss + d0,
                p.dv_ss, rows, cols, 1.f);
}

// ---- launch -----------------------------------------------------------------

template <class K>
cudaError_t launch_one(K kernel, dim3 grid, int threads, int smem, const BwdParams& p,
                       cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

// Grid x runs over (batch row, head, column chunk), the chunks innermost; y
// over the tiles (the dq kernels' last q tiles first under a causal mask).
template <typename T, bool DROP, bool EXTRA>
cudaError_t launch_any_kernel(const BwdParams& p, int which, cudaStream_t stream) {
  const int qt = (p.Sq + TM - 1) / TM;
  const dim3 dq_grid(p.B * p.Hq * p.n_dc, qt);
  // kv tiles: 64 rows for the FMA kernel, DkdvAnyCfg::BKV for the tensor cores.
  const int kv_rows = std::is_same<T, float>::value ? AnyFma::M : DkdvAnyCfg::BKV;
  const dim3 kv_grid(p.B * p.Hkv * p.n_dc, (p.Sk + kv_rows - 1) / kv_rows);
  if constexpr (std::is_same<T, float>::value) {
    if (which == kDq) {
      return launch_one(dq_any_fma_kernel<T, DROP>, dq_grid, THREADS,
                        dq_any_fma_floats() * (int)sizeof(float), p, stream);
    }
    return launch_one(dkdv_any_fma_kernel<T, DROP>, kv_grid, THREADS,
                      dkdv_any_fma_floats() * (int)sizeof(float), p, stream);
  } else {
    if (which == kDq) {
      return launch_one(dq_any_mma_kernel<T, DROP, EXTRA>, dq_grid, DqAnyCfg::NW * 32,
                        DqAnyCfg::SMEM_BYTES, p, stream);
    }
    return launch_one(dkdv_any_mma_kernel<T, DROP, EXTRA>, kv_grid, DkdvAnyCfg::NW * 32,
                      DkdvAnyCfg::SMEM_BYTES, p, stream);
  }
}

template <typename T>
cudaError_t launch_any(const BwdParams& p, int which, cudaStream_t stream) {
  // TM (64) rows a q tile for the host's count; the dk/dv kernels' kv tiles
  // are 64 rows too. dbias is not built past 512 (ROADMAP.md queue A 1(c2)).
  if (p.tile_rows != TM || (which != kDq && which != kDkDv) || p.D <= 512 || p.D % 128 != 0 ||
      p.n_dc != any::col_chunks(p.D)) {
    return cudaErrorInvalidValue;
  }
  const bool extra = p.bias != nullptr || p.softcap > 0.f;
  if (p.drop.on) {
    return extra ? launch_any_kernel<T, true, true>(p, which, stream)
                 : launch_any_kernel<T, true, false>(p, which, stream);
  }
  return extra ? launch_any_kernel<T, false, true>(p, which, stream)
               : launch_any_kernel<T, false, false>(p, which, stream);
}

}  // namespace

int launch_bwd_any(const BwdParams& p, int dtype, int which, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return (int)launch_any<float>(p, which, s);
    case kF16: return (int)launch_any<__half>(p, which, s);
    case kBF16: return (int)launch_any<__nv_bfloat16>(p, which, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace fa2
