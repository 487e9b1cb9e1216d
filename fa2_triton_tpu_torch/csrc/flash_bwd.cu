// FlashAttention-2 backward for Hopper (sm_90a), written by hand in CUDA C++.
//
// Replaces, as `flash_attn_func`'s autograd reaches them:
//   * fa2_triton_tpu/ops/flash_bwd.py:_bwd_causal_strip_kernel (B12, the
//     causal backward of the seq-2048 training path),
//   * fa2_triton_tpu/ops/flash_bwd.py:_bwd_fused_kernel (B2, the no-bias
//     backward of longer sequences),
//   * fa2_triton_tpu/ops/flash_bwd.py:_dq_kernel and _dkdv_kernel (B3, every
//     backward with a bias),
//   * fa2_triton_tpu/ops/flash_bwd.py:_dbias_kernel (B4, the bias gradient).
// The TPU kernels differ in how they fit VMEM and order a sequential grid
// (strip-resident, zigzag, two-pass); they compute one function, and on the
// GPU one deterministic design serves all of them: a dq kernel, a dk/dv
// kernel and a dbias kernel.
//
// Function (scores in the base-2 domain, lse the forward's base-2 LSE):
//   s  = q k^T * scale;  c = softcap * tanh(s / softcap) (or s);  s' = c + bias
//   p  = exp2(s' * log2e - lse)                 (0 where masked or lse = -inf)
//   dp = do v^T;  ds_pre = p * (dp - delta);  ds = ds_pre * (1 - (c/softcap)^2)
//   dq = scale * ds k;  dk = scale * ds^T q (summed over the GQA group);
//   dv = p^T do (summed over the group);  dbias = ds_pre summed over the
//   bias's broadcast batch / head dims.
// delta = rowsum(o * do) - dlse * log2e is computed by the wrapper. The
// softmax scale is folded as in B2 (flash_bwd.py:1586-1595): scale * log2e
// rides on q (dq, dbias kernels) or k (dk/dv kernel) for the recompute, and
// the ds * scale factor is applied once to the dq / dk accumulators, so
// v, do and delta stay unscaled and dp - delta cancels exactly.
//
// Determinism: no atomics anywhere. The dq kernel owns q-row tiles (KV
// loop inside the block), the dk/dv kernel owns KV-row tiles (a loop over
// the whole GQA group's q heads and q tiles inside the block), the dbias
// kernel owns bias tiles (a loop over the reduced batch / head dims inside
// the block). Every sum runs in a fixed order: results are bitwise
// repeatable.
//
// Masking: rows past q_len and columns past kv_len are zero-filled when
// loaded, so padding that holds NaN cannot leak through 0 * NaN; a masked
// element's p and ds are selected to 0, never multiplied. A row with no valid
// column has lse = -inf and gets exactly zero gradient.
//
// Bound on the H100: the two kernels together do 7 S*S*D products per head
// (dk/dv: s, dp, dv, dk; dq: s, dp, dq), compute-bound at training
// lengths. This first version is the simple, correct one: fp32 FMAs on the
// CUDA cores from shared-memory tiles, each thread holding a 4x2
// score tile and 4 x (D/16) accumulator columns in registers, shared rows
// padded by one float against bank conflicts, tiles beyond the causal /
// window / length limits never loaded. wgmma + TMA is later work.
#include "common.cuh"

namespace fa2 {
namespace {

constexpr int THREADS = 256;             // a 16 x 16 grid of threads
constexpr int QB = 64, QK = 32;          // dq / dbias tiles: 64 q rows x 32 kv cols
constexpr int KB = 64, KQ = 32;          // dk/dv tiles: 64 kv rows x 32 q rows

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // [B, Hq, Sq] fp32, base 2
  const float* delta;  // [B, Hq, Sq] fp32
  const void* bias;    // nullptr = none; bias[b][h][row][col] through strides
  int bias_dtype;
  void* dq;
  void* dk;
  void* dv;
  void* dbias;         // [Bb, Hb, Sq, Sk], last dim contiguous, bias dtype
  const int* lens;     // [B, 2] (q_len, kv_len)
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long do_sb, do_sh, do_ss;
  long long dq_sb, dq_sh, dq_ss;
  long long dk_sb, dk_sh, dk_ss;
  long long dv_sb, dv_sh, dv_ss;
  long long bias_sb, bias_sh, bias_sq, bias_sk;
  long long dbias_sb, dbias_sh, dbias_sq;
  int B, Hq, Hkv, Sq, Sk, Bb, Hb;
  int q_off, kv_off, causal, wl, wr;
  float scale;       // softmax scale (natural)
  float scale_log2;  // scale * log2(e)
  float softcap;     // natural units; 0 = off
};

// p, ds and ds_pre of one score element (see the function above). s2 is the
// raw product q.k * scale * log2e.
__device__ __forceinline__ void grad_elem(const BwdParams& p, float s2, float dp, float lse,
                                          float delta, float bias, bool keep, float& pr,
                                          float& ds, float& ds_pre) {
  float t = 0.f;
  if (p.softcap > 0.f || p.bias != nullptr) {
    float x = s2 * (1.f / LOG2E);
    if (p.softcap > 0.f) {
      t = tanhf(x / p.softcap);
      x = p.softcap * t;
    }
    s2 = (x + bias) * LOG2E;
  }
  keep = keep && isfinite(lse);
  pr = keep ? exp2f(s2 - lse) : 0.f;
  ds_pre = keep ? pr * (dp - delta) : 0.f;
  ds = p.softcap > 0.f ? ds_pre * (1.f - t * t) : ds_pre;
}

__device__ __forceinline__ float bias_at(const BwdParams& p, int b, int h, int r, int c,
                                         bool keep) {
  if (p.bias == nullptr || !keep) return 0.f;
  return load_any(p.bias, p.bias_dtype,
                  b * p.bias_sb + h * p.bias_sh + r * p.bias_sq + c * p.bias_sk);
}

// Stage `rows` rows of a [*, D] operand (row stride `ss`) into shared memory
// with row pitch D + 1, times `mul`; rows at or past `valid` are zero.
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, const T* src, long long ss, int row0, int rows,
                                      int valid, float mul) {
  constexpr int D4 = D / 4;
  for (int i = threadIdx.x; i < rows * D4; i += THREADS) {
    const int r = i / D4, d = (i % D4) * 4;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (row0 + r < valid) load_vec<T, 4>(src + (long long)(row0 + r) * ss + d, x);
#pragma unroll
    for (int j = 0; j < 4; ++j) dst[r * (D + 1) + d + j] = x[j] * mul;
  }
}

// The local KV columns [lo, hi) that the live rows of the q tile at q0 can
// see (the forward kernel's rule).
__device__ __forceinline__ void kv_range(const BwdParams& p, int q0, int q_len, int kv_len,
                                         int& lo, int& hi) {
  const int shift = kv_len - q_len;
  const int row_lo = p.q_off + q0;
  const int row_hi = min(p.q_off + min(q0 + QB, p.Sq), q_len) - 1;  // inclusive
  hi = min(p.Sk, kv_len - p.kv_off);
  if (p.causal) {
    hi = min(hi, row_hi + shift + 1 - p.kv_off);
  } else if (p.wr >= 0) {
    hi = min(hi, row_hi + shift + p.wr + 1 - p.kv_off);
  }
  if (row_hi < row_lo) hi = 0;
  lo = p.wl >= 0 ? max(0, row_lo + shift - p.wl - p.kv_off) : 0;
}

template <int D>
constexpr int dq_smem_floats() {
  return 2 * QB * (D + 1) + 2 * QK * (D + 1) + QB * (QK + 1) + 2 * QB;
}

// Scores and dp of a 64 x 32 (q rows x kv cols) tile: thread (tx, ty) owns
// rows ty + 16 i and columns tx + 16 j.
template <int D>
__device__ __forceinline__ void qk_tile(const float* Qs, const float* dOs, const float* Ks,
                                        const float* Vs, float (&s)[4][2], float (&dp)[4][2]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float a[4], o[4], c[2], w[2];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = Qs[(ty + 16 * i) * (D + 1) + d];
      o[i] = dOs[(ty + 16 * i) * (D + 1) + d];
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      c[j] = Ks[(tx + 16 * j) * (D + 1) + d];
      w[j] = Vs[(tx + 16 * j) * (D + 1) + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        s[i][j] = fmaf(a[i], c[j], s[i][j]);
        dp[i][j] = fmaf(o[i], w[j], dp[i][j]);
      }
  }
}

// Stage the q-side operands of the dq / dbias kernels: q * scale * log2e,
// do, and the rows' lse and delta (-inf / 0 past the valid rows).
template <typename T, int D>
__device__ __forceinline__ void stage_q_side(const BwdParams& p, int b, int h, int q0,
                                             int q_valid, float* Qs, float* dOs, float* lse_s,
                                             float* delta_s) {
  const T* qp = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* dop = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  stage<T, D>(Qs, qp, p.q_ss, q0, QB, q_valid, p.scale_log2);
  stage<T, D>(dOs, dop, p.do_ss, q0, QB, q_valid, 1.f);
  for (int r = threadIdx.x; r < QB; r += THREADS) {
    const long long i = ((long long)b * p.Hq + h) * p.Sq + q0 + r;
    const bool ok = q0 + r < q_valid;
    lse_s[r] = ok ? p.lse[i] : neg_inf();
    delta_s[r] = ok ? p.delta[i] : 0.f;
  }
}

// dq: one block per (64-row q tile, q head, batch row); loops over the KV
// tiles up to the causal / window / length edge.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS) dq_kernel(const BwdParams p) {
  extern __shared__ float smem[];
  float* Qs = smem;                    // [QB][D+1] q * scale * log2e
  float* dOs = Qs + QB * (D + 1);      // [QB][D+1]
  float* Ks = dOs + QB * (D + 1);      // [QK][D+1]
  float* Vs = Ks + QK * (D + 1);       // [QK][D+1]
  float* Ss = Vs + QK * (D + 1);       // [QB][QK+1] ds
  float* lse_s = Ss + QB * (QK + 1);   // [QB]
  float* delta_s = lse_s + QB;         // [QB]

  constexpr int DJ = D / 16;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int q0 = blockIdx.x * QB, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  const int q_len = p.lens[2 * b], kv_len = p.lens[2 * b + 1];
  const int q_valid = min(p.Sq, q_len - p.q_off);
  const int kv_valid = min(p.Sk, kv_len - p.kv_off);
  const T* kp = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vp = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;

  stage_q_side<T, D>(p, b, h, q0, q_valid, Qs, dOs, lse_s, delta_s);
  int lo, hi;
  kv_range(p, q0, q_len, kv_len, lo, hi);

  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  for (int k0 = (lo / QK) * QK; k0 < hi; k0 += QK) {
    __syncthreads();  // q side staged / previous tile fully consumed
    stage<T, D>(Ks, kp, p.k_ss, k0, QK, kv_valid, 1.f);
    stage<T, D>(Vs, vp, p.v_ss, k0, QK, kv_valid, 1.f);
    __syncthreads();
    float s[4][2], dp[4][2];
    qk_tile<D>(Qs, dOs, Ks, Vs, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        const bool keep = keep_at(q0 + r, k0 + c, p.Sq, p.Sk, p.q_off, p.kv_off, q_len, kv_len,
                                  p.causal, p.wl, p.wr);
        float pr, ds, ds_pre;
        grad_elem(p, s[i][j], dp[i][j], lse_s[r], delta_s[r],
                  bias_at(p, b, h, q0 + r, k0 + c, keep), keep, pr, ds, ds_pre);
        Ss[r * (QK + 1) + c] = ds;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < QK; ++c) {
      float dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = Ss[(ty + 16 * i) * (QK + 1) + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float kk = Ks[c * (D + 1) + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(dsv[i], kk, acc[i][j]);
      }
    }
  }

  T* dqp = static_cast<T*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= p.Sq) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j) dqp[r * p.dq_ss + tx + 16 * j] = from_f<T>(acc[i][j] * p.scale);
  }
}

template <int D>
constexpr int dkdv_smem_floats() {
  return 2 * KB * (D + 1) + 2 * KQ * (D + 1) + 2 * KB * (KQ + 1) + 2 * KQ;
}

// dk/dv: one block per (64-row KV tile, KV head, batch row); loops over the
// group's q heads and, for each, the q tiles that can see this KV tile.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS) dkdv_kernel(const BwdParams p) {
  extern __shared__ float smem[];
  float* Ks = smem;                    // [KB][D+1] k * scale * log2e
  float* Vs = Ks + KB * (D + 1);       // [KB][D+1]
  float* Qs = Vs + KB * (D + 1);       // [KQ][D+1]
  float* dOs = Qs + KQ * (D + 1);      // [KQ][D+1]
  float* Ps = dOs + KQ * (D + 1);      // [KB][KQ+1] p^T
  float* dSs = Ps + KB * (KQ + 1);     // [KB][KQ+1] ds^T
  float* lse_s = dSs + KB * (KQ + 1);  // [KQ]
  float* delta_s = lse_s + KQ;         // [KQ]

  constexpr int DJ = D / 16;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int k0 = blockIdx.x * KB, hk = blockIdx.y, b = blockIdx.z;
  const int group = p.Hq / p.Hkv;
  const int q_len = p.lens[2 * b], kv_len = p.lens[2 * b + 1];
  const int shift = kv_len - q_len;
  const int q_valid = min(p.Sq, q_len - p.q_off);
  const int kv_valid = min(p.Sk, kv_len - p.kv_off);

  stage<T, D>(Ks, static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh, p.k_ss, k0, KB,
              kv_valid, p.scale_log2);
  stage<T, D>(Vs, static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh, p.v_ss, k0, KB,
              kv_valid, 1.f);

  // Local q rows [r_lo, r_hi) that can see a live column of this tile.
  const int col_lo = p.kv_off + k0;
  const int col_hi = p.kv_off + min(k0 + KB, kv_valid) - 1;  // inclusive
  int r_lo = 0, r_hi = q_valid;
  if (p.causal) {
    r_lo = max(0, col_lo - shift - p.q_off);
  } else if (p.wr >= 0) {
    r_lo = max(0, col_lo - shift - p.wr - p.q_off);
  }
  if (p.wl >= 0) r_hi = min(r_hi, col_hi - shift + p.wl - p.q_off + 1);
  if (col_hi < col_lo) r_hi = 0;

  float dk_acc[4][DJ], dv_acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const T* qp = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
    const T* dop = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
    for (int r0 = (r_lo / KQ) * KQ; r0 < r_hi; r0 += KQ) {
      __syncthreads();  // K/V staged / previous q tile fully consumed
      stage<T, D>(Qs, qp, p.q_ss, r0, KQ, q_valid, 1.f);
      stage<T, D>(dOs, dop, p.do_ss, r0, KQ, q_valid, 1.f);
      for (int r = threadIdx.x; r < KQ; r += THREADS) {
        const long long i = ((long long)b * p.Hq + h) * p.Sq + r0 + r;
        const bool ok = r0 + r < q_valid;
        lse_s[r] = ok ? p.lse[i] : neg_inf();
        delta_s[r] = ok ? p.delta[i] : 0.f;
      }
      __syncthreads();

      // s^T and dp^T of the 64 x 32 (kv rows x q rows) tile: thread (tx,
      // ty) owns kv rows ty + 16 i and q rows tx + 16 j.
      float s[4][2], dp[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float a[4], w[4], c[2], o[2];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          a[i] = Ks[(ty + 16 * i) * (D + 1) + d];
          w[i] = Vs[(ty + 16 * i) * (D + 1) + d];
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          c[j] = Qs[(tx + 16 * j) * (D + 1) + d];
          o[j] = dOs[(tx + 16 * j) * (D + 1) + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            s[i][j] = fmaf(a[i], c[j], s[i][j]);
            dp[i][j] = fmaf(w[i], o[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int kr = ty + 16 * i, qr = tx + 16 * j;
          const bool keep = keep_at(r0 + qr, k0 + kr, p.Sq, p.Sk, p.q_off, p.kv_off, q_len,
                                    kv_len, p.causal, p.wl, p.wr);
          float pr, ds, ds_pre;
          grad_elem(p, s[i][j], dp[i][j], lse_s[qr], delta_s[qr],
                    bias_at(p, b, h, r0 + qr, k0 + kr, keep), keep, pr, ds, ds_pre);
          Ps[kr * (KQ + 1) + qr] = pr;
          dSs[kr * (KQ + 1) + qr] = ds;
        }
      }
      __syncthreads();
#pragma unroll 4
      for (int c = 0; c < KQ; ++c) {
        float pv[4], dsv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = Ps[(ty + 16 * i) * (KQ + 1) + c];
          dsv[i] = dSs[(ty + 16 * i) * (KQ + 1) + c];
        }
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          const float qq = Qs[c * (D + 1) + tx + 16 * j];
          const float oo = dOs[c * (D + 1) + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dk_acc[i][j] = fmaf(dsv[i], qq, dk_acc[i][j]);
            dv_acc[i][j] = fmaf(pv[i], oo, dv_acc[i][j]);
          }
        }
      }
    }
  }

  T* dkp = static_cast<T*>(p.dk) + b * p.dk_sb + hk * p.dk_sh;
  T* dvp = static_cast<T*>(p.dv) + b * p.dv_sb + hk * p.dv_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = k0 + ty + 16 * i;
    if (r >= p.Sk) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      dkp[r * p.dk_ss + tx + 16 * j] = from_f<T>(dk_acc[i][j] * p.scale);
      dvp[r * p.dv_ss + tx + 16 * j] = from_f<T>(dv_acc[i][j]);
    }
  }
}

template <int D>
constexpr int dbias_smem_floats() {
  return 2 * QB * (D + 1) + 2 * QK * (D + 1) + 2 * QB;
}

// dbias: one block per (64 x 32 bias tile, bias batch x head index). Loops
// over the batch rows and q heads that the bias broadcasts to (all of them
// on a broadcast dim, its own index otherwise) and sums ds_pre in registers.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS) dbias_kernel(const BwdParams p) {
  extern __shared__ float smem[];
  float* Qs = smem;                    // [QB][D+1] q * scale * log2e
  float* dOs = Qs + QB * (D + 1);      // [QB][D+1]
  float* Ks = dOs + QB * (D + 1);      // [QK][D+1]
  float* Vs = Ks + QK * (D + 1);       // [QK][D+1]
  float* lse_s = Vs + QK * (D + 1);    // [QB]
  float* delta_s = lse_s + QB;         // [QB]

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int q0 = blockIdx.x * QB, k0 = blockIdx.y * QK;
  const int bb = blockIdx.z / p.Hb, hb = blockIdx.z % p.Hb;
  const int b_lo = p.Bb == 1 ? 0 : bb, b_hi = p.Bb == 1 ? p.B : bb + 1;
  const int h_lo = p.Hb == 1 ? 0 : hb, h_hi = p.Hb == 1 ? p.Hq : hb + 1;

  float acc[4][2] = {{0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}};
  for (int b = b_lo; b < b_hi; ++b) {
    const int q_len = p.lens[2 * b], kv_len = p.lens[2 * b + 1];
    int lo, hi;
    kv_range(p, q0, q_len, kv_len, lo, hi);
    if (k0 >= hi || k0 + QK <= lo) continue;  // no live element for this row
    const int q_valid = min(p.Sq, q_len - p.q_off);
    const int kv_valid = min(p.Sk, kv_len - p.kv_off);
    for (int h = h_lo; h < h_hi; ++h) {
      const int hk = h / (p.Hq / p.Hkv);
      __syncthreads();  // previous (b, h) fully consumed
      stage_q_side<T, D>(p, b, h, q0, q_valid, Qs, dOs, lse_s, delta_s);
      stage<T, D>(Ks, static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh, p.k_ss, k0, QK,
                  kv_valid, 1.f);
      stage<T, D>(Vs, static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh, p.v_ss, k0, QK,
                  kv_valid, 1.f);
      __syncthreads();
      float s[4][2], dp[4][2];
      qk_tile<D>(Qs, dOs, Ks, Vs, s, dp);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int r = ty + 16 * i, c = tx + 16 * j;
          const bool keep = keep_at(q0 + r, k0 + c, p.Sq, p.Sk, p.q_off, p.kv_off, q_len,
                                    kv_len, p.causal, p.wl, p.wr);
          float pr, ds, ds_pre;
          grad_elem(p, s[i][j], dp[i][j], lse_s[r], delta_s[r],
                    bias_at(p, b, h, q0 + r, k0 + c, keep), keep, pr, ds, ds_pre);
          acc[i][j] += ds_pre;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = k0 + tx + 16 * j;
      if (r < p.Sq && c < p.Sk) {
        store_any(p.dbias, p.bias_dtype,
                  bb * p.dbias_sb + hb * p.dbias_sh + r * p.dbias_sq + c, acc[i][j]);
      }
    }
  }
}

enum Kernel : int { kDq = 0, kDkDv = 1, kDbias = 2 };

template <typename T, int D>
cudaError_t launch(const BwdParams& p, int which, cudaStream_t stream) {
  cudaError_t e;
  int smem;
  dim3 grid;
  switch (which) {
    case kDq:
      smem = dq_smem_floats<D>() * (int)sizeof(float);
      e = cudaFuncSetAttribute(dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return e;
      grid = dim3((p.Sq + QB - 1) / QB, p.Hq, p.B);
      dq_kernel<T, D><<<grid, THREADS, smem, stream>>>(p);
      break;
    case kDkDv:
      smem = dkdv_smem_floats<D>() * (int)sizeof(float);
      e = cudaFuncSetAttribute(dkdv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
      if (e != cudaSuccess) return e;
      grid = dim3((p.Sk + KB - 1) / KB, p.Hkv, p.B);
      dkdv_kernel<T, D><<<grid, THREADS, smem, stream>>>(p);
      break;
    case kDbias:
      smem = dbias_smem_floats<D>() * (int)sizeof(float);
      e = cudaFuncSetAttribute(dbias_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
      if (e != cudaSuccess) return e;
      grid = dim3((p.Sq + QB - 1) / QB, (p.Sk + QK - 1) / QK, p.Bb * p.Hb);
      dbias_kernel<T, D><<<grid, THREADS, smem, stream>>>(p);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const BwdParams& p, int which, int D, cudaStream_t stream) {
  switch (D) {
    case 64: return launch<T, 64>(p, which, stream);
    case 128: return launch<T, 128>(p, which, stream);
    case 256: return launch<T, 256>(p, which, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace fa2

// One entry for the three kernels (`which`: 0 dq, 1 dk/dv, 2 dbias).
// `strides` holds, in elements: q, k, v, do, dq, dk, dv (batch, head, row
// each), bias (batch, head, row, col; 0 on broadcast dims) and dbias (batch,
// head, row): 28 values.
extern "C" int fa2_flash_bwd(
    int which, int dtype, int B, int Hq, int Hkv, int Sq, int Sk, int D,
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta,
    const void* bias, int bias_dtype, int Bb, int Hb,
    void* dq, void* dk, void* dv, void* dbias,
    const int* lens, const long long* strides,
    int q_off, int kv_off, int causal, int wl, int wr,
    float softmax_scale, float softcap, void* stream) {
  fa2::BwdParams p;
  p.q = q; p.k = k; p.v = v; p.dout = dout; p.lse = lse; p.delta = delta;
  p.bias = bias; p.bias_dtype = bias_dtype;
  p.dq = dq; p.dk = dk; p.dv = dv; p.dbias = dbias; p.lens = lens;
  const long long* s = strides;
  p.q_sb = s[0]; p.q_sh = s[1]; p.q_ss = s[2];
  p.k_sb = s[3]; p.k_sh = s[4]; p.k_ss = s[5];
  p.v_sb = s[6]; p.v_sh = s[7]; p.v_ss = s[8];
  p.do_sb = s[9]; p.do_sh = s[10]; p.do_ss = s[11];
  p.dq_sb = s[12]; p.dq_sh = s[13]; p.dq_ss = s[14];
  p.dk_sb = s[15]; p.dk_sh = s[16]; p.dk_ss = s[17];
  p.dv_sb = s[18]; p.dv_sh = s[19]; p.dv_ss = s[20];
  p.bias_sb = s[21]; p.bias_sh = s[22]; p.bias_sq = s[23]; p.bias_sk = s[24];
  p.dbias_sb = s[25]; p.dbias_sh = s[26]; p.dbias_sq = s[27];
  p.B = B; p.Hq = Hq; p.Hkv = Hkv; p.Sq = Sq; p.Sk = Sk; p.Bb = Bb; p.Hb = Hb;
  p.q_off = q_off; p.kv_off = kv_off; p.causal = causal; p.wl = wl; p.wr = wr;
  p.scale = softmax_scale;
  p.scale_log2 = softmax_scale * fa2::LOG2E;
  p.softcap = softcap;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case fa2::kF32: return (int)fa2::launch_d<float>(p, which, D, st);
    case fa2::kF16: return (int)fa2::launch_d<__half>(p, which, D, st);
    case fa2::kBF16: return (int)fa2::launch_d<__nv_bfloat16>(p, which, D, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
