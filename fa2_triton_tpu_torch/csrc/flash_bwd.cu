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
// With dropout (flash_bwd.py:_recompute_p_and_ds, l.133-156) every kernel
// regenerates the forward's keep mask from the same counter (common.cuh:
// dropout_keep, the q head h and global row / column): dp becomes
// keep ? dp / (1 - p) : 0 in ds_pre, and dv's operand p becomes
// keep ? p / (1 - p) : 0; p itself stays undropped. Each kernel is built
// with and without dropout (the DROP template flag): without, the factor is
// the constant 1 and no hash code is compiled in.
// delta = rowsum(o * do) - dlse * log2e is computed by the wrapper. The
// softmax scale is folded as in B2 (flash_bwd.py:1586-1595): scale * log2e
// rides on the scores (the FMA kernels fold it into the staged fp32 q or k,
// the tensor-core kernels apply it to the fp32 score accumulator), and the
// ds * scale factor is applied once to the dq / dk accumulators, so v, do
// and delta stay unscaled and dp - delta cancels exactly.
//
// Region mode (`k_prescaled`, the split schedule's rectangles, B13 rect:
// fa2_triton_tpu/ops/flash_bwd.py:flash_attn_backward_rect l.1138, the TPU's
// _bwd_fused_kernel on a rectangle): the wrapper hands the dq and dk/dv
// kernels views of the region's rows and columns, with q_off / kv_off
// moved by the region's origin so masks and dropout counters stay global,
// causal off, k already multiplied by scale * log2e and delta the global
// one; then q and k are staged as given and dq = acc / log2e. A flag at
// run time, not a template: it only changes three factors per block.
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
// Bound on the H100: the dq and dk/dv kernels together do 7 S*S*D products
// per head (dk/dv: s, dp, dv, dk; dq: s, dp, dq), compute-bound at training
// lengths. Two designs, by input type:
//
// bf16 / fp16 inputs: mma.sync.m16n8k16 tiles with fp32 accumulation
// (mma_tiles.cuh), operands 16-bit in shared memory, the products' operands
// rounded to the input dtype as JAX rounds them (ds before ds k,
// flash_bwd.py:229; p and ds before p^T do and ds^T q, l.328, l.333).
//   * dq_mma_kernel has the forward's shape: 4 warps x 16 q rows of a 64-row
//     q tile, K / V tiles of 64 rows (32 at D 256) double-buffered by
//     cp.async; S = Q K^T and dP = dO V^T, ds per accumulator element, ds
//     repacked into A fragments in registers, dQ += dS K with K by
//     ldmatrix.trans; dQ stays in registers and goes out once, as 16-byte
//     stores.
//   * dkdv_mma_kernel has the fused kernels' shape without dQ: 8 warps own
//     MmaCfg::BKV kv rows and stream the group's q tiles through
//     bwd_mma.cuh's mma_q_step (S^T, dP^T, dV += P^T dO, dK += dS^T Q).
//   * The scale goes on the fp32 score accumulator (s_mul), not into a
//     rounded q or k. Bias and softcap live in their own instantiations
//     (EXTRA); a tile that every element keeps skips the mask test.
// fp32 inputs (no TF32): fp32 FMAs on the CUDA cores from shared-memory
// tiles (attn_tiles.cuh, shared with the forward and varlen kernels), each
// thread holding a 4x2 score tile and 4 x (D/16) accumulator columns in
// registers, shared rows padded by one float against bank conflicts, tiles
// beyond the causal / window / length limits never loaded. The dbias kernel
// stays on these FMA tiles for every input type.
#include "bwd_mma.cuh"

namespace fa2 {
namespace {

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
  float s_mul;       // the score's factor to log2 units: scale * log2(e), or 1 (region mode);
                     // folded into the staged q (FMA dq, dbias) or k (FMA dk/dv), applied to
                     // the fp32 score accumulator (tensor-core kernels)
  float dq_mul;      // dq = dq_mul * sum ds k: scale, or 1 / log2(e) (region mode)
  float softcap;     // natural units; 0 = off
  Dropout drop;
  int Sq_real, Sk_real;  // the dropout counter's lengths
  int tile_rows;         // the q rows of a dq block the host counts in
};

// The dropout factor of element (local row r, local column c) of (b, h): 1
// without dropout, 1 / (1 - p) where kept, 0 where dropped.
template <bool DROP>
__device__ __forceinline__ float drop_at(const BwdParams& p, int b, int h, int r, int c) {
  if constexpr (DROP) {
    return dropout_keep(p.drop.seed, p.drop.threshold, b, h, p.q_off + r, p.kv_off + c, p.Hq,
                        p.Sq_real, p.Sk_real)
               ? p.drop.scale
               : 0.f;
  } else {
    return 1.f;
  }
}

// p (times the dropout factor `drop`: dv's operand), ds and ds_pre of one
// score element (see the function above). s2 is the raw product
// q.k * scale * log2e.
__device__ __forceinline__ void grad_elem(const BwdParams& p, float s2, float dp, float lse,
                                          float delta, float bias, bool keep, float drop,
                                          float& pr, float& ds, float& ds_pre) {
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
  const float pu = keep ? exp2f(s2 - lse) : 0.f;
  ds_pre = keep ? pu * (dp * drop - delta) : 0.f;
  ds = p.softcap > 0.f ? ds_pre * (1.f - t * t) : ds_pre;
  pr = pu * drop;
}

__device__ __forceinline__ float bias_at(const BwdParams& p, int b, int h, int r, int c,
                                         bool keep) {
  if (p.bias == nullptr || !keep) return 0.f;
  return load_any(p.bias, p.bias_dtype,
                  b * p.bias_sb + h * p.bias_sh + r * p.bias_sq + c * p.bias_sk);
}

// Stage the q side of the dq / dbias kernels for (b, h) and the q tile at q0.
template <typename T, int D>
__device__ __forceinline__ void stage_q_side(const BwdParams& p, const DqSmem& s, int b, int h,
                                             int q0, int q_valid) {
  const long long row0 = ((long long)b * p.Hq + h) * p.Sq;
  dq_stage_q<T, D>(s, static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh, p.q_ss,
                   static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh, p.do_ss,
                   p.lse + row0, p.delta + row0, q0, q_valid, p.s_mul);
}

// dq: one block per (64-row q tile, q head, batch row); loops over the KV
// tiles up to the causal / window / length edge.
template <typename T, int D, bool DROP>
__global__ void __launch_bounds__(THREADS) dq_kernel(const BwdParams p) {
  extern __shared__ float smem[];
  const DqSmem s = dq_smem<D>(smem);
  const int q0 = blockIdx.x * TM, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  const int q_len = p.lens[2 * b], kv_len = p.lens[2 * b + 1];
  const int q_valid = min(p.Sq, q_len - p.q_off);
  const int kv_valid = min(p.Sk, kv_len - p.kv_off);
  const T* kp = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vp = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;

  stage_q_side<T, D>(p, s, b, h, q0, q_valid);
  const KeyRange kr = key_range(p, q0, TM, q_len, kv_len);

  float acc[4][D / 16];
  zero_acc<D>(acc);
  for (int k0 = (kr.lo / TN) * TN; k0 < kr.hi; k0 += TN) {
    auto ds_of = [&](int r, int c, float s2, float dp) {
      const bool keep = keep_at(q0 + r, k0 + c, p.Sq, p.Sk, p.q_off, p.kv_off, q_len, kv_len,
                                p.causal, p.wl, p.wr);
      float pr, ds, ds_pre;
      grad_elem(p, s2, dp, s.lse_s[r], s.delta_s[r], bias_at(p, b, h, q0 + r, k0 + c, keep),
                keep, drop_at<DROP>(p, b, h, q0 + r, k0 + c), pr, ds, ds_pre);
      return ds;
    };
    dq_kv_step<T, D>(s, kp, p.k_ss, vp, p.v_ss, k0, kv_valid, ds_of, acc);
  }
  store_tile<T, D>(acc, static_cast<T*>(p.dq) + b * p.dq_sb + h * p.dq_sh + q0 * p.dq_ss,
                   p.dq_ss, min(TM, p.Sq - q0), p.dq_mul);
}

// dk/dv: one block per (64-row KV tile, KV head, batch row); loops over the
// group's q heads and, for each, the q tiles that can see this KV tile.
template <typename T, int D, bool DROP>
__global__ void __launch_bounds__(THREADS) dkdv_kernel(const BwdParams p) {
  extern __shared__ float smem[];
  const DkdvSmem s = dkdv_smem<D>(smem);
  const int k0 = blockIdx.x * TM, hk = blockIdx.y, b = blockIdx.z;
  const int group = p.Hq / p.Hkv;
  const int q_len = p.lens[2 * b], kv_len = p.lens[2 * b + 1];
  const int shift = kv_len - q_len;
  const int q_valid = min(p.Sq, q_len - p.q_off);
  const int kv_valid = min(p.Sk, kv_len - p.kv_off);

  stage<T, D>(s.Ks, static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh, p.k_ss, k0, TM,
              kv_valid, p.s_mul);
  stage<T, D>(s.Vs, static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh, p.v_ss, k0, TM,
              kv_valid, 1.f);

  // Local q rows [r_lo, r_hi) that can see a live column of this tile.
  const int col_lo = p.kv_off + k0;
  const int col_hi = p.kv_off + min(k0 + TM, kv_valid) - 1;  // inclusive
  int r_lo = 0, r_hi = q_valid;
  if (p.causal) {
    r_lo = max(0, col_lo - shift - p.q_off);
  } else if (p.wr >= 0) {
    r_lo = max(0, col_lo - shift - p.wr - p.q_off);
  }
  if (p.wl >= 0) r_hi = min(r_hi, col_hi - shift + p.wl - p.q_off + 1);
  if (col_hi < col_lo) r_hi = 0;

  float dk_acc[4][D / 16], dv_acc[4][D / 16];
  zero_acc<D>(dk_acc);
  zero_acc<D>(dv_acc);
  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const long long row0 = ((long long)b * p.Hq + h) * p.Sq;
    const T* qp = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
    const T* dop = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
    for (int r0 = (r_lo / TN) * TN; r0 < r_hi; r0 += TN) {
      auto pds_of = [&](int kr, int qr, float s2, float dp, float& pr, float& ds) {
        const bool keep = keep_at(r0 + qr, k0 + kr, p.Sq, p.Sk, p.q_off, p.kv_off, q_len,
                                  kv_len, p.causal, p.wl, p.wr);
        float ds_pre;
        // h is the q head of this group member, r0 + qr the q row: the
        // forward's counter, not the kv head's or the kv tile's.
        grad_elem(p, s2, dp, s.lse_s[qr], s.delta_s[qr], bias_at(p, b, h, r0 + qr, k0 + kr, keep),
                  keep, drop_at<DROP>(p, b, h, r0 + qr, k0 + kr), pr, ds, ds_pre);
      };
      dkdv_q_step<T, D>(s, qp, p.q_ss, dop, p.do_ss, p.lse + row0, p.delta + row0, r0, q_valid,
                        pds_of, dk_acc, dv_acc);
    }
  }

  const int rows = min(TM, p.Sk - k0);
  store_tile<T, D>(dk_acc, static_cast<T*>(p.dk) + b * p.dk_sb + hk * p.dk_sh + k0 * p.dk_ss,
                   p.dk_ss, rows, p.scale);
  store_tile<T, D>(dv_acc, static_cast<T*>(p.dv) + b * p.dv_sb + hk * p.dv_sh + k0 * p.dv_ss,
                   p.dv_ss, rows, 1.f);
}

// dbias: one block per (64 x 32 bias tile, bias batch x head index). Loops
// over the batch rows and q heads that the bias broadcasts to (all of them
// on a broadcast dim, its own index otherwise) and sums ds_pre in registers.
// Shared memory is the dq kernel's layout (its ds tile unused).
template <typename T, int D, bool DROP>
__global__ void __launch_bounds__(THREADS) dbias_kernel(const BwdParams p) {
  extern __shared__ float smem[];
  const DqSmem s = dq_smem<D>(smem);

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int q0 = blockIdx.x * TM, k0 = blockIdx.y * TN;
  const int bb = blockIdx.z / p.Hb, hb = blockIdx.z % p.Hb;
  const int b_lo = p.Bb == 1 ? 0 : bb, b_hi = p.Bb == 1 ? p.B : bb + 1;
  const int h_lo = p.Hb == 1 ? 0 : hb, h_hi = p.Hb == 1 ? p.Hq : hb + 1;

  float acc[4][2] = {{0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}};
  for (int b = b_lo; b < b_hi; ++b) {
    const int q_len = p.lens[2 * b], kv_len = p.lens[2 * b + 1];
    const KeyRange kr = key_range(p, q0, TM, q_len, kv_len);
    if (k0 >= kr.hi || k0 + TN <= kr.lo) continue;  // no live element for this row
    const int q_valid = min(p.Sq, q_len - p.q_off);
    const int kv_valid = min(p.Sk, kv_len - p.kv_off);
    for (int h = h_lo; h < h_hi; ++h) {
      const int hk = h / (p.Hq / p.Hkv);
      __syncthreads();  // previous (b, h) fully consumed
      stage_q_side<T, D>(p, s, b, h, q0, q_valid);
      stage<T, D>(s.Ks, static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh, p.k_ss, k0, TN,
                  kv_valid, 1.f);
      stage<T, D>(s.Vs, static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh, p.v_ss, k0, TN,
                  kv_valid, 1.f);
      __syncthreads();
      float sc[4][2], dp[4][2];
      dot_tile2<D>(s.Qs, s.Ks, s.dOs, s.Vs, sc, dp);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int r = ty + 16 * i, c = tx + 16 * j;
          const bool keep = keep_at(q0 + r, k0 + c, p.Sq, p.Sk, p.q_off, p.kv_off, q_len,
                                    kv_len, p.causal, p.wl, p.wr);
          float pr, ds, ds_pre;
          grad_elem(p, sc[i][j], dp[i][j], s.lse_s[r], s.delta_s[r],
                    bias_at(p, b, h, q0 + r, k0 + c, keep), keep,
                    drop_at<DROP>(p, b, h, q0 + r, k0 + c), pr, ds, ds_pre);
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

// ---- 16-bit inputs: tensor-core tiles ---------------------------------------

// The element rule of the tensor-core kernels at (local row r, column c) of
// (b, h): s comes in as the raw score accumulator (q . k) and leaves as dv's
// operand p, dp comes in as do . v and leaves as ds. The score is scaled to
// log2 units on the fp32 accumulator (s_mul), never folded into a rounded q
// or k. Without EXTRA, grad_plain (grad_elem without bias and softcap) and
// no mask test on a `free_tile`; with EXTRA, grad_elem.
template <bool DROP, bool EXTRA>
__device__ __forceinline__ void pair_elem(const BwdParams& p, int b, int h, int r, int c,
                                          int q_len, int kv_len, bool free_tile, float lse,
                                          float delta, float& s, float& dp) {
  const bool keep = free_tile || keep_at(r, c, p.Sq, p.Sk, p.q_off, p.kv_off, q_len, kv_len,
                                         p.causal, p.wl, p.wr);
  const float drop = drop_at<DROP>(p, b, h, r, c);
  float pr, ds;
  if constexpr (EXTRA) {
    float ds_pre;
    grad_elem(p, s * p.s_mul, dp, lse, delta, bias_at(p, b, h, r, c, keep), keep, drop, pr, ds,
              ds_pre);
  } else {
    grad_plain(s * p.s_mul, dp, lse, delta, keep, drop, pr, ds);
  }
  s = pr;
  dp = ds;
}

// dq, 16-bit inputs: one block of 4 warps per (64-row q tile, q head, batch
// row), on bwd_mma.cuh's dq tiles (DqMmaCfg: Q and dO staged once, K / V
// tiles double-buffered, zero past kv_valid).
template <typename T, int D, bool DROP, bool EXTRA>
__global__ void __launch_bounds__(DqMmaCfg<D>::NW * 32) dq_mma_kernel(const BwdParams p) {
  using C = DqMmaCfg<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);  // [BQ][P]
  T* dOs = Qs + C::BQ * C::P;              // [BQ][P]
  T* kv_s = dOs + C::BQ * C::P;            // buffer j: K at 2 j BKV rows, V BKV rows on
  const int h = blockIdx.x % p.Hq, b = blockIdx.x / p.Hq;
  const int q0 = (p.causal ? (int)(gridDim.y - 1 - blockIdx.y) : (int)blockIdx.y) * C::BQ;
  const int hk = h / (p.Hq / p.Hkv);
  const int q_len = p.lens[2 * b], kv_len = p.lens[2 * b + 1];
  const int q_valid = min(p.Sq, q_len - p.q_off);
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32, g = lane / 4;

  const T* kp = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vp = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  const KeyRange kr = key_range(p, q0, C::BQ, q_len, kv_len);
  const int k_begin = (kr.lo / C::BKV) * C::BKV;
  const int n_tiles = kr.hi > k_begin ? (kr.hi - k_begin + C::BKV - 1) / C::BKV : 0;

  // lse and delta of rows g and g + 8 of the warp's 16; rows past q_valid
  // get lse = -inf, so a mask-free tile gives them p = ds = 0.
  float lse[2], delta[2];
  const long long row0 = ((long long)b * p.Hq + h) * p.Sq + q0;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = w * 16 + g + 8 * hr;
    const bool ok = q0 + r < q_valid;
    lse[hr] = ok ? p.lse[row0 + r] : neg_inf();
    delta[hr] = ok ? p.delta[row0 + r] : 0.f;
  }
  float dq[C::NT_D][4];
#pragma unroll
  for (int n = 0; n < C::NT_D; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;

  auto load = [&](int i, T* K, T* V) {
    cp_rows<C>(K, kp, p.k_ss, k_begin + i * C::BKV, C::BKV, kr.kv_valid);
    cp_rows<C>(V, vp, p.v_ss, k_begin + i * C::BKV, C::BKV, kr.kv_valid);
  };
  if (n_tiles > 0) {
    cp_rows<C>(Qs, static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh, p.q_ss, q0, C::BQ,
               q_valid);
    cp_rows<C>(dOs, static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh, p.do_ss, q0,
               C::BQ, q_valid);
    load(0, kv_s, kv_s + C::BKV * C::P);
    cp_async_commit();
  }
  dq_kv_loop<C, T>(kv_s, n_tiles, load, [&](int i, const T* Ks, const T* Vs) {
    const int k0 = k_begin + i * C::BKV;
    const bool free_tile = !EXTRA && k0 >= kr.free_lo && k0 + C::BKV <= kr.free_hi;
    auto elem = [&](int r, int c, int hr, float& sc, float& dp) {
      pair_elem<DROP, EXTRA>(p, b, h, q0 + r, k0 + c, q_len, kv_len, free_tile, lse[hr],
                             delta[hr], sc, dp);
    };
    dq_mma_tile<C, T>(Qs, dOs, Ks, Vs, elem, dq);
  });
  dq_mma_store<C, T>(dq, Qs, static_cast<T*>(p.dq) + b * p.dq_sb + h * p.dq_sh + q0 * p.dq_ss,
                     p.dq_ss, p.Sq - q0, p.dq_mul);
}

// dk/dv, 16-bit inputs: one block of 8 warps per (MmaCfg::BKV kv rows, kv
// head, batch row) walks every q tile of every q head of the GQA group that
// can see them (dkdv_kernel's rows), with bwd_mma.cuh's tiles: dK and dV
// stay in registers, q / dO / lse / delta tiles are double-buffered, and no
// dS^T is kept (the dq kernel computes dQ).
template <typename T, int D, bool DROP, bool EXTRA>
__global__ void __launch_bounds__(THREADS, 1) dkdv_mma_kernel(const BwdParams p) {
  using C = MmaCfg<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const MmaSmem<T> s = mma_smem<C, T>(smem_raw);
  const int hk = blockIdx.x % p.Hkv, b = blockIdx.x / p.Hkv, k0 = blockIdx.y * C::BKV;
  const int group = p.Hq / p.Hkv;
  const int q_len = p.lens[2 * b], kv_len = p.lens[2 * b + 1];
  const int shift = kv_len - q_len;
  const int q_valid = min(p.Sq, q_len - p.q_off);
  const int kv_valid = min(p.Sk, kv_len - p.kv_off);

  // Local q rows [r_lo, r_hi) that can see a live column of this tile, and
  // whether every element of a q tile [r0, r0 + BQ) inside them is kept.
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
  const int total = group * nqt;
  float dk[C::NT_KV][4], dv[C::NT_KV][4];
  mma_zero_kv<C>(dk, dv);
  if (total > 0) {
    cp_rows<C>(s.K, static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh, p.k_ss, k0, C::BKV,
               kv_valid);
    cp_rows<C>(s.V, static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh, p.v_ss, k0, C::BKV,
               kv_valid);
    auto issue = [&](int i) {
      const int h = hk * group + i / nqt, r0 = ra + (i % nqt) * C::BQ;
      const long long row0 = ((long long)b * p.Hq + h) * p.Sq;
      mma_load_q<C, T>(p, s, i & 1, b, h, r0, q_valid, p.lse + row0, p.delta + row0);
    };
    mma_q_loop(total, issue, [&](int i) {
      const int h = hk * group + i / nqt, r0 = ra + (i % nqt) * C::BQ;
      const bool free_tile = all_kept(r0);
      // h is the q head of this group member, r0 + qr the q row: the
      // forward's counter and the bias's (row, column), at the transposed
      // accumulator position.
      auto elem = [&](int kr, int qr, float lse, float delta, float& sc, float& dp) {
        pair_elem<DROP, EXTRA>(p, b, h, r0 + qr, k0 + kr, q_len, kv_len, free_tile, lse, delta,
                               sc, dp);
      };
      mma_q_step<C, T, false>(s, i & 1, elem, dk, dv);
    });
  }
  const int rows = min(C::BKV, p.Sk - k0);
  mma_store_kv<C, T>(dk, static_cast<T*>(p.dk) + b * p.dk_sb + hk * p.dk_sh + k0 * p.dk_ss,
                     p.dk_ss, rows, p.scale);
  mma_store_kv<C, T>(dv, static_cast<T*>(p.dv) + b * p.dv_sb + hk * p.dv_sh + k0 * p.dv_ss,
                     p.dv_ss, rows, 1.f);
}

enum Kernel : int { kDq = 0, kDkDv = 1, kDbias = 2 };

// fp32 inputs: the FMA dq (`which` 0) or dk/dv (1) kernel.
template <int D, bool DROP>
cudaError_t launch_fma(const BwdParams& p, int which, cudaStream_t stream) {
  const int smem =
      (which == kDq ? dq_smem_floats<D>() : dkdv_smem_floats<D>()) * (int)sizeof(float);
  cudaError_t e;
  if (which == kDq) {
    e = cudaFuncSetAttribute(dq_kernel<float, D, DROP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    dq_kernel<float, D, DROP><<<dim3((p.Sq + TM - 1) / TM, p.Hq, p.B), THREADS, smem, stream>>>(p);
  } else {
    e = cudaFuncSetAttribute(dkdv_kernel<float, D, DROP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    dkdv_kernel<float, D, DROP>
        <<<dim3((p.Sk + TM - 1) / TM, p.Hkv, p.B), THREADS, smem, stream>>>(p);
  }
  return cudaGetLastError();
}

// Every input type: the dbias kernel (FMA tiles).
template <typename T, int D, bool DROP>
cudaError_t launch_dbias(const BwdParams& p, cudaStream_t stream) {
  const int smem = dq_smem_floats<D>() * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(dbias_kernel<T, D, DROP>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.Sq + TM - 1) / TM, (p.Sk + TN - 1) / TN, p.Bb * p.Hb);
  dbias_kernel<T, D, DROP><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// The tensor-core dq and dk/dv kernels. Grid x runs over (head, batch row),
// y over the tiles, longest first under causal masks (the dq kernel's last q
// tiles, the dk/dv kernel's first kv tiles), so the short ones fill the tail.
template <typename T, int D, bool DROP, bool EXTRA>
cudaError_t launch_mma(const BwdParams& p, int which, cudaStream_t stream) {
  cudaError_t e;
  if (which == kDq) {
    using C = DqMmaCfg<D>;
    e = cudaFuncSetAttribute(dq_mma_kernel<T, D, DROP, EXTRA>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM_BYTES);
    if (e != cudaSuccess) return e;
    dq_mma_kernel<T, D, DROP, EXTRA><<<dim3(p.Hq * p.B, (p.Sq + C::BQ - 1) / C::BQ), C::NW * 32,
                                       C::SMEM_BYTES, stream>>>(p);
  } else {
    using C = MmaCfg<D>;
    e = cudaFuncSetAttribute(dkdv_mma_kernel<T, D, DROP, EXTRA>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM_BYTES);
    if (e != cudaSuccess) return e;
    dkdv_mma_kernel<T, D, DROP, EXTRA><<<dim3(p.Hkv * p.B, (p.Sk + C::BKV - 1) / C::BKV), THREADS,
                                         C::SMEM_BYTES, stream>>>(p);
  }
  return cudaGetLastError();
}

// fp32 inputs take the FMA dq and dk/dv kernels; bf16 / fp16 the tensor-core
// ones (no path back to the FMA ones). dbias is the FMA kernel for both.
template <typename T, int D, bool DROP>
cudaError_t launch_kernel(const BwdParams& p, int which, cudaStream_t stream) {
  // The host counts q tiles (TILE_ROWS) in the dq kernels' rows (TM, DqMmaCfg::BQ).
  if (p.tile_rows != TM || (which != kDq && which != kDkDv && which != kDbias)) {
    return cudaErrorInvalidValue;
  }
  if (which == kDbias) return launch_dbias<T, D, DROP>(p, stream);
  if constexpr (std::is_same<T, float>::value) {
    return launch_fma<D, DROP>(p, which, stream);
  } else {
    return p.bias != nullptr || p.softcap > 0.f ? launch_mma<T, D, DROP, true>(p, which, stream)
                                                : launch_mma<T, D, DROP, false>(p, which, stream);
  }
}

template <typename T, int D>
cudaError_t launch(const BwdParams& p, int which, cudaStream_t stream) {
  return p.drop.on ? launch_kernel<T, D, true>(p, which, stream)
                   : launch_kernel<T, D, false>(p, which, stream);
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
// head, row): 28 values. `k_prescaled` is the region mode (k * scale * log2e
// given; no bias, no softcap). `tile_rows`: the q rows of a dq block the
// host counts in (ops/flash_fwd.py TILE_ROWS); the call fails unless it is
// the kernels' (64). 16-bit q / k / v / do: rows, strides and base pointers
// 16-byte aligned.
extern "C" int fa2_flash_bwd(
    int which, int dtype, int B, int Hq, int Hkv, int Sq, int Sk, int D,
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta,
    const void* bias, int bias_dtype, int Bb, int Hb,
    void* dq, void* dk, void* dv, void* dbias,
    const int* lens, const long long* strides,
    int q_off, int kv_off, int causal, int wl, int wr,
    float softmax_scale, float softcap,
    int dropout, unsigned int drop_seed, unsigned int drop_threshold, float drop_scale,
    int Sq_real, int Sk_real, int k_prescaled, int tile_rows, void* stream) {
  if (k_prescaled && (bias != nullptr || softcap > 0.f || which == 2)) {
    return (int)cudaErrorInvalidValue;
  }
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
  p.s_mul = k_prescaled ? 1.f : softmax_scale * fa2::LOG2E;
  p.dq_mul = k_prescaled ? 1.f / fa2::LOG2E : softmax_scale;
  p.softcap = softcap;
  p.drop.on = dropout; p.drop.seed = drop_seed; p.drop.threshold = drop_threshold;
  p.drop.scale = drop_scale;
  p.Sq_real = Sq_real; p.Sk_real = Sk_real;
  p.tile_rows = tile_rows;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case fa2::kF32: return (int)fa2::launch_d<float>(p, which, D, st);
    case fa2::kF16: return (int)fa2::launch_d<__half>(p, which, D, st);
    case fa2::kBF16: return (int)fa2::launch_d<__nv_bfloat16>(p, which, D, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
