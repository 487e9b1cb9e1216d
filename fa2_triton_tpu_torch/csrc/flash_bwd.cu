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
// lengths. The dbias kernel does 2 (s, dp) per reduced (b, h) and writes the
// whole [Bb, Hb, Sq, Sk] gradient: bound by bytes (the write, and the bias
// read); on the card its short steps leave it bound by instruction issue
// and ldmatrix traffic (the dbias section below). Two designs, by input
// type:
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
//   * dbias_mma_kernel owns dbias tiles of 64 q rows x 64 keys (32 at D
//     256) for one (bias batch, bias head), 16 warps at D 64 / 128 (8 at D
//     256) each on 16 rows x a quarter (half) of the keys (bwd_mma.cuh's
//     sdp_mma_tile, the dq kernels' S / dP half):
//     persistent blocks walk their tiles' reduced (b, h) steps as one
//     cp.async stream, double-buffered, the next step's tiles (and the next
//     tile's bias) landing during this step's products; ds_pre is summed
//     unrounded in fp32 registers; the bias tile comes in, and the dbias
//     tile goes out, as 16-byte chunks through shared memory.
//   * The scale goes on the fp32 score accumulator (s_mul), not into a
//     rounded q or k. Bias and softcap live in their own instantiations
//     (EXTRA); a tile that every element keeps skips the mask test.
// fp32 inputs (no TF32): fp32 FMAs on the CUDA cores from shared-memory
// tiles (attn_tiles.cuh, shared with the forward and varlen kernels), each
// thread holding a 4x2 score tile and 4 x (D/16) accumulator columns in
// registers, shared rows padded by one float against bank conflicts, tiles
// beyond the causal / window / length limits never loaded (dq_kernel,
// dkdv_kernel, dbias_kernel).
#include <algorithm>
#include <climits>

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

// dbias, fp32 inputs: one block per (64 x 32 bias tile, bias batch x head
// index). Loops over the batch rows and q heads that the bias broadcasts to
// (all of them on a broadcast dim, its own index otherwise) and sums ds_pre
// in registers. Shared memory is the dq kernel's layout (its ds tile
// unused).
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

// ---- dbias, 16-bit inputs ---------------------------------------------------
//
// A block owns a dbias tile of BQ = 64 q rows x BKV keys (64, 32 at D 256);
// warp w computes rows 16 (w % 4) and keys WK (w / 4) of it (sdp_mma_tile).
// The step is short (two 64 x 64 x D products), so what bounds it on the
// H100 is issue and latency, not the tensor cores: 16 warps at D <= 128 (4
// per SM sub-partition), the chunks a thread copies fixed at compile time, the
// tile decode by multiply and shift, the bias read once a tile, the mask a
// column span per row. Shared memory:
// Q, dO, K, V ([2][rows][P], 16-bit) and lse, delta, double-buffered by step;
// the bias tile as it arrives and the dbias tile on its way out ([BQ][BT]
// bytes each, in the bias's dtype). A bias or dbias row is kept as the
// 16-byte aligned chunks that cover it in device memory (`row_shift`: its
// address mod 16), so rows of any alignment move as 16-byte copies (S 2047
// rows are 4094 bytes); a chunk past the row's ends is never touched, and
// its bytes in shared memory are never read as values of kept elements.
template <int D_>
struct DbiasMmaCfg {
  static constexpr int D = D_;
  static constexpr int BQ = 64;                   // q rows of a tile
  static constexpr int BKV = D <= 128 ? 64 : 32;  // keys of a tile
  static constexpr int NW = D <= 128 ? 16 : 8;    // warps: 4 along the rows x NW / 4 along the keys
  static constexpr int WK = BKV / (NW / 4);       // keys of a warp
  static constexpr int NT = WK / 8;               // its n-tiles
  static constexpr int P = D + 8;                 // operand row pitch, elements
  static constexpr int BT = BKV * 4 + 16;         // bias / dbias row pitch, bytes: fp32 + a shift
  static constexpr int SMEM_BYTES = 2 * (2 * BQ + 2 * BKV) * P * 2 + 2 * BQ * BT + 4 * BQ * 4;
  static_assert(NT % 2 == 0, "sdp_mma_tile takes n-tiles in pairs");
};

// n / d for 0 <= n < 2^31 by a multiply and a shift, d >= 1 fixed for the
// kernel (Granlund and Montgomery's round-up method, as CUTLASS's
// FastDivmod): the tile decode runs several times a tile, and a division by
// a run-time int is a long chain of dependent instructions.
struct FastDiv {
  int d;
  uint32_t m, s;
  __device__ explicit FastDiv(int d_) : d(d_), m(0), s(0) {
    if (d > 1) {
      const int l = 32 - __clz(d - 1);  // ceil(log2 d)
      m = (uint32_t)(((1ull << (31 + l)) + d - 1) / d);
      s = l - 1;
    }
  }
  __device__ int div(int n) const { return d > 1 ? (int)(__umulhi((uint32_t)n, m) >> s) : n; }
};

// The dbias tiles of a launch: index t = ((bb * Hb + hb) * nq + q tile) * nk
// + kv tile.
struct DbGrid {
  int n_tiles;
  FastDiv nk, nqk, hb;  // kv tiles; q x kv tiles; Hb
};

template <class C>
__device__ __forceinline__ DbGrid db_grid(const BwdParams& p) {
  const int nq = (p.Sq + C::BQ - 1) / C::BQ, nk = (p.Sk + C::BKV - 1) / C::BKV;
  return {nq * nk * p.Bb * p.Hb, FastDiv(nk), FastDiv(nq * nk), FastDiv(p.Hb)};
}

// A dbias tile, and the batch rows / q heads it sums over (all of them on a
// broadcast dim).
struct DbTile {
  int q0, k0, bb, hb, b_lo, b_hi, h_lo, h_hi;
};

template <class C>
__device__ __forceinline__ DbTile db_tile(const BwdParams& p, const DbGrid& g, int t) {
  const int z = g.nqk.div(t), qk = t - z * g.nqk.d, qt = g.nk.div(qk);
  DbTile d;
  d.k0 = (qk - qt * g.nk.d) * C::BKV;
  d.q0 = qt * C::BQ;
  d.bb = g.hb.div(z);
  d.hb = z - d.bb * p.Hb;
  d.b_lo = p.Bb == 1 ? 0 : d.bb;
  d.b_hi = p.Bb == 1 ? p.B : d.bb + 1;
  d.h_lo = p.Hb == 1 ? 0 : d.hb;
  d.h_hi = p.Hb == 1 ? p.Hq : d.hb + 1;
  return d;
}

// One reduced step (b, h) of tile t; t >= the tile count: none left.
struct DbStep {
  int t, b, h;
};

// The first step at or after batch row b_from (b_lo when < 0) of tile t, or
// of the block's later tiles t + k gridDim.x, whose batch row keeps an
// element of the tile (dbias_kernel's skip: key_range of its lengths).
template <class C>
__device__ __forceinline__ DbStep db_seek(const BwdParams& p, const DbGrid& g, int t, int b_from) {
  for (; t < g.n_tiles; t += gridDim.x, b_from = -1) {
    const DbTile d = db_tile<C>(p, g, t);
    for (int b = b_from < 0 ? d.b_lo : b_from; b < d.b_hi; ++b) {
      const KeyRange kr = key_range(p, d.q0, C::BQ, p.lens[2 * b], p.lens[2 * b + 1]);
      if (d.k0 < kr.hi && d.k0 + C::BKV > kr.lo) return {t, b, d.h_lo};
    }
  }
  return {t, 0, 0};
}

// The step after s (of tile d): the next q head (h inner), else the next
// live batch row.
template <class C>
__device__ __forceinline__ DbStep db_next(const BwdParams& p, const DbGrid& g, DbStep s,
                                          const DbTile& d) {
  if (s.h + 1 < d.h_hi) return {s.t, s.b, s.h + 1};
  return db_seek<C>(p, g, s.t, s.b + 1);
}

__device__ __forceinline__ int dtype_bytes(int dtype) { return dtype == kF32 ? 4 : 2; }

__device__ __forceinline__ int row_shift(const void* row) {
  return static_cast<int>(reinterpret_cast<uintptr_t>(row) & 15);
}

// Element (tile row 0, tile key 0) of d's bias.
__device__ __forceinline__ const char* db_bias_base(const BwdParams& p, const DbTile& d) {
  return static_cast<const char*>(p.bias) +
         ((long long)d.bb * p.bias_sb + (long long)d.hb * p.bias_sh + (long long)d.q0 * p.bias_sq +
          (long long)d.k0 * p.bias_sk) * dtype_bytes(p.bias_dtype);
}

// The bias tile of d into `dst` (not committed), a warp per row: 16-byte
// cp.async chunks (lane j the row's j-th) where the bias's last dim is
// contiguous, else element loads (a broadcast or strided last dim). Rows
// past Sq and chunks past Sk are not read.
template <class C>
__device__ __forceinline__ void db_load_bias(const BwdParams& p, const DbTile& d,
                                             unsigned char* dst) {
  const int lane = threadIdx.x % 32, es = dtype_bytes(p.bias_dtype);
  const int rows = min(C::BQ, p.Sq - d.q0), ncols = min(C::BKV, p.Sk - d.k0);
  const long long pitch = p.bias_sq * es, col = p.bias_sk * es;
  const char* row = db_bias_base(p, d) + (threadIdx.x / 32) * pitch;
  unsigned char* to = dst + (threadIdx.x / 32) * C::BT;
  for (int r = threadIdx.x / 32; r < rows; r += C::NW, row += C::NW * pitch, to += C::NW * C::BT) {
    if (p.bias_sk == 1) {
      const int sh = row_shift(row);
      if (16 * lane < sh + ncols * es) cp_async16(to + 16 * lane, row - sh + 16 * lane, true);
      continue;
    }
    for (int c = lane; c < ncols; c += 32) {
      const char* src = row + c * col;
      if (es == 4) {
        *reinterpret_cast<uint32_t*>(to + 4 * c) = *reinterpret_cast<const uint32_t*>(src);
      } else {
        *reinterpret_cast<uint16_t*>(to + 2 * c) = *reinterpret_cast<const uint16_t*>(src);
      }
    }
  }
}

// Row r of d's dbias tile in device memory.
__device__ __forceinline__ char* db_out_row(const BwdParams& p, const DbTile& d, int r) {
  const long long at = (long long)d.bb * p.dbias_sb + (long long)d.hb * p.dbias_sh +
                       (long long)(d.q0 + r) * p.dbias_sq + d.k0;
  return static_cast<char*>(p.dbias) + at * dtype_bytes(p.bias_dtype);
}

// d's dbias tile out to device memory, a warp per row: from `stage` (rows
// laid out at their row_shift) or zeros (stage == nullptr). Of a row's
// bytes, the aligned 16-byte chunks inside it go out one per lane, and the
// elements before and after them one per lane.
template <class C>
__device__ __forceinline__ void db_store(const BwdParams& p, const DbTile& d,
                                         const unsigned char* stage) {
  const int lane = threadIdx.x % 32, es = dtype_bytes(p.bias_dtype), lg = es == 4 ? 2 : 1;
  const int rows = min(C::BQ, p.Sq - d.q0), nbytes = min(C::BKV, p.Sk - d.k0) * es;
  const long long pitch = p.dbias_sq * es;
  char* row = db_out_row(p, d, threadIdx.x / 32);
  for (int r = threadIdx.x / 32; r < rows; r += C::NW, row += C::NW * pitch) {
    const int sh = row_shift(row);
    const int head = min((16 - sh) & 15, nbytes);  // bytes before the first aligned chunk
    const int nfull = (nbytes - head) >> 4, tail = nbytes - head - (nfull << 4);
    const unsigned char* src = stage + r * C::BT + sh;  // row byte x at src[x]
    if (lane < nfull) {
      const int at = head + 16 * lane;
      *reinterpret_cast<uint4*>(row + at) =
          stage ? *reinterpret_cast<const uint4*>(src + at) : make_uint4(0u, 0u, 0u, 0u);
      continue;
    }
    // The head's elements, then the tail's past the full chunks.
    const int k = lane - nfull;
    if (k >= (head + tail) >> lg) continue;
    const int x = k < (head >> lg) ? k << lg : (nfull << 4) + (k << lg);
    if (es == 4) {
      *reinterpret_cast<uint32_t*>(row + x) =
          stage ? *reinterpret_cast<const uint32_t*>(src + x) : 0u;
    } else {
      *reinterpret_cast<uint16_t*>(row + x) =
          stage ? *reinterpret_cast<const uint16_t*>(src + x) : uint16_t(0);
    }
  }
}

// Rows [row0, row0 + ROWS) of a [*, D] operand (row stride ss) into dst
// (pitch C::P) by the block's C::NW warps, rows at or past `valid` zero: as
// cp_rows copies them, but each thread's chunks are fixed at compile time
// (a column and rows RS apart), so a copy costs one 64-bit add, not a row
// address of its own; at a run-time trip count cp_rows' loop compiled to
// over a thousand instructions a step.
template <class C, int ROWS, typename T>
__device__ __forceinline__ void db_rows(T* dst, const T* src, long long ss, int row0, int valid) {
  constexpr int CH = C::D / 8, NT = C::NW * 32, RS = NT / CH, K = ROWS * CH / NT;
  static_assert(NT % CH == 0 && ROWS * CH % NT == 0, "chunks per thread");
  const int r = threadIdx.x / CH, c = (threadIdx.x % CH) * 8;
  const T* from = src + (long long)(row0 + r) * ss + c;
#pragma unroll
  for (int k = 0; k < K; ++k, from += RS * ss) {
    const bool ok = row0 + r + k * RS < valid;
    cp_async16(dst + (r + k * RS) * C::P + c, ok ? from : src, ok);
  }
}

// f(B()) with B the C++ type of dtype code `dtype` (the bias's).
template <class F>
__device__ __forceinline__ void with_dtype(int dtype, const F& f) {
  if (dtype == kF32) {
    f(0.f);
  } else if (dtype == kBF16) {
    f(__nv_bfloat16());
  } else {
    f(__half());
  }
}

// dbias, 16-bit inputs: persistent blocks; block i owns the tiles i,
// i + gridDim.x, ... and walks their reduced (b, h) steps in dbias_kernel's
// order (b outer, h inner; a batch row that keeps nothing of the tile is
// skipped) as one stream: each step waits for its own copies, then issues
// the next step's Q / dO / K / V / lse / delta (and the next tile's bias),
// which land while this step's S = Q K^T and dP = dO V^T run on mma.sync.
// The bias of a tile is read into registers once, at its first step; the
// mask is a column span per row (keep_span). ds_pre (grad_elem, unrounded)
// is summed in fp32 in the accumulator layout, in the fixed step order: no
// atomics, no second pass. A tile no step keeps is stored as zeros, and
// loads nothing.
template <typename T, int D, bool DROP>
__global__ void __launch_bounds__(DbiasMmaCfg<D>::NW * 32, 1) dbias_mma_kernel(const BwdParams p) {
  using C = DbiasMmaCfg<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qb = reinterpret_cast<T*>(smem_raw);  // [2][BQ][P]
  T* dOb = Qb + 2 * C::BQ * C::P;          // [2][BQ][P]
  T* Kb = dOb + 2 * C::BQ * C::P;          // [2][BKV][P]
  T* Vb = Kb + 2 * C::BKV * C::P;          // [2][BKV][P]
  unsigned char* bias_in = reinterpret_cast<unsigned char*>(Vb + 2 * C::BKV * C::P);  // [BQ][BT]
  unsigned char* out_s = bias_in + C::BQ * C::BT;                                      // [BQ][BT]
  float* lse_s = reinterpret_cast<float*>(out_s + C::BQ * C::BT);                      // [2][BQ]
  float* delta_s = lse_s + 2 * C::BQ;                                                  // [2][BQ]

  const int lane = threadIdx.x % 32, w = threadIdx.x / 32, g = lane / 4, tq = lane % 4;
  const int wq = (w % 4) * 16, wk = (w / 4) * C::WK;  // the warp's first row and key in the tile
  const DbGrid grid = db_grid<C>(p);
  const int group = p.Hq / p.Hkv;

  // Step st's copies (of tile d) into operand buffer `buf`, and the tile's
  // bias into bias_in when it is the tile's first step.
  auto issue = [&](const DbStep& st, const DbTile& d, int buf, bool bias) {
    const int q_valid = min(p.Sq, p.lens[2 * st.b] - p.q_off);
    const int kv_valid = min(p.Sk, p.lens[2 * st.b + 1] - p.kv_off);
    const int hk = st.h / group;
    db_rows<C, C::BQ>(Qb + buf * C::BQ * C::P,
                      static_cast<const T*>(p.q) + st.b * p.q_sb + st.h * p.q_sh, p.q_ss, d.q0,
                      q_valid);
    db_rows<C, C::BQ>(dOb + buf * C::BQ * C::P,
                      static_cast<const T*>(p.dout) + st.b * p.do_sb + st.h * p.do_sh, p.do_ss,
                      d.q0, q_valid);
    db_rows<C, C::BKV>(Kb + buf * C::BKV * C::P,
                       static_cast<const T*>(p.k) + st.b * p.k_sb + hk * p.k_sh, p.k_ss, d.k0,
                       kv_valid);
    db_rows<C, C::BKV>(Vb + buf * C::BKV * C::P,
                       static_cast<const T*>(p.v) + st.b * p.v_sb + hk * p.v_sh, p.v_ss, d.k0,
                       kv_valid);
    if (threadIdx.x < 2 * C::BQ) {  // lse and delta of the q rows, 0 at or past q_valid
      const int r = threadIdx.x % C::BQ;
      const bool ok = d.q0 + r < q_valid;
      const long long at = ((long long)st.b * p.Hq + st.h) * p.Sq + (ok ? d.q0 + r : 0);
      const bool is_lse = threadIdx.x < C::BQ;
      cp_async4((is_lse ? lse_s : delta_s) + buf * C::BQ + r, (is_lse ? p.lse : p.delta) + at, ok);
    }
    if (bias) db_load_bias<C>(p, d, bias_in);
  };

  // Tiles t_st, t_st + gridDim.x, ... before the current one are not stored
  // yet: a tile no step keeps (zeros) and, when `staged`, the last live tile
  // (t_st itself, from out_s). They go out after the next step's copies are
  // issued, so that its products run while the stores drain.
  int t_st = blockIdx.x;
  bool staged = false;
  auto flush = [&](int upto) {
    for (; t_st < upto; t_st += gridDim.x) {
      db_store<C>(p, db_tile<C>(p, grid, t_st), staged ? out_s : nullptr);
      staged = false;
    }
  };

  DbStep cur = db_seek<C>(p, grid, blockIdx.x, -1);
  if (cur.t < grid.n_tiles) issue(cur, db_tile<C>(p, grid, cur.t), 0, true);
  cp_async_commit();
  int buf = 0;  // cur's operand buffer
#pragma unroll 1
  while (cur.t < grid.n_tiles) {
    const int t = cur.t;
    const DbTile d = db_tile<C>(p, grid, t);
    float bz[C::NT][4], acc[C::NT][4];
#pragma unroll
    for (int n = 0; n < C::NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
    bool first = true;
#pragma unroll 1
    while (cur.t == t) {
      const DbStep nxt = db_next<C>(p, grid, cur, d);
      cp_async_wait<0>();
      __syncthreads();  // cur's copies have landed; every warp is done with buffer buf ^ 1
      if (first) {
        const char* base = db_bias_base(p, d);
        const long long pitch = p.bias_sq * dtype_bytes(p.bias_dtype);
        with_dtype(p.bias_dtype, [&](auto zero) {
          using B = decltype(zero);
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int rl = wq + g + 8 * hr;
            const B* row = reinterpret_cast<const B*>(
                bias_in + rl * C::BT + (p.bias_sk == 1 ? row_shift(base + rl * pitch) : 0));
#pragma unroll
            for (int n = 0; n < C::NT; ++n)
#pragma unroll
              for (int e = 0; e < 2; ++e) bz[n][2 * hr + e] = to_f(row[wk + n * 8 + 2 * tq + e]);
          }
        });
        if (nxt.t != t) __syncthreads();  // read before the next tile's bias lands
      }
      if (nxt.t == t) {
        issue(nxt, d, buf ^ 1, false);
      } else if (nxt.t < grid.n_tiles) {
        issue(nxt, db_tile<C>(p, grid, nxt.t), buf ^ 1, true);
      }
      cp_async_commit();
      if (first) flush(t);
      first = false;

      const int b = cur.b, h = cur.h;
      const int q_len = p.lens[2 * b], kv_len = p.lens[2 * b + 1];
      int2 span[2];
      float lse[2], delta[2];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int rl = wq + g + 8 * hr;
        span[hr] = keep_span(d.q0 + rl, p.Sq, p.Sk, p.q_off, p.kv_off, q_len, kv_len, p.causal,
                             p.wl, p.wr);
        lse[hr] = lse_s[buf * C::BQ + rl];
        delta[hr] = delta_s[buf * C::BQ + rl];
      }
      float sc[C::NT][4], dp[C::NT][4];
      sdp_mma_tile<C, T>(Qb + (buf * C::BQ + wq) * C::P, dOb + (buf * C::BQ + wq) * C::P,
                         Kb + (buf * C::BKV + wk) * C::P, Vb + (buf * C::BKV + wk) * C::P, sc, dp);
      auto elems = [&]() {
#pragma unroll
        for (int n = 0; n < C::NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int hr = e / 2, c = d.k0 + wk + n * 8 + 2 * tq + (e % 2);
            const bool keep = c >= span[hr].x && c < span[hr].y;
            float pr, ds, ds_pre;
            grad_elem(p, sc[n][e] * p.s_mul, dp[n][e], lse[hr], delta[hr], bz[n][e], keep,
                      drop_at<DROP>(p, b, h, d.q0 + wq + g + 8 * hr, c), pr, ds, ds_pre);
            acc[n][e] += ds_pre;
          }
      };
      // One copy of the element loop per softcap case, so that grad_elem's
      // test folds away and the loop has no branch.
      if (p.softcap > 0.f) {
        elems();
      } else {
        elems();
      }
      cur = nxt;
      buf ^= 1;
    }
    // The dbias tile into out_s, at dbias's shifts, once the flush above has
    // read the previous one out.
    __syncthreads();
    with_dtype(p.bias_dtype, [&](auto zero) {
      using B = decltype(zero);
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int rl = wq + g + 8 * hr;
        B* row = reinterpret_cast<B*>(out_s + rl * C::BT + row_shift(db_out_row(p, d, rl)));
#pragma unroll
        for (int n = 0; n < C::NT; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) row[wk + n * 8 + 2 * tq + e] = from_f<B>(acc[n][2 * hr + e]);
      }
    });
    staged = true;
  }
  __syncthreads();
  flush(grid.n_tiles);
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

// fp32 inputs: the FMA dbias kernel.
template <int D, bool DROP>
cudaError_t launch_dbias(const BwdParams& p, cudaStream_t stream) {
  const int smem = dq_smem_floats<D>() * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(dbias_kernel<float, D, DROP>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.Sq + TM - 1) / TM, (p.Sk + TN - 1) / TN, p.Bb * p.Hb);
  dbias_kernel<float, D, DROP><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// 16-bit inputs: the tensor-core dbias kernel, as many persistent blocks as
// the card holds at once (fewer when there are fewer tiles).
template <typename T, int D, bool DROP>
cudaError_t launch_dbias_mma(const BwdParams& p, cudaStream_t stream) {
  using C = DbiasMmaCfg<D>;
  auto kernel = dbias_mma_kernel<T, D, DROP>;
  const long long tiles = (long long)((p.Sq + C::BQ - 1) / C::BQ) * ((p.Sk + C::BKV - 1) / C::BKV) *
                          p.Bb * p.Hb;
  if (tiles > INT_MAX) return cudaErrorInvalidValue;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM_BYTES);
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, C::NW * 32, C::SMEM_BYTES);
  }
  if (e != cudaSuccess) return e;
  const long long grid = std::min(tiles, (long long)sms * std::max(per_sm, 1));
  kernel<<<(int)grid, C::NW * 32, C::SMEM_BYTES, stream>>>(p);
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

// fp32 inputs take the FMA dq, dk/dv and dbias kernels; bf16 / fp16 the
// tensor-core ones (no path back to the FMA ones).
template <typename T, int D, bool DROP>
cudaError_t launch_kernel(const BwdParams& p, int which, cudaStream_t stream) {
  // The host counts q tiles (TILE_ROWS) in the dq kernels' rows (TM, DqMmaCfg::BQ).
  if (p.tile_rows != TM || (which != kDq && which != kDkDv && which != kDbias)) {
    return cudaErrorInvalidValue;
  }
  if constexpr (std::is_same<T, float>::value) {
    return which == kDbias ? launch_dbias<D, DROP>(p, stream)
                           : launch_fma<D, DROP>(p, which, stream);
  } else {
    if (which == kDbias) return launch_dbias_mma<T, D, DROP>(p, stream);
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
