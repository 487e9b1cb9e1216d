// FlashAttention-2 forward for Hopper (sm_90a), written by hand in CUDA C++.
//
// Replaces: fa2_triton_tpu/ops/flash_fwd.py:_fwd_kernel (B1),
// _fwd_tri_square_kernel (B9) and _fwd_causal_strip_kernel (B10, l.640) as
// the serving prefill, the training forward and flash_attn_forward_causal_strip
// reach them (padded prompts, causal, GQA, and B1's additive bias, indexed by
// q head as in the JAX package), and the split causal schedule's kernels: B9
// in its diag_stride mode (flash_attn_forward_causal_diag, l.969 -> l.1012),
// _fwd_kernel_nobias on a rectangle (B11, flash_attn_forward_rect, l.1041 ->
// l.1141) and its merge mode _fwd_kernel_merge (B1 merge, l.447; the
// finaliser at l.367-381). The TPU kernels compute the same function and
// differ only in how they fit VMEM, the per-grid-step cost of a sequential
// grid and which tiles skip the mask; on the GPU one kernel serves them all:
//   * the strip is a causal call;
//   * the diag is a causal call with a leaf length T (FwdParams::leaf): local
//     row r attends only local columns of its own leaf [T (r / T), + T),
//     which key_range cuts the key range to;
//   * a rectangle, local rows [row0, row_end) against columns [col0,
//     col_end), is a non-causal call on the region: fa2_flash_fwd_rect moves
//     the q / k / v / o / lse pointers to it and q_off / kv_off by row0 /
//     col0, so the mask, the validity in the global frame and the dropout
//     counters are the generic call's;
//   * the merge is the MERGE instantiation: its store reads the previous o
//     (q's dtype) and lse of its own rows, applies the associative merge
//       m = max(lse_p, lse), w1 = 2^(lse_p - m), w2 = 2^(lse - m),
//       o = (o_p w1 + o w2) / (w1 + w2), lse = m + log2(w1 + w2)
//     (both dead: weights 0, o = 0, lse = -inf, no NaN) and writes both back
//     in place. Each block owns its rows, so nothing races; the merged o is
//     stored in q's dtype between launches, as in JAX.
//
// Function: o = softmax(q k^T * scale [softcapped, + bias, masked]) v with a base-2
// online softmax and fp32 accumulators, and the dropout branch of the TPU
// kernels (flash_fwd.py:320-348, 546-554): with dropout_p > 0 an element is
// kept iff counter_hash(seed, ((b * Hq + h) * Sq_real + row) * Sk_real +
// col) >= threshold (common.cuh), l sums the undropped p, only the P V
// product sees the mask, and o = acc / l / (1 - p); lse does not change.
// The kernels are built with and without dropout (the DROP template flag), so
// the dropout-free instantiations carry none of the hash code.
// Per batch row b, lens[b] = (q_len, kv_len) are GLOBAL actual lengths;
// q_off / kv_off place this call's rows and columns in that global frame. Causal and window masks are
// bottom-right aligned on (q_len, kv_len): keep iff
//   row + shift - left <= col <= row + shift + right,  shift = kv_len - q_len.
// Rows that see no valid column (beyond q_len, or masked out entirely) get
// o = 0 and lse = -inf. lse is stored in log2 units, [B, Hq, Sq] fp32.
//
// Bound on the H100: at prefill lengths (S >= 128, D = 128) attention is
// compute-bound (4*S*D flops per 2*D*2 bytes of K/V per query row), so the
// roof is the tensor cores (989 TFLOP/s bf16). Two kernels, one per input
// type, both one block per (64-row q tile, q head, batch row):
//
// flash_fwd_mma_kernel, bf16 / fp16 inputs: 16-bit mma.sync tiles (the tile
// step and the store in fwd_mma.cuh, shared with varlen.cu's packed forward).
//   * 4 warps, each owning 16 q rows for the whole kv loop, so a row's
//     softmax state (m, l) stays in one warp's registers: row max and row sum
//     are quad shuffles, with no shared memory and no barrier.
//   * q, k and v stay 16-bit in shared memory (rows padded by 8 elements, so
//     the 8 row addresses of every ldmatrix fall in distinct bank groups).
//     Q's A fragments are loaded once and kept in registers at D 64 / 128
//     (reloaded from shared memory per kv tile at D 256, where O alone takes
//     128 registers a thread). K / V tiles of 64 rows (32 at D 256) arrive
//     by 16-byte cp.async copies, double-buffered: one barrier per tile, and
//     the next tile loads while this one computes. Rows past kv_valid and q
//     rows past q_len are zero-filled on load (0 x NaN = NaN in an mma).
//   * S = Q K^T with m16n8k16 (fp32 accumulation); scale * log2(e) is
//     applied to the fp32 accumulator, not folded into a rounded q (the TPU
//     kernels' fold, flash_fwd.py:240, would move lse by far more than the
//     1e-4 it is held to). Then the score epilogue at each accumulator
//     element's (row, column): mask, softcap in natural units, bias. Bias and
//     softcap live in their own instantiation (EXTRA), out of the trainer's
//     loop.
//   * A kv tile that every live row keeps whole (at or below the diagonal
//     of the q tile's first row, inside the real keys and the window: the
//     B10 strip's rule, flash_fwd.py:640) skips the mask test. The store
//     then applies JAX's dead-row rule (rows past q_len: o = 0, lse = -inf).
//   * P is rounded to the input dtype, as the TPU kernels round p to v's
//     dtype before P V (flash_fwd.py:334-338), and repacked from S's
//     accumulators into A fragments in registers; O += P V with V by
//     ldmatrix.trans. o goes out through the warp's own q rows of shared
//     memory as 16-byte stores.
//   * Causal calls launch the longest q tiles first: by position inside the
//     leaf (the whole call is one leaf without one), descending, the leaves
//     interleaved; the q heads of one GQA group are adjacent in blockIdx.y,
//     so their K/V stay in L2.
//   * The merge reads the previous o through the warp's own q rows of shared
//     memory (16-byte loads, as the store writes), so it holds no registers
//     across the kv loop.
//
// flash_fwd_kernel, fp32 inputs: fp32 FMAs on the CUDA cores from shared
// memory tiles (attn_tiles.cuh, shared with the backward and varlen
// kernels), no TF32: q staged once with scale*log2(e) folded in, 32-row K/V
// tiles, a 4x2 score tile and a 4x(D/16) output tile per thread; KV tiles
// beyond the causal limit or kv_len are never loaded.
#include "attn_tiles.cuh"
#include "fwd_mma.cuh"

namespace fa2 {
namespace {

struct FwdParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  const int* lens;  // [B, 2] (q_len, kv_len)
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  const void* bias;  // nullptr = none; else read as bias[b][h][row][col] through
  int bias_dtype;    // its strides (0 on broadcast dims), dtype code below
  long long bias_sb, bias_sh, bias_sq, bias_sk;
  int Hq, Hkv, Sq, Sk;
  int q_off, kv_off, causal, wl, wr;
  float scale_log2;  // softmax_scale * log2(e)
  float softcap;     // natural units; 0 = off
  Dropout drop;
  int Sq_real, Sk_real;  // the dropout counter's lengths
  int tile_rows;         // the q rows of a block the host counts in
  int leaf;              // the diag's leaf length T (a multiple of 64), 0 = none
  int lse_rows;          // rows of lse per (b, h): Sq, or the full tensor's in a merge
};

// Blocks in x: one per 64-row q tile, per leaf position with a leaf (the
// last leaf may be short: its missing tiles exit at once).
dim3 fwd_grid(const FwdParams& p, int bq, int B) {
  const int x = p.leaf > 0 ? (p.Sq + p.leaf - 1) / p.leaf * (p.leaf / bq) : (p.Sq + bq - 1) / bq;
  return dim3(x, p.Hq, B);
}

// The first local row of block x's q tile: in order when not causal; when
// causal the longest tiles first, by position inside the leaf (one leaf of
// gridDim.x tiles without one), descending, the leaves interleaved.
__device__ __forceinline__ int tile_row0(const FwdParams& p, int bq) {
  const int x = blockIdx.x;
  if (!p.causal) return x * bq;
  const int per_leaf = p.leaf > 0 ? p.leaf / bq : (int)gridDim.x;
  const int n_leaves = gridDim.x / per_leaf;
  return ((x % n_leaves) * per_leaf + per_leaf - 1 - x / n_leaves) * bq;
}

// ---- fp32 inputs: FMA tiles -------------------------------------------------

// fwd_store's merge form: o / lse point at the tile's first row of the
// running (o, lse), which hold the previous partial on entry.
template <typename T, int D>
__device__ __forceinline__ void fwd_store_merge(const FwdSmem& s, float m_run, float l_run,
                                                const float (&acc)[4][D / 16], float* lse, T* op,
                                                long long o_ss, int rows, float out_scale) {
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16, srow = tid / 4;
  float* w = s.Ss;  // [TM][4]: this partial's 1 / l, then w1, w2 and 1 / (w1 + w2)
  __syncthreads();  // every thread is done with the last tile's Ss
  if ((tid % 4) == 0) {
    const float lse_new = l_run > 0.f ? m_run + log2f(l_run) : neg_inf();
    const float lse_p = srow < rows ? lse[srow] : neg_inf();
    const float m_t = fmaxf(lse_p, lse_new);
    const float m_safe = isfinite(m_t) ? m_t : 0.f;
    const float w1 = exp2f(lse_p - m_safe), w2 = exp2f(lse_new - m_safe), l_t = w1 + w2;
    w[srow * 4 + 0] = l_run > 0.f ? 1.f / l_run * out_scale : 0.f;
    w[srow * 4 + 1] = w1;
    w[srow * 4 + 2] = w2;
    w[srow * 4 + 3] = l_t > 0.f ? 1.f / l_t : 0.f;
    if (srow < rows) lse[srow] = l_t > 0.f ? m_safe + log2f(l_t) : neg_inf();
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= rows) continue;
    const float l_inv = w[r * 4 + 0], w1 = w[r * 4 + 1], w2 = w[r * 4 + 2], inv = w[r * 4 + 3];
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      T* dst = op + r * o_ss + tx + 16 * j;
      *dst = from_f<T>((to_f(*dst) * w1 + acc[i][j] * l_inv * w2) * inv);
    }
  }
}

// One block per (64-row q tile, q head, batch row); the tile math is
// attn_tiles.cuh's forward.
template <typename T, int D, bool DROP, bool MERGE>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(const FwdParams p) {
  extern __shared__ float smem[];
  const FwdSmem s = fwd_smem<D>(smem);
  const int q0 = tile_row0(p, TM), h = blockIdx.y, b = blockIdx.z;
  if (q0 >= p.Sq) return;
  const int hk = h / (p.Hq / p.Hkv);
  const int q_len = p.lens[2 * b], kv_len = p.lens[2 * b + 1];

  const T* qp = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kp = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vp = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  stage<T, D>(s.Qs, qp, p.q_ss, q0, TM, p.Sq, p.scale_log2);

  const KeyRange kr = key_range(p, q0, TM, q_len, kv_len, p.leaf);
  float m_run = MASK_LOG2, l_run = 0.f;
  float acc[4][D / 16];
  zero_acc<D>(acc);
  for (int k0 = (kr.lo / TN) * TN; k0 < kr.hi; k0 += TN) {
    auto score = [&](int r, int c, float x) {
      const bool keep = keep_at(q0 + r, k0 + c, p.Sq, p.Sk, p.q_off, p.kv_off, q_len, kv_len,
                                p.causal, p.wl, p.wr);
      // A merge (the split's rectangle) has neither, so its build carries
      // no bias or softcap code.
      if (!MERGE && (p.softcap > 0.f || p.bias != nullptr)) {
        // Cap in natural units, add the bias there, then back to log2.
        x *= 1.f / LOG2E;
        if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
        if (p.bias != nullptr && keep) {
          x += load_any(p.bias, p.bias_dtype, b * p.bias_sb + h * p.bias_sh +
                                                  (q0 + r) * p.bias_sq + (k0 + c) * p.bias_sk);
        }
        x *= LOG2E;
      }
      return keep ? x : neg_inf();
    };
    auto drop = [&](int r, int c, float pr) {
      if constexpr (DROP) {
        return dropout_keep(p.drop.seed, p.drop.threshold, b, h, p.q_off + q0 + r,
                            p.kv_off + k0 + c, p.Hq, p.Sq_real, p.Sk_real)
                   ? pr
                   : 0.f;
      } else {
        return pr;
      }
    };
    // Rows past the real keys stay zero: cache rows beyond kv_len may hold
    // anything, and 0 * NaN would poison the P V product.
    fwd_kv_step<T, D>(s, kp, p.k_ss, vp, p.v_ss, k0, kr.kv_valid, score, drop, m_run, l_run,
                      acc);
  }
  float* lse = p.lse + ((long long)b * p.Hq + h) * p.lse_rows + q0;
  T* op = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh + q0 * p.o_ss;
  const int rows = min(TM, p.Sq - q0);
  const float out_scale = DROP ? p.drop.scale : 1.f;
  if constexpr (MERGE) {
    fwd_store_merge<T, D>(s, m_run, l_run, acc, lse, op, p.o_ss, rows, out_scale);
  } else {
    fwd_store<T, D>(s, m_run, l_run, acc, lse, op, p.o_ss, rows, out_scale);
  }
}

// ---- 16-bit inputs: tensor-core tiles ---------------------------------------

// The tile step and the store are fwd_mma.cuh's; this kernel walks the
// dense call's kv tiles [k_begin, kr.hi) with keep_at's mask (and bias /
// softcap in the EXTRA instantiation).
template <typename T, int D, bool DROP, bool EXTRA, bool MERGE>
__global__ void __launch_bounds__(FwdMmaCfg<D>::NW * 32) flash_fwd_mma_kernel(const FwdParams p) {
  using C = FwdMmaCfg<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);  // [BQ][P]
  T* kv_s = Qs + C::BQ * C::P;             // buffer j: K at 2 j BKV rows, V BKV rows on
  const int q0 = tile_row0(p, C::BQ);
  if (q0 >= p.Sq) return;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  const int q_len = p.lens[2 * b], kv_len = p.lens[2 * b + 1];

  const T* qp = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kp = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vp = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;

  const KeyRange kr = key_range(p, q0, C::BQ, q_len, kv_len, p.leaf);
  const int kv_valid = kr.kv_valid;
  const int k_begin = (kr.lo / C::BKV) * C::BKV;
  const int n_tiles = kr.hi > k_begin ? (kr.hi - k_begin + C::BKV - 1) / C::BKV : 0;

  float o[C::NT_O][4], m_run[2], l_run[2];
  fwd_mma_init<C>(o, m_run, l_run);
  QFrags<C> qf;

  if (n_tiles > 0) {
    cp_rows<C>(Qs, qp, p.q_ss, q0, C::BQ, min(p.Sq, q_len - p.q_off));
    cp_async_commit();
    fwd_load_kv<C>(kv_s, kp, p.k_ss, vp, p.v_ss, k_begin, kv_valid);
    cp_async_commit();
    if constexpr (C::Q_REGS) {
      cp_async_wait<1>();
      __syncthreads();
      fwd_mma_load_q<C>(qf, Qs);
    }
  }
#pragma unroll 1
  for (int i = 0; i < n_tiles; ++i) {
    const int k0 = k_begin + i * C::BKV;
    cp_async_wait<0>();
    __syncthreads();  // tile i has landed; every warp is done with tile i - 1
    if (i + 1 < n_tiles) {
      fwd_load_kv<C>(kv_s + ((i + 1) & 1) * 2 * C::BKV * C::P, kp, p.k_ss, vp, p.v_ss,
                     k0 + C::BKV, kv_valid);
      cp_async_commit();
    }
    const T* Ks = kv_s + (i & 1) * 2 * C::BKV * C::P;
    // keep_at's mask, and in EXTRA the cap in natural units and the bias
    // there, then back to log2.
    auto score = [&](int r, int c, float x) {
      const bool keep = keep_at(q0 + r, k0 + c, p.Sq, p.Sk, p.q_off, p.kv_off, q_len, kv_len,
                                p.causal, p.wl, p.wr);
      if constexpr (EXTRA) {
        x *= 1.f / LOG2E;
        if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
        if (p.bias != nullptr && keep) {
          x += load_any(p.bias, p.bias_dtype, b * p.bias_sb + h * p.bias_sh +
                                                  (q0 + r) * p.bias_sq + (k0 + c) * p.bias_sk);
        }
        x *= LOG2E;
      }
      return keep ? x : neg_inf();
    };
    auto undropped = [&](int r, int c, int) {
      return dropout_keep(p.drop.seed, p.drop.threshold, b, h, p.q_off + q0 + r,
                          p.kv_off + k0 + c, p.Hq, p.Sq_real, p.Sk_real);
    };
    // A tile every live row keeps whole skips the mask test (never with
    // bias / softcap, which every element needs).
    const bool free_tile = !EXTRA && k0 >= kr.free_lo && k0 + C::BKV <= kr.free_hi;
    fwd_mma_tile<C, T, DROP>(qf, Qs, Ks, Ks + C::BKV * C::P, p.scale_log2, free_tile, score,
                             undropped, o, m_run, l_run);
  }

  // Rows past q_len (free tiles gave them a sum) get o = 0 and lse = -inf;
  // the store writes the rows inside Sq.
  fwd_mma_store<C, T, MERGE>(
      o, m_run, l_run, Qs, static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh + (long long)q0 * p.o_ss,
      p.o_ss, p.lse + ((long long)b * p.Hq + h) * p.lse_rows + q0, q_len - p.q_off - q0,
      p.Sq - q0, DROP ? p.drop.scale : 1.f);
}

// ---- launch -----------------------------------------------------------------

template <typename T, int D, bool DROP, bool MERGE>
cudaError_t launch_fma(const FwdParams& p, int B, cudaStream_t stream) {
  if (p.tile_rows != TM) return cudaErrorInvalidValue;
  const int smem = fwd_smem_floats<D>() * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_kernel<T, D, DROP, MERGE>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  flash_fwd_kernel<T, D, DROP, MERGE><<<fwd_grid(p, TM, B), THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int D, bool DROP, bool EXTRA, bool MERGE>
cudaError_t launch_mma(const FwdParams& p, int B, cudaStream_t stream) {
  using C = FwdMmaCfg<D>;
  // The host counts q tiles (TILE_ROWS, and the schedules' alignment) in these rows.
  if (p.tile_rows != C::BQ) return cudaErrorInvalidValue;
  void (*kernel)(const FwdParams) = flash_fwd_mma_kernel<T, D, DROP, EXTRA, MERGE>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM_BYTES);
  if (e != cudaSuccess) return e;
  kernel<<<fwd_grid(p, C::BQ, B), C::NW * 32, C::SMEM_BYTES, stream>>>(p);
  return cudaGetLastError();
}

// fp32 takes the FMA kernel, bf16 / fp16 the tensor-core kernel (no path
// back to the FMA one). A merge has no bias or softcap (the split's calls).
template <typename T, int D, bool DROP>
cudaError_t launch_kernel(const FwdParams& p, bool merge, int B, cudaStream_t stream) {
  if constexpr (std::is_same<T, float>::value) {
    return merge ? launch_fma<T, D, DROP, true>(p, B, stream)
                 : launch_fma<T, D, DROP, false>(p, B, stream);
  } else {
    const bool extra = p.bias != nullptr || p.softcap > 0.f;
    if (merge) return launch_mma<T, D, DROP, false, true>(p, B, stream);
    return extra ? launch_mma<T, D, DROP, true, false>(p, B, stream)
                 : launch_mma<T, D, DROP, false, false>(p, B, stream);
  }
}

template <typename T, int D>
cudaError_t launch(const FwdParams& p, bool merge, int B, cudaStream_t stream) {
  return p.drop.on ? launch_kernel<T, D, true>(p, merge, B, stream)
                   : launch_kernel<T, D, false>(p, merge, B, stream);
}

template <typename T>
cudaError_t launch_d(const FwdParams& p, bool merge, int B, int D, cudaStream_t stream) {
  switch (D) {
    case 64: return launch<T, 64>(p, merge, B, stream);
    case 128: return launch<T, 128>(p, merge, B, stream);
    case 256: return launch<T, 256>(p, merge, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

int launch_dtype(const FwdParams& p, int dtype, bool merge, int B, int D, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return (int)launch_d<float>(p, merge, B, D, s);
    case kF16: return (int)launch_d<__half>(p, merge, B, D, s);
    case kBF16: return (int)launch_d<__nv_bfloat16>(p, merge, B, D, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// A call's params as the split schedule's entries make them (not causal, no
// bias, window, softcap or leaf, the kernels' own tile rows, lse_rows = Sq);
// each entry then sets what differs.
FwdParams call_params(int Hq, int Hkv, int Sq, int Sk, const void* q, const void* k,
                       const void* v, void* o, float* lse, const int* lens, long long q_sb,
                       long long q_sh, long long q_ss, long long k_sb, long long k_sh,
                       long long k_ss, long long v_sb, long long v_sh, long long v_ss,
                       long long o_sb, long long o_sh, long long o_ss, int q_off, int kv_off,
                       float softmax_scale, int dropout, unsigned int drop_seed,
                       unsigned int drop_threshold, float drop_scale, int Sq_real, int Sk_real) {
  FwdParams p;
  p.q = q; p.k = k; p.v = v; p.o = o; p.lse = lse; p.lens = lens;
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_ss = q_ss;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_ss = k_ss;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_ss = v_ss;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_ss = o_ss;
  p.bias = nullptr; p.bias_dtype = 0;
  p.bias_sb = p.bias_sh = p.bias_sq = p.bias_sk = 0;
  p.Hq = Hq; p.Hkv = Hkv; p.Sq = Sq; p.Sk = Sk;
  p.q_off = q_off; p.kv_off = kv_off; p.causal = 0; p.wl = -1; p.wr = -1;
  p.scale_log2 = softmax_scale * LOG2E;
  p.softcap = 0.f;
  p.drop.on = dropout; p.drop.seed = drop_seed; p.drop.threshold = drop_threshold;
  p.drop.scale = drop_scale;
  p.Sq_real = Sq_real; p.Sk_real = Sk_real;
  p.tile_rows = TM;
  p.leaf = 0;
  p.lse_rows = Sq;
  return p;
}

}  // namespace
}  // namespace fa2

// tile_rows: the q rows of a block the host counts in (ops/flash_fwd.py
// TILE_ROWS); the call fails unless it is the kernels' (64). 16-bit q / k / v
// / o: rows, strides and base pointers 16-byte aligned.
extern "C" int fa2_flash_fwd(
    int dtype, int B, int Hq, int Hkv, int Sq, int Sk, int D,
    const void* q, const void* k, const void* v, void* o, float* lse, const int* lens,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss,
    const void* bias, int bias_dtype,
    long long bias_sb, long long bias_sh, long long bias_sq, long long bias_sk,
    int q_off, int kv_off, int causal, int wl, int wr,
    float softmax_scale, float softcap,
    int dropout, unsigned int drop_seed, unsigned int drop_threshold, float drop_scale,
    int Sq_real, int Sk_real, int tile_rows, void* stream) {
  fa2::FwdParams p = fa2::call_params(
      Hq, Hkv, Sq, Sk, q, k, v, o, lse, lens, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh,
      v_ss, o_sb, o_sh, o_ss, q_off, kv_off, softmax_scale, dropout, drop_seed, drop_threshold,
      drop_scale, Sq_real, Sk_real);
  p.bias = bias; p.bias_dtype = bias_dtype;
  p.bias_sb = bias_sb; p.bias_sh = bias_sh; p.bias_sq = bias_sq; p.bias_sk = bias_sk;
  p.causal = causal; p.wl = wl; p.wr = wr;
  p.softcap = softcap;
  p.tile_rows = tile_rows;
  return fa2::launch_dtype(p, dtype, false, B, D, stream);
}

// The split's diag (B9 diag): every T x T causal leaf of the call in one
// launch, leaf = T > 0 a multiple of 64 (Sq == Sk, checked by the wrapper).
extern "C" int fa2_flash_fwd_causal(
    int dtype, int leaf, int B, int Hq, int Hkv, int Sq, int Sk, int D,
    const void* q, const void* k, const void* v, void* o, float* lse, const int* lens,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss,
    int q_off, int kv_off, float softmax_scale,
    int dropout, unsigned int drop_seed, unsigned int drop_threshold, float drop_scale,
    int Sq_real, int Sk_real, void* stream) {
  if (leaf <= 0 || leaf % fa2::TM != 0) return (int)cudaErrorInvalidValue;
  fa2::FwdParams p = fa2::call_params(
      Hq, Hkv, Sq, Sk, q, k, v, o, lse, lens, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh,
      v_ss, o_sb, o_sh, o_ss, q_off, kv_off, softmax_scale, dropout, drop_seed, drop_threshold,
      drop_scale, Sq_real, Sk_real);
  p.causal = 1;
  p.leaf = leaf;
  return fa2::launch_dtype(p, dtype, false, B, D, stream);
}

// A rectangle of the split (B11; merge = 1: B1 merge): local q rows [row0,
// row_end) against K / V columns [col0, col_end) of the whole tensors, not
// causal. Its o / lse row of local row r is r - out_row0 (lse_rows rows of
// lse per (b, h)): region-sized with out_row0 = row0, the full-size running
// (o, lse) with out_row0 = 0 in a merge.
extern "C" int fa2_flash_fwd_rect(
    int dtype, int merge, int B, int Hq, int Hkv, int Sq, int Sk, int D,
    const void* q, const void* k, const void* v, void* o, float* lse, const int* lens,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss,
    int q_off, int kv_off, float softmax_scale,
    int dropout, unsigned int drop_seed, unsigned int drop_threshold, float drop_scale,
    int Sq_real, int Sk_real, int lse_rows, int row0, int row_end, int col0, int col_end,
    int out_row0, void* stream) {
  if (!(0 <= row0 && row0 < row_end && row_end <= Sq && 0 <= col0 && col0 < col_end &&
        col_end <= Sk && 0 <= out_row0 && out_row0 <= row0)) {
    return (int)cudaErrorInvalidValue;
  }
  // The region as a call of its own: pointers moved to its first row and
  // column, and q_off / kv_off with them, so validity and dropout stay in
  // the global frame.
  const long long es = dtype == fa2::kF32 ? 4 : 2;
  const long long out = row0 - out_row0;
  fa2::FwdParams p = fa2::call_params(
      Hq, Hkv, row_end - row0, col_end - col0, static_cast<const char*>(q) + row0 * q_ss * es,
      static_cast<const char*>(k) + col0 * k_ss * es,
      static_cast<const char*>(v) + col0 * v_ss * es, static_cast<char*>(o) + out * o_ss * es,
      lse + out, lens, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss,
      q_off + row0, kv_off + col0, softmax_scale, dropout, drop_seed, drop_threshold, drop_scale,
      Sq_real, Sk_real);
  p.lse_rows = lse_rows;
  return fa2::launch_dtype(p, dtype, merge != 0, B, D, stream);
}

extern "C" const char* fa2_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
