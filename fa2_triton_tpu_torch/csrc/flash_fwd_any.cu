// The forward kernels of flash_fwd.cu past head dim 512, at any multiple of
// 128 (D a run-time argument): B1, B9, B10, B9 diag, B11 and the B1 merge
// (fa2_triton_tpu/ops/flash_fwd.py: _fwd_kernel, _fwd_tri_square_kernel,
// _fwd_causal_strip_kernel, flash_attn_forward_causal_diag /
// _rect and _fwd_kernel_merge), as flash_fwd.cu's entry points reach them:
// the same function, the same params (FwdParams), masks, dropout counters,
// dead-row rule and causal tile order, on any_tiles.cuh's column split.
//
// Bound on the H100: compute (4 S D products per query row against 2 D x 2
// bytes of K / V per key), the tensor cores' 989 TFLOP/s in bf16. The split
// does (n_chunks * 2 D + 2 D) / 4 D times that work (2.5x at D 1024), and
// re-reads q and k from L2 once per chunk and kv tile.
//
// fwd_any_mma_kernel, bf16 / fp16: a block of 4 warps owns a 64-row q tile
// and a chunk of DC = 256 columns of O, each warp 16 rows (O: 128 fp32
// registers a thread, S over 64 keys: 32). Per 64-row kv tile it streams
// (q, k) slices of 64 columns (double-buffered cp.async, any_tiles.cuh
// slice_loop) into S = Q K^T on mma.sync m16n8k16, then takes
// fwd_mma.cuh's softmax (fwd_mma_softmax: mask, softcap and bias in EXTRA,
// the free-tile rule, dropout) and O += P V from the chunk's V columns,
// staged with the tile's first slice. The store writes o / lse straight
// from the accumulators; every chunk computes the same m and l, and chunk
// 0 writes lse. MERGE reads the previous o of its own columns and the
// previous lse from a separate read-only copy (FwdParams::lse_prev): chunk
// 0 writes the merged lse while the other chunks may still read the
// previous one, so the two must not share memory.
//
// fwd_any_fma_kernel, fp32 (no TF32): attn_tiles.cuh's 64 x 32 FMA tiles,
// the scores summed over staged slices of 64 columns (dot_tile), the chunk's
// V columns staged per kv tile, fwd_fold's softmax and P V.
#define FA2_ANY
#include "flash_fwd.cu"

namespace fa2 {
namespace {

struct FwdAnyCfg {
  static constexpr int BQ = TM;                // q rows of a block
  static constexpr int RG = BQ / 16;           // row groups: one warp each
  static constexpr int NW = RG;
  static constexpr int BKV = 64;               // kv rows of a tile
  static constexpr int NT_S = BKV / 8;         // n-tiles of a warp's S
  static constexpr int NT_O = any::DC / 8;     // n-tiles of a warp's O
  static constexpr int SLICE = (BQ + BKV) * any::SP;   // a slice buffer: q's, then k's
  static constexpr int SMEM_BYTES = (2 * SLICE + 2 * BKV * any::CP) * 2;
};

// o = acc / l * out_scale (o: the tile's row 0 at the chunk's first column)
// and lse (the tile's row 0) of the warp's rows < rows, columns < cols;
// rows at or past `live` or that kept nothing get o = 0, lse = -inf. MERGE:
// merged with the previous o (read here, each chunk its own columns) and
// lse_prev, as fwd_mma_store merges.
template <class C, typename T, bool MERGE>
__device__ __forceinline__ void any_mma_store(const float (&o)[C::NT_O][4], const float (&m_run)[2],
                                              const float (&l_run)[2], T* op, long long o_ss,
                                              float* lse, const float* lse_prev, bool write_lse,
                                              int live, int rows, int cols, float out_scale) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4, w = threadIdx.x / 32;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = w * 16 + g + 8 * hr;
    if (r >= rows) continue;
    const bool ok = r < live && l_run[hr] > 0.f;
    const float inv = ok ? 1.f / l_run[hr] * out_scale : 0.f;
    float lse_r = ok ? m_run[hr] + log2f(l_run[hr]) : neg_inf();
    float w1 = 0.f, w2 = 1.f, inv_t = 1.f;
    if constexpr (MERGE) {
      const float lse_p = lse_prev[r];
      const float m_t = fmaxf(lse_p, lse_r);
      const float m_safe = isfinite(m_t) ? m_t : 0.f;
      w1 = exp2f(lse_p - m_safe);
      w2 = exp2f(lse_r - m_safe);
      const float l_t = w1 + w2;
      inv_t = l_t > 0.f ? 1.f / l_t : 0.f;
      lse_r = l_t > 0.f ? m_safe + log2f(l_t) : neg_inf();
    }
#pragma unroll
    for (int n = 0; n < C::NT_O; ++n) {
      const int c = n * 8 + 2 * t;
      if (c >= cols) continue;
      T* dst = op + (long long)r * o_ss + c;
      float o0 = o[n][2 * hr] * inv, o1 = o[n][2 * hr + 1] * inv;
      if constexpr (MERGE) {
        o0 = (to_f(dst[0]) * w1 + o0 * w2) * inv_t;
        o1 = (to_f(dst[1]) * w1 + o1 * w2) * inv_t;
      }
      *reinterpret_cast<uint32_t*>(dst) = pack2<T>(o0, o1);
    }
    if (t == 0 && write_lse) lse[r] = lse_r;
  }
}

// One block per (64-row q tile x column chunk, q head, batch row): blockIdx.x
// = tile * n_dc + chunk, so the chunks of a tile run side by side and share
// its q / k reads in L2.
template <typename T, bool DROP, bool EXTRA, bool MERGE>
__global__ void __launch_bounds__(FwdAnyCfg::NW * 32) fwd_any_mma_kernel(const FwdParams p) {
  using C = FwdAnyCfg;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sl = reinterpret_cast<T*>(smem_raw);  // slice buffer j at j SLICE: q [BQ][SP], k [BKV][SP]
  T* vb = sl + 2 * C::SLICE;               // V chunk buffer j at j BKV CP: [BKV][CP]
  const int chunk = blockIdx.x % p.n_dc;
  const int q0 = tile_row0(p, C::BQ, blockIdx.x / p.n_dc, gridDim.x / p.n_dc);
  if (q0 >= p.Sq) return;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  const int q_len = p.lens[2 * b], kv_len = p.lens[2 * b + 1];
  const int d0 = chunk * any::DC, w = threadIdx.x / 32;

  const T* qp = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kp = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vp = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  const KeyRange kr = key_range(p, q0, C::BQ, q_len, kv_len, p.leaf);
  const int q_valid = min(p.Sq, q_len - p.q_off);
  const int k_begin = (kr.lo / C::BKV) * C::BKV;
  const int n_tiles = kr.hi > k_begin ? (kr.hi - k_begin + C::BKV - 1) / C::BKV : 0;
  const int n_slices = p.D / any::KS;

  float o[C::NT_O][4], m_run[2], l_run[2], s[C::NT_S][4];
  fwd_mma_init<C>(o, m_run, l_run);
  any::slice_loop(
      n_tiles, n_slices,
      [&](int i, int sl_i, int buf) {
        const int k0 = k_begin + i * C::BKV, c = sl_i * any::KS;
        T* dst = sl + buf * C::SLICE;
        any::cp_tile<C::BQ, any::KS, any::SP, C::NW * 32>(dst, qp, p.q_ss, q0, q_valid, c, p.D);
        any::cp_tile<C::BKV, any::KS, any::SP, C::NW * 32>(dst + C::BQ * any::SP, kp, p.k_ss, k0,
                                                           kr.kv_valid, c, p.D);
        if (sl_i == 0) {
          any::cp_tile<C::BKV, any::DC, any::CP, C::NW * 32>(vb + (i & 1) * C::BKV * any::CP, vp,
                                                             p.v_ss, k0, kr.kv_valid, d0, p.D);
        }
      },
      [&](int i, int sl_i, int buf) {
        const T* src = sl + buf * C::SLICE;
        if (sl_i == 0) any::zero_frags(s);
        any::mma_abt<T, C::NT_S, any::SP>(s, src + w * 16 * any::SP, src + C::BQ * any::SP);
        if (sl_i + 1 < n_slices) return;
        const int k0 = k_begin + i * C::BKV;
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
        const bool free_tile = !EXTRA && k0 >= kr.free_lo && k0 + C::BKV <= kr.free_hi;
        fwd_mma_softmax<C, DROP>(s, p.scale_log2, free_tile, score, undropped, o, m_run, l_run);
        any::mma_xb<T, C::BKV / 16, C::NT_O, any::CP>(o, s, vb + (i & 1) * C::BKV * any::CP);
      });

  const long long lse_at = ((long long)b * p.Hq + h) * p.lse_rows + q0;
  any_mma_store<C, T, MERGE>(
      o, m_run, l_run,
      static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh + (long long)q0 * p.o_ss + d0, p.o_ss,
      p.lse + chunk * p.lse_cs + lse_at, MERGE ? p.lse_prev + lse_at : nullptr,
      chunk == 0 || p.lse_cs != 0, q_len - p.q_off - q0, min(C::BQ, p.Sq - q0),
      min(any::DC, p.D - d0), DROP ? p.drop.scale : 1.f);
}

// ---- fp32 inputs --------------------------------------------------------------

using AnyFma = FmaTile<any::DC>;  // 64 x 32 tiles, 4 x 16 accumulators a thread

constexpr int fwd_any_fma_floats() {
  constexpr int M = AnyFma::M, N = AnyFma::N;
  return (M + N) * (any::KS + 1) + N * any::DC + M * (N + 1) + 2 * M;
}

// The FMA store: fwd_store / fwd_store_merge at the chunk's columns (< cols)
// with the previous lse read from lse_prev.
template <typename T, bool MERGE>
__device__ __forceinline__ void any_fma_store(const FwdSmem& s, float m_run, float l_run,
                                              const FmaAcc<any::DC>& acc, float* lse,
                                              const float* lse_prev, bool write_lse, T* op,
                                              long long o_ss, int rows, int cols,
                                              float out_scale) {
  using F = AnyFma;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16, srow = tid / F::TPR;
  float* wt = s.Ss;  // [M][4]: 1 / l times out_scale, then the merge's w1, w2, 1 / (w1 + w2)
  __syncthreads();   // every thread is done with the last tile's Ss
  if ((tid % F::TPR) == 0) {
    float lse_r = l_run > 0.f ? m_run + log2f(l_run) : neg_inf();
    float w1 = 0.f, w2 = 1.f, inv_t = 1.f;
    if (MERGE && srow < rows) {
      const float lse_p = lse_prev[srow];
      const float m_t = fmaxf(lse_p, lse_r);
      const float m_safe = isfinite(m_t) ? m_t : 0.f;
      w1 = exp2f(lse_p - m_safe);
      w2 = exp2f(lse_r - m_safe);
      const float l_t = w1 + w2;
      inv_t = l_t > 0.f ? 1.f / l_t : 0.f;
      lse_r = l_t > 0.f ? m_safe + log2f(l_t) : neg_inf();
    }
    wt[srow * 4 + 0] = l_run > 0.f ? 1.f / l_run * out_scale : 0.f;
    wt[srow * 4 + 1] = w1;
    wt[srow * 4 + 2] = w2;
    wt[srow * 4 + 3] = inv_t;
    if (srow < rows && write_lse) lse[srow] = lse_r;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < F::RI; ++i) {
    const int r = ty + 16 * i;
    if (r >= rows) continue;
    const float l_inv = wt[r * 4 + 0], w1 = wt[r * 4 + 1], w2 = wt[r * 4 + 2], inv = wt[r * 4 + 3];
#pragma unroll
    for (int j = 0; j < any::DC / 16; ++j) {
      const int c = tx + 16 * j;
      if (c >= cols) continue;
      T* dst = op + r * o_ss + c;
      const float x = acc[i][j] * l_inv;
      *dst = from_f<T>(MERGE ? (to_f(*dst) * w1 + x * w2) * inv : x);
    }
  }
}

template <typename T, bool DROP, bool MERGE>
__global__ void __launch_bounds__(THREADS) fwd_any_fma_kernel(const FwdParams p) {
  using F = AnyFma;
  extern __shared__ float smem[];
  FwdSmem s;
  s.Qs = smem;                                  // [M][KS + 1] a slice of q * scale * log2e
  s.Ks = s.Qs + F::M * (any::KS + 1);           // [N][KS + 1]
  s.Vs = s.Ks + F::N * (any::KS + 1);           // [N][DC] the chunk's columns of v
  s.Ss = s.Vs + F::N * any::DC;                 // [M][N + 1]
  s.alpha_s = s.Ss + F::M * (F::N + 1);
  s.l_s = s.alpha_s + F::M;
  const int chunk = blockIdx.x % p.n_dc;
  const int q0 = tile_row0(p, F::M, blockIdx.x / p.n_dc, gridDim.x / p.n_dc);
  if (q0 >= p.Sq) return;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  const int q_len = p.lens[2 * b], kv_len = p.lens[2 * b + 1];
  const int d0 = chunk * any::DC;

  const T* qp = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kp = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vp = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  const KeyRange kr = key_range(p, q0, F::M, q_len, kv_len, p.leaf);
  float m_run = MASK_LOG2, l_run = 0.f;
  FmaAcc<any::DC> acc;
  zero_acc<any::DC>(acc);
  for (int k0 = (kr.lo / F::N) * F::N; k0 < kr.hi; k0 += F::N) {
    FmaScores<any::DC> sc;
#pragma unroll
    for (int i = 0; i < F::RI; ++i)
#pragma unroll
      for (int j = 0; j < F::RJ; ++j) sc[i][j] = 0.f;
    for (int c = 0; c < p.D; c += any::KS) {
      __syncthreads();  // the previous slice (or tile) fully consumed
      any::stage_cols<T, any::KS, any::KS + 1>(s.Qs, qp, p.q_ss, q0, F::M, p.Sq, c, p.D,
                                               p.scale_log2);
      any::stage_cols<T, any::KS, any::KS + 1>(s.Ks, kp, p.k_ss, k0, F::N, kr.kv_valid, c, p.D,
                                               1.f);
      __syncthreads();
      FmaScores<any::KS> part;
      dot_tile<any::KS>(s.Qs, s.Ks, part);
#pragma unroll
      for (int i = 0; i < F::RI; ++i)
#pragma unroll
        for (int j = 0; j < F::RJ; ++j) sc[i][j] += part[i][j];
    }
    any::stage_cols<T, any::DC, any::DC>(s.Vs, vp, p.v_ss, k0, F::N, kr.kv_valid, d0, p.D, 1.f);
    __syncthreads();
    auto score = [&](int r, int c, float x) {
      const bool keep = keep_at(q0 + r, k0 + c, p.Sq, p.Sk, p.q_off, p.kv_off, q_len, kv_len,
                                p.causal, p.wl, p.wr);
      if (!MERGE && (p.softcap > 0.f || p.bias != nullptr)) {
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
    fwd_fold<any::DC>(s, sc, score, drop, m_run, l_run, acc);
  }
  const long long lse_at = ((long long)b * p.Hq + h) * p.lse_rows + q0;
  any_fma_store<T, MERGE>(s, m_run, l_run, acc, p.lse + chunk * p.lse_cs + lse_at,
                          MERGE ? p.lse_prev + lse_at : nullptr, chunk == 0 || p.lse_cs != 0,
                          static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh +
                              (long long)q0 * p.o_ss + d0,
                          p.o_ss, min(F::M, p.Sq - q0), min(any::DC, p.D - d0),
                          DROP ? p.drop.scale : 1.f);
}

// ---- launch -----------------------------------------------------------------

dim3 any_grid(const FwdParams& p, int bq, int B) {
  dim3 g = fwd_grid(p, bq, B);
  g.x *= p.n_dc;
  return g;
}

template <typename T, bool DROP, bool MERGE>
cudaError_t launch_any_fma(const FwdParams& p, int B, cudaStream_t stream) {
  if (p.tile_rows != TM) return cudaErrorInvalidValue;
  const int smem = fwd_any_fma_floats() * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(fwd_any_fma_kernel<T, DROP, MERGE>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  fwd_any_fma_kernel<T, DROP, MERGE><<<any_grid(p, AnyFma::M, B), THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, bool DROP, bool EXTRA, bool MERGE>
cudaError_t launch_any_mma(const FwdParams& p, int B, cudaStream_t stream) {
  using C = FwdAnyCfg;
  if (p.tile_rows != C::BQ) return cudaErrorInvalidValue;
  void (*kernel)(const FwdParams) = fwd_any_mma_kernel<T, DROP, EXTRA, MERGE>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM_BYTES);
  if (e != cudaSuccess) return e;
  kernel<<<any_grid(p, C::BQ, B), C::NW * 32, C::SMEM_BYTES, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, bool DROP>
cudaError_t launch_any_kernel(const FwdParams& p, bool merge, int B, cudaStream_t stream) {
  if constexpr (std::is_same<T, float>::value) {
    return merge ? launch_any_fma<T, DROP, true>(p, B, stream)
                 : launch_any_fma<T, DROP, false>(p, B, stream);
  } else {
    const bool extra = p.bias != nullptr || p.softcap > 0.f;
    if (merge) return launch_any_mma<T, DROP, false, true>(p, B, stream);
    return extra ? launch_any_mma<T, DROP, true, false>(p, B, stream)
                 : launch_any_mma<T, DROP, false, false>(p, B, stream);
  }
}

template <typename T>
cudaError_t launch_any(const FwdParams& p, bool merge, int B, cudaStream_t stream) {
  if (p.D <= 512 || p.D % 128 != 0 || p.n_dc != any::col_chunks(p.D) ||
      (merge && p.lse_prev == nullptr)) {
    return cudaErrorInvalidValue;
  }
  return p.drop.on ? launch_any_kernel<T, true>(p, merge, B, stream)
                   : launch_any_kernel<T, false>(p, merge, B, stream);
}

}  // namespace

int launch_fwd_any(const FwdParams& p, int dtype, bool merge, int B, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return (int)launch_any<float>(p, merge, B, s);
    case kF16: return (int)launch_any<__half>(p, merge, B, s);
    case kBF16: return (int)launch_any<__nv_bfloat16>(p, merge, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace fa2
