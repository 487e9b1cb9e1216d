// Rectangle forward of the split causal schedule for Hopper (sm_90a), written
// by hand in CUDA C++, with an in-place merge epilogue (B11 and B1 merge).
//
// Replaces: fa2_triton_tpu/ops/flash_fwd.py:flash_attn_forward_rect (l.1041 ->
// l.1141), which runs _fwd_kernel_nobias on a rectangle, and its merge mode
// _fwd_kernel_merge (l.447; the finaliser at l.367-381), driven by
// _causal_split_forward (l.1165).
//
// Function: non-causal attention of local q rows [row0, row_end) against
// local K/V columns [col0, col_end) of the full tensors, with flash_fwd.cu's
// validity (keep col < kv_len and row < q_len of lens[b], in the global frame
// of q_off / kv_off), base-2 online softmax, fp32 accumulators and
// counter-hash dropout on global rows and columns. Without MERGE it writes
// region-sized o and lse (local row r at r - out_row0 = r - row0). With MERGE,
// o and lse are the full-size running (o, lse) of disjoint columns: the
// epilogue reads the previous o (q's dtype) and lse of its own rows, applies
// the associative merge of flash_fwd.py:372-381
//   m = max(lse_p, lse), w1 = 2^(lse_p - m), w2 = 2^(lse - m),
//   o = (o_p w1 + o w2) / (w1 + w2), lse = m + log2(w1 + w2)
// (both dead: weights 0, o = 0, lse = -inf, no NaN), and writes both back in
// place. Each block owns its rows, so the in-place write races with nothing;
// the merged o is stored in q's dtype between launches, as in JAX.
//
// Bound on the H100: compute (4 * rows * cols * D flops per q head against
// the rows' q/o and the columns' K/V bytes), so the roof is the tensor cores.
// Like flash_fwd.cu this first version does fp32 FMAs on the CUDA cores on
// attn_tiles.cuh's tile math, one block per (64-row q tile, q head, batch
// row); a rectangle has no diagonal, so every tile is full work and the
// blocks are equal. wgmma + TMA is later work.
#include "attn_tiles.cuh"

namespace fa2 {
namespace {

struct RectParams {
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
  int lse_rows;  // rows of lse per (b, h)
  int Hq, Hkv, Sq, Sk;
  int q_off, kv_off;
  float scale_log2;  // softmax_scale * log2(e)
  Dropout drop;
  int Sq_real, Sk_real;  // the dropout counter's lengths
  int row0, row_end, col0, col_end;  // the rectangle in local rows / columns
  int out_row0;                      // o / lse row of local row r: r - out_row0
};

// fwd_store's merge form: o / lse point at the tile's first row of the
// running full-size (o, lse), which hold the previous partial on entry.
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
      const float o_new = acc[i][j] * l_inv;
      *dst = from_f<T>((to_f(*dst) * w1 + o_new * w2) * inv);
    }
  }
}

template <typename T, int D, bool DROP, bool MERGE>
__global__ void __launch_bounds__(THREADS) rect_kernel(const RectParams p) {
  extern __shared__ float smem[];
  const FwdSmem s = fwd_smem<D>(smem);
  const int q0 = p.row0 + blockIdx.x * TM, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  const int q_len = p.lens[2 * b], kv_len = p.lens[2 * b + 1];

  const T* qp = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kp = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vp = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  stage<T, D>(s.Qs, qp, p.q_ss, q0, TM, p.row_end, p.scale_log2);

  const int kv_valid = min(p.col_end, kv_len - p.kv_off);  // local columns with real keys
  const bool live = p.q_off + q0 < q_len;                  // a row of the tile can attend
  float m_run = MASK_LOG2, l_run = 0.f;
  float acc[4][D / 16];
  zero_acc<D>(acc);
  for (int k0 = p.col0; live && k0 < kv_valid; k0 += TN) {
    auto score = [&](int r, int c, float x) {
      return (k0 + c < kv_valid && p.q_off + q0 + r < q_len) ? x : neg_inf();
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
    fwd_kv_step<T, D>(s, kp, p.k_ss, vp, p.v_ss, k0, kv_valid, score, drop, m_run, l_run, acc);
  }
  const int out = q0 - p.out_row0;
  float* lse = p.lse + ((long long)b * p.Hq + h) * p.lse_rows + out;
  T* op = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh + out * p.o_ss;
  const int rows = min(TM, p.row_end - q0);
  const float out_scale = DROP ? p.drop.scale : 1.f;
  if constexpr (MERGE) {
    fwd_store_merge<T, D>(s, m_run, l_run, acc, lse, op, p.o_ss, rows, out_scale);
  } else {
    fwd_store<T, D>(s, m_run, l_run, acc, lse, op, p.o_ss, rows, out_scale);
  }
}

template <typename T, int D, bool DROP, bool MERGE>
cudaError_t launch_kernel(const RectParams& p, int B, cudaStream_t stream) {
  const int smem = fwd_smem_floats<D>() * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(rect_kernel<T, D, DROP, MERGE>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((p.row_end - p.row0 + TM - 1) / TM, p.Hq, B);
  rect_kernel<T, D, DROP, MERGE><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch(const RectParams& p, bool merge, int B, cudaStream_t stream) {
  if (p.drop.on) {
    return merge ? launch_kernel<T, D, true, true>(p, B, stream)
                 : launch_kernel<T, D, true, false>(p, B, stream);
  }
  return merge ? launch_kernel<T, D, false, true>(p, B, stream)
               : launch_kernel<T, D, false, false>(p, B, stream);
}

template <typename T>
cudaError_t launch_d(const RectParams& p, bool merge, int B, int D, cudaStream_t stream) {
  switch (D) {
    case 64: return launch<T, 64>(p, merge, B, stream);
    case 128: return launch<T, 128>(p, merge, B, stream);
    case 256: return launch<T, 256>(p, merge, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace fa2

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
        col_end <= Sk)) {
    return (int)cudaErrorInvalidValue;
  }
  fa2::RectParams p;
  p.q = q; p.k = k; p.v = v; p.o = o; p.lse = lse; p.lens = lens;
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_ss = q_ss;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_ss = k_ss;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_ss = v_ss;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_ss = o_ss;
  p.lse_rows = lse_rows;
  p.Hq = Hq; p.Hkv = Hkv; p.Sq = Sq; p.Sk = Sk;
  p.q_off = q_off; p.kv_off = kv_off;
  p.scale_log2 = softmax_scale * fa2::LOG2E;
  p.drop.on = dropout; p.drop.seed = drop_seed; p.drop.threshold = drop_threshold;
  p.drop.scale = drop_scale;
  p.Sq_real = Sq_real; p.Sk_real = Sk_real;
  p.row0 = row0; p.row_end = row_end; p.col0 = col0; p.col_end = col_end;
  p.out_row0 = out_row0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case fa2::kF32: return (int)fa2::launch_d<float>(p, merge != 0, B, D, s);
    case fa2::kF16: return (int)fa2::launch_d<__half>(p, merge != 0, B, D, s);
    case fa2::kBF16: return (int)fa2::launch_d<__nv_bfloat16>(p, merge != 0, B, D, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
