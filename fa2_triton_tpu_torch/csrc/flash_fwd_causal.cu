// The split schedule's diagonal leaf triangles (B9 diag) for Hopper
// (sm_90a), written by hand in CUDA C++. The whole-strip causal forward (B10)
// that this file also held is now a causal call of csrc/flash_fwd.cu.
//
// Replaces: fa2_triton_tpu/ops/flash_fwd.py:_fwd_tri_square_kernel (l.454) in
// its diag_stride / leaf_subs mode (flash_attn_forward_causal_diag l.969 ->
// l.1012).
//
// Function: causal attention exactly as csrc/flash_fwd.cu's FMA kernel
// (flash_fwd_kernel) computes it (base-2 online softmax, fp32 accumulators, the causal mask
// bottom-right aligned on lens[b] = (q_len, kv_len) in the global frame that
// q_off / kv_off place the call in, counter-hash dropout on global rows and
// columns with the real lengths Sq_real / Sk_real, o = acc / l / (1 - p)),
// restricted to leaves: with leaf length T, local row r attends only local
// columns of its own leaf, [T * (r / T), T * (r / T + 1)); the split
// schedule's rectangles (flash_fwd_rect.cu) supply the columns below it. Rows
// at or past q_len, or above a negative shift's diagonal, get o = 0 and lse =
// -inf (JAX flash_fwd.py:771-776); lse is base-2, [B, Hq, Sq] fp32.
//
// Bound on the H100: at these lengths (S >= 1024, D = 128) attention is
// compute-bound, so the roof is the tensor cores (989 TFLOP/s bf16). This
// kernel still does fp32 FMAs on the CUDA cores for every input type, on
// attn_tiles.cuh's tile math (one block per 64-row q tile, q head and batch
// row, 32-row K/V tiles streamed through shared memory); moving it to
// flash_fwd.cu's tensor-core tile is ROADMAP queue B's next forward item.
// Its design against the bound:
//   * a K/V tile that ends at or below the diagonal of the q tile's FIRST
//     row, inside the real keys, runs a score step with no mask test (every
//     live row of the tile keeps every column of it), and only the two or
//     three tiles that cross the diagonal keep the test; the mask-free steps
//     give rows past q_len a sum, so the store applies JAX's dead-row rule
//     itself;
//   * blocks launch longest rows first (reverse blockIdx.x): the last q tile
//     of a leaf walks the most K/V tiles; the q heads of one GQA group are
//     adjacent in blockIdx.y, so their K/V stay in L2.
#include "attn_tiles.cuh"

namespace fa2 {
namespace {

struct CausalParams {
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
  int Hq, Hkv, Sq, Sk;
  int q_off, kv_off;
  float scale_log2;  // softmax_scale * log2(e)
  Dropout drop;
  int Sq_real, Sk_real;  // the dropout counter's lengths
  int leaf;              // the leaf length T (a multiple of TM)
};

// The 64-row q tile at local row q0 of head h, batch row b.
template <typename T, int D, bool DROP>
__device__ __forceinline__ void causal_tile(const CausalParams& p, float* smem, int q0, int h,
                                            int b) {
  const FwdSmem s = fwd_smem<D>(smem);
  const int hk = h / (p.Hq / p.Hkv);
  const int q_len = p.lens[2 * b], kv_len = p.lens[2 * b + 1];
  const int shift = kv_len - q_len;

  const T* qp = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kp = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vp = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  stage<T, D>(s.Qs, qp, p.q_ss, q0, TM, p.Sq, p.scale_log2);

  // flash_fwd.cu's key range [lo, hi) for a causal tile, cut to the leaf.
  const int row_lo = p.q_off + q0;
  const int row_hi = min(p.q_off + min(q0 + TM, p.Sq), q_len) - 1;  // inclusive
  const int kv_valid = min(p.Sk, kv_len - p.kv_off);
  const int lo = (q0 / p.leaf) * p.leaf;
  int hi = min(min(kv_valid, row_hi + shift + 1 - p.kv_off), lo + p.leaf);
  if (row_hi < row_lo) hi = 0;
  // Local columns below this bound sit at or below the first row's diagonal
  // and inside the real keys: every live row of the tile keeps them.
  const int free_hi = min(kv_valid, row_lo + shift + 1 - p.kv_off);

  float m_run = MASK_LOG2, l_run = 0.f;
  float acc[4][D / 16];
  zero_acc<D>(acc);
  for (int k0 = lo; k0 < hi; k0 += TN) {
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
    if (k0 + TN <= free_hi) {
      fwd_kv_step<T, D>(s, kp, p.k_ss, vp, p.v_ss, k0, kv_valid,
                        [](int, int, float x) { return x; }, drop, m_run, l_run, acc);
    } else {
      auto score = [&](int r, int c, float x) {
        return keep_at(q0 + r, k0 + c, p.Sq, p.Sk, p.q_off, p.kv_off, q_len, kv_len, 1, -1, -1)
                   ? x
                   : neg_inf();
      };
      fwd_kv_step<T, D>(s, kp, p.k_ss, vp, p.v_ss, k0, kv_valid, score, drop, m_run, l_run, acc);
    }
  }

  // JAX's dead-row rule: l = 0 and a zero accumulator give o = 0, lse = -inf.
  const auto dead = [&](int r) {
    const int rg = row_lo + r;
    return !(rg < q_len && rg + shift >= 0);
  };
  if (dead(threadIdx.x / 4)) l_run = 0.f;
  const int ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (dead(ty + 16 * i)) {
#pragma unroll
      for (int j = 0; j < D / 16; ++j) acc[i][j] = 0.f;
    }
  }
  fwd_store<T, D>(s, m_run, l_run, acc, p.lse + ((long long)b * p.Hq + h) * p.Sq + q0,
                  static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh + q0 * p.o_ss, p.o_ss,
                  min(TM, p.Sq - q0), DROP ? p.drop.scale : 1.f);
}

template <typename T, int D, bool DROP>
__global__ void __launch_bounds__(THREADS) causal_diag_kernel(const CausalParams p) {
  extern __shared__ float smem[];
  causal_tile<T, D, DROP>(p, smem, (gridDim.x - 1 - blockIdx.x) * TM, blockIdx.y, blockIdx.z);
}

template <typename T, int D, bool DROP>
cudaError_t launch_kernel(const CausalParams& p, int B, cudaStream_t stream) {
  void (*kernel)(const CausalParams) = causal_diag_kernel<T, D, DROP>;
  const int smem = fwd_smem_floats<D>() * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((p.Sq + TM - 1) / TM, p.Hq, B);
  kernel<<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const CausalParams& p, int B, int D, cudaStream_t stream) {
  const bool drop = p.drop.on;
  switch (D) {
    case 64: return drop ? launch_kernel<T, 64, true>(p, B, stream) : launch_kernel<T, 64, false>(p, B, stream);
    case 128: return drop ? launch_kernel<T, 128, true>(p, B, stream) : launch_kernel<T, 128, false>(p, B, stream);
    case 256: return drop ? launch_kernel<T, 256, true>(p, B, stream) : launch_kernel<T, 256, false>(p, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace fa2

// leaf = T > 0, a multiple of 64: the diag leaves (B9 diag). leaf = 0, once the
// strip (B10), is refused: the strip is fa2_flash_fwd with causal = 1.
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
  fa2::CausalParams p;
  p.q = q; p.k = k; p.v = v; p.o = o; p.lse = lse; p.lens = lens;
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_ss = q_ss;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_ss = k_ss;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_ss = v_ss;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_ss = o_ss;
  p.Hq = Hq; p.Hkv = Hkv; p.Sq = Sq; p.Sk = Sk;
  p.q_off = q_off; p.kv_off = kv_off;
  p.scale_log2 = softmax_scale * fa2::LOG2E;
  p.drop.on = dropout; p.drop.seed = drop_seed; p.drop.threshold = drop_threshold;
  p.drop.scale = drop_scale;
  p.Sq_real = Sq_real; p.Sk_real = Sk_real;
  p.leaf = leaf;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case fa2::kF32: return (int)fa2::launch_d<float>(p, B, D, s);
    case fa2::kF16: return (int)fa2::launch_d<__half>(p, B, D, s);
    case fa2::kBF16: return (int)fa2::launch_d<__nv_bfloat16>(p, B, D, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
