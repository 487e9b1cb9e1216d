// FlashAttention-2 forward for Hopper (sm_90a), written by hand in CUDA C++.
//
// Replaces: fa2_triton_tpu/ops/flash_fwd.py:_fwd_kernel (B1) and
// fa2_triton_tpu/ops/flash_fwd.py:_fwd_tri_square_kernel (B9) as the serving
// prefill and the training forward reach them (padded prompts, causal, GQA,
// and B1's additive bias, indexed by q head as in the JAX package). The two TPU kernels
// compute the same function and differ only in how they fit VMEM and the
// per-grid-step cost of a sequential grid; on the GPU one kernel serves both.
//
// Function: o = softmax(q k^T * scale [softcapped, + bias, masked]) v with a base-2
// online softmax and fp32 accumulators, and the dropout branch of both TPU
// kernels (flash_fwd.py:320-348, 546-554): with dropout_p > 0 an element is
// kept iff counter_hash(seed, ((b * Hq + h) * Sq_real + row) * Sk_real +
// col) >= threshold (common.cuh), l sums the undropped p, only the P V
// product sees the mask, and o = acc / l / (1 - p); lse does not change.
// The kernel is built with and without dropout (the DROP template flag), so
// the dropout-free instantiation carries none of the hash code.
// Per batch row b, lens[b] = (q_len, kv_len) are GLOBAL actual lengths;
// q_off / kv_off place this call's rows and columns in that global frame. Causal and window masks are
// bottom-right aligned on (q_len, kv_len): keep iff
//   row + shift - left <= col <= row + shift + right,  shift = kv_len - q_len.
// Rows that see no valid column (beyond q_len, or masked out entirely) get
// o = 0 and lse = -inf. lse is stored in log2 units, [B, Hq, Sq] fp32.
//
// Bound on the H100: at prefill lengths (S >= 128, D = 128) attention is
// compute-bound (4*S*D flops per 2*D*2 bytes of K/V per query row), so the
// roof is the tensor cores (989 TFLOP/s bf16). This first kernel is the
// simple, correct version: fp32 FMAs on the CUDA cores from shared memory
// tiles, the same code for fp32/fp16/bf16. Its design against the bound:
//   * one block per (64-row q tile, q head, batch); a loop over 32-row KV
//     tiles stands in for the TPU's sequential grid dimension;
//   * q is staged once per block with scale*log2(e) folded in; each thread
//     holds a 4x2 score tile and a 4x(D/16) output tile in registers, so
//     every shared-memory load feeds 2-4 FMAs;
//   * KV tiles beyond the causal limit or kv_len are never loaded;
//   * shared rows are padded by one float so the 16 threads that read 16
//     different K rows hit 16 different banks.
// wgmma + TMA (the route to the tensor-core roof) is later work. The tile
// math lives in attn_tiles.cuh, shared with the backward and varlen kernels.
#include "attn_tiles.cuh"

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
};

// One block per (64-row q tile, q head, batch row); the tile math is
// attn_tiles.cuh's forward.
template <typename T, int D, bool DROP>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(const FwdParams p) {
  extern __shared__ float smem[];
  const FwdSmem s = fwd_smem<D>(smem);
  const int q0 = blockIdx.x * TM, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  const int q_len = p.lens[2 * b], kv_len = p.lens[2 * b + 1];
  const int shift = kv_len - q_len;

  const T* qp = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kp = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vp = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  stage<T, D>(s.Qs, qp, p.q_ss, q0, TM, p.Sq, p.scale_log2);

  // Global rows of this tile that can attend, and the local key range
  // [lo, hi) they need: past the causal/right limit of the last live row,
  // past kv_len, or left of the first row's window nothing is loaded.
  const int row_lo = p.q_off + q0;
  const int row_hi = min(p.q_off + min(q0 + TM, p.Sq), q_len) - 1;  // inclusive
  const int kv_valid = min(p.Sk, kv_len - p.kv_off);  // local rows with real keys
  int hi = kv_valid;
  if (p.causal) {
    hi = min(hi, row_hi + shift + 1 - p.kv_off);
  } else if (p.wr >= 0) {
    hi = min(hi, row_hi + shift + p.wr + 1 - p.kv_off);
  }
  if (row_hi < row_lo) hi = 0;
  const int lo = p.wl >= 0 ? max(0, row_lo + shift - p.wl - p.kv_off) : 0;

  float m_run = MASK_LOG2, l_run = 0.f;
  float acc[4][D / 16];
  zero_acc<D>(acc);
  for (int k0 = (lo / TN) * TN; k0 < hi; k0 += TN) {
    auto score = [&](int r, int c, float x) {
      const bool keep = keep_at(q0 + r, k0 + c, p.Sq, p.Sk, p.q_off, p.kv_off, q_len, kv_len,
                                p.causal, p.wl, p.wr);
      if (p.softcap > 0.f || p.bias != nullptr) {
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
    fwd_kv_step<T, D>(s, kp, p.k_ss, vp, p.v_ss, k0, kv_valid, score, drop, m_run, l_run, acc);
  }
  fwd_store<T, D>(s, m_run, l_run, acc, p.lse + ((long long)b * p.Hq + h) * p.Sq + q0,
                  static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh + q0 * p.o_ss, p.o_ss,
                  min(TM, p.Sq - q0), DROP ? p.drop.scale : 1.f);
}

template <typename T, int D, bool DROP>
cudaError_t launch_kernel(const FwdParams& p, int B, cudaStream_t stream) {
  const int smem = fwd_smem_floats<D>() * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_kernel<T, D, DROP>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((p.Sq + TM - 1) / TM, p.Hq, B);
  flash_fwd_kernel<T, D, DROP><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch(const FwdParams& p, int B, cudaStream_t stream) {
  return p.drop.on ? launch_kernel<T, D, true>(p, B, stream)
                   : launch_kernel<T, D, false>(p, B, stream);
}

template <typename T>
cudaError_t launch_d(const FwdParams& p, int B, int D, cudaStream_t stream) {
  switch (D) {
    case 64: return launch<T, 64>(p, B, stream);
    case 128: return launch<T, 128>(p, B, stream);
    case 256: return launch<T, 256>(p, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace fa2

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
    int Sq_real, int Sk_real, void* stream) {
  fa2::FwdParams p;
  p.q = q; p.k = k; p.v = v; p.o = o; p.lse = lse; p.lens = lens;
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_ss = q_ss;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_ss = k_ss;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_ss = v_ss;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_ss = o_ss;
  p.bias = bias; p.bias_dtype = bias_dtype;
  p.bias_sb = bias_sb; p.bias_sh = bias_sh; p.bias_sq = bias_sq; p.bias_sk = bias_sk;
  p.Hq = Hq; p.Hkv = Hkv; p.Sq = Sq; p.Sk = Sk;
  p.q_off = q_off; p.kv_off = kv_off; p.causal = causal; p.wl = wl; p.wr = wr;
  p.scale_log2 = softmax_scale * fa2::LOG2E;
  p.softcap = softcap;
  p.drop.on = dropout; p.drop.seed = drop_seed; p.drop.threshold = drop_threshold;
  p.drop.scale = drop_scale;
  p.Sq_real = Sq_real; p.Sk_real = Sk_real;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case fa2::kF32: return (int)fa2::launch_d<float>(p, B, D, s);
    case fa2::kF16: return (int)fa2::launch_d<__half>(p, B, D, s);
    case fa2::kBF16: return (int)fa2::launch_d<__nv_bfloat16>(p, B, D, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* fa2_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
