// Short causal fused backward for Hopper (sm_90a), written by hand in CUDA
// C++: the tri-square backward (B13) and the split schedule's diagonal
// leaves (B13 diag).
//
// Replaces: fa2_triton_tpu/ops/flash_bwd.py:_bwd_tri_square_kernel (l.845),
// launched by flash_attn_backward_tri_square (l.985 -> l.1021, the k fold
// and delta in the kernel) and, in its diag_stride / leaf_subs mode, by
// flash_attn_backward_causal_diag (l.1060 -> l.1095, prescaled k and the
// global delta given).
//
// Function: the causal backward of bwd_fused.cuh (the TPU kernel's 5-product
// tile math), bottom-right aligned on lens[b] = (q_len, kv_len) in the global
// frame of q_off / kv_off. With a leaf length T (diag), local row r meets
// only the local columns of its own leaf [T * (r / T), T * (r / T + 1)); the
// split's rectangles (flash_bwd.cu in its region mode) add the rest, and the
// outputs are full-size.
//
// Design: like the TPU grid, one block per (batch row, kv head) — times the
// leaf for the diag — owns the whole sequence (or leaf) and the whole GQA
// group: it walks the 64-row kv tiles in order, keeps each tile's dk / dv in
// registers over the group's q rows at or below the diagonal, and adds each
// q tile's ds k into an fp32 dq accumulator that only it writes; dq is
// rounded once at the end. A prologue zeroes that accumulator and, in the
// tri-square, computes delta = rowsum(o * do) - adj for the block's rows.
// Tiles wholly below the diagonal and inside the lengths skip the mask test.
//
// Bound on the H100: 5 S x S x D products over the causal pairs, compute-
// bound at these lengths (989 TFLOP/s bf16 tensor-core peak). This first
// version does fp32 FMAs on the CUDA cores; and one block per (batch row,
// kv head) fills only B * Hkv of the 132 SMs (64 at 2 x 2048 with 32 heads).
// Both are written down in PERF.md, not fixed here.
#include "bwd_fused.cuh"

namespace fa2 {
namespace {

template <typename T, int D, bool DROP>
__global__ void __launch_bounds__(THREADS) bwd_tri_kernel(const FusedBwdParams p) {
  extern __shared__ float smem[];
  const DkdvSmem s = dkdv_smem<D>(smem);
  const int hk = blockIdx.y, b = blockIdx.z;
  const int group = p.Hq / p.Hkv;
  const int q_len = p.lens[2 * b], kv_len = p.lens[2 * b + 1];
  const int shift = kv_len - q_len;
  const int q_valid = min(p.Sq, q_len - p.q_off);
  const int kv_valid = min(p.Sk, kv_len - p.kv_off);
  // The block's rows [R0, R1) and columns [C0, C1): one leaf, or all.
  int R0 = 0, R1 = p.Sq, C0 = 0, C1 = p.Sk;
  if (p.leaf > 0) {
    R0 = C0 = blockIdx.x * p.leaf;
    R1 = min(R0 + p.leaf, p.Sq);
    C1 = min(C0 + p.leaf, p.Sk);
  }

  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    float* dqh = dq_head<D>(p, p.dq_acc, b, h);
    for (int r0 = R0; r0 < R1; r0 += TN) dq_tile_zero<D>(dqh + (long long)r0 * D, R1 - r0);
    if (p.o != nullptr) delta_rows<T, D>(p, b, h, R0, R1);
  }

  const T* kp = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vp = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  for (int k0 = C0; k0 < C1; k0 += TM) {
    __syncthreads();  // the delta rows / the previous tile's K fully consumed
    stage_k<T, D>(p, s.Ks, kp, k0, kv_valid);
    stage<T, D>(s.Vs, vp, p.v_ss, k0, TM, kv_valid, 1.f);
    int r_lo, r_hi;
    kv_tile_rows(p, k0, shift, q_valid, kv_valid, r_lo, r_hi);
    r_lo = max(r_lo, R0);
    r_hi = min(r_hi, R1);
    // A q tile at r0 keeps all of this kv tile when the tile's last column
    // is at or below the diagonal of its first row, inside the lengths.
    auto is_free = [&](int r0) {
      return r0 + TN <= q_valid && k0 + TM <= kv_valid &&
             p.kv_off + k0 + TM - 1 <= p.q_off + r0 + shift;
    };
    float dk_acc[4][D / 16], dv_acc[4][D / 16];
    zero_acc<D>(dk_acc);
    zero_acc<D>(dv_acc);
    for (int g = 0; g < group; ++g) {
      const int h = hk * group + g;
      fused_rows<T, D, DROP>(p, s, b, h, k0, (r_lo / TN) * TN, r_hi, q_len, kv_len, q_valid,
                             is_free, dq_head<D>(p, p.dq_acc, b, h), dk_acc, dv_acc);
    }
    const int rows = min(TM, p.Sk - k0);
    store_tile<T, D>(dk_acc, static_cast<T*>(p.dk) + b * p.dk_sb + hk * p.dk_sh + k0 * p.dk_ss,
                     p.dk_ss, rows, p.scale);
    store_tile<T, D>(dv_acc, static_cast<T*>(p.dv) + b * p.dv_sb + hk * p.dv_sh + k0 * p.dv_ss,
                     p.dv_ss, rows, 1.f);
  }

  // Each accumulator element is written here by the thread that summed it.
  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const float* dqh = dq_head<D>(p, p.dq_acc, b, h);
    T* out = static_cast<T*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
    for (int r0 = R0; r0 < R1; r0 += TN) {
      dq_tile_write<T, D>(dqh + (long long)r0 * D, out + r0 * p.dq_ss, p.dq_ss, R1 - r0);
    }
  }
}

template <typename T, int D, bool DROP>
cudaError_t launch_kernel(const FusedBwdParams& p, cudaStream_t stream) {
  const int smem = dkdv_smem_floats<D>() * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(bwd_tri_kernel<T, D, DROP>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const int leaves = p.leaf > 0 ? (p.Sq + p.leaf - 1) / p.leaf : 1;
  dim3 grid(leaves, p.Hkv, p.B);
  bwd_tri_kernel<T, D, DROP><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const FusedBwdParams& p, int D, cudaStream_t stream) {
  const bool drop = p.drop.on;
  switch (D) {
    case 64: return drop ? launch_kernel<T, 64, true>(p, stream) : launch_kernel<T, 64, false>(p, stream);
    case 128: return drop ? launch_kernel<T, 128, true>(p, stream) : launch_kernel<T, 128, false>(p, stream);
    case 256: return drop ? launch_kernel<T, 256, true>(p, stream) : launch_kernel<T, 256, false>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace fa2

// leaf = 0: the tri-square (B13), one block per (batch row, kv head); leaf =
// T > 0, a multiple of 64 with Sq == Sk: the diag leaves (B13 diag). k_mul =
// scale * log2e folds k in the kernel; 0 takes k prescaled. o non-null: delta
// = rowsum(o * do) - delta (the dlse adjustment, nullable) into delta_buf;
// null: delta is the delta. dq_acc: fp32 [B, Hq, Sq, D] scratch.
extern "C" int fa2_flash_bwd_tri(
    int dtype, int leaf, int B, int Hq, int Hkv, int Sq, int Sk, int D,
    const void* q, const void* k, const void* v, const void* dout, const void* o,
    const float* lse, const float* delta, float* delta_buf, float* dq_acc,
    void* dq, void* dk, void* dv, const int* lens, const long long* strides,
    int q_off, int kv_off, float softmax_scale, float k_mul,
    int dropout, unsigned int drop_seed, unsigned int drop_threshold, float drop_scale,
    int Sq_real, int Sk_real, void* stream) {
  if (leaf < 0 || leaf % fa2::TM != 0 || (leaf > 0 && Sq != Sk)) return (int)cudaErrorInvalidValue;
  fa2::FusedBwdParams p = {};
  p.q = q; p.k = k; p.v = v; p.dout = dout; p.o = o;
  p.lse = lse; p.delta = delta; p.delta_buf = delta_buf; p.dq_acc = dq_acc;
  p.dq = dq; p.dk = dk; p.dv = dv; p.lens = lens;
  fa2::fill_strides(p, strides);
  p.B = B; p.Hq = Hq; p.Hkv = Hkv; p.Sq = Sq; p.Sk = Sk;
  p.q_off = q_off; p.kv_off = kv_off; p.causal = 1; p.wl = -1; p.wr = -1;
  p.scale = softmax_scale; p.k_mul = k_mul;
  p.drop.on = dropout; p.drop.seed = drop_seed; p.drop.threshold = drop_threshold;
  p.drop.scale = drop_scale;
  p.Sq_real = Sq_real; p.Sk_real = Sk_real;
  p.leaf = leaf;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case fa2::kF32: return (int)fa2::launch_d<float>(p, D, st);
    case fa2::kF16: return (int)fa2::launch_d<__half>(p, D, st);
    case fa2::kBF16: return (int)fa2::launch_d<__nv_bfloat16>(p, D, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
