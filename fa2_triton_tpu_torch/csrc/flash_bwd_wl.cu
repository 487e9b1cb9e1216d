// Work-list fused backward for Hopper (sm_90a), written by hand in CUDA C++
// (B14).
//
// Replaces: fa2_triton_tpu/ops/flash_bwd.py:_bwd_fused_wl_kernel (l.1849),
// launched by flash_attn_backward_fused_wl (l.1986 -> l.2120) on the host
// schedule of build_causal_bwd_worklist (l.1779).
//
// Function: the backward of bwd_fused.cuh (5 products per tile pair) over
// exactly the (g, iq, ws) steps of the host's int32 table [nsteps][8] =
// (g, iq, ws, flags, strip, 0, 0, 0): q rows [iq * sub, (iq + 1) * sub) of
// q head hk * group + g against kv columns [ws * sub, (ws + 1) * sub), cut
// to the tensors. The table is the kernel's schedule: it says which tiles
// exist, which are masked (WL_MASK_TRI / WL_MASK_GEN: the causal / window /
// length test on every element; an unmasked step skips it wherever its tile
// lies inside the lengths), and when the fp32 dk / dv strip accumulators
// are zeroed and written (WL_INIT_KV / WL_WRITE_KV) and, with one strip,
// when each row's dq is (WL_INIT_DQ / WL_WRITE_DQ).
//
// Design: the TPU walks the table serially per (batch row, kv head); that
// would fill only B * Hkv of the 132 SMs (32 at 1 x 8192 with 32 heads).
// Here the table is strip-major, and one block per (strip, kv head, batch
// row) walks its strip's steps in table order: 128 blocks at 1 x 8192. A
// block subdivides each sub x sub step into 64-row kv tiles (dk / dv loaded
// from its strip's fp32 accumulators into registers, q rows streamed 32 at a
// time) and adds ds k into a dq accumulator. With several strips (dq_whole,
// the TPU's whole-sequence fp32 dq scratch) each strip's block sums into its
// own fp32 dq partial, zeroed at its first step, and a second kernel adds
// the partials in strip order and rounds dq once: the TPU's init-at-step-0 /
// write-at-the-end, made parallel without atomics or spin-waits. Results are
// bitwise repeatable.
//
// Bound on the H100: 5 S x S x D products over the steps' pairs, compute-
// bound (989 TFLOP/s bf16). This first version does fp32 FMAs on the CUDA
// cores; under causal masking the first strip holds the most steps (58 of
// 136 per head at 1 x 8192), so it sets the time. Written down in PERF.md.
#include "bwd_fused.cuh"

namespace fa2 {
namespace {

// The fp32 dk or dv accumulator of a 64-row kv tile (rows < `rows`) in the
// acc_tile mapping (rows ty + 16 i, columns tx + 16 j): zero, load, store.
template <int D>
__device__ __forceinline__ void kv_acc_zero(float* acc, int rows) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc[r * D + tx + 16 * j] = 0.f;
  }
}

template <int D>
__device__ __forceinline__ void kv_acc_load(const float* acc, int rows, float (&x)[4][D / 16]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) x[i][j] = r < rows ? acc[r * D + tx + 16 * j] : 0.f;
  }
}

template <int D>
__device__ __forceinline__ void kv_acc_store(float* acc, int rows, const float (&x)[4][D / 16]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc[r * D + tx + 16 * j] = x[i][j];
  }
}

template <typename T, int D, bool DROP>
__global__ void __launch_bounds__(THREADS) bwd_wl_kernel(const FusedBwdParams p) {
  extern __shared__ float smem[];
  const DkdvSmem s = dkdv_smem<D>(smem);
  const int part = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int group = p.Hq / p.Hkv;
  const int q_len = p.lens[2 * b], kv_len = p.lens[2 * b + 1];
  const int shift = kv_len - q_len;
  const int q_valid = min(p.Sq, q_len - p.q_off);
  const int kv_valid = min(p.Sk, kv_len - p.kv_off);
  float* dq_base = p.dq_acc + (p.dq_whole ? (long long)part * p.B * p.Hq * p.Sq * D : 0);
  const long long kv_row0 = ((long long)b * p.Hkv + hk) * p.Sk;
  float* dkh = p.dk_acc + kv_row0 * D;
  float* dvh = p.dv_acc + kv_row0 * D;
  const T* kp = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vp = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;

  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    if (p.o != nullptr) delta_rows<T, D>(p, b, h, 0, p.Sq);
    if (p.dq_whole) {
      float* dqh = dq_head<D>(p, dq_base, b, h);
      for (int r0 = 0; r0 < p.Sq; r0 += TN) dq_tile_zero<D>(dqh + (long long)r0 * D, p.Sq - r0);
    }
  }

  for (int st = p.starts[part]; st < p.starts[part + 1]; ++st) {
    const int* e = p.table + 8 * st;
    const int g = e[0], iq = e[1], ws = e[2], flags = e[3], strip = e[4];
    const int h = hk * group + g;
    float* dqh = dq_head<D>(p, dq_base, b, h);
    const int c_lo = strip * p.strip_cols, c_hi = min(c_lo + p.strip_cols, p.Sk);
    const int ra = iq * p.sub, rb = min(ra + p.sub, p.Sq);
    if (flags & WL_INIT_KV) {
      for (int k0 = c_lo; k0 < c_hi; k0 += TM) {
        kv_acc_zero<D>(dkh + (long long)k0 * D, c_hi - k0);
        kv_acc_zero<D>(dvh + (long long)k0 * D, c_hi - k0);
      }
    }
    if (!p.dq_whole && (flags & WL_INIT_DQ)) {
      for (int r0 = ra; r0 < rb; r0 += TN) dq_tile_zero<D>(dqh + (long long)r0 * D, rb - r0);
    }
    const bool masked = (flags & (WL_MASK_GEN | WL_MASK_TRI)) != 0;
    const int wb = min((ws + 1) * p.sub, p.Sk);
    for (int k0 = ws * p.sub; k0 < wb; k0 += TM) {
      __syncthreads();  // the delta rows / the previous tile's K fully consumed
      stage_k<T, D>(p, s.Ks, kp, k0, kv_valid);
      stage<T, D>(s.Vs, vp, p.v_ss, k0, TM, kv_valid, 1.f);
      int r_lo, r_hi;
      kv_tile_rows(p, k0, shift, q_valid, kv_valid, r_lo, r_hi);
      r_lo = max(r_lo, ra);
      r_hi = min(r_hi, rb);
      auto is_free = [&](int r0) { return !masked && r0 + TN <= q_valid && k0 + TM <= kv_valid; };
      const int rows = min(TM, p.Sk - k0);
      float dk_acc[4][D / 16], dv_acc[4][D / 16];
      kv_acc_load<D>(dkh + (long long)k0 * D, rows, dk_acc);
      kv_acc_load<D>(dvh + (long long)k0 * D, rows, dv_acc);
      fused_rows<T, D, DROP>(p, s, b, h, k0, (r_lo / TN) * TN, r_hi, q_len, kv_len, q_valid,
                             is_free, dqh, dk_acc, dv_acc);
      kv_acc_store<D>(dkh + (long long)k0 * D, rows, dk_acc);
      kv_acc_store<D>(dvh + (long long)k0 * D, rows, dv_acc);
    }
    if (flags & WL_WRITE_KV) {
      for (int k0 = c_lo; k0 < c_hi; k0 += TM) {
        float x[4][D / 16];
        const int rows = min(TM, c_hi - k0);
        kv_acc_load<D>(dkh + (long long)k0 * D, rows, x);
        store_tile<T, D>(x, static_cast<T*>(p.dk) + b * p.dk_sb + hk * p.dk_sh + k0 * p.dk_ss,
                         p.dk_ss, rows, p.scale);
        kv_acc_load<D>(dvh + (long long)k0 * D, rows, x);
        store_tile<T, D>(x, static_cast<T*>(p.dv) + b * p.dv_sb + hk * p.dv_sh + k0 * p.dv_ss,
                         p.dv_ss, rows, 1.f);
      }
    }
    if (!p.dq_whole && (flags & WL_WRITE_DQ)) {
      T* out = static_cast<T*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
      for (int r0 = ra; r0 < rb; r0 += TN) {
        dq_tile_write<T, D>(dqh + (long long)r0 * D, out + r0 * p.dq_ss, p.dq_ss, rb - r0);
      }
    }
  }
}

// dq = (sum of the strips' fp32 partials, in strip order) / log2e, in T.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS) wl_dq_reduce_kernel(const FusedBwdParams p, int parts) {
  const long long n = (long long)p.B * p.Hq * p.Sq * D;
  for (long long i = blockIdx.x * (long long)THREADS + threadIdx.x; i < n;
       i += (long long)gridDim.x * THREADS) {
    float acc = 0.f;
    for (int s = 0; s < parts; ++s) acc += p.dq_acc[s * n + i];
    const int d = (int)(i % D);
    const long long row = i / D;
    const int r = (int)(row % p.Sq);
    const int h = (int)((row / p.Sq) % p.Hq);
    const int b = (int)(row / ((long long)p.Sq * p.Hq));
    static_cast<T*>(p.dq)[b * p.dq_sb + h * p.dq_sh + r * p.dq_ss + d] =
        from_f<T>(acc * (1.f / LOG2E));
  }
}

template <typename T, int D, bool DROP>
cudaError_t launch_kernel(const FusedBwdParams& p, int parts, cudaStream_t stream) {
  const int smem = dkdv_smem_floats<D>() * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(bwd_wl_kernel<T, D, DROP>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  bwd_wl_kernel<T, D, DROP><<<dim3(parts, p.Hkv, p.B), THREADS, smem, stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess || !p.dq_whole) return e;
  const long long n = (long long)p.B * p.Hq * p.Sq * D;
  const long long want = (n + THREADS - 1) / THREADS, cap = 132 * 16;
  const int blocks = (int)(want < cap ? want : cap);
  wl_dq_reduce_kernel<T, D><<<blocks, THREADS, 0, stream>>>(p, parts);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const FusedBwdParams& p, int parts, int D, cudaStream_t stream) {
  const bool drop = p.drop.on;
  switch (D) {
    case 64: return drop ? launch_kernel<T, 64, true>(p, parts, stream) : launch_kernel<T, 64, false>(p, parts, stream);
    case 128: return drop ? launch_kernel<T, 128, true>(p, parts, stream) : launch_kernel<T, 128, false>(p, parts, stream);
    case 256: return drop ? launch_kernel<T, 256, true>(p, parts, stream) : launch_kernel<T, 256, false>(p, parts, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace fa2

// The table (device int32 [nsteps][8]) and `starts` (device int32
// [parts + 1], the first step of each strip, strip-major) come from
// build_causal_bwd_worklist; sub and strip_cols (the strip width block_kv)
// are multiples of 64. dq_whole = 0 (one strip): dq_acc is fp32 [B, Hq, Sq,
// D] and each row is initialised and written at its table flags; dq_whole =
// 1: dq_acc is fp32 [parts, B, Hq, Sq, D] partials and a second kernel
// writes dq. dk_acc / dv_acc: fp32 [B, Hkv, Sk, D]. k_mul and o as in
// fa2_flash_bwd_tri; the in-kernel delta needs one strip (one block per
// batch row and kv head writes it).
extern "C" int fa2_flash_bwd_wl(
    int dtype, int B, int Hq, int Hkv, int Sq, int Sk, int D,
    const void* q, const void* k, const void* v, const void* dout, const void* o,
    const float* lse, const float* delta, float* delta_buf, float* dq_acc,
    float* dk_acc, float* dv_acc, void* dq, void* dk, void* dv,
    const int* table, const int* starts, int parts, int sub, int strip_cols, int dq_whole,
    const int* lens, const long long* strides,
    int q_off, int kv_off, int causal, int wl, int wr, float softmax_scale, float k_mul,
    int dropout, unsigned int drop_seed, unsigned int drop_threshold, float drop_scale,
    int Sq_real, int Sk_real, void* stream) {
  if (sub <= 0 || sub % fa2::TM != 0 || strip_cols % sub != 0 || parts <= 0 ||
      (o != nullptr && (dq_whole || parts != 1))) {
    return (int)cudaErrorInvalidValue;
  }
  fa2::FusedBwdParams p = {};
  p.q = q; p.k = k; p.v = v; p.dout = dout; p.o = o;
  p.lse = lse; p.delta = delta; p.delta_buf = delta_buf; p.dq_acc = dq_acc;
  p.dk_acc = dk_acc; p.dv_acc = dv_acc;
  p.dq = dq; p.dk = dk; p.dv = dv; p.lens = lens;
  fa2::fill_strides(p, strides);
  p.B = B; p.Hq = Hq; p.Hkv = Hkv; p.Sq = Sq; p.Sk = Sk;
  p.q_off = q_off; p.kv_off = kv_off; p.causal = causal; p.wl = wl; p.wr = wr;
  p.scale = softmax_scale; p.k_mul = k_mul;
  p.drop.on = dropout; p.drop.seed = drop_seed; p.drop.threshold = drop_threshold;
  p.drop.scale = drop_scale;
  p.Sq_real = Sq_real; p.Sk_real = Sk_real;
  p.table = table; p.starts = starts; p.sub = sub; p.strip_cols = strip_cols;
  p.dq_whole = dq_whole;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case fa2::kF32: return (int)fa2::launch_d<float>(p, parts, D, st);
    case fa2::kF16: return (int)fa2::launch_d<__half>(p, parts, D, st);
    case fa2::kBF16: return (int)fa2::launch_d<__nv_bfloat16>(p, parts, D, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
