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
// lies inside the lengths), and, with one strip, when each row's dq is
// initialised and written (WL_INIT_DQ / WL_WRITE_DQ).
//
// Bound on the H100: 5 S x S x D products over the steps' pairs, compute-
// bound (989 TFLOP/s bf16).
//
// Design, 16-bit inputs (bwd_wl_mma_kernel, bwd_mma.cuh's tensor-core
// tiles): the TPU walks the table serially per (batch row, kv head). Here
// the host partition (ops/flash_bwd.py:wl_partition) cuts each strip's steps
// at row boundaries into chunks of about equal work, enough chunks to fill
// the card; one block per (chunk, kv head, batch row). A block walks the
// strip's kv tiles in column order, keeps each tile's dk / dv in registers
// over every step of its chunk that meets the tile (each with its own mask
// flags) and writes them once into the chunk's fp32 dk / dv partial over the
// strip's columns. Its rows' dq is zeroed at the start and summed in fp32:
// with several strips (dq_whole) into the strip's dq partial, whose rows the
// strip's chunks share out; with one strip into the dq accumulator, written
// at the WL_WRITE_DQ steps, after the in-kernel delta of its rows. A reduce
// kernel adds the chunk partials of each kv row in chunk order and the strip
// partials of each q row in strip order, and rounds dk, dv (and dq) once.
// No atomics, no inter-block flags: bitwise repeatable.
//
// fp32 inputs keep the FMA kernel (bwd_wl_kernel: one block per
// strip walking its steps in table order, fp32 dk / dv strip accumulators
// zeroed and written at WL_INIT_KV / WL_WRITE_KV, attn_tiles.cuh's tiles).
//
// Head dims 384 and 512 compile in flash_bwd_wl_wide.cu (this file with
// FA2_WIDE defined), beside 64 / 128 / 256 here, so that the two build in
// parallel: the 16-bit tiles of bwd_mma.cuh's FusedKv past D 256 (32 kv
// rows, 32-row q tiles), FmaTile's 32 x 16 tiles for fp32.
#include "bwd_mma.cuh"

namespace fa2 {

// The launch at head dim 384 or 512 (flash_bwd_wl_wide.cu).
int launch_wl_wide(const FusedBwdParams& p, int dtype, int parts, int D, void* stream);

namespace {

// The fp32 dk or dv accumulator of an FmaTile<D>::M-row kv tile (rows <
// `rows`) in the acc_tile mapping (rows ty + 16 i, columns tx + 16 j):
// zero, load, store.
template <int D>
__device__ __forceinline__ void kv_acc_zero(float* acc, int rows) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < FmaTile<D>::RI; ++i) {
    const int r = ty + 16 * i;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc[r * D + tx + 16 * j] = 0.f;
  }
}

template <int D>
__device__ __forceinline__ void kv_acc_load(const float* acc, int rows, FmaAcc<D>& x) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < FmaTile<D>::RI; ++i) {
    const int r = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) x[i][j] = r < rows ? acc[r * D + tx + 16 * j] : 0.f;
  }
}

template <int D>
__device__ __forceinline__ void kv_acc_store(float* acc, int rows, const FmaAcc<D>& x) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < FmaTile<D>::RI; ++i) {
    const int r = ty + 16 * i;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc[r * D + tx + 16 * j] = x[i][j];
  }
}

template <typename T, int D, bool DROP>
__global__ void __launch_bounds__(THREADS) bwd_wl_kernel(const FusedBwdParams p) {
  constexpr int M = FmaTile<D>::M, N = FmaTile<D>::N;
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
      for (int r0 = 0; r0 < p.Sq; r0 += N) dq_tile_zero<D>(dqh + (long long)r0 * D, p.Sq - r0);
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
      for (int k0 = c_lo; k0 < c_hi; k0 += M) {
        kv_acc_zero<D>(dkh + (long long)k0 * D, c_hi - k0);
        kv_acc_zero<D>(dvh + (long long)k0 * D, c_hi - k0);
      }
    }
    if (!p.dq_whole && (flags & WL_INIT_DQ)) {
      for (int r0 = ra; r0 < rb; r0 += N) dq_tile_zero<D>(dqh + (long long)r0 * D, rb - r0);
    }
    const bool masked = (flags & (WL_MASK_GEN | WL_MASK_TRI)) != 0;
    const int wb = min((ws + 1) * p.sub, p.Sk);
    for (int k0 = ws * p.sub; k0 < wb; k0 += M) {
      __syncthreads();  // the delta rows / the previous tile's K fully consumed
      stage_k<T, D>(p, s.Ks, kp, k0, kv_valid);
      stage<T, D>(s.Vs, vp, p.v_ss, k0, M, kv_valid, 1.f);
      int r_lo, r_hi;
      kv_tile_rows(p, k0, min(k0 + M, kv_valid), shift, q_valid, r_lo, r_hi);
      r_lo = max(r_lo, ra);
      r_hi = min(r_hi, rb);
      auto is_free = [&](int r0) { return !masked && r0 + N <= q_valid && k0 + M <= kv_valid; };
      const int rows = min(M, p.Sk - k0);
      FmaAcc<D> dk_acc, dv_acc;
      kv_acc_load<D>(dkh + (long long)k0 * D, rows, dk_acc);
      kv_acc_load<D>(dvh + (long long)k0 * D, rows, dv_acc);
      fused_rows<T, D, DROP>(p, s, b, h, k0, (r_lo / N) * N, r_hi, q_len, kv_len, q_valid,
                             is_free, dqh, dk_acc, dv_acc);
      kv_acc_store<D>(dkh + (long long)k0 * D, rows, dk_acc);
      kv_acc_store<D>(dvh + (long long)k0 * D, rows, dv_acc);
    }
    if (flags & WL_WRITE_KV) {
      for (int k0 = c_lo; k0 < c_hi; k0 += M) {
        FmaAcc<D> x;
        const int rows = min(M, c_hi - k0);
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
      for (int r0 = ra; r0 < rb; r0 += N) {
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
cudaError_t launch_fma(const FusedBwdParams& p, int parts, cudaStream_t stream) {
  const int smem = dkdv_smem_floats<D>() * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(bwd_wl_kernel<T, D, DROP>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  bwd_wl_kernel<T, D, DROP><<<dim3(parts, p.Hkv, p.B), THREADS, smem, stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess || !p.dq_whole) return e;
  const long long n = (long long)p.B * p.Hq * p.Sq * D;
  wl_dq_reduce_kernel<T, D><<<stride_blocks(n), THREADS, 0, stream>>>(p, parts);
  return cudaGetLastError();
}

// One (step, q tile) of a kv tile's walk; st == end marks the end.
struct WlItem {
  int st, r0, rb;
};

template <typename T, int D, bool DROP>
__global__ void __launch_bounds__(THREADS, 1) bwd_wl_mma_kernel(const FusedBwdParams p) {
  using C = MmaCfg<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const MmaSmem<T> s = mma_smem<C, T>(smem_raw);
  const int chunk = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int group = p.Hq / p.Hkv;
  const int q_len = p.lens[2 * b], kv_len = p.lens[2 * b + 1];
  const int shift = kv_len - q_len;
  const int q_valid = min(p.Sq, q_len - p.q_off);
  const int kv_valid = min(p.Sk, kv_len - p.kv_off);
  const int st0 = p.part[chunk], st1 = p.part[chunk + 1];
  const int strip = p.table[8 * st0 + 4];
  float* dq_base = p.dq_acc + (p.dq_whole ? (long long)strip * p.B * p.Hq * p.Sq * D : 0);
  const long long part_row0 = (((long long)chunk * p.B + b) * p.Hkv + hk) * p.strip_cols;
  float* dkp = p.dk_acc + part_row0 * D;
  float* dvp = p.dv_acc + part_row0 * D;
  const T* kp = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vp = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  const float* delta = p.o != nullptr ? p.delta_buf : p.delta;

  // The chunk's rows (its steps' (g, iq), each a run of steps): zero their dq
  // and, with o, compute their delta.
  for (int st = st0; st < st1; ++st) {
    const int* e = p.table + 8 * st;
    if (st > st0 && e[0] == e[-8] && e[1] == e[-7]) continue;
    const int h = hk * group + e[0], ra = e[1] * p.sub, rb = min(ra + p.sub, p.Sq);
    float* dqh = dq_head<D>(p, dq_base, b, h);
    for (int i = threadIdx.x; i < (rb - ra) * (D / 4); i += THREADS) {
      *reinterpret_cast<float4*>(dqh + (long long)ra * D + 4 * i) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    if (p.o != nullptr) delta_rows<T, D>(p, b, h, ra, rb);
  }

  const int nsub = p.strip_cols / p.sub, c_lo = strip * p.strip_cols;
  for (int ws = strip * nsub; ws < (strip + 1) * nsub && ws * p.sub < p.Sk; ++ws) {
    const int w_end = min((ws + 1) * p.sub, p.Sk);
    for (int k0 = ws * p.sub; k0 < w_end; k0 += C::BKV) {
      const int c_end = min(k0 + C::BKV, w_end), c_lim = min(c_end, kv_valid);
      int r_lo, r_hi;
      kv_tile_rows(p, k0, c_lim, shift, q_valid, r_lo, r_hi);
      // The first q tile at or after step `st` of this ws that meets the tile.
      auto first_item = [&](int st) -> WlItem {
        for (; st < st1; ++st) {
          const int* e = p.table + 8 * st;
          if (e[2] != ws) continue;
          const int ra = max(e[1] * p.sub, r_lo), rb = min(min(e[1] * p.sub + p.sub, p.Sq), r_hi);
          if (ra < rb) return {st, (ra / C::BQ) * C::BQ, rb};
        }
        return {st1, 0, 0};
      };
      auto next_item = [&](WlItem it) -> WlItem {
        it.r0 += C::BQ;
        return it.r0 < it.rb ? it : first_item(it.st + 1);
      };
      float dk[C::NT_KV][4], dv[C::NT_KV][4];
      mma_zero_kv<C>(dk, dv);
      WlItem it = first_item(st0);
      __syncthreads();  // dq zeroed and delta written / the previous tile consumed
      if (it.st < st1) {
        mma_load_kv<C, T>(p, s, kp, vp, k0, c_lim);
        auto issue = [&](const WlItem& x, int buf) {
          const int h = hk * group + p.table[8 * x.st];
          const long long row0 = ((long long)b * p.Hq + h) * p.Sq;
          mma_load_q<C, T>(p, s, buf, b, h, x.r0, q_valid, p.lse + row0, delta + row0);
        };
        issue(it, 0);
        cp_async_commit();
        for (int i = 0; it.st < st1; ++i) {
          const WlItem nx = next_item(it);
          if (nx.st < st1) {
            issue(nx, (i + 1) & 1);
            cp_async_commit();
            cp_async_wait<1>();
          } else {
            cp_async_wait<0>();
          }
          __syncthreads();
          const int* e = p.table + 8 * it.st;
          const int h = hk * group + e[0];
          const bool masked = (e[3] & (WL_MASK_GEN | WL_MASK_TRI)) != 0;
          const bool free_tile = !masked && it.r0 + C::BQ <= q_valid && c_lim == k0 + C::BKV;
          mma_q_step<C, T, true>(
              s, i & 1, fused_elem<DROP>(p, b, h, it.r0, k0, c_lim, free_tile, q_len, kv_len), dk,
              dv);
          __syncthreads();
          mma_dq_step<C, T>(s, dq_head<D>(p, dq_base, b, h), it.r0, p.Sq, false);
          it = nx;
        }
      }
      mma_store_kv_f32<C>(dk, dkp + (long long)(k0 - c_lo) * D, c_end - k0);
      mma_store_kv_f32<C>(dv, dvp + (long long)(k0 - c_lo) * D, c_end - k0);
    }
  }

  if (!p.dq_whole) {
    __syncthreads();  // every thread's dq sums are in
    for (int st = st0; st < st1; ++st) {
      const int* e = p.table + 8 * st;
      if (!(e[3] & WL_WRITE_DQ)) continue;
      const int h = hk * group + e[0], ra = e[1] * p.sub, rb = min(ra + p.sub, p.Sq);
      const float* dqh = dq_head<D>(p, dq_base, b, h);
      T* out = static_cast<T*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
      for (int i = threadIdx.x; i < (rb - ra) * (D / 4); i += THREADS) {
        const int r = ra + i / (D / 4), d = (i % (D / 4)) * 4;
        const float4 v = *reinterpret_cast<const float4*>(dqh + (long long)r * D + d);
        T* o = out + (long long)r * p.dq_ss + d;
        o[0] = from_f<T>(v.x * (1.f / LOG2E));
        o[1] = from_f<T>(v.y * (1.f / LOG2E));
        o[2] = from_f<T>(v.z * (1.f / LOG2E));
        o[3] = from_f<T>(v.w * (1.f / LOG2E));
      }
    }
  }
}

// dk = scale * (the chunk partials of each kv row, in chunk order), dv the
// same sum, each rounded once to T; with several strips also dq = (the strip
// partials of each q row whose q-row block the strip covers, in strip order)
// / log2e.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS) wl_mma_reduce_kernel(const FusedBwdParams p,
                                                                int strips) {
  const int* strip_chunks = p.part + p.nparts + 1;
  const int* cover = strip_chunks + strips + 1;
  const int nq = (p.Sq + p.sub - 1) / p.sub;
  const long long n_kv = (long long)p.B * p.Hkv * p.Sk * (D / 4);
  const long long n_q = p.dq_whole ? (long long)p.B * p.Hq * p.Sq * (D / 4) : 0;
  const long long chunk_stride = (long long)p.B * p.Hkv * p.strip_cols * D;
  const long long strip_stride = (long long)p.B * p.Hq * p.Sq * D;
  for (long long i = blockIdx.x * (long long)THREADS + threadIdx.x; i < n_kv + n_q;
       i += (long long)gridDim.x * THREADS) {
    if (i < n_kv) {
      const int d = (int)(i % (D / 4)) * 4;
      const long long row = i / (D / 4);
      const int col = (int)(row % p.Sk), hk = (int)((row / p.Sk) % p.Hkv);
      const int b = (int)(row / ((long long)p.Sk * p.Hkv));
      const int st = col / p.strip_cols;
      const long long off = (((long long)b * p.Hkv + hk) * p.strip_cols + col - st * p.strip_cols) * D + d;
      float k4[4] = {0.f, 0.f, 0.f, 0.f}, v4[4] = {0.f, 0.f, 0.f, 0.f};
      for (int c = strip_chunks[st]; c < strip_chunks[st + 1]; ++c) {
        const float4 a = *reinterpret_cast<const float4*>(p.dk_acc + c * chunk_stride + off);
        const float4 v = *reinterpret_cast<const float4*>(p.dv_acc + c * chunk_stride + off);
        k4[0] += a.x; k4[1] += a.y; k4[2] += a.z; k4[3] += a.w;
        v4[0] += v.x; v4[1] += v.y; v4[2] += v.z; v4[3] += v.w;
      }
      T* dk = static_cast<T*>(p.dk) + b * p.dk_sb + hk * p.dk_sh + (long long)col * p.dk_ss + d;
      T* dv = static_cast<T*>(p.dv) + b * p.dv_sb + hk * p.dv_sh + (long long)col * p.dv_ss + d;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        dk[k] = from_f<T>(k4[k] * p.scale);
        dv[k] = from_f<T>(v4[k]);
      }
    } else {
      const long long j = i - n_kv;
      const int d = (int)(j % (D / 4)) * 4;
      const long long row = j / (D / 4);
      const int r = (int)(row % p.Sq), h = (int)((row / p.Sq) % p.Hq);
      const int b = (int)(row / ((long long)p.Sq * p.Hq));
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int st = 0; st < strips; ++st) {
        if (!cover[st * nq + r / p.sub]) continue;
        const float4 a = *reinterpret_cast<const float4*>(p.dq_acc + st * strip_stride + row * D + d);
        acc[0] += a.x; acc[1] += a.y; acc[2] += a.z; acc[3] += a.w;
      }
      T* out = static_cast<T*>(p.dq) + b * p.dq_sb + h * p.dq_sh + (long long)r * p.dq_ss + d;
#pragma unroll
      for (int k = 0; k < 4; ++k) out[k] = from_f<T>(acc[k] * (1.f / LOG2E));
    }
  }
}

template <typename T, int D, bool DROP>
cudaError_t launch_mma(const FusedBwdParams& p, cudaStream_t stream) {
  using C = MmaCfg<D>;
  // The host partition (ops/flash_bwd.py) lists tiles of these sizes.
  if (p.tile_q != C::BQ || p.tile_kv != C::BKV) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(bwd_wl_mma_kernel<T, D, DROP>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM_BYTES);
  if (e != cudaSuccess) return e;
  bwd_wl_mma_kernel<T, D, DROP>
      <<<dim3(p.nparts, p.Hkv, p.B), THREADS, C::SMEM_BYTES, stream>>>(p);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const int strips = (p.Sk + p.strip_cols - 1) / p.strip_cols;
  const long long n = (long long)p.B * (p.Hkv * (long long)p.Sk + (p.dq_whole ? (long long)p.Hq * p.Sq : 0)) * (D / 4);
  wl_mma_reduce_kernel<T, D><<<stride_blocks(n), THREADS, 0, stream>>>(p, strips);
  return cudaGetLastError();
}

template <typename T, int D, bool DROP>
cudaError_t launch_kernel(const FusedBwdParams& p, int parts, cudaStream_t stream) {
  if constexpr (std::is_same<T, float>::value) {
    return launch_fma<T, D, DROP>(p, parts, stream);
  } else {
    return launch_mma<T, D, DROP>(p, stream);
  }
}

template <typename T, int D>
cudaError_t launch(const FusedBwdParams& p, int parts, cudaStream_t stream) {
  return p.drop.on ? launch_kernel<T, D, true>(p, parts, stream)
                   : launch_kernel<T, D, false>(p, parts, stream);
}

// The head dims of this translation unit: 64 / 128 / 256 here, 384 / 512 in
// flash_bwd_wl_wide.cu.
template <typename T>
cudaError_t launch_d(const FusedBwdParams& p, int parts, int D, cudaStream_t stream) {
  switch (D) {
#ifdef FA2_WIDE
    case 384: return launch<T, 384>(p, parts, stream);
    case 512: return launch<T, 512>(p, parts, stream);
#else
    case 64: return launch<T, 64>(p, parts, stream);
    case 128: return launch<T, 128>(p, parts, stream);
    case 256: return launch<T, 256>(p, parts, stream);
#endif
    default: return cudaErrorInvalidValue;
  }
}

int launch_dtype(const FusedBwdParams& p, int dtype, int parts, int D, void* stream) {
#ifndef FA2_WIDE
  if (D > 256) return launch_wl_wide(p, dtype, parts, D, stream);
#endif
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return (int)launch_d<float>(p, parts, D, st);
    case kF16: return (int)launch_d<__half>(p, parts, D, st);
    case kBF16: return (int)launch_d<__nv_bfloat16>(p, parts, D, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

#ifdef FA2_WIDE
int launch_wl_wide(const FusedBwdParams& p, int dtype, int parts, int D, void* stream) {
  return launch_dtype(p, dtype, parts, D, stream);
}
#endif
}  // namespace fa2

#ifndef FA2_WIDE

// The table (device int32 [nsteps][8]) and `starts` (device int32
// [parts + 1], the first step of each strip, strip-major) come from
// build_causal_bwd_worklist; sub and strip_cols (the strip width block_kv)
// are multiples of 64. dq_whole = 0 (one strip): dq_acc is fp32 [B, Hq, Sq,
// D] and each row is initialised and written at its table flags; dq_whole =
// 1: dq_acc is fp32 [parts, B, Hq, Sq, D] partials and a second kernel
// writes dq. dk_acc / dv_acc: fp32 [B, Hkv, Sk, D]. k_mul and o as in
// fa2_flash_bwd_tri; the in-kernel delta needs one strip. 16-bit inputs:
// part (device int32, wl_partition's table) with nparts chunks, counted in
// tile_q x tile_kv tiles (MmaCfg's, else the call fails); dq_acc is
// fp32 [strips, B, Hq, Sq, D] with dq_whole (strips = ceil(Sk / strip_cols)),
// else [B, Hq, Sq, D]; dk_acc / dv_acc are the chunks' fp32 partials
// [nparts, B, Hkv, strip_cols, D]; rows, strides and base pointers of q, k,
// v, do 16-byte aligned.
extern "C" int fa2_flash_bwd_wl(
    int dtype, int B, int Hq, int Hkv, int Sq, int Sk, int D,
    const void* q, const void* k, const void* v, const void* dout, const void* o,
    const float* lse, const float* delta, float* delta_buf, float* dq_acc,
    float* dk_acc, float* dv_acc, void* dq, void* dk, void* dv,
    const int* table, const int* starts, int parts, int sub, int strip_cols, int dq_whole,
    const int* lens, const long long* strides,
    int q_off, int kv_off, int causal, int wl, int wr, float softmax_scale, float k_mul,
    int dropout, unsigned int drop_seed, unsigned int drop_threshold, float drop_scale,
    int Sq_real, int Sk_real, const int* part, int nparts, int tile_q, int tile_kv,
    void* stream) {
  if (sub <= 0 || sub % fa2::TM != 0 || strip_cols % sub != 0 || parts <= 0 ||
      (o != nullptr && (dq_whole || parts != 1)) ||
      (dtype != fa2::kF32 && (part == nullptr || nparts <= 0))) {
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
  p.part = part; p.nparts = nparts; p.tile_q = tile_q; p.tile_kv = tile_kv;
  return fa2::launch_dtype(p, dtype, parts, D, stream);
}
#endif  // FA2_WIDE
