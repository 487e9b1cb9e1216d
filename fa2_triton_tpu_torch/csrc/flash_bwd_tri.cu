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
// Bound on the H100: 5 S x S x D products over the causal pairs, compute-
// bound at these lengths (989 TFLOP/s bf16 tensor-core peak).
//
// Design, 16-bit inputs (bwd_tri_mma_kernel, on bwd_mma.cuh's tensor-core
// tiles): the host partition (ops/flash_bwd.py:tri_partition) gives each
// (leaf, kv head, batch row) P blocks, enough to fill the card, and each
// block a fixed list of kv tiles of equal causal work (tile t with tile
// n - 1 - t), in ascending order. A block keeps each tile's dk / dv in
// registers over the q rows of the whole GQA group at or below the diagonal
// and writes them once; it adds each q tile's ds k into its own fp32 dq
// partial (the first tile stores, the later ones add: their rows are a
// subset). A prologue kernel computes delta = rowsum(o * do) - adj once for
// all blocks (tri-square), and a reduce kernel adds the P partials of each
// row in block order and rounds dq once. No atomics: bitwise repeatable.
//
// fp32 inputs keep the FMA kernel (bwd_tri_kernel: one block per
// (leaf, batch row, kv head) over the whole sequence, attn_tiles.cuh's
// tiles), so the fp32 contract (1e-4 against the plain twin) needs no TF32.
//
// Head dims 384 and 512 compile in flash_bwd_tri_wide.cu (this file with
// FA2_WIDE defined), beside 64 / 128 / 256 here, so that the two build in
// parallel. There the 16-bit tiles are bwd_mma.cuh's FusedKv past D 256
// (32 kv rows, 32-row q tiles, 4 warps along D: 153,600 / 202,752 B of
// shared memory) and the FMA kernel takes FmaTile's 32 x 16 tiles.
#include "bwd_mma.cuh"

namespace fa2 {

// The launch at head dim 384 or 512 (flash_bwd_tri_wide.cu).
int launch_tri_wide(const FusedBwdParams& p, int dtype, int D, void* stream);

namespace {

template <typename T, int D, bool DROP>
__global__ void __launch_bounds__(THREADS) bwd_tri_kernel(const FusedBwdParams p) {
  constexpr int M = FmaTile<D>::M, N = FmaTile<D>::N;
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
    for (int r0 = R0; r0 < R1; r0 += N) dq_tile_zero<D>(dqh + (long long)r0 * D, R1 - r0);
    if (p.o != nullptr) delta_rows<T, D>(p, b, h, R0, R1);
  }

  const T* kp = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vp = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  for (int k0 = C0; k0 < C1; k0 += M) {
    __syncthreads();  // the delta rows / the previous tile's K fully consumed
    stage_k<T, D>(p, s.Ks, kp, k0, kv_valid);
    stage<T, D>(s.Vs, vp, p.v_ss, k0, M, kv_valid, 1.f);
    int r_lo, r_hi;
    kv_tile_rows(p, k0, min(k0 + M, kv_valid), shift, q_valid, r_lo, r_hi);
    r_lo = max(r_lo, R0);
    r_hi = min(r_hi, R1);
    // A q tile at r0 keeps all of this kv tile when the tile's last column
    // is at or below the diagonal of its first row, inside the lengths.
    auto is_free = [&](int r0) {
      return r0 + N <= q_valid && k0 + M <= kv_valid &&
             p.kv_off + k0 + M - 1 <= p.q_off + r0 + shift;
    };
    FmaAcc<D> dk_acc, dv_acc;
    zero_acc<D>(dk_acc);
    zero_acc<D>(dv_acc);
    for (int g = 0; g < group; ++g) {
      const int h = hk * group + g;
      fused_rows<T, D, DROP>(p, s, b, h, k0, (r_lo / N) * N, r_hi, q_len, kv_len, q_valid,
                             is_free, dq_head<D>(p, p.dq_acc, b, h), dk_acc, dv_acc);
    }
    const int rows = min(M, p.Sk - k0);
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
    for (int r0 = R0; r0 < R1; r0 += N) {
      dq_tile_write<T, D>(dqh + (long long)r0 * D, out + r0 * p.dq_ss, p.dq_ss, R1 - r0);
    }
  }
}

template <typename T, int D, bool DROP>
cudaError_t launch_fma(const FusedBwdParams& p, cudaStream_t stream) {
  const int smem = dkdv_smem_floats<D>() * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(bwd_tri_kernel<T, D, DROP>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const int leaves = p.leaf > 0 ? (p.Sq + p.leaf - 1) / p.leaf : 1;
  dim3 grid(leaves, p.Hkv, p.B);
  bwd_tri_kernel<T, D, DROP><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// The block's rows [R0, R1) and columns [C0, C1): leaf `li`, or all.
__device__ __forceinline__ void leaf_bounds(const FusedBwdParams& p, int li, int& R0, int& R1,
                                            int& C0, int& C1) {
  R0 = C0 = 0;
  R1 = p.Sq;
  C1 = p.Sk;
  if (p.leaf > 0) {
    R0 = C0 = li * p.leaf;
    R1 = min(R0 + p.leaf, p.Sq);
    C1 = min(C0 + p.leaf, p.Sk);
  }
}

// delta = rowsum(o * do) - adj of every row (b, h, r): r < the row's
// q_valid, else 0. One warp per row, a fixed shuffle order; lane l reads
// elements [l D / 32, (l + 1) D / 32) as one vector load, or as 8-byte ones
// where its span is longer than 8 bytes and not a whole number of 16 (D 384
// in 16 bits: 24).
template <typename T, int D>
__global__ void __launch_bounds__(THREADS) fused_delta_kernel(const FusedBwdParams p) {
  const int lane = threadIdx.x % 32;
  const long long rows = (long long)p.B * p.Hq * p.Sq;
  for (long long row = (long long)blockIdx.x * (THREADS / 32) + threadIdx.x / 32; row < rows;
       row += (long long)gridDim.x * (THREADS / 32)) {
    const int r = (int)(row % p.Sq), h = (int)((row / p.Sq) % p.Hq);
    const int b = (int)(row / ((long long)p.Sq * p.Hq));
    const int q_valid = min(p.Sq, p.lens[2 * b] - p.q_off);
    float acc = 0.f;
    if (r < q_valid) {
      const T* op = static_cast<const T*>(p.o) + b * p.o_sb + h * p.o_sh + (long long)r * p.o_ss;
      const T* dop =
          static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh + (long long)r * p.do_ss;
      constexpr int PER = D / 32;
      constexpr int BYTES = PER * (int)sizeof(T);
      constexpr int V = BYTES % 16 == 0 || BYTES <= 8 ? PER : 8 / (int)sizeof(T);
#pragma unroll
      for (int c = 0; c < PER; c += V) {
        float x[V], y[V];
        load_vec<T, V>(op + lane * PER + c, x);
        load_vec<T, V>(dop + lane * PER + c, y);
#pragma unroll
        for (int i = 0; i < V; ++i) acc = fmaf(x[i], y[i], acc);
      }
      acc = warp_sum(acc);
      acc -= p.delta != nullptr ? p.delta[row] : 0.f;
    }
    if (lane == 0) p.delta_buf[row] = r < q_valid ? acc : 0.f;
  }
}

template <typename T, int D, bool DROP>
__global__ void __launch_bounds__(THREADS, 1) bwd_tri_mma_kernel(const FusedBwdParams p) {
  using C = MmaCfg<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const MmaSmem<T> s = mma_smem<C, T>(smem_raw);
  const int x = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int group = p.Hq / p.Hkv;
  const int q_len = p.lens[2 * b], kv_len = p.lens[2 * b + 1];
  const int shift = kv_len - q_len;
  const int q_valid = min(p.Sq, q_len - p.q_off);
  const int kv_valid = min(p.Sk, kv_len - p.kv_off);
  int R0, R1, C0, C1;
  leaf_bounds(p, x / p.nparts, R0, R1, C0, C1);
  const int qv = min(q_valid, R1);
  const int leaves = p.leaf > 0 ? (p.Sq + p.leaf - 1) / p.leaf : 1;
  const int* tiles = p.part + leaves * p.nparts + 1;
  const int t0 = p.part[x], t1 = p.part[x + 1];
  float* dq_part = p.dq_acc + (long long)(x % p.nparts) * p.B * p.Hq * p.Sq * D;
  const T* kp = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vp = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  const float* delta = p.o != nullptr ? p.delta_buf : p.delta;

  for (int ti = t0; ti < t1; ++ti) {
    const int k0 = tiles[ti];
    const int c_end = min(k0 + C::BKV, C1), c_lim = min(c_end, kv_valid);
    int r_lo, r_hi;
    kv_tile_rows(p, k0, c_lim, shift, q_valid, r_lo, r_hi);
    r_lo = max(r_lo, R0);
    r_hi = min(r_hi, R1);
    const int ra = (r_lo / C::BQ) * C::BQ;
    const int nqt = r_hi > r_lo ? (r_hi - ra + C::BQ - 1) / C::BQ : 0;
    const int total = group * nqt;
    float dk[C::NT_KV][4], dv[C::NT_KV][4];
    mma_zero_kv<C>(dk, dv);
    if (total > 0) {
      __syncthreads();  // the previous tile's K / V and dS^T fully consumed
      mma_load_kv<C, T>(p, s, kp, vp, k0, c_lim);
      auto issue = [&](int i) {
        const int h = hk * group + i / nqt, r0 = ra + (i % nqt) * C::BQ;
        const long long row0 = ((long long)b * p.Hq + h) * p.Sq;
        mma_load_q<C, T>(p, s, i & 1, b, h, r0, qv, p.lse + row0, delta + row0);
      };
      issue(0);
      cp_async_commit();
      for (int i = 0; i < total; ++i) {
        if (i + 1 < total) {
          issue(i + 1);
          cp_async_commit();
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();
        const int h = hk * group + i / nqt, r0 = ra + (i % nqt) * C::BQ;
        // Every element is kept when the tile's last column is at or below
        // the diagonal of the q tile's first row, inside the lengths.
        const bool free_tile = r0 + C::BQ <= qv && c_lim == k0 + C::BKV &&
                               p.kv_off + k0 + C::BKV - 1 <= p.q_off + r0 + shift;
        mma_q_step<C, T, true>(
            s, i & 1, fused_elem<DROP>(p, b, h, r0, k0, c_lim, free_tile, q_len, kv_len), dk, dv);
        __syncthreads();
        mma_dq_step<C, T>(s, dq_part + ((long long)b * p.Hq + h) * p.Sq * D, r0, p.Sq, ti == t0);
      }
    }
    const int rows = c_end - k0;
    mma_store_kv<C, T>(dk, static_cast<T*>(p.dk) + b * p.dk_sb + hk * p.dk_sh + k0 * p.dk_ss,
                       p.dk_ss, rows, p.scale);
    mma_store_kv<C, T>(dv, static_cast<T*>(p.dv) + b * p.dv_sb + hk * p.dv_sh + k0 * p.dv_ss,
                       p.dv_ss, rows, 1.f);
  }
}

// dq = (the P partials of each row, in block order) / log2e, in T. Partial
// j holds rows from its first tile's first row to the leaf's end (the later
// tiles' rows are a subset); rows past q_valid are zero.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS) tri_dq_reduce_kernel(const FusedBwdParams p) {
  const long long n = (long long)p.B * p.Hq * p.Sq * (D / 4);
  const long long part_stride = (long long)p.B * p.Hq * p.Sq * D;
  const int leaves = p.leaf > 0 ? (p.Sq + p.leaf - 1) / p.leaf : 1;
  const int* tiles = p.part + leaves * p.nparts + 1;
  for (long long i = blockIdx.x * (long long)THREADS + threadIdx.x; i < n;
       i += (long long)gridDim.x * THREADS) {
    const int d = (int)(i % (D / 4)) * 4;
    const long long row = i / (D / 4);
    const int r = (int)(row % p.Sq), h = (int)((row / p.Sq) % p.Hq);
    const int b = (int)(row / ((long long)p.Sq * p.Hq));
    const int q_len = p.lens[2 * b], kv_len = p.lens[2 * b + 1];
    const int shift = kv_len - q_len;
    const int q_valid = min(p.Sq, q_len - p.q_off);
    const int kv_valid = min(p.Sk, kv_len - p.kv_off);
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    if (r < q_valid) {
      const int li = p.leaf > 0 ? r / p.leaf : 0;
      int R0, R1, C0, C1;
      leaf_bounds(p, li, R0, R1, C0, C1);
      for (int j = 0; j < p.nparts; ++j) {
        const int x = li * p.nparts + j;
        if (p.part[x] == p.part[x + 1]) continue;
        const int k0 = tiles[p.part[x]];
        int r_lo, r_hi;
        kv_tile_rows(p, k0, min(min(k0 + MmaCfg<D>::BKV, C1), kv_valid), shift, q_valid, r_lo,
                     r_hi);
        if (r < max(r_lo, R0) || r >= r_hi) continue;
        const float4 v = *reinterpret_cast<const float4*>(p.dq_acc + j * part_stride + row * D + d);
        acc[0] += v.x; acc[1] += v.y; acc[2] += v.z; acc[3] += v.w;
      }
    }
    T* out = static_cast<T*>(p.dq) + b * p.dq_sb + h * p.dq_sh + (long long)r * p.dq_ss + d;
#pragma unroll
    for (int k = 0; k < 4; ++k) out[k] = from_f<T>(acc[k] * (1.f / LOG2E));
  }
}

template <typename T, int D, bool DROP>
cudaError_t launch_mma(const FusedBwdParams& p, cudaStream_t stream) {
  using C = MmaCfg<D>;
  // The host partition (ops/flash_bwd.py) lists tiles of these sizes.
  if (p.tile_q != C::BQ || p.tile_kv != C::BKV) return cudaErrorInvalidValue;
  cudaError_t e;
  if (p.o != nullptr) {
    fused_delta_kernel<T, D><<<stride_blocks((long long)p.B * p.Hq * p.Sq, THREADS / 32), THREADS,
                               0, stream>>>(p);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  e = cudaFuncSetAttribute(bwd_tri_mma_kernel<T, D, DROP>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM_BYTES);
  if (e != cudaSuccess) return e;
  const int leaves = p.leaf > 0 ? (p.Sq + p.leaf - 1) / p.leaf : 1;
  bwd_tri_mma_kernel<T, D, DROP>
      <<<dim3(leaves * p.nparts, p.Hkv, p.B), THREADS, C::SMEM_BYTES, stream>>>(p);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  tri_dq_reduce_kernel<T, D>
      <<<stride_blocks((long long)p.B * p.Hq * p.Sq * (D / 4)), THREADS, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int D, bool DROP>
cudaError_t launch_kernel(const FusedBwdParams& p, cudaStream_t stream) {
  if constexpr (std::is_same<T, float>::value) {
    return launch_fma<T, D, DROP>(p, stream);
  } else {
    return launch_mma<T, D, DROP>(p, stream);
  }
}

template <typename T, int D>
cudaError_t launch(const FusedBwdParams& p, cudaStream_t stream) {
  return p.drop.on ? launch_kernel<T, D, true>(p, stream) : launch_kernel<T, D, false>(p, stream);
}

// The head dims of this translation unit: 64 / 128 / 256 here, 384 / 512 in
// flash_bwd_tri_wide.cu.
template <typename T>
cudaError_t launch_d(const FusedBwdParams& p, int D, cudaStream_t stream) {
  switch (D) {
#ifdef FA2_WIDE
    case 384: return launch<T, 384>(p, stream);
    case 512: return launch<T, 512>(p, stream);
#else
    case 64: return launch<T, 64>(p, stream);
    case 128: return launch<T, 128>(p, stream);
    case 256: return launch<T, 256>(p, stream);
#endif
    default: return cudaErrorInvalidValue;
  }
}

int launch_dtype(const FusedBwdParams& p, int dtype, int D, void* stream) {
#ifndef FA2_WIDE
  if (D > 256) return launch_tri_wide(p, dtype, D, stream);
#endif
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return (int)launch_d<float>(p, D, st);
    case kF16: return (int)launch_d<__half>(p, D, st);
    case kBF16: return (int)launch_d<__nv_bfloat16>(p, D, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

#ifdef FA2_WIDE
int launch_tri_wide(const FusedBwdParams& p, int dtype, int D, void* stream) {
  return launch_dtype(p, dtype, D, stream);
}
#endif
}  // namespace fa2

#ifndef FA2_WIDE

// leaf = 0: the tri-square (B13); leaf = T > 0, a multiple of 64 with Sq ==
// Sk: the diag leaves (B13 diag). k_mul = scale * log2e folds k in the
// kernel; 0 takes k prescaled. o non-null: delta = rowsum(o * do) - delta
// (the dlse adjustment, nullable) into delta_buf; null: delta is the delta.
// 16-bit: part (device int32, tri_partition's table) and nparts = P blocks
// per (leaf, kv head, batch row), its tiles of tile_kv rows walked in q
// tiles of tile_q rows (MmaCfg's, else the call fails); dq_acc fp32 [P, B,
// Hq, Sq, D]; rows, strides and base pointers of q, k, v, do 16-byte
// aligned. fp32: part is unused and dq_acc is fp32 [B, Hq, Sq, D].
extern "C" int fa2_flash_bwd_tri(
    int dtype, int leaf, int B, int Hq, int Hkv, int Sq, int Sk, int D,
    const void* q, const void* k, const void* v, const void* dout, const void* o,
    const float* lse, const float* delta, float* delta_buf, float* dq_acc,
    void* dq, void* dk, void* dv, const int* lens, const long long* strides,
    int q_off, int kv_off, float softmax_scale, float k_mul,
    int dropout, unsigned int drop_seed, unsigned int drop_threshold, float drop_scale,
    int Sq_real, int Sk_real, const int* part, int nparts, int tile_q, int tile_kv,
    void* stream) {
  if (leaf < 0 || leaf % fa2::TM != 0 || (leaf > 0 && Sq != Sk) ||
      (dtype != fa2::kF32 && (part == nullptr || nparts <= 0))) {
    return (int)cudaErrorInvalidValue;
  }
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
  p.part = part; p.nparts = nparts; p.tile_q = tile_q; p.tile_kv = tile_kv;
  return fa2::launch_dtype(p, dtype, D, stream);
}
#endif  // FA2_WIDE
