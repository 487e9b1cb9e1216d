// Packed variable-length and block-sparse attention for Hopper (sm_90a),
// written by hand in CUDA C++: forward, dq and dk/dv.
//
// Replaces:
//   * varlen_fwd:  fa2_triton_tpu/ops/varlen.py:_varlen_fwd_kernel (B7),
//   * varlen_dq:   fa2_triton_tpu/ops/varlen.py:_varlen_dq_kernel (B8),
//   * varlen_dkdv: fa2_triton_tpu/ops/varlen.py:_varlen_dkdv_kernel (B8),
// as `flash_attn_varlen_func` and `flash_attn_blocksparse_func` reach them.
//
// Function: documents are packed back to back in one [1, H, T, D] stream,
// each starting at a multiple of the user blocks (block_q, block_kv). A
// host work list (ops/varlen.py:_build_schedule) holds exactly the (q
// block, kv block) pairs that carry work, after causal skipping and the
// optional block mask. Per segment: causal masking bottom-right aligned on
// the true lengths (shift = kv_len - q_len), base-2 lse, o = 0 and lse =
// -inf on rows that keep no column, dq = dk = dv = 0 exactly outside live
// rows. The TPU walks the list as a sequential grid and carries (m, l,
// acc) in scratch between steps. Here the list is a launch table: sorted by
// packed q block (q-major) or kv block (kv-major), with a CSR row pointer
// over it, so each block finds the entries of its user block and loops over
// them itself:
//   * varlen_fwd / varlen_dq: one block per (64-row q tile, q head); for
//     each entry of its user q block, a loop over that kv block's KV tiles,
//     up to kv_len and the causal edge of the tile's last live row;
//   * varlen_dkdv: one block per (64-row kv tile, kv head); for each entry
//     of its user kv block (column 7 is the GQA group index), a loop over
//     that q block's q tiles, from the causal edge to q_len. dk and dv are
//     summed over the whole group inside the block: no atomics, and every
//     run is bitwise repeatable.
// Each CUDA tile nests in one user block (the wrapper checks block_q and
// block_kv are multiples of 64), so the block mask and the alignment stay
// defined at the user's blocks. Every tile of the stream is written: a tile
// whose rows are all dead (a padded tail, a block the mask filtered out
// entirely, a dummy entry whose length was clamped) writes zeros and -inf
// without loading anything. Masked scores are -inf under a finite running
// max floor, and elements are kept by row < q_len, col < kv_len and the
// causal rule, so a row whose surviving blocks hold no causal column ends
// with o = 0 and lse = -inf (the TPU kernel's finite -1e30 mask averages v
// there). Rows past q_len and columns past kv_len are zero-filled when
// loaded: the gaps of the packed stream may hold NaN.
//
// Dropout (varlen.py:_packed_dropout_bits, l.214-230): an element of q head
// h at GLOBAL packed row / column is kept iff hash(hash(hash(seed, h), row),
// col) >= threshold (common.cuh:packed_dropout_keep); the forward drops p
// from P V only (l sums the undropped p) and scales o by 1 / (1 - p), and
// dq / dk/dv regenerate the mask as the dense backward does (grad_plain's
// dropout factor). Each kernel is built with and without dropout (the DROP
// template flag), so the dropout-free instantiations carry no hash code.
//
// Bound on the H100: at document lengths of hundreds to thousands of
// tokens, compute (4 D flops per kept (row, column) pair and head forward,
// 6 D for dq, 8 D for dk/dv, against 2-4 bytes per element moved), so the
// roof is the tensor cores. Two designs, by input type:
//
// bf16 / fp16 inputs: mma.sync.m16n8k16 tiles with fp32 accumulation, the
// dense kernels' (flash_fwd.cu and fwd_mma.cuh; flash_bwd.cu and
// bwd_mma.cuh) with the varlen key and q ranges. JAX rounds p before p v
// (varlen.py:291), ds before ds k (l.439) and p and ds before p^T do and
// ds^T q (l.519, l.524): so do these kernels.
//   * varlen_mma_fwd_kernel / varlen_mma_dq_kernel: one block of 4 warps
//     per (64-row q tile, q head), each warp 16 q rows, on fwd_mma.cuh's
//     tile step (Q staged once, in registers at D <= 128) or bwd_mma.cuh's
//     dq tiles (Q and dO staged once); K / V tiles of 64 rows, 32 at D 256,
//     double-buffered by cp.async. The block walks the (entry, kv tile)
//     pairs of its user q block as one flat loop, so the next tile's copies
//     always overlap this one's products: a cursor per stream (the copies
//     run one tile ahead of the products) steps over entries whose key
//     range is empty for this tile. The forward's store writes o through
//     the warp's own shared-memory rows as 16-byte stores.
//   * varlen_mma_dkdv_kernel: one block per (64-row kv tile, kv head) on
//     bwd_mma.cuh's mma_q_step (dK and dV in registers; q / do / lse /
//     delta tiles double-buffered), walking the (entry, 64-row q tile)
//     pairs of its user kv block the same way. 64 kv rows (4 warps at D <=
//     128, 8 at D 256, two splitting D), not the dense kernel's 128: the
//     user blocks are multiples of 64, so a 64-row tile never straddles two
//     of them (two documents), whatever block_kv the caller picked.
//   * The scale rides on the fp32 score accumulator (never folded into a
//     rounded q or k), dq and dk take it once at the store; an element is
//     kept by row < q_len, col < kv_len and the causal rule, and masked
//     elements are selected to -inf (forward) or 0 (p, ds); a tile whose
//     elements are all kept skips the test. Rows past q_len and keys past
//     kv_len are zero-filled by cp.async (the tensor cores give 0 x NaN =
//     NaN), dead q rows get lse = -inf (p = ds = 0 in the backward).
//   * Heaviest tiles first: causal documents of 64-4096 tokens give tiles
//     whose work differs by up to 64x, so the host hands each grid its
//     tiles sorted by the work their loops cover (ops/varlen.py:_tile_order,
//     ties by index), all heads of a tile next to each other. The forward
//     and dq cover the same keys, so they share the order (and the host
//     hands dq the forward's table).
// fp32 inputs (no TF32): the fp32 CUDA-core tile math of flash_fwd.cu's and
// flash_bwd.cu's FMA kernels (attn_tiles.cuh), which, like them, loads no
// tile past kv_len, q_len or the causal edge; the work list keeps filtered
// and causally dead blocks out of the loops altogether.
#include "bwd_mma.cuh"
#include "fwd_mma.cuh"

namespace fa2 {
namespace {

struct VarlenParams {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  void* o;
  float* lse;          // [1, Hq, T] fp32, base 2 (written by fwd, read by dq / dk/dv)
  const float* delta;  // [1, Hq, T] fp32
  void* dq;
  void* dk;
  void* dv;
  const int* work;     // [n, 8] int32 work list (ops/varlen.py)
  const int* rowptr;   // [T / block + 1] CSR row pointer over it
  const int* order;    // [T / 64] the 64-row tiles, heaviest first (16-bit kernels)
  long long q_sh, q_ss, k_sh, k_ss, v_sh, v_ss, do_sh, do_ss;
  long long o_sh, o_ss, dq_sh, dq_ss, dk_sh, dk_ss, dv_sh, dv_ss;
  int Hq, Hkv, T, block_q, block_kv, causal;
  float scale;       // softmax scale (natural)
  float scale_log2;  // scale * log2(e)
  Dropout drop;
};

// The dropout factor of the element of q head stream `seed_h` (= hash(seed,
// h)) at packed row / column: 1 without dropout, 1 / (1 - p) where kept, 0
// where dropped.
template <bool DROP>
__device__ __forceinline__ float packed_drop_at(const VarlenParams& p, uint32_t seed_h, int row,
                                                int col) {
  if constexpr (DROP) {
    return packed_dropout_keep(seed_h, p.drop.threshold, row, col) ? p.drop.scale : 0.f;
  } else {
    return 1.f;
  }
}

// The segment a 64-row output tile at packed row t0 belongs to, from the
// first entry of its user block (every entry of a block shares it): the
// block's entries [e_lo, e_hi), the tile's first row in segment
// coordinates, the segment's length along the tile's axis (q_len for a q
// tile, kv_len for a kv tile) and the tile's live rows.
struct TileSeg {
  int e_lo, e_hi, first, len, live;
};

__device__ __forceinline__ TileSeg tile_seg(const VarlenParams& p, int t0, int block, int lo_col,
                                            int len_col) {
  TileSeg t;
  const int ub = t0 / block;
  t.e_lo = p.rowptr[ub];
  t.e_hi = p.rowptr[ub + 1];
  const int* w = p.work + 8 * t.e_lo;
  t.first = (t.e_lo < t.e_hi ? w[lo_col] : 0) + t0 - ub * block;
  t.len = t.e_lo < t.e_hi ? w[len_col] : 0;
  t.live = max(0, min(TM, t.len - t.first));
  return t;
}

template <typename T, int D, bool DROP>
__global__ void __launch_bounds__(THREADS) varlen_fwd_kernel(const VarlenParams p) {
  extern __shared__ float smem[];
  const FwdSmem s = fwd_smem<D>(smem);
  const int q0 = blockIdx.x * TM, h = blockIdx.y, hk = h / (p.Hq / p.Hkv);
  const TileSeg t = tile_seg(p, q0, p.block_q, 2, 4);
  const int qlen = t.len;
  const uint32_t seed_h = counter_hash_u32(p.drop.seed, (uint32_t)h);

  stage<T, D>(s.Qs, static_cast<const T*>(p.q) + h * p.q_sh, p.q_ss, q0, TM, q0 + t.live,
              p.scale_log2);
  float m_run = MASK_LOG2, l_run = 0.f;
  float acc[4][D / 16];
  zero_acc<D>(acc);
  for (int e = t.live > 0 ? t.e_lo : t.e_hi; e < t.e_hi; ++e) {
    const int* w = p.work + 8 * e;
    const int kv_lo = w[3], kvlen = w[5], shift = kvlen - qlen;
    const long long kb0 = (long long)w[1] * p.block_kv;  // packed row of the block's first key
    const int kv_valid = min(p.block_kv, kvlen - kv_lo);
    int hi = kv_valid;
    if (p.causal) hi = min(hi, t.first + t.live - 1 + shift + 1 - kv_lo);
    const T* kp = static_cast<const T*>(p.k) + hk * p.k_sh + kb0 * p.k_ss;
    const T* vp = static_cast<const T*>(p.v) + hk * p.v_sh + kb0 * p.v_ss;
    for (int k0 = 0; k0 < hi; k0 += TN) {
      auto score = [&](int r, int c, float x) {
        const int row = t.first + r, col = kv_lo + k0 + c;
        const bool keep = r < t.live && col < kvlen && (!p.causal || col <= row + shift);
        return keep ? x : neg_inf();
      };
      auto drop = [&](int r, int c, float pr) {
        return packed_drop_at<DROP>(p, seed_h, q0 + r, (int)kb0 + k0 + c) != 0.f ? pr : 0.f;
      };
      fwd_kv_step<T, D>(s, kp, p.k_ss, vp, p.v_ss, k0, kv_valid, score, drop, m_run, l_run, acc);
    }
  }
  fwd_store<T, D>(s, m_run, l_run, acc, p.lse + (long long)h * p.T + q0,
                  static_cast<T*>(p.o) + h * p.o_sh + q0 * p.o_ss, p.o_ss, TM,
                  DROP ? p.drop.scale : 1.f);
}

template <typename T, int D, bool DROP>
__global__ void __launch_bounds__(THREADS) varlen_dq_kernel(const VarlenParams p) {
  extern __shared__ float smem[];
  const DqSmem s = dq_smem<D>(smem);
  const int q0 = blockIdx.x * TM, h = blockIdx.y, hk = h / (p.Hq / p.Hkv);
  const TileSeg t = tile_seg(p, q0, p.block_q, 2, 4);
  const int qlen = t.len;
  const long long row0 = (long long)h * p.T;
  const uint32_t seed_h = counter_hash_u32(p.drop.seed, (uint32_t)h);

  dq_stage_q<T, D>(s, static_cast<const T*>(p.q) + h * p.q_sh, p.q_ss,
                   static_cast<const T*>(p.dout) + h * p.do_sh, p.do_ss, p.lse + row0,
                   p.delta + row0, q0, q0 + t.live, p.scale_log2);
  float acc[4][D / 16];
  zero_acc<D>(acc);
  for (int e = t.live > 0 ? t.e_lo : t.e_hi; e < t.e_hi; ++e) {
    const int* w = p.work + 8 * e;
    const int kv_lo = w[3], kvlen = w[5], shift = kvlen - qlen;
    const long long kb0 = (long long)w[1] * p.block_kv;
    const int kv_valid = min(p.block_kv, kvlen - kv_lo);
    int hi = kv_valid;
    if (p.causal) hi = min(hi, t.first + t.live - 1 + shift + 1 - kv_lo);
    const T* kp = static_cast<const T*>(p.k) + hk * p.k_sh + kb0 * p.k_ss;
    const T* vp = static_cast<const T*>(p.v) + hk * p.v_sh + kb0 * p.v_ss;
    for (int k0 = 0; k0 < hi; k0 += TN) {
      auto ds_of = [&](int r, int c, float s2, float dp) {
        const int row = t.first + r, col = kv_lo + k0 + c;
        const bool keep = r < t.live && col < kvlen && (!p.causal || col <= row + shift);
        float pr, ds;
        grad_plain(s2, dp, s.lse_s[r], s.delta_s[r], keep,
                   packed_drop_at<DROP>(p, seed_h, q0 + r, (int)kb0 + k0 + c), pr, ds);
        return ds;
      };
      dq_kv_step<T, D>(s, kp, p.k_ss, vp, p.v_ss, k0, kv_valid, ds_of, acc);
    }
  }
  store_tile<T, D>(acc, static_cast<T*>(p.dq) + h * p.dq_sh + q0 * p.dq_ss, p.dq_ss, TM,
                   p.scale);
}

template <typename T, int D, bool DROP>
__global__ void __launch_bounds__(THREADS) varlen_dkdv_kernel(const VarlenParams p) {
  extern __shared__ float smem[];
  const DkdvSmem s = dkdv_smem<D>(smem);
  const int k0 = blockIdx.x * TM, hk = blockIdx.y, group = p.Hq / p.Hkv;
  const TileSeg t = tile_seg(p, k0, p.block_kv, 3, 5);
  const int kvlen = t.len;

  stage<T, D>(s.Ks, static_cast<const T*>(p.k) + hk * p.k_sh, p.k_ss, k0, TM, k0 + t.live,
              p.scale_log2);
  stage<T, D>(s.Vs, static_cast<const T*>(p.v) + hk * p.v_sh, p.v_ss, k0, TM, k0 + t.live, 1.f);
  float dk_acc[4][D / 16], dv_acc[4][D / 16];
  zero_acc<D>(dk_acc);
  zero_acc<D>(dv_acc);
  for (int e = t.live > 0 ? t.e_lo : t.e_hi; e < t.e_hi; ++e) {
    const int* w = p.work + 8 * e;
    const int q_lo = w[2], qlen = w[4], shift = kvlen - qlen;
    const int h = hk * group + w[7];  // the q head: the forward's stream
    const uint32_t seed_h = counter_hash_u32(p.drop.seed, (uint32_t)h);
    const long long qb0 = (long long)w[0] * p.block_q;  // packed row of the block's first query
    // Rows [r_lo, r_hi) of the q block that can see a live column of this tile.
    const int r_hi = min(p.block_q, qlen - q_lo);
    const int r_lo = p.causal ? max(0, t.first - shift - q_lo) : 0;
    const T* qp = static_cast<const T*>(p.q) + h * p.q_sh + qb0 * p.q_ss;
    const T* dop = static_cast<const T*>(p.dout) + h * p.do_sh + qb0 * p.do_ss;
    const float* lse = p.lse + (long long)h * p.T + qb0;
    const float* delta = p.delta + (long long)h * p.T + qb0;
    for (int r0 = (r_lo / TN) * TN; r0 < r_hi; r0 += TN) {
      auto pds_of = [&](int kr, int qr, float s2, float dp, float& pr, float& ds) {
        const int row = q_lo + r0 + qr, col = t.first + kr;
        const bool keep = kr < t.live && row < qlen && (!p.causal || col <= row + shift);
        grad_plain(s2, dp, s.lse_s[qr], s.delta_s[qr], keep,
                   packed_drop_at<DROP>(p, seed_h, (int)qb0 + r0 + qr, k0 + kr), pr, ds);
      };
      dkdv_q_step<T, D>(s, qp, p.q_ss, dop, p.do_ss, lse, delta, r0, r_hi, pds_of, dk_acc,
                        dv_acc);
    }
  }
  store_tile<T, D>(dk_acc, static_cast<T*>(p.dk) + hk * p.dk_sh + k0 * p.dk_ss, p.dk_ss, TM,
                   p.scale);
  store_tile<T, D>(dv_acc, static_cast<T*>(p.dv) + hk * p.dv_sh + k0 * p.dv_ss, p.dv_ss, TM, 1.f);
}

// A cursor over the flat (entry, tile) loop of a 16-bit backward block: the
// entry e of the block's user block and the tile j of n in it. walk_from /
// walk_next skip entries with no tile (count(e) == 0).
struct Walk {
  int e, j, n;
};

template <class Count>
__device__ __forceinline__ void walk_from(Walk& c, int e, int e_hi, const Count& count) {
  c.j = 0;
  for (c.e = e; c.e < e_hi && (c.n = count(c.e)) == 0; ++c.e) {
  }
}

template <class Count>
__device__ __forceinline__ void walk_next(Walk& c, int e_hi, const Count& count) {
  if (++c.j < c.n) return;
  walk_from(c, c.e + 1, e_hi, count);
}

// The K and V rows of the kv tile at cursor c (rows [j BKV, + BKV) of
// entry c.e's kv block, zero past its valid keys) into K / V: cp.async
// copies, not committed. kbase / vbase: the kv head's first row.
template <class C, typename T>
__device__ __forceinline__ void load_walk_kv(const VarlenParams& p, const Walk& c, const T* kbase,
                                             const T* vbase, T* K, T* V) {
  const int* we = p.work + 8 * c.e;
  const long long kb0 = (long long)we[1] * p.block_kv;  // packed row of the block's first key
  const int kv_valid = min(p.block_kv, we[5] - we[3]);
  cp_rows<C>(K, kbase + kb0 * p.k_ss, p.k_ss, c.j * C::BKV, C::BKV, kv_valid);
  cp_rows<C>(V, vbase + kb0 * p.v_ss, p.v_ss, c.j * C::BKV, C::BKV, kv_valid);
}

// The keys [0, hi) of entry e's kv block that the live rows of a q tile
// (TileSeg t, segment q_len qlen) need: hi cut at kv_len and at the causal
// edge of the tile's last live row. Returns its tiles of bkv keys.
__device__ __forceinline__ int q_tile_count(const VarlenParams& p, const TileSeg& t, int qlen,
                                            int e, int bkv) {
  const int* we = p.work + 8 * e;
  int hi = min(p.block_kv, we[5] - we[3]);
  if (p.causal) hi = min(hi, t.first + t.live - 1 + (we[5] - qlen) + 1 - we[3]);
  return hi > 0 ? (hi + bkv - 1) / bkv : 0;
}

// The forward, 16-bit inputs: one block of 4 warps per (64-row q tile
// p.order[y], q head x) on fwd_mma.cuh's tile step. Q is staged once (its
// A fragments in registers at D <= 128); entry e covers the keys [0, hi) of
// its kv block (q_tile_count), and its tiles of BKV keys and those of the
// next entries form one double-buffered loop. An element is kept by row <
// live, col < kv_len and (causal) col <= row + shift; with dropout at its
// GLOBAL packed row / column (the row's hash taken once per thread), and o
// scaled by 1 / (1 - p) at the store. A tile with no live row, or whose
// rows keep nothing, stores o = 0 and lse = -inf.
template <typename T, int D, bool DROP>
__global__ void __launch_bounds__(FwdMmaCfg<D>::NW * 32)
    varlen_mma_fwd_kernel(const VarlenParams p) {
  using C = FwdMmaCfg<D>;
  static_assert(C::BQ == TM, "the host's 64-row tiles");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);  // [BQ][P]
  T* kv_s = Qs + C::BQ * C::P;             // buffer j: K at 2 j BKV rows, V BKV rows on
  const int h = blockIdx.x, q0 = p.order[blockIdx.y] * C::BQ, hk = h / (p.Hq / p.Hkv);
  const TileSeg t = tile_seg(p, q0, p.block_q, 2, 4);
  const int qlen = t.len;

  auto count = [&](int e) { return q_tile_count(p, t, qlen, e, C::BKV); };
  int n_tiles = 0;
  for (int e = t.live > 0 ? t.e_lo : t.e_hi; e < t.e_hi; ++e) n_tiles += count(e);

  float o[C::NT_O][4], m_run[2], l_run[2];
  fwd_mma_init<C>(o, m_run, l_run);
  QFrags<C> qf;
  // hash(hash(seed, h), row) of the thread's rows g and g + 8: the packed
  // stream's first two hashes, constant over the kv loop.
  uint32_t row_h[2] = {0u, 0u};
  if constexpr (DROP) {
    const uint32_t seed_h = counter_hash_u32(p.drop.seed, (uint32_t)h);
    const int r = threadIdx.x / 32 * 16 + threadIdx.x % 32 / 4;
    row_h[0] = counter_hash_u32(seed_h, (uint32_t)(q0 + r));
    row_h[1] = counter_hash_u32(seed_h, (uint32_t)(q0 + r + 8));
  }

  const T* kbase = static_cast<const T*>(p.k) + hk * p.k_sh;
  const T* vbase = static_cast<const T*>(p.v) + hk * p.v_sh;
  Walk nxt, cur;  // the tile whose copies go out next; the tile computed next
  walk_from(nxt, t.e_lo, t.e_hi, count);
  cur = nxt;
  auto load = [&](int, T* K, T* V) {
    load_walk_kv<C>(p, nxt, kbase, vbase, K, V);
    walk_next(nxt, t.e_hi, count);
  };
  if (n_tiles > 0) {
    cp_rows<C>(Qs, static_cast<const T*>(p.q) + h * p.q_sh, p.q_ss, q0, C::BQ, q0 + t.live);
    cp_async_commit();
    load(0, kv_s, kv_s + C::BKV * C::P);
    cp_async_commit();
    if constexpr (C::Q_REGS) {
      cp_async_wait<1>();
      __syncthreads();
      fwd_mma_load_q<C>(qf, Qs);
    }
  }
  dq_kv_loop<C, T>(kv_s, n_tiles, load, [&](int, const T* Ks, const T* Vs) {
    const int* we = p.work + 8 * cur.e;
    const int kv_lo = we[3], kv_valid = min(p.block_kv, we[5] - we[3]), shift = we[5] - qlen;
    const int k0 = cur.j * C::BKV, col0 = we[1] * p.block_kv + k0;  // packed column of key 0
    // Real keys, all at or left of the first row's diagonal: every live row
    // keeps every key (the store zeroes the dead rows).
    const bool free_tile =
        k0 + C::BKV <= kv_valid && (!p.causal || kv_lo + k0 + C::BKV - 1 <= t.first + shift);
    auto score = [&](int r, int c, float x) {
      const bool keep = r < t.live && k0 + c < kv_valid &&
                        (!p.causal || kv_lo + k0 + c <= t.first + r + shift);
      return keep ? x : neg_inf();
    };
    auto undropped = [&](int, int c, int hr) {
      return counter_hash_u32(row_h[hr], (uint32_t)(col0 + c)) >= p.drop.threshold;
    };
    fwd_mma_tile<C, T, DROP>(qf, Qs, Ks, Vs, p.scale_log2, free_tile, score, undropped, o, m_run,
                             l_run);
    walk_next(cur, t.e_hi, count);
  });
  fwd_mma_store<C, T, false>(o, m_run, l_run, Qs,
                             static_cast<T*>(p.o) + h * p.o_sh + (long long)q0 * p.o_ss, p.o_ss,
                             p.lse + (long long)h * p.T + q0, t.live, C::BQ,
                             DROP ? p.drop.scale : 1.f);
}

// dq, 16-bit inputs: one block of 4 warps per (64-row q tile p.order[y], q
// head x) on bwd_mma.cuh's dq tiles. Entry e covers the keys [0, hi) of its
// kv block (q_tile_count, the forward's); its tiles of BKV keys and those
// of the next entries form one double-buffered loop.
template <typename T, int D, bool DROP>
__global__ void __launch_bounds__(DqMmaCfg<D>::NW * 32) varlen_mma_dq_kernel(const VarlenParams p) {
  using C = DqMmaCfg<D>;
  static_assert(C::BQ == TM, "the host's 64-row tiles");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);  // [BQ][P]
  T* dOs = Qs + C::BQ * C::P;              // [BQ][P]
  T* kv_s = dOs + C::BQ * C::P;            // buffer j: K at 2 j BKV rows, V BKV rows on
  const int h = blockIdx.x, q0 = p.order[blockIdx.y] * C::BQ, hk = h / (p.Hq / p.Hkv);
  const TileSeg t = tile_seg(p, q0, p.block_q, 2, 4);
  const int qlen = t.len;
  const uint32_t seed_h = counter_hash_u32(p.drop.seed, (uint32_t)h);
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32, g = lane / 4;

  auto count = [&](int e) { return q_tile_count(p, t, qlen, e, C::BKV); };
  int n_tiles = 0;
  for (int e = t.live > 0 ? t.e_lo : t.e_hi; e < t.e_hi; ++e) n_tiles += count(e);

  // lse and delta of rows g and g + 8 of the warp's 16; dead rows get lse =
  // -inf, so every element of theirs gives p = ds = 0.
  float lse[2], delta[2];
  const long long row0 = (long long)h * p.T + q0;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = w * 16 + g + 8 * hr;
    const bool ok = r < t.live;
    lse[hr] = ok ? p.lse[row0 + r] : neg_inf();
    delta[hr] = ok ? p.delta[row0 + r] : 0.f;
  }
  float dq[C::NT_D][4];
#pragma unroll
  for (int n = 0; n < C::NT_D; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;

  const T* kbase = static_cast<const T*>(p.k) + hk * p.k_sh;
  const T* vbase = static_cast<const T*>(p.v) + hk * p.v_sh;
  Walk nxt, cur;  // the tile whose copies go out next; the tile computed next
  walk_from(nxt, t.e_lo, t.e_hi, count);
  cur = nxt;
  auto load = [&](int, T* K, T* V) {
    load_walk_kv<C>(p, nxt, kbase, vbase, K, V);
    walk_next(nxt, t.e_hi, count);
  };
  if (n_tiles > 0) {
    cp_rows<C>(Qs, static_cast<const T*>(p.q) + h * p.q_sh, p.q_ss, q0, C::BQ, q0 + t.live);
    cp_rows<C>(dOs, static_cast<const T*>(p.dout) + h * p.do_sh, p.do_ss, q0, C::BQ,
               q0 + t.live);
    load(0, kv_s, kv_s + C::BKV * C::P);
    cp_async_commit();
  }
  dq_kv_loop<C, T>(kv_s, n_tiles, load, [&](int, const T* Ks, const T* Vs) {
    const int* we = p.work + 8 * cur.e;
    const int kv_lo = we[3], kv_valid = min(p.block_kv, we[5] - we[3]), shift = we[5] - qlen;
    const int k0 = cur.j * C::BKV, col0 = we[1] * p.block_kv + k0;  // packed column of key 0
    // Real keys, all at or left of the first row's diagonal: every live row
    // keeps every key.
    const bool free_tile =
        k0 + C::BKV <= kv_valid && (!p.causal || kv_lo + k0 + C::BKV - 1 <= t.first + shift);
    auto elem = [&](int r, int c, int hr, float& sc, float& dp) {
      const bool keep = free_tile || (k0 + c < kv_valid &&
                                      (!p.causal || kv_lo + k0 + c <= t.first + r + shift));
      float pr, ds;
      grad_plain(sc * p.scale_log2, dp, lse[hr], delta[hr], keep,
                 packed_drop_at<DROP>(p, seed_h, q0 + r, col0 + c), pr, ds);
      sc = pr;
      dp = ds;
    };
    dq_mma_tile<C, T>(Qs, dOs, Ks, Vs, elem, dq);
    walk_next(cur, t.e_hi, count);
  });
  dq_mma_store<C, T>(dq, Qs, static_cast<T*>(p.dq) + h * p.dq_sh + (long long)q0 * p.dq_ss,
                     p.dq_ss, C::BQ, p.scale);
}

// The 16-bit dk/dv kernel's tiles: 64 kv rows, 4 warps at D <= 128 (each 16
// kv rows, all of D), 8 at D 256 (two per 16 rows, each half of D); no dS^T.
template <int D>
using VarlenKvCfg = MmaCfg<D, 64, (D <= 128 ? 4 : 8), false>;

// dk/dv, 16-bit inputs: one block per (64-row kv tile p.order[y], kv head
// x). Entry e (a q block of group member w[7]) covers its q rows [r_lo,
// r_hi): from the first that sees the tile's first live column to q_len;
// its 64-row q tiles from r_lo rounded down and those of the next entries
// form one double-buffered loop through mma_q_step.
template <typename T, int D, bool DROP>
__global__ void __launch_bounds__(VarlenKvCfg<D>::NW * 32, 1)
    varlen_mma_dkdv_kernel(const VarlenParams p) {
  using C = VarlenKvCfg<D>;
  static_assert(C::BKV == TM && C::BQ == TM, "the host's 64-row tiles");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const MmaSmem<T> s = mma_smem<C, T>(smem_raw);
  const int hk = blockIdx.x, k0 = p.order[blockIdx.y] * C::BKV, group = p.Hq / p.Hkv;
  const TileSeg t = tile_seg(p, k0, p.block_kv, 3, 5);
  const int kvlen = t.len;

  // The q rows of entry e: [ra, r_hi) in q tiles of BQ (returned: their
  // count), ra = r_lo rounded down to a tile.
  auto rows = [&](int e, int& ra, int& r_hi) {
    const int* we = p.work + 8 * e;
    r_hi = min(p.block_q, we[4] - we[2]);
    const int r_lo = p.causal ? max(0, t.first - (kvlen - we[4]) - we[2]) : 0;
    ra = (r_lo / C::BQ) * C::BQ;
    return r_hi > r_lo ? (r_hi - ra + C::BQ - 1) / C::BQ : 0;
  };
  auto count = [&](int e) {
    int ra, r_hi;
    return rows(e, ra, r_hi);
  };
  int n_tiles = 0;
  for (int e = t.live > 0 ? t.e_lo : t.e_hi; e < t.e_hi; ++e) n_tiles += count(e);

  float dk[C::NT_KV][4], dv[C::NT_KV][4];
  mma_zero_kv<C>(dk, dv);
  if (n_tiles > 0) {
    cp_rows<C>(s.K, static_cast<const T*>(p.k) + hk * p.k_sh, p.k_ss, k0, C::BKV, k0 + t.live);
    cp_rows<C>(s.V, static_cast<const T*>(p.v) + hk * p.v_sh, p.v_ss, k0, C::BKV, k0 + t.live);
    Walk nxt, cur;  // the q tile whose copies go out next; the q tile computed next
    walk_from(nxt, t.e_lo, t.e_hi, count);
    cur = nxt;
    auto issue = [&](int i) {
      const int* we = p.work + 8 * nxt.e;
      int ra, r_hi;
      rows(nxt.e, ra, r_hi);
      const int h = hk * group + we[7];  // the q head: the forward's stream
      const long long qb0 = (long long)we[0] * p.block_q;  // packed row of the block's first query
      const long long row0 = (long long)h * p.T + qb0;
      mma_load_q_rows<C, T>(s, i & 1, static_cast<const T*>(p.q) + h * p.q_sh + qb0 * p.q_ss,
                            p.q_ss, static_cast<const T*>(p.dout) + h * p.do_sh + qb0 * p.do_ss,
                            p.do_ss, p.lse + row0, p.delta + row0, ra + nxt.j * C::BQ, r_hi);
      walk_next(nxt, t.e_hi, count);
    };
    mma_q_loop(n_tiles, issue, [&](int i) {
      const int* we = p.work + 8 * cur.e;
      int ra, r_hi;
      rows(cur.e, ra, r_hi);
      const int q_lo = we[2], qlen = we[4], shift = kvlen - qlen, r0 = ra + cur.j * C::BQ;
      const int row0 = we[0] * p.block_q + r0;  // packed row of the q tile's first row
      const uint32_t seed_h = counter_hash_u32(p.drop.seed, (uint32_t)(hk * group + we[7]));
      // Live kv rows and q rows, the tile's last column at or left of the
      // first q row's diagonal: every element kept.
      const bool free_tile = t.live == C::BKV && r0 + C::BQ <= r_hi &&
                             (!p.causal || t.first + C::BKV - 1 <= q_lo + r0 + shift);
      auto elem = [&](int kr, int qr, float lse, float delta, float& sc, float& dp) {
        const int row = q_lo + r0 + qr, col = t.first + kr;
        const bool keep =
            free_tile || (kr < t.live && row < qlen && (!p.causal || col <= row + shift));
        float pr, ds;
        grad_plain(sc * p.scale_log2, dp, lse, delta, keep,
                   packed_drop_at<DROP>(p, seed_h, row0 + qr, k0 + kr), pr, ds);
        sc = pr;
        dp = ds;
      };
      mma_q_step<C, T, false>(s, i & 1, elem, dk, dv);
      walk_next(cur, t.e_hi, count);
    });
  }
  mma_store_kv<C, T>(dk, static_cast<T*>(p.dk) + hk * p.dk_sh + (long long)k0 * p.dk_ss, p.dk_ss,
                     C::BKV, p.scale);
  mma_store_kv<C, T>(dv, static_cast<T*>(p.dv) + hk * p.dv_sh + (long long)k0 * p.dv_ss, p.dv_ss,
                     C::BKV, 1.f);
}

enum Kernel : int { kFwd = 0, kDq = 1, kDkDv = 2 };

template <typename K>
cudaError_t launch_kernel(K kernel, int smem_bytes, dim3 grid, int threads, const VarlenParams& p,
                          cudaStream_t stream) {
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) return e;
  kernel<<<grid, threads, smem_bytes, stream>>>(p);
  return cudaGetLastError();
}

// fp32 takes the FMA kernels (grid x the tile, y the head), bf16 / fp16 the
// tensor-core ones (no path back to the FMA ones; grid x the head, y the
// tile in p.order).
template <typename T, int D, bool DROP>
cudaError_t launch_kernels(const VarlenParams& p, int which, cudaStream_t stream) {
  const int tiles = p.T / TM;
  const int f = (int)sizeof(float);
  if (which != kFwd && which != kDq && which != kDkDv) return cudaErrorInvalidValue;
  if constexpr (std::is_same<T, float>::value) {
    if (which == kFwd) {
      return launch_kernel(varlen_fwd_kernel<T, D, DROP>, fwd_smem_floats<D>() * f,
                           dim3(tiles, p.Hq), THREADS, p, stream);
    }
    return which == kDq ? launch_kernel(varlen_dq_kernel<T, D, DROP>, dq_smem_floats<D>() * f,
                                        dim3(tiles, p.Hq), THREADS, p, stream)
                        : launch_kernel(varlen_dkdv_kernel<T, D, DROP>,
                                        dkdv_smem_floats<D>() * f, dim3(tiles, p.Hkv), THREADS,
                                        p, stream);
  } else {
    if (p.order == nullptr) return cudaErrorInvalidValue;
    using FC = FwdMmaCfg<D>;
    using QC = DqMmaCfg<D>;
    using KC = VarlenKvCfg<D>;
    if (which == kFwd) {
      return launch_kernel(varlen_mma_fwd_kernel<T, D, DROP>, FC::SMEM_BYTES, dim3(p.Hq, tiles),
                           FC::NW * 32, p, stream);
    }
    return which == kDq ? launch_kernel(varlen_mma_dq_kernel<T, D, DROP>, QC::SMEM_BYTES,
                                        dim3(p.Hq, tiles), QC::NW * 32, p, stream)
                        : launch_kernel(varlen_mma_dkdv_kernel<T, D, DROP>, KC::SMEM_BYTES,
                                        dim3(p.Hkv, tiles), KC::NW * 32, p, stream);
  }
}

template <typename T, int D>
cudaError_t launch(const VarlenParams& p, int which, cudaStream_t stream) {
  return p.drop.on ? launch_kernels<T, D, true>(p, which, stream)
                   : launch_kernels<T, D, false>(p, which, stream);
}

template <typename T>
cudaError_t launch_d(const VarlenParams& p, int which, int D, cudaStream_t stream) {
  switch (D) {
    case 64: return launch<T, 64>(p, which, stream);
    case 128: return launch<T, 128>(p, which, stream);
    case 256: return launch<T, 256>(p, which, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace fa2

// One entry for the three kernels (`which`: 0 forward, 1 dq, 2 dk/dv; the
// forward reads q, k, v and writes o, lse; the backward kernels read q, k,
// v, do, lse, delta and write dq or dk / dv). `work` / `rowptr` are the
// q-major table for 0 and 1, the kv-major one for 2; `order` the T / 64
// tiles of 64 rows, heaviest first (read by the 16-bit kernels, which fail
// the launch without it; may be null for fp32). `strides` holds, in
// elements, the head and row strides of q, k, v, do, o, dq, dk, dv (16
// values; the batch dim is 1). T must be a multiple of 64, block_q and
// block_kv multiples of 64 that divide T. 16-bit q / k / v / do / o: rows,
// strides and base pointers 16-byte aligned.
extern "C" int fa2_varlen(
    int which, int dtype, int Hq, int Hkv, int T, int D,
    const void* q, const void* k, const void* v, const void* dout, void* o, float* lse,
    const float* delta, void* dq, void* dk, void* dv,
    const int* work, const int* rowptr, const int* order, const long long* strides,
    int block_q, int block_kv, int causal, float softmax_scale,
    int dropout, unsigned int drop_seed, unsigned int drop_threshold, float drop_scale,
    void* stream) {
  fa2::VarlenParams p;
  p.q = q; p.k = k; p.v = v; p.dout = dout; p.o = o; p.lse = lse; p.delta = delta;
  p.dq = dq; p.dk = dk; p.dv = dv; p.work = work; p.rowptr = rowptr;
  p.order = order;
  const long long* s = strides;
  p.q_sh = s[0]; p.q_ss = s[1]; p.k_sh = s[2]; p.k_ss = s[3];
  p.v_sh = s[4]; p.v_ss = s[5]; p.do_sh = s[6]; p.do_ss = s[7];
  p.o_sh = s[8]; p.o_ss = s[9]; p.dq_sh = s[10]; p.dq_ss = s[11];
  p.dk_sh = s[12]; p.dk_ss = s[13]; p.dv_sh = s[14]; p.dv_ss = s[15];
  p.Hq = Hq; p.Hkv = Hkv; p.T = T; p.block_q = block_q; p.block_kv = block_kv;
  p.causal = causal;
  p.scale = softmax_scale;
  p.scale_log2 = softmax_scale * fa2::LOG2E;
  p.drop.on = dropout; p.drop.seed = drop_seed; p.drop.threshold = drop_threshold;
  p.drop.scale = drop_scale;
  if (T % fa2::TM || block_q % fa2::TM || block_kv % fa2::TM || T % block_q || T % block_kv) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case fa2::kF32: return (int)fa2::launch_d<float>(p, which, D, st);
    case fa2::kF16: return (int)fa2::launch_d<__half>(p, which, D, st);
    case fa2::kBF16: return (int)fa2::launch_d<__nv_bfloat16>(p, which, D, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
