// Tiles of the attention kernels at head dims past 512 (any multiple of
// 128): flash_fwd_any.cu's forward and flash_bwd_any.cu's dq and dk/dv.
//
// No tiling that holds whole rows of D in registers or shared memory
// reaches "any D": at D 1024 a 64-row Q tile alone is 132 KB of shared
// memory, and O or dQ over 16 rows x D / 2 columns a warp is 256 fp32
// registers a thread. So D is a run-time argument, and the output columns
// are split over blocks: a block owns a column chunk of DC = 256 columns
// of O (dQ; dK and dV), the accumulator width that is spill-free at D 256,
// and a grid dimension walks the chunks (`col_chunks`). Each block forms
// S = Q K^T (and dP = dO V^T) over the WHOLE D, streaming slices of KS =
// 64 columns of each operand through a double-buffered ring of shared
// memory (`slice_loop`), then applies P (dS) to its own chunk's columns of
// V (K; Q and dO), staged once per tile. Every block of a row tile does the
// same products in the same order for S, m and l, so the chunks agree on
// them bit for bit (lse included). The price is S (and dP) once per chunk:
// a forward does (n_chunks * 2 D + 2 D) / 4 D times the products of one
// pass, 2.5x at D 1024. A last chunk narrower than DC (D 640: 512 + 128)
// is zero-filled on load and cut at the store.
#pragma once

#include "attn_tiles.cuh"
#include "mma_tiles.cuh"

namespace fa2 {
namespace any {

constexpr int KS = 64;    // columns of a streamed slice of q / k / v / do
constexpr int DC = 256;   // output columns of a block (a column chunk)
constexpr int SP = KS + 8;   // a slice's shared row pitch (16 bytes of pad: ldmatrix banks)
constexpr int CP = DC + 8;   // a chunk's shared row pitch

// Column chunks of head dim D: the blocks a row tile (kv tile) is split over.
__host__ __device__ constexpr int col_chunks(int D) { return (D + DC - 1) / DC; }

// Rows [row0, row0 + ROWS) x columns [col0, col0 + W) of a row-major
// operand (row stride ss, D columns) into dst (pitch DP) by NT threads, as
// 16-byte cp.async copies; rows at or past `valid` and columns at or past D
// are zero-filled without a read. Not committed.
template <int ROWS, int W, int DP, int NT, typename T>
__device__ __forceinline__ void cp_tile(T* dst, const T* src, long long ss, int row0, int valid,
                                        int col0, int D) {
  constexpr int CH = W / 8;
  for (int i = threadIdx.x; i < ROWS * CH; i += NT) {
    const int r = i / CH, c = (i % CH) * 8;
    const bool ok = row0 + r < valid && col0 + c < D;
    cp_async16(dst + r * DP + c, ok ? src + (long long)(row0 + r) * ss + col0 + c : src, ok);
  }
}

// The slice loop: steps (i, s) for i < n_outer (kv tiles, q tiles) and s <
// n_slices (D / KS), in that order, double-buffered: issue(i, s, buf)
// copies step (i, s)'s slices into buffer buf (not committed; at s == 0
// also i's chunk tiles), step(i, s, buf) consumes them. One barrier a step:
// step j + 1 lands while step j computes.
template <class Issue, class Step>
__device__ __forceinline__ void slice_loop(int n_outer, int n_slices, const Issue& issue,
                                           const Step& step) {
  const int n = n_outer * n_slices;
  if (n <= 0) return;
  issue(0, 0, 0);
  cp_async_commit();
  int i = 0, s = 0;
#pragma unroll 1
  for (int j = 0; j < n; ++j) {
    cp_async_wait<0>();
    __syncthreads();  // step j has landed; every warp is done with step j - 1
    const int ni = s + 1 < n_slices ? i : i + 1, ns = s + 1 < n_slices ? s + 1 : 0;
    if (j + 1 < n) {
      issue(ni, ns, (j + 1) & 1);
      cp_async_commit();
    }
    step(i, s, j & 1);
    i = ni;
    s = ns;
  }
}

// acc[n] += A . B^T over one slice (KS columns): A the warp's 16 rows, B
// NT * 8 rows, both row-major with pitch P (accumulator element e of n-tile
// n: A row g + 8 (e / 2), B row n * 8 + 2 t + e % 2).
template <typename T, int NT, int P>
__device__ __forceinline__ void mma_abt(float (&acc)[NT][4], const T* A, const T* B) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int kk = 0; kk < KS / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, A + (lane % 16) * P + kk * 16 + (lane / 16) * 8);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b[4];
      ldsm_x4(b, B + (np * 16 + lane % 8 + (lane / 16) * 8) * P + kk * 16 + ((lane / 8) % 2) * 8);
      mma16816<T>(acc[2 * np], a, b[0], b[1]);
      mma16816<T>(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// The warp's 16 rows x KT * 16 columns held as fp32 accumulators x (n-tile
// n: columns n * 8 ..), rounded to T and repacked into A fragments.
template <typename T, int KT>
__device__ __forceinline__ void pack_frags(const float (&x)[2 * KT][4], uint32_t (&a)[KT][4]) {
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    a[kk][0] = pack2<T>(x[2 * kk][0], x[2 * kk][1]);
    a[kk][1] = pack2<T>(x[2 * kk][2], x[2 * kk][3]);
    a[kk][2] = pack2<T>(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    a[kk][3] = pack2<T>(x[2 * kk + 1][2], x[2 * kk + 1][3]);
  }
}

// acc[n] += A . B: A KT packed A fragments (pack_frags), B KT * 16 rows x NO
// * 8 columns, row-major with pitch P, read by ldmatrix.trans.
template <typename T, int KT, int NO, int P>
__device__ __forceinline__ void mma_ab(float (&acc)[NO][4], const uint32_t (&a)[KT][4],
                                       const T* B) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
#pragma unroll
    for (int np = 0; np < NO / 2; ++np) {
      uint32_t b[4];
      ldsm_x4_t(b, B + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * P + np * 16 + (lane / 16) * 8);
      mma16816<T>(acc[2 * np], a[kk], b[0], b[1]);
      mma16816<T>(acc[2 * np + 1], a[kk], b[2], b[3]);
    }
  }
}

// acc[n] += X . B for fp32 accumulators x (pack_frags, then mma_ab).
template <typename T, int KT, int NO, int P>
__device__ __forceinline__ void mma_xb(float (&acc)[NO][4], const float (&x)[2 * KT][4],
                                       const T* B) {
  uint32_t a[KT][4];
  pack_frags<T, KT>(x, a);
  mma_ab<T, KT, NO, P>(acc, a, B);
}

template <int N>
__device__ __forceinline__ void zero_frags(float (&x)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[n][e] = 0.f;
}

// A warp's NO * 8 accumulator columns of its 16 rows (row0 of the warp at
// out, row stride ss) times mul, rounded to T: rows < rows, columns < cols
// (the chunk's, cut at D).
template <typename T, int NO>
__device__ __forceinline__ void store_frags(const float (&x)[NO][4], T* out, long long ss,
                                            int rows, int cols, float mul) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = g + 8 * hr;
    if (r >= rows) continue;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int c = n * 8 + 2 * t;
      if (c < cols) {
        *reinterpret_cast<uint32_t*>(out + r * ss + c) =
            pack2<T>(x[n][2 * hr] * mul, x[n][2 * hr + 1] * mul);
      }
    }
  }
}

// ---- fp32 inputs: FMA tiles over slices ---------------------------------------

// Rows [row0, row0 + rows) x columns [col0, col0 + W) of a [*, D] operand
// (row stride ss) into dst (pitch DP) as fp32 times mul, by THREADS threads;
// rows at or past `valid` and columns at or past D are zero.
template <typename T, int W, int DP>
__device__ __forceinline__ void stage_cols(float* dst, const T* src, long long ss, int row0,
                                           int rows, int valid, int col0, int D, float mul) {
  constexpr int W4 = W / 4;
  for (int i = threadIdx.x; i < rows * W4; i += THREADS) {
    const int r = i / W4, d = (i % W4) * 4;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (row0 + r < valid && col0 + d < D) load_vec<T, 4>(src + (long long)(row0 + r) * ss + col0 + d, x);
#pragma unroll
    for (int j = 0; j < 4; ++j) dst[r * DP + d + j] = x[j] * mul;
  }
}

}  // namespace any
}  // namespace fa2
