// The float32 flash-attention machinery shared by the forward K1
// (flash_attention_fwd.cu) and the backward K2 and K3
// (flash_attention_bwd.cu): split-TF32 ("3xTF32") products on the tensor
// cores.
//
// Each f32 operand x is split as x = hi + lo, hi = x truncated to TF32
// (its low 13 mantissa bits cleared) and lo = x - hi (exact), which the
// tensor core reads truncated to TF32 in turn; each product a b runs as
// lo(a) hi(b) + hi(a) lo(b) + hi(a) hi(b) on mma.sync.m16n8k8 tf32, the
// small terms first into the f32 accumulator. lo(a) lo(b), ~2^-20 of the
// product, is dropped: the inputs keep ~21 of f32's 24 significant bits
// where plain TF32 keeps 11 (TF32 alone would put ~1e-3 into p through
// the scores).
//
// Route: mma.sync with the operands read from the swizzled TMA tiles into
// registers, not wgmma. wgmma takes 32-bit operands K-major only (no
// transpose for tf32, and TMA does not transpose 4-byte elements), so
// p v, ds k, p^T dO and ds^T q would need v^T, k^T, dO^T and q^T written
// by the block, and each operand read from shared memory would need its lo
// half in a buffer of its own (a K2 block at D = 64: 194 KB, one block an
// SM; at D = 128, 354 KB, which does not fit). With mma.sync the split
// happens in registers as each fragment is loaded and the transposed
// operands are read in place: no derived copy, two blocks an SM at
// D <= 64.
//   - A block is four warps of 16 rows each and no producer warp: thread
//     0 starts the TMA loads of a 2-stage ring (the f32 rows by cp.async
//     from every thread, mbarriers), and a barrier a tile frees a stage.
//     With a fifth warp, three warps share some SM quarters and ptxas
//     capped the registers at 168, where the products spilled; four
//     warps get up to 255 (two blocks an SM). Tiles are 64 rows of
//     32-column f32 boxes under the 128-byte swizzle, so every fragment
//     load below reads 32 distinct banks.
//   - The m16n8k8 accumulator holds (row g, columns 2t, 2t + 1) where its
//     A fragment wants (row g, columns t, t + 4) (g = lane / 4, t = lane %
//     4). Instead of shuffling, the second products (p v, ds k, p^T dO,
//     ds^T q) take the reduction index of each 8 in the order 0, 2, 4, 6,
//     1, 3, 5, 7: the accumulator registers are the A fragment as they
//     stand, and the B fragment reads rows 2t and 2t + 1 of the tile.
//   - The scores come out in the wgmma accumulator layout, so p and ds are
//     formed in the registers by the bf16 kernels' helpers.
//   - mma.sync's tf32 peak is ~319 TFLOP/s (tensor_core_rates.py); the
//     split, the loads and the exp keep the warps' issue, not the tensor
//     cores, the limit (PERF.md).

#pragma once

#include "flash_attention_sm90.cuh"

namespace mmf_flash_tf32 {

using namespace mmf_flash_sm90;

constexpr int F_STAGES = 2;          // the ring's depth
constexpr int F_THREADS = ROWS * 2;  // four warps of 16 rows, no producer

// Shared memory of a block, NB 64-column blocks of the head dim (2 NB
// boxes a tile): its OWN own tiles (K1: q; K2: q and dO; K3: k and v), the
// ring (two tiles and up to 256 f32 row values a stage), K2's row
// statistics, the mbarriers.
template <int NB, int OWN = 2>
struct FLayout {
  static constexpr int TILE = 2 * NB * BOX_BYTES;  // 64 rows x 64 NB f32
  static constexpr int STAGE = 2 * TILE + ALIGN;
  static constexpr int RING = OWN * TILE;
  static constexpr int STATS = RING + F_STAGES * STAGE;
  static constexpr int BARS = STATS + 3 * ROWS * 4;
  static constexpr int BYTES = BARS + (F_STAGES + 1) * 8 + ALIGN;
};

// Fragment offsets (floats) within a swizzled f32 tile: 64 rows of 32-
// column boxes (2048 floats each), 128 bytes a row, 16-byte chunk m of
// row r at chunk m ^ (r % 8). Each lane keeps its own part of them, so
// that every fragment load is a base register plus a constant:
//   - rows 8 n + g (16 w + g in the own tiles), column 8 kk + t + 4 h:
//     2048 (kk / 4) + 256 n + row_k[(2 kk + h) % 8];
//   - rows 8 j + 2t + h, column 8 n + g: 2048 (n / 4) + 256 j +
//     col_k[n % 4][h].
struct FragOffsets {
  int row_k[8], col_k[4][2];

  __device__ __forceinline__ FragOffsets() {
    const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
    for (int m = 0; m < 8; ++m) row_k[m] = 32 * g + ((m ^ g) << 2) + t;
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        col_k[n][h] = 64 * t + 32 * h +
                      (((2 * n + (g >> 2)) ^ (2 * t + h)) << 2) + (g & 3);
  }
};

struct Split {
  uint32_t hi, lo;
};

// hi: x with its low 13 mantissa bits cleared (a TF32 value, exact as the
// tensor core reads it); lo = x - hi, exact in f32, which the tensor core
// reads to its top 11 bits (|lo| < 2^-10 |x|, so x keeps ~21 bits).
__device__ __forceinline__ Split split_tf32(float x) {
  const uint32_t hi = __float_as_uint(x) & 0xffffe000u;
  return {hi, __float_as_uint(x - __uint_as_float(hi))};
}

__device__ __forceinline__ void mma_tf32(float* d, uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The three TF32 products of d += a b in their order: 0 lo(a) hi(b), 1
// hi(a) lo(b), 2 hi(a) hi(b) (small terms first).
__device__ __forceinline__ void mma_term(int term, float* d,
                                         const Split (&a)[4], Split b0,
                                         Split b1) {
  if (term == 0)
    mma_tf32(d, a[0].lo, a[1].lo, a[2].lo, a[3].lo, b0.hi, b1.hi);
  else if (term == 1)
    mma_tf32(d, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b0.lo, b1.lo);
  else
    mma_tf32(d, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b0.hi, b1.hi);
}

// s = A B^T over the 64 NB head-dim columns (zeros past D), and with
// N_PRODUCTS = 2 also dp = C E^T (K2, K3; K1 passes one): the warp's rows
// 16 w + g and + 8 of the own tiles A and C (`A` and `C` already offset to
// row 16 w) against the 64 rows of the ring tiles B and E. s[4 n + e] is
// row g + 8 (e >> 1) of the warp, column 8 n + 2t + (e & 1): the wgmma
// accumulator layout the bf16 helpers read. A k-step's fragments are
// loaded and split first, then its products issue term by term over the
// accumulators, so no product waits on the one before.
template <int NB, int N_PRODUCTS>
__device__ __forceinline__ void score_products(float (&s)[32],
                                               float (&dp)[32],
                                               const float* A,
                                               const float* B,
                                               const float* C,
                                               const float* E,
                                               const FragOffsets& o) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    s[i] = 0.f;
    if (N_PRODUCTS == 2) dp[i] = 0.f;
  }
#pragma unroll
  for (int kk = 0; kk < 8 * NB; ++kk) {
    const int lo = o.row_k[(2 * kk) & 7] + 2048 * (kk >> 2);
    const int hi = o.row_k[(2 * kk + 1) & 7] + 2048 * (kk >> 2);
    const Split a[4] = {split_tf32(A[lo]), split_tf32(A[lo + 256]),
                        split_tf32(A[hi]), split_tf32(A[hi + 256])};
    Split e[4];
    if (N_PRODUCTS == 2) {
      e[0] = split_tf32(C[lo]);
      e[1] = split_tf32(C[lo + 256]);
      e[2] = split_tf32(C[hi]);
      e[3] = split_tf32(C[hi + 256]);
    }
    Split b[8][2], f[8][2];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      b[n][0] = split_tf32(B[lo + 256 * n]);
      b[n][1] = split_tf32(B[hi + 256 * n]);
      if (N_PRODUCTS == 2) {
        f[n][0] = split_tf32(E[lo + 256 * n]);
        f[n][1] = split_tf32(E[hi + 256 * n]);
      }
    }
#pragma unroll
    for (int term = 0; term < 3; ++term)
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        mma_term(term, &s[4 * n], a, b[n][0], b[n][1]);
        if (N_PRODUCTS == 2) mma_term(term, &dp[4 * n], e, f[n][0], f[n][1]);
      }
  }
}

// acc += X B, reduced over the 64 rows of the ring tile B, for two such
// products at once (X0 B0 into acc0, X1 B1 into acc1; K1 and K2 pass one):
// X is the warp's [16, 64] in the accumulator layout above, taken as the A
// fragment with the reduction index permuted within each 8 (slot t is
// column 2t, slot t + 4 column 2t + 1), and B read in the same order (rows
// 8 j + 2t and 8 j + 2t + 1). acc[nb][4 i + e]: head-dim column 64 nb +
// 8 i + 2t + (e & 1), as store_rows writes it. Products issue term by
// term over the accumulators, as in score_products.
template <int NB, int N_PRODUCTS>
__device__ __forceinline__ void acc_products(float (&acc0)[NB][32],
                                             const float (&x0)[32],
                                             const float* B0,
                                             float (&acc1)[NB][32],
                                             const float (&x1)[32],
                                             const float* B1,
                                             const FragOffsets& o) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const Split a[4] = {split_tf32(x0[4 * j]), split_tf32(x0[4 * j + 2]),
                        split_tf32(x0[4 * j + 1]),
                        split_tf32(x0[4 * j + 3])};
    Split c[4];
    if (N_PRODUCTS == 2) {
      c[0] = split_tf32(x1[4 * j]);
      c[1] = split_tf32(x1[4 * j + 2]);
      c[2] = split_tf32(x1[4 * j + 1]);
      c[3] = split_tf32(x1[4 * j + 3]);
    }
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      Split b[8][2], f[8][2];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int n = 8 * nb + i;
        const int at = 2048 * (n >> 2) + 256 * j;
        b[i][0] = split_tf32(B0[at + o.col_k[n & 3][0]]);
        b[i][1] = split_tf32(B0[at + o.col_k[n & 3][1]]);
        if (N_PRODUCTS == 2) {
          f[i][0] = split_tf32(B1[at + o.col_k[n & 3][0]]);
          f[i][1] = split_tf32(B1[at + o.col_k[n & 3][1]]);
        }
      }
#pragma unroll
      for (int term = 0; term < 3; ++term)
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          mma_term(term, &acc0[nb][4 * i], a, b[i][0], b[i][1]);
          if (N_PRODUCTS == 2)
            mma_term(term, &acc1[nb][4 * i], c, f[i][0], f[i][1]);
        }
    }
  }
}

// Zeros the boxes past `boxes` of every tile TMA fills (the OWN own tiles
// and both tiles of each stage), which it never writes: the products run
// over all 64 NB columns. Nothing to do when D fills the tiles' boxes.
template <int NB, int OWN>
__device__ __forceinline__ void zero_spare_boxes(unsigned char* base,
                                                 int boxes) {
  using Lay = FLayout<NB, OWN>;
  const int spare = 2 * NB - boxes;
  if (spare == 0) return;
  constexpr int TILES = OWN + 2 * F_STAGES;
  const int per_tile = spare * (BOX_BYTES / 16);  // 16-byte stores
  for (int i = threadIdx.x; i < TILES * per_tile; i += F_THREADS) {
    const int tile = i / per_tile, at = i - tile * per_tile;
    unsigned char* t = tile < OWN ? base + tile * Lay::TILE
                                  : base + Lay::RING +
                                        ((tile - OWN) >> 1) * Lay::STAGE +
                                        ((tile - OWN) & 1) * Lay::TILE;
    reinterpret_cast<float4*>(t + boxes * BOX_BYTES)[at] =
        make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// Thread 0 starts the block's OWN own tiles (`boxes` 32-column boxes of 64
// rows from row0 of map m0 and, for OWN = 2, of m1) onto `bar`.
template <int NB, int OWN>
__device__ __forceinline__ void load_own_f32(unsigned char* base,
                                             uint64_t* bar,
                                             const CUtensorMap* m0,
                                             const CUtensorMap* m1, int row0,
                                             int h, int b, int boxes) {
  if (threadIdx.x != 0) return;
  mbar_arrive_expect_tx(bar, OWN * boxes * BOX_BYTES);
  for (int i = 0; i < boxes; ++i) {
    tma_load(base + i * BOX_BYTES, m0, bar, 32 * i, row0, h, b);
    if (OWN == 2)
      tma_load(base + FLayout<NB>::TILE + i * BOX_BYTES, m1, bar, 32 * i,
               row0, h, b);
  }
}

// Starts ring tile t (64 rows from row0) into stage t % F_STAGES: thread 0
// its two tiles by TMA, every thread its share of the stage's f32 rows by
// cp.async (`fill`); every thread arrives on the stage's full barrier once
// its copies land, so no thread waits for a load here.
template <int NB, typename Fill>
__device__ __forceinline__ void load_stage(int t, unsigned char* ring,
                                           uint64_t* full,
                                           const CUtensorMap* m0,
                                           const CUtensorMap* m1, int row0,
                                           int h, int b, int boxes,
                                           Fill fill) {
  using Lay = FLayout<NB>;
  const int s = t % F_STAGES;
  unsigned char* st = ring + s * Lay::STAGE;
  if (threadIdx.x == 0) {
    mbar_expect_tx(&full[s], 2 * boxes * BOX_BYTES);
    for (int i = 0; i < boxes; ++i) {
      tma_load(st + i * BOX_BYTES, m0, &full[s], 32 * i, row0, h, b);
      tma_load(st + Lay::TILE + i * BOX_BYTES, m1, &full[s], 32 * i, row0, h,
               b);
    }
  }
  fill(reinterpret_cast<float*>(st + 2 * Lay::TILE));
  cp_async_arrive(&full[s]);
}

// Before tile t's products: starts tile t + F_STAGES - 1 into the stage
// that tile t - 1 used, once every warp is done with it (the loads of a
// tile overlap the products of the tiles before it), then waits for tile
// t. The first F_STAGES - 1 tiles are started before the loop. With
// `period`, the ring walks the rows `period` tiles at a time, again and
// again (tile t holds rows 64 (t % period) on; K2's two passes).
template <int NB, typename Fill>
__device__ __forceinline__ void next_stage(int t, int n_tiles,
                                           unsigned char* ring,
                                           uint64_t* full,
                                           const CUtensorMap* m0,
                                           const CUtensorMap* m1, int h,
                                           int b, int boxes, Fill fill,
                                           int period = 0) {
  const int ahead = t + F_STAGES - 1;
  if (ahead < n_tiles) {
    if (t > 0) __syncthreads();
    load_stage<NB>(ahead, ring, full, m0, m1,
                   64 * (period > 0 ? ahead % period : ahead), h, b, boxes,
                   fill);
  }
  mbar_wait(&full[t % F_STAGES], (t / F_STAGES) & 1);
}

__device__ __forceinline__ void init_f32_barriers(uint64_t* full,
                                                  uint64_t* own_bar) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < F_STAGES; ++s) mbar_init(&full[s], F_THREADS);
    mbar_init(own_bar, 1);
    mbar_init_fence();
  }
  __syncthreads();
}

}  // namespace mmf_flash_tf32
