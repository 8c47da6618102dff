// The float32 flash-attention machinery for head dims above 128 (up to
// 256), shared by the forward K1 (flash_attention_fwd.cu) and the backward
// K2 and K3 (flash_attention_bwd.cu).
//
// Why a second design: the split-TF32 kernels (flash_attention_tf32.cuh)
// keep a 64-row f32 tile of the whole head dim in shared memory and a
// warp's 16 rows of the output in registers. At D = 256 a tile is 64 KB:
// K1's q tile and a 2-stage k/v ring would take 320 KB against the 227 KB
// a block may hold, and the output accumulator alone 128 registers a
// thread. The one main path above D = 128 is the multihead Pythia's
// attention from one question row to 100 regions at D = 256 (B = 512,
// H = 8): a matrix-vector product a (b, h), whose bound is the bytes of k
// and v (~0.85 GB, ~0.25 ms at 3.35 TB/s), ~1 FLOP a byte. A 16-row mma
// tile would spend 15 of its 16 rows on padding there.
//
// So these kernels are plain FP32 FMA code (exact f32 products, no tensor
// cores), shaped for few query rows and wide heads:
//   - a block is 8 warps (W_THREADS) and owns W_QR = 16 rows of the
//     operand it keeps (K1, K2: q rows; K3: 32 kv rows, W_KT); the other
//     operand streams through a 2-stage ring of tiles (K1, K2: 32 kv rows;
//     K3: 16 q rows) filled by 16-byte cp.async copies, rows past the
//     sequence zero-filled. At D = 256 a K1 block holds ~147 KB, K2
//     ~163 KB, K3 ~134 KB: one block an SM, its next tile's copies in
//     flight during this tile's math;
//   - the dot products over the head dim (scores s = q k^T and, in the
//     backward, dp = dO v^T): warp w takes the tile's rows w, w + 8, w +
//     16, w + 24 of the streamed or owned 32-row operand, each lane two
//     16-byte chunks of the head dim (lane and lane + 32), the partial sums
//     reduced over the warp by shuffles; only the rows that exist are
//     computed, so one query row costs one row's work;
//   - the products that reduce over the tile's rows (o += p v, dq += ds k,
//     dv += p^T dO, dk += ds^T q): thread d owns head-dim column d and
//     keeps its column of the block's rows in registers (16 for K1 and
//     K2, 2 x 32 for K3), reading the tile's column d (consecutive threads,
//     consecutive addresses) and the shared probabilities as broadcasts;
//   - the online softmax (K1) runs a warp a row over the tile's 32
//     columns, two rows a warp;
//   - K2 walks its kv tiles twice, as the split-TF32 K2 does: delta =
//     rowsum(p dp) over the first pass (flash_attention_bwd.cu says why).
// Layout in shared memory: row r of a [rows, D] operand at r * D floats
// (D is a multiple of 8, so rows stay 16-byte aligned); the dot products
// read whole 512-byte row slices per warp and the column products
// consecutive words: no bank conflicts.

#pragma once

#include <math.h>

#include "flash_attention_common.cuh"
#include "hopper.cuh"

namespace mmf_flash_wide {

using namespace mmf_flash;
using mmf_hopper::smem_u32;

constexpr int W_THREADS = 256;  // 8 warps
constexpr int W_WARPS = W_THREADS / 32;
constexpr int W_QR = 16;        // q rows a K1/K2 block, a K3 ring tile
constexpr int W_KT = 32;        // kv rows a K1/K2 ring tile, a K3 block
constexpr int W_MAX_D = 256;
constexpr int W_PT = 20;        // row stride (floats) of the transposed p
constexpr float W_LOG2E = 1.4426950408889634f;

// 16 bytes from global into shared memory, zeros when `valid` is false
// (nothing is read then; `src` must still be a mapped address).
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most one committed group of this thread is pending.
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Starts copying rows r0 .. r0 + rows - 1 of a [n, D] operand (rows
// `ld` floats apart, head dim contiguous) into `dst` ([rows, D] floats);
// rows at or past n are zero-filled.
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          long long ld, int r0, int rows,
                                          int n, int D) {
  const int per_row = D / 4;
  for (int i = threadIdx.x; i < rows * per_row; i += W_THREADS) {
    const int r = i / per_row, c = i - r * per_row;
    const bool in = r0 + r < n;
    cp_async_16(dst + r * D + 4 * c, src + (in ? r0 + r : 0) * ld + 4 * c,
                in);
  }
}

// This lane's two 16-byte chunks of row `row` ([., D] in shared memory):
// columns 4 lane .. + 3 and 128 + 4 lane .. + 3, zeros past D.
__device__ __forceinline__ void load_chunks(float4 (&x)[2], const float* row,
                                            int D) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = 4 * (lane + 32 * i);
    x[i] = c < D ? *reinterpret_cast<const float4*>(row + c)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

__device__ __forceinline__ float dot_chunks(const float4 (&a)[2],
                                            const float4 (&b)[2]) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    s = fmaf(a[i].x, b[i].x, s);
    s = fmaf(a[i].y, b[i].y, s);
    s = fmaf(a[i].z, b[i].z, s);
    s = fmaf(a[i].w, b[i].w, s);
  }
  return s;
}

// The four 32-row tile rows warp w takes in the dot products.
__device__ __forceinline__ int tile_row(int u) {
  return (threadIdx.x >> 5) + W_WARPS * u;
}

// Sums x[u] over the warp (every lane gets the four sums).
__device__ __forceinline__ void warp_sum4(float (&x)[4]) {
#pragma unroll
  for (int u = 0; u < 4; ++u) x[u] = sum_xor(x[u], 32);
}

// The value of x[u] for the lane u (< 4) that stores it: a select chain, so
// no register array is indexed by a run-time value.
__device__ __forceinline__ float pick4(const float (&x)[4], int u) {
  return u == 0 ? x[0] : u == 1 ? x[1] : u == 2 ? x[2] : x[3];
}

}  // namespace mmf_flash_wide
