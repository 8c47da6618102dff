// The warp-specialised Hopper (sm_90a) machinery shared by the bfloat16
// flash-attention kernels: the forward K1 (flash_attention_fwd.cu) and the
// backward K2 and K3 (flash_attention_bwd.cu).
//
// A block is one consumer warpgroup (warps 0-3, the 64 rows it owns) and
// one producer warp (warp 4) that keeps a ring of STAGES shared-memory
// stages filled by TMA and cp.async; mbarriers signal a full stage (32
// producer lanes and the copies' bytes) and an empty one (128 consumer
// threads). The head dim is padded with zeros to NB 64-column boxes
// (NB = 1 for D <= 64, 2 up to 128); layouts and descriptors in hopper.cuh.
//
// The tiles' elementwise math is branch-free (selects, clamped indices,
// the kind of bias chosen once per tile), so the 32 elements' dependency
// chains interleave; with a branch per element they run one after another.

#pragma once

#include "flash_attention_common.cuh"
#include "hopper.cuh"

namespace mmf_flash_sm90 {

using namespace mmf_flash;
using namespace mmf_hopper;

constexpr int STAGES = 3;       // ring depth
constexpr int ALIGN = 1024;     // swizzled boxes start on 1 KB
constexpr int ROWS = 64;        // rows a block owns
constexpr int CONSUMERS = 128;  // one warpgroup
constexpr int THREADS = CONSUMERS + 32;

// Layout of a block's shared memory: its OWN own operands (64 rows each,
// loaded once), the ring (two tiles and up to 256 f32 row values a
// stage), f32 row statistics (K2), the mbarriers.
template <int NB, int OWN = 2>
struct WLayout {
  static constexpr int TILE = NB * BOX_BYTES;  // one operand, 64 rows
  static constexpr int STAGE = 2 * TILE + ALIGN;
  static constexpr int RING = OWN * TILE;
  static constexpr int STATS = RING + STAGES * STAGE;
  static constexpr int BARS = STATS + 3 * ROWS * 4;
  static constexpr int BYTES = BARS + (2 * STAGES + 1) * 8 + ALIGN;
};

__device__ __forceinline__ unsigned char* align_smem(unsigned char* p) {
  const uint32_t a = smem_u32(p);
  return p + ((ALIGN - a % ALIGN) % ALIGN);
}

// The ring's stage index and phase parity of tile t.
__device__ __forceinline__ int stage_of(int t) { return t % STAGES; }
__device__ __forceinline__ uint32_t full_parity(int t) {
  return (t / STAGES) & 1;
}

// Producer: waits for stage `t` to be free; lane 0 starts the two tiles'
// copies; then `fill` starts cp.async copies of the stage's f32 rows (all
// 32 lanes), and every lane arrives on the full barrier when its copies
// land, so the producer never waits for a load.
template <int NB, typename Fill>
__device__ __forceinline__ void produce(int t, unsigned char* ring,
                                        uint64_t* full, uint64_t* empty,
                                        const CUtensorMap* m0,
                                        const CUtensorMap* m1, int row0,
                                        int h, int b, Fill fill) {
  using Lay = WLayout<NB>;
  const int s = stage_of(t);
  if (t >= STAGES) mbar_wait(&empty[s], ((t / STAGES) - 1) & 1);
  unsigned char* st = ring + s * Lay::STAGE;
  if ((threadIdx.x & 31) == 0) {
    mbar_expect_tx(&full[s], 2 * Lay::TILE);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      tma_load(st + nb * BOX_BYTES, m0, &full[s], 64 * nb, row0, h, b);
      tma_load(st + Lay::TILE + nb * BOX_BYTES, m1, &full[s], 64 * nb, row0,
               h, b);
    }
  }
  fill(reinterpret_cast<float*>(st + 2 * Lay::TILE));
  cp_async_arrive(&full[s]);
}

// One thread loads the block's OWN own operands (64 rows from row0 of map
// m0 and, for OWN = 2, of m1) to the start of shared memory, onto `bar`.
template <int NB, int OWN = 2>
__device__ __forceinline__ void load_own(unsigned char* base, uint64_t* bar,
                                         const CUtensorMap* m0,
                                         const CUtensorMap* m1, int row0,
                                         int h, int b) {
  mbar_arrive_expect_tx(bar, OWN * WLayout<NB>::TILE);
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
    tma_load(base + nb * BOX_BYTES, m0, bar, 64 * nb, row0, h, b);
    if (OWN == 2)
      tma_load(base + WLayout<NB>::TILE + nb * BOX_BYTES, m1, bar, 64 * nb,
               row0, h, b);
  }
}

// The A operand of a 64-deep product from a 64 x 64 f32 accumulator,
// rounded to bf16: k16 step kk takes column blocks 2 kk and 2 kk + 1.
__device__ __forceinline__ void pack_acc(uint32_t (&a)[4][4],
                                         const float (&d)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[kk][r] = pack_bf16(d[8 * kk + 2 * r], d[8 * kk + 2 * r + 1]);
}

__device__ __forceinline__ void store_pair(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}
__device__ __forceinline__ void store_pair(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

// Stores rows `row[i]` (i < 2) of a warpgroup's [64, 64 NB] accumulators
// as T (bf16 or f32), row i times `mul[i]`, columns below D.
template <int NB, typename T>
__device__ __forceinline__ void store_rows(T* base, long long ld,
                                           const int (&row)[2], int n_rows,
                                           int D, const float (&mul)[2],
                                           const float (&acc)[NB][32]) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= n_rows) continue;
    T* dst = base + row[i] * ld;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int d = 64 * nb + 8 * j + 2 * t;
        if (d < D)
          store_pair(dst + d, acc[nb][4 * j + 2 * i] * mul[i],
                     acc[nb][4 * j + 2 * i + 1] * mul[i]);
      }
  }
}

// The same with one factor for both rows.
template <int NB>
__device__ __forceinline__ void store_rows(bf16* base, long long ld,
                                           const int (&row)[2], int n_rows,
                                           int D, float mul,
                                           const float (&acc)[NB][32]) {
  const float both[2] = {mul, mul};
  store_rows<NB, bf16>(base, ld, row, n_rows, D, both, acc);
}

// exp(x) as exp2(x log2 e): the subtraction s - m comes first, so the
// finite -0.7 * f32max mask value never overflows the product.
constexpr float LOG2E = 1.4426950408889634f;

// 1 / x to about 1 ulp, branch-free (x = l >= 1 here, or 0 on rows that
// are masked out afterwards).
__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

}  // namespace mmf_flash_sm90
