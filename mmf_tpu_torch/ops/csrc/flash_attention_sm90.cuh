// The warp-specialised Hopper (sm_90a) machinery shared by the bfloat16
// flash-attention kernels: the forward K1 (flash_attention_fwd.cu) and the
// backward K2 and K3 (flash_attention_bwd.cu).
//
// A block is one consumer warpgroup (warps 0-3, the 64 rows it owns) and
// one producer warp (warp 4) that keeps a ring of NST shared-memory
// stages filled by TMA and cp.async; mbarriers signal a full stage (32
// producer lanes and the copies' bytes) and an empty one (128 consumer
// threads). The head dim is padded with zeros to NB 64-column boxes
// (NB = 1 for D <= 64, 2 up to 128); layouts and descriptors in hopper.cuh.
//
// K1 and K2 run persistent grids (persistent_grid, item_of): as many
// blocks as fit on the card, each working through items of 64 rows of one
// (b, h), with barriers for the own operands (own_full, own_empty) so the
// producer loads the next item's while the consumers finish this one.
// Each writes its bf16 output by TMA store from an own tile it is done
// with (stage_rows, store_boxes): with each thread storing 4-byte pairs,
// the stores took ~30% of K1's time at ViLBERT's shapes and MMFT's
// (PERF.md). K3 keeps a block for each 64 kv rows and its plain
// stores.
//
// The ring's depth is a template parameter of the layout and the
// producer. What it trades: a block at D = 128 owns 32 KB (K1: two q
// buffers; K2: q and dO) and a stage holds a 16 KB k (or q) and a 16 KB v
// (or dO) tile, so three stages take a block to ~131 KB of shared memory,
// one block an SM; two stages (~100 KB) let two blocks share an SM.
// Registers bound the blocks an SM too: with five warps a block, two
// blocks put three warps on some quarter of the SM and ptxas gives a
// thread 168 registers, three blocks 128. K3 keeps three stages (STAGES).
//
// The tiles' elementwise math is branch-free (selects, clamped indices,
// the kind of bias a template parameter of the kernel), so the 32
// elements' dependency chains interleave; with a branch per element they
// run one after another.

#pragma once

#include <mutex>
#include <vector>

#include "flash_attention_common.cuh"
#include "hopper.cuh"

namespace mmf_flash_sm90 {

using namespace mmf_flash;
using namespace mmf_hopper;

constexpr int STAGES = 3;       // ring depth of K3
constexpr int ALIGN = 1024;     // swizzled boxes start on 1 KB
constexpr int ROWS = 64;        // rows a block owns
constexpr int CONSUMERS = 128;  // one warpgroup
constexpr int THREADS = CONSUMERS + 32;

// Layout of a block's shared memory: its OWN own operands (64 rows each,
// loaded once per item), the ring of NST stages (two tiles and up to 256
// f32 row values a stage), f32 row statistics (K2), the mbarriers (full
// and empty a stage, and OWN_BARS for the own operands).
template <int NB, int OWN = 2, int NST = STAGES, int OWN_BARS = 1>
struct WLayout {
  static constexpr int TILE = NB * BOX_BYTES;  // one operand, 64 rows
  static constexpr int STAGE = 2 * TILE + ALIGN;
  static constexpr int RING = OWN * TILE;
  static constexpr int STATS = RING + NST * STAGE;
  static constexpr int BARS = STATS + 3 * ROWS * 4;
  static constexpr int BYTES = BARS + (2 * NST + OWN_BARS) * 8 + ALIGN;
};

__device__ __forceinline__ unsigned char* align_smem(unsigned char* p) {
  const uint32_t a = smem_u32(p);
  return p + ((ALIGN - a % ALIGN) % ALIGN);
}

// The stage index and phase parity of tile t in a ring of NST stages.
template <int NST = STAGES>
__device__ __forceinline__ int stage_of(int t) {
  return t % NST;
}
template <int NST = STAGES>
__device__ __forceinline__ uint32_t full_parity(int t) {
  return (t / NST) & 1;
}

// Thread 0 initialises a ring's barriers (full: the producer's 32 lanes;
// empty: the consumers) and those of OWNB buffers of the own operands
// (own_full: the producer's one thread and the copies' bytes; own_empty:
// the consumers); the block syncs.
template <int NST, int OWNB = 1>
__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* empty,
                                          uint64_t* own_full,
                                          uint64_t* own_empty) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < NST; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], CONSUMERS);
    }
    for (int s = 0; s < OWNB; ++s) {
      mbar_init(&own_full[s], 1);
      mbar_init(&own_empty[s], CONSUMERS);
    }
    mbar_init_fence();
  }
  __syncthreads();
}

// The items of a persistent grid: block blockIdx.x takes items blockIdx.x,
// + gridDim.x, ...; item i is the 64-row block i % n_blocks of (h, b) =
// (i / n_blocks % H, i / (n_blocks H)), so the row blocks of one (b, h),
// which read the same k and v, run side by side.
struct Item {
  int row0, h, b;
};

__device__ __forceinline__ Item item_of(int i, int n_blocks, int H) {
  const int r = i % n_blocks, bh = i / n_blocks;
  return {ROWS * r, bh % H, bh / H};
}

// Sets a kernel's dynamic shared memory size and asks the occupancy
// calculator how many of its blocks fit on an SM.
template <typename Kernel>
inline cudaError_t blocks_per_sm(Kernel kernel, int threads, int smem,
                                 int* per_sm) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel,
                                                        threads, smem);
  return err;
}

// The blocks of a persistent grid of `items` items: as many as fit on the
// card at once (blocks_per_sm times the SMs), or one an item where there
// are fewer. A kernel's first launch on a device finds its fit and sets
// its shared memory size; later launches read the fit from a table, so
// they make one host call (cudaGetDevice) for it.
template <typename Kernel>
inline cudaError_t persistent_grid(Kernel kernel, int threads, int smem,
                                   int items, int* grid) {
  struct Fit {
    const void* kernel;
    int dev, blocks;
  };
  static std::mutex mu;
  static std::vector<Fit> fits;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const void* key = reinterpret_cast<const void*>(kernel);
  int fit = 0;
  {
    std::lock_guard<std::mutex> lock(mu);
    for (const Fit& f : fits)
      if (f.kernel == key && f.dev == dev) fit = f.blocks;
  }
  if (fit == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = blocks_per_sm(kernel, threads, smem, &per_sm);
    if (err != cudaSuccess) return err;
    fit = per_sm * sms > 0 ? per_sm * sms : 1;
    std::lock_guard<std::mutex> lock(mu);
    fits.push_back({key, dev, fit});
  }
  *grid = items < fit ? items : fit;
  return cudaSuccess;
}

// Producer: waits for stage `t` to be free; lane 0 starts the two tiles'
// copies; then `fill` starts cp.async copies of the stage's f32 rows (all
// 32 lanes), and every lane arrives on the full barrier when its copies
// land, so the producer never waits for a load.
template <int NB, int NST, typename Fill>
__device__ __forceinline__ void produce(int t, unsigned char* ring,
                                        uint64_t* full, uint64_t* empty,
                                        const CUtensorMap* m0,
                                        const CUtensorMap* m1, int row0,
                                        int h, int b, Fill fill) {
  using Lay = WLayout<NB, 2, NST>;
  const int s = stage_of<NST>(t);
  if (t >= NST) mbar_wait(&empty[s], ((t / NST) - 1) & 1);
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
// m0 and, for OWN = 2, of m1) to `base`, onto `bar`.
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

// Writes a warpgroup's [64, 64 NB] accumulators, row i of this lane times
// mul[i], as bf16 into `tile`: NB 128-byte-swizzled 64 x 64 boxes, the
// layout a TMA store reads (16-byte chunk c of row r at chunk c ^ (r %
// 8); the four lanes of a row write one chunk, and the 8 rows of a warp
// land in distinct banks).
template <int NB>
__device__ __forceinline__ void stage_rows(unsigned char* tile,
                                           const float (&mul)[2],
                                           const float (&acc)[NB][32]) {
  const int tid = threadIdx.x, t4 = tid & 3;
  const int r0 = 16 * (tid >> 5) + ((tid & 31) >> 2);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    unsigned char* row = tile + r * 128 + 4 * t4;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(row + nb * BOX_BYTES +
                                           ((j ^ (r & 7)) << 4)) =
            __floats2bfloat162_rn(acc[nb][4 * j + 2 * i] * mul[i],
                                  acc[nb][4 * j + 2 * i + 1] * mul[i]);
  }
}

// The TMA store of a staged tile (stage_rows): its boxes from row row0 of
// (h, b) of `map`, in one bulk group of the calling thread. The tile may
// be reused once that thread has waited for the group's reads
// (tma_store_wait_read).
template <int NB>
__device__ __forceinline__ void store_boxes(const unsigned char* tile,
                                           const CUtensorMap* map, int row0,
                                           int h, int b) {
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
    tma_store(map, tile + nb * BOX_BYTES, 64 * nb, row0, h, b);
  tma_store_commit();
}

// The consumers' rows of an item out through a TMA store: once every
// consumer is past its last product reading `tile`, staged there as bf16
// (stage_rows) and stored by thread 0 (store_boxes).
template <int NB>
__device__ __forceinline__ void store_tile(unsigned char* tile,
                                          const CUtensorMap* map, int row0,
                                          int h, int b, const float (&mul)[2],
                                          const float (&acc)[NB][32]) {
  named_barrier(1, CONSUMERS);
  stage_rows<NB>(tile, mul, acc);
  fence_proxy_async();
  named_barrier(1, CONSUMERS);
  if (threadIdx.x == 0) store_boxes<NB>(tile, map, row0, h, b);
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

// 2^x in one MUFU op, to 2 ulp (exp2f's bound; its range handling costs
// three more instructions); subnormal results flush to 0.
__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 1 / x to about 1 ulp, branch-free (x = l >= 1 here, or 0 on rows that
// are masked out afterwards).
__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

}  // namespace mmf_flash_sm90
