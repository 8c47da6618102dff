// Flash-attention forward for Hopper (sm_90a): K1, in its inference form,
// its stats form and its raw-stats form.
//
// Replaces the Pallas TPU kernel mmf_tpu/ops/attention.py::_flash_kernel
// (launched from _flash_forward). Same function: softmax(q k^T * scale +
// bias) v with the online softmax over kv tiles in f32, output cast to the
// input dtype; rows whose every column is -inf (nothing to attend to) emit
// zeros instead of NaN. The stats form (the TPU kernel's with_lse=True,
// for the backward in flash_attention_bwd.cu) also writes the row max m
// and the normalizer l, f32 [B, H, Sq], separately and not as m + log l:
// at the -0.7 * f32max mask value log l would be absorbed. A row with
// l == 0 stores m = 0 and l = 1, so exp(s - m) / l is exactly 0 there.
// The raw-stats form (raw_stats=True, the ring attention's block state)
// writes the unnormalized f32 accumulator sum_k exp(s - m) v and the raw
// m and l, none of them parked or divided: a row with no finite score
// gives m = -inf, l = 0, acc = 0, which a merge treats as empty.
//
// What bounds it on the H100: a (b, h) does ~4 S S D FLOPs against ~4 S D
// elements of q/k/v/o, ~S FLOPs an element; at the port's sequences
// (100-228 rows) that is under the ~295 FLOPs a byte where the tensor
// cores would be the limit, so the bound is the bytes. An item of work
// (64 q rows of one (b, h)) is short: two to four 64-row kv tiles, ~1 us
// of products and softmax. So the time goes to latency: an item's loads,
// its chain of products and softmax, and its stores. Measured by taking
// parts out (PERF.md): at D = 128 and at MMFT's 114 rows the
// output's bytes take ~25% of the time and the softmax ~5%; on the main
// path (228 rows, four kv tiles) the softmax ~25%. Design of the bfloat16
// kernel (the ring, layouts and items of flash_attention_sm90.cuh, which
// the backward K2 shares):
//   - a persistent grid: as many blocks as fit on the card, each working
//     through items in turn (item_of). A block is one consumer warpgroup
//     and one producer warp. The producer loads each item's q by TMA into
//     one of two buffers and streams every item's k and v tiles of 64 kv
//     rows through one shared-memory ring, with the tile's padding-mask
//     bias row beside them (cp.async); mbarriers count the bytes. So the
//     next item's loads run during this item's products;
//   - the output leaves through the item's q buffer: the consumers write
//     their rows there as bf16 in the swizzled box layout (stage_rows) and
//     arrive on a barrier; the producer stores the buffer by TMA through
//     the given strides (the [B, S, H, D] layout the next projection reads
//     is written in place; rows past Sq are not written), waits until the
//     store has read it, and loads the q of the item two on into it. The
//     consumers never wait for a store. The raw form's f32 accumulator
//     goes out by plain stores;
//   - blocks an SM, from the head dim alone (bf16_block): registers bound
//     them (five warps a block: two blocks leave 168 registers a thread,
//     three 128). D <= 64: three blocks, a 3-stage ring (~69 KB); D = 128:
//     two blocks, a 2-stage ring (~100 KB; three stages held one block an
//     SM, and a ViLBERT item has at most two kv tiles);
//   - s = q k^T runs on wgmma from shared memory (both K-major); the
//     online softmax stays in the accumulator registers, f32, branch-free:
//     kv columns at or past Skv get p = 0 by a select, on the tile that
//     has them (a zero-filled k row would score 0 + bias, not -inf); the
//     kind of bias (a row, or per element) is a template parameter; exp is
//     one ex2.approx with the subtraction first; the row max is reduced
//     over the 4 lanes of a row every tile, the normalizer only once at
//     the end;
//   - p is rounded to bf16 (as the plain version rounds probabilities to
//     v's dtype) into wgmma's register A operand, and o += p v reads v
//     MN-major from the ring: no transposed copy;
//   - the three forms are one kernel with a template parameter, so the
//     stats form computes the inference form's bits;
//   - float32 (ViLT serves and trains in f32, S = 617) runs
//     flash_fwd_tf32x3_kernel: the products in split-TF32 on mma.sync
//     (flash_attention_tf32.cuh, shared with the f32 K2 and K3), to keep
//     f32 accuracy on the tensor cores. One block per (b, h, 64 q rows) of
//     four warps of 16 rows and no producer warp: thread 0 loads q once by
//     TMA and streams k and v through a 2-stage ring of 128-byte-swizzled
//     32-column f32 boxes, the padding-mask bias row beside them
//     (cp.async). s = q k^T comes out in the wgmma accumulator layout, so
//     online_softmax below is the online softmax of both dtypes; p stays
//     f32 and is the A fragment of p v as it stands (the reduction index
//     permuted), v read in place from the ring; each tile's p v is summed
//     from zero and added to o with one rounding. What bounds it: 3 x 4 B H
//     Sq Skv D FLOPs at the TF32 rate, 0.45 ms at ViLT's [64, 12, 617, 64]
//     (495 TFLOP/s; 1.12 ms for the same work in f32 on the FMA units).
//     Two blocks an SM at D <= 64 (~84 KB of shared memory each), one at
//     D up to 128.
// The bias is read in f32 through its own strides: stride 0 broadcasts a
// [B,1,1,Skv] padding-mask row over heads and q rows without
// materialising [B,H,Sq,Skv]. q/k/v/o are addressed through (batch, head,
// seq) strides with a contiguous head dim (the tensor maps carry them),
// so the [B,S,H,D] -> [B,H,S,D] view of a projection output is
// read in place.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (mmf_tpu_torch/ops/_build.py); plain C entry
//        points loaded with ctypes. TMA descriptors are encoded per call
//        with cuTensorMapEncodeTiled, reached through the runtime's
//        cudaGetDriverEntryPoint, so the library needs no -lcuda.

#include <limits.h>
#include <math.h>

#include "flash_attention_f32_wide.cuh"
#include "flash_attention_tf32.cuh"

namespace {

using namespace mmf_flash_tf32;
constexpr int MAX_D = 128;  // bf16; f32 takes up to mmf_flash_wide::W_MAX_D

struct Strides {
  long long q[3], k[3], v[3], o[3], bias[3];  // (batch, head, seq)
};

// ---------------------------------------------------------------------------
// bfloat16: the warp-specialised wgmma kernel. FORM: 0 inference (out in
// the input dtype), 1 stats (out, parked m and l), 2 raw (f32 accumulator
// out, raw m and l); the f32 kernel below takes the same forms.
// ---------------------------------------------------------------------------
enum { INFERENCE = 0, STATS = 1, RAW = 2 };

struct Maps {
  CUtensorMap q, k, v, o;  // o: the bf16 output (not the raw form's f32)
};

struct Args {
  const float* bias;   // null: no bias
  void* o;             // output in the input dtype, or the f32 raw acc
  float *m, *l;        // [B, H, Sq]; null in the inference form
  int B, H, Sq, Skv, D;
  float scale;
  Strides st;
};

// One kv tile of the online softmax for this lane's rows `i`: the scores
// become p = exp(s - m_new) in place, the running max m moves to m_new,
// this lane's share of the normalizer l is rescaled by alpha = exp(m -
// m_new) and gains the tile's p. Columns past Skv get p = 0, selected
// only where the tile has them (RAGGED); the bias is the tile's row
// (`bias_row`, zeros without a bias) or, with ELEM_BIAS, read per element
// from the rows `brow`. A row with no finite score yet keeps p = 0 (its
// max is taken as 0). EX2: 2^x by ex2_approx (the bf16 kernel), or by
// exp2f (the f32 kernel).
template <bool ELEM_BIAS, bool RAGGED = true, bool EX2 = false>
__device__ __forceinline__ void online_softmax(
    float (&sc)[32], float (&m)[2], float (&l)[2], float (&alpha)[2],
    const float* bias_row, const float* const (&brow)[2], int kv0, int Skv,
    float scale) {
  auto pow2 = [](float x) { return EX2 ? ex2_approx(x) : exp2f(x); };
  const int t4 = threadIdx.x & 3;
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    const int i = (e >> 1) & 1, c = 8 * (e >> 2) + 2 * t4 + (e & 1);
    const float bias =
        ELEM_BIAS ? brow[i][min(kv0 + c, Skv - 1)] : bias_row[c];
    const float x = fmaf(sc[e], scale, bias);
    sc[e] = !RAGGED || kv0 + c < Skv ? x : -INFINITY;
    mx[i] = fmaxf(mx[i], sc[e]);
  }
  float m_use[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float m_new = fmaxf(m[i], max_xor(mx[i], 4));
    m_use[i] = m_new == -INFINITY ? 0.f : m_new;
    alpha[i] = pow2((m[i] - m_use[i]) * LOG2E);
    m[i] = m_new;
    l[i] *= alpha[i];
  }
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    const int i = (e >> 1) & 1;
    sc[e] = pow2((sc[e] - m_use[i]) * LOG2E);
    l[i] += sc[e];
  }
}

// A ring stage's k tile; v follows it (+ Lay::TILE), then the bias row.
template <int NB, int NST>
__device__ __forceinline__ unsigned char* ring_stage(unsigned char* ring,
                                                     int t) {
  return ring + stage_of<NST>(t) * WLayout<NB, 1, NST>::STAGE;
}

// One kv tile (ring tile t, kv rows kv0 on) of the consumer warpgroup, in
// order: s = q k^T, the online softmax, o rescaled, o += p v (p rounded
// to bf16, as the plain version rounds probabilities to v's dtype, into
// wgmma's register A operand; v read MN-major from the ring), and the
// stage handed back.
template <int NB, int ELEM, int NST>
__device__ __forceinline__ void fwd_tile(
    int t, int kv0, const Args& a, unsigned char* ring, uint64_t* full,
    uint64_t* empty, uint32_t q_addr, const float* const (&brow)[2],
    float (&o)[NB][32], float (&m)[2], float (&l)[2]) {
  using Lay = WLayout<NB, 1, NST>;
  unsigned char* stg = ring_stage<NB, NST>(ring, t);
  const uint32_t k_addr = smem_u32(stg), v_addr = k_addr + Lay::TILE;
  const float* bias_row = reinterpret_cast<const float*>(stg + 2 * Lay::TILE);
  mbar_wait(&full[stage_of<NST>(t)], full_parity<NST>(t));
  float sc[32], alpha[2];
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = 0.f;
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < 4 * NB; ++kk)  // s = q k^T over the head dim
    wgmma_ss(sc, kmajor_desc(q_addr, kk), kmajor_desc(k_addr, kk), 1);
  wg_commit();
  wg_wait_all();
  fence_acc(sc);
  const bool ragged = kv0 + 64 > a.Skv;  // the tile has columns past Skv
  if (ragged)
    online_softmax<ELEM != 0, true, true>(sc, m, l, alpha, bias_row, brow,
                                          kv0, a.Skv, a.scale);
  else
    online_softmax<ELEM != 0, false, true>(sc, m, l, alpha, bias_row, brow,
                                           kv0, a.Skv, a.scale);
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int e = 0; e < 32; ++e) o[nb][e] *= alpha[(e >> 1) & 1];
  uint32_t pa[4][4];
  pack_acc(pa, sc);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
      wgmma_rs_mn(o[nb], pa[kk], mnmajor_desc(v_addr + nb * BOX_BYTES, kk));
  wg_commit();
  wg_wait_all();
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) fence_acc(o[nb]);
  mbar_arrive(&empty[stage_of<NST>(t)]);
}

// The bf16 block: one consumer warpgroup (64 q rows at a time) and a
// producer warp; a persistent grid, each block working through items
// (item_of: 64 q rows of one (b, h)) in turn. q has two buffers, and an
// item's output leaves through its q buffer: the consumers stage it there
// and arrive on own_empty; the producer stores it by TMA, waits until the
// store has read it, and loads the q of the item two on into the buffer.
// k and v tiles stream through one ring of NST stages. So the next items'
// loads run during this item's products, and the consumers never wait for
// a store. ELEM: the bias is read per element (a [B|1, H|1, Sq, Skv] bias)
// rather than as the tile's padding-mask row.
template <int NB, int FORM, int ELEM, int NST, int MIN_BLOCKS>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    flash_fwd_sm90_kernel(const __grid_constant__ Maps maps, const Args a) {
  constexpr int QBUF = 2;
  using Lay = WLayout<NB, QBUF, NST, 2 * QBUF>;  // own operands: q buffers
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align_smem(smem_raw);
  unsigned char* ring = base + Lay::RING;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + Lay::BARS);
  uint64_t* empty = full + NST;
  uint64_t* own_full = empty + NST;
  uint64_t* own_empty = own_full + QBUF;

  const Strides& st = a.st;
  const int n_tiles = (a.Skv + 63) / 64;  // >= 1: the entry refuses Skv 0
  const int n_blocks = (a.Sq + ROWS - 1) / ROWS;
  const int items = n_blocks * a.H * a.B;
  init_ring<NST, QBUF>(full, empty, own_full, own_empty);

  // producer warp: each item's q once, and its output out; k, v through
  // the ring
  if (warp_uniform_index() >= CONSUMERS / 32) {
    const int lane = threadIdx.x & 31;
    // a valid global address for the copies that read nothing
    const float* dummy = static_cast<const float*>(a.o);
    // the block's item jj (item ii) has left its output in its q buffer:
    // store it (the raw form's went out by plain stores) and wait until
    // the store has read the buffer
    auto retire = [&](int jj, int ii) {
      mbar_wait(&own_empty[jj % QBUF], (jj / QBUF) & 1);
      if (FORM != RAW) {
        const Item p = item_of(ii, n_blocks, a.H);
        store_boxes<NB>(base + (jj % QBUF) * Lay::TILE, &maps.o, p.row0, p.h,
                        p.b);
        tma_store_wait_read();
      }
    };
    int t = 0, j = 0;  // the ring's tile count, the block's item count
    for (int i = blockIdx.x; i < items; i += gridDim.x, ++j) {
      const Item it = item_of(i, n_blocks, a.H);
      const float* bias_bh =
          a.bias == nullptr ? nullptr
                            : a.bias + it.b * st.bias[0] + it.h * st.bias[1];
      const bool row_bias = !ELEM && bias_bh != nullptr;
      if (lane == 0) {  // q ahead of the item's tiles
        if (j >= QBUF) retire(j - QBUF, i - QBUF * int(gridDim.x));
        load_own<NB, 1>(base + (j % QBUF) * Lay::TILE, &own_full[j % QBUF],
                        &maps.q, nullptr, it.row0, it.h, it.b);
      }
      for (int kv0 = 0; kv0 < a.Skv; kv0 += 64, ++t)
        produce<NB, NST>(t, ring, full, empty, &maps.k, &maps.v, kv0, it.h,
                         it.b, [&](float* rows) {  // the padding-mask row
                           for (int c = lane; c < 64; c += 32) {
                             const bool in = row_bias && kv0 + c < a.Skv;
                             cp_async_4(rows + c,
                                        in ? bias_bh + kv0 + c : dummy, in);
                           }
                         });
    }
    if (lane == 0)  // the last items' outputs
      for (int jj = j < QBUF ? 0 : j - QBUF; jj < j; ++jj)
        retire(jj, int(blockIdx.x + jj * gridDim.x));
    return;
  }

  // consumers: the warpgroup owns q rows row0 .. row0 + 63 of an item
  const int tid = threadIdx.x, g = (tid & 31) >> 2;
  const int r0 = 16 * (tid >> 5) + g;  // this lane's rows: r0, r0 + 8
  int t = 0;  // the ring's tile count
  for (int i = blockIdx.x, j = 0; i < items; i += gridDim.x, ++j) {
    const Item it = item_of(i, n_blocks, a.H);
    const float* bias_bh =
        a.bias == nullptr ? nullptr
                          : a.bias + it.b * st.bias[0] + it.h * st.bias[1];
    const int qrow[2] = {it.row0 + r0, it.row0 + r0 + 8};
    const float* brow[2];  // rows of a per-element bias (clamped to Sq)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      brow[r] = ELEM ? bias_bh + min(qrow[r], a.Sq - 1) * st.bias[2]
                     : nullptr;
    float o[NB][32];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 32; ++e) o[nb][e] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    unsigned char* q_tile = base + (j % QBUF) * Lay::TILE;
    const uint32_t q_addr = smem_u32(q_tile);
    mbar_wait(&own_full[j % QBUF], (j / QBUF) & 1);
    for (int kv = 0; kv < n_tiles; ++kv)
      fwd_tile<NB, ELEM, NST>(t + kv, 64 * kv, a, ring, full, empty, q_addr,
                              brow, o, m, l);
    t += n_tiles;

    // the normalizer: the 4 lanes of a row hold its partial sums
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = sum_xor(l[r], 4);
    const long long so = ((long long)it.b * a.H + it.h) * a.Sq;
    if (FORM == RAW) {
      const float one[2] = {1.f, 1.f};
      store_rows<NB, float>(static_cast<float*>(a.o) + it.b * st.o[0] +
                                it.h * st.o[1],
                            st.o[2], qrow, a.Sq, a.D, one, o);
    } else {
      float inv[2];  // l == 0 (no finite score): zeros
#pragma unroll
      for (int r = 0; r < 2; ++r) inv[r] = l[r] > 0.f ? 1.f / l[r] : 0.f;
      // the output into q's buffer, once every warp is past its scores
      named_barrier(1, CONSUMERS);
      stage_rows<NB>(q_tile, inv, o);
      fence_proxy_async();  // for the producer's TMA store
    }
    mbar_arrive(&own_empty[j % QBUF]);
    if (FORM != INFERENCE && (tid & 3) == 0) {  // the row's 4 lanes agree
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (qrow[r] >= a.Sq) continue;
        const bool parked = FORM == STATS && !(l[r] > 0.f);
        a.m[so + qrow[r]] = parked ? 0.f : m[r];
        a.l[so + qrow[r]] = parked ? 1.f : l[r];
      }
    }
  }
}

// A bf16 instance: the kernel and its dynamic shared memory.
struct Bf16Kernel {
  void (*kernel)(const Maps, const Args);
  int smem;
};

template <int NB, int FORM, int ELEM, int NST, int MIN_BLOCKS>
Bf16Kernel bf16_kernel() {
  return {flash_fwd_sm90_kernel<NB, FORM, ELEM, NST, MIN_BLOCKS>,
          WLayout<NB, 2, NST, 4>::BYTES};  // two q buffers
}

// The block each bf16 shape takes, from its head dim (measured on the
// H100, PERF.md): at D <= 64, three stages and three blocks an SM (the
// registers allow three; ~69 KB of shared memory a block); at D = 128,
// two stages (~100 KB) and two blocks an SM, where three stages held one,
// and one block of two consumer warpgroups sharing each k and v tile was
// slower. A per-element bias (no bf16 main path has one) holds 32 more
// addresses a tile: two blocks an SM at D <= 64 and one at D = 128, where
// more would spill registers.
template <int FORM, int ELEM>
Bf16Kernel bf16_block(int D) {
  return D > 64 ? bf16_kernel<2, FORM, ELEM, 2, ELEM ? 1 : 2>()
                : bf16_kernel<1, FORM, ELEM, 3, ELEM ? 2 : 3>();
}

Bf16Kernel bf16_block(int D, int form, bool elem) {
  switch (form * 2 + elem) {
    case 0: return bf16_block<INFERENCE, 0>(D);
    case 1: return bf16_block<INFERENCE, 1>(D);
    case 2: return bf16_block<STATS, 0>(D);
    case 3: return bf16_block<STATS, 1>(D);
    case 4: return bf16_block<RAW, 0>(D);
    default: return bf16_block<RAW, 1>(D);
  }
}

// Launches a bf16 K1 block as a persistent grid: as many blocks as fit on
// the card at once (blocks an SM times SMs), or one an item if there are
// fewer items.
cudaError_t launch_bf16(const Maps& maps, const Args& a, int form,
                        cudaStream_t stream) {
  const bool elem = a.bias != nullptr && a.st.bias[2] != 0;
  const Bf16Kernel k = bf16_block(a.D, form, elem);
  int grid = 0;
  const cudaError_t err = persistent_grid(
      k.kernel, THREADS, k.smem, (a.Sq + ROWS - 1) / ROWS * a.H * a.B, &grid);
  if (err != cudaSuccess) return err;
  k.kernel<<<grid, THREADS, k.smem, stream>>>(maps, a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// float32: split-TF32 on mma.sync (flash_attention_tf32.cuh), the same
// forms. One block per (b, h, 64 q rows); q own, k and v through the ring
// with the tile's padding-mask row; warp w owns q rows q0 + 16 w + g and
// + 8, in the accumulator layout the bf16 kernel's helpers read.
// ---------------------------------------------------------------------------
template <int NB, int FORM, int MIN_BLOCKS>
__global__ void __launch_bounds__(F_THREADS, MIN_BLOCKS)
    flash_fwd_tf32x3_kernel(const __grid_constant__ Maps maps, const Args a) {
  using Lay = FLayout<NB, 1>;  // one own tile: q
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align_smem(smem_raw);
  unsigned char* ring = base + Lay::RING;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + Lay::BARS);
  uint64_t* own_bar = full + F_STAGES;

  const int q0 = blockIdx.x * ROWS, h = blockIdx.y, b = blockIdx.z;
  const Strides& st = a.st;
  const int n_tiles = (a.Skv + 63) / 64, boxes = (a.D + 31) / 32;
  const float* bias_bh =
      a.bias == nullptr ? nullptr : a.bias + b * st.bias[0] + h * st.bias[1];
  const bool row_bias = bias_bh != nullptr && st.bias[2] == 0;
  const int tid = threadIdx.x, g = (tid & 31) >> 2;
  // a valid global address for the copies that read nothing
  const float* dummy = static_cast<const float*>(a.o);
  auto fill = [&](int kv0) {  // the tile's padding-mask row, or zeros
    return [&, kv0](float* rows) {
      if (tid < 64) {
        const bool in = row_bias && kv0 + tid < a.Skv;
        cp_async_4(rows + tid, in ? bias_bh + kv0 + tid : dummy, in);
      }
    };
  };
  zero_spare_boxes<NB, 1>(base, boxes);
  init_f32_barriers(full, own_bar);
  load_own_f32<NB, 1>(base, own_bar, &maps.q, nullptr, q0, h, b, boxes);
  for (int t = 0; t < F_STAGES - 1 && t < n_tiles; ++t)
    load_stage<NB>(t, ring, full, &maps.k, &maps.v, 64 * t, h, b, boxes,
                   fill(64 * t));

  const int r0 = 16 * (tid >> 5) + g;  // this lane's rows: r0, r0 + 8
  const int qrow[2] = {q0 + r0, q0 + r0 + 8};
  const bool elem_bias = bias_bh != nullptr && !row_bias;
  const float* brow[2];  // rows of a per-element bias (clamped to Sq)
#pragma unroll
  for (int i = 0; i < 2; ++i)
    brow[i] = elem_bias ? bias_bh + min(qrow[i], a.Sq - 1) * st.bias[2]
                        : nullptr;
  float o[NB][32];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int e = 0; e < 32; ++e) o[nb][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const FragOffsets frag;
  mbar_wait(own_bar, 0);
  // the q tile from this warp's 16 rows on
  const float* q_t = reinterpret_cast<const float*>(base) + 512 * (tid >> 5);

  for (int t = 0; t < n_tiles; ++t) {
    const int kv0 = 64 * t, ahead = 64 * (t + F_STAGES - 1);
    next_stage<NB>(t, n_tiles, ring, full, &maps.k, &maps.v, h, b, boxes,
                   fill(ahead));
    const unsigned char* stg = ring + (t % F_STAGES) * Lay::STAGE;
    const float* k_t = reinterpret_cast<const float*>(stg);
    const float* v_t = reinterpret_cast<const float*>(stg + Lay::TILE);
    const float* bias_row =
        reinterpret_cast<const float*>(stg + 2 * Lay::TILE);
    float sc[32], alpha[2];
    score_products<NB, 1>(sc, sc, q_t, k_t, q_t, k_t, frag);  // s = q k^T
    if (elem_bias)
      online_softmax<true>(sc, m, l, alpha, bias_row, brow, kv0, a.Skv,
                           a.scale);
    else
      online_softmax<false>(sc, m, l, alpha, bias_row, brow, kv0, a.Skv,
                            a.scale);
    // o = alpha o + p v. The tensor cores truncate their f32 sum at each
    // chained product, so the tile's p v is summed from zero (24 chained
    // products for each 64 head-dim columns) and added to o with one
    // rounding: carried through every tile's products (234 at 617 kv), o
    // drifted to ~1e-5, the f32 output bound's size.
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      float pv[1][32];
#pragma unroll
      for (int e = 0; e < 32; ++e) pv[0][e] = 0.f;
      const float* v_nb = v_t + 4096 * nb;  // head-dim columns 64 nb on
      acc_products<1, 1>(pv, sc, v_nb, pv, sc, v_nb, frag);
#pragma unroll
      for (int e = 0; e < 32; ++e)
        o[nb][e] = fmaf(o[nb][e], alpha[(e >> 1) & 1], pv[0][e]);
    }
  }

  // the normalizer: the 4 lanes of a row hold its partial sums
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = sum_xor(l[i], 4);
  float mul[2] = {1.f, 1.f};  // raw form: the unnormalized accumulator
  if (FORM != RAW)  // l == 0 (no finite score): zeros
#pragma unroll
    for (int i = 0; i < 2; ++i) mul[i] = l[i] > 0.f ? 1.f / l[i] : 0.f;
  store_rows<NB, float>(static_cast<float*>(a.o) + b * st.o[0] + h * st.o[1],
                        st.o[2], qrow, a.Sq, a.D, mul, o);
  const long long so = ((long long)b * a.H + h) * a.Sq;
  if (FORM != INFERENCE && (tid & 3) == 0) {  // the 4 lanes of a row agree
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (qrow[i] >= a.Sq) continue;
      const bool parked = FORM == STATS && !(l[i] > 0.f);
      a.m[so + qrow[i]] = parked ? 0.f : m[i];
      a.l[so + qrow[i]] = parked ? 1.f : l[i];
    }
  }
}

// Sets the f32 kernel's shared-memory size, then encodes the q, k, v maps
// (that call makes the device's primary context current in the calling
// thread, which encoding a tensor map needs) and launches. Two blocks an
// SM at D <= 64 (8 warps: up to 255 registers a thread), one above.
template <int NB, int FORM>
cudaError_t launch_f32_nb(const void* q, const void* k, const void* v,
                          const Args& a, int B, cudaStream_t stream) {
  auto kernel = flash_fwd_tf32x3_kernel<NB, FORM, NB == 1 ? 2 : 1>;
  const int smem = FLayout<NB, 1>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  Maps maps;
  if (!make_tile_map(&maps.q, q, a.D, a.Sq, a.H, B, a.st.q, true) ||
      !make_tile_map(&maps.k, k, a.D, a.Skv, a.H, B, a.st.k, true) ||
      !make_tile_map(&maps.v, v, a.D, a.Skv, a.H, B, a.st.v, true))
    return cudaErrorInvalidValue;
  dim3 grid((a.Sq + ROWS - 1) / ROWS, a.H, B);
  kernel<<<grid, F_THREADS, smem, stream>>>(maps, a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// float32 at head dims 136-256: FP32 FMA code for few query rows
// (flash_attention_f32_wide.cuh says why), the inference and stats forms.
// One block per (b, h, 16 q rows); q own, k and v through a 2-stage ring
// of 32-row tiles.
// ---------------------------------------------------------------------------
namespace wide = mmf_flash_wide;

struct WideFwdLayout {
  int q, ring, stage, s, pt, stats, bytes;  // float offsets; bytes
  __host__ __device__ explicit WideFwdLayout(int D) {
    q = 0;
    stage = 2 * wide::W_KT * D;  // k then v
    ring = q + wide::W_QR * D;
    s = ring + 2 * stage;
    pt = s + wide::W_QR * wide::W_KT;
    stats = pt + wide::W_KT * wide::W_PT;  // alpha, m, l of the 16 rows
    bytes = 4 * (stats + 3 * wide::W_QR);
  }
};

template <int FORM>
__global__ void __launch_bounds__(wide::W_THREADS, 1)
    flash_fwd_f32_wide_kernel(const float* __restrict__ q,
                              const float* __restrict__ k,
                              const float* __restrict__ v, const Args a) {
  using namespace mmf_flash_wide;
  extern __shared__ float4 smem_f4[];
  float* sm = reinterpret_cast<float*>(smem_f4);
  const int D = a.D;
  const WideFwdLayout lay(D);
  float* q_s = sm + lay.q;
  float* s_s = sm + lay.s;    // [16][32] the tile's scores
  float* p_t = sm + lay.pt;   // [32][W_PT] its probabilities, transposed
  float* alpha_s = sm + lay.stats;
  float* m_s = alpha_s + W_QR;
  float* l_s = m_s + W_QR;

  const int q0 = blockIdx.x * W_QR, h = blockIdx.y, b = blockIdx.z;
  const Strides& st = a.st;
  const int nr = min(W_QR, a.Sq - q0);
  const int n_tiles = (a.Skv + W_KT - 1) / W_KT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* qb = q + b * st.q[0] + h * st.q[1];
  const float* kb = k + b * st.k[0] + h * st.k[1];
  const float* vb = v + b * st.v[0] + h * st.v[1];
  const float* bias_bh =
      a.bias == nullptr ? nullptr : a.bias + b * st.bias[0] + h * st.bias[1];

  auto load_tile = [&](int t) {
    float* stg = sm + lay.ring + (t & 1) * lay.stage;
    load_rows(stg, kb, st.k[2], W_KT * t, W_KT, a.Skv, D);
    load_rows(stg + W_KT * D, vb, st.v[2], W_KT * t, W_KT, a.Skv, D);
  };
  load_rows(q_s, qb, st.q[2], q0, W_QR, a.Sq, D);
  load_tile(0);
  cp_async_commit();
  if (n_tiles > 1) load_tile(1);
  cp_async_commit();

  float o[W_QR];
#pragma unroll
  for (int r = 0; r < W_QR; ++r) o[r] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // rows warp, + 8

  for (int t = 0; t < n_tiles; ++t) {
    const int kv0 = W_KT * t;
    const float* k_t = sm + lay.ring + (t & 1) * lay.stage;
    const float* v_t = k_t + W_KT * D;
    cp_async_wait_one();
    __syncthreads();
    // s = q k^T * scale + bias for the block's rows; past Skv: -inf
    {
      float4 kr[4][2];
#pragma unroll
      for (int u = 0; u < 4; ++u) load_chunks(kr[u], k_t + tile_row(u) * D, D);
      for (int r = 0; r < nr; ++r) {
        float4 qr[2];
        load_chunks(qr, q_s + r * D, D);
        float x[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) x[u] = dot_chunks(qr, kr[u]);
        warp_sum4(x);
        if (lane < 4) {
          const int j = tile_row(lane), kv = kv0 + j;
          float sc = -INFINITY;
          if (kv < a.Skv)
            sc = fmaf(pick4(x, lane), a.scale,
                      bias_bh == nullptr
                          ? 0.f
                          : bias_bh[(long long)(q0 + r) * st.bias[2] + kv]);
          s_s[r * W_KT + j] = sc;
        }
      }
    }
    __syncthreads();
    // the online softmax: warp w takes rows w and w + 8, lane j column j
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = warp + W_WARPS * i;
      const float sc = r < nr ? s_s[r * W_KT + lane] : -INFINITY;
      const float m_new = fmaxf(m[i], max_xor(sc, 32));
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = exp2f((m[i] - m_use) * W_LOG2E);
      const float p = exp2f((sc - m_use) * W_LOG2E);
      l[i] = fmaf(l[i], alpha, sum_xor(p, 32));
      m[i] = m_new;
      p_t[lane * W_PT + r] = p;
      if (lane == 0) alpha_s[r] = alpha;
    }
    __syncthreads();
    // o = alpha o + p v: thread d, head-dim column d
    if (tid < D) {
      float pv[W_QR];
#pragma unroll
      for (int r = 0; r < W_QR; ++r) pv[r] = 0.f;
      const int nk = min(W_KT, a.Skv - kv0);
      for (int j = 0; j < nk; ++j) {
        const float vj = v_t[j * D + tid];
        const float4* pj = reinterpret_cast<const float4*>(p_t + j * W_PT);
#pragma unroll
        for (int c = 0; c < W_QR / 4; ++c) {
          const float4 p4 = pj[c];
          pv[4 * c] = fmaf(p4.x, vj, pv[4 * c]);
          pv[4 * c + 1] = fmaf(p4.y, vj, pv[4 * c + 1]);
          pv[4 * c + 2] = fmaf(p4.z, vj, pv[4 * c + 2]);
          pv[4 * c + 3] = fmaf(p4.w, vj, pv[4 * c + 3]);
        }
      }
#pragma unroll
      for (int r = 0; r < W_QR; ++r) o[r] = fmaf(o[r], alpha_s[r], pv[r]);
    }
    __syncthreads();  // the stage and p are free
    if (t + 2 < n_tiles) load_tile(t + 2);
    cp_async_commit();
  }

  if (lane == 0)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m_s[warp + W_WARPS * i] = m[i];
      l_s[warp + W_WARPS * i] = l[i];
    }
  __syncthreads();
  if (tid < D) {
    float* ob = static_cast<float*>(a.o) + b * st.o[0] + h * st.o[1];
#pragma unroll
    for (int r = 0; r < W_QR; ++r)
      if (r < nr)  // l == 0 (no finite score): zeros
        ob[(long long)(q0 + r) * st.o[2] + tid] =
            l_s[r] > 0.f ? o[r] / l_s[r] : 0.f;
  }
  if (FORM == STATS && tid < nr) {
    const long long so = ((long long)b * a.H + h) * a.Sq + q0 + tid;
    const bool parked = !(l_s[tid] > 0.f);
    a.m[so] = parked ? 0.f : m_s[tid];
    a.l[so] = parked ? 1.f : l_s[tid];
  }
}

// Sets the wide kernel's shared-memory size and launches a block per
// (16 q rows, h, b).
template <int FORM>
cudaError_t launch_f32_wide(const void* q, const void* k, const void* v,
                            const Args& a, int B, cudaStream_t stream) {
  auto kernel = flash_fwd_f32_wide_kernel<FORM>;
  const int smem = WideFwdLayout(a.D).bytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.Sq + wide::W_QR - 1) / wide::W_QR, a.H, B);
  kernel<<<grid, wide::W_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), a);
  return cudaGetLastError();
}

template <int FORM>
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       const Args& a, int B, cudaStream_t s) {
  if (a.D > MAX_D) return launch_f32_wide<FORM>(q, k, v, a, B, s);
  return a.D > 64 ? launch_f32_nb<2, FORM>(q, k, v, a, B, s)
                  : launch_f32_nb<1, FORM>(q, k, v, a, B, s);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o share it); bias is
// float32 or null. strides: 15 element strides, (batch, head, seq) for
// q, k, v, o and bias in that order; the head dim is contiguous in all.
// m_out / l_out: both null (inference form) or both contiguous float32
// [B, H, Sq] (stats form).
// q/k/v (and, in bf16, o: a TMA store writes it) need 16-byte aligned
// pointers and strides that are multiples of 16 bytes, positive on every
// dim longer than 1 (the TMA maps carry them).
// Launches on `stream`, allocates nothing, returns cudaGetLastError() (or
// cudaErrorInvalidValue / cudaErrorMisalignedAddress for arguments the
// kernels do not take).
static int forward(const void* q, const void* k, const void* v,
                   const void* bias, void* o, float* m_out, float* l_out,
                   int dtype, int B, int H, int Sq, int Skv, int D,
                   const long long* strides, float scale, bool raw,
                   void* stream) {
  // (Skv 0 leaves no kv tile to map; the bf16 kernels' items must count
  // in an int)
  // f32 takes head dims up to 256 (the wide kernel above 128, not in the
  // raw form); bf16 up to 128
  const int max_d = dtype == 0 && !raw ? mmf_flash_wide::W_MAX_D : MAX_D;
  if ((m_out == nullptr) != (l_out == nullptr) || (raw && m_out == nullptr) ||
      D <= 0 || D > max_d || D % 8 != 0 || B > 65535 || H > 65535 ||
      Skv <= 0 || (Sq + 63LL) / 64 * H * B > INT_MAX ||
      (dtype != 0 && dtype != 1))
    return int(cudaErrorInvalidValue);
  if (B == 0 || H == 0 || Sq == 0) return 0;
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.q[i] = strides[i];
    st.k[i] = strides[3 + i];
    st.v[i] = strides[6 + i];
    st.o[i] = strides[9 + i];
    st.bias[i] = strides[12 + i];
  }
  const int eb = dtype == 1 ? 2 : 4;
  if (!aligned16(q, st.q, eb) || !aligned16(k, st.k, eb) ||
      !aligned16(v, st.v, eb))
    return int(cudaErrorMisalignedAddress);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Args a{};
  a.bias = static_cast<const float*>(bias), a.o = o;
  a.m = m_out, a.l = l_out;
  a.B = B, a.H = H, a.Sq = Sq, a.Skv = Skv, a.D = D, a.scale = scale;
  a.st = st;
  if (dtype == 0) {
    if (raw) return int(launch_f32<RAW>(q, k, v, a, B, s));
    return int(m_out == nullptr ? launch_f32<INFERENCE>(q, k, v, a, B, s)
                                : launch_f32<STATS>(q, k, v, a, B, s));
  }
  if (!raw && !aligned16(o, st.o, eb)) return int(cudaErrorMisalignedAddress);
  Maps maps;
  if (!make_tile_map(&maps.q, q, D, Sq, H, B, st.q) ||
      !make_tile_map(&maps.k, k, D, Skv, H, B, st.k) ||
      !make_tile_map(&maps.v, v, D, Skv, H, B, st.v) ||
      (!raw && !make_tile_map(&maps.o, o, D, Sq, H, B, st.o)))
    return int(cudaErrorInvalidValue);
  const int form = raw ? RAW : m_out == nullptr ? INFERENCE : STATS;
  return int(launch_bf16(maps, a, form, s));
}

int mmf_flash_attention_fwd(const void* q, const void* k, const void* v,
                            const void* bias, void* o, float* m_out,
                            float* l_out, int dtype, int B, int H, int Sq,
                            int Skv, int D, const long long* strides,
                            float scale, void* stream) {
  return forward(q, k, v, bias, o, m_out, l_out, dtype, B, H, Sq, Skv, D,
                 strides, scale, false, stream);
}

// The raw-stats form (the TPU kernel's raw_stats=True, the ring's block
// state): acc, float32 with the strides given for o, is the unnormalized
// sum_k exp(s - m) v; m_out and l_out (required) the raw row max and
// normalizer. A row with no finite score gives m = -inf, l = 0, acc = 0.
int mmf_flash_attention_fwd_raw(const void* q, const void* k, const void* v,
                                const void* bias, float* acc, float* m_out,
                                float* l_out, int dtype, int B, int H,
                                int Sq, int Skv, int D,
                                const long long* strides, float scale,
                                void* stream) {
  return forward(q, k, v, bias, acc, m_out, l_out, dtype, B, H, Sq, Skv, D,
                 strides, scale, true, stream);
}

// Dynamic shared memory of a K1 block at head dim D, bf16 (dtype 1) or
// f32 (0), for reports.
int mmf_flash_attention_fwd_smem_bytes(int D, int dtype) {
  if (dtype == 0 && D > MAX_D) return WideFwdLayout(D).bytes;
  if (dtype == 0) return D <= 64 ? FLayout<1, 1>::BYTES : FLayout<2, 1>::BYTES;
  return bf16_block(D, INFERENCE, false).smem;
}

// Blocks an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor) of the bf16
// K1 block the launcher takes at head dim D, in `form` (0 inference, 1
// stats, 2 raw) with a per-element bias (`elem`) or not; its dynamic
// shared memory in *smem. For reports; a negative cudaError_t on failure.
int mmf_flash_attention_fwd_occupancy(int D, int form, int elem, int* smem) {
  if (D <= 0 || D > MAX_D || form < 0 || form > 2) return -1;
  const Bf16Kernel k = bf16_block(D, form, elem != 0);
  int blocks = 0;
  const cudaError_t err = blocks_per_sm(k.kernel, THREADS, k.smem, &blocks);
  *smem = k.smem;
  return err == cudaSuccess ? blocks : -int(err);
}

const char* mmf_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
