// Flash-attention backward for Hopper (sm_90a): K2 (dq) and K3 (dk, dv).
//
// Replace the Pallas TPU kernels mmf_tpu/ops/attention.py::
// _flash_bwd_dq_kernel and _flash_bwd_dkv_kernel (launched from
// _flash_backward). Same function: the [Sq, Skv] probabilities are rebuilt
// one tile at a time from the forward's saved row max m and normalizer l
// (flash_attention_fwd.cu, stats form), never stored:
//   s  = q k^T * scale + bias             (f32, as the forward computed it)
//   p  = exp(s - m) / l
//   ds = p * (dO v^T - delta),  delta = rowsum(dO * O)
//   K2: dq = scale * ds k                 (one block per q tile, kv loop)
//   K3: dv = p^T dO, dk = scale * ds^T q  (one block per kv tile, q loop)
// Accumulation is f32; outputs are written in the input dtype. The bias is
// a mask: it gets no gradient (the JAX backward returns zeros for it).
//
// delta is folded into K2's prologue: each K2 item reads its q rows of dO
// and O once, keeps delta in shared memory and writes it to a float32
// [B, H, Sq] buffer that K3, launched after K2 on the same stream, reads.
//
// What bounds them on the H100: K2 does 3 and K3 4 products of ~2 S S D
// FLOPs per (b, h) against ~6 S D elements read, a few hundred FLOPs a
// byte at the port's sequences (100-228 rows): below the line where the
// tensor cores would be the limit, so the bound is the bytes. An item of
// work (64 rows of one (b, h)) is short: two to four 64-row tiles. So the
// time goes to latency: an item's loads, its chain of products and
// elementwise math, and its stores, and how many items overlap on an SM.
// Design of the bfloat16 kernels (warp-specialised; the ring, items and
// stores of flash_attention_sm90.cuh):
//   - K2: a persistent grid (K1's design, flash_attention_fwd.cu): as
//     many blocks as fit, each working through items of 64 q rows of one
//     (b, h). A block is one consumer warpgroup and one producer warp. The
//     producer loads an item's q and dO by TMA (one buffer: 32 KB at
//     D = 128) as soon as the last item's dq has left through q's tile
//     (handing them back earlier, after the last s and dp, measured the
//     same), and streams every item's k and v tiles of 64 kv rows
//     through one shared-memory ring, with the tile's padding-mask bias
//     row beside them (cp.async); mbarriers count the bytes. s = q k^T
//     and dp = dO v^T run on wgmma from shared memory (K-major); ds =
//     p (dp - delta) is formed in the accumulator registers, rounded to
//     bf16 and fed back as wgmma's register A operand for dq += ds k,
//     with k read through an MN-major descriptor: no transposed copy.
//     delta is the item's prologue (16-byte loads of dO and O, all in
//     flight together; the next item's rows are prefetched into L2, ~9%
//     faster), written for K3. dq goes out by one TMA store from q's
//     tile. Blocks an SM (dq_block): three
//     at D <= 64 with a 3-stage ring; two at D = 128 with a 2-stage ring
//     (~100 KB; three stages held one block, ~1.3x slower at ViLBERT's
//     shapes). Issuing tile t's s and dp behind tile t - 1's dq += ds k
//     was slower (PERF.md): its registers spilled at 168.
//   - K3: one block per (b, h, 64 kv rows): k and v loaded once; q and dO
//     tiles of 64 q rows stream through the ring with their m, l and
//     delta rows (cp.async). s^T = k q^T and dp^T = v dO^T on wgmma; p^T
//     and ds^T stay in registers as the A operands of dv += p^T dO and
//     dk += ds^T q, with q and dO read MN-major.
//   - The elementwise math is branch-free and the wgmma paths are
//     provably non-divergent (ptxas otherwise serialises the products).
//     K3 runs two blocks an SM at D <= 64 (its five accumulators) and one
//     at D = 128.
//   - The head dim is zero-padded to 64-column boxes (TMA fills rows and
//     columns outside the tensor with zeros); padded kv columns get p = 0
//     and padded rows are never stored. No atomics: every output element
//     is written by one block, so two runs give the same bits.
//   - float32: the same blocks and ring, with the products in split-TF32
//     on mma.sync (flash_attention_tf32.cuh says why not wgmma).
//   - The bias is read in f32 through its strides (0 on broadcast dims): a
//     [B,1,1,Skv] padding-mask row once per tile (K2) or block (K3), any
//     other bias per element. q, k, v, O, dO and the three gradients are
//     addressed through (batch, head, seq) strides, so [B, S, H, D]
//     projection views are read and written in place (the tensor maps
//     carry the strides).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (mmf_tpu_torch/ops/_build.py); plain C entry
//        points loaded with ctypes. TMA descriptors are encoded per call
//        with cuTensorMapEncodeTiled, reached through the runtime's
//        cudaGetDriverEntryPoint, so the library needs no -lcuda.

#include <limits.h>
#include <math.h>

#include "flash_attention_tf32.cuh"

namespace {

using namespace mmf_flash_tf32;

constexpr int MAX_D = 128;

struct Strides {
  // (batch, head, seq) element strides; the head dim is contiguous
  long long q[3], k[3], v[3], o[3], dout[3], dq[3], dk[3], dv[3], bias[3];
};

struct Args {
  const void *q, *k, *v, *o, *dout;
  const float* bias;   // null: no bias
  const float *m, *l;  // [B, H, Sq] from the forward's stats form
  float* delta;        // [B, H, Sq]: written by K2, read by K3
  void *dq, *dk, *dv;
  int B, H, Sq, Skv, D;
  float scale;
  Strides st;
};

// ---------------------------------------------------------------------------
// bfloat16: warp-specialised wgmma kernels (the block, ring and layouts of
// flash_attention_sm90.cuh, shared with the forward K1).
// ---------------------------------------------------------------------------
struct Maps {
  CUtensorMap q, k, v, dout, dq;  // dq: the bf16 K2's output
};

// s (+)= A B^T and dp (+)= C E^T over the head dim, all four K-major tiles
// (the block's own rows times a ring tile).
template <int NB>
__device__ __forceinline__ void two_score_products(float (&s)[32],
                                                   float (&dp)[32],
                                                   uint32_t a, uint32_t bt,
                                                   uint32_t c, uint32_t et) {
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < 4 * NB; ++kk)
    wgmma_ss(s, kmajor_desc(a, kk), kmajor_desc(bt, kk), 1);
#pragma unroll
  for (int kk = 0; kk < 4 * NB; ++kk)
    wgmma_ss(dp, kmajor_desc(c, kk), kmajor_desc(et, kk), 1);
  wg_commit();
  wg_wait_all();
  fence_acc(s);
  fence_acc(dp);
}

// K2: ds = p (dp - delta) in place of the scores, p = exp(s - m) / l, for
// the rows `i` of this lane; columns past Skv get p = 0. The bias is the
// tile's row (`bias_row`, zeros without a bias) or, with ELEM_BIAS, read
// per element from the rows `brow`.
template <bool ELEM_BIAS>
__device__ __forceinline__ void dq_tile_ds(
    float (&sc)[32], const float (&dp)[32], const float* bias_row,
    const float* const (&brow)[2], int kv0, int Skv, float scale,
    const float (&mr)[2], const float (&lir)[2], const float (&dr)[2]) {
  const int t4 = threadIdx.x & 3;
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    const int i = (e >> 1) & 1, c = 8 * (e >> 2) + 2 * t4 + (e & 1);
    const float bias =
        ELEM_BIAS ? brow[i][min(kv0 + c, Skv - 1)] : bias_row[c];
    const float p =
        exp2f((fmaf(sc[e], scale, bias) - mr[i]) * LOG2E) * lir[i];
    sc[e] = (kv0 + c < Skv ? p : 0.f) * (dp[e] - dr[i]);
  }
}

// K3: p^T in place of s^T and ds^T in place of dp^T for this lane's kv
// rows; `rows` holds the q tile's m, l and delta; p = 0 outside either
// sequence. The bias is the kv rows' padding-mask value `bk` (zeros
// without a bias) or, with ELEM_BIAS, read per element.
template <bool ELEM_BIAS>
__device__ __forceinline__ void dkv_tile_p_ds(
    float (&sc)[32], float (&dp)[32], const float* rows, const float (&bk)[2],
    const float* bias_bh, long long bias_ld, const int (&kvrow)[2], int q0,
    int Sq, int Skv, float scale) {
  const int t4 = threadIdx.x & 3;
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    const int i = (e >> 1) & 1, c = 8 * (e >> 2) + 2 * t4 + (e & 1);
    const bool in = q0 + c < Sq && kvrow[i] < Skv;
    const float bias =
        ELEM_BIAS ? bias_bh[min(q0 + c, Sq - 1) * bias_ld +
                            min(kvrow[i], Skv - 1)]
                  : bk[i];
    const float pe = exp2f((fmaf(sc[e], scale, bias) - rows[c]) * LOG2E) *
                     rcp_approx(rows[64 + c]);
    const float p = in ? pe : 0.f;
    sc[e] = p;
    dp[e] = p * (dp[e] - rows[128 + c]);
  }
}

// K2's ring stage of tile t: k, then v (+ TILE), then the bias row.
template <int NB, int NST>
__device__ __forceinline__ unsigned char* dq_stage(unsigned char* ring,
                                                   int t) {
  return ring + stage_of<NST>(t) * WLayout<NB, 2, NST>::STAGE;
}

// One kv tile (ring tile t, kv rows kv0 on) of K2's consumer warpgroup: s
// = q k^T and dp = dO v^T, ds = p (dp - delta) rounded to bf16 as the
// register A operand of dq += ds k (k read MN-major from the ring), each
// product waited for; then the stage is handed back.
template <int NB, int ELEM, int NST>
__device__ __forceinline__ void dq_tile(
    int t, int kv0, const Args& a, unsigned char* ring, uint64_t* full,
    uint64_t* empty, uint32_t q_addr, uint32_t do_addr,
    const float* const (&brow)[2], const float (&mr)[2],
    const float (&lir)[2], const float (&dr)[2], float (&dq)[NB][32]) {
  using Lay = WLayout<NB, 2, NST, 2>;
  unsigned char* stg = dq_stage<NB, NST>(ring, t);
  const uint32_t k_addr = smem_u32(stg), v_addr = k_addr + Lay::TILE;
  mbar_wait(&full[stage_of<NST>(t)], full_parity<NST>(t));
  float sc[32], dp[32];
  two_score_products<NB>(sc, dp, q_addr, k_addr, do_addr, v_addr);
  dq_tile_ds<ELEM != 0>(sc, dp,
                        reinterpret_cast<const float*>(stg + 2 * Lay::TILE),
                        brow, kv0, a.Skv, a.scale, mr, lir, dr);
  uint32_t da[4][4];
  pack_acc(da, sc);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
      wgmma_rs_mn(dq[nb], da[kk], mnmajor_desc(k_addr + nb * BOX_BYTES, kk));
  wg_commit();
  wg_wait_all();
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) fence_acc(dq[nb]);
  mbar_arrive(&empty[stage_of<NST>(t)]);
}

// K2's bf16 block: one consumer warpgroup (64 q rows at a time) and a
// producer warp; a persistent grid over items (item_of), as K1's
// (flash_attention_fwd.cu): the producer loads an item's q and dO (one
// buffer: 32 KB at D = 128) once the last item's dq has left through q's
// tile, and streams every item's k and v through one ring of NST stages.
// ELEM as K1's.
template <int NB, int ELEM, int NST, int MIN_BLOCKS>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    bwd_dq_sm90_kernel(const __grid_constant__ Maps maps, const Args a) {
  using Lay = WLayout<NB, 2, NST, 2>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align_smem(smem_raw);
  unsigned char* ring = base + Lay::RING;
  float* m_s = reinterpret_cast<float*>(base + Lay::STATS);
  float* li_s = m_s + ROWS;
  float* dl_s = li_s + ROWS;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + Lay::BARS);
  uint64_t* empty = full + NST;
  uint64_t* own_full = empty + NST;
  uint64_t* own_empty = own_full + 1;

  const Strides& st = a.st;
  const int n_tiles = (a.Skv + 63) / 64;  // >= 1: the entry refuses Skv 0
  const int n_blocks = (a.Sq + ROWS - 1) / ROWS;
  const int items = n_blocks * a.H * a.B;
  init_ring<NST>(full, empty, own_full, own_empty);

  // producer warp: each item's q and dO once; k, v through the ring
  if (warp_uniform_index() >= CONSUMERS / 32) {
    const int lane = threadIdx.x & 31;
    int t = 0;  // the ring's tile count
    for (int i = blockIdx.x, j = 0; i < items; i += gridDim.x, ++j) {
      const Item it = item_of(i, n_blocks, a.H);
      const float* bias_bh =
          a.bias == nullptr ? nullptr
                            : a.bias + it.b * st.bias[0] + it.h * st.bias[1];
      const bool row_bias = !ELEM && bias_bh != nullptr;
      if (lane == 1) {  // lane 0 goes on to the item's tiles meanwhile
        if (j > 0) mbar_wait(own_empty, (j - 1) & 1);
        load_own<NB>(base, own_full, &maps.q, &maps.dout, it.row0, it.h,
                     it.b);
      }
      for (int kv0 = 0; kv0 < a.Skv; kv0 += 64, ++t)
        produce<NB, NST>(t, ring, full, empty, &maps.k, &maps.v, kv0, it.h,
                         it.b, [&](float* rows) {  // the padding-mask row
                           for (int c = lane; c < 64; c += 32) {
                             const bool in = row_bias && kv0 + c < a.Skv;
                             cp_async_4(rows + c,
                                        in ? bias_bh + kv0 + c : a.m, in);
                           }
                         });
    }
    return;
  }

  // consumers: the warpgroup owns q rows row0 .. row0 + 63 of an item
  const int tid = threadIdx.x, g = (tid & 31) >> 2;
  const int r0 = 16 * (tid >> 5) + g;  // this lane's rows: r0, r0 + 8
  const uint32_t q_addr = smem_u32(base), do_addr = q_addr + Lay::TILE;
  int t = 0;  // the ring's tile count
  for (int i = blockIdx.x, j = 0; i < items; i += gridDim.x, ++j) {
    const Item it = item_of(i, n_blocks, a.H);
    const float* bias_bh =
        a.bias == nullptr ? nullptr
                          : a.bias + it.b * st.bias[0] + it.h * st.bias[1];
    const long long so = ((long long)it.b * a.H + it.h) * a.Sq;
    const bf16* ob =
        static_cast<const bf16*>(a.o) + it.b * st.o[0] + it.h * st.o[1];
    const bf16* dob = static_cast<const bf16*>(a.dout) + it.b * st.dout[0] +
                      it.h * st.dout[1];
    named_barrier(1, CONSUMERS);  // the last item's rows have been read
    {
      // delta = rowsum(dO * O), f32, 8 threads a row, 16-byte loads; with
      // m and 1 / l, for the item's rows (all loads of the four passes
      // are independent: unrolled, they are in flight together)
      const int part = tid & 7;
      float acc[4], mv[4], lv[4];
#pragma unroll
      for (int pass = 0; pass < 4; ++pass) {
        const int s = it.row0 + 16 * pass + (tid >> 3);
        const bool in = s < a.Sq;
        acc[pass] = 0.f;
        mv[pass] = 0.f;
        lv[pass] = 1.f;
        if (in && part == 0) {
          mv[pass] = a.m[so + s];
          lv[pass] = a.l[so + s];
        }
#pragma unroll
        for (int c = 0; c < NB; ++c) {
          const int c8 = 8 * part + 64 * c;
          if (!in || c8 >= a.D) continue;
          const uint4 x =
              *reinterpret_cast<const uint4*>(dob + s * st.dout[2] + c8);
          const uint4 y =
              *reinterpret_cast<const uint4*>(ob + s * st.o[2] + c8);
          const __nv_bfloat162* xp =
              reinterpret_cast<const __nv_bfloat162*>(&x);
          const __nv_bfloat162* yp =
              reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 xf = __bfloat1622float2(xp[e]);
            const float2 yf = __bfloat1622float2(yp[e]);
            acc[pass] = fmaf(xf.x, yf.x, acc[pass]);
            acc[pass] = fmaf(xf.y, yf.y, acc[pass]);
          }
        }
      }
#pragma unroll
      for (int pass = 0; pass < 4; ++pass) {
        const int r = 16 * pass + (tid >> 3), s = it.row0 + r;
        const bool in = s < a.Sq;
        const float d = sum_xor(acc[pass], 8);
        if (part == 0) {
          dl_s[r] = in ? d : 0.f;
          m_s[r] = mv[pass];
          li_s[r] = 1.f / lv[pass];
          if (in) a.delta[so + s] = d;
        }
      }
      named_barrier(1, CONSUMERS);
    }
    const int qrow[2] = {it.row0 + r0, it.row0 + r0 + 8};
    float mr[2], lir[2], dr[2];
    const float* brow[2];  // rows of a per-element bias (clamped to Sq)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mr[r] = m_s[r0 + 8 * r];
      lir[r] = li_s[r0 + 8 * r];
      dr[r] = dl_s[r0 + 8 * r];
      brow[r] = ELEM ? bias_bh + min(qrow[r], a.Sq - 1) * st.bias[2]
                     : nullptr;
    }
    // the next item's O and dO rows on their way to L2 (the TMA brings
    // its dO to shared memory; the prologue above reads both again)
    if (i + int(gridDim.x) < items) {
      const Item nx = item_of(i + gridDim.x, n_blocks, a.H);
      const int row = nx.row0 + (tid >> 1), off = 64 * (tid & 1);
      if (row < a.Sq && off < a.D) {
        prefetch_l2(static_cast<const bf16*>(a.o) + nx.b * st.o[0] +
                    nx.h * st.o[1] + row * st.o[2] + off);
        prefetch_l2(static_cast<const bf16*>(a.dout) + nx.b * st.dout[0] +
                    nx.h * st.dout[1] + row * st.dout[2] + off);
      }
    }
    float dq[NB][32];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 32; ++e) dq[nb][e] = 0.f;
    mbar_wait(own_full, j & 1);
    for (int kv = 0; kv < n_tiles; ++kv)
      dq_tile<NB, ELEM, NST>(t + kv, 64 * kv, a, ring, full, empty, q_addr,
                             do_addr, brow, mr, lir, dr, dq);
    t += n_tiles;
    // out through q's tile, which the item is done with
    const float mul[2] = {a.scale, a.scale};
    store_tile<NB>(base, &maps.dq, it.row0, it.h, it.b, mul, dq);
    if (tid == 0) tma_store_wait_read();
    mbar_arrive(own_empty);  // q's and dO's tiles are free
  }
}

template <int NB, int MIN_BLOCKS>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    bwd_dkv_sm90_kernel(const __grid_constant__ Maps maps, const Args a) {
  using Lay = WLayout<NB>;  // STAGES (3) stages
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align_smem(smem_raw);
  unsigned char* ring = base + Lay::RING;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + Lay::BARS);
  uint64_t* empty = full + STAGES;
  uint64_t* own_bar = empty + STAGES;

  const int kv0 = blockIdx.x * ROWS, h = blockIdx.y, b = blockIdx.z;
  const Strides& st = a.st;
  const int n_tiles = (a.Sq + 63) / 64;
  const float* bias_bh =
      a.bias == nullptr ? nullptr : a.bias + b * st.bias[0] + h * st.bias[1];
  const bool row_bias = bias_bh != nullptr && st.bias[2] == 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], CONSUMERS);
    }
    mbar_init(own_bar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  // producer warp: k, v once; q, dO through the ring
  if (warp_uniform_index() >= CONSUMERS / 32) {
    if (threadIdx.x == CONSUMERS)
      load_own<NB>(base, own_bar, &maps.k, &maps.v, kv0, h, b);
    const int lane = threadIdx.x & 31;
    const long long so = ((long long)b * a.H + h) * a.Sq;
    for (int t = 0; t < n_tiles; ++t) {
      const int q0 = 64 * t;
      produce<NB, STAGES>(
          t, ring, full, empty, &maps.q, &maps.dout, q0, h, b,
          [&](float* rows) {  // m, l, delta of the tile's rows
            for (int r = lane; r < 64; r += 32) {
              const long long i = so + min(q0 + r, a.Sq - 1);
              const bool in = q0 + r < a.Sq;
              cp_async_4(rows + r, a.m + i, in);
              cp_async_4(rows + 64 + r, a.l + i, in);
              cp_async_4(rows + 128 + r, a.delta + i, in);
            }
          });
    }
    return;
  }

  // consumers: the warpgroup owns kv rows kv0 .. kv0 + 63
  const int tid = threadIdx.x, g = (tid & 31) >> 2;
  const int r0 = 16 * (tid >> 5) + g;  // this lane's rows: r0, r0 + 8
  const int kvrow[2] = {kv0 + r0, kv0 + r0 + 8};
  float bk[2] = {0.f, 0.f};  // the padding-mask row at this lane's kv rows
  if (row_bias)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (kvrow[i] < a.Skv) bk[i] = bias_bh[kvrow[i]];
  float dk[NB][32], dv[NB][32];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int e = 0; e < 32; ++e) dk[nb][e] = dv[nb][e] = 0.f;
  mbar_wait(own_bar, 0);
  const uint32_t k_addr = smem_u32(base), v_addr = k_addr + Lay::TILE;

  for (int t = 0; t < n_tiles; ++t) {
    const int s = stage_of(t), q0 = 64 * t;
    mbar_wait(&full[s], full_parity(t));
    unsigned char* stg = ring + s * Lay::STAGE;
    const uint32_t q_addr = smem_u32(stg), do_addr = q_addr + Lay::TILE;
    const float* m_t = reinterpret_cast<const float*>(stg + 2 * Lay::TILE);
    // s^T = k q^T and (dO v^T)^T = v dO^T: rows kv, columns q
    float sc[32], dp[32];
    two_score_products<NB>(sc, dp, k_addr, q_addr, v_addr, do_addr);
    if (bias_bh != nullptr && !row_bias)
      dkv_tile_p_ds<true>(sc, dp, m_t, bk, bias_bh, st.bias[2], kvrow, q0,
                          a.Sq, a.Skv, a.scale);
    else
      dkv_tile_p_ds<false>(sc, dp, m_t, bk, bias_bh, st.bias[2], kvrow, q0,
                           a.Sq, a.Skv, a.scale);
    // dv += p^T dO, dk += ds^T q: register A operands, dO and q read
    // MN-major from the ring
    uint32_t pa[4][4], da[4][4];
    pack_acc(pa, sc);
    pack_acc(da, dp);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        wgmma_rs_mn(dv[nb], pa[kk],
                    mnmajor_desc(do_addr + nb * BOX_BYTES, kk));
        wgmma_rs_mn(dk[nb], da[kk],
                    mnmajor_desc(q_addr + nb * BOX_BYTES, kk));
      }
    wg_commit();
    wg_wait_all();
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      fence_acc(dk[nb]);
      fence_acc(dv[nb]);
    }
    mbar_arrive(&empty[s]);
  }
  bf16* dkb = static_cast<bf16*>(a.dk) + b * st.dk[0] + h * st.dk[1];
  bf16* dvb = static_cast<bf16*>(a.dv) + b * st.dv[0] + h * st.dv[1];
  store_rows<NB>(dkb, st.dk[2], kvrow, a.Skv, a.D, a.scale, dk);
  store_rows<NB>(dvb, st.dv[2], kvrow, a.Skv, a.D, 1.f, dv);
}

// ---------------------------------------------------------------------------
// float32: split-TF32 products on mma.sync, four warps a block and a
// 2-stage ring (flash_attention_tf32.cuh: the products, the layouts, the
// loads, and why not wgmma).
//   - What bounds them: 3 x 6 (K2) and 3 x 8 (K3) B H Sq Skv D FLOPs on
//     the tensor cores at TF32 rate, 0.68 and 0.91 ms at ViLT's [64, 12,
//     617, 64] (495 TFLOP/s); on the FP32 FMA units the same work in f32
//     takes at least 1.68 and 2.23 ms (67 TFLOP/s). mma.sync's tf32 peak
//     is ~319 TFLOP/s; the split, the loads and the exp keep the warps'
//     issue, not the tensor cores, the limit (PERF.md).
// ---------------------------------------------------------------------------

// K2 in f32: replaces _flash_bwd_dq_kernel (mmf_tpu/ops/attention.py) in
// float32. One block per (b, h, 64 q rows); q and dO own, k and v through
// the ring with the tile's padding-mask row.
template <int NB, int MIN_BLOCKS>
__global__ void __launch_bounds__(F_THREADS, MIN_BLOCKS)
    bwd_dq_tf32x3_kernel(const __grid_constant__ Maps maps, const Args a) {
  using Lay = FLayout<NB>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align_smem(smem_raw);
  unsigned char* ring = base + Lay::RING;
  float* m_s = reinterpret_cast<float*>(base + Lay::STATS);
  float* li_s = m_s + ROWS;
  float* dl_s = li_s + ROWS;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + Lay::BARS);
  uint64_t* own_bar = full + F_STAGES;

  const int q0 = blockIdx.x * ROWS, h = blockIdx.y, b = blockIdx.z;
  const Strides& st = a.st;
  const int n_tiles = (a.Skv + 63) / 64, boxes = (a.D + 31) / 32;
  const float* bias_bh =
      a.bias == nullptr ? nullptr : a.bias + b * st.bias[0] + h * st.bias[1];
  const bool row_bias = bias_bh != nullptr && st.bias[2] == 0;
  const int tid = threadIdx.x, g = (tid & 31) >> 2;
  auto fill = [&](int kv0) {  // the tile's padding-mask row, or zeros
    return [&, kv0](float* rows) {
      if (tid < 64) {
        const bool in = row_bias && kv0 + tid < a.Skv;
        cp_async_4(rows + tid, in ? bias_bh + kv0 + tid : a.m, in);
      }
    };
  };
  zero_spare_boxes<NB, 2>(base, boxes);
  init_f32_barriers(full, own_bar);
  load_own_f32<NB, 2>(base, own_bar, &maps.q, &maps.dout, q0, h, b, boxes);
  for (int t = 0; t < F_STAGES - 1 && t < n_tiles; ++t)
    load_stage<NB>(t, ring, full, &maps.k, &maps.v, 64 * t, h, b, boxes,
                   fill(64 * t));

  const long long so = ((long long)b * a.H + h) * a.Sq;
  {
    // delta = rowsum(dO * O), 8 threads a row, 16-byte loads, with m and
    // 1 / l, for the block's rows
    const float* ob =
        static_cast<const float*>(a.o) + b * st.o[0] + h * st.o[1];
    const float* dob =
        static_cast<const float*>(a.dout) + b * st.dout[0] + h * st.dout[1];
    const int part = tid & 7;
    float acc[4], mv[4], lv[4];
#pragma unroll
    for (int pass = 0; pass < 4; ++pass) {
      const int s = q0 + 16 * pass + (tid >> 3);
      const bool in = s < a.Sq;
      acc[pass] = 0.f;
      mv[pass] = 0.f;
      lv[pass] = 1.f;
      if (in && part == 0) {
        mv[pass] = a.m[so + s];
        lv[pass] = a.l[so + s];
      }
#pragma unroll
      for (int c = 0; c < 2 * NB; ++c) {
        const int c4 = 4 * part + 32 * c;
        if (!in || c4 >= a.D) continue;
        const float4 x =
            *reinterpret_cast<const float4*>(dob + s * st.dout[2] + c4);
        const float4 y =
            *reinterpret_cast<const float4*>(ob + s * st.o[2] + c4);
        acc[pass] = fmaf(x.x, y.x, acc[pass]);
        acc[pass] = fmaf(x.y, y.y, acc[pass]);
        acc[pass] = fmaf(x.z, y.z, acc[pass]);
        acc[pass] = fmaf(x.w, y.w, acc[pass]);
      }
    }
#pragma unroll
    for (int pass = 0; pass < 4; ++pass) {
      const int r = 16 * pass + (tid >> 3), s = q0 + r;
      const bool in = s < a.Sq;
      const float d = sum_xor(acc[pass], 8);
      if (part == 0) {
        dl_s[r] = in ? d : 0.f;
        m_s[r] = mv[pass];
        li_s[r] = 1.f / lv[pass];
        if (in) a.delta[so + s] = d;
      }
    }
    __syncthreads();
  }
  // warp w owns q rows q0 + 16 w + g and + 8
  const int r0 = 16 * (tid >> 5) + g;
  const int qrow[2] = {q0 + r0, q0 + r0 + 8};
  const bool elem_bias = bias_bh != nullptr && !row_bias;
  float mr[2], lir[2], dr[2];
  const float* brow[2];  // rows of a per-element bias (clamped to Sq)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mr[i] = m_s[r0 + 8 * i];
    lir[i] = li_s[r0 + 8 * i];
    dr[i] = dl_s[r0 + 8 * i];
    brow[i] = elem_bias ? bias_bh + min(qrow[i], a.Sq - 1) * st.bias[2]
                        : nullptr;
  }
  float dq[NB][32];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int e = 0; e < 32; ++e) dq[nb][e] = 0.f;
  const FragOffsets frag;
  mbar_wait(own_bar, 0);
  // the own tiles from this warp's 16 rows on
  const float* q_t = reinterpret_cast<const float*>(base) + 512 * (tid >> 5);
  const float* do_t =
      reinterpret_cast<const float*>(base + Lay::TILE) + 512 * (tid >> 5);

  for (int t = 0; t < n_tiles; ++t) {
    const int kv0 = 64 * t, ahead = 64 * (t + F_STAGES - 1);
    next_stage<NB>(t, n_tiles, ring, full, &maps.k, &maps.v, h, b, boxes,
                   fill(ahead));
    const unsigned char* stg = ring + (t % F_STAGES) * Lay::STAGE;
    const float* k_t = reinterpret_cast<const float*>(stg);
    const float* v_t = reinterpret_cast<const float*>(stg + Lay::TILE);
    const float* bias_row =
        reinterpret_cast<const float*>(stg + 2 * Lay::TILE);
    float sc[32], dp[32];
    score_products<NB, 2>(sc, dp, q_t, k_t, do_t, v_t, frag);
    if (elem_bias)
      dq_tile_ds<true>(sc, dp, bias_row, brow, kv0, a.Skv, a.scale, mr,
                       lir, dr);
    else
      dq_tile_ds<false>(sc, dp, bias_row, brow, kv0, a.Skv, a.scale, mr,
                        lir, dr);
    acc_products<NB, 1>(dq, sc, k_t, dq, sc, k_t, frag);  // dq += ds k
  }
  float* dqb = static_cast<float*>(a.dq) + b * st.dq[0] + h * st.dq[1];
  const float mul[2] = {a.scale, a.scale};
  store_rows<NB, float>(dqb, st.dq[2], qrow, a.Sq, a.D, mul, dq);
}

// K3 in f32: replaces _flash_bwd_dkv_kernel (mmf_tpu/ops/attention.py) in
// float32. One block per (b, h, 64 kv rows); k and v own, q and dO through
// the ring with the tile's m, l and delta rows.
template <int NB, int MIN_BLOCKS>
__global__ void __launch_bounds__(F_THREADS, MIN_BLOCKS)
    bwd_dkv_tf32x3_kernel(const __grid_constant__ Maps maps, const Args a) {
  using Lay = FLayout<NB>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align_smem(smem_raw);
  unsigned char* ring = base + Lay::RING;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + Lay::BARS);
  uint64_t* own_bar = full + F_STAGES;

  const int kv0 = blockIdx.x * ROWS, h = blockIdx.y, b = blockIdx.z;
  const Strides& st = a.st;
  const int n_tiles = (a.Sq + 63) / 64, boxes = (a.D + 31) / 32;
  const float* bias_bh =
      a.bias == nullptr ? nullptr : a.bias + b * st.bias[0] + h * st.bias[1];
  const bool row_bias = bias_bh != nullptr && st.bias[2] == 0;
  const int tid = threadIdx.x, g = (tid & 31) >> 2;
  const long long so = ((long long)b * a.H + h) * a.Sq;
  auto fill = [&](int q0) {  // m, l and delta of the tile's rows
    return [&, q0](float* rows) {
      if (tid < 64) {
        const long long i = so + min(q0 + tid, a.Sq - 1);
        const bool in = q0 + tid < a.Sq;
        cp_async_4(rows + tid, a.m + i, in);
        cp_async_4(rows + 64 + tid, a.l + i, in);
        cp_async_4(rows + 128 + tid, a.delta + i, in);
      }
    };
  };
  zero_spare_boxes<NB, 2>(base, boxes);
  init_f32_barriers(full, own_bar);
  load_own_f32<NB, 2>(base, own_bar, &maps.k, &maps.v, kv0, h, b, boxes);
  for (int t = 0; t < F_STAGES - 1 && t < n_tiles; ++t)
    load_stage<NB>(t, ring, full, &maps.q, &maps.dout, 64 * t, h, b, boxes,
                   fill(64 * t));

  // warp w owns kv rows kv0 + 16 w + g and + 8
  const int r0 = 16 * (tid >> 5) + g;
  const int kvrow[2] = {kv0 + r0, kv0 + r0 + 8};
  float bk[2] = {0.f, 0.f};  // the padding-mask row at this lane's kv rows
  if (row_bias)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (kvrow[i] < a.Skv) bk[i] = bias_bh[kvrow[i]];
  float dk[NB][32], dv[NB][32];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int e = 0; e < 32; ++e) dk[nb][e] = dv[nb][e] = 0.f;
  const FragOffsets frag;
  mbar_wait(own_bar, 0);
  // the own tiles from this warp's 16 rows on
  const float* k_t = reinterpret_cast<const float*>(base) + 512 * (tid >> 5);
  const float* v_t =
      reinterpret_cast<const float*>(base + Lay::TILE) + 512 * (tid >> 5);

  for (int t = 0; t < n_tiles; ++t) {
    const int q0 = 64 * t, ahead = 64 * (t + F_STAGES - 1);
    next_stage<NB>(t, n_tiles, ring, full, &maps.q, &maps.dout, h, b, boxes,
                   fill(ahead));
    const unsigned char* stg = ring + (t % F_STAGES) * Lay::STAGE;
    const float* q_t = reinterpret_cast<const float*>(stg);
    const float* do_t = reinterpret_cast<const float*>(stg + Lay::TILE);
    const float* rows = reinterpret_cast<const float*>(stg + 2 * Lay::TILE);
    // s^T = k q^T and (dO v^T)^T = v dO^T: rows kv, columns q
    float sc[32], dp[32];
    score_products<NB, 2>(sc, dp, k_t, q_t, v_t, do_t, frag);
    if (bias_bh != nullptr && !row_bias)
      dkv_tile_p_ds<true>(sc, dp, rows, bk, bias_bh, st.bias[2], kvrow, q0,
                          a.Sq, a.Skv, a.scale);
    else
      dkv_tile_p_ds<false>(sc, dp, rows, bk, bias_bh, st.bias[2], kvrow, q0,
                           a.Sq, a.Skv, a.scale);
    // dv += p^T dO and dk += ds^T q
    acc_products<NB, 2>(dv, sc, do_t, dk, dp, q_t, frag);
  }
  float* dkb = static_cast<float*>(a.dk) + b * st.dk[0] + h * st.dk[1];
  float* dvb = static_cast<float*>(a.dv) + b * st.dv[0] + h * st.dv[1];
  const float k_mul[2] = {a.scale, a.scale}, v_mul[2] = {1.f, 1.f};
  store_rows<NB, float>(dkb, st.dk[2], kvrow, a.Skv, a.D, k_mul, dk);
  store_rows<NB, float>(dvb, st.dv[2], kvrow, a.Skv, a.D, v_mul, dv);
}

// A bf16 K2 instance: the kernel and its dynamic shared memory.
struct DqKernel {
  void (*kernel)(const Maps, const Args);
  int smem;
};

// The four operand maps (bf16, or f32 with `f32`), or false for a layout
// TMA does not take.
bool make_maps(Maps& maps, const Args& a, int B, bool f32) {
  return make_tile_map(&maps.q, a.q, a.D, a.Sq, a.H, B, a.st.q, f32) &&
         make_tile_map(&maps.k, a.k, a.D, a.Skv, a.H, B, a.st.k, f32) &&
         make_tile_map(&maps.v, a.v, a.D, a.Skv, a.H, B, a.st.v, f32) &&
         make_tile_map(&maps.dout, a.dout, a.D, a.Sq, a.H, B, a.st.dout,
                       f32);
}

// Sets the kernel's shared-memory size, encodes the four operand maps (f32
// or bf16) and launches `grid` blocks of `threads`. The attribute call
// comes first: it makes the device's primary context current in the
// calling thread, which encoding a tensor map needs (a fresh host thread,
// as autograd's backward thread, may have none yet).
template <typename Kernel>
cudaError_t launch_sm90(Kernel kernel, size_t smem, int threads, dim3 grid,
                        int B, bool f32, const Args& a,
                        cudaStream_t stream, bool dq_map = false) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  Maps maps;
  if (!make_maps(maps, a, B, f32) ||
      (dq_map && !make_tile_map(&maps.dq, a.dq, a.D, a.Sq, a.H, B, a.st.dq)))
    return cudaErrorInvalidValue;
  kernel<<<grid, threads, smem, stream>>>(maps, a);
  return cudaGetLastError();
}

// One block per (64 rows, h, b).
dim3 row_grid(int n_rows, const Args& a, int B) {
  return dim3((n_rows + ROWS - 1) / ROWS, a.H, B);
}

// K2's bf16 block at head dim D (measured on the H100, PERF.md): at
// D <= 64 three stages and three blocks an SM (the registers allow
// three); at D = 128 two stages (~100 KB of shared memory) and two blocks
// an SM, where three stages (~133 KB) held one. A per-element bias (no
// bf16 main path has one) takes two blocks at D <= 64 and one at D = 128,
// where more would spill. A persistent grid.
template <int ELEM>
DqKernel dq_block(int D) {
  return D > 64 ? DqKernel{bwd_dq_sm90_kernel<2, ELEM, 2, ELEM ? 1 : 2>,
                           WLayout<2, 2, 2, 2>::BYTES}
                : DqKernel{bwd_dq_sm90_kernel<1, ELEM, 3, ELEM ? 2 : 3>,
                           WLayout<1, 2, 3, 2>::BYTES};
}

DqKernel dq_block(int D, bool elem) {
  return elem ? dq_block<1>(D) : dq_block<0>(D);
}

// The bf16 kernels: K2 as dq_block says. K3 (five 32-register
// accumulators) runs two blocks an SM at D <= 64 (at three it spills and
// ptxas serialises its products) and one at D = 128 (255 registers),
// three stages: one consumer warpgroup a block beat two there, since a
// block's latency chain is long and more, smaller blocks overlap better.
cudaError_t launch_bf16(bool dq, int B, const Args& a, cudaStream_t s) {
  if (dq) {
    const DqKernel k = dq_block(a.D, a.bias != nullptr && a.st.bias[2] != 0);
    int grid = 0;
    const cudaError_t err = persistent_grid(
        k.kernel, THREADS, k.smem, (a.Sq + ROWS - 1) / ROWS * a.H * B, &grid);
    if (err != cudaSuccess) return err;
    return launch_sm90(k.kernel, k.smem, THREADS, dim3(grid), B, false, a,
                       s, true);
  }
  const dim3 grid = row_grid(a.Skv, a, B);
  return a.D > 64 ? launch_sm90(bwd_dkv_sm90_kernel<2, 1>, WLayout<2>::BYTES,
                                THREADS, grid, B, false, a, s)
                  : launch_sm90(bwd_dkv_sm90_kernel<1, 2>, WLayout<1>::BYTES,
                                THREADS, grid, B, false, a, s);
}

// The f32 kernels: two blocks an SM at D <= 64 (~100 KB of shared memory
// each, 8 warps an SM: up to 255 registers a thread), one above (~196 KB).
cudaError_t launch_f32(bool dq, int B, const Args& a, cudaStream_t s) {
  const dim3 grid = row_grid(dq ? a.Sq : a.Skv, a, B);
  if (a.D > 64)
    return dq ? launch_sm90(bwd_dq_tf32x3_kernel<2, 1>, FLayout<2>::BYTES,
                            F_THREADS, grid, B, true, a, s)
              : launch_sm90(bwd_dkv_tf32x3_kernel<2, 1>, FLayout<2>::BYTES,
                            F_THREADS, grid, B, true, a, s);
  return dq ? launch_sm90(bwd_dq_tf32x3_kernel<1, 2>, FLayout<1>::BYTES,
                          F_THREADS, grid, B, true, a, s)
            : launch_sm90(bwd_dkv_tf32x3_kernel<1, 2>, FLayout<1>::BYTES,
                          F_THREADS, grid, B, true, a, s);
}

// Validates the arguments shared by both entry points and fills `a`.
// Returns cudaSuccess, or the error the entry point reports.
cudaError_t prepare(Args& a, int dtype, int B, int H, int Sq, int Skv,
                    int D, const long long* strides, float scale) {
  if (D <= 0 || D > MAX_D || D % 8 != 0 || B > 65535 || H > 65535 ||
      (dtype != 0 && dtype != 1) || a.m == nullptr || a.l == nullptr ||
      a.delta == nullptr)
    return cudaErrorInvalidValue;
  a.B = B;
  a.H = H;
  a.Sq = Sq;
  a.Skv = Skv;
  a.D = D;
  a.scale = scale;
  long long* dst[9] = {a.st.q,  a.st.k,  a.st.v,  a.st.o,   a.st.dout,
                       a.st.dq, a.st.dk, a.st.dv, a.st.bias};
  for (int t = 0; t < 9; ++t)
    for (int i = 0; i < 3; ++i) dst[t][i] = strides[3 * t + i];
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Shared conventions of both entry points. dtype: 0 = float32,
// 1 = bfloat16 (q, k, v, o, dout and the gradients share it); bias is
// float32 or null. strides: 27 element strides, (batch, head, seq) for
// q, k, v, o, dout, dq, dk, dv and bias in that order; the head dim is
// contiguous in all. m, l, delta: contiguous float32 [B, H, Sq]. q, k, v,
// o and dout (and the bf16 K2's dq: a TMA store writes it) need 16-byte
// aligned pointers and strides that are multiples of 16 bytes, positive
// on every dim longer than 1 (the TMA maps carry them). Each launches on
// `stream`, allocates nothing and returns cudaGetLastError() (or
// cudaErrorInvalidValue / cudaErrorMisalignedAddress for arguments the
// kernels do not take).

// K2: dq, and delta = rowsum(dout * o) written for K3.
int mmf_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                               const void* o, const void* dout,
                               const float* bias, const float* m,
                               const float* l, float* delta, void* dq,
                               int dtype, int B, int H, int Sq, int Skv,
                               int D, const long long* strides, float scale,
                               void* stream) {
  Args a{};
  a.q = q, a.k = k, a.v = v, a.o = o, a.dout = dout, a.bias = bias;
  a.m = m, a.l = l, a.delta = delta, a.dq = dq;
  cudaError_t err = prepare(a, dtype, B, H, Sq, Skv, D, strides, scale);
  if (err != cudaSuccess) return int(err);
  if (B == 0 || H == 0 || Sq == 0) return 0;
  // no kv tile to map; items of the persistent grid past an int
  if (Skv <= 0 || (Sq + 63LL) / 64 * H * B > INT_MAX)
    return int(cudaErrorInvalidValue);
  const int eb = dtype == 1 ? 2 : 4;
  if (!aligned16(q, a.st.q, eb) || !aligned16(k, a.st.k, eb) ||
      !aligned16(v, a.st.v, eb) || !aligned16(o, a.st.o, eb) ||
      !aligned16(dout, a.st.dout, eb) ||
      (dtype == 1 && !aligned16(dq, a.st.dq, eb)))
    return int(cudaErrorMisalignedAddress);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return int(dtype == 1 ? launch_bf16(true, B, a, s)
                        : launch_f32(true, B, a, s));
}

// K3: dk and dv, from the delta that K2 wrote.
int mmf_flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                const void* dout, const float* bias,
                                const float* m, const float* l,
                                const float* delta, void* dk, void* dv,
                                int dtype, int B, int H, int Sq, int Skv,
                                int D, const long long* strides, float scale,
                                void* stream) {
  Args a{};
  a.q = q, a.k = k, a.v = v, a.dout = dout, a.bias = bias;
  a.m = m, a.l = l, a.delta = const_cast<float*>(delta), a.dk = dk, a.dv = dv;
  cudaError_t err = prepare(a, dtype, B, H, Sq, Skv, D, strides, scale);
  if (err != cudaSuccess) return int(err);
  if (B == 0 || H == 0 || Skv == 0) return 0;
  const int eb = dtype == 1 ? 2 : 4;
  if (!aligned16(q, a.st.q, eb) || !aligned16(k, a.st.k, eb) ||
      !aligned16(v, a.st.v, eb) || !aligned16(dout, a.st.dout, eb))
    return int(cudaErrorMisalignedAddress);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return int(dtype == 1 ? launch_bf16(false, B, a, s)
                        : launch_f32(false, B, a, s));
}

// Dynamic shared memory of a K2 (dq 1) or K3 (dq 0) block at head dim D,
// bf16 (dtype 1) or f32 (0; K2 and K3 share the layout), for reports.
int mmf_flash_attention_bwd_smem_bytes(int D, int dtype, int dq) {
  if (dtype == 0) return D <= 64 ? FLayout<1>::BYTES : FLayout<2>::BYTES;
  if (dq) return dq_block(D, false).smem;
  return D <= 64 ? WLayout<1>::BYTES : WLayout<2>::BYTES;
}

// Blocks an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor) of the bf16
// K2 block the launcher takes at head dim D, with a per-element bias
// (`elem`) or not; its dynamic shared memory in *smem. For reports; a
// negative cudaError_t on failure.
int mmf_flash_attention_bwd_dq_occupancy(int D, int elem, int* smem) {
  if (D <= 0 || D > MAX_D) return -1;
  const DqKernel k = dq_block(D, elem != 0);
  int blocks = 0;
  const cudaError_t err = blocks_per_sm(k.kernel, THREADS, k.smem, &blocks);
  *smem = k.smem;
  return err == cudaSuccess ? blocks : -int(err);
}

const char* mmf_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
