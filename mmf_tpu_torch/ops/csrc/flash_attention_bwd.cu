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
// delta is folded into K2's prologue: each K2 block reads its q rows of dO
// and O once, keeps delta in shared memory and writes it to a float32
// [B, H, Sq] buffer that K3, launched after K2 on the same stream, reads.
//
// What bounds them on the H100: at the main path's shape (B=64, H=12,
// S=228, D=64) K2 does 3 and K3 4 products of ~2*S*S*D FLOPs per (b, h)
// against ~6*S*D elements read: a few hundred FLOPs per byte, so the
// bound is close to the line between bytes and tensor-core operations,
// and only wgmma reaches the tensor cores' full rate on Hopper. At this
// shape a block's work is short (four 64-row tiles), so what decides the
// time is the latency of a block's chain of loads, products and
// elementwise math, and how many blocks overlap on an SM. Design of the
// bfloat16 kernels (warp-specialised; layouts in hopper.cuh):
//   - K2: one block per (b, h, 64 q rows): one consumer warpgroup and one
//     producer warp. q and dO are loaded once by TMA; k and v tiles of 64
//     kv rows stream through a 3-stage shared-memory ring filled by TMA,
//     with the tile's padding-mask bias row beside them (cp.async);
//     mbarriers count the bytes, so loads overlap the products and the
//     producer never waits for a load. s = q k^T and dp = dO v^T run on
//     wgmma from shared memory (K-major); ds = p (dp - delta) is formed in
//     the accumulator registers, rounded to bf16 and fed back as wgmma's
//     register A operand for dq += ds k, with k read through an MN-major
//     descriptor: no transposed copy. delta is K2's prologue (16-byte
//     loads of dO and O, all in flight together), written for K3.
//   - K3: one block per (b, h, 64 kv rows): k and v loaded once; q and dO
//     tiles of 64 q rows stream through the ring with their m, l and
//     delta rows (cp.async). s^T = k q^T and dp^T = v dO^T on wgmma; p^T
//     and ds^T stay in registers as the A operands of dv += p^T dO and
//     dk += ds^T q, with q and dO read MN-major.
//   - The elementwise math is branch-free and the wgmma paths are
//     provably non-divergent (ptxas otherwise serialises the products).
//     K2 runs three blocks an SM, K3 two (its five accumulators).
//   - The head dim is zero-padded to 64-column boxes (TMA fills rows and
//     columns outside the tensor with zeros); padded kv columns get p = 0
//     and padded rows are never stored. No atomics: every output element
//     is written by one block, so two runs give the same bits.
//   - float32: the same blocks and ring, with the products in split-TF32
//     on mma.sync (the float32 section below says why not wgmma).
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

#include <math.h>

#include "flash_attention_sm90.cuh"

namespace {

using namespace mmf_flash_sm90;

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
  int H, Sq, Skv, D;
  float scale;
  Strides st;
};

// ---------------------------------------------------------------------------
// bfloat16: warp-specialised wgmma kernels (the block, ring and layouts of
// flash_attention_sm90.cuh, shared with the forward K1).
// ---------------------------------------------------------------------------
struct Maps {
  CUtensorMap q, k, v, dout;
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

template <int NB, int MIN_BLOCKS>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    bwd_dq_sm90_kernel(const __grid_constant__ Maps maps, const Args a) {
  using Lay = WLayout<NB>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align_smem(smem_raw);
  unsigned char* ring = base + Lay::RING;
  float* m_s = reinterpret_cast<float*>(base + Lay::STATS);
  float* li_s = m_s + ROWS;
  float* dl_s = li_s + ROWS;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + Lay::BARS);
  uint64_t* empty = full + STAGES;
  uint64_t* own_bar = empty + STAGES;

  const int q0 = blockIdx.x * ROWS, h = blockIdx.y, b = blockIdx.z;
  const Strides& st = a.st;
  const int n_tiles = (a.Skv + 63) / 64;
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

  // producer warp: q, dO once; k, v through the ring
  if (warp_uniform_index() >= CONSUMERS / 32) {
    if (threadIdx.x == CONSUMERS)
      load_own<NB>(base, own_bar, &maps.q, &maps.dout, q0, h, b);
    const int lane = threadIdx.x & 31;
    for (int t = 0; t < n_tiles; ++t) {
      const int kv0 = 64 * t;
      produce<NB>(t, ring, full, empty, &maps.k, &maps.v, kv0, h, b,
                  [&](float* rows) {  // the tile's padding-mask row, or 0
                    for (int c = lane; c < 64; c += 32) {
                      const bool in = row_bias && kv0 + c < a.Skv;
                      cp_async_4(rows + c, in ? bias_bh + kv0 + c : a.m, in);
                    }
                  });
    }
    return;
  }

  // consumers: the warpgroup owns q rows q0 .. q0 + 63
  const int tid = threadIdx.x, g = (tid & 31) >> 2;
  const long long so = ((long long)b * a.H + h) * a.Sq;
  {
    // delta = rowsum(dO * O), f32, 8 threads a row, 16-byte loads; with
    // m and 1 / l, for the block's rows
    const bf16* ob = static_cast<const bf16*>(a.o) + b * st.o[0] + h * st.o[1];
    const bf16* dob =
        static_cast<const bf16*>(a.dout) + b * st.dout[0] + h * st.dout[1];
    // (all loads of the four passes are independent: unrolled, they are
    // in flight together)
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
      for (int c = 0; c < NB; ++c) {
        const int c8 = 8 * part + 64 * c;
        if (!in || c8 >= a.D) continue;
        const uint4 x =
            *reinterpret_cast<const uint4*>(dob + s * st.dout[2] + c8);
        const uint4 y = *reinterpret_cast<const uint4*>(ob + s * st.o[2] + c8);
        const __nv_bfloat162* xp = reinterpret_cast<const __nv_bfloat162*>(&x);
        const __nv_bfloat162* yp = reinterpret_cast<const __nv_bfloat162*>(&y);
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
    named_barrier(1, CONSUMERS);
  }
  const int r0 = 16 * (tid >> 5) + g;  // this lane's rows: r0, r0 + 8
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
  mbar_wait(own_bar, 0);
  const uint32_t q_addr = smem_u32(base), do_addr = q_addr + Lay::TILE;

  for (int t = 0; t < n_tiles; ++t) {
    const int s = stage_of(t), kv0 = 64 * t;
    mbar_wait(&full[s], full_parity(t));
    unsigned char* stg = ring + s * Lay::STAGE;
    const uint32_t k_addr = smem_u32(stg), v_addr = k_addr + Lay::TILE;
    const float* bias_row = reinterpret_cast<const float*>(stg + 2 * Lay::TILE);
    float sc[32], dp[32];
    two_score_products<NB>(sc, dp, q_addr, k_addr, do_addr, v_addr);
    if (elem_bias)
      dq_tile_ds<true>(sc, dp, bias_row, brow, kv0, a.Skv, a.scale, mr,
                       lir, dr);
    else
      dq_tile_ds<false>(sc, dp, bias_row, brow, kv0, a.Skv, a.scale, mr,
                        lir, dr);
    // dq += ds k: ds rounded to bf16 as the register A operand, k read
    // MN-major from the ring
    uint32_t da[4][4];
    pack_acc(da, sc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
        wgmma_rs_mn(dq[nb], da[kk],
                    mnmajor_desc(k_addr + nb * BOX_BYTES, kk));
    wg_commit();
    wg_wait_all();
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) fence_acc(dq[nb]);
    mbar_arrive(&empty[s]);
  }
  bf16* dqb = static_cast<bf16*>(a.dq) + b * st.dq[0] + h * st.dq[1];
  store_rows<NB>(dqb, st.dq[2], qrow, a.Sq, a.D, a.scale, dq);
}

template <int NB, int MIN_BLOCKS>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    bwd_dkv_sm90_kernel(const __grid_constant__ Maps maps, const Args a) {
  using Lay = WLayout<NB>;
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
      produce<NB>(t, ring, full, empty, &maps.q, &maps.dout, q0, h, b,
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
// float32: split-TF32 ("3xTF32") products on the tensor cores.
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
// ds k, p^T dO and ds^T q would need k^T, dO^T and q^T written by the
// block, and each operand read from shared memory would need its lo half
// in a buffer of its own: at D = 64 a K2 block would hold q, dO and their
// lo (64 KB), a 2-stage k/v ring (66 KB), k and v lo, k^T and its lo
// (64 KB): 194 KB, one block and one consumer warpgroup an SM, whose exp
// and split work would stall its own products; at D = 128, 354 KB, which
// does not fit. With mma.sync the split happens in registers as each
// fragment is loaded and the transposed operands are read in place: no
// derived copy, ~100 KB a block at D = 64, two blocks an SM.
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
//     4). Instead of shuffling, the second products (ds k, p^T dO, ds^T q)
//     take the reduction index of each 8 in the order 0, 2, 4, 6, 1, 3, 5,
//     7: the accumulator registers are the A fragment as they stand, and
//     the B fragment reads rows 2t and 2t + 1 of the tile.
//   - p and ds are formed in the registers by the bf16 kernels' helpers:
//     the bias row once a tile, a per-element bias per element.
//   - What bounds them: 3 x 6 (K2) and 3 x 8 (K3) B H Sq Skv D FLOPs on
//     the tensor cores at TF32 rate, 0.68 and 0.91 ms at ViLT's [64, 12,
//     617, 64] (495 TFLOP/s); on the FP32 FMA units the same work in f32
//     takes at least 1.68 and 2.23 ms (67 TFLOP/s). mma.sync's tf32 peak
//     is ~319 TFLOP/s; the split, the loads and the exp keep the warps'
//     issue, not the tensor cores, the limit (PERF.md).
// ---------------------------------------------------------------------------
constexpr int F_STAGES = 2;        // the f32 ring's depth
constexpr int F_THREADS = ROWS * 2;  // four warps of 16 rows, no producer

// Shared memory of an f32 block, NB 64-column blocks of the head dim (2 NB
// boxes a tile): its two own tiles, the ring (two tiles and up to 256 f32
// row values a stage), K2's row statistics, the mbarriers.
template <int NB>
struct FLayout {
  static constexpr int TILE = 2 * NB * BOX_BYTES;  // 64 rows x 64 NB f32
  static constexpr int STAGE = 2 * TILE + ALIGN;
  static constexpr int RING = 2 * TILE;
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

// s = A B^T and dp = C E^T over the 64 NB head-dim columns (zeros past
// D): the warp's rows 16 w + g and + 8 of the own tiles A and C (`A` and
// `C` already offset to row 16 w) against the 64 rows of the ring tiles B
// and E. s[4 n + e] is row g + 8 (e >> 1) of the warp, column 8 n + 2t +
// (e & 1): the wgmma accumulator layout the bf16 helpers read. A k-step's
// fragments are loaded and split first, then its 48 products issue term by
// term over the 16 accumulators, so no product waits on the one before.
template <int NB>
__device__ __forceinline__ void score_products(float (&s)[32],
                                               float (&dp)[32],
                                               const float* A,
                                               const float* B,
                                               const float* C,
                                               const float* E,
                                               const FragOffsets& o) {
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 8 * NB; ++kk) {
    const int lo = o.row_k[(2 * kk) & 7] + 2048 * (kk >> 2);
    const int hi = o.row_k[(2 * kk + 1) & 7] + 2048 * (kk >> 2);
    const Split a[4] = {split_tf32(A[lo]), split_tf32(A[lo + 256]),
                        split_tf32(A[hi]), split_tf32(A[hi + 256])};
    const Split e[4] = {split_tf32(C[lo]), split_tf32(C[lo + 256]),
                        split_tf32(C[hi]), split_tf32(C[hi + 256])};
    Split b[8][2], f[8][2];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      b[n][0] = split_tf32(B[lo + 256 * n]);
      b[n][1] = split_tf32(B[hi + 256 * n]);
      f[n][0] = split_tf32(E[lo + 256 * n]);
      f[n][1] = split_tf32(E[hi + 256 * n]);
    }
#pragma unroll
    for (int term = 0; term < 3; ++term)
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        mma_term(term, &s[4 * n], a, b[n][0], b[n][1]);
        mma_term(term, &dp[4 * n], e, f[n][0], f[n][1]);
      }
  }
}

// acc += X B, reduced over the 64 rows of the ring tile B, for two such
// products at once (X0 B0 into acc0, X1 B1 into acc1; K2 passes one): X is
// the warp's [16, 64] in the accumulator layout above, taken as the A
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

// Zeros the boxes past `boxes` of every tile TMA fills (the two own tiles
// and both tiles of each stage), which it never writes: the products run
// over all 64 NB columns. Nothing to do when D fills the tiles' boxes.
template <int NB>
__device__ __forceinline__ void zero_spare_boxes(unsigned char* base,
                                                 int boxes) {
  using Lay = FLayout<NB>;
  const int spare = 2 * NB - boxes;
  if (spare == 0) return;
  constexpr int TILES = 2 + 2 * F_STAGES;
  const int per_tile = spare * (BOX_BYTES / 16);  // 16-byte stores
  for (int i = threadIdx.x; i < TILES * per_tile; i += F_THREADS) {
    const int tile = i / per_tile, at = i - tile * per_tile;
    unsigned char* t = tile < 2 ? base + tile * Lay::TILE
                                : base + Lay::RING +
                                      ((tile - 2) >> 1) * Lay::STAGE +
                                      ((tile - 2) & 1) * Lay::TILE;
    reinterpret_cast<float4*>(t + boxes * BOX_BYTES)[at] =
        make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// Thread 0 starts the block's two own tiles (`boxes` 32-column boxes of 64
// rows from row0 of maps m0 and m1) onto `bar`.
template <int NB>
__device__ __forceinline__ void load_own_f32(unsigned char* base,
                                             uint64_t* bar,
                                             const CUtensorMap* m0,
                                             const CUtensorMap* m1, int row0,
                                             int h, int b, int boxes) {
  if (threadIdx.x != 0) return;
  mbar_arrive_expect_tx(bar, 2 * boxes * BOX_BYTES);
  for (int i = 0; i < boxes; ++i) {
    tma_load(base + i * BOX_BYTES, m0, bar, 32 * i, row0, h, b);
    tma_load(base + FLayout<NB>::TILE + i * BOX_BYTES, m1, bar, 32 * i, row0,
             h, b);
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
// t. The first F_STAGES - 1 tiles are started before the loop.
template <int NB, typename Fill>
__device__ __forceinline__ void next_stage(int t, int n_tiles,
                                           unsigned char* ring,
                                           uint64_t* full,
                                           const CUtensorMap* m0,
                                           const CUtensorMap* m1, int h,
                                           int b, int boxes, Fill fill) {
  const int ahead = t + F_STAGES - 1;
  if (ahead < n_tiles) {
    if (t > 0) __syncthreads();
    load_stage<NB>(ahead, ring, full, m0, m1, 64 * ahead, h, b, boxes, fill);
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
  zero_spare_boxes<NB>(base, boxes);
  init_f32_barriers(full, own_bar);
  load_own_f32<NB>(base, own_bar, &maps.q, &maps.dout, q0, h, b, boxes);
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
    score_products<NB>(sc, dp, q_t, k_t, do_t, v_t, frag);
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
  zero_spare_boxes<NB>(base, boxes);
  init_f32_barriers(full, own_bar);
  load_own_f32<NB>(base, own_bar, &maps.k, &maps.v, kv0, h, b, boxes);
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
    score_products<NB>(sc, dp, k_t, q_t, v_t, do_t, frag);
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
// or bf16) and launches one block of `threads` per (64 rows, h, b). The
// attribute call comes first: it makes the device's primary context
// current in the calling thread, which encoding a tensor map needs (a
// fresh host thread, as autograd's backward thread, may have none yet).
template <typename Kernel>
cudaError_t launch_sm90(Kernel kernel, size_t smem, int threads, int n_rows,
                        int B, bool f32, const Args& a,
                        cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  Maps maps;
  if (!make_maps(maps, a, B, f32)) return cudaErrorInvalidValue;
  dim3 grid((n_rows + ROWS - 1) / ROWS, a.H, B);
  kernel<<<grid, threads, smem, stream>>>(maps, a);
  return cudaGetLastError();
}

// Blocks an SM, measured on the H100 (PERF.md): one consumer
// warpgroup a block beat two, since a block's latency chain is long and
// more, smaller blocks overlap better; K2 fits three blocks an SM, K3
// (five 32-register accumulators) two: at three it spills and ptxas
// serialises its products. D > 64 doubles the accumulators: one block.
cudaError_t launch_bf16(bool dq, int B, const Args& a, cudaStream_t s) {
  if (a.D > 64)
    return dq ? launch_sm90(bwd_dq_sm90_kernel<2, 1>, WLayout<2>::BYTES,
                            THREADS, a.Sq, B, false, a, s)
              : launch_sm90(bwd_dkv_sm90_kernel<2, 1>, WLayout<2>::BYTES,
                            THREADS, a.Skv, B, false, a, s);
  return dq ? launch_sm90(bwd_dq_sm90_kernel<1, 3>, WLayout<1>::BYTES,
                          THREADS, a.Sq, B, false, a, s)
            : launch_sm90(bwd_dkv_sm90_kernel<1, 2>, WLayout<1>::BYTES,
                          THREADS, a.Skv, B, false, a, s);
}

// The f32 kernels: two blocks an SM at D <= 64 (~100 KB of shared memory
// each, 8 warps an SM: up to 255 registers a thread), one above (~196 KB).
cudaError_t launch_f32(bool dq, int B, const Args& a, cudaStream_t s) {
  if (a.D > 64)
    return dq ? launch_sm90(bwd_dq_tf32x3_kernel<2, 1>, FLayout<2>::BYTES,
                            F_THREADS, a.Sq, B, true, a, s)
              : launch_sm90(bwd_dkv_tf32x3_kernel<2, 1>, FLayout<2>::BYTES,
                            F_THREADS, a.Skv, B, true, a, s);
  return dq ? launch_sm90(bwd_dq_tf32x3_kernel<1, 2>, FLayout<1>::BYTES,
                          F_THREADS, a.Sq, B, true, a, s)
            : launch_sm90(bwd_dkv_tf32x3_kernel<1, 2>, FLayout<1>::BYTES,
                          F_THREADS, a.Skv, B, true, a, s);
}

// Validates the arguments shared by both entry points and fills `a`.
// Returns cudaSuccess, or the error the entry point reports.
cudaError_t prepare(Args& a, int dtype, int B, int H, int Sq, int Skv,
                    int D, const long long* strides, float scale) {
  if (D <= 0 || D > MAX_D || D % 8 != 0 || B > 65535 || H > 65535 ||
      (dtype != 0 && dtype != 1) || a.m == nullptr || a.l == nullptr ||
      a.delta == nullptr)
    return cudaErrorInvalidValue;
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
// o and dout need 16-byte aligned pointers and strides that are multiples
// of 16 bytes, positive on every dim longer than 1 (the TMA maps carry
// them). Each launches on `stream`, allocates nothing and returns
// cudaGetLastError() (or cudaErrorInvalidValue / cudaErrorMisalignedAddress
// for arguments the kernels do not take).

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
  const int eb = dtype == 1 ? 2 : 4;
  if (!aligned16(q, a.st.q, eb) || !aligned16(k, a.st.k, eb) ||
      !aligned16(v, a.st.v, eb) || !aligned16(o, a.st.o, eb) ||
      !aligned16(dout, a.st.dout, eb))
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

// Dynamic shared memory of a K2 or K3 block at head dim D (both kernels
// share the layout), bf16 (dtype 1) or f32 (0), for reports.
int mmf_flash_attention_bwd_smem_bytes(int D, int dtype) {
  if (dtype == 0) return D <= 64 ? FLayout<1>::BYTES : FLayout<2>::BYTES;
  return D <= 64 ? WLayout<1>::BYTES : WLayout<2>::BYTES;
}

const char* mmf_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
