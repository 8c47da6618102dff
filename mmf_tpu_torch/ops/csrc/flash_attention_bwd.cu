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
// against ~6*S*D elements read: a few hundred FLOPs per byte, so tensor-
// core throughput, and the [S, S] tiles kept out of device memory, decide.
// Design (the forward's, with the same fragment tricks):
//   - bfloat16: mma.sync m16n8k16 (bf16 in, f32 accumulate), 4 warps of 16
//     rows. K2 keeps its q and dO fragments in registers for the whole kv
//     loop; scores and dO v^T are f32 accumulators, turned into ds in
//     registers and repacked in place, rounded to bf16, as the A operand of
//     ds k. K3 does the same with the roles of q and kv swapped, its k and
//     v fragments read from shared memory, and both p^T and ds^T repacked
//     as A operands of p^T dO and ds^T q.
//   - Each product needs its B operand contiguous along the reduction, so
//     the tile that a kernel reduces over along the sequence (k in K2, q
//     and dO in K3) is also stored transposed, in shared memory only: no
//     transposed copy is made in device memory.
//   - float32: plain FMAs in a 16 x 16 thread grid (4 x 4 register tiles),
//     as the forward's f32 kernel, to keep f32 parity.
//   - Ragged q rows and kv columns are masked in the kernels; the bias is
//     read in f32 through its strides (0 on broadcast dims); q, k, v, O,
//     dO and the three gradients are addressed through (batch, head, seq)
//     strides, so [B, S, H, D] projection views are read and written in
//     place.
//   - wgmma, TMA, ldmatrix and overlap of loads with compute are later
//     work: this is the first, simple version.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (mmf_tpu_torch/ops/_build.py); plain C entry
//        points loaded with ctypes.

#include <math.h>

#include "flash_attention_common.cuh"

namespace {

using namespace mmf_flash;

constexpr int BQ = 64;  // q rows per tile
constexpr int BK = 64;  // kv rows per tile
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
// float32: FMA kernels, 256 threads = 16 x 16; thread (ty, tx) owns tile
// rows ty + 16 i and columns tx + 16 j (i, j < 4) of the score tile, and
// rows ty + 16 i, head-dim columns tx + 16 j (j < NJ) of its gradients.
// ---------------------------------------------------------------------------
constexpr int F_THREADS = 256;
constexpr int F_LD = BQ + 1;  // padded row length of [*][64] f32 tiles

size_t dq_f32_smem_bytes(int d) {
  // q^T * scale [D][F_LD], dO^T [D][F_LD], k [BK][D+1], v [BK][D+1],
  // ds [BQ][F_LD]
  return sizeof(float) * (size_t(2) * d * F_LD + size_t(2) * BK * (d + 1) +
                          size_t(BQ) * F_LD);
}

size_t dkv_f32_smem_bytes(int d) {
  // k^T [D][F_LD], v^T [D][F_LD], q * scale [BQ][D+1], dO [BQ][D+1],
  // p^T [BK][F_LD], ds^T [BK][F_LD]
  return sizeof(float) * (size_t(2) * d * F_LD + size_t(2) * BQ * (d + 1) +
                          size_t(2) * BK * F_LD);
}

template <int NJ>
__global__ void __launch_bounds__(F_THREADS) bwd_dq_f32_kernel(Args a) {
  extern __shared__ float smem[];
  __shared__ float m_s[BQ], li_s[BQ], dl_s[BQ];
  const int D = a.D, LDR = D + 1;
  float* qt = smem;             // [D][F_LD]: q^T * scale
  float* dot = qt + D * F_LD;   // [D][F_LD]: dO^T
  float* ks = dot + D * F_LD;   // [BK][LDR]
  float* vs = ks + BK * LDR;    // [BK][LDR]
  float* dss = vs + BK * LDR;   // [BQ][F_LD]: ds of this tile

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const Strides& st = a.st;
  const float* qb = static_cast<const float*>(a.q) + b * st.q[0] + h * st.q[1];
  const float* kb = static_cast<const float*>(a.k) + b * st.k[0] + h * st.k[1];
  const float* vb = static_cast<const float*>(a.v) + b * st.v[0] + h * st.v[1];
  const float* ob = static_cast<const float*>(a.o) + b * st.o[0] + h * st.o[1];
  const float* dob =
      static_cast<const float*>(a.dout) + b * st.dout[0] + h * st.dout[1];
  float* dqb = static_cast<float*>(a.dq) + b * st.dq[0] + h * st.dq[1];
  const float* bb =
      a.bias == nullptr ? nullptr : a.bias + b * st.bias[0] + h * st.bias[1];
  const long long so = ((long long)b * a.H + h) * a.Sq;

  for (int idx = tid; idx < BQ * D; idx += F_THREADS) {
    const int r = idx / D, d = idx - (idx / D) * D;
    const int s = q0 + r;
    const bool in = s < a.Sq;
    qt[d * F_LD + r] = in ? qb[s * st.q[2] + d] * a.scale : 0.f;
    dot[d * F_LD + r] = in ? dob[s * st.dout[2] + d] : 0.f;
  }
  // delta = rowsum(dO * O): warp w reduces rows 8 w .. 8 w + 7
  for (int rr = 0; rr < BQ / 8; ++rr) {
    const int r = warp * (BQ / 8) + rr, s = q0 + r;
    float acc = 0.f;
    if (s < a.Sq)
      for (int d = lane; d < D; d += 32)
        acc += dob[s * st.dout[2] + d] * ob[s * st.o[2] + d];
    acc = sum_xor(acc, 32);
    if (lane == 0) {
      const bool in = s < a.Sq;
      dl_s[r] = in ? acc : 0.f;
      m_s[r] = in ? a.m[so + s] : 0.f;
      li_s[r] = in ? 1.f / a.l[so + s] : 1.f;
      if (in) a.delta[so + s] = acc;
    }
  }
  __syncthreads();
  float mr[4], lir[4], dr[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    mr[i] = m_s[ty + 16 * i];
    lir[i] = li_s[ty + 16 * i];
    dr[i] = dl_s[ty + 16 * i];
  }

  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  for (int kv0 = 0; kv0 < a.Skv; kv0 += BK) {
    __syncthreads();  // previous tile's ks/vs/dss fully consumed
    for (int idx = tid; idx < BK * D; idx += F_THREADS) {
      const int c = idx / D, d = idx - (idx / D) * D;
      const int s = kv0 + c;
      const bool in = s < a.Skv;
      ks[c * LDR + d] = in ? kb[s * st.k[2] + d] : 0.f;
      vs[c * LDR + d] = in ? vb[s * st.v[2] + d] : 0.f;
    }
    __syncthreads();

    float sc[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; ++d) {
      float aq[4], ado[4], bk[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        aq[i] = qt[d * F_LD + ty + 16 * i];
        ado[i] = dot[d * F_LD + ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        bk[j] = ks[(tx + 16 * j) * LDR + d];
        bv[j] = vs[(tx + 16 * j) * LDR + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sc[i][j] = fmaf(aq[i], bk[j], sc[i][j]);
          dp[i][j] = fmaf(ado[i], bv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = kv0 + tx + 16 * j;
        float s = sc[i][j];
        if (c >= a.Skv) {
          s = -INFINITY;  // outside the sequence: p = 0
        } else if (bb != nullptr && r < a.Sq) {
          s += bb[r * st.bias[2] + c];
        }
        const float p = expf(s - mr[i]) * lir[i];
        dss[(ty + 16 * i) * F_LD + tx + 16 * j] = p * (dp[i][j] - dr[i]);
      }
    }
    __syncthreads();

    const int n_cols = min(BK, a.Skv - kv0);
#pragma unroll 4
    for (int c = 0; c < n_cols; ++c) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = dss[(ty + 16 * i) * F_LD + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int d = tx + 16 * j;
        if (d < D) {
          const float kv = ks[c * LDR + d];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(ds[i], kv, acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= a.Sq) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) dqb[r * st.dq[2] + d] = acc[i][j] * a.scale;
    }
  }
}

template <int NJ>
__global__ void __launch_bounds__(F_THREADS) bwd_dkv_f32_kernel(Args a) {
  extern __shared__ float smem[];
  __shared__ float m_s[BQ], li_s[BQ], dl_s[BQ];
  const int D = a.D, LDR = D + 1;
  float* kt = smem;            // [D][F_LD]: k^T
  float* vt = kt + D * F_LD;   // [D][F_LD]: v^T
  float* qs = vt + D * F_LD;   // [BQ][LDR]: q * scale
  float* dos = qs + BQ * LDR;  // [BQ][LDR]: dO
  float* pt = dos + BQ * LDR;  // [BK][F_LD]: p^T of this tile
  float* dst = pt + BK * F_LD;  // [BK][F_LD]: ds^T of this tile

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int kv0 = blockIdx.x * BK, h = blockIdx.y, b = blockIdx.z;
  const Strides& st = a.st;
  const float* qb = static_cast<const float*>(a.q) + b * st.q[0] + h * st.q[1];
  const float* kb = static_cast<const float*>(a.k) + b * st.k[0] + h * st.k[1];
  const float* vb = static_cast<const float*>(a.v) + b * st.v[0] + h * st.v[1];
  const float* dob =
      static_cast<const float*>(a.dout) + b * st.dout[0] + h * st.dout[1];
  float* dkb = static_cast<float*>(a.dk) + b * st.dk[0] + h * st.dk[1];
  float* dvb = static_cast<float*>(a.dv) + b * st.dv[0] + h * st.dv[1];
  const float* bb =
      a.bias == nullptr ? nullptr : a.bias + b * st.bias[0] + h * st.bias[1];
  const long long so = ((long long)b * a.H + h) * a.Sq;

  for (int idx = tid; idx < BK * D; idx += F_THREADS) {
    const int c = idx / D, d = idx - (idx / D) * D;
    const int s = kv0 + c;
    const bool in = s < a.Skv;
    kt[d * F_LD + c] = in ? kb[s * st.k[2] + d] : 0.f;
    vt[d * F_LD + c] = in ? vb[s * st.v[2] + d] : 0.f;
  }

  float dk[4][NJ], dv[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dk[i][j] = dv[i][j] = 0.f;

  for (int q0 = 0; q0 < a.Sq; q0 += BQ) {
    __syncthreads();  // previous tile's qs/dos/pt/dst fully consumed
    for (int idx = tid; idx < BQ * D; idx += F_THREADS) {
      const int r = idx / D, d = idx - (idx / D) * D;
      const int s = q0 + r;
      const bool in = s < a.Sq;
      qs[r * LDR + d] = in ? qb[s * st.q[2] + d] * a.scale : 0.f;
      dos[r * LDR + d] = in ? dob[s * st.dout[2] + d] : 0.f;
    }
    if (tid < BQ) {
      const int s = q0 + tid;
      const bool in = s < a.Sq;
      m_s[tid] = in ? a.m[so + s] : 0.f;
      li_s[tid] = in ? 1.f / a.l[so + s] : 1.f;
      dl_s[tid] = in ? a.delta[so + s] : 0.f;
    }
    __syncthreads();

    // s^T and (dO v^T)^T: rows = kv (ty + 16 i), columns = q (tx + 16 j)
    float sc[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; ++d) {
      float ak[4], av[4], bq[4], bdo[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ak[i] = kt[d * F_LD + ty + 16 * i];
        av[i] = vt[d * F_LD + ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        bq[j] = qs[(tx + 16 * j) * LDR + d];
        bdo[j] = dos[(tx + 16 * j) * LDR + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sc[i][j] = fmaf(ak[i], bq[j], sc[i][j]);
          dp[i][j] = fmaf(av[i], bdo[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = kv0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int rl = tx + 16 * j, r = q0 + rl;
        float p = 0.f;  // outside either sequence
        if (r < a.Sq && c < a.Skv) {
          float s = sc[i][j];
          if (bb != nullptr) s += bb[r * st.bias[2] + c];
          p = expf(s - m_s[rl]) * li_s[rl];
        }
        pt[(ty + 16 * i) * F_LD + rl] = p;
        dst[(ty + 16 * i) * F_LD + rl] = p * (dp[i][j] - dl_s[rl]);
      }
    }
    __syncthreads();

    const int n_rows = min(BQ, a.Sq - q0);
#pragma unroll 4
    for (int r = 0; r < n_rows; ++r) {
      float p[4], ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        p[i] = pt[(ty + 16 * i) * F_LD + r];
        ds[i] = dst[(ty + 16 * i) * F_LD + r];
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int d = tx + 16 * j;
        if (d < D) {
          const float qv = qs[r * LDR + d], dov = dos[r * LDR + d];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dv[i][j] = fmaf(p[i], dov, dv[i][j]);
            dk[i][j] = fmaf(ds[i], qv, dk[i][j]);  // qs holds q * scale
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = kv0 + ty + 16 * i;
    if (c >= a.Skv) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) {
        dkb[c * st.dk[2] + d] = dk[i][j];
        dvb[c * st.dv[2] + d] = dv[i][j];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16: tensor-core kernels on mma.sync m16n8k16, 4 warps; warp w owns
// the tile rows 16 w .. 16 w + 15 (q rows in K2, kv rows in K3); a lane
// holds rows g and g + 8 of them (fragment layouts in the common header).
// ---------------------------------------------------------------------------
constexpr int T_WARPS = 4;
constexpr int T_THREADS = 32 * T_WARPS;
constexpr int T_LD = 64 + 8;  // row length of a transposed [D][64] tile

template <int NK>
size_t dq_bf16_smem_bytes() {
  // q, dO [BQ][16 NK + 8]; k, v [BK][16 NK + 8]; k^T [16 NK][T_LD]
  return sizeof(bf16) * (size_t(2 * BQ + 2 * BK) * (16 * NK + 8) +
                         size_t(16 * NK) * T_LD);
}

template <int NK>
size_t dkv_bf16_smem_bytes() {
  // k, v [BK][16 NK + 8]; q, dO [BQ][16 NK + 8]; q^T, dO^T [16 NK][T_LD]
  return sizeof(bf16) * (size_t(2 * BK + 2 * BQ) * (16 * NK + 8) +
                         size_t(2 * 16 * NK) * T_LD);
}

// rows [row0, row0 + n) of a (seq, D) bf16 matrix at `src` (row stride
// `ld`) into `dst` [n][LDH], zero outside the sequence and the head dim;
// with `dst_t` non-null also transposed into dst_t [DP][T_LD].
template <int DP, int LDH>
__device__ __forceinline__ void load_tile(bf16* dst, bf16* dst_t,
                                          const bf16* src, long long ld,
                                          int row0, int n_seq, int D) {
  constexpr int VEC = DP / 8;  // 16-byte vectors per padded row
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int idx = threadIdx.x; idx < 64 * VEC; idx += T_THREADS) {
    // rows fastest, so neighbouring lanes store neighbouring columns of
    // the transposed tile
    const int rr = idx % 64, c8 = (idx / 64) * 8;
    const int s = row0 + rr;
    const uint4 val = (s < n_seq && c8 < D)
                          ? *reinterpret_cast<const uint4*>(src + s * ld + c8)
                          : zero;
    *reinterpret_cast<uint4*>(dst + rr * LDH + c8) = val;
    if (dst_t != nullptr) {
      const bf16* e = reinterpret_cast<const bf16*>(&val);
#pragma unroll
      for (int i = 0; i < 8; ++i) dst_t[(c8 + i) * T_LD + rr] = e[i];
    }
  }
}

template <int NK>
__global__ void __launch_bounds__(T_THREADS) bwd_dq_bf16_kernel(Args a) {
  constexpr int DP = 16 * NK;
  constexpr int LDH = DP + 8;  // padded rows: conflict-free fragment loads
  constexpr int NS = BK / 8;   // 8-column score slices per kv tile
  constexpr int NO = 2 * NK;   // 8-column output slices
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float m_s[BQ], li_s[BQ], dl_s[BQ];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [BQ][LDH]
  bf16* dos = qs + BQ * LDH;                     // [BQ][LDH]
  bf16* ks = dos + BQ * LDH;                     // [BK][LDH]
  bf16* vs = ks + BK * LDH;                      // [BK][LDH]
  bf16* kt = vs + BK * LDH;                      // [DP][T_LD]: k^T

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int D = a.D;
  const Strides& st = a.st;
  const bf16* qb = static_cast<const bf16*>(a.q) + b * st.q[0] + h * st.q[1];
  const bf16* kb = static_cast<const bf16*>(a.k) + b * st.k[0] + h * st.k[1];
  const bf16* vb = static_cast<const bf16*>(a.v) + b * st.v[0] + h * st.v[1];
  const bf16* ob = static_cast<const bf16*>(a.o) + b * st.o[0] + h * st.o[1];
  const bf16* dob =
      static_cast<const bf16*>(a.dout) + b * st.dout[0] + h * st.dout[1];
  bf16* dqb = static_cast<bf16*>(a.dq) + b * st.dq[0] + h * st.dq[1];
  const long long so = ((long long)b * a.H + h) * a.Sq;

  load_tile<DP, LDH>(qs, nullptr, qb, st.q[2], q0, a.Sq, D);
  load_tile<DP, LDH>(dos, nullptr, dob, st.dout[2], q0, a.Sq, D);
  // delta = rowsum(dO * O) in f32: warp w reduces rows 16 w .. 16 w + 15
  for (int rr = 0; rr < 16; ++rr) {
    const int r = warp * 16 + rr, s = q0 + r;
    float acc = 0.f;
    if (s < a.Sq)
      for (int d = lane; d < D; d += 32)
        acc += __bfloat162float(dob[s * st.dout[2] + d]) *
               __bfloat162float(ob[s * st.o[2] + d]);
    acc = sum_xor(acc, 32);
    if (lane == 0) {
      const bool in = s < a.Sq;
      dl_s[r] = in ? acc : 0.f;
      m_s[r] = in ? a.m[so + s] : 0.f;
      li_s[r] = in ? 1.f / a.l[so + s] : 1.f;
      if (in) a.delta[so + s] = acc;
    }
  }
  __syncthreads();

  const int rq = warp * 16 + g;  // this lane's rows: rq and rq + 8
  const int qrow[2] = {q0 + rq, q0 + rq + 8};
  float mr[2], lir[2], dr[2];
  const float* brow[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mr[i] = m_s[rq + 8 * i];
    lir[i] = li_s[rq + 8 * i];
    dr[i] = dl_s[rq + 8 * i];
    brow[i] = (a.bias != nullptr && qrow[i] < a.Sq)
                  ? a.bias + b * st.bias[0] + h * st.bias[1] +
                        qrow[i] * st.bias[2]
                  : nullptr;
  }
  uint32_t qf[NK][4], dof[NK][4];  // A fragments of this warp's 16 rows
#pragma unroll
  for (int kc = 0; kc < NK; ++kc) {
    load_a(qf[kc], qs + rq * LDH + 16 * kc + 2 * t, LDH);
    load_a(dof[kc], dos + rq * LDH + 16 * kc + 2 * t, LDH);
  }

  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int kv0 = 0; kv0 < a.Skv; kv0 += BK) {
    __syncthreads();  // every warp is done with the previous ks/vs/kt
    load_tile<DP, LDH>(ks, kt, kb, st.k[2], kv0, a.Skv, D);
    load_tile<DP, LDH>(vs, nullptr, vb, st.v[2], kv0, a.Skv, D);
    __syncthreads();

    float sc[NS][4], dp[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
      dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < NK; ++kc) {
        uint32_t bk[2], bv[2];
        load_b(bk, ks + (8 * j + g) * LDH + 16 * kc + 2 * t);
        load_b(bv, vs + (8 * j + g) * LDH + 16 * kc + 2 * t);
        mma_16816(sc[j], qf[kc], bk);
        mma_16816(dp[j], dof[kc], bv);
      }
    }
    // ds = p * (dp - delta), p = exp(s - m) / l, in place of the scores
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, c = kv0 + 8 * j + 2 * t + (e & 1);
        float s = sc[j][e] * a.scale;
        if (c >= a.Skv) {
          s = -INFINITY;  // outside the sequence: p = 0
        } else if (brow[i] != nullptr) {
          s += brow[i][c];
        }
        const float p = expf(s - mr[i]) * lir[i];
        sc[j][e] = p * (dp[j][e] - dr[i]);
      }
    // dq += ds k: ds rounded to bf16, straight from the registers
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      uint32_t da[4];
      pack_a(da, sc[2 * kc], sc[2 * kc + 1]);
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        if (8 * j >= D) continue;  // padding slice of an odd-8 head dim
        uint32_t bk[2];
        load_b(bk, kt + (8 * j + g) * T_LD + 16 * kc + 2 * t);
        mma_16816(acc[j], da, bk);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (qrow[i] >= a.Sq) continue;
    bf16* row = dqb + qrow[i] * st.dq[2];
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      const int d = 8 * j + 2 * t;
      if (d < D)
        *reinterpret_cast<__nv_bfloat162*>(row + d) = __floats2bfloat162_rn(
            acc[j][2 * i] * a.scale, acc[j][2 * i + 1] * a.scale);
    }
  }
}

template <int NK>
__global__ void __launch_bounds__(T_THREADS) bwd_dkv_bf16_kernel(Args a) {
  constexpr int DP = 16 * NK;
  constexpr int LDH = DP + 8;
  constexpr int NS = BQ / 8;  // 8-column (q) slices of the s^T tile
  constexpr int NO = 2 * NK;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float m_s[BQ], li_s[BQ], dl_s[BQ];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // [BK][LDH]
  bf16* vs = ks + BK * LDH;                      // [BK][LDH]
  bf16* qs = vs + BK * LDH;                      // [BQ][LDH]
  bf16* dos = qs + BQ * LDH;                     // [BQ][LDH]
  bf16* qt = dos + BQ * LDH;                     // [DP][T_LD]: q^T
  bf16* dot = qt + DP * T_LD;                    // [DP][T_LD]: dO^T

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kv0 = blockIdx.x * BK, h = blockIdx.y, b = blockIdx.z;
  const int D = a.D;
  const Strides& st = a.st;
  const bf16* qb = static_cast<const bf16*>(a.q) + b * st.q[0] + h * st.q[1];
  const bf16* kb = static_cast<const bf16*>(a.k) + b * st.k[0] + h * st.k[1];
  const bf16* vb = static_cast<const bf16*>(a.v) + b * st.v[0] + h * st.v[1];
  const bf16* dob =
      static_cast<const bf16*>(a.dout) + b * st.dout[0] + h * st.dout[1];
  bf16* dkb = static_cast<bf16*>(a.dk) + b * st.dk[0] + h * st.dk[1];
  bf16* dvb = static_cast<bf16*>(a.dv) + b * st.dv[0] + h * st.dv[1];
  const float* bb =
      a.bias == nullptr ? nullptr : a.bias + b * st.bias[0] + h * st.bias[1];
  const long long so = ((long long)b * a.H + h) * a.Sq;

  load_tile<DP, LDH>(ks, nullptr, kb, st.k[2], kv0, a.Skv, D);
  load_tile<DP, LDH>(vs, nullptr, vb, st.v[2], kv0, a.Skv, D);

  const int rk = warp * 16 + g;  // this lane's kv rows: rk and rk + 8
  const int kvrow[2] = {kv0 + rk, kv0 + rk + 8};
  float dk[NO][4], dv[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  for (int q0 = 0; q0 < a.Sq; q0 += BQ) {
    __syncthreads();  // every warp is done with the previous q tile
    load_tile<DP, LDH>(qs, qt, qb, st.q[2], q0, a.Sq, D);
    load_tile<DP, LDH>(dos, dot, dob, st.dout[2], q0, a.Sq, D);
    if (threadIdx.x < BQ) {
      const int s = q0 + threadIdx.x;
      const bool in = s < a.Sq;
      m_s[threadIdx.x] = in ? a.m[so + s] : 0.f;
      li_s[threadIdx.x] = in ? 1.f / a.l[so + s] : 1.f;
      dl_s[threadIdx.x] = in ? a.delta[so + s] : 0.f;
    }
    __syncthreads();

    // s^T = k q^T and (dO v^T)^T = v dO^T: rows = kv, columns = q
    float sc[NS][4], dp[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < NK; ++kc) {
      uint32_t ka[4], va[4];
      load_a(ka, ks + rk * LDH + 16 * kc + 2 * t, LDH);
      load_a(va, vs + rk * LDH + 16 * kc + 2 * t, LDH);
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        uint32_t bq[2], bdo[2];
        load_b(bq, qs + (8 * j + g) * LDH + 16 * kc + 2 * t);
        load_b(bdo, dos + (8 * j + g) * LDH + 16 * kc + 2 * t);
        mma_16816(sc[j], ka, bq);
        mma_16816(dp[j], va, bdo);
      }
    }
    // p^T in place of s^T, ds^T in place of dp^T
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = kvrow[e >> 1];
        const int rl = 8 * j + 2 * t + (e & 1), r = q0 + rl;
        float p = 0.f;  // outside either sequence
        if (r < a.Sq && c < a.Skv) {
          float s = sc[j][e] * a.scale;
          if (bb != nullptr) s += bb[r * st.bias[2] + c];
          p = expf(s - m_s[rl]) * li_s[rl];
        }
        sc[j][e] = p;
        dp[j][e] = p * (dp[j][e] - dl_s[rl]);
      }
    // dv += p^T dO, dk += ds^T q: A operands straight from the registers
#pragma unroll
    for (int kc = 0; kc < BQ / 16; ++kc) {
      uint32_t pa[4], da[4];
      pack_a(pa, sc[2 * kc], sc[2 * kc + 1]);
      pack_a(da, dp[2 * kc], dp[2 * kc + 1]);
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        if (8 * j >= D) continue;  // padding slice of an odd-8 head dim
        uint32_t bdo[2], bq[2];
        load_b(bdo, dot + (8 * j + g) * T_LD + 16 * kc + 2 * t);
        load_b(bq, qt + (8 * j + g) * T_LD + 16 * kc + 2 * t);
        mma_16816(dv[j], pa, bdo);
        mma_16816(dk[j], da, bq);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (kvrow[i] >= a.Skv) continue;
    bf16* krow = dkb + kvrow[i] * st.dk[2];
    bf16* vrow = dvb + kvrow[i] * st.dv[2];
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      const int d = 8 * j + 2 * t;
      if (d < D) {
        *reinterpret_cast<__nv_bfloat162*>(krow + d) = __floats2bfloat162_rn(
            dk[j][2 * i] * a.scale, dk[j][2 * i + 1] * a.scale);
        *reinterpret_cast<__nv_bfloat162*>(vrow + d) =
            __floats2bfloat162_rn(dv[j][2 * i], dv[j][2 * i + 1]);
      }
    }
  }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, size_t smem, int threads, int n_tiles,
                   int B, const Args& a, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  dim3 grid(n_tiles, a.H, B);
  kernel<<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int N>
cudaError_t launch_dq(int dtype, int B, const Args& a, cudaStream_t s) {
  const int tiles = (a.Sq + BQ - 1) / BQ;
  if (dtype == 1)
    return launch(bwd_dq_bf16_kernel<N>, dq_bf16_smem_bytes<N>(), T_THREADS,
                  tiles, B, a, s);
  return launch(bwd_dq_f32_kernel<N>, dq_f32_smem_bytes(a.D), F_THREADS,
                tiles, B, a, s);
}

template <int N>
cudaError_t launch_dkv(int dtype, int B, const Args& a, cudaStream_t s) {
  const int tiles = (a.Skv + BK - 1) / BK;
  if (dtype == 1)
    return launch(bwd_dkv_bf16_kernel<N>, dkv_bf16_smem_bytes<N>(),
                  T_THREADS, tiles, B, a, s);
  return launch(bwd_dkv_f32_kernel<N>, dkv_f32_smem_bytes(a.D), F_THREADS,
                tiles, B, a, s);
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
// contiguous in all. m, l, delta: contiguous float32 [B, H, Sq]. bfloat16
// inputs need 16-byte aligned pointers and strides that are multiples of
// 8. Each launches on `stream`, allocates nothing and returns
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
  if (dtype == 1 &&
      (!aligned16(q, a.st.q) || !aligned16(k, a.st.k) ||
       !aligned16(v, a.st.v) || !aligned16(dout, a.st.dout)))
    return int(cudaErrorMisalignedAddress);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((D + 15) / 16) {
#define MMF_CASE(n) \
  case n:           \
    return int(launch_dq<n>(dtype, B, a, s));
    MMF_CASE(1) MMF_CASE(2) MMF_CASE(3) MMF_CASE(4)
    MMF_CASE(5) MMF_CASE(6) MMF_CASE(7) MMF_CASE(8)
#undef MMF_CASE
  }
  return int(cudaErrorInvalidValue);
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
  if (dtype == 1 &&
      (!aligned16(q, a.st.q) || !aligned16(k, a.st.k) ||
       !aligned16(v, a.st.v) || !aligned16(dout, a.st.dout)))
    return int(cudaErrorMisalignedAddress);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((D + 15) / 16) {
#define MMF_CASE(n) \
  case n:           \
    return int(launch_dkv<n>(dtype, B, a, s));
    MMF_CASE(1) MMF_CASE(2) MMF_CASE(3) MMF_CASE(4)
    MMF_CASE(5) MMF_CASE(6) MMF_CASE(7) MMF_CASE(8)
#undef MMF_CASE
  }
  return int(cudaErrorInvalidValue);
}

const char* mmf_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
