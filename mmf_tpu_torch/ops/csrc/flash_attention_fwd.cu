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
// What bounds it on the H100: at the main path's shape (B<=64, H=12,
// S=228, D=64) attention is ~4*S*S*D FLOPs per (b, h) against ~4*S*D
// elements of q/k/v/o, i.e. ~S FLOPs per element: compute dominates and
// the [S, S] score matrix is the traffic to avoid. Design:
//   - one block per (b, h, 64-row q tile); it loops over 64-column kv
//     tiles held in shared memory, so scores never reach device memory;
//   - the running row max m, normalizer l and output accumulator stay in
//     registers, in f32, for the whole kv loop;
//   - bfloat16 inputs multiply on the tensor cores (mma.sync m16n8k16,
//     f32 accumulation): each of 4 warps owns 16 q rows; the q k^T
//     accumulator fragments hold the scores for the f32 online softmax
//     and are repacked in place, rounded to bf16 (as the plain version
//     rounds probabilities to v's dtype), as the A operand of p v;
//   - float32 inputs multiply with plain f32 FMAs (a 4x4 register tile
//     per thread for q k^T, 4 x D/16 for p v), to keep f32 parity;
//   - wgmma, TMA and warp specialisation are later work;
//   - the additive bias is read in f32 through its own strides: stride 0
//     broadcasts a [B,1,1,Skv] padding-mask row over heads and q rows
//     without materialising [B,H,Sq,Skv];
//   - ragged q rows and kv columns are masked in the kernel: columns past
//     Skv are excluded exactly (score -inf), the same meaning as the true
//     -inf padding of the TPU kernel, and no padded copies are made.
// q/k/v/o are addressed through (batch, head, seq) strides with a
// contiguous head dim, so the [B,S,H,D] -> [B,H,S,D] view of a projection
// output is read in place and the output can be written straight into the
// [B,S,H,D] layout the next projection wants.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (mmf_tpu_torch/ops/_build.py); plain C entry
//        point loaded with ctypes.

#include <math.h>

#include "flash_attention_common.cuh"

namespace {

using namespace mmf_flash;
constexpr int BQ = 64;  // q rows per block
constexpr int BK = 64;  // kv columns per shared-memory tile
constexpr int MAX_D = 128;

struct Strides {
  long long q[3], k[3], v[3], o[3], bias[3];  // (batch, head, seq)
};

// ---------------------------------------------------------------------------
// float32: FMA kernel, 256 threads = 16 x 16, thread (ty, tx) owns q rows
// ty + 16 i and kv columns / output columns tx + 16 j
// ---------------------------------------------------------------------------
constexpr int F_THREADS = 256;
constexpr int F_LD = 65;  // padded row length of the [*, 64] f32 tiles

size_t f32_smem_bytes(int d) {
  // q^T [D][F_LD], k^T [D][F_LD], v [BK][D], p [BQ][F_LD]
  return sizeof(float) *
         (size_t(2) * d * F_LD + size_t(BK) * d + size_t(BQ) * F_LD);
}

// NJ = ceil(D / 16): output columns per thread.
template <int NJ>
__global__ void __launch_bounds__(F_THREADS)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ bias, float* __restrict__ o,
                     float* __restrict__ m_out, float* __restrict__ l_out,
                     int Sq, int Skv, int D, float scale, Strides st,
                     bool raw) {
  extern __shared__ float smem[];
  float* qt = smem;          // [D][F_LD]: q^T * scale
  float* kt = qt + D * F_LD;  // [D][F_LD]: k^T
  float* vs = kt + D * F_LD;  // [BK][D]
  float* ps = vs + BK * D;    // [BQ][F_LD]: probabilities of this tile

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  const float* qb = q + b * st.q[0] + h * st.q[1];
  const float* kb = k + b * st.k[0] + h * st.k[1];
  const float* vb = v + b * st.v[0] + h * st.v[1];
  float* ob = o + b * st.o[0] + h * st.o[1];
  const float* bb =
      bias == nullptr ? nullptr : bias + b * st.bias[0] + h * st.bias[1];

  for (int idx = tid; idx < BQ * D; idx += F_THREADS) {
    const int r = idx / D, d = idx - (idx / D) * D;
    const int s = q0 + r;
    qt[d * F_LD + r] = s < Sq ? qb[s * st.q[2] + d] * scale : 0.f;
  }

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  for (int kv0 = 0; kv0 < Skv; kv0 += BK) {
    __syncthreads();  // previous tile's kt/vs/ps fully consumed
    for (int idx = tid; idx < BK * D; idx += F_THREADS) {
      const int c = idx / D, d = idx - (idx / D) * D;
      const int s = kv0 + c;
      const bool in = s < Skv;
      kt[d * F_LD + c] = in ? kb[s * st.k[2] + d] : 0.f;
      vs[c * D + d] = in ? vb[s * st.v[2] + d] : 0.f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qt[d * F_LD + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = kt[d * F_LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(a[i], bk[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = kv0 + tx + 16 * j;
        if (c >= Skv) {
          sc[i][j] = -INFINITY;  // outside the sequence: excluded exactly
        } else if (bb != nullptr && r < Sq) {
          sc[i][j] += bb[r * st.bias[2] + c];
        }
        mx = fmaxf(mx, sc[i][j]);
      }
      mx = max_xor(mx, 16);  // the 16 lanes of a half-warp share a row
      const float m_new = fmaxf(m[i], mx);
      // a row with no finite score yet keeps p = 0 instead of NaN
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = expf(m[i] - m_use);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(sc[i][j] - m_use);
        rs += p;
        ps[(ty + 16 * i) * F_LD + tx + 16 * j] = p;
      }
      rs = sum_xor(rs, 16);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    const int n_cols = min(BK, Skv - kv0);
#pragma unroll 4
    for (int c = 0; c < n_cols; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(ty + 16 * i) * F_LD + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int d = tx + 16 * j;
        if (d < D) {
          const float vv = vs[c * D + d];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= Sq) continue;
    // raw form: the unnormalized accumulator; l == 0: zeros
    const float inv = raw ? 1.f : l[i] > 0.f ? 1.f / l[i] : 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) ob[r * st.o[2] + d] = acc[i][j] * inv;
    }
    if (m_out != nullptr && tx == 0) {  // the 16 lanes of a row agree
      const long long idx = ((long long)b * gridDim.y + h) * Sq + r;
      m_out[idx] = raw ? m[i] : l[i] > 0.f ? m[i] : 0.f;
      l_out[idx] = raw ? l[i] : l[i] > 0.f ? l[i] : 1.f;
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16: tensor-core kernel on mma.sync m16n8k16 (bf16 in, f32 out).
// 4 warps; warp w owns q rows 16 w .. 16 w + 15. In the PTX fragment
// layouts, lane (g = lane / 4, t = lane % 4) holds rows g and g + 8 of
// every 16-row tile, at columns 2 t, 2 t + 1 of each 8-column slice, so
// row statistics reduce over the 4 lanes of a group, and the score
// accumulator of q k^T is reused in place as the A operand of p v.
// ---------------------------------------------------------------------------
constexpr int T_WARPS = 4;
constexpr int T_THREADS = 32 * T_WARPS;
constexpr int V_LD = BK + 8;  // row length of the transposed v tile

template <int NK>
size_t bf16_smem_bytes() {
  // q [BQ][16 NK + 8], k [BK][16 NK + 8], v^T [16 NK][V_LD]
  return sizeof(bf16) *
         (size_t(BQ + BK) * (16 * NK + 8) + size_t(16 * NK) * V_LD);
}

// NK = ceil(D / 16): 16-wide slices of the head dim (zero-padded in
// shared memory when D is an odd multiple of 8).
template <int NK>
__global__ void __launch_bounds__(T_THREADS)
flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v,
                      const float* __restrict__ bias, bf16* __restrict__ o,
                      float* __restrict__ m_out, float* __restrict__ l_out,
                      int Sq, int Skv, int D, float scale, Strides st,
                      float* __restrict__ acc_out) {
  constexpr int DP = 16 * NK;
  constexpr int LDH = DP + 8;  // padded rows: conflict-free fragment loads
  constexpr int VEC = DP / 8;  // 16-byte vectors per padded row
  constexpr int NS = BK / 8;   // 8-column score slices per kv tile
  constexpr int NO = 2 * NK;   // 8-column output slices
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [BQ][LDH]
  bf16* ks = qs + BQ * LDH;                      // [BK][LDH]
  bf16* vt = ks + BK * LDH;                      // [DP][V_LD]: v^T

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const bf16* qb = q + b * st.q[0] + h * st.q[1];
  const bf16* kb = k + b * st.k[0] + h * st.k[1];
  const bf16* vb = v + b * st.v[0] + h * st.v[1];
  bf16* ob = o + b * st.o[0] + h * st.o[1];
  const int rq = warp * 16 + g;  // this lane's rows: rq and rq + 8
  const int qrow[2] = {q0 + rq, q0 + rq + 8};
  const float* brow[2];
  for (int i = 0; i < 2; ++i)
    brow[i] = (bias != nullptr && qrow[i] < Sq)
                  ? bias + b * st.bias[0] + h * st.bias[1] +
                        qrow[i] * st.bias[2]
                  : nullptr;

  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int idx = threadIdx.x; idx < BQ * VEC; idx += T_THREADS) {
    const int rr = idx / VEC, c8 = (idx % VEC) * 8;
    const int s = q0 + rr;
    *reinterpret_cast<uint4*>(qs + rr * LDH + c8) =
        (s < Sq && c8 < D)
            ? *reinterpret_cast<const uint4*>(qb + s * st.q[2] + c8)
            : zero;
  }
  __syncthreads();
  uint32_t qf[NK][4];  // A fragments of this warp's 16 q rows
#pragma unroll
  for (int kc = 0; kc < NK; ++kc) {
    const bf16* p = qs + rq * LDH + 16 * kc + 2 * t;
    qf[kc][0] = ld_pair(p);
    qf[kc][1] = ld_pair(p + 8 * LDH);
    qf[kc][2] = ld_pair(p + 8);
    qf[kc][3] = ld_pair(p + 8 * LDH + 8);
  }

  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int kv0 = 0; kv0 < Skv; kv0 += BK) {
    __syncthreads();  // every warp is done with the previous ks/vt
    for (int idx = threadIdx.x; idx < BK * VEC; idx += T_THREADS) {
      const int rr = idx / VEC, c8 = (idx % VEC) * 8;
      const int s = kv0 + rr;
      *reinterpret_cast<uint4*>(ks + rr * LDH + c8) =
          (s < Skv && c8 < D)
              ? *reinterpret_cast<const uint4*>(kb + s * st.k[2] + c8)
              : zero;
    }
    for (int idx = threadIdx.x; idx < BK * VEC; idx += T_THREADS) {
      // kv fastest, so neighbouring lanes store neighbouring columns
      const int rr = idx % BK, c8 = (idx / BK) * 8;
      const int s = kv0 + rr;
      uint4 val = (s < Skv && c8 < D)
                      ? *reinterpret_cast<const uint4*>(vb + s * st.v[2] + c8)
                      : zero;
      const bf16* e = reinterpret_cast<const bf16*>(&val);
#pragma unroll
      for (int i = 0; i < 8; ++i) vt[(c8 + i) * V_LD + rr] = e[i];
    }
    __syncthreads();

    // scores: 16 rows x 64 kv columns, f32 in registers
    float sc[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < NK; ++kc) {
        const bf16* p = ks + (8 * j + g) * LDH + 16 * kc + 2 * t;
        const uint32_t bk[2] = {ld_pair(p), ld_pair(p + 8)};
        mma_16816(sc[j], qf[kc], bk);
      }
    }

    // online softmax over this tile for rows rq (i = 0) and rq + 8 (i = 1)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, kc = kv0 + 8 * j + 2 * t + (e & 1);
        float s = sc[j][e] * scale;
        if (kc >= Skv) {
          s = -INFINITY;  // outside the sequence: excluded exactly
        } else if (brow[i] != nullptr) {
          s += brow[i][kc];
        }
        sc[j][e] = s;
        mx[i] = fmaxf(mx[i], s);
      }
    float alpha[2], m_use[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = max_xor(mx[i], 4);  // the 4 lanes of a group share the row
      const float m_new = fmaxf(m[i], mx[i]);
      // a row with no finite score yet keeps p = 0 instead of NaN
      m_use[i] = m_new == -INFINITY ? 0.f : m_new;
      alpha[i] = expf(m[i] - m_use[i]);
      m[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(sc[j][e] - m_use[e >> 1]);
        sc[j][e] = p;
        rs[e >> 1] += p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + sum_xor(rs[i], 4);
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }

    // p v: probabilities rounded to bf16 (as the plain version rounds
    // them to v's dtype), straight from the score registers
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      const uint32_t pa[4] = {
          pack_bf16(sc[2 * kc][0], sc[2 * kc][1]),
          pack_bf16(sc[2 * kc][2], sc[2 * kc][3]),
          pack_bf16(sc[2 * kc + 1][0], sc[2 * kc + 1][1]),
          pack_bf16(sc[2 * kc + 1][2], sc[2 * kc + 1][3])};
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        if (8 * j >= D) continue;  // padding slice of an odd-8 head dim
        const bf16* p = vt + (8 * j + g) * V_LD + 16 * kc + 2 * t;
        const uint32_t bv[2] = {ld_pair(p), ld_pair(p + 8)};
        mma_16816(acc[j], pa, bv);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (qrow[i] >= Sq) continue;
    if (acc_out != nullptr) {  // raw form: f32 accumulator, raw m and l
      float* arow = acc_out + b * st.o[0] + h * st.o[1] + qrow[i] * st.o[2];
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        const int d = 8 * j + 2 * t;
        if (d < D)
          *reinterpret_cast<float2*>(arow + d) =
              make_float2(acc[j][2 * i], acc[j][2 * i + 1]);
      }
      if (t == 0) {
        const long long idx = ((long long)b * gridDim.y + h) * Sq + qrow[i];
        m_out[idx] = m[i];
        l_out[idx] = l[i];
      }
      continue;
    }
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;  // l == 0: zeros
    bf16* orow = ob + qrow[i] * st.o[2];
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      const int d = 8 * j + 2 * t;
      if (d < D)
        *reinterpret_cast<__nv_bfloat162*>(orow + d) = __floats2bfloat162_rn(
            acc[j][2 * i] * inv, acc[j][2 * i + 1] * inv);
    }
    if (m_out != nullptr && t == 0) {  // the 4 lanes of a group agree
      const long long idx = ((long long)b * gridDim.y + h) * Sq + qrow[i];
      m_out[idx] = l[i] > 0.f ? m[i] : 0.f;
      l_out[idx] = l[i] > 0.f ? l[i] : 1.f;
    }
  }
}

template <int NJ>
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       const void* bias, void* o, float* m_out,
                       float* l_out, int B, int H, int Sq, int Skv, int D,
                       float scale, const Strides& st, bool raw,
                       cudaStream_t stream) {
  const size_t smem = f32_smem_bytes(D);
  auto kernel = flash_fwd_f32_kernel<NJ>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kernel<<<grid, F_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(bias),
      static_cast<float*>(o), m_out, l_out, Sq, Skv, D, scale, st, raw);
  return cudaGetLastError();
}

template <int NK>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        const void* bias, void* o, float* m_out,
                        float* l_out, int B, int H, int Sq, int Skv, int D,
                        float scale, const Strides& st, bool raw,
                        cudaStream_t stream) {
  const size_t smem = bf16_smem_bytes<NK>();
  auto kernel = flash_fwd_bf16_kernel<NK>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kernel<<<grid, T_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const float*>(bias),
      raw ? nullptr : static_cast<bf16*>(o), m_out, l_out, Sq, Skv, D, scale,
      st, raw ? static_cast<float*>(o) : nullptr);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o share it); bias is
// float32 or null. strides: 15 element strides, (batch, head, seq) for
// q, k, v, o and bias in that order; the head dim is contiguous in all.
// m_out / l_out: both null (inference form) or both contiguous float32
// [B, H, Sq] (stats form).
// bfloat16 q/k/v need 16-byte aligned pointers and strides that are
// multiples of 8. Launches on `stream`, allocates nothing, returns
// cudaGetLastError() (or cudaErrorInvalidValue / cudaErrorMisalignedAddress
// for arguments the kernels do not take).
static int forward(const void* q, const void* k, const void* v,
                   const void* bias, void* o, float* m_out, float* l_out,
                   int dtype, int B, int H, int Sq, int Skv, int D,
                   const long long* strides, float scale, bool raw,
                   void* stream) {
  if ((m_out == nullptr) != (l_out == nullptr) || (raw && m_out == nullptr) ||
      D <= 0 || D > MAX_D ||
      D % 8 != 0 || B > 65535 || H > 65535 || (dtype != 0 && dtype != 1))
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n16 = (D + 15) / 16;
  if (dtype == 1) {
    if (!aligned16(q, st.q) || !aligned16(k, st.k) || !aligned16(v, st.v))
      return int(cudaErrorMisalignedAddress);
    switch (n16) {
#define MMF_CASE(n)                                                         \
  case n:                                                                   \
    return int(launch_bf16<n>(q, k, v, bias, o, m_out, l_out, B, H, Sq, Skv, \
                              D, scale, st, raw, s));
      MMF_CASE(1) MMF_CASE(2) MMF_CASE(3) MMF_CASE(4)
      MMF_CASE(5) MMF_CASE(6) MMF_CASE(7) MMF_CASE(8)
#undef MMF_CASE
    }
  } else {
    switch (n16) {
#define MMF_CASE(n)                                                        \
  case n:                                                                  \
    return int(launch_f32<n>(q, k, v, bias, o, m_out, l_out, B, H, Sq, Skv, \
                             D, scale, st, raw, s));
      MMF_CASE(1) MMF_CASE(2) MMF_CASE(3) MMF_CASE(4)
      MMF_CASE(5) MMF_CASE(6) MMF_CASE(7) MMF_CASE(8)
#undef MMF_CASE
    }
  }
  return int(cudaErrorInvalidValue);
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

const char* mmf_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
