// LayerNorm backward for Hopper (sm_90a): K4-bwd.
//
// Replaces the backward of the JAX custom_vjp mmf_tpu/ops/layernorm.py::
// _ln_pallas, _ln_pallas_bwd, which takes the VJP of _ln_reference (the
// TPU has no Pallas backward for LayerNorm; the port's first version
// recomputed the plain forward and asked autograd for its VJP, some 30-40
// launches a call). Same function, for y = LayerNorm(x [+ r]) with f32
// statistics and an f32 affine (scale, bias):
//   h = x (+ r) in f32, mean = sum(h) / H, var = sum((h - mean)^2) / H
//   (the forward's two-pass formula), rstd = 1 / sqrt(var + eps),
//   xhat = (h - mean) rstd, g = dy scale,
//   dx = rstd (g - mean(g) - xhat mean(g xhat))   in x's dtype
//   dr = dx (the wrapper returns the same tensor),
//   dscale = sum over rows of dy xhat, dbias = sum over rows of dy   (f32).
//
// What bounds it on the H100: device memory. About 10 operations per
// element against 8 bytes moved in bf16 (x, r, dy read once, dx written
// once): 89.6 MB at [14592, 768] with the residual, 0.027 ms at 3.35 TB/s.
// Design, one launch a call:
//   - a persistent grid, at most as many blocks as the card holds at once
//     (one an SM at the main paths' widths) and one an SM at least
//     whenever there are as many rows, each taking one contiguous run of
//     floor(rows / grid) or ceil(rows / grid) rows: every SM has work
//     until the end, with no pass that runs mostly empty; fewer rows than
//     SMs take a block a tile, up to 16 blocks (the wrapper's
//     bwd_row_plan);
//   - a block is eight consumer warps and one producer warp. The producer
//     streams the run through a ring of shared-memory stages, a tile of
//     eight rows of x, dy and r each, by 1-D bulk copies (TMA without a
//     tensor map: the tile is contiguous) completed on an mbarrier, so two
//     to eight tiles (147 KB at H = 768) are in flight while the
//     consumers work; the first ones start before the block's first
//     barrier, and the scale comes with tile 0;
//   - a consumer warp takes one row of a tile (up to 1024 columns; wider
//     rows take 2, 4 or 8 warps, their partial sums met in shared memory):
//     it copies its columns from the stage into registers (a lane holds its
//     columns as 16-byte vectors, lane l taking vectors l, l + 32, ... so
//     that the reads are conflict-free), hands the stage back to the
//     producer (an mbarrier arrive: the next tile's copy starts before this
//     row's math), then reduces the row by butterfly shuffles and stores
//     dx from registers. The lane adds dy xhat and dy of its columns over
//     its rows in registers: with the loads taken off the warps, one block
//     of nine warps an SM keeps the memory busy, and the registers (168 a
//     thread at nine warps) hold the column sums at H = 768 and 1024 alike
//     (the scale is read from shared memory at each use);
//   - the sums across warps (in warp order, through shared memory) and
//     across blocks are taken inside the kernel in a fixed order: each
//     block writes its f32 row of dscale and dbias partials, and the last
//     block of each group of 16 blocks to finish (a ticket counter) adds
//     its group's rows in block order; the last group to finish adds the
//     groups' rows the same way into dscale and dbias (a grid of up to 16
//     blocks is one group, summed once). The last block resets its
//     counter, so the scratch needs no clearing between calls. No float
//     atomics: two calls give the same bits. At 132 blocks this sum and
//     the launch are the floor of a call at small and middling row counts
//     (PERF.md, where the variants measured slower are: a cluster summing
//     through distributed shared memory, a ticket taken by every block,
//     flags that let the last group add its own rows on the way).
// Any hidden size: rows are laid out with a stride ld, H rounded up to
// whole 16-byte vectors, the columns past H zero (x, r, dy and the scale;
// the wrapper pads a ragged width), and the centred sum of squares masks
// them; those columns of dx and of the partials are never read. Rows wider
// than 8192 take ln_bwd_wide_kernel: one block a row, four passes over the
// row (sum, centred squares, the g sums, dx) that re-read it from L2
// instead of holding it in registers, each thread adding its columns' dy
// xhat and dy into its block's partial rows in place; it ends in the same
// ticketed sum.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (mmf_tpu_torch/ops/_build.py); plain C entry
//        points loaded with ctypes.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace mmf_hopper;

constexpr int kWarps = 8;                    // consumer warps a block
constexpr int kThreads = 32 * (kWarps + 1);  // and the producer warp
constexpr int kWideThreads = 32 * kWarps;    // ln_bwd_wide_kernel's block
constexpr int kMaxHidden = 8192;  // 8 warps x 32 lanes x 32 columns
constexpr int kMaxStages = 8;
constexpr int kRingBytes = 150 * 1024;  // the ring's share of shared memory
constexpr int kSumBarrier = 1;          // the consumer warps' named barrier
constexpr int kTicketStride = 32;  // a ticket counter a 128-byte line

// A 16-byte vector of T: kN elements, held raw, read and written as f32.
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int kN = 4;
  using Raw = float4;
  __device__ __forceinline__ static Raw load(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  __device__ __forceinline__ static void unpack(const Raw& q, float* v) {
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  }
  __device__ __forceinline__ static void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  using Raw = uint4;
  __device__ __forceinline__ static Raw load(const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint4*>(p);
  }
  // element 2k sits in the low half of word k (little-endian); a bf16 is
  // the high half of the f32 with the same bits
  __device__ __forceinline__ static void unpack(const Raw& q, float* v) {
    const uint32_t u[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[2 * k] = __uint_as_float(u[k] << 16);
      v[2 * k + 1] = __uint_as_float(u[k] & 0xffff0000u);
    }
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p,
                                               const float* v) {
    uint32_t u[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const __nv_bfloat162 b = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
      u[k] = *reinterpret_cast<const uint32_t*>(&b);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(u[0], u[1], u[2], u[3]);
  }
};

template <>
struct Vec<__half> {
  static constexpr int kN = 8;
  using Raw = uint4;
  __device__ __forceinline__ static Raw load(const __half* p) {
    return *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ static void unpack(const Raw& q, float* v) {
    const uint32_t u[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&u[k]));
      v[2 * k] = f.x;
      v[2 * k + 1] = f.y;
    }
  }
  __device__ __forceinline__ static void store(__half* p, const float* v) {
    uint32_t u[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const __half2 b = __floats2half2_rn(v[2 * k], v[2 * k + 1]);
      u[k] = *reinterpret_cast<const uint32_t*>(&b);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(u[0], u[1], u[2], u[3]);
  }
};

// The scale at columns col .. col + E - 1 (f32, 16-byte aligned).
template <int E>
__device__ __forceinline__ void load_scale(const float* w, int col, float* v) {
#pragma unroll
  for (int e = 0; e < E; e += 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(w + col + e));
    v[e] = q.x;
    v[e + 1] = q.y;
    v[e + 2] = q.z;
    v[e + 3] = q.w;
  }
}

// The sum of p's E entries, pairwise (p is overwritten).
template <int E>
__device__ __forceinline__ float fold(float (&p)[E]) {
#pragma unroll
  for (int w = E / 2; w > 0; w >>= 1)
#pragma unroll
    for (int e = 0; e < w; ++e) p[e] += p[e + w];
  return p[0];
}

// Sums of the N values v over the WPR warps that hold one row (every lane
// gets the same bits: a butterfly adds each pair in both lanes alike).
// buf: this row group's [WPR][2] slots; each of a row's three sums has its
// own buffer, so that the barriers between them keep reuse safe. Every
// warp of the block's kWarps meets the barrier.
template <int WPR, int N>
__device__ __forceinline__ void row_sum(float (&v)[N], float (*buf)[2],
                                        int part) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int n = 0; n < N; ++n) v[n] += __shfl_xor_sync(0xffffffffu, v[n], o);
  if constexpr (WPR > 1) {
    if ((threadIdx.x & 31) == 0)
#pragma unroll
      for (int n = 0; n < N; ++n) buf[part][n] = v[n];
    named_barrier(kSumBarrier, 32 * kWarps);
#pragma unroll
    for (int n = 0; n < N; ++n) {
      v[n] = 0.f;
#pragma unroll
      for (int k = 0; k < WPR; ++k) v[n] += buf[k][n];
    }
  }
}

// dst[j] = the sum over r < nrows, in order, of src[r n + j], for j < n (n
// a multiple of 4), src read through L2 (other blocks wrote it). A thread
// takes two columns of float4 at once and keeps up to 16 rows of each in
// flight: at n = 2 x 768 and up to 16 rows, one round trip to L2.
__device__ __forceinline__ void sum_rows(const float* src, int nrows, int n,
                                         float* dst) {
  constexpr int kBatch = 16;
  const int n4 = n / 4;
  const float4* s4 = reinterpret_cast<const float4*>(src);
  for (int j0 = threadIdx.x; j0 < n4; j0 += 2 * blockDim.x) {
    const int j1 = j0 + blockDim.x;
    const bool two = j1 < n4;
    float4 a[2] = {make_float4(0.f, 0.f, 0.f, 0.f),
                   make_float4(0.f, 0.f, 0.f, 0.f)};
    for (int r = 0; r < nrows; r += kBatch) {
      const int m = min(kBatch, nrows - r);
      float4 v[2][kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        if (k < m) {
          const float4* row = s4 + static_cast<size_t>(r + k) * n4;
          v[0][k] = __ldcg(row + j0);
          if (two) v[1][k] = __ldcg(row + j1);
        }
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        if (k < m) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            a[c].x += v[c][k].x;
            a[c].y += v[c][k].y;
            a[c].z += v[c][k].z;
            a[c].w += v[c][k].w;
          }
        }
      }
    }
    reinterpret_cast<float4*>(dst)[j0] = a[0];
    if (two) reinterpret_cast<float4*>(dst)[j1] = a[1];
  }
}

// Takes a ticket: adds 1 to *p and returns the count before, with
// release semantics (the writes the block made before its barrier are
// visible to whoever acquires the count) and acquire semantics (the
// writes of every block that took a ticket before are visible here).
__device__ __forceinline__ unsigned take_ticket(unsigned* p) {
  unsigned old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;\n"
               : "=r"(old)
               : "l"(p)
               : "memory");
  return old;
}

// The sum of the blocks' partial rows part[0 .. gridDim.x) (n floats
// each; this block's row written by its threads before the call) into
// out, in a fixed order whichever block finishes last. Blocks form groups
// of `group`; the last of a group to arrive (ticket g) adds its group's
// rows, in block order, into row gridDim.x + g of part; the last group
// (ticket `groups`) adds those rows, in group order, into out. Ticket k is
// tickets[k kTicketStride]. The last arrival resets its counter: tickets
// are zero before and after a call. Every thread of the block calls it.
__device__ void finish(float* part, unsigned* tickets, float* out, int n,
                       int group) {
  __shared__ int last;
  const int grid = gridDim.x, b = blockIdx.x;
  const int groups = (grid + group - 1) / group, g = b / group;
  const int members = min(group, grid - g * group);
  __syncthreads();  // this block's row, before its ticket
  if (threadIdx.x == 0) {
    last = take_ticket(&tickets[g * kTicketStride]) == unsigned(members - 1);
    if (last) tickets[g * kTicketStride] = 0u;
  }
  __syncthreads();
  if (!last) return;
  float* mine = groups == 1 ? out : part + static_cast<size_t>(grid + g) * n;
  sum_rows(part + static_cast<size_t>(g) * group * n, members, n, mine);
  if (groups == 1) return;
  __syncthreads();
  if (threadIdx.x == 0) {
    last = take_ticket(&tickets[groups * kTicketStride]) ==
           unsigned(groups - 1);
    if (last) tickets[groups * kTicketStride] = 0u;
  }
  __syncthreads();
  if (!last) return;
  sum_rows(part + static_cast<size_t>(grid) * n, groups, n, out);
}

// The kernel's dynamic shared memory: mbarriers, the row sums' slots, the
// scale (f32 [ld]), then the ring of `stages` stages of three [G, ld]
// tiles (x, dy, r), 128-byte aligned. The block's column sums reuse the
// ring at the end.
struct Layout {
  int scale, ring, stage, total;
};

__host__ __device__ __forceinline__ Layout layout(int ld, int elt, int G,
                                                  int stages) {
  Layout l;
  l.scale = 2 * kMaxStages * 8 + 3 * kWarps * 2 * 4;  // mbarriers, sums
  l.ring = (l.scale + ld * 4 + 127) / 128 * 128;
  l.stage = 3 * G * ld * elt;
  l.total = l.ring + stages * l.stage;
  return l;
}

// As many stages as fit kRingBytes, two to kMaxStages.
__host__ __device__ __forceinline__ int ring_stages(int ld, int elt, int G) {
  const int n = kRingBytes / layout(ld, elt, G, 0).stage;
  return n < 2 ? 2 : n > kMaxStages ? kMaxStages : n;
}

// VPL: 16-byte vectors a lane holds of a row; WPR: warps a row. A block
// takes rows [start, start + count) of the row-major [rows, ld] tensors,
// the first H of each row's ld elements real; its partial row of dscale
// and dbias is row blockIdx.x of part ([grid + groups, 2 ld] f32).
template <typename T, int VPL, int WPR>
__global__ void __launch_bounds__(kThreads, 1)
    ln_bwd_kernel(const T* __restrict__ x, const T* __restrict__ res,
                  const float* __restrict__ w, const T* __restrict__ dy,
                  T* __restrict__ dx, float* __restrict__ part,
                  unsigned* __restrict__ tickets, float* __restrict__ out,
                  int rows, int H, int ld, float eps, int group) {
  using V = Vec<T>;
  constexpr int E = V::kN;
  constexpr int G = kWarps / WPR;  // rows a tile holds, a row group each
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxStages;
  auto red = reinterpret_cast<float(*)[G][WPR][2]>(empty + kMaxStages);
  const int stages = ring_stages(ld, int(sizeof(T)), G);
  const Layout lay = layout(ld, int(sizeof(T)), G, stages);
  float* wsm = reinterpret_cast<float*>(smem + lay.scale);
  T* ring = reinterpret_cast<T*>(smem + lay.ring);
  const size_t tile = static_cast<size_t>(G) * ld;  // elements a tile

  // this block's run of rows
  const int q = rows / gridDim.x, rem = rows % gridDim.x;
  const int b = blockIdx.x;
  const int start = b * q + min(b, rem), count = q + (b < rem ? 1 : 0);
  const int tiles = (count + G - 1) / G;
  const int warp = warp_uniform_index(), lane = threadIdx.x & 31;

  // the producer (lane 0 of the last warp): tile i into stage i % stages,
  // the scale with tile 0. It sets up the mbarriers and starts the first
  // stages' copies before the block's first barrier; a later tile waits
  // until its stage's previous tile has been taken by every consumer warp
  auto issue = [&](int i) {
    const int s = i % stages;
    const int n = min(G, count - i * G);
    const uint32_t bytes = uint32_t(n) * ld * sizeof(T);
    const uint32_t scale_bytes = i == 0 ? uint32_t(ld) * 4 : 0;
    const size_t off = static_cast<size_t>(start + i * G) * ld;
    T* st = ring + static_cast<size_t>(s) * 3 * tile;
    mbar_arrive_expect_tx(&full[s],
                          (res != nullptr ? 3 : 2) * bytes + scale_bytes);
    if (i == 0) bulk_load(wsm, w, scale_bytes, &full[s]);
    bulk_load(st, x + off, bytes, &full[s]);
    bulk_load(st + tile, dy + off, bytes, &full[s]);
    if (res != nullptr) bulk_load(st + 2 * tile, res + off, bytes, &full[s]);
  };
  if (threadIdx.x == 32 * kWarps) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWarps);
    }
    mbar_init_fence();
    for (int i = 0; i < min(stages, tiles); ++i) issue(i);
  }
  __syncthreads();

  if (warp == kWarps) {
    if (lane == 0) {
      for (int i = stages; i < tiles; ++i) {
        mbar_wait(&empty[i % stages], ((i / stages) - 1) & 1);
        issue(i);
      }
    }
    __syncwarp();
  } else {
    const int rg = warp / WPR, wpart = warp % WPR;
    const int first = wpart * 32 + lane;  // first vector
    const int nvec = ld / E;
    const float inv_h = 1.f / static_cast<float>(H);
    bool valid[VPL];
    float acc_s[VPL][E], acc_b[VPL][E];
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      valid[i] = first + 32 * WPR * i < nvec;
#pragma unroll
      for (int e = 0; e < E; ++e) acc_s[i][e] = acc_b[i][e] = 0.f;
    }
    // the scale at vector k's columns (zero for a lane without one), from
    // shared memory, where it lands with tile 0 (held in registers, it
    // cost the 1024-column instances spills)
    auto scale = [&](int k, float* v) {
      if (valid[k]) {
#pragma unroll
        for (int e = 0; e < E; e += 4) {
          const float4 q = *reinterpret_cast<const float4*>(
              wsm + (first + 32 * WPR * k) * E + e);
          v[e] = q.x;
          v[e + 1] = q.y;
          v[e + 2] = q.z;
          v[e + 3] = q.w;
        }
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) v[e] = 0.f;
      }
    };

    // the loop is uniform over the consumer warps: every warp meets the
    // barriers of the multi-warp rows and arrives on every stage
    for (int i = 0; i < tiles; ++i) {
      const int s = i % stages;
      const int r = i * G + rg;  // this row group's row in the run
      const bool active = r < count;
      mbar_wait(&full[s], (i / stages) & 1);
      const T* st = ring + static_cast<size_t>(s) * 3 * tile +
                    static_cast<size_t>(rg) * ld;
      float h[VPL][E];
      typename V::Raw draw[VPL];
#pragma unroll
      for (int k = 0; k < VPL; ++k) {
        const int col = (first + 32 * WPR * k) * E;
        if (active && valid[k]) {
          V::unpack(V::load(st + col), h[k]);
          draw[k] = V::load(st + tile + col);
          if (res != nullptr) {
            float rv[E];
            V::unpack(V::load(st + 2 * tile + col), rv);
#pragma unroll
            for (int e = 0; e < E; ++e) h[k][e] += rv[e];
          }
        } else {
#pragma unroll
          for (int e = 0; e < E; ++e) h[k][e] = 0.f;
          draw[k] = typename V::Raw{};
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);  // the stage is free again

      // a lane's sums run in E chains of VPL terms, folded pairwise
      float pa[E], pb[E];
#pragma unroll
      for (int e = 0; e < E; ++e) pa[e] = 0.f;
#pragma unroll
      for (int k = 0; k < VPL; ++k)
#pragma unroll
        for (int e = 0; e < E; ++e) pa[e] += h[k][e];
      float sum[1] = {fold(pa)};
      row_sum<WPR>(sum, red[0][rg], wpart);
      const float mean = sum[0] / static_cast<float>(H);
#pragma unroll
      for (int e = 0; e < E; ++e) pa[e] = 0.f;
      // the squares skip the zero-padded tail of a ragged width; whole
      // rows (ld == H, a uniform branch) keep a loop without the element
      // mask, which in the one loop cost spills and 3% at H = 768 in bf16
      if (ld == H) {
#pragma unroll
        for (int k = 0; k < VPL; ++k)
#pragma unroll
          for (int e = 0; e < E; ++e) {
            const float c = valid[k] ? h[k][e] - mean : 0.f;
            pa[e] += c * c;
          }
      } else {
#pragma unroll
        for (int k = 0; k < VPL; ++k)
#pragma unroll
          for (int e = 0; e < E; ++e) {
            const float c =
                (first + 32 * WPR * k) * E + e < H ? h[k][e] - mean : 0.f;
            pa[e] += c * c;
          }
      }
      float sq[1] = {fold(pa)};
      row_sum<WPR>(sq, red[1][rg], wpart);
      const float rstd = 1.f / sqrtf(sq[0] / static_cast<float>(H) + eps);
#pragma unroll
      for (int e = 0; e < E; ++e) pa[e] = pb[e] = 0.f;
#pragma unroll
      for (int k = 0; k < VPL; ++k) {
        float d[E], wv[E];
        V::unpack(draw[k], d);
        scale(k, wv);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          h[k][e] = (h[k][e] - mean) * rstd;  // xhat from here on
          const float g = d[e] * wv[e];
          pa[e] += g;
          pb[e] += g * h[k][e];
        }
      }
      float sg[2] = {fold(pa), fold(pb)};  // sum of g, sum of g xhat
      row_sum<WPR>(sg, red[2][rg], wpart);
      const float mg = sg[0] * inv_h, mgx = sg[1] * inv_h;
      if (active) {
        T* dst = dx + static_cast<size_t>(start + r) * ld;
#pragma unroll
        for (int k = 0; k < VPL; ++k) {
          if (!valid[k]) continue;
          float d[E], wv[E], o[E];
          V::unpack(draw[k], d);
          scale(k, wv);
#pragma unroll
          for (int e = 0; e < E; ++e) {
            o[e] = rstd * (d[e] * wv[e] - mg - h[k][e] * mgx);
            acc_s[k][e] += d[e] * h[k][e];
            acc_b[k][e] += d[e];
          }
          V::store(dst + (first + 32 * WPR * k) * E, o);
        }
      }
    }

    // the block's column sums: once every consumer warp has read its
    // last tile (the first barrier), row group g writes its lanes' sums to
    // rows [g][2][ld] f32 at the ring's start
    named_barrier(kSumBarrier, 32 * kWarps);
    float* cols =
        reinterpret_cast<float*>(ring) + static_cast<size_t>(rg) * 2 * ld;
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
      if (!valid[k]) continue;
      const int col = (first + 32 * WPR * k) * E;
#pragma unroll
      for (int e = 0; e < E; e += 4) {
        *reinterpret_cast<float4*>(cols + col + e) = make_float4(
            acc_s[k][e], acc_s[k][e + 1], acc_s[k][e + 2], acc_s[k][e + 3]);
        *reinterpret_cast<float4*>(cols + ld + col + e) = make_float4(
            acc_b[k][e], acc_b[k][e + 1], acc_b[k][e + 2], acc_b[k][e + 3]);
      }
    }
  }
  __syncthreads();
  // the block's row of partials: the row groups' rows added in order (a
  // grid of one block writes dscale and dbias themselves)
  const float4* rows4 = reinterpret_cast<const float4*>(ring);
  const int n4 = ld / 2;  // 2 ld floats
  float4* dst = reinterpret_cast<float4*>(
      gridDim.x == 1 ? out : part + static_cast<size_t>(b) * 2 * ld);
  for (int j = threadIdx.x; j < n4; j += kThreads) {
    float4 a = rows4[j];
#pragma unroll
    for (int g = 1; g < G; ++g) {
      const float4 v = rows4[g * n4 + j];
      a.x += v.x;
      a.y += v.y;
      a.z += v.z;
      a.w += v.w;
    }
    dst[j] = a;
  }
  if (gridDim.x > 1) finish(part, tickets, out, 2 * ld, group);
}

// Rows wider than kMaxHidden: one block a row (rows blockIdx.x,
// blockIdx.x + gridDim.x, ...), four passes over it, re-read from L2. The
// block's partial rows of dscale and dbias are summed in place in its row
// of part, row after row: thread t owns the columns of vectors t, t +
// kWideThreads, ... of both, so no two threads touch one entry. Needs
// gridDim.x <= rows (the first row writes the partials).
template <typename T>
__global__ void __launch_bounds__(kWideThreads)
    ln_bwd_wide_kernel(const T* __restrict__ x, const T* __restrict__ res,
                       const float* __restrict__ w, const T* __restrict__ dy,
                       T* __restrict__ dx, float* __restrict__ part,
                       unsigned* __restrict__ tickets, float* __restrict__ out,
                       int rows, int H, int ld, float eps, int group) {
  using V = Vec<T>;
  constexpr int E = V::kN;
  __shared__ float red[3][kWarps][2];
  const int nvec = ld / E, wpart = threadIdx.x >> 5;
  const float inv_h = 1.f / static_cast<float>(H);
  float* ps = part + static_cast<size_t>(blockIdx.x) * 2 * ld;
  float* pb = ps + ld;
  for (long long row = blockIdx.x; row < rows; row += gridDim.x) {
    const size_t off = static_cast<size_t>(row) * ld;
    const bool first_row = row == blockIdx.x;
    auto load_h = [&](int col, float* h) {
      V::unpack(V::load(x + off + col), h);
      if (res != nullptr) {
        float r[E];
        V::unpack(V::load(res + off + col), r);
#pragma unroll
        for (int e = 0; e < E; ++e) h[e] += r[e];
      }
    };
    float sum[1] = {0.f};
    for (int v = threadIdx.x; v < nvec; v += kWideThreads) {
      float h[E];
      load_h(v * E, h);
#pragma unroll
      for (int e = 0; e < E; ++e) sum[0] += h[e];
    }
    row_sum<kWarps>(sum, red[0], wpart);
    const float mean = sum[0] / static_cast<float>(H);
    float sq[1] = {0.f};
    for (int v = threadIdx.x; v < nvec; v += kWideThreads) {
      float h[E];
      load_h(v * E, h);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float c = v * E + e < H ? h[e] - mean : 0.f;
        sq[0] += c * c;
      }
    }
    row_sum<kWarps>(sq, red[1], wpart);
    const float rstd = 1.f / sqrtf(sq[0] / static_cast<float>(H) + eps);
    float sg[2] = {0.f, 0.f};
    for (int v = threadIdx.x; v < nvec; v += kWideThreads) {
      float h[E], d[E], wv[E];
      load_h(v * E, h);
      V::unpack(V::load(dy + off + v * E), d);
      load_scale<E>(w, v * E, wv);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float g = d[e] * wv[e];
        sg[0] += g;
        sg[1] += g * ((h[e] - mean) * rstd);
      }
    }
    row_sum<kWarps>(sg, red[2], wpart);
    const float mg = sg[0] * inv_h, mgx = sg[1] * inv_h;
    for (int v = threadIdx.x; v < nvec; v += kWideThreads) {
      const int col = v * E;
      float h[E], d[E], wv[E], o[E];
      load_h(col, h);
      V::unpack(V::load(dy + off + col), d);
      load_scale<E>(w, col, wv);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float xhat = (h[e] - mean) * rstd;
        o[e] = rstd * (d[e] * wv[e] - mg - xhat * mgx);
        ps[col + e] = (first_row ? 0.f : ps[col + e]) + d[e] * xhat;
        pb[col + e] = (first_row ? 0.f : pb[col + e]) + d[e];
      }
      V::store(dx + off + col, o);
    }
  }
  finish(part, tickets, out, 2 * ld, group);
}

template <typename T>
using BwdKernel = void (*)(const T*, const T*, const float*, const T*, T*,
                           float*, unsigned*, float*, int, int, int, float,
                           int);

// The kernel for rows of ld elements of T (ld a positive multiple of 16
// bytes), its threads a block and the rows a tile holds (0 for the wide
// kernel); null for another ld.
template <typename T>
BwdKernel<T> pick(int ld, int* threads, int* tile_rows) {
  constexpr int E = Vec<T>::kN, VMAX = 32 / E;  // 32 columns a lane
  if (ld <= 0 || ld % E != 0) return nullptr;
  *threads = kWideThreads;
  *tile_rows = 0;
  if (ld > kMaxHidden) return ln_bwd_wide_kernel<T>;
  const int nvec = ld / E;
  *threads = kThreads;
  *tile_rows = kWarps;
  if (nvec <= 32 * VMAX) {
    const int vpl = (nvec + 31) / 32;
    if (vpl <= 1) return ln_bwd_kernel<T, 1, 1>;
    if (vpl <= 2) return ln_bwd_kernel<T, 2, 1>;
    if constexpr (E == 8) {
      if (vpl <= 3) return ln_bwd_kernel<T, 3, 1>;
      return ln_bwd_kernel<T, 4, 1>;
    } else {
      if (vpl <= 4) return ln_bwd_kernel<T, 4, 1>;
      if (vpl <= 6) return ln_bwd_kernel<T, 6, 1>;
      return ln_bwd_kernel<T, 8, 1>;
    }
  }
  if (nvec <= 2 * 32 * VMAX) {
    *tile_rows = kWarps / 2;
    return ln_bwd_kernel<T, VMAX, 2>;
  }
  if (nvec <= 4 * 32 * VMAX) {
    *tile_rows = kWarps / 4;
    return ln_bwd_kernel<T, VMAX, 4>;
  }
  *tile_rows = 1;
  return ln_bwd_kernel<T, VMAX, 8>;
}

// Dynamic shared memory of the kernel pick() returns (0 for the wide one).
template <typename T>
int smem_bytes(int ld, int tile_rows) {
  if (tile_rows == 0) return 0;
  const int elt = int(sizeof(T));
  return layout(ld, elt, tile_rows, ring_stages(ld, elt, tile_rows)).total;
}

template <typename T>
cudaError_t geometry(int ld, int* blocks_per_sm, int* rows_at_once) {
  int threads = 0, tile_rows = 0;
  const BwdKernel<T> k = pick<T>(ld, &threads, &tile_rows);
  if (k == nullptr) return cudaErrorInvalidValue;
  const int smem = smem_bytes<T>(ld, tile_rows);
  *rows_at_once = tile_rows == 0 ? 1 : tile_rows;
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  cudaFuncAttributes fa;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, k);
  if (e != cudaSuccess) return e;
  if (smem > optin - int(fa.sharedSizeBytes)) return cudaErrorInvalidValue;
  // as much as the card allows, so that any ld of this instance launches
  e = cudaFuncSetAttribute(reinterpret_cast<const void*>(k),
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           optin - int(fa.sharedSizeBytes));
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, reinterpret_cast<const void*>(k), threads, smem);
  // the wide kernel re-reads rows from L2: two blocks an SM
  if (tile_rows == 0 && *blocks_per_sm > 2) *blocks_per_sm = 2;
  return e;
}

template <typename T>
cudaError_t launch(const void* x, const void* res, const float* w,
                   const void* dy, void* dx, float* part, unsigned* tickets,
                   float* out, int rows, int H, int ld, float eps, int grid,
                   int group, cudaStream_t s) {
  int threads = 0, tile_rows = 0;
  const BwdKernel<T> k = pick<T>(ld, &threads, &tile_rows);
  if (k == nullptr) return cudaErrorInvalidValue;
  k<<<grid, threads, smem_bytes<T>(ld, tile_rows), s>>>(
      static_cast<const T*>(x), static_cast<const T*>(res), w,
      static_cast<const T*>(dy), static_cast<T*>(dx), part, tickets, out,
      rows, H, ld, eps, group);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// For dtype 0 (float32), 1 (bfloat16) or 2 (float16) and a row stride ld
// (a positive multiple of 16 bytes), on the current device: the blocks of
// K4-bwd's kernel one SM holds and the rows a block takes at once (a
// tile). It also lets the kernel take its shared memory: call it once per
// (dtype, ld) and device before mmf_layer_norm_bwd. Returns a cudaError
// (cudaErrorInvalidValue for another dtype or ld).
int mmf_layer_norm_bwd_geometry(int dtype, int ld, int* blocks_per_sm,
                                int* rows_at_once) {
  if (dtype == 0)
    return int(geometry<float>(ld, blocks_per_sm, rows_at_once));
  if (dtype == 1)
    return int(geometry<__nv_bfloat16>(ld, blocks_per_sm, rows_at_once));
  if (dtype == 2)
    return int(geometry<__half>(ld, blocks_per_sm, rows_at_once));
  return int(cudaErrorInvalidValue);
}

// x, res (or null), dy, dx: [rows, ld] row-major in dtype, 16-byte
// aligned, ld a multiple of 16 bytes, columns H .. ld - 1 of x, res and
// dy zero; w: f32 [ld] (the scale, zero past H); out: f32 [2, ld], dscale
// then dbias (entries past H meaningless, as are dx's); part: f32
// [grid + ceil(grid / group), 2 ld] scratch; tickets: [(ceil(grid /
// group) + 1) x 32] unsigned, zero (every call leaves them zero).
// 1 <= grid <= rows, group >= 1. Launches one kernel on `stream`,
// allocates nothing, returns cudaGetLastError() (or cudaErrorInvalidValue
// / cudaErrorMisalignedAddress for arguments it does not take).
int mmf_layer_norm_bwd(const void* x, const void* res, const float* w,
                       const void* dy, void* dx, float* part,
                       unsigned* tickets, float* out, int dtype, int rows,
                       int H, int ld, float eps, int grid, int group,
                       void* stream) {
  if (rows < 1 || H < 1 || H > ld || grid < 1 || grid > rows ||
      grid > (1 << 20) || group < 1 || part == nullptr || tickets == nullptr)
    return int(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(res) |
       reinterpret_cast<uintptr_t>(w) | reinterpret_cast<uintptr_t>(dy) |
       reinterpret_cast<uintptr_t>(dx) | reinterpret_cast<uintptr_t>(part) |
       reinterpret_cast<uintptr_t>(out)) % 16 != 0)
    return int(cudaErrorMisalignedAddress);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return int(launch<float>(x, res, w, dy, dx, part, tickets, out, rows, H,
                             ld, eps, grid, group, s));
  if (dtype == 1)
    return int(launch<__nv_bfloat16>(x, res, w, dy, dx, part, tickets, out,
                                     rows, H, ld, eps, grid, group, s));
  if (dtype == 2)
    return int(launch<__half>(x, res, w, dy, dx, part, tickets, out, rows, H,
                              ld, eps, grid, group, s));
  return int(cudaErrorInvalidValue);
}

const char* mmf_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
